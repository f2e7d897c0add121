// Point programs on Hopper (sm_90a): the G2 ladder of hash-to-G2 and
// signing, and the grouped Miller loop, each one launch of a kernel that
// interprets a program over a register file of Fq rows in shared memory.
//
//   g2_ladder_kernel:      [n, 4, 14] affine G2 (x0, x1, y0, y1), [n]
//             infinity flags, the signed window digits of one scalar (device
//             int32 arrays) and its correction flag -> [n, 4, 14] affine
//             [k]P and [n] infinity flags: the odd-multiples table, every
//             window (w doublings, a table load by digit, the add), the
//             correction add and the Fermat inversion of jac_to_affine
//   miller_grouped_kernel: g1 [G, 2P, 14], g2 [G, 4P, 14] -> [G, 12, 14],
//             per group the product of P Miller functions f_{|z|,Q}(P):
//             for each of the 63 tail bits of |z| the doubling lines of every
//             pair, one Fq12 squaring and P line multiplies, on a set bit the
//             addition lines and P more line multiplies, then the conjugation
//
// The programs (ops/fq_program.py, built by ops/fq_points.py) are the
// port's own formulas recorded op by op: scalar_mul.jac_double / jac_add /
// build_odd_multiples / jac_to_affine with the window loop of the
// reference's windowed_scalar_mul (consensus_specs_tpu/ops/scalar_mul.py:275,
// a lax.fori_loop whose digits are data) and Field.pow_static's inversion;
// bls_torch._dbl_lines / _add_lines with the f-update of
// Tower.fq12_sqr_mul_lines / fq12_mul_lines (the reference's
// consensus_specs_tpu/ops/bls_jax.py:240-312 miller_loop_grouped, a
// lax.fori_loop). XLA programs, no Pallas kernel. Every op is the same
// exact integer computation as the plain function it stands for
// (ops/fq.py fq_mul_plain, Field.is_zero, fq_bilinear_plain, the lazy limb
// add / sub / neg / where, fq_norm), so the outputs equal the Python loops
// limb for limb; ops/fq_program.py::run_program_plain is the plain twin.
//
// What bounds them on this card. At the main path's sizes (1-16 ladder
// lanes in a block verify or a signature, 128 in a firehose stage; 16 or
// 128 Miller groups) neither bytes nor multiply-adds: a cofactor ladder
// lane is about 50,000 dependent field operations (some 4,000 levels of
// products), against a few kilobytes of input and output. The time is the
// latency of the dependency chain, and before these kernels it was the
// host's cost of one launch per product (about 10,500 launches per hash
// batch, 2,200 per Miller loop).
//
// Design:
// - One program for the whole loop. The host schedules the ops into
//   bundles of mutually independent ops (an op joins the first bundle after
//   its inputs), allocates registers by liveness and uploads the program
//   once per device. The ladder's program depends only on (nbits, w): the
//   digits are data, so the cofactor and every 256-bit signing scalar each
//   reuse one program. The Miller program depends only on P.
// - State in shared memory for the whole loop. A lane's register file
//   (rows of 14 int64 limbs, 16-byte aligned), its flags and the bundle's
//   scratch (leaf operand rows, wide rows) live in dynamic shared memory
//   (above 48 KB through cudaFuncSetAttribute); inputs are staged once with
//   cp.async and the outputs leave in one coalesced store.
// - A bundle in four phases over the block's threads, a barrier after
//   each, as one step of the chain kernel (csrc/fq_mont.cu): (A) linear
//   ops (one thread per row) and the tower products' pre-sums (one thread
//   per operand limb, the compiled Table<K> code reading the register file
//   through a gather); (B) every multiply's schoolbook into int64 columns
//   and every tower product's leaves (one thread per leaf); (C) the tower
//   products' gamma sums (one thread per column); (D) every REDC (one
//   thread per output row). So a doubling costs its dependency depth in
//   bundles, not its products one after another. A bundle without
//   products runs phase A alone; one without tower products skips C.
// - A phase's items are numbered across the bundle's ops, class by class,
//   and thread t takes items t, t + threads, ...: the ops of one bundle run
//   side by side, neighbouring threads on the same code.
// - One lane (ladder) or one group (Miller) per block while the launch has
//   fewer lanes than the card has SMs; more lanes per block only beyond.
//   Threads: enough for the widest phase of the program, 64 to 256.
//
// Ranges: the ops see exactly the values the plain loops see, so every
// intermediate stays in the reference's proven budget (csrc/fq_mont.cu's
// note).

#include "fq_arith.cuh"

namespace {

constexpr int kWords = 8;             // int32 words per op
constexpr int kAdd = 1, kSub = 2, kNeg = 3, kNorm = 4, kSel = 5, kLoad = 6,
              kSgn = 7, kFand = 8, kFnot = 9;
constexpr int kMul = 16, kIsz = 17, kBil = 32;
constexpr int kNormFull = kL + 3;     // rounds to the unique signed-top form
constexpr int kThreads = 256;

// The tower products a program may run: P leaves, R outputs, Ca / Cb rows.
struct KindShape {
  int P, R, Ca, Cb;
};
static_assert(kNumKinds == 5, "the kind list below names kinds 0 .. 4");
#define FQ_SHAPE(K) {Table<K>::P, Table<K>::R, Table<K>::Ca, Table<K>::Cb}
__constant__ KindShape kShapes[kNumKinds] = {FQ_SHAPE(0), FQ_SHAPE(1), FQ_SHAPE(2),
                                             FQ_SHAPE(3), FQ_SHAPE(4)};

struct Prog {
  const int* bundles;        // [n_bundles][4]: linear ops, multiplies, products, first op
  const int* ops;            // [n_ops][kWords]
  const int* pool;           // row lists
  const int* const_regs;     // [n_const]
  const int* in_regs[2];     // [in_rows[g]]
  const int* out_regs;       // [out_rows]
  const long long* consts;   // [n_const][kL]
  const int* d_idx;          // [m] table index of each window digit
  const int* d_sign;         // [m] its sign
  int n_bundles, n_const, nreg, nflag, nx, ng;
  int in_rows[2], out_rows;
  int lane_flag, uniform_flag, uniform_val, out_flag;
};

struct Io {
  const long long* in[2];          // [n][in_rows[g]][kL]
  const unsigned char* lane_flags; // [n] or null
  long long* out;                  // [n][out_rows][kL]
  unsigned char* out_flags;        // [n] or null
  unsigned n;
  int tile;                        // lanes per block
  long long* stamps;               // null, or 1 + n_bundles clock64() values
};

// A block's shared memory: per lane the register file (nreg rows), the
// leaf operand rows x and y (nx each), the wide rows (ng) and the flags.
struct File {
  long long *regs, *x, *y, *g;
  int* flags;
  int reg_r, x_r, g_r, flag_r;     // per lane
};

__device__ __forceinline__ File file_of(long long* smem, const Prog& p, int tile) {
  File f;
  f.reg_r = p.nreg * kL;
  f.x_r = p.nx * kL;
  f.g_r = p.ng * kWPitch;
  f.flag_r = (p.nflag + 3) & ~3;
  f.regs = smem;
  f.x = f.regs + tile * f.reg_r;
  f.y = f.x + tile * f.x_r;
  f.g = f.y + tile * f.x_r;
  f.flags = reinterpret_cast<int*>(f.g + tile * f.g_r);
  return f;
}

// Row c of a product's operand is register rows[c] of the lane: the
// compiled pre-sums read a[c * kL].
struct Gather {
  const long long* base;     // the lane's register file, at the thread's limb
  const int* rows;
  __device__ __forceinline__ long long operator[](int i) const {
    return base[rows[i / kL] * kL];
  }
};

__device__ __forceinline__ void copy_row(long long* d, const long long* s) {
  const longlong2* sv = reinterpret_cast<const longlong2*>(s);
  longlong2* dv = reinterpret_cast<longlong2*>(d);
#pragma unroll
  for (int k = 0; k < kL / 2; ++k) dv[k] = sv[k];
}

// One linear op on lane l.
__device__ __forceinline__ void linear(const int* w, const Prog& p, long long* R, int* Fl) {
  const int code = w[0];
  switch (code) {
    case kAdd:
    case kSub: {
      long long a[kL], b[kL];
      load_row(R + w[2] * kL, a);
      load_row(R + w[3] * kL, b);
#pragma unroll
      for (int k = 0; k < kL; ++k) a[k] = code == kAdd ? a[k] + b[k] : a[k] - b[k];
      store_row(R + w[1] * kL, a);
      break;
    }
    case kNeg:
    case kNorm: {
      long long a[kL];
      load_row(R + w[2] * kL, a);
      if (code == kNeg) {
#pragma unroll
        for (int k = 0; k < kL; ++k) a[k] = -a[k];
      } else {
        carry_rounds(a);
      }
      store_row(R + w[1] * kL, a);
      break;
    }
    case kSel:
      copy_row(R + w[1] * kL, R + (Fl[w[4]] ? w[2] : w[3]) * kL);
      break;
    case kLoad:
      copy_row(R + w[1] * kL, R + p.pool[w[6] + p.d_idx[w[5]]] * kL);
      break;
    case kSgn:
      Fl[w[1]] = p.d_sign[w[5]] < 0;
      break;
    case kFand:
      Fl[w[1]] = Fl[w[2]] & Fl[w[3]];
      break;
    default:    // kFnot
      Fl[w[1]] = !Fl[w[2]];
      break;
  }
}

template <class T>
__device__ __forceinline__ void presum(bool is_b, const long long* R, const int* rows,
                                       int t, long long* x, long long* y) {
  if (!is_b) {
    T::alpha(Gather{R + t, rows}, x + t);
  } else {
    T::beta(Gather{R + t, rows + T::Ca}, y + t);
  }
}

template <class T>
__device__ __forceinline__ void gamma_col(const long long* x, long long* g, int j) {
  T::gamma(reinterpret_cast<const int*>(x) + j, g + j);
}

#define FQ_PROGRAM_KIND(kind, fn, args)      \
  switch (kind) {                            \
    case 0: fn<Table<0>> args; break;        \
    case 1: fn<Table<1>> args; break;        \
    case 2: fn<Table<2>> args; break;        \
    case 3: fn<Table<3>> args; break;        \
    default: fn<Table<4>> args; break;       \
  }

// Product k of a bundle's tower products holding item j of a phase whose
// items per product are nl * per(kind): k, and j made relative to it.
template <class Per>
__device__ __forceinline__ int product_of(const int* bil, int nl, int& j, Per per) {
  int k = 0;
  for (;; ++k) {
    const int cnt = nl * per(kShapes[bil[k * kWords] - kBil]);
    if (j < cnt) return k;
    j -= cnt;
  }
}

// One bundle of the program over the block's nl lanes. In each phase the
// threads take the phase's items in order, i = tid, tid + nt, ...: the
// ops of a class stand one after another in the bundle, so neighbouring
// threads run the same code on neighbouring items.
__device__ __forceinline__ void bundle(const Prog& p, const File& f, int b, int nl) {
  const int n_lin = p.bundles[4 * b], n_mul = p.bundles[4 * b + 1];
  const int n_bil = p.bundles[4 * b + 2];
  const int* lin = p.ops + p.bundles[4 * b + 3] * kWords;
  const int* mul = lin + n_lin * kWords;
  const int* bil = mul + n_mul * kWords;
  const int tid = threadIdx.x, nt = blockDim.x;

  // (A) linear ops, one item per (op, lane); pre-sums, one per (product,
  // operand, limb, lane)
  const int lin_items = n_lin * nl;
  for (int i = tid; i < lin_items + n_bil * nl * 2 * kL; i += nt) {
    if (i < lin_items) {
      const int k = i / nl, l = i - k * nl;
      linear(lin + k * kWords, p, f.regs + l * f.reg_r, f.flags + l * f.flag_r);
    } else {
      const int j = i - lin_items, per = nl * 2 * kL;
      const int k = j / per, r = j - k * per, l = r / (2 * kL), lt = r - l * 2 * kL;
      const int* w = bil + k * kWords;
      const bool is_b = lt >= kL;
      const int t = is_b ? lt - kL : lt;
      long long* x = f.x + l * f.x_r + w[2] * kL;
      long long* y = f.y + l * f.x_r + w[2] * kL;
      FQ_PROGRAM_KIND(w[0] - kBil, presum, (is_b, f.regs + l * f.reg_r, p.pool + w[1], t, x, y))
    }
  }
  __syncthreads();
  if (n_mul + n_bil == 0) return;

  // (B) a multiply's schoolbook into its wide row, one item per (op, lane);
  // a product's leaf into its own x row as int32 columns, one per (product,
  // leaf, lane)
  const int mul_items = n_mul * nl;
  int leaf_items = 0;
  for (int k = 0; k < n_bil; ++k) leaf_items += nl * kShapes[bil[k * kWords] - kBil].P;
  for (int i = tid; i < mul_items + leaf_items; i += nt) {
    const long long *xs, *ys;
    long long* dst;
    const bool is_mul = i < mul_items;
    if (is_mul) {
      const int k = i / nl, l = i - k * nl;
      const int* w = mul + k * kWords;
      const long long* R = f.regs + l * f.reg_r;
      xs = R + w[2] * kL;
      ys = R + w[3] * kL;
      dst = f.g + l * f.g_r + w[6] * kWPitch;
    } else {
      int j = i - mul_items;
      const int k = product_of(bil, nl, j, [](const KindShape& s) { return s.P; });
      const int P = kShapes[bil[k * kWords] - kBil].P;
      const int l = j / P, leaf = j - l * P;
      const int row = (bil[k * kWords + 2] + leaf) * kL;
      dst = f.x + l * f.x_r + row;
      xs = dst;
      ys = f.y + l * f.x_r + row;
    }
    long long x[kL], y[kL];
    load_row(xs, x);
    load_row(ys, y);
    int x32[kL], y32[kL];
    narrow32(x, x32);
    narrow32(y, y32);
    long long c[kW];
    schoolbook(x32, y32, c);
    if (is_mul) {
      longlong2* d = reinterpret_cast<longlong2*>(dst);
#pragma unroll
      for (int q = 0; q < kW / 2; ++q) d[q] = make_longlong2(c[2 * q], c[2 * q + 1]);
    } else {
      int wn[kW];
      wide_norm32(c, wn);
      int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
        d[q] = make_int4(wn[4 * q], wn[4 * q + 1], wn[4 * q + 2], wn[4 * q + 3]);
    }
  }
  __syncthreads();

  // (C) products' gamma sums, one item per (product, column, lane)
  if (n_bil) {
    const int per = nl * kW;
    for (int i = tid; i < n_bil * per; i += nt) {
      const int k = i / per, r = i - k * per, l = r / kW, col = r - l * kW;
      const int* w = bil + k * kWords;
      FQ_PROGRAM_KIND(w[0] - kBil, gamma_col, (f.x + l * f.x_r + w[2] * kL,
                                               f.g + l * f.g_r + w[3] * kWPitch, col))
    }
    __syncthreads();
  }

  // (D) REDCs: a multiply's row (and is_zero's compare), one item per (op,
  // lane); a product's output rows, one per (product, output, lane)
  int redc_items = 0;
  for (int k = 0; k < n_bil; ++k) redc_items += nl * kShapes[bil[k * kWords] - kBil].R;
  for (int i = tid; i < mul_items + redc_items; i += nt) {
    const long long* src;
    long long* R;
    const int* w;
    int out_row, l;
    if (i < mul_items) {
      const int k = i / nl;
      l = i - k * nl;
      w = mul + k * kWords;
      R = f.regs + l * f.reg_r;
      src = f.g + l * f.g_r + w[6] * kWPitch;
      out_row = w[1];
    } else {
      int j = i - mul_items;
      const int k = product_of(bil, nl, j, [](const KindShape& s) { return s.R; });
      w = bil + k * kWords;
      const KindShape s = kShapes[w[0] - kBil];
      l = j / s.R;
      const int r = j - l * s.R;
      R = f.regs + l * f.reg_r;
      src = f.g + l * f.g_r + (w[3] + r) * kWPitch;
      out_row = p.pool[w[1] + s.Ca + s.Cb + r];
    }
    long long c[kW];
    load_row(src, c);
    long long res[kL];
    redc(c, res);
    if (w[0] != kIsz) {
      store_row(R + out_row * kL, res);
    } else {
#pragma unroll 1
      for (int s = 0; s < kNormFull; ++s) carry_round(res);
      const long long* qp = R + w[4] * kL;
      const long long* qn = R + w[5] * kL;
      bool z = true, eq = true, en = true;
#pragma unroll
      for (int s = 0; s < kL; ++s) {
        z = z && res[s] == 0;
        eq = eq && res[s] == qp[s];
        en = en && res[s] == qn[s];
      }
      f.flags[l * f.flag_r + out_row] = z || eq || en;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void run_program(const Prog& p, const Io& io) {
  extern __shared__ __align__(16) long long smem[];
  const File f = file_of(smem, p, io.tile);
  const unsigned lane0 = blockIdx.x * static_cast<unsigned>(io.tile);
  const int nl = static_cast<int>(min(static_cast<unsigned>(io.tile), io.n - lane0));
  const int tid = threadIdx.x, nt = blockDim.x;
  constexpr int kHalf = kL / 2;

  // constants into every lane's registers; the inputs' rows (cp.async)
  for (int i = tid; i < nl * p.n_const * kHalf; i += nt) {
    const int row = i / kHalf, piece = i - row * kHalf;
    const int l = row / p.n_const, c = row - l * p.n_const;
    reinterpret_cast<longlong2*>(f.regs + l * f.reg_r + p.const_regs[c] * kL)[piece] =
        reinterpret_cast<const longlong2*>(p.consts + c * kL)[piece];
  }
  for (int g = 0; g < 2; ++g) {
    const int rows = p.in_rows[g];
    for (int i = tid; i < nl * rows * kHalf; i += nt) {
      const int row = i / kHalf, piece = i - row * kHalf;
      const int l = row / rows, r = row - l * rows;
      cp_async16(f.regs + l * f.reg_r + p.in_regs[g][r] * kL + 2 * piece,
                 io.in[g] + (static_cast<long long>(lane0 + l) * rows + r) * kL + 2 * piece);
    }
  }
  for (int l = tid; l < nl; l += nt) {
    int* Fl = f.flags + l * f.flag_r;
    if (p.lane_flag >= 0) Fl[p.lane_flag] = io.lane_flags ? io.lane_flags[lane0 + l] != 0 : 0;
    if (p.uniform_flag >= 0) Fl[p.uniform_flag] = p.uniform_val;
  }
  cp_async_wait_all();
  __syncthreads();
  long long* stamp = (io.stamps != nullptr && blockIdx.x == 0 && tid == 0) ? io.stamps : nullptr;
  if (stamp) stamp[0] = clock64();

  for (int b = 0; b < p.n_bundles; ++b) {
    bundle(p, f, b, nl);
    if (stamp) stamp[1 + b] = clock64();
  }

  // the outputs: rows (16 bytes per thread), then the flag
  for (int i = tid; i < nl * p.out_rows * kHalf; i += nt) {
    const int row = i / kHalf, piece = i - row * kHalf;
    const int l = row / p.out_rows, r = row - l * p.out_rows;
    reinterpret_cast<longlong2*>(io.out + (static_cast<long long>(lane0) * p.out_rows) * kL)[i] =
        reinterpret_cast<const longlong2*>(f.regs + l * f.reg_r + p.out_regs[r] * kL)[piece];
  }
  if (p.out_flag >= 0 && io.out_flags != nullptr) {
    for (int l = tid; l < nl; l += nt)
      io.out_flags[lane0 + l] = static_cast<unsigned char>(f.flags[l * f.flag_r + p.out_flag]);
  }
}

__global__ void __launch_bounds__(kThreads) g2_ladder_kernel(Prog p, Io io) {
  run_program(p, io);
}

__global__ void __launch_bounds__(kThreads) miller_grouped_kernel(Prog p, Io io) {
  run_program(p, io);
}

// ---------------------------------------------------------------------------
// Launch configuration
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;
constexpr int kSmemTarget = 96 * 1024;    // lanes per block: about this much

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
  bool ready[2] = {false, false};
};

DeviceInfo g_devices[kMaxDevices];

// The header's fields, in order (ops/fq_points.py::_HEADER).
enum Field {
  kCode, kConsts, kNBundles, kNConst, kNReg, kNFlag, kNX, kNG, kMaxItems,
  kOffBundles, kOffOps, kOffPool, kOffConstRegs, kOffIn0, kOffIn1, kOffOut,
  kInRows0, kInRows1, kOutRows, kLaneFlag, kUniformFlag, kUniformVal, kOutFlag,
  kDigitIdx, kDigitSign, kIn0, kIn1, kLaneFlags, kOut, kOutFlags, kLanes, kStamps,
  kHeaderLen
};

int launch(int which, const long long* h, void* stream) {
  const long long n = h[kLanes];
  if (n <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceInfo& d = g_devices[dev];
  void (*kernel)(Prog, Io) = which == 0 ? g2_ladder_kernel : miller_grouped_kernel;
  if (!d.ready[which]) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem_optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    d.ready[which] = true;
  }
  const int* code = reinterpret_cast<const int*>(h[kCode]);
  Prog p;
  p.bundles = code + h[kOffBundles];
  p.ops = code + h[kOffOps];
  p.pool = code + h[kOffPool];
  p.const_regs = code + h[kOffConstRegs];
  p.in_regs[0] = code + h[kOffIn0];
  p.in_regs[1] = code + h[kOffIn1];
  p.out_regs = code + h[kOffOut];
  p.consts = reinterpret_cast<const long long*>(h[kConsts]);
  p.d_idx = reinterpret_cast<const int*>(h[kDigitIdx]);
  p.d_sign = reinterpret_cast<const int*>(h[kDigitSign]);
  p.n_bundles = static_cast<int>(h[kNBundles]);
  p.n_const = static_cast<int>(h[kNConst]);
  p.nreg = static_cast<int>(h[kNReg]);
  p.nflag = static_cast<int>(h[kNFlag]);
  p.nx = static_cast<int>(h[kNX]);
  p.ng = static_cast<int>(h[kNG]);
  p.in_rows[0] = static_cast<int>(h[kInRows0]);
  p.in_rows[1] = static_cast<int>(h[kInRows1]);
  p.out_rows = static_cast<int>(h[kOutRows]);
  p.lane_flag = static_cast<int>(h[kLaneFlag]);
  p.uniform_flag = static_cast<int>(h[kUniformFlag]);
  p.uniform_val = static_cast<int>(h[kUniformVal]);
  p.out_flag = static_cast<int>(h[kOutFlag]);
  Io io;
  io.in[0] = reinterpret_cast<const long long*>(h[kIn0]);
  io.in[1] = reinterpret_cast<const long long*>(h[kIn1]);
  io.lane_flags = reinterpret_cast<const unsigned char*>(h[kLaneFlags]);
  io.out = reinterpret_cast<long long*>(h[kOut]);
  io.out_flags = reinterpret_cast<unsigned char*>(h[kOutFlags]);
  io.n = static_cast<unsigned>(n);
  io.stamps = reinterpret_cast<long long*>(h[kStamps]);

  const long long per_lane = 8LL * (p.nreg * kL + 2 * p.nx * kL + p.ng * kWPitch) +
                             4LL * ((p.nflag + 3) & ~3);
  if (per_lane > d.smem_optin) return static_cast<int>(cudaErrorInvalidValue);
  long long tile = (n + d.sms - 1) / d.sms;
  const long long fit = kSmemTarget / per_lane > 0 ? kSmemTarget / per_lane : 1;
  if (tile > fit) tile = fit;
  if (tile < 1) tile = 1;
  io.tile = static_cast<int>(tile);
  long long threads = ((h[kMaxItems] * tile + 31) / 32) * 32;
  if (threads < 64) threads = 64;
  if (threads > kThreads) threads = kThreads;
  kernel<<<static_cast<unsigned>((n + tile - 1) / tile), static_cast<unsigned>(threads),
           static_cast<size_t>(per_lane * tile), static_cast<cudaStream_t>(stream)>>>(p, io);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher takes the program's and the call's header (kHeaderLen
// int64s: device pointers and counts, see Field) and returns the
// cudaError_t of its launch (0 on success).
int g2_ladder_launch(const long long* header, void* stream) {
  return launch(0, header, stream);
}

int miller_grouped_launch(const long long* header, void* stream) {
  return launch(1, header, stream);
}

int fq_points_header_len() { return kHeaderLen; }

}  // extern "C"
