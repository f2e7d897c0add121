// BLS12-381 Montgomery arithmetic for Hopper (sm_90a), on the port's lazy
// 29-bit x 14 signed int64 limb layout.
//
//   fq_mul:   [N,14] x [N,14] -> [N,14]   three carry rounds on each
//             input, the 14x14 schoolbook into 28 columns, the 14-step
//             interleaved REDC, three closing carry rounds (and, on
//             request, 17 more: the unique signed-top form)
//   fq_redc:  [N,28] -> [N,14]             the REDC and closing rounds
//   fq_chain: [N,Ca,14] -> [N,Ca,14], a program of tower products (Fq2
//             multiply, Fq12 multiply / square / line multiply,
//             cyclotomic square) on one accumulator, each step's b the
//             accumulator (a square), a fixed base [N,Cb,14] or slice p
//             of an operand [N,S,Cs,14]. A product: for each of P leaves,
//             the alpha and beta pre-sums of the input coefficients,
//             three carry rounds on each, the schoolbook and three wide
//             carry rounds; for each of R outputs, the gamma sum of the
//             leaves' columns, the REDC and the closing rounds. A single
//             tower product (ops/fq_cuda.py::fq_bilinear_cuda) is a
//             program of one step.
//
// Replaces consensus_specs_tpu/ops/fq.py:450 fq_mul and :413 fq_redc;
// fq_chain the coeff-placement tower product of
// consensus_specs_tpu/ops/fq_tower.py:509 _bilinear_wide_cols / :522
// _bilinear (also :130 fq2_mul and :569 fq12_cyclo_sqr) and the two loops
// of nothing but such products in consensus_specs_tpu/ops/bls_jax.py:
// :201 _pow_abs (cyclotomic squarings and multiplies by f, a
// lax.fori_loop) and the Miller step's f-update, :291-310 (one Fq12
// squaring and P line multiplies). XLA programs, no Pallas kernel. Output
// limbs are bit-identical to the plain versions (ops/fq.py, fq_mul_plain,
// fq_redc_plain, fq_bilinear_plain, fq_bilinear_chain_plain): the carry
// rounds sit at the same points and every other step is an exact integer
// sum, whose order does not matter, inside the reference's proven budget.
// Each step of a chain is the same integer computation as one product
// launched alone (norm_in's three rounds on the accumulator, one_col's
// Montgomery one included), so a chain's limbs equal those of the loop of
// single products bit for bit.
//
// What bounds them on this card. Counting products alone, bytes: a lane
// of fq_mul moves 336 bytes for 406 limb products, fq_redc 336 bytes for
// 210, an Fq12 multiply 4,032 bytes for 13,104 (54 schoolbooks of 196 and
// 12 REDCs of 210), and at one 32 x 32 -> 64-bit multiply-add
// (IMAD.WIDE) per product, 64 per clock per SM, the products take less
// time than the bytes at 3.35 TB/s. A chain reads its inputs once and
// writes its output once for all its products, so a chain of more than
// a few steps is bound by its products (the |z| exponentiation, 69
// steps: 594,720 products a lane). fq_mul and fq_redc come close to their
// bound. A tower product also runs its pre-sums, carry rounds and gamma
// sums; on the main path, where a launch covers 16-768 lanes, it is bound
// by the latency of its dependent phases, and before chains by the host's
// cost of one launch per product.
//
// Design:
// - Coalesced staging. A block stages its tile of rows into shared memory
//   with cp.async, 16 bytes per thread where the rows are 16-byte aligned
//   (8 otherwise), neighbouring threads on neighbouring pieces of a row,
//   so contiguous rows are read as one contiguous range. A thread then
//   reads its own row with 16-byte shared loads; row pitches of 14 and 30
//   int64 limbs (28 int32 columns) make those conflict-free (a quarter
//   warp's 8 rows start on distinct 16-byte bank groups). Outputs go back
//   through shared memory and leave as 16-byte coalesced stores.
// - Broadcast without copies. Each operand comes with its own strides
//   over up to four lane axes (0 where it is broadcast), a coefficient
//   stride and a slice stride; the block works out each lane's row offset
//   once.
// - 32-bit arithmetic where the budget allows it. A multiply operand's
//   limbs fit int32 after the first of its three input carry rounds (body
//   in [-2^6, 2^29 + 2^6), top within 2^19 + 2^6), so the other two run
//   in int32 and each schoolbook product is one signed mad.wide.s32 into
//   an int64 column. In the REDC, m < 2^29 comes from a 32-bit multiply
//   (only its low 29 bits count), and m x q_j is one unsigned
//   mad.wide.u32. A leaf's columns fit int32 after two of its three wide
//   rounds (body in [-16, 2^29 + 16], column 27 within 2^10 + 1): the
//   third runs in int32 and the leaves are kept as int32. REDC columns
//   stay int64. tests/test_torch_fq_tower.py proves these ranges from the
//   budget.
// - Chains. A block owns its lanes for the whole program: the accumulator
//   stays in shared memory from step to step, the base and the operand
//   are staged once with it, and only the last step's result goes to
//   device memory. Lanes are independent, so blocks never talk to each
//   other. The program (an int32 code per step: kind | source << 4) is
//   passed by value with the launch.
// - Tables compiled in. The five tower products are Table<K>
//   specializations in csrc/fq_tables.cuh, generated from the port's
//   tables (ops/fq_tables_gen.py): the alpha and beta pre-sums and the
//   gamma sums are straight-line code with immediate coefficients. No
//   table is copied to a block or decoded at run time. A product's code
//   is selected once per step by its kind, which is the same for the
//   whole block, so no warp diverges on it.
// - A product in four phases over the block's tile, all in shared memory,
//   each phase's threads running one code path: (A) one thread per (lane,
//   operand, limb) computes that limb of every leaf's operand (the table's
//   straight-line pre-sum; a-threads and b-threads in separate warps);
//   (B) one thread per (lane, leaf) narrows its two operands, multiplies
//   and normalizes, and stores its 28 int32 columns over its own a row;
//   (C) one thread per (lane, column) sums that column of every output
//   (the gamma code); (D) one thread per (lane, output) reduces and
//   writes the new accumulator coefficient. With `norm_in` the
//   accumulator's rows take three carry rounds first; with `one_col` b's
//   extra row is Montgomery one, kept after the accumulator's rows.
// - Lanes per block: as many as keep one leaf per thread (256 threads) in
//   about 96 KB of shared memory (an Fq12 chain lane needs about 17.8 KB:
//   accumulator and one 1,456 B, base 1,344 B, leaf operands 2 x 6,048 B,
//   gamma sums 2,880 B; so 4 lanes of an Fq12 multiply), and fewer when a
//   launch has fewer lanes than the card has SMs: a chain at the
//   firehose's 128 lanes runs one lane per block on 128 SMs (64 threads),
//   where 16 blocks of 8 lanes would leave 116 SMs idle, because at these
//   lane counts a product's time is the latency of its phases, not the
//   card's throughput.
//
// Signed overflow is undefined in C++, so every intermediate stays inside
// the budget the reference proves (pre-sums of <= 8 inputs with body
// limbs <= 2^32; leaf columns <= 14 x 2^58 before the wide rounds; gamma
// sums < 2^35; REDC columns plus 13 additions < 2^63). `>>` on long long
// is arithmetic under nvcc, which the borrow propagation relies on; the
// left shift of a top carry is a multiply by 2^29, so no negative value is
// shifted left.


#include "fq_arith.cuh"

namespace {

constexpr int kMaxDims = 4;

// Row (lane, s, c) of an operand starts at
// ptr + sum_d index_d(lane) * stride[d] + s * sstride + c * cstride; its
// limbs are contiguous. vec16: every row start is 16-byte aligned.
struct Operand {
  const long long* ptr;
  long long stride[kMaxDims];
  long long cstride;
  long long sstride;
  int vec16;
};

// The lanes, row-major over size[0 .. ndim-1] (the last axis fastest).
struct Lanes {
  unsigned size[kMaxDims];
  int ndim;
};

// layout[] (1 + 4 + 3 x 6 + 3 int64s): ndim, size[4], then per operand
// stride[4], cstride, vec16, then the three operands' slice strides.
constexpr int kOperandLen = kMaxDims + 2;
constexpr int kSliceAt = 1 + kMaxDims + 3 * kOperandLen;

Lanes parse_lanes(const long long* layout) {
  Lanes ln;
  ln.ndim = static_cast<int>(layout[0]);
  for (int d = 0; d < kMaxDims; ++d) ln.size[d] = static_cast<unsigned>(layout[1 + d]);
  return ln;
}

Operand parse_operand(const long long* layout, int k, const void* ptr) {
  const long long* p = layout + 1 + kMaxDims + k * kOperandLen;
  Operand op;
  op.ptr = static_cast<const long long*>(ptr);
  for (int d = 0; d < kMaxDims; ++d) op.stride[d] = p[d];
  op.cstride = p[kMaxDims];
  op.vec16 = static_cast<int>(p[kMaxDims + 1]);
  op.sstride = layout[kSliceAt + k];
  return op;
}

__device__ __forceinline__ long long lane_offset(const Lanes& ln,
                                                 const Operand& op,
                                                 unsigned lane) {
  long long off = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d >= 0; --d) {
    if (d < ln.ndim) {
      const unsigned s = ln.size[d];
      const unsigned q = lane / s;
      off += static_cast<long long>(lane - q * s) * op.stride[d];
      lane = q;
    }
  }
  return off;
}

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

// Block-cooperative copy of rows (l, s, c), l < nl, s < S, c < C, of W
// limbs each into dst row l * rows_per_lane + s * C + c (pitch limbs
// apart). off[l] is lane l's row offset. Completes at cp_async_wait_all().
template <int W>
__device__ __forceinline__ void stage_rows(long long* dst, int pitch,
                                           int rows_per_lane, const Operand& op,
                                           const long long* off, int nl, int S,
                                           int C) {
  const int SC = S * C;
  if (op.vec16) {
    constexpr int kPieces = W / 2;
    const int n = nl * SC * kPieces;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / kPieces, piece = i - row * kPieces;
      const int l = row / SC, sc = row - l * SC, s = sc / C, c = sc - s * C;
      cp_async16(dst + (l * rows_per_lane + sc) * pitch + 2 * piece,
                 op.ptr + off[l] + s * op.sstride + c * op.cstride + 2 * piece);
    }
  } else {
    const int n = nl * SC * W;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / W, k = i - row * W;
      const int l = row / SC, sc = row - l * SC, s = sc / C, c = sc - s * C;
      cp_async8(dst + (l * rows_per_lane + sc) * pitch + k,
                op.ptr + off[l] + s * op.sstride + c * op.cstride + k);
    }
  }
}


// n limbs (even) of a contiguous output tile from shared to global
// memory, 16 bytes per thread, neighbouring threads on neighbouring
// addresses.
__device__ __forceinline__ void copy_out(long long* dst, const long long* src,
                                         int n) {
  const longlong2* s = reinterpret_cast<const longlong2*>(src);
  longlong2* d = reinterpret_cast<longlong2*>(dst);
  for (int i = threadIdx.x; i < n / 2; i += blockDim.x) d[i] = s[i];
}


// ---------------------------------------------------------------------------
// fq_mul, fq_redc
// ---------------------------------------------------------------------------

constexpr int kMulTile = 128;
constexpr int kRedcTile = 128;

constexpr int kNormFull = kL + 3;     // rounds to the unique signed-top form

__global__ void __launch_bounds__(kMulTile)
fq_mul_kernel(Operand a, Operand b, long long* __restrict__ out, Lanes lanes,
              unsigned n, int norm_full) {
  __shared__ __align__(16) long long sa[kMulTile * kL];
  __shared__ __align__(16) long long sb[kMulTile * kL];
  __shared__ long long offa[kMulTile], offb[kMulTile];
  const unsigned lane0 = blockIdx.x * kMulTile;
  const int nl = static_cast<int>(min(static_cast<unsigned>(kMulTile), n - lane0));
  const int t = threadIdx.x;
  if (t < nl) {
    offa[t] = lane_offset(lanes, a, lane0 + t);
    offb[t] = lane_offset(lanes, b, lane0 + t);
  }
  __syncthreads();
  stage_rows<kL>(sa, kL, 1, a, offa, nl, 1, 1);
  stage_rows<kL>(sb, kL, 1, b, offb, nl, 1, 1);
  cp_async_wait_all();
  __syncthreads();
  if (t < nl) {
    long long x[kL], y[kL];
    load_row(sa + t * kL, x);
    load_row(sb + t * kL, y);
    int x32[kL], y32[kL];
    narrow32(x, x32);
    narrow32(y, y32);
    long long c[kW];
    schoolbook(x32, y32, c);
    long long r[kL];
    redc(c, r);
    if (norm_full) {
#pragma unroll 1
      for (int k = 0; k < kNormFull; ++k) carry_round(r);
    }
    store_row(sa + t * kL, r);     // the thread's own row: no other reader
  }
  __syncthreads();
  copy_out(out + static_cast<long long>(lane0) * kL, sa, nl * kL);
}

__global__ void __launch_bounds__(kRedcTile)
fq_redc_kernel(Operand cols, long long* __restrict__ out, Lanes lanes,
               unsigned n) {
  __shared__ __align__(16) long long sc[kRedcTile * kWPitch];
  __shared__ __align__(16) long long so[kRedcTile * kL];
  __shared__ long long off[kRedcTile];
  const unsigned lane0 = blockIdx.x * kRedcTile;
  const int nl = static_cast<int>(min(static_cast<unsigned>(kRedcTile), n - lane0));
  const int t = threadIdx.x;
  if (t < nl) off[t] = lane_offset(lanes, cols, lane0 + t);
  __syncthreads();
  stage_rows<kW>(sc, kWPitch, 1, cols, off, nl, 1, 1);
  cp_async_wait_all();
  __syncthreads();
  if (t < nl) {
    long long c[kW];
    load_row(sc + t * kWPitch, c);
    long long r[kL];
    redc(c, r);
    store_row(so + t * kL, r);
  }
  __syncthreads();
  copy_out(out + static_cast<long long>(lane0) * kL, so, nl * kL);
}

// ---------------------------------------------------------------------------
// fq_chain: a program of tower products on one accumulator
// ---------------------------------------------------------------------------

constexpr int kChainThreads = 256;
constexpr int kMaxSteps = 128;
constexpr int kKindBits = 4;          // a step's code: kind | source << 4
constexpr int kSrcAcc = 0, kSrcBase = 1, kSrcOperand = 2;
constexpr int kPhases = 4;            // clock stamps per step (A, B, C, D)

// What the kernel needs of a kind at run time (the rest is in its code).
struct KindInfo {
  int P, R, Ca, Cb;
  bool one_col, norm_in;
};

static_assert(kNumKinds == 5, "the kind lists below name kinds 0 .. 4");
#define FQ_INFO(K)                                                       \
  {Table<K>::P, Table<K>::R, Table<K>::Ca, Table<K>::Cb, Table<K>::one_col, \
   Table<K>::norm_in}
#define FQ_KIND_INFO {FQ_INFO(0), FQ_INFO(1), FQ_INFO(2), FQ_INFO(3), FQ_INFO(4)}
__constant__ KindInfo kKinds[kNumKinds] = FQ_KIND_INFO;
constexpr KindInfo kKindsHost[kNumKinds] = FQ_KIND_INFO;

struct Chain {
  int n_steps;
  int Ca;          // the accumulator's coefficients (every step's Ca and R)
  int Cb;          // the base's rows (0: no base)
  int S, Cs;       // the operand's slices and rows per slice (0: no operand)
  int P;           // the most leaves of any step
  int tile;        // lanes per block
  int step[kMaxSteps];
};

// A block's shared memory, per lane: the accumulator's Ca rows and
// Montgomery one; the base's Cb rows; the operand's S x Cs rows; the
// leaves' a and b operands (P rows each; after phase B the a rows hold the
// leaves' int32 columns); the gamma sums (Ca rows of kWPitch); then the
// three operands' lane offsets.
struct Regions {
  long long *acc, *base, *opr, *x, *y, *gsum, *off;
  int acc_r, base_r, opr_r, x_r;      // int64s per lane
};

__device__ __forceinline__ Regions regions(long long* smem, const Chain& ch) {
  Regions g;
  g.acc_r = (ch.Ca + 1) * kL;
  g.base_r = ch.Cb * kL;
  g.opr_r = ch.S * ch.Cs * kL;
  g.x_r = ch.P * kL;
  g.acc = smem;
  g.base = g.acc + ch.tile * g.acc_r;
  g.opr = g.base + ch.tile * g.base_r;
  g.x = g.opr + ch.tile * g.opr_r;
  g.y = g.x + ch.tile * g.x_r;
  g.gsum = g.y + ch.tile * g.x_r;
  g.off = g.gsum + ch.tile * ch.Ca * kWPitch;
  return g;
}

__device__ __forceinline__ void phase_end(long long* stamp) {
  __syncthreads();
  if (stamp) *stamp = clock64();
}

// Phase A: limb t of every leaf's a and b operand for each lane, one
// thread per (lane, operand, limb); a-threads and b-threads start at
// warp boundaries, so no warp runs both codes.
template <class T>
__device__ __forceinline__ void presums(const Regions& g, const Chain& ch,
                                        int src, int nl) {
  const int items = nl * kL;
  const int padded = (items + 31) & ~31;
  for (int i = threadIdx.x; i < 2 * padded; i += blockDim.x) {
    const bool is_b = i >= padded;
    const int j = is_b ? i - padded : i;
    if (j >= items) continue;
    const int l = j / kL, t = j - l * kL;
    if (!is_b) {
      T::alpha(g.acc + l * g.acc_r + t, g.x + l * g.x_r + t);
    } else {
      const long long* b =
          src == kSrcAcc    ? g.acc + l * g.acc_r
          : src == kSrcBase ? g.base + l * g.base_r
                            : g.opr + l * g.opr_r + (src - kSrcOperand) * ch.Cs * kL;
      T::beta(b + t, g.y + l * g.x_r + t);
    }
  }
}

// Phase C: column j of every output's gamma sum, one thread per (lane,
// column).
template <class T>
__device__ __forceinline__ void gammas(const Regions& g, const Chain& ch, int nl) {
  const int* leaves = reinterpret_cast<const int*>(g.x);
  for (int i = threadIdx.x; i < nl * kW; i += blockDim.x) {
    const int l = i / kW, j = i - l * kW;
    T::gamma(leaves + 2 * l * g.x_r + j, g.gsum + l * ch.Ca * kWPitch + j);
  }
}

// fn<Table<kind>> args, kind uniform over the block.
#define FQ_BY_KIND(kind, fn, args)           \
  switch (kind) {                            \
    case 0: fn<Table<0>> args; break;        \
    case 1: fn<Table<1>> args; break;        \
    case 2: fn<Table<2>> args; break;        \
    case 3: fn<Table<3>> args; break;        \
    default: fn<Table<4>> args; break;       \
  }

__global__ void __launch_bounds__(kChainThreads)
fq_chain_kernel(Operand a, Operand b, Operand o, long long* __restrict__ out,
                Lanes lanes, unsigned n, Chain ch, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) long long smem[];
  const Regions g = regions(smem, ch);
  const unsigned lane0 = blockIdx.x * static_cast<unsigned>(ch.tile);
  const int nl = static_cast<int>(min(static_cast<unsigned>(ch.tile), n - lane0));
  const int tid = threadIdx.x, nt = blockDim.x;
  long long* offa = g.off;
  long long* offb = offa + ch.tile;
  long long* offo = offb + ch.tile;

  for (int l = tid; l < nl; l += nt) {
    offa[l] = lane_offset(lanes, a, lane0 + l);
    if (ch.Cb) offb[l] = lane_offset(lanes, b, lane0 + l);
    if (ch.S) offo[l] = lane_offset(lanes, o, lane0 + l);
  }
  __syncthreads();
  stage_rows<kL>(g.acc, kL, ch.Ca + 1, a, offa, nl, 1, ch.Ca);
  if (ch.Cb) stage_rows<kL>(g.base, kL, ch.Cb, b, offb, nl, 1, ch.Cb);
  if (ch.S) stage_rows<kL>(g.opr, kL, ch.S * ch.Cs, o, offo, nl, ch.S, ch.Cs);
  for (int i = tid; i < nl * kL; i += nt) {      // b's one_col row
    const int l = i / kL, k = i - l * kL;
    g.acc[l * g.acc_r + ch.Ca * kL + k] = kOneMont[k];
  }
  cp_async_wait_all();
  long long* stamp = (stamps != nullptr && blockIdx.x == 0 && tid == 0) ? stamps : nullptr;
  phase_end(stamp);

  for (int s = 0; s < ch.n_steps; ++s) {
    const int code = ch.step[s];
    const int kind = code & ((1 << kKindBits) - 1), src = code >> kKindBits;
    const KindInfo kd = kKinds[kind];
    long long* st = stamp ? stamp + 1 + s * kPhases : nullptr;
    if (kd.norm_in) {         // three carry rounds on the accumulator's rows
      for (int i = tid; i < nl * ch.Ca; i += nt) {
        const int l = i / ch.Ca, c = i - l * ch.Ca;
        long long* row = g.acc + l * g.acc_r + c * kL;
        long long x[kL];
        load_row(row, x);
        carry_rounds(x);
        store_row(row, x);
      }
      __syncthreads();
    }
    FQ_BY_KIND(kind, presums, (g, ch, src, nl))
    phase_end(st ? st + 0 : nullptr);

    // Phase B: one thread per (lane, leaf); the leaf's columns replace
    // its own a row, which no other thread reads
    for (int i = tid; i < nl * kd.P; i += nt) {
      const int l = i / kd.P, k = i - l * kd.P;
      long long* xr = g.x + l * g.x_r + k * kL;
      long long x[kL], y[kL];
      load_row(xr, x);
      load_row(g.y + l * g.x_r + k * kL, y);
      int x32[kL], y32[kL];
      narrow32(x, x32);
      narrow32(y, y32);
      long long c[kW];
      schoolbook(x32, y32, c);
      int w[kW];
      wide_norm32(c, w);
      int4* dst = reinterpret_cast<int4*>(xr);
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
        dst[q] = make_int4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
    phase_end(st ? st + 1 : nullptr);

    FQ_BY_KIND(kind, gammas, (g, ch, nl))
    phase_end(st ? st + 2 : nullptr);

    // Phase D: one thread per (lane, output) reduces into the accumulator
    for (int i = tid; i < nl * kd.R; i += nt) {
      const int l = i / kd.R, r = i - l * kd.R;
      long long c[kW];
      load_row(g.gsum + (l * ch.Ca + r) * kWPitch, c);
      long long res[kL];
      redc(c, res);
      store_row(g.acc + l * g.acc_r + r * kL, res);
    }
    phase_end(st ? st + 3 : nullptr);
  }

  // the accumulator's Ca rows of each lane, 16 bytes per thread
  longlong2* dst = reinterpret_cast<longlong2*>(out + static_cast<long long>(lane0) * ch.Ca * kL);
  constexpr int kHalf = kL / 2;
  for (int i = tid; i < nl * ch.Ca * kHalf; i += nt) {
    const int row = i / kHalf, piece = i - row * kHalf;
    const int l = row / ch.Ca, c = row - l * ch.Ca;
    dst[i] = reinterpret_cast<const longlong2*>(g.acc + l * g.acc_r + c * kL)[piece];
  }
}

__global__ void fq_empty_kernel() {}

// ---------------------------------------------------------------------------
// Launch configuration
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;
constexpr int kChainSmemTarget = 96 * 1024;   // lanes per block: about this much
constexpr int kChainSmemLimit = 200 * 1024;   // the opt-in ceiling asked for
constexpr int kChainMaxTile = 64;

struct DeviceInfo {
  int sms = 0;
  bool smem_opt_in = false;
};

DeviceInfo g_devices[kMaxDevices];

// The device's SM count, with fq_chain_kernel's dynamic shared memory
// ceiling raised once. Returns a cudaError_t.
int device_info(DeviceInfo** info) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceInfo& d = g_devices[dev];
  if (!d.smem_opt_in) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(fq_chain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kChainSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    d.smem_opt_in = true;
  }
  *info = &d;
  return 0;
}

inline unsigned blocks_for(long long n, int tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

inline int round32(int x) { return (x + 31) & ~31; }

// Checks the program against the operands' shapes and sets ch.P; false
// where a step cannot run.
bool check_program(Chain& ch, const int* program) {
  ch.P = 0;
  for (int s = 0; s < ch.n_steps; ++s) {
    const int code = program[s];
    const int kind = code & ((1 << kKindBits) - 1), src = code >> kKindBits;
    if (code < 0 || kind >= kNumKinds) return false;
    const KindInfo& k = kKindsHost[kind];
    if (k.Ca != ch.Ca || k.R != ch.Ca) return false;
    if (src == kSrcAcc) {
      if (k.Cb != ch.Ca) return false;
    } else if (k.one_col || k.norm_in) {
      return false;
    } else if (src == kSrcBase) {
      if (k.Cb != ch.Cb) return false;
    } else if (src - kSrcOperand >= ch.S || k.Cb != ch.Cs) {
      return false;
    }
    ch.step[s] = code;
    if (k.P > ch.P) ch.P = k.P;
  }
  return true;
}

}  // namespace

extern "C" {

// Every launcher returns the cudaError_t of its launch (0 on success).
// n: lanes (< 2^31); layout: 26 int64s (see parse_lanes / parse_operand),
// operands in the launcher's order; out: n contiguous output rows,
// 16-byte aligned.

// norm_full: NORM_FULL (17) more carry rounds after the closing ones, the
// unique signed-top limbs that Field.is_zero and canon compare.
int fq_mul_launch(const void* a, const void* b, void* out, long long n,
                  const long long* layout, int norm_full, void* stream) {
  if (n <= 0) return 0;
  fq_mul_kernel<<<blocks_for(n, kMulTile), kMulTile, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      parse_operand(layout, 0, a), parse_operand(layout, 1, b),
      static_cast<long long*>(out), parse_lanes(layout),
      static_cast<unsigned>(n), norm_full);
  return static_cast<int>(cudaGetLastError());
}

int fq_redc_launch(const void* cols, void* out, long long n,
                   const long long* layout, void* stream) {
  if (n <= 0) return 0;
  fq_redc_kernel<<<blocks_for(n, kRedcTile), kRedcTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      parse_operand(layout, 0, cols), static_cast<long long*>(out),
      parse_lanes(layout), static_cast<unsigned>(n));
  return static_cast<int>(cudaGetLastError());
}

// A chain: acc [n, Ca, 14] (operand 0), base [n, Cb, 14] (operand 1, or
// null with Cb = 0), operand [n, S, Cs, 14] (operand 2, or null with
// S = 0); program: n_steps int32 codes (kind | source << 4); dims: Ca,
// Cb, S, Cs; out: [n, Ca, 14]. stamps: null, or room for
// 1 + 4 x n_steps int64s: block 0's clock64() at the start and after
// each phase of each step.
int fq_chain_launch(const void* acc, const void* base, const void* operand,
                    void* out, long long n, const long long* layout,
                    const int* program, int n_steps, const int* dims,
                    void* stamps, void* stream) {
  if (n <= 0) return 0;
  if (n_steps < 1 || n_steps > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo* info = nullptr;
  const int err = device_info(&info);
  if (err != 0) return err;
  Chain ch;
  ch.n_steps = n_steps;
  ch.Ca = dims[0];
  ch.Cb = dims[1];
  ch.S = dims[2];
  ch.Cs = dims[3];
  if (ch.Ca < 1 || ch.Cb < 0 || ch.S < 0 || ch.Cs < 0 || (ch.Cb && !base) ||
      (ch.S && (!operand || ch.Cs < 1)) || !check_program(ch, program))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!ch.S) ch.Cs = 0;
  const long long per_lane =
      8LL * ((ch.Ca + 1) * kL + ch.Cb * kL + ch.S * ch.Cs * kL + 2 * ch.P * kL +
             ch.Ca * kWPitch + 3);
  // one leaf per thread, about kChainSmemTarget of shared memory, and for
  // small launches at least one block per SM
  long long tile = kChainThreads / ch.P;
  if (kChainSmemTarget / per_lane < tile) tile = kChainSmemTarget / per_lane;
  if (tile > kChainMaxTile) tile = kChainMaxTile;
  const long long spread = (n + info->sms - 1) / info->sms;
  if (spread < tile) tile = spread;
  if (tile < 1) tile = 1;
  ch.tile = static_cast<int>(tile);
  const long long smem = per_lane * tile;
  if (smem > kChainSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int threads = 2 * round32(ch.tile * kL);
  const int most = ch.tile * (ch.P > kW ? ch.P : kW);
  if (most > threads) threads = most;
  threads = round32(threads);
  if (threads > kChainThreads) threads = kChainThreads;
  fq_chain_kernel<<<blocks_for(n, ch.tile), threads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      parse_operand(layout, 0, acc), parse_operand(layout, 1, base),
      parse_operand(layout, 2, operand), static_cast<long long*>(out),
      parse_lanes(layout), static_cast<unsigned>(n), ch,
      static_cast<long long*>(stamps));
  return static_cast<int>(cudaGetLastError());
}

// The floor of a launch on this stream: an empty kernel, one warp.
int fq_empty_launch(void* stream) {
  fq_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
