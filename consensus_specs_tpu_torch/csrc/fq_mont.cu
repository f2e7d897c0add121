// BLS12-381 Montgomery arithmetic for Hopper (sm_90a), on the port's lazy
// 29-bit x 14 signed int64 limb layout.
//
//   fq_mul:      [N,14] x [N,14] -> [N,14]   three carry rounds on each
//                input, the 14x14 schoolbook into 28 columns, the 14-step
//                interleaved REDC, three closing carry rounds (and, on
//                request, 17 more: the unique signed-top form)
//   fq_redc:     [N,28] -> [N,14]             the REDC and closing rounds
//   fq_bilinear: [N,Ca,14] x [N,Cb,14] -> [N,R,14], one tower product
//                (Fq2 multiply, Fq12 multiply / square / line multiply,
//                cyclotomic square): for each of P leaves, the alpha and
//                beta pre-sums of the input coefficients, three carry
//                rounds on each, the schoolbook and three wide carry
//                rounds; for each of R outputs, the gamma sum of the
//                leaves' columns, the REDC and the closing rounds
//
// Replaces consensus_specs_tpu/ops/fq.py:450 fq_mul and :413 fq_redc, and
// for fq_bilinear the coeff-placement tower product of
// consensus_specs_tpu/ops/fq_tower.py:509 _bilinear_wide_cols / :522
// _bilinear (also :130 fq2_mul and :569 fq12_cyclo_sqr): XLA programs, no
// Pallas kernel. In eager PyTorch one tower product was a REDC launch
// behind some 145-430 small torch ops (pre-sums, carry rounds, the skewed
// outer product, gathers); it is one launch here. Output limbs are
// bit-identical to the plain versions (ops/fq.py, fq_mul_plain,
// fq_redc_plain, fq_bilinear_plain): the carry rounds sit at the same
// points and every other step is an exact integer sum, whose order does
// not matter, inside the reference's proven budget.
//
// What bounds them on this card. Counting products alone, bytes: a lane
// of fq_mul moves 336 bytes for 406 limb products, fq_redc 336 bytes for
// 210, an Fq12 multiply 4,032 bytes for 13,104 (54 schoolbooks of 196 and
// 12 REDCs of 210), and at one 32 x 32 -> 64-bit multiply-add
// (IMAD.WIDE) per product, 64 per clock per SM, the products take less
// time than the bytes at 3.35 TB/s. fq_mul and fq_redc come close to that
// bound. fq_bilinear also runs its pre-sums, carry rounds and gamma sums,
// several times the instructions of its products, so at large lane counts
// it is bound by instruction issue, and on the main path, where a launch
// covers 16-64 lanes, by the latency of its three dependent phases.
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
//   over up to four lane axes (0 where it is broadcast) and a
//   coefficient stride; the block works out each lane's row offset once.
// - 32-bit arithmetic where the budget allows it. A multiply operand's
//   limbs fit int32 after the first of its three input carry rounds (body
//   in [-2^6, 2^29 + 2^6), top within 2^19 + 2^6), so the other two run
//   in int32 and each schoolbook product is one signed mad.wide.s32 into
//   an int64 column. In the REDC, m < 2^29 comes from a 32-bit multiply
//   (only its low 29 bits count), and m x q_j is one unsigned
//   mad.wide.u32. A leaf's columns fit int32 after two of its three wide
//   rounds (body in [-16, 2^29 + 16], column 27 within 2^10 + 1): the
//   third runs in int32, the leaves are kept as int32, and each gamma
//   term is one mad.wide.s32. REDC columns stay int64.
//   tests/test_torch_fq_tower.py proves these ranges from the budget.
// - fq_bilinear in three phases over a tile of lanes, all in shared
//   memory: one thread per (lane, leaf) builds its two operands from the
//   staged coefficients and the alpha / beta rows, multiplies and
//   normalizes, and stores 28 leaf columns; one thread per (lane, output,
//   4 columns) sums its gamma row, reading the leaves 16 bytes at a time;
//   one thread per (lane, output) reduces. A block takes as many lanes
//   as keep one leaf per thread (256 threads) in about 96 KB of shared
//   memory, and fewer when a launch has fewer lanes than the card has
//   SMs. So a launch of 16 lanes of an Fq12 multiply runs 864 leaf
//   threads where a lane-per-thread kernel would run 16. The tables (CSR rows of
//   (coefficient << 16 | column) entries) are uploaded once per device
//   and copied into shared memory by each block. With `norm_in` the
//   staged input coefficients take three carry rounds first; with
//   `one_col` b gets Montgomery one as an extra coefficient (the
//   cyclotomic square's passthrough).
//
// Signed overflow is undefined in C++, so every intermediate stays inside
// the budget the reference proves (pre-sums of <= 8 inputs with body
// limbs <= 2^32; leaf columns <= 14 x 2^58 before the wide rounds; gamma
// sums < 2^35; REDC columns plus 13 additions < 2^63). `>>` on long long
// is arithmetic under nvcc, which the borrow propagation relies on; the
// left shift of a top carry is a multiply by 2^29, so no negative value is
// shifted left.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 29;
constexpr int kL = 14;
constexpr int kW = 2 * kL;            // wide columns
constexpr int kWPitch = kW + 2;       // shared-memory pitch of a wide row
constexpr int kQuads = kW / 4;        // a leaf row as int4s
constexpr long long kMask = (1LL << kB) - 1;
constexpr long long kRadix = 1LL << kB;
constexpr long long kQinvNeg = 0x1ffcfffdLL;   // -q^{-1} mod 2^29

// q in 29-bit limbs, least significant first.
__constant__ long long kQ[kL] = {
    0x1fffaaabLL, 0x0ff7ffffLL, 0x14ffffeeLL, 0x17fffd62LL, 0x0f6241eaLL,
    0x09507b58LL, 0x0afd9cc3LL, 0x109e70a2LL, 0x1764774bLL, 0x121a5d66LL,
    0x12c6e9edLL, 0x12ffcd34LL, 0x00111ea3LL, 0x0000000dLL};

constexpr int kMaxDims = 4;

// Row (lane, c) of an operand starts at
// ptr + sum_d index_d(lane) * stride[d] + c * cstride; its limbs are
// contiguous. vec16: every row start is 16-byte aligned.
struct Operand {
  const long long* ptr;
  long long stride[kMaxDims];
  long long cstride;
  int vec16;
};

// The lanes, row-major over size[0 .. ndim-1] (the last axis fastest).
struct Lanes {
  unsigned size[kMaxDims];
  int ndim;
};

// A tower product's shape, and the lanes a block takes.
struct Shape {
  int P, R, Ca, Cb;     // leaves, outputs, a's and b's own coefficients
  int one_col, norm_in;
  int table_len;        // int32 entries of the packed tables
  int tile;             // lanes per block
};

// layout[] (1 + 4 + 2 x 6 int64s): ndim, size[4], then per operand
// stride[4], cstride, vec16.

Lanes parse_lanes(const long long* layout) {
  Lanes ln;
  ln.ndim = static_cast<int>(layout[0]);
  for (int d = 0; d < kMaxDims; ++d) ln.size[d] = static_cast<unsigned>(layout[1 + d]);
  return ln;
}

Operand parse_operand(const long long* layout, int k, const void* ptr) {
  const long long* p = layout + 1 + kMaxDims + k * (kMaxDims + 2);
  Operand op;
  op.ptr = static_cast<const long long*>(ptr);
  for (int d = 0; d < kMaxDims; ++d) op.stride[d] = p[d];
  op.cstride = p[kMaxDims];
  op.vec16 = static_cast<int>(p[kMaxDims + 1]);
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block-cooperative copy of rows (l, c), l < nl, c < C, of W limbs each
// into dst row l * rows_per_lane + c (pitch limbs apart). off[l] is lane
// l's row offset. Completes at cp_async_wait_all().
template <int W>
__device__ __forceinline__ void stage_rows(long long* dst, int pitch,
                                           int rows_per_lane, const Operand& op,
                                           const long long* off, int nl, int C) {
  if (op.vec16) {
    constexpr int kPieces = W / 2;
    const int n = nl * C * kPieces;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / kPieces, piece = i - row * kPieces;
      const int l = row / C, c = row - l * C;
      cp_async16(dst + (l * rows_per_lane + c) * pitch + 2 * piece,
                 op.ptr + off[l] + c * op.cstride + 2 * piece);
    }
  } else {
    const int n = nl * C * W;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / W, k = i - row * W;
      const int l = row / C, c = row - l * C;
      cp_async8(dst + (l * rows_per_lane + c) * pitch + k,
                op.ptr + off[l] + c * op.cstride + k);
    }
  }
}

// A thread's own row from / to shared memory, 16 bytes at a time (the row
// must start 16-byte aligned).
template <int W>
__device__ __forceinline__ void load_row(const long long* s, long long (&x)[W]) {
  const longlong2* v = reinterpret_cast<const longlong2*>(s);
#pragma unroll
  for (int k = 0; k < W / 2; ++k) {
    const longlong2 p = v[k];
    x[2 * k] = p.x;
    x[2 * k + 1] = p.y;
  }
}

template <int W>
__device__ __forceinline__ void store_row(long long* s, const long long (&x)[W]) {
  longlong2* v = reinterpret_cast<longlong2*>(s);
#pragma unroll
  for (int k = 0; k < W / 2; ++k) v[k] = make_longlong2(x[2 * k], x[2 * k + 1]);
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
// Arithmetic
// ---------------------------------------------------------------------------

// One value-preserving carry round over N limbs (T = long long or int):
// lo = t & MASK, hi = t >> 29 (arithmetic), t = lo + hi shifted up one
// limb, the top limb keeping its own overflow.
template <typename T, int N>
__device__ __forceinline__ void carry_round(T (&t)[N]) {
  T hi[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    hi[k] = t[k] >> kB;
    t[k] &= static_cast<T>(kMask);
  }
#pragma unroll
  for (int k = 1; k < N; ++k) t[k] += hi[k - 1];
  t[N - 1] += hi[N - 1] * static_cast<T>(kRadix);
}

template <int N>
__device__ __forceinline__ void carry_rounds(long long (&t)[N]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) carry_round(t);
}

template <int N>
__device__ __forceinline__ void to_int32(const long long (&t)[N], int (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = static_cast<int>(t[k]);
}

__device__ __forceinline__ long long mad_wide_s32(int a, int b, long long c) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

__device__ __forceinline__ long long mad_wide_u32(unsigned a, unsigned b,
                                                  long long c) {
  long long d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// The three input carry rounds of a multiply operand, as int32 limbs.
// Inputs have |body| <= 2^35 (a pre-sum of <= 8 budget inputs) and
// |top| <= 2^19, so after the first round, in int64, every limb fits
// int32 (body in [-2^6, 2^29 + 2^6), top within 2^19 + 2^6) and the
// other two rounds run in int32 on the same integers.
__device__ __forceinline__ void narrow32(long long (&t)[kL], int (&x)[kL]) {
  carry_round(t);
  to_int32(t, x);
  carry_round(x);
  carry_round(x);
}

// fq_wide_norm of raw schoolbook columns (|col| <= 14 x 2^58, column 27
// zero), as int32: two rounds in int64 leave the body in [-16, 2^29 + 16]
// and column 27 within 2^10 + 1, and the third runs in int32.
__device__ __forceinline__ void wide_norm32(long long (&c)[kW], int (&w)[kW]) {
  carry_round(c);
  carry_round(c);
  to_int32(c, w);
  carry_round(w);
}

__device__ __forceinline__ void schoolbook(const int (&x)[kL], const int (&y)[kL],
                                           long long (&c)[kW]) {
#pragma unroll
  for (int k = 0; k < kW; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
#pragma unroll
    for (int j = 0; j < kL; ++j) c[i + j] = mad_wide_s32(x[i], y[j], c[i + j]);
  }
}

// cols[0..27] -> out[0..13]: the interleaved reduction and closing rounds.
__device__ __forceinline__ void redc(long long (&c)[kW], long long (&out)[kL]) {
  long long carry = 0;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const long long v = c[i] + carry;
    // the low 29 bits of (v mod 2^29) * (-q^-1): a 32-bit product will do
    const unsigned m = (static_cast<unsigned>(v) * static_cast<unsigned>(kQinvNeg)) &
                       static_cast<unsigned>(kMask);
    carry = mad_wide_u32(m, static_cast<unsigned>(kQ[0]), v) >> kB;
#pragma unroll
    for (int j = 1; j < kL; ++j)
      c[i + j] = mad_wide_u32(m, static_cast<unsigned>(kQ[j]), c[i + j]);
  }
#pragma unroll
  for (int k = 0; k < kL; ++k) out[k] = c[kL + k];
  out[0] += carry;
  carry_rounds(out);
}

// x = sum over CSR entries [e0, e1) of coefficient * rows[column].
__device__ __forceinline__ void presum(const int* tab, int e0, int e1,
                                       const long long* rows, long long (&x)[kL]) {
#pragma unroll
  for (int k = 0; k < kL; ++k) x[k] = 0;
  for (int e = e0; e < e1; ++e) {
    const int ent = tab[e];
    const long long coef = ent >> 16;
    const long long* r = rows + (ent & 0xffff) * kL;
#pragma unroll
    for (int k = 0; k < kL; ++k) x[k] += coef * r[k];
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

constexpr int kMulTile = 128;
constexpr int kRedcTile = 128;
constexpr int kBiThreads = 256;

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
  stage_rows<kL>(sa, kL, 1, a, offa, nl, 1);
  stage_rows<kL>(sb, kL, 1, b, offb, nl, 1);
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
  stage_rows<kW>(sc, kWPitch, 1, cols, off, nl, 1);
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

__global__ void __launch_bounds__(kBiThreads)
fq_bilinear_kernel(Operand a, Operand b, const long long* __restrict__ one,
                   const int* __restrict__ table, long long* __restrict__ out,
                   Lanes lanes, unsigned n, Shape sh) {
  extern __shared__ __align__(16) long long smem[];
  const int P = sh.P, R = sh.R, Ca = sh.Ca, Cb = sh.Cb;
  const int CbS = Cb + sh.one_col;            // b's staged rows per lane
  const int tile = sh.tile;
  // every region a multiple of 16 bytes long: 14 and kWPitch are even
  long long* xa = smem;                                  // [tile][Ca][14]
  long long* xb = xa + tile * Ca * kL;                   // [tile][CbS][14]
  long long* gsum = xb + tile * CbS * kL;                // [tile][R][kWPitch]
  long long* offa = gsum + tile * R * kWPitch;           // [tile]
  long long* offb = offa + tile;                         // [tile]
  int* leaves = reinterpret_cast<int*>(offb + tile);     // [tile][P][28]
  int* tab = leaves + tile * P * kW;                     // [table_len]
  const int* a_start = tab;                              // alpha rows, P + 1
  const int* b_start = tab + P + 1;                      // beta rows, P + 1
  const int* g_start = tab + 2 * (P + 1);                // gamma rows, R + 1

  const unsigned lane0 = blockIdx.x * static_cast<unsigned>(tile);
  const int nl = static_cast<int>(min(static_cast<unsigned>(tile), n - lane0));
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < sh.table_len; i += nt) tab[i] = table[i];
  for (int l = tid; l < nl; l += nt) {
    offa[l] = lane_offset(lanes, a, lane0 + l);
    offb[l] = lane_offset(lanes, b, lane0 + l);
  }
  __syncthreads();
  stage_rows<kL>(xa, kL, Ca, a, offa, nl, Ca);
  stage_rows<kL>(xb, kL, CbS, b, offb, nl, Cb);
  if (sh.one_col) {
    for (int i = tid; i < nl * kL; i += nt) {
      const int l = i / kL, k = i - l * kL;
      xb[(l * CbS + Cb) * kL + k] = one[k];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (sh.norm_in) {        // three carry rounds on each staged input row
    for (int i = tid; i < nl * (Ca + Cb); i += nt) {
      long long* row;
      if (i < nl * Ca) {
        row = xa + i * kL;
      } else {
        const int j = i - nl * Ca, l = j / Cb;
        row = xb + (l * CbS + (j - l * Cb)) * kL;
      }
      long long x[kL];
      load_row(row, x);
      carry_rounds(x);
      store_row(row, x);
    }
    __syncthreads();
  }

  // phase 1: one thread per (lane, leaf)
  for (int i = tid; i < nl * P; i += nt) {
    const int l = i / P, k = i - l * P;
    long long x[kL], y[kL];
    presum(tab, a_start[k], a_start[k + 1], xa + l * Ca * kL, x);
    presum(tab, b_start[k], b_start[k + 1], xb + l * CbS * kL, y);
    int x32[kL], y32[kL];
    narrow32(x, x32);
    narrow32(y, y32);
    long long c[kW];
    schoolbook(x32, y32, c);
    int w[kW];
    wide_norm32(c, w);
    int4* dst = reinterpret_cast<int4*>(leaves + i * kW);
#pragma unroll
    for (int q = 0; q < kW / 4; ++q)
      dst[q] = make_int4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  }
  __syncthreads();

  // phase 2: one thread per (lane, output, 4 columns) sums its gamma row
  for (int i = tid; i < nl * R * kQuads; i += nt) {
    const int lr = i / kQuads, quad = i - lr * kQuads;
    const int l = lr / R, r = lr - l * R;
    const int4* lv = reinterpret_cast<const int4*>(leaves + l * P * kW) + quad;
    long long acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
    for (int e = g_start[r]; e < g_start[r + 1]; ++e) {
      const int ent = tab[e];
      const int coef = ent >> 16;
      const int4 v = lv[(ent & 0xffff) * kQuads];
      acc0 = mad_wide_s32(coef, v.x, acc0);
      acc1 = mad_wide_s32(coef, v.y, acc1);
      acc2 = mad_wide_s32(coef, v.z, acc2);
      acc3 = mad_wide_s32(coef, v.w, acc3);
    }
    longlong2* g = reinterpret_cast<longlong2*>(gsum + lr * kWPitch + 4 * quad);
    g[0] = make_longlong2(acc0, acc1);
    g[1] = make_longlong2(acc2, acc3);
  }
  __syncthreads();

  // phase 3: one thread per (lane, output) reduces; the output tile
  // [tile][R][14] reuses the staged inputs' space, read by no one any more
  long long* so = xa;
  for (int i = tid; i < nl * R; i += nt) {
    long long c[kW];
    load_row(gsum + i * kWPitch, c);
    long long res[kL];
    redc(c, res);
    store_row(so + i * kL, res);
  }
  __syncthreads();
  copy_out(out + static_cast<long long>(lane0) * R * kL, so, nl * R * kL);
}

__global__ void fq_empty_kernel() {}

// ---------------------------------------------------------------------------
// Launch configuration
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;
constexpr int kBiSmemTarget = 96 * 1024;     // lanes per block: about this much
constexpr int kBiSmemLimit = 200 * 1024;     // the opt-in ceiling asked for
constexpr int kBiMaxTile = 64;

struct DeviceInfo {
  int sms = 0;
  bool smem_opt_in = false;
};

DeviceInfo g_devices[kMaxDevices];

// The device's SM count, with fq_bilinear_kernel's dynamic shared memory
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
    err = cudaFuncSetAttribute(fq_bilinear_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBiSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    d.smem_opt_in = true;
  }
  *info = &d;
  return 0;
}

inline unsigned blocks_for(long long n, int tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

}  // namespace

extern "C" {

// Every launcher returns the cudaError_t of its launch (0 on success).
// n: lanes (< 2^31); layout: kLayoutLen int64s (see Operand / Lanes),
// operand 0 then operand 1; out: n contiguous output rows, 16-byte
// aligned.

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

// shape: P, R, Ca, Cb, one_col, norm_in, table_len (int32). table: the
// packed tables on the device; one: Montgomery one, 14 limbs on the
// device.
int fq_bilinear_launch(const void* a, const void* b, const void* one,
                       const void* table, void* out, long long n,
                       const long long* layout, const int* shape,
                       void* stream) {
  if (n <= 0) return 0;
  DeviceInfo* info = nullptr;
  const int err = device_info(&info);
  if (err != 0) return err;
  Shape sh;
  sh.P = shape[0];
  sh.R = shape[1];
  sh.Ca = shape[2];
  sh.Cb = shape[3];
  sh.one_col = shape[4];
  sh.norm_in = shape[5];
  sh.table_len = shape[6];
  if (sh.P < 1 || sh.P > kBiThreads || sh.R < 1 || sh.R > sh.P || sh.Ca < 1 ||
      sh.Cb < 0 || sh.Cb + sh.one_col < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int CbS = sh.Cb + sh.one_col;
  if (sh.R > sh.Ca + CbS) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_lane =
      8LL * ((sh.Ca + CbS) * kL + sh.R * kWPitch + 2) + 4LL * sh.P * kW;
  const long long fixed = 4LL * sh.table_len;
  // one leaf per thread, about kBiSmemTarget of shared memory, and for
  // small launches at least one block per SM
  long long tile = kBiThreads / sh.P;
  tile = tile < (kBiSmemTarget - fixed) / per_lane ? tile
                                                   : (kBiSmemTarget - fixed) / per_lane;
  if (tile > kBiMaxTile) tile = kBiMaxTile;
  const long long spread = (n + info->sms - 1) / info->sms;
  if (spread < tile) tile = spread;
  if (tile < 1) tile = 1;
  sh.tile = static_cast<int>(tile);
  const long long smem = per_lane * tile + fixed;
  if (smem > kBiSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // a thread per leaf (phase 1) and per four gamma columns (phase 2)
  const int items = sh.tile * (sh.P > sh.R * kQuads ? sh.P : sh.R * kQuads);
  int threads = ((items + 31) / 32) * 32;
  if (threads > kBiThreads) threads = kBiThreads;
  fq_bilinear_kernel<<<blocks_for(n, sh.tile), threads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      parse_operand(layout, 0, a), parse_operand(layout, 1, b),
      static_cast<const long long*>(one), static_cast<const int*>(table),
      static_cast<long long*>(out), parse_lanes(layout),
      static_cast<unsigned>(n), sh);
  return static_cast<int>(cudaGetLastError());
}

// The floor of a launch on this stream: an empty kernel, one warp.
int fq_empty_launch(void* stream) {
  fq_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
