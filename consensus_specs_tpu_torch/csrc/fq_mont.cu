// BLS12-381 Montgomery arithmetic for Hopper (sm_90a), on the port's lazy
// 29-bit x 14 signed int64 limb layout.
//
//   fq_mul:   [N,14] x [N,14] -> [N,14]   three carry rounds on each
//             input, the 14x14 schoolbook into 28 columns, the 14-step
//             interleaved REDC, three closing carry rounds (and, on
//             request, 17 more: the unique signed-top form)
//   fq_redc:  [N,28] -> [N,14]             the REDC and closing rounds
//   fq_chain: [N,Ca,14] -> [N,Ca,14], a program of any length on one
//             accumulator (Fq, Fq2 or Fq12), each step's b the
//             accumulator (a square), a fixed base [N,Cb,14] or slot p of
//             an operand [N,S,Cs,14] or of a table the program fills.
//             Steps: a tower product (Fq2 multiply, Fq12 multiply /
//             square / line multiply, cyclotomic square: for each of P
//             leaves, the alpha and beta pre-sums of the input
//             coefficients, three carry rounds on each, the schoolbook
//             and three wide carry rounds; for each of R outputs, the
//             gamma sum of the leaves' columns, the REDC and the closing
//             rounds); an fq_mul (fq_mul's route, no wide norm); an Fq2
//             squaring (Tower.fq2_sqr: two fq_mul-route products, the
//             second doubled); three carry rounds on the accumulator;
//             a store of the accumulator into a slot, a load from one. A
//             single tower product (ops/fq_cuda.py::fq_bilinear_cuda) is
//             a program of one step.
//
// Replaces consensus_specs_tpu/ops/fq.py:450 fq_mul and :413 fq_redc;
// fq_chain the coeff-placement tower product of
// consensus_specs_tpu/ops/fq_tower.py:509 _bilinear_wide_cols / :522
// _bilinear (also :130 fq2_mul and :569 fq12_cyclo_sqr) and the two loops
// of nothing but such products in consensus_specs_tpu/ops/bls_jax.py:
// :201 _pow_abs (cyclotomic squarings and multiplies by f, a
// lax.fori_loop) and the Miller step's f-update, :291-310 (one Fq12
// squaring and P line multiplies); and the fixed-exponent powers,
// consensus_specs_tpu/ops/fq.py:536 _fq_pow_static (:588 fq_inv, :591
// fq_sqrt_candidate: the window table built by a fori_loop, then per
// window 4 squarings and one multiply by a table entry) and
// consensus_specs_tpu/ops/decompress.py:147 _fq2_pow_static (the Fq2
// square root's square-and-multiply walk). XLA programs, no Pallas kernel. Output
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
// steps: 594,720 products a lane; the Fq inversion 489 fq_mul-route
// products, 198,534 a lane). fq_mul and fq_redc come close to their
// bound. A tower product also runs its pre-sums, carry rounds and gamma
// sums; on the main path, where a launch covers 16-768 lanes, a chain is
// bound by the latency of its steps' dependent phases (a REDC's 14-digit
// chain is ~550 cycles whoever runs it), and before chains by the host's
// cost of one launch per product (489 for one Fq inversion).
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
//   are staged once with it (a table's slots start as one), and only the
//   last step's result goes to device memory. Lanes are independent, so
//   blocks never talk to each other. The program (an int32 code per step:
//   kind | source << 4) lives in device memory, uploaded once per program
//   (ops/fq_cuda.py), and is staged into shared memory kProgChunk codes at
//   a time between block barriers: a program has no length limit (the
//   Fq2 square root is 1,123 steps, two chunks).
// - Teams. The warps that own a few lanes run the program on them alone,
//   and a phase ends at a barrier over the team's warps only (__syncwarp
//   for a team of one warp, a named barrier for more): no block-wide
//   barrier inside the program. Fq and Fq2 chains at the path's lane
//   counts run a product's schoolbook and REDC on 16-thread groups
//   (csrc/fq_arith.cuh: lane k owns limb k and columns k and k + 14, the
//   REDC's digits made by every lane), where one thread a product would
//   leave the warp's other lanes idle; a team of one warp owns two Fq
//   lanes or one Fq2 lane. At large lane counts (more than
//   kGroupLanesPerSm an SM) one thread a product issues fewer
//   instructions a lane and wins: a warp owns 32 Fq or 16 Fq2 lanes.
//   Fq12 chains keep one thread a leaf and a REDC (two warps a lane: 54
//   leaves in one round), as the Miller kernel does: a step has dozens of
//   products, and a group costs a warp's issue for two of them
//   (tools/chain_kernel_probe.py measures both variants of every kind).
//   The cyclotomic square's three input rounds run in the previous
//   product's REDC threads, on the row still in registers.
// - A group's REDC keeps its columns in registers (group_redc_regs in
//   csrc/fq_arith.cuh: digit i made by every lane from lane i's column,
//   broadcast by a shuffle), and an fq_mul-route step's schoolbook feeds
//   it directly: one phase, no wide row in shared memory.
// - fq_mul-route steps form their operands from the accumulator as the
//   product reads them (no pre-sum phase): one barrier a step on groups,
//   two on threads.
// - Tables compiled in. The five tower products are Table<K>
//   specializations in csrc/fq_tables.cuh, generated from the port's
//   tables (ops/fq_tables_gen.py): the alpha and beta pre-sums and the
//   gamma sums are straight-line code with immediate coefficients. No
//   table is copied to a block or decoded at run time. A product's code
//   is selected once per step by its kind, which is the same for the
//   whole block, so no warp diverges on it.
// - A tower product in four phases over the team's lanes, all in shared
//   memory, each phase's threads running one code path: (A) one thread
//   per (lane, operand, limb) computes that limb of every leaf's operand
//   (the table's straight-line pre-sum; a-threads and b-threads in
//   separate warps where the team has two); (B) each leaf narrowed,
//   multiplied and normalized, its 28 int32 columns over its own a row;
//   (C) one thread per (lane, column) sums that column of every output
//   (the gamma code); (D) each output reduced into the accumulator. With
//   `norm_in` the accumulator's rows take three carry rounds first; with
//   `one_col` b's extra row is Montgomery one, kept after the
//   accumulator's rows.
// - Teams a block: as many as fit 256 threads in about 96 KB of shared
//   memory (bytes a lane by chain: see Regions); where throughput counts
//   (Fq2 or Fq12 products on threads at more lanes than SMs) the block's
//   256 threads are one team over all its lanes, so a phase's items fill
//   the block; and fewer lanes when a launch has fewer lanes than the card
//   has SMs: every chain at the firehose's
//   128 lanes spreads over 64-128 SMs, because at these lane counts a
//   step's time is the latency of its phases, not the card's throughput.
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
// fq_chain: a program of products on one accumulator
// ---------------------------------------------------------------------------

constexpr int kKindBits = 4;          // a step's code: kind | source << 4
constexpr int kSrcAcc = 0, kSrcBase = 1, kSrcOperand = 2;
// The chain's own step kinds, after the compiled tower products (kinds
// 0 .. kNumKinds - 1; ops/fq.py KIND_MUL .. KIND_LOAD).
constexpr int kKindMul = 5, kKindSqr2 = 6, kKindNorm = 7, kKindStore = 8, kKindLoad = 9;
constexpr int kStepKinds = 10;
static_assert(kKindMul == kNumKinds, "the chain's own kinds follow the tower products");
constexpr int kPhases = 4;            // clock stamps per step (A, B, C, D)
constexpr int kProgChunk = 1024;      // program codes staged into shared memory at a time
constexpr int kChainThreads = 256;    // at most, a block
constexpr int kMaxTeams = 15;         // named barriers 1 .. 15: teams of several warps a block

// What the launcher checks of a kind (the kernel has the rest in code).
// Ca 0: a step on any accumulator (norm, store, load).
struct KindInfo {
  int P, R, Ca, Cb;
  bool one_col, norm_in;
};

static_assert(kNumKinds == 5, "the kind lists below name kinds 0 .. 4");
#define FQ_INFO(K)                                                       \
  {Table<K>::P, Table<K>::R, Table<K>::Ca, Table<K>::Cb, Table<K>::one_col, \
   Table<K>::norm_in}
constexpr KindInfo kKindsHost[kStepKinds] = {
    FQ_INFO(0), FQ_INFO(1), FQ_INFO(2), FQ_INFO(3), FQ_INFO(4),
    {1, 1, 1, 1, false, false},      // fq_mul
    {2, 2, 2, 2, false, false},      // fq2_sqr: two fq_mul-route products
    {0, 0, 0, 0, false, false},      // norm
    {0, 0, 0, 0, false, false},      // store
    {0, 0, 0, 0, false, false}};     // load

struct Chain {
  const int* program;   // n_steps int32 codes, device memory
  int n_steps;
  int Ca;          // the accumulator's coefficients (every product's Ca and R)
  int Cb;          // the base's rows (0: no base)
  int S, Cs;       // slots and rows a slot (0: none)
  int S_op;        // slots staged from the operand (0: a table, every slot one)
  int P;           // the most leaves of any tower product
  int tile;        // lanes a block
  int team_warps;  // warps of a team
  int team_lanes;  // lanes a team owns
  int chunk;       // program codes staged at a time (a multiple of 4)
};

// A block's shared memory: the program chunk (up to kProgChunk int32s, no
// more than the program), the q table (kQzWords), each 16-thread group's
// exchange words (kScrWords; on groups only), then
// per lane the accumulator's Ca rows and Montgomery one (b's extra row of
// the cyclotomic square); the base's Cb rows; the S x Cs slot rows; the
// tower products' leaf operands x and y (P rows each; after phase B the x
// rows hold the leaves' int32 columns); Ca wide rows (kWPitch: the gamma
// sums, or an fq_mul-route product's schoolbook columns); then the three
// operands' lane offsets. Bytes a lane, by chain (the launcher reports a
// launch's shape: ops/fq_cuda.py chain_launch_shape): an Fq power 2,280 (accumulator and one
// 224, the window table of 16 rows x 112 bytes 1,792, one wide row 240,
// offsets 24); the Fq2 square root 1,704 (accumulator and one 336, base
// 224, three leaves' x and y 672, two wide rows 480); an Fq12 chain of
// multiplies 17,776 (accumulator and one 1,456, base 1,344, 54 leaves' x
// and y 12,096, twelve wide rows 2,880).
struct Regions {
  int* prog;
  unsigned* qz;
  int* scr;
  long long *acc, *base, *slot, *x, *y, *g, *off;
  int acc_r, base_r, slot_r, x_r, g_r;      // int64s a lane
};

__host__ __device__ inline long long fixed_words(int threads, bool groups, int chunk) {
  return chunk / 2 + kQzWords / 2 + (groups ? (threads / kGroup) * (kScrWords / 2) : 0);
}

__host__ __device__ inline long long lane_words(const Chain& ch) {
  return (ch.Ca + 1) * kL + ch.Cb * kL + static_cast<long long>(ch.S) * ch.Cs * kL +
         2 * ch.P * kL + ch.Ca * kWPitch + 3;
}

__device__ __forceinline__ Regions regions(long long* smem, const Chain& ch, int threads,
                                           bool groups) {
  Regions g;
  g.prog = reinterpret_cast<int*>(smem);
  long long* p = smem + ch.chunk / 2;
  g.qz = reinterpret_cast<unsigned*>(p);
  p += kQzWords / 2;
  g.scr = reinterpret_cast<int*>(p);
  if (groups) p += (threads / kGroup) * (kScrWords / 2);
  g.acc_r = (ch.Ca + 1) * kL;
  g.base_r = ch.Cb * kL;
  g.slot_r = ch.S * ch.Cs * kL;
  g.x_r = ch.P * kL;
  g.g_r = ch.Ca * kWPitch;
  g.acc = p;
  g.base = g.acc + ch.tile * g.acc_r;
  g.slot = g.base + ch.tile * g.base_r;
  g.x = g.slot + ch.tile * g.slot_r;
  g.y = g.x + ch.tile * g.x_r;
  g.g = g.y + ch.tile * g.x_r;
  g.off = g.g + ch.tile * g.g_r;
  return g;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// A team: the warps that own a few lanes and run the program on them
// alone. Its phases end at a barrier over its own warps: __syncwarp for
// one warp, the named barrier 1 + id otherwise.
struct Team {
  Regions g;
  int Ca, Cs;
  int l0, lanes;        // its first lane in the block, and how many it owns
  int tt, size;         // the thread's index in the team; the team's threads
  int id, warps;
  int gq, groups;       // the thread's 16-thread group in the team; groups
  int k16, k;           // its index in the group, and the limb it owns
  int* scr;             // its group's exchange words
  long long* st;        // block 0's clock stamps of this step, or null

  __device__ __forceinline__ void sync() const {
    if (warps == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + id), "r"(size) : "memory");
    }
  }
  __device__ __forceinline__ void stamp(int phase) const {
    if (st) st[phase] = clock64();
  }
  __device__ __forceinline__ long long* acc(int l) const { return g.acc + l * g.acc_r; }
  // b of a step on lane l: the accumulator, the base or slot src - 2
  __device__ __forceinline__ const long long* b(int l, int src) const {
    return src == kSrcAcc    ? acc(l)
           : src == kSrcBase ? g.base + l * g.base_r
                             : g.slot + l * g.slot_r + (src - kSrcOperand) * Cs * kL;
  }
};

// f(item, own) for the items of a phase dealt to the team's groups, a
// warp's two groups on items base and base + 1: where base + 1 is past the
// end the second group repeats the first's item and stores nothing (own
// false), so both always run group code together (full-warp shuffles).
template <class F>
__device__ __forceinline__ void group_items(const Team& tm, int items, F&& f) {
  for (int base = 0; base < items; base += tm.groups) {
    const int first = base + (tm.gq & ~1);
    if (first >= items) break;
    const bool own = base + tm.gq < items;
    f(own ? base + tm.gq : first, own);
  }
}

// Norm, store, load: thread items over the team's lanes.
__device__ __forceinline__ void control_step(const Team& tm, int kind, int src) {
  if (kind == kKindNorm) {
    for (int i = tm.tt; i < tm.lanes * tm.Ca; i += tm.size) {
      const int li = i / tm.Ca;
      long long* row = tm.acc(tm.l0 + li) + (i - li * tm.Ca) * kL;
      long long x[kL];
      load_row(row, x);
      carry_rounds(x);
      store_row(row, x);
    }
  } else {
    constexpr int kHalf = kL / 2;
    const int per = tm.Ca * kHalf;
    for (int i = tm.tt; i < tm.lanes * per; i += tm.size) {
      const int li = i / per, q = i - li * per, l = tm.l0 + li;
      longlong2* a = reinterpret_cast<longlong2*>(tm.acc(l)) + q;
      longlong2* s = reinterpret_cast<longlong2*>(const_cast<long long*>(tm.b(l, src))) + q;
      if (kind == kKindStore) {
        *s = *a;
      } else {
        *a = *s;
      }
    }
  }
  tm.sync();
  for (int ph = 0; ph < kPhases; ++ph) tm.stamp(ph);
}

// fq_mul (Ca 1) or Tower.fq2_sqr (Ca 2): fq_mul's own route, one product
// per output row (P0 = (a0 + a1)(a0 - a1), P1 = a0 a1), no wide norm and no
// gamma sum; the operands are formed from the accumulator as the product
// reads them (no phase A). On groups the schoolbook and the REDC run in
// one phase, the columns in registers (stamps: B the product, D the
// store); on threads (B) each product's schoolbook into its wide row, (D)
// its REDC into the accumulator's row, P1 doubled.
template <bool kG>
__device__ __forceinline__ void mul_step(const Team& tm, int kind, int src) {
  const bool sqr2 = kind == kKindSqr2;
  const int P = sqr2 ? 2 : 1;
  const int items = tm.lanes * P;
  tm.stamp(0);
  if constexpr (kG) {
    // one item a group (two Fq lanes or one Fq2 lane's two products a
    // warp): the schoolbook's column pair stays in registers for the REDC;
    // the result is stored once every group of the team has read its
    // operands
    long long o = 0;
    int out = -1;
    group_items(tm, items, [&](int it, bool own) {
      const int li = it / P, p = it - li * P, l = tm.l0 + li;
      const long long* A = tm.acc(l);
      long long xk, yk;
      if (sqr2) {
        const long long a0 = A[tm.k], a1 = A[kL + tm.k];
        xk = p ? a0 : a0 + a1;
        yk = p ? a1 : a0 - a1;
      } else {
        xk = A[tm.k];
        yk = tm.b(l, src)[tm.k];
      }
      long long lo, hi;
      group_schoolbook(xk, yk, tm.scr, tm.k16, tm.k, lo, hi);
      o = group_redc_regs(lo, hi, tm.k, tm.g.qz);
      if (sqr2 && p == 1) o += o;
      out = own && tm.k16 < kL ? it : -1;
    });
    tm.stamp(1);
    tm.sync();
    if (out >= 0) tm.acc(tm.l0 + out / P)[(out % P) * kL + tm.k16] = o;
  } else {
    for (int it = tm.tt; it < items; it += tm.size) {
      const int li = it / P, p = it - li * P, l = tm.l0 + li;
      const long long* A = tm.acc(l);
      long long x[kL], y[kL];
      if (sqr2) {
        load_row(A, x);
        load_row(A + kL, y);
        if (p == 0) {
#pragma unroll
          for (int j = 0; j < kL; ++j) {
            const long long a0 = x[j], a1 = y[j];
            x[j] = a0 + a1;
            y[j] = a0 - a1;
          }
        }
      } else {
        load_row(A, x);
        load_row(tm.b(l, src), y);
      }
      int x32[kL], y32[kL];
      narrow32(x, x32);
      narrow32(y, y32);
      long long c[kW];
      schoolbook(x32, y32, c);
      store_row(tm.g.g + l * tm.g.g_r + p * kWPitch, c);
    }
    tm.sync();
    tm.stamp(1);
    for (int it = tm.tt; it < items; it += tm.size) {
      const int li = it / P, p = it - li * P, l = tm.l0 + li;
      long long c[kW];
      load_row(tm.g.g + l * tm.g.g_r + p * kWPitch, c);
      long long r[kL];
      redc(c, r);
      if (sqr2 && p == 1) {
#pragma unroll
        for (int j = 0; j < kL; ++j) r[j] += r[j];
      }
      store_row(tm.acc(l) + p * kL, r);
    }
  }
  tm.sync();
  tm.stamp(2);
  tm.stamp(3);
}

// Whether a step's kind takes three carry rounds on the accumulator first.
__device__ __forceinline__ bool norm_in_kind(int kind) {
  switch (kind) {
    case 0: return Table<0>::norm_in;
    case 1: return Table<1>::norm_in;
    case 2: return Table<2>::norm_in;
    case 3: return Table<3>::norm_in;
    case 4: return Table<4>::norm_in;
    default: return false;
  }
}

// A tower product (Table<K>): (norm_in: three carry rounds on the
// accumulator's rows first, unless the previous product's REDC ran them,
// `normed`) (A) limb t of every leaf's a and b operand, one thread per
// (lane, operand, limb), b-threads from a warp boundary; (B) each leaf
// narrowed, multiplied and wide-normalized, its int32 columns over its own
// x row; (C) one thread per (lane, column) sums that column of every
// output (the gamma code); (D) each output's REDC into the accumulator,
// and three more carry rounds where the next step would run them
// (`norm_next`). B and D on 16-thread groups (kG; the REDC's columns read
// into registers, group_redc_regs), or one thread an item.
template <class T, bool kG>
__device__ __forceinline__ void bilinear_step(const Team& tm, int src, bool normed,
                                              bool norm_next) {
  const Regions& g = tm.g;
  if (T::norm_in && !normed) {
    for (int i = tm.tt; i < tm.lanes * T::Ca; i += tm.size) {
      const int li = i / T::Ca;
      long long* row = tm.acc(tm.l0 + li) + (i - li * T::Ca) * kL;
      long long x[kL];
      load_row(row, x);
      carry_rounds(x);
      store_row(row, x);
    }
    tm.sync();
  }
  const int items = tm.lanes * kL;
  const int padded = (items + 31) & ~31;
  for (int i = tm.tt; i < 2 * padded; i += tm.size) {
    const bool is_b = i >= padded;
    const int j = is_b ? i - padded : i;
    if (j >= items) continue;
    const int li = j / kL, t = j - li * kL, l = tm.l0 + li;
    if (!is_b) {
      T::alpha(tm.acc(l) + t, g.x + l * g.x_r + t);
    } else {
      T::beta(tm.b(l, src) + t, g.y + l * g.x_r + t);
    }
  }
  tm.sync();
  tm.stamp(0);

  const int leaves = tm.lanes * T::P;
  if constexpr (kG) {
    group_items(tm, leaves, [&](int it, bool own) {
      const int li = it / T::P, q = it - li * T::P, l = tm.l0 + li;
      long long* xr = g.x + l * g.x_r + q * kL;
      const long long* yr = g.y + l * g.x_r + q * kL;
      long long lo, hi;
      group_schoolbook(xr[tm.k], yr[tm.k], tm.scr, tm.k16, tm.k, lo, hi);
      int wlo, whi;
      group_wide_norm(lo, hi, tm.k, wlo, whi);
      if (own && tm.k16 < kL) {
        reinterpret_cast<int*>(xr)[tm.k16] = wlo;
        reinterpret_cast<int*>(xr)[kL + tm.k16] = whi;
      }
    });
  } else {
    for (int it = tm.tt; it < leaves; it += tm.size) {
      const int li = it / T::P, q = it - li * T::P, l = tm.l0 + li;
      long long* xr = g.x + l * g.x_r + q * kL;
      long long x[kL], y[kL];
      load_row(xr, x);
      load_row(g.y + l * g.x_r + q * kL, y);
      int x32[kL], y32[kL];
      narrow32(x, x32);
      narrow32(y, y32);
      long long c[kW];
      schoolbook(x32, y32, c);
      int w[kW];
      wide_norm32(c, w);
      int4* dst = reinterpret_cast<int4*>(xr);
#pragma unroll
      for (int q4 = 0; q4 < kQuads; ++q4)
        dst[q4] = make_int4(w[4 * q4], w[4 * q4 + 1], w[4 * q4 + 2], w[4 * q4 + 3]);
    }
  }
  tm.sync();
  tm.stamp(1);

  for (int i = tm.tt; i < tm.lanes * kW; i += tm.size) {
    const int li = i / kW, j = i - li * kW, l = tm.l0 + li;
    T::gamma(reinterpret_cast<const int*>(g.x + l * g.x_r) + j, g.g + l * g.g_r + j);
  }
  tm.sync();
  tm.stamp(2);

  const int outs = tm.lanes * T::R;
  if constexpr (kG) {
    group_items(tm, outs, [&](int it, bool own) {
      const int li = it / T::R, r = it - li * T::R, l = tm.l0 + li;
      const long long* row = g.g + l * g.g_r + r * kWPitch;
      long long o = group_redc_regs(row[tm.k], row[kL + tm.k], tm.k, g.qz);
      if (norm_next) o = group_rounds(o, tm.k, 3);
      if (own && tm.k16 < kL) tm.acc(l)[r * kL + tm.k16] = o;
    });
  } else {
    for (int it = tm.tt; it < outs; it += tm.size) {
      const int li = it / T::R, r = it - li * T::R, l = tm.l0 + li;
      long long c[kW];
      load_row(g.g + l * g.g_r + r * kWPitch, c);
      long long res[kL];
      redc(c, res);
      if (norm_next) carry_rounds(res);
      store_row(tm.acc(l) + r * kL, res);
    }
  }
  tm.sync();
  tm.stamp(3);
}

// bilinear_step<Table<kind>, kG>(args), kind uniform over the team.
#define FQ_STEP_BY_KIND(kind, kG, args)                 \
  switch (kind) {                                       \
    case 0: bilinear_step<Table<0>, kG> args; break;    \
    case 1: bilinear_step<Table<1>, kG> args; break;    \
    case 2: bilinear_step<Table<2>, kG> args; break;    \
    case 3: bilinear_step<Table<3>, kG> args; break;    \
    default: bilinear_step<Table<4>, kG> args; break;   \
  }

// The chain: a block stages its lanes' accumulator, base and slots once,
// every team runs the program on its own lanes (program chunks staged
// into shared memory between block barriers), and the accumulators leave
// in one coalesced store. kG: B and D on 16-thread groups.
template <bool kG>
__global__ void __launch_bounds__(kChainThreads)
fq_chain_kernel(Operand a, Operand b, Operand o, long long* __restrict__ out,
                Lanes lanes, unsigned n, Chain ch, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) long long smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const Regions g = regions(smem, ch, nt, kG);
  const unsigned lane0 = blockIdx.x * static_cast<unsigned>(ch.tile);
  const int nl = static_cast<int>(min(static_cast<unsigned>(ch.tile), n - lane0));
  long long* offa = g.off;
  long long* offb = offa + ch.tile;
  long long* offo = offb + ch.tile;

  for (int l = tid; l < nl; l += nt) {
    offa[l] = lane_offset(lanes, a, lane0 + l);
    if (ch.Cb) offb[l] = lane_offset(lanes, b, lane0 + l);
    if (ch.S_op) offo[l] = lane_offset(lanes, o, lane0 + l);
  }
  for (int i = tid; i < kQzWords; i += nt) g.qz[i] = qz_word(i);
  if (kG) {
    for (int i = tid; i < (nt / kGroup) * kScrWords; i += nt) g.scr[i] = 0;
  }
  // the padding lanes of the last team (zeros: their products stay in
  // range and are never stored)
  const int pad = ch.tile - nl;
  for (int i = tid; i < pad * g.acc_r; i += nt) g.acc[nl * g.acc_r + i] = 0;
  for (int i = tid; i < pad * g.base_r; i += nt) g.base[nl * g.base_r + i] = 0;
  if (ch.S_op) {
    for (int i = tid; i < pad * g.slot_r; i += nt) g.slot[nl * g.slot_r + i] = 0;
  }
  __syncthreads();
  stage_rows<kL>(g.acc, kL, ch.Ca + 1, a, offa, nl, 1, ch.Ca);
  if (ch.Cb) stage_rows<kL>(g.base, kL, ch.Cb, b, offb, nl, 1, ch.Cb);
  if (ch.S_op) stage_rows<kL>(g.slot, kL, ch.S * ch.Cs, o, offo, nl, ch.S, ch.Cs);
  for (int i = tid; i < ch.tile * kL; i += nt) {      // b's one_col row
    const int l = i / kL, k = i - l * kL;
    g.acc[l * g.acc_r + ch.Ca * kL + k] = kOneMont[k];
  }
  if (!ch.S_op) {          // a table: every slot one of the accumulator's field
    const int rows = ch.S * ch.Cs;
    for (int i = tid; i < ch.tile * rows * kL; i += nt) {
      const int row = i / kL, k = i - row * kL, c = (row % rows) % ch.Cs;
      g.slot[i] = c == 0 ? kOneMont[k] : 0;
    }
  }
  // the program's first chunk with the operands: one wait for both
  for (int i = tid; i < min(ch.chunk, ch.n_steps); i += nt) cp_async4(g.prog + i, ch.program + i);
  cp_async_wait_all();

  Team tm;
  tm.g = g;
  tm.Ca = ch.Ca;
  tm.Cs = ch.Cs;
  tm.size = ch.team_warps * 32;
  tm.warps = ch.team_warps;
  tm.id = tid / tm.size;
  tm.tt = tid - tm.id * tm.size;
  tm.l0 = tm.id * ch.team_lanes;
  tm.lanes = ch.team_lanes;
  tm.groups = tm.size / kGroup;
  tm.gq = tm.tt / kGroup;
  tm.k16 = tid & (kGroup - 1);
  tm.k = min(tm.k16, kL - 1);
  tm.scr = g.scr + (tid / kGroup) * kScrWords;
  const bool active = tm.l0 < nl;
  long long* stamp = (stamps != nullptr && blockIdx.x == 0 && tid == 0) ? stamps : nullptr;

  for (int s0 = 0; s0 < ch.n_steps; s0 += ch.chunk) {
    const int m = min(ch.chunk, ch.n_steps - s0);
    if (s0) {              // the next chunk, once every team is past this one
      __syncthreads();
      for (int i = tid; i < m; i += nt) g.prog[i] = ch.program[s0 + i];
    }
    __syncthreads();
    if (stamp && s0 == 0) stamp[0] = clock64();
    if (!active) continue;
    bool normed = false;     // the accumulator had a norm_in step's rounds
    for (int s = 0; s < m; ++s) {
      const int code = g.prog[s];
      const int kind = code & ((1 << kKindBits) - 1), src = code >> kKindBits;
      tm.st = stamp ? stamp + 1 + (s0 + s) * kPhases : nullptr;
      if (kind >= kKindNorm) {
        control_step(tm, kind, src);
        normed = false;
      } else if (kind >= kKindMul) {
        mul_step<kG>(tm, kind, src);
        normed = false;
      } else {
        const bool norm_next = s + 1 < m && norm_in_kind(g.prog[s + 1] & ((1 << kKindBits) - 1));
        FQ_STEP_BY_KIND(kind, kG, (tm, src, normed, norm_next))
        normed = norm_next;
      }
    }
  }
  __syncthreads();

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
// Fq and Fq2 chains run on 16-thread groups up to this many lanes an SM
// (about 4 warps of groups); beyond it one thread a product issues fewer
// instructions a lane.
constexpr int kGroupLanesPerSm = 8;

struct DeviceInfo {
  int sms = 0;
  bool smem_opt_in = false;
};

DeviceInfo g_devices[kMaxDevices];

// The device's SM count, with both chain kernels' dynamic shared memory
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
    err = cudaFuncSetAttribute(fq_chain_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kChainSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(fq_chain_kernel<true>,
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

// Checks the program against the operands' shapes and sets ch.P; false
// where a step cannot run.
bool check_program(Chain& ch, const int* program) {
  ch.P = 0;
  for (int s = 0; s < ch.n_steps; ++s) {
    const int code = program[s];
    if (code < 0) return false;
    const int kind = code & ((1 << kKindBits) - 1), src = code >> kKindBits;
    if (kind >= kStepKinds) return false;
    const KindInfo& k = kKindsHost[kind];
    const bool slot = src >= kSrcOperand;
    if (slot && src - kSrcOperand >= ch.S) return false;
    if (kind >= kKindNorm) {
      const bool ok = kind == kKindNorm
                          ? src == kSrcAcc
                          : slot && ch.Cs == ch.Ca && !(kind == kKindStore && ch.S_op);
      if (!ok) return false;
      continue;
    }
    if (k.Ca != ch.Ca || k.R != ch.Ca) return false;
    if (src == kSrcAcc) {
      if (k.Cb != ch.Ca) return false;
    } else if (k.one_col || k.norm_in || kind == kKindSqr2) {
      return false;
    } else if (src == kSrcBase) {
      if (k.Cb != ch.Cb) return false;
    } else if (k.Cb != ch.Cs) {
      return false;
    }
    if (kind < kKindMul && k.P > ch.P) ch.P = k.P;
  }
  return true;
}

// The team and block shape of a chain of n lanes (ops/fq_cuda.py
// chain_launch_shape reports it); false where the launcher cannot run it.
// Fq and Fq2 chains run on 16-thread groups up to kGroupLanesPerSm lanes an
// SM, everything else one thread a product (tools/chain_kernel_probe.py
// measures both). Latency teams: on groups a warp owns two Fq lanes or one
// Fq2 lane; on threads a warp owns 32 Fq lanes and two warps one Fq12 lane
// while the launch has no more lanes than SMs. Teams a block: as many as
// fit 256 threads and about kChainSmemTarget bytes, and for small launches
// no more than spreads them over every SM. Throughput (threads, Fq2, or
// Fq12 with more lanes than SMs): the block's 256 threads are one team over
// as many lanes as keep one leaf a thread in about kChainSmemTarget bytes
// (at most kChainMaxTile), so a phase's items spread over all of them as
// with single products at 65,536 lanes.
bool chain_shape(Chain& ch, long long n, int sms, bool& groups, int& threads,
                 long long& smem) {
  groups = ch.Ca <= 2 && n <= static_cast<long long>(kGroupLanesPerSm) * sms;
  ch.chunk = ch.n_steps < kProgChunk ? (ch.n_steps + 3) & ~3 : kProgChunk;
  const long long lane_bytes = 8LL * lane_words(ch);
  const long long room = kChainSmemTarget - 8LL * fixed_words(kChainThreads, groups, ch.chunk);
  const long long spread = (n + sms - 1) / sms;
  if (!groups && ch.Ca > 1 && (ch.Ca == 2 || n > sms)) {
    long long tile = kChainThreads / (ch.P > 0 ? ch.P : 1);
    if (room / lane_bytes < tile) tile = room / lane_bytes;
    if (tile > kChainMaxTile) tile = kChainMaxTile;
    if (spread < tile) tile = spread;
    if (tile < 1) tile = 1;
    ch.team_warps = kChainThreads / 32;
    ch.team_lanes = static_cast<int>(tile);
    ch.tile = ch.team_lanes;
    threads = kChainThreads;
  } else {
    if (groups) {
      ch.team_warps = 1;
      ch.team_lanes = 2 / ch.Ca;
    } else {
      ch.team_warps = ch.Ca == 1 ? 1 : 2;
      ch.team_lanes = ch.Ca == 1 ? 32 : 1;
    }
    const int team_threads = ch.team_warps * 32;
    long long teams = kChainThreads / team_threads;
    const long long fit = room / (lane_bytes * ch.team_lanes);
    if (fit < teams) teams = fit;
    if (ch.team_warps > 1 && teams > kMaxTeams) teams = kMaxTeams;
    const long long needed = (n + ch.team_lanes - 1) / ch.team_lanes;
    if ((needed + sms - 1) / sms < teams) teams = (needed + sms - 1) / sms;
    if (teams < 1) teams = 1;
    ch.tile = static_cast<int>(teams * ch.team_lanes);
    threads = static_cast<int>(teams * team_threads);
  }
  smem = 8LL * fixed_words(threads, groups, ch.chunk) + lane_bytes * ch.tile;
  // mul_step on groups holds one product a group in registers until the
  // team's barrier: a team needs a group for each of its fq_mul-route
  // products (lanes x Ca, the kinds' P; they exist only where Ca <= 2)
  return !(groups && ch.Ca <= 2 &&
           ch.team_lanes * ch.Ca > ch.team_warps * (32 / kGroup));
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
// null with Cb = 0), operand [n, S, Cs, 14] (operand 2, or null: then the
// S slots of Cs = Ca rows are a table, each starting as one); program:
// n_steps int32 codes (kind | source << 4), in host memory (checked here)
// and the same codes in device memory (run); dims: Ca, Cb, S, Cs, and 1
// where the slots are the operand's; out: [n, Ca, 14]. stamps:
// null, or room for 1 + 4 x n_steps int64s: block 0's clock64() at the
// start and after each phase of each step. shape: null, or 4 ints that
// receive the launch's groups flag, threads, lanes a block and blocks.
int fq_chain_launch(const void* acc, const void* base, const void* operand,
                    void* out, long long n, const long long* layout,
                    const int* program, const void* program_dev, int n_steps,
                    const int* dims, void* stamps, int* shape,
                    void* stream) {
  if (n <= 0) return 0;
  if (n_steps < 1 || !program_dev) return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo* info = nullptr;
  const int err = device_info(&info);
  if (err != 0) return err;
  Chain ch;
  ch.program = static_cast<const int*>(program_dev);
  ch.n_steps = n_steps;
  ch.Ca = dims[0];
  ch.Cb = dims[1];
  ch.S = dims[2];
  ch.Cs = dims[3];
  ch.S_op = dims[4] ? ch.S : 0;
  if (ch.Ca < 1 || ch.Cb < 0 || ch.S < 0 || ch.Cs < 0 || (ch.Cb && !base) ||
      (ch.S_op && (!operand || ch.Cs < 1)) || (ch.S && ch.Cs < 1) ||
      !check_program(ch, program))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!ch.S) ch.Cs = 0;
  bool groups = false;
  int threads = 0;
  long long smem = 0;
  if (!chain_shape(ch, n, info->sms, groups, threads, smem) || smem > kChainSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(n, ch.tile);
  if (shape) {
    shape[0] = groups;
    shape[1] = threads;
    shape[2] = ch.tile;
    shape[3] = static_cast<int>(blocks);
  }
  const Operand oa = parse_operand(layout, 0, acc), ob = parse_operand(layout, 1, base),
                oo = parse_operand(layout, 2, operand);
  if (groups) {
    fq_chain_kernel<true><<<blocks, threads, static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
        oa, ob, oo, static_cast<long long*>(out), parse_lanes(layout),
        static_cast<unsigned>(n), ch, static_cast<long long*>(stamps));
  } else {
    fq_chain_kernel<false><<<blocks, threads, static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
        oa, ob, oo, static_cast<long long*>(out), parse_lanes(layout),
        static_cast<unsigned>(n), ch, static_cast<long long*>(stamps));
  }
  return static_cast<int>(cudaGetLastError());
}

// The floor of a launch on this stream: an empty kernel, one warp.
int fq_empty_launch(void* stream) {
  fq_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
