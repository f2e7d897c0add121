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
// Neither kernel knows its program: each runs any compiled program. The
// final exponentiation of a grouped pairing (f -> f^(3 (q^12 - 1) / r) and
// the flag "equal to one", the reference's _grouped_verdict,
// consensus_specs_tpu/ops/bls_jax.py:351) runs on g2_ladder_kernel, and the
// decompressions' addition trees with jac_to_affine (bls_jax.py:442, :469)
// on either, by lanes (ops/fq_points.py: final_exp_program, tree_program,
// FINAL_EXP_MODE, tree_mode).
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
// 128 groups for the Miller loop and the final exponentiation) neither
// bytes nor multiply-adds: a cofactor ladder lane is about 50,000
// dependent field operations (4,619 bundles deep), against a few
// kilobytes of input and output. The time is the latency of the
// dependency chain: what one SM takes to get through a record's phases
// and barriers (chip_smoke.py's `phase kernel` and
// tools/point_program_probe.py print block 0's cycles a bundle, phase by
// phase).
//
// Design:
// - One program for the whole loop. The host schedules the ops into
//   bundles, allocates registers by liveness and uploads the program once
//   per device. The ladder's program depends only on (nbits, w): the digits
//   are data, so the cofactor and every 256-bit signing scalar each reuse
//   one program. The Miller program depends only on P.
// - State in shared memory for the whole loop. A lane's register file
//   (rows of 14 int64 limbs, 16-byte aligned), its flags and the bundle's
//   scratch (leaf operand rows, wide rows) live in dynamic shared memory
//   (above 48 KB through cudaFuncSetAttribute); inputs are staged once with
//   cp.async and the outputs leave in one coalesced store. The window
//   digits and signs (at most 128 each) and q's table are staged once too.
// - The program streamed into shared memory. Each record is
//   self-contained (header, op words, scratch tables, the register lists
//   of loads and products inline), 16-byte aligned in device memory. The
//   block's last warp is the producer: its lane 0 keeps kRing records in
//   flight in a ring of shared-memory slots, each fetched by one TMA bulk
//   copy (cp.async.bulk) that completes on the slot's "full" mbarrier. It
//   requests records 0 .. kRing - 1 first; then, for each record, it reads
//   from the record's header where the record kRing on lies, waits on the
//   slot's "empty" mbarrier (the consumers arrive there once past the
//   record's last barrier) and requests that record into the same slot.
//   It naps (__nanosleep) between polls, so that its waiting takes no
//   issue slots from the consumer warp on its SM sub-partition. The
//   consumer warps wait on "full" (parity: the slot's round) and then read
//   only shared memory.
// - Two kinds of record. A run record packs up to 48 consecutive bundles
//   that hold one multiply each and nothing else (the Fq inversion's window
//   of squarings and table multiplies, in jac_to_affine and fq12_inv): each
//   lane's group (or thread) runs the multiplies one after another, from
//   operands to stored result, with no barrier and no record between them;
//   lane k of a group reads and stores only limb k of the lane's rows, so
//   each multiply sees the one before. Every other bundle is a record of
//   its own.
// - A bundle in seven phases, each skipped with its barrier when empty: (A)
//   linear ops (one thread per row) and the tower products' pre-sums (one
//   thread per operand limb, the compiled Table<K> code reading the
//   register file through a gather; the b pre-sums from the next warp
//   boundary, so that the a and b code run on different warps); (B) every
//   multiply's schoolbook (its raw columns into its wide row) and every
//   tower-product leaf (wide-normalized, its int32 columns over its own x
//   row); (C) the tower products' gamma sums (one thread per column); (D)
//   every REDC, then the phase-E norms folded into it (the three carry
//   rounds of a norm_in on a product output, run on the output's own
//   limbs by the group or thread that made it, into the norm's register;
//   the compiler folds one only where that register's previous value is
//   last read before phase D, and such a norm leaves phase E); (E) the
//   linear ops that read the bundle's own results, then (E2, E3) those that
//   read E's and E2's, so a chain of up to three linear ops after a REDC
//   stays in the bundle instead of opening bundles of linear ops only. A
//   multiply reads phase A's results of its bundle. The row ops (add, sub,
//   neg, sel, load) take one branch-free path, both source rows loaded
//   before the store.
// - The ladder's kernel (g2_ladder_kernel: few products a bundle, latency
//   first) runs B and D on 16-thread groups (a half-warp; csrc/
//   fq_arith.cuh's group multiply, shared with the chain kernel). Lane k
//   (0..13; lanes 14 and 15 follow lane 13 and store nothing) narrows limb
//   k of each operand (narrow32's three carry rounds, the carry from lane
//   k - 1 by a shuffle); the group swaps the int32 limbs through its
//   exchange words; lane k sums columns k and k + 14 of the schoolbook.
//   Where the leaves would take more than one round of the block's groups,
//   each group runs two leaves at once (group_schoolbook2: two chains to
//   interleave), and the multiplies' items are padded to even so that a
//   warp's two groups run one code. REDC (group_redc_regs): lane k holds
//   columns k and 14 + k in registers; digit i is made by every lane from
//   lane i's low column (a shuffle) and the previous digit's carry, so the
//   digits and carries are redc()'s integers, and each lane adds its own
//   terms to its two columns; then three carry rounds across the lanes.
//   A warp's two groups always run group code together (a group without an
//   item repeats its partner's and stores nothing), so every shuffle is a
//   full-warp one.
// - The Miller kernel (miller_grouped_kernel: dozens of leaves and REDCs a
//   bundle; each phase is bound by the SM's throughput, and a 16-thread
//   group costs a warp's instructions for two items) runs B and D one
//   thread an item, with csrc/fq_arith.cuh's narrow32, schoolbook,
//   wide_norm32 and redc.
// - Barriers. A bundle needs nw consumer warps (its widest phase, in
//   threads or groups); the others go straight to the record's end. A
//   phase ends with __syncwarp when nw is 1 and with the named barrier 1
//   over the nw warps otherwise; every record ends with the named barrier 2
//   over all consumer warps. A run has no phase barrier.
// - One lane (ladder) or one group (Miller) per block while the launch has
//   fewer lanes than the card has SMs; more lanes per block only beyond.
//   Threads: 32 x the consumer warps of the program's widest phase (2 to
//   8), and the producer warp.
//
// Shared memory (ops/fq_points.py::launch_shape computes the same): the
// ring is kRing slots of the program's largest record (cofactor and
// 256-bit ladders 488 words: 15,616 bytes; the final exponentiation 564:
// 18,048; Miller P = 3 640: 20,480), the mbarriers, a 48-word q table, the
// digits, 576 bytes of exchange words a 16-thread group (9,216 for 256
// consumer threads), and per lane the file: the ladder 18,160 bytes (95
// rows, 15 leaf rows, 17 wide rows, 19 flags), the final exponentiation
// 34,048, Miller P = 3 47,664. A cofactor-ladder block of one lane takes
// 44,336 bytes, a Miller block of one group at P = 3 77,680: inside the
// 227 KB of an SM.
//
// Ranges: the ops see exactly the values the plain loops see, so every
// intermediate stays in the reference's proven budget (csrc/fq_mont.cu's
// note).

#include "fq_arith.cuh"

namespace {

constexpr int kWords = 8;             // int32 words per op
constexpr int kAdd = 1, kSub = 2, kNeg = 3, kNorm = 4, kSel = 5, kLoad = 6,
              kSgn = 7, kFand = 8;         // 9: fnot
constexpr int kIsz = 17, kBil = 32;       // 16: mul
constexpr int kNormFull = kL + 3;     // rounds to the unique signed-top form
constexpr int kMaxThreads = 256 + 32;  // at most 8 consumer warps, and the producer warp
constexpr int kRing = 8;              // records in flight (ops/fq_program.py RING)
constexpr int kScrPoint = 2 * kScrWords;   // a group's exchange words (two products)
constexpr int kHdr = 16;              // a record's header words (HDR)
constexpr int kNextOff = 7, kNextWords = 8;
constexpr int kRun = 9;               // 1: a run record (ops/fq_program.py REC_RUN)
constexpr int kFoldTab = 10;          // where the fold table lies (0: none)
constexpr int kE2 = 11, kE3 = 12;     // linear ops in phases E2 and E3

struct Prog {
  const int* records;        // the bundle records, 16-byte aligned
  const int* ring0;          // [kRing][2] offset and words of records 0 .. kRing - 1
  const int* const_regs;     // [n_const]
  const int* in_regs[2];     // [in_rows[g]]
  const int* out_regs;       // [out_rows]
  const long long* consts;   // [n_const][kL]
  const int* d_idx;          // [n_digits] table index of each window digit
  const int* d_sign;         // [n_digits] its sign
  int n_records, n_const, nreg, nflag, nx, ng, n_digits, slot_words;
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
  long long* stamps;               // null, or [n_records][kMarks] + 1 clock64() values
};

// Block 0's clock stamps of a record (thread 0): before the record's wait,
// after it, after phases A, B, C, D and E (each with its barrier; a
// skipped phase stamps at once; a run is all phase B), after the record's
// last barrier. The next record's first stamp closes the producer's fetch.
constexpr int kMarks = 8;

// The block's shared memory: the ring and its mbarriers, the q table, the
// digits, the groups' exchange words, then per lane the register file
// (nreg rows), the leaf operand rows x and y (nx each), the wide rows (ng)
// and the flags.
struct Smem {
  int* ring;
  unsigned long long *full, *empty;   // a slot's record is in / has been read
  unsigned* qz;                        // the q table of the group REDCs
  int *d_idx, *d_sign;
  int* scr;
  long long *regs, *x, *y, *g;
  int* flags;
  int reg_r, x_r, g_r, flag_r;     // per lane
};

__device__ __forceinline__ Smem smem_of(char* base, const Prog& p, int tile, int scr_words) {
  Smem s;
  s.ring = reinterpret_cast<int*>(base);
  base += 4 * kRing * p.slot_words;
  s.full = reinterpret_cast<unsigned long long*>(base);
  s.empty = s.full + kRing;
  base += 16 * kRing;
  s.qz = reinterpret_cast<unsigned*>(base);
  base += 4 * kQzWords;
  const int dpad = (p.n_digits + 3) & ~3;
  s.d_idx = reinterpret_cast<int*>(base);
  s.d_sign = s.d_idx + dpad;
  base += 8 * dpad;
  s.scr = reinterpret_cast<int*>(base);
  base += 4 * scr_words;
  s.reg_r = p.nreg * kL;
  s.x_r = p.nx * kL;
  s.g_r = p.ng * kWPitch;
  s.flag_r = (p.nflag + 3) & ~3;
  s.regs = reinterpret_cast<long long*>(base);
  s.x = s.regs + tile * s.reg_r;
  s.y = s.x + tile * s.x_r;
  s.g = s.y + tile * s.x_r;
  s.flags = reinterpret_cast<int*>(s.g + tile * s.g_r);
  return s;
}

// ---------------------------------------------------------------------------
// The ring: TMA bulk copies completing on mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One record into a slot (the producer): the slot's full mbarrier expects its
// bytes.
__device__ __forceinline__ void fetch_record(int* dst, const int* src, int words,
                                             unsigned long long* bar) {
  const unsigned bytes = static_cast<unsigned>(words) * 4u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool try_bar(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A consumer's wait for a record (normally in long before).
__device__ __forceinline__ void wait_bar(unsigned long long* bar, unsigned parity) {
  while (!try_bar(bar, parity)) {
  }
}

// The producer's wait, mostly for the consumers to release a slot: a nap
// between tries, so that its polling takes no issue slots from the
// consumer warp that shares its SM sub-partition.
constexpr unsigned kNapNs = 256;
__device__ __forceinline__ void wait_bar_napping(unsigned long long* bar, unsigned parity) {
  while (!try_bar(bar, parity)) __nanosleep(kNapNs);
}

// ---------------------------------------------------------------------------
// Linear ops and the tower products' pre-sums and gamma sums
// ---------------------------------------------------------------------------

// One linear op on a lane. The row ops (add, sub, neg, sel, load) share
// one branch-free path, d = (+-a) + (+-b or 0) with the source rows chosen
// first, so the threads of a warp on different ops do not split; norm and
// the flag ops are rare and take their own. A phase never reads a register
// it writes: both source rows are loaded whole before the first store, so
// the loads overlap.
__device__ __forceinline__ void linear(const int* wp, const int* rec, const Smem& s,
                                       long long* R, int* Fl) {
  const int4 w0 = reinterpret_cast<const int4*>(wp)[0];
  const int4 w1 = reinterpret_cast<const int4*>(wp)[1];
  const int code = w0.x;
  if (code >= kSgn) {
    Fl[w0.y] = code == kSgn ? s.d_sign[w1.y] < 0
                            : code == kFand ? Fl[w0.z] & Fl[w0.w] : !Fl[w0.z];
    return;
  }
  if (code == kNorm) {
    long long a[kL];
    load_row(R + w0.z * kL, a);
    carry_rounds(a);
    store_row(R + w0.y * kL, a);
    return;
  }
  int ra = w0.z, rb = w0.w;
  if (code == kSel) ra = Fl[w1.x] ? w0.z : w0.w;
  if (code == kLoad) ra = rec[w1.z + s.d_idx[w1.y]];
  const bool two = code == kAdd || code == kSub;
  if (!two) rb = ra;
  const long long sa = code == kNeg ? -1 : 0, sb = code == kSub ? -1 : 0;
  const long long mb = two ? -1 : 0;
  long long a[kL], b[kL];
  load_row(R + ra * kL, a);
  load_row(R + rb * kL, b);
#pragma unroll
  for (int j = 0; j < kL; ++j) a[j] = ((a[j] ^ sa) - sa) + (((b[j] ^ sb) - sb) & mb);
  store_row(R + w0.y * kL, a);
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
static_assert(kNumKinds == 5, "FQ_PROGRAM_KIND names kinds 0 .. 4");

// One thread's multiply or leaf (phase B), the Miller kernel's: csrc/
// fq_arith.cuh's narrow32, schoolbook and wide_norm32, as the chain kernel
// runs them (its REDC in phase D is fq_arith.cuh's redc).
__device__ __forceinline__ void thread_schoolbook(const long long* xs, const long long* ys,
                                                  long long* dst, bool is_mul) {
  long long x[kL], y[kL];
  load_row(xs, x);
  load_row(ys, y);
  int x32[kL], y32[kL];
  narrow32(x, x32);
  narrow32(y, y32);
  long long c[kW];
  schoolbook(x32, y32, c);
  if (is_mul) {
    store_row(dst, c);
  } else {
    int wn[kW];
    wide_norm32(c, wn);
    int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      d[q] = make_int4(wn[4 * q], wn[4 * q + 1], wn[4 * q + 2], wn[4 * q + 3]);
  }
}

// ---------------------------------------------------------------------------
// A bundle
// ---------------------------------------------------------------------------

__device__ __forceinline__ void phase_sync(int nw) {
  if (nw == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"r"(nw * 32) : "memory");
  }
}

// i / d for the block's few divisors (d <= 2^16, i < 2^16): one wide
// multiply by ceil(2^32 / d), made once a block, instead of a division.
struct Div {
  unsigned long long m;
  __device__ explicit Div(int d) : m(((1ULL << 32) + d - 1) / static_cast<unsigned>(d)) {}
  __device__ __forceinline__ int operator()(int i) const {
    return static_cast<int>((static_cast<unsigned long long>(static_cast<unsigned>(i)) * m) >> 32);
  }
};

// The block's lanes: their count, and division by it and by 28 times it.
struct Lanes {
  int n;
  Div by_n, by_limb, by_row;      // by n, 14 n, 28 n
};

// Phase B's item gi (multiplies first, then leaves): its operand rows and
// where its columns go; true for a multiply.
__device__ __forceinline__ bool b_item(int gi, int mul_items, const int* mul,
                                       const int* leaf_tab, const Smem& s, const Lanes& ln,
                                       const long long*& xs, const long long*& ys,
                                       long long*& dst) {
  const int nl = ln.n;
  if (gi < mul_items) {
    const int o = ln.by_n(gi), l = gi - o * nl;
    const int4 w = reinterpret_cast<const int4*>(mul + o * kWords)[0];
    const long long* R = s.regs + l * s.reg_r;
    xs = R + w.z * kL;
    ys = R + w.w * kL;
    dst = s.g + l * s.g_r + mul[o * kWords + 6] * kWPitch;
    return true;
  }
  const int j = gi - mul_items, q = ln.by_n(j), l = j - q * nl;
  const int row = leaf_tab[q] * kL;
  dst = s.x + l * s.x_r + row;
  xs = dst;
  ys = s.y + l * s.x_r + row;
  return false;
}

// Phase D's item gi (the multiplies' REDCs, then the products' outputs):
// its wide row, the lane's register file, the output row, the lane and the
// output's slot (-1 for a multiply); for a multiply its op words too
// (true).
__device__ __forceinline__ bool d_item(int gi, int mul_items, const int* mul,
                                       const int* out_tab, const Smem& s, const Lanes& ln,
                                       const long long*& src, long long*& R, const int*& w,
                                       int& out_row, int& l, int& q) {
  const int nl = ln.n;
  if (gi < mul_items) {
    const int o = ln.by_n(gi);
    l = gi - o * nl;
    w = mul + o * kWords;
    src = s.g + l * s.g_r + w[6] * kWPitch;
    out_row = w[1];
    R = s.regs + l * s.reg_r;
    q = -1;
    return true;
  }
  const int j = gi - mul_items;
  q = ln.by_n(j);
  l = j - q * nl;
  const int e = out_tab[q];
  w = mul;
  src = s.g + l * s.g_r + (e >> 16) * kWPitch;
  out_row = e & 0xFFFF;
  R = s.regs + l * s.reg_r;
  return false;
}

// is_zero of a group's REDC result (limb k on lane k): NORM_FULL carry
// rounds more, then the three patterns (zero, q, -q), each group's vote
// read from its half of the ballot, into the flag. Both groups of the warp
// call it; isz says whether this group's item is an is_zero.
__device__ __forceinline__ void group_is_zero(long long r, int k, int lane, bool isz,
                                              const long long* qp, const long long* qn,
                                              int* flag) {
  const long long y = group_rounds(r, k, kNormFull);
  const bool in = lane < kL;
  const int sh = threadIdx.x & 16;
  const unsigned z = __ballot_sync(kFull, !in || y == 0) >> sh & 0xFFFFu;
  const unsigned eq = __ballot_sync(kFull, !in || y == qp[k]) >> sh & 0xFFFFu;
  const unsigned en = __ballot_sync(kFull, !in || y == qn[k]) >> sh & 0xFFFFu;
  if (isz && lane == 0) *flag = z == 0xFFFFu || eq == 0xFFFFu || en == 0xFFFFu;
}

// One bundle (its record in shared memory) over the block's lanes, on
// the consumer warps. Thread items, i = tid, tid + threads, ...: an op's
// lanes side by side; group items likewise by group, a warp's two groups
// on items base and base + 1 (where base + 1 is past the end the second
// repeats the first's item and stores nothing, so both always run group
// code together: full-warp shuffles). Phases A and E run the same code
// (the pass loop), so the linear ops' instructions are fetched once a
// bundle.
template <bool kGroups>
__device__ __forceinline__ void bundle(const int* rec, const Smem& s, const Lanes& ln,
                                       int warps, long long* st) {
  const int nl = ln.n;
  const int n_a = rec[1], n_m = rec[2], n_p = rec[3], n_e = rec[4];
  const int n_leaf = rec[5], n_out = rec[6], n_e2 = rec[kE2], n_e3 = rec[kE3];
  const int* lin = rec + kHdr;
  const int* mul = lin + n_a * kWords;
  const int* bil = mul + n_m * kWords;
  const int* lin_e = bil + n_p * kWords;
  const int* leaf_tab = lin_e + (n_e + n_e2 + n_e3) * kWords;
  const int* out_tab = leaf_tab + n_leaf;
  const int mul_items = n_m * nl;
  // phase B on groups: where one leaf a group would take more than one
  // round of the block's groups, the leaves go two a group (their pairs)
  // and the multiplies' items are padded to even, so that a warp's two
  // groups run one code; otherwise the multiplies and the leaves are dealt
  // one a group, as they come
  const bool pairs = kGroups && mul_items + n_leaf * nl > 2 * warps;
  const int mul_slots = pairs ? (mul_items + 1) & ~1 : mul_items;
  const int leaf_items = pairs ? (n_leaf * nl + 1) >> 1 : n_leaf * nl;
  // phase A: the linear ops, the products' a pre-sums (one per product,
  // limb and lane), and from the next warp boundary their b pre-sums
  const int pre = n_p * kL * nl;
  const int b_pre = (n_a * nl + pre + 31) & ~31;
  const int items_a = n_p ? b_pre + pre : n_a * nl, items_b = mul_slots + leaf_items;
  const int items_c = n_p * kW * nl, items_e = n_e * nl;
  const int items_d = (n_m + n_out) * nl;
  const int per_item = kGroups ? kGroup : 1;   // threads of a schoolbook or REDC
  const int need = max(max(max(items_a, items_c), max(items_e, max(n_e2, n_e3) * nl)),
                       per_item * max(items_b, items_d));
  const int nw = max(1, min(warps, (need + 31) >> 5));
  const int tid = threadIdx.x;
  if ((tid >> 5) >= nw) return;
  const int nt = nw * 32;
  const int warp = tid >> 5, half = (tid >> 4) & 1, lane = tid & 15, k = min(lane, kL - 1);
  int* scr = s.scr + (tid >> 4) * kScrPoint;

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      if (st) st[2] = clock64();
      bool open = items_a > 0;       // a phase ran since the last barrier
      if (n_m + n_p) {
        if (open) phase_sync(nw);
        if constexpr (kGroups) {
          // (B) on groups (the ladder kernel): a multiply's schoolbook, its
          // raw columns into its wide row; a leaf's schoolbook
          // wide-normalized, its int32 columns over its own x row. Items
          // one a group: a warp whose other item is a leaf wide-normalizes
          // a multiply's columns too (one code), and stores them raw.
          const int singles = pairs ? mul_items : items_b;
          for (int base = warp * 2; base < items_b; base += nw * 2) {
            if (base < (pairs ? mul_slots : items_b)) {
              const bool own = base + half < singles;
              const long long *xs, *ys;
              long long* dst;
              const bool is_mul =
                  b_item(own ? base + half : base, mul_items, mul, leaf_tab, s, ln, xs, ys, dst);
              long long lo, hi;
              group_schoolbook(xs[k], ys[k], scr, lane, k, lo, hi);
              const int partner = base + 1 < singles ? base + 1 : base;
              int wlo = 0, whi = 0;
              if (partner >= mul_items) group_wide_norm(lo, hi, k, wlo, whi);
              if (own && lane < kL) {
                if (is_mul) {
                  dst[lane] = lo;
                  dst[kL + lane] = hi;
                } else {
                  reinterpret_cast<int*>(dst)[lane] = wlo;
                  reinterpret_cast<int*>(dst)[kL + lane] = whi;
                }
              }
            } else {
              // pairs: leaves 2p and 2p + 1 of pair p (past the end the
              // second repeats the first and stores nothing), interleaved
              const int p0 = base - mul_slots, leaves = n_leaf * nl;
              const bool own = p0 + half < leaf_items;
              const int pr = own ? p0 + half : p0;
              const int ja = 2 * pr, jb = min(ja + 1, leaves - 1);
              const bool own_b = own && ja + 1 < leaves;
              const int qa = ln.by_n(ja), la = ja - qa * nl, qb = ln.by_n(jb), lb = jb - qb * nl;
              long long* xa = s.x + la * s.x_r + leaf_tab[qa] * kL;
              const long long* ya = s.y + la * s.x_r + leaf_tab[qa] * kL;
              long long* xb = s.x + lb * s.x_r + leaf_tab[qb] * kL;
              const long long* yb = s.y + lb * s.x_r + leaf_tab[qb] * kL;
              long long loa, hia, lob, hib;
              group_schoolbook2(xa[k], ya[k], xb[k], yb[k], scr, lane, k, loa, hia, lob, hib);
              int wla, wha, wlb, whb;
              group_wide_norm(loa, hia, k, wla, wha);
              group_wide_norm(lob, hib, k, wlb, whb);
              if (own && lane < kL) {
                reinterpret_cast<int*>(xa)[lane] = wla;
                reinterpret_cast<int*>(xa)[kL + lane] = wha;
              }
              if (own_b && lane < kL) {
                reinterpret_cast<int*>(xb)[lane] = wlb;
                reinterpret_cast<int*>(xb)[kL + lane] = whb;
              }
            }
          }
        } else {
          // (B) on threads (the Miller kernel): one thread a multiply's
          // schoolbook into its wide row, or a leaf's wide-normalized
          // columns over its own x row
          for (int gi = tid; gi < items_b; gi += nt) {
            const long long *xs, *ys;
            long long* dst;
            const bool is_mul = b_item(gi, mul_items, mul, leaf_tab, s, ln, xs, ys, dst);
            thread_schoolbook(xs, ys, dst, is_mul);
          }
        }
        phase_sync(nw);
        if (st) st[3] = clock64();

        // (C) products' gamma sums, one item per (product, column, lane)
        if (n_p) {
          for (int i = tid; i < items_c; i += nt) {
            const int o = ln.by_row(i), r = i - o * nl * kW, l = r / kW, col = r - l * kW;
            const int* w = bil + o * kWords;
            FQ_PROGRAM_KIND(w[0] - kBil, gamma_col, (s.x + l * s.x_r + w[2] * kL,
                                                     s.g + l * s.g_r + w[3] * kWPitch, col))
          }
          phase_sync(nw);
        }
        if (st) st[4] = clock64();

        // (D) every REDC (and is_zero's compare): the multiplies', then the
        // products' outputs, each with the folded norm of its phase E where
        // it has one; on groups each wide row's column pair read into
        // registers (group_redc_regs), on threads one thread a row
        if constexpr (kGroups) {
          for (int base = warp * 2; base < items_d; base += nw * 2) {
            const bool own = base + half < items_d;
            const int gi = own ? base + half : base;
            const long long* src;
            long long* R;
            const int* w;
            int out_row, l, q;
            const bool is_mul =
                d_item(gi, mul_items, mul, out_tab, s, ln, src, R, w, out_row, l, q);
            const long long o = group_redc_regs(src[k], src[kL + k], k, s.qz);
            const bool isz = own && is_mul && w[0] == kIsz;
            if (__any_sync(kFull, isz))
              group_is_zero(o, k, lane, isz, R + (isz ? w[4] : 0) * kL,
                            R + (isz ? w[5] : 0) * kL, s.flags + l * s.flag_r + out_row);
            if (own && !isz && lane < kL) R[out_row * kL + lane] = o;
          }
        } else {
          for (int gi = tid; gi < items_d; gi += nt) {
            const long long* src;
            long long* R;
            const int* w;
            int out_row, l, q;
            const bool is_mul =
                d_item(gi, mul_items, mul, out_tab, s, ln, src, R, w, out_row, l, q);
            long long c[kW];
            load_row(src, c);
            long long res[kL];
            redc(c, res);
            if (!is_mul || w[0] != kIsz) {
              store_row(R + out_row * kL, res);
            } else {
#pragma unroll 1
              for (int r = 0; r < kNormFull; ++r) carry_round(res);
              const long long* qp = R + w[4] * kL;
              const long long* qn = R + w[5] * kL;
              bool z = true, eq = true, en = true;
#pragma unroll
              for (int j = 0; j < kL; ++j) {
                z = z && res[j] == 0;
                eq = eq && res[j] == qp[j];
                en = en && res[j] == qn[j];
              }
              s.flags[l * s.flag_r + out_row] = z || eq || en;
            }
          }
        }
        // the folded norms: each output's item again, on the group or
        // thread that stored it (its own limbs: no barrier), three more
        // carry rounds into the norm's register
        if (rec[kFoldTab]) {
          const int* fold = rec + rec[kFoldTab];
          if constexpr (kGroups) {
            for (int base = warp * 2; base < items_d; base += nw * 2) {
              const bool own = base + half < items_d;
              const int gi = own ? base + half : base;
              const long long* src;
              long long* R;
              const int* w;
              int out_row, l, q;
              d_item(gi, mul_items, mul, out_tab, s, ln, src, R, w, out_row, l, q);
              const int f = q >= 0 ? fold[q] : 0;
              if (__any_sync(kFull, f != 0)) {
                const long long v = group_rounds(R[out_row * kL + k], k, 3);
                if (own && f && lane < kL) R[(f - 1) * kL + lane] = v;
              }
            }
          } else {
            for (int gi = tid; gi < items_d; gi += nt) {
              const long long* src;
              long long* R;
              const int* w;
              int out_row, l, q;
              d_item(gi, mul_items, mul, out_tab, s, ln, src, R, w, out_row, l, q);
              const int f = q >= 0 ? fold[q] : 0;
              if (f) {
                long long x[kL];
                load_row(R + out_row * kL, x);
                carry_rounds(x);
                store_row(R + (f - 1) * kL, x);
              }
            }
          }
        }
        open = true;
      } else if (st) {
        st[3] = st[4] = clock64();
      }
      if (items_e && open) phase_sync(nw);
      if (st) st[5] = clock64();
    }
    // (A) linear ops, one item per (op, lane), and the products' pre-sums,
    // one per (product, operand, limb, lane), the a and the b pre-sums on
    // different warps; (E) linear ops on the bundle's own results
    const int* ops = pass ? lin_e : lin;
    const int lin_items = (pass ? n_e : n_a) * nl;
    const int items = pass ? items_e : items_a;
    for (int i = tid; i < items; i += nt) {
      if (i < lin_items) {
        const int o = ln.by_n(i), l = i - o * nl;
        linear(ops + o * kWords, rec, s, s.regs + l * s.reg_r, s.flags + l * s.flag_r);
      } else if (i < lin_items + pre || i >= b_pre) {
        const bool is_b = i >= b_pre;
        const int j = is_b ? i - b_pre : i - lin_items;
        const int o = ln.by_limb(j), r = j - o * nl * kL, l = r / kL, t = r - l * kL;
        const int* w = bil + o * kWords;
        long long* x = s.x + l * s.x_r + w[2] * kL;
        long long* y = s.y + l * s.x_r + w[2] * kL;
        FQ_PROGRAM_KIND(w[0] - kBil, presum, (is_b, s.regs + l * s.reg_r, rec + w[1], t, x, y))
      }
    }
  }
  // (E2, E3) linear ops that read E's and then E2's results
  const int* ops = lin_e + n_e * kWords;
#pragma unroll 1
  for (int level = 0; level < 2; ++level) {
    const int n_lv = level ? n_e3 : n_e2;
    if (!n_lv) break;
    phase_sync(nw);
    for (int i = tid; i < n_lv * nl; i += nt) {
      const int o = ln.by_n(i), l = i - o * nl;
      linear(ops + o * kWords, rec, s, s.regs + l * s.reg_r, s.flags + l * s.flag_r);
    }
    ops += n_lv * kWords;
  }
  if (st) st[6] = clock64();
}

// A run record: its multiplies one after another on each lane, from
// operands to stored result, with no barrier between them. Lane k of a
// group reads and stores only limb k of the lane's rows, so each multiply
// sees the one before (the exchange words are fenced by group_schoolbook's
// own __syncwarp). Groups: a group a lane, the column pair in registers
// from schoolbook to REDC (a warp's second group, where it has no lane,
// repeats the first's and stores nothing); threads: a thread a lane,
// narrow32, schoolbook and redc. Stamps: the run is phase B.
template <bool kGroups>
__device__ __forceinline__ void run(const int* rec, const Smem& s, const Lanes& ln, int warps,
                                    long long* st) {
  if (st) st[2] = clock64();
  const int nl = ln.n, n = rec[2];
  const int4* words = reinterpret_cast<const int4*>(rec + kHdr);   // two int4 a multiply
  const int tid = threadIdx.x;
  if constexpr (kGroups) {
    const int nw = min(warps, (nl + 1) >> 1);
    if ((tid >> 5) < nw) {
      const int half = (tid >> 4) & 1, lane = tid & 15, k = min(lane, kL - 1);
      int* scr = s.scr + (tid >> 4) * kScrPoint;
      for (int base = (tid >> 5) * 2; base < nl; base += nw * 2) {
        const bool own = base + half < nl;
        long long* R = s.regs + (own ? base + half : base) * s.reg_r;
        const bool out = own && lane < kL;
#pragma unroll 1
        for (int j = 0; j < n; ++j) {
          const int4 w = words[2 * j];
          long long lo, hi;
          group_schoolbook(R[w.z * kL + k], R[w.w * kL + k], scr, lane, k, lo, hi);
          const long long r = group_redc_regs(lo, hi, k, s.qz);
          if (out) R[w.y * kL + lane] = r;
        }
      }
    }
  } else {
    for (int l = tid; l < nl; l += warps * 32) {
      long long* R = s.regs + l * s.reg_r;
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const int4 w = words[2 * j];
        long long x[kL], y[kL];
        load_row(R + w.z * kL, x);
        load_row(R + w.w * kL, y);
        int x32[kL], y32[kL];
        narrow32(x, x32);
        narrow32(y, y32);
        long long c[kW];
        schoolbook(x32, y32, c);
        long long res[kL];
        redc(c, res);
        store_row(R + w.y * kL, res);
      }
    }
  }
  if (st) st[3] = st[4] = st[5] = st[6] = clock64();
}

// The producer (lane 0 of the block's last warp): records 0 .. kRing - 1
// first, then for each bundle b, once its record is in (for the header's
// place of record b + kRing) and the consumers have released the slot,
// record b + kRing into the same slot.
__device__ __forceinline__ void produce(const Prog& p, const Smem& s) {
  for (int r = 0; r < kRing && r < p.n_records; ++r)
    fetch_record(s.ring + r * p.slot_words, p.records + p.ring0[2 * r], p.ring0[2 * r + 1],
                 s.full + r);
  for (int b = 0; b + kRing < p.n_records; ++b) {
    const int slot = b % kRing;
    const unsigned round = static_cast<unsigned>(b / kRing) & 1u;
    int* rec = s.ring + slot * p.slot_words;
    wait_bar_napping(s.full + slot, round);
    const int off = rec[kNextOff], words = rec[kNextWords];
    wait_bar_napping(s.empty + slot, round);
    fetch_record(rec, p.records + off, words, s.full + slot);
  }
}

template <bool kGroups>
__device__ __forceinline__ void run_program(const Prog& p, const Io& io) {
  extern __shared__ __align__(16) char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warps = (nt >> 5) - 1;        // consumer warps; the last one produces
  const Smem s = smem_of(smem_raw, p, io.tile, warps * 2 * kScrPoint);
  const unsigned lane0 = blockIdx.x * static_cast<unsigned>(io.tile);
  const int nl = static_cast<int>(min(static_cast<unsigned>(io.tile), io.n - lane0));
  constexpr int kHalf = kL / 2;

  if (tid == 0) {
    for (int r = 0; r < kRing; ++r) {
      bar_init(s.full + r);
      bar_init(s.empty + r);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // constants into every lane's registers; the inputs' rows (cp.async); the
  // flags, the digits, the q table and the groups' exchange words
  for (int i = tid; i < nl * p.n_const * kHalf; i += nt) {
    const int row = i / kHalf, piece = i - row * kHalf;
    const int l = row / p.n_const, c = row - l * p.n_const;
    reinterpret_cast<longlong2*>(s.regs + l * s.reg_r + p.const_regs[c] * kL)[piece] =
        reinterpret_cast<const longlong2*>(p.consts + c * kL)[piece];
  }
  for (int g = 0; g < 2; ++g) {
    const int rows = p.in_rows[g];
    for (int i = tid; i < nl * rows * kHalf; i += nt) {
      const int row = i / kHalf, piece = i - row * kHalf;
      const int l = row / rows, r = row - l * rows;
      cp_async16(s.regs + l * s.reg_r + p.in_regs[g][r] * kL + 2 * piece,
                 io.in[g] + (static_cast<long long>(lane0 + l) * rows + r) * kL + 2 * piece);
    }
  }
  for (int l = tid; l < nl; l += nt) {
    int* Fl = s.flags + l * s.flag_r;
    if (p.lane_flag >= 0) Fl[p.lane_flag] = io.lane_flags ? io.lane_flags[lane0 + l] != 0 : 0;
    if (p.uniform_flag >= 0) Fl[p.uniform_flag] = p.uniform_val;
  }
  for (int i = tid; i < p.n_digits; i += nt) {
    s.d_idx[i] = p.d_idx[i];
    s.d_sign[i] = p.d_sign[i];
  }
  for (int i = tid; i < kQzWords; i += nt) s.qz[i] = qz_word(i);
  for (int i = tid; i < warps * 2 * kScrPoint; i += nt) s.scr[i] = 0;
  cp_async_wait_all();
  __syncthreads();

  if ((tid >> 5) == warps) {
    if ((tid & 31) == 0) produce(p, s);
  } else {
    const Lanes ln{nl, Div(nl), Div(nl * kL), Div(nl * 2 * kL)};
    long long* stamp =
        (io.stamps != nullptr && blockIdx.x == 0 && tid == 0) ? io.stamps : nullptr;
    for (int b = 0; b < p.n_records; ++b) {
      const int slot = b % kRing;
      long long* st = stamp ? stamp + b * kMarks : nullptr;
      if (st) st[0] = clock64();
      wait_bar(s.full + slot, static_cast<unsigned>(b / kRing) & 1u);
      if (st) st[1] = clock64();
      const int* rec = s.ring + slot * p.slot_words;
      if (rec[kRun]) {
        run<kGroups>(rec, s, ln, warps, st);
      } else {
        bundle<kGroups>(rec, s, ln, warps, st);
      }
      asm volatile("bar.sync 2, %0;\n" ::"r"(warps * 32) : "memory");
      if (tid == (warps - 1) * 32) bar_arrive(s.empty + slot);   // off warp 0's path
      if (st) st[7] = clock64();
    }
    if (stamp) stamp[p.n_records * kMarks] = clock64();
  }
  __syncthreads();

  // the outputs: rows (16 bytes per thread), then the flag
  for (int i = tid; i < nl * p.out_rows * kHalf; i += nt) {
    const int row = i / kHalf, piece = i - row * kHalf;
    const int l = row / p.out_rows, r = row - l * p.out_rows;
    reinterpret_cast<longlong2*>(io.out + (static_cast<long long>(lane0) * p.out_rows) * kL)[i] =
        reinterpret_cast<const longlong2*>(s.regs + l * s.reg_r + p.out_regs[r] * kL)[piece];
  }
  if (p.out_flag >= 0 && io.out_flags != nullptr) {
    for (int l = tid; l < nl; l += nt)
      io.out_flags[lane0 + l] = static_cast<unsigned char>(s.flags[l * s.flag_r + p.out_flag]);
  }
}

__global__ void __launch_bounds__(kMaxThreads) g2_ladder_kernel(Prog p, Io io) {
  run_program<true>(p, io);
}

__global__ void __launch_bounds__(kMaxThreads) miller_grouped_kernel(Prog p, Io io) {
  run_program<false>(p, io);
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
  kCode, kConsts, kNRecords, kNConst, kNReg, kNFlag, kNX, kNG, kNDigits, kSlotWords,
  kThreadsLane, kOffRecords, kOffRing0, kOffConstRegs, kOffIn0, kOffIn1, kOffOut,
  kInRows0, kInRows1, kOutRows, kLaneFlag, kUniformFlag, kUniformVal, kOutFlag,
  kDigitIdx, kDigitSign, kIn0, kIn1, kLaneFlags, kOut, kOutFlags, kLanes, kStamps,
  kHeaderLen
};

// Bytes of a block's shared memory before the lanes' files, at `threads`.
long long fixed_bytes(const Prog& p, long long threads) {
  return 4LL * kRing * p.slot_words + 16LL * kRing + 4LL * kQzWords +
         8LL * ((p.n_digits + 3) & ~3) + 4LL * kScrPoint * ((threads - 32) / kGroup);
}

// Consumer warps for the widest phase (2 to 8), and the producer warp.
long long threads_for(long long threads_lane, long long tile) {
  long long t = ((threads_lane * tile + 31) / 32) * 32;
  if (t < 64) t = 64;
  if (t > kMaxThreads - 32) t = kMaxThreads - 32;
  return t + 32;
}

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
  p.records = code + h[kOffRecords];
  p.ring0 = code + h[kOffRing0];
  p.const_regs = code + h[kOffConstRegs];
  p.in_regs[0] = code + h[kOffIn0];
  p.in_regs[1] = code + h[kOffIn1];
  p.out_regs = code + h[kOffOut];
  p.consts = reinterpret_cast<const long long*>(h[kConsts]);
  p.d_idx = reinterpret_cast<const int*>(h[kDigitIdx]);
  p.d_sign = reinterpret_cast<const int*>(h[kDigitSign]);
  p.n_records = static_cast<int>(h[kNRecords]);
  p.n_const = static_cast<int>(h[kNConst]);
  p.nreg = static_cast<int>(h[kNReg]);
  p.nflag = static_cast<int>(h[kNFlag]);
  p.nx = static_cast<int>(h[kNX]);
  p.ng = static_cast<int>(h[kNG]);
  p.n_digits = static_cast<int>(h[kNDigits]);
  p.slot_words = static_cast<int>(h[kSlotWords]);
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

  if ((reinterpret_cast<unsigned long long>(p.records) & 15) || (p.slot_words & 3))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long per_lane = 8LL * (p.nreg * kL + 2 * p.nx * kL + p.ng * kWPitch) +
                             4LL * ((p.nflag + 3) & ~3);
  long long tile = (n + d.sms - 1) / d.sms;
  const long long room = kSmemTarget - fixed_bytes(p, kMaxThreads);
  const long long fit = room / per_lane > 0 ? room / per_lane : 1;
  if (tile > fit) tile = fit;
  if (tile < 1) tile = 1;
  io.tile = static_cast<int>(tile);
  const long long threads = threads_for(h[kThreadsLane], tile);
  const long long bytes = fixed_bytes(p, threads) + per_lane * tile;
  if (bytes > d.smem_optin) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>((n + tile - 1) / tile), static_cast<unsigned>(threads),
           static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream)>>>(p, io);
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
