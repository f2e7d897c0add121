// Device arithmetic shared by csrc/fq_mont.cu and csrc/fq_points.cu: the
// port's lazy 29-bit x 14 signed int64 limb layout, the carry rounds, the
// 32-bit narrowing of a multiply operand, the schoolbook into 28 int64
// columns and the interleaved Montgomery reduction, one thread a product
// or spread over a 16-thread group, and the cp.async and 16-byte
// shared-memory row helpers. See csrc/fq_mont.cu for the ranges
// each step relies on (tests/test_torch_fq_tower.py proves them from the
// reference's budget). Includes the compiled tower products (Table<K>).

#pragma once

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

// The tower products' tables as code: Table<0 .. kNumKinds - 1>.
#include "fq_tables.cuh"

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

// ---------------------------------------------------------------------------
// A multiply over a 16-thread group (a half-warp): lane k (k = min(lane,
// 13)) owns limb k and columns k and k + 14. A warp's two groups always run
// group code together (a group without an item repeats its partner's and
// stores nothing), so every shuffle is a full-warp one.
// ---------------------------------------------------------------------------

constexpr int kGroup = 16;            // threads of a schoolbook or a REDC
constexpr unsigned kFull = 0xFFFFFFFFu;   // both groups of a warp run group code together
constexpr int kScrWords = 72;         // a group's exchange (group_schoolbook)

// narrow32 of an operand, limb k of it: the first carry round in int64 cut
// to int32 (its low 32 bits are narrow32's), then two rounds in int32, the
// carry from lane k - 1 by a shuffle; the top limb keeps its own overflow.
__device__ __forceinline__ int narrow_limb(long long v, int k) {
  const long long h = v >> kB;
  unsigned t = static_cast<unsigned>(v & kMask);
  const int c = __shfl_up_sync(kFull, static_cast<int>(h), 1, kGroup);
  if (k) t += static_cast<unsigned>(c);
  if (k == kL - 1) t += static_cast<unsigned>(h) << kB;
  int x = static_cast<int>(t);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hi = x >> kB;
    unsigned u = static_cast<unsigned>(x & static_cast<int>(kMask));
    const int ci = __shfl_up_sync(kFull, hi, 1, kGroup);
    if (k) u += static_cast<unsigned>(ci);
    if (k == kL - 1) u += static_cast<unsigned>(hi) << kB;
    x = static_cast<int>(u);
  }
  return x;
}

// Columns k (lo) and k + 14 (hi) of schoolbook(narrow32(x), narrow32(y)),
// xk and yk limb k of the two operands: the narrowed limbs go through the
// group's exchange words: x at 0..13, y
// at 29..42 behind 13 zeros (so scr[29 + k - i] is y_{k-i}, or 0 for i > k)
// and at 44..57 ahead of 14 zeros (scr[58 + k - i] is y_{14+k-i}, or 0 for
// i <= k). Every lane runs the same 28 multiply-adds, the same integer sums
// as schoolbook().
__device__ __forceinline__ void group_schoolbook(long long xk, long long yk, int* scr,
                                                 int lane, int k, long long& lo,
                                                 long long& hi) {
  const int x = narrow_limb(xk, k);
  const int y = narrow_limb(yk, k);
  __syncwarp();                  // the group's last item has read its exchange
  if (lane < kL) {
    scr[lane] = x;
    scr[29 + lane] = y;
    scr[44 + lane] = y;
  }
  __syncwarp();
  const int* ylo = scr + 29 + k;
  const int* yhi = scr + 58 + k;
  long long l0 = 0, l1 = 0, h0 = 0, h1 = 0;
#pragma unroll
  for (int i = 0; i < kL; i += 2) {
    l0 = mad_wide_s32(scr[i], ylo[-i], l0);
    h0 = mad_wide_s32(scr[i], yhi[-i], h0);
    l1 = mad_wide_s32(scr[i + 1], ylo[-i - 1], l1);
    h1 = mad_wide_s32(scr[i + 1], yhi[-i - 1], h1);
  }
  lo = l0 + l1;
  hi = h0 + h1;
}

// group_schoolbook of two products at once (a and b), their exchange
// words 72 apart: the two dependency chains interleave.
__device__ __forceinline__ void group_schoolbook2(long long xa, long long ya, long long xb,
                                                  long long yb, int* scr, int lane, int k,
                                                  long long& loa, long long& hia,
                                                  long long& lob, long long& hib) {
  const int x0 = narrow_limb(xa, k);
  const int y0 = narrow_limb(ya, k);
  const int x1 = narrow_limb(xb, k);
  const int y1 = narrow_limb(yb, k);
  __syncwarp();                  // the group's last item has read its exchange
  if (lane < kL) {
    scr[lane] = x0;
    scr[29 + lane] = y0;
    scr[44 + lane] = y0;
    scr[kScrWords + lane] = x1;
    scr[kScrWords + 29 + lane] = y1;
    scr[kScrWords + 44 + lane] = y1;
  }
  __syncwarp();
  const int* s1 = scr + kScrWords;
  long long a0 = 0, a1 = 0, a2 = 0, a3 = 0, b0 = 0, b1 = 0, b2 = 0, b3 = 0;
#pragma unroll
  for (int i = 0; i < kL; i += 2) {
    a0 = mad_wide_s32(scr[i], scr[29 + k - i], a0);
    a1 = mad_wide_s32(scr[i], scr[58 + k - i], a1);
    b0 = mad_wide_s32(s1[i], s1[29 + k - i], b0);
    b1 = mad_wide_s32(s1[i], s1[58 + k - i], b1);
    a2 = mad_wide_s32(scr[i + 1], scr[28 + k - i], a2);
    a3 = mad_wide_s32(scr[i + 1], scr[57 + k - i], a3);
    b2 = mad_wide_s32(s1[i + 1], s1[28 + k - i], b2);
    b3 = mad_wide_s32(s1[i + 1], s1[57 + k - i], b3);
  }
  loa = a0 + a2;
  hia = a1 + a3;
  lob = b0 + b2;
  hib = b1 + b3;
}

// wide_norm32 of a leaf's columns across the group: column j takes the
// carry of column j - 1 (lane k - 1's, or lane 13's low column for column
// 14), column 27 keeps its own overflow; two rounds in int64, one in int32.
__device__ __forceinline__ void group_wide_norm(long long lo, long long hi, int k, int& wlo,
                                                int& whi) {
  const int src = k ? k - 1 : kL - 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long hl = lo >> kB, hh = hi >> kB;
    lo &= kMask;
    hi &= kMask;
    const long long pl = __shfl_sync(kFull, hl, src, kGroup);
    const long long ph = __shfl_sync(kFull, hh, src, kGroup);
    if (k) {
      lo += pl;
      hi += ph;
    } else {
      hi += pl;
    }
    if (k == kL - 1) hi += hh * kRadix;
  }
  int a = static_cast<int>(lo), b = static_cast<int>(hi);
  const int hl = a >> kB, hh = b >> kB;
  a &= static_cast<int>(kMask);
  b &= static_cast<int>(kMask);
  const int pl = __shfl_sync(kFull, hl, src, kGroup);
  const int ph = __shfl_sync(kFull, hh, src, kGroup);
  unsigned ua = static_cast<unsigned>(a), ub = static_cast<unsigned>(b);
  if (k) {
    ua += static_cast<unsigned>(pl);
    ub += static_cast<unsigned>(ph);
  } else {
    ub += static_cast<unsigned>(pl);
  }
  if (k == kL - 1) ub += static_cast<unsigned>(hh) << kB;
  wlo = static_cast<int>(ua);
  whi = static_cast<int>(ub);
}

// n carry rounds of a row held a limb a lane (int64), as a loop.
__device__ __forceinline__ long long group_rounds(long long o, int k, int n) {
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    const long long h = o >> kB;
    o &= kMask;
    const long long c = __shfl_up_sync(kFull, h, 1, kGroup);
    if (k) o += c;
    if (k == kL - 1) o += h * kRadix;
  }
  return o;
}

// The q table of the group REDCs: qz[16 + d] = q_d for d = 1 .. 13, zero
// for every other index (kQzWords words).
constexpr int kQzWords = 48;
__device__ __forceinline__ unsigned qz_word(int i) {
  const int d = i - 16;
  return d >= 1 && d < kL ? static_cast<unsigned>(kQ[d]) : 0u;
}

// redc() of a row held a column pair a lane (lo: column k, hi: column
// 14 + k; lanes 14 and 15 repeat lane 13), limb k of the result, with no
// shared-memory row: digit i is made by every lane from column i (lane
// i's lo, broadcast by a shuffle) plus the carry of digit i - 1, so the
// digits and carries are redc()'s integers; each lane adds m_i q_{k-i} to
// its low column (k > i) and m_i q_{14+k-i} to its high column (k < i),
// the terms redc() adds to columns k and 14 + k, in the same order. Then
// lane 0 takes the last carry and three carry rounds run across the lanes.
// The chain of a digit: a 64-bit shuffle, an add, a 32-bit multiply and
// the next lane's dependent mad.wide (~60 cycles).
__device__ __forceinline__ long long group_redc_regs(long long lo, long long hi, int k,
                                                     const unsigned* qz) {
  long long carry = 0;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const long long v = __shfl_sync(kFull, lo, i, kGroup) + carry;
    const unsigned m = (static_cast<unsigned>(v) * static_cast<unsigned>(kQinvNeg)) &
                       static_cast<unsigned>(kMask);
    carry = mad_wide_u32(m, static_cast<unsigned>(kQ[0]), v) >> kB;
    lo = mad_wide_u32(m, qz[16 + k - i], lo);
    hi = mad_wide_u32(m, qz[16 + kL + k - i], hi);
  }
  if (k == 0) hi += carry;
  return group_rounds(hi, k, 3);
}

}  // namespace
