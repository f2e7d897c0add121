// Device arithmetic shared by csrc/fq_mont.cu and csrc/fq_points.cu: the
// port's lazy 29-bit x 14 signed int64 limb layout, the carry rounds, the
// 32-bit narrowing of a multiply operand, the schoolbook into 28 int64
// columns and the interleaved Montgomery reduction, and the cp.async and
// 16-byte shared-memory row helpers. See csrc/fq_mont.cu for the ranges
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

}  // namespace
