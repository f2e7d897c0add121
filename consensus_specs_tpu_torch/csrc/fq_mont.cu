// BLS12-381 Montgomery multiply and REDC for Hopper (sm_90a), on the port's
// lazy 29-bit x 14 signed int64 limb layout.
//
//   fq_mul:  [N,14] x [N,14] -> [N,14]   three carry rounds on each input,
//            the 14x14 schoolbook into 28 columns, the 14-step interleaved
//            REDC, three closing carry rounds
//   fq_redc: [N,28] -> [N,14]             the REDC and closing rounds alone
//
// Replaces consensus_specs_tpu/ops/fq.py:450 fq_mul and :413 fq_redc, which
// are XLA programs (no Pallas kernel): in eager PyTorch each is a chain of
// some 130-200 elementwise launches, and every Fq2/Fq6/Fq12 product, square
// root and inversion of the verification path funnels through them. The
// output limbs are bit-identical to the plain version (ops/fq.py,
// fq_mul_plain / fq_redc_plain): same operations, same order, every
// intermediate inside the reference's proven budget, so exact int64
// arithmetic gives the same bits.
//
// What bounds it: bytes, then 64-bit integer multiplies. A lane moves 336
// bytes (fq_mul: two 112-byte inputs, one 112-byte output; fq_redc: 224
// in, 112 out). fq_mul needs 406 limb products (196 schoolbook, 15 per
// REDC step), fq_redc 210; Hopper has no 64 x 64 multiplier, so each takes
// at least one 32 x 32 -> 64 multiply-add (IMAD.WIDE), and the compiler,
// which sees that m and q's limbs fit 29 bits, needs no more than a few.
// For sm_90a with CUDA 12.8, cuobjdump -sass shows 1,784 instructions per
// lane for fq_mul (915 IMAD-class) and 728 for fq_redc (411 IMAD-class);
// at 64 IMAD per clock per SM neither reaches the memory time of its
// bytes, so the floor is the bytes. chip_smoke.py prints the counts.
//
// Design: one thread per lane, one simple pass. The limbs and the 28 columns
// live in registers (every loop below has constant trip counts and unrolls),
// reads and writes are per-thread 8-byte loads and stores of the lane's
// contiguous limbs, and a ragged N is masked by each thread's bounds check.
// Signed shifts: >> on long long is arithmetic under nvcc, which the borrow
// propagation relies on; the left shift of the top carry is written as a
// multiply by 2^29 so that no negative value is shifted left.
//
// Left for later work: 32-bit limbs with IMAD.WIDE accumulation, several
// lanes per thread with coalesced lane-major loads, and fusing the tower's
// gamma recombination into the REDC.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 29;
constexpr int kL = 14;
constexpr long long kMask = (1LL << kB) - 1;
constexpr long long kRadix = 1LL << kB;
constexpr long long kQinvNeg = 0x1ffcfffdLL;   // -q^{-1} mod 2^29

// q in 29-bit limbs, least significant first.
__constant__ long long kQ[kL] = {
    0x1fffaaabLL, 0x0ff7ffffLL, 0x14ffffeeLL, 0x17fffd62LL, 0x0f6241eaLL,
    0x09507b58LL, 0x0afd9cc3LL, 0x109e70a2LL, 0x1764774bLL, 0x121a5d66LL,
    0x12c6e9edLL, 0x12ffcd34LL, 0x00111ea3LL, 0x0000000dLL};

template <int N>
__device__ __forceinline__ void carry_rounds(long long (&t)[N]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    long long hi[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      hi[k] = t[k] >> kB;
      t[k] &= kMask;
    }
#pragma unroll
    for (int k = 1; k < N; ++k) t[k] += hi[k - 1];
    t[N - 1] += hi[N - 1] * kRadix;
  }
}

// cols[0..27] -> out[0..13]: the interleaved reduction and closing rounds.
__device__ __forceinline__ void redc(long long (&c)[2 * kL],
                                     long long (&out)[kL]) {
  long long carry = 0;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const long long v = c[i] + carry;
    const long long m = ((v & kMask) * kQinvNeg) & kMask;
    carry = (v + m * kQ[0]) >> kB;
#pragma unroll
    for (int j = 1; j < kL; ++j) c[i + j] += m * kQ[j];
  }
#pragma unroll
  for (int k = 0; k < kL; ++k) out[k] = c[kL + k];
  out[0] += carry;
  carry_rounds(out);
}

__global__ void __launch_bounds__(128)
fq_mul_kernel(const long long* __restrict__ a, const long long* __restrict__ b,
              long long* __restrict__ out, long long n) {
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  long long x[kL], y[kL];
#pragma unroll
  for (int k = 0; k < kL; ++k) {
    x[k] = a[lane * kL + k];
    y[k] = b[lane * kL + k];
  }
  carry_rounds(x);
  carry_rounds(y);
  long long c[2 * kL];
#pragma unroll
  for (int k = 0; k < 2 * kL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < kL; ++i) {
#pragma unroll
    for (int j = 0; j < kL; ++j) c[i + j] += x[i] * y[j];
  }
  long long r[kL];
  redc(c, r);
#pragma unroll
  for (int k = 0; k < kL; ++k) out[lane * kL + k] = r[k];
}

__global__ void __launch_bounds__(128)
fq_redc_kernel(const long long* __restrict__ cols, long long* __restrict__ out,
               long long n) {
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  long long c[2 * kL];
#pragma unroll
  for (int k = 0; k < 2 * kL; ++k) c[k] = cols[lane * 2 * kL + k];
  long long r[kL];
  redc(c, r);
#pragma unroll
  for (int k = 0; k < kL; ++k) out[lane * kL + k] = r[k];
}

constexpr int kThreads = 128;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// a, b, out: device pointers to n contiguous [14] int64 lanes. Returns the
// cudaError_t of the launch (0 on success).
int fq_mul_launch(const void* a, const void* b, void* out, long long n,
                  void* stream) {
  if (n <= 0) return 0;
  fq_mul_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(a), static_cast<const long long*>(b),
      static_cast<long long*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// cols: n contiguous [28] int64 lanes; out: n [14] lanes.
int fq_redc_launch(const void* cols, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  fq_redc_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cols), static_cast<long long*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
