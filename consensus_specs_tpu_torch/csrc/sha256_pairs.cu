// SHA-256 Merkle pair hash for Hopper (sm_90a): N 64-byte messages given as
// [N, 16] big-endian uint32 words -> [N, 8] digest words.
//
// Replaces consensus_specs_tpu/ops/sha256_pallas.py::_sha256_pairs_kernel
// (entry point sha256_pairs_pallas): the same function, two compressions per
// lane -- the message block with a rolling 16-word schedule, then the
// constant padding block of a 64-byte message, whose schedule is
// data-independent and folded into the round constants (kPad below).
//
// What bounds it: integer-ALU throughput, not bytes. Per lane the function
// reads 64 bytes and writes 32 (96 B of traffic) but does 3,904 two-input
// 32-bit operations: 64 message rounds of 26 (three rotates and two xors
// each for Sigma0/Sigma1, four for Ch, five for Maj, seven adds), 48
// schedule steps of 13, 64 padding rounds of 25 (W+K folded) and 16
// feed-forward adds. Hopper's three-input LOP3 and IADD3 fuse these into
// 2,288 instructions, 1,664 of them logic, shift or rotate that only the
// integer ALU pipe (64 lanes per clock per SM) executes; at some 17
// instructions per byte the integer pipe, not the 3.35 TB/s, sets the floor.
//
// What the design does about it: one thread per message, the whole chain
// (8 state words, the 16-word schedule window, the saved midstate) kept in
// registers with all 128 rounds unrolled, rotates as single funnel shifts,
// round constants in __constant__ memory read at compile-time indices, and
// no shared memory or synchronisation. The 16 input words arrive as four
// 16-byte vector loads and the 8 digest words leave as two. A ragged N is
// masked by each thread's own bounds check.
//
// Left for later work: lane-major coalesced loads, several lanes per
// thread, and CUDA graphs over the per-level launch chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kRound[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// kRound[i] + W[i] of the padding block of a 64-byte message (0x80 marker,
// bit length 512); the whole schedule is constant, so it folds into one add.
__constant__ uint32_t kPad[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u, 0x649b69c1u, 0xf0fe4786u,
    0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u,
    0xfdb1232bu, 0xc7353eb0u, 0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u, 0x007f3e86u, 0x37088980u,
    0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u,
    0x6ed41a95u, 0x6d437890u, 0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One round; `kw` is K[i] + W[i] already summed.
#define SHA256_ROUND(kw)                                                   \
  do {                                                                     \
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) +     \
                        ((e & f) ^ (~e & g)) + (kw);                       \
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) +         \
                        ((a & b) ^ (a & c) ^ (b & c));                     \
    h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;     \
  } while (0)

__global__ void __launch_bounds__(256)
sha256_pairs_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                    int64_t n) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  uint32_t w[16];
  const uint4* src = in + lane * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = src[q];
    w[4 * q + 0] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }

  uint32_t a = 0x6a09e667u, b = 0xbb67ae85u, c = 0x3c6ef372u, d = 0xa54ff53au;
  uint32_t e = 0x510e527fu, f = 0x9b05688cu, g = 0x1f83d9abu, h = 0x5be0cd19u;

  // Compression 1: the message block, rolling 16-word schedule window.
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      const uint32_t x = w[(i - 15) & 15];
      const uint32_t y = w[(i - 2) & 15];
      wi = w[i & 15] + (rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3)) + w[(i - 7) & 15] +
           (rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10));
      w[i & 15] = wi;
    }
    SHA256_ROUND(kRound[i] + wi);
  }
  const uint32_t m0 = 0x6a09e667u + a, m1 = 0xbb67ae85u + b;
  const uint32_t m2 = 0x3c6ef372u + c, m3 = 0xa54ff53au + d;
  const uint32_t m4 = 0x510e527fu + e, m5 = 0x9b05688cu + f;
  const uint32_t m6 = 0x1f83d9abu + g, m7 = 0x5be0cd19u + h;

  // Compression 2: the constant padding block, schedule folded into kPad.
  a = m0; b = m1; c = m2; d = m3; e = m4; f = m5; g = m6; h = m7;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    SHA256_ROUND(kPad[i]);
  }

  uint4* dst = out + lane * 2;
  dst[0] = make_uint4(m0 + a, m1 + b, m2 + c, m3 + d);
  dst[1] = make_uint4(m4 + e, m5 + f, m6 + g, m7 + h);
}

}  // namespace

// words: [n, 16] uint32, digests: [n, 8] uint32, both 16-byte aligned and
// contiguous; launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int sha256_pairs_launch(const void* words, void* digests,
                                   int64_t n, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sha256_pairs_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), static_cast<uint4*>(digests), n);
  return static_cast<int>(cudaGetLastError());
}
