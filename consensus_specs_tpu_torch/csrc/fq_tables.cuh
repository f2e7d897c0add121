// Generated by consensus_specs_tpu_torch/ops/fq_tables_gen.py from
// ops/fq_tower.py::TABLES; do not edit. Regenerate with
//   python -m consensus_specs_tpu_torch.ops.fq_tables_gen
//
// Table<K>, K the product's kind (Bilinear.kind): P leaves, R outputs,
// Ca and Cb input coefficients of a and b (b has one more, Montgomery
// one, with one_col), norm_in (three carry rounds on the inputs first).
// alpha(a, x) / beta(b, y): x[k * kL] = alpha[k] . (a[c * kL])_c for one
// limb of one lane (x points at that limb of row 0; a is a pointer to it
// in row 0 of contiguous rows, or any source whose a[c * kL] reads it in
// coefficient c, such as a register file's gather). gamma(lv, g):
// g[r * kWPitch] = sum_k gamma[r][k] * lv[k * kW] for one column of one
// lane (lv: int32 leaf columns). kL, kW and kWPitch come from the
// including file (csrc/fq_arith.cuh).

#pragma once

constexpr int kNumKinds = 5;

// Montgomery one (R mod q), 29-bit limbs, least significant first.
__constant__ long long kOneMont[14] = {0x03a9fb84LL, 0x0ba00690LL, 0x071288f1LL, 0x0f59bcc5LL, 0x126cb614LL, 0x0585bf36LL, 0x1b85ac3dLL, 0x1cf856faLL, 0x1891ecbdLL, 0x1a7eec05LL, 0x155a88f0LL, 0x0741ac6dLL, 0x1317c30fLL, 0x00000009LL};

template <int K>
struct Table;

// fq2_mul
template <>
struct Table<0> {
  static constexpr int P = 3, R = 2, Ca = 2, Cb = 2;
  static constexpr bool one_col = false, norm_in = false;
  template <class Src>
  static __device__ __forceinline__ void alpha(
      const Src& a, long long* __restrict__ x) {
    const long long a0 = a[0 * kL];
    const long long a1 = a[1 * kL];
    x[0 * kL] = a0;
    x[1 * kL] = a1;
    x[2 * kL] = a0 + a1;
  }
  template <class Src>
  static __device__ __forceinline__ void beta(
      const Src& b, long long* __restrict__ y) {
    const long long b0 = b[0 * kL];
    const long long b1 = b[1 * kL];
    y[0 * kL] = b0;
    y[1 * kL] = b1;
    y[2 * kL] = b0 + b1;
  }
  static __device__ __forceinline__ void gamma(
      const int* __restrict__ lv, long long* __restrict__ g) {
    const long long v0 = lv[0 * kW];
    const long long v1 = lv[1 * kW];
    const long long v2 = lv[2 * kW];
    g[0 * kWPitch] = v0 - v1;
    g[1 * kWPitch] = -v0 - v1 + v2;
  }
};

// fq12_mul
template <>
struct Table<1> {
  static constexpr int P = 54, R = 12, Ca = 12, Cb = 12;
  static constexpr bool one_col = false, norm_in = false;
  template <class Src>
  static __device__ __forceinline__ void alpha(
      const Src& a, long long* __restrict__ x) {
    const long long a0 = a[0 * kL];
    const long long a1 = a[1 * kL];
    const long long a2 = a[2 * kL];
    const long long a3 = a[3 * kL];
    const long long a4 = a[4 * kL];
    const long long a5 = a[5 * kL];
    const long long a6 = a[6 * kL];
    const long long a7 = a[7 * kL];
    const long long a8 = a[8 * kL];
    const long long a9 = a[9 * kL];
    const long long a10 = a[10 * kL];
    const long long a11 = a[11 * kL];
    x[0 * kL] = a0;
    x[1 * kL] = a1;
    x[2 * kL] = a0 + a1;
    x[3 * kL] = a2;
    x[4 * kL] = a3;
    x[5 * kL] = a2 + a3;
    x[6 * kL] = a4;
    x[7 * kL] = a5;
    x[8 * kL] = a4 + a5;
    x[9 * kL] = a2 + a4;
    x[10 * kL] = a3 + a5;
    x[11 * kL] = a2 + a3 + a4 + a5;
    x[12 * kL] = a0 + a2;
    x[13 * kL] = a1 + a3;
    x[14 * kL] = a0 + a1 + a2 + a3;
    x[15 * kL] = a0 + a4;
    x[16 * kL] = a1 + a5;
    x[17 * kL] = a0 + a1 + a4 + a5;
    x[18 * kL] = a6;
    x[19 * kL] = a7;
    x[20 * kL] = a6 + a7;
    x[21 * kL] = a8;
    x[22 * kL] = a9;
    x[23 * kL] = a8 + a9;
    x[24 * kL] = a10;
    x[25 * kL] = a11;
    x[26 * kL] = a10 + a11;
    x[27 * kL] = a8 + a10;
    x[28 * kL] = a9 + a11;
    x[29 * kL] = a8 + a9 + a10 + a11;
    x[30 * kL] = a6 + a8;
    x[31 * kL] = a7 + a9;
    x[32 * kL] = a6 + a7 + a8 + a9;
    x[33 * kL] = a6 + a10;
    x[34 * kL] = a7 + a11;
    x[35 * kL] = a6 + a7 + a10 + a11;
    x[36 * kL] = a0 + a6;
    x[37 * kL] = a1 + a7;
    x[38 * kL] = a0 + a1 + a6 + a7;
    x[39 * kL] = a2 + a8;
    x[40 * kL] = a3 + a9;
    x[41 * kL] = a2 + a3 + a8 + a9;
    x[42 * kL] = a4 + a10;
    x[43 * kL] = a5 + a11;
    x[44 * kL] = a4 + a5 + a10 + a11;
    x[45 * kL] = a2 + a4 + a8 + a10;
    x[46 * kL] = a3 + a5 + a9 + a11;
    x[47 * kL] = a2 + a3 + a4 + a5 + a8 + a9 + a10 + a11;
    x[48 * kL] = a0 + a2 + a6 + a8;
    x[49 * kL] = a1 + a3 + a7 + a9;
    x[50 * kL] = a0 + a1 + a2 + a3 + a6 + a7 + a8 + a9;
    x[51 * kL] = a0 + a4 + a6 + a10;
    x[52 * kL] = a1 + a5 + a7 + a11;
    x[53 * kL] = a0 + a1 + a4 + a5 + a6 + a7 + a10 + a11;
  }
  template <class Src>
  static __device__ __forceinline__ void beta(
      const Src& b, long long* __restrict__ y) {
    const long long b0 = b[0 * kL];
    const long long b1 = b[1 * kL];
    const long long b2 = b[2 * kL];
    const long long b3 = b[3 * kL];
    const long long b4 = b[4 * kL];
    const long long b5 = b[5 * kL];
    const long long b6 = b[6 * kL];
    const long long b7 = b[7 * kL];
    const long long b8 = b[8 * kL];
    const long long b9 = b[9 * kL];
    const long long b10 = b[10 * kL];
    const long long b11 = b[11 * kL];
    y[0 * kL] = b0;
    y[1 * kL] = b1;
    y[2 * kL] = b0 + b1;
    y[3 * kL] = b2;
    y[4 * kL] = b3;
    y[5 * kL] = b2 + b3;
    y[6 * kL] = b4;
    y[7 * kL] = b5;
    y[8 * kL] = b4 + b5;
    y[9 * kL] = b2 + b4;
    y[10 * kL] = b3 + b5;
    y[11 * kL] = b2 + b3 + b4 + b5;
    y[12 * kL] = b0 + b2;
    y[13 * kL] = b1 + b3;
    y[14 * kL] = b0 + b1 + b2 + b3;
    y[15 * kL] = b0 + b4;
    y[16 * kL] = b1 + b5;
    y[17 * kL] = b0 + b1 + b4 + b5;
    y[18 * kL] = b6;
    y[19 * kL] = b7;
    y[20 * kL] = b6 + b7;
    y[21 * kL] = b8;
    y[22 * kL] = b9;
    y[23 * kL] = b8 + b9;
    y[24 * kL] = b10;
    y[25 * kL] = b11;
    y[26 * kL] = b10 + b11;
    y[27 * kL] = b8 + b10;
    y[28 * kL] = b9 + b11;
    y[29 * kL] = b8 + b9 + b10 + b11;
    y[30 * kL] = b6 + b8;
    y[31 * kL] = b7 + b9;
    y[32 * kL] = b6 + b7 + b8 + b9;
    y[33 * kL] = b6 + b10;
    y[34 * kL] = b7 + b11;
    y[35 * kL] = b6 + b7 + b10 + b11;
    y[36 * kL] = b0 + b6;
    y[37 * kL] = b1 + b7;
    y[38 * kL] = b0 + b1 + b6 + b7;
    y[39 * kL] = b2 + b8;
    y[40 * kL] = b3 + b9;
    y[41 * kL] = b2 + b3 + b8 + b9;
    y[42 * kL] = b4 + b10;
    y[43 * kL] = b5 + b11;
    y[44 * kL] = b4 + b5 + b10 + b11;
    y[45 * kL] = b2 + b4 + b8 + b10;
    y[46 * kL] = b3 + b5 + b9 + b11;
    y[47 * kL] = b2 + b3 + b4 + b5 + b8 + b9 + b10 + b11;
    y[48 * kL] = b0 + b2 + b6 + b8;
    y[49 * kL] = b1 + b3 + b7 + b9;
    y[50 * kL] = b0 + b1 + b2 + b3 + b6 + b7 + b8 + b9;
    y[51 * kL] = b0 + b4 + b6 + b10;
    y[52 * kL] = b1 + b5 + b7 + b11;
    y[53 * kL] = b0 + b1 + b4 + b5 + b6 + b7 + b10 + b11;
  }
  static __device__ __forceinline__ void gamma(
      const int* __restrict__ lv, long long* __restrict__ g) {
    const long long v0 = lv[0 * kW];
    const long long v1 = lv[1 * kW];
    const long long v2 = lv[2 * kW];
    const long long v3 = lv[3 * kW];
    const long long v4 = lv[4 * kW];
    const long long v5 = lv[5 * kW];
    const long long v6 = lv[6 * kW];
    const long long v7 = lv[7 * kW];
    const long long v8 = lv[8 * kW];
    const long long v9 = lv[9 * kW];
    const long long v10 = lv[10 * kW];
    const long long v11 = lv[11 * kW];
    const long long v12 = lv[12 * kW];
    const long long v13 = lv[13 * kW];
    const long long v14 = lv[14 * kW];
    const long long v15 = lv[15 * kW];
    const long long v16 = lv[16 * kW];
    const long long v17 = lv[17 * kW];
    const long long v18 = lv[18 * kW];
    const long long v19 = lv[19 * kW];
    const long long v20 = lv[20 * kW];
    const long long v21 = lv[21 * kW];
    const long long v22 = lv[22 * kW];
    const long long v23 = lv[23 * kW];
    const long long v24 = lv[24 * kW];
    const long long v25 = lv[25 * kW];
    const long long v26 = lv[26 * kW];
    const long long v27 = lv[27 * kW];
    const long long v28 = lv[28 * kW];
    const long long v29 = lv[29 * kW];
    const long long v30 = lv[30 * kW];
    const long long v31 = lv[31 * kW];
    const long long v32 = lv[32 * kW];
    const long long v33 = lv[33 * kW];
    const long long v34 = lv[34 * kW];
    const long long v35 = lv[35 * kW];
    const long long v36 = lv[36 * kW];
    const long long v37 = lv[37 * kW];
    const long long v38 = lv[38 * kW];
    const long long v39 = lv[39 * kW];
    const long long v40 = lv[40 * kW];
    const long long v41 = lv[41 * kW];
    const long long v42 = lv[42 * kW];
    const long long v43 = lv[43 * kW];
    const long long v44 = lv[44 * kW];
    const long long v45 = lv[45 * kW];
    const long long v46 = lv[46 * kW];
    const long long v47 = lv[47 * kW];
    const long long v48 = lv[48 * kW];
    const long long v49 = lv[49 * kW];
    const long long v50 = lv[50 * kW];
    const long long v51 = lv[51 * kW];
    const long long v52 = lv[52 * kW];
    const long long v53 = lv[53 * kW];
    g[0 * kWPitch] = v0 - v1 - 2 * v3 + v5 - 2 * v6 + v8 + 2 * v9 - v11 - 2 * v18 + v20 + 2 * v21 - v23 - 2 * v24 + v26 + 2 * v33 - v35;
    g[1 * kWPitch] = -v0 - v1 + v2 + 2 * v4 - v5 + 2 * v7 - v8 - 2 * v10 + v11 + 2 * v19 - v20 - 2 * v22 + v23 + 2 * v25 - v26 - 2 * v34 + v35;
    g[2 * kWPitch] = -v0 + v1 - v3 + v4 + 2 * v6 - v8 + v12 - v13 + v18 - v19 - 2 * v21 + v23 - 2 * v24 + v26 + 2 * v27 - v29;
    g[3 * kWPitch] = v0 + v1 - v2 + v3 + v4 - v5 - 2 * v7 + v8 - v12 - v13 + v14 - v18 - v19 + v20 + 2 * v22 - v23 + 2 * v25 - v26 - 2 * v28 + v29;
    g[4 * kWPitch] = -v0 + v1 + v3 - v4 - v6 + v7 + v15 - v16 - v18 + v19 - v21 + v22 + 2 * v24 - v26 + v30 - v31;
    g[5 * kWPitch] = v0 + v1 - v2 - v3 - v4 + v5 + v6 + v7 - v8 - v15 - v16 + v17 + v18 + v19 - v20 + v21 + v22 - v23 - 2 * v25 + v26 - v30 - v31 + v32;
    g[6 * kWPitch] = -v0 + v1 + 2 * v3 - v5 + 2 * v6 - v8 - 2 * v9 + v11 - v18 + v19 + 2 * v21 - v23 + 2 * v24 - v26 - 2 * v27 + v29 + v36 - v37 - 2 * v39 + v41 - 2 * v42 + v44 + 2 * v45 - v47;
    g[7 * kWPitch] = v0 + v1 - v2 - 2 * v4 + v5 - 2 * v7 + v8 + 2 * v10 - v11 + v18 + v19 - v20 - 2 * v22 + v23 - 2 * v25 + v26 + 2 * v28 - v29 - v36 - v37 + v38 + 2 * v40 - v41 + 2 * v43 - v44 - 2 * v46 + v47;
    g[8 * kWPitch] = v0 - v1 + v3 - v4 - 2 * v6 + v8 - v12 + v13 + v18 - v19 + v21 - v22 - 2 * v24 + v26 - v30 + v31 - v36 + v37 - v39 + v40 + 2 * v42 - v44 + v48 - v49;
    g[9 * kWPitch] = -v0 - v1 + v2 - v3 - v4 + v5 + 2 * v7 - v8 + v12 + v13 - v14 - v18 - v19 + v20 - v21 - v22 + v23 + 2 * v25 - v26 + v30 + v31 - v32 + v36 + v37 - v38 + v39 + v40 - v41 - 2 * v43 + v44 - v48 - v49 + v50;
    g[10 * kWPitch] = v0 - v1 - v3 + v4 + v6 - v7 - v15 + v16 + v18 - v19 - v21 + v22 + v24 - v25 - v33 + v34 - v36 + v37 + v39 - v40 - v42 + v43 + v51 - v52;
    g[11 * kWPitch] = -v0 - v1 + v2 + v3 + v4 - v5 - v6 - v7 + v8 + v15 + v16 - v17 - v18 - v19 + v20 + v21 + v22 - v23 - v24 - v25 + v26 + v33 + v34 - v35 + v36 + v37 - v38 - v39 - v40 + v41 + v42 + v43 - v44 - v51 - v52 + v53;
  }
};

// fq12_sqr
template <>
struct Table<2> {
  static constexpr int P = 36, R = 12, Ca = 12, Cb = 12;
  static constexpr bool one_col = false, norm_in = false;
  template <class Src>
  static __device__ __forceinline__ void alpha(
      const Src& a, long long* __restrict__ x) {
    const long long a0 = a[0 * kL];
    const long long a1 = a[1 * kL];
    const long long a2 = a[2 * kL];
    const long long a3 = a[3 * kL];
    const long long a4 = a[4 * kL];
    const long long a5 = a[5 * kL];
    const long long a6 = a[6 * kL];
    const long long a7 = a[7 * kL];
    const long long a8 = a[8 * kL];
    const long long a9 = a[9 * kL];
    const long long a10 = a[10 * kL];
    const long long a11 = a[11 * kL];
    x[0 * kL] = a0;
    x[1 * kL] = a1;
    x[2 * kL] = a0 + a1;
    x[3 * kL] = a2;
    x[4 * kL] = a3;
    x[5 * kL] = a2 + a3;
    x[6 * kL] = a4;
    x[7 * kL] = a5;
    x[8 * kL] = a4 + a5;
    x[9 * kL] = a2 + a4;
    x[10 * kL] = a3 + a5;
    x[11 * kL] = a2 + a3 + a4 + a5;
    x[12 * kL] = a0 + a2;
    x[13 * kL] = a1 + a3;
    x[14 * kL] = a0 + a1 + a2 + a3;
    x[15 * kL] = a0 + a4;
    x[16 * kL] = a1 + a5;
    x[17 * kL] = a0 + a1 + a4 + a5;
    x[18 * kL] = a0 + a6;
    x[19 * kL] = a1 + a7;
    x[20 * kL] = a0 + a1 + a6 + a7;
    x[21 * kL] = a2 + a8;
    x[22 * kL] = a3 + a9;
    x[23 * kL] = a2 + a3 + a8 + a9;
    x[24 * kL] = a4 + a10;
    x[25 * kL] = a5 + a11;
    x[26 * kL] = a4 + a5 + a10 + a11;
    x[27 * kL] = a2 + a4 + a8 + a10;
    x[28 * kL] = a3 + a5 + a9 + a11;
    x[29 * kL] = a2 + a3 + a4 + a5 + a8 + a9 + a10 + a11;
    x[30 * kL] = a0 + a2 + a6 + a8;
    x[31 * kL] = a1 + a3 + a7 + a9;
    x[32 * kL] = a0 + a1 + a2 + a3 + a6 + a7 + a8 + a9;
    x[33 * kL] = a0 + a4 + a6 + a10;
    x[34 * kL] = a1 + a5 + a7 + a11;
    x[35 * kL] = a0 + a1 + a4 + a5 + a6 + a7 + a10 + a11;
  }
  template <class Src>
  static __device__ __forceinline__ void beta(
      const Src& b, long long* __restrict__ y) {
    const long long b0 = b[0 * kL];
    const long long b1 = b[1 * kL];
    const long long b2 = b[2 * kL];
    const long long b3 = b[3 * kL];
    const long long b4 = b[4 * kL];
    const long long b5 = b[5 * kL];
    const long long b6 = b[6 * kL];
    const long long b7 = b[7 * kL];
    const long long b8 = b[8 * kL];
    const long long b9 = b[9 * kL];
    const long long b10 = b[10 * kL];
    const long long b11 = b[11 * kL];
    y[0 * kL] = b6;
    y[1 * kL] = b7;
    y[2 * kL] = b6 + b7;
    y[3 * kL] = b8;
    y[4 * kL] = b9;
    y[5 * kL] = b8 + b9;
    y[6 * kL] = b10;
    y[7 * kL] = b11;
    y[8 * kL] = b10 + b11;
    y[9 * kL] = b8 + b10;
    y[10 * kL] = b9 + b11;
    y[11 * kL] = b8 + b9 + b10 + b11;
    y[12 * kL] = b6 + b8;
    y[13 * kL] = b7 + b9;
    y[14 * kL] = b6 + b7 + b8 + b9;
    y[15 * kL] = b6 + b10;
    y[16 * kL] = b7 + b11;
    y[17 * kL] = b6 + b7 + b10 + b11;
    y[18 * kL] = b0 + b10 - b11;
    y[19 * kL] = b1 + b10 + b11;
    y[20 * kL] = b0 + b1 + 2 * b10;
    y[21 * kL] = b2 + b6;
    y[22 * kL] = b3 + b7;
    y[23 * kL] = b2 + b3 + b6 + b7;
    y[24 * kL] = b4 + b8;
    y[25 * kL] = b5 + b9;
    y[26 * kL] = b4 + b5 + b8 + b9;
    y[27 * kL] = b2 + b4 + b6 + b8;
    y[28 * kL] = b3 + b5 + b7 + b9;
    y[29 * kL] = b2 + b3 + b4 + b5 + b6 + b7 + b8 + b9;
    y[30 * kL] = b0 + b2 + b6 + b10 - b11;
    y[31 * kL] = b1 + b3 + b7 + b10 + b11;
    y[32 * kL] = b0 + b1 + b2 + b3 + b6 + b7 + 2 * b10;
    y[33 * kL] = b0 + b4 + b8 + b10 - b11;
    y[34 * kL] = b1 + b5 + b9 + b10 + b11;
    y[35 * kL] = b0 + b1 + b4 + b5 + b8 + b9 + 2 * b10;
  }
  static __device__ __forceinline__ void gamma(
      const int* __restrict__ lv, long long* __restrict__ g) {
    const long long v0 = lv[0 * kW];
    const long long v1 = lv[1 * kW];
    const long long v2 = lv[2 * kW];
    const long long v3 = lv[3 * kW];
    const long long v4 = lv[4 * kW];
    const long long v5 = lv[5 * kW];
    const long long v6 = lv[6 * kW];
    const long long v7 = lv[7 * kW];
    const long long v8 = lv[8 * kW];
    const long long v9 = lv[9 * kW];
    const long long v10 = lv[10 * kW];
    const long long v11 = lv[11 * kW];
    const long long v12 = lv[12 * kW];
    const long long v13 = lv[13 * kW];
    const long long v14 = lv[14 * kW];
    const long long v15 = lv[15 * kW];
    const long long v16 = lv[16 * kW];
    const long long v17 = lv[17 * kW];
    const long long v18 = lv[18 * kW];
    const long long v19 = lv[19 * kW];
    const long long v20 = lv[20 * kW];
    const long long v21 = lv[21 * kW];
    const long long v22 = lv[22 * kW];
    const long long v23 = lv[23 * kW];
    const long long v24 = lv[24 * kW];
    const long long v25 = lv[25 * kW];
    const long long v26 = lv[26 * kW];
    const long long v27 = lv[27 * kW];
    const long long v28 = lv[28 * kW];
    const long long v29 = lv[29 * kW];
    const long long v30 = lv[30 * kW];
    const long long v31 = lv[31 * kW];
    const long long v32 = lv[32 * kW];
    const long long v33 = lv[33 * kW];
    const long long v34 = lv[34 * kW];
    const long long v35 = lv[35 * kW];
    g[0 * kWPitch] = v0 + v1 - v2 + 4 * v6 - 2 * v8 - 2 * v9 + v11 - 2 * v15 + v17 + v18 - v19 - 2 * v21 + v23 - 2 * v24 + v26 + 2 * v27 - v29;
    g[1 * kWPitch] = v0 - v1 - 4 * v7 + 2 * v8 + 2 * v10 - v11 + 2 * v16 - v17 - v18 - v19 + v20 + 2 * v22 - v23 + 2 * v25 - v26 - 2 * v28 + v29;
    g[2 * kWPitch] = 3 * v3 - v4 - v5 - 2 * v9 + v11 - v12 + v13 - v18 + v19 - v21 + v22 + 2 * v24 - v26 + v30 - v31;
    g[3 * kWPitch] = -v3 - 3 * v4 + 2 * v5 + 2 * v10 - v11 + v12 + v13 - v14 + v18 + v19 - v20 + v21 + v22 - v23 - 2 * v25 + v26 - v30 - v31 + v32;
    g[4 * kWPitch] = 2 * v0 - 2 * v1 - v6 - v7 + v8 - v12 + v13 - v15 + v16 - v18 + v19 + v21 - v22 - v24 + v25 + v33 - v34;
    g[5 * kWPitch] = -2 * v0 - 2 * v1 + 2 * v2 - v6 + v7 + v12 + v13 - v14 + v15 + v16 - v17 + v18 + v19 - v20 - v21 - v22 + v23 + v24 + v25 - v26 - v33 - v34 + v35;
    g[6 * kWPitch] = 2 * v0 - 2 * v1 - 4 * v3 + 2 * v5 - 4 * v6 + 2 * v8 + 4 * v9 - 2 * v11;
    g[7 * kWPitch] = -2 * v0 - 2 * v1 + 2 * v2 + 4 * v4 - 2 * v5 + 4 * v7 - 2 * v8 - 4 * v10 + 2 * v11;
    g[8 * kWPitch] = -2 * v0 + 2 * v1 - 2 * v3 + 2 * v4 + 4 * v6 - 2 * v8 + 2 * v12 - 2 * v13;
    g[9 * kWPitch] = 2 * v0 + 2 * v1 - 2 * v2 + 2 * v3 + 2 * v4 - 2 * v5 - 4 * v7 + 2 * v8 - 2 * v12 - 2 * v13 + 2 * v14;
    g[10 * kWPitch] = -2 * v0 + 2 * v1 + 2 * v3 - 2 * v4 - 2 * v6 + 2 * v7 + 2 * v15 - 2 * v16;
    g[11 * kWPitch] = 2 * v0 + 2 * v1 - 2 * v2 - 2 * v3 - 2 * v4 + 2 * v5 + 2 * v6 + 2 * v7 - 2 * v8 - 2 * v15 - 2 * v16 + 2 * v17;
  }
};

// fq12_mul_line
template <>
struct Table<3> {
  static constexpr int P = 39, R = 12, Ca = 12, Cb = 6;
  static constexpr bool one_col = false, norm_in = false;
  template <class Src>
  static __device__ __forceinline__ void alpha(
      const Src& a, long long* __restrict__ x) {
    const long long a0 = a[0 * kL];
    const long long a1 = a[1 * kL];
    const long long a2 = a[2 * kL];
    const long long a3 = a[3 * kL];
    const long long a4 = a[4 * kL];
    const long long a5 = a[5 * kL];
    const long long a6 = a[6 * kL];
    const long long a7 = a[7 * kL];
    const long long a8 = a[8 * kL];
    const long long a9 = a[9 * kL];
    const long long a10 = a[10 * kL];
    const long long a11 = a[11 * kL];
    x[0 * kL] = a0;
    x[1 * kL] = a1;
    x[2 * kL] = a0 + a1;
    x[3 * kL] = a2;
    x[4 * kL] = a3;
    x[5 * kL] = a2 + a3;
    x[6 * kL] = a2 + a4;
    x[7 * kL] = a3 + a5;
    x[8 * kL] = a2 + a3 + a4 + a5;
    x[9 * kL] = a0 + a2;
    x[10 * kL] = a1 + a3;
    x[11 * kL] = a0 + a1 + a2 + a3;
    x[12 * kL] = a0 + a4;
    x[13 * kL] = a1 + a5;
    x[14 * kL] = a0 + a1 + a4 + a5;
    x[15 * kL] = a8;
    x[16 * kL] = a9;
    x[17 * kL] = a8 + a9;
    x[18 * kL] = a8 + a10;
    x[19 * kL] = a9 + a11;
    x[20 * kL] = a8 + a9 + a10 + a11;
    x[21 * kL] = a6 + a8;
    x[22 * kL] = a7 + a9;
    x[23 * kL] = a6 + a7 + a8 + a9;
    x[24 * kL] = a0 + a6;
    x[25 * kL] = a1 + a7;
    x[26 * kL] = a0 + a1 + a6 + a7;
    x[27 * kL] = a2 + a8;
    x[28 * kL] = a3 + a9;
    x[29 * kL] = a2 + a3 + a8 + a9;
    x[30 * kL] = a2 + a4 + a8 + a10;
    x[31 * kL] = a3 + a5 + a9 + a11;
    x[32 * kL] = a2 + a3 + a4 + a5 + a8 + a9 + a10 + a11;
    x[33 * kL] = a0 + a2 + a6 + a8;
    x[34 * kL] = a1 + a3 + a7 + a9;
    x[35 * kL] = a0 + a1 + a2 + a3 + a6 + a7 + a8 + a9;
    x[36 * kL] = a0 + a4 + a6 + a10;
    x[37 * kL] = a1 + a5 + a7 + a11;
    x[38 * kL] = a0 + a1 + a4 + a5 + a6 + a7 + a10 + a11;
  }
  template <class Src>
  static __device__ __forceinline__ void beta(
      const Src& b, long long* __restrict__ y) {
    const long long b0 = b[0 * kL];
    const long long b1 = b[1 * kL];
    const long long b2 = b[2 * kL];
    const long long b3 = b[3 * kL];
    const long long b4 = b[4 * kL];
    const long long b5 = b[5 * kL];
    y[0 * kL] = b0;
    y[1 * kL] = b1;
    y[2 * kL] = b0 + b1;
    y[3 * kL] = b2;
    y[4 * kL] = b3;
    y[5 * kL] = b2 + b3;
    y[6 * kL] = b2;
    y[7 * kL] = b3;
    y[8 * kL] = b2 + b3;
    y[9 * kL] = b0 + b2;
    y[10 * kL] = b1 + b3;
    y[11 * kL] = b0 + b1 + b2 + b3;
    y[12 * kL] = b0;
    y[13 * kL] = b1;
    y[14 * kL] = b0 + b1;
    y[15 * kL] = b4;
    y[16 * kL] = b5;
    y[17 * kL] = b4 + b5;
    y[18 * kL] = b4;
    y[19 * kL] = b5;
    y[20 * kL] = b4 + b5;
    y[21 * kL] = b4;
    y[22 * kL] = b5;
    y[23 * kL] = b4 + b5;
    y[24 * kL] = b0;
    y[25 * kL] = b1;
    y[26 * kL] = b0 + b1;
    y[27 * kL] = b2 + b4;
    y[28 * kL] = b3 + b5;
    y[29 * kL] = b2 + b3 + b4 + b5;
    y[30 * kL] = b2 + b4;
    y[31 * kL] = b3 + b5;
    y[32 * kL] = b2 + b3 + b4 + b5;
    y[33 * kL] = b0 + b2 + b4;
    y[34 * kL] = b1 + b3 + b5;
    y[35 * kL] = b0 + b1 + b2 + b3 + b4 + b5;
    y[36 * kL] = b0;
    y[37 * kL] = b1;
    y[38 * kL] = b0 + b1;
  }
  static __device__ __forceinline__ void gamma(
      const int* __restrict__ lv, long long* __restrict__ g) {
    const long long v0 = lv[0 * kW];
    const long long v1 = lv[1 * kW];
    const long long v2 = lv[2 * kW];
    const long long v3 = lv[3 * kW];
    const long long v4 = lv[4 * kW];
    const long long v5 = lv[5 * kW];
    const long long v6 = lv[6 * kW];
    const long long v7 = lv[7 * kW];
    const long long v8 = lv[8 * kW];
    const long long v9 = lv[9 * kW];
    const long long v10 = lv[10 * kW];
    const long long v11 = lv[11 * kW];
    const long long v12 = lv[12 * kW];
    const long long v13 = lv[13 * kW];
    const long long v14 = lv[14 * kW];
    const long long v15 = lv[15 * kW];
    const long long v16 = lv[16 * kW];
    const long long v17 = lv[17 * kW];
    const long long v18 = lv[18 * kW];
    const long long v19 = lv[19 * kW];
    const long long v20 = lv[20 * kW];
    const long long v21 = lv[21 * kW];
    const long long v22 = lv[22 * kW];
    const long long v23 = lv[23 * kW];
    const long long v24 = lv[24 * kW];
    const long long v25 = lv[25 * kW];
    const long long v26 = lv[26 * kW];
    const long long v27 = lv[27 * kW];
    const long long v28 = lv[28 * kW];
    const long long v29 = lv[29 * kW];
    const long long v30 = lv[30 * kW];
    const long long v31 = lv[31 * kW];
    const long long v32 = lv[32 * kW];
    const long long v33 = lv[33 * kW];
    const long long v34 = lv[34 * kW];
    const long long v35 = lv[35 * kW];
    const long long v36 = lv[36 * kW];
    const long long v37 = lv[37 * kW];
    const long long v38 = lv[38 * kW];
    g[0 * kWPitch] = v0 - v1 - 2 * v3 + v5 + 2 * v6 - v8 + 2 * v15 - v17;
    g[1 * kWPitch] = -v0 - v1 + v2 + 2 * v4 - v5 - 2 * v7 + v8 - 2 * v16 + v17;
    g[2 * kWPitch] = -v0 + v1 - v3 + v4 + v9 - v10 - 2 * v15 + v17 + 2 * v18 - v20;
    g[3 * kWPitch] = v0 + v1 - v2 + v3 + v4 - v5 - v9 - v10 + v11 + 2 * v16 - v17 - 2 * v19 + v20;
    g[4 * kWPitch] = -v0 + v1 + v3 - v4 + v12 - v13 - v15 + v16 + v21 - v22;
    g[5 * kWPitch] = v0 + v1 - v2 - v3 - v4 + v5 - v12 - v13 + v14 + v15 + v16 - v17 - v21 - v22 + v23;
    g[6 * kWPitch] = -v0 + v1 + 2 * v3 - v5 - 2 * v6 + v8 + 2 * v15 - v17 - 2 * v18 + v20 + v24 - v25 - 2 * v27 + v29 + 2 * v30 - v32;
    g[7 * kWPitch] = v0 + v1 - v2 - 2 * v4 + v5 + 2 * v7 - v8 - 2 * v16 + v17 + 2 * v19 - v20 - v24 - v25 + v26 + 2 * v28 - v29 - 2 * v31 + v32;
    g[8 * kWPitch] = v0 - v1 + v3 - v4 - v9 + v10 + v15 - v16 - v21 + v22 - v24 + v25 - v27 + v28 + v33 - v34;
    g[9 * kWPitch] = -v0 - v1 + v2 - v3 - v4 + v5 + v9 + v10 - v11 - v15 - v16 + v17 + v21 + v22 - v23 + v24 + v25 - v26 + v27 + v28 - v29 - v33 - v34 + v35;
    g[10 * kWPitch] = v0 - v1 - v3 + v4 - v12 + v13 - v15 + v16 - v24 + v25 + v27 - v28 + v36 - v37;
    g[11 * kWPitch] = -v0 - v1 + v2 + v3 + v4 - v5 + v12 + v13 - v14 + v15 + v16 - v17 + v24 + v25 - v26 - v27 - v28 + v29 - v36 - v37 + v38;
  }
};

// fq12_cyclo_sqr
template <>
struct Table<4> {
  static constexpr int P = 30, R = 12, Ca = 12, Cb = 12;
  static constexpr bool one_col = true, norm_in = true;
  template <class Src>
  static __device__ __forceinline__ void alpha(
      const Src& a, long long* __restrict__ x) {
    const long long a0 = a[0 * kL];
    const long long a1 = a[1 * kL];
    const long long a2 = a[2 * kL];
    const long long a3 = a[3 * kL];
    const long long a4 = a[4 * kL];
    const long long a5 = a[5 * kL];
    const long long a6 = a[6 * kL];
    const long long a7 = a[7 * kL];
    const long long a8 = a[8 * kL];
    const long long a9 = a[9 * kL];
    const long long a10 = a[10 * kL];
    const long long a11 = a[11 * kL];
    x[0 * kL] = a0 + a8;
    x[1 * kL] = a1 + a9;
    x[2 * kL] = a0 + a1 + a8 + a9;
    x[3 * kL] = a4 + a6;
    x[4 * kL] = a5 + a7;
    x[5 * kL] = a4 + a5 + a6 + a7;
    x[6 * kL] = a2 + a10;
    x[7 * kL] = a3 + a11;
    x[8 * kL] = a2 + a3 + a10 + a11;
    x[9 * kL] = a0;
    x[10 * kL] = a1;
    x[11 * kL] = a0 + a1;
    x[12 * kL] = a6;
    x[13 * kL] = a7;
    x[14 * kL] = a6 + a7;
    x[15 * kL] = a2;
    x[16 * kL] = a3;
    x[17 * kL] = a2 + a3;
    x[18 * kL] = a0;
    x[19 * kL] = a1;
    x[20 * kL] = a6;
    x[21 * kL] = a7;
    x[22 * kL] = a2;
    x[23 * kL] = a3;
    x[24 * kL] = a8;
    x[25 * kL] = a9;
    x[26 * kL] = a4;
    x[27 * kL] = a5;
    x[28 * kL] = a10;
    x[29 * kL] = a11;
  }
  template <class Src>
  static __device__ __forceinline__ void beta(
      const Src& b, long long* __restrict__ y) {
    const long long b0 = b[0 * kL];
    const long long b1 = b[1 * kL];
    const long long b2 = b[2 * kL];
    const long long b3 = b[3 * kL];
    const long long b4 = b[4 * kL];
    const long long b5 = b[5 * kL];
    const long long b6 = b[6 * kL];
    const long long b7 = b[7 * kL];
    const long long b8 = b[8 * kL];
    const long long b9 = b[9 * kL];
    const long long b10 = b[10 * kL];
    const long long b11 = b[11 * kL];
    const long long b12 = b[12 * kL];
    y[0 * kL] = b0 + b8 - b9;
    y[1 * kL] = b1 + b8 + b9;
    y[2 * kL] = b0 + b1 + 2 * b8;
    y[3 * kL] = b4 - b5 + b6;
    y[4 * kL] = b4 + b5 + b7;
    y[5 * kL] = 2 * b4 + b6 + b7;
    y[6 * kL] = b2 + b10 - b11;
    y[7 * kL] = b3 + b10 + b11;
    y[8 * kL] = b2 + b3 + 2 * b10;
    y[9 * kL] = b8;
    y[10 * kL] = b9;
    y[11 * kL] = b8 + b9;
    y[12 * kL] = b4;
    y[13 * kL] = b5;
    y[14 * kL] = b4 + b5;
    y[15 * kL] = b10;
    y[16 * kL] = b11;
    y[17 * kL] = b10 + b11;
    y[18 * kL] = b12;
    y[19 * kL] = b12;
    y[20 * kL] = b12;
    y[21 * kL] = b12;
    y[22 * kL] = b12;
    y[23 * kL] = b12;
    y[24 * kL] = b12;
    y[25 * kL] = b12;
    y[26 * kL] = b12;
    y[27 * kL] = b12;
    y[28 * kL] = b12;
    y[29 * kL] = b12;
  }
  static __device__ __forceinline__ void gamma(
      const int* __restrict__ lv, long long* __restrict__ g) {
    const long long v0 = lv[0 * kW];
    const long long v1 = lv[1 * kW];
    const long long v2 = lv[2 * kW];
    const long long v3 = lv[3 * kW];
    const long long v4 = lv[4 * kW];
    const long long v5 = lv[5 * kW];
    const long long v6 = lv[6 * kW];
    const long long v7 = lv[7 * kW];
    const long long v8 = lv[8 * kW];
    const long long v9 = lv[9 * kW];
    const long long v10 = lv[10 * kW];
    const long long v11 = lv[11 * kW];
    const long long v12 = lv[12 * kW];
    const long long v13 = lv[13 * kW];
    const long long v14 = lv[14 * kW];
    const long long v15 = lv[15 * kW];
    const long long v16 = lv[16 * kW];
    const long long v17 = lv[17 * kW];
    const long long v18 = lv[18 * kW];
    const long long v19 = lv[19 * kW];
    const long long v20 = lv[20 * kW];
    const long long v21 = lv[21 * kW];
    const long long v22 = lv[22 * kW];
    const long long v23 = lv[23 * kW];
    const long long v24 = lv[24 * kW];
    const long long v25 = lv[25 * kW];
    const long long v26 = lv[26 * kW];
    const long long v27 = lv[27 * kW];
    const long long v28 = lv[28 * kW];
    const long long v29 = lv[29 * kW];
    g[0 * kWPitch] = 3 * v0 - 3 * v1 - 9 * v9 + 3 * v10 + 3 * v11 - 2 * v18;
    g[1 * kWPitch] = -3 * v0 - 3 * v1 + 3 * v2 + 3 * v9 + 9 * v10 - 6 * v11 - 2 * v19;
    g[2 * kWPitch] = 3 * v3 - 3 * v4 - 9 * v12 + 3 * v13 + 3 * v14 - 2 * v22;
    g[3 * kWPitch] = -3 * v3 - 3 * v4 + 3 * v5 + 3 * v12 + 9 * v13 - 6 * v14 - 2 * v23;
    g[4 * kWPitch] = 3 * v6 - 3 * v7 - 9 * v15 + 3 * v16 + 3 * v17 - 2 * v26;
    g[5 * kWPitch] = -3 * v6 - 3 * v7 + 3 * v8 + 3 * v15 + 9 * v16 - 6 * v17 - 2 * v27;
    g[6 * kWPitch] = 12 * v15 - 6 * v17 + 2 * v20;
    g[7 * kWPitch] = -12 * v16 + 6 * v17 + 2 * v21;
    g[8 * kWPitch] = 6 * v9 - 6 * v10 + 2 * v24;
    g[9 * kWPitch] = -6 * v9 - 6 * v10 + 6 * v11 + 2 * v25;
    g[10 * kWPitch] = 6 * v12 - 6 * v13 + 2 * v28;
    g[11 * kWPitch] = -6 * v12 - 6 * v13 + 6 * v14 + 2 * v29;
  }
};
