"""Write csrc/fq_tables.cuh: the tower products' tables as straight-line
CUDA code, one `Table<kind>` specialization per product of
ops/fq_tower.py::TABLES.

    python -m consensus_specs_tpu_torch.ops.fq_tables_gen

rewrites the header from the tables (tests/test_torch_fq_chain.py holds
the committed header equal to `render()`). For each product: its shape
(P leaves, R outputs, Ca / Cb input coefficients, the one_col and
norm_in options), `alpha` and `beta` (a leaf's operands as sums of input
coefficients with immediate coefficients) and `gamma` (an output
coefficient's wide columns as a sum of leaves). Each function works on
one limb or column of one lane, so every thread of a warp runs the same
code; the pre-sums are templates over their source (a row pointer, or
the point kernels' register gather). The header also carries Montgomery
one's limbs (the cyclotomic square's extra b coefficient).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from . import fq as F
from . import fq_tower as T

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "fq_tables.cuh"


def _sum(row: np.ndarray, name: str) -> str:
    """sum_c row[c] * name<c>, coefficients as immediates."""
    out = []
    for c in np.nonzero(row)[0]:
        k = int(row[c])
        term = f"{name}{c}" if abs(k) == 1 else f"{abs(k)} * {name}{c}"
        out.append(("- " if k < 0 else "+ ") + term)
    text = " ".join(out)
    return text[2:] if text.startswith("+ ") else "-" + text[2:]


def _presum(fn: str, mat: np.ndarray, src: str, dst: str) -> list:
    cols = sorted({int(c) for c in np.nonzero(mat)[1]})
    lines = ["  template <class Src>",
             f"  static __device__ __forceinline__ void {fn}(",
             f"      const Src& {src}, long long* __restrict__ {dst}) {{"]
    lines += [f"    const long long {src}{c} = {src}[{c} * kL];" for c in cols]
    lines += [f"    {dst}[{k} * kL] = {_sum(row, src)};" for k, row in enumerate(mat)]
    return lines + ["  }"]


def _gamma(mat: np.ndarray) -> list:
    leaves = sorted({int(k) for k in np.nonzero(mat)[1]})
    lines = ["  static __device__ __forceinline__ void gamma(",
             "      const int* __restrict__ lv, long long* __restrict__ g) {"]
    lines += [f"    const long long v{k} = lv[{k} * kW];" for k in leaves]
    lines += [f"    g[{r} * kWPitch] = {_sum(row, 'v')};" for r, row in enumerate(mat)]
    return lines + ["  }"]


def render() -> str:
    """The header's text."""
    one = ", ".join(f"0x{int(v):08x}LL" for v in F._ONE_MONT)
    out = [
        "// Generated by consensus_specs_tpu_torch/ops/fq_tables_gen.py from",
        "// ops/fq_tower.py::TABLES; do not edit. Regenerate with",
        "//   python -m consensus_specs_tpu_torch.ops.fq_tables_gen",
        "//",
        "// Table<K>, K the product's kind (Bilinear.kind): P leaves, R outputs,",
        "// Ca and Cb input coefficients of a and b (b has one more, Montgomery",
        "// one, with one_col), norm_in (three carry rounds on the inputs first).",
        "// alpha(a, x) / beta(b, y): x[k * kL] = alpha[k] . (a[c * kL])_c for one",
        "// limb of one lane (x points at that limb of row 0; a is a pointer to it",
        "// in row 0 of contiguous rows, or any source whose a[c * kL] reads it in",
        "// coefficient c, such as a register file's gather). gamma(lv, g):",
        "// g[r * kWPitch] = sum_k gamma[r][k] * lv[k * kW] for one column of one",
        "// lane (lv: int32 leaf columns). kL, kW and kWPitch come from the",
        "// including file (csrc/fq_arith.cuh).",
        "",
        "#pragma once",
        "",
        f"constexpr int kNumKinds = {len(T.TABLES)};",
        "",
        "// Montgomery one (R mod q), 29-bit limbs, least significant first.",
        f"__constant__ long long kOneMont[{F.L}] = {{{one}}};",
        "",
        "template <int K>",
        "struct Table;",
    ]
    for t in T.TABLES:
        alpha, beta, gamma = (m.mat for m in t)
        out += [
            "",
            f"// {t.name}",
            "template <>",
            f"struct Table<{t.kind}> {{",
            f"  static constexpr int P = {t.P}, R = {t.R}, Ca = {t.Ca}, Cb = {t.Cb};",
            f"  static constexpr bool one_col = {str(t.one_col).lower()},"
            f" norm_in = {str(t.norm_in).lower()};",
        ]
        out += _presum("alpha", alpha, "a", "x")
        out += _presum("beta", beta, "b", "y")
        out += _gamma(gamma)
        out.append("};")
    return "\n".join(out) + "\n"


def main() -> None:
    HEADER.write_text(render())
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
