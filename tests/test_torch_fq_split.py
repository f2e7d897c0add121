"""The point kernels' split multiply (csrc/fq_points.cu: a multiply, a
leaf and a REDC each on a group of 16 threads) modelled on the CPU by
consensus_specs_tpu_torch/ops/fq_points.py's split_* functions: lane k
holds limb k and columns k and k + 14, the REDC digits come one after
another from the low columns, each lane updates its own high column.
The model is held bit for bit against the port's plain field
(fq_mul_plain, fq_redc_plain, fq_wide_norm, fq_bilinear_plain, each held
against the JAX package in tests/test_torch_fq*.py) and, for the
multiply, against the JAX package's fq_mul on the same inputs.

Inputs are numpy arrays from a seed: lazy limbs in [-16, 2^29] with top
limbs in [0, 13] (the range every program value keeps), the multiply
budget's edge (|body| < 2^32, |top| < 2^16), the values zero, q - 1, q
and -q, and REDC columns at their budget (|col| < 2^35, top column <
2^38) and raw schoolbook columns up to 14 * 2^58. Tolerance zero:
integer limbs compared exactly."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fq as JF
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.ops import fq as TF
from consensus_specs_tpu_torch.ops import fq_points as FPt
from consensus_specs_tpu_torch.ops import fq_tower as TT

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


def _lazy(rng, n):
    a = rng.integers(-16, (1 << 29) + 1, (n, TF.L))
    a[:, -1] = rng.integers(0, 14, n)
    return a


def _edges():
    """Zero, q - 1, q, -q and the largest lazy operands the budget allows
    (every body limb at +-(2^32 - 1), the top at +-(2^16 - 1))."""
    big = np.full(TF.L, TF.NARROW_INPUT_BOUND - 1, np.int64)
    big[-1] = TF.NARROW_TOP_SPILL - 1
    return np.stack([np.zeros(TF.L, np.int64), TF.int_to_limbs(TF.Q - 1),
                     TF.int_to_limbs(TF.Q), TF._NEGQ_PAT, big, -big])


def _t(a):
    return convert.limbs_from_numpy(np.asarray(a), "cpu")


def _operands(seed):
    rng = np.random.default_rng(seed)
    e = _edges()
    rand = _lazy(rng, 64)
    # every edge against every edge and against random lazy values
    a = np.concatenate([np.repeat(e, len(e), 0), e.repeat(8, 0), rand])
    b = np.concatenate([np.tile(e, (len(e), 1)), _lazy(rng, 8 * len(e)), _lazy(rng, 64)])
    return a, b


def test_lane_narrowing_and_columns_are_the_schoolbook():
    """split_narrow == three carry rounds (fq_norm), and the columns of
    the lanes == fq_mul_wide's, on the multiply operands."""
    a, b = _operands(0x5A1)
    x, y = FPt.split_narrow(_t(a)), FPt.split_narrow(_t(b))
    assert torch.equal(x, TF.fq_norm(_t(a))) and torch.equal(y, TF.fq_norm(_t(b)))
    assert torch.equal(FPt.split_columns(x, y), TF.fq_mul_wide(_t(a), _t(b)))


def test_split_mul_is_fq_mul_plain_and_the_reference():
    """The whole multiply as the group runs it == fq_mul_plain == the JAX
    package's fq_mul, edges included."""
    a, b = _operands(0x5A2)
    got = FPt.split_mul(_t(a), _t(b))
    assert torch.equal(got, TF.fq_mul_plain(_t(a), _t(b)))
    assert (convert.limbs_to_numpy(got) == np.asarray(JF.fq_mul(a, b))).all()


@pytest.mark.parametrize("what", ["budget", "raw", "budget registers", "raw registers"])
def test_split_redc_is_fq_redc_plain(what):
    """The group's REDC == fq_redc_plain, on REDC columns at their budget
    and on raw schoolbook columns: every lane making the digits one by one
    from the low columns, each lane's high column updated on its own; and
    ("registers", the kernels' group_redc_regs) each digit's column
    broadcast from its lane, each lane updating both its columns."""
    rng = np.random.default_rng(0x5A3)
    n = 200
    if what.startswith("budget"):
        cols = rng.integers(-(TF.WIDE_COL_BUDGET) + 1, TF.WIDE_COL_BUDGET, (n, 2 * TF.L))
        cols[:, -1] = rng.integers(-(TF.WIDE_TOP_SPILL) + 1, TF.WIDE_TOP_SPILL, n)
        cols[0] = 0
        cols[1, :-1], cols[2, :-1] = TF.WIDE_COL_BUDGET - 1, -TF.WIDE_COL_BUDGET + 1
        cols[1, -1], cols[2, -1] = TF.WIDE_TOP_SPILL - 1, -TF.WIDE_TOP_SPILL + 1
        cols[3] = TF.MASK
    else:
        cols = rng.integers(0, TF.WIDE_COL_RAW, (n, 2 * TF.L))
        cols[:, -1] = 0
        cols[0, :-1] = TF.WIDE_COL_RAW - 1
    route = "registers" if what.endswith("registers") else "triangle"
    assert torch.equal(FPt.split_redc(_t(cols), route), TF.fq_redc_plain(_t(cols)))


def test_split_wide_norm_is_fq_wide_norm():
    """A leaf's columns normalized across the lanes (two rounds in int64,
    one in int32) == fq_wide_norm's three rounds, on the schoolbook
    columns of the multiply operands, edges included (|col| <= 14 *
    2^58, column 27 zero)."""
    a, b = _operands(0x5A4)
    cols = TF.fq_mul_wide(_t(a), _t(b))
    assert torch.equal(FPt.split_wide_norm(cols), TF.fq_wide_norm(cols))


@pytest.mark.parametrize("tables", [t for t in TT.TABLES if not (t.norm_in or t.one_col)],
                         ids=lambda t: t.name)
def test_split_bilinear_is_fq_bilinear_plain(tables):
    """A program's tower product as the kernel runs it (each leaf and each
    output's REDC by a group) == fq_bilinear_plain, and its REDC input ==
    the plain REDC's: every kind the programs record."""
    rng = np.random.default_rng(0x5A5 + tables.kind)
    av = _t(np.stack([_lazy(rng, tables.Ca) for _ in range(12)]))
    bv = _t(np.stack([_lazy(rng, tables.Cb) for _ in range(12)]))
    want = TF.fq_bilinear_plain(av, bv, tables)
    assert torch.equal(FPt.split_bilinear(av, bv, tables), want)
    alpha, beta, gamma = tables
    cols = gamma.apply(TF.fq_wide_norm(TF.fq_mul_wide(alpha.apply(av), beta.apply(bv))))
    assert torch.equal(FPt.split_redc(cols), want)
    assert torch.equal(FPt.split_redc(cols, "registers"), want)
