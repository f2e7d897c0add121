"""Port's base field (consensus_specs_tpu_torch.ops.fq) == the JAX
package's ops/fq.py, limb for limb.

Inputs are numpy arrays from a seed, at the edges of the reference's
proven laziness budget: multiply inputs with body limbs |l| < 2^32 and a
top limb |l| < 2^16, REDC columns |col| < 2^35 (top column < 2^38) and raw
schoolbook columns up to 14 * 2^58. Tolerance: zero (integer limbs)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fq as JF
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.ops import fq as TF
from consensus_specs_tpu_torch.ops import fq_cuda

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

# the field's constants of the CUDA sources (csrc/fq_mont.cu and
# csrc/fq_points.cu include them)
KERNEL_SOURCE = (Path(__file__).resolve().parent.parent
                 / "consensus_specs_tpu_torch" / "csrc" / "fq_arith.cuh")


def _narrow(rng, n):
    """Multiply inputs at the budget edge: |body| < 2^32, |top| < 2^16."""
    a = rng.integers(-(1 << 32) + 1, 1 << 32, (n, 14))
    a[:, -1] = rng.integers(-(1 << 16) + 1, 1 << 16, n)
    return a


def _t(a):
    return convert.limbs_from_numpy(a, "cpu")


def _same(t, j):
    got = convert.limbs_to_numpy(t)
    want = np.asarray(j)
    assert got.shape == want.shape
    assert (got == want).all()


def test_constants_match_jax():
    for name in ("Q", "B", "L", "MASK", "R_MONT", "R2_MONT", "QINV_NEG",
                 "NORM_FULL", "NARROW_INPUT_BOUND", "NARROW_TOP_SPILL",
                 "WIDE_COL_RAW", "WIDE_COL_BUDGET", "WIDE_TOP_SPILL",
                 "NARROW_LIMB_LO", "NARROW_LIMB_HI", "CANONICAL_TOP",
                 "WIDE_ACCUM_FANIN"):
        assert getattr(TF, name) == getattr(JF, name), name
    assert (TF.Q_LIMBS == JF.Q_LIMBS).all() and TF.CANONICAL_TOP == 13
    for k in (0, 1, 2, 12345, JF.Q - 1):
        assert (TF.to_mont(k) == JF.to_mont(k)).all()
        assert TF.from_mont(TF.to_mont(k)) == k
    assert (TF._INV_EXP_BITS == JF._INV_EXP_BITS).all()
    assert (TF._SQRT_EXP_BITS == JF._SQRT_EXP_BITS).all()


def test_pow_static_cost_model_matches_jax_and_counts_the_multiplies():
    """pow_static_muls == the reference's cost model, and == the multiplies
    Field.pow_static makes (squarings excluded) on a short exponent."""
    for nbits in (1, 7, 64, 380, 381):
        for w in range(1, 7):
            assert TF.pow_static_muls(nbits, w) == JF.pow_static_muls(nbits, w)
    calls = []

    def mul(a, b):
        calls.append(1)
        return TF.fq_mul_plain(a, b)
    field = TF.Field(mul, TF.fq_mul_norm_plain, TF.fq_redc_plain, TF.fq_bilinear_plain)
    bits = TF._exp_bits(0b1011_0010_0111_1101_0110)
    a = _t(np.stack([TF.to_mont(5)]))
    got = field.pow_static(a, bits, w=3)
    assert TF.from_mont(convert.limbs_to_numpy(got)[0]) == pow(5, 0b1011_0010_0111_1101_0110, TF.Q)
    squarings = 3 * (-(-len(bits) // 3) - 1)
    assert len(calls) == TF.pow_static_muls(len(bits), 3) + squarings


def test_kernel_source_constants_match():
    """csrc/fq_arith.cuh (the arithmetic csrc/fq_mont.cu and
    csrc/fq_points.cu share) carries q's limbs, -q^-1 mod 2^29, B and L
    as literals; they must be the field's."""
    src = KERNEL_SOURCE.read_text()
    q_block = re.search(r"kQ\[kL\]\s*=\s*\{([^}]*)\}", src).group(1)
    q_limbs = [int(v.rstrip("LL"), 16) for v in re.findall(r"0x[0-9a-fA-F]+LL", q_block)]
    assert q_limbs == [int(v) for v in JF.Q_LIMBS]
    qinv = int(re.search(r"kQinvNeg\s*=\s*(0x[0-9a-fA-F]+)LL", src).group(1), 16)
    assert qinv == JF.QINV_NEG
    assert int(re.search(r"kB\s*=\s*(\d+)", src).group(1)) == JF.B
    assert int(re.search(r"kL\s*=\s*(\d+)", src).group(1)) == JF.L


@pytest.mark.parametrize("rounds", [3, TF.NORM_FULL])
def test_carry_rounds_match_jax(rounds):
    rng = np.random.default_rng(rounds)
    a = rng.integers(-(1 << 33), 1 << 33, (40, 14))
    _same(TF._carry_rounds(_t(a), rounds), JF._carry_rounds_impl(a, rounds))
    w = rng.integers(-TF.WIDE_COL_RAW, TF.WIDE_COL_RAW, (40, 28))
    _same(TF.fq_wide_norm(_t(w), rounds), JF.fq_wide_norm(w, rounds))


def test_fq_mul_wide_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _narrow(rng, 64), _narrow(rng, 64)
    _same(TF.fq_mul_wide(_t(a), _t(b)), JF.fq_mul_wide(a, b))
    # broadcasting one operand over the batch
    _same(TF.fq_mul_wide(_t(a), _t(b[0])), JF.fq_mul_wide(a, b[0]))
    _same(TF.fq_wide_from_mont(_t(a)), JF.fq_wide_from_mont(a))


@pytest.mark.parametrize("edge", ["budget_2^35", "raw_schoolbook"])
def test_fq_redc_matches_jax_at_budget_edges(edge):
    rng = np.random.default_rng(2)
    if edge == "budget_2^35":
        cols = rng.integers(-TF.WIDE_COL_BUDGET + 1, TF.WIDE_COL_BUDGET, (64, 28))
        cols[:, -1] = rng.integers(-TF.WIDE_TOP_SPILL + 1, TF.WIDE_TOP_SPILL, 64)
        cols[0, :-1] = TF.WIDE_COL_BUDGET - 1
        cols[1, :-1] = -TF.WIDE_COL_BUDGET + 1
    else:
        cols = rng.integers(-TF.WIDE_COL_RAW, TF.WIDE_COL_RAW + 1, (64, 28))
        cols[0] = TF.WIDE_COL_RAW
        cols[1] = -TF.WIDE_COL_RAW
    got = TF.fq_redc(_t(cols))
    _same(got, JF.fq_redc(cols))
    assert torch.equal(TF.fq_redc_plain(_t(cols)), got)


def test_fq_mul_and_sqr_match_jax():
    rng = np.random.default_rng(3)
    a, b = _narrow(rng, 64), _narrow(rng, 64)
    _same(TF.fq_mul(_t(a), _t(b)), JF.fq_mul(a, b))
    _same(TF.fq_sqr(_t(a)), JF.fq_sqr(a))
    _same(TF.PLAIN.mul(_t(a), _t(b)), JF.fq_mul(a, b))
    # value check against bignums: Montgomery product of canonical inputs
    x, y = 0x1234567 * 10 ** 90 % JF.Q, JF.Q - 5
    got = TF.fq_mul(_t(TF.to_mont(x)), _t(TF.to_mont(y)))
    assert TF.from_mont(convert.limbs_to_numpy(got)) == x * y % JF.Q


def test_fq_canon_is_zero_eq_match_jax():
    rng = np.random.default_rng(4)
    q = JF.Q
    special = [0, 1, q - 1, q, q + 1, 2 * q - 1]
    rows = [JF.int_to_limbs(v) for v in special]
    rows.append(JF.int_to_limbs(q) - JF.int_to_limbs(0))
    rows.append(-JF.int_to_limbs(q))                   # -q, lazy
    rows.append(-JF.int_to_limbs(1))
    a = np.concatenate([np.stack(rows), _narrow(rng, 32)])
    ta = _t(a)
    _same(TF.fq_canon(ta), JF.fq_canon(a))
    _same(TF.fq_is_zero(ta), JF.fq_is_zero(a))
    b = np.roll(a, 1, axis=0)
    _same(TF.fq_eq(ta, _t(b)), JF.fq_eq(a, b))
    _same(TF.fq_eq(ta, ta), JF.fq_eq(a, a))


def test_fq_inv_and_sqrt_candidate_match_jax():
    rng = np.random.default_rng(5)
    a = _narrow(rng, 6)
    _same(TF.fq_inv(_t(a)), JF.fq_inv(a))
    sq = JF.stack_mont([4, 9, 5, 0])
    _same(TF.fq_sqrt_candidate(_t(sq)), JF.fq_sqrt_candidate(sq))
    got = convert.limbs_to_numpy(TF.fq_sqrt_candidate(_t(sq)))
    assert [TF.from_mont(r) ** 2 % JF.Q for r in got[:2]] == [4, 9]


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the routed entry points are the plain versions; the
    kernel wrappers themselves refuse CPU tensors (they never run the
    plain path)."""
    rng = np.random.default_rng(6)
    a, b = _t(_narrow(rng, 8)), _t(_narrow(rng, 8))
    cols = _t(rng.integers(-(1 << 35), 1 << 35, (8, 28)))
    assert torch.equal(TF.fq_mul(a, b), TF.fq_mul_plain(a, b))
    assert torch.equal(TF.fq_redc(cols), TF.fq_redc_plain(cols))
    with pytest.raises(ValueError):
        fq_cuda.fq_mul_cuda(a, b)
    with pytest.raises(ValueError):
        fq_cuda.fq_redc_cuda(cols)
    assert TF.DEVICE.mul is TF.fq_mul and TF.PLAIN.redc is TF.fq_redc_plain


def test_kernel_bound_counts():
    """The bound's per-lane work: 406 / 210 products, 336 bytes each."""
    assert fq_cuda.PRODUCTS_PER_LANE == {"fq_mul": 406, "fq_redc": 210}
    assert fq_cuda.BYTES_PER_LANE == {"fq_mul": 336, "fq_redc": 336}
    ms, by = fq_cuda.bound_ms("fq_mul", 1 << 20, 132 * 64 * 1.98e9, 3.35e12)
    assert by == "bytes" and ms == pytest.approx(336 * (1 << 20) / 3.35e9)


def test_limb_conversion_round_trip():
    rng = np.random.default_rng(7)
    for shape in [(14,), (3, 2, 14), (2, 2, 3, 2, 14)]:
        a = rng.integers(-(1 << 40), 1 << 40, shape)
        t = convert.limbs_from_numpy(a, "cpu")
        assert t.dtype == torch.int64 and tuple(t.shape) == shape
        assert (convert.limbs_to_numpy(t) == a).all()
    with pytest.raises(TypeError):
        convert.limbs_from_numpy(a.astype(np.int32), "cpu")


def _kernel_rows(layout, k, base, n, C, width):
    """The rows operand k of a launch reads, as csrc/fq_mont.cu's
    lane_offset computes them from the layout argument: [n, C, width]
    gathered from `base` (a flat view of the operand's storage)."""
    vals = list(layout)
    ndim, sizes = vals[0], vals[1:1 + fq_cuda.MAX_DIMS]
    p = vals[1 + fq_cuda.MAX_DIMS + k * (fq_cuda.MAX_DIMS + 2):]
    strides, cstride = p[:fq_cuda.MAX_DIMS], p[fq_cuda.MAX_DIMS]
    rows = []
    for lane in range(n):
        off, rest = 0, lane
        for d in range(fq_cuda.MAX_DIMS - 1, -1, -1):
            if d < ndim:
                rest, i = divmod(rest, sizes[d])
                off += i * strides[d]
        rows.append([base[off + c * cstride: off + c * cstride + width]
                     for c in range(C)])
    return torch.stack([torch.stack(r) for r in rows])


@pytest.mark.parametrize("case", ["fq2_scale", "frobenius", "one_lane", "sliced",
                                  "leading_broadcast"])
def test_kernel_layout_addresses_the_broadcast_rows(case):
    """The host half of the kernels' broadcast: the layout argument built
    from two (broadcast, strided) operands makes the kernel read exactly
    the rows of their expanded views, lane for lane, with no copy."""
    big = torch.arange(6 * 4 * 3 * 2 * 14, dtype=torch.int64)
    a_full = big[:4 * 3 * 2 * 14].reshape(4, 3, 2, 14)
    if case == "fq2_scale":            # a [4, 3, 2, L] x s[..., None, :, :]
        a, b = a_full, big[:4 * 2 * 14].reshape(4, 1, 2, 14) + 7
    elif case == "frobenius":          # x [4, 3, 2, L] x a [3, 2, L] constant
        a, b = a_full, big[:3 * 2 * 14].reshape(3, 2, 14) + 3
    elif case == "one_lane":
        a, b = a_full[:1, :1], a_full[1:2, 2:3]
    elif case == "sliced":             # every other lane, odd offset
        a, b = big.as_strided((4, 3, 2, 14), (168, 56, 14, 1), 14), a_full
    else:                              # [1, 3] over [4, 3]
        a, b = a_full, a_full[2:3]
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    views = [t.expand(batch + (2, 14)) for t in (a, b)]
    layout = fq_cuda._layout(batch, views)
    n = int(np.prod(batch))
    for k, (t, v) in enumerate(zip((a, b), views)):
        base = torch.as_strided(t, (t.untyped_storage().nbytes() // 8,), (1,), 0)
        start = t.storage_offset()
        got = _kernel_rows(layout, k, base[start:], n, 2, 14)
        assert torch.equal(got, v.reshape(n, 2, 14)), (case, k)
    if case == "one_lane":             # no lane axis left
        assert list(layout)[0] == 0
    if case == "frobenius":            # two axes: b's outer stride is 0
        assert list(layout)[:3] == [2, 4, 3]
        assert list(layout)[11:13] == [0, 28]


def test_kernel_bound_counts_bilinear():
    """An Fq12 multiply lane: 54 schoolbooks and 12 REDCs, 13,104
    products; 24 coefficients in and 12 out, 4,032 bytes; about 1.26 ms
    at 1,048,576 lanes, set by the bytes."""
    assert fq_cuda.bilinear_work(54, 12, 12, 12) == (13104, 4032)
    ms, by = fq_cuda.bound_ms("fq_bilinear", 1 << 20, 132 * 64 * 1.98e9, 3.35e12,
                              P=54, R=12, Ca=12, Cb=12)
    assert by == "bytes" and ms == pytest.approx(4032 * (1 << 20) / 3.35e9)
    assert ms == pytest.approx(1.262, abs=1e-3)


def test_bilinear_route_on_the_cpu():
    """fq_bilinear takes the plain version for CPU tensors; the kernel
    wrapper refuses them; DEVICE / PLAIN carry the two routes."""
    from consensus_specs_tpu_torch.ops import fq_tower as TT
    rng = np.random.default_rng(8)
    av = _t(_narrow(rng, 6).reshape(3, 2, 14))
    bv = _t(_narrow(rng, 6).reshape(3, 2, 14))
    assert torch.equal(TF.fq_bilinear(av, bv, TT._FQ2_T),
                       TF.fq_bilinear_plain(av, bv, TT._FQ2_T))
    with pytest.raises(ValueError):
        fq_cuda.fq_bilinear_cuda(av, bv, TT._FQ2_T)
    with pytest.raises(ValueError):
        TF.fq_bilinear_plain(av, bv[..., :1, :], TT._FQ2_T)
    assert TF.DEVICE.bilinear is TF.fq_bilinear
    assert TF.PLAIN.bilinear is TF.fq_bilinear_plain


def test_mul_norm_matches_jax_and_routes_on_the_cpu():
    """fq_mul_norm == the reference's Montgomery product followed by
    NORM_FULL carry rounds (what its fq_is_zero / fq_canon compare), at
    the budget's edges; plain on the CPU, the kernel wrapper refuses CPU
    tensors."""
    rng = np.random.default_rng(9)
    a, b = _narrow(rng, 32), _narrow(rng, 32)
    want = JF._carry_rounds_impl(JF.fq_mul(a, b), JF.NORM_FULL)
    _same(TF.fq_mul_norm(_t(a), _t(b)), want)
    _same(TF.fq_mul_norm_plain(_t(a), _t(b)), want)
    with pytest.raises(ValueError):
        fq_cuda.fq_mul_cuda(_t(a), _t(b), norm_full=True)
    assert TF.DEVICE.mul_norm is TF.fq_mul_norm
    assert TF.PLAIN.mul_norm is TF.fq_mul_norm_plain


def test_helpers_take_no_default_device():
    """fq/fq2/fq12 zeros and ones and the point at infinity need their
    device: none lands on the CPU by omission."""
    from consensus_specs_tpu_torch.ops import bls_torch, fq_tower as TT
    from consensus_specs_tpu_torch.ops import scalar_mul as SM
    for fn in (TF.fq_zeros, TF.fq_ones, TT.fq2_zeros, TT.fq2_ones, TT.fq12_ones):
        with pytest.raises(TypeError):
            fn((2,))
        assert fn((2,), "cpu").device.type == "cpu"
    with pytest.raises(TypeError):
        SM.jac_infinity(bls_torch.G1_OPS, (2,))
    X, Y, Z = SM.jac_infinity(bls_torch.G2_OPS, (2,), "cpu")
    assert X.shape == (2, 2, 14) and bool((Z == 0).all())
