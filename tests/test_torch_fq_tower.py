"""Port's tower (consensus_specs_tpu_torch.ops.fq_tower) == the JAX
package's ops/fq_tower.py, limb for limb, and its derived tables == the
reference's arrays.

Inputs are lazy limb arrays from a seeded numpy generator (body limbs in
[-16, 2^29], the normalized multiply output range); Fq12 cyclotomic
elements come from the final exponentiation's easy part. Tolerance: zero."""
import re

import numpy as np
import pytest

from consensus_specs_tpu.ops import fq_tower as JT
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.ops import fq_tower as TT

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


# One batch shape throughout: the reference runs eagerly here, and its
# per-shape op compilations are shared between the tests of a process.
BATCH = (2,)


def _rand(rng, shape):
    """Lazy limbs in [-16, 2^29] with a top limb in [0, 13], so values
    stay inside the multiply budget (|v| < 2^393)."""
    a = rng.integers(-16, (1 << 29) + 1, shape + (14,))
    a[..., -1] = rng.integers(0, 14, shape)
    return a


def _t(a):
    return convert.limbs_from_numpy(np.asarray(a), "cpu")


def _same(t, j):
    got = convert.limbs_to_numpy(t)
    want = np.asarray(j)
    assert got.shape == want.shape
    assert (got == want).all()


def test_bilinear_tables_equal_reference_arrays():
    ours = TT._MUL_T + TT._SQR_T + TT._LINE_T
    ref = (JT._ALPHA, JT._BETA, JT._GAMMA, JT._SQR_ALPHA, JT._SQR_BETA,
           JT._SQR_GAMMA, JT._LINE_ALPHA, JT._LINE_BETA, JT._LINE_GAMMA)
    assert [m.mat.shape[0] for m in (TT._MUL_T[0], TT._SQR_T[0], TT._LINE_T[0])] \
        == [54, 36, 39]
    for mine, theirs in zip(ours, ref):
        assert mine.mat.dtype == theirs.dtype and (mine.mat == theirs).all()
        # the gather form holds the same matrix
        dense = np.zeros_like(mine.mat)
        for r in range(dense.shape[0]):
            for c, v in zip(mine.idx[r], mine.coef[r, :, 0]):
                dense[r, c] += v
        assert (dense == theirs).all()
    for k in (1, 2, 3):
        assert (TT._FROB[k] == JT._FROB[k]).all()
    assert (TT._FQ12_ONE_NP == JT.fq12_to_limbs(JT.gt.FQ12_ONE)).all()


def test_fq2_ops_match_jax():
    rng = np.random.default_rng(10)
    a, b = _rand(rng, BATCH + (2,)), _rand(rng, BATCH + (2,))
    s = _rand(rng, BATCH)
    ta, tb = _t(a), _t(b)
    want = JT.fq2_mul(a, b)
    _same(TT.fq2_mul(ta, tb), want)
    _same(TT.PLAIN.fq2_mul(ta, tb), want)
    _same(TT.fq2_sqr(ta), JT.fq2_sqr(a))
    _same(TT.fq2_scale(ta, _t(s)), JT.fq2_scale(a, s))
    _same(TT.fq2_mul_xi(ta), JT.fq2_mul_xi(a))
    _same(TT.fq2_conj(ta), JT.fq2_conj(a))
    _same(TT.fq2_inv(ta), JT.fq2_inv(a))
    zero_ish = np.stack([JT.F.int_to_limbs(JT.F.Q), -JT.F.int_to_limbs(JT.F.Q)])
    z = np.concatenate([a, zero_ish[None]])
    _same(TT.fq2_is_zero(_t(z)), JT.fq2_is_zero(z))
    _same(TT.fq2_eq(ta, ta), JT.fq2_eq(a, a))
    _same(TT.fq2_eq(ta, tb), JT.fq2_eq(a, b))


def test_fq6_ops_match_jax():
    rng = np.random.default_rng(11)
    a, b = _rand(rng, BATCH + (3, 2)), _rand(rng, BATCH + (3, 2))
    s = _rand(rng, BATCH + (2,))
    ta, tb = _t(a), _t(b)
    _same(TT.fq6_mul(ta, tb), JT.fq6_mul(a, b))
    _same(TT.fq6_sqr(ta), JT.fq6_sqr(a))
    _same(TT.fq6_scale_fq2(ta, _t(s)), JT.fq6_scale_fq2(a, s))
    _same(TT.fq6_mul_by_v(ta), JT.fq6_mul_by_v(a))
    _same(TT.fq6_inv(ta), JT.fq6_inv(a))


def test_fq12_products_match_jax():
    rng = np.random.default_rng(12)
    a, b = _rand(rng, BATCH + (2, 3, 2)), _rand(rng, BATCH + (2, 3, 2))
    ca, cv, cvw = (_rand(rng, BATCH + (2,)) for _ in range(3))
    ta, tb = _t(a), _t(b)
    _same(TT.fq12_mul(ta, tb), JT.fq12_mul(a, b))
    b0 = np.broadcast_to(b[0], b.shape)                      # broadcast
    _same(TT.fq12_mul(ta, tb[0]), JT.fq12_mul(a, b0))
    _same(TT.fq12_sqr(ta), JT.fq12_sqr(a))
    want = JT.fq12_mul_line(a, ca, cv, cvw)
    _same(TT.fq12_mul_line(ta, _t(ca), _t(cv), _t(cvw)), want)
    _same(TT.PLAIN.fq12_mul_line(ta, _t(ca), _t(cv), _t(cvw)), want)
    _same(TT.fq12_conj(ta), JT.fq12_conj(a))
    _same(TT.fq12_eq(ta, ta), JT.fq12_eq(a, a))
    _same(TT.fq12_eq(ta, tb), JT.fq12_eq(a, b))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fq12_frobenius_matches_jax(k):
    rng = np.random.default_rng(20 + k)
    a = _rand(rng, BATCH + (2, 3, 2))
    _same(TT.fq12_frobenius(_t(a), k), JT.fq12_frobenius(a, k))


def test_fq12_inv_and_cyclotomic_squaring_match_jax():
    """fq12_inv, then the easy part f^((q^6-1)(q^2+1)) -- whose output is
    cyclotomic -- and a chain of Granger-Scott squarings on it."""
    rng = np.random.default_rng(13)
    f = _rand(rng, BATCH + (2, 3, 2))
    tf = _t(f)
    inv_t, inv_j = TT.fq12_inv(tf), JT.fq12_inv(f)
    _same(inv_t, inv_j)
    f1_t = TT.fq12_mul(TT.fq12_conj(tf), inv_t)
    f1_j = JT.fq12_mul(JT.fq12_conj(f), inv_j)
    cyc_t = TT.fq12_mul(TT.fq12_frobenius(f1_t, 2), f1_t)
    cyc_j = JT.fq12_mul(JT.fq12_frobenius(f1_j, 2), f1_j)
    _same(cyc_t, cyc_j)
    for _ in range(4):
        cyc_t, cyc_j = TT.fq12_cyclo_sqr(cyc_t), JT.fq12_cyclo_sqr(cyc_j)
        _same(cyc_t, cyc_j)
    # and the squaring is a squaring: equal in value to the general one
    assert bool(TT.fq12_eq(TT.fq12_cyclo_sqr(cyc_t), TT.fq12_sqr(cyc_t)).all())


# ---------------------------------------------------------------------------
# The fused tower product: every product is one fq_bilinear over tables
# ---------------------------------------------------------------------------

from consensus_specs_tpu.ops import fq as JF  # noqa: E402
from consensus_specs_tpu_torch.ops import fq as TF  # noqa: E402
from consensus_specs_tpu_torch.ops import fq_tables_gen  # noqa: E402

import torch  # noqa: E402


def _edge(rng, shape):
    """Lazy limbs at the multiply budget's edges: |body| < 2^32, |top| <
    2^16, with the first lane all at the maximum and the second all at the
    minimum (values may leave the value budget: the limbs must still
    agree, both sides computing the same integer function)."""
    a = rng.integers(-(1 << 32) + 1, 1 << 32, shape + (14,))
    a[..., -1] = rng.integers(-(1 << 16) + 1, 1 << 16, shape)
    a[0, ..., :-1], a[0, ..., -1] = (1 << 32) - 1, (1 << 16) - 1
    a[1, ..., :-1], a[1, ..., -1] = -(1 << 32) + 1, -(1 << 16) + 1
    return a


def _unfused_fq2_mul_wide(a, b):
    """The tower's Karatsuba wide product, unfused: torch ops around the
    wide multiply, as the port computed it before the fused product."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    A = torch.stack([a0, a1, a0 + a1], dim=-2)
    Bv = torch.stack([b0, b1, b0 + b1], dim=-2)
    Pw = TF.fq_wide_norm(TF.fq_mul_wide(A, Bv))
    t0, t1, t2 = Pw[..., 0, :], Pw[..., 1, :], Pw[..., 2, :]
    return torch.stack([t0 - t1, t2 - t0 - t1], dim=-2)


def _unfused_cyclo_sqr_cols(z_src):
    """The unfused Granger-Scott wide columns, component e at
    [e % 2, e // 2]."""
    z = [z_src[..., e % 2, e // 2, :, :] for e in range(6)]
    pairs = [(z[0], z[3]), (z[1], z[4]), (z[2], z[5])]
    lhs = torch.stack([x0 + x1 for x0, x1 in pairs] + [x0 for x0, _ in pairs], dim=-3)
    rhs = torch.stack([x0 + TT.fq2_mul_xi(x1) for x0, x1 in pairs]
                      + [x1 for _, x1 in pairs], dim=-3)
    P = _unfused_fq2_mul_wide(lhs, rhs)
    sq = []
    for k in range(3):
        m1, m2 = P[..., k, :, :], P[..., 3 + k, :, :]
        sq.append((m1 - m2 - TT.fq2_mul_xi(m2), m2 + m2))
    A2, B2, C2 = sq
    zw_src = TF.fq_wide_norm(TF.fq_mul_wide(z_src, TF.fq_ones((), z_src.device)))
    zw = [zw_src[..., e % 2, e // 2, :, :] for e in range(6)]
    out = [None] * 6
    out[0] = 3 * A2[0] - 2 * zw[0]
    out[3] = 3 * A2[1] + 2 * zw[3]
    out[1] = 3 * TT.fq2_mul_xi(C2[1]) + 2 * zw[1]
    out[4] = 3 * C2[0] - 2 * zw[4]
    out[2] = 3 * B2[0] - 2 * zw[2]
    out[5] = 3 * B2[1] + 2 * zw[5]
    return torch.stack(out, dim=-3)


def _unfused_product(name, a, b):
    """The unfused composition of each product: wide columns, then one
    REDC."""
    if name == "fq2_mul":
        return TF.fq_redc_plain(_unfused_fq2_mul_wide(a, b))
    if name == "fq12_cyclo_sqr":
        red = TF.fq_redc_plain(_unfused_cyclo_sqr_cols(TF.fq_norm(a)))
        rows = [torch.stack([red[..., 2 * i + j, :, :] for i in range(3)], dim=-3)
                for j in range(2)]
        return torch.stack(rows, dim=-4)
    tables = {"fq12_mul": TT._MUL_T, "fq12_sqr": TT._SQR_T,
              "fq12_mul_line": TT._LINE_T}[name]
    alpha, beta, gamma = tables
    av = a.reshape(a.shape[:-4] + (12, 14))
    bv = b if name == "fq12_mul_line" else b.reshape(b.shape[:-4] + (12, 14))
    Pw = TF.fq_wide_norm(TF.fq_mul_wide(alpha.apply(av), beta.apply(bv)))
    cv = TF.fq_redc_plain(gamma.apply(Pw))
    return cv.reshape(cv.shape[:-2] + (2, 3, 2, 14))


# (table, a's shape after the batch, b's shape, the reference function)
_PRODUCTS = {
    "fq2_mul": ((2,), (2,), lambda a, b: JT.fq2_mul(a, b)),
    "fq12_mul": ((2, 3, 2), (2, 3, 2), lambda a, b: JT.fq12_mul(a, b)),
    "fq12_sqr": ((2, 3, 2), None, lambda a, b: JT.fq12_sqr(a)),
    "fq12_mul_line": ((2, 3, 2), (6,), lambda a, b: JT.fq12_mul_line(
        a, b[..., 0:2, :], b[..., 2:4, :], b[..., 4:6, :])),
    "fq12_cyclo_sqr": ((2, 3, 2), None, lambda a, b: JT.fq12_cyclo_sqr(a)),
}


@pytest.mark.parametrize("name", list(_PRODUCTS))
def test_bilinear_plain_equals_unfused_composition_and_jax(name):
    """fq_bilinear_plain with each table == the unfused composition == the JAX
    package's product under its coeff backend, limb for limb, at the
    multiply budget's edges (the squarings: one operand)."""
    tables = {t.name: t for t in TT.TABLES}[name]
    a_shape, b_shape, ref = _PRODUCTS[name]
    rng = np.random.default_rng(30 + len(name))
    a = _edge(rng, BATCH + a_shape)
    b = a if b_shape is None else _edge(rng, BATCH + b_shape)
    ta, tb = _t(a), _t(b)
    av = ta.reshape(BATCH + (tables.Ca, 14))
    bv = av if b_shape is None else tb.reshape(BATCH + (tables.Cb, 14))
    got = TF.fq_bilinear_plain(av, bv, tables)
    unfused = _unfused_product(name, ta, tb)
    assert torch.equal(got.reshape(unfused.shape), unfused)
    with JF.pinned_fq_redc_backend("coeff"):
        _same(got.reshape(unfused.shape), ref(a, b))
    # and the Tower method is that product
    tower = {"fq2_mul": lambda: TT.fq2_mul(ta, tb),
             "fq12_mul": lambda: TT.fq12_mul(ta, tb),
             "fq12_sqr": lambda: TT.fq12_sqr(ta),
             "fq12_mul_line": lambda: TT.fq12_mul_line(
                 ta, tb[..., 0:2, :], tb[..., 2:4, :], tb[..., 4:6, :]),
             "fq12_cyclo_sqr": lambda: TT.fq12_cyclo_sqr(ta)}[name]()
    assert torch.equal(tower, unfused)


def _compiled_matrices(text, t):
    """(alpha, beta, gamma) read back from Table<t.kind>'s straight-line
    code in the generated header's text."""
    body = text.split(f"struct Table<{t.kind}> {{")[1].split("\n};")[0]
    shapes = {"x": (t.P, t.Ca), "y": (t.P, t.Cb + t.one_col), "g": (t.R, t.P)}
    mats = {k: np.zeros(v, np.int64) for k, v in shapes.items()}
    for dst, row, expr in re.findall(r"(\w)\[(\d+) \* k\w+\] = (.*);", body):
        for sign, coef, _, col in re.findall(r"(-?)\s*(?:(\d+) \* )?([abv])(\d+)",
                                             expr):
            mats[dst][int(row), int(col)] += (-1 if sign else 1) * int(coef or 1)
    return mats["x"], mats["y"], mats["g"]


def test_new_tables_pass_the_budget_and_pack_to_their_matrices():
    """The Fq2 and cyclotomic tables pass _check_budget (so does every
    table), the cyclotomic one has 18 Karatsuba and 12 passthrough leaves
    and 12 outputs, and each table's compiled form (its Table<kind> in
    the generated kernel header) decodes to its three matrices."""
    text = fq_tables_gen.render()
    for kind, t in enumerate(TT.TABLES):
        TT._check_budget(*(m.mat for m in t), t.name)
        assert t.kind == kind
        mats = _compiled_matrices(text, t)
        assert all((d == m.mat).all() for d, m in zip(mats, t))
        assert (f"P = {t.P}, R = {t.R}, Ca = {t.Ca}, Cb = {t.Cb};" in
                text.split(f"struct Table<{kind}> {{")[1])
    cyc = TT._CYCLO_T
    assert (cyc.P, cyc.R, cyc.Ca, cyc.Cb) == (30, 12, 12, 12)
    assert cyc.norm_in and cyc.one_col
    one_leaves = np.nonzero(cyc[1].mat[:, TT._ONE_COL])[0]
    assert len(one_leaves) == 12 and (cyc[1].mat[one_leaves, :12] == 0).all()
    assert (TT._FQ2_T.P, TT._FQ2_T.R) == (3, 2)
    bad = cyc[0].mat.copy()
    bad[0, :] = 1
    with pytest.raises(ValueError):
        TT._check_budget(bad, cyc[1].mat, cyc[2].mat, "bad")


class _Spy:
    """A Field route that records its calls; bilinear returns zeros."""

    def __init__(self):
        self.calls = {"mul": 0, "redc": 0, "bilinear": 0}

    def field(self):
        def mul(a, b):
            self.calls["mul"] += 1
            return TF.fq_mul_plain(a, b)

        def mul_norm(a, b):
            self.calls["mul"] += 1
            return TF.fq_mul_norm_plain(a, b)

        def redc(c):
            self.calls["redc"] += 1
            return TF.fq_redc_plain(c)

        def bilinear(av, bv, tables):
            self.calls["bilinear"] += 1
            batch = torch.broadcast_shapes(av.shape[:-2], bv.shape[:-2])
            return torch.zeros(batch + (tables.R, 14), dtype=torch.int64)

        return TF.Field(mul, mul_norm, redc, bilinear)


@pytest.mark.parametrize("name", list(_PRODUCTS))
def test_each_tower_product_is_one_bilinear_call(name, monkeypatch):
    wide = []
    real = TF.fq_mul_wide
    monkeypatch.setattr(TF, "fq_mul_wide", lambda a, b: wide.append(1) or real(a, b))
    spy = _Spy()
    tw = TT.Tower(spy.field())
    rng = np.random.default_rng(40)
    a = _t(_rand(rng, BATCH + (2, 3, 2)))
    line = [_t(_rand(rng, BATCH + (2,))) for _ in range(3)]
    x, y = _t(_rand(rng, BATCH + (2,))), _t(_rand(rng, BATCH + (2,)))
    out = {"fq2_mul": lambda: tw.fq2_mul(x, y),
           "fq12_mul": lambda: tw.fq12_mul(a, a),
           "fq12_sqr": lambda: tw.fq12_sqr(a),
           "fq12_mul_line": lambda: tw.fq12_mul_line(a, *line),
           "fq12_cyclo_sqr": lambda: tw.fq12_cyclo_sqr(a)}[name]()
    assert spy.calls == {"mul": 0, "redc": 0, "bilinear": 1}
    assert wide == []
    assert out.shape == ((x if name == "fq2_mul" else a).shape)


def _round_interval(lo, hi):
    """One carry round over per-limb integer intervals: each limb's low
    bits in [0, MASK] plus the carry from below; the top limb keeps its
    own overflow, so it only gains the carry in."""
    B, n = TF.B, len(lo)
    clo, chi = [x >> B for x in lo], [x >> B for x in hi]
    nlo = [0] + [clo[k - 1] for k in range(1, n - 1)] + [lo[-1] + clo[-2]]
    nhi = ([TF.MASK] + [TF.MASK + chi[k - 1] for k in range(1, n - 1)]
           + [hi[-1] + chi[-2]])
    return nlo, nhi


def test_kernel_int32_preconditions_hold_at_the_budget_edges():
    """csrc/fq_mont.cu holds multiply operands and leaf columns in int32.
    Interval bounds from the multiply budget (|body| <= 2^32, |top| <=
    2^16 per input coefficient) through the largest pre-sum of any table:
    after the first input carry round every limb of every leaf operand
    fits int32 (the kernel runs the other two rounds in int32); after two
    wide rounds every column of a leaf's schoolbook fits int32 (the kernel
    runs the third in int32 and stores the leaves so). Then the same on
    real extremes, all-max and all-min inputs, through each table."""
    def fits(lo, hi):
        return min(lo) >= -(1 << 31) and max(hi) < 1 << 31

    fan_in = max(int(np.abs(m.mat).sum(axis=1).max())
                 for t in TT.TABLES for m in t[:2])
    assert fan_in == 8
    lo = [-fan_in << 32] * 13 + [-fan_in << 16]
    hi = [fan_in << 32] * 13 + [fan_in << 16]
    lo1, hi1 = _round_interval(lo, hi)
    assert fits(lo1, hi1)
    lo3, hi3 = _round_interval(*_round_interval(lo1, hi1))
    assert fits(lo3, hi3)
    m = [max(-a, b) for a, b in zip(lo3, hi3)]
    cols = [sum(m[i] * m[k - i] for i in range(max(0, k - 13), min(k, 13) + 1))
            if k < 27 else 0 for k in range(28)]
    assert max(cols) <= TF.WIDE_COL_RAW + (1 << 50)      # inside int64
    wlo, whi = _round_interval(*_round_interval([-c for c in cols], cols))
    assert fits(wlo, whi)

    rng = np.random.default_rng(50)
    for t in TT.TABLES:
        av = torch.from_numpy(_edge(rng, (4, t.Ca)))
        bv = torch.from_numpy(_edge(rng, (4, t.Cb)))
        if t.one_col:
            bv = torch.cat([bv, TF.fq_ones((4, 1), "cpu")], dim=-2)
        A, Bm = t[0].apply(av), t[1].apply(bv)
        for x in (A, Bm):
            assert int(TF._carry_rounds(x, 1).abs().max()) < 1 << 31
            assert int(TF._carry_rounds(x, 3).abs().max()) < 1 << 31
        w = TF._carry_rounds(TF.fq_mul_wide(A, Bm), 2)
        assert int(w.abs().max()) < 1 << 31
