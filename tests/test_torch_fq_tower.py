"""Port's tower (consensus_specs_tpu_torch.ops.fq_tower) == the JAX
package's ops/fq_tower.py, limb for limb, and its derived tables == the
reference's arrays.

Inputs are lazy limb arrays from a seeded numpy generator (body limbs in
[-16, 2^29], the normalized multiply output range); Fq12 cyclotomic
elements come from the final exponentiation's easy part. Tolerance: zero."""
import numpy as np
import pytest

from consensus_specs_tpu.ops import fq_tower as JT
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.ops import fq_tower as TT

from _release_jax import release_jax_programs  # noqa: F401 (autouse)


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
    _same(TT.fq2_mul(ta, tb), JT.fq2_mul(a, b))
    _same(TT.PLAIN.fq2_mul(ta, tb), JT.fq2_mul(a, b))
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
    _same(TT.fq12_mul_line(ta, _t(ca), _t(cv), _t(cvw)),
          JT.fq12_mul_line(a, ca, cv, cvw))
    _same(TT.PLAIN.fq12_mul_line(ta, _t(ca), _t(cv), _t(cvw)),
          JT.fq12_mul_line(a, ca, cv, cvw))
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
