"""Port's curve layer (consensus_specs_tpu_torch.ops.scalar_mul,
ops.decompress) == the JAX package's, limb for limb, and == the bignum
oracle (consensus_specs_tpu/crypto/bls12_381.py) in value and verdict.

Points are multiples of the generators by seeded scalars; encodings cover
every malformed class of tests/test_decompress.py. The reference's
windowed scalar mul is compared in its unrolled form at a short scalar
(its loop form compiles for half a minute on the CPU); the full 256-bit
width is held against the oracle. Tolerance: zero."""
import random

import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import bls12_381 as gt
from consensus_specs_tpu.ops import bls_jax as BJ
from consensus_specs_tpu.ops import decompress as JD
from consensus_specs_tpu.ops import fq as JF
from consensus_specs_tpu.ops import fq_tower as JT
from consensus_specs_tpu.ops import scalar_mul as JSM
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls12_381 as pgt
from consensus_specs_tpu_torch.ops import bls_torch as BT
from consensus_specs_tpu_torch.ops import decompress as TD
from consensus_specs_tpu_torch.ops import scalar_mul as TSM

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

rng = random.Random(0x7C0)


def _t(a):
    return convert.limbs_from_numpy(np.asarray(a), "cpu")


def _b(a):
    return torch.from_numpy(np.asarray(a, dtype=bool))


def _np(t):
    return convert.limbs_to_numpy(t)


def _same(t, j):
    got, want = _np(t), np.asarray(j)
    assert got.shape == want.shape and (got == want).all()


def _jacobian(points, to_limbs, one):
    """Oracle affine points (None = infinity) -> stacked Jacobian numpy
    limbs with z = 1, infinity as (0, 1, 0)."""
    xs, ys, zs = [], [], []
    for p in points:
        if p is None:
            xs.append(np.zeros_like(one))
            ys.append(one)
            zs.append(np.zeros_like(one))
        else:
            x, y = to_limbs(p)
            xs.append(x)
            ys.append(y)
            zs.append(one)
    return tuple(np.stack(c) for c in (xs, ys, zs))


def _affine_g1(x, y, inf):
    return [None if inf[k] else (JF.from_mont(x[k]), JF.from_mont(y[k]))
            for k in range(len(inf))]


def _affine_g2(x, y, inf):
    return [None if inf[k] else (JT.fq2_from_limbs(x[k]), JT.fq2_from_limbs(y[k]))
            for k in range(len(inf))]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_jac_add_double_match_jax_and_oracle(group):
    """Generic sum, P + P, P + (-P), O + Q, P + O, O + O in one batch."""
    if group == "g1":
        gen, to_limbs, one = gt.G1_GEN, BJ.g1_to_limbs, JF.to_mont(1)
        jops, tops, affine = BJ.G1_OPS, BT.G1_OPS, _affine_g1
    else:
        gen, to_limbs, one = gt.G2_GEN, BJ.g2_to_limbs, JT.fq2_to_limbs(gt.FQ2_ONE)
        jops, tops, affine = BJ.G2_OPS, BT.G2_OPS, _affine_g2
    a = gt.ec_mul(gen, rng.randrange(1, gt.r))
    b = gt.ec_mul(gen, rng.randrange(1, gt.r))
    lhs = [a, a, a, None, a, None]
    rhs = [b, a, gt.ec_neg(a), b, None, None]
    want = [gt.ec_add(p, q) for p, q in zip(lhs, rhs)]
    p1, p2 = _jacobian(lhs, to_limbs, one), _jacobian(rhs, to_limbs, one)
    t1, t2 = tuple(map(_t, p1)), tuple(map(_t, p2))

    got = TSM.jac_add(tops, t1, t2)
    for g, j in zip(got, BJ.jac_add(jops, p1, p2)):
        _same(g, j)
    doubled = TSM.jac_double(tops, t1)
    for g, j in zip(doubled, BJ.jac_double(jops, p1)):
        _same(g, j)
    x, y, inf = TSM.jac_to_affine(tops, got)
    assert affine(_np(x), _np(y), _np(inf)) == want
    dbl = TSM.jac_to_affine(tops, doubled)
    assert affine(*map(_np, dbl))[0] == gt.ec_double(a)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_windowed_scalar_mul_matches_jax_unrolled(group):
    """An even 4-bit scalar (table build, one loop trip and the fixup add)
    over a batch with an infinity point, against the reference's unrolled
    walk at w = 4, then in value against the oracle. The batch has the
    jac_add test's size, so the reference's eager op compilations are
    shared."""
    if group == "g1":
        gen, to_limbs, jops, tops, affine = (
            gt.G1_GEN, BJ.g1_to_limbs, BJ.G1_OPS, BT.G1_OPS, _affine_g1)
    else:
        gen, to_limbs, jops, tops, affine = (
            gt.G2_GEN, BJ.g2_to_limbs, BJ.G2_OPS, BT.G2_OPS, _affine_g2)
    pts = [gt.ec_mul(gen, rng.randrange(1, gt.r)) for _ in range(5)]
    arr = np.stack([to_limbs(p) for p in pts + [pts[0]]])
    inf = np.array([False] * 5 + [True])
    k = 0xA
    rec_j = JSM.recode_signed_windows(k, 4, 4)
    rec_t = TSM.recode_signed_windows(k, 4, 4)
    assert (rec_t.idx == rec_j.idx).all() and (rec_t.sign == rec_j.sign).all()
    assert rec_t.correction == rec_j.correction is True
    want = JSM.windowed_scalar_mul(jops, (arr[:, 0], arr[:, 1]), rec_j.idx,
                                   rec_j.sign, rec_j.correction, w=4,
                                   inf=inf, unroll=True)
    got = TSM.windowed_scalar_mul(tops, (_t(arr[:, 0]), _t(arr[:, 1])),
                                  rec_t, inf=_b(inf))
    for g, j in zip(got, want):
        _same(g, j)
    x, y, is_inf = TSM.jac_to_affine(tops, got)
    assert affine(_np(x), _np(y), _np(is_inf)) == \
        [gt.ec_mul(p, k) for p in pts] + [None]


def test_g1_scalar_mul_full_width_matches_oracle():
    k = rng.randrange(1, gt.r)
    p = gt.ec_mul(gt.G1_GEN, rng.randrange(1, gt.r))
    arr = BJ.g1_to_limbs(p)
    x, y, inf = BT.g1_scalar_mul(_t(arr[0][None]), _t(arr[1][None]), k)
    assert _affine_g1(_np(x), _np(y), _np(inf)) == [gt.ec_mul(p, k)]


def test_g2_generator_matches_reference():
    assert (pgt.G2_GEN[0].c0, pgt.G2_GEN[0].c1, pgt.G2_GEN[1].c0, pgt.G2_GEN[1].c1) == \
        (gt.G2_GEN[0].c0, gt.G2_GEN[0].c1, gt.G2_GEN[1].c0, gt.G2_GEN[1].c1)
    assert pgt.g2_on_curve(pgt.G2_GEN)
    assert pgt.ec_mul(pgt.G2_GEN, pgt.r) is None


def test_scalar_bits_and_cost_model_match_reference():
    for k, width in [(0, 8), (1, 8), (0xA5, 8), (gt.r - 1, 256), (12345, 24),
                     (gt.G2_COFACTOR, gt.G2_COFACTOR.bit_length())]:
        got = TSM.scalar_bits(k, width)
        assert got.dtype == np.uint8 and not got.flags.writeable
        assert (got == JSM.scalar_bits(k, width)).all()
    with pytest.raises(ValueError):
        TSM.scalar_bits(256, 8)
    for nbits in (4, 24, 255, 256, gt.G2_COFACTOR.bit_length()):
        assert TSM.sequential_adds("double_add", nbits) == \
            JSM.sequential_adds("double_add", nbits) == nbits
        assert TSM.sequential_doubles("double_add", nbits) == \
            JSM.sequential_doubles("double_add", nbits)
        for w in range(1, 8):
            assert TSM.sequential_adds("window", nbits, w) == \
                JSM.sequential_adds("window", nbits, w)
            assert TSM.sequential_doubles("window", nbits, w) == \
                JSM.sequential_doubles("window", nbits, w)


def test_windowed_matches_double_and_add_at_a_short_scalar():
    """tests/test_scalar_mul.py's infinity case: a 24-bit scalar at w = 3
    over a batch of a finite point and a flagged infinity; the windowed
    multiply and the double-and-add oracle (jac_scalar_mul over
    scalar_bits) both give [k]P and keep O. The reference's own
    double-and-add is a fori_loop that compiles for about 18 s on the CPU,
    so it is held here through its bits and cost model, and in value
    through the bignum oracle."""
    nbits, w = 24, 3
    k = random.Random(24).randrange(1, 1 << nbits)
    p = gt.ec_mul(gt.G1_GEN, 5)
    arr = np.stack([BJ.g1_to_limbs(p), BJ.g1_to_limbs(p)])
    aff = (_t(arr[:, 0]), _t(arr[:, 1]))
    inf = _b([False, True])
    win = TSM.windowed_scalar_mul(BT.G1_OPS, aff, TSM.recode_signed_windows(k, nbits, w),
                                  inf=inf)
    da = TSM.jac_scalar_mul(BT.G1_OPS, aff, TSM.scalar_bits(k, nbits), inf=inf)
    for pt in (win, da):
        x, y, is_inf = TSM.jac_to_affine(BT.G1_OPS, pt)
        assert _affine_g1(_np(x), _np(y), _np(is_inf)) == [gt.ec_mul(p, k), None]


def test_recoding_matches_reference():
    for k, nbits in [(0, 8), (1, 8), (255, 8), (gt.r - 1, 256),
                     (gt.G2_COFACTOR, gt.G2_COFACTOR.bit_length())]:
        a, b = TSM.recode_signed_windows(k, nbits, 4), JSM.recode_signed_windows(k, nbits, 4)
        assert (a.idx == b.idx).all() and (a.sign == b.sign).all()
        assert a.correction == b.correction
    with pytest.raises(ValueError):
        TSM.recode_signed_windows(256, 8, 4)


def _g1_cases():
    base = gt.compress_g1(gt.ec_mul(gt.G1_GEN, 3))
    x, y = gt.ec_mul(gt.G1_GEN, 7)
    over_q = bytearray((gt.q + 1).to_bytes(48, "big"))
    over_q[0] |= 0x80
    x_off = next(v for v in range(2, 50) if pow(v ** 3 + 4, (gt.q - 1) // 2, gt.q) != 1)
    off_curve = bytearray(x_off.to_bytes(48, "big"))
    off_curve[0] |= 0x80
    corrupt = np.random.default_rng(0).integers(0, 256, (2, 48), dtype=np.uint8)
    return [
        base,
        gt.compress_g1((x, y)), gt.compress_g1((x, gt.q - y)),   # both signs
        gt.compress_g1(None),                                    # infinity
        bytes([base[0] & 0x7F]) + base[1:],                      # c_flag unset
        bytes([0xE0]) + b"\x00" * 47,                            # b with a set
        bytes([0xC0]) + b"\x00" * 46 + b"\x01",                  # b with x != 0
        bytes(over_q),                                           # x >= q
        bytes(off_curve),                                        # not on curve
        base[:-1] + bytes([base[-1] ^ 1]),                       # flipped bit
        corrupt[0].tobytes(), corrupt[1].tobytes(),
    ]


def _g2_cases():
    good = gt.compress_g2(gt.ec_mul(gt.G2_GEN, 5))
    x, y = gt.ec_mul(gt.G2_GEN, 9)
    probe = None
    for c0 in range(2, 60):                 # an x whose y^2 is a non-square
        cand = bytearray(96)
        cand[0] = 0x80
        cand[48:] = c0.to_bytes(48, "big")
        try:
            gt.decompress_g2(bytes(cand))
        except AssertionError:
            probe = bytes(cand)
            break
    real_y = []                              # y with zero imaginary part
    for b in range(1, 80):
        a2 = (b ** 3 - 4) * pow(3 * b, gt.q - 2, gt.q) % gt.q
        if pow(a2, (gt.q - 1) // 2, gt.q) != 1:
            continue
        xr = gt.Fq2(pow(a2, (gt.q + 1) // 4, gt.q), b)
        yr = gt.modular_squareroot(xr * xr * xr + gt.G2_B)
        if yr is None or yr.c1 != 0:
            continue
        for flag in (0, 1):
            z1 = (xr.c1 | (1 << 383) | (flag << 381)).to_bytes(48, "big")
            real_y.append(z1 + xr.c0.to_bytes(48, "big"))
        break
    assert probe is not None and real_y
    return [
        good,
        gt.compress_g2((x, y)), gt.compress_g2((x, -y)),         # both signs
        gt.compress_g2(None),                                    # infinity
        bytes([good[0] & 0x7F]) + good[1:],                      # c_flag unset
        bytes([0xE0]) + b"\x00" * 95,                            # inf with a_flag
        bytes([0xC0]) + b"\x00" * 46 + b"\x01" + b"\x00" * 48,   # inf, x1 != 0
        bytes([0xC0]) + b"\x00" * 47 + b"\x01" + b"\x00" * 47,   # inf, x2 != 0
        good[:48] + bytes([0x80]) + good[49:],                   # z2 flag bits
        probe,                                                   # off curve
    ] + real_y


def _oracle(decode, data):
    try:
        return decode(data)
    except AssertionError:
        return "invalid"


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_decompression_matches_jax_and_oracle(group, monkeypatch):
    """The traced decompression's limbs == the reference's on the parsed
    encodings (recorded from the one call the batch entry makes on them),
    and the batch entry's verdicts and points == the bignum oracle's."""
    if group == "g1":
        cases, parse, width = _g1_cases(), TD.parse_g1_bytes, 48
        decode, affine = gt.decompress_g1, _affine_g1
        name, j_traced = "_g1_decompress_traced", JD._g1_decompress_traced
        batch = TD.g1_decompress_batch
    else:
        cases, parse, width = _g2_cases(), TD.parse_g2_bytes, 96
        decode, affine = gt.decompress_g2, _affine_g2
        name, j_traced = "_g2_decompress_traced", JD._g2_decompress_traced
        batch = TD.g2_decompress_batch
    data = np.stack([np.frombuffer(c, np.uint8) for c in cases])
    assert data.shape[1] == width
    j_parse = JD.parse_g1_bytes if group == "g1" else JD.parse_g2_bytes
    for mine, ref in zip(parse(data), j_parse(data)):
        assert (mine == ref).all()
    x_raw, a_flag, _, _ = parse(data)
    calls = []
    t_traced = getattr(TD, name)

    def traced(x, flag):
        out = t_traced(x, flag)
        calls.append(((x, flag), out))
        return out

    monkeypatch.setattr(TD, name, traced)
    x, y, valid, inf = batch(data, "cpu")
    [((x_in, flag_in), got)] = calls
    assert (_np(x_in) == x_raw).all() and (flag_in.numpy() == a_flag).all()
    want = j_traced(x_raw, a_flag)
    for g, j in zip(got, want):
        _same(g, j)

    pts = affine(_np(x), _np(y), inf)
    verdicts = ["invalid" if not valid[k] else pts[k] for k in range(len(cases))]
    expected = [_oracle(decode, c) for c in cases]
    assert verdicts == expected
    assert expected[0] != "invalid" and expected[3] is None
    assert expected[1] != expected[2]
    # the port's own bignum copy decodes the same way
    mine = pgt.decompress_g1 if group == "g1" else pgt.decompress_g2
    as_tuple = ((lambda p: p) if group == "g1" else
                (lambda p: p if p in (None, "invalid") else
                 tuple((c.c0, c.c1) for c in p)))
    assert [as_tuple(_oracle(mine, c)) for c in cases] == \
        [as_tuple(e) for e in expected]
