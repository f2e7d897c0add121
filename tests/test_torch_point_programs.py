"""The final exponentiation and the decompressions' addition trees as
point programs (consensus_specs_tpu_torch/ops/fq_points.py:
final_exp_program, tree_program; the Recorder's Fq6, Fq12 and G1
vocabulary in ops/fq_program.py), whose kernels are csrc/fq_points.cu:
each program's plain run equals the port's tower and point loops limb
for limb, its recorded ops are the JAX package's functions' ops in order,
values equal the bignum oracle, and bls_torch routes CUDA tensors under
fq_tower.DEVICE to one launch of a program and never to the tower.

Values: points are multiples of the generators by seeded scalars; the
pairing groups cancel (e(P, Q) e(-P, Q), as tests/test_bls_jax.py's
grouped test builds them) or do not. Lazy limbs for the Recorder's methods
come from a seeded numpy generator. Tolerance zero: integer limbs compared
exactly, values compared exactly in the bignum field. The JAX package's
final_exponentiation_3x, _grouped_verdict and the trees' jac_add /
jac_to_affine run on the recorder, with jax and jax.numpy faked, so they
compile nothing and give the ops they ask for; its compiled pairing
programs would take minutes to build here, so values are held against the
bignum oracle instead."""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import bls12_381 as gt
from consensus_specs_tpu.ops import bls_jax as BJ
from consensus_specs_tpu.ops import fq_tower as JT
from consensus_specs_tpu.ops import scalar_mul as JSM
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.ops import bls_torch as BT
from consensus_specs_tpu_torch.ops import decompress as TD
from consensus_specs_tpu_torch.ops import fq as TF
from consensus_specs_tpu_torch.ops import fq_points as FPt
from consensus_specs_tpu_torch.ops import fq_program as FP
from consensus_specs_tpu_torch.ops import fq_tower as TT

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

rng = random.Random(0x15F)
L = TF.L


def _t(a):
    return convert.limbs_from_numpy(np.asarray(a), "cpu")


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def _lazy(nprng, shape):
    """Lazy limbs in [-16, 2^29] with a top limb in [0, 13]: inside the
    multiply budget, as the tower's tests draw them."""
    a = nprng.integers(-16, (1 << 29) + 1, shape + (L,))
    a[..., -1] = nprng.integers(0, 14, shape)
    return a


def _fq12(t, k):
    return JT.fq12_from_limbs(convert.limbs_to_numpy(t)[k])


# ---------------------------------------------------------------------------
# The final exponentiation's program == the tower == the oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def miller_values():
    """Miller values of two groups of two pairs through the Miller
    program's plain run (== the plain tower's loop,
    tests/test_torch_point_kernels.py): group 0 e(P, Q) e(-P, Q)
    (cancels), group 1 e(P, Q) e(P', Q')."""
    P, Q = gt.ec_mul(gt.G1_GEN, rng.randrange(1, gt.r)), gt.ec_mul(gt.G2_GEN, rng.randrange(1, gt.r))
    P2, Q2 = gt.ec_mul(gt.G1_GEN, rng.randrange(1, gt.r)), gt.ec_mul(gt.G2_GEN, rng.randrange(1, gt.r))
    g1 = _t(np.stack([np.stack([BT.g1_to_limbs(P), BT.g1_to_limbs(gt.ec_neg(P))]),
                      np.stack([BT.g1_to_limbs(P), BT.g1_to_limbs(P2)])]))
    g2 = _t(np.stack([np.stack([BT.g2_to_limbs(Q), BT.g2_to_limbs(Q)]),
                      np.stack([BT.g2_to_limbs(Q), BT.g2_to_limbs(Q2)])]))
    return g1, g2, FPt.miller_grouped_plain(g1, g2), [(P, Q), (P2, Q2)]


def test_final_exp_program_matches_tower_and_oracle(miller_values):
    """final_exp_program's plain run == final_exponentiation_3x and
    _grouped_verdict over the plain tower, limb for limb: the verdicts
    True for the cancelling group, False for the other; group 1's power
    == the bignum pairing product (one final exponentiation of the two
    Miller values' product), cubed."""
    g1, g2, f, ((P, Q), (P2, Q2)) = miller_values
    got, ok = FPt.final_exp_plain(f)
    want = BT.final_exponentiation_3x(f, TT.PLAIN)
    _same((got,), (want,))
    assert ok.tolist() == BT._grouped_verdict(f, TT.PLAIN).tolist() == [True, False]
    f1 = (gt.miller_loop(gt.untwist(Q), gt.embed_g1(P))
          * gt.miller_loop(gt.untwist(Q2), gt.embed_g1(P2)))
    assert _fq12(got, 1) == gt.final_exponentiation(f1) ** 3


# ---------------------------------------------------------------------------
# Each Recorder method == its Tower twin
# ---------------------------------------------------------------------------

def _fq6(rec, rows):
    return tuple(FP.V2(rec, rows[2 * i], rows[2 * i + 1]) for i in range(3))


def _rows6(c):
    return [r for v in c for r in v.r]


# method: (rows of each input, recorded body, the tower's function of the
# inputs as [n, rows, 14] tensors)
METHODS = {
    "fq2_mul_xi": ((2,), lambda rec, a: list(rec.fq2_mul_xi(FP.V2(rec, *a)).r),
                   lambda a: TT.fq2_mul_xi(a)),
    "fq6_mul": ((6, 6), lambda rec, a, b: _rows6(rec.fq6_mul(_fq6(rec, a), _fq6(rec, b))),
                lambda a, b: TT.PLAIN.fq6_mul(a.reshape(-1, 3, 2, L), b.reshape(-1, 3, 2, L))),
    "fq6_mul_by_v": ((6,), lambda rec, a: _rows6(rec.fq6_mul_by_v(_fq6(rec, a))),
                     lambda a: TT.fq6_mul_by_v(a.reshape(-1, 3, 2, L))),
    "fq6_inv": ((6,), lambda rec, a: _rows6(rec.fq6_inv(_fq6(rec, a))),
                lambda a: TT.PLAIN.fq6_inv(a.reshape(-1, 3, 2, L))),
    "fq12_mul": ((12, 12), lambda rec, a, b: rec.fq12_mul(a, b),
                 lambda a, b: TT.PLAIN.fq12_mul(a.reshape(-1, 2, 3, 2, L),
                                                b.reshape(-1, 2, 3, 2, L))),
    "fq12_cyclo_sqr": ((12,), lambda rec, a: rec.fq12_cyclo_sqr(a),
                       lambda a: TT.PLAIN.fq12_cyclo_sqr(a.reshape(-1, 2, 3, 2, L))),
    "fq12_inv": ((12,), lambda rec, a: rec.fq12_inv(a),
                 lambda a: TT.PLAIN.fq12_inv(a.reshape(-1, 2, 3, 2, L))),
    "fq12_conj": ((12,), lambda rec, a: rec.fq12_conj(a),
                  lambda a: TT.PLAIN.fq12_conj(a.reshape(-1, 2, 3, 2, L))),
    **{f"fq12_frobenius {k}": ((12,), lambda rec, a, k=k: rec.fq12_frobenius(a, k),
                               lambda a, k=k: TT.PLAIN.fq12_frobenius(
                                   a.reshape(-1, 2, 3, 2, L), k)) for k in (1, 2, 3)},
    "fq12_pow_abs": ((12,), lambda rec, a: rec.fq12_pow_abs(a, np.array([1, 0, 1, 1, 0])),
                     lambda a: TT.PLAIN.fq12_pow_abs(a.reshape(-1, 2, 3, 2, L),
                                                     np.array([1, 0, 1, 1, 0]))),
}


def test_recorder_methods_match_their_tower_twins():
    """Each method of METHODS recorded into a program of its own and run
    through run_program_plain == the plain tower's method, limb for limb,
    on three lanes of lazy limbs. (One test over the methods: the suite's
    size sets pytest-xdist's first chunks, ROADMAP.md's test budget.)"""
    nprng = np.random.default_rng(150)
    for name, (shapes, body, tower) in METHODS.items():
        rec = FP.Recorder()
        ins = [rec.input_rows(0, n) for n in shapes]
        prog = rec.compile(body(rec, *ins))
        args = [_t(_lazy(nprng, (3, n))) for n in shapes]
        got, _ = FP.run_program_plain(prog, torch.cat(args, dim=1))
        want = tower(*args).reshape(3, -1, L)
        assert got.shape == want.shape and torch.equal(got, want), name


def test_fq12_eq_records_one_flag():
    """Recorder.fq12_eq == Tower.fq12_eq: True for equal values in other
    limbs (a + q on a row), False where one row differs."""
    nprng = np.random.default_rng(151)
    rec = FP.Recorder()
    a, b = rec.input_rows(0, 12), rec.input_rows(0, 12)
    prog = rec.compile([], rec.fq12_eq(a, b).v)
    x = _lazy(nprng, (3, 12))
    y = x.copy()
    y[0, 4] += TF.Q_LIMBS                        # the same value
    y[2, 7, 0] += 1                              # another value
    xs, ys = _t(x), _t(y)
    _, flag = FP.run_program_plain(prog, torch.cat([xs, ys], dim=1))
    want = TT.PLAIN.fq12_eq(xs.reshape(3, 2, 3, 2, L), ys.reshape(3, 2, 3, 2, L))
    assert flag.tolist() == want.tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# The trees' programs == bls_torch's loops == the oracle
# ---------------------------------------------------------------------------

def _g1_group(members, inf_at=()):
    enc = np.stack([np.frombuffer(gt.compress_g1(p), np.uint8) for p in members])
    xr, af, inf, wf = TD.parse_g1_bytes(enc)
    inf = inf.copy()
    inf[list(inf_at)] = True
    return xr, af, inf


def test_g1_tree_programs_match_the_loop_and_oracle():
    """Two committees of 16 pubkeys (members 2 and 3 equal: the doubling
    branch; member 5 the negation of member 4: the infinity branch;
    infinity members, the whole of one half in the second row): the
    programs' plain run (point_tree_plain: 3 levels, then 1 level and
    jac_to_affine) == _g1_decompress_aggregate_grouped's loop, limb for
    limb, and each row's sum == the bignum sum."""
    base = [gt.ec_mul(gt.G1_GEN, rng.randrange(1, gt.r)) for _ in range(6)]
    members = [base[j % 6] for j in range(16)]
    members[3], members[5] = members[2], gt.ec_neg(members[4])
    rows = [_g1_group(members, (9,)), _g1_group(members, range(8))]
    xr, af, inf = (torch.from_numpy(np.stack([r[k] for r in rows])) for k in range(3))
    want = BT._g1_decompress_aggregate_grouped(xr, af, inf)
    x, y, _ = TD._g1_decompress_traced(xr, af)
    cur = BT._jacobian_or_infinity(TF.fq_select, x, y, inf, TF.const(TF._ONE_MONT, x.device))
    got = FPt.point_tree_plain("g1", torch.stack(cur, dim=-2))
    _same(got, want[:3])
    assert FPt.tree_plan(4) == [(3, False), (1, True)]
    for k, row in enumerate(rows):
        acc = None
        for m, i in zip(members, row[2]):
            acc = acc if i else gt.ec_add(acc, m)
        xs, ys = convert.limbs_to_numpy(got[0])[k], convert.limbs_to_numpy(got[1])[k]
        assert (TF.from_mont(xs), TF.from_mont(ys)) == acc


@pytest.fixture(scope="module")
def g2_signatures():
    """Four signature points, their parsed encodings and their plain
    decompression (x, y, valid), made once."""
    pts = [gt.ec_mul(gt.G2_GEN, rng.randrange(1, gt.r)) for _ in range(4)]
    enc = np.stack([np.frombuffer(gt.compress_g2(p), np.uint8) for p in pts])
    xr, af, inf, _ = TD.parse_g2_bytes(enc)
    xr, af = torch.from_numpy(xr), torch.from_numpy(af)
    return pts, xr, af, inf, TD._g2_decompress_traced(xr, af)


@pytest.mark.parametrize("n", [1, 4])
def test_g2_tree_programs_match_the_loop(n, g2_signatures, monkeypatch):
    """aggregate_signatures' tree over n signatures, one infinity member
    at n = 4: the programs' plain run == _g2_decompress_aggregate's loop,
    and the sum == the bignum sum (n = 1: jac_to_affine alone). The
    decompression (its own route, held by the decompression's tests) is
    made once and handed to the loop."""
    pts, xr, af, inf, (x, y, valid) = g2_signatures
    pts, inf = pts[:n], inf[:n].copy()
    if n > 1:
        inf[1] = True
    x, y, valid = x[:n], y[:n], valid[:n]
    monkeypatch.setattr(TD, "_g2_decompress_traced", lambda a, b: (x, y, valid))
    inf_t = torch.from_numpy(inf)
    want = BT._g2_decompress_aggregate(xr[:n], af[:n], inf_t)
    cur = BT._jacobian_or_infinity(TT.fq2_select, x, y, inf_t,
                                   TF.const(TT._FQ2_ONE_NP, x.device))
    got = FPt.point_tree_plain("g2", torch.stack(cur, dim=-3)[None])
    _same([g[0] for g in got], want[:3])
    acc = None
    for p, i in zip(pts, inf):
        acc = acc if i else gt.ec_add(acc, p)
    xs, ys = convert.limbs_to_numpy(got[0])[0], convert.limbs_to_numpy(got[1])[0]
    assert (JT.fq2_from_limbs(xs), JT.fq2_from_limbs(ys)) == acc


# ---------------------------------------------------------------------------
# The recorded ops are the JAX package's, in order
# ---------------------------------------------------------------------------

def _fake_jax():
    def fori_loop(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(i, carry)
        return carry

    return SimpleNamespace(lax=SimpleNamespace(fori_loop=fori_loop))


class _Rows(list):
    """A group's 12 symbolic rows where the reference reads f.shape[0]."""
    shape = (1,)


def test_final_exp_ops_are_the_references(monkeypatch):
    """The reference's _grouped_verdict (final_exponentiation_3x with its
    _pow_abs runs, then fq12_eq with one), its tower module the recorder
    and jax faked, records the same ops in the same order as the port's
    final_exp_recording."""
    want = FP.Recorder()
    res, ok = FPt.final_exp_recording(want, want.input_rows(0, 12))
    rec = FP.Recorder()
    f = _Rows(rec.input_rows(0, 12))
    monkeypatch.setattr(BJ, "T", rec)
    monkeypatch.setattr(BJ, "jax", _fake_jax())
    monkeypatch.setattr(BJ, "jnp", np)
    BJ._grouped_verdict(f)
    assert rec.ops == want.ops and len(rec.ops) > 4000
    assert rec.calls.count("fq12_cyclo_sqr") == 316 and want.calls.count("fq12_pow_abs") == 5


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_tree_ops_are_the_references(curve):
    """The reference's jac_add over 8 points level by level and its
    jac_to_affine, on the recorder's G1 or G2 namespace, record the same
    ops as the port's tree_recording(curve, 3, affine=True)."""
    want, _, _ = FPt.tree_recording(curve, 3, True)
    rec = FP.Recorder()
    fo, pts = FPt.tree_inputs(rec, curve, 8)
    while len(pts) > 1:
        pts = [JSM.jac_add(fo, pts[i], pts[i + 1]) for i in range(0, len(pts), 2)]
    JSM.jac_to_affine(fo, pts[0])
    assert rec.ops == want.ops


# ---------------------------------------------------------------------------
# Routing, caching, shapes
# ---------------------------------------------------------------------------

class _CudaLike(torch.Tensor):
    """A CPU tensor that reads as a CUDA one: what the routing sees."""

    @property
    def is_cuda(self):
        return True


def test_cuda_tensors_take_one_program_launch(monkeypatch, miller_values):
    """For CUDA tensors under DEVICE: final_exponentiation_3x and
    _grouped_verdict make one launch of final_exp_program each (on
    FINAL_EXP_MODE's kernel), grouped_pairing_check the Miller launch and
    that one, the G1 tree of 2 x 16 points two launches (3 levels, then
    1 level and jac_to_affine) and the G2 tree of 4 one; no tower product,
    Fq multiply or chain runs. The stubbed launcher runs each program's
    plain twin, so the results equal the plain route's. PLAIN keeps the
    tower."""
    g1, g2, f, _ = miller_values
    want, want_ok = FPt.final_exp_plain(f)
    fe = FPt.final_exp_program()
    calls = []
    runs = {(id(fe), f.data_ptr()): (want.reshape(2, 12, L), want_ok)}   # made once

    def launch(name, prog, dev, n, ins, out_flags=None, **kwargs):
        calls.append((name, prog, n))
        key = (id(prog), ins[0].data_ptr())
        if key not in runs:
            runs[key] = FP.run_program_plain(prog, *[t.as_subclass(torch.Tensor) for t in ins])
        out, flag = runs[key]
        if out_flags is not None:
            out_flags.copy_(flag)
        return out.clone()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the tower or a per-product route")

    monkeypatch.setattr(FPt, "_launch", launch)
    monkeypatch.setattr(FPt, "_operand", lambda t, dev, what: t)
    monkeypatch.setattr(FPt, "_sms", lambda dev: 132)
    for name in ("fq12_inv", "fq12_mul", "fq12_frobenius", "fq12_pow_abs", "fq12_cyclo_sqr",
                 "fq12_eq"):
        monkeypatch.setattr(TT.Tower, name, refuse)
    for name in ("fq_mul_plain", "fq_bilinear_plain", "fq_bilinear_chain_plain"):
        monkeypatch.setattr(TF, name, refuse)
    fc = f.as_subclass(_CudaLike)
    _same((BT.final_exponentiation_3x(fc).as_subclass(torch.Tensor),), (want,))
    assert BT._grouped_verdict(fc).tolist() == want_ok.tolist() == [True, False]
    assert calls == [(FPt.ENTRY[FPt.FINAL_EXP_MODE], fe, 2)] * 2
    del calls[:]
    monkeypatch.setattr(FPt, "miller_grouped_cuda", lambda a, b: f.as_subclass(_CudaLike))
    assert BT.grouped_pairing_check(g1.as_subclass(_CudaLike), g2).tolist() == [True, False]
    assert calls == [(FPt.ENTRY[FPt.FINAL_EXP_MODE], fe, 2)]
    del calls[:]
    pts = torch.from_numpy(_lazy(np.random.default_rng(152), (2, 16, 3)))
    got = FPt.point_tree_cuda("g1", pts.as_subclass(_CudaLike))
    _same([g.as_subclass(torch.Tensor) for g in got], FPt.point_tree_plain("g1", pts))
    assert calls == [("g2_ladder", FPt.tree_program("g1", 3, False), 4),
                     ("g2_ladder", FPt.tree_program("g1", 1, True), 2)]
    del calls[:]
    pts2 = torch.from_numpy(_lazy(np.random.default_rng(153), (1, 4, 3, 2)))
    FPt.point_tree_cuda("g2", pts2.as_subclass(_CudaLike))
    assert calls == [("g2_ladder", FPt.tree_program("g2", 2, True), 1)]
    assert FPt.tree_mode(8 * 132, "cuda") == "groups"
    assert FPt.tree_mode(8 * 132 + 1, "cuda") == "threads"


def test_programs_are_cached_fit_a_block_and_refuse_bad_input():
    """Each program is built once; its lane's register file, scratch and
    flags with the ring fit a block's shared memory at one lane; the
    wrappers refuse CPU tensors (no fallback) and malformed shapes."""
    fe = FPt.final_exp_program()
    assert FPt.final_exp_program() is fe and FPt.tree_program("g1", 3, False) is \
        FPt.tree_program("g1", 3, False)
    for prog in (fe, FPt.tree_program("g1", 3, False), FPt.tree_program("g2", 3, True)):
        _, threads, nbytes, _ = FPt.launch_shape(prog, 1)
        assert nbytes <= 227 * 1024 and threads <= 288
    assert fe.in_rows == (12, 0) and fe.out_rows == 12 and fe.out_flag >= 0
    d = fe.describe()
    assert d["bundles"] < 1000 and d["muls"] > 489 and d["products"] > 300
    with pytest.raises(ValueError, match="expected a tensor on"):
        FPt.final_exp_cuda(torch.zeros((1, 2, 3, 2, L), dtype=torch.int64))
    with pytest.raises(ValueError, match="power of two"):
        FPt.point_tree_plain("g1", torch.zeros((1, 3, 3, L), dtype=torch.int64))
    with pytest.raises(ValueError, match="points"):
        FPt.point_tree_plain("g2", torch.zeros((1, 4, 3, L), dtype=torch.int64))
    assert FPt.tree_plan(0) == [(0, True)] and FPt.tree_plan(10) == [
        (3, False), (3, False), (3, False), (1, True)]
