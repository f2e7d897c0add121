"""The point programs of the G2 ladder and the grouped Miller loop
(consensus_specs_tpu_torch/ops/fq_program.py, ops/fq_points.py), whose
kernels are csrc/fq_points.cu: each program's plain run equals the port's
Python loop bit for bit, its recorded ops are the JAX package's loops'
ops in order, its packed bundle records decode to the compiled ops and run
them in an order where every read finds its value (the final
exponentiation's and a tree's records too: runs of single multiplies,
norms folded into the REDCs), and bls_torch routes to the kernels only for
CUDA tensors under fq_tower.DEVICE.

Values: points are multiples of the generators by seeded scalars, and
hash-to-G2 candidates; the ladder's special cases use a point of order 13
on the twist (13 divides the G2 cofactor), where an 8-bit scalar reaches
jac_add's doubling branch (the correction add of -T to -T) and its
infinity branch (13 T). Tolerance zero: integer limbs compared exactly,
values compared exactly in the bignum field. The JAX package runs its
windowed walk eagerly and unrolled at tests/test_torch_curve.py's 4-bit
scalar and batch of 6; its loops are otherwise recorded, not run: a
namespace stands where they take a field or tower module, so they compile
nothing and give the ops they ask for."""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls_jax as BJ
from consensus_specs_tpu.ops import scalar_mul as JSM
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls12_381 as gt
from consensus_specs_tpu_torch.ops import _nvcc
from consensus_specs_tpu_torch.ops import bls_torch as BT
from consensus_specs_tpu_torch.ops import fq_points as FPt
from consensus_specs_tpu_torch.ops import fq_program as FP
from consensus_specs_tpu_torch.ops import fq_tower as TT
from consensus_specs_tpu_torch.ops import scalar_mul as TSM

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

rng = random.Random(0x12A)
PLAIN_G2 = BT.g2_ops(TT.PLAIN)


def _t(a):
    return convert.limbs_from_numpy(np.asarray(a), "cpu")


def _affine(x, y, inf):
    x, y, inf = (convert.limbs_to_numpy(v) for v in (x, y, inf))
    return [None if inf[k] else (TT.fq2_from_limbs(x[k]), TT.fq2_from_limbs(y[k]))
            for k in range(len(inf))]


def _loop(x, y, inf, rec):
    """The port's windowed loop and jac_to_affine over the plain tower."""
    return TSM.jac_to_affine(PLAIN_G2, TSM.windowed_scalar_mul(
        PLAIN_G2, (x, y), rec, inf=inf))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _ladder_case(points, k, nbits, inf=None):
    """(program's plain run, the port's loop) at one scalar."""
    arr = np.stack([BT.g2_to_limbs(p) for p in points])
    x, y = _t(arr[:, 0]), _t(arr[:, 1])
    rec = TSM.recode_signed_windows(k, nbits, BT.SCALAR_WINDOW)
    return FPt.g2_ladder_plain(x, y, inf, rec), _loop(x, y, inf, rec)


# ---------------------------------------------------------------------------
# The ladder program == the port's loop == the JAX package == the oracle
# ---------------------------------------------------------------------------

class _FakeJnp:
    """What the reference's unrolled windowed walk asks of jax.numpy when
    its field namespace is the recorder: the table as lists, the gather a
    load by digit."""

    def __init__(self, fo):
        self.fo = fo

    @staticmethod
    def stack(values):
        return list(values)

    def take(self, values, digit, axis=0):
        return self.fo.take(values, digit)

    @staticmethod
    def asarray(x):
        return x


def test_ladder_program_at_4_bits_matches_loop_jax_and_oracle():
    """k = 0xA over 4 bits (table build, one window, the correction add)
    on 5 points and one lane flagged infinity: the program's plain run ==
    the port's loop == the reference's unrolled walk (Jacobian, eager), and
    the affine values == the oracle's."""
    pts = [gt.ec_mul(gt.G2_GEN, rng.randrange(1, gt.r)) for _ in range(5)]
    arr = np.stack([BT.g2_to_limbs(p) for p in pts + [pts[0]]])
    inf = np.array([False] * 5 + [True])
    k = 0xA
    rec = TSM.recode_signed_windows(k, 4, 4)
    x, y, tinf = _t(arr[:, 0]), _t(arr[:, 1]), torch.from_numpy(inf)
    got = FPt.g2_ladder_plain(x, y, tinf, rec)
    _same(got, _loop(x, y, tinf, rec))
    assert _affine(*got) == [gt.ec_mul(p, k) for p in pts] + [None]

    # the Jacobian result of the same recording against the reference's walk
    recorder, acc, _ = FPt.ladder_recording(4, 4)
    jac_prog = recorder.compile([r for c in acc for r in c.r])
    jac, _ = FP.run_program_plain(jac_prog, torch.cat([x, y], dim=1), lane_flag=tinf,
                                  uniform_flag=rec.correction,
                                  digits=(np.asarray(rec.idx), np.asarray(rec.sign)))
    want = JSM.windowed_scalar_mul(BJ.G2_OPS, (arr[:, 0], arr[:, 1]), rec.idx, rec.sign,
                                   rec.correction, w=4, inf=inf, unroll=True)
    assert (convert.limbs_to_numpy(jac) ==
            np.stack([np.asarray(c) for c in want], axis=1).reshape(6, 6, 14)).all()


def test_ladder_program_cofactor_two_lanes():
    """The cofactor multiply of hash-to-G2 (~507 bits) on two candidates:
    the program == the port's loop limb for limb, == gt.hash_to_g2."""
    msgs = [(bytes([7]) * 32, 1), (bytes(range(32)), 3)]
    cands = [gt.hash_to_g2_candidate(m, d) for m, d in msgs]
    got, want = _ladder_case(cands, gt.G2_COFACTOR, BT._G2_COFACTOR_NBITS)
    _same(got, want)
    assert _affine(*got) == [gt.hash_to_g2(m, d) for m, d in msgs]


def test_ladder_program_256_bits_and_the_doubling_branch():
    """k = r - 2, 256 bits, even: the walk ends at (r - 1) P = -P and the
    correction adds -P to it, jac_add's doubling branch. Two lanes: the
    program == the port's loop, == the oracle's -2P."""
    pts = [gt.ec_mul(gt.G2_GEN, rng.randrange(1, gt.r)) for _ in range(2)]
    k = gt.r - 2
    got, want = _ladder_case(pts, k, 256)
    _same(got, want)
    assert _affine(*got) == [gt.ec_mul(p, k) for p in pts]


@pytest.fixture(scope="module")
def order13():
    """A point of order 13 on the twist (h r points, 13^2 | h): m Q for a
    hash candidate Q, m = h r / 13^2, times 13 where that has order 169."""
    m = gt.G2_COFACTOR * gt.r // 169
    for n in range(64):
        t = gt.ec_mul(gt.hash_to_g2_candidate(bytes([n]) * 32, 1), m)
        if t is not None and gt.ec_mul(t, 13) is not None:
            t = gt.ec_mul(t, 13)
        if t is not None:
            assert gt.ec_mul(t, 13) is None
            return t
    raise AssertionError("no point of order 13")


@pytest.mark.parametrize("k", [13, 24, 89])
def test_ladder_program_branches_on_a_small_order_point(k, order13):
    """Over 8 bits on T of order 13 and a generator multiple: k = 13 ends
    in jac_add's infinity branch (13 T = O), k = 24 in its doubling branch
    (the correction adds -T to 25 T = -T); the program == the port's loop,
    == the oracle."""
    pts = [order13, gt.ec_mul(gt.G2_GEN, 5)]
    got, want = _ladder_case(pts, k, 8)
    _same(got, want)
    assert _affine(*got) == [gt.ec_mul(p, k) for p in pts]
    assert (_affine(*got)[0] is None) == (k % 13 == 0)


# ---------------------------------------------------------------------------
# The Miller program == miller_loop_grouped
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 3])
def test_miller_program_matches_the_loop(P):
    """One group of P pairs: the program's plain run == the port's
    miller_loop_grouped over the plain tower, limb for limb."""
    g1 = np.stack([BT.g1_to_limbs(gt.ec_mul(gt.G1_GEN, rng.randrange(1, gt.r)))
                   for _ in range(P)])[None]
    g2 = np.stack([BT.g2_to_limbs(gt.ec_mul(gt.G2_GEN, rng.randrange(1, gt.r)))
                   for _ in range(P)])[None]
    g1, g2 = _t(g1), _t(g2)
    got = FPt.miller_grouped_plain(g1, g2)
    assert got.shape == (1, 2, 3, 2, 14)
    assert torch.equal(got, BT.miller_loop_grouped(g1, g2, TT.PLAIN))


# ---------------------------------------------------------------------------
# The recorded ops are the JAX package's, in order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [4, 9])
def test_ladder_ops_are_the_references(nbits, monkeypatch):
    """The reference's windowed_scalar_mul (unrolled) and jac_to_affine,
    run on the recorder with its jax.numpy replaced, record the same ops,
    in the same order, as the port's ladder_recording."""
    want, _, _ = FPt.ladder_recording(nbits, 4)
    rec = FP.Recorder()
    fo = FP.FieldOps(rec)
    monkeypatch.setattr(JSM, "jnp", _FakeJnp(fo))
    aff, inf, corr, digits = FPt.ladder_inputs(rec, nbits, 4)
    acc = JSM.windowed_scalar_mul(fo, aff, digits, digits, corr, w=4, inf=inf,
                                  unroll=True)
    JSM.jac_to_affine(fo, acc)
    assert rec.ops == want.ops and len(rec.ops) > 1000
    assert [v for v, _ in rec.const_rows] == [v for v, _ in want.const_rows]


def _fake_jax():
    def fori_loop(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(i, carry)
        return carry

    def cond(pred, true_fn, false_fn, carry):
        return true_fn(carry) if bool(pred) else false_fn(carry)

    return SimpleNamespace(lax=SimpleNamespace(fori_loop=fori_loop, cond=cond))


class _Coords:
    """g1_aff / g2_aff of one pair: [..., c, :] (and [..., c, :, :]) give
    the recorder's coordinate values."""

    def __init__(self, *coords):
        self.coords = coords

    def __getitem__(self, key):
        return self.coords[key[1]]


def test_miller_ops_are_the_references(monkeypatch):
    """The reference's miller_loop_grouped at P = 1, its tower module the
    recorder (and jax, jax.numpy faked), records the same ops in the same
    order as the port's miller_recording: per bit the doubling lines and
    the f-update (squaring, line multiply), on a set bit the addition
    lines and their line multiply, then the conjugation."""
    want, f_want = FPt.miller_recording(1)
    rec = FP.Recorder()
    (xp, yp, xq, yq), = FPt.miller_inputs(rec, 1)
    monkeypatch.setattr(BJ, "T", rec)
    monkeypatch.setattr(BJ, "jax", _fake_jax())
    monkeypatch.setattr(BJ, "jnp", np)
    f = BJ.miller_loop_grouped(_Coords(xp, yp), _Coords(xq, yq))
    assert rec.ops == want.ops and f == f_want
    assert rec.calls.count("fq12_sqr") == 63 and rec.calls.count("fq12_mul_line") == 68


def test_programs_are_built_once_and_fit_a_block():
    """One program per (nbits, w) and per P, whatever the scalar; a
    lane's register file, scratch and flags, with the block's record ring,
    fit one block's shared memory; the compiled program holds every
    recorded live op once."""
    prog = FPt.ladder_program(256, 4)
    assert FPt.ladder_program(256, 4) is prog and FPt.miller_program(3) is FPt.miller_program(3)
    for p in (prog, FPt.ladder_program(BT._G2_COFACTOR_NBITS, 4), FPt.miller_program(2),
              FPt.miller_program(3)):
        per_lane = 8 * (p.nreg * 14 + 2 * p.nx * 14 + p.ng * 30) + 4 * p.nflag
        tile, threads, nbytes, ring = FPt.launch_shape(p, 1)
        assert tile == 1 and 64 <= threads <= 512 and per_lane < nbytes < 96 * 1024
        assert ring == 4 * FP.RING * p.slot_words
        assert p.code.dtype == np.int32 and p.bundles.sum() == p.n_ops
        assert p.threads_lane >= 1 and p.product_bundles <= p.n_bundles
    assert prog.n_digits == TSM.n_windows(256, 4) and prog.out_rows == 4
    assert FPt.miller_program(3).in_rows == (6, 12)


def _folded_norms(prog):
    """{bundle: registers of the phase-E norms its REDCs run}, read from
    the records' fold tables (a run record stands for its bundles)."""
    code, at, b, out = prog.code, prog.offsets["records"], 0, {}
    for _ in range(prog.n_records):
        head = code[at:at + FP.HDR]
        if head[FP.REC_RUN]:
            b += int(head[2])
        else:
            if head[FP.REC_FOLD_TAB]:
                tab = code[at + head[FP.REC_FOLD_TAB]:at + head[FP.REC_FOLD_TAB] + head[6]]
                out[b] = [int(x) - 1 for x in tab if x]
            b += 1
        at += int(head[FP.REC_WORDS])
    assert b == prog.n_bundles
    return out


def _walk_records(prog):
    """Decode the packed records and walk them in the kernel's phase order
    (A: linear ops and pre-sums read, linear ops write; B: multiplies
    read; D: is_zero's patterns read, products write; E, E2, E3: linear
    ops read and write; a run's bundles one after another), checking that
    decoding
    gives back the compiled op list, that each read finds the value the
    compiled op reads (so it was written in an earlier phase or bundle and
    not overwritten since), that no phase writes a register it reads or
    writes one twice, that a norm the kernel runs in phase D (folded)
    overwrites no value that phase D or E of its bundle still reads, and
    that the outputs end where the program says."""
    folded = _folded_norms(prog)
    decoded = FP.decode(prog)
    assert len(decoded) == prog.n_bundles
    kind, reg = prog.vkind, prog.reg
    holds = {(kind[v], reg[v]): v for v in prog.staged}
    members = {}
    for i, (b, ph) in enumerate(zip(prog.op_bundle, prog.op_phase)):
        members.setdefault((b, ph), []).append(i)

    def mapped(i):
        name, dsts, srcs, aux = prog.ops[i]
        return (name, tuple(reg[v] for v in dsts), tuple(reg[v] for v in srcs),
                aux if name in ("load", "sgn", "bil") else None)

    for b, rec in enumerate(decoded):
        ops = {ph: members.get((b, ph), []) for ph in ("A", "M", "P", "E", "E2", "E3")}
        for ph in ops:
            assert rec[ph] == [mapped(i) for i in ops[ph]], (b, ph)
        leaves, wide = rec["leaf_rows"], rec["wide_rows"]
        assert len(set(leaves)) == len(leaves) and max(leaves + [-1]) < prog.nx
        assert len(set(wide)) == len(wide) and max(wide + [-1]) < prog.ng
        isz = [i for i in ops["M"] if prog.ops[i][0] == "isz"]
        late = {v for i in isz for v in prog.ops[i][2][2:]} | {
            v for ph in ("E", "E2", "E3") for i in ops[ph] for v in prog.ops[i][2]}
        for r in folded.get(b, []):
            assert holds.get(("r", r)) not in late, (b, r)
        phases = (
            ([(i, s) for i in ops["A"] + ops["P"] for s in prog.ops[i][2]], ops["A"]),
            ([(i, s) for i in ops["M"] for s in prog.ops[i][2][:2]], []),
            ([(i, s) for i in isz for s in prog.ops[i][2][2:]], ops["M"] + ops["P"]),
            ([(i, s) for i in ops["E"] for s in prog.ops[i][2]], ops["E"]),
            ([(i, s) for i in ops["E2"] for s in prog.ops[i][2]], ops["E2"]),
            ([(i, s) for i in ops["E3"] for s in prog.ops[i][2]], ops["E3"]))
        for reads, writers in phases:
            read_keys = set()
            for i, v in reads:
                key = (kind[v], reg[v])
                assert holds.get(key) == v, (b, prog.ops[i][0], v)
                read_keys.add(key)
            written = [(kind[d], reg[d]) for i in writers for d in prog.ops[i][1]]
            assert len(set(written)) == len(written) and not read_keys & set(written), b
            for i in writers:
                for d in prog.ops[i][1]:
                    holds[(kind[d], reg[d])] = d
    code, off = prog.code, prog.offsets
    outs = code[off["out"]:off["out"] + prog.out_rows]
    assert [holds[("r", int(r))] for r in outs] == prog.roots[:prog.out_rows]
    if prog.out_flag >= 0:
        assert holds[("f", prog.out_flag)] == prog.roots[-1]


@pytest.mark.parametrize("which", ["ladder 509", "ladder 256", "miller 2", "miller 3",
                                   "final_exp 0", "tree 3"])
def test_packed_records_hold_the_schedule(which):
    """The packed records of the programs of the main path (the ladders,
    the Miller loops, the final exponentiation with its norms folded into
    the REDCs and its inversion's runs, a G2 tree launch with
    jac_to_affine) decode to the compiled ops and run them in an order
    where every operand is written before it is read and no register is
    overwritten while a later reader needs it (_walk_records). The ladder
    folds its linear ops into the bundles of the products that feed them,
    up to three deep (phases E, E2, E3): 3,352 bundles at 509 bits and
    3,330 at the cofactor's width, against 4,651 and 4,619 with phase E
    alone and 8,819 and 8,755 before phase E."""
    what, n = which.split()
    prog = {"ladder": lambda: FPt.ladder_program(int(n), 4),
            "miller": lambda: FPt.miller_program(int(n)),
            "final_exp": FPt.final_exp_program,
            "tree": lambda: FPt.tree_program("g2", int(n), True)}[what]()
    _walk_records(prog)
    if what in ("final_exp", "tree"):
        assert prog.records[:, 4].sum() > 400 and prog.n_records < prog.n_bundles
    if what == "final_exp":
        assert prog.n_folded == 3762 and _folded_norms(prog)
    if which == "ladder 509":
        assert prog.n_bundles == 3352 < 4651
        assert FPt.ladder_program(BT._G2_COFACTOR_NBITS, 4).n_bundles == 3330 < 4619


# ---------------------------------------------------------------------------
# Routing, refusal, work and bound
# ---------------------------------------------------------------------------

class _Sentinel(Exception):
    pass


class _CudaLike:
    """Stands for a CUDA tensor in a routing decision."""

    is_cuda = True
    shape = (1, 2, 14)
    device = torch.device("cpu")

    def reshape(self, *shape):
        return self

    def __getitem__(self, key):
        return self


def test_routes_and_refuses(monkeypatch):
    """CUDA tensors under fq_tower.DEVICE go to the kernels and raise when
    the kernel does not build (nothing falls back); CPU tensors and the
    PLAIN tower take the Python loops; the wrappers refuse CPU tensors;
    without nvcc the build raises KernelCompileError."""
    def refused(*args, **kwargs):
        raise _nvcc.KernelCompileError("no nvcc")

    monkeypatch.setattr(FPt, "g2_ladder_cuda", refused)
    monkeypatch.setattr(FPt, "miller_grouped_cuda", refused)
    cuda = _CudaLike()
    with pytest.raises(_nvcc.KernelCompileError):
        BT.g2_scalar_mul(cuda, cuda, 5, nbits=4)
    with pytest.raises(_nvcc.KernelCompileError):
        BT.miller_loop_grouped(cuda, cuda)

    def plain(*args, **kwargs):
        raise _Sentinel

    monkeypatch.setattr(BT, "_dbl_lines", plain)
    monkeypatch.setattr(TSM, "windowed_scalar_mul", plain)
    g1, g2 = torch.zeros(1, 1, 2, 14, dtype=torch.int64), torch.zeros(1, 1, 2, 2, 14,
                                                                        dtype=torch.int64)
    for call in (lambda: BT.miller_loop_grouped(g1, g2),
                 lambda: BT.miller_loop_grouped(cuda, cuda, TT.PLAIN),
                 lambda: BT.g2_scalar_mul(g2[0, 0, 0], g2[0, 0, 1], 5, nbits=4),
                 lambda: BT.g2_scalar_mul(cuda, cuda, 5, 4, TT.PLAIN)):
        with pytest.raises(_Sentinel):
            call()
    monkeypatch.undo()

    rec = TSM.recode_signed_windows(5, 4, 4)
    x = torch.zeros(2, 2, 14, dtype=torch.int64)
    with pytest.raises(ValueError):
        FPt.g2_ladder_cuda(x, x, None, rec)
    with pytest.raises(ValueError):
        FPt.miller_grouped_cuda(torch.zeros(1, 2, 2, 14, dtype=torch.int64),
                                torch.zeros(1, 2, 2, 2, 14, dtype=torch.int64))
    if _nvcc.shutil.which("nvcc") is None and not _nvcc.library_path("fq_points").exists():
        with pytest.raises(_nvcc.KernelCompileError):
            FPt._launcher("g2_ladder")


def test_work_and_bound():
    """A launch's work: every multiply 406 limb products (196 + 210),
    every leaf 196, every REDC 210; bytes of the inputs and outputs read
    and written once. The cofactor ladder at 16 lanes and the Miller loop
    at 128 x 3 are bound by their products."""
    prog = FPt.ladder_program(BT._G2_COFACTOR_NBITS, 4)
    products, nbytes = FPt.program_work(prog, 1)
    assert products == prog.n_mul * 406 + prog.n_leaves * 196 + prog.n_redc * 210
    assert nbytes == 8 * 14 * 8 + 2
    rate, mem = 132 * 64 * 1.98e9, 3.35e12
    ms, by = FPt.bound_ms(prog, 16, rate, mem)
    assert by == "operations" and ms == pytest.approx(products * 16 / rate * 1e3)
    mp = FPt.miller_program(3)
    products, nbytes = FPt.program_work(mp, 128)
    assert nbytes == 128 * (6 + 12 + 12) * 14 * 8
    assert FPt.bound_ms(mp, 128, rate, mem) == (pytest.approx(products / rate * 1e3),
                                                "operations")
