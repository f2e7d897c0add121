"""The fixed-exponent powers as chains (ops.fq.fq_pow_program with
Field.pow_static, ops.fq_tower.fq2_pow_program with Tower.fq2_pow_static,
and the chain's own step kinds: fq_mul, fq2_sqr, norm, store, load)
against the JAX package's loops and the port's own, and the routing that
sends a CUDA tensor's power to one chain launch.

The JAX functions run as the JAX package's tests run them (eagerly on the
CPU: consensus_specs_tpu/ops/fq.py fq_inv / fq_sqrt_candidate through
_fq_pow_static, decompress.py _fq2_pow_static), at the shapes the port's
other tests already give them. Their op lists come from running them with
`jax` / `jnp` and the tower replaced by recorders. Inputs: seeded numpy
limbs at the multiply budget's edges (|body limb| < 2^32, |top limb| <
2^16) or as the path's products leave them (top limbs in [0, 13]); the
tolerance is zero (integer limbs)."""
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import decompress as JD
from consensus_specs_tpu.ops import fq as JF
from consensus_specs_tpu.ops import fq_tower as JT
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls12_381 as gt
from consensus_specs_tpu_torch.ops import decompress as TD
from consensus_specs_tpu_torch.ops import fq as TF
from consensus_specs_tpu_torch.ops import fq_cuda
from consensus_specs_tpu_torch.ops import fq_tower as TT

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

KERNEL_SOURCE = (Path(__file__).resolve().parent.parent
                 / "consensus_specs_tpu_torch" / "csrc" / "fq_mont.cu")
POWERS = {"inv": TF._INV_EXP_BITS, "sqrt": TF._SQRT_EXP_BITS}


def _edge(rng, shape):
    """Multiply inputs at the budget's edges; lane 0 all at the maximum,
    lane 1 all at the minimum."""
    a = rng.integers(-(1 << 32) + 1, 1 << 32, shape + (14,))
    a[..., -1] = rng.integers(-(1 << 16) + 1, 1 << 16, shape)
    a[0, ..., :-1], a[0, ..., -1] = (1 << 32) - 1, (1 << 16) - 1
    a[1, ..., :-1], a[1, ..., -1] = -(1 << 32) + 1, -(1 << 16) + 1
    return a


def _lazy(rng, shape):
    """Limbs as the products leave them: [-16, 2^29], top limb in [0, 13]."""
    a = rng.integers(-16, (1 << 29) + 1, shape + (14,))
    a[..., -1] = rng.integers(0, 14, shape)
    return a


def _t(a):
    return convert.limbs_from_numpy(a, "cpu")


def _same(t, j):
    got = convert.limbs_to_numpy(t)
    want = np.asarray(j)
    assert got.shape == want.shape
    assert (got == want).all()


def _plain_pow(a, bits):
    """The port's plain Fq power chain on [..., 14] limbs."""
    return TF.fq_bilinear_chain_plain(a[..., None, :], TF.fq_pow_program(bits), None)[..., 0, :]


# ---------------------------------------------------------------------------
# The plain chains == the JAX package's loops, limb for limb
# ---------------------------------------------------------------------------

def test_plain_inv_and_sqrt_chains_equal_jax():
    """fq_inv at tests/test_torch_fq.py's shape (6 lanes at the budget's
    edges) and fq_sqrt_candidate at its 4 (squares and a non-residue):
    the plain chain, DEVICE's route on the CPU and the loop (PLAIN) all
    equal the reference's _fq_pow_static."""
    rng = np.random.default_rng(140)
    a = _edge(rng, (6,))
    want = JF.fq_inv(a)
    _same(_plain_pow(_t(a), TF._INV_EXP_BITS), want)
    _same(TF.fq_inv(_t(a)), want)
    _same(TF.PLAIN.inv(_t(a)), want)
    sq = JF.stack_mont([4, 9, 5, 0])
    want = JF.fq_sqrt_candidate(sq)
    _same(_plain_pow(_t(sq), TF._SQRT_EXP_BITS), want)
    _same(TF.fq_sqrt_candidate(_t(sq)), want)
    roots = convert.limbs_to_numpy(_plain_pow(_t(sq), TF._SQRT_EXP_BITS))
    assert [TF.from_mont(r) ** 2 % TF.Q for r in roots[:2]] == [4, 9]


def test_plain_fq2_sqrt_chain_equals_jax():
    """The Fq2 square root's power (q^2 + 7) / 16 on 2 lanes of lazy
    limbs: the plain chain (decompress._fq2_pow_static on the CPU), the
    loop (Tower(PLAIN)) and the reference's _fq2_pow_static, limb for
    limb, and the bignum power."""
    rng = np.random.default_rng(141)
    a = _lazy(rng, (2, 2))
    bits = TD._SQRT2_EXP_BITS
    want = np.asarray(JD._fq2_pow_static(a, bits))
    _same(TD._fq2_pow_static(_t(a), bits), want)
    _same(TT.PLAIN.fq2_pow_static(_t(a), bits), want)
    one = TT.fq2_ones((2,), "cpu")
    _same(TF.fq_bilinear_chain_plain(one, TT.fq2_pow_program(bits), TT.TABLES, _t(a)), want)
    e = (gt.q ** 2 + 7) // 16
    assert int("".join(map(str, bits)), 2) == e
    for g in range(2):
        assert TT.fq2_from_limbs(want[g]) == TT.fq2_from_limbs(a[g]) ** e


@pytest.mark.parametrize("which", list(POWERS))
def test_pow_chain_equals_the_bignum_power(which):
    """Lane by lane, the plain chain's value == the bignum field's a^e
    (Montgomery in and out), at lanes at the budget's edges."""
    rng = np.random.default_rng(142)
    a = _edge(rng, (3,))
    got = convert.limbs_to_numpy(_plain_pow(_t(a), POWERS[which]))
    e = int("".join(map(str, POWERS[which])), 2)
    for g in range(3):
        assert TF.from_mont(got[g]) == pow(TF.from_mont(a[g]), e, TF.Q)


# ---------------------------------------------------------------------------
# Each step kind == the function it stands for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", ["acc", "base", "slot"])
def test_mul_step_is_fq_mul(src):
    """A KIND_MUL step == fq_mul_plain(acc, b), b the accumulator, the
    base or an operand slot, at the budget's edges (4 lanes)."""
    rng = np.random.default_rng(143)
    acc = _t(_edge(rng, (4, 1)))
    b = _t(_edge(rng, (4, 1)))
    op = _t(_edge(rng, (4, 3, 1)))
    code = {"acc": TF.SRC_ACC, "base": TF.SRC_BASE, "slot": TF.SRC_OPERAND + 2}[src]
    prog = TF.chain_program([(TF.KIND_MUL, code)])
    got = TF.fq_bilinear_chain_plain(acc, prog, None, b, op)
    other = {"acc": acc, "base": b, "slot": op[:, 2]}[src]
    assert torch.equal(got, TF.fq_mul_plain(acc, other))


def test_sqr2_step_is_the_towers_fq2_sqr():
    """A KIND_SQR2 step == Tower.fq2_sqr (PLAIN: (a0 + a1)(a0 - a1) and
    a0 a1 as fq_mul, then (P0, P1 + P1)) == the reference's fq2_sqr."""
    rng = np.random.default_rng(144)
    a = _edge(rng, (4, 2))
    prog = TF.chain_program([(TF.KIND_SQR2, TF.SRC_ACC)])
    got = TF.fq_bilinear_chain_plain(_t(a), prog, None)
    assert torch.equal(got, TT.PLAIN.fq2_sqr(_t(a)))
    _same(got, JT.fq2_sqr(a))


def test_norm_store_load_steps():
    """norm == fq_norm; a store then a load gives the stored value back;
    a table's untouched slot is one of the accumulator's field (a load of
    it gives Montgomery one in row 0 and zero rows after it)."""
    rng = np.random.default_rng(145)
    a = _t(_edge(rng, (3, 2)))
    norm = TF.chain_program([(TF.KIND_NORM, TF.SRC_ACC)])
    assert torch.equal(TF.fq_bilinear_chain_plain(a, norm, None), TF.fq_norm(a))
    prog = TF.chain_program([(TF.KIND_STORE, TF.SRC_OPERAND + 1), (TF.KIND_NORM, TF.SRC_ACC),
                             (TF.KIND_LOAD, TF.SRC_OPERAND + 1)])
    assert torch.equal(TF.fq_bilinear_chain_plain(a, prog, None), a)
    one = TF.fq_bilinear_chain_plain(a, TF.chain_program([(TF.KIND_LOAD, TF.SRC_OPERAND)]), None)
    assert torch.equal(one[:, 0], TF.fq_ones((3,), "cpu")) and not one[:, 1].any()
    assert TF.program_slots(prog) == 2


# ---------------------------------------------------------------------------
# The programs are the reference's op lists
# ---------------------------------------------------------------------------

class _Sym:
    """A symbolic Fq value: the op that made it."""

    shape = (1, 14)

    def __init__(self, name):
        self.name = name


class _SymTable(list):
    """The reference's stacked power table, as a list with `.at[j].set`."""

    @property
    def at(self):
        table = self

        class _At:
            def __getitem__(self, j):
                return SimpleNamespace(set=lambda v: _SymTable(
                    table[:j] + [v] + table[j + 1:]))
        return _At()


def _fake_jax():
    def fori_loop(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(i, carry)
        return carry

    return SimpleNamespace(lax=SimpleNamespace(fori_loop=fori_loop))


def _reference_fq_pow_ops(bits, monkeypatch):
    """The multiplies the reference's _fq_pow_static asks for, in order,
    each as (operand, operand) names: "a" the normalized input, "one" the
    table's Montgomery one, "t<k>" table entry k, "m<i>" the i-th product."""
    ops = []

    def fq_mul(x, y):
        ops.append((x.name, y.name))
        return _Sym(f"m{len(ops) - 1}")

    fake_jnp = SimpleNamespace(
        broadcast_to=lambda v, shape: _SymTable([v] * shape[0]),
        take=lambda table, i, axis=0: table[int(i)],
        asarray=np.asarray)
    monkeypatch.setattr(JF, "fq_norm", lambda a: _Sym("a"))
    monkeypatch.setattr(JF, "fq_ones", lambda shape: _OneRow(_Sym("one")))
    monkeypatch.setattr(JF, "fq_mul", fq_mul)
    monkeypatch.setattr(JF, "jnp", fake_jnp)
    monkeypatch.setattr(JF, "jax", _fake_jax())
    JF._fq_pow_static(_Sym("input"), bits)
    return ops


class _OneRow:
    """fq_ones(shape)[None]: the table's row broadcast by the reference."""

    def __init__(self, one):
        self.one = one
        self.shape = (1,)

    def __getitem__(self, idx):
        return self.one


def _program_fq_ops(prog):
    """The port program's multiplies, named as _reference_fq_pow_ops does."""
    ops, slots, acc = [], {0: "one"}, "input"
    for code in prog:
        kind, src = int(code) & TF.KIND_MASK, int(code) >> TF.KIND_BITS
        if kind == TF.KIND_NORM:
            acc = "a"
        elif kind == TF.KIND_STORE:
            slots[src - TF.SRC_OPERAND] = acc
        elif kind == TF.KIND_LOAD:
            acc = slots.get(src - TF.SRC_OPERAND, "one")
        else:
            assert kind == TF.KIND_MUL
            b = acc if src == TF.SRC_ACC else slots.get(src - TF.SRC_OPERAND, "one")
            ops.append((acc, b))
            acc = f"m{len(ops) - 1}"
    return ops


@pytest.mark.parametrize("which", list(POWERS))
def test_fq_pow_programs_are_the_reference_products(which, monkeypatch):
    """fq_pow_program(e) == the multiplies the reference's _fq_pow_static
    asks for, operand for operand: the table's 14 products of the
    normalized input, then per window 4 squarings and one multiply by a
    table entry (Montgomery one for a zero digit); 489 / 484 products."""
    bits = POWERS[which]
    want = _reference_fq_pow_ops(bits, monkeypatch)
    prog = TF.fq_pow_program(bits)
    assert _program_fq_ops(prog) == want
    assert len(want) == {"inv": 489, "sqrt": 484}[which]
    assert len(prog) == len(want) + {"inv": 17, "sqrt": 17}[which]
    assert TF.fq_pow_program(bits) is prog           # built once


def test_fq2_pow_program_is_the_reference_products(monkeypatch):
    """fq2_pow_program == the products of the reference's
    _fq2_pow_static that reach its result (it squares every bit and
    multiplies by a on every bit, selecting the product on a set bit):
    758 squarings and 365 multiplies by the base."""
    made = {}

    def op(kind, *args):
        v = _Sym(f"{kind}{len(made)}")
        made[v.name] = (kind, args)
        return v

    fake_T = SimpleNamespace(
        fq2_sqr=lambda x: op("sqr", x),
        fq2_mul=lambda x, y: op("mul", x, y),
        fq2_select=lambda c, x, y: x if bool(c) else y,
        fq2_ones=lambda shape: _Sym("one"))
    monkeypatch.setattr(JT, "fq2_sqr", fake_T.fq2_sqr)
    monkeypatch.setattr(JT, "fq2_mul", fake_T.fq2_mul)
    monkeypatch.setattr(JT, "fq2_select", fake_T.fq2_select)
    monkeypatch.setattr(JT, "fq2_ones", fake_T.fq2_ones)
    monkeypatch.setattr(JD, "jnp", SimpleNamespace(
        asarray=np.asarray, broadcast_to=lambda v, shape: v))
    monkeypatch.setattr(JD, "jax", _fake_jax())
    base = _Sym("a")
    base.shape = (1, 2, 14)
    out = JD._fq2_pow_static(base, TD._SQRT2_EXP_BITS)
    chain, v = [], out                     # the ops the result depends on
    while v.name != "one":
        kind, args = made[v.name]
        assert kind == "sqr" or args[1] is base
        chain.append("fq2_sqr" if kind == "sqr" else "fq2_mul")
        v = args[0]
    prog = TT.fq2_pow_program(TD._SQRT2_EXP_BITS)
    names = [TT.step_name(c) for c in prog]
    assert names == chain[::-1]
    assert all(int(c) >> TF.KIND_BITS == (TF.SRC_BASE if n == "fq2_mul" else TF.SRC_ACC)
               for c, n in zip(prog, names))
    assert (names.count("fq2_sqr"), names.count("fq2_mul")) == (758, 365)


# ---------------------------------------------------------------------------
# Routes, refusals, counts, the kernel's kind codes
# ---------------------------------------------------------------------------

class _CudaLike(torch.Tensor):
    """A CPU tensor that reads as a CUDA one: what the routing sees."""

    @property
    def is_cuda(self):
        return True


def test_cuda_powers_take_one_chain_launch(monkeypatch):
    """For a CUDA tensor, DEVICE.inv / sqrt_candidate, Tower.fq2_pow_static
    and decompress._fq2_pow_static each make exactly one call of the chain
    kernel's wrapper with their program, and no multiply and no plain
    chain runs; PLAIN keeps the loops (no chain)."""
    calls = []

    def kernel(acc, program, tables, base=None, operand=None):
        calls.append((tuple(acc.shape), len(program), tables is TT.TABLES, base is not None))
        return acc.as_subclass(torch.Tensor)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain or per-product route")

    monkeypatch.setattr(fq_cuda, "fq_bilinear_chain_cuda", kernel)
    for name in ("fq_bilinear_chain_plain", "fq_mul_plain", "fq_bilinear_plain"):
        monkeypatch.setattr(TF, name, refuse)
    monkeypatch.setattr(fq_cuda, "fq_mul_cuda", refuse)
    rng = np.random.default_rng(146)
    a = _t(_edge(rng, (3,))).as_subclass(_CudaLike)
    TF.DEVICE.inv(a)
    TF.DEVICE.sqrt_candidate(a)
    y = _t(_lazy(rng, (3, 2))).as_subclass(_CudaLike)
    TT.DEVICE.fq2_pow_static(y, TD._SQRT2_EXP_BITS)
    TD._fq2_pow_static(y, TD._SQRT2_EXP_BITS)
    assert calls == [((3, 1, 14), 506, False, False), ((3, 1, 14), 501, False, False),
                     ((3, 2, 14), 1123, True, True), ((3, 2, 14), 1123, True, True)]
    assert TF.DEVICE.chain_powers and not TF.PLAIN.chain_powers
    assert TF.DEVICE.bilinear_chain is TF.fq_bilinear_chain


def test_chain_wrapper_refuses_cpu_and_malformed_programs():
    """The kernel wrapper refuses CPU tensors (no fallback); the launch
    plan refuses every step the kernel cannot run: an unknown kind, a
    slot past the table, a store into an operand, an fq2 squaring of the
    base, an fq_mul on an Fq2 accumulator, a norm of the base, a store
    into a slot of other rows, an empty program. A program has no length
    limit: 5,000 steps plan like one."""
    rng = np.random.default_rng(147)
    f1 = _t(_edge(rng, (2, 1)))
    f2 = _t(_edge(rng, (2, 2)))
    lines = _t(_edge(rng, (2, 2, 1)))
    prog = TF.fq_pow_program(np.array([1, 0, 1], np.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        fq_cuda.fq_bilinear_chain_cuda(f1, prog, None)
    bad = {
        "kind": (f1, np.array([11], np.int32), None, None),
        "slot": (f1, np.array([TF.KIND_MUL | 5 << TF.KIND_BITS], np.int32), None, lines),
        "store": (f1, TF.chain_program([(TF.KIND_STORE, TF.SRC_OPERAND)]), None, lines),
        "sqr2 base": (f2, np.array([TF.KIND_SQR2 | TF.SRC_BASE << TF.KIND_BITS], np.int32),
                      f2, None),
        "mul on Fq2": (f2, TF.chain_program([(TF.KIND_MUL, TF.SRC_ACC)]), None, None),
        "norm base": (f1, np.array([TF.KIND_NORM | TF.SRC_BASE << TF.KIND_BITS], np.int32),
                      f1, None),
        "rows": (f2, TF.chain_program([(TF.KIND_STORE, TF.SRC_OPERAND)]), None,
                 _t(_edge(rng, (2, 1, 1)))),
    }
    for what, (acc, p, base, op) in bad.items():
        with pytest.raises(ValueError):
            fq_cuda._chain_plan(acc, p, base, op)
    with pytest.raises(ValueError):
        fq_cuda._chain_plan(f1, np.zeros(0, np.int32), None, None)
    with pytest.raises(ValueError):
        TF.chain_program([(TF.KIND_STORE, TF.SRC_ACC)])
    with pytest.raises(ValueError):
        TF.chain_program([(TF.KIND_SQR2, TF.SRC_BASE)])
    long = TF.chain_program([(TF.KIND_MUL, TF.SRC_ACC)] * 5000)
    plan = fq_cuda._chain_plan(f1, long, None, None)
    assert len(plan[4]) == 5000 and list(plan[3]) == [1, 0, 0, 0, 0]
    plan = fq_cuda._chain_plan(f1, prog, None, None)
    assert list(plan[3]) == [1, 0, 16, 1, 0]        # a table of 16 one-row slots


def test_pow_chain_work_and_bound():
    """The Fq inversion's chain: 489 fq_mul-route products of 406 limb
    products a lane, 224 bytes (the accumulator read and written; the
    table is the program's own); the Fq2 square root's 758 squarings of
    two and 365 fq2_mul of 3 x 196 + 2 x 210."""
    inv = TF.fq_pow_program(TF._INV_EXP_BITS)
    assert fq_cuda.chain_work(inv, TT.TABLES) == (489 * 406, 224)
    sq2 = TT.fq2_pow_program(TD._SQRT2_EXP_BITS)
    assert fq_cuda.chain_work(sq2, TT.TABLES, Cb=2) == (
        758 * 2 * 406 + 365 * (3 * 196 + 2 * 210), (2 * 2 + 2) * 112)
    ms, by = fq_cuda.chain_bound_ms(inv, TT.TABLES, 128, 132 * 64 * 1.98e9, 3.35e12)
    assert by == "operations" and ms == pytest.approx(489 * 406 * 128 / (132 * 64 * 1.98e9) * 1e3)


def test_final_exponentiation_runs_one_inversion_chain():
    """The final exponentiation over a field that chains its powers: its
    Fq inversion is one chain (6 chains: 5 pow_abs and the inversion) and
    5 fq_mul are left of its 494 (the pair products and the scaling of
    fq2_inv); 44 single tower products either way."""
    counts = {"mul": 0, "bil": 0, "chain": 0}

    def mul(a, b):
        counts["mul"] += 1
        return TF.fq_mul_plain(a, b)

    def bil(av, bv, t):
        counts["bil"] += 1
        return TF.fq_bilinear_plain(av, bv, t)

    def chain(*args):
        counts["chain"] += 1
        return TF.fq_bilinear_chain_plain(*args)

    from consensus_specs_tpu_torch.ops import bls_torch as BT
    rng = np.random.default_rng(148)
    f = _t(_lazy(rng, (1, 2, 3, 2)))
    for powers, want in ((True, {"mul": 5, "bil": 44, "chain": 6}),
                         (False, {"mul": 494, "bil": 44, "chain": 5})):
        counts.update(mul=0, bil=0, chain=0)
        fld = TF.Field(mul, TF.fq_mul_norm_plain, TF.fq_redc_plain, bil, chain,
                       chain_powers=powers)
        got = BT.final_exponentiation_3x(f, TT.Tower(fld))
        assert counts == want
        if powers:
            first = got
        else:
            assert torch.equal(got, first)


def test_kernel_kind_codes_match():
    """csrc/fq_mont.cu's step kinds and sources are ops/fq.py's."""
    src = KERNEL_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("kKindMul") == TF.KIND_MUL == len(TT.TABLES)
    assert (const("kKindSqr2"), const("kKindNorm"), const("kKindStore"),
            const("kKindLoad")) == (TF.KIND_SQR2, TF.KIND_NORM, TF.KIND_STORE, TF.KIND_LOAD)
    assert const("kStepKinds") == TF.N_KINDS
    assert (const("kSrcAcc"), const("kSrcBase"), const("kSrcOperand")) == (
        TF.SRC_ACC, TF.SRC_BASE, TF.SRC_OPERAND)
    assert const("kKindBits") == TF.KIND_BITS
