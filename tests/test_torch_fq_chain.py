"""The port's chains of tower products (ops.fq.fq_bilinear_chain,
ops/fq_tower.py's programs and Tower.fq12_pow_abs / fq12_sqr_mul_lines /
fq12_mul_lines) against the JAX package's loops of products and its
bignum tower, and the generated kernel header against its generator.

The reference's loops (consensus_specs_tpu/ops/bls_jax.py `_pow_abs` and
`miller_loop_grouped`) are run with their tower module and `jax` replaced
by recorders, so they compile nothing and give the sequence of products
they ask for. Values: lazy limbs from a seeded numpy generator, G = 2;
tolerance zero (integer limbs), values compared exactly in the bignum
field."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import bls_jax as BJ
from consensus_specs_tpu.ops import fq_tower as JT
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.ops import bls_torch as BT
from consensus_specs_tpu_torch.ops import fq as TF
from consensus_specs_tpu_torch.ops import fq_cuda
from consensus_specs_tpu_torch.ops import fq_tables_gen
from consensus_specs_tpu_torch.ops import fq_tower as TT

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

G = 2
BITS = {"z": BT._Z_BITS, "z_plus_1": BT._ZP1_BITS}


def _rand(rng, shape):
    """Lazy limbs in [-16, 2^29], top limb in [0, 13]: inside the
    multiply budget."""
    a = rng.integers(-16, (1 << 29) + 1, shape + (14,))
    a[..., -1] = rng.integers(0, 14, shape)
    return convert.limbs_from_numpy(a, "cpu")


def _decode(program):
    """A program's steps as (product name, b source)."""
    return [(TT.TABLES[int(c) & TF.KIND_MASK].name, int(c) >> TF.KIND_BITS)
            for c in program]


# ---------------------------------------------------------------------------
# The programs are the reference's sequences of products
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the reference's tower module inside bls_jax: records
    every Fq12 product with the source of its b, and gives placeholders.
    Fq2 results are [G, P, 2, L] arrays holding p at pair p, so a line's
    slice [:, p] tells which pair it came from."""

    def __init__(self, P=1, base=None):
        self.calls, self.base = [], base
        self.pairs = np.broadcast_to(np.arange(P)[None, :, None, None], (1, P, 2, 14))

    def __getattr__(self, name):
        if name.startswith("fq2_"):
            return lambda *args: self.pairs
        raise AttributeError(name)

    def fq12_ones(self, shape):
        return object()

    def fq12_conj(self, f):
        return f

    def fq12_sqr(self, f):
        self.calls.append(("fq12_sqr", TF.SRC_ACC))
        return object()

    def fq12_cyclo_sqr(self, f):
        self.calls.append(("fq12_cyclo_sqr", TF.SRC_ACC))
        return object()

    def fq12_mul(self, a, b):
        assert b is self.base
        self.calls.append(("fq12_mul", TF.SRC_BASE))
        return object()

    def fq12_mul_line(self, f, c_a, c_v, c_vw):
        p = {int(c.flat[0]) for c in (c_a, c_v, c_vw)}
        assert len(p) == 1
        self.calls.append(("fq12_mul_line", TF.SRC_OPERAND + p.pop()))
        return object()


def _fake_jax():
    def fori_loop(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(i, carry)
        return carry

    def cond(pred, true_fn, false_fn, carry):
        return true_fn(carry) if bool(pred) else false_fn(carry)

    return SimpleNamespace(lax=SimpleNamespace(fori_loop=fori_loop, cond=cond))


@pytest.mark.parametrize("which", list(BITS))
def test_pow_programs_are_the_reference_products(which, monkeypatch):
    """pow_abs_program(e) == the products bls_jax._pow_abs asks for, in
    order: cyclotomic squarings of the accumulator and multiplies by f;
    63 squarings and 6 (|z| + 1) or 5 (|z|) multiplies."""
    f = object()
    rec = _Recorder(base=f)
    monkeypatch.setattr(BJ, "T", rec)
    monkeypatch.setattr(BJ, "jax", _fake_jax())
    BJ._pow_abs(f, BITS[which])
    program = TT.pow_abs_program(BITS[which])
    assert _decode(program) == rec.calls
    n_mul = {"z": 5, "z_plus_1": 6}[which]
    assert len(program) == 63 + n_mul
    assert TT.pow_abs_program(BITS[which]) is program       # built once


@pytest.mark.parametrize("P", [2, 3])
def test_miller_programs_are_the_reference_products(P, monkeypatch):
    """The doubling and addition steps' programs, bit by bit over |z|,
    == the Fq12 products bls_jax.miller_loop_grouped asks for: per bit
    one squaring and P line multiplies (line p from pair p), then on a
    set bit P more; 68 chains in all."""
    rec = _Recorder(P=P)
    monkeypatch.setattr(BJ, "T", rec)
    monkeypatch.setattr(BJ, "jax", _fake_jax())
    monkeypatch.setattr(BJ, "jnp", np)
    BJ.miller_loop_grouped(np.zeros((1, P, 2, 14)), np.zeros((1, P, 2, 2, 14)))
    want, chains = [], 0
    for bit in BT._Z_TAIL_BITS:
        want += _decode(TT.lines_program(P, True))
        chains += 1
        if bit:
            want += _decode(TT.lines_program(P, False))
            chains += 1
    assert rec.calls == want
    assert chains == 68
    assert _decode(TT.lines_program(P, True))[0] == ("fq12_sqr", TF.SRC_ACC)


# ---------------------------------------------------------------------------
# The plain chain == the per-product loop; the values == the bignum field
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cyclotomic():
    """[G, 2, 3, 2, L]: the easy part f^((q^6-1)(q^2+1)) of random f,
    through the port's plain tower: in the cyclotomic subgroup."""
    tw = TT.PLAIN
    f = _rand(np.random.default_rng(60), (G, 2, 3, 2))
    f1 = tw.fq12_mul(TT.fq12_conj(f), tw.fq12_inv(f))
    return tw.fq12_mul(tw.fq12_frobenius(f1, 2), f1)


@pytest.fixture(scope="module")
def powers(cyclotomic):
    """{which: fq12_pow_abs of the cyclotomic element} through the plain
    route (Tower(PLAIN)) and the routed one (on the CPU: plain too)."""
    return {w: (TT.PLAIN.fq12_pow_abs(cyclotomic, bits),
                TT.fq12_pow_abs(cyclotomic, bits)) for w, bits in BITS.items()}


def _pow_abs_by_products(tw, f, bits):
    """The exponentiation one product at a time, as the reference's loop
    (and the port before chains) computes it."""
    positions = np.nonzero(bits)[0]
    acc, prev = f, 0
    for p in positions[1:]:
        for _ in range(int(p - prev)):
            acc = tw.fq12_cyclo_sqr(acc)
        acc = tw.fq12_mul(acc, f)
        prev = int(p)
    for _ in range(len(bits) - 1 - prev):
        acc = tw.fq12_cyclo_sqr(acc)
    return acc


@pytest.mark.parametrize("which", list(BITS))
def test_plain_pow_chain_equals_the_product_loop(which, cyclotomic, powers):
    chain, routed = powers[which]
    assert torch.equal(chain, _pow_abs_by_products(TT.PLAIN, cyclotomic, BITS[which]))
    assert torch.equal(routed, chain)


@pytest.mark.parametrize("square", [True, False])
def test_plain_lines_chain_equals_the_product_loop(square):
    """The Miller step's f-update, P = 3 lines at G = 2: the chain ==
    (squaring, then) one line multiply per pair, limb for limb."""
    rng = np.random.default_rng(61 + square)
    f = _rand(rng, (G, 2, 3, 2))
    c_a, c_v, c_vw = (_rand(rng, (G, 3, 2)) for _ in range(3))
    tw = TT.PLAIN
    want = tw.fq12_sqr(f) if square else f
    for p in range(3):
        want = tw.fq12_mul_line(want, c_a[:, p], c_v[:, p], c_vw[:, p])
    step = tw.fq12_sqr_mul_lines if square else tw.fq12_mul_lines
    got = step(f, c_a, c_v, c_vw)
    assert torch.equal(got, want)
    routed = (TT.fq12_sqr_mul_lines if square else TT.fq12_mul_lines)(f, c_a, c_v, c_vw)
    assert torch.equal(routed, want)


@pytest.mark.parametrize("which", list(BITS))
def test_pow_abs_equals_the_bignum_power(which, cyclotomic, powers):
    """fq12_pow_abs(f, |z|) and (f, |z| + 1) == the reference's bignum
    Fq12 raised to the same exponent, lane for lane."""
    e = int("".join(map(str, BITS[which])), 2)
    assert e == {"z": BJ.gt.BLS_X, "z_plus_1": BJ.gt.BLS_X + 1}[which]
    got = convert.limbs_to_numpy(powers[which][0])
    base = convert.limbs_to_numpy(cyclotomic)
    for g in range(G):
        assert JT.fq12_from_limbs(got[g]) == JT.fq12_from_limbs(base[g]) ** e


# ---------------------------------------------------------------------------
# Routing, checks, counts, the generated header
# ---------------------------------------------------------------------------

def test_chain_routes_and_refuses():
    """On the CPU the routed chain is the plain one; the kernel wrapper
    refuses CPU tensors (no fallback); DEVICE / PLAIN carry the two
    routes; a program names only compiled products from valid sources."""
    rng = np.random.default_rng(62)
    f = _rand(rng, (G, 12))
    prog = TT.lines_program(1, True)
    lines = _rand(rng, (G, 1, 6))
    assert torch.equal(TF.fq_bilinear_chain(f, prog, TT.TABLES, operand=lines),
                       TF.fq_bilinear_chain_plain(f, prog, TT.TABLES, operand=lines))
    with pytest.raises(ValueError):
        fq_cuda.fq_bilinear_chain_cuda(f, prog, TT.TABLES, operand=lines)
    assert TF.DEVICE.bilinear_chain is TF.fq_bilinear_chain
    assert TF.PLAIN.bilinear_chain is TF.fq_bilinear_chain_plain
    with pytest.raises(ValueError):                  # a cyclotomic square of the base
        TF.chain_program([(TT._CYCLO_T, TF.SRC_BASE)])
    with pytest.raises(ValueError):
        TF.chain_program([])
    mixed = TF.chain_program([(TT._MUL_T, TF.SRC_ACC), (TT._FQ2_T, TF.SRC_ACC)])
    with pytest.raises(ValueError, match="fq2_mul"):   # an Fq2 product on Fq12
        fq_cuda._chain_plan(f, mixed, None, None)
    with pytest.raises(ValueError, match="mul_line"):  # line 1 of a 1-line operand
        fq_cuda._chain_plan(f, TT.lines_program(2, False), None, lines)
    with pytest.raises(ValueError, match="kind"):      # no compiled kind 9
        fq_cuda._chain_plan(f, np.array([9], np.int32), None, None)
    plan = fq_cuda._chain_plan(f, prog, None, lines)
    assert len(plan[2]) == fq_cuda._LAYOUT_LEN and list(plan[4]) == prog.tolist()
    with pytest.raises(ValueError, match="compiled"):  # tables other than TABLES
        fq_cuda._chain(f, prog, TT.TABLES[:4], None, lines)


def test_chain_work_and_bound():
    """A pow_abs chain at |z|: 594,720 limb products a lane (63
    cyclotomic squarings of 30 leaves, 5 multiplies of 54, 12 REDCs
    each), 4,032 bytes (f as accumulator and base, the result); at 128
    lanes bound by the products, 4.55 us."""
    prog = TT.pow_abs_program(BT._Z_BITS)
    assert fq_cuda.chain_work(prog, TT.TABLES, Cb=12) == (594720, 4032)
    ms, by = fq_cuda.chain_bound_ms(prog, TT.TABLES, 128, 132 * 64 * 1.98e9,
                                    3.35e12, Cb=12)
    assert by == "operations" and ms == pytest.approx(594720 * 128 / (132 * 64 * 1.98e9) * 1e3)
    assert ms == pytest.approx(0.004551, rel=1e-3)


class _Counting:
    """A Field over the plain versions that counts single tower products
    and chains (what the card's launches would be)."""

    def __init__(self):
        self.products = self.chains = 0

    def field(self):
        def bilinear(av, bv, tables):
            self.products += 1
            return TF.fq_bilinear_plain(av, bv, tables)

        def chain(*args):
            self.chains += 1
            return TF.fq_bilinear_chain_plain(*args)

        return TF.Field(TF.fq_mul_plain, TF.fq_mul_norm_plain, TF.fq_redc_plain,
                        bilinear, chain)


def test_grouped_pairing_runs_73_chains():
    """One grouped pairing at P = 3 (the firehose's shape; the count does
    not depend on G or the values): 68 Miller-step chains and 5 pow_abs
    chains, and the single tower products left beside them: 1,064 (of
    the 1,673 products a pairing makes, the 342 of the exponentiations and
    the 267 of the Miller f-updates run inside the chains)."""
    rng = np.random.default_rng(63)
    count = _Counting()
    tw = TT.Tower(count.field())
    f = BT.miller_loop_grouped(_rand(rng, (1, 3, 2)), _rand(rng, (1, 3, 2, 2)), tw)
    assert count.chains == 68
    BT.final_exponentiation_3x(f, tw)
    assert count.chains == 73
    assert count.products == 1064


def test_committed_header_is_the_generators_output():
    """csrc/fq_tables.cuh == fq_tables_gen.render(): a change to the
    tables cannot drift from the kernel's compiled-in code."""
    assert fq_tables_gen.HEADER.read_text() == fq_tables_gen.render()
    assert fq_tables_gen.HEADER.name == "fq_tables.cuh"
