"""The port's bignum BLS backend (consensus_specs_tpu_torch/crypto/
bls12_381.py::PythonBackend, registered as "python" in crypto/bls.py) held
against the reference's PythonBackend on cases of the
tests/test_bls_jax.py corpus: a verify, a swapped signature, an
aggregate verify, verify_multiple, a point off the curve, a length
mismatch and a garbage signature give the same verdicts; aggregation,
signing, the on-curve checks, the rejection of malformed points and the
field tower give the same bytes and values. Eight bignum verifies in all
(four cases on each side, about a second each); the others fail before
the pairing. "python" runs only where a caller names it: "torch" stays
the default, and without a card that default raises instead of falling
back."""
import random

import pytest

from consensus_specs_tpu.crypto import bls12_381 as JG
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.crypto import bls12_381 as PG

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

DOMAIN = 5
PRIVKEYS = [1, 2, 3, 0xDEADBEEF]


@pytest.fixture(scope="module")
def backends():
    return JG.PythonBackend(), PG.PythonBackend()


def _off_curve_g1() -> bytes:
    """A compressed G1 encoding whose x^3 + 4 is a non-residue."""
    x = next(x for x in range(2, 50) if pow(x ** 3 + 4, (JG.q - 1) // 2, JG.q) != 1)
    enc = bytearray(x.to_bytes(48, "big"))
    enc[0] |= 0x80
    return bytes(enc)


def _case(name):
    """(method, args) of one verify case, signed with the reference."""
    py = JG.PythonBackend()
    msg = b"\x77" * 32
    if name == "single":
        return "verify", (JG.privtopub(123), msg, py.sign(msg, 123, DOMAIN), DOMAIN)
    if name == "swapped":        # the signature of another key
        return "verify", (JG.privtopub(123), msg, py.sign(msg, 124, DOMAIN), DOMAIN)
    if name == "aggregate":
        keys = PRIVKEYS[:3]
        agg_sig = py.aggregate_signatures([py.sign(b"\x55" * 32, k, DOMAIN) for k in keys])
        agg_pub = py.aggregate_pubkeys([JG.privtopub(k) for k in keys])
        return "verify", (agg_pub, b"\x55" * 32, agg_sig, DOMAIN)
    msgs = [b"\x01" * 32, b"\x02" * 32]
    agg = py.aggregate_signatures([py.sign(m, k, DOMAIN) for m, k in zip(msgs, (7, 8))])
    pubs = [JG.privtopub(k) for k in (7, 8)]
    if name == "multiple":
        return "verify_multiple", (pubs, msgs, agg, DOMAIN)
    if name == "length_mismatch":
        return "verify_multiple", (pubs, msgs[:1], agg, DOMAIN)
    if name == "off_curve":
        return "verify", (_off_curve_g1(), msg, agg, DOMAIN)
    assert name == "garbage_signature"
    return "verify", (JG.privtopub(123), msg, b"\x00" * 96, DOMAIN)


@pytest.mark.parametrize("name, want", [
    ("single", True), ("swapped", False), ("aggregate", True),
    ("multiple", True), ("length_mismatch", False), ("off_curve", False),
    ("garbage_signature", False)])
def test_verdicts_match_reference(backends, name, want):
    method, args = _case(name)
    ref, port = backends
    assert getattr(port, method)(*args) is getattr(ref, method)(*args) is want


def test_sign_and_aggregates_match_reference(backends):
    ref, port = backends
    msg = b"\x42" * 32
    for k in PRIVKEYS[:2]:
        assert port.sign(msg, k, DOMAIN) == ref.sign(msg, k, DOMAIN)
    pubs = [JG.privtopub(k) for k in PRIVKEYS]
    inf = JG.compress_g1(None)
    for sub in (pubs, pubs[:3], pubs[:1], pubs[:3] + [inf]):
        assert port.aggregate_pubkeys(sub) == ref.aggregate_pubkeys(sub)
    sigs = [ref.sign(b"\x33" * 32, k, DOMAIN) for k in PRIVKEYS[:3]]
    assert port.aggregate_signatures(sigs) == ref.aggregate_signatures(sigs)
    assert port.aggregate_signatures([]) == ref.aggregate_signatures([])


def test_malformed_points_rejected_like_reference(backends):
    good = [JG.privtopub(k) for k in PRIVKEYS[:3]]
    for bad in (_off_curve_g1(),
                bytes([good[0][0] & 0x7F]) + good[0][1:],     # c_flag unset
                bytes([0xE0]) + b"\x00" * 47):                # infinity with a_flag
        for backend in backends:
            with pytest.raises(AssertionError):
                backend.aggregate_pubkeys(good + [bad])


def test_curve_checks_and_tower_match_reference():
    rng = random.Random(0x515)
    g1 = JG.ec_mul(JG.G1_GEN, rng.randrange(1, JG.r))
    g2 = JG.ec_mul(JG.G2_GEN, rng.randrange(1, JG.r))
    port_g2 = (PG.Fq2(g2[0].c0, g2[0].c1), PG.Fq2(g2[1].c0, g2[1].c1))
    assert PG.g1_on_curve(g1) and PG.g2_on_curve(port_g2) and PG.g1_on_curve(None)
    assert not PG.g1_on_curve((g1[0], g1[1] + 1))
    assert PG.FINAL_EXPONENT == JG.FINAL_EXPONENT

    def fq12(G, vals):
        f2 = [G.Fq2(vals[2 * i], vals[2 * i + 1]) for i in range(6)]
        return G.Fq12(G.Fq6(*f2[:3]), G.Fq6(*f2[3:]))

    def ints(x):
        return [c for f6 in (x.c0, x.c1) for f2 in (f6.c0, f6.c1, f6.c2)
                for c in (f2.c0, f2.c1)]
    a = [rng.randrange(JG.q) for _ in range(12)]
    b = [rng.randrange(JG.q) for _ in range(12)]
    for op in (lambda x, y: x * y, lambda x, y: x - y, lambda x, y: x.inv() * y,
               lambda x, y: x.conj() + y ** 5):
        assert ints(op(fq12(PG, a), fq12(PG, b))) == ints(op(fq12(JG, a), fq12(JG, b)))
    ux, uy = PG.untwist(port_g2)
    jx, jy = JG.untwist(g2)
    assert ints(ux) == ints(jx) and ints(uy) == ints(jy)


def test_python_backend_only_when_named():
    """"python" is registered, selectable and restorable; "torch" stays
    the default (without a card its backend raises instead of falling
    back: tests/test_torch_no_jax.py)."""
    assert PBLS._active_backend_name == "torch"
    assert "python" in PBLS._backends
    PBLS.set_backend("python")
    try:
        assert isinstance(PBLS.get_backend(), PG.PythonBackend)
        pubs = [JG.privtopub(k) for k in PRIVKEYS]
        assert PBLS.bls_aggregate_pubkeys(pubs) == JG.aggregate_pubkeys(pubs)
    finally:
        PBLS._active_backend_name = "torch"
