"""Port's pairing and signature backend (consensus_specs_tpu_torch.ops.
bls_torch) against the bignum oracle (consensus_specs_tpu/crypto/
bls12_381.py): pairing values (cubed, as the device computes
f^(3 (q^12-1)/r)), grouped verdicts, and TorchBackend's verdicts and bytes
== PythonBackend's.

These run the port on the CPU (its plain path) and do not compile new
shapes of the JAX pairing programs; the JAX package's own tests hold
JaxBackend against the same oracle. Points come from seeded scalars."""
import random

import numpy as np
import pytest

from consensus_specs_tpu.crypto import bls12_381 as gt
from consensus_specs_tpu.ops import bls_jax as BJ
from consensus_specs_tpu.ops import fq_tower as JT
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls12_381 as pgt
from consensus_specs_tpu_torch.ops import bls_torch as BT

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

rng = random.Random(0xB15)
DOMAIN = 5


def _t(a):
    return convert.limbs_from_numpy(np.asarray(a), "cpu")


def _fq12(t, k):
    return JT.fq12_from_limbs(convert.limbs_to_numpy(t)[k])


def rand_g1():
    return gt.ec_mul(gt.G1_GEN, rng.randrange(1, gt.r))


def rand_g2():
    return gt.ec_mul(gt.G2_GEN, rng.randrange(1, gt.r))


@pytest.fixture(scope="module")
def backends():
    return gt.PythonBackend(), BT.TorchBackend("cpu")


def test_pairing_matches_oracle_cubed():
    P, Q = rand_g1(), rand_g2()
    g1 = _t(BJ.g1_to_limbs(P)[None, None])
    g2 = _t(BJ.g2_to_limbs(Q)[None, None])
    f = BT.miller_loop_grouped(g1, g2)
    res = BT.final_exponentiation_3x(f)
    assert _fq12(res, 0) == gt.pairing(P, Q) ** 3


def test_grouped_miller_matches_pairwise_product():
    """The groups of tests/test_bls_jax.py's grouped test: group 0 =
    e(2P0,Q0) e(-P0,2Q0) times a stray e(P1,Q1) [fails]; group 1 = three
    slots that do not cancel [fails]; group 2 = e(P0,Q0)^2 e(-P0,2Q0)
    [passes]. Grouped verdicts == the pairwise oracle's, and the grouped
    Miller values == the products of the pairwise ones."""
    Ps = [rand_g1() for _ in range(4)]
    Qs = [rand_g2() for _ in range(4)]
    g1_pts = [[gt.ec_mul(Ps[0], 2), gt.ec_neg(Ps[0]), Ps[1]],
              [Ps[2], Ps[3], gt.ec_mul(Ps[2], 5)],
              [Ps[0], Ps[0], gt.ec_neg(Ps[0])]]
    g2_pts = [[Qs[0], gt.ec_mul(Qs[0], 2), Qs[1]],
              [Qs[2], Qs[3], gt.ec_mul(Qs[2], 7)],
              [Qs[0], Qs[0], gt.ec_mul(Qs[0], 2)]]
    g1 = _t(np.stack([np.stack([BJ.g1_to_limbs(p) for p in row]) for row in g1_pts]))
    g2 = _t(np.stack([np.stack([BJ.g2_to_limbs(q) for q in row]) for row in g2_pts]))
    G, P = 3, 3
    f_grouped = BT.miller_loop_grouped(g1, g2)
    fs_pair = BT.miller_loop_batch(g1.reshape((G * P,) + g1.shape[2:]),
                                   g2.reshape((G * P,) + g2.shape[2:]))
    verdict = BT._grouped_verdict(f_grouped)
    verdict_pair = BT._group_product_is_one(fs_pair.reshape((G, P) + fs_pair.shape[1:]))
    assert verdict.tolist() == verdict_pair.tolist() == [False, False, True]
    for g in range(G):
        prod = _fq12(fs_pair, g * P)
        for p in range(1, P):
            prod = prod * _fq12(fs_pair, g * P + p)
        assert _fq12(f_grouped, g) == prod, g


def _oracle_indexed(py, item):
    """verify_multiple over the aggregates of the sets, False where the
    oracle raises (malformed pubkeys)."""
    sets, msgs, sig, domain = item
    try:
        aggs = [py.aggregate_pubkeys(s) for s in sets]
    except AssertionError:
        return False
    return py.verify_multiple(aggs, msgs, sig, domain)


INDEXED_VERDICTS = [True, False, False, True, True, False, False, False,
                    False, False, True]


@pytest.fixture(scope="module")
def indexed_items():
    """A small block in the phase-0 shape (custody-bit-0 set, empty
    custody-bit-1 set): valid items, a wrong signature, wrong
    participants, an all-empty item, an infinity aggregate, malformed
    pubkey and signature encodings, wrong lengths, a length mismatch."""
    keys = list(range(11, 31))
    pub = {k: pgt.privtopub(k) for k in keys}
    msgs = [bytes([0x40 + i]) * 32 for i in range(8)]
    bit1 = [bytes([0x80 + i]) * 32 for i in range(8)]     # custody bit 1

    def att(members, m, signers=None, sig=None):
        signers = members if signers is None else signers
        if sig is None:
            sig = pgt.sign(msgs[m], sum(signers) % pgt.r, DOMAIN)
        return ([[pub[k] for k in members], []], [msgs[m], bit1[m]], sig, DOMAIN)

    valid0 = att([11, 12, 13], 0)
    valid1 = att([14, 15, 16, 17], 1)

    def neg(k):
        return gt.compress_g1(gt.ec_neg(gt.decompress_g1(pub[k])))

    inf_agg = ([[pub[14], neg(14), pub[18], neg(18)], [pub[19], pub[20], pub[21]]],
               [msgs[2], msgs[3]], pgt.sign(msgs[3], 19 + 20 + 21, DOMAIN), DOMAIN)
    no_c = bytes([pub[22][0] & 0x7F]) + pub[22][1:]
    return [
        valid0,
        att([22, 23, 24], 4, sig=valid0[2]),                 # wrong signature
        att([25, 26, 27], 5, signers=[25, 26, 28]),          # wrong participants
        ([[], []], [msgs[6], msgs[7]], gt.compress_g2(None), DOMAIN),  # empty
        inf_agg,                                             # infinity aggregate
        ([[pub[22], no_c, pub[23]], []], [msgs[4], msgs[5]], valid0[2], DOMAIN),
        att([11, 12, 13], 0, sig=b"\xff" * 96),              # bad signature
        att([11, 12, 13], 0, sig=valid0[2][:95]),            # short signature
        ([[pub[11], pub[12][:47]], []], [msgs[0], msgs[1]], valid0[2], DOMAIN),
        ([[pub[11]], []], [msgs[0]], valid0[2], DOMAIN),     # length mismatch
        valid1,
    ]


@pytest.mark.parametrize("route", ["oracle", "torch"])
def test_indexed_block_matches_python_backend(route, indexed_items, backends,
                                              monkeypatch):
    """The oracle's verdicts and TorchBackend's are each INDEXED_VERDICTS,
    so they equal one another (one route a case, side by side); the
    torch route's staging decides the malformed and empty items and
    sends exactly the five others to the pairing."""
    py, tb = backends
    items = indexed_items
    if route == "oracle":
        assert [_oracle_indexed(py, it) for it in items] == INDEXED_VERDICTS
        return
    staged = []
    stage = tb.stage_indexed_batch

    def recording(batch_items):
        staged.append(stage(batch_items))
        return staged[-1]

    monkeypatch.setattr(tb, "stage_indexed_batch", recording)
    assert tb.verify_indexed_batch(items) == INDEXED_VERDICTS
    [(results, groups)] = staged          # the staging the verify used
    assert [i for i, _ in groups] == [0, 1, 2, 4, 10]
    assert all(len(pairs) == 2 for _, pairs in groups)
    assert results[3] is True and results[5] is False


@pytest.fixture(scope="module")
def multiple_items():
    py = gt.PythonBackend()
    items = []
    for i, (k0, k1) in enumerate([(3, 4), (5, 6), (9, 10)]):
        msgs = [bytes([i + 1]) * 32, bytes([i + 7]) * 32]
        agg = py.aggregate_signatures(
            [py.sign(m, k, DOMAIN) for m, k in zip(msgs, (k0, k1))])
        if i == 1:
            msgs = msgs[::-1]
        items.append(([gt.privtopub(k0), gt.privtopub(k1)], msgs, agg, DOMAIN))
    items.append((items[0][0], items[0][1], b"\x00" * 96, DOMAIN))   # garbage
    items.append((items[0][0], items[0][1][:1], items[0][2], DOMAIN))  # lengths
    return items


@pytest.mark.parametrize("route", ["oracle", "torch"])
def test_verify_and_verify_multiple_batch_match_python_backend(route, multiple_items,
                                                               backends):
    """verify_multiple over the batch: each route's verdicts are the fixed
    ones, so the routes agree; the torch route also verifies one single
    signature."""
    py, tb = backends
    if route == "oracle":
        got = [py.verify_multiple(*it) for it in multiple_items]
    else:
        got = tb.verify_multiple_batch(multiple_items)
        msg = b"\x77" * 32
        assert tb.verify(gt.privtopub(123), msg, py.sign(msg, 123, DOMAIN), DOMAIN)
    assert got == [True, False, True, False, False]


@pytest.mark.parametrize("part", ["aggregation", "signing"])
def test_aggregation_and_signing_bytes_match_python_backend(part, backends):
    py, tb = backends
    pubs = [gt.privtopub(k) for k in (1, 2, 3, 0xDEADBEEF)]
    if part == "aggregation":
        inf = gt.compress_g1(None)
        assert tb.aggregate_pubkeys(pubs[:3] + [inf]) == py.aggregate_pubkeys(pubs[:3] + [inf])
        assert tb.aggregate_pubkeys([]) == py.aggregate_pubkeys([])
        with pytest.raises(AssertionError):
            tb.aggregate_pubkeys(pubs[:2] + [bytes([pubs[2][0] & 0x7F]) + pubs[2][1:]])
        msg = b"\x33" * 32
        sigs = [py.sign(msg, k, DOMAIN) for k in (1, 2, 3)]
        assert tb.aggregate_signatures(sigs) == py.aggregate_signatures(sigs)
        return
    msg = b"\x33" * 32
    assert tb.sign(msg, 0xDEADBEEF, DOMAIN) == py.sign(msg, 0xDEADBEEF, DOMAIN)
    assert tb.privtopub(0xDEADBEEF) == pubs[3]
    assert tb.sign(msg, gt.r, DOMAIN) == gt.compress_g2(None)


def test_hash_to_g2_batch_matches_oracle():
    reqs = [(b"\x01" * 32, 0), (b"\x01" * 32, 7)]
    got = BT.hash_to_g2_batch(reqs, "cpu")
    want = [gt.hash_to_g2(mh, d) for mh, d in reqs]
    assert [(x.c0, x.c1, y.c0, y.c1) for x, y in got] == \
        [(x.c0, x.c1, y.c0, y.c1) for x, y in want]
    assert BT.hash_to_g2_batch([], "cpu") == []
    # the port's host copy hashes the same way
    for (mh, d), (x, y) in zip(reqs, want):
        px, py_ = pgt.hash_to_g2(mh, d)
        assert (px.c0, px.c1, py_.c0, py_.c1) == (x.c0, x.c1, y.c0, y.c1)
