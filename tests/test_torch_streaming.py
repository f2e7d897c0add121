"""The port's attestation firehose (consensus_specs_tpu_torch.streaming,
networking.gossip and the block path's streaming hook) on the CPU.

  * Verdicts: items at G <= 4 groups per batch and P in {2, 3} pairs per
    group go through the StreamingVerifier on the plain route; the
    verdicts equal the bignum oracle's (the JAX package's PythonBackend)
    and TorchBackend("cpu").verify_indexed_batch's, bit for bit.
  * Bookkeeping (bucket order, padded G, ring offsets, ring wraps, the
    capacity error, partial flushes, dedup, cache hits, retention): the
    same push / take / dispatch sequence through the port and through the
    JAX package's VerificationQueue and FirehosePipeline, both with the
    grouped pairing replaced by the same cheap stand-in, gives the same
    verdict maps and counters. No JAX pairing program is compiled.
  * Deadline salvage on a fake clock, as the JAX package's tests do.
  * Gossip -> block, minimal preset, 3 attestations: published through the
    port's GossipRouter, verified by the firehose, then served from its
    cache to the block's batched attestation family (3 cache hits, no new
    launch); the post-state root equals the JAX package's state_transition
    of the same block and state, carried across as SSZ bytes, with BLS
    off on the JAX side."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu import streaming as JS
from consensus_specs_tpu import telemetry as JT
from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.crypto import bls12_381 as gt
from consensus_specs_tpu.ops import bls_jax as BJ
from consensus_specs_tpu.utils.ssz import impl as JI
from consensus_specs_tpu_torch import streaming as PS
from consensus_specs_tpu_torch import telemetry as PT
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.crypto import bls12_381 as pgt
from consensus_specs_tpu_torch.networking.gossip import (GossipRouter,
                                                         TOPIC_BEACON_ATTESTATION)
from consensus_specs_tpu_torch.ops import bls_torch as BT
from consensus_specs_tpu_torch.ops import fq as F
from consensus_specs_tpu_torch.utils.ssz import impl as PI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

DOMAIN = 1
COUNTERS = ("launches", "groups_launched", "ring_wraps", "partial_flushes",
            "duplicates", "ingested", "enqueued", "groups_verified",
            "deadline_miss", "cache_hits", "undecodable")


@pytest.fixture(autouse=True)
def _no_global_verifier():
    prev_j, prev_p = JS.activate(None), PS.activate(None)
    yield
    JS.activate(prev_j)
    PS.activate(prev_p)


def _counts(T):
    out = {n: T.counter(f"firehose.{n}", always=True).value for n in COUNTERS}
    for n in ("deadline_misses", "deadline_salvaged"):
        out[n] = T.counter(f"resilience.{n}", always=True).value
    return out


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def _verifier(S, **kw):
    """A verifier of either package, not registered; the port's on the
    CPU (its default device is the card)."""
    kw.setdefault("register", False)
    if S is PS and "backend" not in kw:
        kw["device"] = "cpu"
    return S.StreamingVerifier(**kw)


# ---------------------------------------------------------------------------
# Staging helpers == the reference's
# ---------------------------------------------------------------------------

def test_stage_example_groups_and_padding_match_reference():
    g1, g2 = BT.stage_example_groups(2, n_distinct=2)
    j1, j2 = BJ.stage_example_groups(2, n_distinct=2)
    assert (g1 == j1).all() and (g2 == j2).all()
    t1, t2 = BT.stage_example_groups(5, n_distinct=2)
    assert t1.shape == (5, 3, 2, F.L) and (t1[4] == g1[0]).all()
    assert (t2[3] == g2[1]).all()
    stacks = [(t1[k], t2[k]) for k in range(3)]
    for got, want in zip(BT.stage_group_arrays(stacks, 3),
                         BJ.stage_group_arrays(stacks, 3)):
        assert got.shape[0] == 4 and (got == want).all()


# ---------------------------------------------------------------------------
# Verdicts on the plain route == the oracle and the synchronous path
# ---------------------------------------------------------------------------

def _sig_sum(*sigs):
    pt = None
    for s in sigs:
        pt = pgt.ec_add(pt, pgt.decompress_g2(s))
    return pgt.compress_g2(pt)


def _oracle_indexed(py, item):
    """verify_multiple over the aggregates of the sets, False where the
    oracle raises (malformed pubkeys)."""
    sets, msgs, sig, domain = item
    try:
        aggs = [py.aggregate_pubkeys(s) for s in sets]
    except AssertionError:
        return False
    return py.verify_multiple(aggs, msgs, sig, domain)


VERDICTS = [True, True, False, False, True, False, True]


@pytest.fixture(scope="module")
def verdict_items():
    """Two groups of 3 pairs (both custody sets set) and two of 2 pairs,
    valid and not, a malformed pubkey, an empty product and a duplicate."""
    pub = {k: pgt.privtopub(k) for k in range(11, 19)}
    m = [bytes([0x50 + i]) * 32 for i in range(4)]
    # one member a set: one committee size, one G1 aggregation program
    p3_ok = ([[pub[11]], [pub[13]]], [m[0], m[1]],
             _sig_sum(pgt.sign(m[0], 11, DOMAIN),
                      pgt.sign(m[1], 13, DOMAIN)), DOMAIN)
    p3_bad = ([[pub[11]], [pub[12]]], [m[0], m[1]], p3_ok[2], DOMAIN)
    p2_ok = ([[pub[14]], []], [m[2], m[3]], pgt.sign(m[2], 14, DOMAIN), DOMAIN)
    p2_bad = ([[pub[16]], []], [m[2], m[3]], pgt.sign(m[2], 17, DOMAIN), DOMAIN)
    malformed = ([[pub[18][:47]], []], [m[0], m[1]], p2_ok[2], DOMAIN)
    empty = ([[], []], [m[0], m[1]], pgt.compress_g2(None), DOMAIN)
    return [p3_ok, p2_ok, malformed, p3_bad, empty, p2_bad, p2_ok]


@pytest.mark.parametrize("route", ["firehose", "verify_indexed_batch", "oracle"])
def test_streamed_verdicts_match_oracle_and_verify_indexed_batch(route, verdict_items):
    """The firehose's verdicts, the synchronous path's and the bignum
    oracle's are each VERDICTS, so they equal one another; one route a
    case, so the three run side by side. The firehose flushes two partial
    batches, G = 2 each."""
    items = verdict_items
    tb = BT.TorchBackend("cpu")
    if route == "firehose":
        v = _verifier(PS, backend=tb, target_groups=4)
        before = _counts(PT)
        got = v.verdicts_for(items)
        d = _delta(before, _counts(PT))
        assert d["launches"] == 2 and d["partial_flushes"] == 2
        assert d["duplicates"] == 1 and d["groups_launched"] == 4
        assert list(v.pipeline.occupancies) == [2, 2]
    elif route == "verify_indexed_batch":
        got = tb.verify_indexed_batch(items)
    else:
        py = gt.PythonBackend()
        got = [_oracle_indexed(py, it) for it in items[:-1]]
        got.append(got[1])                  # the duplicate of item 1
    assert got == VERDICTS


# ---------------------------------------------------------------------------
# Bookkeeping == the reference's, with a stand-in pairing
# ---------------------------------------------------------------------------

def _fake_group(key, count):
    """Limb arrays of one group whose stand-in verdict is key % 3 != 0."""
    return [(np.full((2, F.L), key, np.int64),
             np.full((2, 2, F.L), key, np.int64)) for _ in range(count)]


@pytest.fixture
def stand_in(monkeypatch):
    """Both packages' grouped pairing replaced by one cheap function of
    the first limb: a group passes iff its key is not a multiple of 3."""
    import jax.numpy as jnp

    def jax_check(g1, g2):
        return jnp.asarray(np.asarray(g1)[:, 0, 0, 0] % 3 != 0)

    def torch_check(g1, g2):
        return g1[:, 0, 0, 0] % 3 != 0

    monkeypatch.setattr(BJ, "grouped_pairing_check", jax_check)
    monkeypatch.setattr(BT, "grouped_pairing_check", torch_check)


def _drive_bookkeeping(S):
    """One push / pump / flush sequence; returns what it observed."""
    v = _verifier(S, target_groups=2, ring_capacity=4)
    seen = []
    for key in (1, 2, 3):                        # slot N: P = 3 and P = 2
        v.submit_staged(("a", key), _fake_group(key, 3))
    v.submit_staged(("b", 4), _fake_group(4, 2))
    v.submit_staged(("a", 1), _fake_group(1, 3))  # duplicate key
    seen.append(sorted(v.queue.bucket_depths().items()))
    v.pump()                                       # one full P=3 batch
    seen.append((v.queue.depth, v.pipeline.launches,
                 v.pipeline._offset, list(v.pipeline.occupancies)))
    for key in (5, 6, 7, 9):                       # slot N+1
        v.submit_staged(("a", key), _fake_group(key, 3))
    v.submit_staged(("b", 8), _fake_group(8, 2))
    v.pump()                                       # P=2 full, P=3 wraps
    seen.append((v.queue.depth, v.pipeline.launches, v.pipeline._offset,
                 v.pipeline.in_flight, list(v.pipeline.occupancies)))
    got = v.flush()                                # partial P=3 remainder
    seen.append(sorted(got.items()))
    for k, ok in got.items():
        assert v.verdict(k) is ok
    seen.append(sorted(v.flush().items()))        # nothing in flight
    seen.append(list(v.pipeline.occupancies))
    return seen


def test_queue_pipeline_bookkeeping_matches_reference(stand_in):
    j0 = _counts(JT)
    want = _drive_bookkeeping(JS)
    jd = _delta(j0, _counts(JT))
    p0 = _counts(PT)
    got = _drive_bookkeeping(PS)
    pd = _delta(p0, _counts(PT))
    assert got == want
    assert pd == jd
    assert pd["ring_wraps"] == 2 and pd["partial_flushes"] == 1
    assert dict(got[3])[("a", 3)] is False and dict(got[3])[("a", 1)] is True
    assert PT.gauge("firehose.queue_depth", always=True).value == 0


def test_injected_raise_on_the_batch_key_is_retried(stand_in):
    """The pipeline's launch goes through guarded_dispatch, so fault
    injection reaches it with no code of its own: a raise on the first
    batch is retried before the pairing runs, and the drive observes what
    the unfaulted drive observed, in both packages."""
    from consensus_specs_tpu.resilience import faults as JF
    from consensus_specs_tpu_torch.resilience import faults as PF
    clean = _drive_bookkeeping(PS)
    seen = []
    for S, T, faults in ((JS, JT, JF), (PS, PT, PF)):
        retries0 = T.counter("resilience.retries", always=True).value
        faults.set_schedule("dispatch:*firehose.batch*@1=raise")
        try:
            seen.append(_drive_bookkeeping(S))
        finally:
            faults.set_schedule(None)
        assert T.counter("resilience.retries", always=True).value - retries0 == 1
    assert seen[1] == seen[0] == clean


def test_queue_fifo_and_bucket_order_match_reference():
    qs = [JS.VerificationQueue(3), PS.VerificationQueue(3)]
    out = []
    for q in qs:
        for key, count in [(1, 3), (2, 1), (3, 3), (4, 3), (5, 1), (6, 3),
                           (7, 2), (8, 3)]:
            q.push(key, _fake_group(key, count))
        full = q.take_batches()
        rest = q.take_batches(partial=True)
        out.append([(c, [m[0] for m in ms]) for c, ms in full + rest])
        assert q.depth == 0 and q.bucket_depths() == {}
    assert out[0] == out[1] == [(3, [1, 3, 4]), (1, [2, 5]), (2, [7]),
                                (3, [6, 8])]


def test_capacity_error_and_misconfiguration_match_reference(stand_in):
    for S in (JS, PS):
        pipe = (S.FirehosePipeline(ring_capacity=2) if S is JS else
                S.FirehosePipeline(device="cpu", ring_capacity=2))
        with pytest.raises(ValueError, match="pads to 4 groups"):
            pipe.dispatch(3, [(k, *map(np.stack, zip(*_fake_group(k, 3))))
                              for k in (1, 2, 3)])
        with pytest.raises(AssertionError):
            _verifier(S, target_groups=128, ring_capacity=64)


def test_deadline_salvage_on_fake_clock_matches_reference(stand_in):
    """Every clock read advances 100 ms against a 5 ms budget: the flush
    misses, and the late verdicts are salvaged, not raised."""
    def clock_steps():
        t = [0.0]

        def clock():
            t[0] += 0.1
            return t[0]
        return clock

    deltas = []
    for S, T in ((JS, JT), (PS, PT)):
        v = _verifier(S, target_groups=8, clock=clock_steps(),
                      sleep=lambda s: None)
        v.submit_staged("late", _fake_group(4, 3))
        before = _counts(T)
        assert v.flush(deadline_ms=5.0) == {"late": True}
        assert v.verdict("late") is True
        assert list(v.pipeline.occupancies) == [1]
        deltas.append(_delta(before, _counts(T)))
        ok = _verifier(S, target_groups=2)
        ok.submit_staged("a", _fake_group(1, 3))
        before = _counts(T)
        assert ok.flush(deadline_ms=120_000.0) == {"a": True}
        assert _delta(before, _counts(T))["deadline_miss"] == 0
    assert deltas[0] == deltas[1]
    assert deltas[1]["deadline_miss"] == deltas[1]["deadline_salvaged"] == 1


def test_cache_hits_dedup_and_retention_match_reference():
    item = ([[b"\x01" * 48]], [b"\x02" * 32], b"\x03" * 96, DOMAIN)
    deltas = []
    for S, T in ((JS, JT), (PS, PT)):
        v = _verifier(S, target_groups=2, retain=4096)
        before = _counts(T)
        d = v.submit_indexed(*item)
        assert d == S.verifier.item_digest(*item)
        assert v.submit_indexed(*item) == d                # duplicate
        v._remember(d, True)
        v.submit_indexed(*item)                            # cache hit
        assert v.verdicts_for([item]) == [True]            # served, no staging
        deltas.append(_delta(before, _counts(T)))
        for i in range(v.retain + 10):
            v._seen.add(i)
            v._remember(i, True)
        assert len(v._verdicts) == len(v._seen) == v.retain
        assert v.verdict(0) is None and v.verdict(v.retain + 9) is True
    assert deltas[0] == deltas[1]
    assert deltas[1]["cache_hits"] == 2 and deltas[1]["duplicates"] == 1


def test_steady_state_zero_watchdog_events_and_fixed_ring(stand_in):
    v = _verifier(PS, target_groups=2)
    ptr = v.pipeline.ring.data_ptr()
    retrace0 = PT.counter("watchdog.retrace_events").value
    relayout0 = PT.counter("watchdog.relayout_events").value
    for wave in range(5):
        for k in range(2):
            v.submit_staged((wave, k), _fake_group(3 * wave + k + 1, 3))
        v.pump()
        if wave % 2:
            assert all(v.flush().values())
    v.flush()
    assert v.pipeline.launches == 5
    assert PT.counter("watchdog.retrace_events").value == retrace0
    assert PT.counter("watchdog.relayout_events").value == relayout0
    assert v.pipeline.ring.data_ptr() == ptr


def test_health_and_device_default():
    v = PS.StreamingVerifier(target_groups=8, device="cpu")   # registers
    try:
        assert PS.active() is v
        v.submit_staged("h0", _fake_group(1, 3))
        health = PS.firehose_health()
        assert health["backlog"] == 1 and health["last_flush_age_s"] is None
        assert health["target_groups"] == 8
    finally:
        PS.activate(None)
    assert PS.firehose_health()["in_flight_batches"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PS.StreamingVerifier(register=False)
        with pytest.raises(RuntimeError):
            PS.FirehosePipeline()


# ---------------------------------------------------------------------------
# Gossip -> firehose -> block path
# ---------------------------------------------------------------------------

class _SingleVerifiesOnTheOracle:
    """A TorchBackend whose single verifies run on the bignum oracle: the
    batched route (and with it the firehose's verdict cache) stays the
    TorchBackend's."""

    def __init__(self, tb):
        self.tb, self.oracle = tb, pgt.PythonBackend()

    def verify(self, *args):
        return self.oracle.verify(*args)

    def __getattr__(self, name):
        return getattr(self.tb, name)


def test_gossip_preverification_feeds_block_path(monkeypatch):
    import bench
    from consensus_specs_tpu.models import phase0 as JP
    from consensus_specs_tpu_torch.models import phase0 as PP

    jspec = JP.get_spec("minimal")
    pspec = PP.get_spec("minimal", device="cpu")
    monkeypatch.setattr(JBLS, "bls_active", True)
    monkeypatch.setattr(JBLS, "_active_backend_name", "python")  # the signer
    jstate, jblock = bench.build_config3_state_and_block(
        jspec, 8 * jspec.SLOTS_PER_EPOCH, 3, n_keys=8)
    state = PI.deserialize(JI.serialize(jstate, jspec.BeaconState),
                           pspec.BeaconState)
    block = PI.deserialize(JI.serialize(jblock, jspec.BeaconBlock),
                           pspec.BeaconBlock)
    monkeypatch.setattr(JBLS, "bls_active", False)
    jspec.state_transition(jstate, jblock)

    tb = BT.TorchBackend("cpu")
    monkeypatch.setattr(PBLS, "bls_active", True)
    # the attestations verify in the firehose on the CPU TorchBackend; the
    # block's proposer and randao signatures, which this test does not
    # study, on the port's bignum oracle (about 1 s a verify against about
    # 6 s on a CPU TorchBackend)
    spec_backend = _SingleVerifiesOnTheOracle(tb)
    monkeypatch.setitem(PBLS._backends, "torch_cpu", lambda: spec_backend)
    monkeypatch.setitem(PBLS._backend_cache, "torch_cpu", spec_backend)
    monkeypatch.setattr(PBLS, "_active_backend_name", "torch_cpu")
    monkeypatch.setattr(pspec, "_streaming_verifier", None)
    v = _verifier(PS, backend=tb, target_groups=4)
    router = GossipRouter()
    router.subscribe("verifier", TOPIC_BEACON_ATTESTATION,
                     lambda _topic, payload:
                     v.ingest_gossip(pspec, state, payload))
    atts = list(block.body.attestations)
    swapped = PI.deserialize(PI.serialize(atts[0], pspec.Attestation),
                             pspec.Attestation)
    swapped.signature = atts[1].signature
    for att in atts + [swapped]:
        payload = PI.serialize(att, pspec.Attestation)
        assert router.publish("peer", TOPIC_BEACON_ATTESTATION, payload) == 1
        # a duplicate publish dedups in the router's seen-cache
        assert router.publish("peer2", TOPIC_BEACON_ATTESTATION, payload) == 0
    before = _counts(PT)
    assert v.ingest_gossip(pspec, state, b"\x00\x01garbage") is None
    v.pump()
    got = v.flush()
    assert sorted(got.values()) == [False, True, True, True]
    assert v.pipeline.launches == 1                # one partial batch, G = 4

    pspec._streaming_verifier = v
    pspec.state_transition(state, block)
    d = _delta(before, _counts(PT))
    assert d["cache_hits"] == 3 and d["undecodable"] == 1
    assert v.pipeline.launches == 1                # no new device batch
    assert PI.hash_tree_root(state) == JI.hash_tree_root(jstate)
