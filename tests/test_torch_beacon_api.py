"""The port's beacon-node API (consensus_specs_tpu_torch.api) against the
JAX package's, on the CPU: the 16 scenarios of tests/test_beacon_api.py,
each through both APIs over the same state (built with the JAX
package's factories, minimal preset, carried across as SSZ bytes), BLS
off as there. Duties, produced blocks (their roots), produced
attestations, published state roots and every error status must be the
same. The one deliberate difference: the port's degradation ladder is
full, then single_device (no kernel-swapping rungs)."""
import pytest
import torch

from consensus_specs_tpu import resilience as JR
from consensus_specs_tpu import streaming as JS
from consensus_specs_tpu.api import ApiError as JApiError
from consensus_specs_tpu.api import BeaconNodeAPI as JAPI
from consensus_specs_tpu.api import SyncingStatus as JSync
from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.models import phase0 as JP
from consensus_specs_tpu.testing import factories as f
from consensus_specs_tpu.testing.keys import pubkeys
from consensus_specs_tpu.utils.ssz import impl as JI
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch import resilience as PR
from consensus_specs_tpu_torch import streaming as PS
from consensus_specs_tpu_torch.api import ApiError as PApiError
from consensus_specs_tpu_torch.api import BeaconNodeAPI as PAPI
from consensus_specs_tpu_torch.api import SyncingStatus as PSync
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.models import phase0 as PP
from consensus_specs_tpu_torch.utils.ssz import impl as PIm

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

J = JP.get_spec("minimal")


@pytest.fixture(scope="module")
def P():
    return PP.get_spec("minimal", device="cpu")


@pytest.fixture(autouse=True)
def _bls_off():
    old = JBLS.bls_active, PBLS.bls_active
    JBLS.bls_active = PBLS.bls_active = False
    prev = JS.activate(None), PS.activate(None)
    yield
    JBLS.bls_active, PBLS.bls_active = old
    JS.activate(prev[0])
    PS.activate(prev[1])


@pytest.fixture(scope="module")
def head_bytes():
    state = f.seed_genesis_state(J, J.SLOTS_PER_EPOCH * 8)
    f.advance_slots(J, state, 3)
    return JI.serialize(state, J.BeaconState)


@pytest.fixture()
def apis(P, head_bytes):
    """(reference API, port API) over the same head state."""
    return (JAPI(J, JI.deserialize(head_bytes, J.BeaconState)),
            PAPI(P, convert.state_from_bytes(P, head_bytes), device="cpu"))


def _status(call):
    try:
        call()
    except (JApiError, PApiError) as err:
        return err.status
    return None


def _duty(d):
    return (d.validator_pubkey, d.attestation_slot, d.attestation_shard,
            d.committee, d.validator_index, d.block_proposal_slot)


def _port_block(P, jblock):
    return PIm.deserialize(JI.serialize(jblock, J.BeaconBlock), P.BeaconBlock)


def _root(api):
    spec = api.spec
    return bytes(spec.hash_tree_root(api.state))


def test_node_endpoints(apis):
    j, p = apis
    assert p.get_version() == j.get_version()
    assert p.get_genesis_time() == j.get_genesis_time()
    assert p.get_syncing() == PSync(**vars(j.get_syncing()))
    (jf, jc), (pf, pc) = j.get_fork(), p.get_fork()
    assert PIm.serialize(pf, type(pf)) == JI.serialize(jf, type(jf)) and pc == jc == 0


def test_duties_for_known_pubkeys(apis):
    j, p = apis
    keys = [pubkeys[i] for i in range(4)]
    assert [_duty(d) for d in p.get_validator_duties(keys)] == \
        [_duty(d) for d in j.get_validator_duties(keys)]


def test_duties_unknown_pubkey_404(apis):
    assert [_status(lambda a=a: a.get_validator_duties([b"\xfe" * 48]))
            for a in apis] == [404, 404]


def test_duties_far_epoch_406(apis):
    assert [_status(lambda a=a: a.get_validator_duties([pubkeys[0]], epoch=99))
            for a in apis] == [406, 406]


def test_produce_sign_publish_block(apis, P):
    j, p = apis
    slot = int(j.state.slot) + 1
    jblock = j.produce_block(slot, randao_reveal=b"\x00" * 96)
    pblock = p.produce_block(slot, randao_reveal=b"\x00" * 96)
    assert PIm.hash_tree_root(pblock) == JI.hash_tree_root(jblock)
    f.sign_proposal(J, j.state, jblock, f.proposer_of(J, j.state, slot))
    j.publish_block(jblock)
    p.publish_block(_port_block(P, jblock))
    assert int(p.state.slot) == int(j.state.slot) == slot
    assert _root(p) == bytes(JI.hash_tree_root(j.state))
    assert len(p.published_blocks) == len(j.published_blocks) == 1


def test_publish_invalid_block_400(apis, P):
    j, p = apis
    jblock = j.produce_block(int(j.state.slot) + 1, randao_reveal=b"\x00" * 96)
    jblock.state_root = b"\x13" * 32
    head = _root(p)
    assert [_status(lambda: j.publish_block(jblock)),
            _status(lambda: p.publish_block(_port_block(P, jblock)))] == [400, 400]
    assert p.published_blocks == j.published_blocks == [] and _root(p) == head


def test_produce_block_into_past_400(apis):
    assert [_status(lambda a=a: a.produce_block(0, randao_reveal=b"\x00" * 96))
            for a in apis] == [400, 400]


def _past_duty(api):
    for i in range(16):
        duty = api.get_validator_duties([pubkeys[i]])[0]
        if duty.attestation_slot <= int(api.state.slot):
            return i, duty
    pytest.skip("no past-duty validator in window")


def test_attestation_cycle(apis):
    j, p = apis
    i, duty = _past_duty(j)
    assert _duty(_past_duty(p)[1]) == _duty(duty)
    jatt = j.produce_attestation(pubkeys[i], duty.attestation_slot, duty.attestation_shard)
    patt = p.produce_attestation(pubkeys[i], duty.attestation_slot, duty.attestation_shard)
    assert PIm.serialize(patt, p.spec.Attestation) == JI.serialize(jatt, J.Attestation)
    j.publish_attestation(jatt)
    p.publish_attestation(patt)
    assert p.published_attestations == [patt] and j.published_attestations == [jatt]


def test_attestation_wrong_shard_400(apis):
    j, _ = apis
    duty = j.get_validator_duties([pubkeys[0]])[0]
    wrong = (duty.attestation_shard + 1) % J.SHARD_COUNT
    assert [_status(lambda a=a: a.produce_attestation(pubkeys[0], duty.attestation_slot,
                                                      wrong)) for a in apis] == [400, 400]


def test_syncing_node_returns_503(P, head_bytes):
    j = JAPI(J, JI.deserialize(head_bytes, J.BeaconState),
             syncing=JSync(is_syncing=True, highest_slot=99))
    p = PAPI(P, convert.state_from_bytes(P, head_bytes),
             syncing=PSync(is_syncing=True, highest_slot=99), device="cpu")
    for api in (j, p):
        assert [_status(call) for call in (
            lambda: api.get_validator_duties([pubkeys[0]]),
            lambda: api.produce_block(1, b"\x00" * 96),
            lambda: api.publish_attestation(None))] == [503, 503, 503]
        assert api.get_syncing().is_syncing is True and api.get_version()
        assert "status" in api.get_healthz() and api.get_metrics() is not None
    assert set(p.get_healthz()) == set(j.get_healthz())


def test_healthz_reflects_degradation(apis):
    """Both step to rung 1: the reference's first kernel-swapping rung,
    the port's single_device (it has no kernel-swapping rungs)."""
    j, p = apis
    jsnap, psnap = j.get_healthz(), p.get_healthz()
    assert set(psnap) == set(jsnap) and set(psnap["counters"]) == set(jsnap["counters"])
    assert psnap["rung"] == {"index": 0, "name": "full", "of": ["full", "single_device"]}
    assert PR.ladder().degrade("test") == "single_device"
    JR.ladder().degrade("test")
    try:
        assert j.get_healthz()["status"] == "degraded"
        assert p.get_healthz()["status"] == "degraded"
        assert p.get_healthz()["rung"] == {"index": 1, "name": "single_device",
                                           "of": ["full", "single_device"]}
    finally:
        JR.ladder().reset()
        PR.ladder().reset()


def test_healthz_firehose_section(apis):
    j, p = apis
    idle = [api.get_healthz()["firehose"] for api in (j, p)]
    assert set(idle[1]) == set(idle[0])
    assert [(h["backlog"], h["last_flush_age_s"]) for h in idle] == [(0, None)] * 2
    jv = JS.StreamingVerifier(target_groups=8, register=True)
    pv = PS.StreamingVerifier(target_groups=8, register=True, device="cpu")
    live = [api.get_healthz()["firehose"] for api in (j, p)]
    assert set(live[1]) == set(live[0])
    assert set(live[1]["counters"]) == set(live[0]["counters"])
    assert [(h["target_groups"], h["in_flight_batches"], h["backlog"]) for h in live] == \
        [(8, 0, 0), (8, 0, 0)]
    assert pv.queue.depth == jv.queue.depth == 0


def test_metrics_expose_firehose_instruments(apis):
    j, p = apis
    PS.StreamingVerifier(target_groups=8, register=True, device="cpu")
    p.get_healthz()
    text = p.get_metrics()
    for name in ("cstpu_firehose_queue_depth", "cstpu_firehose_deadline_miss_total",
                 "cstpu_firehose_ingested_total", "cstpu_resilience_retries_total"):
        assert name in text
    assert p.get_trace() is not None


def test_duty_proposal_slot_covers_future_slots(apis):
    j, p = apis
    n = len(j.state.validator_registry)
    keys = [pubkeys[i] for i in range(n)]
    pd = [_duty(d) for d in p.get_validator_duties(keys)]
    assert pd == [_duty(d) for d in j.get_validator_duties(keys)]
    slots = sorted(d[5] for d in pd if d[5] is not None)
    last = J.get_epoch_start_slot(J.get_current_epoch(j.state)) + J.SLOTS_PER_EPOCH - 1
    assert slots and all(int(j.state.slot) <= s <= last for s in slots)
    assert len(set(slots)) == len(slots) and int(j.state.slot) in slots


def test_publish_malformed_block_maps_to_400(apis, P):
    j, p = apis
    jblock = j.produce_block(int(j.state.slot) + 1, b"\x00" * 96)
    pblock = _port_block(P, jblock)
    jblock.slot = pblock.slot = None
    assert [_status(lambda: j.publish_block(jblock)),
            _status(lambda: p.publish_block(pblock))] == [400, 400]


def test_attestation_poc_bit_sets_custody_bit(apis):
    j, p = apis
    i, duty = _past_duty(j)
    for bit in (1, 0):
        atts = [api.produce_attestation(pubkeys[i], duty.attestation_slot,
                                        duty.attestation_shard, poc_bit=bit) for api in apis]
        assert bytes(atts[1].custody_bitfield) == bytes(atts[0].custody_bitfield)
    position = duty.committee.index(duty.validator_index)
    assert atts[1].custody_bitfield == bytes(len(atts[1].custody_bitfield))
    one = p.produce_attestation(pubkeys[i], duty.attestation_slot, duty.attestation_shard,
                                poc_bit=1)
    assert one.custody_bitfield[position // 8] & (1 << (position % 8))


def test_api_defaults_to_the_card(P, head_bytes):
    state = convert.state_from_bytes(P, head_bytes)
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            PAPI(P, state)              # a CPU spec under the card's API
        return
    with pytest.raises(RuntimeError):
        PAPI(P, state)
