"""The port's phase 1 (consensus_specs_tpu_torch/models/phase1/: custody
game, shard chains, Phase1Spec) held bit-identical to the JAX package's on
the CPU: every scenario of tests/test_phase1.py, with the state built by
the JAX package's testing factories and carried across as SSZ bytes, the
same operation applied on both sides, and the serialized states (or the
rejection) compared. The device epoch with the phase-1 insert hooks
(process_epoch_soa -> process_epoch_soa_staged) must equal
Phase1Spec.process_epoch on both packages. Minimal preset, BLS off except
the two signature cases, which verify a custody key reveal through the
port's spec.bls on TorchBackend("cpu")."""
from copy import deepcopy

import pytest

from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.models import phase1 as J1
from consensus_specs_tpu.models.phase0.epoch_soa import \
    process_epoch_soa as j_process_epoch_soa
from consensus_specs_tpu.testing import factories as f
from consensus_specs_tpu.testing.cases.finality import attested_epoch
from consensus_specs_tpu.utils.merkle import (calc_merkle_tree_from_leaves,
                                              get_merkle_proof)
from consensus_specs_tpu.utils.ssz.impl import hash_tree_root, serialize
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.crypto import bls12_381 as bls_host
from consensus_specs_tpu_torch.models import phase0 as P0
from consensus_specs_tpu_torch.models import phase1 as P1
from consensus_specs_tpu_torch.models.phase0.epoch_soa import process_epoch_soa
from consensus_specs_tpu_torch.ops.bls_torch import TorchBackend
from consensus_specs_tpu_torch.utils.ssz import impl as PI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def specs():
    return J1.get_spec("minimal"), P1.get_spec("minimal", device="cpu")


@pytest.fixture(autouse=True)
def _bls_off():
    old = JBLS.bls_active, PBLS.bls_active
    JBLS.bls_active = PBLS.bls_active = False
    yield
    JBLS.bls_active, PBLS.bls_active = old


@pytest.fixture()
def state(specs):
    j, _ = specs
    return f.seed_genesis_state(j, j.SLOTS_PER_EPOCH * 8)


def _port(specs, state):
    j, p = specs
    return convert.state_from_bytes(p, serialize(state, j.BeaconState))


def _op(specs, obj):
    """A JAX package container -> the port's container of the same name."""
    _, p = specs
    return PI.deserialize(serialize(obj, type(obj)), getattr(p, type(obj).__name__))


def _same(specs, jstate, pstate):
    j, p = specs
    assert PI.serialize(pstate, p.BeaconState) == serialize(jstate, j.BeaconState)


def _both(specs, jstate, pstate, name, *objs, raises=False):
    """Apply spec function `name` to both states (each side its own copy
    of the operations); the states must stay byte-identical, and a
    rejection must be one on both sides."""
    j, p = specs
    pobjs = [_op(specs, o) for o in objs]
    if raises:
        with pytest.raises(AssertionError):
            getattr(j, name)(jstate, *objs)
        with pytest.raises(AssertionError):
            getattr(p, name)(pstate, *pobjs)
    else:
        getattr(j, name)(jstate, *objs)
        getattr(p, name)(pstate, *pobjs)
    _same(specs, jstate, pstate)


# ---------------------------------------------------------------------------
# Containers and the spec object
# ---------------------------------------------------------------------------

def test_appended_fields_preserve_phase0_prefix(specs):
    j, p = specs
    p0 = P0.get_spec("minimal", device="cpu")
    for name in ("Validator", "BeaconState", "BeaconBlockBody"):
        p0_fields = [fname for fname, _ in getattr(p0, name).get_fields()]
        p1_fields = [fname for fname, _ in getattr(p, name).get_fields()]
        assert p1_fields[:len(p0_fields)] == p0_fields, name
        assert len(p1_fields) > len(p0_fields), name
        assert p1_fields == [fname for fname, _ in getattr(j, name).get_fields()]
    assert dict(p.BeaconState.get_fields())["validator_registry"].elem_type is p.Validator
    assert sorted(p.container_types) == sorted(j.container_types)


def test_phase1_validator_fields(specs):
    _, p = specs
    v = p.Validator()
    assert v.next_custody_reveal_period == 0
    assert v.max_reveal_lateness == 0


def test_phase1_state_serializes_and_roots(specs, state):
    j, p = specs
    port = _port(specs, state)
    _same(specs, state, port)
    assert PI.hash_tree_root(port, p.BeaconState) == hash_tree_root(state, j.BeaconState)
    assert p.hash_tree_root(port) == j.hash_tree_root(state)


def test_spec_hooks_constants_and_device(specs):
    j, p = specs
    assert [fn.__name__ for fn in p._insert_after_registry_updates] == \
        [fn.__name__ for fn in j._insert_after_registry_updates]
    assert [fn.__name__ for fn in p._insert_after_final_updates] == \
        [fn.__name__ for fn in j._insert_after_final_updates]
    assert [(a, n, h.__name__) for a, n, h in p._extra_block_operations] == \
        [(a, n, h.__name__) for a, n, h in j._extra_block_operations]
    for key in ("EPOCHS_PER_CUSTODY_PERIOD", "CUSTODY_PERIOD_TO_RANDAO_PADDING",
                "EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS", "DOMAIN_SHARD_ATTESTER"):
        assert getattr(p, key) == getattr(j, key)
    assert P1.get_spec("minimal", device="cpu") is p
    assert p.device.type == "cpu"


def test_phase1_spec_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        assert P1.get_spec("minimal").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            P1.get_spec("minimal")


# ---------------------------------------------------------------------------
# Custody key reveals
# ---------------------------------------------------------------------------

def _mature(spec, state, periods=2):
    state.slot = spec.SLOTS_PER_EPOCH * spec.EPOCHS_PER_CUSTODY_PERIOD * periods
    return state


def test_custody_key_reveal_success(specs, state):
    j, _ = specs
    _mature(j, state)
    port = _port(specs, state)
    _both(specs, state, port, "process_custody_key_reveal",
          j.CustodyKeyReveal(revealer_index=3, reveal=b"\x11" * 96))
    assert port.validator_registry[3].next_custody_reveal_period == 1


def test_custody_key_reveal_not_yet_due(specs, state):
    j, _ = specs
    _both(specs, state, _port(specs, state), "process_custody_key_reveal",
          j.CustodyKeyReveal(revealer_index=3, reveal=b"\x11" * 96), raises=True)


def test_custody_key_reveal_in_block(specs, state):
    j, p = specs
    _mature(j, state)
    port = _port(specs, state)
    block = f.empty_block_next(j, state)
    block.body.custody_key_reveals.append(
        j.CustodyKeyReveal(revealer_index=5, reveal=b"\x22" * 96))
    pblock = convert.block_from_bytes(p, serialize(block, j.BeaconBlock))
    j.state_transition(state, block)
    p.state_transition(port, pblock)
    _same(specs, state, port)
    assert port.validator_registry[5].next_custody_reveal_period == 1


@pytest.mark.parametrize("signature", ["valid", "swapped"])
def test_custody_key_reveal_signature_on_the_port_backend(specs, state, monkeypatch, signature):
    """BLS on: the reveal's signature is verified through the port's
    spec.bls (TorchBackend on the CPU); a valid one transitions as the
    JAX package's run with BLS off, a swapped one (the next period's
    signature) is rejected."""
    j, p = specs
    _mature(j, state)
    port = _port(specs, state)
    index = 3
    period = port.validator_registry[index].next_custody_reveal_period
    epoch = p.get_randao_epoch_for_custody_period(period + (signature == "swapped"), index)
    reveal = bls_host.sign(p.hash_tree_root(epoch), index + 1,      # factories' key
                           p.get_domain(port, p.DOMAIN_RANDAO, message_epoch=epoch))
    tb = TorchBackend("cpu")
    monkeypatch.setitem(PBLS._backends, "torch_cpu", lambda: tb)
    monkeypatch.setitem(PBLS._backend_cache, "torch_cpu", tb)
    monkeypatch.setattr(PBLS, "_active_backend_name", "torch_cpu")
    PBLS.bls_active = True
    op = p.CustodyKeyReveal(revealer_index=index, reveal=reveal)
    if signature == "valid":
        p.process_custody_key_reveal(port, op)
        j.process_custody_key_reveal(state, j.CustodyKeyReveal(
            revealer_index=index, reveal=reveal))
        _same(specs, state, port)
    else:
        before = PI.serialize(port, p.BeaconState)
        with pytest.raises(AssertionError):
            p.process_custody_key_reveal(port, op)
        assert PI.serialize(port, p.BeaconState) == before


# ---------------------------------------------------------------------------
# Early derived secret reveals
# ---------------------------------------------------------------------------

def _edsr(spec, state, epoch_ahead, revealed_index=2, masker_index=9):
    return spec.EarlyDerivedSecretReveal(
        revealed_index=revealed_index,
        epoch=spec.get_current_epoch(state) + epoch_ahead,
        reveal=b"\x33" * 96, masker_index=masker_index, mask=b"\x44" * 32)


def test_early_reveal_inside_custody_window_slashes(specs, state):
    j, _ = specs
    port = _port(specs, state)
    reveal = _edsr(j, state, j.CUSTODY_PERIOD_TO_RANDAO_PADDING)
    _both(specs, state, port, "process_early_derived_secret_reveal", reveal)
    assert port.validator_registry[reveal.revealed_index].slashed


def test_early_reveal_outside_window_penalizes_only(specs, state):
    j, _ = specs
    port = _port(specs, state)
    reveal = _edsr(j, state, j.RANDAO_PENALTY_EPOCHS)
    pre = port.balances[reveal.revealed_index]
    _both(specs, state, port, "process_early_derived_secret_reveal", reveal)
    assert not port.validator_registry[reveal.revealed_index].slashed
    assert port.balances[reveal.revealed_index] < pre
    slot_index = reveal.epoch % j.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS
    assert reveal.revealed_index in list(port.exposed_derived_secrets[slot_index])


def test_early_reveal_duplicate_rejected(specs, state):
    j, _ = specs
    port = _port(specs, state)
    reveal = _edsr(j, state, j.RANDAO_PENALTY_EPOCHS)
    _both(specs, state, port, "process_early_derived_secret_reveal", reveal)
    _both(specs, state, port, "process_early_derived_secret_reveal", deepcopy(reveal),
          raises=True)


def test_early_reveal_too_late_rejected(specs, state):
    j, _ = specs
    _both(specs, state, _port(specs, state), "process_early_derived_secret_reveal",
          _edsr(j, state, 0), raises=True)


# ---------------------------------------------------------------------------
# Chunk challenges, responses, bit challenges
# ---------------------------------------------------------------------------

def _challengeable_attestation(spec, state, chunk_count, data_root):
    f.advance_epoch(spec, state)
    f.transition_with_empty_block(spec, state)
    att = f.new_attestation(spec, state)
    att.data.crosslink.data_root = data_root
    if chunk_count:
        att.data.crosslink.end_epoch = att.data.crosslink.start_epoch + 1
    return att


def test_chunk_challenge_and_response(specs, state):
    j, p = specs
    chunk = b"\x07" * j.BYTES_PER_CUSTODY_CHUNK
    att = _challengeable_attestation(j, state, 1, j.ZERO_HASH)
    chunk_count = j.get_custody_chunk_count(att.data.crosslink)
    depth = j.ceillog2(chunk_count)
    assert p.get_custody_chunk_count(_op(specs, att).data.crosslink) == chunk_count
    leaves = [hash_tree_root(chunk)] + [j.ZERO_HASH] * (chunk_count - 1)
    tree = calc_merkle_tree_from_leaves(leaves, depth)
    att.data.crosslink.data_root = tree[-1][0]
    responder = j.get_attesting_indices(state, att.data, att.aggregation_bitfield)[0]
    challenge = j.CustodyChunkChallenge(responder_index=responder, attestation=att,
                                        chunk_index=0)
    port = _port(specs, state)
    _both(specs, state, port, "process_chunk_challenge", challenge)
    records = [r for r in port.custody_chunk_challenge_records
               if r != p.CustodyChunkChallengeRecord()]
    assert len(records) == 1 and records[0].depth == depth
    _both(specs, state, port, "process_chunk_challenge", deepcopy(challenge), raises=True)
    state.slot += j.SLOTS_PER_EPOCH * (j.ACTIVATION_EXIT_DELAY + 1)
    port.slot = state.slot
    response = j.CustodyResponse(
        challenge_index=records[0].challenge_index, chunk_index=0, chunk=chunk,
        data_branch=get_merkle_proof(tree, 0), chunk_bits_branch=[],
        chunk_bits_leaf=j.ZERO_HASH)
    _both(specs, state, port, "process_custody_response", response)
    assert all(r == p.CustodyChunkChallengeRecord()
               for r in port.custody_chunk_challenge_records)


def test_chunk_challenge_wrong_responder_rejected(specs, state):
    j, _ = specs
    att = _challengeable_attestation(j, state, 0, j.ZERO_HASH)
    attesters = j.get_attesting_indices(state, att.data, att.aggregation_bitfield)
    outsider = next(i for i in range(len(state.validator_registry)) if i not in attesters)
    _both(specs, state, _port(specs, state), "process_chunk_challenge",
          j.CustodyChunkChallenge(responder_index=outsider, attestation=att, chunk_index=0),
          raises=True)


def test_challenge_deadline_slashes_responder(specs, state):
    j, p = specs
    att = _challengeable_attestation(j, state, 0, j.ZERO_HASH)
    responder = j.get_attesting_indices(state, att.data, att.aggregation_bitfield)[0]
    port = _port(specs, state)
    _both(specs, state, port, "process_chunk_challenge", j.CustodyChunkChallenge(
        responder_index=responder, attestation=att, chunk_index=0))
    state.slot += j.SLOTS_PER_EPOCH * (j.CUSTODY_RESPONSE_DEADLINE + 2)
    port.slot = state.slot
    _both(specs, state, port, "process_challenge_deadlines")
    assert port.validator_registry[responder].slashed


def test_bit_challenge_opens_record(specs, state):
    j, p = specs
    att = _challengeable_attestation(j, state, 1, j.ZERO_HASH)
    state.slot += j.SLOTS_PER_EPOCH * j.EPOCHS_PER_CUSTODY_PERIOD * 2
    attesters = j.get_attesting_indices(state, att.data, att.aggregation_bitfield)
    challenger = next(i for i in range(len(state.validator_registry)) if i not in attesters)
    chunk_count = j.get_custody_chunk_count(att.data.crosslink)
    width = (chunk_count + 7) // 8
    chunk_bits = next(
        c for c in (bytes([probe]) + b"\x00" * (width - 1) for probe in range(256))
        if j.get_bitfield_bit(j.get_chunk_bits_root(c), 0) == 1)
    assert p.get_chunk_bits_root(chunk_bits) == j.get_chunk_bits_root(chunk_bits)
    challenge = j.CustodyBitChallenge(
        responder_index=attesters[0], attestation=att, challenger_index=challenger,
        responder_key=b"\x55" * 96, chunk_bits=chunk_bits, signature=b"\x66" * 96)
    port = _port(specs, state)
    _both(specs, state, port, "process_bit_challenge", challenge)
    records = [r for r in port.custody_bit_challenge_records
               if r != p.CustodyBitChallengeRecord()]
    assert len(records) == 1 and records[0].chunk_count == chunk_count
    _both(specs, state, port, "process_bit_challenge", deepcopy(challenge), raises=True)


# ---------------------------------------------------------------------------
# Epoch inserts
# ---------------------------------------------------------------------------

def test_reveal_deadline_slashes_laggards(specs, state):
    j, _ = specs
    _mature(j, state, periods=j.CUSTODY_RESPONSE_DEADLINE // j.EPOCHS_PER_CUSTODY_PERIOD + 2)
    port = _port(specs, state)
    _both(specs, state, port, "process_reveal_deadlines")
    assert all(v.slashed for v in port.validator_registry)


def test_final_updates_cleans_exposed_secrets_and_unfreezes(specs, state):
    j, _ = specs
    port = _port(specs, state)
    reveal = _edsr(j, state, j.RANDAO_PENALTY_EPOCHS)
    _both(specs, state, port, "process_early_derived_secret_reveal", reveal)
    leaver = 7
    current_epoch = j.get_current_epoch(state)
    for s in (state, port):
        s.validator_registry[leaver].exit_epoch = current_epoch
        s.validator_registry[leaver].withdrawable_epoch = j.FAR_FUTURE_EPOCH
        s.slot = reveal.epoch * j.SLOTS_PER_EPOCH
    _both(specs, state, port, "after_process_final_updates")
    slot_index = reveal.epoch % j.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS
    assert list(port.exposed_derived_secrets[slot_index]) == []
    assert port.validator_registry[leaver].withdrawable_epoch != j.FAR_FUTURE_EPOCH


def test_phase1_epoch_transition_runs_inserts(specs, state):
    j, p = specs
    port = _port(specs, state)
    f.advance_epoch(j, state)
    p.process_slots(port, state.slot)
    _same(specs, state, port)
    assert p.get_current_epoch(port) == 1


# ---------------------------------------------------------------------------
# Shard chains
# ---------------------------------------------------------------------------

def test_persistent_committee_and_proposer_match(specs, state):
    j, p = specs
    port = _port(specs, state)
    for shard in range(j.SHARD_COUNT):
        got = p.get_persistent_committee(port, shard, port.slot)
        assert got == j.get_persistent_committee(state, shard, state.slot)
        assert got == sorted(got) and got == p.get_persistent_committee(port, shard, port.slot)
        assert p.get_shard_proposer_index(port, shard, port.slot) == \
            j.get_shard_proposer_index(state, shard, state.slot)


def test_crosslink_data_root_matches(specs):
    j, p = specs
    roots = []
    for spec in (j, p):
        body = spec.ShardBlockBody(data=b"\x01" * spec.BYTES_PER_SHARD_BLOCK_BODY)
        blk = spec.ShardBlock(slot=0, shard=0, data=body)
        blk2 = deepcopy(blk)
        blk2.data = spec.ShardBlockBody(data=b"\x02" * spec.BYTES_PER_SHARD_BLOCK_BODY)
        roots.append([spec.compute_crosslink_data_root(x) for x in ([blk], [blk2], [])])
    assert roots[0] == roots[1]
    assert len(set(roots[1])) == 3


@pytest.mark.parametrize("beacon_root", ["real", "wrong"])
def test_shard_block_validity(specs, state, beacon_root):
    j, p = specs
    port = _port(specs, state)
    jblock = f.empty_block(j, state)
    verdicts = []
    for spec, st, beacon_block in ((j, state, jblock),
                                   (p, port, convert.block_from_bytes(
                                       p, serialize(jblock, j.BeaconBlock)))):
        candidate = spec.ShardBlock(
            slot=spec.PHASE_1_FORK_SLOT, shard=1,
            beacon_chain_root=(spec.signing_root(beacon_block) if beacon_root == "real"
                               else b"\x13" * 32),
            parent_root=spec.ZERO_HASH,
            data=spec.ShardBlockBody(data=b"\x00" * spec.BYTES_PER_SHARD_BLOCK_BODY),
            state_root=spec.ZERO_HASH)
        try:
            verdicts.append(spec.is_valid_shard_block(
                [beacon_block] * (spec.SLOTS_PER_EPOCH * 2), st, [], candidate))
        except AssertionError:
            verdicts.append("rejected")
    assert verdicts[0] == verdicts[1] == (True if beacon_root == "real" else "rejected")


# ---------------------------------------------------------------------------
# The device epoch with the insert hooks
# ---------------------------------------------------------------------------

def _diff_epoch_paths(specs, state):
    """Phase1Spec.process_epoch (JAX and port) against the port's
    process_epoch_soa, which must take the staged route, and the JAX
    package's; returns the port's staged post-state."""
    j, p = specs
    if (state.slot + 1) % j.SLOTS_PER_EPOCH != 0:
        state.slot += j.SLOTS_PER_EPOCH - 1 - state.slot % j.SLOTS_PER_EPOCH
    ref, jsoa = deepcopy(state), deepcopy(state)
    pref, psoa = _port(specs, state), _port(specs, state)
    j.process_epoch(ref)
    j_process_epoch_soa(j, jsoa)
    p.process_epoch(pref)
    timings = {}
    assert process_epoch_soa(p, psoa, timings) is not None
    assert timings == {}                 # the staged route leaves it untouched
    want = serialize(ref, j.BeaconState)
    assert serialize(jsoa, j.BeaconState) == want
    assert PI.serialize(pref, p.BeaconState) == want
    assert PI.serialize(psoa, p.BeaconState) == want
    return psoa


def test_phase1_device_epoch_matches_object_model(specs, state):
    j, _ = specs
    f.advance_epoch(j, state)
    f.transition_with_empty_block(j, state)
    _, _, state = attested_epoch(j, state, current=True, previous=True)
    _diff_epoch_paths(specs, state)


def test_phase1_hook_slashing_lands_between_stages(specs, state):
    """@process_challenge_deadlines slashes between the two device stages:
    stage B must see the new slashed flag and slashed-balance table."""
    j, _ = specs
    att = _challengeable_attestation(j, state, 0, j.ZERO_HASH)
    responder = j.get_attesting_indices(state, att.data, att.aggregation_bitfield)[0]
    j.process_chunk_challenge(state, j.CustodyChunkChallenge(
        responder_index=responder, attestation=att, chunk_index=0))
    state.previous_epoch_attestations = []
    state.current_epoch_attestations = []
    state.slot += j.SLOTS_PER_EPOCH * (j.CUSTODY_RESPONSE_DEADLINE + 2)
    soa = _diff_epoch_paths(specs, state)
    assert soa.validator_registry[responder].slashed
