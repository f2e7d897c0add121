"""The port's ResidentCore (consensus_specs_tpu_torch.models.phase0.resident)
on the CPU, held byte-identical to the JAX package's ResidentCore and
object model: the same states and blocks, built with the JAX package's
testing factories and carried across as SSZ bytes, must give the same
per-slot full state roots and the same serialized states through

  1. a multi-epoch drive of attestation-carrying blocks (the three paths
     side by side: JAX object model, JAX ResidentCore, port ResidentCore);
  2. a registry-mutating block (proposer slashing) through the fallback;
  3. a deposit that grows the registry across a padded power of two, the
     forests updated in place;
  4. the checkpoint cycle: write, resume a light core, drive it across an
     epoch boundary;
  5. a foreign state, which the root hook and the overrides decline.
Minimal preset, BLS off."""
from copy import deepcopy

import pytest

from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.models import phase0 as JP
from consensus_specs_tpu.models.phase0.resident import ResidentCore as JRC
from consensus_specs_tpu.testing import factories
from consensus_specs_tpu.utils.ssz.impl import hash_tree_root, serialize
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.models import phase0 as PP
from consensus_specs_tpu_torch.models.phase0 import helpers as PH
from consensus_specs_tpu_torch.models.phase0.resident import ResidentCore
from consensus_specs_tpu_torch.resilience.errors import CheckpointCorrupt
from consensus_specs_tpu_torch.utils.merkle import tree_depth
from consensus_specs_tpu_torch.utils.ssz import impl as PI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture
def specs():
    j = JP.get_spec("minimal")
    p = PP.get_spec("minimal", device="cpu")
    j_active, p_active = JBLS.bls_active, PBLS.bls_active
    JBLS.bls_active = PBLS.bls_active = False
    j.clear_caches()
    p.clear_caches()
    yield j, p
    JBLS.bls_active, PBLS.bls_active = j_active, p_active
    j.clear_caches()
    p.clear_caches()


def _seed(j, p, validators):
    """(JAX object state, port state) of one seeded state two slots past
    genesis."""
    state = factories.seed_genesis_state(j, validators)
    factories.advance_slots(j, state, 2)
    return state, convert.state_from_bytes(p, serialize(state, j.BeaconState))


def _pblock(j, p, block):
    return convert.block_from_bytes(p, serialize(block, j.BeaconBlock))


def _attestation_block(j, ref):
    att = factories.new_attestation(j, ref)
    block = factories.empty_block_next(j, ref)
    block.slot = ref.slot + j.MIN_ATTESTATION_INCLUSION_DELAY
    block.body.attestations.append(att)
    return block


def _same_bytes(j, p, ref, res):
    assert PI.serialize(res, p.BeaconState) == serialize(ref, j.BeaconState)


def test_multi_epoch_drive_matches_reference(specs):
    j, p = specs
    ref, res = _seed(j, p, 4 * j.SLOTS_PER_EPOCH)
    jres = deepcopy(ref)
    jcore = JRC(j, jres)
    core = ResidentCore(p, res)
    try:
        for i in range(3 * j.SLOTS_PER_EPOCH + 4):
            with jcore.suspended():
                block = _attestation_block(j, ref)
                j.state_transition(ref, block)
            jcore.state_transition(jres, block)
            core.state_transition(res, _pblock(j, p, block))
            root = hash_tree_root(ref)
            assert core._state_root(res) == root == jcore._state_root(jres), \
                f"block {i} (slot {block.slot})"
            assert list(res.latest_state_roots) == list(ref.latest_state_roots)
        assert j.get_current_epoch(ref) >= 3
        assert core.timings.keys() == {"stage", "device", "refresh"}
    finally:
        core.exit()
        jcore.exit()
    _same_bytes(j, p, ref, res)
    assert serialize(jres, j.BeaconState) == serialize(ref, j.BeaconState)
    assert PH._state_root_backend is None          # the hook came off


def test_fallback_on_proposer_slashing(specs):
    j, p = specs
    ref, res = _seed(j, p, 4 * j.SLOTS_PER_EPOCH)
    core = ResidentCore(p, res)
    try:
        for i in range(2 * j.SLOTS_PER_EPOCH):
            block = _attestation_block(j, ref)
            if i == j.SLOTS_PER_EPOCH + 1:       # mid-drive, epoch > 0
                block.body.proposer_slashings.append(
                    factories.double_proposal(j, ref))
            j.state_transition(ref, block)
            core.state_transition(res, _pblock(j, p, block))
            assert core._state_root(res) == hash_tree_root(ref)
        assert any(v.slashed for v in ref.validator_registry)
        assert core.mirrors["slashed"].any()
    finally:
        core.exit()
    _same_bytes(j, p, ref, res)


def test_deposit_grows_the_forests_in_place(specs):
    """A slashing updates one registry leaf path in place, and a deposit
    append-grows both forests across the padded power of two: no rebuild,
    roots equal to the object model throughout."""
    j, p = specs
    ref, res = _seed(j, p, 4 * j.SLOTS_PER_EPOCH)
    V = len(ref.validator_registry)
    assert V & (V - 1) == 0
    core = ResidentCore(p, res)
    try:
        core._state_root(res)                    # builds the forests
        reg, bal = core.res.registry_forest, core.res.balances_forest
        assert reg.builds == 1 and reg.n == V

        block = factories.empty_block_next(j, ref)
        block.body.proposer_slashings.append(factories.double_proposal(j, ref))
        j.state_transition(ref, block)
        core.state_transition(res, _pblock(j, p, block))
        assert core.res.registry_forest is reg and reg.builds == 1
        assert 0 < sum(reg.last_pairs_per_level) <= 2 * 2 * reg.depth
        assert core._state_root(res) == hash_tree_root(ref)

        deposit = factories.stage_deposit(j, ref, V, j.MAX_EFFECTIVE_BALANCE)
        # the planted eth1 data is pre-block chain context both paths need
        res.latest_eth1_data = convert.state_from_bytes(
            p, serialize(ref, j.BeaconState)).latest_eth1_data
        block = factories.empty_block_next(j, ref)
        block.body.deposits.append(deposit)
        j.state_transition(ref, block)
        core.state_transition(res, _pblock(j, p, block))
        assert core.res.registry_forest is reg and core.res.balances_forest is bal
        assert reg.n == V + 1 and reg.depth == tree_depth(V + 1) > tree_depth(V)
        assert core.res.v == V + 1 and len(core._pk_np) == V + 1
        assert core._state_root(res) == hash_tree_root(ref)
    finally:
        core.exit()
    _same_bytes(j, p, ref, res)


def test_checkpoint_cycle(specs):
    """checkpoint_bytes equals the object model's serialization; a light
    core resumed from it round-trips the bytes, roots the same, and driven
    across an epoch boundary stays equal to the object model; garbage
    raises the typed CheckpointCorrupt."""
    j, p = specs
    ref, res = _seed(j, p, 4 * j.SLOTS_PER_EPOCH)
    core = ResidentCore(p, res)
    try:
        for _ in range(3):
            block = _attestation_block(j, ref)
            j.state_transition(ref, block)
            core.state_transition(res, _pblock(j, p, block))
        data = core.checkpoint_bytes()
        assert data == serialize(ref, j.BeaconState)
    finally:
        core.exit()

    light = ResidentCore.from_checkpoint(p, data)
    try:
        assert light.checkpoint_bytes() == data
        assert light._state_root(light.state) == hash_tree_root(ref)
        with pytest.raises(NotImplementedError):
            light.state_transition(light.state, _pblock(j, p, block))
        with pytest.raises(NotImplementedError):
            light.exit()
        target = (j.get_current_epoch(ref) + 1) * j.SLOTS_PER_EPOCH + 2
        j.process_slots(ref, target)
        light.process_slots(light.state, target)
        assert light.checkpoint_bytes() == serialize(ref, j.BeaconState)
        assert light._state_root(light.state) == hash_tree_root(ref)
    finally:
        light._uninstall()
    for bad in (data[:100], b"\xff" * len(data), "not bytes"):
        with pytest.raises(CheckpointCorrupt):
            ResidentCore.from_checkpoint(p, bad)


def test_foreign_state_is_declined(specs):
    """The root hook and the overrides answer for the resident state only:
    any other state goes to the object path."""
    j, p = specs
    ref, res = _seed(j, p, 2 * j.SLOTS_PER_EPOCH)
    other = deepcopy(res)
    other.slot += 123
    epoch = p.slot_to_epoch(other.slot)
    for i in range(4):
        other.validator_registry[i].exit_epoch = epoch
    other.validator_registry[4].effective_balance -= p.EFFECTIVE_BALANCE_INCREMENT
    with_slot = deepcopy(ref)
    with_slot.slot += 123
    core = ResidentCore(p, res)
    try:
        assert core._state_root(res) == hash_tree_root(ref)
        assert p.hash_tree_root(other) == PI.hash_tree_root(other)
        assert core._state_root(other) is None
        with core.suspended():
            want_active = list(p.get_active_validator_indices(other, epoch))
            want_total = p.get_total_balance(other, want_active)
            want_eb = p.effective_balance_of(other, 4)
        assert list(p.get_active_validator_indices(other, epoch)) == want_active
        assert want_active[:1] == [4]
        assert p.get_total_balance(other, want_active) == want_total
        assert p.effective_balance_of(other, 4) == want_eb
        assert p.effective_balance_of(res, 4) == res.validator_registry[4].effective_balance
    finally:
        core.exit()
