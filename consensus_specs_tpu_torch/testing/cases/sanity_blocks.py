"""Whole-block sanity scenarios: each drives state_transition with real
blocks carrying one kind of operation (or none) and checks the end state.

Coverage parity with the reference's block sanity suite; transition
contract per consensus-specs specs/core/0_beacon-chain.md:1204-1245 and the
operation handlers :1566-1832.
"""
from __future__ import annotations

from copy import deepcopy

from ...crypto.bls import bls_sign
from ...utils.ssz.impl import hash_tree_root, signing_root
from ...utils.ssz.typing import List as SSZList
from .. import factories as f
from ..keys import privkeys, pubkeys
from . import Case, install_pytests


def _chain(spec, state, *blocks):
    """Common epilogue: yield the pre-state (already yielded), blocks, post."""
    yield "blocks", list(blocks), SSZList[spec.BeaconBlock]
    yield "post", state


def empty_block_transition(spec, state):
    start_slot = state.slot
    votes_before = len(state.eth1_data_votes)
    yield "pre", state

    block = f.empty_block_next(spec, state, signed=True)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    assert len(state.eth1_data_votes) == votes_before + 1
    assert spec.get_block_root_at_slot(state, start_slot) == block.parent_root
    assert spec.get_randao_mix(state, spec.get_current_epoch(state)) != spec.ZERO_HASH


def skipped_slots(spec, state):
    start_slot = state.slot
    yield "pre", state

    block = f.empty_block_next(spec, state)
    block.slot += 3
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    assert state.slot == block.slot
    assert spec.get_randao_mix(state, spec.get_current_epoch(state)) != spec.ZERO_HASH
    for slot in range(start_slot, state.slot):
        assert spec.get_block_root_at_slot(state, slot) == block.parent_root


def empty_epoch_transition(spec, state):
    start_slot = state.slot
    yield "pre", state

    block = f.empty_block_next(spec, state)
    block.slot += spec.SLOTS_PER_EPOCH
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    assert state.slot == block.slot
    for slot in range(start_slot, state.slot):
        assert spec.get_block_root_at_slot(state, slot) == block.parent_root


def proposer_slashing_in_block(spec, state):
    before = deepcopy(state)
    op = f.double_proposal(spec, state, sign_first=True, sign_second=True)
    offender = op.proposer_index
    assert not state.validator_registry[offender].slashed
    yield "pre", state

    block = f.empty_block_next(spec, state)
    block.body.proposer_slashings.append(op)
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    punished = state.validator_registry[offender]
    assert punished.slashed
    assert punished.exit_epoch < spec.FAR_FUTURE_EPOCH
    assert punished.withdrawable_epoch < spec.FAR_FUTURE_EPOCH
    assert f.balance_of(state, offender) < f.balance_of(before, offender)


def attester_slashing_in_block(spec, state):
    before = deepcopy(state)
    op = f.double_vote(spec, state, sign_first=True, sign_second=True)
    offender = (list(op.attestation_1.custody_bit_0_indices)
                + list(op.attestation_1.custody_bit_1_indices))[0]
    assert not state.validator_registry[offender].slashed
    yield "pre", state

    block = f.empty_block_next(spec, state)
    block.body.attester_slashings.append(op)
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    punished = state.validator_registry[offender]
    assert punished.slashed
    assert punished.exit_epoch < spec.FAR_FUTURE_EPOCH
    assert punished.withdrawable_epoch < spec.FAR_FUTURE_EPOCH
    assert f.balance_of(state, offender) < f.balance_of(before, offender)
    rewarded = spec.get_beacon_proposer_index(state)
    assert f.balance_of(state, rewarded) > f.balance_of(before, rewarded)


def deposit_in_block(spec, state):
    registry_before = len(state.validator_registry)
    newcomer = registry_before
    deposit = f.stage_deposit(spec, state, newcomer, spec.MAX_EFFECTIVE_BALANCE,
                              signed=True)
    yield "pre", state

    block = f.empty_block_next(spec, state)
    block.body.deposits.append(deposit)
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    assert len(state.validator_registry) == registry_before + 1
    assert len(state.balances) == registry_before + 1
    assert f.balance_of(state, newcomer) == spec.MAX_EFFECTIVE_BALANCE
    assert state.validator_registry[newcomer].pubkey == pubkeys[newcomer]


def deposit_top_up_in_block(spec, state):
    member = 0
    amount = spec.MAX_EFFECTIVE_BALANCE // 4
    deposit = f.stage_deposit(spec, state, member, amount)
    registry_before = len(state.validator_registry)
    balance_before = f.balance_of(state, member)
    yield "pre", state

    block = f.empty_block_next(spec, state)
    block.body.deposits.append(deposit)
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    assert len(state.validator_registry) == registry_before
    assert len(state.balances) == registry_before
    assert f.balance_of(state, member) == balance_before + amount


def attestation_lifecycle(spec, state):
    state.slot = spec.SLOTS_PER_EPOCH
    yield "pre", state

    attestation = f.new_attestation(spec, state, signed=True)

    current_before = len(state.current_epoch_attestations)
    carrier = f.empty_block_next(spec, state)
    carrier.slot += spec.MIN_ATTESTATION_INCLUSION_DELAY
    carrier.body.attestations.append(attestation)
    f.sign_proposal(spec, state, carrier)
    f.apply_and_seal(spec, state, carrier)
    assert len(state.current_epoch_attestations) == current_before + 1

    # epoch rotation moves current -> previous
    rotating_root = hash_tree_root(state.current_epoch_attestations)
    roller = f.empty_block_next(spec, state)
    roller.slot += spec.SLOTS_PER_EPOCH
    f.sign_proposal(spec, state, roller)
    f.apply_and_seal(spec, state, roller)

    yield from _chain(spec, state, carrier, roller)
    assert len(state.current_epoch_attestations) == 0
    assert hash_tree_root(state.previous_epoch_attestations) == rotating_root


def voluntary_exit_lifecycle(spec, state):
    leaver = spec.get_active_validator_indices(state, spec.get_current_epoch(state))[-1]
    state.slot += spec.PERSISTENT_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH
    yield "pre", state

    notice = spec.VoluntaryExit(
        epoch=spec.get_current_epoch(state), validator_index=leaver)
    notice.signature = bls_sign(
        message_hash=signing_root(notice),
        privkey=privkeys[leaver],
        domain=spec.get_domain(state, spec.DOMAIN_VOLUNTARY_EXIT),
    )

    carrier = f.empty_block_next(spec, state)
    carrier.body.voluntary_exits.append(notice)
    f.sign_proposal(spec, state, carrier)
    f.apply_and_seal(spec, state, carrier)
    assert state.validator_registry[leaver].exit_epoch < spec.FAR_FUTURE_EPOCH

    roller = f.empty_block_next(spec, state)
    roller.slot += spec.SLOTS_PER_EPOCH
    f.sign_proposal(spec, state, roller)
    f.apply_and_seal(spec, state, roller)

    yield from _chain(spec, state, carrier, roller)
    assert state.validator_registry[leaver].exit_epoch < spec.FAR_FUTURE_EPOCH


def balance_driven_status_transitions(spec, state):
    subject = spec.get_active_validator_indices(state, spec.get_current_epoch(state))[-1]
    assert state.validator_registry[subject].exit_epoch == spec.FAR_FUTURE_EPOCH
    state.validator_registry[subject].effective_balance = spec.EJECTION_BALANCE
    yield "pre", state

    block = f.empty_block_next(spec, state)
    block.slot += spec.SLOTS_PER_EPOCH
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    assert state.validator_registry[subject].exit_epoch < spec.FAR_FUTURE_EPOCH


def historical_batch_accumulation(spec, state):
    state.slot += spec.SLOTS_PER_HISTORICAL_ROOT \
        - (state.slot % spec.SLOTS_PER_HISTORICAL_ROOT) - 1
    batches_before = len(state.historical_roots)
    yield "pre", state

    block = f.empty_block_next(spec, state, signed=True)
    f.apply_and_seal(spec, state, block)

    yield from _chain(spec, state, block)
    assert state.slot == block.slot
    assert spec.get_current_epoch(state) \
        % (spec.SLOTS_PER_HISTORICAL_ROOT // spec.SLOTS_PER_EPOCH) == 0
    assert len(state.historical_roots) == batches_before + 1


CASES = [
    Case("empty_block_transition", build=empty_block_transition),
    Case("skipped_slots", build=skipped_slots),
    Case("empty_epoch_transition", build=empty_epoch_transition),
    Case("proposer_slashing", build=proposer_slashing_in_block),
    Case("attester_slashing", build=attester_slashing_in_block),
    Case("deposit_in_block", build=deposit_in_block),
    Case("deposit_top_up", build=deposit_top_up_in_block),
    Case("attestation", build=attestation_lifecycle),
    Case("voluntary_exit", build=voluntary_exit_lifecycle),
    Case("balance_driven_status_transitions", build=balance_driven_status_transitions),
    Case("historical_batch", build=historical_batch_accumulation),
]


def execute(spec, state, case):
    yield from case.build(spec, state)


install_pytests(globals(), CASES, execute)
