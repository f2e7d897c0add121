"""Shared operation runners for the dual-use spec tests.

Each runner is a generator yielding (key, value) vector artifacts in the
layout of the reference's test formats (specs/test_formats/operations):
pre-state, the operation object, then the post-state (None when the op is
invalid and processing must abort).

Centralizing them here (the reference repeats them per test file) keeps each
test module down to the scenario logic.
"""
from __future__ import annotations

from .context import expect_assertion_error
from .factories import balance_of as get_balance


def run_operation_processing(spec, state, op_name: str, operation, process_fn, valid=True):
    """Generic wrapper: yield pre/op/post; on invalid expect assertion + no post."""
    yield "pre", state
    yield op_name, operation
    if not valid:
        expect_assertion_error(lambda: process_fn(state, operation))
        yield "post", None
        return False
    process_fn(state, operation)
    yield "post", state
    return True


def run_attestation_processing(spec, state, attestation, valid=True):
    current_count = len(state.current_epoch_attestations)
    previous_count = len(state.previous_epoch_attestations)
    ok = yield from run_operation_processing(
        spec, state, "attestation", attestation, spec.process_attestation, valid)
    if ok:
        if attestation.data.target_epoch == spec.get_current_epoch(state):
            assert len(state.current_epoch_attestations) == current_count + 1
        else:
            assert len(state.previous_epoch_attestations) == previous_count + 1


def run_block_header_processing(spec, state, block, valid=True):
    spec.process_slots(state, state.slot + 1)
    yield "pre", state
    yield "block", block
    if not valid:
        expect_assertion_error(lambda: spec.process_block_header(state, block))
        yield "post", None
        return
    spec.process_block_header(state, block)
    yield "post", state


def run_proposer_slashing_processing(spec, state, proposer_slashing, valid=True):
    pre_balance = None
    if valid and proposer_slashing.proposer_index < len(state.validator_registry):
        pre_balance = get_balance(state, proposer_slashing.proposer_index)
    ok = yield from run_operation_processing(
        spec, state, "proposer_slashing", proposer_slashing, spec.process_proposer_slashing, valid)
    if ok:
        slashed = state.validator_registry[proposer_slashing.proposer_index]
        assert slashed.slashed
        assert slashed.exit_epoch < spec.FAR_FUTURE_EPOCH
        assert slashed.withdrawable_epoch < spec.FAR_FUTURE_EPOCH
        # proposer slashed themselves: net loss (whistleblower reward < penalty)
        assert get_balance(state, proposer_slashing.proposer_index) < pre_balance


def run_attester_slashing_processing(spec, state, attester_slashing, valid=True):
    pre_balances = None
    if valid:
        slashed_index = attester_slashing.attestation_1.custody_bit_0_indices[0]
        proposer_index = spec.get_beacon_proposer_index(state)
        pre_balances = (
            slashed_index, get_balance(state, slashed_index),
            proposer_index, get_balance(state, proposer_index),
        )
    ok = yield from run_operation_processing(
        spec, state, "attester_slashing", attester_slashing, spec.process_attester_slashing, valid)
    if ok:
        slashed_index, pre_slashed, proposer_index, pre_proposer = pre_balances
        slashed_validator = state.validator_registry[slashed_index]
        assert slashed_validator.slashed
        assert slashed_validator.exit_epoch < spec.FAR_FUTURE_EPOCH
        assert slashed_validator.withdrawable_epoch < spec.FAR_FUTURE_EPOCH
        if slashed_index != proposer_index:
            assert get_balance(state, slashed_index) < pre_slashed
            assert get_balance(state, proposer_index) > pre_proposer
        else:
            assert get_balance(state, slashed_index) >= pre_slashed


def run_deposit_processing(spec, state, deposit, validator_index, valid=True, effective=True):
    pre_validator_count = len(state.validator_registry)
    pre_balance = 0
    if validator_index < pre_validator_count:
        pre_balance = get_balance(state, validator_index)
    ok = yield from run_operation_processing(
        spec, state, "deposit", deposit, spec.process_deposit, valid)
    if not ok:
        return
    if not effective:
        assert len(state.validator_registry) == pre_validator_count
        assert len(state.balances) == pre_validator_count
        if validator_index < pre_validator_count:
            assert get_balance(state, validator_index) == pre_balance
    else:
        expected_count = pre_validator_count + (0 if validator_index < pre_validator_count else 1)
        assert len(state.validator_registry) == expected_count
        assert len(state.balances) == expected_count
        assert get_balance(state, validator_index) == pre_balance + deposit.data.amount
    assert state.deposit_index == state.latest_eth1_data.deposit_count


def run_voluntary_exit_processing(spec, state, voluntary_exit, valid=True):
    validator_index = voluntary_exit.validator_index
    ok = yield from run_operation_processing(
        spec, state, "voluntary_exit", voluntary_exit, spec.process_voluntary_exit, valid)
    if ok:
        assert state.validator_registry[validator_index].exit_epoch < spec.FAR_FUTURE_EPOCH


def run_transfer_processing(spec, state, transfer, valid=True):
    proposer_index = spec.get_beacon_proposer_index(state)
    pre_transfer_sender_balance = state.balances[transfer.sender]
    pre_transfer_recipient_balance = state.balances[transfer.recipient]
    pre_transfer_proposer_balance = state.balances[proposer_index]
    ok = yield from run_operation_processing(
        spec, state, "transfer", transfer, spec.process_transfer, valid)
    if ok:
        sender_balance = state.balances[transfer.sender]
        recipient_balance = state.balances[transfer.recipient]
        assert sender_balance == pre_transfer_sender_balance - transfer.amount - transfer.fee
        assert recipient_balance == pre_transfer_recipient_balance + transfer.amount
        assert state.balances[proposer_index] == pre_transfer_proposer_balance + transfer.fee
