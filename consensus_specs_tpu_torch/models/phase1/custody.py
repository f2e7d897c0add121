"""Custody game: helpers, the five operation handlers, and epoch inserts.

Contract: consensus-specs specs/core/1_custody-game.md — helpers :249-319,
process_custody_key_reveal :335-376, process_early_derived_secret_reveal
:385-453, process_chunk_challenge :462-497, process_bit_challenge :506-576,
process_custody_response + sub-handlers :585-659, epoch inserts :668-716.
(The spec text mixes `revealer_index`/`revealed_index` in
process_custody_key_reveal; CustodyKeyReveal only carries revealer_index,
which is used consistently here.)

All functions take `spec` first and bind as Phase1Spec methods. Port of
consensus_specs_tpu/models/phase1/custody.py; every signature check goes
through `spec.bls` (TorchBackend's kernels on the card).
"""
from __future__ import annotations


# ---------------------------------------------------------------------------
# Helpers (:249-319)
# ---------------------------------------------------------------------------

def ceillog2(spec, x: int) -> int:
    return int(x).bit_length()


def get_custody_chunk_count(spec, crosslink) -> int:
    crosslink_length = min(spec.MAX_EPOCHS_PER_CROSSLINK,
                           crosslink.end_epoch - crosslink.start_epoch)
    chunks_per_epoch = (2 * spec.BYTES_PER_SHARD_BLOCK * spec.SLOTS_PER_EPOCH
                        // spec.BYTES_PER_CUSTODY_CHUNK)
    return crosslink_length * chunks_per_epoch


def get_custody_chunk_bit(spec, key: bytes, chunk: bytes) -> bool:
    return bool(spec.get_bitfield_bit(spec.hash(bytes(key) + bytes(chunk)), 0))


def get_chunk_bits_root(spec, chunk_bitfield: bytes) -> bytes:
    folded = bytearray(32)
    for i in range(0, len(chunk_bitfield), 32):
        block = chunk_bitfield[i:i + 32]
        for j, b in enumerate(block):
            folded[j] ^= b
    return spec.hash(bytes(folded))


def get_randao_epoch_for_custody_period(spec, period: int, validator_index: int) -> int:
    next_period_start = ((period + 1) * spec.EPOCHS_PER_CUSTODY_PERIOD
                         - validator_index % spec.EPOCHS_PER_CUSTODY_PERIOD)
    return next_period_start + spec.CUSTODY_PERIOD_TO_RANDAO_PADDING


def get_validators_custody_reveal_period(spec, state, validator_index: int,
                                         epoch: int = None) -> int:
    if epoch is None:
        epoch = spec.get_current_epoch(state)
    return ((epoch + validator_index % spec.EPOCHS_PER_CUSTODY_PERIOD)
            // spec.EPOCHS_PER_CUSTODY_PERIOD)


def replace_empty_or_append(spec, records, new_element) -> int:
    empty = type(new_element)()
    for i in range(len(records)):
        if records[i] == empty:
            records[i] = new_element
            return i
    records.append(new_element)
    return len(records) - 1


# ---------------------------------------------------------------------------
# Operation handlers
# ---------------------------------------------------------------------------

def process_custody_key_reveal(spec, state, reveal) -> None:
    """Timely custody key reveal: advances the revealer's period (:335-376)."""
    revealer = state.validator_registry[reveal.revealer_index]
    epoch_to_sign = spec.get_randao_epoch_for_custody_period(
        revealer.next_custody_reveal_period, reveal.revealer_index)

    assert revealer.next_custody_reveal_period < \
        spec.get_validators_custody_reveal_period(state, reveal.revealer_index)
    assert spec.is_slashable_validator(revealer, spec.get_current_epoch(state))

    assert spec.bls.bls_verify(
        revealer.pubkey,
        spec.hash_tree_root(epoch_to_sign),
        reveal.reveal,
        spec.get_domain(state, spec.DOMAIN_RANDAO, message_epoch=epoch_to_sign),
    )

    # lateness bookkeeping: timely responses shrink it, late ones set it
    if revealer.next_custody_reveal_period == \
            spec.get_validators_custody_reveal_period(state, reveal.revealer_index) - 2:
        revealer.max_reveal_lateness = max(
            0, revealer.max_reveal_lateness - spec.MAX_REVEAL_LATENESS_DECREMENT)
    revealer.max_reveal_lateness = max(
        revealer.max_reveal_lateness,
        spec.get_validators_custody_reveal_period(state, reveal.revealer_index)
        - revealer.next_custody_reveal_period,
    )
    revealer.next_custody_reveal_period += 1

    proposer_index = spec.get_beacon_proposer_index(state)
    spec.increase_balance(
        state, proposer_index,
        spec.get_base_reward(state, reveal.revealer_index) // spec.MINOR_REWARD_QUOTIENT)


def process_early_derived_secret_reveal(spec, state, reveal) -> None:
    """Punishable premature reveal of a future-epoch derived secret
    (:385-453): full slashing inside the custody window, a scaled penalty
    plus whistleblower/proposer rewards outside it."""
    revealed_validator = state.validator_registry[reveal.revealed_index]
    masker = state.validator_registry[reveal.masker_index]
    current_epoch = spec.get_current_epoch(state)
    slot_index = reveal.epoch % spec.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS

    assert reveal.epoch >= current_epoch + spec.RANDAO_PENALTY_EPOCHS
    assert reveal.epoch < current_epoch + spec.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS
    assert revealed_validator.slashed is False
    assert reveal.revealed_index not in list(state.exposed_derived_secrets[slot_index])

    assert spec.bls.bls_verify_multiple(
        [revealed_validator.pubkey, masker.pubkey],
        [spec.hash_tree_root(reveal.epoch), reveal.mask],
        reveal.reveal,
        spec.get_domain(state, spec.DOMAIN_RANDAO, message_epoch=reveal.epoch),
    )

    if reveal.epoch >= current_epoch + spec.CUSTODY_PERIOD_TO_RANDAO_PADDING:
        # could be a valid custody round key: full slashing
        spec.slash_validator(state, reveal.revealed_index, reveal.masker_index)
    else:
        active_count = len(spec.get_active_validator_indices(state, current_epoch))
        max_proposer_slot_reward = (
            spec.get_base_reward(state, reveal.revealed_index)
            * spec.SLOTS_PER_EPOCH // active_count // spec.PROPOSER_REWARD_QUOTIENT)
        penalty = (max_proposer_slot_reward
                   * spec.EARLY_DERIVED_SECRET_REVEAL_SLOT_REWARD_MULTIPLE
                   * (len(state.exposed_derived_secrets[slot_index]) + 1))

        proposer_index = spec.get_beacon_proposer_index(state)
        whistleblowing_reward = penalty // spec.WHISTLEBLOWING_REWARD_QUOTIENT
        proposer_reward = whistleblowing_reward // spec.PROPOSER_REWARD_QUOTIENT
        spec.increase_balance(state, proposer_index, proposer_reward)
        spec.increase_balance(state, reveal.masker_index,
                              whistleblowing_reward - proposer_reward)
        spec.decrease_balance(state, reveal.revealed_index, penalty)
        state.exposed_derived_secrets[slot_index].append(reveal.revealed_index)


def process_chunk_challenge(spec, state, challenge) -> None:
    """Open a chunk challenge against an attester (:462-497)."""
    spec.validate_indexed_attestation(
        state, spec.convert_to_indexed(state, challenge.attestation))
    data = challenge.attestation.data
    current_epoch = spec.get_current_epoch(state)
    attestation_slot = spec.get_attestation_data_slot(state, data)
    assert spec.slot_to_epoch(attestation_slot) >= current_epoch - spec.MAX_CHUNK_CHALLENGE_DELAY
    responder = state.validator_registry[challenge.responder_index]
    assert responder.exit_epoch >= current_epoch - spec.MAX_CHUNK_CHALLENGE_DELAY

    attesters = spec.get_attesting_indices(
        state, data, challenge.attestation.aggregation_bitfield)
    assert challenge.responder_index in attesters

    for record in state.custody_chunk_challenge_records:
        assert (record.data_root != data.crosslink.data_root
                or record.chunk_index != challenge.chunk_index)

    depth = spec.ceillog2(spec.get_custody_chunk_count(data.crosslink))
    assert challenge.chunk_index < 2 ** depth

    new_record = spec.CustodyChunkChallengeRecord(
        challenge_index=state.custody_challenge_index,
        challenger_index=spec.get_beacon_proposer_index(state),
        responder_index=challenge.responder_index,
        inclusion_epoch=current_epoch,
        data_root=data.crosslink.data_root,
        depth=depth,
        chunk_index=challenge.chunk_index,
    )
    spec.replace_empty_or_append(state.custody_chunk_challenge_records, new_record)
    state.custody_challenge_index += 1
    responder.withdrawable_epoch = spec.FAR_FUTURE_EPOCH


def process_bit_challenge(spec, state, challenge) -> None:
    """Open a custody-bit challenge (:506-576)."""
    current_epoch = spec.get_current_epoch(state)
    challenger = state.validator_registry[challenge.challenger_index]
    assert spec.bls.bls_verify(
        challenger.pubkey,
        spec.signing_root(challenge),
        challenge.signature,
        spec.get_domain(state, spec.DOMAIN_CUSTODY_BIT_CHALLENGE, current_epoch),
    )
    assert spec.is_slashable_validator(challenger, current_epoch)

    attestation = challenge.attestation
    spec.validate_indexed_attestation(
        state, spec.convert_to_indexed(state, attestation))
    responder = state.validator_registry[challenge.responder_index]
    attestation_slot = spec.get_attestation_data_slot(state, attestation.data)
    assert (spec.slot_to_epoch(attestation_slot) + responder.max_reveal_lateness
            <= spec.get_validators_custody_reveal_period(state, challenge.responder_index))

    attesters = spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bitfield)
    assert challenge.responder_index in attesters

    for record in state.custody_bit_challenge_records:
        assert record.challenger_index != challenge.challenger_index

    epoch_to_sign = spec.get_randao_epoch_for_custody_period(
        spec.get_validators_custody_reveal_period(
            state, challenge.responder_index, spec.slot_to_epoch(attestation_slot)),
        challenge.responder_index,
    )
    assert spec.bls.bls_verify(
        responder.pubkey,
        spec.hash_tree_root(epoch_to_sign),
        challenge.responder_key,
        spec.get_domain(state, spec.DOMAIN_RANDAO, message_epoch=epoch_to_sign),
    )

    chunk_count = spec.get_custody_chunk_count(attestation.data.crosslink)
    assert spec.verify_bitfield(challenge.chunk_bits, chunk_count)
    custody_bit = spec.get_bitfield_bit(
        attestation.custody_bitfield, attesters.index(challenge.responder_index))
    assert custody_bit != spec.get_bitfield_bit(
        spec.get_chunk_bits_root(challenge.chunk_bits), 0)

    new_record = spec.CustodyBitChallengeRecord(
        challenge_index=state.custody_challenge_index,
        challenger_index=challenge.challenger_index,
        responder_index=challenge.responder_index,
        inclusion_epoch=current_epoch,
        data_root=attestation.data.crosslink.data_root,
        chunk_count=chunk_count,
        chunk_bits_merkle_root=spec.hash_tree_root(challenge.chunk_bits),
        responder_key=challenge.responder_key,
    )
    spec.replace_empty_or_append(state.custody_bit_challenge_records, new_record)
    state.custody_challenge_index += 1
    responder.withdrawable_epoch = spec.FAR_FUTURE_EPOCH


def process_custody_response(spec, state, response) -> None:
    """Dispatch a response to whichever open challenge it answers (:585-599)."""
    for record in state.custody_chunk_challenge_records:
        if record.challenge_index == response.challenge_index \
                and record != spec.CustodyChunkChallengeRecord():
            return _process_chunk_challenge_response(spec, state, response, record)
    for record in state.custody_bit_challenge_records:
        if record.challenge_index == response.challenge_index \
                and record != spec.CustodyBitChallengeRecord():
            return _process_bit_challenge_response(spec, state, response, record)
    raise AssertionError("response matches no open challenge")


def _process_chunk_challenge_response(spec, state, response, challenge) -> None:
    assert response.chunk_index == challenge.chunk_index
    assert list(response.chunk_bits_branch) == [] and \
        response.chunk_bits_leaf == spec.ZERO_HASH
    assert spec.get_current_epoch(state) >= \
        challenge.inclusion_epoch + spec.ACTIVATION_EXIT_DELAY
    assert spec.verify_merkle_branch(
        leaf=spec.hash_tree_root(response.chunk),
        proof=response.data_branch,
        depth=challenge.depth,
        index=response.chunk_index,
        root=challenge.data_root,
    )
    records = state.custody_chunk_challenge_records
    records[records.index(challenge)] = spec.CustodyChunkChallengeRecord()
    proposer_index = spec.get_beacon_proposer_index(state)
    spec.increase_balance(
        state, proposer_index,
        spec.get_base_reward(state, proposer_index) // spec.MINOR_REWARD_QUOTIENT)


def _process_bit_challenge_response(spec, state, response, challenge) -> None:
    assert response.chunk_index < challenge.chunk_count
    responder = state.validator_registry[challenge.responder_index]
    assert not responder.slashed
    assert spec.verify_merkle_branch(
        leaf=spec.hash_tree_root(response.chunk),
        proof=response.data_branch,
        depth=spec.ceillog2(challenge.chunk_count),
        index=response.chunk_index,
        root=challenge.data_root,
    )
    assert spec.verify_merkle_branch(
        leaf=response.chunk_bits_leaf,
        proof=response.chunk_bits_branch,
        depth=spec.ceillog2(challenge.chunk_count) >> 8,
        index=response.chunk_index // 256,
        root=challenge.chunk_bits_merkle_root,
    )
    assert (spec.get_custody_chunk_bit(challenge.responder_key, response.chunk)
            != bool(spec.get_bitfield_bit(challenge.chunk_bits_leaf,
                                          response.chunk_index % 256)))
    records = state.custody_bit_challenge_records
    records[records.index(challenge)] = spec.CustodyBitChallengeRecord()
    # the challenge was answered: the CHALLENGER lied, slash them
    spec.slash_validator(state, challenge.challenger_index, challenge.responder_index)


# ---------------------------------------------------------------------------
# Epoch inserts (:668-716)
# ---------------------------------------------------------------------------

def process_reveal_deadlines(spec, state) -> None:
    for index, validator in enumerate(state.validator_registry):
        deadline = validator.next_custody_reveal_period + \
            (spec.CUSTODY_RESPONSE_DEADLINE // spec.EPOCHS_PER_CUSTODY_PERIOD)
        if spec.get_validators_custody_reveal_period(state, index) > deadline:
            spec.slash_validator(state, index)


def process_challenge_deadlines(spec, state) -> None:
    current_epoch = spec.get_current_epoch(state)
    for records, empty in (
        (state.custody_chunk_challenge_records, spec.CustodyChunkChallengeRecord()),
        (state.custody_bit_challenge_records, spec.CustodyBitChallengeRecord()),
    ):
        for i in range(len(records)):
            challenge = records[i]
            if challenge == empty:
                continue
            if current_epoch > challenge.inclusion_epoch + spec.CUSTODY_RESPONSE_DEADLINE:
                spec.slash_validator(state, challenge.responder_index,
                                     challenge.challenger_index)
                records[i] = empty


def after_process_final_updates(spec, state) -> None:
    current_epoch = spec.get_current_epoch(state)
    state.exposed_derived_secrets[
        current_epoch % spec.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS] = []
    # un-freeze withdrawability for validators with no open challenge
    open_records = [
        r for r in list(state.custody_chunk_challenge_records)
        + list(state.custody_bit_challenge_records)
        if r != type(r)()
    ]
    frozen = set(r.challenger_index for r in open_records) | \
        set(r.responder_index for r in open_records)
    for index, validator in enumerate(state.validator_registry):
        if index not in frozen:
            if validator.exit_epoch != spec.FAR_FUTURE_EPOCH and \
                    validator.withdrawable_epoch == spec.FAR_FUTURE_EPOCH:
                validator.withdrawable_epoch = \
                    validator.exit_epoch + spec.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
