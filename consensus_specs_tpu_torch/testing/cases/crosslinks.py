"""process_crosslinks scenario table.

Per consensus-specs specs/core/0_beacon-chain.md:1377-1387 (+ the winning-
crosslink argmax :1308-1322 and crosslink deltas :1445-1463): crosslinks
update only from winning attestations; stale re-votes must not re-update,
and their committees are penalized.
"""
from __future__ import annotations

from copy import deepcopy

from .. import factories as f
from . import Case, install_pytests


def _at_epoch_end_run(spec, state):
    """Advance to the epoch's last slot via a sealed block, run the earlier
    epoch sub-transitions, then yield around process_crosslinks."""
    target = state.slot + (spec.SLOTS_PER_EPOCH - state.slot % spec.SLOTS_PER_EPOCH) - 1
    block = f.empty_block_next(spec, state)
    block.slot = target
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    spec.process_slot(state)
    spec.process_justification_and_finalization(state)

    yield "pre", state
    spec.process_crosslinks(state)
    yield "post", state


def no_attestations(spec, state):
    yield from _at_epoch_end_run(spec, state)
    for shard in range(spec.SHARD_COUNT):
        assert state.previous_crosslinks[shard] == state.current_crosslinks[shard]


def _full_vote_in(spec, state, inclusion_offset):
    f.advance_epoch(spec, state)
    att = f.new_attestation(spec, state, signed=True)
    f.participate_all(spec, state, att)
    f.include_attestation(spec, state, att, state.slot + inclusion_offset)
    return att


def update_from_current_epoch(spec, state):
    att = _full_vote_in(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    assert len(state.current_epoch_attestations) == 1
    shard = att.data.crosslink.shard
    before = deepcopy(state.current_crosslinks[shard])
    yield from _at_epoch_end_run(spec, state)
    assert state.previous_crosslinks[shard] != state.current_crosslinks[shard]
    assert before != state.current_crosslinks[shard]


def update_from_previous_epoch(spec, state):
    att = _full_vote_in(spec, state, spec.SLOTS_PER_EPOCH)
    assert len(state.previous_epoch_attestations) == 1
    shard = att.data.crosslink.shard
    before = deepcopy(state.current_crosslinks[shard])
    rewards, penalties = spec.get_crosslink_deltas(state)
    yield from _at_epoch_end_run(spec, state)
    assert state.previous_crosslinks[shard] != state.current_crosslinks[shard]
    assert before != state.current_crosslinks[shard]
    # full participation: everyone in the committee earns, nobody pays
    committee = spec.get_crosslink_committee(
        state, att.data.target_epoch, att.data.crosslink.shard)
    for member in committee:
        assert rewards[member] > 0
        assert penalties[member] == 0


def double_late_crosslink(spec, state):
    if spec.get_epoch_committee_count(state, spec.get_current_epoch(state)) < spec.SHARD_COUNT:
        return  # needs every shard crossed per epoch; preset too small
    f.advance_epoch(spec, state)
    state.slot += 4

    vote_1 = f.new_attestation(spec, state, signed=True)
    f.participate_all(spec, state, vote_1)

    # vote_1 lands one epoch late
    f.advance_epoch(spec, state)
    f.include_attestation(spec, state, vote_1, state.slot + 1)

    # find a second vote on the same shard
    for _ in range(spec.SLOTS_PER_EPOCH):
        vote_2 = f.new_attestation(spec, state)
        if vote_2.data.crosslink.shard == vote_1.data.crosslink.shard:
            f.endorse(spec, state, vote_2)
            break
        f.advance_slots(spec, state)
    f.transition_with_empty_block(spec, state)
    f.participate_all(spec, state, vote_2)

    # vote_2 lands after vote_1 already moved the crosslink
    f.advance_epoch(spec, state)
    f.include_attestation(spec, state, vote_2, state.slot + 1)

    assert len(state.previous_epoch_attestations) == 1
    assert len(state.current_epoch_attestations) == 0

    rewards, penalties = spec.get_crosslink_deltas(state)
    yield from _at_epoch_end_run(spec, state)

    shard = vote_2.data.crosslink.shard
    # stale second vote: no further update, and its committee pays
    assert state.previous_crosslinks[shard] == state.current_crosslinks[shard]
    committee = spec.get_crosslink_committee(
        state, vote_2.data.target_epoch, vote_2.data.crosslink.shard)
    for member in committee:
        assert rewards[member] == 0
        assert penalties[member] > 0


CASES = [
    Case("no_attestations", build=no_attestations),
    Case("single_crosslink_update_from_current_epoch", build=update_from_current_epoch),
    Case("single_crosslink_update_from_previous_epoch", build=update_from_previous_epoch),
    Case("double_late_crosslink", build=double_late_crosslink),
]


def execute(spec, state, case):
    yield from case.build(spec, state)


install_pytests(globals(), CASES, execute)
