"""Casper FFG finality rules 1-4, driven epoch-by-epoch.

Per consensus-specs specs/core/0_beacon-chain.md:1326-1373 (justification
bitfield update + the four finalization rules). Each scenario runs whole
epochs of attesting blocks and asserts which checkpoints moved after each.
"""
from __future__ import annotations

from copy import deepcopy

from ...utils.ssz.typing import List as SSZList
from .. import factories as f
from . import Case, install_pytests

# (current_justified, previous_justified, finalized) movement expectations
MOVED = True
HELD = False


def _assert_checkpoints(state, prior, expectations):
    pairs = (
        ("current_justified_epoch", "current_justified_root"),
        ("previous_justified_epoch", "previous_justified_root"),
        ("finalized_epoch", "finalized_root"),
    )
    for moved, (epoch_field, root_field) in zip(expectations, pairs):
        if moved:
            assert getattr(state, epoch_field) > getattr(prior, epoch_field)
            assert getattr(state, root_field) != getattr(prior, root_field)
        else:
            assert getattr(state, epoch_field) == getattr(prior, epoch_field)
            assert getattr(state, root_field) == getattr(prior, root_field)


def attested_epoch(spec, state, *, current=False, previous=False):
    """Run one epoch of blocks, attaching current- and/or previous-epoch
    attestations to each; returns (prior_state, blocks, new_state)."""
    rolling = deepcopy(state)
    blocks = []
    for _ in range(spec.SLOTS_PER_EPOCH):
        block = f.empty_block_next(spec, rolling)
        if current:
            slot = rolling.slot - spec.MIN_ATTESTATION_INCLUSION_DELAY + 1
            if slot >= spec.get_epoch_start_slot(spec.get_current_epoch(rolling)):
                block.body.attestations.append(f.new_attestation(spec, rolling, slot))
        if previous:
            slot = rolling.slot - spec.SLOTS_PER_EPOCH + 1
            block.body.attestations.append(f.new_attestation(spec, rolling, slot))
        f.apply_and_seal(spec, rolling, block)
        blocks.append(block)
    return state, blocks, rolling


def _past_genesis_window(spec, state):
    for _ in range(2):
        f.advance_epoch(spec, state)
        f.transition_with_empty_block(spec, state)


def rule_4(spec, state):
    """Current-epoch attestations finalize the previous checkpoint."""
    yield "pre", state
    blocks = []
    for round_no in range(4):
        prior, new_blocks, state = attested_epoch(spec, state, current=True)
        blocks += new_blocks
        if round_no <= 1:
            _assert_checkpoints(state, prior, (HELD, HELD, HELD))
        elif round_no == 2:
            _assert_checkpoints(state, prior, (MOVED, HELD, HELD))
        else:
            _assert_checkpoints(state, prior, (MOVED, MOVED, MOVED))
            assert state.finalized_epoch == prior.current_justified_epoch
            assert state.finalized_root == prior.current_justified_root
    yield "blocks", blocks, SSZList[spec.BeaconBlock]
    yield "post", state


def rule_1(spec, state):
    """Previous-epoch attestations finalize two checkpoints back."""
    _past_genesis_window(spec, state)
    yield "pre", state
    blocks = []
    for round_no in range(3):
        prior, new_blocks, state = attested_epoch(spec, state, previous=True)
        blocks += new_blocks
        if round_no == 0:
            _assert_checkpoints(state, prior, (MOVED, HELD, HELD))
        elif round_no == 1:
            _assert_checkpoints(state, prior, (MOVED, MOVED, HELD))
        else:
            _assert_checkpoints(state, prior, (MOVED, MOVED, MOVED))
            assert state.finalized_epoch == prior.previous_justified_epoch
            assert state.finalized_root == prior.previous_justified_root
    yield "blocks", blocks, SSZList[spec.BeaconBlock]
    yield "post", state


def rule_2(spec, state):
    """A skipped epoch, then previous-epoch votes finalize via rule 2."""
    _past_genesis_window(spec, state)
    yield "pre", state
    blocks = []
    prior, new_blocks, state = attested_epoch(spec, state, current=True)
    blocks += new_blocks
    _assert_checkpoints(state, prior, (MOVED, HELD, HELD))

    prior, new_blocks, state = attested_epoch(spec, state)
    blocks += new_blocks
    _assert_checkpoints(state, prior, (HELD, MOVED, HELD))

    prior, new_blocks, state = attested_epoch(spec, state, previous=True)
    blocks += new_blocks
    _assert_checkpoints(state, prior, (MOVED, HELD, MOVED))
    assert state.finalized_epoch == prior.previous_justified_epoch
    assert state.finalized_root == prior.previous_justified_root
    yield "blocks", blocks, SSZList[spec.BeaconBlock]
    yield "post", state


def rule_3(spec, state):
    """Justification skips an epoch then catches up two at once
    (ethereum/eth2.0-specs#611)."""
    _past_genesis_window(spec, state)
    yield "pre", state
    blocks = []

    prior, new_blocks, state = attested_epoch(spec, state, current=True)
    blocks += new_blocks
    _assert_checkpoints(state, prior, (MOVED, HELD, HELD))

    prior, new_blocks, state = attested_epoch(spec, state, current=True)
    blocks += new_blocks
    _assert_checkpoints(state, prior, (MOVED, MOVED, MOVED))

    # an epoch with no attestations at all
    prior, new_blocks, state = attested_epoch(spec, state)
    blocks += new_blocks
    _assert_checkpoints(state, prior, (HELD, MOVED, HELD))

    # previous-epoch votes catch the skipped epoch up (rule 2)
    prior, new_blocks, state = attested_epoch(spec, state, previous=True)
    blocks += new_blocks
    _assert_checkpoints(state, prior, (MOVED, HELD, MOVED))

    # both epochs justify at once -> rule 3
    prior, new_blocks, state = attested_epoch(spec, state, current=True, previous=True)
    blocks += new_blocks
    _assert_checkpoints(state, prior, (MOVED, MOVED, MOVED))
    assert state.finalized_epoch == prior.current_justified_epoch
    assert state.finalized_root == prior.current_justified_root

    yield "blocks", blocks, SSZList[spec.BeaconBlock]
    yield "post", state


CASES = [
    Case("finality_rule_4", build=rule_4, bls=False),
    Case("finality_rule_1", build=rule_1, bls=False),
    Case("finality_rule_2", build=rule_2, bls=False),
    Case("finality_rule_3", build=rule_3, bls=False),
]


def execute(spec, state, case):
    yield from case.build(spec, state)


install_pytests(globals(), CASES, execute)
