"""Slot-advance sanity scenarios (process_slots with no blocks).

Per consensus-specs specs/core/0_beacon-chain.md:1221-1245: every slot
caches the state root and rotates the block-root history; epoch boundaries
trigger process_epoch.
"""
from __future__ import annotations

from .. import factories as f
from . import Case, install_pytests


def _slide(spec, state, slots):
    yield "pre", state
    yield "slots", slots
    spec.process_slots(state, state.slot + slots)
    yield "post", state


def one_slot(spec, state):
    start_slot, start_root = state.slot, spec.hash_tree_root(state)
    yield from _slide(spec, state, 1)
    assert state.slot == start_slot + 1
    assert f.saved_state_root(spec, state, start_slot) == start_root


def two_slots(spec, state):
    yield from _slide(spec, state, 2)


def one_empty_epoch(spec, state):
    yield from _slide(spec, state, spec.SLOTS_PER_EPOCH)


def two_empty_epochs(spec, state):
    yield from _slide(spec, state, spec.SLOTS_PER_EPOCH * 2)


def straddling_the_boundary(spec, state):
    spec.process_slots(state, state.slot + spec.SLOTS_PER_EPOCH // 2)
    yield from _slide(spec, state, spec.SLOTS_PER_EPOCH)


CASES = [
    Case("slots_1", build=one_slot),
    Case("slots_2", build=two_slots),
    Case("empty_epoch", build=one_empty_epoch),
    Case("double_empty_epoch", build=two_empty_epochs),
    Case("over_epoch_boundary", build=straddling_the_boundary),
]


def execute(spec, state, case):
    yield from case.build(spec, state)


install_pytests(globals(), CASES, execute)
