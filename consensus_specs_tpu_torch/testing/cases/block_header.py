"""process_block_header scenario table.

Validity rules per consensus-specs specs/core/0_beacon-chain.md:1576-1595:
slot match, parent-root match, unslashed proposer, proposer signature.
"""
from __future__ import annotations

from copy import deepcopy

from .. import factories as f
from ..runners import run_block_header_processing
from . import Case, install_pytests


def _good(spec, state):
    return f.empty_block_next(spec, state, signed=True)


def _wrong_slot(spec, state):
    block = f.empty_block_next(spec, state)
    block.slot = state.slot + 2  # not the slot being processed
    f.sign_proposal(spec, state, block)
    return block


def _wrong_parent(spec, state):
    block = f.empty_block_next(spec, state)
    block.parent_root = b"\x12" * 32
    f.sign_proposal(spec, state, block)
    return block


def _slashed_proposer(spec, state):
    scratch = deepcopy(state)
    f.advance_slots(spec, scratch)
    offender = spec.get_beacon_proposer_index(scratch)
    state.validator_registry[offender].slashed = True
    return f.empty_block_next(spec, state, signed=True)


CASES = [
    Case("success_block_header", build=_good),
    Case("invalid_sig_block_header", valid=False, bls=True,
         build=lambda spec, state: f.empty_block_next(spec, state)),
    Case("invalid_slot_block_header", valid=False, build=_wrong_slot),
    Case("invalid_parent_root", valid=False, build=_wrong_parent),
    Case("proposer_slashed", valid=False, build=_slashed_proposer),
]


def execute(spec, state, case):
    block = case.build(spec, state)
    yield from run_block_header_processing(spec, state, block, valid=case.valid)


install_pytests(globals(), CASES, execute)
