"""process_proposer_slashing scenario table.

Validity rules per consensus-specs specs/core/0_beacon-chain.md:1647-1667:
same epoch, different headers, both signatures valid, offender slashable.
"""
from __future__ import annotations

from .. import factories as f
from ..keys import privkeys
from ..runners import run_proposer_slashing_processing
from . import Case, install_pytests


def _signed(spec, state):
    return f.double_proposal(spec, state, sign_first=True, sign_second=True)


def _offender(state, op):
    return state.validator_registry[op.proposer_index]


def _epochs_differ(spec, state):
    op = f.double_proposal(spec, state, sign_first=True)
    op.header_2.slot += spec.SLOTS_PER_EPOCH
    f.sign_header(spec, state, op.header_2, privkeys[op.proposer_index])
    return op


def _identical_headers(spec, state):
    op = f.double_proposal(spec, state, sign_first=True)
    op.header_2 = op.header_1
    return op


def _not_yet_active(spec, state):
    op = _signed(spec, state)
    _offender(state, op).activation_epoch = spec.get_current_epoch(state) + 1
    return op


def _already_slashed(spec, state):
    op = _signed(spec, state)
    _offender(state, op).slashed = True
    return op


def _withdrawn(spec, state):
    op = _signed(spec, state)
    state.slot += spec.SLOTS_PER_EPOCH  # so current_epoch - 1 is representable
    _offender(state, op).withdrawable_epoch = spec.get_current_epoch(state) - 1
    return op


def _index_out_of_range(spec, state):
    op = _signed(spec, state)
    op.proposer_index = len(state.validator_registry)
    return op


CASES = [
    Case("success", build=_signed),
    Case("invalid_sig_1", valid=False, bls=True,
         build=lambda spec, state: f.double_proposal(spec, state, sign_second=True)),
    Case("invalid_sig_2", valid=False, bls=True,
         build=lambda spec, state: f.double_proposal(spec, state, sign_first=True)),
    Case("invalid_sig_1_and_2", valid=False, bls=True,
         build=lambda spec, state: f.double_proposal(spec, state)),
    Case("invalid_proposer_index", valid=False, build=_index_out_of_range),
    Case("epochs_are_different", valid=False, build=_epochs_differ),
    Case("headers_are_same", valid=False, build=_identical_headers),
    Case("proposer_is_not_activated", valid=False, build=_not_yet_active),
    Case("proposer_is_slashed", valid=False, build=_already_slashed),
    Case("proposer_is_withdrawn", valid=False, build=_withdrawn),
]


def execute(spec, state, case):
    op = case.build(spec, state)
    yield from run_proposer_slashing_processing(spec, state, op, case.valid)


install_pytests(globals(), CASES, execute)
