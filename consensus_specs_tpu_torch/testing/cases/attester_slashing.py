"""process_attester_slashing scenario table.

Validity rules per consensus-specs specs/core/0_beacon-chain.md:1669-1690:
the two votes must be slashable together (double or surround), signatures
must verify, and at least one participant must still be slashable.
"""
from __future__ import annotations

from .. import factories as f
from ..runners import run_attester_slashing_processing
from . import Case, install_pytests


def _both_signed(spec, state):
    return f.double_vote(spec, state, sign_first=True, sign_second=True)


def _participants(op):
    vote = op.attestation_1
    return list(vote.custody_bit_0_indices) + list(vote.custody_bit_1_indices)


def _surround(spec, state):
    f.advance_epoch(spec, state)
    f.transition_with_empty_block(spec, state)
    state.current_justified_epoch += 1
    op = f.double_vote(spec, state, sign_second=True)
    # widen vote 1 so it surrounds vote 2
    op.attestation_1.data.source_epoch = op.attestation_2.data.source_epoch - 1
    op.attestation_1.data.target_epoch = op.attestation_2.data.target_epoch + 1
    f.endorse_indexed(spec, state, op.attestation_1)
    return op


def _same_data(spec, state):
    op = f.double_vote(spec, state, sign_second=True)
    op.attestation_1.data = op.attestation_2.data
    f.endorse_indexed(spec, state, op.attestation_1)
    return op


def _not_slashable(spec, state):
    op = f.double_vote(spec, state, sign_second=True)
    op.attestation_1.data.target_epoch += 1  # neither double nor surround now
    f.endorse_indexed(spec, state, op.attestation_1)
    return op


def _all_already_slashed(spec, state):
    op = _both_signed(spec, state)
    for index in _participants(op):
        state.validator_registry[index].slashed = True
    return op


def _both_custody_bits(spec, state):
    op = f.double_vote(spec, state, sign_second=True)
    op.attestation_1.custody_bit_1_indices = op.attestation_1.custody_bit_0_indices
    f.endorse_indexed(spec, state, op.attestation_1)
    return op


CASES = [
    Case("success_double", build=_both_signed),
    Case("success_surround", build=_surround),
    Case("invalid_sig_1", valid=False, bls=True,
         build=lambda spec, state: f.double_vote(spec, state, sign_second=True)),
    Case("invalid_sig_2", valid=False, bls=True,
         build=lambda spec, state: f.double_vote(spec, state, sign_first=True)),
    Case("invalid_sig_1_and_2", valid=False, bls=True,
         build=lambda spec, state: f.double_vote(spec, state)),
    Case("same_data", valid=False, build=_same_data),
    Case("no_double_or_surround", valid=False, build=_not_slashable),
    Case("participants_already_slashed", valid=False, build=_all_already_slashed),
    Case("custody_bit_0_and_1", valid=False, build=_both_custody_bits),
]


def execute(spec, state, case):
    op = case.build(spec, state)
    yield from run_attester_slashing_processing(spec, state, op, case.valid)


install_pytests(globals(), CASES, execute)
