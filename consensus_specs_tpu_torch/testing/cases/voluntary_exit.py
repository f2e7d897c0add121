"""process_voluntary_exit scenario table.

Validity rules per consensus-specs specs/core/0_beacon-chain.md:1778-1799:
active, not already exiting, epoch reached, active long enough
(PERSISTENT_COMMITTEE_PERIOD), valid signature. The queue case checks churn
spill-over into the next exit epoch.
"""
from __future__ import annotations

from .. import factories as f
from ..keys import pubkey_to_privkey
from ..runners import run_voluntary_exit_processing
from . import Case, install_pytests


def _mature(spec, state):
    state.slot += spec.PERSISTENT_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH


def _nth_active(spec, state, n):
    return spec.get_active_validator_indices(state, spec.get_current_epoch(state))[n]


def _simple(spec, state, *, signed=True):
    _mature(spec, state)
    return f.exit_notice(spec, state, _nth_active(spec, state, 0), signed=signed)


def _future_epoch(spec, state):
    _mature(spec, state)
    index = _nth_active(spec, state, 0)
    op = f.exit_notice(spec, state, index)
    op.epoch += 1
    f.sign_exit(spec, state, op, pubkey_to_privkey(state.validator_registry[index].pubkey))
    return op


def _unknown_index(spec, state):
    _mature(spec, state)
    index = _nth_active(spec, state, 0)
    op = f.exit_notice(spec, state, index)
    op.validator_index = len(state.validator_registry)
    f.sign_exit(spec, state, op, pubkey_to_privkey(state.validator_registry[index].pubkey))
    return op


def _inactive(spec, state):
    index = _nth_active(spec, state, 0)
    state.validator_registry[index].activation_epoch = spec.FAR_FUTURE_EPOCH
    return f.exit_notice(spec, state, index, signed=True)


def _already_leaving(spec, state):
    _mature(spec, state)
    index = _nth_active(spec, state, 0)
    state.validator_registry[index].exit_epoch = spec.get_current_epoch(state) + 2
    return f.exit_notice(spec, state, index, signed=True)


def _too_young(spec, state):
    index = _nth_active(spec, state, 0)
    op = f.exit_notice(spec, state, index, signed=True)
    activation = state.validator_registry[index].activation_epoch
    assert spec.get_current_epoch(state) - activation < spec.PERSISTENT_COMMITTEE_PERIOD
    return op


CASES = [
    Case("success", build=_simple),
    Case("invalid_signature", valid=False, bls=True,
         build=lambda spec, state: _simple(spec, state, signed=False)),
    Case("validator_exit_in_future", valid=False, build=_future_epoch),
    Case("validator_invalid_validator_index", valid=False, build=_unknown_index),
    Case("validator_not_active", valid=False, build=_inactive),
    Case("validator_already_exited", valid=False, build=_already_leaving),
    Case("validator_not_active_long_enough", valid=False, build=_too_young),
]


def execute(spec, state, case):
    op = case.build(spec, state)
    yield from run_voluntary_exit_processing(spec, state, op, case.valid)


# churn-queue spill-over needs multi-op orchestration: kept as an explicit
# scenario rather than a table row
def _queue_scenario(spec, state):
    _mature(spec, state)
    epoch = spec.get_current_epoch(state)
    head_of_queue = spec.get_active_validator_indices(state, epoch)[:spec.get_churn_limit(state)]
    for index in head_of_queue:
        notice = f.exit_notice(spec, state, index, signed=True)
        for _ in run_voluntary_exit_processing(spec, state, notice):
            continue
    # the churn limit is full: one more exit lands an epoch later
    straggler = spec.get_active_validator_indices(state, epoch)[-1]
    notice = f.exit_notice(spec, state, straggler, signed=True)
    yield from run_voluntary_exit_processing(spec, state, notice)
    assert (state.validator_registry[straggler].exit_epoch
            == state.validator_registry[head_of_queue[0]].exit_epoch + 1)


install_pytests(globals(), CASES, execute)
install_pytests(globals(), [Case("success_exit_queue", build=None)],
                lambda spec, state, case: _queue_scenario(spec, state))
