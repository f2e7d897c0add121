"""process_registry_updates scenario table.

Per consensus-specs specs/core/0_beacon-chain.md:1479-1503: eligible
validators enter the activation queue and activate after the delay;
validators under EJECTION_BALANCE get exit-initiated.
"""
from __future__ import annotations

from .. import factories as f
from . import Case, install_pytests


def _at_epoch_end_run(spec, state):
    """Seal the epoch's last slot, run the sub-transitions preceding
    registry updates, then yield around process_registry_updates."""
    target = state.slot + (spec.SLOTS_PER_EPOCH - state.slot % spec.SLOTS_PER_EPOCH) - 1
    block = f.empty_block_next(spec, state)
    block.slot = target
    f.sign_proposal(spec, state, block)
    f.apply_and_seal(spec, state, block)

    spec.process_slot(state)
    spec.process_justification_and_finalization(state)
    spec.process_crosslinks(state)
    spec.process_rewards_and_penalties(state)

    yield "pre", state
    spec.process_registry_updates(state)
    yield "post", state


def activation(spec, state):
    index = 0
    subject = state.validator_registry[index]
    # stage a fresh, not-yet-eligible validator with a full deposit
    subject.activation_eligibility_epoch = spec.FAR_FUTURE_EPOCH
    subject.activation_epoch = spec.FAR_FUTURE_EPOCH
    subject.effective_balance = spec.MAX_EFFECTIVE_BALANCE
    assert not spec.is_active_validator(subject, spec.get_current_epoch(state))

    for _ in range(spec.ACTIVATION_EXIT_DELAY + 1):
        f.advance_epoch(spec, state)

    yield from _at_epoch_end_run(spec, state)

    subject = state.validator_registry[index]
    assert subject.activation_eligibility_epoch != spec.FAR_FUTURE_EPOCH
    assert subject.activation_epoch != spec.FAR_FUTURE_EPOCH
    assert spec.is_active_validator(subject, spec.get_current_epoch(state))


def ejection(spec, state):
    index = 0
    subject = state.validator_registry[index]
    assert spec.is_active_validator(subject, spec.get_current_epoch(state))
    assert subject.exit_epoch == spec.FAR_FUTURE_EPOCH

    subject.effective_balance = spec.EJECTION_BALANCE

    for _ in range(spec.ACTIVATION_EXIT_DELAY + 1):
        f.advance_epoch(spec, state)

    yield from _at_epoch_end_run(spec, state)

    subject = state.validator_registry[index]
    assert subject.exit_epoch != spec.FAR_FUTURE_EPOCH
    assert not spec.is_active_validator(subject, spec.get_current_epoch(state))


def churn_limit_saturation(spec, state):
    """More queued validators than the churn limit: exactly churn-many
    dequeue per epoch, in activation-eligibility order with index ties
    broken stably (0_beacon-chain.md:1493-1503)."""
    n_queued = spec.get_churn_limit(state) + 2
    queued = list(range(n_queued))
    for i in queued:
        v = state.validator_registry[i]
        # long-eligible but never dequeued (activation still unset)
        v.activation_eligibility_epoch = 0
        v.activation_epoch = spec.FAR_FUTURE_EPOCH
    # the spec recomputes the limit on the MUTATED state at dequeue time
    churn = spec.get_churn_limit(state)
    assert churn + 2 >= n_queued   # limit must not have grown past the queue

    yield from _at_epoch_end_run(spec, state)

    dequeued = [i for i in queued
                if state.validator_registry[i].activation_epoch
                != spec.FAR_FUTURE_EPOCH]
    # stable sort on equal eligibility epochs -> lowest indices first
    assert dequeued == queued[:churn]
    assert len(dequeued) == churn < n_queued


def eligibility_order_beats_index_order(spec, state):
    """A later-index validator with an EARLIER eligibility epoch dequeues
    ahead of an earlier-index one (sort key is eligibility, not index)."""
    churn = spec.get_churn_limit(state)
    n_queued = churn + 1
    # index 0 gets the LATEST eligibility; the rest get progressively
    # earlier ones, so index 0 must be the one left behind
    for pos, i in enumerate(range(n_queued)):
        v = state.validator_registry[i]
        v.activation_eligibility_epoch = n_queued - pos
        v.activation_epoch = spec.FAR_FUTURE_EPOCH
    # the outcome below assumes the dequeue-time limit leaves exactly one
    # queued validator behind; pin it against the MUTATED state
    assert spec.get_churn_limit(state) == n_queued - 1

    yield from _at_epoch_end_run(spec, state)

    assert state.validator_registry[0].activation_epoch == spec.FAR_FUTURE_EPOCH
    for i in range(1, n_queued):
        assert state.validator_registry[i].activation_epoch \
            != spec.FAR_FUTURE_EPOCH, i


CASES = [
    Case("activation", build=activation),
    Case("ejection", build=ejection),
    Case("churn_limit_saturation", build=churn_limit_saturation),
    Case("eligibility_order_beats_index_order",
         build=eligibility_order_beats_index_order),
]


def execute(spec, state, case):
    yield from case.build(spec, state)


install_pytests(globals(), CASES, execute)
