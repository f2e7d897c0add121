"""process_transfer scenario table.

Validity rules per consensus-specs specs/core/0_beacon-chain.md:1801-1832:
balance covers amount+fee, exact slot, sender withdrawable / never
activated / only-excess-above-max-effective, no dust on either side,
pubkey matches withdrawal credentials, valid signature.
"""
from __future__ import annotations

from .. import factories as f
from ..runners import run_transfer_processing
from . import Case, install_pytests


def _never_eligible(spec, state, transfer):
    state.validator_registry[transfer.sender].activation_eligibility_epoch = \
        spec.FAR_FUTURE_EPOCH


def _never_activated(spec, state, transfer):
    state.validator_registry[transfer.sender].activation_epoch = spec.FAR_FUTURE_EPOCH


def _whole_balance(spec, state):
    transfer = f.funds_transfer(spec, state, signed=True)
    _never_eligible(spec, state, transfer)
    return transfer


def _withdrawable_sender(spec, state):
    f.advance_epoch(spec, state)
    f.transition_with_empty_block(spec, state)
    transfer = f.funds_transfer(spec, state, signed=True)
    state.validator_registry[transfer.sender].withdrawable_epoch = \
        spec.get_current_epoch(state) - 1
    return transfer


def _excess(spec, state, *, amount, fee):
    sender = spec.get_active_validator_indices(state, spec.get_current_epoch(state))[-1]
    state.balances[sender] = spec.MAX_EFFECTIVE_BALANCE + 1
    return f.funds_transfer(spec, state, sender=sender, amount=amount, fee=fee,
                            signed=True)


def _unsigned(spec, state):
    transfer = f.funds_transfer(spec, state)
    _never_eligible(spec, state, transfer)
    return transfer


def _active_digging_into_stake(spec, state):
    sender = spec.get_active_validator_indices(state, spec.get_current_epoch(state))[-1]
    state.balances[sender] = spec.MAX_EFFECTIVE_BALANCE
    return f.funds_transfer(spec, state, sender=sender,
                            amount=spec.MAX_EFFECTIVE_BALANCE // 32, fee=0,
                            signed=True)


def _at_wrong_slot(spec, state):
    transfer = f.funds_transfer(spec, state, slot=state.slot + 1, signed=True)
    _never_activated(spec, state, transfer)
    return transfer


def _exact_balance_then(spec, state, *, amount, fee):
    sender = spec.get_active_validator_indices(state, spec.get_current_epoch(state))[-1]
    state.balances[sender] = spec.MAX_EFFECTIVE_BALANCE
    transfer = f.funds_transfer(spec, state, sender=sender, amount=amount, fee=fee,
                                signed=True)
    _never_activated(spec, state, transfer)
    return transfer


def _sender_left_with_dust(spec, state):
    sender = spec.get_active_validator_indices(state, spec.get_current_epoch(state))[-1]
    amount = f.balance_of(state, sender) - spec.MIN_DEPOSIT_AMOUNT + 1
    transfer = f.funds_transfer(spec, state, sender=sender, amount=amount, fee=0,
                                signed=True)
    _never_activated(spec, state, transfer)
    return transfer


def _recipient_left_with_dust(spec, state):
    sender = spec.get_active_validator_indices(state, spec.get_current_epoch(state))[-1]
    state.balances[sender] = spec.MAX_EFFECTIVE_BALANCE + 1
    transfer = f.funds_transfer(spec, state, sender=sender, amount=1, fee=0,
                                signed=True)
    state.balances[transfer.recipient] = 0
    _never_activated(spec, state, transfer)
    return transfer


def _credentials_mismatch(spec, state):
    transfer = f.funds_transfer(spec, state, signed=True)
    state.validator_registry[transfer.sender].withdrawal_credentials = spec.ZERO_HASH
    _never_activated(spec, state, transfer)
    return transfer


CASES = [
    Case("success_non_activated", build=_whole_balance),
    Case("success_withdrawable", build=_withdrawable_sender),
    Case("success_active_above_max_effective",
         build=lambda spec, state: _excess(spec, state, amount=1, fee=0)),
    Case("success_active_above_max_effective_fee",
         build=lambda spec, state: _excess(spec, state, amount=0, fee=1)),
    Case("invalid_signature", valid=False, bls=True, build=_unsigned),
    Case("active_but_transfer_past_effective_balance", valid=False,
         build=_active_digging_into_stake),
    Case("incorrect_slot", valid=False, build=_at_wrong_slot),
    Case("insufficient_balance_for_fee", valid=False,
         build=lambda spec, state: _exact_balance_then(spec, state, amount=0, fee=1)),
    Case("insufficient_balance", valid=False,
         build=lambda spec, state: _exact_balance_then(spec, state, amount=1, fee=0)),
    Case("no_dust_sender", valid=False, build=_sender_left_with_dust),
    Case("no_dust_recipient", valid=False, build=_recipient_left_with_dust),
    Case("invalid_pubkey", valid=False, build=_credentials_mismatch),
]


def execute(spec, state, case):
    transfer = case.build(spec, state)
    yield from run_transfer_processing(spec, state, transfer, case.valid)


install_pytests(globals(), CASES, execute)
