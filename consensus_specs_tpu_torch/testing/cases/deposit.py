"""process_deposit scenario table.

Validity rules per consensus-specs specs/core/0_beacon-chain.md:1729-1776:
Merkle branch against latest_eth1_data at state.deposit_index; bad
proof-of-possession skips a NEW deposit (block remains valid) and is
ignored entirely for top-ups.
"""
from __future__ import annotations

from .. import factories as f
from ..keys import privkeys
from ..runners import run_deposit_processing
from . import Case, install_pytests


def _fresh(spec, state, *, signed):
    index = len(state.validator_registry)
    deposit = f.stage_deposit(spec, state, index, spec.MAX_EFFECTIVE_BALANCE,
                              signed=signed)
    return deposit, index


def _top_up(spec, state, *, signed, withdrawal_credentials=None):
    deposit = f.stage_deposit(
        spec, state, 0, spec.MAX_EFFECTIVE_BALANCE // 4, signed=signed,
        withdrawal_credentials=withdrawal_credentials)
    return deposit, 0


def _junk_credentials(spec, state):
    wc = spec.int_to_bytes(spec.BLS_WITHDRAWAL_PREFIX, length=1) + spec.hash(b"junk")[1:]
    return _top_up(spec, state, signed=False, withdrawal_credentials=wc)


def _index_mismatch(spec, state):
    deposit, index = _fresh(spec, state, signed=False)
    state.deposit_index += 1  # branch no longer verifies at this index
    f.sign_deposit(spec, deposit.data, privkeys[index])
    return deposit, index


def _count_root_mismatch(spec, state):
    tree = f.DepositTree(spec, [spec.ZERO_HASH] * len(state.validator_registry))
    first = tree.count
    f.enroll_deposit(spec, tree, first, spec.MAX_EFFECTIVE_BALANCE, signed=True,
                     withdrawal_credentials=b"\x00" * 32)
    count_after_first = tree.count
    second_index = tree.count
    deposit_2 = f.enroll_deposit(spec, tree, second_index,
                                 spec.MAX_EFFECTIVE_BALANCE, signed=True,
                                 withdrawal_credentials=b"\x00" * 32)
    # state: second deposit's root, but only the first deposit's count
    state.latest_eth1_data.deposit_root = tree.root()
    state.latest_eth1_data.deposit_count = count_after_first
    return deposit_2, second_index


def _corrupt_branch(spec, state):
    deposit, index = _fresh(spec, state, signed=False)
    deposit.proof[-1] = spec.ZERO_HASH
    f.sign_deposit(spec, deposit.data, privkeys[index])
    return deposit, index


CASES = [
    Case("new_deposit",
         build=lambda spec, state: _fresh(spec, state, signed=True)),
    Case("invalid_sig_new_deposit", bls=True,
         build=lambda spec, state: _fresh(spec, state, signed=False),
         run_kwargs={"effective": False}),   # skipped, block still valid
    Case("success_top_up",
         build=lambda spec, state: _top_up(spec, state, signed=True)),
    Case("invalid_sig_top_up", bls=True,     # top-ups never check the sig
         build=lambda spec, state: _top_up(spec, state, signed=False)),
    Case("invalid_withdrawal_credentials_top_up",   # nor the credentials
         build=_junk_credentials),
    Case("wrong_deposit_index", valid=False, build=_index_mismatch),
    Case("wrong_deposit_for_deposit_count", valid=False, build=_count_root_mismatch),
    Case("bad_merkle_proof", valid=False, build=_corrupt_branch),
]


def execute(spec, state, case):
    deposit, index = case.build(spec, state)
    yield from run_deposit_processing(
        spec, state, deposit, index, valid=case.valid,
        **case.run_kwargs)


install_pytests(globals(), CASES, execute)
