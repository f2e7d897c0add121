"""Deposit contract model: the eth1-side incremental Merkle accumulator
(port of consensus_specs_tpu/deposit_contract/).

A model of the upstream deposit_contract/contracts/validator_registration.v.py
(Vyper/EVM there; a host-side Python model here, with a native C++ twin in
native.py: deposit() :69-140, get_deposit_root :51-62, Eth2Genesis trigger
:128-140). contract.deposit_data_roots computes a batch of leaves on a
device.
"""
from .contract import DepositContract, DepositEvent, Eth2GenesisEvent  # noqa: F401
