"""Genesis state and transition entry points (bound as methods of Phase0Spec; port
of consensus_specs_tpu/models/phase0/genesis.py).

Semantics per consensus-specs specs/core/0_beacon-chain.md:1157-1245.
"""
from __future__ import annotations


def get_genesis_beacon_state(spec, deposits, genesis_time: int, genesis_eth1_data):
    state = spec.BeaconState(
        genesis_time=genesis_time,
        latest_eth1_data=genesis_eth1_data,
        latest_block_header=spec.BeaconBlockHeader(body_root=spec.hash_tree_root(spec.BeaconBlockBody())),
    )

    # Process genesis deposits
    for deposit in deposits:
        spec.process_deposit(state, deposit)

    # Process genesis activations
    for validator in state.validator_registry:
        if validator.effective_balance >= spec.MAX_EFFECTIVE_BALANCE:
            validator.activation_eligibility_epoch = spec.GENESIS_EPOCH
            validator.activation_epoch = spec.GENESIS_EPOCH

    # Populate latest_active_index_roots (typ given explicitly: may be empty)
    from ...utils.ssz.typing import List as SSZList, uint64
    genesis_active_index_root = spec.hash_tree_root(
        spec.get_active_validator_indices(state, spec.GENESIS_EPOCH), SSZList[uint64])
    for index in range(spec.LATEST_ACTIVE_INDEX_ROOTS_LENGTH):
        state.latest_active_index_roots[index] = genesis_active_index_root

    return state


def get_genesis_block(spec, genesis_state):
    return spec.BeaconBlock(state_root=spec.hash_tree_root(genesis_state))


def state_transition(spec, state, block, validate_state_root: bool = False):
    # Catch up empty slots, then apply the block
    spec.process_slots(state, block.slot)
    spec.process_block(state, block)
    if validate_state_root:
        assert block.state_root == spec.hash_tree_root(state)
    return state


def process_slots(spec, state, slot: int) -> None:
    assert state.slot <= slot
    while state.slot < slot:
        spec.process_slot(state)
        # Process epoch on the first slot of the next epoch
        if (state.slot + 1) % spec.SLOTS_PER_EPOCH == 0:
            spec.process_epoch(state)
        state.slot += 1


def process_slot(spec, state) -> None:
    # Cache state root
    previous_state_root = spec.hash_tree_root(state)
    state.latest_state_roots[state.slot % spec.SLOTS_PER_HISTORICAL_ROOT] = previous_state_root

    # Cache latest block header state root
    if state.latest_block_header.state_root == spec.ZERO_HASH:
        state.latest_block_header.state_root = previous_state_root

    # Cache block root
    previous_block_root = spec.signing_root(state.latest_block_header)
    state.latest_block_roots[state.slot % spec.SLOTS_PER_HISTORICAL_ROOT] = previous_block_root
