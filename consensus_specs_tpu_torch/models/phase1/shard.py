"""Shard data chains: persistent committees, shard blocks, validity rules.

Contract: consensus-specs specs/core/1_shard-data-chains.md — period/
persistent committees :122-177 (two-period gradual handover), shard
proposer :182-198, header/signature helpers :200-236, crosslink data root
:241-265, validity predicates :280-406. All functions bind as Phase1Spec
methods (`spec` first).

Port of consensus_specs_tpu/models/phase1/shard.py. The committee math
(compute_committee -> swap-or-not) rides the phase-0 batched permutation
(ops/shuffle.py on the spec's device from 2^13 indices up); shard
signatures go through `spec.bls` (TorchBackend's kernels on the card);
the validity predicates are control-flow-heavy host logic by design (they
walk recursively-defined valid-block sets).
"""
from __future__ import annotations

from typing import List, Optional, Sequence


# ---------------------------------------------------------------------------
# Committees
# ---------------------------------------------------------------------------

def get_period_committee(spec, state, epoch: int, shard: int, index: int,
                         count: int) -> List[int]:
    """Committee `index` of `count` for `shard` in the period containing
    `epoch` (:122-136)."""
    return spec.compute_committee(
        indices=spec.get_active_validator_indices(state, epoch),
        seed=spec.generate_seed(state, epoch),
        index=shard * count + index,
        count=spec.SHARD_COUNT * count,
    )


def get_switchover_epoch(spec, state, epoch: int, index: int) -> int:
    # epochs clamp at genesis: before two full periods have elapsed the
    # "earlier" period is the genesis period (the reference implicitly
    # assumes epoch >= 2 periods; phase 1 activates long after genesis)
    earlier_start = max(0, epoch - (epoch % spec.PERSISTENT_COMMITTEE_PERIOD)
                        - spec.PERSISTENT_COMMITTEE_PERIOD * 2)
    mixed = spec.hash(spec.generate_seed(state, earlier_start)
                      + spec.int_to_bytes(index, length=8))
    return spec.bytes_to_int(mixed[0:8]) % spec.PERSISTENT_COMMITTEE_PERIOD


def get_persistent_committee(spec, state, shard: int, slot: int) -> List[int]:
    """The persistent committee for (shard, slot): members hand over
    gradually between the two periods' committees (:150-177)."""
    epoch = spec.slot_to_epoch(slot)
    period = spec.PERSISTENT_COMMITTEE_PERIOD
    earlier_start = max(0, epoch - (epoch % period) - period * 2)
    later_start = max(0, epoch - (epoch % period) - period)

    committee_count = max(
        len(spec.get_active_validator_indices(state, earlier_start))
        // (spec.SHARD_COUNT * spec.TARGET_COMMITTEE_SIZE),
        len(spec.get_active_validator_indices(state, later_start))
        // (spec.SHARD_COUNT * spec.TARGET_COMMITTEE_SIZE),
    ) + 1

    index = slot % committee_count
    earlier = spec.get_period_committee(state, earlier_start, shard, index, committee_count)
    later = spec.get_period_committee(state, later_start, shard, index, committee_count)

    offset = epoch % period
    members = set(
        [i for i in earlier if offset < spec.get_switchover_epoch(state, epoch, i)]
        + [i for i in later if offset >= spec.get_switchover_epoch(state, epoch, i)]
    )
    return sorted(members)


def get_shard_proposer_index(spec, state, shard: int, slot: int) -> Optional[int]:
    """First active member of the randomly-rotated persistent committee
    (:182-198); None when nobody is active."""
    committee = spec.get_persistent_committee(state, shard, slot)
    if not committee:
        return None
    seed = spec.hash(spec.generate_seed(state, spec.get_current_epoch(state))
                     + spec.int_to_bytes(shard, length=8)
                     + spec.int_to_bytes(slot, length=8))
    rotation = spec.bytes_to_int(seed[0:8]) % len(committee)
    rotated = committee[rotation:] + committee[:rotation]
    current_epoch = spec.get_current_epoch(state)
    for index in rotated:
        if spec.is_active_validator(state.validator_registry[index], current_epoch):
            return index
    return None


# ---------------------------------------------------------------------------
# Headers and signatures
# ---------------------------------------------------------------------------

def get_shard_header(spec, block):
    return spec.ShardBlockHeader(
        slot=block.slot,
        shard=block.shard,
        beacon_chain_root=block.beacon_chain_root,
        parent_root=block.parent_root,
        body_root=spec.hash_tree_root(block.data),
        state_root=block.state_root,
        attestations=list(block.attestations),
        signature=block.signature,
    )


def verify_shard_attestation_signature(spec, state, attestation) -> None:
    data = attestation.data
    committee = spec.get_persistent_committee(state, data.shard, data.slot)
    assert spec.verify_bitfield(attestation.aggregation_bitfield, len(committee))
    current_epoch = spec.get_current_epoch(state)
    pubkeys = []
    for i, index in enumerate(committee):
        if spec.get_bitfield_bit(attestation.aggregation_bitfield, i) == 0b1:
            validator = state.validator_registry[index]
            assert spec.is_active_validator(validator, current_epoch)
            pubkeys.append(validator.pubkey)
    assert spec.bls.bls_verify(
        spec.bls.bls_aggregate_pubkeys(pubkeys),
        data.shard_block_root,
        attestation.aggregate_signature,
        spec.get_domain(state, spec.DOMAIN_SHARD_ATTESTER,
                        spec.slot_to_epoch(data.slot)),
    )


def compute_crosslink_data_root(spec, blocks: Sequence) -> bytes:
    """Root binding a crosslink to its shard blocks: H(headers root ||
    bodies root) over power-of-two-padded per-block chunk roots (:241-265)."""
    from ...utils.ssz.impl import serialize
    from ...utils.ssz.typing import Bytes32, List as SSZList

    body_len = spec.BYTES_PER_SHARD_BLOCK_BODY

    def chunked_root(data: bytes) -> bytes:
        padded = bytes(data) + b"\x00" * (-len(data) % 32)
        chunks = [padded[i:i + 32] for i in range(0, len(padded), 32)] or [b"\x00" * 32]
        return spec.hash_tree_root(chunks, SSZList[Bytes32])

    zero_root_cache = []

    def padded_roots(roots: List[bytes]) -> List[bytes]:
        out = list(roots)
        while len(out) & (len(out) - 1) or not out:
            if not zero_root_cache:   # hash the 16 KiB zero body at most once
                zero_root_cache.append(chunked_root(b"\x00" * body_len))
            out.append(zero_root_cache[0])
        return out

    header_roots = [
        chunked_root(serialize(spec.get_shard_header(b)).ljust(body_len, b"\x00"))
        for b in blocks
    ]
    body_roots = [chunked_root(bytes(b.data.data).ljust(body_len, b"\x00"))
                  for b in blocks]
    return spec.hash(
        spec.hash_tree_root(padded_roots(header_roots), SSZList[Bytes32])
        + spec.hash_tree_root(padded_roots(body_roots), SSZList[Bytes32])
    )


# ---------------------------------------------------------------------------
# Validity predicates (:280-406)
# ---------------------------------------------------------------------------

def is_valid_shard_block(spec, beacon_blocks, beacon_state,
                         valid_shard_blocks, candidate) -> bool:
    for block in valid_shard_blocks:
        if candidate == block:
            return True

    assert candidate.slot >= spec.PHASE_1_FORK_SLOT
    assert candidate.shard <= spec.SHARD_COUNT

    beacon_block = beacon_blocks[candidate.slot]
    assert candidate.beacon_chain_root == spec.signing_root(beacon_block)
    assert beacon_block.slot <= candidate.slot

    assert candidate.state_root == spec.ZERO_HASH  # [until phase 2]

    if candidate.slot == spec.PHASE_1_FORK_SLOT:
        assert candidate.parent_root == spec.ZERO_HASH
    else:
        parent = next(
            (b for b in valid_shard_blocks
             if spec.signing_root(b) == candidate.parent_root), None)
        assert parent is not None
        assert parent.shard == candidate.shard
        assert parent.slot < candidate.slot
        assert spec.signing_root(beacon_blocks[parent.slot]) == parent.beacon_chain_root

    assert len(candidate.attestations) <= spec.MAX_SHARD_ATTESTIONS
    for attestation in candidate.attestations:
        assert max(spec.GENESIS_SHARD_SLOT,
                   candidate.slot - spec.SLOTS_PER_EPOCH) <= attestation.data.slot
        assert attestation.data.slot <= \
            candidate.slot - spec.MIN_ATTESTATION_INCLUSION_DELAY
        assert attestation.data.shard == candidate.shard
        spec.verify_shard_attestation_signature(beacon_state, attestation)

    proposer_index = spec.get_shard_proposer_index(
        beacon_state, candidate.shard, candidate.slot)
    assert proposer_index is not None
    assert spec.bls.bls_verify(
        beacon_state.validator_registry[proposer_index].pubkey,
        spec.signing_root(candidate),
        candidate.signature,
        spec.get_domain(beacon_state, spec.DOMAIN_SHARD_PROPOSER,
                        spec.slot_to_epoch(candidate.slot)),
    )
    return True


def is_valid_shard_attestation(spec, valid_shard_blocks, beacon_state,
                               candidate) -> bool:
    shard_block = next(
        (b for b in valid_shard_blocks
         if spec.signing_root(b) == candidate.data.shard_block_root), None)
    assert shard_block is not None
    assert shard_block.slot == candidate.data.slot
    assert shard_block.shard == candidate.data.shard
    spec.verify_shard_attestation_signature(beacon_state, candidate)
    return True


def is_valid_beacon_attestation(spec, shard: int, shard_blocks, beacon_state,
                                valid_attestations, candidate) -> bool:
    for attestation in valid_attestations:
        if candidate == attestation:
            return True

    # previous-crosslink continuity
    if candidate.data.crosslink.start_epoch <= spec.PHASE_1_FORK_EPOCH:
        assert candidate.data.crosslink.parent_root == spec.ZERO_HASH
    else:
        previous = next(
            (a for a in valid_attestations
             if spec.hash_tree_root(a.data.crosslink) ==
             candidate.data.crosslink.parent_root), None)
        assert previous is not None

    # crosslink data root covers the canonical shard blocks from the last
    # crosslink the STATE accepted for this shard (not whatever the
    # candidate claims) up to the lookback horizon
    candidate_slot = spec.get_attestation_data_slot(beacon_state, candidate.data)
    start_epoch = beacon_state.current_crosslinks[shard].end_epoch
    end_epoch = min(spec.slot_to_epoch(candidate_slot) - spec.CROSSLINK_LOOKBACK,
                    start_epoch + spec.MAX_EPOCHS_PER_CROSSLINK)
    blocks = [shard_blocks[slot]
              for slot in range(start_epoch * spec.SLOTS_PER_EPOCH,
                                end_epoch * spec.SLOTS_PER_EPOCH)]
    assert candidate.data.crosslink.data_root == \
        spec.compute_crosslink_data_root(blocks)
    return True
