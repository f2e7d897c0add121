"""Honest-validator duties: assignments, proposal construction, attesting
(copy of consensus_specs_tpu/models/phase0/validator.py).

Capability parity with the spec's validator guide
(specs/validator/0_beacon-chain-validator.md):
`get_committee_assignment` :133-158, `is_proposer` :160-166, block
proposal construction :182-276 (randao reveal :206-220, eth1 vote
:222-236, proposer signature :238-249), attestation construction
:278-361, and the crash-safe slashing-protection rules :363-389 (the
"save before broadcast" local DB).

All functions bind as spec methods (`spec` first). Signing takes explicit
privkeys — keys live with the validator client, never in consensus state.
"""
from __future__ import annotations

from typing import List, Optional, Tuple


def get_committee_assignment(spec, state, epoch: int, validator_index: int
                             ) -> Optional[Tuple[List[int], int, int]]:
    """(committee, shard, slot) where the validator attests in `epoch`
    (`epoch <= next_epoch`); None when not assigned (inactive)."""
    next_epoch = spec.get_current_epoch(state) + 1
    assert epoch <= next_epoch

    committees_per_slot = spec.get_epoch_committee_count(state, epoch) // spec.SLOTS_PER_EPOCH
    start_slot = spec.get_epoch_start_slot(epoch)
    for slot in range(start_slot, start_slot + spec.SLOTS_PER_EPOCH):
        offset = committees_per_slot * (slot % spec.SLOTS_PER_EPOCH)
        slot_start_shard = (spec.get_epoch_start_shard(state, epoch) + offset) % spec.SHARD_COUNT
        for i in range(committees_per_slot):
            shard = (slot_start_shard + i) % spec.SHARD_COUNT
            committee = spec.get_crosslink_committee(state, epoch, shard)
            if validator_index in committee:
                return committee, shard, slot
    return None


def is_proposer(spec, state, validator_index: int) -> bool:
    """Whether the validator proposes at the state's CURRENT slot (the
    state must already sit in the slot in question)."""
    return spec.get_beacon_proposer_index(state) == validator_index


# ---------------------------------------------------------------------------
# Block proposal
# ---------------------------------------------------------------------------

def get_epoch_signature(spec, state, block, privkey: int) -> bytes:
    """The randao reveal for `block` (:206-220)."""
    epoch = spec.slot_to_epoch(block.slot)
    return spec.bls.bls_sign(
        message_hash=spec.hash_tree_root(epoch),
        privkey=privkey,
        domain=spec.get_domain(state, spec.DOMAIN_RANDAO, message_epoch=epoch),
    )


def get_eth1_vote(spec, state, known_eth1_data=None):
    """The proposer's eth1 vote (:222-236): the modal pending vote, ties to
    the earliest; falls back to `known_eth1_data` (the client's own view of
    the ETH1_FOLLOW_DISTANCE-deep block) or the state's latest."""
    votes = list(state.eth1_data_votes)
    if not votes:
        return known_eth1_data if known_eth1_data is not None else state.latest_eth1_data
    best, best_count = None, 0
    for vote in votes:
        count = sum(1 for other in votes if other == vote)
        if count > best_count:
            best, best_count = vote, count
    return best


def get_block_signature(spec, state, block, privkey: int) -> bytes:
    """The proposer signature over the block's signing root (:238-249)."""
    return spec.bls.bls_sign(
        message_hash=spec.signing_root(block),
        privkey=privkey,
        domain=spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER,
                               spec.slot_to_epoch(block.slot)),
    )


def build_proposal(spec, state, slot: int, parent_root: bytes, privkey: int,
                   body=None):
    """Assemble + sign a proposal for `slot` on top of `parent_root`
    (:182-276). Runs the stub-root transition on a copy to compute the
    post-state root, exactly as the guide prescribes."""
    from copy import deepcopy

    block = spec.BeaconBlock()
    block.slot = slot
    block.parent_root = parent_root
    if body is not None:
        block.body = body
    block.body.eth1_data = spec.get_eth1_vote(state)
    block.body.randao_reveal = spec.get_epoch_signature(state, block, privkey)

    # state_root via a stubbed transition (signatures/state-root unchecked)
    from ...crypto import bls
    scratch = deepcopy(state)
    old_active = bls.bls_active
    bls.bls_active = False
    try:
        spec.state_transition(scratch, block)
    finally:
        bls.bls_active = old_active
    block.state_root = spec.hash_tree_root(scratch)
    block.signature = spec.get_block_signature(state, block, privkey)
    return block


# ---------------------------------------------------------------------------
# Attesting
# ---------------------------------------------------------------------------

def build_attestation_duty(spec, head_state, head_block_root: bytes,
                           committee: List[int], shard: int,
                           validator_index: int, privkey: Optional[int],
                           custody_bit: bool = False):
    """The validator's single-bit attestation for its assigned (committee,
    shard) at the head state's slot (:278-361). privkey None returns the
    attestation unsigned (the beacon-node API's produce path: the client
    holds the key and signs, beacon_node_oapi.yaml /validator/attestation).
    custody_bit sets the validator's proof-of-custody bit (:331-340 —
    always False in phase 0; phase 1 clients pass their computed bit)."""
    epoch_start_slot = spec.get_epoch_start_slot(spec.get_current_epoch(head_state))
    if epoch_start_slot == head_state.slot:
        target_root = head_block_root
    else:
        target_root = spec.get_block_root(head_state, spec.get_current_epoch(head_state))

    parent_crosslink = head_state.current_crosslinks[shard]
    data = spec.AttestationData(
        beacon_block_root=head_block_root,
        source_epoch=head_state.current_justified_epoch,
        source_root=head_state.current_justified_root,
        target_epoch=spec.get_current_epoch(head_state),
        target_root=target_root,
        crosslink=spec.Crosslink(
            shard=shard,
            start_epoch=parent_crosslink.end_epoch,
            end_epoch=min(spec.get_current_epoch(head_state),
                          parent_crosslink.end_epoch + spec.MAX_EPOCHS_PER_CROSSLINK),
            parent_root=spec.hash_tree_root(parent_crosslink),
            data_root=spec.ZERO_HASH,
        ),
    )

    width = (len(committee) + 7) // 8
    bits = bytearray(width)
    position = committee.index(validator_index)
    bits[position // 8] |= 1 << (position % 8)
    custody = bytearray(width)
    if custody_bit:
        custody[position // 8] |= 1 << (position % 8)

    if privkey is None:
        signature = b"\x00" * 96
    else:
        wrapped = spec.AttestationDataAndCustodyBit(data=data,
                                                    custody_bit=custody_bit)
        signature = spec.bls.bls_sign(
            message_hash=spec.hash_tree_root(wrapped),
            privkey=privkey,
            domain=spec.get_domain(head_state, spec.DOMAIN_ATTESTATION,
                                   message_epoch=data.target_epoch),
        )
    return spec.Attestation(
        aggregation_bitfield=bytes(bits),
        data=data,
        custody_bitfield=bytes(custody),
        signature=signature,
    )


# ---------------------------------------------------------------------------
# Slashing protection (:363-389) — the "save to disk before broadcast" DB
# ---------------------------------------------------------------------------

class SlashingProtection:
    """Minimal local history guarding against self-slashing: refuse double
    proposals per slot and double/surround votes per validator."""

    def __init__(self):
        self._proposed_slots = set()           # (validator, slot)
        self._votes = {}                       # validator -> [(source, target)]

    def may_propose(self, validator_index: int, slot: int) -> bool:
        return (validator_index, slot) not in self._proposed_slots

    def record_proposal(self, validator_index: int, slot: int) -> None:
        assert self.may_propose(validator_index, slot), "double proposal"
        self._proposed_slots.add((validator_index, slot))

    def may_attest(self, validator_index: int, source_epoch: int,
                   target_epoch: int) -> bool:
        for src, tgt in self._votes.get(validator_index, []):
            if tgt == target_epoch:
                return False                    # double vote
            if src < source_epoch and target_epoch < tgt:
                return False                    # we'd be surrounded
            if source_epoch < src and tgt < target_epoch:
                return False                    # we'd surround
        return True

    def record_attestation(self, validator_index: int, source_epoch: int,
                           target_epoch: int) -> None:
        assert self.may_attest(validator_index, source_epoch, target_epoch), \
            "slashable vote"
        self._votes.setdefault(validator_index, []).append(
            (source_epoch, target_epoch))
