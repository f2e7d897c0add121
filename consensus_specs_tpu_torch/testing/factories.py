"""Valid-by-construction protocol object factories for the spec test corpus.

One consolidated module (the reference scatters these across
test_libs/pyspec/eth2spec/test/helpers/*; capability parity with that whole
directory). Everything here builds objects that *pass* the relevant
process_* handler; scenario tables (testing/cases/) then perturb single
fields to probe each validity rule.

Conventions:
  - factories take `spec` first and mutate `state` only when the protocol
    requires planted context (e.g. a deposit root in latest_eth1_data);
  - `signed=False` is the default everywhere — BLS is off in most corpus
    runs (context.DEFAULT_BLS_ACTIVE) and signing costs real pairings;
  - all signing helpers are separate, so invalid-signature scenarios can
    mutate first and sign (or not) afterwards.
"""
from __future__ import annotations

from copy import deepcopy

from ..crypto.bls import bls_aggregate_signatures, bls_sign
from ..utils.merkle import calc_merkle_tree_from_leaves, get_merkle_proof
from ..utils.ssz.impl import hash_tree_root, signing_root
from .keys import privkeys, pubkey_to_privkey, pubkeys

# ---------------------------------------------------------------------------
# Bitfields
# ---------------------------------------------------------------------------


def bit_on(bitfield: bytes, i: int) -> bytes:
    """Copy of `bitfield` with bit i set (little-endian bit order per byte;
    reads go through spec.get_bitfield_bit)."""
    arr = bytearray(bitfield)
    arr[i // 8] |= 1 << (i % 8)
    return bytes(arr)


# ---------------------------------------------------------------------------
# Genesis seeding (mock: registry written directly, no deposit processing —
# same speed hack the reference documents for its test genesis)
# ---------------------------------------------------------------------------


def mock_withdrawal_credentials(spec, pubkey: bytes) -> bytes:
    """Test-only credentials derived from the pubkey (insecure, documented)."""
    return spec.int_to_bytes(spec.BLS_WITHDRAWAL_PREFIX, length=1) + spec.hash(pubkey)[1:]


def seed_validator(spec, index: int, balance: int):
    """A mock registry entry: deterministic key, derived credentials, NOT
    activated (callers activate explicitly; seed_genesis_state does)."""
    v = spec.Validator(
        pubkey=pubkeys[index],
        withdrawal_credentials=mock_withdrawal_credentials(spec, pubkeys[index]),
        activation_eligibility_epoch=spec.FAR_FUTURE_EPOCH,
        activation_epoch=spec.FAR_FUTURE_EPOCH,
        exit_epoch=spec.FAR_FUTURE_EPOCH,
        withdrawable_epoch=spec.FAR_FUTURE_EPOCH,
    )
    rounded = balance - balance % spec.EFFECTIVE_BALANCE_INCREMENT
    v.effective_balance = min(rounded, spec.MAX_EFFECTIVE_BALANCE)
    return v


def seed_genesis_state(spec, validator_count: int):
    """A genesis-epoch BeaconState with `validator_count` active validators."""
    state = spec.BeaconState(
        genesis_time=0,
        deposit_index=validator_count,
        latest_eth1_data=spec.Eth1Data(
            deposit_root=b"\x42" * 32,
            deposit_count=validator_count,
            block_hash=spec.ZERO_HASH,
        ),
    )
    state.balances = [spec.MAX_EFFECTIVE_BALANCE] * validator_count
    state.validator_registry = [
        seed_validator(spec, i, state.balances[i]) for i in range(validator_count)
    ]
    # genesis activation for fully-funded validators
    for v in state.validator_registry:
        if v.effective_balance >= spec.MAX_EFFECTIVE_BALANCE:
            v.activation_eligibility_epoch = spec.GENESIS_EPOCH
            v.activation_epoch = spec.GENESIS_EPOCH

    from ..utils.ssz.typing import List as SSZList, uint64
    index_root = hash_tree_root(
        spec.get_active_validator_indices(state, spec.GENESIS_EPOCH), SSZList[uint64])
    for i in range(spec.LATEST_ACTIVE_INDEX_ROOTS_LENGTH):
        state.latest_active_index_roots[i] = index_root
    return state


# ---------------------------------------------------------------------------
# State progression
# ---------------------------------------------------------------------------


def balance_of(state, index: int) -> int:
    return state.balances[index]


def advance_slots(spec, state, count: int = 1) -> None:
    spec.process_slots(state, state.slot + count)


def advance_epoch(spec, state) -> None:
    """Run process_slots up to the first slot of the next epoch."""
    remaining = spec.SLOTS_PER_EPOCH - state.slot % spec.SLOTS_PER_EPOCH
    spec.process_slots(state, state.slot + remaining)


def saved_state_root(spec, state, slot) -> bytes:
    assert slot < state.slot <= slot + spec.SLOTS_PER_HISTORICAL_ROOT
    return state.latest_state_roots[slot % spec.SLOTS_PER_HISTORICAL_ROOT]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def empty_block(spec, state, slot=None, *, signed: bool = False):
    """A no-op block at `slot` (default: the state's current slot)."""
    block = spec.BeaconBlock()
    block.slot = state.slot if slot is None else slot
    block.body.eth1_data.deposit_count = state.deposit_index
    parent_header = deepcopy(state.latest_block_header)
    if parent_header.state_root == spec.ZERO_HASH:
        # spec.hash_tree_root so an installed bulk state-root backend serves
        # this (the recursive oracle is seconds per call at mainnet shapes)
        parent_header.state_root = spec.hash_tree_root(state)
    block.parent_root = signing_root(parent_header)
    if signed:
        sign_proposal(spec, state, block)
    return block


def empty_block_next(spec, state, *, signed: bool = False):
    return empty_block(spec, state, state.slot + 1, signed=signed)


def proposer_of(spec, state, slot) -> int:
    """The proposer index for `slot`, computed on a scratch copy when the
    slot is in the state's future."""
    if slot == state.slot:
        return spec.get_beacon_proposer_index(state)
    scratch = deepcopy(state)
    spec.process_slots(scratch, slot)
    return spec.get_beacon_proposer_index(scratch)


def sign_proposal(spec, state, block, proposer_index=None) -> None:
    """Fill randao_reveal + proposer signature. No-op with BLS off (finding
    the future-slot proposer is the expensive part, not the signing)."""
    from ..crypto import bls
    if not bls.bls_active:
        return
    assert state.slot <= block.slot
    if proposer_index is None:
        proposer_index = proposer_of(spec, state, block.slot)
    sk = privkeys[proposer_index]
    epoch = spec.slot_to_epoch(block.slot)
    block.body.randao_reveal = bls_sign(
        message_hash=hash_tree_root(epoch),
        privkey=sk,
        domain=spec.get_domain(state, spec.DOMAIN_RANDAO, message_epoch=epoch),
    )
    block.signature = bls_sign(
        message_hash=signing_root(block),
        privkey=sk,
        domain=spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER, epoch),
    )


def apply_and_seal(spec, state, block) -> None:
    """state_transition, then seal the block with post-state root + sig."""
    spec.state_transition(state, block)
    block.state_root = spec.hash_tree_root(state)
    sign_proposal(spec, state, block)


def transition_with_empty_block(spec, state):
    """Advance the chain one block (current slot); returns the block."""
    block = empty_block(spec, state, signed=True)
    spec.state_transition(state, block)
    return block


def sign_header(spec, state, header, privkey) -> None:
    header.signature = bls_sign(
        message_hash=signing_root(header),
        privkey=privkey,
        domain=spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER),
    )


# ---------------------------------------------------------------------------
# Attestations
# ---------------------------------------------------------------------------


def shard_for_slot(spec, state, slot) -> int:
    """The shard whose committee attests at `slot` (first committee)."""
    epoch = spec.slot_to_epoch(slot)
    per_slot = spec.get_epoch_committee_count(state, epoch) // spec.SLOTS_PER_EPOCH
    offset = per_slot * (slot % spec.SLOTS_PER_EPOCH)
    return (spec.get_epoch_start_shard(state, epoch) + offset) % spec.SHARD_COUNT


def attestation_payload(spec, state, slot, shard):
    """A consistent AttestationData for (slot, shard) given the state's view:
    LMD vote, FFG source/target, and crosslink lineage."""
    assert state.slot >= slot
    current_start = spec.get_epoch_start_slot(spec.get_current_epoch(state))
    in_previous = slot < current_start

    if slot == state.slot:
        head_root = empty_block_next(spec, state).parent_root
    else:
        head_root = spec.get_block_root_at_slot(state, slot)

    if in_previous:
        target_root = spec.get_block_root(state, spec.get_previous_epoch(state))
        source = (state.previous_justified_epoch, state.previous_justified_root)
    else:
        target_root = (head_root if slot == current_start
                       else spec.get_block_root(state, spec.get_current_epoch(state)))
        source = (state.current_justified_epoch, state.current_justified_root)

    epoch = spec.slot_to_epoch(slot)
    lineage = (state.current_crosslinks if epoch == spec.get_current_epoch(state)
               else state.previous_crosslinks)[shard]
    return spec.AttestationData(
        beacon_block_root=head_root,
        source_epoch=source[0],
        source_root=source[1],
        target_epoch=epoch,
        target_root=target_root,
        crosslink=spec.Crosslink(
            shard=shard,
            start_epoch=lineage.end_epoch,
            end_epoch=min(epoch, lineage.end_epoch + spec.MAX_EPOCHS_PER_CROSSLINK),
            data_root=spec.ZERO_HASH,
            parent_root=hash_tree_root(lineage),
        ),
    )


def participate_all(spec, state, attestation) -> None:
    """Set every committee member's aggregation bit."""
    committee = spec.get_crosslink_committee(
        state, attestation.data.target_epoch, attestation.data.crosslink.shard)
    bf = attestation.aggregation_bitfield
    for i in range(len(committee)):
        bf = bit_on(bf, i)
    attestation.aggregation_bitfield = bf


def new_attestation(spec, state, slot=None, *, signed: bool = False):
    """A fully-participated attestation for `slot` (default: current slot)."""
    if slot is None:
        slot = state.slot
    shard = shard_for_slot(spec, state, slot)
    data = attestation_payload(spec, state, slot, shard)
    committee = spec.get_crosslink_committee(state, data.target_epoch, data.crosslink.shard)
    width = (len(committee) + 7) // 8
    att = spec.Attestation(
        aggregation_bitfield=b"\x00" * width,
        data=data,
        custody_bitfield=b"\x00" * width,
    )
    participate_all(spec, state, att)
    if signed:
        endorse(spec, state, att)
    return att


def attestation_signature(spec, state, data, privkey, custody_bit=False) -> bytes:
    wrapped = spec.AttestationDataAndCustodyBit(data=data, custody_bit=custody_bit)
    return bls_sign(
        message_hash=hash_tree_root(wrapped),
        privkey=privkey,
        domain=spec.get_domain(state, spec.DOMAIN_ATTESTATION,
                               message_epoch=data.target_epoch),
    )


def _aggregate_endorsements(spec, state, data, members) -> bytes:
    return bls_aggregate_signatures([
        attestation_signature(spec, state, data, privkeys[m]) for m in members
    ])


def endorse(spec, state, attestation) -> None:
    """(Re)sign an attestation for its current participation set."""
    members = spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bitfield)
    attestation.signature = _aggregate_endorsements(spec, state, attestation.data, members)


def endorse_indexed(spec, state, indexed) -> None:
    members = list(indexed.custody_bit_0_indices) + list(indexed.custody_bit_1_indices)
    indexed.signature = _aggregate_endorsements(spec, state, indexed.data, members)


def include_attestation(spec, state, attestation, slot) -> None:
    """Carry an attestation into the chain via a block at `slot`."""
    block = empty_block_next(spec, state)
    block.slot = slot
    block.body.attestations.append(attestation)
    spec.process_slots(state, block.slot)
    sign_proposal(spec, state, block)
    spec.state_transition(state, block)


# ---------------------------------------------------------------------------
# Deposits
# ---------------------------------------------------------------------------


class DepositTree:
    """Incremental deposit accumulator mirroring the on-chain contract's
    Merkle tree (leaves = hash_tree_root(DepositData))."""

    def __init__(self, spec, leaves=None):
        self.spec = spec
        self.leaves = list(leaves) if leaves else []

    def append(self, deposit_data) -> int:
        self.leaves.append(hash_tree_root(deposit_data))
        return len(self.leaves) - 1

    @property
    def count(self) -> int:
        return len(self.leaves)

    def root(self) -> bytes:
        return self._tree()[-1][0]

    def proof_of(self, index: int):
        return get_merkle_proof(self._tree(), item_index=index)

    def _tree(self):
        return calc_merkle_tree_from_leaves(
            self.leaves, self.spec.DEPOSIT_CONTRACT_TREE_DEPTH)


def deposit_payload(spec, index: int, amount: int, *,
                    withdrawal_credentials=None):
    if withdrawal_credentials is None:
        withdrawal_credentials = mock_withdrawal_credentials(spec, pubkeys[index])
    return spec.DepositData(
        pubkey=pubkeys[index],
        withdrawal_credentials=withdrawal_credentials,
        amount=amount,
    )


def sign_deposit(spec, deposit_data, privkey) -> None:
    deposit_data.signature = bls_sign(
        message_hash=signing_root(deposit_data),
        privkey=privkey,
        domain=spec.bls_domain(spec.DOMAIN_DEPOSIT),
    )


def enroll_deposit(spec, tree: DepositTree, index: int, amount: int, *,
                   signed=False, withdrawal_credentials=None):
    """Append a deposit to `tree` and return the Deposit with its branch."""
    data = deposit_payload(spec, index, amount,
                           withdrawal_credentials=withdrawal_credentials)
    if signed:
        sign_deposit(spec, data, privkeys[index])
    leaf_index = tree.append(data)
    proof = tree.proof_of(leaf_index)
    assert spec.verify_merkle_branch(
        tree.leaves[leaf_index], proof, spec.DEPOSIT_CONTRACT_TREE_DEPTH,
        leaf_index, tree.root())
    return spec.Deposit(proof=list(proof), data=data)


def stage_deposit(spec, state, index: int, amount: int, *, signed=False,
                  withdrawal_credentials=None):
    """Build a deposit AND plant its root/count into the state's eth1 data
    so process_deposit accepts it."""
    tree = DepositTree(spec, [spec.ZERO_HASH] * len(state.validator_registry))
    deposit = enroll_deposit(spec, tree, index, amount, signed=signed,
                             withdrawal_credentials=withdrawal_credentials)
    state.latest_eth1_data.deposit_root = tree.root()
    state.latest_eth1_data.deposit_count = tree.count
    return deposit


# ---------------------------------------------------------------------------
# Slashings
# ---------------------------------------------------------------------------


def double_proposal(spec, state, *, sign_first=False, sign_second=False):
    """A ProposerSlashing: two conflicting headers at adjacent slots from the
    last active validator."""
    epoch = spec.get_current_epoch(state)
    offender = spec.get_active_validator_indices(state, epoch)[-1]
    sk = pubkey_to_privkey(state.validator_registry[offender].pubkey)

    def header(slot, tag):
        return spec.BeaconBlockHeader(
            slot=slot,
            parent_root=tag * 32,
            state_root=b"\x44" * 32,
            body_root=b"\x55" * 32,
        )

    first = header(state.slot, b"\x33")
    second = header(state.slot + 1, b"\x99")
    if sign_first:
        sign_header(spec, state, first, sk)
    if sign_second:
        sign_header(spec, state, second, sk)
    return spec.ProposerSlashing(
        proposer_index=offender, header_1=first, header_2=second)


def double_vote(spec, state, *, sign_first=False, sign_second=False):
    """An AttesterSlashing: the same committee votes twice for the same
    slot with different target roots."""
    vote_1 = new_attestation(spec, state, signed=sign_first)
    vote_2 = deepcopy(vote_1)
    vote_2.data.target_root = b"\x01" * 32
    if sign_second:
        endorse(spec, state, vote_2)
    return spec.AttesterSlashing(
        attestation_1=spec.convert_to_indexed(state, vote_1),
        attestation_2=spec.convert_to_indexed(state, vote_2),
    )


# ---------------------------------------------------------------------------
# Exits and transfers
# ---------------------------------------------------------------------------


def sign_exit(spec, state, exit_op, privkey) -> None:
    exit_op.signature = bls_sign(
        message_hash=signing_root(exit_op),
        privkey=privkey,
        domain=spec.get_domain(state, spec.DOMAIN_VOLUNTARY_EXIT,
                               message_epoch=exit_op.epoch),
    )


def exit_notice(spec, state, validator_index: int, epoch=None, *, signed=False):
    if epoch is None:
        epoch = spec.get_current_epoch(state)
    op = spec.VoluntaryExit(epoch=epoch, validator_index=validator_index)
    if signed:
        sign_exit(spec, state, op,
                  pubkey_to_privkey(state.validator_registry[validator_index].pubkey))
    return op


def sign_transfer(spec, state, transfer, privkey) -> None:
    transfer.signature = bls_sign(
        message_hash=signing_root(transfer),
        privkey=privkey,
        domain=spec.get_domain(state, spec.DOMAIN_TRANSFER),
    )


def _transfer_key(spec):
    # deliberately outside any test registry's range (preset-dependent)
    index = spec.SLOTS_PER_EPOCH * 16 - 1
    return pubkeys[index], privkeys[index]


def funds_transfer(spec, state, *, slot=None, sender=None, amount=None,
                   fee=None, signed=False):
    """A Transfer moving `amount` from the last active validator to the
    first, authorized by a dedicated transfer key whose hash is planted as
    the sender's withdrawal credentials."""
    epoch = spec.get_current_epoch(state)
    active = spec.get_active_validator_indices(state, epoch)
    if sender is None:
        sender = active[-1]
    if fee is None:
        fee = balance_of(state, sender) // 32
    if amount is None:
        amount = balance_of(state, sender) - fee
    pk, sk = _transfer_key(spec)
    transfer = spec.Transfer(
        sender=sender,
        recipient=active[0],
        amount=amount,
        fee=fee,
        slot=state.slot if slot is None else slot,
        pubkey=pk,
    )
    if signed:
        sign_transfer(spec, state, transfer, sk)
    state.validator_registry[sender].withdrawal_credentials = \
        mock_withdrawal_credentials(spec, pk)
    return transfer
