"""Light-client sync protocol: period data, committee reconstruction, and
block-validity proofs.

Contract: consensus-specs specs/light_client/sync_protocol.md — expansions
and `PeriodData` :28-66, period-start epochs :68-80, `get_period_data`
:82-96, light-client state (`ValidatorMemory`) :98-106, committee update
cadence and proof-size budget :108-117 (~38 bytes/epoch amortized),
`compute_committee` :119-160, `BlockValidityProof` +
`verify_block_validity_proof` :164-199 (664-byte proof).

Design notes (adaptation, not translation):
- The reference doc predates its own shard-chain doc's committee helpers
  and is internally inconsistent with it (e.g. `int_to_bytes(index,
  length=3)` here vs `length=8` there). We make the light client
  *internally consistent with our phase-1 shard module*: the committee a
  light client reconstructs offline is bit-identical to
  `get_persistent_committee` computed from the full state — asserted in
  tests/test_sync_protocol.py and tests/test_torch_light_client.py. That equality is the whole point of the
  protocol: the client tracks a shard's persistent committee without the
  registry.
- `PeriodData.committee` stores the shard's full *span* of the period's
  shuffle (the doc's "maximal committee"). The doc's key observation
  (:162) — a shard's span boundaries are independent of committee_count
  because `(n * shard * cc) // (SHARD_COUNT * cc) == n * shard //
  SHARD_COUNT` — is what lets `compute_committee` re-slice the span with
  a committee_count agreed between *two* periods that each only knew
  their own count when the proof was built.
- The pairing check in `verify_block_validity_proof` rides the same
  backend boundary as everything else (`spec.bls`), so TorchBackend's
  kernels on the card verify light-client proofs too.

Port of consensus_specs_tpu/light_client/sync_protocol.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


# ---------------------------------------------------------------------------
# Period data
# ---------------------------------------------------------------------------

@dataclass
class PeriodData:
    """What a light client retains about one persistent-committee period of
    one shard (sync_protocol.md:57-66): enough to rebuild any slot's
    committee slice without the validator registry."""
    validator_count: int            # active validators at period start
    seed: bytes                     # generate_seed(state, period_start)
    committee: List[int]            # the shard's shuffle span, in shuffled order
    validators: Dict[int, object]   # index -> Validator record (pubkey, balance)


@dataclass
class ValidatorMemory:
    """Light-client state (sync_protocol.md:98-106). `fork_version` is the
    client's own view of the chain's fork (learned when it synced its
    finalized header) — domain separation must come from here, never from
    the proof under verification."""
    shard_id: int
    finalized_header: object        # BeaconBlockHeader
    earlier_period_data: PeriodData
    later_period_data: PeriodData
    fork_version: bytes = b"\x00\x00\x00\x00"


def get_earlier_start_epoch(spec, slot: int) -> int:
    epoch = spec.slot_to_epoch(slot)
    return max(0, epoch - (epoch % spec.PERSISTENT_COMMITTEE_PERIOD)
               - spec.PERSISTENT_COMMITTEE_PERIOD * 2)


def get_later_start_epoch(spec, slot: int) -> int:
    epoch = spec.slot_to_epoch(slot)
    return max(0, epoch - (epoch % spec.PERSISTENT_COMMITTEE_PERIOD)
               - spec.PERSISTENT_COMMITTEE_PERIOD)


def _shard_span(spec, indices: List[int], seed: bytes,
                shard: int) -> List[int]:
    """The shard's contiguous span of the period's shuffled validator set
    (concatenation of all its committee_count slices — boundaries are
    committee_count-invariant, sync_protocol.md:162)."""
    n = len(indices)
    if n == 0:
        return []
    start = (n * shard) // spec.SHARD_COUNT
    end = (n * (shard + 1)) // spec.SHARD_COUNT
    perm = spec.get_shuffle_permutation(n, seed)
    return [indices[perm[i]] for i in range(start, end)]


def get_period_data(spec, state, slot: int, shard_id: int,
                    later: bool) -> PeriodData:
    """Extract one period's light-client data from a (full) state — the
    server side of the protocol (sync_protocol.md:82-96). A production
    server would ship this as a MerklePartial against the finalized state
    root (light_client/multiproof.py); here the object itself is the
    payload and the multiproof layer is orthogonal."""
    period_start = (get_later_start_epoch(spec, slot) if later
                    else get_earlier_start_epoch(spec, slot))
    indices = spec.get_active_validator_indices(state, period_start)
    seed = spec.generate_seed(state, period_start)
    span = _shard_span(spec, indices, seed, shard_id)
    return PeriodData(
        validator_count=len(indices),
        seed=seed,
        committee=span,
        validators={i: state.validator_registry[i] for i in span},
    )


# ---------------------------------------------------------------------------
# Committee reconstruction (client side, no registry access)
# ---------------------------------------------------------------------------

def _slice_of_span(span: List[int], n: int, shard: int, shard_count: int,
                   index: int, committee_count: int) -> List[int]:
    """Slice `index` of the shard's `committee_count` slices, cut out of the
    stored span by global shuffle offsets."""
    span_start = (n * shard) // shard_count
    lo = (n * (shard * committee_count + index)) // (shard_count * committee_count)
    hi = (n * (shard * committee_count + index + 1)) // (shard_count * committee_count)
    return span[lo - span_start:hi - span_start]


def _switchover_epoch(spec, seed: bytes, index: int) -> int:
    # Identical formula to models/phase1/shard.py:get_switchover_epoch so
    # the reconstruction matches get_persistent_committee bit-for-bit.
    mixed = spec.hash(seed + spec.int_to_bytes(index, length=8))
    return spec.bytes_to_int(mixed[0:8]) % spec.PERSISTENT_COMMITTEE_PERIOD


def compute_committee(spec, header, validator_memory: ValidatorMemory) -> List[int]:
    """The persistent committee for the header's slot, rebuilt from the two
    stored period datas alone (sync_protocol.md:119-160)."""
    mem = validator_memory
    earlier, later = mem.earlier_period_data, mem.later_period_data
    epoch = spec.slot_to_epoch(header.slot)
    period = spec.PERSISTENT_COMMITTEE_PERIOD

    committee_count = max(
        earlier.validator_count // (spec.SHARD_COUNT * spec.TARGET_COMMITTEE_SIZE),
        later.validator_count // (spec.SHARD_COUNT * spec.TARGET_COMMITTEE_SIZE),
    ) + 1
    index = header.slot % committee_count

    actual_earlier = _slice_of_span(
        earlier.committee, earlier.validator_count, mem.shard_id,
        spec.SHARD_COUNT, index, committee_count)
    actual_later = _slice_of_span(
        later.committee, later.validator_count, mem.shard_id,
        spec.SHARD_COUNT, index, committee_count)

    offset = epoch % period
    members = set(
        [i for i in actual_earlier
         if offset < _switchover_epoch(spec, earlier.seed, i)]
        + [i for i in actual_later
           if offset >= _switchover_epoch(spec, earlier.seed, i)]
    )
    return sorted(members)


# ---------------------------------------------------------------------------
# Block validity proofs
# ---------------------------------------------------------------------------

@dataclass
class BlockValidityProof:
    """664-byte proof that a header is attested by the tracked shard's
    persistent committee (sync_protocol.md:168-175)."""
    header: object                   # BeaconBlockHeader
    shard_aggregate_signature: bytes
    shard_bitfield: bytes
    shard_parent_block: object       # ShardBlock


def verify_block_validity_proof(spec, proof: BlockValidityProof,
                                validator_memory: ValidatorMemory) -> bool:
    """sync_protocol.md:179-197: anchor the shard block to the header,
    check >50% committee balance support, verify the aggregate signature.
    Returns False (never raises) on any failed check — the light client's
    caller treats a bad proof as a peer failure, not a crash."""
    mem = validator_memory
    try:
        assert bytes(proof.shard_parent_block.beacon_chain_root) == \
            spec.signing_root(proof.header)
        committee = compute_committee(spec, proof.header, mem)
        assert committee, "empty committee"
        assert spec.verify_bitfield(proof.shard_bitfield, len(committee))
        records = {**mem.earlier_period_data.validators,
                   **mem.later_period_data.validators}
        support = total = 0
        pubkeys = []
        for i, vindex in enumerate(committee):
            v = records[vindex]
            total += v.effective_balance
            if spec.get_bitfield_bit(proof.shard_bitfield, i) == 0b1:
                support += v.effective_balance
                pubkeys.append(v.pubkey)
        assert support * 2 > total
        domain = spec.bls_domain(spec.DOMAIN_SHARD_ATTESTER,
                                 bytes(mem.fork_version))
        assert spec.bls.bls_verify(
            spec.bls.bls_aggregate_pubkeys(pubkeys),
            spec.signing_root(proof.shard_parent_block),
            bytes(proof.shard_aggregate_signature),
            domain,
        )
        return True
    except (AssertionError, KeyError, IndexError):
        return False


def build_validator_memory(spec, state, slot: int,
                           shard_id: int, finalized_header) -> ValidatorMemory:
    """Server-side convenience: the memory a client holds after syncing to
    `finalized_header` (sync_protocol.md:98-106)."""
    return ValidatorMemory(
        shard_id=shard_id,
        finalized_header=finalized_header,
        earlier_period_data=get_period_data(spec, state, slot, shard_id, later=False),
        later_period_data=get_period_data(spec, state, slot, shard_id, later=True),
    )


# ---------------------------------------------------------------------------
# Authenticated committee updates: PeriodData as a Merkle partial
# (sync_protocol.md:108-117 — "ask the network for new_committee_proof =
#  MerklePartial(get_period_data, ...)"; proof machinery:
#  light_client/multiproof.py per merkle_proofs.md:106-187)
# ---------------------------------------------------------------------------

def _seed_input_paths(spec, period_start: int):
    """The two state leaves generate_seed reads for `period_start`
    (models/phase0/helpers.py:184-193): the randao mix at epoch + LEN -
    MIN_SEED_LOOKAHEAD, and the active-index root at epoch (no offset)."""
    return [
        ["latest_randao_mixes",
         (period_start + spec.LATEST_RANDAO_MIXES_LENGTH
          - spec.MIN_SEED_LOOKAHEAD) % spec.LATEST_RANDAO_MIXES_LENGTH],
        ["latest_active_index_roots",
         period_start % spec.LATEST_ACTIVE_INDEX_ROOTS_LENGTH],
    ]


@dataclass
class PeriodDataProof:
    """Everything a client needs to authenticate a PeriodData against a
    finalized state root: the multiproof plus the ExtendedBeaconState
    expansion of the active-index-root leaf (sync_protocol.md:28-46 — the
    expansion is a re-interpretation of a committed root, so shipping the
    list adds data but no trust; a production server would ship only the
    shard's contiguous slice of it, sync_protocol.md:112)."""
    partial: object                 # MerklePartial over the BeaconState
    active_indices: List[int]       # expansion of the proven index root


def prove_period_data(spec, state, slot: int, shard_id: int, later: bool,
                      tree=None):
    """(PeriodData, PeriodDataProof). The partial authenticates, against
    hash_tree_root(state), every committee member's validator record, the
    registry length (so the verifier can recompute list indices), and the
    seed inputs generate_seed reads — the active-index-root leaf doubles
    as the commitment the shipped active_indices expansion must hash to.
    Pass a prebuilt SSZMerkleTree(state, spec.BeaconState) via `tree` to
    amortize the full-state hashing across the earlier/later pair
    (build_validator_memory's shape) and across clients."""
    from .multiproof import (LENGTH_FLAG, SSZMerkleTree,
                             generalized_index_for_path)

    pd = get_period_data(spec, state, slot, shard_id, later)
    period_start = (get_later_start_epoch(spec, slot) if later
                    else get_earlier_start_epoch(spec, slot))
    typ = spec.BeaconState
    if tree is None:
        tree = SSZMerkleTree(state, typ)
    paths = [["validator_registry", LENGTH_FLAG]]
    paths += [["validator_registry", i] for i in sorted(pd.validators)]
    paths += _seed_input_paths(spec, period_start)
    indices = [generalized_index_for_path(state, typ, p) for p in paths]
    # stale-tree guard without re-hashing the whole state: the prebuilt
    # tree must still agree with the state's mutable scalars — the slot
    # chunk and the registry length leaf pin the snapshot O(1) (a tree
    # built before a slot advance or a deposit fails here)
    assert tree.value is state and tree.typ is typ
    slot_gidx = generalized_index_for_path(state, typ, ["slot"])
    assert int.from_bytes(tree.nodes[slot_gidx][:8], "little") == int(state.slot)
    len_gidx = generalized_index_for_path(state, typ,
                                          ["validator_registry", LENGTH_FLAG])
    assert int.from_bytes(tree.nodes[len_gidx][:8], "little") == \
        len(state.validator_registry)
    partial = tree.prove(indices)
    active = [int(i) for i in
              spec.get_active_validator_indices(state, period_start)]
    return pd, PeriodDataProof(partial=partial, active_indices=active)


def verify_period_data(spec, state_root: bytes, period_data: PeriodData,
                       proof: PeriodDataProof, slot: int, shard_id: int,
                       later: bool) -> bool:
    """Client side — full chain of custody from the finalized state root:

    1. the multiproof verifies, and every proven generalized index is
       RECOMPUTED from the type layout + the proven registry length —
       never taken from the prover (trusting the prover's indices accepts
       record and seed substitutions against an honest root);
    2. every shipped validator record hashes to its proven leaf;
    3. the seed recomputes from the proven randao mix + active-index root;
    4. the shipped active-index expansion hashes to that same proven
       index-root leaf, and the committee span + validator_count recompute
       from it — so a True here covers EVERY field compute_committee
       consumes; a forged span cannot ride an honest proof.

    Returns False on any mismatch."""
    from ..utils.ssz.impl import hash_tree_root
    from ..utils.ssz.typing import List as SSZList, uint64
    from .multiproof import LENGTH_FLAG, generalized_index_for_typed_path

    partial = proof.partial
    try:
        if bytes(partial.root) != bytes(state_root) or not partial.verify():
            return False
        typ = spec.BeaconState
        values = dict(zip(partial.indices, partial.values))
        # step 1: pin the indices
        len_gidx = generalized_index_for_typed_path(
            typ, ["validator_registry", LENGTH_FLAG], {})
        if len_gidx not in values:
            return False
        registry_len = int.from_bytes(values[len_gidx][:8], "little")
        lengths = {("validator_registry",): registry_len}
        period_start = (get_later_start_epoch(spec, slot) if later
                        else get_earlier_start_epoch(spec, slot))
        members = sorted(period_data.validators)
        if any(not 0 <= i < registry_len for i in members):
            return False
        paths = [["validator_registry", LENGTH_FLAG]]
        paths += [["validator_registry", i] for i in members]
        paths += _seed_input_paths(spec, period_start)
        expected = [generalized_index_for_typed_path(typ, p, lengths)
                    for p in paths]
        if expected != list(partial.indices):
            return False
        # step 2: record authenticity against the now-pinned indices
        for i, member in enumerate(members):
            record = period_data.validators[member]
            if hash_tree_root(record, spec.Validator) != values[expected[1 + i]]:
                return False
        # step 3: seed chain of custody
        mix, air = values[expected[-2]], values[expected[-1]]
        seed = spec.hash(mix + air + spec.int_to_bytes(period_start, length=32))
        if seed != period_data.seed:
            return False
        # step 4: span + count from the authenticated expansion
        active = [int(i) for i in proof.active_indices]
        if hash_tree_root(active, SSZList[uint64]) != air:
            return False
        if period_data.validator_count != len(active):
            return False
        span = _shard_span(spec, active, seed, shard_id)
        if span != list(period_data.committee):
            return False
        return set(period_data.validators) == set(span)
    except (AssertionError, KeyError, IndexError, ValueError, TypeError):
        return False
