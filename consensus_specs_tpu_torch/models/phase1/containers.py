"""Phase-1 SSZ containers + field-appended phase-0 containers.

Custody objects per consensus-specs specs/core/1_custody-game.md:120-205;
shard objects per specs/core/1_shard-data-chains.md:70-115; the
"add fields to the end" contract (:207-246) is realized by SUBCLASSING the
phase-0 container types — the SSZ type system collects annotations along
the MRO in base-first order, which is exactly append semantics.
Port of consensus_specs_tpu/models/phase1/containers.py.
"""
from __future__ import annotations

from typing import Any, Dict

from ...utils.ssz.typing import Bytes32, Bytes96, List, Vector, uint64


def _container(name: str, fields: Dict[str, Any], base: type) -> type:
    return type(name, (base,), {"__annotations__": dict(fields)})


def build_types(cfg: Any, p0: Dict[str, type]) -> Dict[str, type]:
    """Phase-1 types against one preset. `p0` = that preset's phase-0 types
    (from models.phase0.containers.build_types); appended containers
    subclass them."""
    from ...utils.ssz.typing import Container
    ts: Dict[str, type] = {}

    # -- custody game objects (1_custody-game.md:120-205) -------------------

    ts["CustodyChunkChallenge"] = _container("CustodyChunkChallenge", {
        "responder_index": uint64,
        "attestation": p0["Attestation"],
        "chunk_index": uint64,
    }, Container)

    ts["CustodyBitChallenge"] = _container("CustodyBitChallenge", {
        "responder_index": uint64,
        "attestation": p0["Attestation"],
        "challenger_index": uint64,
        "responder_key": Bytes96,
        "chunk_bits": bytes,
        "signature": Bytes96,
    }, Container)

    ts["CustodyChunkChallengeRecord"] = _container("CustodyChunkChallengeRecord", {
        "challenge_index": uint64,
        "challenger_index": uint64,
        "responder_index": uint64,
        "inclusion_epoch": uint64,
        "data_root": Bytes32,
        "depth": uint64,
        "chunk_index": uint64,
    }, Container)

    ts["CustodyBitChallengeRecord"] = _container("CustodyBitChallengeRecord", {
        "challenge_index": uint64,
        "challenger_index": uint64,
        "responder_index": uint64,
        "inclusion_epoch": uint64,
        "data_root": Bytes32,
        "chunk_count": uint64,
        "chunk_bits_merkle_root": Bytes32,
        "responder_key": Bytes96,
    }, Container)

    ts["CustodyResponse"] = _container("CustodyResponse", {
        "challenge_index": uint64,
        "chunk_index": uint64,
        "chunk": bytes,          # BYTES_PER_CUSTODY_CHUNK bytes on the wire
        "data_branch": List[Bytes32],
        "chunk_bits_branch": List[Bytes32],
        "chunk_bits_leaf": Bytes32,
    }, Container)

    ts["CustodyKeyReveal"] = _container("CustodyKeyReveal", {
        "revealer_index": uint64,
        "reveal": Bytes96,
    }, Container)

    ts["EarlyDerivedSecretReveal"] = _container("EarlyDerivedSecretReveal", {
        "revealed_index": uint64,
        "epoch": uint64,
        "reveal": Bytes96,
        "masker_index": uint64,
        "mask": Bytes32,
    }, Container)

    # -- shard chain objects (1_shard-data-chains.md:70-115) ----------------

    ts["ShardAttestationData"] = _container("ShardAttestationData", {
        "slot": uint64,
        "shard": uint64,
        "shard_block_root": Bytes32,
    }, Container)

    ts["ShardAttestation"] = _container("ShardAttestation", {
        "data": ts["ShardAttestationData"],
        "aggregation_bitfield": bytes,
        "aggregate_signature": Bytes96,
    }, Container)

    ts["ShardBlockBody"] = _container("ShardBlockBody", {
        "data": bytes,           # BYTES_PER_SHARD_BLOCK_BODY bytes
    }, Container)

    ts["ShardBlock"] = _container("ShardBlock", {
        "slot": uint64,
        "shard": uint64,
        "beacon_chain_root": Bytes32,
        "parent_root": Bytes32,
        "data": ts["ShardBlockBody"],
        "state_root": Bytes32,
        "attestations": List[ts["ShardAttestation"]],
        "signature": Bytes96,
    }, Container)

    ts["ShardBlockHeader"] = _container("ShardBlockHeader", {
        "slot": uint64,
        "shard": uint64,
        "beacon_chain_root": Bytes32,
        "parent_root": Bytes32,
        "body_root": Bytes32,
        "state_root": Bytes32,
        "attestations": List[ts["ShardAttestation"]],
        "signature": Bytes96,
    }, Container)

    # -- field-appended phase-0 containers (1_custody-game.md:207-246) ------

    ts["Validator"] = _container("Validator", {
        "next_custody_reveal_period": uint64,
        "max_reveal_lateness": uint64,
    }, p0["Validator"])

    ts["BeaconState"] = _container("BeaconState", {
        # re-annotating an inherited field keeps its position (the MRO field
        # walk dict.update()s in place) — the registry must hold the
        # EXTENDED Validator type
        "validator_registry": List[ts["Validator"]],
        # appended phase-1 fields
        "custody_chunk_challenge_records": List[ts["CustodyChunkChallengeRecord"]],
        "custody_bit_challenge_records": List[ts["CustodyBitChallengeRecord"]],
        "custody_challenge_index": uint64,
        "exposed_derived_secrets": Vector[
            List[uint64], cfg.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS],
    }, p0["BeaconState"])

    ts["BeaconBlockBody"] = _container("BeaconBlockBody", {
        "custody_chunk_challenges": List[ts["CustodyChunkChallenge"]],
        "custody_bit_challenges": List[ts["CustodyBitChallenge"]],
        "custody_responses": List[ts["CustodyResponse"]],
        "custody_key_reveals": List[ts["CustodyKeyReveal"]],
        "early_derived_secret_reveals": List[ts["EarlyDerivedSecretReveal"]],
    }, p0["BeaconBlockBody"])

    # re-annotating `body` overrides its type IN PLACE (the MRO field walk
    # dict.update()s, keeping the phase-0 field order) — not an append
    ts["BeaconBlock"] = _container("BeaconBlock", {
        "body": ts["BeaconBlockBody"],
    }, p0["BeaconBlock"])

    return ts
