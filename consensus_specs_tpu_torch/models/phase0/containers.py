"""Phase-0 SSZ containers, built per preset (port of
consensus_specs_tpu/models/phase0/containers.py).

Field layouts per consensus-specs specs/core/0_beacon-chain.md:258-564. Types
whose Vector lengths depend on protocol constants (HistoricalBatch, Deposit,
BeaconState) are constructed against the given preset — the equivalent of the
reference's `init_SSZ_types` re-execution trick
(consensus-specs scripts/build_spec.py:108-144), done once at spec build.
"""
from __future__ import annotations

from typing import Any, Dict

from ...utils.ssz.typing import (
    Bytes4, Bytes32, Bytes48, Bytes96, Container, List, Vector, uint64,
)


def _container(name: str, fields: Dict[str, Any], base: type = Container) -> type:
    return type(name, (base,), {"__annotations__": dict(fields)})


def build_types(cfg: Any) -> Dict[str, type]:
    """All phase-0 container types for one preset, dependency-ordered."""
    ts: Dict[str, type] = {}

    ts["Fork"] = _container("Fork", {
        "previous_version": Bytes4,
        "current_version": Bytes4,
        "epoch": uint64,
    })

    ts["Validator"] = _container("Validator", {
        "pubkey": Bytes48,
        "withdrawal_credentials": Bytes32,
        "activation_eligibility_epoch": uint64,
        "activation_epoch": uint64,
        "exit_epoch": uint64,
        "withdrawable_epoch": uint64,
        "slashed": bool,
        "effective_balance": uint64,
    })

    ts["Crosslink"] = _container("Crosslink", {
        "shard": uint64,
        "start_epoch": uint64,
        "end_epoch": uint64,
        "parent_root": Bytes32,
        "data_root": Bytes32,
    })

    ts["AttestationData"] = _container("AttestationData", {
        "beacon_block_root": Bytes32,   # LMD GHOST vote
        "source_epoch": uint64,         # FFG vote
        "source_root": Bytes32,
        "target_epoch": uint64,
        "target_root": Bytes32,
        "crosslink": ts["Crosslink"],   # Crosslink vote
    })

    ts["AttestationDataAndCustodyBit"] = _container("AttestationDataAndCustodyBit", {
        "data": ts["AttestationData"],
        "custody_bit": bool,
    })

    ts["IndexedAttestation"] = _container("IndexedAttestation", {
        "custody_bit_0_indices": List[uint64],
        "custody_bit_1_indices": List[uint64],
        "data": ts["AttestationData"],
        "signature": Bytes96,
    })

    ts["PendingAttestation"] = _container("PendingAttestation", {
        "aggregation_bitfield": bytes,
        "data": ts["AttestationData"],
        "inclusion_delay": uint64,
        "proposer_index": uint64,
    })

    ts["Eth1Data"] = _container("Eth1Data", {
        "deposit_root": Bytes32,
        "deposit_count": uint64,
        "block_hash": Bytes32,
    })

    ts["HistoricalBatch"] = _container("HistoricalBatch", {
        "block_roots": Vector[Bytes32, cfg.SLOTS_PER_HISTORICAL_ROOT],
        "state_roots": Vector[Bytes32, cfg.SLOTS_PER_HISTORICAL_ROOT],
    })

    ts["DepositData"] = _container("DepositData", {
        "pubkey": Bytes48,
        "withdrawal_credentials": Bytes32,
        "amount": uint64,
        "signature": Bytes96,
    })

    ts["BeaconBlockHeader"] = _container("BeaconBlockHeader", {
        "slot": uint64,
        "parent_root": Bytes32,
        "state_root": Bytes32,
        "body_root": Bytes32,
        "signature": Bytes96,
    })

    ts["ProposerSlashing"] = _container("ProposerSlashing", {
        "proposer_index": uint64,
        "header_1": ts["BeaconBlockHeader"],
        "header_2": ts["BeaconBlockHeader"],
    })

    ts["AttesterSlashing"] = _container("AttesterSlashing", {
        "attestation_1": ts["IndexedAttestation"],
        "attestation_2": ts["IndexedAttestation"],
    })

    ts["Attestation"] = _container("Attestation", {
        "aggregation_bitfield": bytes,
        "data": ts["AttestationData"],
        "custody_bitfield": bytes,
        "signature": Bytes96,
    })

    ts["Deposit"] = _container("Deposit", {
        "proof": Vector[Bytes32, cfg.DEPOSIT_CONTRACT_TREE_DEPTH],
        "data": ts["DepositData"],
    })

    ts["VoluntaryExit"] = _container("VoluntaryExit", {
        "epoch": uint64,
        "validator_index": uint64,
        "signature": Bytes96,
    })

    ts["Transfer"] = _container("Transfer", {
        "sender": uint64,
        "recipient": uint64,
        "amount": uint64,
        "fee": uint64,
        "slot": uint64,
        "pubkey": Bytes48,
        "signature": Bytes96,
    })

    ts["BeaconBlockBody"] = _container("BeaconBlockBody", {
        "randao_reveal": Bytes96,
        "eth1_data": ts["Eth1Data"],
        "graffiti": Bytes32,
        "proposer_slashings": List[ts["ProposerSlashing"]],
        "attester_slashings": List[ts["AttesterSlashing"]],
        "attestations": List[ts["Attestation"]],
        "deposits": List[ts["Deposit"]],
        "voluntary_exits": List[ts["VoluntaryExit"]],
        "transfers": List[ts["Transfer"]],
    })

    ts["BeaconBlock"] = _container("BeaconBlock", {
        "slot": uint64,
        "parent_root": Bytes32,
        "state_root": Bytes32,
        "body": ts["BeaconBlockBody"],
        "signature": Bytes96,
    })

    ts["BeaconState"] = _container("BeaconState", {
        # Misc
        "slot": uint64,
        "genesis_time": uint64,
        "fork": ts["Fork"],
        # Validator registry
        "validator_registry": List[ts["Validator"]],
        "balances": List[uint64],
        # Randomness and committees
        "latest_randao_mixes": Vector[Bytes32, cfg.LATEST_RANDAO_MIXES_LENGTH],
        "latest_start_shard": uint64,
        # Finality
        "previous_epoch_attestations": List[ts["PendingAttestation"]],
        "current_epoch_attestations": List[ts["PendingAttestation"]],
        "previous_justified_epoch": uint64,
        "current_justified_epoch": uint64,
        "previous_justified_root": Bytes32,
        "current_justified_root": Bytes32,
        "justification_bitfield": uint64,
        "finalized_epoch": uint64,
        "finalized_root": Bytes32,
        # Recent state
        "current_crosslinks": Vector[ts["Crosslink"], cfg.SHARD_COUNT],
        "previous_crosslinks": Vector[ts["Crosslink"], cfg.SHARD_COUNT],
        "latest_block_roots": Vector[Bytes32, cfg.SLOTS_PER_HISTORICAL_ROOT],
        "latest_state_roots": Vector[Bytes32, cfg.SLOTS_PER_HISTORICAL_ROOT],
        "latest_active_index_roots": Vector[Bytes32, cfg.LATEST_ACTIVE_INDEX_ROOTS_LENGTH],
        "latest_slashed_balances": Vector[uint64, cfg.LATEST_SLASHED_EXIT_LENGTH],
        "latest_block_header": ts["BeaconBlockHeader"],
        "historical_roots": List[Bytes32],
        # Ethereum 1.0 chain data
        "latest_eth1_data": ts["Eth1Data"],
        "eth1_data_votes": List[ts["Eth1Data"]],
        "deposit_index": uint64,
    })

    return ts
