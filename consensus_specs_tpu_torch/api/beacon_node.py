"""The validator <-> beacon-node API, served in-process (port of
consensus_specs_tpu/api/beacon_node.py).

Contract: the validator API's OpenAPI description (beacon_node_oapi.yaml)
  /node/version, /node/genesis_time, /node/syncing, /node/fork
  /validator/duties       per-pubkey proposal and attestation duties
  /validator/block        GET produce / POST publish
  /validator/attestation  GET produce / POST publish
plus the operational /metrics, /trace and /healthz.

Error semantics map to ApiError(status): 400 invalid request, 404 pubkey
unknown, 406 duties cannot be served for the epoch, 503 while syncing.
Production and publishing delegate to the honest-validator duty builders
(models/phase0/validator.py) and the spec's state transition, on the
spec's device (the card by default: `BeaconNodeAPI(..., device=)` must
name it); the API adds only lookup, validation and bookkeeping.
"""
from __future__ import annotations

from copy import deepcopy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..device import resolve

# exception classes that map to HTTP 400: what the spec's validity checks
# raise (assert statements, out-of-range list access, the SSZ machinery's
# rejection of ill-typed values). Broader classes signal implementation
# bugs and propagate.
_INVALID = (AssertionError, IndexError, ValueError)

VERSION = "consensus-specs-tpu/0.3"


class ApiError(Exception):
    def __init__(self, status: int, message: str = ""):
        super().__init__(message or f"HTTP {status}")
        self.status = status


@dataclass
class SyncingStatus:
    is_syncing: bool
    starting_slot: int = 0
    current_slot: int = 0
    highest_slot: int = 0


@dataclass
class ValidatorDuty:
    validator_pubkey: bytes
    attestation_slot: int
    attestation_shard: int
    committee: List[int]
    validator_index: int
    block_proposal_slot: Optional[int] = None   # null unless proposing


class BeaconNodeAPI:
    """One node's view: a spec, its head state, and what was published.
    `device` must be the spec's device ("cuda" unless the caller asks for
    the CPU)."""

    def __init__(self, spec, state, *, syncing: Optional[SyncingStatus] = None,
                 device="cuda"):
        if resolve(device) != spec.device:
            raise ValueError(f"the API runs on {resolve(device)}, the spec "
                             f"on {spec.device}")
        self.spec = spec
        self.state = state
        self.syncing = syncing or SyncingStatus(is_syncing=False)
        self.published_blocks: List[object] = []
        self.published_attestations: List[object] = []
        self._pubkey_index: Dict[bytes, int] = {
            bytes(v.pubkey): i
            for i, v in enumerate(state.validator_registry)
        }

    # -- /node/* ------------------------------------------------------------

    def get_version(self) -> str:
        return VERSION

    def get_genesis_time(self) -> int:
        return int(self.state.genesis_time)

    def get_syncing(self) -> SyncingStatus:
        return self.syncing

    def get_fork(self):
        """-> (fork container, chain_id placeholder 0)."""
        return self.state.fork, 0

    # -- /validator/duties --------------------------------------------------

    def get_validator_duties(self, validator_pubkeys: Sequence[bytes],
                             epoch: Optional[int] = None) -> List[ValidatorDuty]:
        self._reject_if_syncing()
        spec, state = self.spec, self.state
        epoch = spec.get_current_epoch(state) if epoch is None else int(epoch)
        if abs(epoch - spec.get_current_epoch(state)) > 1:
            raise ApiError(406, "duties only computable for adjacent epochs")
        duties = []
        for pubkey in validator_pubkeys:
            index = self._pubkey_index.get(bytes(pubkey))
            if index is None:
                raise ApiError(404, "pubkey not found")
            assignment = spec.get_committee_assignment(state, epoch, index)
            if assignment is None:
                raise ApiError(406, "no assignment in requested epoch")
            committee, shard, slot = assignment
            duties.append(ValidatorDuty(
                validator_pubkey=bytes(pubkey),
                attestation_slot=int(slot),
                attestation_shard=int(shard),
                committee=[int(i) for i in committee],
                validator_index=index,
                block_proposal_slot=self._find_proposal_slot(index, epoch),
            ))
        return duties

    def _find_proposal_slot(self, index: int, epoch: int) -> Optional[int]:
        """First slot of `epoch` (not before the head) where `index`
        proposes. The proposer of a future slot depends on the state AT
        that slot, so one scratch copy advances through the epoch's
        remaining slots, and the slot -> proposer map is cached per head
        slot: lookahead is only reliable within the current epoch."""
        spec, state = self.spec, self.state
        if epoch != spec.get_current_epoch(state):
            return None
        cache_key = (epoch, int(state.slot))
        if getattr(self, "_proposer_map_key", None) != cache_key:
            last_slot = (spec.get_epoch_start_slot(epoch)
                         + spec.SLOTS_PER_EPOCH - 1)
            mapping = {}
            scratch = None
            for slot in range(max(int(state.slot), 1), last_slot + 1):
                if slot == int(state.slot):
                    probe = state
                else:
                    if scratch is None:
                        scratch = deepcopy(state)
                    spec.process_slots(scratch, slot)
                    probe = scratch
                mapping.setdefault(spec.get_beacon_proposer_index(probe), slot)
            self._proposer_map = mapping
            self._proposer_map_key = cache_key
        return self._proposer_map.get(index)

    # -- /validator/block ---------------------------------------------------

    def produce_block(self, slot: int, randao_reveal: bytes):
        """GET /validator/block: an unsigned proposal for `slot`; the
        client signs it and posts it back."""
        self._reject_if_syncing()
        spec, state = self.spec, self.state
        if slot <= 0 or slot < state.slot:
            raise ApiError(400, "cannot propose into the past")
        block = spec.BeaconBlock()
        block.slot = int(slot)
        block.parent_root = spec.signing_root(state.latest_block_header)
        block.body.randao_reveal = bytes(randao_reveal)
        block.body.eth1_data = spec.get_eth1_vote(state)
        scratch = deepcopy(state)
        from ..crypto import bls
        old = bls.bls_active
        bls.bls_active = False
        try:
            spec.state_transition(scratch, block)
            block.state_root = spec.hash_tree_root(scratch)
        except _INVALID:
            raise ApiError(400, "slot not reachable from head state")
        finally:
            bls.bls_active = old
        return block

    def _decode_submission(self, obj, typ):
        """Re-encode a submission through the SSZ wire codec (the body a
        real node receives is bytes): what a client could send and fails
        to encode is a 400 here."""
        from ..utils.ssz.impl import deserialize, serialize
        try:
            return deserialize(serialize(obj, typ), typ)
        except Exception:
            raise ApiError(400, "malformed SSZ submission")

    def publish_block(self, block) -> None:
        """POST /validator/block: apply the signed block to the head state
        (its claimed state root verified); an invalid block is a 400 and
        the head does not move."""
        self._reject_if_syncing()
        spec = self.spec
        block = self._decode_submission(block, spec.BeaconBlock)
        scratch = deepcopy(self.state)
        try:
            spec.state_transition(scratch, block, validate_state_root=True)
        except _INVALID:
            raise ApiError(400, "block failed state transition")
        self.state = scratch
        # the registry is append-only: index new deposits only
        for i in range(len(self._pubkey_index), len(scratch.validator_registry)):
            self._pubkey_index[bytes(scratch.validator_registry[i].pubkey)] = i
        self.published_blocks.append(block)

    # -- /validator/attestation --------------------------------------------

    def produce_attestation(self, validator_pubkey: bytes,
                            slot: int, shard: int,
                            poc_bit: int = 0):
        """GET /validator/attestation: an unsigned single-bit attestation
        for the validator's committee slot."""
        self._reject_if_syncing()
        spec, state = self.spec, self.state
        index = self._pubkey_index.get(bytes(validator_pubkey))
        if index is None:
            raise ApiError(404, "pubkey not found")
        epoch = spec.slot_to_epoch(int(slot))
        assignment = spec.get_committee_assignment(state, epoch, index)
        if assignment is None or int(assignment[1]) != int(shard):
            raise ApiError(400, "validator not assigned to that shard")
        head_root = spec.signing_root(state.latest_block_header)
        return spec.build_attestation_duty(
            state, head_root, assignment[0], int(shard), index,
            privkey=None, custody_bit=bool(poc_bit))

    def publish_attestation(self, attestation) -> None:
        """POST /validator/attestation: queued for the next proposal (the
        block that includes it applies it)."""
        self._reject_if_syncing()
        spec, state = self.spec, self.state
        attestation = self._decode_submission(attestation, spec.Attestation)
        try:
            data_slot = spec.get_attestation_data_slot(state, attestation.data)
            assert data_slot <= state.slot
        except _INVALID:
            raise ApiError(400, "malformed attestation")
        self.published_attestations.append(attestation)

    # -- operational --------------------------------------------------------

    def get_metrics(self) -> str:
        """GET /metrics: the telemetry registry in Prometheus text format;
        served while syncing."""
        from .. import telemetry
        return telemetry.prometheus_text()

    def get_trace(self) -> dict:
        """GET /trace: the span ring as Chrome-trace JSON."""
        from .. import telemetry
        return telemetry.chrome_trace()

    def get_healthz(self) -> dict:
        """GET /healthz: resilience.health_snapshot() (the ladder's rung,
        the recovery counters, the last good checkpoint generation) with
        the firehose section (streaming.firehose_health()). Served while
        syncing and while degraded; the counters are always-on."""
        from .. import resilience, streaming
        snap = resilience.health_snapshot()
        snap["firehose"] = streaming.firehose_health()
        return snap

    # -----------------------------------------------------------------------

    def _reject_if_syncing(self) -> None:
        if self.syncing.is_syncing:
            raise ApiError(503, "beacon node is syncing")
