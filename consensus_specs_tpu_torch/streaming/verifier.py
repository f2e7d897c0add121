"""`StreamingVerifier`: the attestation-firehose facade (port of
consensus_specs_tpu/streaming/verifier.py).

Ingests attestations and aggregates -- SSZ gossip payloads through the
networking decode path, pre-staged pairing groups, or the block path's
deferred-verification items -- dedups them by content digest (the
gossipsub seen-cache idiom, over verification work rather than wire
bytes), stages them through the SAME host pipeline as the synchronous
path (`TorchBackend.stage_indexed_batch`: grouped G1 decompress and
aggregate, batched G2 decompress, batched hash-to-curve), accumulates
the staged groups across slots in a `VerificationQueue`, and drives the
`FirehosePipeline` on its own CUDA stream. Verdicts come back per
attestation, bit-identical to `verify_indexed_batch`
(tests/test_torch_streaming.py holds them equal).

The serving rhythm:

    v = StreamingVerifier(target_groups=128, deadline_ms=...)   # "cuda"
    v.ingest_gossip(spec, state, payload)     # per gossip message
    v.pump()                                  # per slot tick: stage +
                                              #   dispatch full batches
    v.flush()                                 # fork-choice deadline:
                                              #   partial batches + ONE
                                              #   guarded read of the ring
    v.verdict(digest)                         # -> bool | None

`state_transition` consumes the queued verdicts through
`spec._streaming_verifier` (models/phase0/block.py): items the firehose
already verified are served from the cache (`firehose.cache_hits`);
misses verify through the same queue with an immediate flush.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.hash import sha256
from ._metrics import counter as _counter
from ._metrics import span as _span
from .pipeline import FirehosePipeline
from .queue import VerificationQueue

# exception classes the SSZ decoder / spec validity checks raise for
# garbage a gossip peer could actually send (the beacon_node _INVALID set)
_UNDECODABLE = (AssertionError, IndexError, ValueError)


def item_digest(pubkey_sets, message_hashes, signature, domain) -> bytes:
    """Content digest of one verification item — the dedup key AND the
    verdict-cache key shared by gossip pre-verification and the block
    path (identical staging inputs => identical digest => one device
    verification total)."""
    parts = [int(domain).to_bytes(8, "little"), bytes(signature)]
    for pk_set, mh in zip(pubkey_sets, message_hashes):
        parts.append(b"\x01")
        parts.append(bytes(mh))
        for pk in pk_set:
            parts.append(bytes(pk))
    return sha256(b"".join(parts))


def indexed_verify_item(spec, state, indexed) -> tuple:
    """The (pubkey_sets, message_hashes, signature, domain) tuple
    `validate_indexed_attestation` sinks for an indexed attestation —
    built here for gossip ingest so the firehose pre-verifies EXACTLY
    the item the block path will look up later."""
    bit0 = indexed.custody_bit_0_indices
    bit1 = indexed.custody_bit_1_indices
    pubkey_sets = [
        [bytes(state.validator_registry[i].pubkey) for i in bit0],
        [bytes(state.validator_registry[i].pubkey) for i in bit1],
    ]
    message_hashes = [
        spec.hash_tree_root(spec.AttestationDataAndCustodyBit(
            data=indexed.data, custody_bit=False)),
        spec.hash_tree_root(spec.AttestationDataAndCustodyBit(
            data=indexed.data, custody_bit=True)),
    ]
    domain = spec.get_domain(state, spec.DOMAIN_ATTESTATION,
                             indexed.data.target_epoch)
    return (pubkey_sets, message_hashes, bytes(indexed.signature),
            int(domain))


class StreamingVerifier:
    """Queue + pipeline + verdict cache behind one facade."""

    def __init__(self, *, backend=None, device="cuda",
                 target_groups: int = 128,
                 deadline_ms: Optional[float] = None,
                 ring_capacity: Optional[int] = None,
                 retain: int = 65536,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 register: bool = True):
        """`backend` stages the items and names the device: by default
        TorchBackend(device), on "cuda" unless the caller says "cpu"
        (raises without a card). The pipeline runs on that device."""
        if backend is None:
            from ..ops.bls_torch import TorchBackend
            backend = TorchBackend(device)
        self.backend = backend
        self.deadline_ms = deadline_ms
        self.queue = VerificationQueue(target_groups)
        padded = 1
        while padded < target_groups:
            padded *= 2
        if ring_capacity is None:
            ring_capacity = max(1024, 8 * padded)
        assert ring_capacity >= padded, \
            f"ring_capacity {ring_capacity} < padded target {padded}"
        self.pipeline = FirehosePipeline(
            device=backend.device, deadline_ms=deadline_ms,
            ring_capacity=ring_capacity, clock=clock, sleep=sleep)
        # Dedup/verdict retention is BOUNDED — the gossipsub seen-cache
        # idiom: a sustained firehose must not grow host state per
        # aggregate forever. Resolved digests evict FIFO past `retain`
        # (floored well above any flush window, so a block's sink can
        # never lose a verdict mid-lookup); an evicted item that
        # re-arrives simply re-verifies.
        self.retain = max(int(retain), 4096)
        self._verdicts: Dict[bytes, bool] = {}
        self._resolved: collections.deque = collections.deque()
        self._seen: set = set()            # digests submitted or decided
        self._pending: List[Tuple[bytes, tuple]] = []   # awaiting staging
        if register:
            from . import activate
            activate(self)

    # -- ingest ----------------------------------------------------------

    def submit_indexed(self, pubkey_sets, message_hashes, signature,
                       domain) -> bytes:
        """Enqueue one indexed-attestation verification item; returns its
        digest (the verdict handle). Duplicates — same committees, same
        message, same aggregate — collapse onto one verification."""
        item = (
            [ [bytes(p) for p in s] for s in pubkey_sets ],
            [bytes(m) for m in message_hashes],
            bytes(signature), int(domain))
        digest = item_digest(*item)
        if digest in self._verdicts:
            _counter("firehose.cache_hits").inc()
            return digest
        if digest in self._seen:
            _counter("firehose.duplicates").inc()
            return digest
        self._seen.add(digest)
        self._pending.append((digest, item))
        _counter("firehose.ingested").inc()
        return digest

    def submit_staged(self, key, pairs) -> None:
        """Enqueue an ALREADY-STAGED pairing group: pairs = [(g1 [2,L],
        g2 [2,2,L])] limb arrays. The ingestion point for synthetic
        gossip load (chip_smoke.py) and internal re-verification; keys are
        the caller's verdict handles, deduplicated like digests."""
        if key in self._seen or key in self._verdicts:
            _counter("firehose.duplicates").inc()
            return
        self._seen.add(key)
        _counter("firehose.ingested").inc()
        self.queue.push(key, pairs)

    def ingest_gossip(self, spec, state, payload) -> Optional[bytes]:
        """One `beacon_attestation` gossip payload (SSZ bytes, the
        networking/gossip.py wire format) -> submitted digest, or None
        when the payload is undecodable / names unknown committees
        (counted; a bad gossip message must never crash the firehose)."""
        from ..utils.ssz.impl import deserialize
        try:
            att = deserialize(bytes(payload), spec.Attestation)
            indexed = spec.convert_to_indexed(state, att)
            item = indexed_verify_item(spec, state, indexed)
        except _UNDECODABLE:
            _counter("firehose.undecodable").inc()
            return None
        return self.submit_indexed(*item)

    # -- the pipeline rhythm ---------------------------------------------

    def _remember(self, key, verdict: bool) -> None:
        """Record a resolved verdict, evicting the oldest resolved
        entries (and their dedup digests) past the retention bound."""
        if key not in self._verdicts:
            self._resolved.append(key)
        self._verdicts[key] = bool(verdict)
        while len(self._resolved) > self.retain:
            old = self._resolved.popleft()
            self._verdicts.pop(old, None)
            self._seen.discard(old)

    def _stage_pending(self) -> None:
        """Host-stage every pending item through the synchronous path's
        staging (batched across items: one grouped G1 program, one
        hash-to-curve batch) and queue the resulting pairing groups.
        Items decided at staging (malformed -> False, empty product ->
        True) resolve immediately."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        results, groups = self.backend.stage_indexed_batch(
            [item for _, item in pending])
        for idx, (digest, _) in enumerate(pending):
            if results[idx] is not None:
                self._remember(digest, results[idx])
        for idx, pairs in groups:
            self.queue.push(pending[idx][0], pairs)

    def pump(self) -> None:
        """One pipeline turn (call per slot tick / ingest wave): stage
        pending items — host work that overlaps whatever the device is
        pairing — then launch every FULL batch asynchronously. Never
        blocks."""
        with _span("firehose.stage", pending=len(self._pending)):
            self._stage_pending()
        for count, members in self.queue.take_batches():
            self.pipeline.dispatch(count, members)

    def flush(self, deadline_ms: Optional[float] = None
              ) -> Dict[object, bool]:
        """The fork-choice deadline: stage + dispatch everything still
        queued (PARTIAL batches included — counted), then block once on
        the pipeline's guarded ring materialization. Returns the newly
        resolved {key: verdict}; the cache keeps them for `verdict`."""
        with _span("firehose.stage", pending=len(self._pending)):
            self._stage_pending()
        for count, members in self.queue.take_batches(partial=True):
            if len(members) < self.queue.target_groups:
                _counter("firehose.partial_flushes").inc()
            self.pipeline.dispatch(count, members)
        got = self.pipeline.flush(
            deadline_ms if deadline_ms is not None else self.deadline_ms)
        for key, verdict in got.items():
            self._remember(key, verdict)
        return got

    # -- verdicts ---------------------------------------------------------

    def verdict(self, key) -> Optional[bool]:
        """Resolved verdict for a digest/key, None while still queued or
        in flight."""
        return self._verdicts.get(key)

    def verdicts_for(self, items: Sequence[tuple]) -> List[bool]:
        """The block path's entry (models/phase0/block.py): items are
        the `_att_verify_sink` tuples (pubkey_sets, message_hashes,
        signature, domain). Already-verified items (gossip
        pre-verification) are served from the cache; misses stage,
        queue, and flush through the same pipeline. Verdicts are
        bit-identical to `verify_indexed_batch(items)` — same staging,
        same device programs, batch shape proven inert by the
        differential suite."""
        digests = [self.submit_indexed(*item) for item in items]
        if any(d not in self._verdicts for d in digests):
            self.pump()
            self.flush()
        return [bool(self._verdicts[d]) for d in digests]
