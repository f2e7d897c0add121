"""Streaming verification: the attestation firehose (port of
consensus_specs_tpu/streaming/).

Decouples BLS signature verification from `state_transition`. Mainnet
traffic is a gossip firehose -- thousands of aggregates per slot from
about 1M attesting validators -- and the grouped Miller loop shares its
Fq12 squarings across GROUPS: it pays off when fed full device batches,
which one block's worth of attestations never is. This package
accumulates verification work ACROSS slots into full batches and
overlaps the host staging of batch N+1 with the device pairing of
batch N:

  * queue.py    -- `VerificationQueue`: staged pairing groups bucketed by
                   pair count, accumulated across slots toward a target
                   batch occupancy (>= 128 groups per launch).
  * pipeline.py -- `FirehosePipeline`: full batches launched on a CUDA
                   stream of their own through
                   `resilience.guarded_dispatch`, per-batch verdicts
                   copied in place into a device-resident ring, ONE host
                   read at the fork-choice deadline; a deadline miss
                   flushes the partial batch late (salvaged) instead of
                   stalling.
  * verifier.py -- `StreamingVerifier`: the facade. Ingests aggregates
                   (SSZ gossip payloads or pre-staged groups), dedups by
                   content digest, stages through the SAME host pipeline
                   as the synchronous path
                   (`TorchBackend.stage_indexed_batch`), and hands
                   per-attestation verdicts back to `state_transition` /
                   fork choice, bit-identical to the synchronous path.

Telemetry (every counter always=True, so /healthz stays truthful with
telemetry off): spans `firehose.{stage,dispatch,flush}`, gauge
`firehose.queue_depth`, power-of-two histogram `firehose.batch_occupancy`,
counters `firehose.deadline_miss` (+ ingested / duplicates / cache_hits /
launches / groups_verified / ring_wraps / partial_flushes).
"""
from __future__ import annotations

import time
from typing import Optional

from .pipeline import FirehosePipeline
from .queue import VerificationQueue
from .verifier import StreamingVerifier

__all__ = [
    "FirehosePipeline", "StreamingVerifier", "VerificationQueue",
    "activate", "active", "firehose_health",
]

# the process-global verifier /healthz reports (last activated wins;
# None = no firehose running)
_ACTIVE: Optional[StreamingVerifier] = None


def activate(verifier: Optional[StreamingVerifier]):
    """Install `verifier` as the process-global firehose (what
    `firehose_health` reports). Returns the previous one so tests and
    drills can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = verifier
    return prev


def active() -> Optional[StreamingVerifier]:
    return _ACTIVE


def firehose_health() -> dict:
    """The /healthz firehose section: queue backlog, in-flight batches,
    seconds since the last flush, and the always-on counters -- a plain
    JSON-ready dict, meaningful (all-zero backlog, None flush age) even
    when no verifier is active."""
    from .. import telemetry

    v = _ACTIVE
    last_flush = v.pipeline.last_flush_at if v is not None else None
    return {
        "backlog": v.queue.depth if v is not None else 0,
        "in_flight_batches": v.pipeline.in_flight if v is not None else 0,
        "last_flush_age_s": (round(time.monotonic() - last_flush, 3)
                             if last_flush is not None else None),
        "target_groups": v.queue.target_groups if v is not None else None,
        "counters": {
            name: int(telemetry.counter(f"firehose.{name}",
                                        always=True).value)
            for name in ("ingested", "duplicates", "cache_hits",
                         "launches", "groups_verified", "deadline_miss",
                         "partial_flushes")
        },
    }
