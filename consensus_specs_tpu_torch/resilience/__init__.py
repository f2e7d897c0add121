"""Resilience layer (port of consensus_specs_tpu/resilience/): the
serving loop's failure modes, one module each.

  * faults.py     -- `set_schedule(text)` injects seeded faults at the
                     dispatch and checkpoint-I/O seams; disarmed, a site
                     is one module-global read.
  * dispatch.py   -- `guarded_dispatch` wraps the resident epoch boundary
                     and the firehose's launches: wall-clock deadline,
                     typed error taxonomy, bounded retry with backoff; the
                     degradation ladder (full, then single_device: see
                     there).
  * integrity.py  -- the epoch output's tripwire against the reference's
                     declared value hulls, one bool read a boundary.
  * checkpoint.py -- CRC-framed, atomic-rename, generational checkpoints
                     with fallback to the previous good generation.
  * errors.py     -- the typed taxonomy everything above raises.

`BeaconNodeAPI.get_healthz()` serves `health_snapshot()` below. Every
resilience counter is registered `always=True`: an operator reads them
most urgently when the node is degraded, whatever the telemetry switch
says.
"""
from __future__ import annotations

from . import checkpoint, dispatch, faults, integrity  # noqa: F401
from .checkpoint import CheckpointStore, last_good_generation
from .dispatch import (DegradationLadder, classify, guarded_dispatch, ladder,
                       run_with_recovery)
from .errors import (CheckpointCorrupt, CorruptOutput, DeadlineExceeded,
                     DispatchError, FatalDispatchError, ResilienceError,
                     SimulatedCrash, TransientDispatchError)

__all__ = [
    "CheckpointStore", "CheckpointCorrupt", "CorruptOutput",
    "DeadlineExceeded", "DegradationLadder", "DispatchError",
    "FatalDispatchError", "ResilienceError", "SimulatedCrash",
    "TransientDispatchError", "checkpoint", "classify", "dispatch", "faults",
    "guarded_dispatch", "health_snapshot", "integrity", "ladder",
    "last_good_generation", "reset", "run_with_recovery", "snapshot",
]

# the reference's list
_HEALTH_COUNTERS = (
    "resilience.retries", "resilience.deadline_misses",
    "resilience.transient_errors", "resilience.fatal_errors",
    "resilience.corrupt_outputs", "resilience.degradations",
    "resilience.degradations.single_device",
    "resilience.deadline_salvaged",
    "resilience.faults_injected", "watchdog.retrace_events",
    "watchdog.relayout_events", "firehose.deadline_miss",
)


def health_snapshot() -> dict:
    """The /healthz body: the degradation rung, the recovery counters and
    the checkpoint provenance, as a JSON-ready dict."""
    from .. import telemetry

    lad = ladder()
    counters = {name.split("resilience.", 1)[-1]:
                int(telemetry.counter(name, always=True).value)
                for name in _HEALTH_COUNTERS}
    return {
        "status": "ok" if lad.rung == 0 else "degraded",
        "rung": {
            "index": lad.rung,
            "name": lad.rung_name,
            "of": list(DegradationLadder.RUNGS),
        },
        "counters": counters,
        "checkpoint": {
            "last_good_generation": last_good_generation(),
            "saves": int(telemetry.counter(
                "resilience.checkpoint.saves", always=True).value),
            "corrupt_generations": int(telemetry.counter(
                "resilience.checkpoint.corrupt_generations",
                always=True).value),
        },
        "faults_active": faults.active(),
        "deadline_ms": dispatch.deadline_ms_default() or None,
    }


def reset() -> None:
    """Ladder back to full speed and the fault schedule disarmed (metric
    values live in the telemetry registry: telemetry.reset() zeroes
    them)."""
    ladder().reset()
    faults.set_schedule(None)


def snapshot() -> dict:
    """Alias of health_snapshot for per-run JSON rows."""
    return health_snapshot()
