"""Shared lazy-import telemetry handles for the streaming package (copy
of consensus_specs_tpu/streaming/_metrics.py).

One definition for the three modules (queue/pipeline/verifier): every
firehose instrument is registered `always=True` — /healthz reads them
most urgently exactly when observability might be switched off — and
the telemetry import stays inside the call so the package is importable
without dragging the registry in at module load.
"""
from __future__ import annotations


def counter(name: str):
    from .. import telemetry
    return telemetry.counter(name, always=True)


def gauge(name: str):
    from .. import telemetry
    return telemetry.gauge(name, always=True)


def histogram(name: str):
    from .. import telemetry
    return telemetry.histogram(name, always=True)


def span(name: str, **args):
    from .. import telemetry
    return telemetry.span(name, **args)
