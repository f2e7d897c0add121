"""Telemetry: spans, metrics registry, runtime watchdogs, export (port of
consensus_specs_tpu/telemetry/).

    from consensus_specs_tpu_torch import telemetry

    with telemetry.span("resident.device") as sp:
        out = program(args)
        sp.fence(out)                       # synchronized at exit only
    telemetry.counter("firehose.launches", always=True).inc()
    telemetry.snapshot()                    # dict for JSON rows
    telemetry.prometheus_text()             # /metrics body
    telemetry.watchdog.dispatch(key, fn, *args)   # retrace watchdog
    telemetry.watchdog.layout_check(key, tree)    # re-layout watchdog

Switches are functions: `set_enabled(False)` makes every span and metric
a no-op (except `always=True` metrics), `set_fencing(False)` drops the
span-exit fences, `set_ring_size(n)` bounds the span ring.

Names (dot-separated `subsystem.stage`): spans `resident.*` (the resident
serving loop), `firehose.*` (the streaming verifier: stage / dispatch /
flush), `resilience.*`; counters `bls.grouped.*` (grouped-pairing launch
occupancy), `firehose.*` (queue depth, batch occupancy, deadline misses:
always on, /healthz reads them), `resilience.*`, `watchdog.*` (retrace /
re-layout events).
"""
from .core import (Counter, Gauge, Histogram, Span, counter, current_span,
                   enabled, fencing, gauge, histogram, instrument, reset,
                   ring, set_enabled, set_fencing, set_ring_size, snapshot,
                   span, span_seconds)
from .export import (chrome_trace, dump_chrome_trace, dump_prometheus,
                     prometheus_text, write_jsonl)
from . import watchdog
from .watchdog import TelemetryWarning

__all__ = [
    "Counter", "Gauge", "Histogram", "Span", "TelemetryWarning",
    "chrome_trace", "counter", "current_span", "dump_chrome_trace",
    "dump_prometheus", "enabled", "fencing", "gauge", "histogram",
    "instrument", "prometheus_text", "reset", "ring", "set_enabled",
    "set_fencing", "set_ring_size", "snapshot", "span", "span_seconds",
    "watchdog", "write_jsonl",
]
