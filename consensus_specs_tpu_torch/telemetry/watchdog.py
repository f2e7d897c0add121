"""Runtime watchdogs for the two silent performance killers of a
steady-state serving loop (port of consensus_specs_tpu/telemetry/watchdog.py).

Eager PyTorch has no compile cache to read, so the two events are defined
on what a call site can observe:

  * **retrace** -- `dispatch(key, fn, *args)` fingerprints the argument
    signature (shape, dtype and device of every tensor leaf; shape and
    dtype of every numpy leaf; the type of any other leaf) under `key`.
    The key names the logical program with the static context the caller
    believes pins it (a batch shape, a ring size), so the first signature
    seen under a key is warm-up and every NEW signature after it is a
    retrace event: dtype drift, a shape leaking out of the key, a tensor
    arriving on another device. Each one increments
    `watchdog.retrace_events` and warns (`TelemetryWarning`).
  * **re-layout** -- `layout_check(key, tree)` fingerprints the device,
    dtype, shape and strides of every tensor leaf and compares them with
    the key's previous fingerprint: a chained value (the verdict ring,
    the resident columns) that moved, changed type or was re-laid-out
    between steps. Each change increments `watchdog.relayout_events`
    and warns.

Both are no-ops when telemetry is off: `dispatch` degrades to a plain
call, `layout_check` to None.
"""
from __future__ import annotations

import threading
import warnings
from typing import Dict, Optional

from . import core


class TelemetryWarning(UserWarning):
    """Watchdog warnings (retrace / re-layout in a steady-state loop)."""


_lock = threading.Lock()
# key -> {"calls", "events", "seen": set of argument signatures}
_retrace: Dict[object, dict] = {}
# key -> last layout fingerprint
_layouts: Dict[object, tuple] = {}


def _leaf_signature(leaf):
    import numpy as np
    import torch
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    if isinstance(leaf, np.ndarray):
        return ("ndarray", leaf.shape, str(leaf.dtype))
    return (type(leaf).__name__,)


def _signature(args) -> tuple:
    """The argument signature `dispatch` keys retraces on."""
    return tuple(_leaf_signature(leaf) for leaf in core._leaves(args))


def dispatch(key, fn, *args):
    """Call `fn(*args)`, counting a retrace event when `key` meets an
    argument signature it has not seen before, after its first one.
    A plain call when telemetry is off."""
    if not core.enabled():
        return fn(*args)
    sig = _signature(args)
    retraced = False
    with _lock:
        state = _retrace.setdefault(key, {"calls": 0, "events": 0,
                                          "seen": set()})
        state["calls"] += 1
        if sig not in state["seen"]:
            if state["seen"]:
                state["events"] += 1
                retraced = True
            state["seen"].add(sig)
    if retraced:
        core.counter("watchdog.retrace_events").inc()
        warnings.warn(
            f"telemetry: program {key!r} called with a new argument "
            f"signature after warm-up: a steady-state loop is retracing "
            f"(dtype drift? a shape leaking out of the key? another "
            f"device?)", TelemetryWarning, stacklevel=2)
    return fn(*args)


def layout_fingerprint(tree) -> tuple:
    """Per leaf: (device, dtype, shape, strides) for a tensor; "host"
    for anything else."""
    import torch
    fps = []
    for leaf in core._leaves(tree):
        if isinstance(leaf, torch.Tensor):
            fps.append((str(leaf.device), str(leaf.dtype), tuple(leaf.shape),
                        tuple(leaf.stride())))
        else:
            fps.append("host")
    return tuple(fps)


def layout_check(key, tree) -> Optional[tuple]:
    """Record `tree`'s layout fingerprint under `key`; a change from the
    previous fingerprint under the same key is a re-layout event. Use
    ONE key for a chained value, so any change between steps trips it."""
    if not core.enabled():
        return None
    fp = layout_fingerprint(tree)
    with _lock:
        prev = _layouts.get(key)
        _layouts[key] = fp
    if prev is not None and prev != fp:
        core.counter("watchdog.relayout_events").inc()
        warnings.warn(
            f"telemetry: {key!r} changed device, dtype, shape or strides "
            f"between steps: a chained value is being re-laid-out",
            TelemetryWarning, stacklevel=2)
    return fp


def stats(key=None) -> dict:
    """Retrace bookkeeping: per-key {calls, signatures, events} (the whole
    table when `key` is None)."""
    def row(st):
        return {"calls": st["calls"], "signatures": len(st["seen"]),
                "events": st["events"]}
    with _lock:
        if key is not None:
            st = _retrace.get(key)
            return row(st) if st else {"calls": 0, "signatures": 0,
                                       "events": 0}
        return {k: row(st) for k, st in _retrace.items()}


def reset() -> None:
    """Forget warm-up state and layout fingerprints (the event counters
    live in the metrics registry: core.reset() zeroes those)."""
    with _lock:
        _retrace.clear()
        _layouts.clear()


def forget(key) -> None:
    """Drop ONE key's warm-up and fingerprint state, for a deliberate,
    reported re-placement: the next observation under the key is warm-up
    again, not a steady-state event."""
    with _lock:
        _retrace.pop(key, None)
        _layouts.pop(key, None)


def install_compile_listener() -> bool:
    """No counterpart: the reference counts every backend compile through
    JAX's monitoring hooks. Eager PyTorch compiles nothing per call (the
    hand kernels are built once by ops/_nvcc.py), so there is nothing to
    listen to. Returns False, as the reference does where the hooks are
    unavailable."""
    return False
