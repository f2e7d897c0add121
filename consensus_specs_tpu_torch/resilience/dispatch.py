"""Deadline-budgeted guarded dispatch (port of the `classify` and
`guarded_dispatch` half of consensus_specs_tpu/resilience/dispatch.py).

`guarded_dispatch(key, fn, *args, deadline_ms=...)` wraps a device launch:

  * **fast path** -- with no deadline and no integrity check it is
    `telemetry.watchdog.dispatch` inside one try-frame: no synchronize,
    so the launch stays asynchronous. The taxonomy and the retry still
    apply when the call itself raises.
  * **deadline** -- with a budget armed (`deadline_ms=` > 0), the guard
    measures wall clock around the call plus a synchronize of the
    current stream of every CUDA device holding a tensor of the output
    (the stream the call launched on: call the guard under the stream
    the work belongs to). A miss is retried warm before anything is
    raised. On a zero-retry site a valid-but-late output is SALVAGED
    instead of raised: discarding correct work would turn lateness into
    unavailability; the miss is counted (`resilience.deadline_misses`,
    `resilience.deadline_salvaged`).
  * **taxonomy + retry** -- failures classify into the typed errors of
    resilience/errors.py: `torch.cuda.OutOfMemoryError` (and the
    reference's transient status words) retry with exponential backoff;
    a sticky CUDA error -- an illegal address, a launch failure, an
    error code returned by a hand kernel's launcher -- is FATAL and never
    retried: the CUDA context is poisoned, and a retry on it would only
    hide the fault. Clock and sleeper are injectable, so the retry tests
    run on a fake clock.

The reference reads its default budget from an environment switch; here
the budget is the `deadline_ms=` argument only (None or 0: unarmed).

Still to port with the rest of the resilience layer: the seeded fault
injection (`faults.py`, the injected raise / hang / poison branches of
the reference's guard), `DegradationLadder`, `run_with_recovery`,
`integrity.py`, `checkpoint.py` and `health_snapshot`. Until then this
guard has no fault-injection branch at all.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from .. import telemetry
from ..telemetry import core as _tcore
from ..telemetry import watchdog as _watchdog
from .errors import (CorruptOutput, DeadlineExceeded, DispatchError,
                     FatalDispatchError, TransientDispatchError)

RETRIES_DEFAULT = 2
BACKOFF_MS_DEFAULT = 25.0

# status words of infrastructure weather a runtime may raise (the
# reference's classes); checked after the sticky CUDA errors below
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "INTERNAL",
                      "ABORTED", "DEADLINE_EXCEEDED", "CANCELLED")
# a sticky CUDA error poisons the context: every later call fails too
_STICKY_CUDA_MARKERS = ("CUDA error", "cudaError", "illegal memory access",
                        "illegal address", "launch failure",
                        "device-side assert", "misaligned address")


def _counter(name: str):
    return telemetry.counter(name, always=True)


def classify(exc: Exception) -> str:
    """-> "transient" | "fatal". Out of memory is transient; a sticky
    CUDA error is fatal whatever else its message says."""
    import torch
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "transient"
    msg = str(exc)
    if any(marker in msg for marker in _STICKY_CUDA_MARKERS):
        return "fatal"
    if any(marker in msg for marker in _TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


def _synchronize_output(out) -> None:
    """Wait for the device work behind `out`: the current stream of each
    CUDA device holding one of its tensors."""
    import torch
    for dev in _tcore._cuda_devices((out,)):
        torch.cuda.current_stream(dev).synchronize()


def guarded_dispatch(key, fn: Callable, *args,
                     deadline_ms: Optional[float] = None,
                     check: Optional[Callable] = None,
                     retries: int = RETRIES_DEFAULT,
                     backoff_ms: float = BACKOFF_MS_DEFAULT,
                     clock: Callable[[], float] = time.perf_counter,
                     sleep: Callable[[float], None] = time.sleep):
    """Call `fn(*args)` through the retrace watchdog under `key`, with
    the guard rails above. Raises the typed DispatchError taxonomy after
    `retries` extra attempts; returns the (checked) output otherwise.
    `check(out) -> bool` is an integrity tripwire."""
    armed = bool(deadline_ms)
    last_error: Optional[DispatchError] = None
    attempt = 0
    while True:
        if attempt:
            _counter("resilience.retries").inc()
            delay = backoff_ms * (2.0 ** (attempt - 1)) / 1e3
            with telemetry.span("resilience.backoff", key=str(key),
                                attempt=attempt):
                sleep(delay)
        t0 = clock() if armed else 0.0
        try:
            out = _watchdog.dispatch(key, fn, *args)
            if armed:
                _synchronize_output(out)
        except DispatchError:
            raise
        except Exception as exc:        # noqa: BLE001 - classified below
            if classify(exc) == "transient":
                _counter("resilience.transient_errors").inc()
                last_error = TransientDispatchError(
                    str(exc), key=key, attempts=attempt + 1)
                last_error.__cause__ = exc
                if attempt >= retries:
                    break
                attempt += 1
                continue
            _counter("resilience.fatal_errors").inc()
            raise FatalDispatchError(
                f"non-retryable dispatch failure at {key!r}: {exc}",
                key=key, attempts=attempt + 1) from exc
        # the measured window closes here: the deadline covers the call
        # and its synchronize, never the tripwire below
        elapsed_ms = (clock() - t0) * 1e3 if armed else 0.0
        check_ok = True
        if check is not None:
            try:
                check_ok = bool(check(out))
            except Exception as exc:    # noqa: BLE001 - classified below
                if classify(exc) != "transient":
                    _counter("resilience.fatal_errors").inc()
                    raise FatalDispatchError(
                        f"integrity check failed at {key!r}: {exc}",
                        key=key, attempts=attempt + 1) from exc
                _counter("resilience.transient_errors").inc()
                last_error = TransientDispatchError(
                    f"integrity check transiently failed at {key!r}: "
                    f"{exc}", key=key, attempts=attempt + 1)
                last_error.__cause__ = exc
                if attempt >= retries:
                    break
                attempt += 1
                continue
        if armed and elapsed_ms > deadline_ms:
            _counter("resilience.deadline_misses").inc()
            if retries == 0 and check_ok:
                # zero-retry site: the output is valid, merely late;
                # salvage it and leave the miss on the counters
                _counter("resilience.deadline_salvaged").inc()
                return out
            last_error = DeadlineExceeded(
                f"dispatch {key!r} took {elapsed_ms:.1f} ms against "
                f"a {deadline_ms:.0f} ms budget",
                key=key, attempts=attempt + 1,
                elapsed_ms=elapsed_ms, deadline_ms=deadline_ms)
            if attempt >= retries:
                break
            attempt += 1
            continue
        if not check_ok:
            _counter("resilience.corrupt_outputs").inc()
            last_error = CorruptOutput(
                f"integrity tripwire rejected the output of {key!r}",
                key=key, attempts=attempt + 1)
            if attempt >= retries:
                break
            attempt += 1
            continue
        return out
    assert last_error is not None
    raise last_error
