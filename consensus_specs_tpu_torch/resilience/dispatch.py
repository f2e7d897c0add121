"""Deadline-budgeted guarded dispatch with fault injection and the
degradation ladder (port of consensus_specs_tpu/resilience/dispatch.py).

`guarded_dispatch(key, fn, *args, deadline_ms=...)` wraps a device launch:

  * **fast path** -- with no fault schedule armed, no deadline and no
    integrity check it is `telemetry.watchdog.dispatch` inside one
    try-frame: no synchronize, so the launch stays asynchronous. The
    taxonomy and the retry still apply when the call itself raises.
  * **deadline** -- with a budget armed (`deadline_ms=` > 0, or the
    process default `set_deadline_ms_default(ms)` when the argument is
    None), the guard measures wall clock around the call plus a
    synchronize of the current stream of every CUDA device holding a
    tensor of the output (the stream the call launched on: call the
    guard under the stream the work belongs to). A miss is retried warm
    before anything is raised. On a zero-retry site a valid-but-late
    output is SALVAGED instead of raised: discarding correct work would
    turn lateness into unavailability; the miss is counted
    (`resilience.deadline_misses`, `resilience.deadline_salvaged`).
  * **taxonomy + retry** -- failures classify into the typed errors of
    resilience/errors.py: `torch.cuda.OutOfMemoryError` (and the
    reference's transient status words) retry with exponential backoff;
    a sticky CUDA error -- an illegal address, a launch failure, an
    error code returned by a hand kernel's launcher -- is FATAL and never
    retried: the CUDA context is poisoned, and a retry on it would only
    hide the fault. Clock and sleeper are injectable, so the retry tests
    run on a fake clock.
  * **fault injection** -- with a schedule armed (resilience/faults.py),
    each attempt consults `faults.on_dispatch(key)`: `raise` / `fatal`
    raise before the call, `hang` sleeps through the guard's `sleep`
    inside the measured window, `poison` corrupts one leaf of the output
    before the integrity check.

**Consumed inputs.** The guard records on every typed error whether the
failing attempt entered `fn` (`consumed_inputs`). A site whose program
updates its arguments in place -- the resident epoch boundary -- passes
`retries=0`: a failure after the call has been entered must not call
`fn` again on the updated buffers. A failure that provably came before
the call leaves them intact, so it keeps the standard allowance
`max(retries, RETRIES_DEFAULT)`; the allowance is per failure, never
sticky: once an attempt has entered `fn`, the caller's `retries`
applies again.

**The degradation ladder has two rungs.** The reference walks `full ->
merkle_xla -> redc_leaf -> scalar_double_add -> single_device`: its
rungs 1-3 each swap a kernel for its plain twin, which in the port
would be the hidden fallback its rules forbid, so they are left out.
`DegradationLadder.RUNGS == ("full", "single_device")`: the bottom rung
calls back whatever registered with `register_single_device` (a
ResidentCore serving on a mesh registers its
`degrade_to_single_device` around each step, and re-dispatches its
boundary on one device), and `degrade()` returns None once there, so the
caller escalates to `FatalDispatchError`. `reset()` returns the rung
gauge to 0, never a core to its mesh: a core that went single-device
re-shards only through a restore, and the cumulative
`resilience.degradations.single_device` counter keeps that visible on
/healthz. Restoring from a checkpoint stays the caller's job, as in the
reference (`resilience.CheckpointStore.restore`, then replay the slots);
an in-loop restore-and-replay rung would need a block log the reference
does not keep.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from .. import telemetry
from ..telemetry import core as _tcore
from ..telemetry import watchdog as _watchdog
from . import faults
from .errors import (CorruptOutput, DeadlineExceeded, DispatchError,
                     FatalDispatchError, TransientDispatchError)

RETRIES_DEFAULT = 2
BACKOFF_MS_DEFAULT = 25.0

_deadline_ms_default = 0.0

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


def is_device_fault(exc: BaseException) -> bool:
    """True when `exc` is the card's fault, not the input's: a sticky CUDA
    error, the card out of memory, a kernel that failed to build, or a
    typed error of the guard (also where one of these is the `__cause__`).
    Host code that turns errors into a verdict or a response code -- the
    RPC server, node-record verification, the gossip router's handler
    isolation -- re-raises these: read as "bad input", a poisoned context
    would drop every peer and answer every request with an error code."""
    import torch
    from ..ops._nvcc import KernelCompileError
    while exc is not None:
        if isinstance(exc, (torch.cuda.OutOfMemoryError, KernelCompileError,
                            DispatchError)):
            return True
        if any(marker in str(exc) for marker in _STICKY_CUDA_MARKERS):
            return True
        exc = exc.__cause__
    return False


def set_deadline_ms_default(ms: Optional[float]) -> None:
    """The budget a guard uses when its `deadline_ms` is None (0 or None:
    unarmed, the default)."""
    global _deadline_ms_default
    _deadline_ms_default = float(ms or 0.0)


def deadline_ms_default() -> float:
    return _deadline_ms_default


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
    `check(out) -> bool` is an integrity tripwire (resilience/
    integrity.py)."""
    if deadline_ms is None:
        deadline_ms = _deadline_ms_default
    faulty = faults.active()
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
        fault = faults.on_dispatch(key) if faulty else None
        t0 = clock() if armed else 0.0
        dispatched = False      # has fn been entered (inputs consumed)?
        try:
            if fault is not None and fault.action in ("raise", "fatal"):
                faults.raise_injected(key, fault)
            dispatched = True
            out = _watchdog.dispatch(key, fn, *args)
            if fault is not None and fault.action == "hang":
                # the injected wedge burns wall clock inside the window
                sleep(float(fault.param or 100.0) / 1e3)
            if armed:
                _synchronize_output(out)
        except DispatchError:
            raise
        except Exception as exc:        # noqa: BLE001 - classified below
            if classify(exc) == "transient":
                _counter("resilience.transient_errors").inc()
                last_error = TransientDispatchError(
                    str(exc), key=key, attempts=attempt + 1,
                    consumed_inputs=dispatched)
                last_error.__cause__ = exc
                # a failure before the call leaves the inputs intact:
                # the standard allowance, whatever the caller pinned
                allowance = retries if dispatched \
                    else max(retries, RETRIES_DEFAULT)
                if attempt >= allowance:
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
        if fault is not None and fault.action == "poison":
            out = faults.poison_tree(out, fault.param)
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


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------

class DegradationLadder:
    """The serving loop's conservatism level, reported on /healthz: full
    speed, then single device (see the module docstring); below that
    `degrade()` returns None and the caller escalates to fatal."""

    RUNGS = ("full", "single_device")

    def __init__(self):
        self._rung = 0
        self._single_device_cbs = []

    def register_single_device(self, cb: Callable[[], None]) -> None:
        """Hook the bottom rung: ResidentCore registers its
        `degrade_to_single_device` here so the ladder can re-place the
        serving loop without importing it."""
        if cb not in self._single_device_cbs:
            self._single_device_cbs.append(cb)

    def unregister_single_device(self, cb: Callable[[], None]) -> None:
        if cb in self._single_device_cbs:
            self._single_device_cbs.remove(cb)

    @property
    def rung(self) -> int:
        return self._rung

    @property
    def rung_name(self) -> str:
        return self.RUNGS[self._rung]

    @property
    def exhausted(self) -> bool:
        return self._rung >= len(self.RUNGS) - 1

    def degrade(self, reason: str = "") -> Optional[str]:
        """Step one rung down; returns the new rung name, or None at the
        bottom. Counted (`resilience.degradations[.<rung>]`) and gauged
        (`resilience.rung`)."""
        if self.exhausted:
            return None
        self._rung += 1
        name = self.rung_name
        with telemetry.span("resilience.degrade", rung=name, reason=reason or None):
            if name == "single_device":
                for cb in list(self._single_device_cbs):
                    cb()
        _counter("resilience.degradations").inc()
        _counter(f"resilience.degradations.{name}").inc()
        telemetry.gauge("resilience.rung", always=True).set(self._rung)
        return name

    def reset(self) -> None:
        """Back to full speed (the gauge; a core that re-placed itself on
        one device stays there until a restore)."""
        self._rung = 0
        telemetry.gauge("resilience.rung", always=True).set(0)


_LADDER = DegradationLadder()


def ladder() -> DegradationLadder:
    """The process-global ladder (what /healthz reports)."""
    return _LADDER


def run_with_recovery(key, make: Callable[[], tuple], *,
                      deadline_ms: Optional[float] = None,
                      check: Optional[Callable] = None,
                      ladder: Optional[DegradationLadder] = None,
                      retries: int = RETRIES_DEFAULT,
                      backoff_ms: float = BACKOFF_MS_DEFAULT,
                      clock: Callable[[], float] = time.perf_counter,
                      sleep: Callable[[float], None] = time.sleep):
    """guarded_dispatch + the ladder: `make()` returns a fresh
    `(fn, args)` pair per attempt (re-read after each degradation), and
    every typed failure that survives its retries walks one rung before
    the next attempt. Raises FatalDispatchError when the ladder is
    exhausted."""
    lad = ladder if ladder is not None else _LADDER
    while True:
        fn, args = make()
        try:
            return guarded_dispatch(key, fn, *args,
                                    deadline_ms=deadline_ms, check=check,
                                    retries=retries, backoff_ms=backoff_ms,
                                    clock=clock, sleep=sleep)
        except FatalDispatchError:
            raise
        except DispatchError as exc:
            rung = lad.degrade(reason=type(exc).__name__)
            if rung is None:
                raise FatalDispatchError(
                    f"dispatch {key!r} failed at the bottom of the "
                    f"degradation ladder: {exc}",
                    key=key, attempts=exc.attempts) from exc
