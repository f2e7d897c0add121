"""Typed errors of the resilience layer (port of
consensus_specs_tpu/resilience/errors.py), so a caller branches on type,
never on message text. Everything derives from `ResilienceError`.
Imports nothing of the package, so any layer can import the types.

The dispatch taxonomy (resilience/dispatch.py):

  * `TransientDispatchError` -- worth retrying with backoff (the device
    ran out of memory for this attempt);
  * `DeadlineExceeded`      -- the call and the synchronize of its
    output blew the armed wall-clock budget;
  * `CorruptOutput`         -- an integrity tripwire rejected the output;
  * `FatalDispatchError`    -- not retryable (a bug, or a sticky CUDA
    error: the context is poisoned); wraps and chains the original.

`CheckpointCorrupt` and `SimulatedCrash` belong to the checkpoint store
(resilience/checkpoint.py); `InjectedFault` is what the fault harness
(resilience/faults.py) raises for an injected dispatch failure.
"""
from __future__ import annotations


class ResilienceError(Exception):
    """Base class of every typed failure the layer raises."""


class DispatchError(ResilienceError):
    """Base class of the guarded-dispatch taxonomy. `key` names the
    logical program (the watchdog key); `attempts` counts the tries the
    guard spent; `consumed_inputs` records whether the failing attempt
    entered the dispatched function (recovery code branches on it)."""

    def __init__(self, message: str = "", *, key=None, attempts: int = 1,
                 consumed_inputs: bool = True):
        super().__init__(message)
        self.key = key
        self.attempts = attempts
        self.consumed_inputs = consumed_inputs


class TransientDispatchError(DispatchError):
    """Retryable failure (the device was out of memory for this try)."""


class DeadlineExceeded(DispatchError):
    """The dispatch missed its wall-clock budget. `elapsed_ms` /
    `deadline_ms` carry the measurement."""

    def __init__(self, message: str = "", *, key=None, attempts: int = 1,
                 elapsed_ms: float = 0.0, deadline_ms: float = 0.0):
        super().__init__(message, key=key, attempts=attempts)
        self.elapsed_ms = elapsed_ms
        self.deadline_ms = deadline_ms


class CorruptOutput(DispatchError):
    """An integrity tripwire rejected the dispatch output: the buffer is
    dropped, never written into the state."""


class FatalDispatchError(DispatchError):
    """Not retryable: a real bug, a sticky CUDA error, or retries
    exhausted without a transient cause. The original exception (when
    one exists) rides as `__cause__`."""


class CheckpointCorrupt(ResilienceError):
    """A checkpoint payload failed validation: bad magic or version,
    length mismatch, CRC failure (resilience/checkpoint.py's framing), or
    state bytes that do not parse as a serialized BeaconState
    (`ResidentCore.from_checkpoint`'s up-front validation). Carries the
    `generation` when the store knows it (None for raw byte entries)."""

    def __init__(self, message: str = "", *, generation=None):
        super().__init__(message)
        self.generation = generation


class SimulatedCrash(ResilienceError):
    """Raised by the fault harness to model a process killed mid-write
    (`ckpt.write=crash`). Not a CheckpointCorrupt: recovery code must
    treat it like a real crash."""


class InjectedFault(RuntimeError):
    """The exception of a `dispatch=raise` / `dispatch=fatal` fault. A
    RuntimeError, not a ResilienceError: an injected fault goes through
    the same message classification as the failures it simulates."""
