"""Resilience layer (port of consensus_specs_tpu/resilience/): the typed
errors (errors.py) and the deadline-budgeted guarded dispatch
(dispatch.py) the streaming firehose launches through. Every resilience
counter is registered `always=True`: an operator reads them most urgently
when the node is degraded, whatever the telemetry switch says.

Not ported yet: fault injection, the degradation ladder, integrity
tripwires, generational checkpoints and the health snapshot (see
dispatch.py)."""
from .dispatch import classify, guarded_dispatch  # noqa: F401
from .errors import (CheckpointCorrupt, CorruptOutput,  # noqa: F401
                     DeadlineExceeded, DispatchError, FatalDispatchError,
                     ResilienceError, TransientDispatchError)
