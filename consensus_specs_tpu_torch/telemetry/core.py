"""Spans and the metrics registry (port of
consensus_specs_tpu/telemetry/core.py).

Spans time regions of the serving loop; a process-wide registry holds
counters, gauges and power-of-two histograms. The contract is the
reference's:

  * **off means no-op** -- after `set_enabled(False)`, `span()` returns a
    shared no-op singleton (no clock read, no ring write) and every
    counter, gauge and histogram mutation returns at once, except the
    metrics registered `always=True` (the firehose's and the resilience
    layer's, which /healthz reads whatever the switch says). On by
    default: a span costs two `perf_counter` reads and one deque append.
  * **fencing at span exit only** -- a span never synchronizes between
    the statements it wraps. `Span.fence(tensors)` records one CUDA
    event on the current stream (the stream that produced them, when
    called right after it did) and the span synchronizes that event at
    exit, inside the measured window, so the recorded wall time covers
    the device work the region launched. CPU tensors and host values need
    no fence; a span with nothing fenced never synchronizes.
    `set_fencing(False)` turns the exit fences off (launch-only timing).
  * **nesting** -- a per-thread parent/child stack; a ring of the most
    recent finished spans (4096 by default, `set_ring_size`) for the
    Chrome-trace export, and a per-name aggregate (count / total / last)
    that survives ring eviction for `snapshot()` and Prometheus.

The reference reads three environment switches; here they are the
functions `set_enabled`, `set_fencing` and `set_ring_size`.
"""
from __future__ import annotations

import collections
import functools
import math as _math
import threading
import time
from typing import Dict, Iterator, List, Optional

_enabled = True
_fencing = True


def enabled() -> bool:
    """Telemetry master switch (on unless `set_enabled(False)`)."""
    return _enabled


def set_enabled(value: Optional[bool]) -> None:
    """Switch telemetry on or off; None restores the default (on)."""
    global _enabled
    assert value is None or isinstance(value, bool), value
    _enabled = True if value is None else value


def fencing() -> bool:
    """Span-exit fencing switch (on unless `set_fencing(False)`)."""
    return _fencing


def set_fencing(value: Optional[bool]) -> None:
    """Switch the span-exit fences on or off; None restores the default."""
    global _fencing
    assert value is None or isinstance(value, bool), value
    _fencing = True if value is None else value


# ---------------------------------------------------------------------------
# Span API
# ---------------------------------------------------------------------------

RING_SIZE_DEFAULT = 4096
_EPOCH = time.perf_counter()     # the process's time zero for trace timestamps

_ring: collections.deque = collections.deque(maxlen=RING_SIZE_DEFAULT)
# name -> [count, total_seconds, last_seconds]
_span_agg: Dict[str, List] = {}
_tls = threading.local()
_lock = threading.Lock()


def set_ring_size(size: int = RING_SIZE_DEFAULT) -> None:
    """Keep the `size` most recent finished spans (the ring is rebuilt
    with that bound; the newest entries carry over)."""
    global _ring
    assert size >= 1, size
    with _lock:
        _ring = collections.deque(_ring, maxlen=int(size))


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _leaves(tree) -> Iterator:
    """Leaf iteration: tuples (namedtuples included), lists and dict
    values recurse; everything else is a leaf."""
    if isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _leaves(item)
    else:
        yield tree


def _cuda_devices(trees) -> list:
    """The distinct CUDA devices holding a tensor leaf of `trees`."""
    import torch
    devices = []
    for tree in trees:
        for leaf in _leaves(tree):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda \
                    and leaf.device not in devices:
                devices.append(leaf.device)
    return devices


class Span:
    """One timed region. Use via the `span(...)` factory:

        with telemetry.span("resident.device") as sp:
            out = program(args)
            sp.fence(out)           # synchronized at exit, never inside
        sp.duration                 # seconds

    Or as a decorator through `telemetry.instrument("name")`.
    """

    __slots__ = ("name", "args", "t0", "dur", "_depth", "_parent", "_events")

    def __init__(self, name: str, args: Optional[dict] = None):
        self.name = name
        self.args = args or {}
        self.t0 = 0.0
        self.dur = 0.0
        self._depth = 0
        self._parent = ""
        self._events: list = []

    # -- annotations --------------------------------------------------------

    def note(self, **kv) -> "Span":
        self.args.update(kv)
        return self

    def fence(self, *trees) -> "Span":
        """Mark device outputs to wait for at span exit: one CUDA event
        recorded now on the current stream of each device holding a
        tensor of `trees` (host values and CPU tensors are ready
        already). Exit-only by design: waiting inside the span would
        serialize the launches being measured."""
        if fencing():
            import torch
            for dev in _cuda_devices(trees):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self._events.append(ev)
        return self

    @property
    def duration(self) -> float:
        return self.dur

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "Span":
        stack = _stack()
        self._parent = stack[-1].name if stack else ""
        self._depth = len(stack)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # no fence on the exception path: waiting on a half-launched
        # region could raise a second device error and mask the first
        if exc_type is None and fencing():
            for ev in self._events:
                ev.synchronize()
        self._events = []
        self.dur = time.perf_counter() - self.t0
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:        # unbalanced exit (generator teardown)
            stack.remove(self)
        # the lock lets snapshot() / ring() (a concurrent scrape) iterate
        # without racing dict / deque mutation
        with _lock:
            agg = _span_agg.setdefault(self.name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += self.dur
            agg[2] = self.dur
            _ring.append({
                "name": self.name,
                "ts": self.t0 - _EPOCH,
                "dur": self.dur,
                "depth": self._depth,
                "parent": self._parent,
                "tid": threading.get_ident(),
                "args": dict(self.args) if self.args else None,
            })
        return False


class _NullSpan:
    """Shared no-op span: what `span()` hands out when telemetry is off.
    Every method returns at once; `duration` is 0.0."""

    __slots__ = ()
    name = ""
    args: dict = {}
    duration = 0.0
    dur = 0.0

    def note(self, **kv):
        return self

    def fence(self, *trees):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, **args):
    """A context-managed span named `name` (dot-separated scheme
    `subsystem.stage`, e.g. "resident.device", "firehose.flush").
    Returns the shared no-op singleton when telemetry is off."""
    if not enabled():
        return _NULL_SPAN
    return Span(name, args or None)


def instrument(name: str, **args):
    """Decorator form of `span`: the on/off check happens per call, so
    functions decorated at import follow later `set_enabled` calls."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(name, **args):
                return fn(*a, **kw)
        return wrapper
    return deco


def current_span():
    """The innermost open span on this thread (None outside any span)."""
    stack = _stack()
    return stack[-1] if stack else None


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter. `always=True` records even when telemetry is
    off: the accounting /healthz and the tests read whatever the switch."""

    __slots__ = ("name", "always", "value")

    def __init__(self, name: str, always: bool = False):
        self.name = name
        self.always = always
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if self.always or enabled():
            self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    __slots__ = ("name", "always", "value")

    def __init__(self, name: str, always: bool = False):
        self.name = name
        self.always = always
        self.value = 0.0

    def set(self, v) -> None:
        if self.always or enabled():
            self.value = v

    def reset(self) -> None:
        self.value = 0.0


_NONPOS_BUCKET = -(10 ** 9)   # sentinel exponent for the `<= 0` bucket


class Histogram:
    """Power-of-two buckets: an observation v lands in the bucket whose
    upper bound is the smallest 2**k >= v (negative exponents included;
    non-positive values land in the `0` bucket). Tracks count and sum
    like Prometheus."""

    __slots__ = ("name", "always", "counts", "total", "count")

    def __init__(self, name: str, always: bool = False):
        self.name = name
        self.always = always
        self.counts: Dict[int, int] = {}   # exponent k -> observations
        self.total = 0.0
        self.count = 0

    @staticmethod
    def bucket_exp(v) -> Optional[int]:
        if v <= 0:
            return None
        # frexp gives v = m * 2**e with 0.5 <= m < 1, so the smallest k
        # with v <= 2**k is e, except exactly at powers of two (m == 0.5),
        # where it is e - 1
        m, e = _math.frexp(v)
        return e - 1 if m == 0.5 else e

    def observe(self, v) -> None:
        if not (self.always or enabled()):
            return
        self.count += 1
        self.total += v
        k = self.bucket_exp(v)
        key = _NONPOS_BUCKET if k is None else k  # `<= 0` bucket sorts first
        self.counts[key] = self.counts.get(key, 0) + 1

    def reset(self) -> None:
        self.counts = {}
        self.total = 0.0
        self.count = 0


_counters: Dict[str, Counter] = {}
_gauges: Dict[str, Gauge] = {}
_histograms: Dict[str, Histogram] = {}


def _get(registry: dict, cls, name: str, always: bool):
    metric = registry.get(name)
    if metric is None:
        with _lock:
            metric = registry.setdefault(name, cls(name, always))
    if always and not metric.always:
        metric.always = True
    return metric


def counter(name: str, always: bool = False) -> Counter:
    return _get(_counters, Counter, name, always)


def gauge(name: str, always: bool = False) -> Gauge:
    return _get(_gauges, Gauge, name, always)


def histogram(name: str, always: bool = False) -> Histogram:
    return _get(_histograms, Histogram, name, always)


# ---------------------------------------------------------------------------
# Snapshot / reset
# ---------------------------------------------------------------------------

def snapshot() -> dict:
    """One JSON-ready view of everything: counters, gauges, histograms
    and per-span-name aggregates, taken under the module lock so a
    concurrent scrape never races metric creation or a span close."""
    with _lock:
        return {
            "enabled": enabled(),
            "counters": {n: c.value for n, c in sorted(_counters.items())},
            "gauges": {n: g.value for n, g in sorted(_gauges.items())},
            "histograms": {
                n: {
                    "count": h.count,
                    "sum": h.total,
                    "buckets": {
                        ("0" if k == _NONPOS_BUCKET else
                         str(2.0 ** k) if k < 0 else str(2 ** k)): v
                        for k, v in sorted(h.counts.items())
                    },
                }
                for n, h in sorted(_histograms.items())
            },
            "spans": {
                n: {"count": a[0], "total_ms": round(a[1] * 1e3, 3),
                    "last_ms": round(a[2] * 1e3, 3)}
                for n, a in sorted(_span_agg.items())
            },
        }


def span_seconds(name: str, which: str = "last") -> float:
    """Seconds of the `last` (default) or `total` time recorded under a
    span name; 0.0 when the name never closed."""
    agg = _span_agg.get(name)
    if agg is None:
        return 0.0
    return agg[1] if which == "total" else agg[2]


def reset() -> None:
    """Zero every metric and drop span history. Registered metric objects
    survive (module-level handles keep their identity); the watchdog's
    state is separate (watchdog.reset())."""
    with _lock:
        for registry in (_counters, _gauges, _histograms):
            for metric in registry.values():
                metric.reset()
        _span_agg.clear()
        _ring.clear()


def ring() -> list:
    """The finished-span ring (the most recent spans, oldest first)."""
    with _lock:
        return list(_ring)
