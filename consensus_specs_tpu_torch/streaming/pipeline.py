"""Device pipeline of the attestation firehose (port of
consensus_specs_tpu/streaming/pipeline.py).

`FirehosePipeline` owns the device side of the streaming verifier:

  * **its own CUDA stream** -- each full batch is uploaded (pinned host
    buffers, `non_blocking=True`) and its grouped pairing
    (`ops/bls_torch.grouped_pairing_check`, the synchronous path's
    function, through `resilience.guarded_dispatch` unarmed) and ring
    scatter are launched under `torch.cuda.stream(self.stream)`, after
    `wait_stream` on the caller's stream. The hand kernels' wrappers
    launch on the current stream, so the whole batch runs there. The
    host's staging of the next batch reads its own results back on the
    caller's stream, and those reads no longer wait for the pairing. One
    CUDA event is recorded per batch; the flush waits on the newest.
  * **no host read on the dispatch path** -- `dispatch` returns once the
    launches are queued; nothing is read back per batch.
  * **verdict ring** -- one preallocated `[R]` bool tensor on the device,
    allocated on the pipeline's stream; each batch's `[G]` verdicts are
    copied into `ring[start:start + G]` in place on that stream (the
    reference's donated `dynamic_update_slice`; the ring's `data_ptr()`
    never changes). Every tensor of a batch is allocated on the
    pipeline's stream and used only there, so none crosses streams and
    none needs `record_stream`.
  * **deadline-bounded flush** -- `flush(deadline_ms)` is the ONLY point
    that blocks: one guarded, wall-clock-budgeted read of the ring on the
    pipeline's stream. The guard runs with retries=0, so a late ring is
    SALVAGED: the verdicts land, the miss is counted
    (`firehose.deadline_miss`, `resilience.deadline_misses`).
  * **watchdogs** -- the retrace watchdog keys the pairing on
    (pair count, padded groups) and the scatter on (ring size, padded
    groups); the re-layout watchdog fingerprints the ring after every
    scatter. A steady-state firehose launches with zero events of either
    kind.

On the CPU (the tests) there is no stream: every step runs in order.
The reference's TRACE_CONTRACTS and MEM_CONTRACTS (jaxpr tooling) have
no counterpart.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve
from ..resilience import guarded_dispatch
from ..telemetry import watchdog as _watchdog
from ._metrics import counter as _counter
from ._metrics import histogram as _histogram
from ._metrics import span as _span


class FirehosePipeline:
    """Grouped-pairing dispatch on a stream of its own + device verdict
    ring + deadline flush. `clock` / `sleep` go to `guarded_dispatch`, so
    the deadline tests run on a fake clock with no real sleep."""

    def __init__(self, *, device="cuda", deadline_ms: Optional[float] = None,
                 ring_capacity: int = 1024,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        assert ring_capacity >= 1
        self.device = resolve(device)
        self.deadline_ms = deadline_ms
        self.ring_capacity = int(ring_capacity)
        self._clock = clock
        self._sleep = sleep
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        with self._on_stream():
            self.ring = torch.zeros(self.ring_capacity, dtype=torch.bool,
                                    device=self.device)
        self._offset = 0                # next free ring slot
        # (keys, start, n, event) per batch awaiting the flush
        self._pending: List[tuple] = []
        self._harvested: Dict[object, bool] = {}   # ring drained early
        self.last_flush_at: Optional[float] = None
        self.launches = 0
        # real groups of the most recent launches (bounded: cumulative
        # totals live in the always-on counters)
        self.occupancies: collections.deque = collections.deque(
            maxlen=4096)

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    # -- state ----------------------------------------------------------

    @property
    def in_flight(self) -> int:
        """Batches dispatched and not yet flushed."""
        return len(self._pending)

    # -- dispatch (async) ------------------------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _scatter(self, verdicts: torch.Tensor, start: int) -> torch.Tensor:
        self.ring[start:start + verdicts.shape[0]].copy_(verdicts)
        return self.ring

    def dispatch(self, count: int, members) -> None:
        """Launch one batch: members = [(key, g1 [count,2,L],
        g2 [count,2,2,L])]. Returns once the upload, the pairing and the
        ring scatter are queued on the pipeline's stream; nothing is read
        back until `flush`."""
        from ..ops import bls_torch as BT

        keys = [m[0] for m in members]
        g1, g2 = BT.stage_group_arrays([(m[1], m[2]) for m in members], count)
        g = g1.shape[0]
        if g > self.ring_capacity:
            raise ValueError(
                f"firehose batch pads to {g} groups but the verdict "
                f"ring holds {self.ring_capacity}; size ring_capacity "
                f">= the padded target occupancy")
        if self._offset + g > self.ring_capacity:
            # ring full before the deadline: drain early (counted; at the
            # nominal load the capacity covers a whole flush window)
            _counter("firehose.ring_wraps").inc()
            self._harvested.update(self._drain())
        start = self._offset
        with _span("firehose.dispatch", groups=len(members), pairs=count,
                   padded=g):
            producer = (torch.cuda.current_stream(self.device)
                        if self.stream is not None else None)
            with self._on_stream():
                if producer is not None:
                    self.stream.wait_stream(producer)
                g1_t, g2_t = self._upload(g1), self._upload(g2)
                # unarmed guard: the launch stays asynchronous; the
                # taxonomy and the transient retry apply (the staged
                # inputs are not consumed), the deadline arms the flush
                out = guarded_dispatch(
                    ("firehose.batch", count, g), BT.grouped_pairing_check,
                    g1_t, g2_t, deadline_ms=0.0, clock=self._clock,
                    sleep=self._sleep)
                _watchdog.dispatch(("firehose.ring", self.ring_capacity, g),
                                   self._scatter, out, start)
                event = None
                if self.stream is not None:
                    event = torch.cuda.Event()
                    event.record(self.stream)
        # one key for the chained ring: any change of its placement,
        # type or strides between scatters is a re-layout event
        _watchdog.layout_check(("firehose.ring.layout", self.ring_capacity),
                               self.ring)
        self._pending.append((keys, start, len(members), event))
        self._offset += g
        self.launches += 1
        self.occupancies.append(len(members))
        _counter("firehose.launches").inc()
        _counter("firehose.groups_launched").inc(len(members))
        _histogram("firehose.batch_occupancy").observe(len(members))

    # -- flush (the only blocking point) ---------------------------------

    def _drain(self) -> Dict[object, bool]:
        """Wait for the newest pending batch's event, then read the ring
        back and map every pending batch's verdicts: the one device-to-host
        copy, on the pipeline's stream. Callers decide whether it runs
        under a deadline guard."""
        verdicts: Dict[object, bool] = {}
        if not self._pending:
            return verdicts
        newest = self._pending[-1][3]
        if newest is not None:
            newest.synchronize()    # the stream finishes batches in order
        with self._on_stream():
            ok = self.ring[:self._offset].cpu().numpy()
        for keys, start, _, _ in self._pending:
            for k, key in enumerate(keys):
                verdicts[key] = bool(ok[start + k])
        self._pending = []
        self._offset = 0
        return verdicts

    def flush(self, deadline_ms: Optional[float] = None
              ) -> Dict[object, bool]:
        """Block on everything in flight and return {key: verdict}.

        With a wall-clock budget armed (`deadline_ms` or the pipeline's
        default), the read runs through `guarded_dispatch` with
        retries=0: a late ring is SALVAGED and the miss counted."""
        from .. import telemetry

        if deadline_ms is None:
            deadline_ms = self.deadline_ms
        verdicts = dict(self._harvested)
        self._harvested = {}
        with _span("firehose.flush", batches=len(self._pending),
                   deadline_ms=deadline_ms or 0):
            if self._pending:
                misses0 = telemetry.counter(
                    "resilience.deadline_misses", always=True).value
                verdicts.update(guarded_dispatch(
                    ("firehose.flush", self.ring_capacity), self._drain,
                    deadline_ms=deadline_ms or 0.0, retries=0,
                    clock=self._clock, sleep=self._sleep))
                missed = telemetry.counter(
                    "resilience.deadline_misses", always=True).value - misses0
                if missed:
                    _counter("firehose.deadline_miss").inc(missed)
        _counter("firehose.groups_verified").inc(len(verdicts))
        self.last_flush_at = time.monotonic()
        return verdicts

