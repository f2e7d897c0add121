"""Reduction of a torch.profiler trace of the measured window.

Device time is read from the CUDA activity of the trace (kernels, copies
and fills), as `chip_smoke.py::profile_window` read it: the labels'
device-side annotation ranges are left out, since they span the kernels
they hold. Busy time is the union of the device intervals, so work on two
streams at once counts once; the window is the host range labelled
"bench.window" on the profiler's own clock. An idle gap is a stretch of
the window with nothing on the device, named by the innermost
benchmark span ("bench.*") open on the host at its midpoint.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

TOP = 10
NAME = 200          # characters of a templated kernel name kept


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    op_s: Dict[str, float]          # device seconds by op name
    idle_s: Dict[str, float]        # idle seconds by the host's open span

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the ops whose name holds any of `parts`."""
        return sum(s for n, s in self.op_s.items() if any(p in n for p in parts))

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _open_span(inner, starts, t: float) -> str:
    """The innermost span open at t: spans nest, so it is the latest-started
    one that contains t (the benchmark's spans are two deep, so a few
    steps back suffice)."""
    k = bisect.bisect_right(starts, t) - 1
    for s0, s1, name in inner[max(0, k - 8):k + 1][::-1]:
        if s1 >= t:
            return name
    return "host (no span)"


def _raw_events(prof):
    """(name, on device, start us, end us) of every event of the trace, read
    from the profiler's raw results: building its FunctionEvent tree takes
    minutes for a window of a few hundred thousand ops."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            a, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            a, d = float(e.start_us()), float(e.duration_us())
        out.append((e.name(), e.device_type() == DeviceType.CUDA, a, a + d))
    return out


def summarize(prof, window_label: str) -> TraceSummary:
    spans, dev = [], []
    for name, on_device, a, b in _raw_events(prof):
        if name.startswith("bench."):
            if not on_device:
                spans.append((name, a, b))
        elif on_device:
            dev.append((name, a, b))
    win = [(a, b) for n, a, b in spans if n == window_label]
    if not win:
        raise RuntimeError(f"the trace holds no {window_label!r} range")
    w0, w1 = win[0]
    op_s: Dict[str, float] = defaultdict(float)
    ivals = []
    for name, a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        op_s[name] += (b - a) / 1e6
        ivals.append((a, b))
    busy = _union(ivals)
    idle: Dict[str, float] = defaultdict(float)
    inner = sorted((a, b, n) for n, a, b in spans if n != window_label)
    starts = [a for a, _, _ in inner]
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            idle[_open_span(inner, starts, (prev + a) / 2)] += (a - prev) / 1e6
        prev = max(prev, b)
    return TraceSummary(window_s=(w1 - w0) / 1e6,
                        busy_s=sum(b - a for a, b in busy) / 1e6,
                        op_s=dict(op_s), idle_s=dict(idle))
