"""The port's telemetry and guarded dispatch (consensus_specs_tpu_torch.
telemetry, .resilience) against the JAX package's on the CPU.

The same sequence of counter, gauge, histogram and span operations, on a
fresh registry and a fake clock in both packages, gives the same
Prometheus text and the same Chrome-trace events. The watchdogs count a
retrace (a key met with a new argument signature) and a re-layout (a
chained tensor whose device, dtype, shape or strides changed); the
guarded dispatch retries, raises, salvages and counts exactly as the
reference's does on the same fake-clock scenarios."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu import telemetry as JT
from consensus_specs_tpu.resilience import dispatch as JD
from consensus_specs_tpu.resilience import errors as JE
from consensus_specs_tpu.telemetry import core as JCORE
from consensus_specs_tpu_torch import telemetry as PT
from consensus_specs_tpu_torch.resilience import dispatch as PD
from consensus_specs_tpu_torch.resilience import errors as PE
from consensus_specs_tpu_torch.telemetry import core as PCORE
from consensus_specs_tpu_torch.telemetry import watchdog as PW


@pytest.fixture
def fresh(monkeypatch):
    """Both packages on empty registries, a shared fake clock (each read
    advances 1.5 ms; the fixture's value is its time, to set back to 0),
    time zero at 0 and telemetry on; restored after."""
    t = [0.0]

    def clock():
        t[0] += 0.0015
        return t[0]

    for core in (JCORE, PCORE):
        for name in ("_counters", "_gauges", "_histograms", "_span_agg"):
            monkeypatch.setattr(core, name, {})
        monkeypatch.setattr(core, "_ring", type(core._ring)(maxlen=4096))
        monkeypatch.setattr(core, "_EPOCH", 0.0)
        monkeypatch.setattr(core.time, "perf_counter", clock)
    JT.set_enabled(True)
    PT.set_enabled(True)
    yield t
    JT.set_enabled(None)
    JT.set_fencing(None)
    PT.set_enabled(None)
    PT.set_fencing(None)


def _drive(T):
    """One sequence of registry and span operations."""
    T.counter("firehose.launches", always=True).inc()
    T.counter("firehose.launches", always=True).inc(4)
    T.counter("bls.grouped.groups").inc(128)
    T.gauge("firehose.queue_depth", always=True).set(17)
    T.gauge("resilience.rung").set(0.5)
    h = T.histogram("firehose.batch_occupancy", always=True)
    for v in (128, 3, 0, -2, 0.25, 1024, 1000, 0.7):
        h.observe(v)
    with T.span("firehose.flush", batches=2, deadline_ms=500):
        with T.span("firehose.stage", pending=3):
            pass
        with T.span("resident.slot_root"):
            pass
    with T.span("resident.device") as sp:
        sp.note(groups=128)

    @T.instrument("deco.fn")
    def double(a):
        return 2 * a

    assert double(21) == 42
    T.set_enabled(False)
    T.counter("bls.grouped.groups").inc(5)           # off: not counted
    T.counter("firehose.launches", always=True).inc()  # always: counted
    with T.span("never.recorded"):
        pass
    assert double(1) == 2
    T.set_enabled(True)


def test_prometheus_text_and_chrome_trace_match_reference(fresh):
    _drive(JT)
    fresh[0] = 0.0
    _drive(PT)
    assert PT.prometheus_text() == JT.prometheus_text()
    assert PT.snapshot() == JT.snapshot()
    want, got = JT.chrome_trace(), PT.chrome_trace()
    assert got == want
    assert [e["name"] for e in got["traceEvents"]] == [
        "firehose.flush", "firehose.stage", "resident.slot_root",
        "resident.device", "deco.fn"]
    assert got["traceEvents"][1]["args"] == {"pending": 3,
                                             "parent": "firehose.flush"}


def test_switches_ring_size_and_cpu_fence(fresh):
    assert PT.span("x") is not PT.span("y")
    PT.set_enabled(False)
    assert PT.span("x") is PT.span("y")            # the shared no-op span
    assert PT.span("x").duration == 0.0
    PT.set_enabled(None)                           # back to the default: on
    assert PT.enabled()
    PT.set_ring_size(3)
    try:
        for k in range(5):
            with PT.span(f"s{k}"):
                pass
        assert [r["name"] for r in PT.ring()] == ["s2", "s3", "s4"]
        assert PT.snapshot()["spans"]["s0"]["count"] == 1   # aggregates stay
    finally:
        PT.set_ring_size()
    # CPU tensors and host values are ready: a fence records no event
    with PT.span("fenced") as sp:
        sp.fence(torch.ones(3), {"a": (np.zeros(2), 5)})
        assert sp._events == []
    PT.set_fencing(False)
    with PT.span("unfenced") as sp:
        sp.fence(torch.ones(3))
    assert not PT.fencing()


def test_retrace_watchdog_counts_new_signatures(fresh):
    PW.reset()
    events = PT.counter("watchdog.retrace_events")

    def fn(*args):
        return len(args)

    a = torch.zeros(4, 14, dtype=torch.int64)
    assert PW.dispatch("k", fn, a, 3) == 2             # warm-up
    PW.dispatch("k", fn, torch.ones(4, 14, dtype=torch.int64), 9)
    assert events.value == 0                           # same signature
    with pytest.warns(PT.TelemetryWarning):
        PW.dispatch("k", fn, torch.zeros(8, 14, dtype=torch.int64), 3)
    with pytest.warns(PT.TelemetryWarning):
        PW.dispatch("k", fn, a.to(torch.int32), 3)
    assert events.value == 2
    assert PW.stats("k") == {"calls": 4, "signatures": 3, "events": 2}
    PW.dispatch("other", fn, np.zeros(3))              # another key: warm-up
    assert events.value == 2
    PT.set_enabled(False)
    assert PW.dispatch("k", fn, torch.zeros(1)) == 1   # off: a plain call
    assert PW.stats("k")["calls"] == 4
    PT.set_enabled(True)
    PW.forget("k")
    PW.dispatch("k", fn, torch.zeros(1))               # warm-up again
    assert events.value == 2


def test_relayout_watchdog_counts_layout_changes(fresh):
    PW.reset()
    events = PT.counter("watchdog.relayout_events")
    ring = torch.zeros(8, dtype=torch.bool)
    PW.layout_check("ring", ring)
    ring[2:4].copy_(torch.ones(2, dtype=torch.bool))   # in place: same layout
    PW.layout_check("ring", ring)
    assert events.value == 0
    m = torch.zeros(4, 6)
    PW.layout_check("cols", (m, np.zeros(3)))
    with pytest.warns(PT.TelemetryWarning):
        PW.layout_check("cols", (m.t().contiguous().t(), np.zeros(3)))  # strides
    with pytest.warns(PT.TelemetryWarning):
        PW.layout_check("ring", ring.to(torch.int8))   # dtype
    assert events.value == 2
    assert PW.install_compile_listener() is False


# ---------------------------------------------------------------------------
# guarded dispatch: the reference's fake-clock scenarios, counted alike
# ---------------------------------------------------------------------------

_RESILIENCE = ("resilience.retries", "resilience.transient_errors",
               "resilience.fatal_errors", "resilience.deadline_misses",
               "resilience.deadline_salvaged", "resilience.corrupt_outputs")


def _counts(T):
    return {n: T.counter(n, always=True).value for n in _RESILIENCE}


def _fake_clock(step_s):
    t = [0.0]

    def clock():
        t[0] += step_s
        return t[0]
    return clock


def _flaky(fails, message):
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) <= fails:
            raise RuntimeError(message)
        return x + 1
    return fn, calls


def _both(scenario):
    """Run scenario(D, E) in both packages -> (results, counters) each."""
    out = []
    for D, E, T in ((JD, JE, JT), (PD, PE, PT)):
        out.append((scenario(D, E), _counts(T)))
    return out


def _outcome(call, E):
    try:
        return ("ok", call())
    except E.DispatchError as exc:
        return (type(exc).__name__, exc.attempts)


@pytest.mark.parametrize("fails,retries", [(1, 2), (3, 2), (2, 0)])
def test_transient_retry_and_exhaustion_match_reference(fresh, fails, retries):
    sleeps = []

    def scenario(D, E):
        fn, calls = _flaky(fails, "RESOURCE_EXHAUSTED: out of memory")
        res = _outcome(lambda: D.guarded_dispatch(
            ("k", fails), fn, 1, retries=retries, sleep=sleeps.append), E)
        return res, len(calls)

    (want, wc), (got, gc_) = _both(scenario)
    assert got == want and gc_ == wc
    assert sleeps[:len(sleeps) // 2] == sleeps[len(sleeps) // 2:]


def test_deadline_miss_retry_and_salvage_match_reference(fresh):
    def scenario(D, E):
        calls = []

        def fn(x):
            calls.append(x)
            return x * 2
        late = _outcome(lambda: D.guarded_dispatch(
            "late", fn, 3, deadline_ms=5.0, clock=_fake_clock(0.1),
            sleep=lambda s: None), E)
        salvaged = _outcome(lambda: D.guarded_dispatch(
            "salvage", fn, 4, deadline_ms=5.0, retries=0,
            clock=_fake_clock(0.1), sleep=lambda s: None), E)
        in_time = _outcome(lambda: D.guarded_dispatch(
            "fast", fn, 5, deadline_ms=5.0, clock=_fake_clock(0.001),
            sleep=lambda s: None), E)
        corrupt = _outcome(lambda: D.guarded_dispatch(
            "corrupt", fn, 6, check=lambda out: False, retries=1,
            sleep=lambda s: None), E)
        return late, salvaged, in_time, corrupt, len(calls)

    (want, wc), (got, gc_) = _both(scenario)
    assert got == want and gc_ == wc
    assert got[0] == ("DeadlineExceeded", 3)
    assert got[1] == ("ok", 8) and gc_["resilience.deadline_salvaged"] == 1


def test_classify_oom_transient_sticky_cuda_fatal(fresh, monkeypatch):
    assert PD.classify(torch.cuda.OutOfMemoryError("CUDA out of memory")) \
        == "transient"
    for msg in ("CUDA error: an illegal memory access was encountered",
                "fq_bilinear kernel launch failed: cudaError 719",
                "CUDA error: unspecified launch failure (INTERNAL)"):
        assert PD.classify(RuntimeError(msg)) == "fatal"
        fn, calls = _flaky(5, msg)
        with pytest.raises(PE.FatalDispatchError):
            PD.guarded_dispatch("sticky", fn, 1, sleep=lambda s: None)
        assert len(calls) == 1                        # never retried
    assert PD.classify(RuntimeError("UNAVAILABLE: relay")) == "transient"
    assert PD.classify(ValueError("shape")) == "fatal"
    # the unarmed guard never synchronizes; the armed one once per try
    syncs = []
    monkeypatch.setattr(PD, "_synchronize_output", syncs.append)
    PD.guarded_dispatch("unarmed", lambda: torch.ones(2))
    assert syncs == []
    PD.guarded_dispatch("armed", lambda: torch.ones(2), deadline_ms=1e6)
    assert len(syncs) == 1
    assert issubclass(PE.CheckpointCorrupt, PE.ResilienceError)
