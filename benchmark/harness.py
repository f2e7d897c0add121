"""The benchmark's registry and one run of one cell.

Everything the harness runs is found by name, so that a later change adds
files and edits none:

    BENCHMARK.json (repo root)        cells, configurations and metrics
    benchmark/workloads/<cell>.json   the cell's config, mix, chips, parameters
    benchmark/configs/<config>.json   the deployment (preset and sizes)
    benchmark/traffic/<mix>.json      the mix's parameters; its "kind" names
    benchmark/drivers/<kind>.py       the code that drives the program for it
    benchmark/metrics/<metric>.py     one reader per metric: read(facts)

A driver has setup(ctx) -> state, window(ctx, state, seconds, spans) ->
facts, release(state) and check(ctx, state, facts) -> [(name, value,
limit)]. A reader returns a number or None (nothing to read: the metric is
left out of the line).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "consensus_specs_tpu")


class Bench:
    """The benchmark's files under `root` (benchmark/) and the spec at
    `spec` (BENCHMARK.json)."""

    def __init__(self, root: Path = HERE, spec: Optional[Path] = None):
        self.root = Path(root)
        self.spec_path = Path(spec) if spec else self.root.parent / "BENCHMARK.json"
        self.spec = json.loads(self.spec_path.read_text())

    def _json(self, folder: str, name: str) -> dict:
        path = self.root / folder / f"{name}.json"
        if not path.is_file():
            raise LookupError(f"no {folder[:-1]} named {name!r} ({path})")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        entry = next((w for w in self.spec["workloads"] if w["name"] == name), None)
        if entry is None:
            raise LookupError(f"BENCHMARK.json has no workload {name!r}")
        params = self._json("workloads", name)
        for key in ("config", "traffic", "chips"):
            if params.get(key, entry[key]) != entry[key]:
                raise ValueError(f"workloads/{name}.json gives {key} "
                                 f"{params[key]!r}, BENCHMARK.json {entry[key]!r}")
        return {**params, **entry}

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def driver(self, kind: str):
        if not (self.root / "drivers" / f"{kind}.py").is_file():
            raise LookupError(f"no driver for traffic kind {kind!r}")
        return self._module("drivers", kind)

    def reader(self, metric: str):
        return self._module("metrics", metric)

    def _module(self, folder: str, name: str):
        """benchmark/<folder>/<name>.py, imported as a submodule of the
        benchmark package (a metric's name may hold dots)."""
        path = self.root / folder / f"{name}.py"
        if not path.is_file():
            raise LookupError(f"no {folder} file for {name!r} ({path})")
        modname = f"{__package__}.{folder}._{name.replace('.', '_').replace('-', '_')}"
        if modname in sys.modules:
            return sys.modules[modname]
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of `cell` reports: its end-to-end ones, or with
        a trace its per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


class Spans:
    """Host-clock spans around the benchmark's calls into the program: count
    and seconds by name, each also a torch.profiler range when traced. Off,
    a span costs nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.total: Dict[str, List[float]] = {}

    @contextmanager
    def _timed(self, name: str):
        from torch.profiler import record_function
        t = time.perf_counter()
        with record_function(name):
            yield
        rec = self.total.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t

    def __call__(self, name: str):
        return self._timed(name) if self.on else nullcontext()


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """One run of cell `name`: set-up, the measured window, the check.
    Returns the result line's object; the numbers compared are under
    "checks", the last key."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start

    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    driver = bench.driver(mix["kind"])
    dev = torch.device(device)
    ctx = SimpleNamespace(name=name, cell=cell, config=cfg, traffic=mix,
                          seed=int(seed), device=dev, trace=trace)
    t_card = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    now = time.perf_counter()
    print(f"set-up: ready at {now - t_start:.3f} s (the card's context in "
          f"{now - t_card:.3f} s)", flush=True)
    state = driver.setup(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # set-up's objects (the pool, its staged arrays, the reference's data)
    # leave the collector's generations: a full collection in the window
    # then walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    spans = Spans(trace)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with spans("bench.window"):
            facts = driver.window(ctx, state, seconds, spans)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    memory_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    gc.unfreeze()
    driver.release(state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check(ctx, state, facts)
    print(f"check: {time.perf_counter() - t_check:.3f} s", flush=True)
    correct = all(value <= limit for _, value, limit in checks)
    facts.update(setup_s=setup_s, spans=spans.total, device_kind=_device_kind(dev))
    breakdown = None
    if prof is not None:
        from . import trace as trace_mod
        facts["trace"] = trace_mod.summarize(prof, "bench.window")
        breakdown = facts["trace"].breakdown()
    metrics = {}
    for m in bench.metrics(name, trace):
        value = bench.reader(m["name"]).read(SimpleNamespace(**facts, config=cfg,
                                                             cell=cell, traffic=mix))
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": facts["device_kind"], "count": 1,
                "memory_peak_bytes": int(memory_peak)}
    if trace and facts.get("trace") is not None:
        dev_info.update(busy_s=facts["trace"].busy_s, window_s=facts["trace"].window_s)
    out = {"correct": bool(correct), "attempted": int(facts["attempted"]),
           "failed": int(facts["failed"]), "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def _device_kind(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
