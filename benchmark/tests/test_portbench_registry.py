"""BENCHMARK.json against the contract's shape, and the harness finding a
new configuration, mix, metric and cell by file name alone."""
import json
import re

import pytest

from benchmark.harness import Bench

from .conftest import BENCH, SPEC, tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    return json.loads(SPEC.read_text())


def _line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_top_level_and_paths(spec):
    assert set(spec) == KEYS
    assert spec["paths"] == ["benchmark"] and spec["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (spec["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert len(SPEC.read_bytes()) <= 64 * 1024


def test_names_units_and_lines(spec):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[group]:
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        _line(w["why"])
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        _line(c["source"]), _line(c["why"])
        assert c["file"].startswith("benchmark/configs/") and c["reduced"] == []


def test_every_piece_is_found_by_name(spec):
    bench = Bench()
    configs = {c["name"] for c in spec["configs"]}
    used = set()
    for w in spec["workloads"]:
        cell = bench.cell(w["name"])
        used.add(cell["config"])
        assert cell["config"] in configs and bench.config(cell["config"])
        bench.driver(bench.traffic(cell["traffic"])["kind"])
    assert used == configs
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"]).read)
    assert setup_in_every_cell(bench, spec)


def setup_in_every_cell(bench, spec):
    for w in spec["workloads"]:
        e2e = {m["name"] for m in bench.metrics(w["name"], False)}
        layer = bench.metrics(w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    return True


def test_metrics_of_one_layer_name_it_alike(spec):
    by_layer = {}
    for m in spec["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_new_config_mix_metric_and_cell_are_found_by_name(tmp_path):
    """A later change adds files and one entry a list, and edits none."""
    tiny_bench(tmp_path)
    root = tmp_path / "benchmark"
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (root / "configs" / "new-deployment.json").write_text(
        (root / "configs" / "tiny-g.json").read_text())
    mix = json.loads((root / "traffic" / "tiny-gossip.json").read_text())
    (root / "traffic" / "new-mix.json").write_text(json.dumps(dict(mix, pump_every=2)))
    (root / "workloads" / "new.cell.json").write_text(json.dumps(
        {"config": "new-deployment", "traffic": "new-mix", "chips": 1, "pool_slots": 1}))
    (root / "metrics" / "new.metric.py").write_text("def read(f):\n    return 2.0 * f.steps\n")
    spec["configs"].append({"name": "new-deployment", "source": "https://example.org",
                            "file": "benchmark/configs/new-deployment.json", "reduced": [],
                            "why": "found by name"})
    spec["workloads"].append({"name": "new.cell", "config": "new-deployment",
                              "traffic": "new-mix", "chips": 1, "why": "found by name"})
    spec["per_layer"].append({"name": "new.metric", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "att_verified_per_s",
                              "workloads": ["new.cell", "tiny.gossip"]})
    for m in spec["end_to_end"]:
        if m["name"] == "att_verified_per_s":
            m["workloads"].append("new.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root)
    cell = bench.cell("new.cell")
    assert cell["config"] == "new-deployment" and bench.config("new-deployment")["validators"] == 64
    assert bench.traffic("new-mix")["pump_every"] == 2
    assert bench.driver(bench.traffic("new-mix")["kind"]).setup
    assert [m["name"] for m in bench.metrics("new.cell", False)] == ["att_verified_per_s",
                                                                    "setup_s"]
    names = [m["name"] for m in bench.metrics("new.cell", True)]
    assert names == ["new.metric"]
    assert "new.metric" in [m["name"] for m in bench.metrics("tiny.gossip", True)]
    assert "new.metric" not in [m["name"] for m in bench.metrics("v131k.gossip-pairing", True)]
    from types import SimpleNamespace
    assert bench.reader("new.metric").read(SimpleNamespace(steps=3)) == 6.0


def test_unknown_names_are_refused(bench):
    for call, arg in ((bench.cell, "nope"), (bench.config, "nope"), (bench.traffic, "nope"),
                      (bench.driver, "nope"), (bench.reader, "nope")):
        with pytest.raises(LookupError):
            call(arg)
