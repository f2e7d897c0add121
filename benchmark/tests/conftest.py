"""Shared fixtures of the benchmark's own tests (run on the CPU:
`python -m pytest benchmark/tests`). A test that needs the card asks for
the `card` fixture, which skips without one."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
SPEC = BENCH.parent / "BENCHMARK.json"


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _copy(tmp: Path) -> Path:
    root = tmp / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def tiny_bench(tmp: Path):
    """The benchmark's files copied under tmp, plus a tiny cell found by
    name like any other: `tiny.gossip` (one slot of 2 committees of 4, two
    bad signatures, batches of 4)."""
    from benchmark.harness import Bench

    root = _copy(tmp)
    spec = json.loads(SPEC.read_text())

    def put(folder, name, base, **changes):
        data = json.loads((root / folder / f"{base}.json").read_text()) if base else {}
        data.update(changes)
        (root / folder / f"{name}.json").write_text(json.dumps(data))

    put("configs", "tiny-g", "mainnet-v131k", validators=64, committees_per_slot=2,
        committee_size=4, ring_capacity=8)
    put("traffic", "tiny-gossip", "gossip-pairing", target_groups=4, pump_every=4,
        bad_one_in=4, spot_mul=2, spot_pairing=1)
    put("workloads", "tiny.gossip", None, config="tiny-g", traffic="tiny-gossip",
        chips=1, pool_slots=1)
    spec["workloads"] += [
        {"name": "tiny.gossip", "config": "tiny-g", "traffic": "tiny-gossip", "chips": 1,
         "why": "a tiny gossip cell for the CPU tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.gossip")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(root)


@pytest.fixture
def bench(tmp_path):
    return tiny_bench(tmp_path)
