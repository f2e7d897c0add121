"""Each cell's control (the reference in the program's place with one
guarantee broken) comes out not correct, at a size a test run holds; and
the last line of a run has the contract's shape."""
import json
import subprocess
import sys

from benchmark import run as run_mod
from benchmark.control import control_checks
from benchmark.harness import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _results(out: str) -> list:
    """Lines of standard output that are a result (a JSON object)."""
    return [line for line in out.splitlines() if line.startswith("{")]


def test_controls_come_out_not_correct(bench):
    for seed in (1, 2 ** 31 + 3, 2 ** 32 + 5):
        checks = control_checks(bench, "tiny.gossip", seed)
        assert any(v > lim for _, v, lim in checks), (seed, checks)


def test_last_line_schema(bench):
    out = run_cell(bench, "tiny.gossip", 2 ** 31 + 1, 0.0, False, device="cpu")
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"att_verified_per_s", "slot_verify_ms.p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)
    traced = run_cell(bench, "tiny.gossip", 2 ** 31 + 1, 0.0, True, device="cpu")
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in traced["breakdown"].values())
    assert "firehose.host_ms_per_batch" in traced["metrics"]
    assert "att_verified_per_s" not in traced["metrics"]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        return
    rc = run_mod.main(["--workload", "v131k.gossip-pairing", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and not _results(capsys.readouterr().out)


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    from .conftest import BENCH, SPEC
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(SPEC, tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "v131k.gossip-pairing", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and not _results(p.stdout)
