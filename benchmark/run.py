"""Run one cell of the port's benchmark on this machine's card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints progress on earlier lines, each
number compared for `correct` beside its limit as the last lines of
standard error, and as the last line of standard output one JSON object:
correct, attempted, failed, metrics, device (and breakdown with a trace),
then the numbers compared under "checks". Exits non-zero, with no result,
without a CUDA card (or fewer than the cell asks for), without the
program, or when JAX was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Compile caches at fixed paths inside the checkout (the port builds
    its CUDA sources into consensus_specs_tpu_torch/_build/ itself)."""
    cache = CHECKOUT / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    from .harness import Bench, forbidden_modules, run_cell

    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    t = time.perf_counter()
    import torch
    print(f"set-up: torch imported at {t - T0:.3f} s, in {time.perf_counter() - t:.3f} s",
          flush=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T0)
    bad = forbidden_modules()
    if bad:
        print(f"no result: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
