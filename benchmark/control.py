"""Run a cell's control: the reference put in the program's place with one
guarantee of the configuration broken, at the cell's own size, on the
given seeds. Each seed's numbers must fail the cell's limits:

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed: the numbers compared, each with its limit,
and whether the control came out not correct (as it must).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

from .harness import Bench


def control_checks(bench: Bench, name: str, seed: int) -> list:
    cell = bench.cell(name)
    mix = bench.traffic(cell["traffic"])
    ctx = SimpleNamespace(name=name, cell=cell, config=bench.config(cell["config"]),
                          traffic=mix, seed=int(seed))
    return bench.driver(mix["kind"]).control(ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = Bench()
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        checks = control_checks(bench, args.workload, seed)
        caught = any(v > lim for _, v, lim in checks)
        failed_all &= caught
        print(json.dumps({"workload": args.workload, "seed": seed, "not_correct": caught,
                          "seconds": round(time.perf_counter() - t, 3),
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
