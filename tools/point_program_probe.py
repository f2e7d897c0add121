"""The point programs of the final exponentiation and the addition trees,
checked and timed on one CUDA card.

    python3 tools/point_program_probe.py

Builds csrc/fq_points.cu and runs chip_smoke.py's check_point_programs:
final_exp_program at 128 x 3 and 16 x 2, the Miller loop and the final
exponentiation fused into one program against the path's two launches,
and the trees of tree_program at the verify's 16 x 1,024 G1 shape and at
G2 trees of 4 and 64, each on both point kernels ("groups" and
"threads"), torch.equal against the plain twin and lane 0 against the
bignum oracle, with ms, bounds, bundles and block 0's cycles a bundle. The
short call that checks the programs before the whole of chip_smoke.py
runs them; the numbers behind fq_points.FINAL_EXP_MODE and the two
launches of a grouped pairing.

Prints the card's name and power limit first. Imports no JAX.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from consensus_specs_tpu_torch.ops import _nvcc  # noqa: E402
from consensus_specs_tpu_torch.ops import fq_points as FPt  # noqa: E402
from consensus_specs_tpu_torch.ops import fq_program as FP  # noqa: E402

L = 14


def fused_pairing_program(P: int):
    """The Miller loop's program with the final exponentiation's appended:
    a grouped pairing in one launch."""
    rec, f = FPt.miller_recording(P)
    res, ok = FPt.final_exp_recording(rec, f)
    return rec.compile(res, ok.v)


def fused_against_two_launches(dev) -> None:
    """At FINAL_EXP_CASES: the fused program on the Miller loop's kernel
    (threads) == its plain twin == the two programs' plain twins, and its
    ms beside the path's two launches (miller_grouped_cuda, then
    final_exp_cuda) and its bound and cycles a bundle."""
    for label, (G, P) in CS.FINAL_EXP_CASES.items():
        g1n, g2n = CS.cancelling_groups(G, P)
        g1, g2 = torch.from_numpy(g1n).to(dev), torch.from_numpy(g2n).to(dev)
        prog = fused_pairing_program(P)
        ins = (g1.reshape(G, 2 * P, L), g2.reshape(G, 4 * P, L))
        want, plain_ms = CS.fenced_ms(lambda: FP.run_program_plain(prog, *ins))
        two = FPt.final_exp_plain(FPt.miller_grouped_plain(g1, g2))
        CS._same(want[0], two[0].reshape(G, 12, L), f"fused {label}: plain != two programs")
        got = CS.run_on("threads", prog, dev, G, ins)
        CS._same(got[0], want[0], f"fused {label}")
        CS._same(got[1].long(), want[1].long(), f"fused {label} verdicts")
        ms = CS.time_cuda(lambda: CS.run_on("threads", prog, dev, G, ins), 10)
        two_ms = CS.time_cuda(lambda: FPt.final_exp_cuda(FPt.miller_grouped_cuda(g1, g2)), 10)
        c = CS.clocked(prog, lambda st: CS.run_on("threads", prog, dev, G, ins, st), dev, ms)
        bound, by = FPt.bound_ms(prog, G, CS.INT32_OPS_PER_S, CS.HBM_BYTES_PER_S)
        print(f"fused pairing program {label} bit-identical to its plain twin and to the two"
              f" programs' | {ms:.4f} ms on threads ({c['bundles']} bundles,"
              f" {c['cycles_a_bundle']:.0f} cycles a bundle) against the path's two launches"
              f" {two_ms:.4f} ms | plain twin {plain_ms:.1f} ms, bound {bound:.6f} ms by {by}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("point_program_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _nvcc.build_all(("fq_mont", "fq_points"))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pp = CS.check_point_programs(np.random.default_rng(CS.SEED), torch.device("cuda"))
    CS.report_point_programs(pp)
    fused_against_two_launches(torch.device("cuda"))
    print(f"checks and times {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
