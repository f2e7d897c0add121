"""The point programs of the final exponentiation and the addition trees,
checked and timed on one CUDA card, and the point kernels compared with
another commit's in one process.

    python3 tools/point_program_probe.py [--parent DIR] [--variants]
                                         [--rounds N] [--skip-checks] [--json PATH]

1. (unless --skip-checks) Builds csrc/fq_points.cu and runs chip_smoke.py's
   check_point_programs: final_exp_program at 128 x 3 and 16 x 2, the Miller
   loop and the final exponentiation fused into one program against the
   path's two launches, and the trees of tree_program at the verify's
   16 x 1,024 G1 shape and at G2 trees of 4 and 64, each on both point
   kernels ("groups" and "threads"), torch.equal against the plain twin
   and lane 0 against the bignum oracle, with ms, bounds, bundles and block
   0's cycles a bundle.
2. With --parent DIR (a checkout of another commit, e.g. the parent's, made
   with `git archive` into a git-ignored directory): the slice's programs at
   the path's shapes on each tree's own kernel and programs, each tree in
   its own process, in the order parent, this, this, parent: final_exp at
   16 x 2 and 128 x 3 on groups and on threads, the G1 tree's last launch
   (1 level and jac_to_affine at 16 lanes), the cofactor ladder at 16 lanes
   and the Miller loop at 16 x 2 and 128 x 3. For each: a digest of the
   outputs (the two trees' must agree), the ms of N rounds (median and
   range) and block 0's cycles a bundle split by bundle kind (multiplies
   only, runs of them counted bundle by bundle; with tower products) and
   phase (fq_points.PHASES: the record's wait, phases A to E, the
   record's last barrier, the producer's fetch).
3. With --variants: substituted copies of this tree's csrc/fq_points.cu and
   csrc/fq_arith.cuh (VARIANTS), built side by side with this tree's (one
   nvcc each, all at once) and run on the same cases in one process (their
   launchers swapped in turn), bit-identical to this tree's kernel, timed
   in interleaved rounds. Only comparisons made in one call decide a
   design: cycle counts of one build differ between machines.

Prints the card's name and power limit first. Imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# --tree DIR (used by --parent): the package and chip_smoke.py of that checkout
_TREE = sys.argv[sys.argv.index("--tree") + 1] if "--tree" in sys.argv else None
ROOT = Path(_TREE).resolve() if _TREE else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from consensus_specs_tpu_torch.crypto import bls12_381 as gt  # noqa: E402
from consensus_specs_tpu_torch.ops import _nvcc  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_torch as BT  # noqa: E402
from consensus_specs_tpu_torch.ops import fq_points as FPt  # noqa: E402
from consensus_specs_tpu_torch.ops import fq_program as FP  # noqa: E402
from consensus_specs_tpu_torch.ops import scalar_mul as SM  # noqa: E402

L = 14
ENTRIES = ("g2_ladder", "miller_grouped")
# substituted copies of this tree's csrc/fq_points.cu and csrc/fq_arith.cuh:
# (file, old, new) triples
VARIANTS = {
    # phase B's leaves one a group in every bundle (the committed kernel
    # takes them two a group where one a group would need a second round)
    "single leaves": [("fq_points.cu",
                       "const bool pairs = kGroups && mul_items + n_leaf * nl > 2 * warps;",
                       "const bool pairs = false;")],
}
KINDS = ("multiplies only", "with tower products", "runs")


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


# ---------------------------------------------------------------------------
# Builds compared in one call
# ---------------------------------------------------------------------------

def _substituted(subs, name: str, dst: Path) -> None:
    """The variant's copies of the sources it changes, in dst."""
    dst.mkdir(parents=True, exist_ok=True)
    texts = {}
    for fname, old, new in subs:
        src = texts.get(fname) or (_nvcc.CSRC / fname).read_text()
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in {fname}")
        texts[fname] = src.replace(old, new)
    texts.setdefault("fq_points.cu", (_nvcc.CSRC / "fq_points.cu").read_text())
    for fname, text in texts.items():
        (dst / fname).write_text(text)


def _sass_total(lib: Path) -> str:
    """Each kernel's static SASS instructions (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?(g2_ladder|miller_grouped)_kernel", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[cur] += 1
    return ", ".join(f"{k} {v} SASS instructions" for k, v in counts.items())


def build_all(work: Path) -> dict:
    """{label: {entry: ctypes function}}: this tree's committed build and
    each VARIANTS copy, one nvcc each, all started together."""
    jobs = {}
    texts = {}
    for name, subs in VARIANTS.items():
        dst = work / re.sub(r"\W+", "_", name)
        _substituted(subs, name, dst)
        texts[name] = (dst / "fq_points.cu", _nvcc.CSRC)
    for name, (cu, inc) in texts.items():
        so = work / (re.sub(r"\W+", "_", name) + ".so")
        jobs[name] = (subprocess.Popen(
            [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-I", str(inc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    _nvcc.build_all(("fq_points",))
    builds = {"this": {e: FPt._launcher(e) for e in ENTRIES}}
    for name, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"build {name} failed:\n{out}")
        lib = ctypes.CDLL(str(so))
        fns = {}
        for e in ENTRIES:
            fn = getattr(lib, f"{e}_launch")
            fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[e] = fn
        builds[name] = fns
        print(f"built {name}: " + " / ".join(
            ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln)
            + " | " + _sass_total(so), flush=True)
    print("built this: " + " / ".join(
        ln.strip() for ln in _nvcc.log_path("fq_points").read_text().splitlines()
        if "registers" in ln or "spill" in ln)
        + " | " + _sass_total(_nvcc.library_path("fq_points")), flush=True)
    return builds


def compare_cases(dev):
    """[(label, program, run(stamps) -> outputs as a list)]: the slice's
    programs at the path's shapes, inputs from chip_smoke's seeds."""
    cases = []
    for label, (G, P) in (("16 x 2", (16, 2)), ("128 x 3", (CS.FIREHOSE_G, 3))):
        g1n, g2n = CS.cancelling_groups(G, P)
        f = FPt.miller_grouped_cuda(torch.from_numpy(g1n).to(dev), torch.from_numpy(g2n).to(dev))
        rows = f.reshape(G, 12, L).contiguous()
        prog = FPt.final_exp_program()
        for mode in CS.PROGRAM_MODES:
            cases.append((f"final_exp {label} {mode}", prog,
                          lambda st=None, m=mode, r=rows, G=G, p=prog:
                          list(CS.run_on(m, p, dev, G, (r,), st))))
    pts, _ = CS.tree_points("g1", 16, 1024, dev)
    aff = FPt.tree_program("g1", 1, True)
    last = pts.reshape(-1, 2 * 3, L)[:16].contiguous()
    cases.append(("tree g1 last launch 16 (groups)", aff,
                  lambda st=None: list(CS.run_on("groups", aff, dev, 16, (last,), st))))
    seed = 12345
    hp = [gt.hash_to_g2_candidate((seed + j).to_bytes(32, "big"), 1) for j in range(16)]
    arr = np.stack([BT.g2_to_limbs(p) for p in hp])
    xy = torch.from_numpy(np.concatenate([arr[:, 0], arr[:, 1]], axis=1)).to(dev).contiguous()
    rec = SM.recode_signed_windows(gt.G2_COFACTOR, BT._G2_COFACTOR_NBITS, BT.SCALAR_WINDOW)
    lad = FPt.ladder_program(BT._G2_COFACTOR_NBITS, BT.SCALAR_WINDOW)
    digits = FPt._device_digits(rec, dev)

    def ladder(st=None):
        flags = torch.empty(16, dtype=torch.uint8, device=dev)
        out = FPt._launch("g2_ladder", lad, dev, 16, (xy,), None, rec.correction, digits,
                          flags, st)
        return [out, flags]
    cases.append(("cofactor ladder 16", lad, ladder))
    g1d = np.stack([BT.g1_to_limbs(gt.ec_mul(gt.G1_GEN, seed + 2 * j + 1)) for j in range(8)])
    g2d = np.stack([BT.g2_to_limbs(gt.ec_mul(gt.G2_GEN, seed + 2 * j + 2)) for j in range(8)])
    for G, P in ((16, 2), (CS.FIREHOSE_G, 3)):
        sel = (np.arange(G)[:, None] * P + np.arange(P)[None, :]) % 8
        g1, g2 = (torch.from_numpy(d[sel]).to(dev) for d in (g1d, g2d))
        mp = FPt.miller_program(P)
        cases.append((f"miller {G} x {P}", mp,
                      lambda st=None, g1=g1, g2=g2, G=G, P=P, mp=mp: [FPt._launch(
                          "miller_grouped", mp, dev, G,
                          (g1.reshape(G, 2 * P, L), g2.reshape(G, 4 * P, L)), stamps=st)]))
    return cases


def _use(fns) -> None:
    FPt._fns.update(fns)


def _ms(run, reps: int) -> float:
    run()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def compare(builds: dict, dev, rounds: int) -> dict:
    """Every case on every build: bit-identity against "this", ms in
    interleaved rounds, block 0's split by bundle kind and phase."""
    report = {}
    own = dict(builds["this"])
    for label, prog, run in compare_cases(dev):
        _use(own)
        want = [t.long().cpu() for t in run()]
        reps = 3 if prog.n_bundles > 2000 else 10
        times = {name: [] for name in builds}
        for _ in range(rounds):
            for name, fns in builds.items():
                _use(fns)
                times[name].append(_ms(run, reps))
        row = {}
        for name, fns in builds.items():
            _use(fns)
            same = all(torch.equal(g.long().cpu(), w) for g, w in zip(run(), want))
            cycles, phases = FPt.bundle_clocks(run, prog, dev)
            split = CS.bundle_split(prog, cycles, phases)
            t = np.asarray(times[name])
            row[name] = {"same": same, "ms": float(np.median(t)), "ms_min": float(t.min()),
                         "ms_max": float(t.max()),
                         "cycles_a_bundle": float(cycles.sum()) / prog.n_bundles,
                         "split": {k: split[k] for k in KINDS if k in split}}
            print(f"{label} | {name}: {row[name]['ms']:.4f} ms ({t.min():.4f}-{t.max():.4f},"
                  f" {rounds} rounds), bit-identical to this tree's {same}, block 0"
                  f" {cycles.sum() / prog.n_bundles:.0f} cycles a bundle over"
                  f" {prog.n_bundles} | " + "; ".join(
                      f"{k} {split[k]['bundles']} x {split[k]['mean_cycles']:.0f} ("
                      + " / ".join(f"{v:.0f}" for v in split[k]["phases"].values()) + ")"
                      for k in KINDS if k in split) + f" [{' / '.join(FPt.PHASES)}]", flush=True)
            if not same and "timing only" not in name:
                raise SystemExit(f"{label}: {name}'s output differs from this tree's")
        report[label] = row
    _use(own)
    return report


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.long().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(rounds: int) -> dict:
    """This process's tree (--tree, or the repository) on its own kernel:
    every case's digest, ms of each round, cycles a bundle and split."""
    dev = torch.device("cuda")
    _nvcc.build_all(("fq_points",))
    out = {}
    for label, prog, run in compare_cases(dev):
        reps = 3 if prog.n_bundles > 2000 else 10
        digest = _digest(run())
        times = [_ms(run, reps) for _ in range(rounds)]
        cycles, phases = FPt.bundle_clocks(run, prog, dev)
        split = CS.bundle_split(prog, cycles, phases)
        rows = getattr(prog, "records", None)
        rows = rows[:, :4] if rows is not None else prog.bundles
        runs = getattr(prog, "records", np.zeros((len(rows), 5), np.int64))[:, 4] > 0
        sig = {}
        for r, c, ph, is_run in zip(rows.tolist(), cycles.tolist(), phases.tolist(), runs):
            if not is_run:
                e = sig.setdefault(str(tuple(r)), [0, 0, [0] * len(ph)])
                e[0] += 1
                e[1] += c
                e[2] = [a + b for a, b in zip(e[2], ph)]
        out_sig = {k: {"records": v[0], "cycles": v[1] / v[0],
                       "phases": [x / v[0] for x in v[2]]} for k, v in sig.items()}
        out[label] = {"digest": digest, "ms": times, "by_signature": out_sig,
                      "cycles_a_bundle": float(cycles.sum()) / prog.n_bundles,
                      "records": int(cycles.shape[0]), "bundles": int(prog.n_bundles),
                      "split": {k: split[k] for k in KINDS if k in split}}
    return out


def against_parent(parent: Path, rounds: int) -> dict:
    """The cases on the parent's tree and this one, each in its own
    process, in the order parent, this, this, parent."""
    runs = []
    for label, tree in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree),
                              "--worker", "--rounds", str(rounds)], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"worker on {tree}:\n{res.stdout}\n{res.stderr}")
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    report = {}
    for case in runs[0][1]:
        rows = {}
        for name in ("parent", "this"):
            mine = [r[case] for lab, r in runs if lab == name]
            t = np.asarray([x for r in mine for x in r["ms"]])
            rows[name] = {"ms": float(np.median(t)), "ms_min": float(t.min()),
                          "ms_max": float(t.max()), "digest": mine[0]["digest"],
                          "cycles_a_bundle": float(np.mean([r["cycles_a_bundle"] for r in mine])),
                          "records": mine[0]["records"], "bundles": mine[0]["bundles"],
                          "split": mine[-1]["split"]}
        same = len({r[case]["digest"] for _, r in runs}) == 1
        if not same:
            raise SystemExit(f"{case}: the parent's outputs differ from this tree's")
        report[case] = rows
        for name, row in rows.items():
            sp = row["split"]
            print(f"{case} | {name}: {row['ms']:.4f} ms ({row['ms_min']:.4f}-{row['ms_max']:.4f},"
                  f" {2 * rounds} rounds in 2 processes), outputs equal to the other tree's"
                  f" ({row['digest']}), {row['records']} records for {row['bundles']} bundles,"
                  f" block 0 {row['cycles_a_bundle']:.0f} cycles a bundle | " + "; ".join(
                      f"{k} {sp[k]['bundles']} x {sp[k]['mean_cycles']:.0f} ("
                      + " / ".join(f"{v:.0f}" for v in sp[k]["phases"].values()) + ")"
                      for k in KINDS if k in sp) + f" [{' / '.join(FPt.PHASES)}]", flush=True)
        print(f"{case}: this / parent {rows['this']['ms'] / rows['parent']['ms']:.3f}", flush=True)
        # the records that are one bundle, by (A, multiplies, products, E) ops
        # both trees, the heaviest first
        ps, ts = (dict(r[case]["by_signature"]) for r in (runs[0][1], runs[1][1]))
        for key in sorted(ps, key=lambda k: -ps[k]["records"] * ps[k]["cycles"])[:10]:
            if key in ts:
                print(f"  {case} bundles {key} (A, M, P, E ops): parent {ps[key]['records']} x"
                      f" {ps[key]['cycles']:.0f} (" + " / ".join(f"{x:.0f}" for x in ps[key]["phases"])
                      + f"), this {ts[key]['records']} x {ts[key]['cycles']:.0f} ("
                      + " / ".join(f"{x:.0f}" for x in ts[key]["phases"]) + ")", flush=True)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of another commit: compare its point kernels")
    ap.add_argument("--variants", action="store_true", help="compare VARIANTS in one process")
    ap.add_argument("--rounds", type=int, default=5, help="timing rounds a case")
    ap.add_argument("--skip-checks", action="store_true",
                    help="only the comparisons (sections 2 and 3 of the docstring)")
    ap.add_argument("--json", help="also write the comparisons to this file")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("point_program_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.rounds)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    report = {"card": smi}
    if args.parent:
        report["parent"] = against_parent(Path(args.parent).resolve(), args.rounds)
    if args.variants and VARIANTS:
        work = Path(tempfile.mkdtemp(prefix="fq_points_cmp_"))
        try:
            t0 = time.perf_counter()
            builds = build_all(work)
            print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
            report["variants"] = compare(builds, dev, args.rounds)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if not args.skip_checks:
        t0 = time.perf_counter()
        _nvcc.build_all(("fq_mont", "fq_points"))
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        pp = CS.check_point_programs(np.random.default_rng(CS.SEED), dev)
        CS.report_point_programs(pp)
        fused_against_two_launches(dev)
        print(f"checks and times {time.perf_counter() - t0:.1f} s", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
