"""Measurements behind the design of csrc/fq_mont.cu's chain kernel, on one
CUDA card.

    python3 tools/chain_kernel_probe.py [--json PATH] [--rounds N] [--parent DIR]

1. Variants of the chain kernel. The committed source is copied into a
   temporary directory with one substitution per variant, built with the
   package's nvcc flags, and launched through ops/fq_cuda.py's wrappers
   (their launcher swapped for the variant's):
   - "threads": one thread a product, a leaf or a REDC, at every lane count;
   - "groups": each product on a 16-thread group at every lane count (Fq12
     chains too, a team of four warps a lane);
   - "prologue": the committed shape with the program loop cut out, so one
     launch stages the operands and stores the accumulator and computes
     nothing (its output is not checked): what a launch costs besides its
     steps;
   - "3 blocks an SM": the committed kernel with __launch_bounds__ asking
     for three blocks of 256 threads an SM (at most 85 registers a
     thread), the committed shape.
   Every chain of the main path runs at the lane counts the path gives it
   (the fixed-exponent powers of ops/fq.py and ops/fq_tower.py: the Fq
   inversion, the Fq and Fq2 square roots, pow_abs; and single tower
   products, one-step chains). For each case: both variants bit-identical
   to the plain chain (ops/fq.py fq_bilinear_chain_plain); the ms of one
   launch (CUDA events over repeated launches), taken in N interleaved
   rounds (each variant in turn, then again), as median and range;
   each variant's shape (threads, lanes a block, blocks) and block 0's
   cycles a step by kind and phase (fq_cuda.chain_phase_clocks: A pre-sums,
   B schoolbooks, C gamma sums, D REDCs); and the variant the committed
   launcher picks ("auto").
2. With --parent DIR (a checkout of another commit, e.g. the parent's, made
   with `git archive`): the single tower products at 65,536 lanes, one
   fq_bilinear_cuda launch each, timed in separate processes in the order
   parent, this tree, this tree, parent, with a digest of each output so
   that the two trees' limbs can be compared, and each tree's registers a
   thread of the chain kernel (ptxas).

Prints the card's name and power limit first. Imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

# --tree DIR (used by --parent): import the package from that checkout
_TREE = sys.argv[sys.argv.index("--tree") + 1] if "--tree" in sys.argv else None
ROOT = Path(_TREE).resolve() if _TREE else Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from consensus_specs_tpu_torch.ops import _nvcc  # noqa: E402
from consensus_specs_tpu_torch.ops import fq as F  # noqa: E402
from consensus_specs_tpu_torch.ops import fq_cuda  # noqa: E402
from consensus_specs_tpu_torch.ops import fq_tower as T  # noqa: E402

SEED = 20261018
_RULE = "  groups = ch.Ca <= 2 && n <= static_cast<long long>(kGroupLanesPerSm) * sms;"
_TEAM = "      ch.team_warps = 1;\n      ch.team_lanes = 2 / ch.Ca;"
_LOOP = "  for (int s0 = 0; s0 < ch.n_steps; s0 += ch.chunk) {"
_BOUNDS = "__global__ void __launch_bounds__(kChainThreads)\nfq_chain_kernel("
VARIANTS = {
    "threads": [(_RULE, "  groups = false;")],
    "groups": [(_RULE, "  groups = true;"),
               (_TEAM, "      ch.team_warps = ch.Ca <= 2 ? 1 : 4;\n"
                       "      ch.team_lanes = ch.Ca <= 2 ? 2 / ch.Ca : 1;")],
    "prologue": [(_LOOP, "  for (int s0 = 0; s0 < 0; s0 += ch.chunk) {")],
    "3 blocks an SM": [(_BOUNDS, "__global__ void __launch_bounds__(kChainThreads, 3)\n"
                                 "fq_chain_kernel(")],
}
CHECKED = ("threads", "groups", "3 blocks an SM")
SINGLE = ("fq12_mul", "fq12_sqr", "fq12_cyclo_sqr", "fq2_mul")
SINGLE_LANES = 65536


def edge(rng, shape):
    """Multiply inputs at the budget's edges: |body limb| < 2^32, |top
    limb| < 2^16 (lane 0 all at the maximum, lane 1 at the minimum)."""
    a = rng.integers(-(1 << 32) + 1, 1 << 32, shape + (14,))
    a[..., -1] = rng.integers(-(1 << 16) + 1, 1 << 16, shape)
    if shape[0] >= 2:
        a[0, ..., :-1], a[0, ..., -1] = (1 << 32) - 1, (1 << 16) - 1
        a[1, ..., :-1], a[1, ..., -1] = -(1 << 32) + 1, -(1 << 16) + 1
    return a


def lazy(rng, shape):
    """Lazy limbs as the path's products leave them: [-16, 2^29], top
    limb in [0, 13]."""
    a = rng.integers(-16, (1 << 29) + 1, shape + (14,))
    a[..., -1] = rng.integers(0, 14, shape)
    return a


def case_args(rng, name, n, dev):
    """(acc, program, tables, base, operand) of a case at n lanes."""
    from consensus_specs_tpu_torch.ops import bls_torch as BT
    from consensus_specs_tpu_torch.ops import decompress as D
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    if name in ("fq inv", "fq sqrt"):
        bits = F._INV_EXP_BITS if name == "fq inv" else F._SQRT_EXP_BITS
        return t(edge(rng, (n, 1))), F.fq_pow_program(bits), None, None, None
    if name == "fq2 sqrt":
        return (T.fq2_ones((n,), dev), T.fq2_pow_program(D._SQRT2_EXP_BITS), T.TABLES,
                t(lazy(rng, (n, 2))), None)
    if name == "pow_abs |z|":
        acc = t(edge(rng, (n, 12)))
        return acc, T.pow_abs_program(BT._Z_BITS), T.TABLES, acc, None
    tb = {"fq2_mul": T._FQ2_T, "fq12_mul": T._MUL_T}[name.split()[0]]
    prog = F.chain_program([(tb, F.SRC_BASE)])
    return t(edge(rng, (n, tb.Ca))), prog, T.TABLES, t(edge(rng, (n, tb.Cb))), None


# (case, lanes): the lane counts the main path gives each chain (a block
# verify's 16 groups and signatures, a firehose batch's 128 groups, stage
# 1's 16 x 1,024 public keys), single products at the path's lane counts,
# and at chip_smoke.py's throughput check (65,536 lanes)
CASES = [("fq inv", 1), ("fq inv", 16), ("fq inv", 128), ("fq sqrt", 128),
         ("fq sqrt", 16384), ("fq2 sqrt", 16), ("fq2 sqrt", 128),
         ("pow_abs |z|", 16), ("pow_abs |z|", 128), ("fq2_mul one step", 16),
         ("fq2_mul one step", 128), ("fq2_mul one step", 384),
         ("fq12_mul one step", 16), ("fq12_mul one step", 128),
         ("fq2_mul one step", 65536), ("fq12_mul one step", 65536)]


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phases_by_kind(prog, cycles) -> dict:
    """{kind: {"steps", "cycles_per_step": [A, B, C, D]}} of one launch."""
    acc = collections.defaultdict(lambda: [0, np.zeros(4)])
    for code, cyc in zip(prog, cycles):
        a = acc[T.step_name(code)]
        a[0] += 1
        a[1] += cyc
    return {k: {"steps": n, "cycles_per_step": (c / n).round(1).tolist()}
            for k, (n, c) in acc.items()}


def build_variants(work: Path) -> dict:
    """{variant: its fq_chain_launch}, the builds run side by side."""
    src = (_nvcc.CSRC / "fq_mont.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not once in the source")
            text = text.replace(old, new)
        stem = "fq_mont_" + name.replace(" ", "_")
        cu, so = work / f"{stem}.cu", work / f"{stem}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-I", str(_nvcc.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, job) in jobs.items():
        log = job.communicate()[0]
        if job.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        print(f"ptxas {name}: " + " / ".join(registers(log)), flush=True)
        fn = ctypes.CDLL(str(so)).fq_chain_launch
        fn.argtypes = fq_cuda._ARGTYPES["fq_chain"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def registers(log: str) -> list:
    """ptxas's registers and spills of each chain kernel in a build log."""
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "fq_chain_kernel" in ln:
            after = lines[i + 1:i + 5]
            found = [x.split(":", 1)[-1].strip() for x in after if "spill" in x or "registers" in x]
            out.append(f"{'groups' if 'ILb1' in ln else 'threads'}: " + ", ".join(found))
    return out


def use(fn) -> None:
    fq_cuda._fns["fq_chain"] = fn


def spread(xs) -> dict:
    xs = sorted(xs)
    return {"median": float(np.median(xs)), "min": xs[0], "max": xs[-1]}


def run(dev, fns: dict, committed, rounds: int) -> list:
    rng = np.random.default_rng(SEED)
    rows = []
    for name, n in CASES:
        acc, prog, tables, base, op = case_args(rng, name, n, dev)
        want = F.fq_bilinear_chain_plain(acc, prog, tables, base, op)
        use(committed)
        row = {"case": name, "lanes": n, "steps": len(prog),
               "auto": fq_cuda.chain_launch_shape(acc, prog, tables, base, op)}
        reps = max(3, min(50, int(20000 / len(prog) / max(1, n // 128))))
        ms = {v: [] for v in fns}
        for v, fn in fns.items():
            use(fn)
            row[v] = {"shape": fq_cuda.chain_launch_shape(acc, prog, tables, base, op)}
            if v in CHECKED:
                got = fq_cuda._chain(acc, prog, tables, base, op)[0]
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} at {n} lanes, {v}: kernel != plain")
                cycles = fq_cuda.chain_phase_clocks(acc, prog, tables, base, op)
                row[v].update(cycles_per_launch=int(cycles.sum()),
                              phases=phases_by_kind(prog, cycles))
        for _ in range(rounds):
            for v, fn in fns.items():
                use(fn)
                ms[v].append(time_ms(lambda: fq_cuda._chain(acc, prog, tables, base, op), reps))
        for v in fns:
            row[v]["ms"] = spread(ms[v])
        th, gr = row["threads"]["ms"], row["groups"]["ms"]
        row["winner"] = "threads" if th["median"] <= gr["median"] else "groups"
        row["decided"] = th["max"] < gr["min"] or gr["max"] < th["min"]
        rows.append(row)
        auto = "groups" if row["auto"]["groups"] else "threads"
        print(f"{name} at {n} lanes ({len(prog)} steps): " + "; ".join(
            f"{v} {row[v]['ms']['median']:.4f} ms ({row[v]['ms']['min']:.4f}-"
            f"{row[v]['ms']['max']:.4f}; {row[v]['shape']['threads']} threads x"
            f" {row[v]['shape']['blocks']} blocks, {row[v]['shape']['lanes_per_block']}"
            " lanes a block) cycles a step A/B/C/D " + ", ".join(
                f"{k} x {p['steps']} " + "/".join(f"{x:.0f}" for x in p["cycles_per_step"])
                for k, p in row[v]["phases"].items())
            for v in CHECKED)
            + f"; prologue only {row['prologue']['ms']['median']:.4f} ms"
              f" ({row['prologue']['ms']['min']:.4f}-{row['prologue']['ms']['max']:.4f})"
              f" | bit-identical to the plain chain | auto takes {auto}, the faster by"
              f" median is {row['winner']}, the ranges of {rounds} rounds"
              f" {'do not overlap' if row['decided'] else 'overlap'}", flush=True)
        del acc, base, op, want
        torch.cuda.empty_cache()
    use(committed)
    return rows


def single_products(dev) -> dict:
    """{product: {"ms", "digest"}}: one fq_bilinear_cuda launch at
    SINGLE_LANES lanes, inputs at the budget's edges from SEED."""
    rng = np.random.default_rng(SEED)
    by_name = {t.name: t for t in T.TABLES}
    out = {}
    for name in SINGLE:
        tb = by_name[name]
        a = torch.from_numpy(edge(rng, (SINGLE_LANES, tb.Ca))).to(dev)
        b = a if (tb.norm_in or tb.one_col) else torch.from_numpy(
            edge(rng, (SINGLE_LANES, tb.Cb))).to(dev)
        got = fq_cuda.fq_bilinear_cuda(a, b, tb)
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        out[name] = {"ms": time_ms(lambda: fq_cuda.fq_bilinear_cuda(a, b, tb), 50),
                     "digest": digest}
    return {"products": out, "ptxas": registers(_nvcc.log_path("fq_mont").read_text())}


def against_parent(parent: Path) -> list:
    """Single products of the parent's tree and this one, in the order
    parent, this, this, parent, each in its own process."""
    runs = []
    for label, tree in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree),
                              "--single-products"], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"single products of {tree}:\n{res.stdout}\n{res.stderr}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": label, **got})
        print(f"single products at {SINGLE_LANES} lanes, {label}: " + ", ".join(
            f"{k} {v['ms']:.4f} ms (digest {v['digest']})" for k, v in got["products"].items())
            + "; ptxas " + " / ".join(got["ptxas"]), flush=True)
    same = all(r["products"][k]["digest"] == runs[0]["products"][k]["digest"]
               for r in runs for k in SINGLE)
    print(f"single products: the parent's limbs == this tree's: {same}", flush=True)
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the rows to this file")
    ap.add_argument("--rounds", type=int, default=5, help="interleaved timing rounds a case")
    ap.add_argument("--parent", help="a checkout of another commit: time its single products")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--single-products", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chain_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.single_products:
        print(json.dumps(single_products(torch.device("cuda"))))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _nvcc.build_all(("fq_mont",))
    print("ptxas fq_mont: " + " / ".join(
        ln.strip() for ln in _nvcc.log_path("fq_mont").read_text().splitlines()
        if "registers" in ln or "spill" in ln or "entry function" in ln), flush=True)
    report = {"card": smi}
    if args.parent:
        report["single_products"] = against_parent(Path(args.parent).resolve())
    work = Path(tempfile.mkdtemp(prefix="fq_chain_probe_"))
    try:
        fns = build_variants(work)
        report["rows"] = run(torch.device("cuda"), fns, fq_cuda._launcher("fq_chain"),
                             args.rounds)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
