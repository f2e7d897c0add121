#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--json PATH]

Builds every CUDA kernel of the port from its source, holds each against
its plain PyTorch twin on the card, then drives the resident state-root
and epoch-boundary core (consensus_specs_tpu_torch.models.phase0.resident)
at the mainnet preset with 1,000,000 validators: enter (both forests and
roots), 4 slots of 1,024 dirty balances each, one epoch boundary (epoch
program, the next epoch's shuffle, rebuild), 2 more slots. Checks:

  * every root equals the same drive through the plain pair hash on the card;
  * the boundary's columns, scalars, report and permutation equal the port
    run on the CPU from the same pre-boundary state;
  * a whole drive at 2,048 validators equals roots computed here with
    hashlib from the columns (SSZ List[Validator] / List[uint64]);
  * the main path launched the kernel (launch counts read around it).

Prints one line per phase, the card's name and power limit, a JSON line of
kernel numbers, and last {"ok": true, "device": {...}}. Any failure raises
and exits non-zero. Needs one CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.models.phase0 import epoch_soa
from consensus_specs_tpu_torch.models.phase0.resident import ResidentColumns
from consensus_specs_tpu_torch.ops import _nvcc, sha256, sha256_cuda
from consensus_specs_tpu_torch.ops import shuffle as shuffle_mod
from consensus_specs_tpu_torch.utils.config import load_preset

V_MAIN = 1_000_000
V_HASHLIB = 2_048
DIRTY_PER_SLOT = 1_024
SLOTS_BEFORE, SLOTS_AFTER = 4, 2
KERNEL_LANES = 1 << 20
RAGGED = (1, 5, 300)
SEED = 20260801
DEVICE = "cuda"

# H100 SXM peaks: HBM 3.35 TB/s (NVIDIA data sheet); 32-bit integer
# add, logic and shift at 64 per clock per SM for compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput), over
# 132 SMs at the 1.98 GHz maximum SM clock = 16.7 T ops/s per pipe.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def log(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# hashlib roots, written out here independently of the port
# ---------------------------------------------------------------------------

def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def _merkleize(chunks) -> bytes:
    level = list(chunks)
    if not level:
        return bytes(32)
    zero = bytes(32)
    depth = (len(level) - 1).bit_length()
    for _ in range(depth):
        if len(level) % 2:
            level.append(zero)
        level = [_sha(level[i] + level[i + 1]) for i in range(0, len(level), 2)]
        zero = _sha(zero + zero)
    return level[0]


def _mix_in_length(root: bytes, n: int) -> bytes:
    return _sha(root + n.to_bytes(32, "little"))


def hashlib_roots(cols, pk: np.ndarray, wc: np.ndarray):
    """(registry_root, balances_root) of numpy columns, with hashlib."""
    def u64(v):
        return int(v).to_bytes(8, "little") + bytes(24)

    roots = []
    for i in range(pk.shape[0]):
        fields = [
            _sha(pk[i].tobytes() + bytes(16)),
            wc[i].tobytes(),
            u64(cols.activation_eligibility_epoch[i]),
            u64(cols.activation_epoch[i]),
            u64(cols.exit_epoch[i]),
            u64(cols.withdrawable_epoch[i]),
            bytes([int(cols.slashed[i])]) + bytes(31),
            u64(cols.effective_balance[i]),
        ]
        roots.append(_merkleize(fields))
    registry = _mix_in_length(_merkleize(roots), pk.shape[0])
    raw = np.asarray(cols.balance, np.uint64).astype("<u8").tobytes()
    raw += bytes((-len(raw)) % 32)
    chunks = [raw[i:i + 32] for i in range(0, len(raw), 32)]
    balances = _mix_in_length(_merkleize(chunks), cols.balance.shape[0])
    return registry, balances


# ---------------------------------------------------------------------------
# the drive
# ---------------------------------------------------------------------------

class Scenario:
    """One deterministic state and its traffic: columns, keys, the slot
    updates and the boundary's seed, all from numpy with one seed."""

    def __init__(self, cfg, V: int, seed: int):
        rng = np.random.default_rng(seed)
        self.cfg = cfg
        self.cols, self.scal, self.inp = epoch_soa.synthetic_epoch_state(
            cfg, V, rng, random_eligibility=True, random_slashed_balances=True)
        self.pk = rng.integers(0, 256, (V, 48), dtype=np.uint8)
        self.wc = rng.integers(0, 256, (V, 32), dtype=np.uint8)
        k = min(DIRTY_PER_SLOT, V)
        self.slots = [
            (rng.choice(V, size=k, replace=False),
             rng.integers(31 * 10 ** 9, 33 * 10 ** 9, k).astype(np.uint64))
            for _ in range(SLOTS_BEFORE + SLOTS_AFTER)]
        self.boundary_seed = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()


def drive(sc: Scenario, rounds: int, device, pair_fn=None, on_step=None,
          before_boundary=None):
    """enter -> slots -> boundary -> slots on a fresh ResidentColumns.
    Returns (core, roots after every step, boundary outputs).
    on_step(name, core) runs after each step (timing, launch counts)."""
    core = ResidentColumns(sc.cfg, sc.cols, sc.pk, sc.wc, rounds,
                                device=device, pair_fn=pair_fn)
    roots = []

    def step(name, fn):
        fn()
        roots.append((name, core.roots()))
        if on_step is not None:
            on_step(name, core)

    step("enter", core.enter)
    for s, (idx, vals) in enumerate(sc.slots[:SLOTS_BEFORE]):
        step(f"slot{s}", lambda: core.apply_balances(idx, vals))
    if before_boundary is not None:
        before_boundary(core)
    _, scal, inp = convert.columns_from_numpy(sc.cols, sc.scal, sc.inp, device)
    out = {}

    def boundary():
        out["scal"], out["report"], out["perm"] = core.epoch_boundary(
            scal, inp, sc.boundary_seed)
    step("boundary", boundary)
    for s, (idx, vals) in enumerate(sc.slots[SLOTS_BEFORE:]):
        step(f"slot{SLOTS_BEFORE + s}", lambda: core.apply_balances(idx, vals))
    return core, roots, out


def _same_tuple(a, b, what: str) -> None:
    for f in type(a)._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.shape != y.shape or not (x == y).all():
            raise AssertionError(f"{what}.{f} differs between card and CPU")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    result = {"phases": {}}
    sync = torch.cuda.synchronize

    # -- 1. device and kernel build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _nvcc.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _nvcc.log_path("sha256_pairs").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | nvcc build {build_s:.1f} s | ptxas: {' / '.join(ptxas)}")
    result["card"] = smi
    result["build_s"] = build_s

    # -- 2. kernel vs plain ---------------------------------------------------
    rng = np.random.default_rng(SEED)
    words = sha256.words_tensor(
        rng.integers(0, 2 ** 32, (KERNEL_LANES, 16), dtype=np.uint32), dev)
    got = sha256_cuda.sha256_pairs_cuda(words)
    want = sha256.sha256_pairs(words)
    sync()
    max_err = int((sha256.widen(got) - sha256.widen(want)).abs().max())
    if max_err:
        raise AssertionError(f"kernel != plain at {KERNEL_LANES} lanes")
    for n in RAGGED:
        w = sha256.words_tensor(
            rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint32), dev)
        if not torch.equal(sha256_cuda.sha256_pairs_cuda(w), sha256.sha256_pairs(w)):
            raise AssertionError(f"kernel != plain at N={n}")
    msgs = [bytes(range(64)), bytes(64), b"\xff" * 64]
    mw = sha256.words_tensor(np.stack(
        [sha256.bytes_to_words(np.frombuffer(m, np.uint8)) for m in msgs]), dev)
    digests = sha256.words_to_bytes(sha256_cuda.sha256_pairs_cuda(mw))
    for m, d in zip(msgs, digests):
        if d.tobytes() != hashlib.sha256(m).digest():
            raise AssertionError("kernel != hashlib")

    def time_cuda(fn, reps):
        fn()
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / reps

    kernel_ms = time_cuda(lambda: sha256_cuda.sha256_pairs_cuda(words), 50)
    plain_ms = time_cuda(lambda: sha256.sha256_pairs(words), 3)
    bound_ms, bound_by = sha256_cuda.bound_ms(
        KERNEL_LANES, INT32_OPS_PER_S, HBM_BYTES_PER_S)
    log(f"phase kernel: sha256_pairs bit-identical to plain at {KERNEL_LANES} "
        f"lanes and N={list(RAGGED)}, matches hashlib | kernel {kernel_ms:.4f} ms,"
        f" plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by}")
    del words, got, want

    preset = load_preset("mainnet")
    cfg = epoch_soa.EpochConfig.from_preset("mainnet")
    rounds = int(preset["SHUFFLE_ROUND_COUNT"])

    # -- warm-up, and the hashlib check: a whole drive at 2,048 validators ----
    small = Scenario(cfg, V_HASHLIB, SEED + 1)

    def small_step(name, core):
        np_cols = convert.columns_to_numpy(core.cols)[0]
        if core.roots() != hashlib_roots(np_cols, small.pk, small.wc):
            raise AssertionError(f"V={V_HASHLIB} {name}: roots != hashlib")
    drive(small, rounds, dev, on_step=small_step)
    sync()

    # -- 3-5. the main path at 1M validators, timed and counted --------------
    main_sc = Scenario(cfg, V_MAIN, SEED)
    snap = {}
    timings, launches = {}, {}
    clock = {"t": 0.0, "n": 0}

    def main_step(name, core):
        sync()
        timings[name] = (time.perf_counter() - clock["t"]) * 1e3
        launches[name] = sha256_cuda.counter.launches - clock["n"]
        if name == "boundary":       # untimed copies for the CPU check
            snap["after"] = convert.columns_to_numpy(core.cols)[0]
        clock["t"], clock["n"] = time.perf_counter(), sha256_cuda.counter.launches

    def snapshot(core):
        sync()
        snap["before"] = convert.columns_to_numpy(core.cols)[0]
        clock["t"], clock["n"] = time.perf_counter(), sha256_cuda.counter.launches

    torch.cuda.reset_peak_memory_stats()
    sync()
    sha256_cuda.counter.launches = 0
    clock["t"] = time.perf_counter()
    core, roots, bout = drive(main_sc, rounds, dev, on_step=main_step,
                              before_boundary=snapshot)
    sync()
    main_launches = sha256_cuda.counter.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if main_launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    slot_ms = [timings[k] for k in timings if k.startswith("slot")]
    log(f"phase enter: {timings['enter']:.1f} ms, {launches['enter']} launches")
    log(f"phase slots: {SLOTS_BEFORE + SLOTS_AFTER} x {DIRTY_PER_SLOT} dirty, "
        f"ms {[round(t, 2) for t in slot_ms]}, launches "
        f"{[launches[k] for k in launches if k.startswith('slot')]}")
    log(f"phase boundary: {timings['boundary']:.1f} ms (epoch program + shuffle "
        f"of {int(bout['perm'].shape[0])} active + rebuild + roots), "
        f"{launches['boundary']} launches | peak device memory {peak_gib:.2f} GiB")
    result["phases"] = {"ms": timings, "launches": launches,
                        "peak_device_gib": peak_gib}

    # -- 6. checks --------------------------------------------------------------
    t0 = time.perf_counter()
    _, plain_roots, _ = drive(main_sc, rounds, dev, pair_fn=sha256.sha256_pairs)
    sync()
    for (name, r_k), (_, r_p) in zip(roots, plain_roots):
        if r_k != r_p:
            raise AssertionError(f"{name}: kernel-path roots != plain-path roots")
    plain_drive_s = time.perf_counter() - t0

    cpu = torch.device("cpu")
    cpu_cols, cpu_scal, cpu_inp = convert.columns_from_numpy(
        snap["before"], main_sc.scal, main_sc.inp, cpu)
    _, c_scal, c_rep = epoch_soa.epoch_transition_device(cfg, cpu_cols, cpu_scal, cpu_inp)
    c_np = convert.columns_to_numpy(cpu_cols, c_scal, c_rep)
    _, g_scal, g_rep = convert.columns_to_numpy(core.cols, bout["scal"], bout["report"])
    _same_tuple(snap["after"], c_np[0], "columns")
    _same_tuple(g_scal, c_np[1], "scalars")
    _same_tuple(g_rep, c_np[2], "report")
    n_active = int(core.active_indices.shape[0])
    cpu_perm = shuffle_mod.shuffle_permutation_on_device(
        main_sc.boundary_seed, n_active, rounds, cpu)
    if not torch.equal(bout["perm"].cpu(), cpu_perm):
        raise AssertionError("permutation differs between card and CPU")
    log(f"phase checks: {len(roots)} roots == plain-path drive on the card "
        f"({plain_drive_s:.1f} s); boundary columns, scalars, report and "
        f"permutation == CPU run; V={V_HASHLIB} drive == hashlib")

    # -- where the boundary's time goes: its parts once more, each fenced ------
    parts = {}

    def fenced(name, fn):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        parts[name] = (time.perf_counter() - t) * 1e3

    _, b_scal, b_inp = convert.columns_from_numpy(
        main_sc.cols, main_sc.scal, main_sc.inp, dev)
    b_cols = type(core.cols)(*[c.clone() for c in core.cols])
    fenced("epoch_program", lambda: epoch_soa.epoch_transition_device(
        cfg, b_cols, b_scal, b_inp))
    fenced("shuffle", lambda: shuffle_mod.shuffle_permutation_on_device(
        main_sc.boundary_seed, n_active, rounds, dev))
    fenced("rebuild", core.enter)
    fenced("roots", core.roots)
    log("phase breakdown: boundary parts, ms "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    result["boundary_parts_ms"] = parts

    # -- 7. kernels line ---------------------------------------------------------
    kernels = [{
        "name": "sha256_pairs",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/sha256_pairs.cu",
        "replaces": "consensus_specs_tpu/ops/sha256_pallas.py:70",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "lanes": KERNEL_LANES,
        "bit_identical": True,
    }]
    result["kernels"] = kernels
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
