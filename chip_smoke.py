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

Then the block-attestation slice (consensus_specs_tpu_torch.ops.bls_torch)
at BASELINE.json config 3's width on config 5's registry: one block of
SHARD_COUNT / SLOTS_PER_EPOCH = 16 attestations, each over a full
committee of V / SHARD_COUNT = 976 members (64 keypairs cycled over the
members, one signature per committee under the sum of its members' keys;
staged on the host, untimed), verified through TorchBackend's
verify_indexed_batch. Checks:

  * the Montgomery kernels (csrc/fq_mont.cu, fq_mul and fq_redc) are
    bit-identical to their plain versions at 1,048,576 lanes and at
    N = 1, 5, 300, on inputs at the edges of the limb budget;
  * the valid block gives 16 x True, the block with one signature swapped
    for another committee's gives exactly that item False;
  * one grouped pairing of the block gives bit-identical Fq12 limbs
    through the kernels and through the plain functions on the card;
  * the verify launched both kernels (launch counts read around it).

Prints one line per phase, the card's name and power limit, a JSON line of
kernel numbers, and last {"ok": true, "device": {...}}. Any failure raises
and exits non-zero. Needs one CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls12_381 as bls_host
from consensus_specs_tpu_torch.models.phase0 import epoch_soa
from consensus_specs_tpu_torch.models.phase0.resident import ResidentColumns
from consensus_specs_tpu_torch.ops import _nvcc, sha256, sha256_cuda
from consensus_specs_tpu_torch.ops import bls_torch, fq_cuda, fq_tower
from consensus_specs_tpu_torch.ops import fq as fq_mod
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
# add, logic and shift, and 32-bit integer multiply-add, at 64 per clock
# per SM for compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), over 132 SMs at the 1.98 GHz
# maximum SM clock = 16.7 T ops/s per pipe.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

N_KEYS = 64                 # keypairs cycled over the committee members
BLS_DOMAIN = 0x0100000000000000 + 1
BAD_ITEM = 5                # the item whose signature is swapped
PLAIN_GROUPS = 16           # groups of the kernel-vs-plain pairing check
STAGE_LABELS = {
    "stage_pubkeys": "stage 1, G1 decompress + aggregate of every pubkey",
    "stage_signatures": "stage 2, G2 decompress of the signatures",
    "stage_messages": "stage 3, hash_to_G2 of the messages",
    "stage_pairs": "stage 4 staging, pairing inputs (host)",
    "grouped_pairing": "stage 4, grouped pairing",
}


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


def time_cuda(fn, reps):
    """ms per call of fn on the card, CUDA events around `reps` calls
    after one warm-up call."""
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


def fenced_ms(fn):
    """(result, wall ms) of fn, fenced by synchronizations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def device_busy(fn):
    """{wall_ms, device_ms, idle_share} of fn traced by torch.profiler
    (CUDA activity): device_ms sums the kernels' own device time, and the
    wall includes the profiler's overhead. None where the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = fenced_ms(fn)
    dev_us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0) for e in prof.key_averages())
    if dev_us <= 0:
        return {"wall_ms": wall, "device_ms": None, "idle_share": None}
    return {"wall_ms": wall, "device_ms": dev_us / 1e3,
            "idle_share": 1 - dev_us / 1e3 / wall}


def fq_launches():
    return fq_cuda.mul_counter.launches, fq_cuda.redc_counter.launches


def zero_fq_counters():
    fq_cuda.mul_counter.launches = 0
    fq_cuda.redc_counter.launches = 0


def sass_counts(lib: Path) -> dict:
    """{entry point: Counter of SASS opcodes} of a built library, read
    with cuobjdump -sass; {} where the toolkit has no cuobjdump. Every
    loop of csrc/fq_mont.cu is unrolled and its only branch is the bounds
    check, so the static count is the instructions one lane executes."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?(fq_mul|fq_redc)_kernel", line)
        if m:
            cur = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            cur[m.group(1).split(".")[0]] += 1
    return counts


def fq_kernel_inputs(rng, n, what):
    """Seeded lanes at the edges of the limb budget: multiply inputs with
    |body limb| < 2^32 and |top limb| < 2^16; REDC columns with
    |col| < 2^35 (top < 2^38), or raw schoolbook columns up to 14 * 2^58."""
    if what == "mul":
        a = rng.integers(-(1 << 32) + 1, 1 << 32, (n, 14))
        a[:, -1] = rng.integers(-(1 << 16) + 1, 1 << 16, n)
        return a
    if what == "redc":
        c = rng.integers(-fq_mod.WIDE_COL_BUDGET + 1, fq_mod.WIDE_COL_BUDGET, (n, 28))
        c[:, -1] = rng.integers(-fq_mod.WIDE_TOP_SPILL + 1, fq_mod.WIDE_TOP_SPILL, n)
        return c
    return rng.integers(-fq_mod.WIDE_COL_RAW, fq_mod.WIDE_COL_RAW + 1, (n, 28))


def check_fq_kernels(rng, dev):
    """fq_mul / fq_redc kernels vs their plain versions: max |difference|
    (must be 0) and bit identity at KERNEL_LANES and RAGGED lanes; then
    kernel, plain and bound ms at KERNEL_LANES. Returns {name: numbers}."""
    out = {}
    for name in ("fq_mul", "fq_redc"):
        errs = []
        for n in (KERNEL_LANES,) + RAGGED:
            if name == "fq_mul":
                a, b = (torch.from_numpy(fq_kernel_inputs(rng, n, "mul")).to(dev)
                        for _ in range(2))
                pairs = [(fq_cuda.fq_mul_cuda(a, b), fq_mod.fq_mul_plain(a, b))]
            else:
                pairs = []
                for what in ("redc", "raw"):
                    c = torch.from_numpy(fq_kernel_inputs(rng, n, what)).to(dev)
                    pairs.append((fq_cuda.fq_redc_cuda(c), fq_mod.fq_redc_plain(c)))
            torch.cuda.synchronize()
            for got, want in pairs:
                errs.append(int((got - want).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} kernel != plain at N={n}")
        a, b = (torch.from_numpy(fq_kernel_inputs(rng, KERNEL_LANES, "mul")).to(dev)
                for _ in range(2))
        c = torch.from_numpy(fq_kernel_inputs(rng, KERNEL_LANES, "redc")).to(dev)
        if name == "fq_mul":
            kern, plain = (lambda: fq_cuda.fq_mul_cuda(a, b),
                           lambda: fq_mod.fq_mul_plain(a, b))
        else:
            kern, plain = (lambda: fq_cuda.fq_redc_cuda(c),
                           lambda: fq_mod.fq_redc_plain(c))
        bound, by = fq_cuda.bound_ms(name, KERNEL_LANES, INT32_OPS_PER_S,
                                     HBM_BYTES_PER_S)
        out[name] = {"max_abs_err": max(errs), "ms": time_cuda(kern, 50),
                     "plain_ms": time_cuda(plain, 3), "bound_ms": bound,
                     "bound_by": by}
    return out


class Block:
    """One block's attestations at mainnet width, staged on the host with
    the port's bignum copy: SHARD_COUNT / SLOTS_PER_EPOCH attestations,
    attestation c over validators [c*size, (c+1)*size), size =
    V // SHARD_COUNT; validator v's key is (v % N_KEYS) + 1, so a
    committee's aggregate signature is one signature under the sum of its
    members' keys mod r. Items are phase 0's (custody-bit-0 set, empty
    custody-bit-1 set) with their two message hashes."""

    def __init__(self, preset, V: int, seed: int):
        rng = np.random.default_rng(seed)
        self.n_att = int(preset["SHARD_COUNT"]) // int(preset["SLOTS_PER_EPOCH"])
        self.size = V // int(preset["SHARD_COUNT"])
        pubs = [bls_host.privtopub(k + 1) for k in range(N_KEYS)]
        hashes = rng.integers(0, 256, (self.n_att, 2, 32), dtype=np.uint8)
        self.items = []
        for c in range(self.n_att):
            members = range(c * self.size, (c + 1) * self.size)
            secret = sum(v % N_KEYS + 1 for v in members) % bls_host.r
            m0, m1 = hashes[c, 0].tobytes(), hashes[c, 1].tobytes()
            self.items.append((
                [[pubs[v % N_KEYS] for v in members], []], [m0, m1],
                bls_host.sign(m0, secret, BLS_DOMAIN), BLS_DOMAIN))
        bad = list(self.items[BAD_ITEM])
        bad[2] = self.items[(BAD_ITEM + 1) % self.n_att][2]
        self.corrupt = self.items[:BAD_ITEM] + [tuple(bad)] + self.items[BAD_ITEM + 1:]


def drive_bls(block: Block, dev):
    """The slice on the card: verify_indexed_batch of the valid block
    (counted: the launches of the main path), warm verify, the corrupted
    block, the four stages fenced one by one, and the kernel-route vs
    plain-route grouped pairing. Returns the numbers; raises on any wrong
    verdict or mismatch."""
    tb = bls_torch.TorchBackend(dev)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    zero_fq_counters()
    verdicts, out["verify_cold_ms"] = fenced_ms(
        lambda: tb.verify_indexed_batch(block.items))
    out["launches"] = dict(zip(("fq_mul", "fq_redc"), fq_launches()))
    if verdicts != [True] * block.n_att:
        raise AssertionError(f"valid block verdicts {verdicts}")
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"verify launched {out['launches']}")
    _, out["verify_warm_ms"] = fenced_ms(lambda: tb.verify_indexed_batch(block.items))
    out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    bad, out["verify_corrupt_ms"] = fenced_ms(
        lambda: tb.verify_indexed_batch(block.corrupt))
    if bad != [k != BAD_ITEM for k in range(block.n_att)]:
        raise AssertionError(f"corrupted block verdicts {bad}")

    # the stages of one more verify, each fenced and counted on its own
    st = tb.indexed_state(block.items)
    out["stages"] = {}

    def timed(name, fn):
        zero_fq_counters()
        res, ms = fenced_ms(fn)
        mul, redc = fq_launches()
        out["stages"][name] = {"ms": ms, "fq_mul": mul, "fq_redc": redc}
        return res

    for stage in tb.INDEXED_STAGES:
        timed(stage, lambda stage=stage: getattr(tb, stage)(st))
    g1 = torch.from_numpy(np.stack([np.stack([a for a, _ in p])
                                    for _, p in st.groups])).to(dev)
    g2 = torch.from_numpy(np.stack([np.stack([b for _, b in p])
                                    for _, p in st.groups])).to(dev)
    ok = timed("grouped_pairing", lambda: bls_torch.grouped_pairing_check(g1, g2))
    if not bool(ok.all()):
        raise AssertionError("staged grouped pairing rejected the valid block")

    # kernel route vs plain route, one grouped pairing of the block
    n = min(PLAIN_GROUPS, g1.shape[0])
    routes = {}
    for name, tower in (("kernel", fq_tower.DEVICE), ("plain", fq_tower.PLAIN)):
        def pair(tower=tower):
            f = bls_torch.miller_loop_grouped(g1[:n], g2[:n], tower)
            return f, bls_torch.final_exponentiation_3x(f, tower)
        routes[name], out[f"pairing_{name}_ms"] = fenced_ms(pair)
    for k_t, p_t in zip(routes["kernel"], routes["plain"]):
        if not torch.equal(k_t, p_t):
            raise AssertionError("grouped pairing: kernel route != plain route")
    out["pairing_groups_compared"] = n
    out["pairing_trace"] = device_busy(
        lambda: bls_torch.grouped_pairing_check(g1, g2))
    out["shape"] = {"attestations": block.n_att, "committee": block.size,
                    "pubkeys": block.n_att * block.size, "pairs": int(g1.shape[1])}
    return out


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
    ptxas = {name: [ln.strip() for ln in _nvcc.log_path(name).read_text().splitlines()
                    if "registers" in ln or "spill" in ln or "entry function" in ln]
             for name in _nvcc.SOURCES}
    log(f"phase device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | nvcc build of {list(_nvcc.SOURCES)} {build_s:.1f} s"
        f" | ptxas sha256_pairs: {' / '.join(ptxas['sha256_pairs'])}")
    log("phase device: ptxas fq_mont: " + " / ".join(ptxas["fq_mont"]))
    sass = sass_counts(_nvcc.library_path("fq_mont"))
    for name, cnt in sass.items():
        imad = sum(v for k, v in cnt.items() if k.startswith("IMAD"))
        log(f"phase device: SASS {name}: {sum(cnt.values())} instructions per lane,"
            f" {imad} IMAD-class, " + ", ".join(
                f"{k} {v}" for k, v in cnt.most_common(10)))
    result["card"] = smi
    result["build_s"] = build_s
    result["ptxas"] = ptxas
    result["sass"] = {k: dict(v) for k, v in sass.items()}

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

    kernel_ms = time_cuda(lambda: sha256_cuda.sha256_pairs_cuda(words), 50)
    plain_ms = time_cuda(lambda: sha256.sha256_pairs(words), 3)
    bound_ms, bound_by = sha256_cuda.bound_ms(
        KERNEL_LANES, INT32_OPS_PER_S, HBM_BYTES_PER_S)
    log(f"phase kernel: sha256_pairs bit-identical to plain at {KERNEL_LANES} "
        f"lanes and N={list(RAGGED)}, matches hashlib | kernel {kernel_ms:.4f} ms,"
        f" plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by {bound_by}")
    del words, got, want

    fq_k = check_fq_kernels(rng, dev)
    for name, k in fq_k.items():
        log(f"phase kernel: {name} bit-identical to plain at {KERNEL_LANES} lanes"
            f" and N={list(RAGGED)} (max_abs_err {k['max_abs_err']}) | kernel"
            f" {k['ms']:.4f} ms, plain {k['plain_ms']:.2f} ms, bound"
            f" {k['bound_ms']:.4f} ms by {k['bound_by']}")
    torch.cuda.empty_cache()

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

    # -- 7. the block-attestation slice -----------------------------------------
    del core, b_cols
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    block = Block(preset, V_MAIN, SEED + 2)
    stage_s = time.perf_counter() - t0
    bls = drive_bls(block, dev)
    shape = bls["shape"]
    for name, st in bls["stages"].items():
        log(f"phase bls {STAGE_LABELS[name]}: {st['ms']:.1f} ms, fq_mul"
            f" {st['fq_mul']} / fq_redc {st['fq_redc']} launches")
    log(f"phase bls verify: {shape['attestations']} x {shape['committee']}"
        f" ({shape['pubkeys']} pubkeys, {shape['pairs']} pairs per group) |"
        f" cold {bls['verify_cold_ms']:.1f} ms, warm {bls['verify_warm_ms']:.1f} ms,"
        f" corrupted block {bls['verify_corrupt_ms']:.1f} ms | launches fq_mul"
        f" {bls['launches']['fq_mul']} / fq_redc {bls['launches']['fq_redc']} |"
        f" peak device memory {bls['peak_device_gib']:.2f} GiB | host staging"
        f" {stage_s:.1f} s (untimed)")
    log(f"phase bls checks: {shape['attestations']} x True; item {BAD_ITEM} alone"
        f" False with a swapped signature; grouped pairing of"
        f" {bls['pairing_groups_compared']} groups bit-identical through kernels"
        f" ({bls['pairing_kernel_ms']:.1f} ms) and plain functions"
        f" ({bls['pairing_plain_ms']:.1f} ms)")
    tr = bls["pairing_trace"]
    log("phase bls trace: stage 4 grouped pairing under torch.profiler: wall"
        f" {tr['wall_ms']:.1f} ms, device "
        + ("not measured (no device time in the trace)" if tr["device_ms"] is None
           else f"{tr['device_ms']:.1f} ms, idle share {tr['idle_share']:.3f}"))
    result["bls"] = bls

    # -- 8. kernels line ---------------------------------------------------------
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
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/fq_mont.cu",
        "replaces": {"fq_mul": "consensus_specs_tpu/ops/fq.py:450",
                     "fq_redc": "consensus_specs_tpu/ops/fq.py:413"}[name],
        "launches": bls["launches"][name],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
        "lanes": KERNEL_LANES,
        "bit_identical": True,
    } for name, k in fq_k.items()]
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
