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

  * the Montgomery kernels (csrc/fq_mont.cu) are bit-identical to their
    plain versions on inputs at the edges of the limb budget: fq_mul
    (also with broadcast operands, and with the NORM_FULL rounds that
    Field.is_zero and canon ask for) and fq_redc at 1,048,576 lanes and at
    N = 1, 5, 300; the fused tower product fq_bilinear for each of its
    five tables (Fq2 multiply, Fq12 multiply, square and line multiply,
    cyclotomic square) at N = 1, 5, 300 and 65,536;
  * the valid block gives 16 x True, the block with one signature swapped
    for another committee's gives exactly that item False;
  * one grouped pairing of the block gives bit-identical Fq12 limbs
    through the kernels and through the plain functions on the card;
  * the verify launched fq_mul and fq_bilinear (launch counts read
    around it), one fq_bilinear per tower product, and no plain wide
    product ran on the card (ops.fq.cuda_wide_calls read around it).

Kernel times: at 1,048,576 lanes beside each kernel's bound, and at the
lane count the verify launches most, beside an empty kernel's launch on
the same stream (per eager call, host included, and per launch replayed
from a CUDA graph, device only).

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
BILINEAR_CHECK = 1 << 16
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


FQ_COUNTERS = {"fq_mul": fq_cuda.mul_counter, "fq_redc": fq_cuda.redc_counter,
               "fq_bilinear": fq_cuda.bilinear_counter}


def aten_ops(fn):
    """How many aten operators fn dispatches (every torch op the host
    issues, the kernels' output allocations included; the hand kernels'
    own launches go through ctypes and are counted by their wrappers)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def fq_launches():
    return {name: c.launches for name, c in FQ_COUNTERS.items()}


def fq_lanes():
    """Launches by lanes per launch ("table:lanes" for fq_bilinear)."""
    return {name: {(k if isinstance(k, int) else f"{k[0]}:{k[1]}"): v
                   for k, v in c.lanes.items()}
            for name, c in FQ_COUNTERS.items()}


def zero_fq_counters():
    for c in FQ_COUNTERS.values():
        c.reset()


def sass_counts(lib: Path) -> dict:
    """{kernel: Counter of SASS opcodes} of a built library, read with
    cuobjdump -sass; {} where the toolkit has no cuobjdump. Static counts:
    the arithmetic of a row (carry rounds, schoolbook, REDC) is unrolled,
    the staging and the tower product's pre-sum and gamma loops are not."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?(fq_mul|fq_redc|fq_bilinear)_kernel", line)
        if m:
            cur = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None:
            cur[m.group(1).split(".")[0]] += 1
    return counts


def fq_kernel_inputs(rng, n, what, coeffs=()):
    """Seeded lanes at the edges of the limb budget: multiply inputs
    [n, *coeffs, 14] with |body limb| < 2^32 and |top limb| < 2^16 (from
    two lanes up, lane 0 all at the maximum and lane 1 all at the
    minimum); REDC columns with |col| < 2^35 (top < 2^38), or raw
    schoolbook columns up to 14 * 2^58."""
    if what == "mul":
        shape = (n,) + tuple(coeffs)
        a = rng.integers(-(1 << 32) + 1, 1 << 32, shape + (14,))
        a[..., -1] = rng.integers(-(1 << 16) + 1, 1 << 16, shape)
        if n >= 2:
            a[0, ..., :-1], a[0, ..., -1] = (1 << 32) - 1, (1 << 16) - 1
            a[1, ..., :-1], a[1, ..., -1] = -(1 << 32) + 1, -(1 << 16) + 1
        return a
    if what == "redc":
        c = rng.integers(-fq_mod.WIDE_COL_BUDGET + 1, fq_mod.WIDE_COL_BUDGET, (n, 28))
        c[:, -1] = rng.integers(-fq_mod.WIDE_TOP_SPILL + 1, fq_mod.WIDE_TOP_SPILL, n)
        return c
    return rng.integers(-fq_mod.WIDE_COL_RAW, fq_mod.WIDE_COL_RAW + 1, (n, 28))


def bilinear_operands(rng, tables, n, dev):
    """(av, bv) of a tower product at the budget's edges; the squarings
    take one operand twice, as their Tower methods do."""
    av = torch.from_numpy(fq_kernel_inputs(rng, n, "mul", (tables.Ca,))).to(dev)
    if tables.name in SQUARINGS:
        return av, av
    return av, torch.from_numpy(fq_kernel_inputs(rng, n, "mul", (tables.Cb,))).to(dev)


SQUARINGS = ("fq12_sqr", "fq12_cyclo_sqr")


def bilinear_bound(tables, lanes):
    return fq_cuda.bound_ms(
        "fq_bilinear", lanes, INT32_OPS_PER_S, HBM_BYTES_PER_S, P=tables.P,
        R=tables.R, Ca=tables.Ca, Cb=0 if tables.name in SQUARINGS else tables.Cb)


def graph_ms(fn, reps):
    """ms per call of fn replayed from a CUDA graph of `reps` calls: the
    device's time per launch, with no host work between launches."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _same(got, want, what):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel != plain")
    return int((got - want).abs().max())


def check_fq_kernels(rng, dev):
    """fq_mul / fq_redc / fq_bilinear kernels vs their plain versions:
    max |difference| (must be 0) and bit identity; then kernel, plain and
    bound ms. fq_mul and fq_redc at KERNEL_LANES and RAGGED lanes (fq_mul
    also with an operand broadcast over the lanes and over an inner
    axis), timed at KERNEL_LANES. fq_bilinear, each table, at RAGGED and
    BILINEAR_CHECK lanes (the plain Fq12 product needs about 85 KB a
    lane), timed at KERNEL_LANES (kernel) and BILINEAR_CHECK (kernel and
    plain). Returns {name: numbers}."""
    out = {}
    for name in ("fq_mul", "fq_redc"):
        errs = []
        for n in (KERNEL_LANES,) + RAGGED:
            if name == "fq_mul":
                a, b = (torch.from_numpy(fq_kernel_inputs(rng, n, "mul")).to(dev)
                        for _ in range(2))
                a2 = torch.from_numpy(fq_kernel_inputs(rng, n, "mul", (2,))).to(dev)
                s1 = torch.from_numpy(fq_kernel_inputs(rng, n, "mul", (1,))).to(dev)
                for x, y, what in ((a, b, "plain"), (a, b[0], "broadcast lanes"),
                                   (a2, s1, "broadcast inner axis")):
                    errs.append(_same(fq_cuda.fq_mul_cuda(x, y), fq_mod.fq_mul_plain(x, y),
                                      f"fq_mul {what} N={n}"))
                errs.append(_same(fq_cuda.fq_mul_cuda(a, b, norm_full=True),
                                  fq_mod.fq_mul_norm_plain(a, b), f"fq_mul norm_full N={n}"))
                del a, b, a2, s1
            else:
                for what in ("redc", "raw"):
                    c = torch.from_numpy(fq_kernel_inputs(rng, n, what)).to(dev)
                    errs.append(_same(fq_cuda.fq_redc_cuda(c), fq_mod.fq_redc_plain(c),
                                      f"fq_redc {what} N={n}"))
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
                     "bound_by": by, "lanes": KERNEL_LANES}
        del a, b, c
        torch.cuda.empty_cache()

    tables = {}
    for tb in fq_tower.TABLES:
        errs = []
        for n in RAGGED + (BILINEAR_CHECK,):
            av, bv = bilinear_operands(rng, tb, n, dev)
            errs.append(_same(fq_cuda.fq_bilinear_cuda(av, bv, tb),
                              fq_mod.fq_bilinear_plain(av, bv, tb), f"{tb.name} N={n}"))
        kern = lambda: fq_cuda.fq_bilinear_cuda(av, bv, tb)  # noqa: E731
        plain = lambda: fq_mod.fq_bilinear_plain(av, bv, tb)  # noqa: E731
        row = {"max_abs_err": max(errs), "check_lanes": BILINEAR_CHECK,
               "check_ms": time_cuda(kern, 20), "plain_ms": time_cuda(plain, 2)}
        row["check_bound_ms"], row["check_bound_by"] = bilinear_bound(tb, BILINEAR_CHECK)
        del av, bv
        torch.cuda.empty_cache()
        av, bv = bilinear_operands(rng, tb, KERNEL_LANES, dev)
        row["ms"] = time_cuda(kern, 5)
        row["bound_ms"], row["bound_by"] = bilinear_bound(tb, KERNEL_LANES)
        row["lanes"] = KERNEL_LANES
        tables[tb.name] = row
        del av, bv
        torch.cuda.empty_cache()
    out["fq_bilinear"] = tables
    return out


def small_launch_times(lanes_seen, dev, rng):
    """Each kernel at the lane count the verify launched it with most
    (for fq_bilinear: each table at its own), per eager call (host and
    device) and per launch replayed from a CUDA graph (device), beside the
    same two times of an empty kernel. lanes_seen: fq_lanes() of the
    verify. Returns {"empty": {...}, name or table: {...}}."""
    out = {"empty": {"lanes": 0, "call_ms": time_cuda(fq_cuda.empty_launch, 500),
                     "graph_ms": graph_ms(fq_cuda.empty_launch, 200)}}

    def put(key, lanes, fn, count):
        out[key] = {"lanes": lanes, "launches": count,
                    "call_ms": time_cuda(fn, 500), "graph_ms": graph_ms(fn, 200)}

    if lanes_seen["fq_mul"]:
        n, count = max(lanes_seen["fq_mul"].items(), key=lambda kv: kv[1])
        a, b = (torch.from_numpy(fq_kernel_inputs(rng, n, "mul")).to(dev)
                for _ in range(2))
        put("fq_mul", n, lambda: fq_cuda.fq_mul_cuda(a, b), count)
    by_table = collections.defaultdict(dict)
    for key, count in lanes_seen["fq_bilinear"].items():
        name, n = key.split(":")
        by_table[name][int(n)] = count
    for tb in fq_tower.TABLES:
        if not by_table[tb.name]:
            continue
        n, count = max(by_table[tb.name].items(), key=lambda kv: kv[1])
        av, bv = bilinear_operands(rng, tb, n, dev)
        put(tb.name, n, lambda av=av, bv=bv, tb=tb: fq_cuda.fq_bilinear_cuda(av, bv, tb),
            count)
        out[tb.name]["bound_ms"], _ = bilinear_bound(tb, n)
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
    wide0 = fq_mod.cuda_wide_calls.calls
    zero_fq_counters()
    verdicts, out["verify_cold_ms"] = fenced_ms(
        lambda: tb.verify_indexed_batch(block.items))
    out["launches"] = fq_launches()
    if verdicts != [True] * block.n_att:
        raise AssertionError(f"valid block verdicts {verdicts}")
    if min(out["launches"]["fq_mul"], out["launches"]["fq_bilinear"]) <= 0:
        raise AssertionError(f"verify launched {out['launches']}")
    zero_fq_counters()
    _, out["verify_warm_ms"] = fenced_ms(lambda: tb.verify_indexed_batch(block.items))
    out["warm_launches"], out["warm_lanes"] = fq_launches(), fq_lanes()
    out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["plain_wide_on_card"] = fq_mod.cuda_wide_calls.calls - wide0
    if out["plain_wide_on_card"]:
        raise AssertionError(f"the verify ran {out['plain_wide_on_card']} plain"
                             " wide products on the card")
    out["aten_ops_per_verify"] = aten_ops(lambda: tb.verify_indexed_batch(block.items))
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
        out["stages"][name] = {"ms": ms, **fq_launches(), "lanes": fq_lanes()}
        return res

    for stage in tb.INDEXED_STAGES:
        timed(stage, lambda stage=stage: getattr(tb, stage)(st))
    # stage 3's host half: the try-and-increment search of each message
    _, out["stage_messages_host_ms"] = fenced_ms(
        lambda: [bls_host.hash_to_g2_candidate(mh, dom) for mh, dom in st.hashed])
    out["messages_hashed"] = len(st.hashed)
    g1 = torch.from_numpy(np.stack([np.stack([a for a, _ in p])
                                    for _, p in st.groups])).to(dev)
    g2 = torch.from_numpy(np.stack([np.stack([b for _, b in p])
                                    for _, p in st.groups])).to(dev)
    ok = timed("grouped_pairing", lambda: bls_torch.grouped_pairing_check(g1, g2))
    if not bool(ok.all()):
        raise AssertionError("staged grouped pairing rejected the valid block")
    # the same stages once more, untimed, counting the host's aten ops
    st_count = tb.indexed_state(block.items)
    for stage in tb.INDEXED_STAGES:
        out["stages"][stage]["aten_ops"] = aten_ops(
            lambda stage=stage: getattr(tb, stage)(st_count))
    out["stages"]["grouped_pairing"]["aten_ops"] = aten_ops(
        lambda: bls_torch.grouped_pairing_check(g1, g2))

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
        log(f"phase device: SASS {name}_kernel: {sum(cnt.values())} instructions"
            f" (static), {imad} IMAD-class, " + ", ".join(
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
    for name in ("fq_mul", "fq_redc"):
        k = fq_k[name]
        log(f"phase kernel: {name} bit-identical to plain at {KERNEL_LANES} lanes"
            f" and N={list(RAGGED)}{' (and broadcast, norm_full)' if name == 'fq_mul' else ''}"
            f" (max_abs_err {k['max_abs_err']}) | kernel {k['ms']:.4f} ms, plain"
            f" {k['plain_ms']:.2f} ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']}")
    for name, k in fq_k["fq_bilinear"].items():
        log(f"phase kernel: fq_bilinear {name} bit-identical to plain at"
            f" N={list(RAGGED) + [BILINEAR_CHECK]} (max_abs_err {k['max_abs_err']}) |"
            f" {KERNEL_LANES} lanes: kernel {k['ms']:.4f} ms, bound"
            f" {k['bound_ms']:.4f} ms by {k['bound_by']} | {BILINEAR_CHECK} lanes:"
            f" kernel {k['check_ms']:.4f} ms, plain {k['plain_ms']:.2f} ms, bound"
            f" {k['check_bound_ms']:.4f} ms")
    result["fq_kernels"] = fq_k
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
    def hist(lanes):
        """'lanes x launches', most launches first."""
        top = sorted(lanes.items(), key=lambda kv: -kv[1])
        return ", ".join(f"{k} x {v}" for k, v in top) or "-"

    for name, st in bls["stages"].items():
        log(f"phase bls {STAGE_LABELS[name]}: {st['ms']:.1f} ms, fq_mul"
            f" {st['fq_mul']} / fq_redc {st['fq_redc']} / fq_bilinear"
            f" {st['fq_bilinear']} launches, {st['aten_ops']} aten ops (an extra,"
            f" untimed run) | lanes per launch: fq_mul"
            f" {hist(st['lanes']['fq_mul'])}; fq_bilinear"
            f" {hist(st['lanes']['fq_bilinear'])}")
    launches, warm = bls["launches"], bls["warm_launches"]
    log(f"phase bls verify: {shape['attestations']} x {shape['committee']}"
        f" ({shape['pubkeys']} pubkeys, {shape['pairs']} pairs per group) |"
        f" cold {bls['verify_cold_ms']:.1f} ms, warm {bls['verify_warm_ms']:.1f} ms,"
        f" corrupted block {bls['verify_corrupt_ms']:.1f} ms | launches (cold / warm)"
        f" fq_mul {launches['fq_mul']} / {warm['fq_mul']}, fq_redc"
        f" {launches['fq_redc']} / {warm['fq_redc']}, fq_bilinear"
        f" {launches['fq_bilinear']} / {warm['fq_bilinear']} (one per tower"
        f" product), plain wide products on the card {bls['plain_wide_on_card']},"
        f" aten ops per verify {bls['aten_ops_per_verify']} (an extra, untimed run) |"
        f" peak device memory {bls['peak_device_gib']:.2f} GiB | host staging"
        f" {stage_s:.1f} s (untimed)")
    log(f"phase bls stage 3 split: the host's try-and-increment search of the"
        f" {bls['messages_hashed']} messages alone"
        f" {bls['stage_messages_host_ms']:.1f} ms of the stage's"
        f" {bls['stages']['stage_messages']['ms']:.1f} ms")
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

    # -- where a launch of the main path's size stands ---------------------------
    small = small_launch_times(bls["warm_lanes"], dev, rng)
    log("phase launch: at the verify's most frequent lane counts, ms per eager"
        " call (host and device) / per launch replayed from a CUDA graph: "
        + "; ".join(f"{k} {v['lanes']} lanes {v['call_ms']:.4f} / {v['graph_ms']:.4f}"
                    + (f" (bound {v['bound_ms']:.6f})" if "bound_ms" in v else "")
                    for k, v in small.items()))
    result["small_launch"] = small

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
        "max_abs_err": fq_k[name]["max_abs_err"],
        "ms": fq_k[name]["ms"],
        "plain_ms": fq_k[name]["plain_ms"],
        "bound_ms": fq_k[name]["bound_ms"],
        "bound_by": fq_k[name]["bound_by"],
        "library_ms": None,
        "lanes": KERNEL_LANES,
        "bit_identical": True,
    } for name in ("fq_mul", "fq_redc")]
    mul12 = fq_k["fq_bilinear"]["fq12_mul"]
    kernels.append({
        "name": "fq_bilinear",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/fq_mont.cu",
        "replaces": "consensus_specs_tpu/ops/fq_tower.py:522",
        "launches": bls["launches"]["fq_bilinear"],
        "max_abs_err": max(k["max_abs_err"] for k in fq_k["fq_bilinear"].values()),
        "ms": mul12["check_ms"],
        "plain_ms": mul12["plain_ms"],
        "bound_ms": mul12["check_bound_ms"],
        "bound_by": mul12["check_bound_by"],
        "library_ms": None,
        "lanes": BILINEAR_CHECK,
        "table": "fq12_mul",
        "bit_identical": True,
    })
    # every tower product's REDC runs inside fq_bilinear now, so the main
    # path launches fq_redc no more; it must have launched the others
    for k in kernels:
        k["on_main_path"] = k["name"] != "fq_redc"
        if k["on_main_path"] and k["launches"] <= 0:
            raise AssertionError(f"the main path never launched {k['name']}")
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
