"""Traffic kind "gossip": slot bursts of single-signer attestations through
the port's attestation firehose.

Set-up makes the pool (benchmark/gen/gossip.py), stages it once through
the port's `TorchBackend.stage_indexed_batch` (stages 1-3: pubkeys,
signatures, hash to G2) and warms the verifier with one burst. The window
replays the pool slot by slot into `StreamingVerifier.submit_staged`,
with `pump()` after every `pump_every` attestations and `flush()` at the
slot's end; the loop is closed: the next burst starts when the flush
returns. Keys are unique per replay, so no attestation is served from
the verdict cache. The check compares every verdict the window returned
with the reference's (benchmark/reference/gossip.py), and counts every
attestation of the pool that staging or the verifier left without one.
"""
from __future__ import annotations

import gc
import time
from contextlib import nullcontext

import numpy as np

from ..gen import rng_of
from ..gen.gossip import make_pool
from ..reference import gossip as ref


def setup(ctx):
    import torch

    from consensus_specs_tpu_torch import telemetry
    from consensus_specs_tpu_torch.ops.bls_torch import TorchBackend
    from consensus_specs_tpu_torch.streaming import StreamingVerifier

    cfg, mix, cell = ctx.config, ctx.traffic, ctx.cell
    tb = time.perf_counter()
    if ctx.device.type == "cuda":
        from consensus_specs_tpu_torch.ops import _nvcc
        _nvcc.build_all()
    t0 = time.perf_counter()
    print(f"set-up: kernels built or found in {t0 - tb:.3f} s", flush=True)
    pool = make_pool(ctx.seed, cfg["validators"], cell["pool_slots"],
                     cfg["committees_per_slot"], cfg["committee_size"],
                     mix["bad_one_in"], cfg["domain"])
    t1 = time.perf_counter()
    backend = TorchBackend(ctx.device)
    staged = backend.indexed_state(pool.items)
    stage_s = []
    for stage in backend.INDEXED_STAGES:      # stage_indexed_batch, one stage at a time
        ts = time.perf_counter()
        getattr(backend, stage)(staged)
        stage_s.append(f"{stage} {time.perf_counter() - ts:.3f} s")
    results, groups = staged.results, staged.groups
    t2 = time.perf_counter()
    pairs = [None] * len(pool.items)
    for i, p in groups:
        pairs[i] = p
    verifier = StreamingVerifier(backend=backend, target_groups=mix["target_groups"],
                                 ring_capacity=cfg["ring_capacity"], register=False)
    has_pairs = np.array([p is not None for p in pairs])
    decided = np.array([r is not None for r in results])
    slots = [np.flatnonzero((pool.slot_of == s) & has_pairs) for s in range(cell["pool_slots"])]
    st = {"pool": pool, "staged": results, "pairs": pairs, "slots": slots,
          "slot_sizes": np.bincount(pool.slot_of, minlength=cell["pool_slots"]),
          "slot_decided": np.bincount(pool.slot_of[decided], minlength=cell["pool_slots"]),
          "verifier": verifier, "got": [], "telemetry": telemetry}
    _burst(st, "warm", 0, mix["pump_every"], lambda name: nullcontext())
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    print(f"set-up: pool of {len(pool.items)} made in {t1 - t0:.3f} s, staged in "
          f"{t2 - t1:.3f} s ({', '.join(stage_s)}), warm burst "
          f"{time.perf_counter() - t2:.3f} s", flush=True)
    return st


def _burst(st, replay, slot: int, pump_every: int, spans) -> int:
    """One slot: submit every staged item of pool slot `slot` (pump after
    each pump_every), then flush. -> verdicts returned."""
    v, pairs, idx = st["verifier"], st["pairs"], st["slots"][slot]
    for lo in range(0, len(idx), pump_every):
        with spans("bench.submit"):
            for i in idx[lo:lo + pump_every]:
                v.submit_staged((replay, int(i)), pairs[i])
        with spans("bench.pump"):
            v.pump()
    with spans("bench.flush"):
        got = v.flush()
    st["got"].append((replay, slot, got))
    return len(got)


def window(ctx, st, seconds: float, spans) -> dict:
    mix = ctx.traffic
    v = st["verifier"]
    wraps = st["telemetry"].counter("firehose.ring_wraps", always=True)
    wraps0, launches0 = wraps.value, v.pipeline.launches
    bursts, attempted, verdicts, decided = [], 0, 0, 0
    gc0 = [g["collections"] for g in gc.get_stats()]
    t0 = time.perf_counter()
    replay = 0
    while True:
        slot = replay % len(st["slots"])
        b0 = time.perf_counter()
        verdicts += _burst(st, replay, slot, mix["pump_every"], spans)
        b1 = time.perf_counter()
        attempted += int(st["slot_sizes"][slot])
        decided += int(st["slot_decided"][slot])
        bursts.append((b1 - b0) * 1e3)
        replay += 1
        if b1 - t0 >= seconds:
            break
    window_s = b1 - t0
    ring_wraps = int(wraps.value - wraps0)
    q = np.percentile(bursts, [0, 50, 95, 100])
    collections = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    print(f"gossip: {replay} bursts, {attempted} attestations, {verdicts} verdicts, "
          f"firehose.ring_wraps {ring_wraps}; burst ms min {q[0]:.3f} median {q[1]:.3f} "
          f"p95 {q[2]:.3f} max {q[3]:.3f}; Python gc collections by generation "
          f"{collections}", flush=True)
    return {"window_s": window_s, "attempted": attempted,
            "failed": attempted - decided - verdicts,
            "verdicts": verdicts, "bursts_ms": bursts,
            "batches": v.pipeline.launches - launches0, "groups": verdicts,
            "pairs_per_group": 2, "ring_wraps": ring_wraps}


def release(st) -> None:
    st["verifier"] = None


def check(ctx, st, facts) -> list:
    """Numbers compared, each with its limit: verdicts that differ from the
    reference's (staging's decisions included); attestations left without
    a verdict: those of the pool that staging neither decided nor gave
    pairs, and in every burst (the warm one too) those submitted that the
    flush did not answer; and the reference's own spot check."""
    pool, staged, pairs = st["pool"], st["staged"], st["pairs"]
    want = ref.expected_verdicts(pool)
    wrong = sum(int(r is not None and bool(r) != want[i]) for i, r in enumerate(staged))
    missing = sum(int(r is None and pairs[i] is None) for i, r in enumerate(staged))
    for replay, slot, got in st["got"]:
        answered = {i for r, i in got if r == replay}
        missing += sum(int(int(i) not in answered) for i in st["slots"][slot])
        for (_, i), verdict in got.items():
            wrong += int(verdict != want[i])
    spot = ref.spot_check(pool, rng_of(ctx.seed, 2), ctx.traffic["spot_mul"],
                          ctx.traffic["spot_pairing"])
    return [("verdicts_wrong", wrong, 0), ("verdicts_missing", missing, 0),
            ("reference_spot_wrong", spot, 0)]


def control(ctx) -> list:
    """The control in the program's place: the reference with the signature
    check left out (benchmark/reference/gossip.py::control_verdicts), over
    the cell's pool. -> the numbers `check` compares."""
    cfg, cell, mix = ctx.config, ctx.cell, ctx.traffic
    pool = make_pool(ctx.seed, cfg["validators"], cell["pool_slots"],
                     cfg["committees_per_slot"], cfg["committee_size"],
                     mix["bad_one_in"], cfg["domain"])
    wrong = int((ref.control_verdicts(pool) != ref.expected_verdicts(pool)).sum())
    return [("verdicts_wrong", wrong, 0), ("verdicts_missing", 0, 0)]
