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
    cyclotomic square) at N = 1, 5, 300 and 65,536; the chains
    (fq_bilinear_chain: the exponentiation by |z| and |z| + 1, the Miller
    step's f-update for 2 and 3 pairs, and the fixed-exponent powers: the
    Fq inversion and square root, the Fq2 square root) at N = 1, 5, 300,
    16 and 128 (the Fq square root also at stage 1's 16,384), against the
    plain chain, against the same products launched one at a time
    (fq_bilinear, fq_mul, the tower's fq2_sqr), and lane 0 against the
    bignum field's power or product, each step's phases clocked at 128
    lanes;
  * the valid block gives 16 x True, the block with one signature swapped
    for another committee's gives exactly that item False;
  * one grouped pairing of the block gives bit-identical Fq12 limbs
    through the kernels and through the plain functions on the card;
  * the verify launched fq_mul, fq_bilinear and fq_bilinear_chain
    (launch counts read around it), one fq_bilinear per tower product
    outside the chains, and no plain wide product ran on the card
    (ops.fq.cuda_wide_calls read around it).

Then the spec path: the port's ResidentCore driven through the system's
own entry points (consensus_specs_tpu_torch.models.phase0: get_spec,
ResidentCore, the spec's process_block), mainnet preset at full width:

  * resume at V = 1,000,000: state bytes assembled from synthetic columns
    and a light state with a full epoch of PendingAttestations
    (state_bytes_from_columns, no Validator object), from_checkpoint,
    process_slots one slot at a time across an epoch boundary (a full
    state root every slot), checkpoint_bytes, from_checkpoint again. The
    roots and written bytes must equal the same drive with the plain pair
    hash on the card (which launches no kernel); the resumed core must
    write the same bytes and have the same root;
  * blocks at V = 131,072 (16 committees of 128 a slot) through the object
    entry ResidentCore(spec, state), BLS on the "torch" backend: blocks
    of 16 fully participating attestations (signed on the host, untimed),
    one signed voluntary exit (the fallback path), then a block with two
    attestation signatures swapped, which the batched verify must reject
    (exactly those two items False, the AssertionError raised in
    process_attestations_batched); the exited state's bulk root must
    equal the resident root;
  * reference at V = 2,048: 12 blocks across an epoch boundary through
    ResidentCore and through the port's unpatched object model, per-slot
    roots, full roots and serialized states equal;
  * resilience on the resume's state bytes (V = 1,000,000): a
    CheckpointStore in a temporary directory saves a generation at the
    resume and one after the boundary; a poison of the balance column at
    the boundary (fault schedule "dispatch:*epoch*@1=poison:6") must read
    False in the tripwire and raise FatalDispatchError with
    consumed_inputs, and store.restore + a replay of the slots must give
    every root of the unfaulted drive; the second save, truncated on
    write ("ckpt.write@2=truncate:33"), must make restore fall back to
    the first generation (corrupt_generations 1); a raise at the boundary
    must be retried once with every later root unchanged; the boundary
    slot runs with the tripwire on and off from the same bytes (same
    root; the tripwire's own ms against the reference's 3% bound, which
    is recorded, not enforced); health_snapshot before and after
    resilience.reset();
  * the beacon-node API at V = 131,072 (an object state one slot before
    the end of its epoch, BLS on "torch"): duties of 16 validators equal
    get_committee_assignment; produce_block with a host-signed randao
    reveal, the block signed on the host; the block with its signature
    swapped for the reveal rejected with ApiError 400 and the head
    unchanged; publish_block of the signed block, its state root equal to
    the same block through ResidentCore; an attestation produced and
    queued; /metrics and /healthz carry the resilience counters. From
    produce_block on, install_bulk_state_root puts the state roots of
    produce and publish on the card (sha256_pairs launches), removed at the
    phase's end.

Then slice 8, mainnet preset, each path with the launch counts at 0 just
before it and read just after:

  * epoch bridge: process_epoch_soa (models/phase0/epoch_soa.py) on an
    object state of 131,072 validators at the last slot of epoch 2 with
    both epochs' attestations pending, BLS off, the bulk state root
    installed: its distill / perm / device / writeback timings and the
    state root; the root must equal the same call through the plain pair
    hash (no kernel launch), and at 2,048 validators the bridge must equal
    the unpatched object model's process_epoch byte for byte;
  * chunk tree: bulk.build_chunk_tree over 2**20 random chunks on the
    card, an update of 64 rows, an append that crosses 2**20; every root
    equal to merkleize_chunk_array (hashlib) and to the plain pair hash's
    handle; the merkle.forest.* counter deltas;
  * phase 1: Phase1Spec at 131,072 validators (epoch 2,049, every
    validator past its first custody period), BLS on "torch", the bulk
    root installed: a block carrying a custody key reveal and an early
    derived secret reveal (signed on the host), a reveal with another
    validator's signature rejected, the epoch boundary through
    process_epoch_soa's staged route, a block in the new epoch; the final
    root equal to the same blocks replayed through the plain pair hash;
    at 2,048 validators a boundary where @process_challenge_deadlines
    slashes between the two device stages equals Phase1Spec.process_epoch;
  * light client on phase 1's final state: build_validator_memory,
    compute_committee == get_persistent_committee, prove_period_data /
    verify_period_data against the bulk root (a forged seed rejected), a
    BlockValidityProof verified through spec.bls on the card and the same
    proof with another message's signature rejected.

Slice 9, each path with the counts at 0 just before it and read just after:

  * bls oracle (after the BLS phases): TorchBackend on the card against
    the port's own bignum PythonBackend ("python") on the host: a single
    verify, an aggregate verify of 4 keys (each side aggregating), a
    swapped signature; verdicts equal, each side's ms;
  * mesh (after phase resilience, on the resume drive's 1M state bytes):
    ResidentCore.from_checkpoint(..., mesh=ServingMesh([cuda] * 4)) driven
    over the same 8 slots across the 2 -> 3 boundary, every root equal to
    the single-device drive's; the boundary's cross-shard steps fenced and
    clocked; the drive again after a `mesh=lose:2` schedule re-planned
    the mesh to 2 shards; a raise x3 at mesh.epoch walks the ladder to
    single_device with the roots still equal; the grouped pairing of 8
    groups x 2 pairs split over the 4 shards equal to the single-device
    verdicts, one swapped group False in both. With more than one card
    visible, the drive also runs over the distinct cards. Shards on one
    card are separate tensors: the code a host with several cards runs,
    less the peer-to-peer copies; no multi-GPU speed is claimed.

Then the attestation firehose (consensus_specs_tpu_torch.streaming) at the
reference's steady-state shape, 128 groups x 3 pairs a batch, a verdict
ring of 1,024, the port's stage_example_groups(8) tiled as traffic: the
warm wave's verdicts must equal the synchronous _grouped_pairing_dispatch,
one 128 x 3 batch from stage_group_arrays (a padded tail, one group's
signature swapped) must give bit-identical Fq12 limbs through the kernels
and through the plain functions on the card, every verdict True, 4 waves with a pump after each and one flush (no host
synchronization while the waves are dispatched: torch.cuda's sync debug
mode "error", and none in their torch.profiler range), occupancy >= 128,
0 deadline misses under a 2,000 ms flush budget, 0 retrace and 0
re-layout watchdog events, the ring's data_ptr constant, and a wave with
one group's signature swapped must read False at that key only.

The block drive also carries two gossip slots: the slot's attestations
published as SSZ through the port's GossipRouter to a StreamingVerifier
(a duplicate publish reaches no subscriber), pumped and flushed, then the
block carrying them with spec._streaming_verifier set: 16 cache hits, 0
new pipeline launches, and the post-state root equal to the same block
run synchronously from its pre-state's checkpoint bytes; a gossip
attestation with a swapped signature must read False and its block be
rejected in process_attestations_batched.

Then fork choice at V = 1,000,000: a Store over a forked DAG of 96
blocks, seeded latest messages; lmd_ghost (get_head's vote sum and head
walk) on the card must equal the CPU path.

Last, slice 10, the conformance vectors (consensus_specs_tpu_torch.
generators), "phase vectors": every family of suites.all_creators()
emitted at the mainnet preset through run_generator with --device cuda
--accel and BLS on the "torch" backend, in VECTORS_WORKERS worker
processes, each file reloaded as YAML with the suite header; the 10
signature-bearing corpus rows of tests/test_bls_corpus_jax.py at minimal,
"torch" on the card equal to the bignum "python" dict for dict; every
vector of the BLS family re-derived on the card (TorchBackend and
hash_to_g2_batch); every table family at minimal with BLS off, the card
route equal to the host route (--device cpu, no bulk root) byte for
byte. The fq_mont kernels carry the phase; its states (512 validators)
have no Merkle level big enough for the bulk root's device route, so it
launches no sha256_pairs.

Then slice 11, each phase with the counts at 0 just before it and read
just after:

  * deposit: a mainnet genesis through the deposit contract
    (consensus_specs_tpu_torch.deposit_contract), 65,536 full deposits
    made from the seed: DepositContract.deposit one at a time (the
    Eth2Genesis event fires on the 65,536th exactly), the native C++ tree
    (csrc/deposit_tree.cpp, built with g++) in one batch, and the card:
    the 65,536 leaves recomputed there over the contract's fixed chunk
    shapes (every message 64 bytes: sha256_pairs launches) equal the
    host's deposit_data_root, and their tree (16 levels on the card, then
    the zero subtrees to depth 32) gives the contract's root, as does the
    native tree; sha256_many on the card equals hashlib at lengths 1, 55,
    56, 64, 65 and 200;
  * networking (consensus_specs_tpu_torch.networking): a NodeRecord
    signed and verified through TorchBackend on the card (True, False
    after seq += 1, False with another record's signature; fq_mont
    launches), then an RPC loopback pair whose server answers from the
    spec-block drive's chain at V = 131,072: hello (should_disconnect:
    same network stays, another drops), beacon_block_roots over the
    drive's slots, beacon_block_headers and beacon_block_bodies in the
    mainnet types; every decoded body's hash_tree_root equals its
    header's body_root, and a garbage wire comes back PARSE_ERROR.

The point kernels (csrc/fq_points.cu, ops/fq_points.py), in `phase
kernel`: the G2 ladder (g2_ladder_kernel: hash-to-G2's cofactor multiply
and a signature's 256-bit multiply, one launch each, the table, every
window, the correction and the inversion) at 16 and 128 lanes on the
cofactor and at 1 lane on a 256-bit scalar, and the grouped Miller loop
(miller_grouped_kernel, one launch a grouped pairing) at 16 x 2 and
128 x 3, each bit-identical (torch.equal on the limbs and flags) to its
plain twin, the same program run through torch's plain functions on the
card, lane 0 of each ladder also equal to the bignum oracle; each with
its ms, its plain twin's, its bound and block 0's cycles per bundle. On
the main path every verify's grouped pairing is one miller_grouped launch
and its message batch one g2_ladder launch (the stage lines count them:
stage 3 and the Miller loop launch no fq_mul or fq_bilinear), and
pairing_routes holds the kernel route against the Python loop over the
plain functions on the block's and the firehose's inputs. `phase bls
sign` times TorchBackend.sign (the host's hash_to_g2, then one ladder
launch), its signature equal to the bignum oracle's.

The point programs of the final exponentiation and the addition trees
(ops/fq_points.py: final_exp_program, tree_program), in `phase kernel`:
each on both point kernels (g2_ladder_kernel's 16-thread multiplies,
miller_grouped_kernel's thread an item) and through the path's wrappers
bit-identical to its plain twin, at the main path's shapes (the final
exponentiation at 128 x 3 and 16 x 2, the G1 tree of a block's 16
committees padded to 1,024 and G2 trees of 4 and 64), lane 0
against the bignum oracle (the final power, two pairing verdicts, each
tree's row-0 sum); each with its ms, its plain twin's, its bound, its
bundles and block 0's cycles a bundle. On the main path every grouped
pairing is a miller_grouped launch and a final_exp launch (a firehose
batch at most FIREHOSE_MAX_LAUNCHES launches), and a verify's stage 1
makes at most STAGE1_MAX_LAUNCHES launches, its trees point_tree launches.

Kernel times: at 1,048,576 lanes beside each kernel's bound, and at the
lane count the verify launches most, beside an empty kernel's launch on
the same stream (per eager call, host included, and per launch replayed
from a CUDA graph, device only).

Prints one line per phase, the card's name and power limit, a JSON line of
kernel numbers (launches on the spec path, and by path), and last
{"ok": true, "device": {...}}. Any failure raises
and exits non-zero. Needs one CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import copy
import functools
import hashlib
import importlib
import json
import multiprocessing
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch
import yaml

from consensus_specs_tpu_torch import convert, resilience, streaming, telemetry
from consensus_specs_tpu_torch.api import ApiError, BeaconNodeAPI
from consensus_specs_tpu_torch.api import beacon_node as api_mod
from consensus_specs_tpu_torch.crypto import bls12_381 as bls_host
from consensus_specs_tpu_torch.light_client import sync_protocol as light_client
from consensus_specs_tpu_torch.models import phase0, phase1
from consensus_specs_tpu_torch.models.phase0 import epoch_soa, fork_choice
from consensus_specs_tpu_torch.models.phase0 import helpers as spec_helpers
from consensus_specs_tpu_torch.models.phase0.resident import (ResidentColumns,
                                                             ResidentCore)
from consensus_specs_tpu_torch.ops import _nvcc, sha256, sha256_cuda
from consensus_specs_tpu_torch.ops import bls_torch, fq_cuda, fq_points, fq_tower
from consensus_specs_tpu_torch.ops import scalar_mul as scalar_mul_mod
from consensus_specs_tpu_torch.ops import decompress as decomp_mod
from consensus_specs_tpu_torch.ops import fq as fq_mod
from consensus_specs_tpu_torch.ops import shuffle as shuffle_mod
from consensus_specs_tpu_torch.utils.config import load_preset
from consensus_specs_tpu_torch.parallel.sharding import ServingMesh
from consensus_specs_tpu_torch.networking.gossip import (GossipRouter,
                                                         TOPIC_BEACON_ATTESTATION)
from consensus_specs_tpu_torch import networking
from consensus_specs_tpu_torch.networking import identity, messaging, rpc
from consensus_specs_tpu_torch.deposit_contract import contract as deposit_contract
from consensus_specs_tpu_torch.deposit_contract import native as deposit_native
from consensus_specs_tpu_torch.utils.hash import zerohashes
from consensus_specs_tpu_torch.utils.ssz import bulk as ssz_bulk
from consensus_specs_tpu_torch.utils.ssz import impl as ssz_impl
from consensus_specs_tpu_torch.resilience import faults, integrity
from consensus_specs_tpu_torch.utils.ssz.columns import state_bytes_from_columns

V_MAIN = 1_000_000
V_HASHLIB = 2_048
DIRTY_PER_SLOT = 1_024
SLOTS_BEFORE, SLOTS_AFTER = 4, 2
KERNEL_LANES = 1 << 20
RAGGED = (1, 5, 300)
BILINEAR_CHECK = 1 << 16
SEED = 20260801
DEVICE = "cuda"
# the spec path (mainnet preset at full width)
V_RESUME = 1_000_000        # BASELINE.json config 5
V_BLOCKS = 131_072          # the smallest mainnet registry with 16 committees of 128 a slot
V_REFERENCE = 2_048         # the object model's size for the reference drive
RESUME_BEFORE, RESUME_AFTER = 4, 4    # slots before / after the epoch boundary
N_SPEC_BLOCKS = 4           # attestation blocks of the block drive
N_REFERENCE_BLOCKS = 12

# H100 SXM peaks: HBM 3.35 TB/s (NVIDIA data sheet); 32-bit integer
# add, logic and shift, and 32-bit integer multiply-add, at 64 per clock
# per SM for compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), over 132 SMs at the 1.98 GHz
# maximum SM clock = 16.7 T ops/s per pipe.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# the firehose (streaming verifier) at the reference's committed
# steady-state shape: G = 128 groups x P = 3 pairs, a ring of 1,024
FIREHOSE_G = 128
FIREHOSE_RING = 1024
FIREHOSE_WAVES = 4
FIREHOSE_DISTINCT = 8       # signed groups, tiled (device work value-independent)
FIREHOSE_BAD_KEY = 37       # the group whose signature is swapped
FIREHOSE_PAD = 3            # padded groups of the kernel-vs-plain batch
# the flush budget: the attestation deadline, a third of a 6 s slot
FIREHOSE_DEADLINE_MS = 2000.0
# fork choice: latest messages of 1M validators over a forked block DAG
V_FORK_CHOICE = 1_000_000
FORK_CHOICE_BLOCKS = 96
FORK_CHOICE_REPS = 20

# slice 8: the epoch bridges, the chunk tree, phase 1 and the light client
CHUNK_TREE_N = 1 << 20      # chunks of the tree handle
CHUNK_TREE_DIRTY = 64       # rows of its update
CHUNK_TREE_APPEND = 1_000   # rows of its append (crosses 2**20)
LIGHT_CLIENT_SHARD = 3
CHECK_ATT_SLOTS = 2         # attested slots an epoch in the object-model checks

# slice 9: the serving mesh and the bignum oracle
MESH_SHARDS = 4             # shards of the mesh on one card
MESH_GROUPS = 8             # groups of the sharded grouped pairing (2 pairs each)
MESH_BAD_GROUP = 5          # the group whose key is swapped

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
               "fq_bilinear": fq_cuda.bilinear_counter,
               "fq_bilinear_chain": fq_cuda.chain_counter,
               "g2_ladder": fq_points.ladder_counter,
               "miller_grouped": fq_points.miller_counter,
               "final_exp": fq_points.final_exp_counter,
               "point_tree": fq_points.tree_counter}


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


# the launches of every pairing: the Miller loop's and the final
# exponentiation's programs
PAIRING_PATH = ("miller_grouped", "final_exp")
# and of every decompression on the card (a block's verify, an aggregate):
# the lift, curve check and sign by fq_mul, the G2 ones by fq_bilinear too,
# the square roots and the G2 inversion chains, the addition trees programs
DECOMPRESS_PATH = ("fq_mul", "fq_bilinear", "fq_bilinear_chain", "point_tree")
BLS_PATH = PAIRING_PATH + DECOMPRESS_PATH


def programs(launches) -> str:
    """The point programs' launch counts, for a phase line."""
    return " / ".join(f"{k} {launches.get(k, 0)}" for k in
                      ("miller_grouped", "final_exp", "point_tree"))


def launched_path(launches, decompress: bool = True) -> bool:
    """Whether a path launched every kernel of its pairings and, where it
    decompresses on the card, of its decompressions."""
    return min(launches[k] for k in (BLS_PATH if decompress else PAIRING_PATH)) > 0


def fq_launches():
    return {name: c.launches for name, c in FQ_COUNTERS.items()}


def fq_lanes():
    """Launches by lanes per launch ("table:lanes" for fq_bilinear,
    "steps:lanes" for fq_bilinear_chain, "groups:pairs" for
    miller_grouped)."""
    return {name: {(k if isinstance(k, int) else f"{k[0]}:{k[1]}"): v
                   for k, v in c.lanes.items()}
            for name, c in FQ_COUNTERS.items()}


def zero_fq_counters():
    for c in FQ_COUNTERS.values():
        c.reset()


def sass_counts(lib: Path) -> dict:
    """{kernel: Counter of SASS opcodes} of a built library, read with
    cuobjdump -sass; {} where the toolkit has no cuobjdump. Static counts:
    the arithmetic of a row (carry rounds, schoolbook, REDC) and the
    compiled tables' pre-sums and gamma sums are unrolled, the staging and
    a chain's step loop are not."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?(fq_mul|fq_redc|fq_chain|g2_ladder|miller_grouped)"
                      r"_kernel", line)
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


CHAIN_LANES = RAGGED + (16, FIREHOSE_G)
G1_SQRT_LANES = 16 * 1024   # stage 1's public keys: 16 committees, each padded to 1,024
POW_BITS = {68: bls_torch._Z_BITS, 69: bls_torch._ZP1_BITS}   # by steps
# the fixed-exponent powers, one chain each: label -> (program, accumulator
# coefficients, exponent)
POWERS = {"fq inv": (fq_mod.fq_pow_program(fq_mod._INV_EXP_BITS), 1, fq_mod.Q - 2),
          "fq sqrt": (fq_mod.fq_pow_program(fq_mod._SQRT_EXP_BITS), 1, (fq_mod.Q + 1) // 4),
          "fq2 sqrt": (fq_tower.fq2_pow_program(decomp_mod._SQRT2_EXP_BITS), 2,
                       (fq_mod.Q ** 2 + 7) // 16)}
POWER_STEPS = {len(prog): label for label, (prog, _, _) in POWERS.items()}


def chain_kind(steps: int) -> str:
    """What a chain of `steps` steps on the main path is: "pow_abs", one
    of POWERS' labels, or "miller" (the f-update's 2-4 steps)."""
    return "pow_abs" if steps in POW_BITS else POWER_STEPS.get(steps, "miller")


def chain_program_of(steps: int, pairs: int):
    """The main path's chain of `steps` steps in a pairing of `pairs`
    pairs: a pow_abs exponentiation (68 or 69 steps), a fixed-exponent
    power (POWERS), else the Miller doubling (pairs + 1) or addition
    (pairs) step."""
    if steps in POW_BITS:
        return fq_tower.pow_abs_program(POW_BITS[steps])
    if steps in POWER_STEPS:
        return POWERS[POWER_STEPS[steps]][0]
    return fq_tower.lines_program(pairs, steps == pairs + 1)


def fq12_value(limbs) -> bls_host.Fq12:
    """[12, 14] or [2, 3, 2, 14] Montgomery limbs -> the bignum Fq12."""
    a = np.asarray(limbs).reshape(2, 3, 2, 14)
    return bls_host.Fq12(*(bls_host.Fq6(*(fq_tower.fq2_from_limbs(a[h, c]) for c in range(3)))
                           for h in range(2)))


def fq12_limbs(x: bls_host.Fq12) -> np.ndarray:
    return np.stack([np.stack([fq_tower.fq2_to_limbs(c) for c in (h.c0, h.c1, h.c2)])
                     for h in (x.c0, x.c1)]).reshape(12, 14)


@functools.lru_cache(maxsize=1)
def cyclotomic_limbs(seed: int = SEED) -> np.ndarray:
    """A random element of the cyclotomic subgroup (the easy part
    f^((q^6-1)(q^2+1)) of a seeded f, in the bignum field), as limbs:
    pow_abs's squarings are squarings only there."""
    rng = np.random.default_rng(seed)
    f = fq12_value(np.stack([fq_mod.to_mont(int(v)) for v in
                             rng.integers(0, 1 << 62, 12)]))
    f1 = f.conj() * f.inv()
    return fq12_limbs((f1 ** (fq_mod.Q ** 2)) * f1)


def chain_args(rng, steps, pairs, n, dev):
    """(acc, program, base, operand) of that chain at n lanes, inputs at
    the multiply budget's edges: the exponentiation's base is its
    accumulator (f; lane 0 a cyclotomic element), the Miller step's
    operand its [n, P, 6, 14] lines; an Fq power's accumulator is a, an
    Fq2 power's one with a as the base."""
    prog = chain_program_of(steps, pairs)
    if steps in POWER_STEPS:
        _, ca, _ = POWERS[POWER_STEPS[steps]]
        a = torch.from_numpy(fq_kernel_inputs(rng, n, "mul", (ca,))).to(dev)
        if ca == 1:
            return a, prog, None, None
        return fq_tower.fq2_ones((n,), dev), prog, a, None
    acc = fq_kernel_inputs(rng, n, "mul", (12,))
    if steps in POW_BITS:
        acc[0] = cyclotomic_limbs()
        acc = torch.from_numpy(acc).to(dev)
        return acc, prog, acc, None
    acc = torch.from_numpy(acc).to(dev)
    lines = torch.from_numpy(fq_kernel_inputs(rng, n, "mul", (pairs, 6))).to(dev)
    return acc, prog, None, lines


def oracle_lane0(label, steps, acc, base, op):
    """The chain's function on lane 0 in the bignum field (crypto/
    bls12_381.py), as a value to compare: a^e for the powers, f^e for
    pow_abs, (f^2) * l_0 * ... * l_{P-1} for the Miller steps."""
    a0 = lambda t: t[0].cpu().numpy()  # noqa: E731
    if label in POWERS:
        _, ca, e = POWERS[label]
        if ca == 1:
            return pow(fq_mod.from_mont(a0(acc)[0]), e, fq_mod.Q)
        return fq_tower.fq2_from_limbs(a0(base)) ** e
    f = fq12_value(a0(acc))
    if steps in POW_BITS:
        return f ** int("".join(map(str, POW_BITS[steps])), 2)
    out = f * f if label.startswith("Miller doubling") else f
    lines = a0(op)
    zero = bls_host.Fq2(0, 0)
    for p in range(lines.shape[0]):
        c_a, c_v, c_vw = (fq_tower.fq2_from_limbs(lines[p, 2 * j:2 * j + 2]) for j in range(3))
        out = out * bls_host.Fq12(bls_host.Fq6(c_a, c_v, zero), bls_host.Fq6(zero, c_vw, zero))
    return out


def value_lane0(label, out):
    """Lane 0 of a chain's output as oracle_lane0's kind of value."""
    v = out[0].cpu().numpy()
    if label in POWERS:
        return fq_mod.from_mont(v[0]) if POWERS[label][1] == 1 else fq_tower.fq2_from_limbs(v)
    return fq12_value(v)


# every chain of the main path: (steps, pairs); the powers at CHAIN_LANES
# and at the lane counts of their own paths
CHAINS = {"pow_abs |z|": (68, 3), "pow_abs |z|+1": (69, 3),
          "Miller doubling P=3": (4, 3), "Miller addition P=3": (3, 3),
          "Miller doubling P=2": (3, 2), "Miller addition P=2": (2, 2),
          **{label: (len(prog), 3) for label, (prog, _, _) in POWERS.items()}}
PATH_LANES = {"fq sqrt": (G1_SQRT_LANES,)}
TIMED = [(label, FIREHOSE_G) for label in CHAINS] + [("fq sqrt", G1_SQRT_LANES)]


def chain_bound(prog, base, operand, lanes):
    return fq_cuda.chain_bound_ms(
        prog, fq_tower.TABLES, lanes, INT32_OPS_PER_S, HBM_BYTES_PER_S,
        Cb=0 if base is None else base.shape[-2],
        S=0 if operand is None else operand.shape[-3],
        Cs=0 if operand is None else operand.shape[-2])


def check_chains(rng, dev):
    """fq_bilinear_chain kernel vs the plain chain, vs the same products
    launched one at a time on the card (fq_bilinear_cuda, fq_mul_cuda and
    the tower's fq2_sqr over it), bit-identical, and lane 0 vs the bignum
    field (crypto/bls12_381.py), for every chain of the main path (pow_abs,
    the Miller f-updates, the Fq inversion and square root, the Fq2 square
    root) at CHAIN_LANES lanes and the powers at their paths' lanes; then
    each chain's kernel, per-product and plain ms beside its bound and
    the launcher's shape, at the firehose's 128 lanes (the stage-1 square
    root also at its 16,384), and block 0's clock cycles per phase of each
    step (A pre-sums or a norm / store / load, B leaves or schoolbooks, C
    gamma sums, D REDCs), summed by step kind and scaled to the chain's
    measured time: clocked once right after the plain chain's torch
    kernels ran ("cold") and once right after that ("warm", reported by
    kind). Returns {"max_abs_err": 0, "chains": {label: numbers}}."""
    tables = fq_tower.TABLES
    errs, checked = [], collections.defaultdict(list)
    for label, (steps, pairs) in CHAINS.items():
        for n in CHAIN_LANES + PATH_LANES.get(label, ()):
            acc, prog, base, op = chain_args(rng, steps, pairs, n, dev)
            got = fq_cuda.fq_bilinear_chain_cuda(acc, prog, tables, base, op)
            errs.append(_same(got, fq_mod.fq_bilinear_chain_plain(acc, prog, tables, base, op),
                              f"chain {label} N={n}"))
            _same(got, fq_mod.chain_by_products(fq_cuda.fq_bilinear_cuda, acc, prog, tables,
                                                base, op, mul=fq_cuda.fq_mul_cuda),
                  f"chain {label} N={n} vs the products launched one at a time")
            if value_lane0(label, got) != oracle_lane0(label, steps, acc, base, op):
                raise AssertionError(f"chain {label} N={n}: lane 0 != the bignum field's")
            checked[label].append(n)
            del acc, base, op, got
    rows = {}
    for label, n in TIMED:
        steps, pairs = CHAINS[label]
        acc, prog, base, op = chain_args(rng, steps, pairs, n, dev)
        reps = max(2, min(20, 4000 // steps))
        row = {"steps": steps, "lanes": n, "checked_lanes": checked[label],
               "ms": time_cuda(lambda: fq_cuda.fq_bilinear_chain_cuda(
                   acc, prog, tables, base, op), reps),
               "per_product_ms": time_cuda(lambda: fq_mod.chain_by_products(
                   fq_cuda.fq_bilinear_cuda, acc, prog, tables, base, op,
                   mul=fq_cuda.fq_mul_cuda), 2 if steps > 100 else 5),
               "plain_ms": time_cuda(lambda: fq_mod.fq_bilinear_chain_plain(
                   acc, prog, tables, base, op), 1),
               "shape": fq_cuda.chain_launch_shape(acc, prog, tables, base, op)}
        row["bound_ms"], row["bound_by"] = chain_bound(prog, base, op, n)
        cold = fq_cuda.chain_phase_clocks(acc, prog, tables, base, op)
        cycles = fq_cuda.chain_phase_clocks(acc, prog, tables, base, op)
        row["first_step_cycles"] = {"cold": cold[0].tolist(), "warm": cycles[0].tolist()}
        us_per_cycle = row["ms"] * 1e3 / max(int(cycles.sum()), 1)
        phases = {}
        for code, cyc in zip(prog, cycles):
            ph = phases.setdefault(fq_tower.step_name(code), {"steps": 0, "cycles": np.zeros(4, np.int64)})
            ph["steps"] += 1
            ph["cycles"] += cyc
        row["phases"] = {name: {"steps": ph["steps"],
                                "cycles_per_step": (ph["cycles"] / ph["steps"]).tolist(),
                                "us_per_step": (ph["cycles"] / ph["steps"]
                                                * us_per_cycle).tolist()}
                         for name, ph in phases.items()}
        rows[label if n == FIREHOSE_G else f"{label} {n}"] = row
        del acc, base, op
        torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "chains": rows}


# the point kernels' shapes on the main path: the cofactor ladder of a block
# verify (16 .. 32 messages) and of a firehose-sized batch, a signature's
# 256-bit ladder; the grouped Miller loop of a block (16 x 2) and of a
# firehose batch (128 x 3)
LADDER_CASES = {"cofactor 16": (16, "cofactor"), "cofactor 128": (FIREHOSE_G, "cofactor"),
                "sign 256-bit 1": (1, "sign")}
MILLER_CASES = {"16 x 2": (16, 2), "128 x 3": (FIREHOSE_G, 3)}


# PR 12's times of the point kernels at these shapes, ms ("NVIDIA H100
# 80GB HBM3, 700.00 W", runs 12.1 / 12.2 of PERF.md section 6): the first
# version of the interpreter, printed beside this run's
PR12_MS = {("g2_ladder", "cofactor 16"): (25.5147, 25.5123),
           ("g2_ladder", "cofactor 128"): (26.2645, 26.3028),
           ("g2_ladder", "sign 256-bit 1"): (13.5664, 13.5518),
           ("miller_grouped", "16 x 2"): (2.9886, 2.9923),
           ("miller_grouped", "128 x 3"): (3.4638, 3.4521)}
BUNDLE_CLASSES = ("linear only", "multiplies only", "with tower products", "with a phase E",
                  "runs")


def bundle_split(prog, cycles, phases):
    """The clocked records of one launch (fq_points.bundle_clocks: a
    bundle, or a run record of small bundles) by what they hold: bundles
    of linear ops only, of multiplies without tower products, with tower
    products, (across the last two) product bundles that also run a phase
    E, and run records (counted by their bundles) -> {class: {bundles,
    mean_cycles a bundle, share, phases: {phase: mean cycles a bundle}}}
    (phases: fq_points.PHASES; a run is all phase B), and "runs" also
    {records, multiplies, cycles_a_multiply}."""
    r = prog.records                 # linear A, multiplies, products, linear E, run bundles
    run = r[:, 4] > 0
    products = (r[:, 1] + r[:, 2]) > 0
    weight = np.where(run, r[:, 4], 1)
    members = {"linear only": ~run & ~products,
               "multiplies only": ~run & (r[:, 1] > 0) & (r[:, 2] == 0),
               "with tower products": r[:, 2] > 0,
               "with a phase E": products & ~run & (r[:, 3] > 0),
               "runs": run}
    total = max(int(cycles.sum()), 1)
    out = {}
    for c, m in members.items():
        n = int(weight[m].sum())
        out[c] = {"bundles": n, "mean_cycles": float(cycles[m].sum()) / n if n else 0.0,
                  "share": float(cycles[m].sum()) / total,
                  "phases": {ph: float(phases[m, j].sum()) / n if n else 0.0
                             for j, ph in enumerate(fq_points.PHASES)}}
    muls = int(r[run, 1].sum())
    out["runs"].update({"records": int(run.sum()), "multiplies": muls,
                        "cycles_a_multiply": float(cycles[run].sum()) / muls if muls else 0.0})
    return out


def point_launch(prog, lanes):
    """The launch's shape (fq_points.launch_shape on this card's SMs):
    lanes a block, threads, shared bytes a block and a lane (the ring
    included), the ring's bytes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile, threads, nbytes, ring = fq_points.launch_shape(prog, lanes, sms)
    return {"lanes_a_block": tile, "threads": threads, "smem_block": nbytes,
            "smem_lane": nbytes / tile, "ring_bytes": ring}


def check_point_kernels(rng, dev):
    """The ladder kernel (g2_ladder_kernel) and the grouped Miller kernel
    (miller_grouped_kernel) vs their plain twins (fq_points.g2_ladder_plain
    / miller_grouped_plain, the same program through torch's plain
    functions on the card), torch.equal on the limbs and flags, at the
    main path's shapes (LADDER_CASES, MILLER_CASES); lane 0 of each ladder
    case also against the bignum oracle. Then each kernel's ms beside its
    plain twin's and its bound, and block 0's cycles per bundle, split by
    what the bundles hold. Returns {"ladder": {case: numbers}, "miller":
    {case: numbers}}."""
    out = {"ladder": {}, "miller": {}}
    seed = int(rng.integers(1 << 30))
    for label, (n, what) in LADDER_CASES.items():
        if what == "cofactor":
            msgs = [(int(seed + j).to_bytes(32, "big"), BLS_DOMAIN) for j in range(n)]
            pts = [bls_host.hash_to_g2_candidate(m, d) for m, d in msgs]
            k, nbits = bls_host.G2_COFACTOR, bls_torch._G2_COFACTOR_NBITS
            oracle = bls_host.hash_to_g2(*msgs[0])
        else:
            pts = [bls_host.hash_to_g2(seed.to_bytes(32, "big"), BLS_DOMAIN)]
            k, nbits = int(seed * 0x9E3779B97F4A7C15 + 1) % bls_host.r, 256
            oracle = bls_host.ec_mul(pts[0], k)
        arr = np.stack([bls_torch.g2_to_limbs(p) for p in pts])
        x = torch.from_numpy(arr[:, 0]).to(dev)
        y = torch.from_numpy(arr[:, 1]).to(dev)
        rec = scalar_mul_mod.recode_signed_windows(k, nbits, bls_torch.SCALAR_WINDOW)
        prog = fq_points.ladder_program(nbits, bls_torch.SCALAR_WINDOW)
        got = fq_points.g2_ladder_cuda(x, y, None, rec)
        want, plain_ms = fenced_ms(lambda: fq_points.g2_ladder_plain(x, y, None, rec))
        for g, w, what_ in zip(got, want, ("x", "y", "is_inf")):
            _same(g.long(), w.long(), f"g2_ladder {label} {what_}")
        x0, y0 = got[0][0].cpu().numpy(), got[1][0].cpu().numpy()
        if bool(got[2][0]) or (fq_tower.fq2_from_limbs(x0), fq_tower.fq2_from_limbs(y0)) != oracle:
            raise AssertionError(f"g2_ladder {label}: lane 0 != the bignum oracle")
        row = {"lanes": n, "bits": nbits, "max_abs_err": 0, "plain_ms": plain_ms,
               "ms": time_cuda(lambda: fq_points.g2_ladder_cuda(x, y, None, rec), 5),
               "program": prog.describe()}
        row["bound_ms"], row["bound_by"] = fq_points.bound_ms(prog, n, INT32_OPS_PER_S,
                                                              HBM_BYTES_PER_S)
        cycles, phases = fq_points.bundle_clocks(
            lambda st: fq_points.g2_ladder_cuda(x, y, None, rec, stamps=st), prog, dev)
        row["bundle_cycles"] = bundle_split(prog, cycles, phases)
        row["us_per_bundle"] = row["ms"] * 1e3 / prog.n_bundles
        row["launch"] = point_launch(prog, n)
        row["pr12_ms"] = PR12_MS[("g2_ladder", label)]
        out["ladder"][label] = row
    g1d, g2d = [], []
    for j in range(8):
        g1d.append(bls_torch.g1_to_limbs(bls_host.ec_mul(bls_host.G1_GEN, seed + 2 * j + 1)))
        g2d.append(bls_torch.g2_to_limbs(bls_host.ec_mul(bls_host.G2_GEN, seed + 2 * j + 2)))
    g1d, g2d = np.stack(g1d), np.stack(g2d)
    for label, (G, P) in MILLER_CASES.items():
        sel = (np.arange(G)[:, None] * P + np.arange(P)[None, :]) % 8
        g1 = torch.from_numpy(g1d[sel]).to(dev)
        g2 = torch.from_numpy(g2d[sel]).to(dev)
        prog = fq_points.miller_program(P)
        got = fq_points.miller_grouped_cuda(g1, g2)
        want, plain_ms = fenced_ms(lambda: fq_points.miller_grouped_plain(g1, g2))
        _same(got, want, f"miller_grouped {label}")
        row = {"groups": G, "pairs": P, "max_abs_err": 0, "plain_ms": plain_ms,
               "ms": time_cuda(lambda: fq_points.miller_grouped_cuda(g1, g2), 10),
               "program": prog.describe()}
        row["bound_ms"], row["bound_by"] = fq_points.bound_ms(prog, G, INT32_OPS_PER_S,
                                                              HBM_BYTES_PER_S)
        cycles, phases = fq_points.bundle_clocks(
            lambda st: fq_points.miller_grouped_cuda(g1, g2, stamps=st), prog, dev)
        row["bundle_cycles"] = bundle_split(prog, cycles, phases)
        row["us_per_bundle"] = row["ms"] * 1e3 / prog.n_bundles
        row["launch"] = point_launch(prog, G)
        row["pr12_ms"] = PR12_MS[("miller_grouped", label)]
        out["miller"][label] = row
    return out


def report_point_kernels(pk) -> None:
    def split(row):
        split_ = row["bundle_cycles"]
        return "; ".join(f"{c} {split_[c]['bundles']} x {split_[c]['mean_cycles']:.0f} cycles"
                         f" ({100 * split_[c]['share']:.1f}%: " + " / ".join(
                             f"{u:.0f}" for u in split_[c]["phases"].values()) + ")"
                         for c in BUNDLE_CLASSES) + (
            f"; the runs: {split_['runs']['records']} records,"
            f" {split_['runs']['multiplies']} multiplies,"
            f" {split_['runs']['cycles_a_multiply']:.0f} cycles a multiply")

    for name, rows in (("g2_ladder", pk["ladder"]), ("miller_grouped", pk["miller"])):
        for label, r in rows.items():
            prog, ln = r["program"], r["launch"]
            log(f"phase kernel: {name} {label} bit-identical to its plain twin (max_abs_err"
                f" {r['max_abs_err']}){' and lane 0 == the bignum oracle' if name == 'g2_ladder' else ''}"
                f" | kernel {r['ms']:.4f} ms (PR 12, runs 12.1 / 12.2:"
                f" {r['pr12_ms'][0]:.4f} / {r['pr12_ms'][1]:.4f} ms), plain twin"
                f" {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']}"
                f" | program: {prog['ops']} ops ({prog['muls']} multiplies,"
                f" {prog['products']} tower products, {prog['linear']} linear of which"
                f" {prog['linear_e']} in phase E) in {prog['bundles']} bundles"
                f" ({prog['product_bundles']} with products, {prog['linear_only']} linear"
                f" only), {prog['registers']} registers, {r['us_per_bundle']:.3f} us a bundle"
                f" | launch: {ln['lanes_a_block']} lane(s) a block, {ln['threads']} threads,"
                f" shared {ln['smem_block']} B a block, {ln['smem_lane']:.0f} B a lane with"
                f" the ring ({ln['ring_bytes']} B, records of <= {prog['record_words_max']}"
                f" words) | block 0's cycles by bundle (" + " / ".join(fq_points.PHASES)
                + f" of each): {split(r)}")


# the point programs of the final exponentiation and the addition trees
# at the main path's shapes: a firehose batch (128 groups of 3 pairs) and a
# block's grouped pairing (16 x 2); the pubkey trees of a block's verify
# (16 committees of 976, padded to 1,024), and aggregate_signatures'
# tree (the oracle phase's 4 signatures; 64 for a tree of two launches)
FINAL_EXP_CASES = {"128 x 3": (FIREHOSE_G, 3), "16 x 2": (16, 2)}
TREE_CASES = {"g1 16 x 1024": ("g1", 16, 1024), "g2 1 x 4": ("g2", 1, 4),
              "g2 1 x 64": ("g2", 1, 64)}
PROGRAM_MODES = ("groups", "threads")
# the launches a firehose batch and the warm verify's stage 1 may make
FIREHOSE_MAX_LAUNCHES = 3
STAGE1_MAX_LAUNCHES = 15


def cancelling_groups(G: int, P: int):
    """(g1, g2) numpy: G groups of P pairs whose pairing product is one,
    every group but group 1, whose signature is group 2's: P = 3 the
    firehose's traffic (stage_example_groups), P = 2 pairing_groups."""
    g1, g2 = (bls_torch.stage_example_groups(G) if P == 3 else pairing_groups(8, G))
    g2[1, 0] = g2[2, 0]
    return g1, g2


def clocked(prog, fn, dev, ms):
    """Block 0's mean cycles a bundle of one launch (fn(stamps) launches
    it; a run record's cycles spread over its bundles), split by what the
    bundles hold (bundle_split), and the launch's us a bundle."""
    cycles, phases = fq_points.bundle_clocks(fn, prog, dev)
    return {"bundles": prog.n_bundles, "records": prog.n_records,
            "cycles_a_bundle": float(cycles.sum()) / max(prog.n_bundles, 1),
            "us_a_bundle": ms * 1e3 / max(prog.n_bundles, 1),
            "split": bundle_split(prog, cycles, phases)}


def tree_points(curve: str, B: int, C: int, dev):
    """(Jacobian points [B, C, 3, (2,) 14] on dev, the bignum affine
    members of row 0): multiples of the generator by 8 seeded scalars,
    cycled, with infinity members (every 37th from 5), member 3 equal to
    member 2 (jac_add's doubling branch) and member 5 the negation of
    member 4 (its infinity branch)."""
    gen = bls_host.G1_GEN if curve == "g1" else bls_host.G2_GEN
    base = [bls_host.ec_mul(gen, SEED % 1000 + 7 * j + 3) for j in range(8)]
    members = [base[j % 8] for j in range(C)]
    if C >= 6:
        members[3] = members[2]
        members[5] = bls_host.ec_neg(members[4])
    inf = np.zeros((B, C), bool)
    inf[:, 5::37] = True
    to_limbs = bls_torch.g1_to_limbs if curve == "g1" else bls_torch.g2_to_limbs
    aff = torch.from_numpy(np.stack([to_limbs(m) for m in members])).to(dev)
    aff = aff[None].expand((B,) + tuple(aff.shape))
    x, y = aff[:, :, 0], aff[:, :, 1]
    if curve == "g1":
        sel, one = fq_mod.fq_select, fq_mod.const(fq_mod._ONE_MONT, dev)
    else:
        sel, one = fq_tower.fq2_select, fq_mod.const(fq_tower._FQ2_ONE_NP, dev)
    jac = bls_torch._jacobian_or_infinity(sel, x, y, torch.from_numpy(inf).to(dev), one)
    pts = torch.stack(jac, dim=2).contiguous()
    return pts, [m for m, i in zip(members, inf[0]) if not i]


def run_on(mode: str, prog, dev, n: int, ins, stamps=None):
    """One launch of a program on the point kernel of `mode` ("groups" or
    "threads", fq_points.ENTRY), whatever kernel the path takes for it ->
    (out rows, out flags or None). A measurement: counted by no wrapper."""
    flags = torch.empty(n, dtype=torch.uint8, device=dev) if prog.out_flag >= 0 else None
    out = fq_points._launch(fq_points.ENTRY[mode], prog, dev, n, ins, out_flags=flags,
                            stamps=stamps)
    return out, None if flags is None else flags.bool()


def check_point_programs(rng, dev):
    """The final exponentiation's program (fq_points.final_exp_program)
    and the addition trees' programs (tree_program, in point_tree_cuda's
    launches) on the point kernels vs
    their plain twins (the same programs through torch's plain functions
    on the card), torch.equal on the limbs and flags, on both kernels
    ("groups": g2_ladder_kernel's 16-thread multiplies, "threads":
    miller_grouped_kernel's thread an item) and through the path's
    wrappers, at FINAL_EXP_CASES and TREE_CASES. Lane 0 against the bignum
    oracle: the final power of f (crypto/bls12_381.py final_exponentiation,
    cubed) at 128 x 3, the pairing verdicts of groups 0 (True) and 1
    (False) at 16 x 2 (multi_pairing_is_one), each tree's row-0 sum
    (ec_add). Then each program's ms on each kernel beside its plain
    twin's and its bound, bundles and block 0's cycles a bundle. Returns
    {"final_exp": {case: numbers}, "tree": {case: numbers}}."""
    out = {"final_exp": {}, "tree": {}}
    for label, (G, P) in FINAL_EXP_CASES.items():
        g1n, g2n = cancelling_groups(G, P)
        g1, g2 = torch.from_numpy(g1n).to(dev), torch.from_numpy(g2n).to(dev)
        f = fq_points.miller_grouped_cuda(g1, g2)
        prog = fq_points.final_exp_program()
        want, plain_ms = fenced_ms(lambda: fq_points.final_exp_plain(f))
        expect = [g != 1 for g in range(G)]
        if want[1].tolist() != expect:
            raise AssertionError(f"final_exp {label}: plain verdicts {want[1].tolist()}")
        got = fq_points.final_exp_cuda(f)
        _same(got[0], want[0], f"final_exp {label}")
        _same(got[1].long(), want[1].long(), f"final_exp {label} verdicts")
        row = {"groups": G, "pairs": P, "max_abs_err": 0, "plain_ms": plain_ms,
               "ms": time_cuda(lambda: fq_points.final_exp_cuda(f), 10),
               "program": prog.describe(), "launch": point_launch(prog, G), "modes": {}}
        rows = f.reshape(G, 12, fq_mod.L)
        for mode in PROGRAM_MODES:
            res, ok = run_on(mode, prog, dev, G, (rows,))
            _same(res, want[0].reshape(G, 12, fq_mod.L), f"final_exp {label} {mode}")
            _same(ok.long(), want[1].long(), f"final_exp {label} {mode} verdicts")
            ms = time_cuda(lambda: run_on(mode, prog, dev, G, (rows,)), 10)
            row["modes"][mode] = {"ms": ms, **clocked(
                prog, lambda st: run_on(mode, prog, dev, G, (rows,), st), dev, ms)}
        row["bound_ms"], row["bound_by"] = fq_points.bound_ms(prog, G, INT32_OPS_PER_S,
                                                              HBM_BYTES_PER_S)
        if label == "128 x 3":
            f0 = fq12_value(f[0].cpu().numpy())
            if fq12_value(want[0][0].cpu().numpy()) != bls_host.final_exponentiation(f0) ** 3:
                raise AssertionError(f"final_exp {label}: lane 0 != the bignum field's")
        else:
            for g in (0, 1):
                pairs = [(host_g1(g1n[g, p]), host_g2(g2n[g, p])) for p in range(P)]
                if bls_host.multi_pairing_is_one(pairs) != expect[g]:
                    raise AssertionError(f"final_exp {label}: group {g} != the bignum oracle")
        out["final_exp"][label] = row
        del f, g1, g2
    for label, (curve, B, C) in TREE_CASES.items():
        pts, members = tree_points(curve, B, C, dev)
        want, plain_ms = fenced_ms(lambda: fq_points.point_tree_plain(curve, pts))
        acc = None
        for m in members:
            acc = bls_host.ec_add(acc, m)
        x0, y0 = want[0][0].cpu().numpy(), want[1][0].cpu().numpy()
        host = (None if bool(want[2][0]) else
                host_g1((x0, y0)) if curve == "g1" else host_g2((x0, y0)))
        if host != acc:
            raise AssertionError(f"point tree {label}: row 0 != the bignum sum")
        plan = fq_points.tree_plan(C.bit_length() - 1)
        launches, lanes, bound = [], B * C, 0.0
        for k, affine in plan:
            lanes >>= k
            prog = fq_points.tree_program(curve, k, affine)
            launches.append({"levels": k, "affine": affine, "lanes": lanes,
                             "mode": fq_points.tree_mode(lanes, dev),
                             "bundles": prog.n_bundles, "registers": prog.nreg})
            bound += fq_points.bound_ms(prog, lanes, INT32_OPS_PER_S, HBM_BYTES_PER_S)[0]
        row = {"curve": curve, "rows": B, "points": C, "max_abs_err": 0,
               "plain_ms": plain_ms, "launches": launches, "bound_ms": bound,
               "bound_by": "operations", "modes": {}}
        for mode in PROGRAM_MODES + ("auto",):
            def tree(mode=mode):
                if mode == "auto":
                    return fq_points.point_tree_cuda(curve, pts)
                return fq_points._point_tree(curve, pts, lambda n, dev: mode)
            for g, w, what in zip(tree(), want, ("x", "y", "is_inf")):
                _same(g.long(), w.long(), f"point tree {label} {mode} {what}")
            row["modes"][mode] = time_cuda(tree, 10)
        row["ms"] = row["modes"]["auto"]
        # the last launch (its levels and jac_to_affine) alone, on points
        # of the input: the program's work does not depend on the values
        aff = fq_points.tree_program(curve, plan[-1][0], True)
        n_aff = launches[-1]["lanes"]
        last = pts.reshape(-1, (1 << plan[-1][0]) * pts[0, 0].numel() // fq_mod.L,
                           fq_mod.L)[:n_aff].contiguous()
        mode = launches[-1]["mode"]
        aff_ms = time_cuda(lambda: run_on(mode, aff, dev, n_aff, (last,)), 10)
        row["affine_launch"] = {"ms": aff_ms, **clocked(
            aff, lambda st: run_on(mode, aff, dev, n_aff, (last,), st), dev, aff_ms)}
        out["tree"][label] = row
        del pts
    return out


def host_g1(limbs):
    return (fq_mod.from_mont(limbs[0]), fq_mod.from_mont(limbs[1]))


def host_g2(limbs):
    return (fq_tower.fq2_from_limbs(limbs[0]), fq_tower.fq2_from_limbs(limbs[1]))


def chain_step_cycles(fq_ch) -> dict:
    """The chain kernel's cycles a step from check_chains' clocks of this
    run (phases A to D summed): an Fq multiply (the Fq inversion's chain)
    and the Fq12 products (pow_abs |z|'s cyclotomic squares and multiplies)
    -> {step name: cycles}; {} where the chains were not clocked."""
    out = {}
    for label in ("fq inv", "pow_abs |z|"):
        for name, ph in fq_ch.get("chains", {}).get(label, {}).get("phases", {}).items():
            if name in ("fq_mul", "fq12_cyclo_sqr", "fq12_mul"):
                out[name] = float(sum(ph["cycles_per_step"]))
    return out


def _phase_split(split, kinds=("multiplies only", "runs", "with tower products")) -> str:
    return "; ".join(f"{k} {split[k]['bundles']} x {split[k]['mean_cycles']:.0f} ("
                     + " / ".join(f"{v:.0f}" for v in split[k]["phases"].values()) + ")"
                     for k in kinds if split[k]["bundles"]) + (
        f"; runs {split['runs']['cycles_a_multiply']:.0f} cycles a multiply"
        if split["runs"]["multiplies"] else "")


def report_point_programs(pp, fq_ch=None) -> None:
    chain = chain_step_cycles(fq_ch or {})
    beside = (" | the chain kernel's steps in this run, cycles: " + ", ".join(
        f"{k} {v:.0f}" for k, v in chain.items())) if chain else ""
    for label, r in pp["final_exp"].items():
        prog = r["program"]
        log(f"phase kernel: final_exp program {label} bit-identical to its plain twin on"
            " both kernels (max_abs_err 0), "
            + ("lane 0 == the bignum field's f^(3 (q^12 - 1) / r)" if label == "128 x 3"
               else "groups 0 / 1 verdicts == the bignum oracle's (True / False)")
            + " | " + ", ".join(f"{m} {v['ms']:.4f} ms ({v['cycles_a_bundle']:.0f} cycles,"
                                f" {v['us_a_bundle']:.3f} us a bundle)"
                                for m, v in r["modes"].items())
            + f"; the path's wrapper ({fq_points.FINAL_EXP_MODE}) {r['ms']:.4f} ms, plain twin"
            f" {r['plain_ms']:.1f} ms, bound"
            f" {r['bound_ms']:.6f} ms by {r['bound_by']} | program: {prog['ops']} ops"
            f" ({prog['muls']} multiplies, {prog['products']} tower products, {prog['linear']}"
            f" linear) in {prog['bundles']} bundles, {prog['records']} records,"
            f" {prog['registers']} registers, shared {r['launch']['smem_block']} B a block")
        for m, v in r["modes"].items():
            log(f"phase kernel: final_exp program {label} on {m}: block 0's cycles a bundle"
                f" by kind (" + " / ".join(fq_points.PHASES) + f"): {_phase_split(v['split'])}"
                + beside)
    for label, r in pp["tree"].items():
        al = r["affine_launch"]
        log(f"phase kernel: point_tree {label} bit-identical to its plain twin on both"
            f" kernels and with the path's choice, row 0 == the bignum sum | ms "
            + ", ".join(f"{m} {v:.4f}" for m, v in r["modes"].items())
            + f", plain twin {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.6f} ms | launches: "
            + "; ".join(f"{x['levels']} levels{' + affine' if x['affine'] else ''} at"
                        f" {x['lanes']} lanes ({x['mode']}, {x['bundles']} bundles,"
                        f" {x['registers']} registers)" for x in r["launches"])
            + f" | the last launch alone {al['ms']:.4f} ms, {al['bundles']} bundles in"
            f" {al['records']} records, block 0 {al['cycles_a_bundle']:.0f} cycles a bundle ("
            + " / ".join(fq_points.PHASES) + f"): {_phase_split(al['split'])}" + beside)


def small_launch_times(lanes_seen, dev, rng, pairs):
    """Each kernel at the lane count the verify launched it with most
    (for fq_bilinear: each table at its own; for fq_bilinear_chain: each
    chain, by its steps, of a pairing of `pairs` pairs), per eager call
    (host and device) and per launch replayed from a CUDA graph (device),
    beside the same two times of an empty kernel. lanes_seen: fq_lanes()
    of the verify. Returns {"empty": {...}, name, table or chain: {...}}."""
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
        out["fq_mul"]["bound_ms"], _ = fq_cuda.bound_ms("fq_mul", n, INT32_OPS_PER_S,
                                                        HBM_BYTES_PER_S)
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
    by_steps = collections.defaultdict(dict)
    for key, count in lanes_seen["fq_bilinear_chain"].items():
        steps, n = map(int, key.split(":"))
        by_steps[steps][n] = count
    for steps, seen in sorted(by_steps.items(), reverse=True):
        n, count = max(seen.items(), key=lambda kv: kv[1])
        acc, prog, base, op = chain_args(rng, steps, pairs, n, dev)
        key = f"chain {steps} steps ({chain_kind(steps)})"
        put(key, n, lambda acc=acc, prog=prog, base=base, op=op:
            fq_cuda.fq_bilinear_chain_cuda(acc, prog, fq_tower.TABLES, base, op), count)
        out[key]["bound_ms"], _ = chain_bound(prog, base, op, n)
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


def pairing_routes(g1, g2, what: str):
    """One grouped pairing (miller_loop_grouped, final_exponentiation_3x)
    of g1 [G,P,2,L] / g2 [G,P,2,2,L] on the card through the kernels
    (fq_tower.DEVICE) and through the plain functions (fq_tower.PLAIN):
    the Miller values and the final powers must be bit-identical. ->
    (kernel route's final powers [G,2,3,2,L], kernel ms, plain ms)."""
    routes, ms = {}, {}
    for name, tower in (("kernel", fq_tower.DEVICE), ("plain", fq_tower.PLAIN)):
        def pair(tower=tower):
            f = bls_torch.miller_loop_grouped(g1, g2, tower)
            return f, bls_torch.final_exponentiation_3x(f, tower)
        routes[name], ms[name] = fenced_ms(pair)
    for k_t, p_t in zip(routes["kernel"], routes["plain"]):
        if not torch.equal(k_t, p_t):
            raise AssertionError(f"{what} grouped pairing: kernel route != plain route")
    return routes["kernel"][1], ms["kernel"], ms["plain"]


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
    if not launched_path(out["launches"]):
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

    # signing: the host's hash_to_g2, then the 256-bit ladder on the card
    msg, key = bytes(range(32)), (SEED * 0x9E3779B97F4A7C15) % bls_host.r
    want = bls_host.sign(msg, key, BLS_DOMAIN)
    tb.sign(msg, key, BLS_DOMAIN)            # the 256-bit program, built once
    sign_ms = []
    for _ in range(3):
        zero_fq_counters()
        sig, ms = fenced_ms(lambda: tb.sign(msg, key, BLS_DOMAIN))
        if sig != want:
            raise AssertionError("TorchBackend.sign != the bignum oracle's signature")
        sign_ms.append(ms)
    out["sign"] = {"ms": sign_ms, "launches": {k: v for k, v in fq_launches().items() if v},
                   "host_hash_ms": fenced_ms(lambda: bls_host.hash_to_g2(msg, BLS_DOMAIN))[1]}
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
    s1 = out["stages"]["stage_pubkeys"]
    out["stage1_launches"] = sum(s1[k] for k in FQ_COUNTERS)
    if out["stage1_launches"] > STAGE1_MAX_LAUNCHES or not s1["point_tree"]:
        raise AssertionError(f"stage 1 made {out['stage1_launches']} launches"
                             f" (at most {STAGE1_MAX_LAUNCHES}, the trees' among them): {s1}")
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
    _, out["pairing_kernel_ms"], out["pairing_plain_ms"] = pairing_routes(
        g1[:n], g2[:n], "block")
    out["pairing_groups_compared"] = n
    out["pairing_trace"] = device_busy(
        lambda: bls_torch.grouped_pairing_check(g1, g2))
    out["shape"] = {"attestations": block.n_att, "committee": block.size,
                    "pubkeys": block.n_att * block.size, "pairs": int(g1.shape[1])}
    return out

# ---------------------------------------------------------------------------
# the firehose: the streaming verifier at its committed steady-state shape
# ---------------------------------------------------------------------------

def tele_count(name: str):
    """An always-on telemetry counter's value."""
    return telemetry.counter(name, always=True).value


SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def syncs_in_ranges(events, labels):
    """{label: n}: the host synchronizations (SYNC_EVENTS) and
    device-to-host copies that start inside each label's range, all on
    the host's timeline. A label's range is its host event (its
    device-side annotation spans its kernels, which may run on into the
    next range). A copy counts at the host op that issued it, the op whose
    kernels list the device-side copy: the copy's own device event starts
    at a device time that the profiler projects onto the host clock, and
    that projection may fall a little before the range that issued it."""
    from torch.autograd import DeviceType
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in events if e.name in labels and e.device_type == DeviceType.CPU}
    syncs = dict.fromkeys(labels, 0)
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in SYNC_EVENTS or any("DtoH" in k.name for k in e.kernels):
            for label, (a, b) in ranges.items():
                if a <= e.time_range.start <= b:
                    syncs[label] += 1
    return syncs


def profile_window(steps):
    """steps: [(label, fn)] run in order under torch.profiler (CPU and CUDA
    activity), each inside a record_function range of its label. Returns
    {wall_ms, device_ms, busy_share, syncs: {label: n}}: syncs counts the
    host synchronizations (stream, device, event) and device-to-host copies
    that start inside each label's range; device_ms sums the device time of
    every kernel and copy on the device timeline (None where the trace
    holds no device time); the wall includes the profiler's overhead."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for label, fn in steps:
            with record_function(label):
                fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType
    labels = [label for label, _ in steps]
    events = prof.events()
    syncs = syncs_in_ranges(events, labels)
    # device events only (kernels, copies): a CPU-side event's device time
    # repeats its kernels', and the labels' own device-side annotation
    # ranges span the kernels they hold
    dev_us = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == DeviceType.CUDA and e.name not in labels)
    return {"wall_ms": wall, "device_ms": dev_us / 1e3 if dev_us > 0 else None,
            "busy_share": dev_us / 1e3 / wall if dev_us > 0 else None,
            "syncs": syncs}


def drive_firehose(dev, rng):
    """The streaming verifier (consensus_specs_tpu_torch.streaming) at the
    reference's steady-state shape, G = 128 groups x P = 3 pairs, ring of
    1,024: the port's stage_example_groups(8) tiled and submitted with
    submit_staged (the reference bench's traffic). One warm wave (verdicts
    == the synchronous _grouped_pairing_dispatch), one padded 128 x 3
    batch through the kernels and the plain functions (bit-identical),
    FIREHOSE_WAVES waves with a pump after each and one flush (timed,
    kernel launches counted, the waves and pumps under torch.cuda's sync
    debug mode "error": any host synchronization raises), the same window
    traced (device-busy share, synchronizations counted per range), then
    a wave with one group's signature swapped. Returns the numbers; raises
    on any failed check."""
    g1d, g2d = bls_torch.stage_example_groups(FIREHOSE_DISTINCT, FIREHOSE_DISTINCT)
    n_distinct, P = g1d.shape[0], g1d.shape[1]

    def pairs_for(k, bad=False):
        i = k % n_distinct
        pairs = [(g1d[i, p], g2d[i, p]) for p in range(P)]
        if bad:      # another group's signature, over another message
            pairs[0] = (g1d[i, 0], g2d[(i + 1) % n_distinct, 0])
        return pairs

    v = streaming.StreamingVerifier(
        device=dev, target_groups=FIREHOSE_G, ring_capacity=FIREHOSE_RING,
        deadline_ms=FIREHOSE_DEADLINE_MS, register=False)
    ring_ptr = v.pipeline.ring.data_ptr()

    def wave(tag, bad_key=None):
        for k in range(FIREHOSE_G):
            v.submit_staged((tag, k), pairs_for(k, bad=k == bad_key))

    def waves(tag):
        for w in range(FIREHOSE_WAVES):
            wave((tag, w))
            v.pump()

    def one_wave(tag, bad_key=None):
        wave(tag, bad_key)
        v.pump()
        return v.flush()

    out = {"groups": FIREHOSE_G, "pairs": P, "ring": FIREHOSE_RING,
           "waves": FIREHOSE_WAVES, "deadline_ms": FIREHOSE_DEADLINE_MS}
    warm, out["warm_ms"] = fenced_ms(lambda: one_wave("warm"))
    if len(warm) != FIREHOSE_G or not all(warm.values()):
        raise AssertionError("firehose: the warm wave did not verify")
    sync_verdicts, out["sync_dispatch_ms"] = fenced_ms(
        lambda: bls_torch._grouped_pairing_dispatch(
            [(("warm", k), pairs_for(k)) for k in range(FIREHOSE_G)], dev))
    if sync_verdicts != warm:
        raise AssertionError("firehose: streamed verdicts != synchronous dispatch")

    # kernel route vs plain route at the firehose's batch shape: one batch
    # from the shared staging point (stage_group_arrays), FIREHOSE_PAD
    # copies of the last group filling the tail up to 128 x 3, the swapped
    # group in it; Fq12 limbs bit-identical, verdicts False there only
    real = FIREHOSE_G - FIREHOSE_PAD
    g1, g2 = bls_torch.stage_group_arrays(
        [(np.stack([a for a, _ in p]), np.stack([b for _, b in p]))
         for p in (pairs_for(k, bad=k == FIREHOSE_BAD_KEY) for k in range(real))], P)
    if g1.shape[:2] != (FIREHOSE_G, P):
        raise AssertionError(f"firehose: staged batch shape {g1.shape}")
    final, out["pairing_kernel_ms"], out["pairing_plain_ms"] = pairing_routes(
        torch.from_numpy(g1).to(dev), torch.from_numpy(g2).to(dev), "firehose")
    ok = fq_tower.DEVICE.fq12_eq(final, fq_tower.fq12_ones((FIREHOSE_G,), final.device))
    if [k for k, b in enumerate(ok.tolist()) if not b] != [FIREHOSE_BAD_KEY]:
        raise AssertionError("firehose: the staged batch's verdicts")
    out["pairing_shape"] = list(g1.shape[:2])

    retrace0 = telemetry.counter("watchdog.retrace_events").value
    relayout0 = telemetry.counter("watchdog.relayout_events").value
    miss0 = tele_count("firehose.deadline_miss")
    occ0, launches0 = len(v.pipeline.occupancies), v.pipeline.launches
    # the steady-state window: the kernels' counts set to 0 just before it
    zero_fq_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        waves("steady")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t1 = time.perf_counter()
    res = v.flush()
    t2 = time.perf_counter()
    out["launches"], out["lanes"] = fq_launches(), fq_lanes()
    batches = v.pipeline.launches - launches0
    groups = FIREHOSE_WAVES * FIREHOSE_G
    if len(res) != groups or not all(res.values()):
        raise AssertionError("firehose: steady-state verdicts")
    occupancies = list(v.pipeline.occupancies)[occ0:]
    out.update(batches=batches, occupancy_min=min(occupancies),
               dispatch_ms=(t1 - t0) * 1e3, flush_ms=(t2 - t1) * 1e3,
               window_ms=(t2 - t0) * 1e3)
    out["ms_per_batch"] = out["window_ms"] / batches
    out["aggverify_per_s"] = groups / (t2 - t0)
    out["pairings_per_s"] = groups * P / (t2 - t0)
    out["per_batch"] = {k: n / batches for k, n in out["launches"].items()}
    by_kind = collections.Counter()
    for key, count in out["lanes"]["fq_bilinear_chain"].items():
        by_kind[chain_kind(int(key.split(":")[0]))] += count
    out["chains_per_batch"] = {k: by_kind[k] / batches for k in by_kind}
    if out["occupancy_min"] < FIREHOSE_G:
        raise AssertionError(f"firehose: occupancy {out['occupancy_min']} < {FIREHOSE_G}")
    if not launched_path(out["launches"], decompress=False):
        raise AssertionError(f"firehose launched {out['launches']}")
    out["launches_per_batch"] = sum(out["per_batch"].values())
    if out["launches_per_batch"] > FIREHOSE_MAX_LAUNCHES:
        raise AssertionError(f"firehose: {out['launches_per_batch']} launches a batch"
                             f" > {FIREHOSE_MAX_LAUNCHES}: {out['per_batch']}")

    # the same window traced: device-busy share, synchronizations per range
    out["trace"] = profile_window([("firehose.waves", lambda: waves("traced")),
                                   ("firehose.flush", v.flush)])
    if out["trace"]["syncs"]["firehose.waves"]:
        raise AssertionError(f"firehose: host synchronizations outside the flush:"
                             f" {out['trace']['syncs']}")

    bad, out["bad_ms"] = fenced_ms(lambda: one_wave("bad", FIREHOSE_BAD_KEY))
    wrong = [k for k, ok in bad.items() if not ok]
    if wrong != [("bad", FIREHOSE_BAD_KEY)] or len(bad) != FIREHOSE_G:
        raise AssertionError(f"firehose: swapped-signature wave read False at {wrong}")
    out["deadline_misses"] = tele_count("firehose.deadline_miss") - miss0
    out["retrace_events"] = telemetry.counter("watchdog.retrace_events").value - retrace0
    out["relayout_events"] = telemetry.counter("watchdog.relayout_events").value - relayout0
    out["ring_ptr_constant"] = v.pipeline.ring.data_ptr() == ring_ptr
    if out["deadline_misses"] or out["retrace_events"] or out["relayout_events"]:
        raise AssertionError(f"firehose: {out['deadline_misses']} deadline misses,"
                             f" {out['retrace_events']} retrace / {out['relayout_events']}"
                             " re-layout events")
    if not out["ring_ptr_constant"]:
        raise AssertionError("firehose: the verdict ring moved")
    out["launch_times"] = small_launch_times(out["lanes"], dev, rng, P)
    return out


def report_firehose(fh) -> None:
    per = fh["per_batch"]
    log(f"phase firehose: {fh['groups']} groups x {fh['pairs']} pairs a batch, ring"
        f" {fh['ring']}, stage_example_groups({FIREHOSE_DISTINCT}) tiled | warm wave"
        f" {fh['warm_ms']:.1f} ms (synchronous dispatch of the same groups"
        f" {fh['sync_dispatch_ms']:.1f} ms, verdicts equal) | steady state"
        f" {fh['waves']} waves + pumps {fh['dispatch_ms']:.1f} ms, flush"
        f" {fh['flush_ms']:.1f} ms: {fh['batches']} batches, {fh['ms_per_batch']:.1f} ms"
        f" per batch, {fh['aggverify_per_s']:.1f} aggverify/s,"
        f" {fh['pairings_per_s']:.1f} pairings/s | occupancy min {fh['occupancy_min']}")
    tr = fh["trace"]
    chains = fh["chains_per_batch"]
    log(f"phase firehose launches: per batch fq_mul {per['fq_mul']:.1f} / fq_redc"
        f" {per['fq_redc']:.1f} / fq_bilinear {per['fq_bilinear']:.1f} /"
        f" miller_grouped {per['miller_grouped']:.1f} / final_exp {per['final_exp']:.1f} /"
        f" point_tree {per['point_tree']:.1f} /"
        f" g2_ladder {per['g2_ladder']:.1f} /"
        f" fq_bilinear_chain {per['fq_bilinear_chain']:.1f} (by chain: "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(chains.items())) + "); the"
        f" fq_bilinear family {per['fq_bilinear'] + per['fq_bilinear_chain']:.1f}, all"
        f" hand-kernel launches {sum(per.values()):.1f} (at most {FIREHOSE_MAX_LAUNCHES};"
        f" 57 + 1 while the final exponentiation was tower products) | lanes per launch: fq_mul"
        f" {hist(fh['lanes']['fq_mul'])}; fq_bilinear {hist(fh['lanes']['fq_bilinear'])};"
        f" fq_bilinear_chain (steps:lanes) {hist(fh['lanes']['fq_bilinear_chain'])}")
    log("phase firehose trace: the same window under torch.profiler: wall"
        f" {tr['wall_ms']:.1f} ms, device "
        + ("not measured (no device time in the trace)" if tr["device_ms"] is None
           else f"{tr['device_ms']:.1f} ms, busy share {tr['busy_share']:.3f}")
        + f" | synchronizations and device-to-host copies per range {tr['syncs']}")
    log("phase firehose launch: at the firehose's most frequent lane counts, ms per"
        " eager call (host and device) / per launch replayed from a CUDA graph: "
        + "; ".join(f"{k} {t['lanes']} lanes {t['call_ms']:.4f} / {t['graph_ms']:.4f}"
                    + (f" (bound {t['bound_ms']:.6f})" if "bound_ms" in t else "")
                    for k, t in fh["launch_times"].items()))
    log(f"phase firehose checks: warm verdicts == synchronous dispatch; a"
        f" {fh['pairing_shape'][0]} x {fh['pairing_shape'][1]} batch from"
        f" stage_group_arrays ({FIREHOSE_PAD} padded groups, key {FIREHOSE_BAD_KEY}"
        f" swapped) bit-identical through kernels ({fh['pairing_kernel_ms']:.1f} ms)"
        f" and plain functions ({fh['pairing_plain_ms']:.1f} ms); every verdict"
        f" True; the wave with key {FIREHOSE_BAD_KEY}'s signature swapped reads False"
        f" there only ({fh['bad_ms']:.1f} ms); {fh['deadline_misses']} deadline misses"
        f" under {fh['deadline_ms']:.0f} ms; {fh['retrace_events']} retrace /"
        f" {fh['relayout_events']} re-layout events; ring data_ptr constant; no host"
        f" synchronization in the waves (sync debug mode \"error\")")


def hist(lanes):
    """'lanes x launches', most launches first."""
    top = sorted(lanes.items(), key=lambda kv: -kv[1])
    return ", ".join(f"{k} x {v}" for k, v in top) or "-"


# ---------------------------------------------------------------------------
# the spec path: ResidentCore through the system's own entry points
# ---------------------------------------------------------------------------

def full_bitfield(size: int) -> bytes:
    """Every member's aggregation bit set, excess bits zero."""
    bf = bytearray(b"\xff" * (size // 8))
    if size % 8:
        bf.append((1 << (size % 8)) - 1)
    return bytes(bf)


def active_index_root(spec, active: np.ndarray, dev) -> bytes:
    return ssz_bulk.uint64_list_root_from_column(active.astype(np.uint64), dev)


def resume_state_bytes(spec, V: int, seed: int, dev) -> bytes:
    """A serialized mainnet BeaconState RESUME_BEFORE slots before the end
    of epoch 2, built without a Validator object: synthetic columns
    (epoch_soa.synthetic_epoch_state: 10% not yet activated, 10% not yet
    eligible, 5% slashed, random balances), random identities, and a light
    state holding a full epoch of PendingAttestations (epoch 1, every
    committee) plus epoch 2's up to the state's slot, laid out by
    epoch_soa._epoch_layout; state_bytes_from_columns assembles the bytes."""
    rng = np.random.default_rng(seed)
    cols, scal, _ = epoch_soa.synthetic_epoch_state(
        epoch_soa.EpochConfig.from_spec(spec), V, rng,
        random_eligibility=True, random_slashed_balances=True)
    np_cols = dict(cols._asdict())
    np_cols["pubkey"] = rng.integers(0, 256, (V, 48), dtype=np.uint8)
    np_cols["withdrawal_credentials"] = rng.integers(0, 256, (V, 32), dtype=np.uint8)
    spe = spec.SLOTS_PER_EPOCH
    state = spec.BeaconState(genesis_time=0, deposit_index=V,
                             latest_eth1_data=spec.Eth1Data(deposit_count=V))
    state.slot = 3 * spe - RESUME_BEFORE
    state.latest_slashed_balances = [int(x) for x in scal.latest_slashed_balances]
    root = active_index_root(spec, np.nonzero(cols.activation_epoch == 0)[0], dev)
    for i in range(spec.LATEST_ACTIVE_INDEX_ROOTS_LENGTH):
        state.latest_active_index_roots[i] = root
    add_pending_attestations(spec, state, np_cols)
    return state_bytes_from_columns(state, np_cols, spec)


def add_pending_attestations(spec, state, np_cols, att_slots=None) -> None:
    """PendingAttestations of every committee of the previous epoch and of
    the current epoch's slots before state.slot (of only the first
    `att_slots` slots of each epoch, if given), laid out by
    epoch_soa._epoch_layout over `np_cols`, every member participating,
    included after the minimum delay."""
    spe = spec.SLOTS_PER_EPOCH
    parent_root = spec.hash_tree_root(spec.Crosslink())
    current = spec.get_current_epoch(state)
    for epoch, store in ((current - 1, state.previous_epoch_attestations),
                         (current, state.current_epoch_attestations)):
        lay = epoch_soa._epoch_layout(spec, state, np_cols, epoch)
        for off in range(lay.count):
            slot = spec.get_epoch_start_slot(epoch) + off // (lay.count // spe)
            if slot >= state.slot or (att_slots is not None and slot % spe >= att_slots):
                continue
            committee = lay.shuffled[lay.bounds[off]:lay.bounds[off + 1]]
            data = spec.AttestationData(
                beacon_block_root=spec.get_block_root_at_slot(state, slot),
                source_epoch=state.current_justified_epoch,
                source_root=state.current_justified_root,
                target_epoch=epoch,
                target_root=spec.get_block_root(state, epoch),
                crosslink=spec.Crosslink(
                    shard=(lay.start_shard + off) % spec.SHARD_COUNT,
                    parent_root=parent_root,
                    end_epoch=min(epoch, spec.MAX_EPOCHS_PER_CROSSLINK)))
            store.append(spec.PendingAttestation(
                aggregation_bitfield=full_bitfield(len(committee)), data=data,
                inclusion_delay=spec.MIN_ATTESTATION_INCLUSION_DELAY,
                proposer_index=int(committee[0])))


def drive_resume(spec, data: bytes, sync):
    """from_checkpoint -> process_slots one slot at a time across the
    epoch boundary -> checkpoint_bytes -> from_checkpoint again. Returns
    the numbers, the per-slot state roots and the written bytes; checks
    that the resumed core writes the same bytes and has the same root."""
    from consensus_specs_tpu_torch.models.phase0 import helpers as spec_helpers
    ssz_bulk.clear_memo()            # every drive hashes everything itself
    spec.clear_caches()              # and shuffles the committees itself
    out = {"slot_ms": [], "slot_launches": []}
    counter = sha256_cuda.counter
    core = core2 = None
    try:
        n0 = counter.launches
        t0 = time.perf_counter()
        core = ResidentCore.from_checkpoint(spec, data)
        core._registry_balances_roots()
        sync()
        out["enter_ms"] = (time.perf_counter() - t0) * 1e3
        out["enter_launches"] = counter.launches - n0
        state = core.state
        first = int(state.slot)
        for _ in range(RESUME_BEFORE + RESUME_AFTER):
            boundary = (state.slot + 1) % spec.SLOTS_PER_EPOCH == 0
            n0 = counter.launches
            t0 = time.perf_counter()
            core.process_slots(state, state.slot + 1)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            if boundary:
                out["boundary_ms"], out["boundary_launches"] = ms, counter.launches - n0
                out["boundary_parts_ms"] = {k: v * 1e3 for k, v in core.timings.items()}
            else:
                out["slot_ms"].append(ms)
                out["slot_launches"].append(counter.launches - n0)
        h = spec.SLOTS_PER_HISTORICAL_ROOT
        out["roots"] = [bytes(state.latest_state_roots[s % h])
                        for s in range(first, int(state.slot))]
        root = core._state_root(state)
        n0 = counter.launches
        t0 = time.perf_counter()
        written = core.checkpoint_bytes()
        out["write_ms"] = (time.perf_counter() - t0) * 1e3
        out["write_launches"] = counter.launches - n0
        core._uninstall()
        n0 = counter.launches
        t0 = time.perf_counter()
        core2 = ResidentCore.from_checkpoint(spec, written)
        core2._registry_balances_roots()
        sync()
        out["resume_ms"] = (time.perf_counter() - t0) * 1e3
        out["resume_launches"] = counter.launches - n0
        # the path's own launches: the checks' root and bytes are not in them
        out["launches"] = (out["enter_launches"] + sum(out["slot_launches"])
                           + out["boundary_launches"] + out["write_launches"]
                           + out["resume_launches"])
        if core2.checkpoint_bytes() != written:
            raise AssertionError("the resumed core writes other bytes")
        if core2._state_root(core2.state) != root:
            raise AssertionError("the resumed core has another state root")
        out["written"] = written
        out["bytes"] = len(written)
        out["final_root"], out["first"], out["end"] = root, first, int(state.slot)
    finally:
        for c in (core2, core):
            if c is not None:
                c._uninstall()
    if spec_helpers._state_root_backend is not None:
        raise AssertionError("a resident core left its state-root hook installed")
    return out


def drive_slots(core, end: int, sync):
    """process_slots one slot at a time up to `end`; -> ms per slot."""
    state, ms = core.state, []
    while state.slot < end:
        t0 = time.perf_counter()
        core.process_slots(state, state.slot + 1)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def slot_roots(core, first: int, end: int):
    h = core.spec.SLOTS_PER_HISTORICAL_ROOT
    return [bytes(core.state.latest_state_roots[s % h]) for s in range(first, end)]


def drive_resilience(spec, data: bytes, want, sync):
    """The resilience layer on the resume drive's state bytes (V = 1M):
    a CheckpointStore in a temporary directory; a poison of the balance
    column at the boundary tripwired into FatalDispatchError, then
    restore and replay; a truncated newest generation and the fallback;
    a raise at the boundary retried; the boundary with tripwires on and
    off. `want` is the unfaulted drive (its per-slot roots, final root
    and slot range). Every check raises on failure."""
    first, end = want["first"], want["end"]
    before = first + RESUME_BEFORE - 1          # the slot whose advance runs the epoch
    counter = sha256_cuda.counter
    out = {"health": []}
    trip = {"ms": [], "ok": []}

    def timed_check(o, _inner=integrity.epoch_output_check):
        sync()
        t0 = time.perf_counter()
        ok = _inner(o)
        trip["ms"].append((time.perf_counter() - t0) * 1e3)
        trip["ok"].append(ok)
        return ok

    def fresh(payload):
        core = ResidentCore.from_checkpoint(spec, payload)
        core._state_root(core.state)             # the first root's memo, untimed
        sync()
        return core

    base = {n: tele_count(f"resilience.{n}")
            for n in ("retries", "faults_injected", "corrupt_outputs",
                      "checkpoint.corrupt_generations")}
    plain_check = integrity.epoch_output_check
    integrity.epoch_output_check = timed_check
    core = None
    try:
        with tempfile.TemporaryDirectory(prefix="ckpt-") as tmp:
            store = resilience.CheckpointStore(tmp, keep=4)
            faults.set_schedule("dispatch:*epoch*@1=poison:6;ckpt.write@2=truncate:33")
            core = fresh(data)
            t0 = time.perf_counter()
            payload = core.checkpoint_bytes()
            t1 = time.perf_counter()
            store.save(payload)
            out["save"] = [{"write_ms": (t1 - t0) * 1e3,
                            "save_ms": (time.perf_counter() - t1) * 1e3,
                            "frame_bytes": len(payload) + 28, "slot": first}]
            del payload
            drive_slots(core, before, sync)
            pre = core.checkpoint_bytes()
            # the poison: the tripwire reads False, the boundary is fatal
            t0 = time.perf_counter()
            try:
                core.process_slots(core.state, before + 1)
                raise AssertionError("the poisoned boundary was accepted")
            except resilience.FatalDispatchError as e:
                if not e.consumed_inputs or "CheckpointStore.restore" not in str(e):
                    raise AssertionError(f"poison: {e!r}, consumed_inputs {e.consumed_inputs}")
            out["fatal_ms"] = (time.perf_counter() - t0) * 1e3
            core._uninstall()
            if trip["ok"] != [False]:
                raise AssertionError(f"poison: tripwire verdicts {trip['ok']}")
            # restore the last good generation and replay to the same slot
            n0 = counter.launches
            t0 = time.perf_counter()
            gen, core = store.restore(spec)
            core._registry_balances_roots()
            sync()
            out["restore_ms"] = (time.perf_counter() - t0) * 1e3
            if gen != 1:
                raise AssertionError(f"restore loaded generation {gen}")
            replay = drive_slots(core, before + 1, sync)
            n_save = counter.launches
            t0 = time.perf_counter()
            payload = core.checkpoint_bytes()
            t1 = time.perf_counter()
            store.save(payload)                 # the 2nd write: truncated on disk
            out["save"].append({"write_ms": (t1 - t0) * 1e3,
                                "save_ms": (time.perf_counter() - t1) * 1e3,
                                "frame_bytes": len(payload) + 28, "slot": before + 1})
            del payload
            n_save = counter.launches - n_save
            replay += drive_slots(core, end, sync)
            out["replay_ms"] = sum(replay)
            out["replay_slots"] = len(replay)
            out["recovery_launches"] = counter.launches - n0 - n_save
            if slot_roots(core, first, end) != want["roots"]:
                raise AssertionError("replay: per-slot roots != the unfaulted drive's")
            if core._state_root(core.state) != want["final_root"]:
                raise AssertionError("replay: final root != the unfaulted drive's")
            core._uninstall()
            out["health"].append(resilience.health_snapshot())
            resilience.reset()
            out["health"].append(resilience.health_snapshot())
            # the newest generation is corrupt: restore falls back
            if store.generations() != [1, 2]:
                raise AssertionError(f"store holds {store.generations()}")
            t0 = time.perf_counter()
            gen, core = store.restore(spec)
            out["fallback_ms"] = (time.perf_counter() - t0) * 1e3
            if gen != 1 or core._state_root(core.state) != want["roots"][0]:
                raise AssertionError(f"fallback restored generation {gen}")
            core._uninstall()
        # a raise at the boundary: retried before the program runs
        faults.set_schedule("dispatch:*epoch*@1=raise")
        core = fresh(pre)
        drive_slots(core, end, sync)
        faults.set_schedule(None)
        if slot_roots(core, before, end) != want["roots"][before - first:]:
            raise AssertionError("raise: per-slot roots != the unfaulted drive's")
        if core._state_root(core.state) != want["final_root"]:
            raise AssertionError("raise: final root != the unfaulted drive's")
        core._uninstall()
        # the boundary with tripwires on and off, the same state bytes
        out["boundary_ms"], trip["ms"] = {}, []
        roots = []
        for on in (True, False):
            integrity.set_tripwires(on)
            core = fresh(pre)
            out["boundary_ms"][on] = drive_slots(core, before + 1, sync)[0]
            roots.append(core._state_root(core.state))
            core._uninstall()
        integrity.set_tripwires(None)
        if roots != [want["roots"][before + 1 - first]] * 2:
            raise AssertionError("the boundary's root differs with tripwires on / off")
        out["tripwire_ms"] = trip["ms"][0]
        core = None
    finally:
        integrity.epoch_output_check = plain_check
        integrity.set_tripwires(None)
        resilience.reset()
        if core is not None:
            core._uninstall()
    out["counts"] = {n: tele_count(f"resilience.{n}") - v for n, v in base.items()}
    if out["counts"] != {"retries": 1, "faults_injected": 3, "corrupt_outputs": 1,
                         "checkpoint.corrupt_generations": 1}:
        raise AssertionError(f"resilience counters moved by {out['counts']}")
    out["tripwire_share"] = out["tripwire_ms"] / out["boundary_ms"][True]
    return out


def drive_bls_oracle(dev):
    """phase bls oracle: three verdicts of TorchBackend on the card against
    the port's own bignum PythonBackend (crypto/bls12_381.py, "python") on
    the host: a single verify, an aggregate verify of 4 keys (each
    backend aggregating the keys and signatures itself), a swapped
    signature. Returns ms per verdict on each side and the card's
    launches; raises on any disagreement."""
    tb, py = bls_torch.TorchBackend(dev), bls_host.PythonBackend()
    msg = bytes(range(32))
    keys = [11, 12, 13, 14]
    pubs = [bls_host.privtopub(k) for k in keys]
    sigs = [bls_host.sign(msg, k, BLS_DOMAIN) for k in keys]
    cases = {"single": ((pubs[0], msg, sigs[0], BLS_DOMAIN), True),
             "swapped": ((pubs[0], msg, sigs[1], BLS_DOMAIN), False)}
    out = {"cases": {}}
    zero_fq_counters()
    agg_pub, agg_sig = tb.aggregate_pubkeys(pubs), tb.aggregate_signatures(sigs)
    if (agg_pub, agg_sig) != (py.aggregate_pubkeys(pubs), py.aggregate_signatures(sigs)):
        raise AssertionError("bls oracle: the card's aggregates != the bignum backend's")
    cases["aggregate of 4"] = ((agg_pub, msg, agg_sig, BLS_DOMAIN), True)
    for name, (args, want) in cases.items():
        card, card_ms = fenced_ms(lambda: tb.verify(*args))
        t0 = time.perf_counter()
        host = py.verify(*args)
        host_ms = (time.perf_counter() - t0) * 1e3
        if not card is host is want:
            raise AssertionError(f"bls oracle {name}: card {card}, bignum {host}, want {want}")
        out["cases"][name] = {"verdict": want, "card_ms": card_ms, "host_ms": host_ms}
    out["launches"] = fq_launches()
    if not launched_path(out["launches"]):
        raise AssertionError(f"bls oracle: the card's verifies launched {out['launches']}")
    return out


def mesh_drive(spec, data: bytes, mesh, sync):
    """ResidentCore.from_checkpoint(spec, data, mesh=mesh), its forests,
    then the resume drive's slots one at a time across the boundary.
    -> (numbers, per-slot roots, final root); the boundary slot's
    cross-shard steps fenced and clocked by the mesh's exchange."""
    ssz_bulk.clear_memo()
    spec.clear_caches()
    out = {"slot_ms": []}
    core = None
    try:
        n0 = sha256_cuda.counter.launches
        t0 = time.perf_counter()
        core = ResidentCore.from_checkpoint(spec, data, mesh=mesh)
        core._registry_balances_roots()
        sync()
        out["enter_ms"] = (time.perf_counter() - t0) * 1e3
        out["enter_launches"] = sha256_cuda.counter.launches - n0
        state = core.state
        first = int(state.slot)
        for _ in range(RESUME_BEFORE + RESUME_AFTER):
            boundary = (state.slot + 1) % spec.SLOTS_PER_EPOCH == 0
            ex = core._mesh.exchange if core._mesh is not None else None
            if boundary and ex is not None:
                ex.fence, ex.seconds, ex.steps = True, 0.0, 0
            n0 = sha256_cuda.counter.launches
            t0 = time.perf_counter()
            core.process_slots(state, state.slot + 1)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            if boundary:
                out["boundary_ms"], out["boundary_launches"] = ms, sha256_cuda.counter.launches - n0
                out["boundary_parts_ms"] = {k: v * 1e3 for k, v in core.timings.items()}
                if ex is not None:
                    out["cross_shard_ms"], out["cross_shard_steps"] = ex.seconds * 1e3, ex.steps
                    ex.fence = False
            else:
                out["slot_ms"].append(ms)
        roots = slot_roots(core, first, int(state.slot))
        final = core._state_root(state)
        out["single_device_at_end"] = core._mesh is None
    finally:
        if core is not None:
            core._uninstall()
    return out, roots, final


def pairing_groups(n_distinct: int, n_groups: int):
    """(g1 [n_groups, 2, 2, L], g2 [n_groups, 2, 2, 2, L]) numpy: groups of
    one signature's check, e(-G1, sig) * e(pk, H(m)) == 1, n_distinct of
    them signed on the host and tiled."""
    g1 = np.zeros((n_distinct, 2, 2, fq_mod.L), np.int64)
    g2 = np.zeros((n_distinct, 2, 2, 2, fq_mod.L), np.int64)
    for g in range(n_distinct):
        msg, k = bytes([g + 1]) * 32, 101 + g
        pairs = [(bls_host.ec_neg(bls_host.G1_GEN),
                  bls_host.decompress_g2(bls_host.sign(msg, k, BLS_DOMAIN))),
                 (bls_host.decompress_g1(bls_host.privtopub(k)),
                  bls_host.hash_to_g2(msg, BLS_DOMAIN))]
        g1[g] = np.stack([bls_torch.g1_to_limbs(a) for a, _ in pairs])
        g2[g] = np.stack([bls_torch.g2_to_limbs(b) for _, b in pairs])
    reps = -(-n_groups // n_distinct)
    return (np.tile(g1, (reps, 1, 1, 1))[:n_groups].copy(),
            np.tile(g2, (reps, 1, 1, 1, 1))[:n_groups].copy())


def drive_mesh(spec, data: bytes, want, sync, dev):
    """phase mesh on the resume drive's 1M state bytes: the drive under
    ServingMesh([dev] * MESH_SHARDS) against the single-device drive's
    roots (`want`), counted from 0 (its sha256_pairs launches are the mesh
    path's); the same drive after a `mesh=lose:2` schedule re-plans the
    mesh; a fault at mesh.epoch walks the ladder to single_device; the
    sharded grouped pairing (MESH_GROUPS x 2 pairs) against the
    single-device pairing, one group swapped to fail. Raises on any
    difference."""
    out = {}
    devices = [dev] * MESH_SHARDS
    mesh4 = ServingMesh(devices)
    zero_counts()
    out["drive"], roots, final = mesh_drive(spec, data, mesh4, sync)
    out["launches"] = counts()
    if roots != want["roots"] or final != want["final_root"]:
        raise AssertionError("mesh: the sharded drive's roots != the single-device drive's")
    out["shards"], out["distinct"] = mesh4.size, mesh4.distinct_devices
    out["copies"] = mesh4.exchange.copies

    faults.set_schedule("mesh@1=lose:2")
    try:
        mesh2 = ServingMesh.available(devices=devices)
    finally:
        faults.set_schedule(None)
    if mesh2 is None or mesh2.size != 2:
        raise AssertionError(f"mesh=lose:2 over {len(devices)} shards gave {mesh2}")
    out["lose2"], roots, final = mesh_drive(spec, data, mesh2, sync)
    if roots != want["roots"] or final != want["final_root"]:
        raise AssertionError("mesh: the drive after mesh=lose:2 differs")

    deg0 = tele_count("resilience.degradations.single_device")
    faults.set_schedule("dispatch:*mesh.epoch*@1-3=raise")
    try:
        out["ladder"], roots, final = mesh_drive(spec, data, ServingMesh(devices), sync)
    finally:
        faults.set_schedule(None)
        rung = resilience.ladder().rung_name
        resilience.reset()
    out["ladder"]["degradations"] = tele_count("resilience.degradations.single_device") - deg0
    if roots != want["roots"] or final != want["final_root"]:
        raise AssertionError("mesh: the drive degraded to single_device differs")
    if not out["ladder"]["single_device_at_end"] or rung != "single_device" \
            or out["ladder"]["degradations"] != 1:
        raise AssertionError(f"mesh: the ladder ended at {rung}, degradations "
                             f"{out['ladder']['degradations']}")

    # the attestation axis: the groups split over the shards
    g1, g2 = pairing_groups(2, MESH_GROUPS)
    g1[MESH_BAD_GROUP, 1] = g1[0, 1] if MESH_BAD_GROUP % 2 else g1[1, 1]  # another key
    t1, t2 = torch.from_numpy(g1).to(dev), torch.from_numpy(g2).to(dev)
    expect = [k != MESH_BAD_GROUP for k in range(MESH_GROUPS)]
    zero_fq_counters()
    single, out["pairing_single_ms"] = fenced_ms(lambda: bls_torch.grouped_pairing_check(t1, t2))
    out["pairing_single_launches"] = fq_launches()
    zero_fq_counters()
    sharded, out["pairing_sharded_ms"] = fenced_ms(lambda: mesh4.grouped_pairing_check(t1, t2))
    out["pairing_launches"] = fq_launches()
    if single.tolist() != expect or sharded.tolist() != expect:
        raise AssertionError(f"mesh pairing: single {single.tolist()}, sharded "
                             f"{sharded.tolist()}, want {expect}")
    if not launched_path(out["pairing_launches"], decompress=False):
        raise AssertionError(f"mesh pairing launched {out['pairing_launches']}")

    # distinct cards, where the machine has more than one
    out["cards"] = torch.cuda.device_count()
    if out["cards"] > 1:
        cards = ServingMesh.available()
        out["cards_drive"], roots, final = mesh_drive(spec, data, cards, sync)
        out["cards_mesh"] = [str(d) for d in cards.devices]
        if roots != want["roots"] or final != want["final_root"]:
            raise AssertionError("mesh over distinct cards: roots differ")
    return out


def report_mesh(m, single) -> None:
    """Print phase mesh's lines; `single` is the resume drive's numbers."""
    d, note = m["drive"], (f"{m['shards']} shards on {m['distinct']} distinct device(s)")
    log(f"phase mesh: {note}, V={single['validators']:,} mainnet, from_checkpoint + sharded"
        f" forests {d['enter_ms']:.1f} ms, {d['enter_launches']} sha256_pairs launches"
        f" (single device {single['enter_launches']}) | per-slot root ms min / median / max"
        f" {min(d['slot_ms']):.2f} / {float(np.median(d['slot_ms'])):.2f} / {max(d['slot_ms']):.2f}"
        f" | boundary slot {d['boundary_ms']:.1f} ms (single device"
        f" {single['boundary_ms']:.1f}; stage {d['boundary_parts_ms']['stage']:.1f} / device"
        f" {d['boundary_parts_ms']['device']:.1f} / refresh {d['boundary_parts_ms']['refresh']:.1f}),"
        f" {d['boundary_launches']} launches (single device {single['boundary_launches']}),"
        f" cross-shard steps {d['cross_shard_steps']} taking {d['cross_shard_ms']:.1f} ms"
        f" ({d['cross_shard_ms'] / d['boundary_ms']:.1%} of it, fenced) | the path's launches"
        f" {m['launches']['sha256_pairs']} sha256_pairs | tensors the exchange moved between"
        f" devices {m['copies']}")
    log(f"phase mesh checks: {note}: every per-slot root and the final root == the"
        f" single-device drive's; after mesh=lose:2 (2 shards on {m['distinct']} distinct"
        f" device(s)): equal again, boundary {m['lose2']['boundary_ms']:.1f} ms; a raise x3 at"
        f" mesh.epoch walked the ladder to single_device (degradations.single_device"
        f" {m['ladder']['degradations']}), boundary {m['ladder']['boundary_ms']:.1f} ms, roots"
        f" equal")
    log(f"phase mesh pairing: {MESH_GROUPS} groups x 2 pairs, {note}: verdicts == the"
        f" single-device pairing's, group {MESH_BAD_GROUP} False in both | sharded"
        f" {m['pairing_sharded_ms']:.1f} ms (fq_mul / fq_bilinear / chains"
        f" {m['pairing_launches']['fq_mul']} / {m['pairing_launches']['fq_bilinear']} /"
        f" {m['pairing_launches']['fq_bilinear_chain']}; {programs(m['pairing_launches'])}),"
        f" single device"
        f" {m['pairing_single_ms']:.1f} ms ({m['pairing_single_launches']['fq_mul']} /"
        f" {m['pairing_single_launches']['fq_bilinear']} /"
        f" {m['pairing_single_launches']['fq_bilinear_chain']})")
    if m["cards"] > 1:
        log(f"phase mesh cards: the same drive over {m['cards_mesh']}: roots equal,"
            f" boundary {m['cards_drive']['boundary_ms']:.1f} ms")
    else:
        log("phase mesh cards: one card visible: the mesh over distinct cards was not run"
            " (4 shards on one card: not a multi-GPU measurement)")


def drive_api(spec, V: int, sync, dev):
    """The beacon-node API over an object state of V validators one slot
    before the last of its epoch, BLS on the "torch" backend: duties of 16
    members of the epoch's first committee against
    get_committee_assignment; then, with install_bulk_state_root on the
    card (removed at the end), produce_block with a randao reveal signed on
    the host, the block signed on the host; the block with its signature
    swapped for the randao reveal rejected with 400 and the head
    unchanged; publish_block of the signed block, its state root equal to
    the same block applied through ResidentCore; produce and publish an
    attestation; /metrics and /healthz. Every validator has a pubkey of
    its own (the API indexes them), the next slot's proposer a real key."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    spe = spec.SLOTS_PER_EPOCH
    slot = (spec.PERSISTENT_COMMITTEE_PERIOD + 1) * spe + spe - 2
    t0 = time.perf_counter()
    state = beacon_state(spec, V, slot - 1, lambda i: i.to_bytes(48, "little"), dev)
    # the proposer of slot + 1 reads the seed and the effective balances,
    # which the slots before it do not change
    state.slot = slot + 1
    proposer = spec.get_beacon_proposer_index(state)
    state.slot = slot - 1
    key = key_of(proposer)
    state.validator_registry[proposer].pubkey = bls_host.privtopub(key)
    # a head the node has advanced to its slot: the latest header carries
    # its state root, so produce_block's parent root is the chain's
    spec.process_slots(state, slot)
    epoch = spec.get_current_epoch(state)
    first = spec.get_crosslink_committee(state, epoch, spec.get_epoch_start_shard(state, epoch))
    idx = [int(i) for i in first[:16]]
    want = [spec.get_committee_assignment(state, epoch, i) for i in idx]
    out = {"build_s": time.perf_counter() - t0, "validators": V}
    was_active = spec_bls.bls_active
    spec_bls.bls_active = True
    spec_bls.set_backend("torch")
    copies = []

    def timed_deepcopy(x, _inner=copy.deepcopy):
        t = time.perf_counter()
        res = _inner(x)
        copies.append((time.perf_counter() - t) * 1e3)
        return res
    api_mod.deepcopy = timed_deepcopy
    core = None
    try:
        api = BeaconNodeAPI(spec, state, device=dev)
        keys = [bytes(state.validator_registry[i].pubkey) for i in idx]
        t0 = time.perf_counter()
        duties = api.get_validator_duties(keys)
        out["duties_ms"] = (time.perf_counter() - t0) * 1e3
        for i, d, (committee, shard, dslot) in zip(idx, duties, want):
            if (d.validator_index, d.committee, d.attestation_shard, d.attestation_slot) != \
                    (i, [int(c) for c in committee], int(shard), int(dslot)):
                raise AssertionError(f"api: duty of validator {i} != get_committee_assignment")
        reveal = bls_host.sign(spec.hash_tree_root(epoch), key,
                               spec.get_domain(state, spec.DOMAIN_RANDAO, epoch))
        # the state roots of produce and publish on the card, as the JAX
        # package's entry points install them
        spec_helpers.install_bulk_state_root(device=dev)
        copies.clear()
        t0 = time.perf_counter()
        block = api.produce_block(slot + 1, reveal)
        out["produce_ms"] = (time.perf_counter() - t0) * 1e3
        block.signature = bls_host.sign(spec.signing_root(block), key, spec.get_domain(
            state, spec.DOMAIN_BEACON_PROPOSER))
        bad = copy.deepcopy(block)
        bad.signature = reveal
        copies.clear()
        t0 = time.perf_counter()
        try:
            api.publish_block(bad)
            raise AssertionError("api: the block with a swapped signature was published")
        except ApiError as e:
            if e.status != 400:
                raise AssertionError(f"api: the swapped signature gave {e.status}")
        out["reject_ms"] = (time.perf_counter() - t0) * 1e3
        if api.state is not state or api.published_blocks:
            raise AssertionError("api: the rejected block moved the head")
        zero_fq_counters()
        n0 = sha256_cuda.counter.launches
        copies.clear()
        t0 = time.perf_counter()
        api.publish_block(block)
        sync()
        out["publish_ms"] = (time.perf_counter() - t0) * 1e3
        out["publish_deepcopy_ms"] = sum(copies)
        out["publish_fq"] = fq_launches()
        out["publish_sha256"] = sha256_cuda.counter.launches - n0
        if int(api.state.slot) != slot + 1 or len(api.published_blocks) != 1:
            raise AssertionError("api: the published block did not become the head")
        # the same block through ResidentCore from the old head
        core = ResidentCore(spec, state)
        core.state_transition(state, copy.deepcopy(block))
        if core._state_root(state) != bytes(block.state_root):
            raise AssertionError("api: head root != the block applied through ResidentCore")
        core._uninstall()
        core = None
        duty = next(d for d in duties if d.attestation_slot <= int(api.state.slot))
        att = api.produce_attestation(duty.validator_pubkey, duty.attestation_slot,
                                      duty.attestation_shard)
        api.publish_attestation(att)
        if len(api.published_attestations) != 1:
            raise AssertionError("api: the attestation was not queued")
        health = api.get_healthz()          # registers the always-on counters
        metrics = api.get_metrics()
        if "resilience_" not in metrics or not {"firehose", "checkpoint"} <= set(health):
            raise AssertionError("api: /metrics or /healthz lacks the resilience view")
        out["metrics_lines"] = sum(1 for ln in metrics.splitlines()
                                   if "resilience_" in ln and not ln.startswith("#"))
    finally:
        api_mod.deepcopy = copy.deepcopy
        spec_bls.bls_active = was_active
        if core is not None:
            core._uninstall()
        spec_helpers.set_state_root_backend(None)
    return out


def zero_counts() -> None:
    """Every hand kernel's launch count to 0 (a path's drive starts here)."""
    sha256_cuda.counter.launches = 0
    zero_fq_counters()


def counts() -> dict:
    """Launches by kernel since zero_counts()."""
    return {"sha256_pairs": sha256_cuda.counter.launches, **fq_launches()}


def attested_state(spec, V: int, slot: int, pubkey_of, dev, att_slots=None):
    """beacon_state at `slot` with add_pending_attestations: the epoch
    program's crosslink, justification and reward paths all run. The
    object model's reward loop costs validators x attestations, so the
    checks against it attest `att_slots` slots an epoch."""
    state = beacon_state(spec, V, slot, pubkey_of, dev)
    add_pending_attestations(spec, state, epoch_soa.columns_np_from_state(state), att_slots)
    return state


def process_slots_bridged(spec, state, slot: int) -> None:
    """spec.process_slots with the epoch boundary through
    epoch_soa.process_epoch_soa (the staged route for a phase-1 spec)."""
    while state.slot < slot:
        spec.process_slot(state)
        if (state.slot + 1) % spec.SLOTS_PER_EPOCH == 0:
            epoch_soa.process_epoch_soa(spec, state)
        state.slot += 1


def convert_spec(state, src, dst, name="BeaconState"):
    """An object of `src` spec's container `name` as `dst`'s (SSZ bytes)."""
    return ssz_impl.deserialize(ssz_impl.serialize(state, getattr(src, name)),
                                getattr(dst, name))


def drive_epoch_bridge(spec, V: int, v_check: int, sync, dev):
    """process_epoch_soa on the object state chip_smoke.beacon_state builds
    at V validators, the last slot of epoch 2, both epochs' attestations
    pending, BLS off, the bulk state root installed on the card: the four
    timings, then the state root. The same call on a copy through a spec
    whose pair hash is the plain one (and the bulk root through it) must
    give the same root and launch no kernel; at v_check validators the
    bridge must equal the unpatched object model's process_epoch on a
    deepcopy, byte for byte. Returns the numbers."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    slot = 3 * spec.SLOTS_PER_EPOCH - 1
    keys = lambda i: i.to_bytes(48, "little")  # noqa: E731
    t0 = time.perf_counter()
    state = attested_state(spec, V, slot, keys, dev)
    twin = copy.deepcopy(state)
    out = {"validators": V, "build_s": time.perf_counter() - t0,
           "pending": len(state.previous_epoch_attestations)
           + len(state.current_epoch_attestations)}
    was_active = spec_bls.bls_active
    spec_bls.bls_active = False
    try:
        ssz_bulk.clear_memo()
        spec_helpers.install_bulk_state_root(device=dev)
        timings = {}
        zero_counts()
        sync()
        t0 = time.perf_counter()
        epoch_soa.process_epoch_soa(spec, state, timings)
        sync()
        t1 = time.perf_counter()
        root = spec.hash_tree_root(state)
        sync()
        t2 = time.perf_counter()
        out["launches"] = counts()["sha256_pairs"]
        out["epoch_ms"] = (t1 - t0) * 1e3
        out["timings_ms"] = {k: v * 1e3 for k, v in timings.items()}
        out["root_ms"] = (t2 - t1) * 1e3
        if set(timings) != {"distill", "perm", "device", "writeback"}:
            raise AssertionError(f"epoch bridge: timings {sorted(timings)}")

        plain_spec = phase0.Phase0Spec(load_preset("mainnet"), device=dev,
                                       pair_fn=sha256.sha256_pairs)
        ssz_bulk.clear_memo()
        n0 = sha256_cuda.counter.launches
        t0 = time.perf_counter()
        epoch_soa.process_epoch_soa(plain_spec, twin)
        plain_root = ssz_bulk.state_root_bulk(twin, dev, sha256.sha256_pairs)
        sync()
        out["plain_s"] = time.perf_counter() - t0
        if sha256_cuda.counter.launches != n0:
            raise AssertionError("epoch bridge: the plain pair hash launched the kernel")
        if plain_root != root:
            raise AssertionError("epoch bridge: state root != the plain pair hash's")
        del twin

        small = attested_state(spec, v_check, slot, keys, dev, CHECK_ATT_SLOTS)
        ref = copy.deepcopy(small)
        spec_helpers.set_state_root_backend(None)
        t0 = time.perf_counter()
        spec.process_epoch(ref)
        epoch_soa.process_epoch_soa(spec, small)
        out["check_s"] = time.perf_counter() - t0
        if ssz_impl.serialize(small, spec.BeaconState) != ssz_impl.serialize(ref, spec.BeaconState):
            raise AssertionError(f"epoch bridge: V={v_check} state != process_epoch's")
        out["check_validators"] = v_check
        out["justified"] = (int(state.previous_justified_epoch),
                            int(state.current_justified_epoch))
    finally:
        spec_helpers.set_state_root_backend(None)
        spec_bls.bls_active = was_active
    return out


def drive_chunk_tree(dev, rng, sync):
    """bulk.build_chunk_tree over CHUNK_TREE_N random chunks on the card,
    an update of CHUNK_TREE_DIRTY rows, an append of CHUNK_TREE_APPEND rows
    that crosses 2**20: each root must equal merkleize_chunk_array (hashlib
    on the host) and the same handle through the plain pair hash on the
    card. Returns the ms, the kernel's launches and the merkle.forest.*
    counter deltas of the kernel route."""
    names = ("pair_lanes", "launches", "builds")

    def forest():
        return [telemetry.counter(f"merkle.forest.{k}").value for k in names]

    chunks = rng.integers(0, 256, (CHUNK_TREE_N, 32), dtype=np.uint8)
    idx = np.sort(rng.choice(CHUNK_TREE_N, CHUNK_TREE_DIRTY, replace=False))
    rows = rng.integers(0, 256, (CHUNK_TREE_DIRTY, 32), dtype=np.uint8)
    more = rng.integers(0, 256, (CHUNK_TREE_APPEND, 32), dtype=np.uint8)
    out = {"chunks": CHUNK_TREE_N, "dirty": CHUNK_TREE_DIRTY, "append": CHUNK_TREE_APPEND}
    was = telemetry.enabled()
    telemetry.set_enabled(True)
    try:
        ssz_bulk.clear_memo()
        f0 = forest()
        zero_counts()
        roots = []
        sync()
        t0 = time.perf_counter()
        handle = ssz_bulk.build_chunk_tree(chunks, device=dev)
        roots.append(handle.root())
        t1 = time.perf_counter()
        handle.update(idx, rows)
        roots.append(handle.root())
        t2 = time.perf_counter()
        out["update_pairs_per_level"] = list(handle.tree.last_pairs_per_level)
        handle.append(more)
        roots.append(handle.root())
        t3 = time.perf_counter()
        out["launches"] = counts()["sha256_pairs"]
        out["forest_deltas"] = dict(zip(names, (b - a for a, b in zip(f0, forest()))))
        out["ms"] = {"build": (t1 - t0) * 1e3, "update": (t2 - t1) * 1e3,
                     "append": (t3 - t2) * 1e3}
    finally:
        telemetry.set_enabled(was)
    n0 = sha256_cuda.counter.launches
    plain = ssz_bulk.build_chunk_tree(chunks, device=dev, pair_fn=sha256.sha256_pairs)
    plain_roots = [plain.root()]
    plain.update(idx, rows)
    plain_roots.append(plain.root())
    plain.append(more)
    plain_roots.append(plain.root())
    if sha256_cuda.counter.launches != n0:
        raise AssertionError("chunk tree: the plain pair hash launched the kernel")
    ssz_bulk.clear_memo()
    t0 = time.perf_counter()
    want = [ssz_bulk.merkleize_chunk_array(chunks)]
    chunks[idx] = rows
    want.append(ssz_bulk.merkleize_chunk_array(chunks))
    want.append(ssz_bulk.merkleize_chunk_array(np.concatenate([chunks, more])))
    out["hashlib_s"] = time.perf_counter() - t0
    if roots != plain_roots or roots != want:
        raise AssertionError("chunk tree: a root != merkleize_chunk_array / the plain route")
    return out


def phase1_drive(spec, state, sync, blocks=None):
    """The phase-1 drive on `state` (three slots before the end of its
    epoch): a block carrying one custody key reveal and one early derived
    secret reveal, signed on the host; a custody key reveal with another
    validator's signature, rejected by process_custody_key_reveal before
    it writes; the epoch boundary through process_epoch_soa (the staged
    route); the state root; a block in the new epoch. Builds and times the
    blocks, or, given `blocks`, replays them untimed. Returns (rows, the
    blocks): one row per step with its ms and launches by kernel."""
    rows = []
    build = blocks is None
    blocks = [] if build else list(blocks)

    def step(kind, fn):
        zero_counts()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        rows.append({"kind": kind, "ms": (time.perf_counter() - t0) * 1e3, **counts()})

    step("slot", lambda: spec.process_slots(state, int(state.slot) + 1))
    if build:
        r, r2, a, m = 1_000, 1_001, 2_000, 3_000      # keys of r, r2, a, m differ
        period = state.validator_registry[r].next_custody_reveal_period
        rev_epoch = spec.get_randao_epoch_for_custody_period(period, r)
        reveal = bls_host.sign(spec.hash_tree_root(rev_epoch), key_of(r), spec.get_domain(
            state, spec.DOMAIN_RANDAO, message_epoch=rev_epoch))
        epoch = spec.get_current_epoch(state) + spec.RANDAO_PENALTY_EPOCHS
        mask = hashlib.sha256(b"mask").digest()
        domain = spec.get_domain(state, spec.DOMAIN_RANDAO, message_epoch=epoch)
        secret = bls_host.compress_g2(bls_host.ec_add(
            bls_host.decompress_g2(bls_host.sign(spec.hash_tree_root(epoch), key_of(a), domain)),
            bls_host.decompress_g2(bls_host.sign(mask, key_of(m), domain))))
        bad = spec.CustodyKeyReveal(revealer_index=r2, reveal=reveal)

        def reject():
            try:
                spec.process_custody_key_reveal(state, bad)
            except AssertionError:
                return
            raise AssertionError("phase1: a reveal with a swapped signature was accepted")
        step("reveal with a swapped signature, rejected", reject)
        if state.validator_registry[r2].next_custody_reveal_period != 0:
            raise AssertionError("phase1: the rejected reveal wrote the state")
        blocks.append(proposed_block(
            spec, state,
            custody_key_reveals=[spec.CustodyKeyReveal(revealer_index=r, reveal=reveal)],
            early_derived_secret_reveals=[spec.EarlyDerivedSecretReveal(
                revealed_index=a, epoch=epoch, reveal=secret, masker_index=m, mask=mask)]))
    step("block with 2 reveals", lambda: spec.state_transition(state, blocks[0]))
    boundary = (spec.get_current_epoch(state) + 1) * spec.SLOTS_PER_EPOCH
    step("slots + boundary (process_epoch_soa, staged)",
         lambda: process_slots_bridged(spec, state, boundary))
    step("state root", lambda: spec.hash_tree_root(state))
    if build:
        blocks.append(proposed_block(spec, state))
    step("block in the new epoch", lambda: spec.state_transition(state, blocks[1]))
    return rows, blocks


def drive_phase1(V: int, v_check: int, sync, dev):
    """Phase1Spec on mainnet at V validators (keys cycled over N_KEYS
    keypairs), an attested state three slots before the end of epoch
    PERSISTENT_COMMITTEE_PERIOD + 1 (every validator past its first
    custody period), BLS on "torch", the bulk state root installed:
    phase1_drive. The same blocks replayed on a copy through a spec whose
    pair hash is the plain one (BLS off: the signatures were checked) must
    end on the same root and launch no kernel. At v_check validators, BLS
    off, a boundary far enough out that @process_challenge_deadlines slashes
    an overdue challenge's responder between the two device stages:
    process_epoch_soa must equal Phase1Spec.process_epoch on a deepcopy.
    Returns (the numbers, the spec, the final state) for the light
    client."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    spec = phase1.get_spec("mainnet", device=dev)
    spe = spec.SLOTS_PER_EPOCH
    pubs = [bls_host.privtopub(k + 1) for k in range(N_KEYS)]
    slot = (spec.PERSISTENT_COMMITTEE_PERIOD + 2) * spe - 3
    t0 = time.perf_counter()
    state = attested_state(spec, V, slot, lambda i: pubs[i % N_KEYS], dev)
    start = ssz_impl.serialize(state, spec.BeaconState)
    out = {"validators": V, "slot": slot, "build_s": time.perf_counter() - t0}
    was_active = spec_bls.bls_active
    try:
        spec_bls.bls_active = True
        spec_bls.set_backend("torch")
        ssz_bulk.clear_memo()
        spec_helpers.install_bulk_state_root(device=dev)
        rows, blocks = phase1_drive(spec, state, sync)
        root = spec.hash_tree_root(state)
        out["rows"] = rows
        out["slots"] = (slot, int(state.slot))

        plain = phase1.Phase1Spec(load_preset("mainnet"), device=dev,
                                  pair_fn=sha256.sha256_pairs)
        spec_bls.bls_active = False
        ssz_bulk.clear_memo()
        spec_helpers.install_bulk_state_root(device=dev, pair_fn=sha256.sha256_pairs)
        t0 = time.perf_counter()
        twin = ssz_impl.deserialize(start, plain.BeaconState)
        plain_rows, _ = phase1_drive(plain, twin, sync, [
            convert_spec(b, spec, plain, "BeaconBlock") for b in blocks])
        if plain.hash_tree_root(twin) != root:
            raise AssertionError("phase1: final root != the plain pair hash's drive")
        out["plain_s"] = time.perf_counter() - t0
        if sum(row["sha256_pairs"] for row in plain_rows):
            raise AssertionError("phase1: the plain pair hash launched the kernel")
        del twin

        spec_helpers.set_state_root_backend(None)
        small = attested_state(spec, v_check, (spec.CUSTODY_RESPONSE_DEADLINE + 3) * spe - 1,
                               lambda i: i.to_bytes(48, "little"), dev, CHECK_ATT_SLOTS)
        responder = 5
        small.custody_chunk_challenge_records.append(spec.CustodyChunkChallengeRecord(
            challenge_index=0, challenger_index=1, responder_index=responder,
            inclusion_epoch=0, data_root=b"\x01" * 32, depth=0, chunk_index=0))
        small.custody_challenge_index = 1
        ref = copy.deepcopy(small)
        t0 = time.perf_counter()
        spec.process_epoch(ref)
        epoch_soa.process_epoch_soa(spec, small)
        out["check_s"] = time.perf_counter() - t0
        if ssz_impl.serialize(small, spec.BeaconState) != ssz_impl.serialize(ref, spec.BeaconState):
            raise AssertionError(f"phase1: V={v_check} staged boundary != Phase1Spec.process_epoch")
        if not small.validator_registry[responder].slashed:
            raise AssertionError("phase1: the overdue challenge's responder was not slashed")
        out["check_validators"] = v_check
    finally:
        spec_helpers.set_state_root_backend(None)
        spec_bls.bls_active = was_active
    return out, spec, state


def drive_light_client(spec, state, sync):
    """The light client on the phase-1 state after its drive, BLS on
    "torch": build_validator_memory; compute_committee ==
    get_persistent_committee for LIGHT_CLIENT_SHARD; prove_period_data and
    verify_period_data against the state's bulk root (a forged seed
    rejected); a BlockValidityProof of the shard committee's aggregate
    signature (signed on the host) verified through spec.bls on the card,
    and the same proof with the signature of another message rejected.
    Returns the numbers and the proof verify's launches by kernel."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    slot, shard = int(state.slot), LIGHT_CLIENT_SHARD
    out = {"validators": len(state.validator_registry), "slot": slot, "shard": shard}
    header = spec.BeaconBlockHeader(slot=slot, parent_root=spec.signing_root(
        state.latest_block_header), state_root=bytes(state.latest_state_roots[
            (slot - 1) % spec.SLOTS_PER_HISTORICAL_ROOT]))
    was_active = spec_bls.bls_active
    try:
        spec_bls.bls_active = True
        spec_bls.set_backend("torch")
        t0 = time.perf_counter()
        memory = light_client.build_validator_memory(spec, state, slot, shard, header)
        t1 = time.perf_counter()
        committee = light_client.compute_committee(spec, header, memory)
        t2 = time.perf_counter()
        if committee != spec.get_persistent_committee(state, shard, slot) or not committee:
            raise AssertionError("light client: compute_committee != get_persistent_committee")
        out.update(memory_ms=(t1 - t0) * 1e3, committee_ms=(t2 - t1) * 1e3,
                   committee=len(committee))
        root = ssz_bulk.state_root_bulk(state, spec.device)
        t0 = time.perf_counter()
        pd, proof = light_client.prove_period_data(spec, state, slot, shard, later=True)
        t1 = time.perf_counter()
        ok = light_client.verify_period_data(spec, root, pd, proof, slot, shard, later=True)
        t2 = time.perf_counter()
        forged = copy.deepcopy(pd)
        forged.seed = b"\x55" * 32
        if not ok or light_client.verify_period_data(spec, root, forged, proof, slot, shard,
                                                     later=True):
            raise AssertionError("light client: period data verdicts wrong")
        out.update(prove_ms=(t1 - t0) * 1e3, verify_period_ms=(t2 - t1) * 1e3,
                   proof_nodes=len(proof.partial.proof) + len(proof.partial.values))
        parent = spec.ShardBlock(
            slot=slot, shard=shard, beacon_chain_root=spec.signing_root(header),
            parent_root=spec.ZERO_HASH,
            data=spec.ShardBlockBody(data=b"\x00" * spec.BYTES_PER_SHARD_BLOCK_BODY),
            state_root=spec.ZERO_HASH)
        domain = spec.bls_domain(spec.DOMAIN_SHARD_ATTESTER, bytes(memory.fork_version))
        good = light_client.BlockValidityProof(
            header=header, shard_bitfield=full_bitfield(len(committee)),
            shard_aggregate_signature=sign_committee(committee, spec.signing_root(parent), domain),
            shard_parent_block=parent)
        bad = copy.copy(good)
        bad.shard_aggregate_signature = sign_committee(committee, spec.signing_root(header), domain)
        zero_counts()
        sync()
        t0 = time.perf_counter()
        if not light_client.verify_block_validity_proof(spec, good, memory):
            raise AssertionError("light client: the block validity proof was rejected")
        sync()
        out["proof_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = counts()
        t0 = time.perf_counter()
        if light_client.verify_block_validity_proof(spec, bad, memory):
            raise AssertionError("light client: a proof with a swapped signature was accepted")
        out["reject_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        spec_bls.bls_active = was_active
    return out


def drive_slice8(rng, sync, dev, v=V_BLOCKS, v_check=V_REFERENCE):
    """The paths of slice 8, each driven with the counts at 0 just before
    it and read just after: the epoch bridge, the chunk tree, phase 1 and
    the light client on phase 1's final state. Returns the numbers."""
    spec = phase0.get_spec("mainnet", device=dev)
    out = {"bridge": drive_epoch_bridge(spec, v, v_check, sync, dev)}
    torch.cuda.empty_cache()
    out["chunk_tree"] = drive_chunk_tree(dev, rng, sync)
    torch.cuda.empty_cache()
    out["phase1"], p1_spec, p1_state = drive_phase1(v, v_check, sync, dev)
    out["phase1_launches"] = {k: sum(row[k] for row in out["phase1"]["rows"])
                              for k in ("sha256_pairs",) + tuple(FQ_COUNTERS)}
    out["light_client"] = drive_light_client(p1_spec, p1_state, sync)
    return out


def report_slice8(s8) -> None:
    """Print slice 8's phase lines."""
    br = s8["bridge"]
    t = br["timings_ms"]
    log(f"phase epoch bridge: process_epoch_soa V={br['validators']:,} mainnet, object"
        f" state with {br['pending']:,} pending attestations (built in {br['build_s']:.1f} s,"
        f" untimed), BLS off, bulk state root installed | {br['epoch_ms']:.1f} ms: distill"
        f" {t['distill']:.1f} / perm {t['perm']:.1f} / device {t['device']:.1f} / writeback"
        f" {t['writeback']:.1f} | state root {br['root_ms']:.1f} ms | sha256_pairs launches"
        f" {br['launches']} | justified {br['justified']} | root == the plain pair hash's"
        f" ({br['plain_s']:.1f} s, 0 kernel launches) | V={br['check_validators']:,}: =="
        f" the object model's process_epoch byte for byte ({br['check_s']:.1f} s)")
    ct = s8["chunk_tree"]
    log(f"phase chunk tree: build_chunk_tree of {ct['chunks']:,} chunks {ct['ms']['build']:.1f}"
        f" ms (with root) | update of {ct['dirty']} rows {ct['ms']['update']:.1f} ms, pairs"
        f" per level {ct['update_pairs_per_level']} | append of {ct['append']:,} rows (crosses"
        f" 2**20) {ct['ms']['append']:.1f} ms | sha256_pairs launches {ct['launches']} |"
        f" merkle.forest deltas {ct['forest_deltas']} | the three roots =="
        f" merkleize_chunk_array (hashlib, {ct['hashlib_s']:.1f} s) and the plain pair hash's")
    ph = s8["phase1"]
    for row in ph["rows"]:
        log(f"phase phase1: {row['kind']}: {row['ms']:.1f} ms | sha256_pairs"
            f" {row['sha256_pairs']} / fq_mul {row['fq_mul']} / fq_bilinear {row['fq_bilinear']}"
            f" / fq_bilinear_chain {row['fq_bilinear_chain']} / {programs(row)} launches")
    log(f"phase phase1: Phase1Spec V={ph['validators']:,} mainnet, slots {ph['slots'][0]}-"
        f"{ph['slots'][1]} (state built in {ph['build_s']:.1f} s, untimed), BLS on the torch"
        f" backend, bulk state root installed | launches {s8['phase1_launches']} | final root"
        f" == the same blocks with the plain pair hash ({ph['plain_s']:.1f} s, 0 kernel"
        f" launches) | V={ph['check_validators']:,} staged boundary with a hook slashing"
        f" between the stages == Phase1Spec.process_epoch ({ph['check_s']:.1f} s)")
    lc = s8["light_client"]
    log(f"phase light client: V={lc['validators']:,}, slot {lc['slot']}, shard {lc['shard']} |"
        f" build_validator_memory {lc['memory_ms']:.1f} ms | compute_committee"
        f" {lc['committee_ms']:.1f} ms, {lc['committee']} members == get_persistent_committee"
        f" | prove_period_data {lc['prove_ms']:.1f} ms ({lc['proof_nodes']} nodes),"
        f" verify_period_data {lc['verify_period_ms']:.1f} ms, a forged seed rejected |"
        f" BlockValidityProof verified through spec.bls {lc['proof_ms']:.1f} ms, fq_mul"
        f" {lc['launches']['fq_mul']} / fq_bilinear {lc['launches']['fq_bilinear']} /"
        f" fq_bilinear_chain {lc['launches']['fq_bilinear_chain']} /"
        f" {programs(lc['launches'])} launches; the swapped"
        f" signature rejected in {lc['reject_ms']:.1f} ms")


def beacon_state(spec, V: int, slot: int, pubkey_of, dev):
    """An object-model mainnet state: V validators active from genesis at
    the maximum effective balance, `pubkey_of(i)` as validator i's key."""
    state = spec.BeaconState(genesis_time=0, deposit_index=V,
                             latest_eth1_data=spec.Eth1Data(deposit_count=V))
    state.balances = [spec.MAX_EFFECTIVE_BALANCE] * V
    state.validator_registry = [
        spec.Validator(
            pubkey=pubkey_of(i), withdrawal_credentials=bytes(32),
            activation_eligibility_epoch=spec.GENESIS_EPOCH,
            activation_epoch=spec.GENESIS_EPOCH,
            exit_epoch=spec.FAR_FUTURE_EPOCH,
            withdrawable_epoch=spec.FAR_FUTURE_EPOCH,
            effective_balance=spec.MAX_EFFECTIVE_BALANCE)
        for i in range(V)]
    root = active_index_root(spec, np.arange(V), dev)
    for i in range(spec.LATEST_ACTIVE_INDEX_ROOTS_LENGTH):
        state.latest_active_index_roots[i] = root
    state.slot = slot
    return state


def slot_attestations(spec, state, slot: int, sign_with=None):
    """Fully participating attestations of every committee of `slot`
    (< state.slot), consistent with `state` (the checks of
    process_attestation). sign_with(committee, message, domain) gives the
    signature; without it the signature stays zero (BLS off)."""
    spe = spec.SLOTS_PER_EPOCH
    epoch = spec.slot_to_epoch(slot)
    per_slot = spec.get_epoch_committee_count(state, epoch) // spe
    start = spec.get_epoch_start_shard(state, epoch)
    current = epoch == spec.get_current_epoch(state)
    source = ((state.current_justified_epoch, state.current_justified_root)
              if current else
              (state.previous_justified_epoch, state.previous_justified_root))
    out = []
    for k in range(per_slot):
        shard = (start + per_slot * (slot % spe) + k) % spec.SHARD_COUNT
        committee = spec.get_crosslink_committee(state, epoch, shard)
        lineage = (state.current_crosslinks if current
                   else state.previous_crosslinks)[shard]
        data = spec.AttestationData(
            beacon_block_root=spec.get_block_root_at_slot(state, slot),
            source_epoch=source[0], source_root=source[1],
            target_epoch=epoch, target_root=spec.get_block_root(state, epoch),
            crosslink=spec.Crosslink(
                shard=shard, start_epoch=lineage.end_epoch,
                end_epoch=min(epoch, lineage.end_epoch + spec.MAX_EPOCHS_PER_CROSSLINK),
                parent_root=spec.hash_tree_root(lineage)))
        bits = full_bitfield(len(committee))
        att = spec.Attestation(aggregation_bitfield=bits, data=data,
                               custody_bitfield=bytes(len(bits)))
        if sign_with is not None:
            msg = spec.hash_tree_root(
                spec.AttestationDataAndCustodyBit(data=data, custody_bit=False))
            att.signature = sign_with(committee, msg, spec.get_domain(
                state, spec.DOMAIN_ATTESTATION, epoch))
        out.append(att)
    return out


def key_of(index: int) -> int:
    """Validator i's secret key in the block drive: 64 keypairs cycled."""
    return index % N_KEYS + 1


def sign_committee(committee, msg, domain) -> bytes:
    """One signature under the sum of the members' keys: the aggregate of
    their signatures (host, untimed staging)."""
    return bls_host.sign(msg, sum(key_of(int(i)) for i in committee) % bls_host.r, domain)


def proposed_block(spec, state, attestations=(), exits=(), signed=True, **operations):
    """A block at state.slot (the state already advanced to it) carrying
    the operations (`operations`: further body lists by name, such as
    phase 1's custody_key_reveals), with the proposer's randao reveal and
    signature."""
    block = spec.BeaconBlock(slot=state.slot,
                             parent_root=spec.signing_root(state.latest_block_header))
    block.body.eth1_data.deposit_count = state.deposit_index
    block.body.attestations = list(attestations)
    block.body.voluntary_exits = list(exits)
    for name, ops in operations.items():
        setattr(block.body, name, list(ops))
    if signed:
        key = key_of(spec.get_beacon_proposer_index(state))
        epoch = spec.get_current_epoch(state)
        block.body.randao_reveal = bls_host.sign(
            spec.hash_tree_root(epoch), key,
            spec.get_domain(state, spec.DOMAIN_RANDAO, epoch))
        block.signature = bls_host.sign(
            spec.signing_root(block), key,
            spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER))
    return block


def publish_and_verify(spec, state, atts, v, sync):
    """One slot's attestations published as SSZ through a GossipRouter whose
    subscriber is the firehose `v` (ingest_gossip: decode, indexed item,
    dedup), then pump (staging) and flush (the partial batch launched and
    the ring read back). A second publish of each payload must reach no
    subscriber. Returns (digest per attestation, ms per part, verdicts)."""
    router = GossipRouter()
    digests = []
    router.subscribe("firehose", TOPIC_BEACON_ATTESTATION,
                     lambda _topic, payload: digests.append(
                         v.ingest_gossip(spec, state, payload)))
    payloads = [ssz_impl.serialize(a, spec.Attestation) for a in atts]
    sync()
    t0 = time.perf_counter()
    for payload in payloads:
        if router.publish("peer", TOPIC_BEACON_ATTESTATION, payload) != 1:
            raise AssertionError("gossip: a publish did not reach the firehose")
    t1 = time.perf_counter()
    v.pump()
    sync()
    t2 = time.perf_counter()
    got = v.flush()
    t3 = time.perf_counter()
    if sum(router.publish("peer2", TOPIC_BEACON_ATTESTATION, p) for p in payloads):
        raise AssertionError("gossip: a duplicate publish reached a subscriber")
    if None in digests or sorted(got) != sorted(digests):
        raise AssertionError("gossip: an attestation was not verified")
    ms = {"ingest_ms": (t1 - t0) * 1e3, "pump_ms": (t2 - t1) * 1e3,
          "flush_ms": (t3 - t2) * 1e3, "verify_ms": (t3 - t0) * 1e3}
    return digests, ms, got


def drive_blocks(spec, V: int, n_blocks: int, sync, dev):
    """The object entry with BLS on: ResidentCore(spec, state) over V
    validators (keys cycled over N_KEYS keypairs) at an epoch past
    PERSISTENT_COMMITTEE_PERIOD; n_blocks blocks each carrying the
    attestations of the slot MIN_ATTESTATION_INCLUSION_DELAY before it,
    then the gossip slot (its attestations published through a
    GossipRouter to a StreamingVerifier, pumped and flushed, then the block
    carrying them with spec._streaming_verifier set: every verdict a cache
    hit, no new pipeline launch), then a block with a signed voluntary exit
    (the fallback path), then a block whose attestation signatures BAD_ITEM
    and BAD_ITEM + 1 are swapped, which the batched verify must reject with
    exactly those two items False, then a gossip slot with BAD_ITEM's
    signature swapped (False in the firehose, the block rejected on it).
    After the drive, the gossip-fed block runs again from its pre-state's
    checkpoint bytes on a core of its own, verified synchronously: the
    roots must be equal. Every slot advance and block is one row;
    sha256_launches is the sum of the entry's and the rows' launches (the
    checks after the drive and the host staging between rows are not in
    it). Returns the numbers."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    pubs = [bls_host.privtopub(k + 1) for k in range(N_KEYS)]
    spe = spec.SLOTS_PER_EPOCH
    epoch0 = spec.PERSISTENT_COMMITTEE_PERIOD + 1
    t0 = time.perf_counter()
    state = beacon_state(spec, V, epoch0 * spe, lambda i: pubs[i % N_KEYS], dev)
    out = {"build_s": time.perf_counter() - t0, "blocks": []}
    was_active = spec_bls.bls_active
    spec_bls.bls_active = True
    spec_bls.set_backend("torch")
    backend = spec_bls.get_backend()
    verify_ms, single_ms, verdicts = [], [], []

    def timed_verify(items, _inner=backend.verify_indexed_batch):
        t = time.perf_counter()
        res = _inner(items)
        sync()
        verify_ms.append((time.perf_counter() - t) * 1e3)
        verdicts.append([bool(v) for v in res])
        return res

    def timed_single(*args, _inner=backend.verify):
        t = time.perf_counter()
        res = _inner(*args)
        sync()
        single_ms.append((time.perf_counter() - t) * 1e3)
        return res
    backend.verify_indexed_batch = timed_verify
    backend.verify = timed_single
    core = None
    chain = []          # the accepted blocks, in order (phase networking serves them)
    try:
        counter = sha256_cuda.counter
        n0 = counter.launches
        t0 = time.perf_counter()
        core = ResidentCore(spec, state)
        core._registry_balances_roots()
        sync()
        out["enter_ms"] = (time.perf_counter() - t0) * 1e3
        out["enter_launches"] = counter.launches - n0
        delay = spec.MIN_ATTESTATION_INCLUSION_DELAY

        def advance(slot):
            n0 = counter.launches
            t0 = time.perf_counter()
            core.process_slots(state, slot)
            sync()
            return {"slots_ms": (time.perf_counter() - t0) * 1e3,
                    "slots_launches": counter.launches - n0}

        def apply(block, kind, slots):
            zero_fq_counters()
            verify_ms.clear()
            single_ms.clear()
            verdicts.clear()
            n0 = counter.launches
            before = len(state.current_epoch_attestations)
            t0 = time.perf_counter()
            try:
                core.state_transition(state, block)
                raised = None
            except AssertionError as e:
                raised = e
            sync()
            row = {"kind": kind, "block_ms": (time.perf_counter() - t0) * 1e3,
                   "verify_ms": sum(verify_ms), "single_verifies": len(single_ms),
                   "single_verify_ms": sum(single_ms),
                   "sha256_launches": counter.launches - n0,
                   "attestations": len(state.current_epoch_attestations) - before,
                   **fq_launches(), **slots}
            out["blocks"].append(row)
            if raised is None:
                chain.append(block)
            return row, raised

        slot = epoch0 * spe + delay
        for b in range(n_blocks):
            slot += 1
            slots = advance(slot)
            t0 = time.perf_counter()
            block = proposed_block(spec, state, slot_attestations(
                spec, state, slot - delay, sign_committee))
            staged_s = time.perf_counter() - t0
            row, raised = apply(block, "attestations", slots)
            row["staging_s"] = staged_s
            if raised is not None:
                raise raised
            if row["attestations"] != len(block.body.attestations):
                raise AssertionError(f"block {b}: {row['attestations']} attestations kept")
            if not launched_path(row):
                raise AssertionError(f"block {b} verified without the kernels: {row}")

        # the gossip slot: its attestations through the router and the
        # firehose, then the block carrying them served from its cache
        v = streaming.StreamingVerifier(backend=backend, target_groups=FIREHOSE_G,
                                        deadline_ms=FIREHOSE_DEADLINE_MS,
                                        register=False)

        def gossip_block(kind, swap):
            slot_now = state.slot + 1
            slots = advance(slot_now)
            atts = slot_attestations(spec, state, slot_now - delay, sign_committee)
            if swap:
                atts[BAD_ITEM].signature = atts[BAD_ITEM + 1].signature
            block = proposed_block(spec, state, atts)
            pre = core.checkpoint_bytes() if not swap else None
            zero_fq_counters()
            digests, ms, got = publish_and_verify(spec, state, atts, v, sync)
            g = {"verify": ms, "verify_launches": fq_launches(),
                 "false_at": [k for k, d in enumerate(digests) if not got[d]]}
            if g["false_at"] != ([BAD_ITEM] if swap else []):
                raise AssertionError(f"gossip: verdicts False at {g['false_at']}")
            hits0, launches0 = tele_count("firehose.cache_hits"), v.pipeline.launches
            spec._streaming_verifier = v
            try:
                row, raised = apply(block, kind, slots)
            finally:
                spec._streaming_verifier = None
            g["cache_hits"] = tele_count("firehose.cache_hits") - hits0
            g["new_launches"] = v.pipeline.launches - launches0
            g["block_ms"], g["attestations"] = row["block_ms"], len(atts)
            if g["cache_hits"] != len(atts) or g["new_launches"] or row["verify_ms"]:
                raise AssertionError(f"gossip block: {g['cache_hits']} cache hits,"
                                     f" {g['new_launches']} new launches, verify"
                                     f" {row['verify_ms']} ms")
            return g, raised, pre, block

        g, raised, gossip_pre, block = gossip_block("gossip-fed (firehose cache)", False)
        if raised is not None:
            raise raised
        slot = int(state.slot)
        g["root"] = core._state_root(state).hex()
        out["gossip"] = {"good": g, "pre": gossip_pre,
                         "block": ssz_impl.serialize(block, spec.BeaconBlock)}

        slot += 1
        slots = advance(slot)
        leaver = (spec.get_beacon_proposer_index(state) + 1) % V
        exit_op = spec.VoluntaryExit(epoch=spec.get_current_epoch(state),
                                     validator_index=leaver)
        exit_op.signature = bls_host.sign(
            spec.signing_root(exit_op), key_of(leaver),
            spec.get_domain(state, spec.DOMAIN_VOLUNTARY_EXIT, exit_op.epoch))
        forest = core.res.registry_forest
        _, raised = apply(proposed_block(spec, state, exits=[exit_op]),
                          "voluntary exit (fallback)", slots)
        if raised is not None:
            raise raised
        if core.mirrors["exit_epoch"][leaver] == spec.FAR_FUTURE_EPOCH:
            raise AssertionError("the voluntary exit did not land")
        if core.res.registry_forest is not forest:
            raise AssertionError("the fallback rebuilt the registry forest")
        out["exit_pairs_per_level"] = list(forest.last_pairs_per_level)

        slot += 1
        slots = advance(slot)
        atts = slot_attestations(spec, state, slot - delay, sign_committee)
        atts[BAD_ITEM].signature, atts[BAD_ITEM + 1].signature = \
            atts[BAD_ITEM + 1].signature, atts[BAD_ITEM].signature
        row, raised = apply(proposed_block(spec, state, atts), "2 swapped signatures", slots)
        if raised is None:
            raise AssertionError("the block with swapped signatures was accepted")
        # the raise is the batched verdict's: one batched verify ran, exactly
        # the two swapped items read False, and the assertion that failed is
        # the one after the verify in process_attestations_batched
        expected = [k not in (BAD_ITEM, BAD_ITEM + 1) for k in range(len(atts))]
        if verdicts != [expected]:
            raise AssertionError(f"bad block: batched verdicts {verdicts}, expected"
                                 f" only items {BAD_ITEM} and {BAD_ITEM + 1} False")
        where = traceback.extract_tb(raised.__traceback__)[-1]
        if where.name != "process_attestations_batched":
            raise AssertionError(f"bad block raised in {where.name}, not after the"
                                 f" batched verify: {raised!r}")
        out["bad_block_verdicts"] = verdicts[0]

        # a gossip attestation with a swapped signature reads False in the
        # firehose, and the block carrying it is rejected on that verdict
        g, raised, _, _ = gossip_block("gossip-fed, 1 swapped signature (rejected)", True)
        if raised is None:
            raise AssertionError("the gossip-fed block with a swapped signature was accepted")
        where = traceback.extract_tb(raised.__traceback__)[-1]
        if where.name != "process_attestations_batched":
            raise AssertionError(f"gossip bad block raised in {where.name}: {raised!r}")
        out["gossip"]["bad"] = g
        out["sha256_launches"] = out["enter_launches"] + sum(
            r["slots_launches"] + r["sha256_launches"] for r in out["blocks"])
        root = core._state_root(state)
        # not JSON: phase networking pops it
        out["chain"] = {"blocks": chain, "finalized_epoch": int(state.finalized_epoch),
                        "finalized_root": bytes(state.finalized_root)}
    finally:
        del backend.verify_indexed_batch, backend.verify
        spec_bls.bls_active = was_active
        if core is not None:
            core.exit()
    # the registry as objects again, rooted by the bulk path
    if ssz_bulk.state_root_bulk(state, dev) != root:
        raise AssertionError("resident root != bulk root of the exited state")
    # the gossip-fed block's synchronous twin: the same block from its
    # pre-state's checkpoint bytes on a core of its own, its attestations
    # through verify_indexed_batch
    gossip = out["gossip"]
    spec_bls.bls_active = True
    twin = None
    t0 = time.perf_counter()
    try:
        twin_state = ssz_impl.deserialize(gossip.pop("pre"), spec.BeaconState)
        twin = ResidentCore(spec, twin_state)
        t1 = time.perf_counter()
        twin.state_transition(twin_state, ssz_impl.deserialize(
            gossip.pop("block"), spec.BeaconBlock))
        sync()
        gossip["twin_block_ms"] = (time.perf_counter() - t1) * 1e3
        twin_root = twin._state_root(twin_state).hex()
    finally:
        spec_bls.bls_active = was_active
        if twin is not None:
            twin.exit()
    gossip["twin_s"] = time.perf_counter() - t0
    if twin_root != gossip["good"]["root"]:
        raise AssertionError("gossip-fed block root != its synchronous twin's")
    out["shape"] = {"validators": V, "attestations_per_block": len(atts),
                    "committee": len(spec.get_crosslink_committee(
                        state, spec.get_current_epoch(state),
                        atts[0].data.crosslink.shard))}
    return out


def drive_reference(spec, V: int, n_blocks: int, dev):
    """The same kind of drive through ResidentCore and through the port's
    unpatched object model (core.suspended(): spec.process_slots /
    spec.process_block), BLS off, from a state n_blocks // 2 slots before
    the end of epoch 2 across the boundary: each block carries the
    attestations of the slot MIN_ATTESTATION_INCLUSION_DELAY before it.
    Per-slot state roots and full roots must agree after every block, and
    the serialized states at the end."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    spe = spec.SLOTS_PER_EPOCH
    state = beacon_state(spec, V, 3 * spe - n_blocks // 2, lambda i: i.to_bytes(48, "little"), dev)
    ref, res = copy.deepcopy(state), state
    was_active = spec_bls.bls_active
    spec_bls.bls_active = False
    core = ResidentCore(spec, res)
    t0 = time.perf_counter()
    try:
        for _ in range(n_blocks):
            slot = res.slot + 1
            core.process_slots(res, slot)
            with core.suspended():
                spec.process_slots(ref, slot)
                block = proposed_block(spec, ref, slot_attestations(
                    spec, ref, slot - spec.MIN_ATTESTATION_INCLUSION_DELAY),
                    signed=False)
                spec.process_block(ref, block)
            core.state_transition(res, copy.deepcopy(block))
            if list(res.latest_state_roots) != list(ref.latest_state_roots):
                raise AssertionError(f"slot {slot}: per-slot roots differ")
            if core._state_root(res) != ssz_impl.hash_tree_root(ref):
                raise AssertionError(f"slot {slot}: state roots differ")
    finally:
        core.exit()
        spec_bls.bls_active = was_active
    if ssz_impl.serialize(res, spec.BeaconState) != ssz_impl.serialize(ref, spec.BeaconState):
        raise AssertionError("serialized states differ")
    return {"s": time.perf_counter() - t0, "blocks": n_blocks,
            "slots": (int(state.slot) - n_blocks, int(state.slot))}


def spec_path(dev, sync, v_resume=V_RESUME, v_blocks=V_BLOCKS,
              v_reference=V_REFERENCE):
    """The spec-path phase: the resume drive (kernel pair hash, then the
    same drive with the plain pair hash, roots and bytes compared), the
    block drive, the reference drive. Returns the numbers."""
    spec = phase0.get_spec("mainnet", device=dev)
    out = {}
    t0 = time.perf_counter()
    data = resume_state_bytes(spec, v_resume, SEED + 3, dev)
    out["resume_build_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    out["resume"] = drive_resume(spec, data, sync)
    out["resume"]["validators"] = v_resume
    out["resume"]["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if out["resume"]["launches"] <= 0:
        raise AssertionError("the resume drive never launched sha256_pairs")
    plain_spec = phase0.Phase0Spec(load_preset("mainnet"), device=dev,
                                   pair_fn=sha256.sha256_pairs)
    n0 = sha256_cuda.counter.launches
    t0 = time.perf_counter()
    plain = drive_resume(plain_spec, data, sync)
    out["resume_plain_s"] = time.perf_counter() - t0
    out["resume_plain_launches"] = sha256_cuda.counter.launches - n0
    if out["resume_plain_launches"]:
        raise AssertionError("the plain drive launched the kernel")
    if plain["roots"] != out["resume"]["roots"] or plain["written"] != out["resume"]["written"]:
        raise AssertionError("resume drive: kernel roots/bytes != plain pair hash")
    del plain, out["resume"]["written"]
    torch.cuda.empty_cache()
    out["resilience"] = drive_resilience(spec, data, out["resume"], sync)
    torch.cuda.empty_cache()
    out["mesh"] = drive_mesh(spec, data, out["resume"], sync, spec.device)
    del data
    out["resume"]["roots"] = len(out["resume"]["roots"])
    out["resume"]["final_root"] = out["resume"]["final_root"].hex()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    out["blocks"] = drive_blocks(spec, v_blocks, N_SPEC_BLOCKS, sync, dev)
    out["blocks"]["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["api"] = drive_api(spec, v_blocks, sync, dev)
    out["reference"] = drive_reference(spec, v_reference, N_REFERENCE_BLOCKS, dev)
    out["reference"]["validators"] = v_reference
    return out



def report_spec_path(sp) -> dict:
    """Print the spec-path phase's lines; returns its launches per kernel
    (the resume and block drives), raising if the block drive launched no
    pair hash."""
    r = sp["resume"]
    log(f"phase spec resume: V={r['validators']:,} mainnet, state bytes built from columns"
        f" in {sp['resume_build_s']:.1f} s (untimed) | from_checkpoint + roots"
        f" {r['enter_ms']:.1f} ms, {r['enter_launches']} launches | per-slot root ms"
        f" min / median / max {min(r['slot_ms']):.2f} / {float(np.median(r['slot_ms'])):.2f}"
        f" / {max(r['slot_ms']):.2f} over {len(r['slot_ms'])} slots, launches"
        f" {r['slot_launches']} | boundary slot {r['boundary_ms']:.1f} ms (stage"
        f" {r['boundary_parts_ms']['stage']:.1f} / device {r['boundary_parts_ms']['device']:.1f}"
        f" / refresh {r['boundary_parts_ms']['refresh']:.1f}), {r['boundary_launches']}"
        f" launches | checkpoint write {r['write_ms']:.1f} ms ({r['bytes']:,} bytes),"
        f" {r['write_launches']} launches | resume {r['resume_ms']:.1f} ms,"
        f" {r['resume_launches']} launches | sha256_pairs launches {r['launches']}"
        f" (entry + slots + boundary + write + resume) | peak device memory"
        f" {r['peak_device_gib']:.2f} GiB")
    log(f"phase spec resume checks: {r['roots']} per-slot roots and the written bytes =="
        f" the same drive with the plain pair hash on the card ({sp['resume_plain_s']:.1f} s,"
        f" {sp['resume_plain_launches']} kernel launches); the resumed core writes the"
        f" same bytes and has the same root")
    rs = sp["resilience"]
    for k, sv in enumerate(rs["save"]):
        log(f"phase resilience: CheckpointStore save {k + 1} (slot {sv['slot']}):"
            f" checkpoint_bytes {sv['write_ms']:.1f} ms, frame + write + fsync + rename"
            f" {sv['save_ms']:.1f} ms, {sv['frame_bytes']:,} frame bytes")
    on, off = rs["boundary_ms"][True], rs["boundary_ms"][False]
    log(f"phase resilience: boundary slot with the tripwire {on:.1f} ms, without"
        f" {off:.1f} ms, the tripwire itself {rs['tripwire_ms']:.3f} ms (one host read)"
        f" = {rs['tripwire_share'] * 100:.2f}% of the guarded boundary (the reference's"
        f" bound: under 3%; {'met' if rs['tripwire_share'] < 0.03 else 'MISSED'}); the"
        f" same root either way")
    log(f"phase resilience: poison of the balance column (leaf 6) at the boundary:"
        f" tripwire False, FatalDispatchError with consumed_inputs after"
        f" {rs['fatal_ms']:.1f} ms | restore of generation 1 {rs['restore_ms']:.1f} ms"
        f" (against the 3,000 ms resume limit), replay of {rs['replay_slots']} slots"
        f" {rs['replay_ms']:.1f} ms, restore + replay {rs['restore_ms'] + rs['replay_ms']:.1f}"
        f" ms, sha256_pairs launches {rs['recovery_launches']} (recovery) | every"
        f" replayed root == the unfaulted drive's")
    log(f"phase resilience: a raise at the boundary retried once before the program ran,"
        f" every later root == the unfaulted drive's | generation 2 truncated by 33 bytes"
        f" on write: restore fell back to generation 1 in {rs['fallback_ms']:.1f} ms,"
        f" corrupt_generations 1 | counter deltas {rs['counts']}")
    for label, snap in zip(("before", "after"), rs["health"]):
        log(f"phase resilience health {label} resilience.reset(): {json.dumps(snap)}")
    a = sp["api"]
    log(f"phase api: BeaconNodeAPI V={a['validators']:,} mainnet (state built in"
        f" {a['build_s']:.1f} s, untimed), BLS on the torch backend | duties of 16 pubkeys"
        f" {a['duties_ms']:.1f} ms == get_committee_assignment | bulk state root installed"
        f" on the card from here | produce_block"
        f" {a['produce_ms']:.1f} ms | swapped signature rejected with 400 in"
        f" {a['reject_ms']:.1f} ms, head unchanged | publish_block {a['publish_ms']:.1f} ms"
        f" (deepcopy {a['publish_deepcopy_ms']:.1f} + transition"
        f" {a['publish_ms'] - a['publish_deepcopy_ms']:.1f}; the block's limit 2,000 ms),"
        f" fq_mul {a['publish_fq']['fq_mul']} / fq_bilinear {a['publish_fq']['fq_bilinear']}"
        f" / fq_bilinear_chain {a['publish_fq']['fq_bilinear_chain']} /"
        f" {programs(a['publish_fq'])} / sha256_pairs"
        f" {a['publish_sha256']} launches | head root == the block through ResidentCore |"
        f" attestation produced and queued | /metrics {a['metrics_lines']} resilience"
        f" lines, /healthz with firehose and checkpoint")
    b = sp["blocks"]
    for row in b["blocks"]:
        log(f"phase spec block: {row['kind']}, {row['attestations']} attestations appended |"
            f" slots before it {row['slots_ms']:.1f} ms, {row['slots_launches']} launches |"
            f" state_transition {row['block_ms']:.1f} ms, of which verify_indexed_batch"
            f" {row['verify_ms']:.1f} ms and {row['single_verifies']} single verifies"
            f" {row['single_verify_ms']:.1f} ms | fq_mul {row['fq_mul']} / fq_bilinear"
            f" {row['fq_bilinear']} / fq_bilinear_chain {row['fq_bilinear_chain']} /"
            f" {programs(row)} / sha256_pairs {row['sha256_launches']} launches"
            + (f" | host signing {row['staging_s']:.1f} s (untimed)"
               if "staging_s" in row else ""))
    shape = b["shape"]
    bad = [k for k, v in enumerate(b["bad_block_verdicts"]) if not v]
    log(f"phase spec blocks: V={shape['validators']:,} mainnet, object entry"
        f" ResidentCore(spec, state) {b['enter_ms']:.1f} ms ({b['enter_launches']}"
        f" launches), state built in {b['build_s']:.1f} s (untimed) |"
        f" {shape['attestations_per_block']} attestations of {shape['committee']} a block,"
        f" BLS on the torch backend | the exit re-hashed {b['exit_pairs_per_level']}"
        f" pairs per level | the block with 2 swapped signatures: batched verdict False"
        f" at items {bad} only, AssertionError from process_attestations_batched |"
        f" sha256_pairs launches {b['sha256_launches']} (entry + slots + blocks)"
        f" | peak device memory {b['peak_device_gib']:.2f} GiB")
    gs = b["gossip"]
    for name, label in (("good", "the gossip slot"),
                        ("bad", "the gossip slot with 1 swapped signature")):
        g, ms = gs[name], gs[name]["verify"]
        log(f"phase gossip: {label}: {g['attestations']} attestations published as SSZ"
            f" through the GossipRouter (a duplicate publish reached 0 subscribers) |"
            f" firehose verify {ms['verify_ms']:.1f} ms (ingest {ms['ingest_ms']:.1f} /"
            f" pump, the staging {ms['pump_ms']:.1f} / flush {ms['flush_ms']:.1f}),"
            f" fq_mul {g['verify_launches']['fq_mul']} / fq_bilinear"
            f" {g['verify_launches']['fq_bilinear']} / fq_bilinear_chain"
            f" {g['verify_launches']['fq_bilinear_chain']} / {programs(g['verify_launches'])}"
            f" launches, False at"
            f" {g['false_at']} |"
            f" block state_transition {g['block_ms']:.1f} ms with {g['cache_hits']} cache"
            f" hits and {g['new_launches']} new pipeline launches")
    sync_ms = [row["block_ms"] for row in b["blocks"] if row["kind"] == "attestations"]
    log(f"phase gossip checks: the gossip-fed block's root == the same block run"
        f" synchronously from its pre-state's checkpoint bytes on a core of its own"
        f" (block {gs['twin_block_ms']:.1f} ms, {gs['twin_s']:.1f} s with the entry); the"
        f" swapped attestation read False in the firehose and its block was rejected in"
        f" process_attestations_batched | this run's synchronous attestation blocks"
        f" {min(sync_ms):.1f}-{max(sync_ms):.1f} ms")
    ref = sp["reference"]
    log(f"phase spec reference: V={ref['validators']:,} mainnet, {ref['blocks']} blocks, slots"
        f" {ref['slots'][0]}-{ref['slots'][1]} across the epoch boundary: per-slot roots,"
        f" state roots after every block and the serialized states == the port's object"
        f" model ({ref['s']:.1f} s)")
    spec_launches = {
        "sha256_pairs": r["launches"] + b["sha256_launches"],
        **{k: sum(row[k] for row in b["blocks"]) for k in FQ_COUNTERS}}
    if b["sha256_launches"] <= 0:
        raise AssertionError("the block drive never launched sha256_pairs")
    return spec_launches


def drive_fork_choice(dev, seed: int):
    """The fork-choice duty at mainnet scale: a Store over a DAG of
    FORK_CHOICE_BLOCKS blocks with forks (each block's parent among the
    eight before it), latest messages of V_FORK_CHOICE validators to random
    blocks from `seed` (a tenth vote again later, at higher slots), random
    effective balances, 2% inactive. fork_choice.lmd_ghost -- get_head's
    vote sum and head walk -- on the card (the scatter-add of the votes)
    must equal the same call on the CPU, head and subtree weights. Timed
    per call (the head comes back to the host, so the host clock holds the
    device work)."""
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    store = fork_choice.Store()

    def root(i):
        return hashlib.sha256(i.to_bytes(8, "little")).digest()

    store.add_block(root(0), SimpleNamespace(slot=0), None)
    for i in range(1, FORK_CHOICE_BLOCKS):
        parent = int(rng.integers(max(0, i - 8), i))
        store.add_block(root(i), SimpleNamespace(slot=store.slots[parent] + int(
            rng.integers(1, 3))), store.roots[parent])
    V = V_FORK_CHOICE
    first = rng.integers(0, FORK_CHOICE_BLOCKS, V)
    for b in range(FORK_CHOICE_BLOCKS):
        store.on_attestation(np.flatnonzero(first == b), store.roots[b], store.slots[b])
    later = rng.choice(V, V // 10, replace=False)
    again = rng.integers(0, FORK_CHOICE_BLOCKS, later.shape[0])
    for b in range(FORK_CHOICE_BLOCKS):
        store.on_attestation(later[again == b], store.roots[b], store.slots[b] + 64)
    balances = rng.integers(17, 33, V).astype(np.int64) * 10 ** 9
    active = np.flatnonzero(rng.random(V) >= 0.02)
    build_s = time.perf_counter() - t0
    start = store.roots[0]

    def head(device):
        return fork_choice.lmd_ghost(store, balances, active, start, device=device)

    def times(device, reps):
        out = []
        for _ in range(reps):
            t = time.perf_counter()
            h = head(device)
            out.append((time.perf_counter() - t) * 1e3)
        return h, out

    got, card_ms = times(dev, FORK_CHOICE_REPS + 1)        # the first call is cold
    want, cpu_ms = times("cpu", 3)
    if got != want:
        raise AssertionError("fork choice: the head on the card != the CPU path's")
    w_card = fork_choice.subtree_weights(store, balances, active, dev)
    w_cpu = fork_choice.subtree_weights(store, balances, active, "cpu")
    if not (w_card == w_cpu).all():
        raise AssertionError("fork choice: subtree weights differ between card and CPU")
    forks = sum(len(c) > 1 for c in store.children)
    return {"validators": V, "blocks": FORK_CHOICE_BLOCKS, "forks": forks,
            "voting": int((store.msg_target >= 0).sum()), "active": int(active.shape[0]),
            "build_s": build_s, "cold_ms": card_ms[0], "card_ms": card_ms[1:],
            "cpu_ms": cpu_ms, "head_index": store.block_index[got],
            "head_slot": store.slots[store.block_index[got]]}


# ---------------------------------------------------------------------------
# Slice 10: the conformance vectors emitted from the card
# ---------------------------------------------------------------------------

# the signature-bearing corpus rows of tests/test_bls_corpus_jax.py
VECTORS_CORPUS_ROWS = (
    ("attestation", "test_success"),
    ("attestation", "test_invalid_attestation_signature"),
    ("block_header", "test_success_block_header"),
    ("block_header", "test_invalid_sig_block_header"),
    ("proposer_slashing", "test_success"),
    ("proposer_slashing", "test_invalid_sig_1"),
    ("deposit", "test_new_deposit"),
    ("deposit", "test_invalid_sig_new_deposit"),
    ("voluntary_exit", "test_success"),
    ("voluntary_exit", "test_invalid_signature"),
)
SUITE_KEYS = ("title", "summary", "forks_timeline", "forks", "config", "runner",
              "handler", "test_cases")
# worker processes of the mainnet emission, each with its own CUDA context:
# a suite's time is host-bound (the launches of its signatures, hashlib
# roots, YAML), and the card is idle most of it
VECTORS_WORKERS = 6


def load_yaml(path):
    """yaml.safe_load of a file, through libyaml's safe loader where the
    installation has it (the same documents, faster)."""
    with open(path) as fh:
        return yaml.load(fh, Loader=getattr(yaml, "CSafeLoader", yaml.SafeLoader))


def emit(creator, out_dir: Path, preset: str, argv):
    """run_generator("vectors", [creator], ...): the CLI's own entry point, one
    suite. Returns (path, ms, launches by kernel counted from 0)."""
    from consensus_specs_tpu_torch.generators.base import run_generator
    zero_counts()
    (written,), ms = fenced_ms(lambda: run_generator(
        "vectors", [creator], ["-o", str(out_dir), "-p", preset, *argv]))
    return Path(written), ms, counts()


def emit_suite(index: int, out_dir: str, argv):
    """One suite of suites.all_creators() (by index) emitted at mainnet with
    BLS on through "torch", in a worker process of drive_vectors' pool;
    its file reloaded as YAML and its header checked. Returns the suite's
    row: name, ms, cases, bytes and launches by kernel (this process's
    counters, from 0)."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    from consensus_specs_tpu_torch.generators import suites
    spec_bls.bls_active = True
    spec_bls.set_backend("torch")
    path, ms, launches = emit(suites.all_creators()[index], Path(out_dir), "mainnet", argv)
    doc = load_yaml(path)
    missing = [k for k in SUITE_KEYS if k not in doc]
    if missing or doc["config"] != "mainnet" or not doc["test_cases"]:
        raise AssertionError(f"vectors: {path} lacks {missing} or its cases")
    return {"suite": f"{doc['runner']}/{doc['handler']}", "ms": ms,
            "cases": len(doc["test_cases"]), "bytes": path.stat().st_size,
            "launches": launches}


def table_creators(bls_default: bool):
    """Every table family's creators (operations, epoch_processing,
    sanity), replaying with BLS on or off by default."""
    from consensus_specs_tpu_torch.generators import suites
    return [(lambda preset, device="cuda", r=r, h=h, m=m: suites._replay(
                r, h, m, preset, bls_default=bls_default, device=device))
            for r, tables in (("operations", suites.OPERATION_TABLES),
                              ("epoch_processing", suites.EPOCH_TABLES),
                              ("sanity", suites.SANITY_TABLES))
            for h, m in tables.items()]


def rederive_bls(bls_dir: Path, dev):
    """Every sign_msg, priv_to_pub, aggregate_sigs and aggregate_pubkeys
    vector of the emitted BLS family (computed by the host bignum curve)
    re-derived through TorchBackend on the card, every msg_hash_g2_*
    vector through bls_torch.hash_to_g2_batch; raises on any difference.
    Returns vectors by handler."""
    tb = bls_torch.TorchBackend(dev)

    def cases(handler):
        return load_yaml(bls_dir / handler / f"{handler}_mainnet.yaml")["test_cases"]

    def hexb(s):
        return bytes.fromhex(s[2:])

    derive = {
        "sign_msg": lambda i: tb.sign(hexb(i["message"]), int(i["privkey"], 16), i["domain"]),
        "priv_to_pub": lambda i: tb.privtopub(int(i, 16)),
        "aggregate_sigs": lambda i: tb.aggregate_signatures([hexb(s) for s in i]),
        "aggregate_pubkeys": lambda i: tb.aggregate_pubkeys([hexb(p) for p in i]),
    }
    done = {}
    for handler, fn in derive.items():
        cs = cases(handler)
        for c in cs:
            if "0x" + fn(c["input"]).hex() != c["output"]:
                raise AssertionError(f"vectors bls {handler}: the card != the vector "
                                     f"for input {c['input']}")
        done[handler] = len(cs)
    for handler in ("msg_hash_g2_uncompressed", "msg_hash_g2_compressed"):
        cs = cases(handler)
        pts = bls_torch.hash_to_g2_batch(
            [(hexb(c["input"]["message"]), c["input"]["domain"]) for c in cs], dev)
        for c, (x, y) in zip(cs, pts):
            if handler == "msg_hash_g2_uncompressed":
                got = [[hex(x.c0), hex(x.c1)], [hex(y.c0), hex(y.c1)]]
            else:
                z = bls_host.compress_g2((x, y))
                got = ["0x" + z[:48].hex(), "0x" + z[48:].hex()]
            if got != c["output"]:
                raise AssertionError(f"vectors bls {handler}: hash_to_g2_batch on the card"
                                     f" != the vector for input {c['input']}")
        done[handler] = len(cs)
    return done


def drive_vectors(dev):
    """phase vectors: the conformance-vector generators of the port
    (consensus_specs_tpu_torch.generators) on the card.

    (a) run_generator for every family of suites.all_creators() at the
        mainnet preset with --device <dev> --accel, BLS on through the
        "torch" backend, one suite a call in VECTORS_WORKERS worker
        processes (emit_suite): each suite's ms, cases and launches by
        kernel, the emission's wall time; every file reloads as YAML with
        the suite header's keys;
    (b) the 10 signature-bearing corpus rows (VECTORS_CORPUS_ROWS) in
        generator mode at minimal, BLS on: "torch" with the spec on the
        card against the port's bignum "python" with the spec on the CPU,
        artifacts equal dict for dict;
    (c) every vector of (a)'s BLS family re-derived on the card
        (rederive_bls);
    (d) every table family at minimal with BLS off by default: the card
        route (--device <dev> --accel, "torch" for the rows that force
        BLS on) against the host route (--device cpu, no bulk root,
        "python"), YAML bytes equal.
    Raises on any failure; nothing is caught and carried on."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    from consensus_specs_tpu_torch.generators import suites
    from consensus_specs_tpu_torch.generators.from_tables import table
    device = str(dev)
    card = ["--device", device, "--accel"]
    host = ["--device", "cpu"]
    out = {"suites": [], "corpus": [], "routes": []}
    old_backend, was_active = spec_bls._active_backend_name, spec_bls.bls_active
    tmp = Path(tempfile.mkdtemp(prefix="vectors-"))
    try:
        spec_bls.bls_active = True
        spec_bls.set_backend("torch")
        # (a) the emission at mainnet, VECTORS_WORKERS suites at a time
        n = len(suites.all_creators())
        t0 = time.perf_counter()
        with ProcessPoolExecutor(VECTORS_WORKERS,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            out["suites"] = list(pool.map(emit_suite, range(n), [str(tmp / "a")] * n,
                                          [card] * n))
        out["emission_s"] = time.perf_counter() - t0
        total = collections.Counter()
        for row in out["suites"]:
            total.update(row["launches"])
        out["launches"] = dict(total)
        if not launched_path(total):
            raise AssertionError(f"vectors: the emission launched {dict(total)}")

        # (b) the BLS corpus: "torch" on the card == the "python" oracle
        for module, case in VECTORS_CORPUS_ROWS:
            fn = getattr(importlib.import_module(table(module)), case)
            spec_bls.set_backend("torch")
            zero_counts()
            got, card_ms = fenced_ms(lambda: fn(
                generator_mode=True, phase="phase0", preset="minimal", bls_active=True,
                device=device))
            launches = counts()
            spec_bls.set_backend("python")
            t0 = time.perf_counter()
            want = fn(generator_mode=True, phase="phase0", preset="minimal",
                      bls_active=True, device="cpu")
            host_ms = (time.perf_counter() - t0) * 1e3
            if got is None or got != want:
                raise AssertionError(f"vectors corpus {module}:{case}: the card's artifacts"
                                     " != the bignum backend's")
            out["corpus"].append({"row": f"{module}:{case}", "card_ms": card_ms,
                                  "host_ms": host_ms, "launches": launches})
        spec_bls.set_backend("torch")

        # (c) the BLS family re-derived on the card
        zero_counts()
        done, ms = fenced_ms(lambda: rederive_bls(tmp / "a" / "tests" / "bls", dev))
        out["bls"] = {"vectors": done, "ms": ms, "launches": counts()}

        # (d) the card route against the host route, minimal, BLS off
        for creator in table_creators(bls_default=False):
            spec_bls.set_backend("torch")
            c_path, c_ms, c_launches = emit(creator, tmp / "card", "minimal", card)
            spec_bls.set_backend("python")
            h_path, h_ms, _ = emit(creator, tmp / "host", "minimal", host)
            if (c_path.relative_to(tmp / "card") != h_path.relative_to(tmp / "host")
                    or c_path.read_bytes() != h_path.read_bytes()):
                raise AssertionError(f"vectors routes: {c_path} != {h_path}")
            out["routes"].append({"suite": str(c_path.parent.relative_to(tmp / "card" / "tests")),
                                  "card_ms": c_ms, "host_ms": h_ms,
                                  "bytes": c_path.stat().st_size, "launches": c_launches})
    finally:
        spec_bls._active_backend_name, spec_bls.bls_active = old_backend, was_active
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def report_vectors(v) -> None:
    def kernels(launches):
        return (f"sha256_pairs {launches['sha256_pairs']} / fq_mul {launches['fq_mul']} /"
                f" fq_bilinear {launches['fq_bilinear']} / chains"
                f" {launches['fq_bilinear_chain']} / {programs(launches)}")

    for s in v["suites"]:
        log(f"phase vectors suite {s['suite']} (mainnet, --accel, BLS on \"torch\"):"
            f" {s['ms']:.1f} ms, {s['cases']} cases, {s['bytes']} bytes | launches"
            f" {kernels(s['launches'])}")
    log(f"phase vectors emission: {len(v['suites'])} suites, "
        f"{sum(s['cases'] for s in v['suites'])} cases, {VECTORS_WORKERS} worker processes:"
        f" {v['emission_s']:.1f} s wall (suites' ms summed"
        f" {sum(s['ms'] for s in v['suites']) / 1e3:.1f} s), every file reloaded as YAML"
        f" with the suite header | launches {kernels(v['launches'])}")
    log("phase vectors corpus (minimal, BLS on): \"torch\" with the spec on the card =="
        " the bignum \"python\" with the spec on the CPU, dict for dict; row card ms /"
        " host ms (card launches fq_mul / fq_bilinear / chains): " + "; ".join(
            f"{r['row']} {r['card_ms']:.1f} / {r['host_ms']:.1f}"
            f" ({r['launches']['fq_mul']} / {r['launches']['fq_bilinear']} /"
            f" {r['launches']['fq_bilinear_chain']})" for r in v["corpus"]))
    b = v["bls"]
    log(f"phase vectors bls: {sum(b['vectors'].values())} vectors re-derived on the card"
        f" == the host bignum's (" + ", ".join(f"{k} {n}" for k, n in b["vectors"].items())
        + f") in {b['ms']:.1f} ms | launches {kernels(b['launches'])}")
    routes = collections.Counter()
    for r in v["routes"]:
        routes.update(r["launches"])
    log(f"phase vectors routes (minimal, BLS off; {len(v['routes'])} table families):"
        " card (--accel) == host (--device cpu) byte for byte; suite card ms / host ms: "
        + "; ".join(f"{r['suite']} {r['card_ms']:.1f} / {r['host_ms']:.1f}"
                    for r in v["routes"])
        + f" | card launches {kernels(routes)}")


# ---------------------------------------------------------------------------
# Slice 11: the deposit contract and networking
# ---------------------------------------------------------------------------

DEPOSIT_TIMESTAMP = 1_606_824_023       # the genesis deposit's block time
SHA256_MANY_LENGTHS = (1, 55, 56, 64, 65, 200)
SHA256_MANY_N = 4_096                   # messages of each length


def drive_deposit(dev, seed: int, sync):
    """phase deposit: a mainnet genesis through the deposit contract,
    CHAIN_START_FULL_DEPOSIT_THRESHOLD (65,536) full deposits made from the
    seed, through the host contract (DepositContract.deposit, one at a
    time: the Eth2Genesis event must fire on the last exactly), the native
    C++ tree (deposit_batch) and the card: the leaves recomputed over the
    contract's fixed chunk shapes (deposit_data_roots, four pair-hash
    launches) equal the host's deposit_data_root, and their tree
    (merkle_root_from_leaves_device, 16 levels, then zerohashes[16..31])
    gives the contract's root. sha256_many on the card equals hashlib at
    SHA256_MANY_LENGTHS. Returns the numbers."""
    t_phase = time.perf_counter()
    zero_fq_counters()
    n = deposit_contract.CHAIN_START_FULL_DEPOSIT_THRESHOLD
    rng = np.random.default_rng(seed)
    pks = rng.integers(0, 256, (n, 48), dtype=np.uint8)
    wcs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sigs = rng.integers(0, 256, (n, 96), dtype=np.uint8)
    vals = np.full(n, deposit_contract.FULL_DEPOSIT_GWEI, dtype=np.uint64)
    rows = [(pks[i].tobytes(), wcs[i].tobytes(), sigs[i].tobytes()) for i in range(n)]
    out = {"deposits": n}

    contract = deposit_contract.DepositContract()
    t0 = time.perf_counter()
    events = [contract.deposit(pk, wc, sig, int(vals[i]), DEPOSIT_TIMESTAMP)
              for i, (pk, wc, sig) in enumerate(rows)]
    out["host_ms"] = (time.perf_counter() - t0) * 1e3
    fired = [i for i, e in enumerate(events) if e is not None]
    if fired != [n - 1] or not contract.chain_started:
        raise AssertionError(f"Eth2Genesis fired at deposits {fired}, not at {n - 1} alone")
    genesis = events[-1]
    root = contract.get_deposit_root()
    if genesis.deposit_root != root or genesis.deposit_count != n.to_bytes(8, "little"):
        raise AssertionError("the genesis event's root or count != the contract's")
    out["genesis_time"] = int.from_bytes(genesis.time, "little")

    t0 = time.perf_counter()
    tree = deposit_native.NativeDepositTree()
    tree.deposit_batch(pks, wcs, sigs, vals)
    out["native_ms"] = (time.perf_counter() - t0) * 1e3
    if tree.get_deposit_root() != root or tree.deposit_count != n:
        raise AssertionError("native deposit tree root != the contract's")

    t0 = time.perf_counter()
    host_leaves = [deposit_contract.deposit_data_root(pk, wc, int(vals[i]), sig)
                   for i, (pk, wc, sig) in enumerate(rows)]
    out["host_leaves_ms"] = (time.perf_counter() - t0) * 1e3
    sha256_cuda.counter.launches = 0
    sync()
    t0 = time.perf_counter()
    leaves = deposit_contract.deposit_data_roots(pks, wcs, vals, sigs, device=dev)
    out["card_leaves_ms"] = (time.perf_counter() - t0) * 1e3   # words_to_bytes synced
    out["leaves_launches"] = sha256_cuda.counter.launches
    if [leaf.tobytes() for leaf in leaves] != host_leaves:
        raise AssertionError("the card's deposit leaves != deposit_data_root on the host")

    n0 = sha256_cuda.counter.launches
    t0 = time.perf_counter()
    sub = sha256.merkle_root_from_leaves_device(host_leaves, n, device=dev)
    node = sub
    for depth in range(n.bit_length() - 1, deposit_contract.TREE_DEPTH):
        node = _sha(node + zerohashes[depth])
    out["card_root_ms"] = (time.perf_counter() - t0) * 1e3
    out["root_launches"] = sha256_cuda.counter.launches - n0
    if node != root:
        raise AssertionError("the card's deposit root != the contract's")
    out["launches"] = out["leaves_launches"] + out["root_launches"]
    if out["root_launches"] <= 0 or out["leaves_launches"] <= 0:
        raise AssertionError("phase deposit never launched sha256_pairs")

    mrng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    for length in SHA256_MANY_LENGTHS:
        msgs = mrng.integers(0, 256, (SHA256_MANY_N, length), dtype=np.uint8)
        got = sha256.sha256_many(msgs, device=dev)
        for i in range(SHA256_MANY_N):
            if got[i].tobytes() != hashlib.sha256(msgs[i].tobytes()).digest():
                raise AssertionError(f"sha256_many on the card != hashlib at length {length}")
    out["sha256_many_ms"] = (time.perf_counter() - t0) * 1e3
    out["root"] = root.hex()
    out["fq_launches"] = fq_launches()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def report_deposit(d) -> None:
    log(f"phase deposit: {d['deposits']:,} full deposits (mainnet genesis threshold),"
        f" Eth2Genesis on the last exactly (time {d['genesis_time']}) | deposit root"
        f" {d['root'][:16]}.. equal through the host contract ({d['host_ms']:.1f} ms,"
        f" one deposit at a time), the native tree ({d['native_ms']:.1f} ms, one batch)"
        f" and the card (tree of the leaves {d['card_root_ms']:.1f} ms,"
        f" {d['root_launches']} sha256_pairs launches) | leaves on the card"
        f" {d['card_leaves_ms']:.1f} ms ({d['leaves_launches']} launches) == host"
        f" deposit_data_root ({d['host_leaves_ms']:.1f} ms) | sha256_many on the card =="
        f" hashlib at lengths {list(SHA256_MANY_LENGTHS)} x {SHA256_MANY_N}"
        f" ({d['sha256_many_ms']:.1f} ms) | phase {d['seconds']:.1f} s")


def drive_networking(spec, chain, dev, sync):
    """phase networking: one NodeRecord signed and verified through
    TorchBackend on the card (True as signed, False after seq += 1, False
    with another record's signature), then an RPC loopback_pair whose node
    B serves the block drive's chain (mainnet types): hello with
    should_disconnect both ways, beacon_block_roots over the drive's
    slots, beacon_block_headers and beacon_block_bodies; the client
    decodes every body and its hash_tree_root must equal its header's
    body_root, and each header's signing root its block root. A garbage
    wire comes back PARSE_ERROR. Returns the numbers."""
    from consensus_specs_tpu_torch.crypto import bls as spec_bls
    from consensus_specs_tpu_torch.utils.ssz.typing import List as SSZList
    t_phase = time.perf_counter()
    out = {}
    was_active = spec_bls.bls_active
    spec_bls.bls_active = True
    spec_bls.set_backend("torch")
    zero_fq_counters()
    n0 = sha256_cuda.counter.launches
    try:
        ms = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            res = fn()
            sync()
            ms[name] = (time.perf_counter() - t0) * 1e3
            return res
        record = timed("sign", lambda: networking.NodeRecord(
            ip="10.0.0.1", pubkey=bls_host.privtopub(key_of(0))).sign(key_of(0)))
        other = networking.NodeRecord(ip="10.0.0.2", pubkey=bls_host.privtopub(key_of(1)))
        other.sign(key_of(1))
        if not bls_host.PythonBackend().verify(
                bytes(record.pubkey), record.content_digest(), record.signature,
                identity.ENR_SIGNING_DOMAIN):
            raise AssertionError("the card's record signature fails the bignum verify")
        verdicts = [timed("verify", record.verify)]
        record.seq += 1
        verdicts.append(timed("verify_seq_changed", record.verify))
        record.seq -= 1
        record.signature = other.signature
        verdicts.append(timed("verify_other_signature", record.verify))
        if verdicts != [True, False, False]:
            raise AssertionError(f"node record verdicts {verdicts} != [True, False, False]")
        out["record_ms"] = ms
        out["launches"] = fq_launches()
        if not launched_path(out["launches"], decompress=False):
            raise AssertionError(f"the node records did not launch the pairing: {out['launches']}")
    finally:
        spec_bls.bls_active = was_active

    blocks = chain["blocks"]
    roots = [spec.signing_root(b) for b in blocks]
    by_root = dict(zip(roots, blocks))
    head = blocks[-1]
    a, b = rpc.loopback_pair("client", "server")
    mine = rpc.Hello(network_id=1, chain_id=1,
                     latest_finalized_root=chain["finalized_root"],
                     latest_finalized_epoch=chain["finalized_epoch"],
                     best_root=roots[-1], best_slot=int(head.slot))

    def known_root(epoch):
        return chain["finalized_root"] if epoch == chain["finalized_epoch"] else None

    def roots_of(req):
        lo, hi = int(req.start_slot), int(req.start_slot) + int(req.count)
        return rpc.BlockRootsResponse(roots=[
            rpc.BlockRootSlot(block_root=r, slot=int(blk.slot))
            for r, blk in zip(roots, blocks) if lo <= int(blk.slot) < hi])

    def header_of(blk):
        return spec.BeaconBlockHeader(
            slot=blk.slot, parent_root=blk.parent_root, state_root=blk.state_root,
            body_root=spec.hash_tree_root(blk.body, spec.BeaconBlockBody),
            signature=blk.signature)

    def headers_of(req):
        start = roots.index(bytes(req.start_root))
        picked = blocks[start::int(req.skip_slots) + 1][:int(req.max_headers)]
        return rpc.BlockHeadersResponse(headers=ssz_impl.serialize(
            [header_of(blk) for blk in picked], SSZList[spec.BeaconBlockHeader]))

    def bodies_of(req):
        return rpc.BlockBodiesResponse(block_bodies=ssz_impl.serialize(
            [by_root[bytes(r)].body for r in req.block_roots],
            SSZList[spec.BeaconBlockBody]))

    b.register(rpc.HELLO, lambda theirs: mine)
    b.register(rpc.BEACON_BLOCK_ROOTS, roots_of)
    b.register(rpc.BEACON_BLOCK_HEADERS, headers_of)
    b.register(rpc.BEACON_BLOCK_BODIES, bodies_of)
    ms = {}

    def call(name, method, body):
        t0 = time.perf_counter()
        res = a.call(method, body)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return res
    theirs = call("hello", rpc.HELLO, mine)
    stranger = rpc.Hello(**{f: getattr(theirs, f) for f in rpc.Hello.get_field_names()})
    stranger.network_id = 2
    hello = [rpc.should_disconnect(mine, theirs, known_root),
             rpc.should_disconnect(mine, stranger, known_root)]
    if hello != [False, True]:
        raise AssertionError(f"should_disconnect (same network, other network) = {hello}")
    first, last = int(blocks[0].slot), int(head.slot)
    got_roots = call("beacon_block_roots", rpc.BEACON_BLOCK_ROOTS,
                     rpc.BlockRootsRequest(start_slot=first, count=last - first + 1))
    if [(bytes(r.block_root), int(r.slot)) for r in got_roots.roots] != \
            [(r, int(blk.slot)) for r, blk in zip(roots, blocks)]:
        raise AssertionError("beacon_block_roots != the drive's chain")
    got_headers = call("beacon_block_headers", rpc.BEACON_BLOCK_HEADERS, rpc.BlockHeadersRequest(
        start_root=roots[0], start_slot=first, max_headers=len(blocks), skip_slots=0))
    got_bodies = call("beacon_block_bodies", rpc.BEACON_BLOCK_BODIES, rpc.BlockBodiesRequest(
        block_roots=[r.block_root for r in got_roots.roots]))
    t0 = time.perf_counter()
    headers = ssz_impl.deserialize(bytes(got_headers.headers), SSZList[spec.BeaconBlockHeader])
    bodies = ssz_impl.deserialize(bytes(got_bodies.block_bodies), SSZList[spec.BeaconBlockBody])
    if len(headers) != len(blocks) or len(bodies) != len(blocks):
        raise AssertionError(f"{len(headers)} headers, {len(bodies)} bodies for {len(blocks)} blocks")
    for k, (header, body) in enumerate(zip(headers, bodies)):
        if spec.hash_tree_root(body, spec.BeaconBlockBody) != bytes(header.body_root):
            raise AssertionError(f"block {k}: body root != the header's body_root")
        if spec.signing_root(header) != roots[k] or int(header.slot) != int(blocks[k].slot):
            raise AssertionError(f"block {k}: header's signing root != the block root")
    ms["client_check"] = (time.perf_counter() - t0) * 1e3
    _, _, payload = messaging.decode_message(b.handle_wire(b"\xff" * 40))
    if int(ssz_impl.deserialize(payload, rpc.Response).response_code) != rpc.PARSE_ERROR:
        raise AssertionError("a garbage wire did not come back PARSE_ERROR")
    out["rpc_ms"] = ms
    out["rpc"] = {"blocks": len(blocks), "slots": [first, last],
                  "attestations": sum(len(blk.body.attestations) for blk in blocks),
                  "headers_bytes": len(bytes(got_headers.headers)),
                  "bodies_bytes": len(bytes(got_bodies.block_bodies))}
    out["sha256_launches"] = sha256_cuda.counter.launches - n0
    out["seconds"] = time.perf_counter() - t_phase
    return out


def report_networking(nw) -> None:
    r, rm, l = nw["rpc"], nw["rpc_ms"], nw["launches"]
    log("phase networking: node record on TorchBackend, sign / verify / verify after"
        " seq += 1 / verify with another record's signature ms "
        + " / ".join(f"{v:.1f}" for v in nw["record_ms"].values())
        + f" -> True / False / False | launches fq_mul {l['fq_mul']} / fq_bilinear"
        f" {l['fq_bilinear']} / fq_bilinear_chain {l['fq_bilinear_chain']} / fq_redc"
        f" {l['fq_redc']} / {programs(l)} | RPC loopback over the block drive's {r['blocks']} blocks"
        f" (slots {r['slots'][0]}..{r['slots'][1]}, {r['attestations']} attestations,"
        f" mainnet types): hello {rm['hello']:.1f} ms (same network: stay, another:"
        f" drop), beacon_block_roots {rm['beacon_block_roots']:.1f} ms,"
        f" beacon_block_headers {rm['beacon_block_headers']:.1f} ms"
        f" ({r['headers_bytes']} B), beacon_block_bodies"
        f" {rm['beacon_block_bodies']:.1f} ms ({r['bodies_bytes']} B), the client's"
        f" decode and body roots {rm['client_check']:.1f} ms: every body root =="
        f" its header's body_root; garbage wire -> PARSE_ERROR | sha256_pairs"
        f" launches {nw['sha256_launches']} | phase {nw['seconds']:.1f} s")



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
    log("phase device: ptxas fq_points: " + " / ".join(ptxas["fq_points"]))
    sass = {**sass_counts(_nvcc.library_path("fq_mont")),
            **sass_counts(_nvcc.library_path("fq_points"))}
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
    fq_ch = check_chains(rng, dev)
    for label, c in fq_ch["chains"].items():
        sh = c["shape"]
        log(f"phase kernel: fq_bilinear_chain {label} ({c['steps']} steps) bit-identical"
            f" to the plain chain and to its products launched one at a time, lane 0 =="
            f" the bignum field's, at N={c['checked_lanes']} (max_abs_err"
            f" {fq_ch['max_abs_err']}) | {c['lanes']} lanes"
            f" ({'16-thread groups' if sh['groups'] else 'one thread a product'},"
            f" {sh['threads']} threads x {sh['blocks']} blocks): kernel {c['ms']:.4f} ms"
            f" ({c['ms'] / c['steps'] * 1e3:.2f} us a step), one launch per product"
            f" {c['per_product_ms']:.4f} ms, plain {c['plain_ms']:.2f} ms, bound"
            f" {c['bound_ms']:.6f} ms by {c['bound_by']} | phases A / B / C / D of a"
            " step, us (block 0's cycles): " + "; ".join(
                f"{name} x {ph['steps']} "
                + " / ".join(f"{u:.2f}" for u in ph["us_per_step"])
                + " (" + " / ".join(f"{x:.0f}" for x in ph["cycles_per_step"]) + ")"
                for name, ph in c["phases"].items())
            + " | first step's cycles right after the plain chain's kernels / again"
            " right after: " + " / ".join(str(x) for x in c["first_step_cycles"]["cold"])
            + "; " + " / ".join(str(x) for x in c["first_step_cycles"]["warm"]))
    result["fq_chains"] = fq_ch
    torch.cuda.empty_cache()
    pk = check_point_kernels(rng, dev)
    report_point_kernels(pk)
    pp = check_point_programs(rng, dev)
    report_point_programs(pp, fq_ch)
    result["point_programs"] = pp
    result["point_kernels"] = pk

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
            f" {st['fq_mul']} / fq_redc {st['fq_redc']} / fq_bilinear"
            f" {st['fq_bilinear']} / fq_bilinear_chain {st['fq_bilinear_chain']} /"
            f" g2_ladder {st['g2_ladder']} / miller_grouped {st['miller_grouped']} /"
            f" final_exp {st['final_exp']} / point_tree"
            f" {st['point_tree']} launches ({sum(st[k] for k in FQ_COUNTERS)} in all),"
            f" {st['aten_ops']} aten ops (an extra, untimed run) | lanes"
            f" per launch: fq_mul {hist(st['lanes']['fq_mul'])}; fq_bilinear"
            f" {hist(st['lanes']['fq_bilinear'])}; fq_bilinear_chain (steps:lanes)"
            f" {hist(st['lanes']['fq_bilinear_chain'])}; g2_ladder"
            f" {hist(st['lanes']['g2_ladder'])}; miller_grouped (groups:pairs)"
            f" {hist(st['lanes']['miller_grouped'])}; final_exp {hist(st['lanes']['final_exp'])};"
            f" point_tree (curve:lanes) {hist(st['lanes']['point_tree'])}")
    launches, warm = bls["launches"], bls["warm_launches"]
    log(f"phase bls verify: {shape['attestations']} x {shape['committee']}"
        f" ({shape['pubkeys']} pubkeys, {shape['pairs']} pairs per group) |"
        f" cold {bls['verify_cold_ms']:.1f} ms, warm {bls['verify_warm_ms']:.1f} ms,"
        f" corrupted block {bls['verify_corrupt_ms']:.1f} ms | launches (cold / warm)"
        f" fq_mul {launches['fq_mul']} / {warm['fq_mul']}, fq_redc"
        f" {launches['fq_redc']} / {warm['fq_redc']}, fq_bilinear"
        f" {launches['fq_bilinear']} / {warm['fq_bilinear']} (one per tower"
        f" product outside the chains), fq_bilinear_chain"
        f" {launches['fq_bilinear_chain']} / {warm['fq_bilinear_chain']} (family"
        f" {launches['fq_bilinear'] + launches['fq_bilinear_chain']}), g2_ladder"
        f" {launches['g2_ladder']} / {warm['g2_ladder']}, miller_grouped"
        f" {launches['miller_grouped']} / {warm['miller_grouped']}, final_exp"
        f" {launches['final_exp']} / {warm['final_exp']}, point_tree"
        f" {launches['point_tree']} / {warm['point_tree']}"
        f" (stage 1: {bls['stage1_launches']} launches, at most {STAGE1_MAX_LAUNCHES}),"
        f" all {sum(warm[k] for k in FQ_COUNTERS)} warm, plain wide"
        f" products on the card {bls['plain_wide_on_card']},"
        f" aten ops per verify {bls['aten_ops_per_verify']} (an extra, untimed run) |"
        f" peak device memory {bls['peak_device_gib']:.2f} GiB | host staging"
        f" {stage_s:.1f} s (untimed)")
    log(f"phase bls stage 3 split: the host's try-and-increment search of the"
        f" {bls['messages_hashed']} messages alone"
        f" {bls['stage_messages_host_ms']:.1f} ms of the stage's"
        f" {bls['stages']['stage_messages']['ms']:.1f} ms")
    sg = bls["sign"]
    log(f"phase bls sign: TorchBackend.sign ms {[round(t, 1) for t in sg['ms']]} (warm),"
        f" of which the host's hash_to_g2 {sg['host_hash_ms']:.1f} ms | launches per"
        f" signature {sg['launches']} | == the bignum oracle's signature")
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

    # -- the port's own oracle: TorchBackend on the card vs the bignum backend --
    oracle = drive_bls_oracle(dev)
    log("phase bls oracle: TorchBackend on the card == the port's bignum PythonBackend"
        " (\"python\") on the host, verdict, card ms / host ms: " + "; ".join(
            f"{name} {c['verdict']} {c['card_ms']:.1f} / {c['host_ms']:.1f}"
            for name, c in oracle["cases"].items())
        + f" | the card's launches fq_mul {oracle['launches']['fq_mul']} / fq_bilinear"
          f" {oracle['launches']['fq_bilinear']} / chains {oracle['launches']['fq_bilinear_chain']}"
          f" / {programs(oracle['launches'])}")
    result["bls_oracle"] = oracle

    # -- where a launch of the main path's size stands ---------------------------
    small = small_launch_times(bls["warm_lanes"], dev, rng, shape["pairs"])
    log("phase launch: at the verify's most frequent lane counts, ms per eager"
        " call (host and device) / per launch replayed from a CUDA graph: "
        + "; ".join(f"{k} {v['lanes']} lanes {v['call_ms']:.4f} / {v['graph_ms']:.4f}"
                    + (f" (bound {v['bound_ms']:.6f})" if "bound_ms" in v else "")
                    for k, v in small.items()))
    result["small_launch"] = small

    # -- 8. the firehose: the streaming verifier at 128 x 3 ---------------------
    torch.cuda.empty_cache()
    fh = drive_firehose(dev, rng)
    report_firehose(fh)
    result["firehose"] = fh

    # -- 9. the spec path: ResidentCore through the entry points, gossip ------
    torch.cuda.empty_cache()
    sp = spec_path(dev, sync)
    result["spec_path"] = sp
    spec_launches = report_spec_path(sp)
    r, b = sp["resume"], sp["blocks"]
    report_mesh(sp["mesh"], r)

    # -- 9b. slice 8: the epoch bridge, the chunk tree, phase 1, the light client
    torch.cuda.empty_cache()
    s8 = drive_slice8(rng, sync, dev)
    report_slice8(s8)
    result["slice8"] = s8

    # -- 10. fork choice at 1M validators ---------------------------------------
    fc = drive_fork_choice(dev, SEED + 4)
    log(f"phase fork choice: Store of {fc['blocks']} blocks ({fc['forks']} forks),"
        f" latest messages of {fc['voting']:,} of V={fc['validators']:,} validators"
        f" ({fc['active']:,} active), built in {fc['build_s']:.1f} s (untimed) |"
        f" lmd_ghost on the card ms min / median / max {min(fc['card_ms']):.2f} /"
        f" {float(np.median(fc['card_ms'])):.2f} / {max(fc['card_ms']):.2f} over"
        f" {len(fc['card_ms'])} calls (cold {fc['cold_ms']:.1f}), on the CPU median"
        f" {float(np.median(fc['cpu_ms'])):.2f} | head == the CPU path's (block"
        f" {fc['head_index']}, slot {fc['head_slot']}), subtree weights equal")
    result["fork_choice"] = fc

    # -- 10b. slice 10: the conformance vectors from the card ---------------------
    torch.cuda.empty_cache()
    vec = drive_vectors(dev)
    report_vectors(vec)
    result["vectors"] = vec

    # -- 10c. slice 11: the deposit contract and networking ----------------------
    torch.cuda.empty_cache()
    dep = drive_deposit(dev, SEED + 5, sync)
    report_deposit(dep)
    result["deposit"] = dep
    nw = drive_networking(phase0.get_spec("mainnet", device=dev), b.pop("chain"), dev, sync)
    report_networking(nw)
    result["networking"] = nw

    # -- 11. kernels line --------------------------------------------------------
    gossip_launches = b["gossip"]["good"]["verify_launches"]
    kernels = [{
        "name": "sha256_pairs",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/sha256_pairs.cu",
        "replaces": "consensus_specs_tpu/ops/sha256_pallas.py:70",
        "launches": spec_launches["sha256_pairs"],
        "launches_by_path": {"resident_columns": main_launches,
                             "spec_resume": r["launches"],
                             "spec_blocks": b["sha256_launches"],
                             "recovery": sp["resilience"]["recovery_launches"],
                             "epoch_bridge": s8["bridge"]["launches"],
                             "chunk_tree": s8["chunk_tree"]["launches"],
                             "phase1": s8["phase1_launches"]["sha256_pairs"],
                             "api": sp["api"]["publish_sha256"],
                             "mesh": sp["mesh"]["launches"]["sha256_pairs"],
                             "deposit": dep["launches"]},
        # the vectors' states (512 validators) have no Merkle level of
        # bulk._DEVICE_MIN_PAIRS pairs: their roots stay on hashlib; the
        # networking phase's roots (block bodies) are host SSZ
        "launches_off_path": {"vectors": vec["launches"]["sha256_pairs"],
                              "networking": nw["sha256_launches"]},
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
        "launches": spec_launches[name],
        "launches_by_path": {"bls_verify": bls["launches"][name],
                             "spec_blocks": spec_launches[name],
                             "firehose": fh["launches"][name],
                             "gossip_verify": gossip_launches[name],
                             "api": sp["api"]["publish_fq"][name],
                             "phase1": s8["phase1_launches"][name],
                             "light_client": s8["light_client"]["launches"][name],
                             "bls_oracle": oracle["launches"][name],
                             "mesh_pairing": sp["mesh"]["pairing_launches"][name],
                             "vectors": vec["launches"][name],
                             "networking": nw["launches"][name]},
        "launches_off_path": {"deposit": dep["fq_launches"][name]},
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
        "launches": spec_launches["fq_bilinear"],
        "launches_by_path": {"bls_verify": bls["launches"]["fq_bilinear"],
                             "spec_blocks": spec_launches["fq_bilinear"],
                             "firehose": fh["launches"]["fq_bilinear"],
                             "gossip_verify": gossip_launches["fq_bilinear"],
                             "api": sp["api"]["publish_fq"]["fq_bilinear"],
                             "phase1": s8["phase1_launches"]["fq_bilinear"],
                             "light_client": s8["light_client"]["launches"]["fq_bilinear"],
                             "bls_oracle": oracle["launches"]["fq_bilinear"],
                             "mesh_pairing": sp["mesh"]["pairing_launches"]["fq_bilinear"],
                             "vectors": vec["launches"]["fq_bilinear"],
                             "networking": nw["launches"]["fq_bilinear"]},
        "launches_off_path": {"deposit": dep["fq_launches"]["fq_bilinear"]},
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
    # the chains on the path are the decompressions' fixed-exponent powers
    # (pow_abs runs inside the final exponentiation's program):
    # the main entry is stage 1's square root at its 16,384 lanes
    pow_z = fq_ch["chains"][f"fq sqrt {G1_SQRT_LANES}"]
    kernels.append({
        "name": "fq_bilinear_chain",
        "route": "cuda",
        "source": "consensus_specs_tpu_torch/csrc/fq_mont.cu",
        "replaces": "consensus_specs_tpu/ops/fq.py:591",
        "launches": spec_launches["fq_bilinear_chain"],
        "launches_by_path": {"bls_verify": bls["launches"]["fq_bilinear_chain"],
                             "spec_blocks": spec_launches["fq_bilinear_chain"],
                             "firehose": fh["launches"]["fq_bilinear_chain"],
                             "gossip_verify": gossip_launches["fq_bilinear_chain"],
                             "api": sp["api"]["publish_fq"]["fq_bilinear_chain"],
                             "phase1": s8["phase1_launches"]["fq_bilinear_chain"],
                             "light_client": s8["light_client"]["launches"]["fq_bilinear_chain"],
                             "bls_oracle": oracle["launches"]["fq_bilinear_chain"],
                             "mesh_pairing": sp["mesh"]["pairing_launches"]["fq_bilinear_chain"],
                             "vectors": vec["launches"]["fq_bilinear_chain"],
                             "networking": nw["launches"]["fq_bilinear_chain"]},
        "launches_off_path": {"deposit": dep["fq_launches"]["fq_bilinear_chain"]},
        "max_abs_err": fq_ch["max_abs_err"],
        "ms": pow_z["ms"],
        "plain_ms": pow_z["plain_ms"],
        "bound_ms": pow_z["bound_ms"],
        "bound_by": pow_z["bound_by"],
        "library_ms": None,
        "lanes": G1_SQRT_LANES,
        "chain": "fq sqrt",
        "per_product_ms": pow_z["per_product_ms"],
        # the other powers run on the same kernel; pow_abs (bls_jax.py:201)
        # only off the path, the final exponentiation being a program
        "also_replaces": {"fq inv": "consensus_specs_tpu/ops/fq.py:588",
                          "fq2 sqrt": "consensus_specs_tpu/ops/decompress.py:147",
                          "pow_abs": "consensus_specs_tpu/ops/bls_jax.py:201"},
        "by_chain": {label: {k: c[k] for k in ("steps", "lanes", "ms", "per_product_ms",
                                               "plain_ms", "bound_ms", "bound_by")}
                     for label, c in fq_ch["chains"].items()},
        "bit_identical": True,
    })
    def by_path(name):
        return {"bls_verify": bls["launches"][name], "spec_blocks": spec_launches[name],
                "firehose": fh["launches"][name], "gossip_verify": gossip_launches[name],
                "api": sp["api"]["publish_fq"][name], "phase1": s8["phase1_launches"][name],
                "light_client": s8["light_client"]["launches"][name],
                "bls_oracle": oracle["launches"][name],
                "mesh_pairing": sp["mesh"]["pairing_launches"][name],
                "vectors": vec["launches"][name], "networking": nw["launches"][name],
                "deposit": dep["fq_launches"][name]}

    # the ladder runs where a batch of 8 or more messages is hashed on the
    # card (a block's verify, the spec path's blocks, the vectors' BLS
    # family) and in every TorchBackend.sign (the vectors, the node record);
    # the Miller kernel in every pairing
    ladder_paths = ("bls_verify", "spec_blocks", "vectors", "networking")
    for name, rows, main_case, replaces in (
            ("g2_ladder", pk["ladder"], "cofactor 16",
             "consensus_specs_tpu/ops/scalar_mul.py:275"),
            ("miller_grouped", pk["miller"], "16 x 2",
             "consensus_specs_tpu/ops/bls_jax.py:240")):
        paths = by_path(name)
        must = ladder_paths if name == "g2_ladder" else tuple(p for p in paths if p != "deposit")
        r = rows[main_case]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "consensus_specs_tpu_torch/csrc/fq_points.cu",
            "replaces": replaces,
            "launches": spec_launches[name],
            "launches_by_path": {p: paths[p] for p in must},
            "launches_off_path": {p: n for p, n in paths.items() if p not in must},
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "shape": main_case,
            "by_shape": {label: {k: x[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                         for label, x in rows.items()},
            "bit_identical": True,
        })
    # the final exponentiation's program runs in every pairing; the trees'
    # programs where keys or signatures are decompressed and aggregated on
    # the card, as do fq_mul, fq_bilinear and the chains (the decompressions'
    # lift, curve checks, square roots and G2 inversion): a path that only
    # pairs (the firehose, the API's and phase 1's single verifies, the
    # mesh's pairing, a node record) launches none of those
    decompress_paths = ("bls_verify", "spec_blocks", "gossip_verify", "bls_oracle", "vectors")
    for k in kernels:
        if k["name"] in ("fq_mul", "fq_bilinear", "fq_bilinear_chain"):
            for p in [p for p in k["launches_by_path"] if p not in decompress_paths]:
                k["launches_off_path"][p] = k["launches_by_path"].pop(p)
    for name, rows, main_case, replaces, program, must in (
            ("final_exp", pp["final_exp"], "128 x 3", "consensus_specs_tpu/ops/bls_jax.py:351",
             "final_exp_program", tuple(p for p in by_path("final_exp") if p != "deposit")),
            ("point_tree", pp["tree"], "g1 16 x 1024", "consensus_specs_tpu/ops/bls_jax.py:442",
             "tree_program", decompress_paths)):
        paths = by_path(name)
        r = rows[main_case]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "consensus_specs_tpu_torch/csrc/fq_points.cu",
            "program": f"consensus_specs_tpu_torch/ops/fq_points.py::{program}",
            "replaces": replaces,
            "launches": spec_launches[name],
            "launches_by_path": {p: paths[p] for p in must},
            "launches_off_path": {p: n for p, n in paths.items() if p not in must},
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "shape": main_case,
            "by_shape": {label: {k: x[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                         for label, x in rows.items()},
            "bit_identical": True,
        })
    # every tower product's REDC runs inside fq_bilinear now, so no path
    # launches fq_redc; every path must have launched each of the others
    for k in kernels:
        k["on_main_path"] = k["name"] != "fq_redc"
        if k["on_main_path"] and min(k["launches_by_path"].values()) <= 0:
            raise AssertionError(f"a path never launched {k['name']}: "
                                 f"{k['launches_by_path']}")
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
