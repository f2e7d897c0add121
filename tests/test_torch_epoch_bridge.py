"""The port's epoch bridges, chunk-tree handle, forest counters and bulk
state-root hook (consensus_specs_tpu_torch: models/phase0/epoch_soa.py
process_epoch_soa / process_epoch_soa_staged, utils/ssz/bulk.py
ChunkTreeHandle / build_chunk_tree, utils/ssz/incremental.py's
merkle.forest.* counters, models/phase0/helpers.py
install_bulk_state_root) held bit-identical to the JAX package on the CPU.

States are built with the JAX package's testing factories and carried
across as SSZ bytes; every scenario of tests/test_epoch_soa.py runs the
object model's process_epoch and the JAX package's process_epoch_soa on
copies, and the port's bridge on the carried state: the serialized states
must be equal. The handle and the hook follow
tests/test_incremental_merkle.py:229-259 and tests/test_state_root_backend.py.
Minimal preset, BLS off."""
import random
from copy import deepcopy

import numpy as np
import pytest
import torch

from consensus_specs_tpu import telemetry as JTEL
from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.models import phase0 as JP
from consensus_specs_tpu.models.phase0.epoch_soa import \
    process_epoch_soa as j_process_epoch_soa
from consensus_specs_tpu.testing import factories as f
from consensus_specs_tpu.testing.cases.finality import attested_epoch
from consensus_specs_tpu.utils.ssz import bulk as JB
from consensus_specs_tpu.utils.ssz.impl import hash_tree_root, serialize
from consensus_specs_tpu_torch import convert, telemetry
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.models import phase0 as PP
from consensus_specs_tpu_torch.models.phase0 import helpers as PH
from consensus_specs_tpu_torch.models.phase0.epoch_soa import (
    process_epoch_soa, process_epoch_soa_staged)
from consensus_specs_tpu_torch.ops.sha256 import sha256_pairs
from consensus_specs_tpu_torch.utils.ssz import bulk as PB
from consensus_specs_tpu_torch.utils.ssz import impl as PI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

TIMING_KEYS = {"distill", "perm", "device", "writeback"}


@pytest.fixture
def specs():
    j = JP.get_spec("minimal")
    p = PP.get_spec("minimal", device="cpu")
    j_active, p_active = JBLS.bls_active, PBLS.bls_active
    JBLS.bls_active = PBLS.bls_active = False
    j.clear_caches()
    p.clear_caches()
    yield j, p
    JBLS.bls_active, PBLS.bls_active = j_active, p_active
    PH.set_state_root_backend(None)
    j.clear_caches()
    p.clear_caches()


def _to_port(j, p, state):
    return convert.state_from_bytes(p, serialize(state, j.BeaconState))


def _to_boundary(spec, state):
    """Advance to the last slot of the epoch (process_epoch's slot)."""
    if (state.slot + 1) % spec.SLOTS_PER_EPOCH != 0:
        spec.process_slots(
            state, state.slot + spec.SLOTS_PER_EPOCH - 1 - state.slot % spec.SLOTS_PER_EPOCH)


def _same_epoch_transition(j, p, state, staged=False):
    """process_epoch (JAX object model), the JAX package's process_epoch_soa
    and the port's bridge from the same state: equal serialized states.
    Returns the reference's post-state."""
    _to_boundary(j, state)
    ref, jsoa = deepcopy(state), deepcopy(state)
    port = _to_port(j, p, state)
    j.process_epoch(ref)
    j_process_epoch_soa(j, jsoa)
    want = serialize(ref, j.BeaconState)
    assert serialize(jsoa, j.BeaconState) == want
    if staged:
        cols, scal = process_epoch_soa_staged(p, port)
    else:
        timings = {}
        cols, scal = process_epoch_soa(p, port, timings)
        assert timings.keys() == TIMING_KEYS
        assert all(t >= 0 for t in timings.values())
    assert PI.serialize(port, p.BeaconState) == want
    # the returned device columns are the post-transition ones
    assert convert.to_numpy(cols.balance).tolist() == list(ref.balances)
    assert int(convert.to_numpy(scal.latest_start_shard)) == ref.latest_start_shard
    return ref


def _genesis(j):
    return f.seed_genesis_state(j, j.SLOTS_PER_EPOCH * 8)


def _started(j):
    state = _genesis(j)
    f.advance_epoch(j, state)
    f.transition_with_empty_block(j, state)
    return state


# ---------------------------------------------------------------------------
# The fused bridge: tests/test_epoch_soa.py's scenarios
# ---------------------------------------------------------------------------

def test_columns_from_state_matches_jax(specs):
    """The registry's columns on a device, from the state or from the
    caller's numpy columns; resident.py re-exports pad_validator_columns."""
    from consensus_specs_tpu.models.phase0 import epoch_soa as JE
    from consensus_specs_tpu_torch.models.phase0 import epoch_soa as PE
    from consensus_specs_tpu_torch.models.phase0 import resident as PR
    j, p = specs
    state = _genesis(j)
    state.balances[3] = 2 ** 64 - 1          # a uint64 past int64's range
    port = _to_port(j, p, state)
    want = JE.columns_from_state(state)
    for got in (PE.columns_from_state(port, device="cpu"),
                PE.columns_from_state(port, PE.columns_np_from_state(port), device="cpu")):
        assert got._fields == want._fields
        for f in want._fields:
            assert (convert.to_numpy(getattr(got, f)) == np.asarray(getattr(want, f))).all(), f
    assert PR.pad_validator_columns is PE.pad_validator_columns


def test_genesis_epoch_transition(specs):
    j, p = specs
    _same_epoch_transition(j, p, _genesis(j))


def test_empty_epochs(specs):
    j, p = specs
    state = _genesis(j)
    for _ in range(3):
        f.advance_epoch(j, state)
        f.transition_with_empty_block(j, state)
    _same_epoch_transition(j, p, state)


@pytest.mark.parametrize("fill_cur,fill_prev", [(True, False), (True, True), (False, True)])
def test_epochs_with_attestations(specs, fill_cur, fill_prev):
    j, p = specs
    state = _started(j)
    _, _, state = attested_epoch(j, state, current=fill_cur, previous=fill_prev)
    _same_epoch_transition(j, p, state)


def test_justification_and_finalization_parity(specs):
    j, p = specs
    state = _started(j)
    for _ in range(4):
        _, _, state = attested_epoch(j, state, current=True)
        _same_epoch_transition(j, p, deepcopy(state))
    assert state.finalized_epoch > 0    # the scenario reaches finality


def _slashed_and_ejected(j):
    state = _started(j)
    _, _, state = attested_epoch(j, state, current=True, previous=True)
    rng = random.Random(1234)
    current_epoch = j.get_current_epoch(state)
    for i in rng.sample(range(len(state.validator_registry)), 4):
        v = state.validator_registry[i]
        v.slashed = True
        v.exit_epoch = current_epoch + 1
        v.withdrawable_epoch = current_epoch + j.LATEST_SLASHED_EXIT_LENGTH
        state.latest_slashed_balances[current_epoch % j.LATEST_SLASHED_EXIT_LENGTH] += \
            v.effective_balance
    v = state.validator_registry[7]          # at the slashing-penalty epoch
    v.slashed = True
    v.exit_epoch = current_epoch
    v.withdrawable_epoch = current_epoch + j.LATEST_SLASHED_EXIT_LENGTH // 2
    for i in rng.sample(range(len(state.validator_registry)), 5):
        if not state.validator_registry[i].slashed:
            state.validator_registry[i].effective_balance = j.EJECTION_BALANCE
            state.balances[i] = j.EJECTION_BALANCE
    for k in range(6):                       # the activation queue
        nv = f.seed_validator(j, len(state.validator_registry), j.MAX_EFFECTIVE_BALANCE)
        nv.activation_eligibility_epoch = (j.FAR_FUTURE_EPOCH if k % 3 == 0
                                           else current_epoch - k % 2)
        state.validator_registry.append(nv)
        state.balances.append(j.MAX_EFFECTIVE_BALANCE)
    for i in range(0, len(state.validator_registry), 3):
        state.balances[i] = max(0, state.balances[i] - rng.randrange(0, 3 * 10 ** 9))
    return state


def test_slashed_and_ejected_validators(specs):
    """FAR_FUTURE_EPOCH (2**64 - 1, -1 as int64) crosses the host read
    between the program and the object state as uint64."""
    j, p = specs
    ref = _same_epoch_transition(j, p, _slashed_and_ejected(j))
    assert any(v.exit_epoch == j.FAR_FUTURE_EPOCH for v in ref.validator_registry)


@pytest.mark.parametrize("scenario", ["attested", "slashed"])
def test_staged_bridge_on_phase0(specs, scenario):
    """The staged route (stage A, the host read, a second distillation,
    stage B) on a spec without hooks equals process_epoch."""
    j, p = specs
    if scenario == "slashed":
        state = _slashed_and_ejected(j)
    else:
        state = _started(j)
        _, _, state = attested_epoch(j, state, current=True, previous=True)
    _same_epoch_transition(j, p, state, staged=True)


def test_bridge_spans_in_telemetry(specs):
    j, p = specs
    state = _to_port(j, p, _genesis(j))
    _to_boundary(p, state)
    telemetry.reset()
    process_epoch_soa(p, state)
    snap = telemetry.snapshot()["spans"]
    assert {"epoch.distill", "epoch.device", "epoch.writeback"} <= set(snap)
    assert snap["epoch.distill"]["count"] == 2      # columns, then inputs
    assert "epoch.perm" not in snap                 # only with timings


# ---------------------------------------------------------------------------
# Chunk-tree handle and forest counters (test_incremental_merkle.py:229-259)
# ---------------------------------------------------------------------------

def _rand_chunks(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def test_chunk_tree_handle_matches_oracle_and_jax():
    """Roots equal the port's one-shot merkleize and the JAX package's
    (its host Merkleizer: the JAX handle's forest is the counters test's)."""
    rng = np.random.default_rng(11)
    chunks = _rand_chunks(rng, 200)
    handle = PB.build_chunk_tree(chunks, device="cpu")
    assert handle.root() == PB.merkleize_chunk_array(chunks) == JB.merkleize_chunk_array(chunks)
    idx = [7, 100, 199]
    rows = _rand_chunks(rng, 3)
    handle.update(idx, rows)
    chunks[idx] = rows
    assert handle.root() == PB.merkleize_chunk_array(chunks) == JB.merkleize_chunk_array(chunks)
    # three root paths, padded to 4 lanes until they meet (O(dirty * log N))
    assert handle.tree.last_pairs_per_level == [4, 4, 4, 4, 4, 4, 2, 1]
    rows = _rand_chunks(rng, 70)                 # 200 -> 270 crosses 256
    handle.append(rows)
    chunks = np.concatenate([chunks, rows])
    assert handle.root() == PB.merkleize_chunk_array(chunks) == JB.merkleize_chunk_array(chunks)


def test_chunk_tree_handle_defaults_to_the_card():
    if torch.cuda.is_available():
        assert PB.build_chunk_tree(np.zeros((4, 32), np.uint8)).tree.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            PB.build_chunk_tree(np.zeros((4, 32), np.uint8))


def test_handle_owns_its_chunks():
    rng = np.random.default_rng(12)
    chunks = _rand_chunks(rng, 128)
    handle = PB.build_chunk_tree(chunks, device="cpu")
    want = handle.root()
    chunks[:] = 0
    assert handle.root() == want


def test_forest_invalidation_evicts_memo_entries():
    rng = np.random.default_rng(13)
    chunks = _rand_chunks(rng, 256)
    handle = PB.build_chunk_tree(chunks, device="cpu")
    r0 = handle.root()
    key = ("mca", chunks.tobytes())
    assert PB._memo.get(key) == r0
    bytes_before = PB._memo_bytes
    row = _rand_chunks(rng, 1)
    handle.update([11], row)
    assert key not in PB._memo
    assert PB._memo_bytes < bytes_before
    assert PB.merkleize_chunk_array(chunks) == r0
    chunks[11] = row
    assert handle.root() == PB.merkleize_chunk_array(chunks) != r0


def test_rejected_update_leaves_mirror_and_forest():
    rng = np.random.default_rng(14)
    chunks = _rand_chunks(rng, 100)
    handle = PB.build_chunk_tree(chunks, device="cpu")
    r0 = handle.root()
    with pytest.raises(ValueError):              # duplicate indices
        handle.update([3, 3], _rand_chunks(rng, 2))
    with pytest.raises(IndexError):              # past the end
        handle.update([100], _rand_chunks(rng, 1))
    assert np.array_equal(handle._chunks, chunks)
    assert handle.root() == r0 == PB.merkleize_chunk_array(chunks)


def test_pair_fn_reaches_the_handle():
    seen = []

    def probe(words):
        seen.append(int(words.shape[0]))
        return sha256_pairs(words)

    chunks = _rand_chunks(np.random.default_rng(15), 64)
    handle = PB.build_chunk_tree(chunks, device="cpu", pair_fn=probe)
    assert seen == [32, 16, 8, 4, 2, 1]
    assert handle.root() == PB.merkleize_chunk_array(chunks)


def _counter_values(mod):
    return [mod.counter(f"merkle.forest.{k}").value
            for k in ("pair_lanes", "launches", "builds")]


def test_forest_counters_move_as_the_reference():
    """The same build, update and append sequence moves the port's
    merkle.forest.{pair_lanes, launches, builds} as the JAX package's."""
    was_j, was_p = JTEL.enabled(), telemetry.enabled()
    JTEL.set_enabled(True)
    telemetry.set_enabled(True)
    try:
        rng = np.random.default_rng(16)
        chunks = _rand_chunks(rng, 300)
        deltas = []
        for mod, build in ((JTEL, JB.build_chunk_tree),
                           (telemetry, lambda c: PB.build_chunk_tree(c, device="cpu"))):
            before = _counter_values(mod)
            handle = build(chunks)
            handle.update([0, 150, 299], chunks[[5, 6, 7]])
            handle.append(chunks[:300])          # 300 -> 600 crosses 512
            deltas.append([a - b for a, b in zip(_counter_values(mod), before)])
        assert deltas[0] == deltas[1]
        lanes, launches, builds = deltas[1]
        assert builds == 1 and launches > 0 and lanes > 0
    finally:
        JTEL.set_enabled(was_j)
        telemetry.set_enabled(was_p)


# ---------------------------------------------------------------------------
# The bulk state-root hook (tests/test_state_root_backend.py)
# ---------------------------------------------------------------------------

def test_hook_returns_oracle_root(specs):
    j, p = specs
    state = _to_port(j, p, _genesis(j))
    PH.install_bulk_state_root(device="cpu")
    hooked = p.hash_tree_root(state)
    PH.set_state_root_backend(None)
    assert hooked == p.hash_tree_root(state) == PI.hash_tree_root(state) == \
        hash_tree_root(_genesis(j))


def test_hook_is_actually_consulted(specs):
    j, p = specs
    state = _to_port(j, p, f.seed_genesis_state(j, 8))
    seen = []

    def probe(s):
        seen.append(s)
        return None

    PH.set_state_root_backend(probe)
    root = p.hash_tree_root(state)
    assert seen == [state]
    assert root == PI.hash_tree_root(state)


def test_hook_declines_below_min_validators(specs, monkeypatch):
    j, p = specs
    state = _to_port(j, p, _genesis(j))
    calls = []
    real = PB.state_root_bulk
    monkeypatch.setattr(PB, "state_root_bulk",
                        lambda s, d, fn: calls.append(d) or real(s, d, fn))
    n = len(state.validator_registry)
    PH.install_bulk_state_root(min_validators=n + 1, device="cpu")
    assert p.hash_tree_root(state) == PI.hash_tree_root(state)
    assert calls == []
    PH.install_bulk_state_root(min_validators=n, device="cpu")
    assert p.hash_tree_root(state) == PI.hash_tree_root(state)
    assert calls == [torch.device("cpu")]


def test_hook_defaults_to_the_card(specs):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        PH.install_bulk_state_root()
    assert PH._state_root_backend is None


def test_installed_route_hashes_on_the_given_device(specs):
    """At V = 2**15 the registry's pubkey level has 2**15 pairs: the
    installed route hashes it through `pair_fn` on the given device, not
    through hashlib, and the root equals the host route's."""
    _, p = specs
    V = 1 << 15
    state = p.BeaconState(genesis_time=0, deposit_index=V)
    state.validator_registry = [
        p.Validator(pubkey=i.to_bytes(48, "little"),
                    activation_epoch=p.GENESIS_EPOCH,
                    exit_epoch=p.FAR_FUTURE_EPOCH,
                    withdrawable_epoch=p.FAR_FUTURE_EPOCH,
                    effective_balance=p.MAX_EFFECTIVE_BALANCE)
        for i in range(V)]
    state.balances = [p.MAX_EFFECTIVE_BALANCE] * V
    lanes = []

    def probe(words):
        assert words.device.type == "cpu"
        lanes.append(int(words.shape[0]))
        return sha256_pairs(words)

    PB.clear_memo()
    PH.install_bulk_state_root(device="cpu", pair_fn=probe)
    hooked = p.hash_tree_root(state)
    PH.set_state_root_backend(None)
    assert max(lanes) >= V
    PB.clear_memo()
    assert hooked == PB.state_root_bulk(state)      # hashlib throughout
    PB.clear_memo()


def test_transitions_identical_with_and_without_hook(specs):
    """Blocks, attestations and epoch boundaries under the installed root,
    on the port, against the JAX package's run of the same blocks."""
    j, p = specs
    ref = _started(j)
    port = _to_port(j, p, ref)
    PH.install_bulk_state_root(device="cpu")
    for _ in range(j.SLOTS_PER_EPOCH + 2):
        att = f.new_attestation(j, ref)
        block = f.empty_block_next(j, ref)
        block.slot = ref.slot + j.MIN_ATTESTATION_INCLUSION_DELAY
        block.body.attestations.append(att)
        j.state_transition(ref, block)
        p.state_transition(port, convert.block_from_bytes(p, serialize(block, j.BeaconBlock)))
        assert list(port.latest_state_roots) == list(ref.latest_state_roots)
    PH.set_state_root_backend(None)
    assert PI.serialize(port, p.BeaconState) == serialize(ref, j.BeaconState)


def test_resident_core_restores_the_installed_bulk_root(specs):
    """ResidentCore saves the installed state-root backend when it patches
    the spec and puts the same one back when it exits; the restored bulk
    root still roots the exited state as the oracle does."""
    from consensus_specs_tpu_torch.models.phase0.resident import ResidentCore
    j, p = specs
    state = _to_port(j, p, _started(j))
    PH.install_bulk_state_root(device="cpu")
    installed = PH._state_root_backend
    core = ResidentCore(p, state)
    try:
        assert PH._state_root_backend is not installed
        p.process_slots(state, state.slot + 1)
    finally:
        core.exit()
    assert PH._state_root_backend is installed
    assert p.hash_tree_root(state) == PI.hash_tree_root(state)
