"""The port's ResidentCore under a serving mesh
(`ResidentCore(spec, state, mesh=ServingMesh(["cpu"] * 8))`), held
byte-identical to the JAX package's object model, and the single_device
rung, after tests/test_resident.py:276-375, tests/test_resilience.py's
ladder and tests/test_chaos_checkpoint.py::test_restore_across_mesh_shapes:

  1. the serving loop across two epoch boundaries with every column and
     forest level-0 staying as shards on their devices, the cap
     replicated; every per-transition root equal to the object model's;
  2. a registry-mutating block re-entering incrementally (same forests,
     scatter-only updates) and a deposit growing the padded columns and
     the forests across a shard boundary (V 32 -> 33: columns 32 -> 40
     rows, forest capacity 32 -> 64), then a sharded boundary;
  3. an injected failure of the sharded boundary before the program ran
     walks the ladder to single_device: the core re-enters on one device
     and every root still equals the unfaulted drive's; a poisoned shard
     after the program ran is fatal with consumed_inputs;
  4. the ladder's two rungs against the reference's bottom rung;
  5. a checkpoint written under 8 shards restored under 2 and under none,
     and a light core resumed from the same bytes under 4 shards driven
     across a boundary, equal to the single-device core.
Minimal preset, BLS off."""
import numpy as np
import pytest

from consensus_specs_tpu import resilience as JR
from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.models import phase0 as JP
from consensus_specs_tpu.resilience import dispatch as JD
from consensus_specs_tpu.testing import factories
from consensus_specs_tpu.utils.ssz.impl import deserialize, hash_tree_root, serialize
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch import resilience as PR
from consensus_specs_tpu_torch import telemetry as PT
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.models import phase0 as PP
from consensus_specs_tpu_torch.models.phase0 import helpers as PH
from consensus_specs_tpu_torch.models.phase0.resident import (MeshResidentColumns,
                                                             ResidentColumns,
                                                             ResidentCore)
from consensus_specs_tpu_torch.parallel import Replicated, Sharded
from consensus_specs_tpu_torch.parallel.sharding import ServingMesh
from consensus_specs_tpu_torch.resilience import checkpoint as PC
from consensus_specs_tpu_torch.resilience import dispatch as PD
from consensus_specs_tpu_torch.resilience import errors as PErr
from consensus_specs_tpu_torch.resilience import faults as PF
from consensus_specs_tpu_torch.telemetry import watchdog as PW
from consensus_specs_tpu_torch.utils.merkle import tree_depth
from consensus_specs_tpu_torch.utils.ssz import impl as PI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _clean():
    for res in (JR, PR):
        res.reset()
    PT.reset()
    PW.reset()
    yield
    for res in (JR, PR):
        res.reset()
    PT.reset()
    PW.reset()


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
    j.clear_caches()
    p.clear_caches()


def _seed(j, p, validators):
    state = factories.seed_genesis_state(j, validators)
    factories.advance_slots(j, state, 2)
    return state, convert.state_from_bytes(p, serialize(state, j.BeaconState))


def _pblock(j, p, block):
    return convert.block_from_bytes(p, serialize(block, j.BeaconBlock))


def _attestation_block(j, ref):
    att = factories.new_attestation(j, ref)
    block = factories.empty_block_next(j, ref)
    block.slot = ref.slot + j.MIN_ATTESTATION_INCLUSION_DELAY
    block.body.attestations.append(att)
    return block


def _on_mesh(core, mesh):
    res = core.res
    assert isinstance(res, MeshResidentColumns) and core._mesh is mesh
    for col in (*res.cols, res.pubkeys, res.withdrawal_credentials):
        assert isinstance(col, Sharded) and col.devices == mesh.devices
        assert col.rows == mesh.pad_rows(res.v)


def test_resident_sharded_serving_loop(specs):
    j, p = specs
    mesh = ServingMesh(CPU8)
    ref, res = _seed(j, p, 4 * j.SLOTS_PER_EPOCH)
    core = ResidentCore(p, res, mesh=mesh)
    try:
        _on_mesh(core, mesh)
        for i in range(2 * j.SLOTS_PER_EPOCH + 2):
            block = _attestation_block(j, ref)
            j.state_transition(ref, block)
            core.state_transition(res, _pblock(j, p, block))
            assert core._state_root(res) == hash_tree_root(ref), f"block {i}"
        assert j.get_current_epoch(ref) >= 2
        _on_mesh(core, mesh)
        reg = core.res.registry_forest
        assert isinstance(reg.levels[0], Sharded) and reg.levels[0].devices == mesh.devices
        assert isinstance(reg.levels[-1], Replicated)
        assert PT.counter("watchdog.relayout_events").value == 0
    finally:
        core.exit()
    assert PI.serialize(res, p.BeaconState) == serialize(ref, j.BeaconState)
    assert PH._state_root_backend is None


def test_resident_sharded_fallback_and_deposit_growth(specs):
    j, p = specs
    mesh = ServingMesh(CPU8)
    ref, res = _seed(j, p, 4 * j.SLOTS_PER_EPOCH)
    core = ResidentCore(p, res, mesh=mesh)
    try:
        core._state_root(res)
        f_reg, f_bal = core.res.registry_forest, core.res.balances_forest
        V = len(ref.validator_registry)
        assert V % mesh.size == 0 and f_reg.n == V and f_reg.builds == 1

        # slashing: incremental re-entry, the forests survive
        block = factories.empty_block_next(j, ref)
        block.body.proposer_slashings.append(factories.double_proposal(j, ref))
        j.process_slots(ref, block.slot)
        j.process_block(ref, block)
        core.state_transition(res, _pblock(j, p, block))
        assert core.res.registry_forest is f_reg and core.res.balances_forest is f_bal
        assert f_reg.builds == 1
        assert 0 < sum(f_reg.last_pairs_per_level) <= 2 * 2 * f_reg.depth
        assert core._state_root(res) == hash_tree_root(ref)
        _on_mesh(core, mesh)

        # deposit: V -> V + 1 crosses the padding AND the forest capacity
        deposit = factories.stage_deposit(j, ref, V, j.MAX_EFFECTIVE_BALANCE)
        res.latest_eth1_data = convert.state_from_bytes(
            p, serialize(ref, j.BeaconState)).latest_eth1_data
        block = factories.empty_block_next(j, ref)
        block.body.deposits.append(deposit)
        j.process_slots(ref, block.slot)
        j.process_block(ref, block)
        core.state_transition(res, _pblock(j, p, block))
        assert core.res.v == V + 1
        assert core.cols.balance.rows == mesh.pad_rows(V + 1) == 40
        _on_mesh(core, mesh)
        assert core.res.registry_forest is f_reg and f_reg.n == V + 1
        assert f_reg.depth == tree_depth(V + 1) > tree_depth(V)
        assert f_reg.levels[0].rows == 64 and f_reg.builds == 1
        assert len(core._pk_np) == V + 1
        assert core._state_root(res) == hash_tree_root(ref)
        pad = convert.to_numpy(core.cols.activation_epoch)[V + 1:]
        assert (pad == np.uint64(j.FAR_FUTURE_EPOCH)).all()

        # and the next epoch boundary still runs sharded
        target = j.get_epoch_start_slot(j.get_current_epoch(ref) + 1)
        j.process_slots(ref, target)
        core.process_slots(res, target)
        assert core._state_root(res) == hash_tree_root(ref)
        _on_mesh(core, mesh)
    finally:
        core.exit()
    assert PI.serialize(res, p.BeaconState) == serialize(ref, j.BeaconState)


@pytest.fixture(scope="module")
def ckpt():
    """Checkpoint bytes two slots before an epoch boundary, the object
    model's roots across it, built once."""
    j = JP.get_spec("minimal")
    JBLS.bls_active, was = False, JBLS.bls_active
    try:
        state = factories.seed_genesis_state(j, 4 * j.SLOTS_PER_EPOCH)
        factories.advance_slots(j, state, j.SLOTS_PER_EPOCH - 2)
        data = serialize(state, j.BeaconState)
        end = int(state.slot) + 5
        ref = deserialize(data, j.BeaconState)
        j.process_slots(ref, end)
        h = j.SLOTS_PER_HISTORICAL_ROOT
        roots = [bytes(ref.latest_state_roots[s % h]) for s in range(int(state.slot), end)]
    finally:
        JBLS.bls_active = was
    return {"data": data, "end": end, "roots": roots, "final": bytes(hash_tree_root(ref))}


def _drive(core, end):
    state, first = core.state, int(core.state.slot)
    try:
        while state.slot < end:
            core.process_slots(state, state.slot + 1)
        h = core.spec.SLOTS_PER_HISTORICAL_ROOT
        return ([bytes(state.latest_state_roots[s % h]) for s in range(first, end)],
                core._state_root(state))
    finally:
        core._uninstall()


def test_light_core_under_a_mesh_matches_single(specs, ckpt):
    _, p = specs
    got = {}
    for name, mesh in (("mesh", ServingMesh(["cpu"] * 4)), ("single", None)):
        core = ResidentCore.from_checkpoint(p, ckpt["data"], mesh=mesh)
        got[name] = _drive(core, ckpt["end"])
        got[name + "_bytes"] = core.checkpoint_bytes()
    assert got["mesh"] == got["single"] == (ckpt["roots"], ckpt["final"])
    assert got["mesh_bytes"] == got["single_bytes"]


def test_failed_sharded_boundary_walks_to_single_device(specs, ckpt):
    """Three injected raises before the sharded program runs spend the
    guard's pre-dispatch allowance; the ladder's bottom rung re-enters the
    core on one device, the boundary runs there, and the drive equals the
    unfaulted one. Counted, spanned, and /healthz says degraded."""
    _, p = specs
    PF.set_schedule("dispatch:*mesh.epoch*@1-3=raise")
    core = ResidentCore.from_checkpoint(p, ckpt["data"], mesh=ServingMesh(CPU8))
    try:
        assert _drive(core, ckpt["end"]) == (ckpt["roots"], ckpt["final"])
    finally:
        PF.set_schedule(None)
    assert core._mesh is None and type(core.res) is ResidentColumns
    assert PR.ladder().rung_name == "single_device"
    snap = PR.health_snapshot()
    assert snap["status"] == "degraded" and snap["counters"]["degradations.single_device"] == 1
    assert snap["counters"]["retries"] == 2
    assert PT.counter("resilience.faults.raise", always=True).value == 3
    assert PT.counter("watchdog.relayout_events").value == 0
    assert PT.snapshot()["spans"]["resident.degrade_single_device"]["count"] == 1
    core.degrade_to_single_device()                    # idempotent
    assert type(core.res) is ResidentColumns


def test_poisoned_shard_after_the_program_is_fatal(specs, ckpt):
    _, p = specs
    # leaves: 7 columns x 8 shards; leaf 48 is shard 0 of the balance column
    PF.set_schedule("dispatch:*mesh.epoch*@1=poison:48")
    core = ResidentCore.from_checkpoint(p, ckpt["data"], mesh=ServingMesh(CPU8))
    try:
        with pytest.raises(PErr.FatalDispatchError) as ei:
            _drive(core, ckpt["end"])
    finally:
        PF.set_schedule(None)
    assert ei.value.consumed_inputs is True
    assert isinstance(ei.value.__cause__, PErr.CorruptOutput)
    assert PR.ladder().rung_name == "full"
    assert PH._state_root_backend is None


def test_ladder_single_device_rung_like_reference():
    """Both ladders end at single_device and call its hooks there; the
    port has no kernel-swapping rungs between. reset() returns the gauge,
    never a core, and the rung's counter survives it."""
    assert PD.DegradationLadder.RUNGS == ("full", "single_device")
    assert JD.DegradationLadder.RUNGS[-1] == "single_device"
    hits = {"jax": [], "port": []}
    for name, D in (("jax", JD), ("port", PD)):
        lad = D.DegradationLadder()
        cb = lambda n=name: hits[n].append(lad.rung_name)  # noqa: E731
        lad.register_single_device(cb)
        while lad.degrade("test") is not None:
            pass
        assert lad.exhausted and lad.rung_name == "single_device"
        lad.unregister_single_device(cb)
        lad.reset()
        assert lad.rung_name == "full"
        lad.register_single_device(cb)
        lad.unregister_single_device(cb)
        assert lad.degrade("again") is not None and hits[name] == ["single_device"]
        lad.reset()
    assert PT.counter("resilience.degradations.single_device", always=True).value == 2
    assert PR.health_snapshot()["status"] == "ok"


def test_restore_across_mesh_shapes(specs, ckpt, tmp_path):
    """A checkpoint written under 8 shards restores under 2 and under
    none, bit-identically: the payload is logical bytes."""
    _, p = specs
    st = PC.CheckpointStore(tmp_path)
    core8 = ResidentCore.from_checkpoint(p, ckpt["data"], mesh=ServingMesh(CPU8))
    try:
        st.save(core8.checkpoint_bytes())
        want = (core8.checkpoint_bytes(), core8._state_root(core8.state))
    finally:
        core8._uninstall()
    assert want[0] == ckpt["data"]
    for mesh in (ServingMesh(["cpu"] * 2), None):
        gen, core = st.restore(p, mesh=mesh)
        try:
            assert gen == 1 and core._mesh is mesh
            assert (core.checkpoint_bytes(), core._state_root(core.state)) == want
        finally:
            core._uninstall()
    assert want[1] == bytes(hash_tree_root(deserialize(ckpt["data"], JP.get_spec("minimal").BeaconState)))
