"""The port's generational checkpoints (consensus_specs_tpu_torch.resilience.
checkpoint) and the guarded epoch boundary of its ResidentCore, on the CPU:

  * frames are byte-identical to the reference's;
  * the store scenarios of tests/test_chaos_checkpoint.py run through both
    packages' stores with the same fault schedules and observe the same
    generations, payloads, typed errors and counters: save, load and
    prune; fallback over corrupt generations; the prune keeping the last
    good one; a silently corrupt save not advancing the last good; an
    empty or all-corrupt store; a kill mid-write; the read-side hook;
  * the port's ResidentCore at the minimal preset (a light core resumed
    from checkpoint bytes built with the JAX package's factories): an
    injected raise at the epoch boundary is retried before the program
    runs, and every root equals the unfaulted drive's; an injected poison
    of the balance column is tripwired into FatalDispatchError with
    consumed_inputs, and restore + replay from the store lands on the
    unfaulted roots, and on the JAX object model's state root."""
import os

import pytest

from consensus_specs_tpu import telemetry as JT
from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.models import phase0 as JP
from consensus_specs_tpu.resilience import checkpoint as JC
from consensus_specs_tpu.resilience import errors as JErr
from consensus_specs_tpu.resilience import faults as JF
from consensus_specs_tpu.testing import factories
from consensus_specs_tpu.utils.ssz.impl import deserialize, hash_tree_root, serialize
from consensus_specs_tpu_torch import telemetry as PT
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.models import phase0 as PP
from consensus_specs_tpu_torch.models.phase0 import helpers as PH
from consensus_specs_tpu_torch.models.phase0.resident import ResidentCore
from consensus_specs_tpu_torch.resilience import checkpoint as PC
from consensus_specs_tpu_torch.resilience import errors as PErr
from consensus_specs_tpu_torch.resilience import faults as PF
from consensus_specs_tpu_torch.resilience import integrity as PI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

PACKAGES = {"jax": (JC, JF, JT, JErr), "port": (PC, PF, PT, PErr)}


@pytest.fixture(autouse=True)
def _clean():
    for faults, tele in ((JF, JT), (PF, PT)):
        faults.set_schedule(None)
        tele.reset()
    yield
    for faults, tele in ((JF, JT), (PF, PT)):
        faults.set_schedule(None)
        tele.reset()


@pytest.mark.parametrize("payload, gen", [(b"", 1), (b"state-bytes" * 99, 7),
                                          (bytes(range(256)) * 3, (1 << 40) + 3)])
def test_frames_byte_identical(payload, gen):
    data = PC.frame(payload, gen)
    assert data == JC.frame(payload, gen)
    assert PC.unframe(data, generation=gen) == JC.unframe(data, generation=gen) == (gen, payload)
    for bad in (data[:10], data[:-3], b"JUNK" + data[4:], data[:9] + bytes([data[9] ^ 1]) + data[10:]):
        for C, E in ((JC, JErr), (PC, PErr)):
            with pytest.raises(E.CheckpointCorrupt):
                C.unframe(bad, generation=gen)


# ---------------------------------------------------------------------------
# Store scenarios, run through both packages
# ---------------------------------------------------------------------------

def _corrupt_count(T):
    return T.counter("resilience.checkpoint.corrupt_generations", always=True).value


def _save_load_prune(C, F, T, E, root):
    st = C.CheckpointStore(root, keep=3)
    gens = [st.save(b"gen%d" % i) for i in range(5)]
    return [gens, st.generations(), st.load(), st.load(generation=4),
            C.last_good_generation()]


def _fallback(C, F, T, E, root):
    st = C.CheckpointStore(root, keep=4)
    st.save(b"good-one")
    F.set_schedule("ckpt.write@1=truncate:9;ckpt.write@2=bitflip:40")
    st.save(b"truncated-on-disk")
    st.save(b"bitflipped-on-disk")
    F.set_schedule(None)
    return [st.generations(), st.load(), _corrupt_count(T), st.load(),
            _corrupt_count(T)]


def _prune_keeps_last_good(C, F, T, E, root):
    st = C.CheckpointStore(root, keep=2)
    st.save(b"the-only-good-one")
    F.set_schedule("ckpt.write@1-99=truncate:15")
    for i in range(5):
        st.save(b"corrupt-%d" % i)
    F.set_schedule(None)
    out = [st.generations(), st.load()]
    st.save(b"fresh-good")
    st.save(b"fresher-good")
    return out + [st.generations(), st.load()]


def _silent_corruption(C, F, T, E, root):
    st = C.CheckpointStore(root)
    st.save(b"good")
    out = [C.last_good_generation()]
    F.set_schedule("ckpt.write@1=truncate:9")
    st.save(b"corrupt-on-disk")
    F.set_schedule(None)
    return out + [C.last_good_generation(), st.load()]


def _empty_and_all_corrupt(C, F, T, E, root):
    st = C.CheckpointStore(root)
    out = []
    with pytest.raises(E.CheckpointCorrupt) as ei:
        st.load()
    out.append(str(ei.value).replace(str(root), "ROOT"))
    F.set_schedule("ckpt.write@1=truncate:999999")
    st.save(b"doomed")
    F.set_schedule(None)
    with pytest.raises(E.CheckpointCorrupt) as ei:
        st.load()
    return out + [str(ei.value), ei.value.generation, _corrupt_count(T)]


def _kill_mid_write(C, F, T, E, root):
    st = C.CheckpointStore(root)
    st.save(b"alpha")
    st.save(b"beta")
    F.set_schedule("ckpt.write@1=crash:0.4")
    with pytest.raises(E.SimulatedCrash) as ei:
        st.save(b"never-lands")
    F.set_schedule(None)
    out = [str(ei.value), st.generations(), st.load(),
           sorted(n for n in os.listdir(st.root) if n.startswith(".tmp-"))]
    return out + [st.save(b"gamma"), st.load()]


def _read_side_hook(C, F, T, E, root):
    st = C.CheckpointStore(root)
    st.save(b"pristine")
    st.save(b"latest")
    F.set_schedule("ckpt.read@1=bitflip:35")
    out = [st.load()]
    F.set_schedule(None)
    return out + [st.load(), _corrupt_count(T), C.last_good_generation()]


@pytest.mark.parametrize("scenario", [
    _save_load_prune, _fallback, _prune_keeps_last_good, _silent_corruption,
    _empty_and_all_corrupt, _kill_mid_write, _read_side_hook],
    ids=lambda f: f.__name__.strip("_"))
def test_store_scenario_matches_reference(scenario, tmp_path):
    seen = {}
    for name, (C, F, T, E) in PACKAGES.items():
        seen[name] = scenario(C, F, T, E, tmp_path / name)
        seen[name].append(T.counter("resilience.checkpoint.saves", always=True).value)
        seen[name].append(sorted(os.listdir(tmp_path / name)))
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------------------------------
# ResidentCore's guarded boundary: raise, poison, restore and replay
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drive():
    """The minimal spec on the CPU, checkpoint bytes two slots past
    genesis (32 validators, JAX factories), the slot to drive to (one
    boundary on the way) and the unfaulted drive's per-slot roots and
    final state root."""
    j = JP.get_spec("minimal")
    p = PP.get_spec("minimal", device="cpu")
    j_active, p_active = JBLS.bls_active, PBLS.bls_active
    JBLS.bls_active = PBLS.bls_active = False
    p.clear_caches()
    state = factories.seed_genesis_state(j, 4 * j.SLOTS_PER_EPOCH)
    factories.advance_slots(j, state, 2)
    data = serialize(state, j.BeaconState)
    end = int(state.slot) + j.SLOTS_PER_EPOCH
    roots, final = _drive(p, data, end)
    yield {"j": j, "p": p, "data": data, "end": end, "roots": roots,
           "final": final}
    JBLS.bls_active, PBLS.bls_active = j_active, p_active


def _drive(p, data, end, core=None):
    """Resume (or take `core`), drive one slot at a time to `end`;
    -> (per-slot roots, final state root)."""
    core = core or ResidentCore.from_checkpoint(p, data)
    try:
        state = core.state
        first = int(state.slot)
        while state.slot < end:
            core.process_slots(state, state.slot + 1)
        h = p.SLOTS_PER_HISTORICAL_ROOT
        roots = [bytes(state.latest_state_roots[s % h]) for s in range(first, end)]
        return roots, core._state_root(state)
    finally:
        core._uninstall()


def _retries():
    return PT.counter("resilience.retries", always=True).value


def test_injected_raise_at_the_boundary_is_retried(drive):
    PF.set_schedule("dispatch:*epoch*@1=raise")
    roots, final = _drive(drive["p"], drive["data"], drive["end"])
    assert (roots, final) == (drive["roots"], drive["final"])
    assert _retries() == 1
    assert PT.counter("resilience.faults_injected", always=True).value == 1


def test_poisoned_boundary_is_fatal_then_restore_and_replay(drive, tmp_path):
    """Leaf 6 (balance, the reference's flatten order) poisoned to the
    uint64 maximum: the tripwire rejects it, the in-place columns make it
    fatal, and the store's generation brings the core back."""
    p, end = drive["p"], drive["end"]
    store = PC.CheckpointStore(tmp_path)
    assert store.save(drive["data"]) == 1
    PF.set_schedule("dispatch:*epoch*@1=poison:6")
    core = ResidentCore.from_checkpoint(p, drive["data"])
    try:
        with pytest.raises(PErr.FatalDispatchError) as ei:
            while core.state.slot < end:
                core.process_slots(core.state, core.state.slot + 1)
    finally:
        core._uninstall()
    assert ei.value.consumed_inputs is True
    assert "CheckpointStore.restore" in str(ei.value)
    assert isinstance(ei.value.__cause__, PErr.CorruptOutput)
    assert PT.counter("resilience.corrupt_outputs", always=True).value == 1
    assert _retries() == 0
    assert PH._state_root_backend is None
    gen, restored = store.restore(p)
    assert gen == 1
    roots, final = _drive(p, None, end, core=restored)
    assert (roots, final) == (drive["roots"], drive["final"])
    # the replayed state is the JAX package's object model's
    j = drive["j"]
    ref = deserialize(drive["data"], j.BeaconState)
    j.process_slots(ref, end)
    assert final == bytes(hash_tree_root(ref))


def test_tripwires_off_lets_the_poison_through(drive):
    """With the tripwire disarmed the poisoned balance reaches the root:
    the check, not luck, is what stopped it above."""
    PI.set_tripwires(False)
    PF.set_schedule("dispatch:*epoch*@1=poison:6")
    try:
        _, final = _drive(drive["p"], drive["data"], drive["end"])
    finally:
        PI.set_tripwires(None)
    assert final != drive["final"]
    assert PT.counter("resilience.faults.poison", always=True).value == 1
