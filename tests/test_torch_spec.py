"""The port's spec object model (consensus_specs_tpu_torch: utils/config,
utils/ssz/{typing,impl,bulk,columns}, crypto/bls, models/phase0/{containers,
helpers,epoch,block,genesis,spec}) held byte-identical to the JAX
package's on the CPU: the same values built with the JAX package cross as
SSZ bytes, and every serialization, root, permutation and transition must
come out the same. Minimal preset, BLS off unless a test records it."""
import hashlib

import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.models import phase0 as JP
from consensus_specs_tpu.testing import factories
from consensus_specs_tpu.utils import config as JC
from consensus_specs_tpu.utils import merkle as JM
from consensus_specs_tpu.utils.ssz import bulk as JB
from consensus_specs_tpu.utils.ssz import impl as JI
from consensus_specs_tpu.utils.ssz import typing as JT
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.models import phase0 as PP
from consensus_specs_tpu_torch.models.phase0.epoch_soa import EpochConfig
from consensus_specs_tpu_torch.ops.sha256 import sha256_pairs
from consensus_specs_tpu_torch.utils import config as PC
from consensus_specs_tpu_torch.utils.ssz import bulk as PB
from consensus_specs_tpu_torch.utils.ssz import impl as PI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


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


def _to_port(p, obj, name):
    return PI.deserialize(JI.serialize(obj, type(obj)), getattr(p, name))


# ---------------------------------------------------------------------------
# Presets and the spec object
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["minimal", "mainnet"])
def test_preset_and_epoch_config_match(name):
    assert dict(PC.load_preset(name).items()) == dict(JC.load_preset(name).items())
    from consensus_specs_tpu.models.phase0.epoch_soa import EpochConfig as JEC
    want = JEC.from_spec(JP.get_spec(name))
    assert tuple(EpochConfig.from_spec(PP.get_spec(name, device="cpu"))) == tuple(want)
    assert tuple(EpochConfig.from_preset(name)) == tuple(want)


@pytest.mark.parametrize("name", ["mainnet", "testing"])
def test_fork_timelines_match(name):
    """configs/fork_timelines/ through both packages; each call a copy."""
    tl = PC.load_fork_timeline(name)
    assert tl == JC.load_fork_timeline(name) and tl["phase0"] == 0
    tl["phase0"] = 99
    assert PC.load_fork_timeline(name)["phase0"] == 0
    for timeline in (tl, {"phase0": 0, "phase1": 100}, PC.load_fork_timeline(name)):
        for epoch in (0, 99, 100, 500, 10 ** 6):
            live = [e for e in timeline.values() if e <= epoch]
            if not live:
                with pytest.raises(AssertionError):
                    PC.fork_at_epoch(timeline, epoch)
                continue
            assert PC.fork_at_epoch(timeline, epoch) == JC.fork_at_epoch(timeline, epoch)


def test_ssz_package_reexports_match():
    """utils/ssz/__init__ exports the reference's names, each the port's
    own typing/impl object."""
    import consensus_specs_tpu.utils.ssz as JS
    import consensus_specs_tpu_torch.utils.ssz as PS
    from consensus_specs_tpu_torch.utils.ssz import typing as PT
    want = sorted(n for n, v in vars(JS).items() if not n.startswith("_")
                  and not isinstance(v, type(JS)))
    assert len(want) == 44
    for n in want:
        assert getattr(PS, n) is getattr(PT, n, None) or getattr(PS, n) is getattr(PI, n), n


def test_spec_and_bls_backend_default_to_the_card():
    """get_spec and the built-in "torch" backend run on "cuda" unless told
    otherwise; without a card they raise instead of using the CPU."""
    if torch.cuda.is_available():
        assert PP.get_spec("minimal").device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        PP.get_spec("minimal")
    with pytest.raises(RuntimeError):
        PBLS._backends["torch"]()
    assert PP.get_spec("minimal", device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# SSZ: every container, random values
# ---------------------------------------------------------------------------

def _random_value(typ, rng, depth=0):
    if JT.is_bool_type(typ):
        return bool(rng.integers(0, 2))
    if JT.is_uint_type(typ):
        raw = rng.integers(0, 256, JT.uint_byte_size(typ), dtype=np.uint8)
        return typ(int.from_bytes(raw.tobytes(), "little"))
    if JT.is_bytes_type(typ):
        return rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8).tobytes()
    if JT.is_bytesn_type(typ):
        return typ(rng.integers(0, 256, typ.length, dtype=np.uint8).tobytes())
    if JT.is_list_type(typ):
        return [_random_value(typ.elem_type, rng, depth + 1)
                for _ in range(int(rng.integers(0, 4 if depth < 2 else 2)))]
    if JT.is_vector_type(typ):
        return typ([_random_value(typ.elem_type, rng, depth + 1)
                    for _ in range(typ.length)])
    if JT.is_container_type(typ):
        return typ(**{f: _random_value(t, rng, depth + 1) for f, t in typ.get_fields()})
    raise TypeError(typ)


@pytest.mark.parametrize("name", sorted(JP.get_spec("minimal").container_types))
def test_container_bytes_and_roots_match(name, specs):
    j, p = specs
    rng = np.random.default_rng(sum(name.encode()))
    for _ in range(2):
        value = _random_value(getattr(j, name), rng)
        data = JI.serialize(value, type(value))
        ported = PI.deserialize(data, getattr(p, name))
        assert PI.serialize(ported, type(ported)) == data
        root = JI.hash_tree_root(value, type(value))
        assert PI.hash_tree_root(ported, type(ported)) == root
        assert PB.hash_tree_root_bulk(ported, type(ported), "cpu") == root
        assert PI.signing_root(ported) == JI.signing_root(value)
        assert PI.serialize(ported.copy(), type(ported)) == data


def test_container_takes_adhoc_attributes(specs):
    _, p = specs
    state = p.BeaconState(slot=5)
    data = PI.serialize(state, p.BeaconState)
    state._proposer_memo = ((5, 0), 3)
    assert PI.serialize(state, p.BeaconState) == data
    assert convert.state_from_bytes(p, data).slot == 5


# ---------------------------------------------------------------------------
# Bulk hashing: the device route of large batches
# ---------------------------------------------------------------------------

def test_hash_pairs_array_device_route_matches_hashlib():
    """A batch of >= 2^15 pairs goes through the pair hash on the caller's
    device (the plain route on the CPU) in one call; a smaller one, or one
    with no device, stays on hashlib. Every route gives hashlib's digests."""
    rng = np.random.default_rng(3)
    n = PB._DEVICE_MIN_PAIRS + 3
    pairs = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    calls = []

    def counting(words):
        calls.append(int(words.shape[0]))
        return sha256_pairs(words)

    want = np.frombuffer(b"".join(hashlib.sha256(r.tobytes()).digest()
                                  for r in pairs), np.uint8).reshape(n, 32)
    assert (PB.hash_pairs_array(pairs, "cpu", counting) == want).all()
    assert calls == [n]
    assert (PB.hash_pairs_array(pairs, "cpu") == want).all()
    assert (PB.hash_pairs_array(pairs) == want).all()
    assert (PB.hash_pairs_array(pairs[:1000], "cpu", counting) == want[:1000]).all()
    assert calls == [n]

    chunks = rng.integers(0, 256, (2 * n + 5, 32), dtype=np.uint8)
    PB.clear_memo()
    root = PB.merkleize_chunk_array(chunks, "cpu", counting)
    assert calls[1] == n + 3         # the first level only
    assert root == JM.merkleize_chunks([c.tobytes() for c in chunks])
    cols = rng.integers(0, 2 ** 63, 9000, dtype=np.uint64)
    assert PB.uint64_list_root_from_column(cols, "cpu") == \
        JB.uint64_list_root_from_column(cols)


def test_registry_column_roots_match():
    """The host column path (validator_leaf_chunks, subtree_roots_batch,
    validator_registry_root_from_columns, uint64_list_root_from_column)
    equals the JAX package's and the port's device path from the same
    columns."""
    rng = np.random.default_rng(4)
    V = 300
    pk = rng.integers(0, 256, (V, 48), dtype=np.uint8)
    wc = rng.integers(0, 256, (V, 32), dtype=np.uint8)
    epochs = [rng.integers(0, 2 ** 64, V, dtype=np.uint64) for _ in range(4)]
    slashed = rng.random(V) < 0.5
    eff = rng.integers(0, 2 ** 64, V, dtype=np.uint64)
    bal = rng.integers(0, 2 ** 64, V, dtype=np.uint64)
    args = (pk, wc, *epochs, slashed, eff)
    leaves = PB.validator_leaf_chunks(*args, "cpu")
    assert np.array_equal(leaves, JB.validator_leaf_chunks(*args))
    assert np.array_equal(PB.subtree_roots_batch(leaves, "cpu"),
                          JB.subtree_roots_batch(leaves))
    reg = PB.validator_registry_root_from_columns(*args, "cpu")
    assert reg == JB.validator_registry_root_from_columns(*args)
    t = [torch.from_numpy(np.ascontiguousarray(a.view(np.int64) if a.dtype == np.uint64 else a))
         for a in (pk, wc, *epochs, slashed, eff, bal)]
    assert PB.registry_and_balances_roots_device(*t) == (
        reg, PB.uint64_list_root_from_column(bal, "cpu"))


# ---------------------------------------------------------------------------
# Helpers: the committee shuffle on the spec's device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 100, 8191, 8192, 8197])
def test_shuffle_permutation_matches(n, specs):
    j, p = specs
    seed = hashlib.sha256(n.to_bytes(4, "little")).digest()
    got = p.get_shuffle_permutation(n, seed)
    assert np.array_equal(got, j.get_shuffle_permutation(n, seed))
    assert p.get_shuffle_permutation(n, seed) is got          # cached


# ---------------------------------------------------------------------------
# Genesis and the object-model transition
# ---------------------------------------------------------------------------

def test_genesis_matches(specs):
    j, p = specs
    eth1 = j.Eth1Data(deposit_root=b"\x42" * 32, block_hash=b"\x07" * 32)
    js = j.get_genesis_beacon_state([], 1234, eth1)
    ps = p.get_genesis_beacon_state([], 1234, _to_port(p, eth1, "Eth1Data"))
    assert PI.serialize(ps, p.BeaconState) == JI.serialize(js, j.BeaconState)
    assert PI.serialize(p.get_genesis_block(ps), p.BeaconBlock) == \
        JI.serialize(j.get_genesis_block(js), j.BeaconBlock)


def test_object_model_drive_matches(specs):
    """The port's unpatched spec functions (process_slots, process_block,
    the object epoch path) over 1.5 epochs of attestation-carrying blocks
    equal the JAX package's, state bytes after every block."""
    j, p = specs
    state = factories.seed_genesis_state(j, 4 * j.SLOTS_PER_EPOCH)
    factories.advance_slots(j, state, 2)
    ps = convert.state_from_bytes(p, JI.serialize(state, j.BeaconState))
    for _ in range(j.SLOTS_PER_EPOCH + j.SLOTS_PER_EPOCH // 2):
        att = factories.new_attestation(j, state)
        block = factories.empty_block_next(j, state)
        block.slot = state.slot + j.MIN_ATTESTATION_INCLUSION_DELAY
        block.body.attestations.append(att)
        j.state_transition(state, block)
        p.state_transition(ps, convert.block_from_bytes(
            p, JI.serialize(block, j.BeaconBlock)))
        assert PI.serialize(ps, p.BeaconState) == JI.serialize(state, j.BeaconState)
    assert j.get_current_epoch(state) >= 1


# ---------------------------------------------------------------------------
# The attestation sink
# ---------------------------------------------------------------------------

class _Recording:
    """A backend that accepts everything and records the block's batched
    indexed-attestation checks."""

    def __init__(self):
        self.batches = []

    def verify(self, *args):
        return True

    def verify_indexed_batch(self, items):
        self.batches.append([
            ([[bytes(pk) for pk in s] for s in sets], [bytes(m) for m in mhs],
             bytes(sig), int(domain))
            for sets, mhs, sig, domain in items])
        return [True] * len(items)


def test_attestation_sink_receives_the_same_checks(specs, monkeypatch):
    """Each package's block processing hands its backend the same
    (pubkey_sets, message_hashes, signature, domain) for the same block,
    asserted once after the attestation loop."""
    j, p = specs
    state = factories.seed_genesis_state(j, 4 * j.SLOTS_PER_EPOCH)
    factories.advance_slots(j, state, 2)
    ps = convert.state_from_bytes(p, JI.serialize(state, j.BeaconState))
    block = factories.empty_block_next(j, state)
    block.slot = state.slot + j.MIN_ATTESTATION_INCLUSION_DELAY
    for slot in (state.slot - 1, state.slot):
        att = factories.new_attestation(j, state, slot)
        att.signature = bytes(range(96))
        block.body.attestations.append(att)
    pblock = convert.block_from_bytes(p, JI.serialize(block, j.BeaconBlock))

    recorders = {}
    for mod in (JBLS, PBLS):
        rec = recorders[mod] = _Recording()
        monkeypatch.setitem(mod._backends, "recording", lambda rec=rec: rec)
        monkeypatch.setitem(mod._backend_cache, "recording", rec)
        monkeypatch.setattr(mod, "_active_backend_name", "recording")
        monkeypatch.setattr(mod, "bls_active", True)
    j.state_transition(state, block)
    p.state_transition(ps, pblock)
    got, want = recorders[PBLS].batches, recorders[JBLS].batches
    assert len(want) == 1 and len(want[0]) == 2
    assert got == want
    assert p._att_verify_sink is None
    assert PI.serialize(ps, p.BeaconState) == JI.serialize(state, j.BeaconState)
