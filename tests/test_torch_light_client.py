"""The port's light client (consensus_specs_tpu_torch/light_client/:
multiproofs and the committee-sync protocol) held bit-identical to the JAX
package's on the CPU: every scenario of tests/test_light_client.py and
tests/test_sync_protocol.py runs through both packages, with states built
by the JAX package's testing factories and carried across as SSZ bytes;
node maps, generalized indices, proofs, committees and verdicts must be
equal, and the port's compute_committee must equal its
get_persistent_committee. Minimal preset, BLS off except the two
block-validity cases, which verify through the port's spec.bls on
TorchBackend("cpu")."""
import copy
from random import Random

import pytest

from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.light_client import multiproof as JM
from consensus_specs_tpu.light_client import sync_protocol as JS
from consensus_specs_tpu.models import phase0 as J0
from consensus_specs_tpu.models import phase1 as J1
from consensus_specs_tpu.testing import factories as f
from consensus_specs_tpu.utils.ssz import typing as JT
from consensus_specs_tpu.utils.ssz.impl import deserialize, hash_tree_root, serialize
from consensus_specs_tpu_torch import convert
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.crypto import bls12_381 as bls_host
from consensus_specs_tpu_torch.light_client import multiproof as PM
from consensus_specs_tpu_torch.light_client import sync_protocol as PS
from consensus_specs_tpu_torch.models import phase0 as P0
from consensus_specs_tpu_torch.models import phase1 as P1
from consensus_specs_tpu_torch.ops.bls_torch import TorchBackend
from consensus_specs_tpu_torch.utils.hash import sha256
from consensus_specs_tpu_torch.utils.ssz import impl as PI
from consensus_specs_tpu_torch.utils.ssz import typing as PT

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _bls_off():
    old = JBLS.bls_active, PBLS.bls_active
    JBLS.bls_active = PBLS.bls_active = False
    yield
    JBLS.bls_active, PBLS.bls_active = old


# ---------------------------------------------------------------------------
# Multiproofs (tests/test_light_client.py)
# ---------------------------------------------------------------------------

def test_merkle_tree_nodes_structure():
    leaves = [bytes([i]) * 32 for i in range(4)]
    nodes = PM.merkle_tree_nodes(leaves)
    assert nodes == JM.merkle_tree_nodes(leaves)
    assert nodes[4] == leaves[0] and nodes[7] == leaves[3]
    assert nodes[2] == sha256(leaves[0] + leaves[1])
    assert nodes[1] == sha256(nodes[2] + nodes[3])


def test_single_leaf_proof_roundtrip():
    leaves = [bytes([i]) * 32 for i in range(8)]
    nodes = PM.merkle_tree_nodes(leaves)
    for gidx in (8, 11, 15):
        helpers = PM.get_helper_indices([gidx])
        assert helpers == JM.get_helper_indices([gidx])
        proof = [nodes[i] for i in helpers]
        assert PM.verify_multiproof(nodes[1], [gidx], [nodes[gidx]], proof)
        assert not PM.verify_multiproof(nodes[1], [gidx], [b"\xff" * 32], proof)


def test_multiproof_smaller_than_separate_proofs():
    leaves = [bytes([i]) * 32 for i in range(8)]
    nodes = PM.merkle_tree_nodes(leaves)
    indices = [8, 9, 14]
    helpers = PM.get_helper_indices(indices)
    assert len(helpers) == 3
    assert PM.verify_multiproof(nodes[1], indices, [nodes[i] for i in indices],
                                [nodes[i] for i in helpers])


@pytest.mark.parametrize("seed", range(4))
def test_random_multiproofs(seed):
    rng = Random(seed)
    n = 16
    leaves = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n)]
    nodes = PM.merkle_tree_nodes(leaves)
    k = rng.randrange(1, 6)
    indices = rng.sample(range(n, 2 * n), k)
    helpers = PM.get_helper_indices(indices)
    proof = [nodes[i] for i in helpers]
    values = [nodes[i] for i in indices]
    cases = [(values, proof)]
    if proof:
        bad = list(proof)
        bad[0] = b"\x00" * 32 if bad[0] != b"\x00" * 32 else b"\x01" * 32
        cases.append((values, bad))
    got = [PM.verify_multiproof(nodes[1], indices, v, p) for v, p in cases]
    assert got == [JM.verify_multiproof(nodes[1], indices, v, p) for v, p in cases]
    assert got == [True, False][:len(cases)]


def _demo_types(T):
    class Inner(T.Container):
        w: T.uint64
        r: T.Bytes32

    class Demo(T.Container):
        x: T.uint64
        y: T.List[T.uint64]
        vec: T.Vector[Inner, 2]

    obj = Demo(x=7, y=[5, 6, 7],
               vec=T.Vector[Inner, 2]([Inner(w=1, r=b"\xaa" * 32),
                                       Inner(w=2, r=b"\xbb" * 32)]))
    return obj, Demo


def test_object_tree_and_path_indices_match():
    pobj, ptyp = _demo_types(PT)
    jobj, jtyp = _demo_types(JT)
    nodes = PM.object_tree(pobj, ptyp)
    assert nodes == JM.object_tree(jobj, jtyp)
    assert nodes[1] == PI.hash_tree_root(pobj, ptyp)
    tree = PM.SSZMerkleTree(pobj, ptyp)
    paths = (["x"], ["y", PM.LENGTH_FLAG], ["y", 0], ["vec", 1, "w"], ["vec", 0, "r"])
    idx = [PM.generalized_index_for_path(pobj, ptyp, q) for q in paths]
    assert idx == [JM.generalized_index_for_path(jobj, jtyp, q) for q in paths]
    assert tree.nodes[idx[0]] == (7).to_bytes(8, "little") + b"\x00" * 24
    assert tree.nodes[idx[1]] == (3).to_bytes(32, "little")
    assert tree.nodes[idx[2]][:8] == (5).to_bytes(8, "little")
    assert tree.nodes[idx[3]] == (2).to_bytes(8, "little") + b"\x00" * 24


def test_partial_proves_paths_against_state_root():
    pobj, ptyp = _demo_types(PT)
    jobj, jtyp = _demo_types(JT)
    paths = (["x"], ["y", PM.LENGTH_FLAG], ["vec", 0, "r"])
    partial = PM.SSZMerkleTree(pobj, ptyp).prove(
        [PM.generalized_index_for_path(pobj, ptyp, q) for q in paths])
    jpartial = JM.SSZMerkleTree(jobj, jtyp).prove(
        [JM.generalized_index_for_path(jobj, jtyp, q) for q in paths])
    assert (partial.root, partial.indices, partial.values, partial.proof) == \
        (jpartial.root, jpartial.indices, jpartial.values, jpartial.proof)
    assert partial.verify()
    assert partial.value_at(partial.indices[2]) == b"\xaa" * 32
    assert not PM.MerklePartial(b"\x42" * 32, partial.indices, partial.values,
                                partial.proof).verify()


def test_beacon_state_field_proof():
    """A light client authenticates finalized_epoch against the state root."""
    j, p = J0.get_spec("minimal"), P0.get_spec("minimal", device="cpu")
    jstate = f.seed_genesis_state(j, j.SLOTS_PER_EPOCH * 8)
    jstate.finalized_epoch = 9
    state = convert.state_from_bytes(p, serialize(jstate, j.BeaconState))
    tree = PM.SSZMerkleTree(state, p.BeaconState)
    gidx = PM.generalized_index_for_path(state, p.BeaconState, ["finalized_epoch"])
    assert gidx == JM.generalized_index_for_path(jstate, j.BeaconState, ["finalized_epoch"])
    partial = tree.prove([gidx])
    assert partial.verify()
    assert int.from_bytes(partial.value_at(gidx)[:8], "little") == 9
    assert tree.root == hash_tree_root(jstate, j.BeaconState)


# ---------------------------------------------------------------------------
# The committee-sync protocol (tests/test_sync_protocol.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def specs():
    return J1.get_spec("minimal"), P1.get_spec("minimal", device="cpu")


@pytest.fixture()
def states(specs):
    j, p = specs
    jstate = f.seed_genesis_state(j, j.SLOTS_PER_EPOCH * 8)
    return jstate, convert.state_from_bytes(p, serialize(jstate, j.BeaconState))


def _header(spec, slot):
    return spec.BeaconBlockHeader(slot=slot, parent_root=b"\x01" * 32,
                                  state_root=b"\x02" * 32, body_root=b"\x03" * 32)


def _period_data_equal(a, b, spec_a, spec_b):
    assert (a.validator_count, a.seed, list(a.committee)) == \
        (b.validator_count, b.seed, list(b.committee))
    assert sorted(a.validators) == sorted(b.validators)
    for i in a.validators:
        assert serialize(a.validators[i], spec_a.Validator) == \
            PI.serialize(b.validators[i], spec_b.Validator)


def _committees_match(specs, states, slots):
    j, p = specs
    jstate, state = states
    for shard in range(j.SHARD_COUNT):
        for slot in slots:
            memory = PS.build_validator_memory(p, state, slot, shard, _header(p, slot))
            jmemory = JS.build_validator_memory(j, jstate, slot, shard, _header(j, slot))
            for w in ("earlier_period_data", "later_period_data"):
                _period_data_equal(getattr(jmemory, w), getattr(memory, w), j, p)
            got = PS.compute_committee(p, _header(p, slot), memory)
            assert got == p.get_persistent_committee(state, shard, slot), (shard, slot)
            assert got == JS.compute_committee(j, _header(j, slot), jmemory)
            assert got == j.get_persistent_committee(jstate, shard, slot)
            assert got


def test_reconstructed_committee_matches_full_node(specs, states):
    j, _ = specs
    _committees_match(specs, states, (0, 1, 5, j.SLOTS_PER_EPOCH + 3))


def test_cross_period_handover_matches_full_node(specs, states, monkeypatch):
    """A real two-period handover: a period of 2 epochs, the state past
    epoch 4, so the earlier and later seeds differ."""
    j, p = specs
    for spec in specs:
        monkeypatch.setattr(spec, "PERSISTENT_COMMITTEE_PERIOD", 2)
    for s in states:
        s.slot = 5 * j.SLOTS_PER_EPOCH + 1
    memory = PS.build_validator_memory(p, states[1], states[1].slot, 0,
                                       _header(p, states[1].slot))
    assert memory.earlier_period_data.seed != memory.later_period_data.seed
    _committees_match(specs, states, (states[0].slot - 3, states[0].slot))


def test_period_data_is_registry_free(specs, states):
    j, p = specs
    pd = PS.get_period_data(p, states[1], 0, 2, later=True)
    _period_data_equal(JS.get_period_data(j, states[0], 0, 2, later=True), pd, j, p)
    assert pd.validator_count == len(states[1].validator_registry)
    assert len(pd.committee) == len(states[1].validator_registry) // p.SHARD_COUNT
    assert set(pd.validators) == set(pd.committee)


def _proof(spec, state, shard, slot, sign):
    """A BlockValidityProof for the shard's committee at `slot`, signed on
    the host with the factories' keys (validator i holds key i + 1) when
    `sign`; returns (proof, memory)."""
    header = _header(spec, slot)
    memory = PS.build_validator_memory(spec, state, slot, shard, header)
    committee = PS.compute_committee(spec, header, memory)
    parent = spec.ShardBlock(
        slot=slot, shard=shard, beacon_chain_root=spec.signing_root(header),
        parent_root=spec.ZERO_HASH,
        data=spec.ShardBlockBody(data=b"\x00" * spec.BYTES_PER_SHARD_BLOCK_BODY),
        state_root=spec.ZERO_HASH)
    signature = b"\x00" * 96
    if sign:
        domain = spec.bls_domain(spec.DOMAIN_SHARD_ATTESTER, b"\x00\x00\x00\x00")
        point = None
        for i in committee:
            point = bls_host.ec_add(point, bls_host.decompress_g2(
                bls_host.sign(spec.signing_root(parent), int(i) + 1, domain)))
        signature = bls_host.compress_g2(point)
    nbytes = (len(committee) + 7) // 8
    bitfield = bytes([0xFF] * nbytes)
    tail = len(committee) % 8
    if tail:
        bitfield = bitfield[:-1] + bytes([(1 << tail) - 1])
    return PS.BlockValidityProof(header=header, shard_aggregate_signature=signature,
                                 shard_bitfield=bitfield, shard_parent_block=parent), memory


@pytest.mark.parametrize("signature", ["valid", "corrupted"])
def test_block_validity_proof_on_the_port_backend(specs, states, monkeypatch, signature):
    """BLS on: the aggregate signature of the shard committee verifies
    through the port's spec.bls (TorchBackend on the CPU); one flipped
    bit of it is rejected."""
    _, p = specs
    proof, memory = _proof(p, states[1], 1, 0, sign=True)
    if signature == "corrupted":
        sig = bytearray(proof.shard_aggregate_signature)
        sig[5] ^= 0x01
        proof = copy.copy(proof)
        proof.shard_aggregate_signature = bytes(sig)
    tb = TorchBackend("cpu")
    monkeypatch.setitem(PBLS._backends, "torch_cpu", lambda: tb)
    monkeypatch.setitem(PBLS._backend_cache, "torch_cpu", tb)
    monkeypatch.setattr(PBLS, "_active_backend_name", "torch_cpu")
    PBLS.bls_active = True
    assert PS.verify_block_validity_proof(p, proof, memory) is (signature == "valid")


def test_block_validity_proof_rejects_tampering(specs, states):
    """The anchor and the support checks (BLS off on both packages): the
    untampered proof passes them, a foreign header and an empty bitfield
    do not, with the JAX package's verdicts."""
    j, p = specs
    verdicts = []
    for spec, sp, state in ((j, JS, states[0]), (p, PS, states[1])):
        proof, memory = _proof(spec, state, 1, 0, sign=False)
        bad = sp.BlockValidityProof(
            header=_header(spec, 1), shard_aggregate_signature=proof.shard_aggregate_signature,
            shard_bitfield=proof.shard_bitfield, shard_parent_block=proof.shard_parent_block)
        empty = sp.BlockValidityProof(
            header=proof.header, shard_aggregate_signature=proof.shard_aggregate_signature,
            shard_bitfield=bytes(len(proof.shard_bitfield)),
            shard_parent_block=proof.shard_parent_block)
        verdicts.append([sp.verify_block_validity_proof(spec, x, memory)
                         for x in (proof, bad, empty)])
    assert verdicts[0] == verdicts[1] == [True, False, False]


def _distinct_seed_inputs(spec, state):
    for k in range(spec.LATEST_RANDAO_MIXES_LENGTH):
        state.latest_randao_mixes[k] = bytes([k % 256]) * 32
    for k in range(spec.LATEST_ACTIVE_INDEX_ROOTS_LENGTH):
        state.latest_active_index_roots[k] = bytes([0x40 | (k % 64)]) * 32
    period_start = PS.get_later_start_epoch(spec, 0)
    active = [int(i) for i in spec.get_active_validator_indices(state, period_start)]
    state.latest_active_index_roots[period_start % spec.LATEST_ACTIVE_INDEX_ROOTS_LENGTH] = \
        PI.hash_tree_root(active, PT.List[PT.uint64])


def test_period_data_merkle_partial_roundtrip(specs, states):
    """prove_period_data / verify_period_data against the state root, and
    every tamper of tests/test_sync_protocol.py rejected, on both packages."""
    j, p = specs
    _distinct_seed_inputs(p, states[1])
    jstate = deserialize(PI.serialize(states[1], p.BeaconState), j.BeaconState)
    results = []
    for spec, sp, state, htr in ((j, JS, jstate, hash_tree_root),
                                 (p, PS, states[1], PI.hash_tree_root)):
        root = htr(state, spec.BeaconState)
        pd, proof = sp.prove_period_data(spec, state, slot=0, shard_id=2, later=True)
        tampered = []
        pd_bad = copy.deepcopy(pd)
        pd_bad.validators[sorted(pd_bad.validators)[0]].effective_balance += 1
        pd_bad2 = copy.deepcopy(pd)
        pd_bad2.seed = b"\x55" * 32
        pd_bad3 = copy.deepcopy(pd)
        pd_bad3.committee = ([pd_bad3.committee[1], pd_bad3.committee[0]]
                             + list(pd_bad3.committee[2:]))
        proof_bad = copy.deepcopy(proof)
        proof_bad.active_indices = proof.active_indices[:-1]
        proof_leaf = copy.deepcopy(proof)
        proof_leaf.partial.values[0] = b"\x99" * 32
        for r, d, pr in ((root, pd, proof), (b"\xee" * 32, pd, proof), (root, pd_bad, proof),
                         (root, pd_bad2, proof), (root, pd_bad3, proof),
                         (root, pd, proof_bad), (root, pd, proof_leaf)):
            tampered.append(sp.verify_period_data(spec, r, d, pr, slot=0, shard_id=2,
                                                  later=True))
        results.append((root, proof.partial.indices, proof.partial.values,
                        proof.partial.proof, list(proof.active_indices), tampered))
    assert results[0] == results[1]
    assert results[1][-1] == [True] + [False] * 6


def test_period_data_proof_forgeries_rejected(specs, states):
    """A registry leaf of another validator under a member's claim, and
    seed inputs proven from registry leaves: valid multiproofs of the
    honest root, rejected by verify_period_data."""
    _, p = specs
    state = states[1]
    root = PI.hash_tree_root(state, p.BeaconState)
    pd, _ = PS.prove_period_data(p, state, slot=0, shard_id=2, later=True)
    members = sorted(pd.validators)
    outsider = next(i for i in range(len(state.validator_registry)) if i not in pd.validators)
    tree = PM.SSZMerkleTree(state, p.BeaconState)
    period_start = PS.get_later_start_epoch(p, 0)
    active = [int(i) for i in p.get_active_validator_indices(state, period_start)]

    victim = members[0]
    pd_forged = copy.deepcopy(pd)
    pd_forged.validators[victim] = state.validator_registry[outsider]
    paths = [["validator_registry", PM.LENGTH_FLAG]]
    paths += [["validator_registry", outsider if i == victim else i] for i in members]
    paths += PS._seed_input_paths(p, period_start)
    forged = tree.prove([PM.generalized_index_for_path(state, p.BeaconState, q) for q in paths])
    assert forged.verify()
    assert not PS.verify_period_data(p, root, pd_forged, PS.PeriodDataProof(forged, active),
                                     slot=0, shard_id=2, later=True)

    paths = [["validator_registry", PM.LENGTH_FLAG]]
    paths += [["validator_registry", i] for i in members]
    paths += [["validator_registry", outsider],
              ["validator_registry", (outsider + 1) % len(state.validator_registry)]]
    idxs = [PM.generalized_index_for_path(state, p.BeaconState, q) for q in paths]
    forged2 = tree.prove(idxs)
    assert forged2.verify()
    pd_forged2 = copy.deepcopy(pd)
    pd_forged2.seed = p.hash(forged2.value_at(idxs[-2]) + forged2.value_at(idxs[-1])
                             + p.int_to_bytes(period_start, length=32))
    assert not PS.verify_period_data(p, root, pd_forged2, PS.PeriodDataProof(forged2, active),
                                     slot=0, shard_id=2, later=True)


def test_typed_path_indices_agree_with_value_paths(specs, states):
    j, p = specs
    jstate, state = states
    lengths = {("validator_registry",): len(state.validator_registry)}
    paths = ([["validator_registry", PM.LENGTH_FLAG], ["validator_registry", 0],
              ["validator_registry", 7], ["latest_randao_mixes", 3],
              ["latest_active_index_roots", 1], ["fork"], ["slot"]])
    for q in paths:
        got = PM.generalized_index_for_typed_path(p.BeaconState, q, lengths)
        assert got == PM.generalized_index_for_path(state, p.BeaconState, q), q
        assert got == JM.generalized_index_for_path(jstate, j.BeaconState, q), q
