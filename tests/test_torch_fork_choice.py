"""The port's fork choice and validator duties
(consensus_specs_tpu_torch.models.phase0.{fork_choice,validator}) against
the JAX package's on the CPU.

Seeded random block DAGs and votes (ties included) go through both
packages' Store / on_attestation / lmd_ghost, the port summing the votes
on the CPU device: the latest-message arrays, subtree weights and heads
must be equal, and equal to the object-model walk. Duties: a minimal
genesis state built by the JAX package crosses as SSZ bytes, and every
validator's get_committee_assignment and build_attestation_duty
(serialized) must equal the reference's."""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import bls as JBLS
from consensus_specs_tpu.models import phase0 as JP
from consensus_specs_tpu.models.phase0 import fork_choice as JFC
from consensus_specs_tpu.testing import factories
from consensus_specs_tpu.utils.ssz import impl as JI
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.models import phase0 as PP
from consensus_specs_tpu_torch.models.phase0 import fork_choice as PFC
from consensus_specs_tpu_torch.utils.ssz import impl as PI


def _root(i):
    return i.to_bytes(2, "little") + bytes(30)


def _build(FC, rng_seed, n_blocks, V, votes, tie_roots=False):
    """The same seeded DAG and vote stream in one package's Store."""
    rng = random.Random(rng_seed)
    store = FC.Store()
    store.add_block(_root(0), SimpleNamespace(slot=0), None)
    for i in range(1, n_blocks):
        parent = rng.randrange(i)
        slot = store.slots[parent] + (1 if tie_roots else rng.randrange(1, 4))
        store.add_block(_root(i), SimpleNamespace(slot=slot),
                        store.roots[parent])
    for _ in range(votes):
        members = rng.sample(range(V), rng.randrange(1, 6))
        pick = rng.randrange(-1, n_blocks)
        root = b"\x00" * 32 if pick < 0 else store.roots[pick]
        slot = rng.randrange(0, 12)                 # repeats: ties by slot
        store.on_attestation(members, root, slot)
    store.on_attestation([V + 3], _root(n_blocks + 7), 2)   # unknown target
    return store


def _messages(store):
    return {v: (m.slot, m.beacon_block_root)
            for v, m in store.latest_messages.items()}


@pytest.mark.parametrize("seed,n_blocks,ties", [
    (0, 40, False), (1, 40, False), (2, 64, False), (3, 64, True),
    (4, 7, True), (5, 1, False)])
def test_lmd_ghost_matches_reference(seed, n_blocks, ties):
    V = 60
    rng = np.random.default_rng(seed)
    # equal balances where ties are wanted: siblings tie on weight and
    # the higher root wins
    balances = ([32] * V if ties else
                list(rng.integers(1, 32_000_000_000, V, dtype=np.int64)))
    active = sorted(rng.choice(V, size=V - 5, replace=False).tolist())
    j = _build(JFC, seed, n_blocks, V, votes=90, tie_roots=ties)
    p = _build(PFC, seed, n_blocks, V, votes=90, tie_roots=ties)
    assert (p.msg_target == j.msg_target).all()
    assert (p.msg_slot == j.msg_slot).all()
    assert _messages(p) == _messages(j)
    w = PFC.subtree_weights(p, balances, active, "cpu")
    assert w.dtype == np.uint64
    assert (w == JFC.subtree_weights(j, np.asarray(balances, np.uint64),
                                     active)).all()
    for start in {j.roots[0], j.roots[min(3, n_blocks - 1)]}:
        want = JFC.lmd_ghost(j, balances, active, start)
        assert PFC.lmd_ghost(p, balances, active, start, device="cpu") == want
        assert JFC.lmd_ghost_reference(j, balances, active, start) == want
        assert PFC.lmd_ghost_reference(p, balances, active, start) == want


def test_latest_message_rule_bit_for_bit():
    """Higher slot wins, the first observation wins ties, ZERO_HASH is
    genesis, an unknown target is ignored -- one masked write each."""
    stores = []
    for FC in (JFC, PFC):
        s = FC.Store()
        s.add_block(_root(0), SimpleNamespace(slot=0), None)
        s.add_block(_root(1), SimpleNamespace(slot=1), _root(0))
        s.add_block(_root(2), SimpleNamespace(slot=1), _root(0))
        s.on_attestation([0, 4], _root(1), slot=5)
        s.on_attestation([0, 1], _root(2), slot=5)      # tie: first wins
        s.on_attestation([4], _root(2), slot=3)         # older: ignored
        s.on_attestation([1, 2], _root(1), slot=7)      # newer: replaces
        s.on_attestation([3], b"\x00" * 32, slot=2)     # genesis alias
        s.on_attestation([9], _root(9), slot=9)         # unknown: ignored
        s.on_attestation([], _root(1), slot=9)
        stores.append(s)
    j, p = stores
    assert (p.msg_target == j.msg_target).all()
    assert (p.msg_slot == j.msg_slot).all()
    assert p.msg_target.tolist() == [1, 1, 1, 0, 1]
    assert p.get_ancestor(2, 0) == j.get_ancestor(2, 0) == 0


def test_vote_sum_is_exact_int64_and_device_defaults_to_the_card():
    """Balances near 2^35 Gwei summed over many votes stay exact; the
    default device is "cuda" and raises without a card."""
    s = PFC.Store()
    s.add_block(_root(0), SimpleNamespace(slot=0), None)
    s.add_block(_root(1), SimpleNamespace(slot=1), _root(0))
    V = 5000
    s.on_attestation(list(range(V)), _root(1), slot=1)
    balances = [2 ** 35 - 1 - v for v in range(V)]
    w = PFC.subtree_weights(s, balances, range(V), "cpu")
    assert int(w[1]) == sum(balances) and int(w[0]) == sum(balances)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PFC.lmd_ghost(s, balances, range(V), _root(0))


@pytest.fixture(scope="module")
def duty_states():
    j = JP.get_spec("minimal")
    p = PP.get_spec("minimal", device="cpu")
    j_active, p_active = JBLS.bls_active, PBLS.bls_active
    JBLS.bls_active = PBLS.bls_active = False
    try:
        state = factories.seed_genesis_state(j, j.SLOTS_PER_EPOCH * 8)
        factories.advance_slots(j, state, 3)
        data = JI.serialize(state, j.BeaconState)
        yield j, p, state, PI.deserialize(data, p.BeaconState)
    finally:
        JBLS.bls_active, PBLS.bls_active = j_active, p_active


def test_committee_assignment_and_attestation_duty_match_reference(duty_states):
    j, p, js, ps = duty_states
    epoch = j.get_current_epoch(js)
    head_root = b"\x5a" * 32
    for e in (epoch, epoch + 1):
        for v in range(len(js.validator_registry)):
            want = j.get_committee_assignment(js, e, v)
            got = p.get_committee_assignment(ps, e, v)
            assert got == want, (e, v)
            if e != epoch or want is None:
                continue
            committee, shard, _ = want
            for bit in (False, True):
                wa = j.build_attestation_duty(js, head_root, committee, shard,
                                              v, None, custody_bit=bit)
                pa = p.build_attestation_duty(ps, head_root, committee, shard,
                                              v, None, custody_bit=bit)
                assert PI.serialize(pa, p.Attestation) == \
                    JI.serialize(wa, j.Attestation)
    assert p.is_proposer(ps, j.get_beacon_proposer_index(js))
    with pytest.raises(AssertionError):
        p.get_committee_assignment(ps, epoch + 2, 0)
