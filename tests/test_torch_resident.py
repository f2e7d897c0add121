"""The port's slice as a whole: ResidentColumns driven on the CPU through
enter, 3 slots, an epoch boundary and 2 more slots, every step held
against the JAX package on the same numpy columns:
registry_and_balances_roots_device for the roots, epoch_transition_device
for the boundary's columns, scalars and report, and
shuffle_permutation_device for the next epoch's permutation."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.models.phase0 import epoch_soa as JE
from consensus_specs_tpu.ops.shuffle import shuffle_permutation_device
from consensus_specs_tpu.utils.ssz import bulk as JB
from consensus_specs_tpu_torch.convert import columns_from_numpy, columns_to_numpy
from consensus_specs_tpu_torch.models.phase0.epoch_soa import (
    EpochConfig, synthetic_epoch_state)
from consensus_specs_tpu_torch.models.phase0.resident import ResidentColumns
from consensus_specs_tpu_torch.utils.config import load_preset

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

V = 301            # not a power of two, not a multiple of 4
ROUNDS = load_preset("minimal")["SHUFFLE_ROUND_COUNT"]


def _state(seed=21):
    cfg = EpochConfig.from_preset("minimal")
    rng = np.random.default_rng(seed)
    cols, scal, inp = synthetic_epoch_state(
        cfg, V, rng, random_eligibility=True, random_slashed_balances=True)
    pk = rng.integers(0, 256, (V, 48), dtype=np.uint8)
    wc = rng.integers(0, 256, (V, 32), dtype=np.uint8)
    return cfg, cols, scal, inp, pk, wc


def _jax_roots(cols, pk, wc):
    return JB.registry_and_balances_roots_device(
        pk, wc, cols.activation_eligibility_epoch, cols.activation_epoch,
        cols.exit_epoch, cols.withdrawable_epoch, cols.slashed,
        cols.effective_balance, cols.balance)


def _slot(core, cols, rng, k):
    idx = rng.choice(V, size=k, replace=False)
    vals = rng.integers(0, 2 ** 64, k, dtype=np.uint64)
    core.apply_balances(idx, vals)
    bal = cols.balance.copy()
    bal[idx] = vals
    return cols._replace(balance=bal)


def test_resident_drive_matches_jax():
    cfg, cols, scal, inp, pk, wc = _state()
    core = ResidentColumns(cfg, cols, pk, wc, ROUNDS, device="cpu")
    core.enter()
    assert core.roots() == _jax_roots(cols, pk, wc)
    rng = np.random.default_rng(5)
    for k in (1, 17, 64):                        # three slots
        cols = _slot(core, cols, rng, k)
        assert core.roots() == _jax_roots(cols, pk, wc)
    assert core.balances_forest.last_pairs_per_level     # updated, not rebuilt
    assert core.balances_forest.builds == 1

    # boundary: epoch program + shuffle + rebuild
    seed = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    _, t_scal, t_inp = columns_from_numpy(cols, scal, inp, device="cpu")
    new_scal, report, perm = core.epoch_boundary(t_scal, t_inp, seed)
    j_cols, j_scal, j_rep = JE.epoch_transition_device(
        JE.EpochConfig(*cfg), JE.ValidatorColumns(*cols),
        JE.EpochScalars(*scal), JE.EpochInputs(*inp))
    got_cols, got_scal, got_rep = columns_to_numpy(core.cols, new_scal, report)
    for got, want in ((got_cols, j_cols), (got_scal, j_scal), (got_rep, j_rep)):
        for f in type(want)._fields:
            assert (np.asarray(getattr(got, f))
                    == np.asarray(getattr(want, f))).all(), f
    cols = got_cols
    next_epoch = int(got_scal.slot) // cfg.SLOTS_PER_EPOCH + 1
    active = np.nonzero((cols.activation_epoch <= next_epoch)
                        & (next_epoch < cols.exit_epoch))[0]
    assert (core.active_indices.numpy() == active).all()
    assert (perm.numpy() == shuffle_permutation_device(
        seed, active.shape[0], ROUNDS)).all()
    assert core.balances_forest.builds == 1     # a fresh forest after the rebuild
    assert core.roots() == _jax_roots(cols, pk, wc)

    for k in (3, 300):                           # two more slots
        cols = _slot(core, cols, rng, k)
        assert core.roots() == _jax_roots(cols, pk, wc)


def test_resident_needs_cuda_unless_cpu_is_asked(monkeypatch):
    cfg, cols, _, _, pk, wc = _state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidentColumns(cfg, cols, pk, wc, ROUNDS)
    ResidentColumns(cfg, cols, pk, wc, ROUNDS, device="cpu")
