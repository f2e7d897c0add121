"""Port's epoch program (consensus_specs_tpu_torch.models.phase0.epoch_soa) ==
the JAX package's epoch_transition_device: columns, scalars and report,
bit for bit, on synthetic states that hold FAR_FUTURE_EPOCH (-1 as int64)
in the compared columns, queued activations, ejections, exits in flight
and slashings due."""
import numpy as np
import pytest

from consensus_specs_tpu.models.phase0 import epoch_soa as JE
from consensus_specs_tpu.models.phase0 import get_spec
from consensus_specs_tpu_torch.convert import columns_from_numpy, columns_to_numpy
from consensus_specs_tpu_torch.models.phase0 import epoch_soa as TE

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("preset", ["minimal", "mainnet"])
def test_epoch_config_matches_jax(preset):
    assert TE.EpochConfig.from_preset(preset) == JE.EpochConfig.from_spec(
        get_spec(preset))


def _np(nt):
    return type(nt)(*[np.asarray(x) for x in nt])


def _hazards(cfg, cols, scal, rng):
    """Exits in flight, ejections, slashings due this epoch and
    not-yet-eligible validators on top of a synthetic state."""
    V = cols.balance.shape[0]
    cur = int(scal.slot) // cfg.SLOTS_PER_EPOCH
    L = cfg.LATEST_SLASHED_EXIT_LENGTH
    exit_ep = cols.exit_epoch.copy()
    wd = cols.withdrawable_epoch.copy()
    eff = cols.effective_balance.copy()
    elig = cols.activation_eligibility_epoch.copy()
    k = rng.choice(V, size=V // 4, replace=False)
    exiting, ejecting, slashing, fresh = np.array_split(k, 4)
    exit_ep[exiting] = cur + rng.integers(1, 20, exiting.shape[0])
    wd[exiting] = exit_ep[exiting] + cfg.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    eff[ejecting] = cfg.EJECTION_BALANCE - rng.integers(0, 3, ejecting.shape[0]) * 10 ** 9
    wd[slashing] = cur + L // 2
    slashed = cols.slashed.copy()
    slashed[slashing] = True
    elig[fresh] = cfg.FAR_FUTURE_EPOCH
    return cols._replace(exit_epoch=exit_ep, withdrawable_epoch=wd,
                         effective_balance=eff, slashed=slashed,
                         activation_eligibility_epoch=elig)


def _run_both(cfg, cols, scal, inp):
    j_cols, j_scal, j_rep = JE.epoch_transition_device(
        JE.EpochConfig(*cfg), JE.ValidatorColumns(*cols),
        JE.EpochScalars(*scal), JE.EpochInputs(*inp))
    t_cols, t_scal, t_inp = columns_from_numpy(cols, scal, inp, device="cpu")
    out_cols, out_scal, out_rep = TE.epoch_transition_device(
        cfg, t_cols, t_scal, t_inp)
    assert out_cols is t_cols            # updated in place
    return (columns_to_numpy(out_cols, out_scal, out_rep),
            (_np(j_cols), _np(j_scal), _np(j_rep)))


def _assert_same(got, want):
    for g_nt, w_nt in zip(got, want):
        for f in type(w_nt)._fields:
            g, w = np.asarray(getattr(g_nt, f)), np.asarray(getattr(w_nt, f))
            assert g.dtype == w.dtype and g.shape == w.shape, f
            assert (g == w).all(), f


@pytest.mark.parametrize("random_eligibility,random_slashed_balances,hazards", [
    (False, False, False),
    (True, True, False),
    (True, True, True),
    (False, True, True),
])
def test_epoch_transition_matches_jax(random_eligibility,
                                      random_slashed_balances, hazards):
    cfg = TE.EpochConfig.from_preset("minimal")
    seed = 10 + 2 * random_eligibility + random_slashed_balances
    cols, scal, inp = TE.synthetic_epoch_state(
        cfg, 512, np.random.default_rng(seed),
        random_eligibility=random_eligibility,
        random_slashed_balances=random_slashed_balances)
    if hazards:
        cols = _hazards(cfg, cols, scal, np.random.default_rng(seed + 100))
    got, want = _run_both(cfg, cols, scal, inp)
    _assert_same(got, want)
    # the hazards really fire: someone dequeued, ejected, penalised
    new_cols = got[0]
    if random_eligibility:
        assert (new_cols.activation_epoch != cols.activation_epoch).any()
    if hazards:
        assert (new_cols.exit_epoch != cols.exit_epoch).any()


def test_synthetic_state_matches_jax():
    cfg = TE.EpochConfig.from_preset("minimal")
    got = TE.synthetic_epoch_state(cfg, 300, np.random.default_rng(3),
                                   random_eligibility=True,
                                   random_slashed_balances=True)
    want = JE.synthetic_epoch_state(JE.EpochConfig(*cfg), 300,
                                    np.random.default_rng(3),
                                    random_eligibility=True,
                                    random_slashed_balances=True)
    _assert_same(got, tuple(_np(nt) for nt in want))


def test_columns_round_trip_keeps_uint64_bits():
    cfg = TE.EpochConfig.from_preset("minimal")
    cols, scal, inp = TE.synthetic_epoch_state(
        cfg, 64, np.random.default_rng(1), random_eligibility=True)
    t_cols, t_scal, _ = columns_from_numpy(cols, scal, inp, device="cpu")
    assert int(t_cols.exit_epoch[0]) == -1          # FAR_FUTURE_EPOCH
    back_cols, back_scal, _ = columns_to_numpy(t_cols, t_scal)
    _assert_same((back_cols, back_scal), (cols, _np(scal)))
