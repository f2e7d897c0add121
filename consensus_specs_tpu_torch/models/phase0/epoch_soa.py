"""The numeric epoch transition over structure-of-arrays columns
(port of the device half of consensus_specs_tpu/models/phase0/epoch_soa.py).

The same masked elementwise program as the reference: justification and
finalization, attestation and crosslink deltas, registry updates with the
closed-form exit queue and the stable-sorted activation queue, slashings
and the numeric final updates. The host distillation from the object
model is not ported here.

uint64 columns and scalars are int64 tensors holding the bit patterns
(FAR_FUTURE_EPOCH = 2**64 - 1 is -1). Every compare, min/max, division
and remainder of a uint64 value is the unsigned one (ops.intmath), the
activation queue sorts on the unsigned-order key, and shifts of uint64
values are logical, so the program agrees with the reference on the
whole uint64 range and not only where values stay below 2**63. Plain
int64 arithmetic remains only on counts of validators and on the
reference's own int64 slashing window.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops import intmath
from ...ops.intmath import (udivmod_u64, ule, ult, umax, umax_reduce, umin,
                            u64_key)
from ...utils.config import load_preset

_I64 = torch.int64


class EpochConfig(NamedTuple):
    """Constants of the epoch program (the reference's field list)."""
    SLOTS_PER_EPOCH: int
    GENESIS_EPOCH: int
    FAR_FUTURE_EPOCH: int
    BASE_REWARD_FACTOR: int
    BASE_REWARDS_PER_EPOCH: int
    PROPOSER_REWARD_QUOTIENT: int
    MIN_ATTESTATION_INCLUSION_DELAY: int
    MIN_EPOCHS_TO_INACTIVITY_PENALTY: int
    INACTIVITY_PENALTY_QUOTIENT: int
    MIN_PER_EPOCH_CHURN_LIMIT: int
    CHURN_LIMIT_QUOTIENT: int
    MAX_EFFECTIVE_BALANCE: int
    EJECTION_BALANCE: int
    EFFECTIVE_BALANCE_INCREMENT: int
    ACTIVATION_EXIT_DELAY: int
    MIN_VALIDATOR_WITHDRAWABILITY_DELAY: int
    LATEST_SLASHED_EXIT_LENGTH: int
    MIN_SLASHING_PENALTY_QUOTIENT: int
    SHARD_COUNT: int
    TARGET_COMMITTEE_SIZE: int

    @classmethod
    def from_preset(cls, name_or_path: str) -> "EpochConfig":
        consts = load_preset(name_or_path)
        return cls(**{f: int(consts[f]) for f in cls._fields})


class ValidatorColumns(NamedTuple):
    """SoA layout of the validator registry + balances."""
    activation_eligibility_epoch: torch.Tensor  # [V] uint64 bits
    activation_epoch: torch.Tensor              # [V] uint64 bits
    exit_epoch: torch.Tensor                    # [V] uint64 bits
    withdrawable_epoch: torch.Tensor            # [V] uint64 bits
    slashed: torch.Tensor                       # [V] bool
    effective_balance: torch.Tensor             # [V] uint64 bits
    balance: torch.Tensor                       # [V] uint64 bits


class EpochScalars(NamedTuple):
    slot: torch.Tensor                      # () uint64 bits
    previous_justified_epoch: torch.Tensor  # ()
    current_justified_epoch: torch.Tensor   # ()
    justification_bitfield: torch.Tensor    # ()
    finalized_epoch: torch.Tensor           # ()
    latest_start_shard: torch.Tensor        # ()
    latest_slashed_balances: torch.Tensor   # [LATEST_SLASHED_EXIT_LENGTH]


class EpochInputs(NamedTuple):
    """Participation facts distilled from PendingAttestations."""
    prev_src: torch.Tensor        # [V] bool
    prev_tgt: torch.Tensor        # [V] bool
    prev_head: torch.Tensor       # [V] bool
    curr_tgt: torch.Tensor        # [V] bool
    incl_delay: torch.Tensor      # [V] uint64 bits (1 where unset)
    att_proposer: torch.Tensor    # [V] int32
    v_shard: torch.Tensor         # [V] int32, -1 if none
    in_winning: torch.Tensor      # [V] bool
    shard_att_balance: torch.Tensor   # [SHARD_COUNT] uint64 bits (>= 1)
    shard_comm_balance: torch.Tensor  # [SHARD_COUNT] uint64 bits (>= 1)


class EpochReport(NamedTuple):
    """Scalar decisions the host needs to finish byte-rooted bookkeeping."""
    justified_prev_fired: torch.Tensor  # () bool
    justified_curr_fired: torch.Tensor  # () bool
    finalized_fired: torch.Tensor       # () bool
    justification_active: torch.Tensor  # () bool


def _u64(value: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return value - (1 << 64) if value >= 1 << 63 else value


def _udiv(x: torch.Tensor, d) -> torch.Tensor:
    return udivmod_u64(x, d)[0]


def _total_balance(eff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """get_total_balance over a mask: max(sum, 1) (sum mod 2**64)."""
    return umax(torch.where(mask, eff, 0).sum(), 1)


def _stage_a(cfg: EpochConfig, cols: ValidatorColumns, scal: EpochScalars,
             inp: EpochInputs):
    """The reference's _stage_a_traced: justification/finalization +
    rewards/penalties + registry updates. Returns (cols', scal', report)
    as new tensors; `cols` is only read."""
    V = cols.balance.shape[0]
    dev = cols.balance.device
    FAR = _u64(cfg.FAR_FUTURE_EPOCH)
    G = cfg.GENESIS_EPOCH

    current_epoch = _udiv(scal.slot, cfg.SLOTS_PER_EPOCH)
    previous_epoch = torch.where(current_epoch == G, G,
                                 torch.clamp(current_epoch, min=1) - 1)

    active_curr = ule(cols.activation_epoch, current_epoch) & ult(current_epoch, cols.exit_epoch)
    active_prev = ule(cols.activation_epoch, previous_epoch) & ult(previous_epoch, cols.exit_epoch)
    eff = cols.effective_balance
    total_balance = _total_balance(eff, active_curr)
    active_count = active_curr.to(_I64).sum()

    # -- Justification and finalization -------------------------------------
    justification_active = ult(G + 1, current_epoch)
    unslashed = ~cols.slashed
    prev_tgt_balance = _total_balance(eff, inp.prev_tgt & unslashed)
    curr_tgt_balance = _total_balance(eff, inp.curr_tgt & unslashed)

    old_prev_just = scal.previous_justified_epoch
    old_curr_just = scal.current_justified_epoch
    new_prev_just = old_curr_just
    bitfield = scal.justification_bitfield << 1        # wraps = % 2**64
    just_prev = ule(total_balance * 2, prev_tgt_balance * 3)
    just_curr = ule(total_balance * 2, curr_tgt_balance * 3)
    new_curr_just = torch.where(just_prev, previous_epoch, old_curr_just)
    bitfield = torch.where(just_prev, bitfield | 2, bitfield)
    new_curr_just = torch.where(just_curr, current_epoch, new_curr_just)
    bitfield = torch.where(just_curr, bitfield | 1, bitfield)

    shifted = intmath.ushr(bitfield, 1)
    c1 = ((shifted & 7) == 0b111) & (old_prev_just + 3 == current_epoch)
    c2 = ((shifted & 3) == 0b11) & (old_prev_just + 2 == current_epoch)
    c3 = ((bitfield & 7) == 0b111) & (old_curr_just + 2 == current_epoch)
    c4 = ((bitfield & 3) == 0b11) & (old_curr_just + 1 == current_epoch)
    new_finalized = scal.finalized_epoch
    new_finalized = torch.where(c1, old_prev_just, new_finalized)
    new_finalized = torch.where(c2, old_prev_just, new_finalized)
    new_finalized = torch.where(c3, old_curr_just, new_finalized)
    new_finalized = torch.where(c4, old_curr_just, new_finalized)
    fin_fired = (c1 | c2 | c3 | c4) & justification_active

    prev_just = torch.where(justification_active, new_prev_just, old_prev_just)
    curr_just = torch.where(justification_active, new_curr_just, old_curr_just)
    bitfield = torch.where(justification_active, bitfield, scal.justification_bitfield)
    finalized = torch.where(justification_active, new_finalized, scal.finalized_epoch)

    # -- Rewards and penalties ----------------------------------------------
    rewards_active = current_epoch != G
    sqrt_total = intmath.isqrt_u64(total_balance)
    base_reward = _udiv(_udiv(eff * cfg.BASE_REWARD_FACTOR, sqrt_total),
                        cfg.BASE_REWARDS_PER_EPOCH)

    eligible = active_prev | (cols.slashed & ult(previous_epoch + 1, cols.withdrawable_epoch))
    rewards = torch.zeros(V, dtype=_I64, device=dev)
    penalties = torch.zeros(V, dtype=_I64, device=dev)

    # Micro-incentives for matching source / target / head
    for flag in (inp.prev_src, inp.prev_tgt, inp.prev_head):
        in_set = flag & unslashed
        att_balance = _total_balance(eff, in_set)
        match_reward = intmath.muldiv_u64(base_reward, att_balance, total_balance)
        rewards = rewards + torch.where(eligible & in_set, match_reward, 0)
        penalties = penalties + torch.where(eligible & ~in_set, base_reward, 0)

    # Proposer + inclusion-delay micro-rewards for source attesters
    src_set = inp.prev_src & unslashed
    proposer_gain = torch.where(
        src_set, _udiv(base_reward, cfg.PROPOSER_REWARD_QUOTIENT), 0)
    rewards = rewards.index_add(0, inp.att_proposer, proposer_gain)
    delay = umax(inp.incl_delay, 1)
    rewards = rewards + torch.where(
        src_set, _udiv(base_reward * cfg.MIN_ATTESTATION_INCLUSION_DELAY, delay), 0)

    # Inactivity penalty (finalized <= previous_epoch on real chains; the
    # min() mirrors the reference's saturating form)
    finality_delay = previous_epoch - umin(finalized, previous_epoch)
    inactivity = ult(cfg.MIN_EPOCHS_TO_INACTIVITY_PENALTY, finality_delay)
    tgt_set = inp.prev_tgt & unslashed
    penalties = penalties + torch.where(
        inactivity & eligible, cfg.BASE_REWARDS_PER_EPOCH * base_reward, 0)
    penalties = penalties + torch.where(
        inactivity & eligible & ~tgt_set,
        _udiv(eff * finality_delay, cfg.INACTIVITY_PENALTY_QUOTIENT), 0)

    # Crosslink deltas: per-shard tables gathered per validator
    in_committee = inp.v_shard >= 0
    shard_idx = torch.clamp(inp.v_shard, min=0).to(_I64)
    cl_att = inp.shard_att_balance[shard_idx]
    cl_comm = umax(inp.shard_comm_balance[shard_idx], torch.ones_like(cl_att))
    cl_reward = intmath.muldiv_u64(base_reward, cl_att, cl_comm)
    rewards = rewards + torch.where(in_committee & inp.in_winning, cl_reward, 0)
    penalties = penalties + torch.where(in_committee & ~inp.in_winning, base_reward, 0)

    # Apply: increase then saturating decrease
    balance = cols.balance + torch.where(rewards_active, rewards, 0)
    pen = torch.where(rewards_active, penalties, 0)
    balance = torch.where(ult(balance, pen), 0, balance - pen)

    # -- Registry updates ---------------------------------------------------
    churn = torch.clamp(active_count // cfg.CHURN_LIMIT_QUOTIENT,
                        min=cfg.MIN_PER_EPOCH_CHURN_LIMIT)

    # Activation eligibility
    elig = torch.where(
        (cols.activation_eligibility_epoch == FAR) & ule(cfg.MAX_EFFECTIVE_BALANCE, eff),
        current_epoch, cols.activation_eligibility_epoch)

    # Ejections -> closed-form exit queue
    ejected = active_curr & ule(eff, cfg.EJECTION_BALANCE) & (cols.exit_epoch == FAR)
    delayed_exit = current_epoch + 1 + cfg.ACTIVATION_EXIT_DELAY
    has_exit = cols.exit_epoch != FAR
    base_epoch = umax(umax_reduce(torch.where(has_exit, cols.exit_epoch, 0)),
                      delayed_exit)
    count_at_base = (cols.exit_epoch == base_epoch).to(_I64).sum()
    c0 = torch.minimum(count_at_base, churn)
    ej = ejected.to(_I64)
    rank = torch.cumsum(ej, 0) - ej
    assigned = base_epoch + (c0 + rank) // churn
    exit_epoch = torch.where(ejected, assigned, cols.exit_epoch)
    withdrawable = torch.where(
        ejected, assigned + cfg.MIN_VALIDATOR_WITHDRAWABILITY_DELAY,
        cols.withdrawable_epoch)

    # Activation queue: stable sort by eligibility epoch (unsigned order),
    # dequeue churn-many
    delayed_fin = finalized + 1 + cfg.ACTIVATION_EXIT_DELAY
    queued = (elig != FAR) & ule(delayed_fin, cols.activation_epoch)
    sort_key = u64_key(torch.where(queued, elig, FAR))
    order = torch.argsort(sort_key, stable=True)
    pos = torch.empty(V, dtype=_I64, device=dev)
    pos[order] = torch.arange(V, dtype=_I64, device=dev)
    dequeued = queued & (pos < churn)
    activation = torch.where(
        dequeued & (cols.activation_epoch == FAR),
        current_epoch + 1 + cfg.ACTIVATION_EXIT_DELAY, cols.activation_epoch)

    mid_cols = ValidatorColumns(
        activation_eligibility_epoch=elig,
        activation_epoch=activation,
        exit_epoch=exit_epoch,
        withdrawable_epoch=withdrawable,
        slashed=cols.slashed,
        effective_balance=eff,
        balance=balance,
    )
    mid_scal = scal._replace(
        previous_justified_epoch=prev_just,
        current_justified_epoch=curr_just,
        justification_bitfield=bitfield,
        finalized_epoch=finalized,
    )
    report = EpochReport(
        justified_prev_fired=just_prev & justification_active,
        justified_curr_fired=just_curr & justification_active,
        finalized_fired=fin_fired,
        justification_active=justification_active,
    )
    return mid_cols, mid_scal, report


def _stage_b(cfg: EpochConfig, cols: ValidatorColumns, scal: EpochScalars):
    """The reference's _stage_b_traced: slashings + the numeric final
    updates. Returns (cols', scal') with new effective balance and balance
    tensors; `cols` is only read."""
    eff = cols.effective_balance
    balance = cols.balance
    current_epoch = _udiv(scal.slot, cfg.SLOTS_PER_EPOCH)
    active_curr = ule(cols.activation_epoch, current_epoch) & ult(current_epoch, cols.exit_epoch)
    total_balance = _total_balance(eff, active_curr)
    active_count = active_curr.to(_I64).sum()

    # -- Slashings ----------------------------------------------------------
    L = cfg.LATEST_SLASHED_EXIT_LENGTH
    lsb = scal.latest_slashed_balances
    at_start = lsb[(current_epoch + 1) % L]
    at_end = lsb[current_epoch % L]
    tp3 = (at_end - at_start) * 3
    m = torch.minimum(tp3, total_balance)
    scaled = torch.where(
        m < 0, 0,
        intmath.muldiv_u64(eff, torch.clamp(m, min=0), total_balance))
    slash_penalty = umax(scaled, _udiv(eff, cfg.MIN_SLASHING_PENALTY_QUOTIENT))
    slash_now = cols.slashed & (current_epoch == cols.withdrawable_epoch - L // 2)
    slash_penalty = torch.where(slash_now, slash_penalty, 0)
    balance = torch.where(ult(balance, slash_penalty), 0, balance - slash_penalty)

    # -- Final updates, numeric parts ---------------------------------------
    next_epoch = current_epoch + 1
    half_inc = cfg.EFFECTIVE_BALANCE_INCREMENT // 2
    stale = ult(balance, eff) | ult(eff + 3 * half_inc, balance)
    new_eff = torch.where(
        stale,
        umin(balance - udivmod_u64(balance, cfg.EFFECTIVE_BALANCE_INCREMENT)[1],
             cfg.MAX_EFFECTIVE_BALANCE),
        eff)

    # Start shard rotation (get_shard_delta over the current epoch)
    committees = torch.clamp(
        torch.clamp(active_count // cfg.SLOTS_PER_EPOCH // cfg.TARGET_COMMITTEE_SIZE,
                    max=cfg.SHARD_COUNT // cfg.SLOTS_PER_EPOCH),
        min=1) * cfg.SLOTS_PER_EPOCH
    shard_delta = torch.clamp(
        committees, max=cfg.SHARD_COUNT - cfg.SHARD_COUNT // cfg.SLOTS_PER_EPOCH)
    start_shard = udivmod_u64(scal.latest_start_shard + shard_delta,
                              cfg.SHARD_COUNT)[1]

    lsb = lsb.clone()
    lsb[next_epoch % L] = lsb[current_epoch % L]

    new_cols = cols._replace(effective_balance=new_eff, balance=balance)
    new_scal = scal._replace(latest_start_shard=start_shard,
                             latest_slashed_balances=lsb)
    return new_cols, new_scal


def epoch_transition_device(cfg: EpochConfig, cols: ValidatorColumns,
                            scal: EpochScalars, inp: EpochInputs):
    """The whole numeric epoch transition on the columns' device.

    The columns are updated IN PLACE (the reference donates them to its
    jitted program for the same reason: no second copy of the registry),
    and returned; the scalars and report are new tensors. Returns
    (cols, scal', report)."""
    mid_cols, mid_scal, report = _stage_a(cfg, cols, scal, inp)
    new_cols, new_scal = _stage_b(cfg, mid_cols, mid_scal)
    for f in ValidatorColumns._fields:
        dst = getattr(cols, f)
        src = getattr(new_cols, f)
        if src is not dst:
            dst.copy_(src)
    return cols, new_scal, report


def synthetic_epoch_state(cfg: EpochConfig, V: int, rng,
                          slashed_p: float = 0.05,
                          incl_delay_max: int = 8,
                          random_eligibility: bool = False,
                          random_slashed_balances: bool = False):
    """Plausible random (cols, scal, inp) as numpy arrays (uint64/bool/
    int32), drawing from `rng` in the reference's order so one seed gives
    the reference's state; convert.columns_from_numpy uploads them."""
    FAR = np.uint64(cfg.FAR_FUTURE_EPOCH)
    MAX_EB = 32_000_000_000
    if random_eligibility:
        elig = np.where(rng.random(V) < 0.1, FAR, np.uint64(0)).astype(np.uint64)
        act = np.where(rng.random(V) < 0.1, FAR, np.uint64(0)).astype(np.uint64)
    else:
        elig = np.zeros(V, np.uint64)
        act = np.zeros(V, np.uint64)
    cols = ValidatorColumns(
        activation_eligibility_epoch=elig,
        activation_epoch=act,
        exit_epoch=np.full(V, FAR, np.uint64),
        withdrawable_epoch=np.full(V, FAR, np.uint64),
        slashed=rng.random(V) < slashed_p,
        effective_balance=np.full(V, MAX_EB, np.uint64),
        balance=rng.integers(MAX_EB - 10 ** 9, MAX_EB + 10 ** 9, V).astype(np.uint64),
    )
    if random_slashed_balances:
        lsb = rng.integers(0, 10 ** 12, cfg.LATEST_SLASHED_EXIT_LENGTH).astype(np.uint64)
    else:
        lsb = np.zeros(cfg.LATEST_SLASHED_EXIT_LENGTH, np.uint64)
    scal = EpochScalars(
        slot=np.uint64(10 * cfg.SLOTS_PER_EPOCH - 1),
        previous_justified_epoch=np.uint64(7),
        current_justified_epoch=np.uint64(8),
        justification_bitfield=np.uint64(0b1111),
        finalized_epoch=np.uint64(7),
        latest_start_shard=np.uint64(0),
        latest_slashed_balances=lsb,
    )
    comm_bal = np.maximum(
        np.full(cfg.SHARD_COUNT, (V // max(1, cfg.SHARD_COUNT)) * MAX_EB,
                dtype=np.uint64), 1)
    inp = EpochInputs(
        prev_src=rng.random(V) < 0.95,
        prev_tgt=rng.random(V) < 0.90,
        prev_head=rng.random(V) < 0.85,
        curr_tgt=rng.random(V) < 0.90,
        incl_delay=rng.integers(1, incl_delay_max + 1, V).astype(np.uint64),
        att_proposer=rng.integers(0, V, V).astype(np.int32),
        v_shard=rng.integers(0, cfg.SHARD_COUNT, V).astype(np.int32),
        in_winning=rng.random(V) < 0.90,
        shard_att_balance=(comm_bal * 9) // 10 + 1,
        shard_comm_balance=comm_bal,
    )
    return cols, scal, inp
