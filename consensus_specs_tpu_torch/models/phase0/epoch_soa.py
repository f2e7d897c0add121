"""The numeric epoch transition over structure-of-arrays columns
(port of consensus_specs_tpu/models/phase0/epoch_soa.py: the device
program, its host half, and the bridges process_epoch_soa /
process_epoch_soa_staged that run an object state's process_epoch
through them).

The same masked elementwise program as the reference: justification and
finalization, attestation and crosslink deltas, registry updates with the
closed-form exit queue and the stable-sorted activation queue, slashings
and the numeric final updates. The host half below distills the program's
inputs from the object model (numpy), as the reference's does.

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

import itertools
import operator
from typing import NamedTuple

import numpy as np
import torch

from ... import telemetry
from ...device import resolve
from ...ops import intmath
from ...ops.intmath import (udivmod_u64, ule, ult, umax, umax_reduce, umin,
                            u64_key)
from ...parallel.exchange import ShardExchange
from ...utils.config import load_preset
from ...utils.ssz import bulk

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
        consts = dict(load_preset(name_or_path).items())
        consts["GENESIS_EPOCH"] = consts["GENESIS_SLOT"] // consts["SLOTS_PER_EPOCH"]
        return cls(**{f: int(consts[f]) for f in cls._fields})

    @classmethod
    def from_spec(cls, spec) -> "EpochConfig":
        return cls(**{f: int(getattr(spec, f)) for f in cls._fields})


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


def _masked_sums(eff: torch.Tensor, masks) -> torch.Tensor:
    """[len(masks)] sums of eff over each mask (mod 2**64): one shard's
    partials of get_total_balance."""
    return torch.stack([torch.where(m, eff, 0).sum() for m in masks])


# ---------------------------------------------------------------------------
# The program, one shard's rows at a time
#
# _stage_a_rows / _stage_b_rows run on one shard's rows (all of them on a
# single device) as generators: where a row's value depends on other
# rows they yield a request to the cross-shard exchange
# (parallel/exchange.py::ShardExchange) and resume with its answer:
#   ("sum", partials)          balance sums and counts (mod 2**64)
#   ("scatter_add", (i, v, n)) the proposer rewards, by global index
#   ("umax", x)                the exit queue's latest exit epoch
#   ("prefix", partials)       count at the base epoch; the ejection rank
#   ("rank", keys)             the activation queue's stable sort
# _run_shards drives every shard's generator in lockstep. A single device
# is the one-shard case: the exchange's answers are then the plain
# single-tensor reductions, so both placements run the same program.
# Integer sums are exact in any order, so the sharded program is
# bit-identical to the single-device one.
# ---------------------------------------------------------------------------

def _run_shards(program, shard_args, exchange):
    """Run program(*args) for every shard's args in lockstep, answering
    each round of requests through the exchange method of the request's
    name; -> the per-shard results."""
    gens = [program(*args) for args in shard_args]
    reqs = [next(g) for g in gens]
    while True:
        op = reqs[0][0]
        if any(r[0] != op for r in reqs):
            raise AssertionError(f"shards diverged: {[r[0] for r in reqs]}")
        answers = getattr(exchange, op)([r[1] for r in reqs])
        outs, done = [], False
        for g, ans in zip(gens, answers):
            try:
                outs.append(g.send(ans))
            except StopIteration as stop:
                done = True
                outs.append(stop.value)
        if done:
            return outs
        reqs = outs


def _one_shard(program, *args):
    cols = args[1]
    return _run_shards(program, [args],
                       ShardExchange([cols.balance.device]))[0]


def _stage_a_rows(cfg: EpochConfig, cols: ValidatorColumns,
                  scal: EpochScalars, inp: EpochInputs):
    """The reference's _stage_a_traced on one shard's rows (a generator,
    see above): justification/finalization + rewards/penalties + registry
    updates. Returns (cols', scal', report) as new tensors; `cols` is only
    read. att_proposer holds global validator indices."""
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
    unslashed = ~cols.slashed
    flags = (inp.prev_src & unslashed, inp.prev_tgt & unslashed,
             inp.prev_head & unslashed)
    sums = yield ("sum", torch.cat([
        _masked_sums(eff, (active_curr,) + flags + (inp.curr_tgt & unslashed,)),
        active_curr.to(_I64).sum()[None]]))
    total_balance = umax(sums[0], 1)            # get_total_balance: max(sum, 1)
    att_balances = [umax(sums[k], 1) for k in (1, 2, 3)]
    prev_tgt_balance = att_balances[1]
    curr_tgt_balance = umax(sums[4], 1)
    active_count = sums[5]

    # -- Justification and finalization -------------------------------------
    justification_active = ult(G + 1, current_epoch)

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
    for in_set, att_balance in zip(flags, att_balances):
        match_reward = intmath.muldiv_u64(base_reward, att_balance, total_balance)
        rewards = rewards + torch.where(eligible & in_set, match_reward, 0)
        penalties = penalties + torch.where(eligible & ~in_set, base_reward, 0)

    # Proposer + inclusion-delay micro-rewards for source attesters (the
    # proposer's row may lie in another shard: the exchange adds it there)
    src_set = flags[0]
    proposer_gain = torch.where(
        src_set, _udiv(base_reward, cfg.PROPOSER_REWARD_QUOTIENT), 0)
    rewards = rewards + (yield ("scatter_add", (inp.att_proposer, proposer_gain, V)))
    delay = umax(inp.incl_delay, 1)
    rewards = rewards + torch.where(
        src_set, _udiv(base_reward * cfg.MIN_ATTESTATION_INCLUSION_DELAY, delay), 0)

    # Inactivity penalty (finalized <= previous_epoch on real chains; the
    # min() mirrors the reference's saturating form)
    finality_delay = previous_epoch - umin(finalized, previous_epoch)
    inactivity = ult(cfg.MIN_EPOCHS_TO_INACTIVITY_PENALTY, finality_delay)
    tgt_set = flags[1]
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

    # Ejections -> closed-form exit queue (every shard's rank offset by the
    # ejections of the shards before it)
    ejected = active_curr & ule(eff, cfg.EJECTION_BALANCE) & (cols.exit_epoch == FAR)
    delayed_exit = current_epoch + 1 + cfg.ACTIVATION_EXIT_DELAY
    has_exit = cols.exit_epoch != FAR
    latest_exit = yield ("umax", umax_reduce(torch.where(has_exit, cols.exit_epoch, 0)))
    base_epoch = umax(latest_exit, delayed_exit)
    ej = ejected.to(_I64)
    total, before = yield ("prefix", torch.stack(
        [(cols.exit_epoch == base_epoch).to(_I64).sum(), ej.sum()]))
    c0 = torch.minimum(total[0], churn)
    rank = torch.cumsum(ej, 0) - ej + before[1]
    assigned = base_epoch + (c0 + rank) // churn
    exit_epoch = torch.where(ejected, assigned, cols.exit_epoch)
    withdrawable = torch.where(
        ejected, assigned + cfg.MIN_VALIDATOR_WITHDRAWABILITY_DELAY,
        cols.withdrawable_epoch)

    # Activation queue: stable sort by eligibility epoch (unsigned order)
    # over every shard's rows, dequeue churn-many
    delayed_fin = finalized + 1 + cfg.ACTIVATION_EXIT_DELAY
    queued = (elig != FAR) & ule(delayed_fin, cols.activation_epoch)
    pos = yield ("rank", u64_key(torch.where(queued, elig, FAR)))
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


def _stage_b_rows(cfg: EpochConfig, cols: ValidatorColumns, scal: EpochScalars):
    """The reference's _stage_b_traced on one shard's rows (a generator):
    slashings + the numeric final updates. Returns (cols', scal') with new
    effective balance and balance tensors; `cols` is only read."""
    eff = cols.effective_balance
    balance = cols.balance
    current_epoch = _udiv(scal.slot, cfg.SLOTS_PER_EPOCH)
    active_curr = ule(cols.activation_epoch, current_epoch) & ult(current_epoch, cols.exit_epoch)
    sums = yield ("sum", torch.cat([_masked_sums(eff, (active_curr,)),
                                    active_curr.to(_I64).sum()[None]]))
    total_balance = umax(sums[0], 1)
    active_count = sums[1]

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


def _epoch_rows(cfg: EpochConfig, cols: ValidatorColumns, scal: EpochScalars,
                inp: EpochInputs):
    """Both stages on one shard's rows: -> (cols', scal', report)."""
    mid_cols, mid_scal, report = yield from _stage_a_rows(cfg, cols, scal, inp)
    new_cols, new_scal = yield from _stage_b_rows(cfg, mid_cols, mid_scal)
    return new_cols, new_scal, report


def _stage_a(cfg: EpochConfig, cols: ValidatorColumns, scal: EpochScalars,
             inp: EpochInputs):
    """Stage A on one device: -> (cols', scal', report); `cols` is only
    read."""
    return _one_shard(_stage_a_rows, cfg, cols, scal, inp)


def _stage_b(cfg: EpochConfig, cols: ValidatorColumns, scal: EpochScalars):
    """Stage B on one device: -> (cols', scal'); `cols` is only read."""
    return _one_shard(_stage_b_rows, cfg, cols, scal)


def _write_in_place(cols: ValidatorColumns, new_cols: ValidatorColumns) -> None:
    for f in ValidatorColumns._fields:
        dst = getattr(cols, f)
        src = getattr(new_cols, f)
        if src is not dst:
            dst.copy_(src)


def epoch_transition_device(cfg: EpochConfig, cols: ValidatorColumns,
                            scal: EpochScalars, inp: EpochInputs):
    """The whole numeric epoch transition on the columns' device.

    The columns are updated IN PLACE (the reference donates them to its
    jitted program for the same reason: no second copy of the registry),
    and returned; the scalars and report are new tensors. Returns
    (cols, scal', report)."""
    new_cols, new_scal, report = _one_shard(_epoch_rows, cfg, cols, scal, inp)
    _write_in_place(cols, new_cols)
    return cols, new_scal, report


def epoch_transition_shards(cfg: EpochConfig, shard_cols, shard_scal,
                            shard_inp, exchange):
    """The same program over row shards (lists of per-shard
    ValidatorColumns / EpochScalars / EpochInputs, shard i on
    exchange.devices[i]; the scalars and the two crosslink tables
    replicated on every shard's device), every cross-shard step through
    `exchange`. Each shard's columns are updated in place. -> (the shard
    columns, per-shard scalars', per-shard reports)."""
    outs = _run_shards(_epoch_rows, [(cfg, c, s, i) for c, s, i in
                                     zip(shard_cols, shard_scal, shard_inp)],
                       exchange)
    for cols, (new_cols, _, _) in zip(shard_cols, outs):
        _write_in_place(cols, new_cols)
    return shard_cols, [o[1] for o in outs], [o[2] for o in outs]


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

# ---------------------------------------------------------------------------
# Inert validator padding (the sharded serving layout)
#
# A serving mesh shards `[V]` columns into equal row blocks, so V is padded
# to a multiple of the mesh size. The padding rows are INERT: a
# never-eligible, never-active, zero-balance validator every mask in the
# program excludes --
#   * active/eligible masks are False (activation == exit == FAR_FUTURE),
#   * uint64 balance sums gain exact zeros (order-independent),
#   * the activation-queue stable sort keys padding at FAR_FUTURE behind
#     every real row (padding indices are the largest), so queued positions
#     are unchanged,
#   * the exit-queue base/count scans see exit_epoch == FAR (excluded), and
#   * the proposer scatter-add receives a zero gain at index 0.
# The `[V]` prefix of the padded program's outputs is therefore
# bit-identical to the unpadded program (held in tests/test_torch_multichip.py,
# a non-divisible V included).
# ---------------------------------------------------------------------------

def inert_column_tail(field: str, k: int, far: int) -> np.ndarray:
    """[k] inert-validator rows for one ValidatorColumns field (numpy
    uint64 / bool)."""
    if field in ("activation_eligibility_epoch", "activation_epoch",
                 "exit_epoch", "withdrawable_epoch"):
        return np.full(k, far, dtype=np.uint64)
    if field == "slashed":
        return np.zeros(k, dtype=bool)
    return np.zeros(k, dtype=np.uint64)   # effective_balance, balance


def _tail_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=like.device, dtype=like.dtype)


def pad_validator_columns(cols: ValidatorColumns, vp: int,
                          far: int) -> ValidatorColumns:
    """Pad [V] column tensors to [vp] rows with inert validators (see
    above); new tensors, `cols` untouched (returned as is when V == vp)."""
    V = int(cols.balance.shape[0])
    k = vp - V
    if k < 0:
        raise ValueError(f"cannot pad {V} rows down to {vp}")
    if k == 0:
        return cols
    return ValidatorColumns(**{
        f: torch.cat([getattr(cols, f),
                      _tail_tensor(inert_column_tail(f, k, far), getattr(cols, f))])
        for f in ValidatorColumns._fields})


def pad_epoch_inputs(inp: EpochInputs, vp: int) -> EpochInputs:
    """Pad the [V] participation facts to [vp] rows with the neutral
    values build_epoch_inputs uses for non-participants (flags False,
    inclusion delay 1, proposer 0, no crosslink committee); the two
    replicated per-shard tables pass through."""
    V = int(inp.prev_src.shape[0])
    k = vp - V
    if k < 0:
        raise ValueError(f"cannot pad {V} rows down to {vp}")
    if k == 0:
        return inp

    def ext(x, value):
        return torch.cat([x, torch.full((k,), value, dtype=x.dtype,
                                        device=x.device)])
    return inp._replace(
        prev_src=ext(inp.prev_src, False),
        prev_tgt=ext(inp.prev_tgt, False),
        prev_head=ext(inp.prev_head, False),
        curr_tgt=ext(inp.curr_tgt, False),
        incl_delay=ext(inp.incl_delay, 1),
        att_proposer=ext(inp.att_proposer, 0),
        v_shard=ext(inp.v_shard, -1),
        in_winning=ext(inp.in_winning, False),
    )


# ===========================================================================
# Host half: object-model state <-> numpy columns, input distillation
# (port of the reference's host bridge; everything here is numpy, and the
# resident core uploads what the device program needs through convert.py)
# ===========================================================================

def columns_np_from_state(state) -> dict:
    """Numpy SoA extraction of the registry (shared by the device upload and
    the vectorized input distillation, so the registry is walked once)."""
    vr = state.validator_registry
    n = len(vr)

    def col(f, dtype=np.uint64):
        # map(attrgetter) beats a genexpr ~30% at registry scale (no
        # per-element generator frame) — this walk is the distill floor
        return np.fromiter(map(operator.attrgetter(f), vr), dtype=dtype,
                           count=n)

    return {
        "activation_eligibility_epoch": col("activation_eligibility_epoch"),
        "activation_epoch": col("activation_epoch"),
        "exit_epoch": col("exit_epoch"),
        "withdrawable_epoch": col("withdrawable_epoch"),
        "slashed": col("slashed", dtype=np.bool_),
        "effective_balance": col("effective_balance"),
        "balance": np.fromiter((b for b in state.balances), dtype=np.uint64, count=n),
    }


def columns_from_state(state, np_cols: dict = None, device="cuda") -> ValidatorColumns:
    """The registry's columns as tensors on `device` (uint64 as int64 bit
    patterns), from `np_cols` when the caller has them already."""
    from ...convert import to_tensor
    dev = resolve(device)
    np_cols = np_cols if np_cols is not None else columns_np_from_state(state)
    return ValidatorColumns(**{f: to_tensor(np_cols[f], dev)
                               for f in ValidatorColumns._fields})


def scalars_from_state(state) -> EpochScalars:
    """The state's epoch scalars as numpy uint64 (convert.py uploads)."""
    u64 = np.uint64
    return EpochScalars(
        slot=u64(state.slot),
        previous_justified_epoch=u64(state.previous_justified_epoch),
        current_justified_epoch=u64(state.current_justified_epoch),
        justification_bitfield=u64(state.justification_bitfield),
        finalized_epoch=u64(state.finalized_epoch),
        latest_start_shard=u64(state.latest_start_shard),
        latest_slashed_balances=np.array(
            [int(x) for x in state.latest_slashed_balances], dtype=np.uint64),
    )


# ---------------------------------------------------------------------------
# Vectorized input distillation
#
# The former implementation looped `get_attesting_indices` per attestation
# and `get_winning_crosslink_and_attesting_indices` per shard — O(V·A) host
# Python at 1M validators. This layer computes each epoch's committee layout
# ONCE as numpy arrays (the batched swap-or-not permutation already exists
# behind get_shuffle_permutation), decodes every attestation bitfield ONCE
# with np.unpackbits, and reduces winners/balances with array ops. Reference
# semantics it must reproduce exactly: get_attesting_indices
# (0_beacon-chain.md:905-917), the matching-attestation filters (:1266-1322),
# min-inclusion-delay first-tie order (:1423-1429), and crosslink winner
# selection incl. ties + the default-Crosslink edge (:1308-1322).
# ---------------------------------------------------------------------------

class _Layout(NamedTuple):
    """One epoch's committee layout: committee `off` of `count` is
    shuffled[bounds[off]:bounds[off+1]] (compute_committee :884-891)."""
    epoch: int
    shuffled: np.ndarray     # [A] int64 - active indices in shuffled order
    bounds: np.ndarray       # [count+1] int64
    count: int
    start_shard: int


class EpochContext(NamedTuple):
    """Everything the host distillation derives from the object state."""
    n: int
    np_cols: dict
    layouts: dict            # epoch -> _Layout
    prev_atts: list          # PendingAttestation (previous epoch list)
    curr_atts: list
    prev_parts: list         # [len(prev_atts)] np.ndarray participant indices
    curr_parts: list
    cl_roots: dict           # content tuple -> hash_tree_root(Crosslink)


def _crosslink_root(spec, ctx: "EpochContext", c) -> bytes:
    """hash_tree_root(Crosslink) through a content-keyed cache.

    _crosslink_winners runs three times per transition (two epochs in
    process_crosslinks + the deltas pass re-selecting against the updated
    records, mirroring process_epoch's ordering :1251-1262) and most
    candidates repeat — without the cache these tiny-container merkleizations
    are >half of the 1M-validator distill wall-clock. build_epoch_context
    pre-fills the cache in one vectorized batch (_prefill_crosslink_roots);
    this per-record path is the fallback for records created mid-pass."""
    key = (int(c.shard), int(c.start_epoch), int(c.end_epoch),
           bytes(c.parent_root), bytes(c.data_root))
    r = ctx.cl_roots.get(key)
    if r is None:
        r = ctx.cl_roots[key] = spec.hash_tree_root(c)
    return r


def _prefill_crosslink_roots(spec, ctx: "EpochContext", state) -> None:
    """Batch every Crosslink merkleization the winner-selection passes will
    query — the state's records + each attestation's candidate + the
    default — into ONE [N, 8, 32] subtree_roots_batch call instead of ~2k
    recursive per-container hash_tree_root walks (those were ~1.2 s of the
    1M-validator distill). Chunk layout per container Merkleization rules
    (simple-serialize.md:134-145): 5 field leaves (three uint64, two
    Bytes32) padded to the next power of two."""
    keys = {}
    for c in itertools.chain(
            state.current_crosslinks,
            (a.data.crosslink for a in ctx.prev_atts),
            (a.data.crosslink for a in ctx.curr_atts),
            (spec.Crosslink(),)):
        key = (int(c.shard), int(c.start_epoch), int(c.end_epoch),
               bytes(c.parent_root), bytes(c.data_root))
        if key not in keys and key not in ctx.cl_roots:
            keys[key] = None
    if not keys:
        return
    ks = list(keys)
    n = len(ks)
    leaves = np.zeros((n, 8, 32), dtype=np.uint8)
    u64s = np.array([(k[0], k[1], k[2]) for k in ks], dtype="<u8")
    leaves[:, 0:3, :8] = u64s.view(np.uint8).reshape(n, 3, 8)
    leaves[:, 3, :] = np.frombuffer(b"".join(k[3] for k in ks),
                                    np.uint8).reshape(n, 32)
    leaves[:, 4, :] = np.frombuffer(b"".join(k[4] for k in ks),
                                    np.uint8).reshape(n, 32)
    roots = bulk.subtree_roots_batch(leaves, spec.device, spec.pair_fn)
    for i, k in enumerate(ks):
        ctx.cl_roots[k] = roots[i].tobytes()


def _committee_count_for_active(spec, active_count: int) -> int:
    return max(1, min(spec.SHARD_COUNT // spec.SLOTS_PER_EPOCH,
                      active_count // spec.SLOTS_PER_EPOCH
                      // spec.TARGET_COMMITTEE_SIZE)) * spec.SLOTS_PER_EPOCH


def _active_count_np(np_cols: dict, epoch: int) -> int:
    return int(np.count_nonzero(
        (np_cols["activation_epoch"] <= np.uint64(epoch))
        & (np.uint64(epoch) < np_cols["exit_epoch"])))


def _start_shard_np(spec, state, np_cols: dict, epoch: int) -> int:
    """get_epoch_start_shard (:741-745) with active counts from columns
    (the helper recomputes the O(V) active list per shard-delta call)."""
    current_epoch = spec.get_current_epoch(state)
    assert epoch <= current_epoch + 1

    def delta(e):
        return min(_committee_count_for_active(spec, _active_count_np(np_cols, e)),
                   spec.SHARD_COUNT - spec.SHARD_COUNT // spec.SLOTS_PER_EPOCH)

    check_epoch = current_epoch + 1
    shard = (state.latest_start_shard + delta(current_epoch)) % spec.SHARD_COUNT
    while check_epoch > epoch:
        check_epoch -= 1
        shard = (shard + spec.SHARD_COUNT - delta(check_epoch)) % spec.SHARD_COUNT
    return shard


def _epoch_layout(spec, state, np_cols: dict, epoch: int) -> _Layout:
    active = np.nonzero(
        (np_cols["activation_epoch"] <= np.uint64(epoch))
        & (np.uint64(epoch) < np_cols["exit_epoch"]))[0].astype(np.int64)
    seed = spec.generate_seed(state, epoch)
    perm = spec.get_shuffle_permutation(len(active), seed)
    shuffled = active[perm] if len(active) else active
    count = _committee_count_for_active(spec, len(active))
    bounds = (len(active) * np.arange(count + 1, dtype=np.int64)) // count
    return _Layout(epoch=epoch, shuffled=shuffled, bounds=bounds, count=count,
                   start_shard=_start_shard_np(spec, state, np_cols, epoch))


def _decode_participants(spec, layouts: dict, atts) -> list:
    """Per attestation: participant validator indices
    (get_attesting_indices :905-917; order is irrelevant downstream, so the
    reference's sorted() is dropped).

    Batched: every aggregation bitfield decodes through ONE concatenated
    unpackbits and the committee bounds resolve as one vectorized pass per
    epoch — at a full mainnet epoch (~2k attestations) the per-attestation
    loop below does only the two ragged ops (slice + boolean gather)."""
    if not atts:
        return []
    n = len(atts)
    shards = np.fromiter((int(a.data.crosslink.shard) for a in atts),
                         np.int64, n)
    epochs = np.fromiter((int(a.data.target_epoch) for a in atts),
                         np.int64, n)
    bfs = [bytes(a.aggregation_bitfield) for a in atts]
    lo = np.full(n, -1, np.int64)
    hi = np.full(n, -1, np.int64)
    for e, lay in layouts.items():
        m = epochs == e
        if not m.any():
            continue
        offs = (shards[m] + spec.SHARD_COUNT - lay.start_shard) % spec.SHARD_COUNT
        lo[m] = lay.bounds[offs]
        hi[m] = lay.bounds[offs + 1]
    # deterministic diagnostic (the old per-attestation dict lookup raised
    # KeyError) if a target epoch ever escapes build_epoch_context's union
    assert (lo >= 0).all(), "attestation target epoch missing from layouts"
    sizes = hi - lo
    blens = np.fromiter((len(b) for b in bfs), np.int64, n)
    assert (blens == (sizes + 7) // 8).all()  # verify_bitfield :355-361
    allbits = np.unpackbits(np.frombuffer(b"".join(bfs), np.uint8),
                            bitorder="little").astype(bool)
    starts = np.concatenate([[0], np.cumsum(blens * 8)])
    parts = []
    for j in range(n):
        lay = layouts[int(epochs[j])]
        bits = allbits[starts[j]:starts[j] + sizes[j]]
        parts.append(lay.shuffled[lo[j]:hi[j]][bits])
    return parts


def build_epoch_context(spec, state, np_cols: dict = None) -> EpochContext:
    np_cols = np_cols if np_cols is not None else columns_np_from_state(state)
    current_epoch = spec.get_current_epoch(state)
    previous_epoch = spec.get_previous_epoch(state)
    prev_atts = list(spec.get_matching_source_attestations(state, previous_epoch))
    curr_atts = list(spec.get_matching_source_attestations(state, current_epoch))
    layouts = {}
    for e in {previous_epoch, current_epoch}.union(
            int(a.data.target_epoch) for a in prev_atts + curr_atts):
        layouts[e] = _epoch_layout(spec, state, np_cols, e)
    ctx = EpochContext(
        # column length, not len(validator_registry): identical for object
        # states, and checkpoint-resumed resident states keep the registry
        # as columns without materializing objects (resident.py)
        n=len(np_cols["slashed"]), np_cols=np_cols, layouts=layouts,
        prev_atts=prev_atts, curr_atts=curr_atts,
        prev_parts=_decode_participants(spec, layouts, prev_atts),
        curr_parts=_decode_participants(spec, layouts, curr_atts),
        cl_roots={},
    )
    _prefill_crosslink_roots(spec, ctx, state)
    return ctx


def _union_flags(n: int, parts_iter) -> np.ndarray:
    flags = np.zeros(n, dtype=bool)
    chunks = list(parts_iter)
    if chunks:
        flags[np.concatenate(chunks)] = True
    return flags


def _unslashed_union(ctx: EpochContext, parts_list) -> np.ndarray:
    """get_unslashed_attesting_indices (:1294-1300) as an index array."""
    if not parts_list:
        return np.empty(0, dtype=np.int64)
    if len(parts_list) == 1:
        # the common shape (one candidate attestation per group): bitfield
        # decode already yields unique indices, so the dedupe sort is pure
        # overhead — it was ~half the winner-selection time at 1M
        idx = parts_list[0]
    else:
        idx = np.unique(np.concatenate(parts_list))
    return idx[~ctx.np_cols["slashed"][idx]]


def _balance_of(ctx: EpochContext, idx: np.ndarray) -> int:
    """get_total_balance (:933-941): max(sum of effective balances, 1)."""
    return max(int(ctx.np_cols["effective_balance"][idx].sum()), 1)


def _attestation_data_slot(spec, lay: _Layout, data) -> int:
    """get_attestation_data_slot (:747-754) from the cached layout."""
    off = (int(data.crosslink.shard) + spec.SHARD_COUNT
           - lay.start_shard) % spec.SHARD_COUNT
    return (spec.get_epoch_start_slot(lay.epoch)
            + off // (lay.count // spec.SLOTS_PER_EPOCH))


def _crosslink_winners(spec, state, ctx: EpochContext, epoch: int):
    """Per committee offset of `epoch`: (winning_crosslink,
    unslashed_attesting_indices, attesting_balance) — the vectorized
    get_winning_crosslink_and_attesting_indices (:1308-1322), evaluated
    against the CURRENT state.current_crosslinks (callers control ordering
    vs record mutation, exactly like the reference's sequential loops)."""
    current_epoch = spec.get_current_epoch(state)
    atts = ctx.curr_atts if epoch == current_epoch else ctx.prev_atts
    parts = ctx.curr_parts if epoch == current_epoch else ctx.prev_parts
    lay = ctx.layouts[epoch]

    def htr(c):
        return _crosslink_root(spec, ctx, c)

    default_cl = spec.Crosslink()
    default_root = htr(default_cl)

    by_shard: dict = {}
    for j, a in enumerate(atts):
        by_shard.setdefault(int(a.data.crosslink.shard), []).append(j)

    out = []
    for off in range(lay.count):
        shard = (lay.start_shard + off) % spec.SHARD_COUNT
        js = by_shard.get(shard, ())
        current_root = htr(state.current_crosslinks[shard])
        # Candidate crosslinks grouped by root, first-occurrence order; the
        # root filter is `current_root in (c.parent_root, hash_tree_root(c))`
        groups: dict = {}
        order = []
        cl_of = {}
        for j in js:
            c = atts[j].data.crosslink
            r = htr(c)
            if current_root != bytes(c.parent_root) and current_root != r:
                continue
            if r not in groups:
                groups[r] = []
                order.append(r)
                cl_of[r] = c
            groups[r].append(j)
        if not order:
            # max(..., default=Crosslink()): the default still collects
            # attestations whose crosslink equals it (:1318-1321)
            win_js = [j for j in js if htr(atts[j].data.crosslink) == default_root]
            win_idx = _unslashed_union(ctx, [parts[j] for j in win_js])
            out.append((default_cl, win_idx, _balance_of(ctx, win_idx)))
            continue
        best = None
        for r in order:
            idx = _unslashed_union(ctx, [parts[j] for j in groups[r]])
            key = (_balance_of(ctx, idx), bytes(cl_of[r].data_root))
            if best is None or key > best[0]:  # strict: first max wins, like max()
                best = (key, cl_of[r], idx)
        out.append((best[1], best[2], best[0][0]))
    return out


def _committee_balances(ctx: EpochContext, lay: _Layout) -> np.ndarray:
    """[count] committee effective-balance sums via one cumsum (>=1 each)."""
    eff = ctx.np_cols["effective_balance"][lay.shuffled].astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(eff)])
    return np.maximum(cs[lay.bounds[1:]] - cs[lay.bounds[:-1]], 1).astype(np.uint64)


def process_crosslinks_vectorized(spec, state, ctx: EpochContext) -> None:
    """process_crosslinks (:1377-1387) on the decoded context.

    The reference mutates state.current_crosslinks[shard] as it loops
    (epoch, offset) — but within one epoch each offset touches a DISTINCT
    shard (count <= SHARD_COUNT consecutive shards) and selection for a
    shard reads only that shard's record, so the epoch's winners can be
    batch-computed before its updates. Across epochs the sequencing is
    preserved: the current epoch's winners are selected against the
    previous epoch's updated records."""
    state.previous_crosslinks = [c for c in state.current_crosslinks]
    for epoch in (spec.get_previous_epoch(state), spec.get_current_epoch(state)):
        lay = ctx.layouts[epoch]
        comm_bal = _committee_balances(ctx, lay)
        winners = _crosslink_winners(spec, state, ctx, epoch)
        for off, (winner, _, att_bal) in enumerate(winners):
            shard = (lay.start_shard + off) % spec.SHARD_COUNT
            if 3 * att_bal >= 2 * int(comm_bal[off]):
                state.current_crosslinks[shard] = winner


def build_epoch_inputs(spec, state, ctx: EpochContext = None) -> EpochInputs:
    """Distill PendingAttestations + committee layout into the epoch
    program's inputs, as numpy arrays (convert.py uploads them).

    Must be called AFTER process_crosslinks has run on `state` (winner
    selection for deltas reads the updated current_crosslinks, matching the
    reference's process_epoch ordering :1251-1262).
    """
    ctx = ctx if ctx is not None else build_epoch_context(spec, state)
    n = ctx.n
    current_epoch = spec.get_current_epoch(state)
    previous_epoch = spec.get_previous_epoch(state)
    prev_lay = ctx.layouts[previous_epoch]

    # Matching filters (:1266-1290) — cheap per-attestation byte compares
    prev_target_root = spec.get_block_root(state, previous_epoch)
    prev_src = _union_flags(n, ctx.prev_parts)
    prev_tgt = _union_flags(n, (
        p for a, p in zip(ctx.prev_atts, ctx.prev_parts)
        if bytes(a.data.target_root) == prev_target_root))
    prev_head = _union_flags(n, (
        p for a, p in zip(ctx.prev_atts, ctx.prev_parts)
        if bytes(a.data.beacon_block_root) == spec.get_block_root_at_slot(
            state, _attestation_data_slot(
                spec, ctx.layouts[int(a.data.target_epoch)], a.data))))
    curr_target_root = spec.get_block_root(state, current_epoch)
    curr_tgt = _union_flags(n, (
        p for a, p in zip(ctx.curr_atts, ctx.curr_parts)
        if bytes(a.data.target_root) == curr_target_root))

    # Min-inclusion-delay attestation per source attester (:1423-1429);
    # python min() keeps the first minimum, so strict < preserves tie order.
    incl_delay = np.ones(n, dtype=np.uint64)
    best = np.full(n, np.iinfo(np.uint64).max, dtype=np.uint64)
    att_proposer = np.zeros(n, dtype=np.int32)
    for a, idxs in zip(ctx.prev_atts, ctx.prev_parts):
        better = a.inclusion_delay < best[idxs]
        upd = idxs[better]
        best[upd] = a.inclusion_delay
        incl_delay[upd] = a.inclusion_delay
        att_proposer[upd] = a.proposer_index

    # Crosslink-committee layout + winners for the previous epoch (:1445-1463)
    v_shard = np.full(n, -1, dtype=np.int32)
    shards = ((prev_lay.start_shard + np.arange(prev_lay.count))
              % spec.SHARD_COUNT).astype(np.int32)
    v_shard[prev_lay.shuffled] = np.repeat(shards, np.diff(prev_lay.bounds))
    in_winning = np.zeros(n, dtype=bool)
    shard_att_balance = np.ones(spec.SHARD_COUNT, dtype=np.uint64)
    shard_comm_balance = np.ones(spec.SHARD_COUNT, dtype=np.uint64)
    comm_bal = _committee_balances(ctx, prev_lay)
    winners = _crosslink_winners(spec, state, ctx, previous_epoch)
    for off, (_, win_idx, att_bal) in enumerate(winners):
        shard = int(shards[off])
        in_winning[win_idx] = True
        shard_att_balance[shard] = att_bal
        shard_comm_balance[shard] = comm_bal[off]

    return EpochInputs(
        prev_src=prev_src,
        prev_tgt=prev_tgt,
        prev_head=prev_head,
        curr_tgt=curr_tgt,
        incl_delay=incl_delay,
        att_proposer=att_proposer,
        v_shard=v_shard,
        in_winning=in_winning,
        shard_att_balance=shard_att_balance,
        shard_comm_balance=shard_comm_balance,
    )


def _apply_justification(spec, state, new_scal, report,
                         previous_epoch, current_epoch) -> None:
    """Justification scalars + the root writes they gate (:1326-1373);
    new_scal and report downloaded as numpy (uint64 / bool)."""
    if bool(report.justification_active):
        state.previous_justified_root = state.current_justified_root
        state.previous_justified_epoch = int(new_scal.previous_justified_epoch)
        state.current_justified_epoch = int(new_scal.current_justified_epoch)
        state.justification_bitfield = int(new_scal.justification_bitfield)
        if bool(report.justified_prev_fired):
            state.current_justified_root = spec.get_block_root(state, previous_epoch)
        if bool(report.justified_curr_fired):
            state.current_justified_root = spec.get_block_root(state, current_epoch)
        state.finalized_epoch = int(new_scal.finalized_epoch)
        if bool(report.finalized_fired):
            state.finalized_root = spec.get_block_root(state, state.finalized_epoch)


def _apply_validator_columns(state, new_cols) -> None:
    """Numpy uint64 columns -> object registry (.tolist() yields python
    ints ~10x faster than per-element int() casts at registry scale);
    `slashed` is excluded — the numeric epoch stages never change it."""
    arrs = {f: np.asarray(getattr(new_cols, f)).tolist()
            for f in ValidatorColumns._fields if f != "slashed"}
    for v, elig, act, exit_ep, wd, eff in zip(
            state.validator_registry, arrs["activation_eligibility_epoch"],
            arrs["activation_epoch"], arrs["exit_epoch"],
            arrs["withdrawable_epoch"], arrs["effective_balance"]):
        v.activation_eligibility_epoch = elig
        v.activation_epoch = act
        v.exit_epoch = exit_ep
        v.withdrawable_epoch = wd
        v.effective_balance = eff
    state.balances = arrs["balance"]


# ===========================================================================
# Bridges: the object model's process_epoch through the device program
# ===========================================================================

def _upload_columns(spec, state, np_cols: dict = None):
    """Fresh device columns and scalars of `state` on spec.device (never a
    caller's tensors: the fused program writes its columns in place)."""
    from ... import convert
    np_cols = np_cols if np_cols is not None else columns_np_from_state(state)
    cols, scal, _ = convert.columns_from_numpy(
        ValidatorColumns(**np_cols), scalars_from_state(state), None,
        spec.device)
    return cols, scal


def _write_back_scalars(state, np_scal) -> None:
    state.latest_slashed_balances = [
        int(x) for x in np_scal.latest_slashed_balances]
    state.latest_start_shard = int(np_scal.latest_start_shard)


def process_epoch_soa(spec, state, timings: dict = None):
    """Drop-in replacement for spec.process_epoch through the device
    program on spec.device.

    The host does the byte-rooted bookkeeping (justified / finalized
    roots, randao / index-root / historical rotations, attestation
    rotation) in the reference's write order; the device does every
    [V]-shaped loop. A spec with phase-1 insert hooks takes
    process_epoch_soa_staged, which runs them at process_epoch's points.

    Returns the post-transition device columns and scalars (still on the
    device). The stages run under telemetry spans "epoch.distill",
    "epoch.perm", "epoch.device" and "epoch.writeback", fenced at span
    exit only; with `timings`, their seconds go to the keys "distill",
    "perm", "device" and "writeback" (zeros with telemetry off; the staged
    route leaves `timings` untouched)."""
    from ... import convert
    if spec._insert_after_registry_updates or spec._insert_after_final_updates:
        return process_epoch_soa_staged(spec, state)

    with telemetry.span("epoch.distill") as sp_cols:
        cfg = EpochConfig.from_spec(spec)
        np_cols = columns_np_from_state(state)
        cols, scal = _upload_columns(spec, state, np_cols)
        current_epoch = spec.get_current_epoch(state)
        previous_epoch = spec.get_previous_epoch(state)

    if timings is not None:
        # the two layout permutations are device work (the shuffle), not
        # host distillation: warm them into the spec's permutation cache
        # under their own span so "epoch.distill" stays host-only
        with telemetry.span("epoch.perm") as sp_perm:
            for e in (previous_epoch, current_epoch):
                spec.get_shuffle_permutation(
                    _active_count_np(np_cols, e), spec.generate_seed(state, e))
        timings["perm"] = sp_perm.duration

    with telemetry.span("epoch.distill") as sp_inp:
        # crosslink records update on the host (byte roots) before the
        # input distillation, in process_epoch's order (:1251-1262)
        ctx = build_epoch_context(spec, state, np_cols)
        process_crosslinks_vectorized(spec, state, ctx)
        _, _, inp = convert.columns_from_numpy(
            None, None, build_epoch_inputs(spec, state, ctx), spec.device)
        if timings is not None:
            # the uploads land in "epoch.distill", not in the program's span
            sp_inp.fence(cols, scal, inp)

    with telemetry.span("epoch.device") as sp_dev:
        dev_cols, dev_scal, dev_report = epoch_transition_device(
            cfg, cols, scal, inp)
        sp_dev.fence(dev_cols.balance)

    with telemetry.span("epoch.writeback") as sp_wb:
        new_cols, new_scal, report = convert.columns_to_numpy(
            dev_cols, dev_scal, dev_report)
        _apply_justification(spec, state, new_scal, report,
                             previous_epoch, current_epoch)
        _apply_validator_columns(state, new_cols)
        _write_back_scalars(state, new_scal)
        spec.final_updates_byte_rooted(state)

    if timings is not None:
        timings["distill"] = sp_cols.duration + sp_inp.duration
        timings["device"] = sp_dev.duration
        timings["writeback"] = sp_wb.duration
    return dev_cols, dev_scal


def process_epoch_soa_staged(spec, state):
    """The device epoch for a spec WITH phase-1 insert hooks: stage A
    (justification, rewards, registry updates) on the device, its results
    written to the object state, the @process_reveal_deadlines /
    @process_challenge_deadlines hooks on that state (they slash
    validators and grow the slashed-balance table), then stage B
    (slashings, numeric final updates) on columns distilled AGAIN from the
    mutated state, then the byte-rooted final updates and the
    @after_process_final_updates hooks: process_epoch's exact order
    (1_custody-game.md:668-716). Returns stage B's device columns and
    scalars."""
    from ... import convert
    cfg = EpochConfig.from_spec(spec)
    np_cols = columns_np_from_state(state)
    cols, scal = _upload_columns(spec, state, np_cols)
    current_epoch = spec.get_current_epoch(state)
    previous_epoch = spec.get_previous_epoch(state)

    ctx = build_epoch_context(spec, state, np_cols)
    process_crosslinks_vectorized(spec, state, ctx)
    _, _, inp = convert.columns_from_numpy(
        None, None, build_epoch_inputs(spec, state, ctx), spec.device)

    mid_cols, mid_scal, report = convert.columns_to_numpy(
        *_stage_a(cfg, cols, scal, inp))
    _apply_justification(spec, state, mid_scal, report,
                         previous_epoch, current_epoch)
    _apply_validator_columns(state, mid_cols)

    for hook in spec._insert_after_registry_updates:
        hook(state)

    cols2, scal2 = _upload_columns(spec, state)
    dev_cols, dev_scal = _stage_b(cfg, cols2, scal2)
    b_cols, b_scal, _ = convert.columns_to_numpy(dev_cols, dev_scal)
    _apply_validator_columns(state, b_cols)
    _write_back_scalars(state, b_scal)

    spec.final_updates_byte_rooted(state)
    for hook in spec._insert_after_final_updates:
        hook(state)
    return dev_cols, dev_scal
