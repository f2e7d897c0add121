"""The G2 ladder, the grouped Miller loop, the final exponentiation and the
decompressions' addition trees as programs, and the wrappers of their
kernels (csrc/fq_points.cu).

`ladder_program(nbits, w)` records, over ops/fq_program.py's Recorder,
what bls_torch.g2_scalar_mul computes: scalar_mul._lift_affine,
build_odd_multiples, the reference's window loop with the digits as data
(consensus_specs_tpu/ops/scalar_mul.py:275 windowed_scalar_mul: a table
load by digit, the negation selected by its sign, w jac_double and one
jac_add per window, the correction add selected by a flag) and
jac_to_affine with Field.pow_static's inversion. `miller_program(P)`
records bls_torch.miller_loop_grouped: per tail bit of |z| the port's
_dbl_lines for each pair and the f-update (one Fq12 squaring, P line
multiplies), on a set bit _add_lines and P more line multiplies, then the
conjugation. `final_exp_program()` records bls_torch._grouped_verdict on
a group's 12 Miller rows: final_exponentiation_3x (fq12_inv with its Fq
inversion, the Frobenius maps, the five pow_abs runs of cyclotomic
squarings, the products) and fq12_eq with one -> the final power and the
verdict flag.
`tree_program(curve, levels, affine)` records `levels` levels of the G1 or
G2 addition tree (scalar_mul.jac_add on neighbouring points) over 2^levels
points a lane, with jac_to_affine when `affine`. All are built once per
shape and cached.

`g2_ladder_cuda` / `miller_grouped_cuda` / `final_exp_cuda` run a
program in one launch of a kernel, and `point_tree_cuda` a tree in one
launch a TREE_LEVELS levels (`tree_plan`); `*_plain` run the same
programs through fq_program.run_program_plain (the plain twins the tests
and the card's checks hold the kernels against).
Either kernel runs any program (ENTRY: "groups" puts a multiply on a
16-thread group, "threads" one thread on an item): the ladder and the final
exponentiation take groups, the Miller loop threads, a tree launch groups
up to GROUP_LANES_PER_SM lanes an SM and threads beyond. bls_torch routes
CUDA tensors under fq_tower.DEVICE to the kernels and keeps its Python
loops for CPU tensors and fq_tower.PLAIN; a program or shape a kernel
cannot run, or a kernel that does not build or launch, raises. Each
wrapper counts its launches (`ladder_counter`, `miller_counter`,
`final_exp_counter`, `tree_counter`). `launch_shape` gives a launch's
block and shared memory as the kernel sizes them; `bundle_clocks` reads
block 0's cycles a bundle and phase.

The split_* functions model, on the CPU, the ladder kernel's multiply on
a 16-thread group (limb k and columns k, k + 14 on lane k; the REDC with
the columns in registers, each digit's column broadcast from its lane,
or every lane making the digits from the low columns), for the tests to
hold against the plain field; nothing on a path calls them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import fq as F
from . import fq_program as FP
from . import scalar_mul as SM
from ._nvcc import load_library
from .fq_cuda import _Counter

L = F.L

# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------


def ladder_walk(fo, aff, idx, sign, correction, w: int, inf=None):
    """[k]P with the digits as data, as the reference's windowed_scalar_mul
    computes it (table load by idx[i], y negated where sign[i] < 0, the
    correction add kept where the flag is set), over ops/scalar_mul.py's
    point functions. fo: a field-ops namespace with `take` (values[idx])."""
    lifted = SM._lift_affine(fo, aff, inf)
    entries = SM.build_odd_multiples(fo, lifted, w)
    table = tuple([e[c] for e in entries] for c in range(3))

    def entry(i):
        tx, ty, tz = (fo.take(t, idx[i]) for t in table)
        ty = fo.select(sign[i] < 0, fo.neg(ty), ty)
        return (tx, ty, tz)

    acc = entry(0)
    for i in range(1, int(idx.shape[0])):
        for _ in range(w):
            acc = SM.jac_double(fo, acc)
        acc = SM.jac_add(fo, acc, entry(i))
    minus_p = (lifted[0], fo.neg(lifted[1]), lifted[2])
    fixed = SM.jac_add(fo, acc, minus_p)
    return tuple(fo.select(correction, f, a) for f, a in zip(fixed, acc))


def ladder_inputs(rec: FP.Recorder, nbits: int, w: int):
    """The ladder's inputs, in the program's order: (x, y), the infinity
    lane flag, the correction flag, the digits."""
    x, y = rec.input_fq2(0), rec.input_fq2(0)
    inf = rec.input_lane_flag()
    corr = rec.input_uniform_flag()
    return (x, y), inf, corr, FP.Digits(rec, SM.n_windows(nbits, w))


def ladder_recording(nbits: int, w: int):
    """(recorder, Jacobian [k]P, affine (x, y, is_inf)): g2_scalar_mul's
    ops for `nbits`-bit scalars at window w."""
    rec = FP.Recorder()
    fo = FP.FieldOps(rec)
    aff, inf, corr, digits = ladder_inputs(rec, nbits, w)
    acc = ladder_walk(fo, aff, digits, digits, corr, w, inf)
    return rec, acc, SM.jac_to_affine(fo, acc)


@functools.lru_cache(maxsize=None)
def ladder_program(nbits: int, w: int) -> FP.Program:
    """The program of g2_scalar_mul for every scalar of `nbits` bits at
    window w: input rows (x0, x1, y0, y1), the infinity lane flag, the
    correction flag and n_windows(nbits, w) digits -> rows (x0, x1, y0, y1)
    and the infinity flag."""
    rec, _, (xo, yo, info) = ladder_recording(nbits, w)
    return rec.compile(xo.r + yo.r, info.v, n_digits=SM.n_windows(nbits, w))


def miller_walk(rec, pairs, dbl_lines, add_lines, tail_bits):
    """The grouped Miller loop over per-pair symbolic inputs pairs =
    [(xp, yp, xq, yq)], with the port's line functions: f as 12 rows."""
    f = rec.fq12_ones()
    state = [(xq, yq, rec.fq2_ones()) for _, _, xq, yq in pairs]
    for bit in tail_bits:
        lines = []
        for p, (xp, yp, xq, yq) in enumerate(pairs):
            X, Y, Z = state[p]
            c_a, c_v, c_vw, X, Y, Z = dbl_lines(rec, X, Y, Z, xp, yp)
            lines.append((c_a, c_v, c_vw))
            state[p] = (X, Y, Z)
        f = rec.fq12_sqr_mul_lines(f, *zip(*lines))
        if bit:
            lines = []
            for p, (xp, yp, xq, yq) in enumerate(pairs):
                X, Y, Z = state[p]
                c_a, c_v, c_vw, X, Y, Z = add_lines(rec, X, Y, Z, xq, yq, xp, yp)
                lines.append((c_a, c_v, c_vw))
                state[p] = (X, Y, Z)
            f = rec.fq12_mul_lines(f, *zip(*lines))
    return rec.fq12_conj(f)


def miller_inputs(rec: FP.Recorder, P: int):
    """The Miller loop's inputs, in the program's order: per pair
    (xp, yp, xq, yq), the G1 rows of every pair first."""
    g1 = [[FP.S1(rec, v) for v in rec.input_rows(0, 2)] for _ in range(P)]
    g2 = [(rec.input_fq2(1), rec.input_fq2(1)) for _ in range(P)]
    return [(a[0], a[1], b[0], b[1]) for a, b in zip(g1, g2)]


def miller_recording(P: int):
    """(recorder, f rows): miller_loop_grouped's ops for groups of P
    pairs."""
    from . import bls_torch as BT
    rec = FP.Recorder()
    pairs = miller_inputs(rec, P)
    return rec, miller_walk(rec, pairs, BT._dbl_lines, BT._add_lines, BT._Z_TAIL_BITS)


@functools.lru_cache(maxsize=None)
def miller_program(P: int) -> FP.Program:
    """The program of miller_loop_grouped for groups of P pairs: input
    group 0 the pairs' G1 rows (xp, yp), group 1 their G2 rows (xq0, xq1,
    yq0, yq1) -> the 12 rows of the group's conjugated f."""
    rec, f = miller_recording(P)
    return rec.compile(f)


def final_exp_recording(rec: FP.Recorder, f):
    """(result rows, verdict flag): bls_torch._grouped_verdict recorded
    over `rec` from the 12 rows f: final_exponentiation_3x, then
    Tower.fq12_eq of the result with one."""
    from . import bls_torch as BT
    res = BT.final_exponentiation_3x(f, rec)
    return res, rec.fq12_eq(res, rec.fq12_ones())


@functools.lru_cache(maxsize=None)
def final_exp_program() -> FP.Program:
    """The program of _grouped_verdict: input group 0 a group's 12 Miller
    rows -> the 12 rows of f^(3 (q^12 - 1) / r) and the flag "equal to
    one"."""
    rec = FP.Recorder()
    res, ok = final_exp_recording(rec, rec.input_rows(0, 12))
    return rec.compile(res, ok.v)


TREE_LEVELS = 3        # tree levels a launch: 2^3 points a lane


def _rows(v):
    return [v.v] if isinstance(v, FP.S1) else list(v.r)


def tree_inputs(rec: FP.Recorder, curve: str, n: int):
    """(field ops, n Jacobian points) over input group 0: per point the
    rows of X, Y, Z (G1: one row each, G2: two)."""
    if curve == "g1":
        fo = FP.G1Ops(rec)
        return fo, [tuple(FP.S1(rec, v) for v in rec.input_rows(0, 3)) for _ in range(n)]
    fo = FP.FieldOps(rec)
    return fo, [tuple(rec.input_fq2(0) for _ in range(3)) for _ in range(n)]


def tree_walk(fo, pts):
    """The decompressions' addition tree: each level adds points 2i and
    2i + 1 (scalar_mul.jac_add), as bls_torch's loop does."""
    while len(pts) > 1:
        pts = [SM.jac_add(fo, pts[i], pts[i + 1]) for i in range(0, len(pts), 2)]
    return pts[0]


def tree_recording(curve: str, levels: int, affine: bool):
    """(recorder, output rows, output flag or None): `levels` levels of
    the addition tree over 2^levels Jacobian points of `curve` ("g1" over
    Fq rows, "g2" over Fq2), then with `affine` jac_to_affine."""
    rec = FP.Recorder()
    fo, pts = tree_inputs(rec, curve, 1 << levels)
    acc = tree_walk(fo, pts)
    if affine:
        x, y, inf = SM.jac_to_affine(fo, acc)
        return rec, _rows(x) + _rows(y), inf.v
    return rec, [r for c in acc for r in _rows(c)], None


@functools.lru_cache(maxsize=None)
def tree_program(curve: str, levels: int, affine: bool) -> FP.Program:
    """tree_recording's program: input group 0 the points' (X, Y, Z) rows
    -> the sum's (X, Y, Z) rows, or with `affine` the (x, y) rows and the
    infinity flag."""
    rec, rows, flag = tree_recording(curve, levels, affine)
    return rec.compile(rows, flag)


def tree_plan(levels: int):
    """The launches of a tree of 2^levels points: [(levels, affine)],
    TREE_LEVELS levels each, jac_to_affine in the last."""
    plan = []
    while levels > TREE_LEVELS:
        plan.append((TREE_LEVELS, False))
        levels -= TREE_LEVELS
    return plan + [(levels, True)]


def _tree_shape(curve: str, pts: torch.Tensor):
    """(points a row B, points C, rows a point) of a tree's input."""
    coord = (L,) if curve == "g1" else (2, L)
    if curve not in ("g1", "g2") or pts.dim() != 3 + len(coord) \
            or pts.shape[2:] != (3,) + coord:
        raise ValueError(f"point tree {curve}: points {tuple(pts.shape)}")
    B, C = int(pts.shape[0]), int(pts.shape[1])
    if C < 1 or C & (C - 1):
        raise ValueError(f"point tree: {C} points a row, not a power of two")
    return B, C, 3 * len(coord)


# ---------------------------------------------------------------------------
# Work and bounds
# ---------------------------------------------------------------------------

def program_work(prog: FP.Program, lanes: int):
    """(limb products, bytes) of a launch: every multiply's 196 schoolbook
    and 210 REDC products, every tower product's leaves (196 each) and
    REDCs (210 each), per lane; the inputs read and the outputs written
    once (a lane's flag one byte in, one out)."""
    products = prog.n_mul * (L * L + L * 15) + prog.n_leaves * L * L + prog.n_redc * L * 15
    rows = prog.in_rows[0] + prog.in_rows[1] + prog.out_rows
    nbytes = rows * L * 8 + (2 if prog.out_flag >= 0 else 0)
    return products * lanes, nbytes * lanes


def bound_ms(prog: FP.Program, lanes: int, imad_per_s: float,
             bytes_per_s: float):
    """(ms, "operations" | "bytes"): the launch's products at one
    IMAD.WIDE each at the 32-bit multiply-add rate, or its bytes at the
    memory rate, whichever is longer."""
    products, nbytes = program_work(prog, lanes)
    ops_ms = products / imad_per_s * 1e3
    bytes_ms = nbytes / bytes_per_s * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# csrc/fq_points.cu's launch constants
_SMEM_TARGET, _SCR_WORDS, _Q_WORDS = 96 * 1024, 144, 48
_MAX_CONSUMERS = 256              # threads, the producer warp aside


def launch_shape(prog: FP.Program, lanes: int, sms: int = 132):
    """(lanes a block, threads, shared bytes a block, the ring's bytes) of
    a launch of `lanes` lanes on a card of `sms` SMs, as csrc/fq_points.cu's
    launch() computes them: consumer warps for the widest phase (2 to 8)
    and the producer warp; the ring of FP.RING slots of the largest
    record, its full and empty mbarriers, the q table, the digits, 144
    exchange words a 16-thread group, and per lane the register file,
    leaf rows, wide rows and flags."""
    per_lane = (8 * (prog.nreg * L + 2 * prog.nx * L + prog.ng * (2 * L + 2))
                + 4 * ((prog.nflag + 3) & ~3))
    ring = 4 * FP.RING * prog.slot_words

    def fixed(threads):
        return (ring + 16 * FP.RING + 4 * _Q_WORDS + 8 * ((prog.n_digits + 3) & ~3)
                + 4 * _SCR_WORDS * ((threads - 32) // FP.GROUP))

    tile = max(1, min(-(-lanes // sms),
                      (_SMEM_TARGET - fixed(_MAX_CONSUMERS + 32)) // per_lane))
    threads = min(_MAX_CONSUMERS, max(64, -(-prog.threads_lane * tile // 32) * 32)) + 32
    return tile, threads, fixed(threads) + per_lane * tile, ring


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _digits(rec: SM.SignedWindows):
    return np.asarray(rec.idx, np.int64), np.asarray(rec.sign, np.int64)


def g2_ladder_plain(x: torch.Tensor, y: torch.Tensor, inf: Optional[torch.Tensor],
                    rec: SM.SignedWindows):
    """The ladder program through run_program_plain: x, y [n, 2, 14]
    affine limbs, inf [n] bool (None: no infinity lane) -> (x, y, is_inf)
    equal to jac_to_affine(windowed_scalar_mul(...)) bit for bit."""
    prog = ladder_program(rec.nbits, rec.w)
    n = x.shape[0]
    out, flag = FP.run_program_plain(
        prog, torch.cat([x, y], dim=-2).reshape(n, 4, L), lane_flag=inf,
        uniform_flag=rec.correction, digits=_digits(rec))
    return out[:, :2], out[:, 2:], flag


def final_exp_plain(f: torch.Tensor):
    """The final exponentiation's program through run_program_plain: f
    [G, 2, 3, 2, 14] -> (f^(3 (q^12 - 1) / r) [G, 2, 3, 2, 14], [G] bool
    equal to one)."""
    G = f.shape[0]
    out, flag = FP.run_program_plain(final_exp_program(), f.reshape(G, 12, L))
    return out.reshape(G, 2, 3, 2, L), flag


def _tree_out(curve, B, out, flag):
    coord = (L,) if curve == "g1" else (2, L)
    k = 1 if curve == "g1" else 2
    return (out[:, :k].reshape((B,) + coord), out[:, k:].reshape((B,) + coord),
            flag.bool())


def point_tree_plain(curve: str, pts: torch.Tensor):
    """The tree's launches (tree_plan) through run_program_plain: pts
    [B, C, 3, 14] (G1) or [B, C, 3, 2, 14] (G2) Jacobian, C a power of
    two -> affine (x, y, is_inf) of each row's sum, as bls_torch's loop
    and jac_to_affine give them."""
    B, C, rows = _tree_shape(curve, pts)
    cur = pts.reshape(B, C, rows, L)
    for k, affine in tree_plan(C.bit_length() - 1):
        n = B * (C >> k)
        cur, flag = FP.run_program_plain(tree_program(curve, k, affine),
                                         cur.reshape(n, (1 << k) * rows, L))
        C >>= k
    return _tree_out(curve, B, cur, flag)


def miller_grouped_plain(g1: torch.Tensor, g2: torch.Tensor):
    """The Miller program through run_program_plain: g1 [G, P, 2, 14], g2
    [G, P, 2, 2, 14] -> [G, 2, 3, 2, 14]."""
    G, P = g1.shape[0], g1.shape[1]
    out, _ = FP.run_program_plain(miller_program(P), g1.reshape(G, 2 * P, L),
                                  g2.reshape(G, 4 * P, L))
    return out.reshape(G, 2, 3, 2, L)


# ---------------------------------------------------------------------------
# The ladder kernel's split multiply, modelled on the CPU
# ---------------------------------------------------------------------------
#
# csrc/fq_points.cu's g2_ladder_kernel runs each multiply, leaf and REDC on
# a group of 16 threads: lane k (0..13) holds limb k of a row and columns k
# and k + 14 of a wide row. These functions do the same arithmetic on a
# lane axis (the last axis, length 14), in the kernel's order and integer
# widths, so the tests can hold the decomposition against fq_mul_plain /
# fq_redc_plain before any card. The kernel's documented twin; nothing on
# a path calls them.

_LANE = np.arange(L)
_ROT = (_LANE[:, None] - _LANE[None, :]) % L            # [k, i]: (k - i) mod 14
_LOW = _LANE[None, :] <= _LANE[:, None]                 # [k, i]: i <= k
_Q_PAD = np.concatenate([F.Q_LIMBS, np.zeros(2 * L + 4 - L, np.int64)])
_Q_HIGH = _Q_PAD[L + _LANE[:, None] - _LANE[None, :]]    # [k, i]: q_{14+k-i}, 0 if i <= k


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of t as a signed int32 value (an int32 register)."""
    return ((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _from_below(h: torch.Tensor) -> torch.Tensor:
    """Lane k - 1's value at lane k (a shuffle up by one), 0 at lane 0."""
    return torch.cat([torch.zeros_like(h[..., :1]), h[..., :-1]], dim=-1)


def lane_round(t: torch.Tensor, int32: bool = False) -> torch.Tensor:
    """One carry round of a row held a limb a lane: lane k keeps its low
    29 bits plus lane k - 1's carry, lane 13 keeps its own overflow. With
    int32, in 32-bit registers (every sum cut to 32 bits)."""
    hi = t >> F.B
    top = torch.zeros_like(t)
    top[..., -1] = hi[..., -1] * (1 << F.B)
    out = (t & F.MASK) + _from_below(hi) + top
    return _wrap32(out) if int32 else out


def split_narrow(a: torch.Tensor) -> torch.Tensor:
    """narrow32 of a multiply operand by lanes: one round in int64, cut to
    int32, two rounds in int32 -> [..., 14] int32 values (as int64)."""
    x = _wrap32(lane_round(a))
    return lane_round(lane_round(x, True), True)


def split_columns(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The schoolbook by lanes: lane k sums x_i y_{(k-i) mod 14} into
    column k where i <= k and into column k + 14 where i > k (the kernel
    reads y from zero-padded copies, so every lane runs the same 28
    multiply-adds) -> [..., 28] int64 columns."""
    prod = x[..., None, :] * y[..., torch.as_tensor(_ROT)]        # [..., k, i]
    low = torch.as_tensor(_LOW)
    return torch.cat([(prod * low).sum(-1), (prod * ~low).sum(-1)], dim=-1)


def split_wide_norm(cols: torch.Tensor) -> torch.Tensor:
    """wide_norm32 by lanes: lane k holds columns k (lo) and k + 14 (hi);
    column j takes column j - 1's carry (lane 0's hi takes lane 13's lo
    carry), column 27 keeps its own overflow; two rounds in int64, one in
    int32."""
    lo, hi = cols[..., :L], cols[..., L:]
    for r in range(3):
        hl, hh = lo >> F.B, hi >> F.B
        carry_hi = torch.cat([hl[..., -1:], hh[..., :-1]], dim=-1)
        top = torch.zeros_like(hi)
        top[..., -1] = hh[..., -1] * (1 << F.B)
        lo = (lo & F.MASK) + _from_below(hl)
        hi = (hi & F.MASK) + carry_hi + top
        if r >= 1:                   # the int32 round runs on the cut values
            lo, hi = _wrap32(lo), _wrap32(hi)
    return torch.cat([lo, hi], dim=-1)


_Q_LO = np.where(_LANE[:, None] > _LANE[None, :],
                 _Q_PAD[np.clip(_LANE[:, None] - _LANE[None, :], 0, L - 1)], 0)   # q_{k-i}, k > i


def split_redc(cols: torch.Tensor, route: str = "triangle") -> torch.Tensor:
    """redc() by lanes (lane k: columns k and 14 + k) -> [..., 14] limbs.
    "triangle": the 14 digits one after another from the low 14 columns,
    every lane making them (the low triangle of the reduction, as one
    thread's redc() runs it), then lane k adds m_i q_{14+k-i} to its
    column 14 + k (zero for i <= k). "registers" (csrc/fq_arith.cuh
    group_redc_regs, the point and chain kernels' groups): digit i from
    lane i's low column, broadcast, plus the previous digit's carry; every
    lane adds m_i q_{k-i} to its low column (k > i) and m_i q_{14+k-i} to
    its high one (k < i). Either way lane 0 then adds the last carry, and
    three carry rounds run across the lanes."""
    q = [int(v) for v in F.Q_LIMBS]
    carry = torch.zeros_like(cols[..., 0])
    if route == "registers":
        lo, out = cols[..., :L].clone(), cols[..., L:].clone()
        q_lo, q_hi = torch.as_tensor(_Q_LO), torch.as_tensor(_Q_HIGH)
        for i in range(L):
            v = lo[..., i] + carry                                  # lane i's, broadcast
            m = ((v & 0xFFFFFFFF) * F.QINV_NEG) & F.MASK
            carry = (m * q[0] + v) >> F.B
            lo = lo + m[..., None] * q_lo[:, i]
            out = out + m[..., None] * q_hi[:, i]
    else:
        low = cols[..., :L].clone()
        digits = []
        for i in range(L):
            v = low[..., i] + carry
            m = ((v & 0xFFFFFFFF) * F.QINV_NEG) & F.MASK
            carry = (m * q[0] + v) >> F.B
            for j in range(1, L - i):
                low[..., i + j] += m * q[j]
            digits.append(m)
        m = torch.stack(digits, dim=-1)                             # [..., i]
        out = cols[..., L:] + (m[..., None, :] * torch.as_tensor(_Q_HIGH)).sum(-1)
    out[..., 0] += carry
    for _ in range(3):
        out = lane_round(out)
    return out


def split_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A multiply as the kernel's group runs it (the columns straight into
    the REDC in registers): fq_mul_plain's integers."""
    return split_redc(split_columns(split_narrow(a), split_narrow(b)), "registers")


def split_bilinear(av: torch.Tensor, bv: torch.Tensor, tables: F.Bilinear) -> torch.Tensor:
    """A program's tower product (no norm_in, no one_col) as the kernel
    runs it: each leaf by a group (narrow, columns, wide norm), the gamma
    sums, each output's REDC by a group: fq_bilinear_plain's integers."""
    alpha, beta, gamma = tables
    leaves = split_wide_norm(split_columns(split_narrow(alpha.apply(av)),
                                           split_narrow(beta.apply(bv))))
    return split_redc(gamma.apply(leaves), "registers")


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

ladder_counter = _Counter()       # lanes per launch
miller_counter = _Counter()       # keyed (groups, pairs)
final_exp_counter = _Counter()    # groups per launch
tree_counter = _Counter()         # keyed (curve, lanes)

# The two kernels of csrc/fq_points.cu run any program: g2_ladder_kernel
# puts each multiply on a 16-thread group ("groups"), miller_grouped_kernel
# one thread on an item ("threads").
ENTRY = {"groups": "g2_ladder", "threads": "miller_grouped"}
GROUP_LANES_PER_SM = 8            # tree launches take groups up to this many lanes an SM
# The final exponentiation's kernel, by measurement (tools/
# point_program_probe.py, PERF.md section 6): on groups 1.68-1.77 ms at 16
# and 128 lanes against 2.26-2.36 on threads. A grouped pairing stays two
# launches, the Miller loop's and this one: the two programs fused into one
# took 4.07-4.39 ms against 3.51-3.96.
FINAL_EXP_MODE = "groups"
_SMS: Dict[torch.device, int] = {}


def _sms(dev: torch.device) -> int:
    n = _SMS.get(dev)
    if n is None:
        n = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def tree_mode(lanes: int, dev: torch.device) -> str:
    """A tree launch's kernel: groups up to GROUP_LANES_PER_SM lanes an SM
    (latency), threads beyond (throughput), as the chain kernel chooses."""
    return "groups" if lanes <= GROUP_LANES_PER_SM * _sms(dev) else "threads"

_HEADER = ("code", "consts", "n_records", "n_const", "nreg", "nflag", "nx", "ng",
           "n_digits", "slot_words", "threads_lane", "off_records", "off_ring0",
           "off_const_regs", "off_in0", "off_in1", "off_out", "in_rows0", "in_rows1",
           "out_rows", "lane_flag", "uniform_flag", "uniform_val", "out_flag",
           "digit_idx", "digit_sign", "in0", "in1", "lane_flags", "out", "out_flags",
           "lanes", "stamps")
_fns: Dict[str, object] = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = load_library("fq_points")
        if lib.fq_points_header_len() != len(_HEADER):
            raise RuntimeError("csrc/fq_points.cu's header != ops/fq_points.py's")
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# programs on each device, uploaded once: (program, device) -> (code, consts)
_UPLOADED: Dict[Tuple[int, torch.device], Tuple[FP.Program, torch.Tensor, torch.Tensor]] = {}
# each recoding's digit arrays on each device
_DIGITS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _uploaded(prog: FP.Program, dev: torch.device):
    key = (id(prog), dev)
    hit = _UPLOADED.get(key)
    if hit is None:
        hit = _UPLOADED[key] = (prog, torch.from_numpy(prog.code).to(dev),
                                torch.from_numpy(np.ascontiguousarray(prog.consts)).to(dev))
    return hit[1], hit[2]


def _device_digits(rec: SM.SignedWindows, dev: torch.device):
    key = (rec.idx.tobytes(), rec.sign.tobytes(), dev)
    hit = _DIGITS.get(key)
    if hit is None:
        if len(_DIGITS) >= 256:
            _DIGITS.clear()
        hit = _DIGITS[key] = tuple(torch.tensor(np.asarray(a, np.int32), device=dev)
                                   for a in (rec.idx, rec.sign))
    return hit


def _operand(t: torch.Tensor, dev: torch.device, what: str) -> torch.Tensor:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{what}: expected a tensor on {dev}, got {t.device}")
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64 limbs, got {t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, prog: FP.Program, dev: torch.device, n: int, ins,
            lane_flags=None, uniform_val: bool = False, digits=None,
            out_flags=None, stamps=None) -> torch.Tensor:
    code, consts = _uploaded(prog, dev)
    out = torch.empty((n, prog.out_rows, L), dtype=torch.int64, device=dev)
    ptr = {"code": code.data_ptr(), "consts": consts.data_ptr(),
           "uniform_val": int(bool(uniform_val)), "lanes": n,
           "in0": ins[0].data_ptr(), "in1": ins[1].data_ptr() if len(ins) > 1 else 0,
           "lane_flags": 0 if lane_flags is None else lane_flags.data_ptr(),
           "out": out.data_ptr(),
           "out_flags": 0 if out_flags is None else out_flags.data_ptr(),
           "digit_idx": 0 if digits is None else digits[0].data_ptr(),
           "digit_sign": 0 if digits is None else digits[1].data_ptr(),
           "stamps": 0 if stamps is None else stamps.data_ptr(),
           "in_rows0": prog.in_rows[0], "in_rows1": prog.in_rows[1]}
    for k in ("n_records", "n_const", "nreg", "nflag", "nx", "ng", "n_digits",
              "slot_words", "threads_lane", "out_rows", "lane_flag", "uniform_flag",
              "out_flag"):
        ptr[k] = getattr(prog, k)
    for k, v in prog.offsets.items():
        ptr["off_" + k] = v
    header = (ctypes.c_longlong * len(_HEADER))(*(int(ptr[k]) for k in _HEADER))
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = _launcher(name)(header, torch.cuda.current_stream().cuda_stream)
    else:
        err = _launcher(name)(header, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def g2_ladder_cuda(x: torch.Tensor, y: torch.Tensor, inf: Optional[torch.Tensor],
                   rec: SM.SignedWindows, stamps=None):
    """[k]P in one launch of g2_ladder_kernel: x, y [n, 2, 14] int64
    affine limbs on one CUDA device, inf [n] bool or None, rec the
    scalar's recoding (its digits go to the device once) -> (x, y, is_inf)
    as g2_ladder_plain gives them."""
    dev = x.device
    x, y = _operand(x, dev, "g2_ladder"), _operand(y, dev, "g2_ladder")
    n = x.shape[0]
    if x.shape[1:] != (2, L) or y.shape != x.shape:
        raise ValueError(f"g2_ladder: x {tuple(x.shape)}, y {tuple(y.shape)}")
    if inf is not None and (inf.shape != (n,) or inf.device != dev):
        raise ValueError(f"g2_ladder: infinity flags {tuple(inf.shape)} on {inf.device}")
    prog = ladder_program(rec.nbits, rec.w)
    if rec.idx.shape[0] != prog.n_digits:
        raise ValueError(f"g2_ladder: {rec.idx.shape[0]} digits for {prog.n_digits}")
    xy = torch.cat([x, y], dim=1)
    flags = None if inf is None else inf.to(torch.uint8).contiguous()
    out_flags = torch.empty(n, dtype=torch.uint8, device=dev)
    out = _launch("g2_ladder", prog, dev, n, (xy,), flags, rec.correction,
                  _device_digits(rec, dev), out_flags, stamps)
    if n:
        ladder_counter.record(n)
    return out[:, :2], out[:, 2:], out_flags.bool()


def miller_grouped_cuda(g1: torch.Tensor, g2: torch.Tensor, stamps=None) -> torch.Tensor:
    """miller_loop_grouped in one launch of miller_grouped_kernel: g1
    [G, P, 2, 14], g2 [G, P, 2, 2, 14] int64 limbs on one CUDA device ->
    [G, 2, 3, 2, 14]."""
    dev = g1.device
    g1, g2 = _operand(g1, dev, "miller_grouped"), _operand(g2, dev, "miller_grouped")
    if g1.dim() != 4 or g1.shape[2:] != (2, L) or g2.shape != g1.shape[:2] + (2, 2, L):
        raise ValueError(f"miller_grouped: g1 {tuple(g1.shape)}, g2 {tuple(g2.shape)}")
    G, P = g1.shape[0], g1.shape[1]
    out = _launch("miller_grouped", miller_program(P), dev, G, (g1, g2),
                  stamps=stamps)
    if G:
        miller_counter.record((G, P))
    return out.reshape(G, 2, 3, 2, L)


STAMPS = 8          # clock stamps a bundle (csrc/fq_points.cu kMarks)
PHASES = ("wait", "A", "B", "C", "D", "E", "barrier", "fetch")


def bundle_clocks(fn, prog: FP.Program, dev):
    """Block 0's SM clock cycles in one launch (fn(stamps) launches it
    with a stamp buffer): ([n_records] cycles of each record, a bundle or
    a run (prog.records), [n_records, 8] its split: the wait for its
    record, phases A to E (each with its barrier; a run is all phase B),
    the record's last barrier, the producer's fetch of the record RING
    on). A measurement: the launch is counted by its wrapper like any
    other."""
    stamps = torch.zeros(prog.n_records * STAMPS + 1, dtype=torch.int64, device=dev)
    fn(stamps)
    st = stamps.cpu().numpy()
    marks = st[:-1].reshape(-1, STAMPS)
    nxt = np.append(marks[1:, 0], st[-1])
    split = np.diff(np.concatenate([marks, nxt[:, None]], axis=1), axis=1)
    return nxt - marks[:, 0], split


def _flags_out(n: int, dev: torch.device) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8, device=dev)


def final_exp_cuda(f: torch.Tensor, stamps=None):
    """final_exp_program in one launch on FINAL_EXP_MODE's kernel: f
    [G, 2, 3, 2, 14] int64 limbs on one CUDA device -> (f^(3 (q^12 - 1) /
    r) [G, 2, 3, 2, 14], [G] bool equal to one), as final_exp_plain gives
    them."""
    dev = f.device
    f = _operand(f, dev, "final_exp")
    if f.dim() != 5 or f.shape[1:] != (2, 3, 2, L):
        raise ValueError(f"final_exp: f {tuple(f.shape)}")
    G = f.shape[0]
    flags = _flags_out(G, dev)
    out = _launch(ENTRY[FINAL_EXP_MODE], final_exp_program(), dev, G, (f,),
                  out_flags=flags, stamps=stamps)
    if G:
        final_exp_counter.record(G)
    return out.reshape(G, 2, 3, 2, L), flags.bool()


def _point_tree(curve: str, pts: torch.Tensor, mode_of):
    dev = pts.device
    B, C, rows = _tree_shape(curve, pts)
    cur = _operand(pts, dev, "point_tree")
    flags = None
    for k, affine in tree_plan(C.bit_length() - 1):
        n = B * (C >> k)
        flags = _flags_out(n, dev) if affine else None
        cur = _launch(ENTRY[mode_of(n, dev)], tree_program(curve, k, affine), dev, n,
                      (cur.reshape(n, (1 << k) * rows, L),), out_flags=flags)
        if n:
            tree_counter.record((curve, n))
        C >>= k
    return _tree_out(curve, B, cur, flags)


def point_tree_cuda(curve: str, pts: torch.Tensor):
    """The decompressions' addition tree and jac_to_affine on the card:
    pts [B, C, 3, 14] (G1) or [B, C, 3, 2, 14] (G2) Jacobian int64 limbs
    on one CUDA device, C a power of two -> affine (x, y, is_inf) of each
    row's sum, as point_tree_plain gives them: one launch of
    tree_program per TREE_LEVELS levels (tree_plan), each lane adding
    2^levels neighbouring points, the last launch with jac_to_affine, each
    on tree_mode's kernel. A launch's input is the previous one's output
    as it lies."""
    return _point_tree(curve, pts, tree_mode)
