"""Batched BLS12-381 base-field arithmetic on torch tensors: Montgomery
form, lazy signed 29-bit limbs, double-width lazy reduction (port of
consensus_specs_tpu/ops/fq.py).

An Fq element is a `[..., L]` int64 tensor of 29-bit limbs (14 x 29 = 406
>= 381 bits); a double-width product is a `[..., 2L]` int64 tensor of
schoolbook columns. The algorithm is the reference's, step for step, so
limbs compare bit for bit with it:

- Lazy signed limbs: add/sub/neg are single tensor ops; limbs drift out of
  [0, 2^29) and may go negative between multiplications.
- Split multiply: `fq_mul_wide` (three carry rounds on each input, then
  the reduction-free schoolbook) and `fq_redc` (the 14-step interleaved
  Montgomery reduction and three closing carry rounds);
  `fq_mul = fq_redc o fq_mul_wide`. The tower (ops/fq_tower.py) reduces
  once per output coefficient over recombined wide columns.
- Carry rounds are value-preserving whole-tensor rounds
  (lo = v & MASK, hi = v >> B arithmetic, v = lo + shift_up(hi), the top
  limb keeping its own overflow); NORM_FULL rounds give the unique
  signed-top representation for the boundary ops.

Laziness budget (the reference's, machine-checked there): mul inputs
have body limbs |l| <= 2^32 and a top limb |l_13| <= 2^16; `fq_redc`
takes body columns |col| < 2^35 (or one raw schoolbook, |col| <= 14 *
2^58) and returns limbs in [-16, 2^29] with values in (-2q, 2q). Inside
it nothing leaves int64.

Tower products (ops/fq_tower.py) are one `fq_bilinear` each: pre-sum
tables build the leaf operands, every leaf is a wide product with one
wide normalization, a gamma table recombines the leaves' columns and one
REDC per output coefficient reduces them (`Bilinear` holds the tables).
A chain (`fq_bilinear_chain`) runs a program of such products on one
accumulator, each step's b taken from the accumulator, a fixed base or
a slice of an operand: the exponentiation by |z| and the Miller loop's
f-update are one chain each.

Routing: `fq_mul`, `fq_redc`, `fq_bilinear` and `fq_bilinear_chain`
launch the hand-written kernels (csrc/fq_mont.cu through ops/fq_cuda.py)
for a CUDA tensor and run the plain versions below, `fq_mul_plain` /
`fq_redc_plain` / `fq_bilinear_plain` / `fq_bilinear_chain_plain`, for a
CPU tensor. Everything that multiplies above them goes through a
`Field`:
`DEVICE` takes that routing, `PLAIN` runs the plain versions on any
device (the check that holds the kernel route against the plain one on
the card). The module-level names (`fq_inv`, `fq_canon`, ...) are
`DEVICE`'s.

Host helpers (int_to_limbs, to_mont, ...) work on numpy; device
constants are built once per device and cached (`const`).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
B = 29                      # bits per limb
L = 14                      # limbs (14*29 = 406 bits)
MASK = (1 << B) - 1
R_MONT = (1 << (B * L)) % Q
R2_MONT = (R_MONT * R_MONT) % Q
QINV_NEG = pow(-Q, -1, 1 << B)   # -q^{-1} mod 2^B

NORM_FULL = L + 3           # rounds for exact ripple propagation

# The laziness budget (module docstring), as in the reference.
NARROW_LIMB_LO = -16                    # post-norm body limb floor
NARROW_LIMB_HI = 1 << B                 # post-norm body limb ceiling (2^29)
NARROW_INPUT_BOUND = 1 << 32            # |body limb| into a multiply
NARROW_TOP_SPILL = 1 << 16              # |top limb| into a multiply
CANONICAL_TOP = Q >> (B * (L - 1))      # = 13: top limb of a canonical x < q
WIDE_COL_RAW = L << (2 * B)             # 14*2^58: one raw schoolbook column
WIDE_ACCUM_FANIN = 64                   # gamma abs-fan-in ceiling (fq_tower)
WIDE_COL_BUDGET = WIDE_ACCUM_FANIN << B  # 2^35: fq_redc body-column budget
WIDE_TOP_SPILL = 1 << 38                # fq_redc top-column budget


def int_to_limbs(x: int) -> np.ndarray:
    """Host: python int (>= 0, < 2^406) -> [L] int64 limb array."""
    out = np.zeros(L, dtype=np.int64)
    for i in range(L):
        out[i] = (x >> (B * i)) & MASK
    return out


def limbs_to_int(limbs) -> int:
    """Host: [L] limb array (possibly lazy/signed) -> python int mod q."""
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(arr[..., i]) << (B * i) for i in range(L)) % Q


def _signed_rep(x: int) -> np.ndarray:
    """Host: the limb rep with limbs 0..L-2 in [0, 2^29) and the sign in
    the top limb -- what NORM_FULL carry rounds converge to."""
    out = np.zeros(L, dtype=np.int64)
    for i in range(L - 1):
        li = x & MASK
        out[i] = li
        x = (x - li) >> B
    out[L - 1] = x
    return out


def to_mont(x: int) -> np.ndarray:
    """Host: int -> Montgomery-form limb array."""
    return int_to_limbs((x % Q) * R_MONT % Q)


def from_mont(limbs) -> int:
    """Host: Montgomery-form limb array (lazy ok) -> canonical int."""
    return limbs_to_int(limbs) * pow(R_MONT, -1, Q) % Q


def stack_mont(values: Sequence[int]) -> np.ndarray:
    """Host: [N] ints -> [N, L] Montgomery limb arrays."""
    return np.stack([to_mont(v) for v in values])


Q_LIMBS = int_to_limbs(Q)
_Q_NP = Q_LIMBS
_Q2_NP = int_to_limbs(2 * Q)     # 2q < 2^383: fits 14 limbs
_Q_TAIL_NP = _Q_NP[1:].copy()    # q's limbs 1..L-1, added during REDC
_ZERO_PAT = np.zeros(L, dtype=np.int64)
_Q_PAT = _signed_rep(Q)
_NEGQ_PAT = _signed_rep(-Q)
_ONE_MONT = to_mont(1)

# ---------------------------------------------------------------------------
# Device constants
# ---------------------------------------------------------------------------

_CONSTS: Dict[Tuple[int, torch.device], Tuple[np.ndarray, torch.Tensor]] = {}


def const(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on `device`, made once.
    Keyed by the array's identity (the cache keeps the array alive, so an
    id is never reused): pass long-lived arrays, never temporaries."""
    key = (id(arr), torch.device(device))
    hit = _CONSTS.get(key)
    if hit is None:
        hit = (arr, torch.as_tensor(np.ascontiguousarray(arr)).to(device))
        _CONSTS[key] = hit
    return hit[1]


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

_ROUND_MASKS: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}


def _round_masks(width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(low, body) of a carry round over `width` limbs: low keeps a body
    limb's low B bits and all of the top limb, body keeps the carries of
    the body limbs and drops the top limb's (it keeps its own overflow)."""
    masks = _ROUND_MASKS.get(width)
    if masks is None:
        low = np.full(width, MASK, dtype=np.int64)
        low[-1] = -1
        body = np.full(width, -1, dtype=np.int64)
        body[-1] = 0
        masks = _ROUND_MASKS[width] = (low, body)
    return masks


def _carry_rounds(t: torch.Tensor, n: int) -> torch.Tensor:
    """n value-preserving rounds of carry/borrow propagation over the last
    axis (length-generic: [..., L] elements and [..., 2L] columns): each
    body limb keeps its low B bits plus the carry from below (hi = v >> B,
    arithmetic, so borrows propagate as -1), the top limb keeps its own
    overflow. Five tensor ops a round; returns a new tensor."""
    low, body = (const(m, t.device) for m in _round_masks(t.shape[-1]))
    for _ in range(n):
        t = (t & low) + torch.roll((t >> B) & body, 1, dims=-1)
    return t


def fq_norm(a: torch.Tensor, rounds: int = 3) -> torch.Tensor:
    """Crush limb magnitudes: 3 rounds bring |limb| <= 2^33 inputs into
    [-16, 2^29]; NORM_FULL rounds give the unique signed-top form."""
    return _carry_rounds(a, rounds)


def fq_wide_norm(t: torch.Tensor, rounds: int = 3) -> torch.Tensor:
    """Value-preserving carry rounds over [..., 2L] wide columns: raw
    schoolbook columns back to a [-16, 2^29] body before any >2-term
    accumulation (the tower's gamma recombination)."""
    return _carry_rounds(t, rounds)


# ---------------------------------------------------------------------------
# Lazy arithmetic
# ---------------------------------------------------------------------------

def fq_add(a, b):
    return a + b


def fq_sub(a, b):
    return a - b


def fq_neg(a):
    return -a


def fq_select(cond, a, b):
    """where(cond, a, b) broadcasting cond over the limb axis."""
    return torch.where(cond[..., None], a, b)


def fq_zeros(shape, device):
    return torch.zeros(tuple(shape) + (L,), dtype=torch.int64, device=device)


def fq_ones(shape, device):
    """Montgomery one (R mod q), broadcast to shape."""
    return const(_ONE_MONT, device).expand(tuple(shape) + (L,))


# ---------------------------------------------------------------------------
# Multiplication: plain versions and the routing
# ---------------------------------------------------------------------------

class _Calls:
    def __init__(self) -> None:
        self.calls = 0


# Calls of fq_mul_wide on CUDA tensors. Only the PLAIN route makes them
# on the card (the kernel route multiplies inside its kernels), so a run
# reads it around a DEVICE drive to show that nothing there fell to torch.
cuda_wide_calls = _Calls()


def fq_mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook double-width product, no reduction: [..., L] x [..., L]
    -> [..., 2L] int64 columns, cols[k] = sum_{i+j=k} a_i b_j after three
    carry rounds on each input. Columns reach 14*2^58 < 2^62.

    The L x L outer product is summed along anti-diagonals by the skew
    view: each row padded to 2L and the flat buffer re-read with row
    stride 2L - 1, which shifts row i right by i columns."""
    if a.is_cuda or b.is_cuda:
        cuda_wide_calls.calls += 1
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = _carry_rounds(a.expand(shape), 3)
    b = _carry_rounds(b.expand(shape), 3)
    batch = shape[:-1]
    prod = a[..., :, None] * b[..., None, :]                  # [..., L, L]
    flat = tnf.pad(prod, (0, L)).reshape(batch + (2 * L * L,))
    skew = flat[..., :L * (2 * L - 1)].reshape(batch + (L, 2 * L - 1))
    return tnf.pad(skew.sum(-2), (0, 1))                      # [..., 2L]


def fq_wide_from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery element [..., L] -> wide columns [..., 2L] of value a*R
    (limbs shifted up L columns after a defensive normalization)."""
    a = _carry_rounds(a, 3)
    return torch.cat([torch.zeros_like(a), a], dim=-1)


def fq_redc_plain(cols: torch.Tensor) -> torch.Tensor:
    """Interleaved Montgomery reduction: [..., 2L] columns of value v ->
    [..., L] limbs of value v * R^-1 mod q, lazy (limbs in [-16, 2^29],
    value in (-2q, 2q) for in-budget inputs). Per step: m from the low 29
    bits of the running column, the carry (v + m q_0) >> B (exact: the sum
    is divisible by 2^B), and m * q_1..q_13 added to the next 13 columns;
    then the upper half takes the last carry and three carry rounds."""
    assert cols.shape[-1] == 2 * L, cols.shape
    cols = cols.clone()
    q_tail = const(_Q_TAIL_NP, cols.device)
    q0 = int(_Q_NP[0])
    carry = None
    for i in range(L):
        v = cols[..., i] if carry is None else cols[..., i] + carry
        m = ((v & MASK) * QINV_NEG) & MASK
        carry = (v + m * q0) >> B
        cols[..., i + 1:i + L] += m[..., None] * q_tail
    upper = cols[..., L:]
    upper[..., 0] += carry
    return _carry_rounds(upper, 3)


def fq_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod q, lazy in and out:
    fq_redc_plain(fq_mul_wide(a, b))."""
    return fq_redc_plain(fq_mul_wide(a, b))


def fq_mul_norm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fq_mul_plain, then NORM_FULL carry rounds: the unique signed-top
    limbs of a*b*R^-1, what Field.is_zero and canon compare."""
    return _carry_rounds(fq_mul_plain(a, b), NORM_FULL)


def _plain_device(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cpu":
            raise ValueError(f"unsupported device {t.device}")


def fq_redc(cols: torch.Tensor) -> torch.Tensor:
    """fq_redc_plain's function. A CUDA tensor launches the hand-written
    kernel (raising if it cannot build or launch); a CPU tensor takes the
    plain version."""
    if cols.is_cuda:
        from .fq_cuda import fq_redc_cuda
        return fq_redc_cuda(cols)
    _plain_device(cols)
    return fq_redc_plain(cols)


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fq_mul_plain's function, with fq_redc's routing: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if a.is_cuda or b.is_cuda:
        from .fq_cuda import fq_mul_cuda
        return fq_mul_cuda(a, b)
    _plain_device(a, b)
    return fq_mul_plain(a, b)


def fq_mul_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fq_mul_norm_plain's function, with fq_mul's routing (the same
    kernel, asked for the extra rounds)."""
    if a.is_cuda or b.is_cuda:
        from .fq_cuda import fq_mul_cuda
        return fq_mul_cuda(a, b, norm_full=True)
    _plain_device(a, b)
    return fq_mul_norm_plain(a, b)


# ---------------------------------------------------------------------------
# Tower products: one bilinear form, reduced once per output coefficient
# ---------------------------------------------------------------------------

class IntMatrix:
    """A small-integer [R, C] matrix as a padded gather over the C axis of
    x ([..., C, K] -> [..., R, K]): idx [R, F] column indices and coef
    [R, F] coefficients, zero on padding. Exact int64 in three tensor ops
    (torch has no int64 matmul on CUDA)."""

    def __init__(self, mat: np.ndarray):
        self.mat = mat
        nz = [np.nonzero(row)[0] for row in mat]
        width = max(1, max(len(c) for c in nz))
        self.idx = np.zeros((mat.shape[0], width), dtype=np.int64)
        self.coef = np.zeros((mat.shape[0], width, 1), dtype=np.int64)
        for r, cols in enumerate(nz):
            self.idx[r, :len(cols)] = cols
            self.coef[r, :len(cols), 0] = mat[r, cols]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        g = x[..., const(self.idx, x.device), :]              # [..., R, F, K]
        return (g * const(self.coef, x.device)).sum(-2)


class Bilinear(tuple):
    """One tower product as the tuple (alpha, beta, gamma) of IntMatrix:
    leaf k multiplies alpha[k] . av by beta[k] . bv (av [..., Ca, L],
    bv [..., Cb, L]), and output coefficient r is the REDC of gamma[r]
    over the leaves' wide-normalized columns (see fq_bilinear_plain).

    Options: `norm_in` runs three carry rounds on every input coefficient
    first; `one_col` gives bv one more coefficient, Montgomery one, after
    its Cb own (beta has Cb + 1 columns). `kind` is the product's index
    in the set the kernel has compiled in (csrc/fq_tables.cuh, generated
    from ops/fq_tower.py::TABLES in that order), and names it in a
    chain's program."""

    def __new__(cls, alpha, beta, gamma, name: str, kind: int,
                norm_in: bool = False, one_col: bool = False):
        self = super().__new__(cls, (IntMatrix(alpha), IntMatrix(beta),
                                     IntMatrix(gamma)))
        self.name, self.kind = name, kind
        self.norm_in, self.one_col = norm_in, one_col
        self.P, self.Ca = alpha.shape
        self.Cb = beta.shape[1] - int(one_col)
        self.R = gamma.shape[0]
        return self


def fq_bilinear_plain(av: torch.Tensor, bv: torch.Tensor,
                      tables: Bilinear) -> torch.Tensor:
    """[..., R, L]: fq_redc(gamma . fq_wide_norm(fq_mul_wide(alpha . av,
    beta . bv))), the reference's coeff-placement tower product, with the
    tables' input options applied first. av and bv broadcast over their
    batch axes."""
    alpha, beta, gamma = tables
    if av.shape[-2:] != (tables.Ca, L) or bv.shape[-2:] != (tables.Cb, L):
        raise ValueError(f"{tables.name}: operands {tuple(av.shape)} and "
                         f"{tuple(bv.shape)} for ({tables.Ca}, {tables.Cb}) "
                         "coefficients")
    if tables.norm_in:
        same = bv is av
        av = fq_norm(av)
        bv = av if same else fq_norm(bv)
    if tables.one_col:
        bv = torch.cat([bv, fq_ones(bv.shape[:-2] + (1,), bv.device)], dim=-2)
    leaves = fq_wide_norm(fq_mul_wide(alpha.apply(av), beta.apply(bv)))
    return fq_redc_plain(gamma.apply(leaves))


def fq_bilinear(av: torch.Tensor, bv: torch.Tensor,
                tables: Bilinear) -> torch.Tensor:
    """fq_bilinear_plain's function, with fq_mul's routing: one launch of
    the fused kernel for CUDA tensors, the plain version for CPU ones."""
    if av.is_cuda or bv.is_cuda:
        from .fq_cuda import fq_bilinear_cuda
        return fq_bilinear_cuda(av, bv, tables)
    _plain_device(av, bv)
    return fq_bilinear_plain(av, bv, tables)


# ---------------------------------------------------------------------------
# Chains: a program of products on one accumulator
# ---------------------------------------------------------------------------

# A program is one int32 array, a code per step: the step's kind in the
# low KIND_BITS bits, the source of its b above them. SRC_ACC: the
# accumulator itself (a square); SRC_BASE: the chain's fixed base;
# SRC_OPERAND + p: slot p ([..., p, :, :] of the operand, [..., S, Cs, L]).
#
# Kinds 0 .. KIND_MUL - 1 are the tower products the kernel compiles in
# (ops/fq_tower.py::TABLES, in that order). The others reproduce the
# loops that are not tower products, op for op:
# - KIND_MUL: acc = fq_mul(acc, b), fq_mul's own route (three carry rounds
#   on each input, schoolbook, REDC; no wide norm), on an Fq accumulator;
# - KIND_SQR2: Tower.fq2_sqr of an Fq2 accumulator: the two fq_mul-route
#   products (a0 + a1)(a0 - a1) and a0 a1, then (P0, P1 + P1);
# - KIND_NORM: acc = fq_norm(acc), three carry rounds on every row;
# - KIND_STORE / KIND_LOAD: slot p = acc / acc = slot p (a window table).
# A chain without an operand has slots all the same: as many as its
# program names, each starting as one of the accumulator's field
# (Montgomery one in row 0, zero rows after it); its stores fill them.
KIND_BITS = 4
KIND_MASK = (1 << KIND_BITS) - 1
SRC_ACC, SRC_BASE, SRC_OPERAND = 0, 1, 2
KIND_MUL, KIND_SQR2, KIND_NORM, KIND_STORE, KIND_LOAD = range(5, 10)
N_KINDS = 10
STEP_NAMES = {KIND_MUL: "fq_mul", KIND_SQR2: "fq2_sqr", KIND_NORM: "norm",
              KIND_STORE: "store", KIND_LOAD: "load"}
STEP_CA = {KIND_MUL: 1, KIND_SQR2: 2}      # the others take any accumulator


def chain_program(steps) -> np.ndarray:
    """[(Bilinear or one of the KIND_* steps, source)] -> the program's
    int32 codes. Every tower product maps the accumulator's coefficients
    onto themselves (R == Ca), and one that normalizes its inputs or
    appends Montgomery one squares the accumulator; KIND_SQR2 and
    KIND_NORM read the accumulator alone, KIND_STORE and KIND_LOAD name a
    slot."""
    codes = []
    for step, src in steps:
        if isinstance(step, Bilinear):
            if step.R != step.Ca:
                raise ValueError(f"{step.name}: R {step.R} != Ca {step.Ca}")
            if (step.norm_in or step.one_col) and src != SRC_ACC:
                raise ValueError(f"{step.name} squares the accumulator")
            kind = step.kind
        else:
            kind = int(step)
            if kind not in STEP_NAMES:
                raise ValueError(f"no chain step of kind {kind}")
            if kind in (KIND_SQR2, KIND_NORM) and src != SRC_ACC:
                raise ValueError(f"{STEP_NAMES[kind]} reads the accumulator alone")
            if kind in (KIND_STORE, KIND_LOAD) and src < SRC_OPERAND:
                raise ValueError(f"{STEP_NAMES[kind]} names a slot")
        if src < 0:
            raise ValueError(f"source {src}")
        codes.append(kind | src << KIND_BITS)
    if not codes:
        raise ValueError("a chain has at least one step")
    return np.array(codes, dtype=np.int32)


def program_slots(program: np.ndarray) -> int:
    """The slots a program names (the highest slot + 1; 0 for none)."""
    src = np.asarray(program) >> KIND_BITS
    return int(max(0, src.max() - SRC_OPERAND + 1))


def field_one_like(acc: torch.Tensor) -> torch.Tensor:
    """One of acc's field ([..., C, L]: Montgomery one in row 0, zero
    rows after it), broadcast to acc's shape."""
    one = torch.zeros(acc.shape[-2:], dtype=torch.int64, device=acc.device)
    one[0] = const(_ONE_MONT, acc.device)
    return one.expand(acc.shape)


def fq2_sqr_by(mul: Callable, a: torch.Tensor) -> torch.Tensor:
    """Tower.fq2_sqr over a multiply route: (a0 + a1)(a0 - a1) and a0 a1
    as one fq_mul of stacked pairs, then (P0, P1 + P1)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    P = mul(torch.stack([a0 + a1, a0], dim=-2), torch.stack([a0 - a1, a1], dim=-2))
    return torch.stack([P[..., 0, :], P[..., 1, :] + P[..., 1, :]], dim=-2)


def chain_by_products(bilinear: Callable, acc: torch.Tensor,
                      program: np.ndarray, tables: Optional[Sequence[Bilinear]],
                      base: Optional[torch.Tensor] = None,
                      operand: Optional[torch.Tensor] = None,
                      mul: Optional[Callable] = None) -> torch.Tensor:
    """The chain one step at a time: a tower product is acc =
    bilinear(acc, b, tables[kind]), b the accumulator, the base or a slot;
    KIND_MUL and KIND_SQR2 multiply through `mul` (fq_mul's function, as
    fq_mul and Tower.fq2_sqr do); the norm, store and load steps are the
    tensor ops they name. tables: the products by kind (None where the
    program has none)."""
    slots = None
    if operand is None and program_slots(program):
        slots = [field_one_like(acc)] * program_slots(program)
    for code in program:
        kind, src = int(code) & KIND_MASK, int(code) >> KIND_BITS
        if src == SRC_ACC:
            b = acc
        elif src == SRC_BASE:
            b = base
        elif slots is not None:
            b = slots[src - SRC_OPERAND]
        else:
            b = operand[..., src - SRC_OPERAND, :, :]
        if kind < KIND_MUL:
            acc = bilinear(acc, b, tables[kind])
        elif kind == KIND_MUL:
            acc = mul(acc, b)
        elif kind == KIND_SQR2:
            acc = fq2_sqr_by(mul, acc)
        elif kind == KIND_NORM:
            acc = fq_norm(acc)
        elif kind == KIND_STORE:
            slots[src - SRC_OPERAND] = acc
        elif kind == KIND_LOAD:
            acc = b
        else:
            raise ValueError(f"no chain step of kind {kind}")
    return acc


def fq_bilinear_chain_plain(acc: torch.Tensor, program: np.ndarray,
                            tables: Optional[Sequence[Bilinear]],
                            base: Optional[torch.Tensor] = None,
                            operand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc [..., Ca, L] through the program's steps -> [..., Ca, L], each
    product fq_bilinear_plain or fq_mul_plain; base [..., Cb, L] and
    operand [..., S, Cs, L] broadcast with acc over the batch axes."""
    return chain_by_products(fq_bilinear_plain, acc, program, tables, base,
                             operand, fq_mul_plain)


def fq_bilinear_chain(acc: torch.Tensor, program: np.ndarray,
                      tables: Optional[Sequence[Bilinear]],
                      base: Optional[torch.Tensor] = None,
                      operand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fq_bilinear_chain_plain's function: the whole program in one launch
    of the chain kernel for CUDA tensors, the plain version for CPU
    ones."""
    ts = [t for t in (acc, base, operand) if t is not None]
    if any(t.is_cuda for t in ts):
        from .fq_cuda import fq_bilinear_chain_cuda
        return fq_bilinear_chain_cuda(acc, program, tables, base, operand)
    _plain_device(*ts)
    return fq_bilinear_chain_plain(acc, program, tables, base, operand)


# ---------------------------------------------------------------------------
# Exponent staging (host)
# ---------------------------------------------------------------------------

def _exp_bits(e: int) -> np.ndarray:
    """Static exponent -> bit array, MSB first."""
    bits = bin(e)[2:]
    return np.frombuffer(bits.encode(), dtype=np.uint8) - ord("0")


_INV_EXP_BITS = _exp_bits(Q - 2)
_SQRT_EXP_BITS = _exp_bits((Q + 1) // 4)
_POW_WINDOW = 4


def _exp_window_digits(bits_np: np.ndarray, w: int) -> np.ndarray:
    """MSB-first bit array -> [ceil(n/w)] w-bit window digits, MSB window
    first, zero-padded at the top."""
    n = int(bits_np.shape[0])
    m = -(-n // w)
    padded = np.concatenate(
        [np.zeros(m * w - n, np.uint8), bits_np.astype(np.uint8)])
    weights = 1 << np.arange(w - 1, -1, -1, dtype=np.int64)
    return (padded.reshape(m, w) @ weights).astype(np.int32)


def pow_static_muls(nbits: int, w: int) -> int:
    """Multiplies of Field.pow_static over an `nbits` exponent, squarings
    excluded: the table's 2^w - 2 and one per window after the first."""
    return ((1 << w) - 2) + (-(-nbits // w) - 1)


_FQ_PROGRAMS: Dict[tuple, np.ndarray] = {}


def fq_pow_program(bits_np: np.ndarray, w: int = _POW_WINDOW) -> np.ndarray:
    """Field.pow_static's fixed window as a chain on an Fq accumulator
    that starts as a: fq_norm(a) into slot 1, table[k] = table[k-1] * a
    into slot k for k = 2 .. 2^w - 1 (slot 0 stays Montgomery one), the
    top digit's entry loaded, then per window w squarings and one
    multiply by slot d. Built once per exponent."""
    key = (bytes(np.asarray(bits_np, dtype=np.uint8)), w)
    prog = _FQ_PROGRAMS.get(key)
    if prog is None:
        digits = [int(d) for d in _exp_window_digits(bits_np, w)]
        steps = [(KIND_NORM, SRC_ACC), (KIND_STORE, SRC_OPERAND + 1)]
        for k in range(2, 1 << w):
            steps += [(KIND_MUL, SRC_OPERAND + 1), (KIND_STORE, SRC_OPERAND + k)]
        steps.append((KIND_LOAD, SRC_OPERAND + digits[0]))
        for d in digits[1:]:
            steps += [(KIND_MUL, SRC_ACC)] * w + [(KIND_MUL, SRC_OPERAND + d)]
        prog = _FQ_PROGRAMS[key] = chain_program(steps)
    return prog


# ---------------------------------------------------------------------------
# The field: everything that multiplies, over one multiply/REDC route
# ---------------------------------------------------------------------------

class Field:
    """Fq operations over one route: `mul` ([..., L] x [..., L] ->
    [..., L]), `mul_norm` (mul, then NORM_FULL carry rounds), `redc`
    ([..., 2L] -> [..., L]), `bilinear` (a tower product, (av, bv,
    Bilinear) -> [..., R, L]) and `bilinear_chain` (a program of steps,
    (acc, program, tables, base, operand) -> [..., Ca, L]; by default one
    `bilinear` or `mul` per step). The boundary ops and the
    static-exponent powers are the reference's, written once over the
    route; with `chain_powers` a power is one `bilinear_chain` of
    fq_pow_program, else the loop of `mul`s (the same products)."""

    def __init__(self, mul: Callable, mul_norm: Callable, redc: Callable,
                 bilinear: Callable, bilinear_chain: Optional[Callable] = None,
                 chain_powers: bool = False):
        self.mul = mul
        self.mul_norm = mul_norm
        self.redc = redc
        self.bilinear = bilinear
        self.bilinear_chain = bilinear_chain or functools.partial(
            chain_by_products, bilinear, mul=mul)
        self.chain_powers = chain_powers

    def sqr(self, a):
        return self.mul(a, a)

    def _reduced_full(self, a):
        """Value into (-2q, 2q) by one Montgomery multiply by R, then the
        unique signed-top limbs (NORM_FULL carry rounds)."""
        return self.mul_norm(a, fq_ones(a.shape[:-1], a.device))

    def is_zero(self, a):
        y = self._reduced_full(a)

        def match(pat):
            return torch.all(y == const(pat, y.device), dim=-1)

        # value in (-2q, 2q) and = 0 mod q  <=>  value in {-q, 0, q}
        return match(_ZERO_PAT) | match(_Q_PAT) | match(_NEGQ_PAT)

    def eq(self, a, b):
        return self.is_zero(a - b)

    def canon(self, a):
        """Unique canonical limbs in [0, q) (compression, host checks)."""
        t = self._reduced_full(a)
        neg = t[..., -1] < 0
        t = torch.where(neg[..., None], t + const(_Q2_NP, t.device), t)
        t = _carry_rounds(t, NORM_FULL)
        d = _carry_rounds(t - const(_Q_NP, t.device), NORM_FULL)
        return torch.where((d[..., -1] >= 0)[..., None], d, t)

    def pow_static(self, a, bits_np: np.ndarray, w: Optional[int] = None):
        """a^e, e a static bit array: fixed-window evaluation (table of
        a^0..a^(2^w-1), then per window w squarings and one multiply --
        by the table's one for a zero digit, as in the reference): one
        chain (fq_pow_program) with chain_powers, else the loop."""
        if w is None:
            w = _POW_WINDOW
        if self.chain_powers:
            return self.bilinear_chain(a[..., None, :], fq_pow_program(bits_np, w),
                                       None)[..., 0, :]
        digits = [int(d) for d in _exp_window_digits(bits_np, w)]
        a = fq_norm(a)
        table = [fq_ones(a.shape[:-1], a.device), a]
        for _ in range(2, 1 << w):
            table.append(self.mul(table[-1], a))
        acc = table[digits[0]]
        for d in digits[1:]:
            for _ in range(w):
                acc = self.mul(acc, acc)
            acc = self.mul(acc, table[d])
        return acc

    def inv(self, a):
        """a^(q-2): Fermat inversion, Montgomery in and out."""
        return self.pow_static(a, _INV_EXP_BITS)

    def sqrt_candidate(self, a):
        """a^((q+1)/4): the square root if a is a QR (q = 3 mod 4); the
        caller checks candidate^2 == a."""
        return self.pow_static(a, _SQRT_EXP_BITS)


DEVICE = Field(fq_mul, fq_mul_norm, fq_redc, fq_bilinear, fq_bilinear_chain,
               chain_powers=True)
PLAIN = Field(fq_mul_plain, fq_mul_norm_plain, fq_redc_plain, fq_bilinear_plain,
              fq_bilinear_chain_plain)

fq_sqr = DEVICE.sqr
fq_is_zero = DEVICE.is_zero
fq_eq = DEVICE.eq
fq_canon = DEVICE.canon
fq_inv = DEVICE.inv
fq_sqrt_candidate = DEVICE.sqrt_candidate
