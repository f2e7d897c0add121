"""Point formulas as programs over a register file of Fq rows: the
recorder that turns the port's own formulas into ops, the scheduler and
register allocator that turn the ops into one int32 program, and the
program's plain interpreter (run_program_plain).

The G2 ladder of hash-to-G2 and signing, the grouped Miller loop, the
pairing's final exponentiation and the decompressions' addition trees are
long walks of small dependent field operations. On the card each is one
launch of a kernel that interprets such a program (csrc/fq_points.cu,
ops/fq_points.py), or a few for a tree: the host records the walk once,
per shape, and the kernel runs every lane's whole walk out of shared
memory. The Recorder speaks Fq (rows), Fq2, Fq6 and Fq12 as the port's
Tower does, and G1 and G2 as ops/scalar_mul.py's field namespaces
(G1Ops, FieldOps).

Values are rows: one Fq element, 14 lazy int64 limbs (an Fq2 is two rows,
an Fq12 twelve), and flags: one bool per lane. An op is one of

- `add`, `sub`, `neg` (lazy limb arithmetic), `norm` (three carry rounds,
  ops.fq.fq_norm), `sel` (a row chosen by a flag), `load` (row
  `rows[idx[pos]]` of a table, idx a digit read from device memory),
  `sgn` (the flag sign[pos] < 0), `fand` and `fnot` on flags;
- `mul` (ops.fq.fq_mul_plain: Montgomery product of two rows) and `isz`
  (ops.fq.Field.is_zero of a row: mul_norm by Montgomery one, then the
  three-pattern compare);
- `bil`: one tower product of a compiled kind (ops/fq_tower.py::TABLES),
  a list of a rows and b rows to R result rows, ops.fq.fq_bilinear_plain's
  function. A table's norm_in is recorded as `norm` ops on the inputs
  before the product, its one_col as one more b row, the constant
  Montgomery one.

Each op is an exact integer function of its inputs, so the order of
mutually independent ops changes no bit: a program computes what the
recorded formulas compute, limb for limb.

Compiling a recording: dead ops are dropped; every op goes to the first
phase its inputs allow. A bundle runs seven phases (csrc/fq_points.cu):
A linear ops and the tower products' pre-sums, B schoolbooks, C gamma
sums, D REDCs, E, E2 and E3 linear ops. So a multiply reads phase A's
results of its own bundle, and a chain of up to three lazy add, sub,
neg, select, load or norm ops that follow a REDC runs in the REDC's
bundle instead of opening bundles of their own. No op goes earlier than the bundle of the op LOOKAHEAD ops
before it (which bounds how far ahead loads and line coefficients run),
nor into a bundle whose scratch is full. Rows and flags get registers by
liveness over phases (lowest free first; a register is free again only
after the phase of its last read). The program: one self-contained
record per bundle (header, eight int32 words per op, each leaf's and
each REDC's scratch row, the register lists of loads and products
inline, the phase-E norms folded into the REDCs), or one run record per
stretch of single-multiply bundles; the first records' places, the
register maps and the constant rows. decode() reads the records back
bundle by bundle, in the order the kernel runs them.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fq as F
from . import fq_tower as T

L = F.L
WORDS = 8                      # int32 words per op

# Op codes. Linear ops (phase A of a bundle):
ADD, SUB, NEG, NORM, SEL, LOAD, SGN, FAND, FNOT = range(1, 10)
# Multiplies (phases B and D):
MUL, ISZ = 16, 17
# Tower products: BIL + kind (phases A-D)
BIL = 32

LINEAR = {"add": ADD, "sub": SUB, "neg": NEG, "norm": NORM, "sel": SEL,
          "load": LOAD, "sgn": SGN, "fand": FAND, "fnot": FNOT}
MULTIPLY = {"mul": MUL, "isz": ISZ}

LOOKAHEAD = 192                # ops an op may be hoisted above
MAX_LEAVES = 128               # leaf rows (x and y each) of one bundle
MAX_WIDE = 64                  # wide rows of one bundle

# A bundle's phases, in order: A linear ops and the tower products'
# pre-sums, B schoolbooks, C gamma sums, D REDCs, E linear ops that read
# the bundle's own results, then E2 and E3: linear ops that read E's and
# E2's. A phase time is NPH * bundle + phase.
PH_A, PH_B, PH_C, PH_D, PH_E, PH_E2, PH_E3 = range(7)
NPH = 7
LINEAR_PHASES = {PH_A: "A", PH_E: "E", PH_E2: "E2", PH_E3: "E3"}
LINEAR_CLASSES = {c: ph for ph, c in LINEAR_PHASES.items()}
GROUP = 16                     # threads of one schoolbook or REDC (a half-warp)
RING = 8                       # bundle records in flight in the kernel's ring
# A record's header, HDR int32 words: its length in words (a multiple of
# 4), the counts (linear ops in A, multiplies, tower products, linear ops
# in E, leaves, product outputs), the place of the record RING on (offset
# and words in the records section; 0 words at the end), 1 for a run
# record, where its fold table lies (0: none), and the counts of linear
# ops in E2 and E3 (their op words follow E's). A phase-E norm of a
# product output can be folded into the REDC that makes the output (write
# in phase D): it leaves phase E's op words, and the fold table holds, per
# product output, the norm's register plus one (0: none), then the norm's
# place among the phase's ops as scheduled (-1: none), which decode puts
# it back at.
HDR = 16
REC_WORDS, REC_NEXT_OFF, REC_NEXT_WORDS = 0, 7, 8
REC_RUN, REC_FOLD_TAB, REC_E2, REC_E3 = 9, 10, 11, 12
# A run record packs up to RUN_MAX consecutive bundles that each hold one
# `mul` and nothing else (the Fq inversion's window): the multiplies' op
# words in order, run one after another (each may read the one before) on
# one 16-thread group a lane (or one thread), from operands to stored
# result, with no barrier and no record between them. Header: the
# multiplies' count in place of the multiplies', REC_RUN 1.
RUN_MAX = 48

# ---------------------------------------------------------------------------
# Symbolic values
# ---------------------------------------------------------------------------

class S1:
    """A symbolic Fq row (one value id)."""

    __slots__ = ("rec", "v")
    shape = (1, 1, L)
    device = torch.device("cpu")

    def __init__(self, rec, v: int):
        self.rec, self.v = rec, v


class V2:
    """A symbolic Fq2 value: rows (c0, c1). Arithmetic operators record
    the lazy limb ops of ops/fq_tower.py's fq2_add / fq2_sub / fq2_neg."""

    __slots__ = ("rec", "r")
    shape = (2, L)
    device = torch.device("cpu")

    def __init__(self, rec, r0: int, r1: int):
        self.rec, self.r = rec, (r0, r1)

    def __add__(self, o):
        return self.rec.fq2_add(self, o)

    def __sub__(self, o):
        return self.rec.fq2_sub(self, o)

    def __neg__(self):
        return self.rec.fq2_neg(self)

    def __getitem__(self, key):
        """A pair's slice of a one-pair batch (c[:, 0]) is the value."""
        return self


class Flag:
    __slots__ = ("rec", "v")

    def __init__(self, rec, v: int):
        self.rec, self.v = rec, v

    def __and__(self, o):
        return Flag(self.rec, self.rec.op("fand", 1, "f", (self.v, o.v))[0])

    def __invert__(self):
        return Flag(self.rec, self.rec.op("fnot", 1, "f", (self.v,))[0])


class Digit:
    """Digit i of a scalar's recoding, read by the program from device
    memory: a table index, or (sign) compared with 0."""

    __slots__ = ("rec", "i")

    def __init__(self, rec, i: int):
        self.rec, self.i = rec, i

    def __lt__(self, zero):
        assert zero == 0
        return Flag(self.rec, self.rec.op("sgn", 1, "f", (), aux=self.i)[0])


class Digits:
    def __init__(self, rec, m: int):
        self.rec, self.shape = rec, (m,)

    def __getitem__(self, i):
        return Digit(self.rec, int(i))


# ---------------------------------------------------------------------------
# The recorder: a field, Fq2 curve and tower namespace whose every call
# records ops
# ---------------------------------------------------------------------------

class Recorder:
    """Records ops. It stands where ops/scalar_mul.py takes a field-ops
    namespace `fo` (G2 over Fq2: mul, sqr, add, sub, neg, inv, select,
    is_zero, zeros, ones, val_ndim) and where bls_torch's line functions
    take a Tower (fq2_mul, fq2_sqr, fq2_scale, ...). Each method records
    the ops of the port's own method (ops/fq_tower.py::Tower, ops/fq.py::
    Field), row by row and in the same order."""

    def __init__(self):
        self.ops: List[tuple] = []          # (name, dsts, srcs, aux)
        self.vkind: List[str] = []          # "r" row / "f" flag
        self.consts: Dict[bytes, int] = {}
        self.const_rows: List[Tuple[int, np.ndarray]] = []
        self.inputs: Tuple[List[int], List[int]] = ([], [])
        self.lane_flag: Optional[int] = None
        self.uniform_flag: Optional[int] = None
        self.calls: List[str] = []          # the tower-level calls, in order

    # -- values -------------------------------------------------------------

    def _new(self, kind: str) -> int:
        self.vkind.append(kind)
        return len(self.vkind) - 1

    def op(self, name: str, ndst: int, kind: str, srcs, aux=None) -> List[int]:
        dsts = [self._new(kind) for _ in range(ndst)]
        self.ops.append((name, tuple(dsts), tuple(srcs), aux))
        return dsts

    def const(self, limbs) -> int:
        arr = np.asarray(limbs, dtype=np.int64).reshape(L)
        key = arr.tobytes()
        v = self.consts.get(key)
        if v is None:
            v = self.consts[key] = self._new("r")
            self.const_rows.append((v, arr.copy()))
        return v

    def input_rows(self, group: int, n: int) -> List[int]:
        rows = [self._new("r") for _ in range(n)]
        self.inputs[group].extend(rows)
        return rows

    def input_fq2(self, group: int) -> V2:
        return V2(self, *self.input_rows(group, 2))

    def input_lane_flag(self) -> Flag:
        self.lane_flag = self._new("f")
        return Flag(self, self.lane_flag)

    def input_uniform_flag(self) -> Flag:
        self.uniform_flag = self._new("f")
        return Flag(self, self.uniform_flag)

    def _row(self, s) -> int:
        """A row operand: a symbolic row, or a constant (tensor / array)."""
        if isinstance(s, S1):
            return s.v
        if isinstance(s, torch.Tensor):
            s = s.cpu().numpy()
        return self.const(s)

    # -- row ops ------------------------------------------------------------

    def add(self, a, b):
        return self.op("add", 1, "r", (a, b))[0]

    def sub(self, a, b):
        return self.op("sub", 1, "r", (a, b))[0]

    def neg_row(self, a):
        return self.op("neg", 1, "r", (a,))[0]

    def mul_row(self, a, b):
        return self.op("mul", 1, "r", (a, b))[0]

    def isz(self, a) -> Flag:
        srcs = (a, self.const(F._ONE_MONT), self.const(F._Q_PAT),
                self.const(F._NEGQ_PAT))
        return Flag(self, self.op("isz", 1, "f", srcs)[0])

    def bil(self, tables: F.Bilinear, a_rows, b_rows) -> List[int]:
        """fq_bilinear_plain(a, b, tables): with norm_in, a `norm` op on
        every input row first (one set when b is a); with one_col, the
        constant Montgomery one as b's last row."""
        if T.TABLES[tables.kind] is not tables:
            raise ValueError(f"{tables.name}: not a program product")
        if len(a_rows) != tables.Ca or len(b_rows) != tables.Cb:
            raise ValueError(f"{tables.name}: {len(a_rows)} x {len(b_rows)} rows")
        if tables.norm_in:
            same = b_rows is a_rows
            a_rows = [self.op("norm", 1, "r", (r,))[0] for r in a_rows]
            b_rows = a_rows if same else [self.op("norm", 1, "r", (r,))[0] for r in b_rows]
        if tables.one_col:
            b_rows = list(b_rows) + [self.const(F._ONE_MONT)]
        return self.op("bil", tables.R, "r", tuple(a_rows) + tuple(b_rows),
                       aux=tables.kind)

    # -- Fq: Field.pow_static and inv ----------------------------------------

    def fq_inv(self, a: int) -> int:
        """Field.inv: a^(q-2) by Field.pow_static's fixed window."""
        w = F._POW_WINDOW
        digits = [int(d) for d in F._exp_window_digits(F._INV_EXP_BITS, w)]
        a = self.op("norm", 1, "r", (a,))[0]
        table = [self.const(F._ONE_MONT), a]
        for _ in range(2, 1 << w):
            table.append(self.mul_row(table[-1], a))
        acc = table[digits[0]]
        for d in digits[1:]:
            for _ in range(w):
                acc = self.mul_row(acc, acc)
            acc = self.mul_row(acc, table[d])
        return acc

    # -- Fq2 (Tower's methods and the G2 namespace) ---------------------------

    def fq2_add(self, a, b):
        return V2(self, self.add(a.r[0], b.r[0]), self.add(a.r[1], b.r[1]))

    def fq2_sub(self, a, b):
        return V2(self, self.sub(a.r[0], b.r[0]), self.sub(a.r[1], b.r[1]))

    def fq2_neg(self, a):
        return V2(self, self.neg_row(a.r[0]), self.neg_row(a.r[1]))

    def fq2_mul(self, a, b):
        self.calls.append("fq2_mul")
        return V2(self, *self.bil(T._FQ2_T, a.r, b.r))

    def fq2_sqr(self, a):
        """Tower.fq2_sqr: (a0 + a1)(a0 - a1) and a0 a1, then 2 a0 a1."""
        self.calls.append("fq2_sqr")
        a0, a1 = a.r
        s, d = self.add(a0, a1), self.sub(a0, a1)
        p0, p1 = self.mul_row(s, d), self.mul_row(a0, a1)
        return V2(self, p0, self.add(p1, p1))

    def fq2_scale(self, a, s):
        self.calls.append("fq2_scale")
        s = self._row(s)
        return V2(self, self.mul_row(a.r[0], s), self.mul_row(a.r[1], s))

    def fq2_inv(self, a):
        """Tower.fq2_inv: the norm a0^2 + a1^2, one Fq inversion, then
        (a0, -a1) / norm."""
        self.calls.append("fq2_inv")
        a0, a1 = a.r
        n0, n1 = self.mul_row(a0, a0), self.mul_row(a1, a1)
        inv_norm = self.fq_inv(self.add(n0, n1))
        o0, o1 = self.mul_row(a0, inv_norm), self.mul_row(a1, inv_norm)
        return V2(self, o0, self.neg_row(o1))

    def fq2_is_zero(self, a):
        self.calls.append("fq2_is_zero")
        return self.isz(a.r[0]) & self.isz(a.r[1])

    def fq2_select(self, cond, a, b):
        return V2(self, *(self.op("sel", 1, "r", (cond.v, x, y))[0]
                          for x, y in zip(a.r, b.r)))

    def fq2_zeros(self, batch=(), device=None):
        z = self.const(np.zeros(L, np.int64))
        return V2(self, z, z)

    def fq2_ones(self, batch=(), device=None):
        return V2(self, self.const(T._FQ2_ONE_NP[0]), self.const(T._FQ2_ONE_NP[1]))

    def take(self, values: Sequence[V2], d: Digit) -> V2:
        """values[idx[d]], idx read from device memory: one load per row."""
        return V2(self, *(self.op("load", 1, "r", [v.r[h] for v in values], aux=d.i)[0]
                          for h in range(2)))

    def fq2_mul_xi(self, a):
        """fq_tower.fq2_mul_xi: (a0 - a1, a0 + a1)."""
        a0, a1 = a.r
        return V2(self, self.sub(a0, a1), self.add(a0, a1))

    # -- Fq6: a tuple of three V2 (Tower's methods) ----------------------------

    def fq6_mul(self, a, b):
        """Tower.fq6_mul: Karatsuba over Fq2, six fq2_mul."""
        m, xi = self.fq2_mul, self.fq2_mul_xi
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0, t1, t2 = m(a0, b0), m(a1, b1), m(a2, b2)
        c0 = t0 + xi(m(a1 + a2, b1 + b2) - (t1 + t2))
        c1 = (m(a0 + a1, b0 + b1) - (t0 + t1)) + xi(t2)
        c2 = (m(a0 + a2, b0 + b2) - (t0 + t2)) + t1
        return (c0, c1, c2)

    def fq6_mul_by_v(self, a):
        """fq_tower.fq6_mul_by_v: (c2 xi, c0, c1)."""
        return (self.fq2_mul_xi(a[2]), a[0], a[1])

    def fq6_inv(self, a):
        """Tower.fq6_inv: the cofactors, the norm's Fq2 inversion, three
        products."""
        m, sq, xi = self.fq2_mul, self.fq2_sqr, self.fq2_mul_xi
        a0, a1, a2 = a
        t0 = sq(a0) - xi(m(a1, a2))
        t1 = xi(sq(a2)) - m(a0, a1)
        t2 = sq(a1) - m(a0, a2)
        denom = m(a0, t0) + xi(m(a2, t1) + m(a1, t2))
        inv_d = self.fq2_inv(denom)
        return (m(t0, inv_d), m(t1, inv_d), m(t2, inv_d))

    # -- Fq12: 12 rows, flat [w j][v i][u h] (the Miller loop's f) --------------

    def fq12_ones(self, batch=(), device=None):
        return [self.const(r) for r in T._FQ12_ONE_NP.reshape(12, L)]

    def _fq6_of(self, f, j: int):
        return tuple(V2(self, f[6 * j + 2 * i], f[6 * j + 2 * i + 1]) for i in range(3))

    @staticmethod
    def _rows_of(c0, c1):
        return [r for c in c0 + c1 for r in c.r]

    def fq12_mul(self, a, b):
        self.calls.append("fq12_mul")
        return self.bil(T._MUL_T, a, b)

    def fq12_cyclo_sqr(self, a):
        """Tower.fq12_cyclo_sqr: the inputs' norm, then the product with
        Montgomery one as b's thirteenth row."""
        self.calls.append("fq12_cyclo_sqr")
        return self.bil(T._CYCLO_T, a, a)

    def fq12_inv(self, f):
        """Tower.fq12_inv over Fq6: (a0 - a1 w) / (a0^2 - v a1^2)."""
        self.calls.append("fq12_inv")
        a0, a1 = self._fq6_of(f, 0), self._fq6_of(f, 1)
        a0a0 = self.fq6_mul(a0, a0)
        denom = tuple(x - y for x, y in zip(a0a0, self.fq6_mul_by_v(self.fq6_mul(a1, a1))))
        inv_d = self.fq6_inv(denom)
        return self._rows_of(self.fq6_mul(a0, inv_d),
                             tuple(-c for c in self.fq6_mul(a1, inv_d)))

    def fq12_frobenius(self, f, k: int):
        """Tower.fq12_frobenius: each Fq2 coefficient conjugated for odd
        k, then multiplied by its constant of fq_tower._FROB[k]."""
        self.calls.append("fq12_frobenius")
        coeffs = T._FROB[k].reshape(6, 2, L)
        out = []
        for c in range(6):
            r0, r1 = f[2 * c], f[2 * c + 1]
            if k % 2 == 1:
                r1 = self.neg_row(r1)
            out += self.bil(T._FQ2_T, (r0, r1),
                            (self.const(coeffs[c, 0]), self.const(coeffs[c, 1])))
        return out

    def fq12_pow_abs(self, f, bits_np):
        """Tower.fq12_pow_abs: the steps of fq_tower.pow_abs_program, as
        fq.chain_by_products runs them (a product of the accumulator with
        itself or with the base f)."""
        self.calls.append("fq12_pow_abs")
        acc = f
        for code in T.pow_abs_program(bits_np):
            kind, src = int(code) & F.KIND_MASK, int(code) >> F.KIND_BITS
            acc = self.bil(T.TABLES[kind], acc, acc if src == F.SRC_ACC else f)
        return acc

    def fq12_eq(self, a, b) -> Flag:
        """Tower.fq12_eq: every row of a - b is zero (is_zero), the flags
        ANDed."""
        flags = [self.isz(self.sub(x, y)) for x, y in zip(a, b)]
        out = flags[0]
        for fl in flags[1:]:
            out = out & fl
        return out

    def fq12_conj(self, f):
        """Rows 6..11 (the w coefficient) negated."""
        return list(f[:6]) + [self.neg_row(r) for r in f[6:]]

    def fq12_sqr(self, f):
        self.calls.append("fq12_sqr")
        return self.bil(T._SQR_T, f, f)

    def fq12_mul_line(self, f, c_a, c_v, c_vw):
        self.calls.append("fq12_mul_line")
        return self.bil(T._LINE_T, f, c_a.r + c_v.r + c_vw.r)

    def fq12_sqr_mul_lines(self, f, c_a, c_v, c_vw):
        """Tower.fq12_sqr_mul_lines over per-pair lists of lines."""
        f = self.fq12_sqr(f)
        return self.fq12_mul_lines(f, c_a, c_v, c_vw)

    def fq12_mul_lines(self, f, c_a, c_v, c_vw):
        for a, v, vw in zip(c_a, c_v, c_vw):
            f = self.fq12_mul_line(f, a, v, vw)
        return f

    # -- compile ------------------------------------------------------------

    def compile(self, out_rows: Sequence[int], out_flag: Optional[int] = None,
                n_digits: int = 0) -> "Program":
        return _compile(self, list(out_rows), out_flag, n_digits)


class G1Ops:
    """The G1 field-ops namespace of ops/scalar_mul.py over a Recorder,
    bls_torch.G1_OPS's twin: Fq rows (S1), mul / sqr a `mul` op, inv
    Field.inv's window (Recorder.fq_inv), is_zero an `isz` op."""

    val_ndim = 1

    def __init__(self, rec: Recorder):
        self.rec = rec

    def _s(self, v: int) -> S1:
        return S1(self.rec, v)

    def mul(self, a, b):
        return self._s(self.rec.mul_row(a.v, b.v))

    def sqr(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return self._s(self.rec.add(a.v, b.v))

    def sub(self, a, b):
        return self._s(self.rec.sub(a.v, b.v))

    def neg(self, a):
        return self._s(self.rec.neg_row(a.v))

    def inv(self, a):
        return self._s(self.rec.fq_inv(a.v))

    def select(self, cond, a, b):
        return self._s(self.rec.op("sel", 1, "r", (cond.v, a.v, b.v))[0])

    def is_zero(self, a):
        return self.rec.isz(a.v)

    def zeros(self, batch=(), device=None):
        return self._s(self.rec.const(np.zeros(L, np.int64)))

    def ones(self, batch=(), device=None):
        return self._s(self.rec.const(F._ONE_MONT))


class FieldOps:
    """The G2 field-ops namespace of ops/scalar_mul.py (`fo`) over a
    Recorder: its Fq2 methods under the namespace's names, and `take`
    (the table load by a digit) for the window loop."""

    val_ndim = 2

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.mul, self.sqr, self.neg = rec.fq2_mul, rec.fq2_sqr, rec.fq2_neg
        self.add, self.sub, self.inv = rec.fq2_add, rec.fq2_sub, rec.fq2_inv
        self.select, self.is_zero = rec.fq2_select, rec.fq2_is_zero
        self.zeros, self.ones, self.take = rec.fq2_zeros, rec.fq2_ones, rec.take


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------

class Program:
    """A compiled recording. `code` holds, in int32: the bundle records
    (offset 0, each 16-byte aligned), the first RING records' (offset,
    words), then the register maps (constants, inputs 0 and 1, outputs);
    `consts` [n_const, 14] int64 the constant rows. `bundles` [nb, 4]:
    each bundle's linear ops in phase A, multiplies, tower products and
    linear ops in phases E to E3. `ops`, `op_bundle`, `op_phase` and `reg` are
    the compiled schedule (ops with value ids, each op's bundle and phase
    class, value -> register), which decode() gives back from `code`;
    `staged` the values written before the first bundle (inputs,
    constants, flags), `roots` the output values. The kernel runs
    `n_records` records: one a bundle, or one a run of up to RUN_MAX
    single-multiply bundles (`records` [n_records, 5]: the counts of
    `bundles` summed, and 1 for a run). `slot_words` is the largest
    record, `threads_lane` the threads a lane's widest phase asks for with
    16-thread groups."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def describe(self) -> dict:
        """Counts of the compiled program (ops by class, bundles by what
        they hold, records and runs, folded norms, registers, scratch rows,
        record sizes)."""
        b = self.bundles
        return {"ops": self.n_ops, "bundles": self.n_bundles, "records": self.n_records,
                "runs": int((self.records[:, 4] > 0).sum()),
                "run_bundles": int(self.records[:, 4].sum()), "folded_norms": self.n_folded,
                "product_bundles": self.product_bundles,
                "linear_only": int(((b[:, 1] + b[:, 2]) == 0).sum()),
                "phase_e_bundles": int(((b[:, 3] > 0) & ((b[:, 1] + b[:, 2]) > 0)).sum()),
                "muls": self.n_mul, "products": self.n_bil, "leaves": self.n_leaves,
                "redcs": self.n_redc, "linear": self.n_lin,
                "linear_e": int(b[:, 3].sum()), "registers": self.nreg,
                "flags": self.nflag, "leaf_rows": self.nx, "wide_rows": self.ng,
                "record_words_max": self.slot_words, "code_words": int(self.code.shape[0])}


def _dce(rec: Recorder, outs: Sequence[int]) -> List[tuple]:
    live = set(outs)
    keep = []
    for op in reversed(rec.ops):
        if any(d in live for d in op[1]):
            keep.append(op)
            live.update(op[2])
    return keep[::-1]


def _class_of(name: str) -> str:
    """The op's class in a record: "P" tower product, "M" multiply, "L"
    linear (its phase, A or E, is the schedule's)."""
    return "P" if name == "bil" else "M" if name in MULTIPLY else "L"


def _schedule(ops: List[tuple]) -> Tuple[List[int], List[str]]:
    """Each op's bundle and phase class ("A", "M", "P", "E", "E2", "E3"),
    as early as its inputs allow: phase times t = NPH * bundle + phase; a
    linear op runs in phase A, E, E2 or E3 after its inputs' writes (so a
    chain of up to three linear ops after a REDC stays in its bundle), a
    multiply reads in B
    (so a phase-A result feeds it in the same bundle), a tower product's
    pre-sums read in A (its inputs come from an earlier bundle); products
    write in D. No op is placed before the bundle of the op LOOKAHEAD
    ops before it, nor into a bundle whose leaf or wide scratch is full.
    Bundles are numbered densely."""
    ready: Dict[int, int] = {}
    bundle, phase = [0] * len(ops), [""] * len(ops)
    used_x: Dict[int, int] = {}
    used_g: Dict[int, int] = {}
    for i, (name, dsts, srcs, aux) in enumerate(ops):
        r = max([ready.get(s, -1) for s in srcs] + [-1])
        lo = bundle[i - LOOKAHEAD] if i >= LOOKAHEAD else 0
        cls = _class_of(name)
        if cls == "L":
            t = max(r + 1, NPH * lo)
            if t % NPH not in LINEAR_PHASES:
                t += PH_E - t % NPH
            b, ph, done = t // NPH, LINEAR_PHASES[t % NPH], t
        else:
            if cls == "P":
                tab = T.TABLES[aux]
                need_x, need_g = tab.P, tab.R
                b = max(lo, r // NPH + 1)
            else:
                need_x, need_g = 0, 1
                b = max(lo, (r - PH_B) // NPH + 1)
            while (used_x.get(b, 0) + need_x > MAX_LEAVES
                   or used_g.get(b, 0) + need_g > MAX_WIDE):
                b += 1
            used_x[b] = used_x.get(b, 0) + need_x
            used_g[b] = used_g.get(b, 0) + need_g
            ph, done = cls, NPH * b + PH_D
        bundle[i], phase[i] = b, ph
        for d in dsts:
            ready[d] = done
    dense = {b: k for k, b in enumerate(sorted(set(bundle)))}
    return [dense[b] for b in bundle], phase


def _times(name: str, b: int, ph: str, nsrc: int):
    """(write time, read time of each source) of an op in bundle b."""
    base = NPH * b
    if ph in LINEAR_CLASSES:
        t = base + LINEAR_CLASSES[ph]
        return t, [t] * nsrc
    if ph == "P":
        return base + PH_D, [base + PH_A] * nsrc
    reads = [base + PH_B] * nsrc
    if name == "isz":          # the q and -q patterns are compared in D
        reads[2:] = [base + PH_D] * (nsrc - 2)
    return base + PH_D, reads


def _linear_word(op, reg: Dict[int, int], pool: List[int], at_pool: int) -> List[int]:
    """A linear op's WORDS int32 words; a load's row list goes to `pool`,
    which starts at word `at_pool` of its record."""
    name, dsts, srcs, aux = op
    s = [reg[v] for v in srcs]
    w = [0] * WORDS
    w[0], w[1] = LINEAR[name], reg[dsts[0]]
    if name == "load":
        w[4], w[5], w[6] = len(s), aux, at_pool + len(pool)
        pool.extend(s)
    elif name == "sgn":
        w[5] = aux
    elif name == "sel":
        w[4], w[2], w[3] = s
    else:
        w[2:2 + len(s)] = s
    return w


def _multiply_word(op, reg: Dict[int, int], wide: int) -> List[int]:
    name, dsts, srcs, _ = op
    w = [0] * WORDS
    w[0], w[1] = MULTIPLY[name], reg[dsts[0]]
    w[2:2 + len(srcs)] = [reg[v] for v in srcs]     # isz: a, one, q, -q
    w[6] = wide
    return w


def _run_record(ops, reg: Dict[int, int], muls: List[int]) -> List[int]:
    """A run record of the multiplies `muls` (op indices), in order."""
    body = [x for i in muls for x in _multiply_word(ops[i], reg, 0)]
    head = [0] * HDR
    head[0], head[2], head[REC_RUN] = HDR + len(body), len(muls), 1
    return head + body


def _compile(rec: Recorder, outs: List[int], out_flag: Optional[int],
             n_digits: int) -> Program:
    roots = outs + ([] if out_flag is None else [out_flag])
    ops = _dce(rec, roots)
    op_bundle, op_phase = _schedule(ops)
    n_bundles = max(op_bundle) + 1 if ops else 0

    # -- registers: a value holds its register from its write to its last
    # read (phase times, both ends included); a register is free again only
    # after the phase of its last read
    written: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for (name, dsts, srcs, _), b, ph in zip(ops, op_bundle, op_phase):
        w, reads = _times(name, b, ph, len(srcs))
        for d in dsts:
            written[d] = w
        for s, t in zip(srcs, reads):
            last[s] = max(last.get(s, -1), t)
    end = NPH * n_bundles
    for v in roots:
        last[v] = end
    used = set(last)

    free = {"r": [], "f": []}
    count = {"r": 0, "f": 0}
    reg: Dict[int, int] = {}
    busy: List[Tuple[int, int]] = []       # (last read, value)
    holder_last: Dict[Tuple[str, int], int] = {}   # a register's latest value's last read
    prev_last: Dict[int, int] = {}         # value -> its register's previous value's last read

    def release_before(t: int) -> None:
        while busy and busy[0][0] < t:
            _, v = heapq.heappop(busy)
            heapq.heappush(free[rec.vkind[v]], reg[v])

    def alloc(v: int, t: int) -> None:
        kind = rec.vkind[v]
        if free[kind]:
            r = heapq.heappop(free[kind])
        else:
            r = count[kind]
            count[kind] += 1
        reg[v] = r
        prev_last[v] = holder_last.get((kind, r), -1)
        holder_last[(kind, r)] = last.get(v, t)
        heapq.heappush(busy, (last.get(v, t), v))

    const_rows = [(v, a) for v, a in rec.const_rows if v in used]
    pre = list(rec.inputs[0]) + list(rec.inputs[1]) + [v for v, _ in const_rows]
    pre += [v for v in (rec.lane_flag, rec.uniform_flag) if v is not None]
    for v in pre:                          # staged, unread ones free at time 0
        alloc(v, -1)
    order = sorted(range(len(ops)), key=lambda i: (written[ops[i][1][0]], i))
    for i in order:
        t = written[ops[i][1][0]]
        release_before(t)
        for d in ops[i][1]:
            alloc(d, t)

    # -- records -----------------------------------------------------------------
    by_bundle: List[Dict[str, List[int]]] = [
        {k: [] for k in ("A", "M", "P", "E", "E2", "E3")} for _ in range(n_bundles)]
    for i, (b, ph) in enumerate(zip(op_bundle, op_phase)):
        by_bundle[b][ph].append(i)
    records, rows, run_of = [], [], []
    nx = ng = 0
    n_fold = 0
    threads_lane = 1
    n_mul = n_bil = n_lin = n_leaves = n_redc = 0
    for members in by_bundle:
        lin_a, mul, bil, lin_e, lin_e2, lin_e3 = (members[k] for k in
                                                  ("A", "M", "P", "E", "E2", "E3"))
        tabs = [T.TABLES[ops[i][3]] for i in bil]
        # phase E's norms of a product output of this bundle, run by the
        # REDC that makes their input (write at D) where their register's
        # previous value is last read before D
        slot_of = {d: k for k, d in enumerate(d for i in bil for d in ops[i][1])}
        fold: Dict[int, int] = {}          # E op -> output slot
        d_time = NPH * op_bundle[lin_e[0]] + PH_D if lin_e else 0
        for i in lin_e:
            name, dsts, srcs, _ = ops[i]
            k = slot_of.get(srcs[0], -1) if name == "norm" else -1
            if k >= 0 and k not in fold.values() and prev_last[dsts[0]] < d_time:
                fold[i] = k
        live_e = [i for i in lin_e if i not in fold]
        n_leaf = sum(t.P for t in tabs)
        n_out = sum(t.R for t in tabs)
        n_words = len(lin_a) + len(mul) + len(bil) + len(live_e) + len(lin_e2) + len(lin_e3)
        at_pool = HDR + WORDS * n_words + n_leaf + n_out
        words, leaf_tab, out_tab, pool = [], [], [], []

        def linear_word(i):
            return _linear_word(ops[i], reg, pool, at_pool)

        words += [linear_word(i) for i in lin_a]
        g_off = x_off = 0
        for i in mul:
            words.append(_multiply_word(ops[i], reg, g_off))
            g_off += 1
        for i, t in zip(bil, tabs):
            _, dsts, srcs, aux = ops[i]
            w = [0] * WORDS
            w[0], w[1], w[2], w[3] = BIL + aux, at_pool + len(pool), x_off, g_off
            pool.extend([reg[v] for v in srcs] + [reg[v] for v in dsts])
            leaf_tab += [x_off + k for k in range(t.P)]
            out_tab += [((g_off + r) << 16) | reg[d] for r, d in enumerate(dsts)]
            x_off += t.P
            g_off += t.R
            words.append(w)
        words += [linear_word(i) for i in live_e + lin_e2 + lin_e3]
        body = [x for w in words for x in w] + leaf_tab + out_tab + pool
        head = [0] * HDR
        head[1:7] = [len(lin_a), len(mul), len(bil), len(live_e), n_leaf, n_out]
        head[REC_E2], head[REC_E3] = len(lin_e2), len(lin_e3)
        if fold:
            folded, place = [0] * n_out, [-1] * n_out
            for i, k in fold.items():
                folded[k], place[k] = reg[ops[i][1][0]] + 1, lin_e.index(i)
            head[REC_FOLD_TAB] = HDR + len(body)
            body += folded + place
            n_fold += len(fold)
        size = -(-(HDR + len(body)) // 4) * 4
        head[0] = size
        records.append(head + body + [0] * (size - HDR - len(body)))
        n_late = len(lin_e) + len(lin_e2) + len(lin_e3)
        rows.append([len(lin_a), len(mul), len(bil), n_late])
        run_of.append(mul[0] if len(mul) == 1 and len(words) == 1
                      and ops[mul[0]][0] == "mul" else None)
        nx, ng = max(nx, x_off), max(ng, g_off)
        threads_lane = max(threads_lane, len(lin_a) + 2 * L * len(bil),
                           GROUP * (len(mul) + n_leaf), GROUP * (len(mul) + n_out),
                           len(lin_e), len(lin_e2), len(lin_e3))
        n_mul += len(mul)
        n_bil += len(bil)
        n_lin += len(lin_a) + n_late
        n_leaves += n_leaf
        n_redc += n_out
    # stretches of consecutive single-multiply bundles into run records
    packed, record_rows = [], []
    b = 0
    while b < len(records):
        e = b
        while e < len(records) and run_of[e] is not None and e - b < RUN_MAX:
            e += 1
        if e - b < 2:
            packed.append(records[b])
            record_rows.append(rows[b] + [0])
            b += 1
            continue
        packed.append(_run_record(ops, reg, run_of[b:e]))
        record_rows.append([0, e - b, 0, 0, e - b])
        b = e
    records = packed
    starts = np.cumsum([0] + [len(r) for r in records])
    for b, r in enumerate(records):        # where the record RING on lies
        if b + RING < len(records):
            r[REC_NEXT_OFF], r[REC_NEXT_WORDS] = starts[b + RING], len(records[b + RING])
    ring0 = [0] * (2 * RING)
    for b in range(min(RING, len(records))):
        ring0[2 * b], ring0[2 * b + 1] = starts[b], len(records[b])

    def regs_of(vs):
        return [reg[v] for v in vs]

    const_regs = [reg[v] for v, _ in const_rows]
    consts = (np.stack([a for _, a in const_rows]) if const_rows
              else np.zeros((0, L), np.int64))
    sections = {"records": np.asarray([x for r in records for x in r], np.int32),
                "ring0": np.asarray(ring0, np.int32),
                "const_regs": np.asarray(const_regs, np.int32),
                "in0": np.asarray(regs_of(rec.inputs[0]), np.int32),
                "in1": np.asarray(regs_of(rec.inputs[1]), np.int32),
                "out": np.asarray(regs_of(outs), np.int32)}
    offsets, parts, at = {}, [], 0
    for k, arr in sections.items():
        offsets[k] = at
        parts.append(arr)
        at += arr.shape[0]
    bundles = np.asarray(rows, np.int64).reshape(-1, 4)
    return Program(
        code=np.concatenate(parts).astype(np.int32), consts=consts, offsets=offsets,
        n_bundles=n_bundles, n_ops=len(ops), nreg=count["r"], nflag=count["f"],
        nx=nx, ng=ng, n_const=len(const_regs), in_rows=(len(rec.inputs[0]),
                                                         len(rec.inputs[1])),
        out_rows=len(outs), lane_flag=reg.get(rec.lane_flag, -1),
        uniform_flag=reg.get(rec.uniform_flag, -1),
        out_flag=-1 if out_flag is None else reg[out_flag], n_digits=n_digits,
        n_records=len(records), records=np.asarray(record_rows, np.int64).reshape(-1, 5),
        slot_words=max([len(r) for r in records] + [4]), threads_lane=threads_lane,
        product_bundles=int(((bundles[:, 1] + bundles[:, 2]) > 0).sum()),
        n_mul=n_mul, n_bil=n_bil, n_lin=n_lin, n_leaves=n_leaves, n_redc=n_redc,
        n_folded=n_fold,
        bundles=bundles, ops=ops, op_bundle=op_bundle, op_phase=op_phase, reg=reg,
        staged=pre, roots=roots, vkind=list(rec.vkind))


_NAME_OF = {code: name for name, code in {**LINEAR, **MULTIPLY}.items()}


def b_rows(t: F.Bilinear) -> int:
    """A product's b rows in a program: its Cb, and Montgomery one's row
    with one_col."""
    return t.Cb + int(t.one_col)


def _decode_linear(w, rec) -> tuple:
    name = _NAME_OF[int(w[0])]
    if name == "load":
        return name, (int(w[1]),), tuple(int(x) for x in rec[w[6]:w[6] + w[4]]), int(w[5])
    if name == "sgn":
        return name, (int(w[1]),), (), int(w[5])
    if name == "sel":
        return name, (int(w[1]),), (int(w[4]), int(w[2]), int(w[3])), None
    n = 1 if name in ("neg", "norm", "fnot") else 2
    return name, (int(w[1]),), tuple(int(x) for x in w[2:2 + n]), None


def _decode_multiply(w) -> tuple:
    name = _NAME_OF[int(w[0])]
    n = 4 if name == "isz" else 2
    return name, (int(w[1]),), tuple(int(x) for x in w[2:2 + n]), None


def decode(prog: Program) -> List[Dict[str, list]]:
    """The program's records read back from `code`: per bundle {"A",
    "M", "P", "E", "E2", "E3": [(name, dst registers, source registers,
    aux)]} in
    record order (aux: a load's or sgn's digit, a product's kind, else
    None), "leaf_rows" (each leaf's scratch row), "wide_rows" (each
    REDC's wide scratch row: the multiplies', then the products'
    outputs') and "run" (the bundle's multiply is one of a run record's,
    which the kernel runs in this order, each after the one before)."""
    code = prog.code
    at = prog.offsets["records"]
    out = []
    for _ in range(prog.n_records):
        rec = code[at:at + int(code[at + REC_WORDS])]
        n_a, n_m, n_p, n_e, n_leaf, n_out = (int(x) for x in rec[1:7])
        if rec[REC_RUN]:
            for w in rec[HDR:HDR + WORDS * n_m].reshape(-1, WORDS):
                out.append({"A": [], "M": [_decode_multiply(w)], "P": [], "E": [], "E2": [],
                            "E3": [], "leaf_rows": [], "wide_rows": [int(w[6])], "run": True})
            at += len(rec)
            continue
        n_e2, n_e3 = int(rec[REC_E2]), int(rec[REC_E3])
        words = rec[HDR:HDR + WORDS * (n_a + n_m + n_p + n_e + n_e2 + n_e3)].reshape(-1, WORDS)
        tabs_at = HDR + WORDS * len(words)
        leaf_tab = [int(x) for x in rec[tabs_at:tabs_at + n_leaf]]
        out_tab = [int(x) for x in rec[tabs_at + n_leaf:tabs_at + n_leaf + n_out]]

        at_e = n_a + n_m + n_p
        b = {"A": [_decode_linear(w, rec) for w in words[:n_a]], "M": [], "P": [],
             "E": [_decode_linear(w, rec) for w in words[at_e:at_e + n_e]],
             "E2": [_decode_linear(w, rec) for w in words[at_e + n_e:at_e + n_e + n_e2]],
             "E3": [_decode_linear(w, rec) for w in words[at_e + n_e + n_e2:]],
             "leaf_rows": leaf_tab, "wide_rows": [], "run": False}
        for w in words[n_a:n_a + n_m]:
            b["M"].append(_decode_multiply(w))
            b["wide_rows"].append(int(w[6]))
        for w in words[n_a + n_m:n_a + n_m + n_p]:
            kind = int(w[0]) - BIL
            t = T.TABLES[kind]
            n_in = t.Ca + b_rows(t)
            rows = [int(x) for x in rec[w[1]:w[1] + n_in + t.R]]
            b["P"].append(("bil", tuple(rows[n_in:]), tuple(rows[:n_in]), kind))
        b["wide_rows"] += [e >> 16 for e in out_tab]
        if [e & 0xFFFF for e in out_tab] != [d for op in b["P"] for d in op[1]]:
            raise ValueError("a record's REDC table disagrees with its products")
        if rec[REC_FOLD_TAB]:
            at_fold = int(rec[REC_FOLD_TAB])
            folded = rec[at_fold:at_fold + n_out]
            place = rec[at_fold + n_out:at_fold + 2 * n_out]
            for k in sorted(np.nonzero(folded)[0], key=lambda k: place[k]):
                b["E"].insert(int(place[k]), ("norm", (int(folded[k]) - 1,),
                                              (int(out_tab[k] & 0xFFFF),), None))
        out.append(b)
        at += len(rec)
    return out


# ---------------------------------------------------------------------------
# The plain interpreter
# ---------------------------------------------------------------------------

_FLUSH = 0


def _plain_plan(prog: Program, dev: torch.device) -> list:
    """The program's decoded bundles as batched steps of
    run_program_plain, with their index tensors on `dev` (made once per
    program and device): phase A's linear ops, the products, phases E,
    E2 and E3's."""
    plans = prog.__dict__.setdefault("_plans", {})
    plan = plans.get(dev)
    if plan is not None:
        return plan

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    def linear_steps(lin):
        steps = []
        for name in ("add", "sub", "neg", "norm", "sel", "fand", "fnot"):
            sel = [op for op in lin if op[0] == name]
            if not sel:
                continue
            d = [op[1][0] for op in sel]
            if name == "sel":
                f, a, b = ([op[2][k] for op in sel] for k in range(3))
            else:
                f = [0] * len(sel)
                a = [op[2][0] for op in sel]
                b = [op[2][-1] for op in sel]
            steps.append((LINEAR[name], ix(d), ix(a), ix(b), ix(f)))
        for name, d, s, aux in lin:
            if name in ("load", "sgn"):
                steps.append((LINEAR[name], d[0], aux, np.asarray(s, np.int64)))
        return steps

    plan = []
    for b in decode(prog):
        steps = linear_steps(b["A"]) + [(_FLUSH,)]
        mul, bil = b["M"], b["P"]
        if mul or bil:
            isz = np.asarray([op[0] == "isz" for op in mul], bool)
            a = [op[2][0] for op in mul]
            bb = [op[2][1] for op in mul]
            d = np.asarray([op[1][0] for op in mul], np.int64)
            groups = []
            for kind in sorted({op[3] for op in bil}):
                t = T.TABLES[kind]
                rows = np.asarray([op[2] + op[1] for op in bil if op[3] == kind])
                n_in = t.Ca + b_rows(t)
                groups.append((t, ix(rows[:, :t.Ca]), ix(rows[:, t.Ca:n_in]),
                               ix(rows[:, n_in:])))
            steps.append((MUL, ix(a), ix(bb), ix(np.nonzero(~isz)[0]),
                          ix(np.nonzero(isz)[0]), ix(d[~isz]), ix(d[isz]), groups))
        for ph in ("E", "E2", "E3"):
            steps += linear_steps(b[ph]) + [(_FLUSH,)]
        plan.append(steps)
    plans[dev] = plan
    return plan


def run_program_plain(prog: Program, in0: torch.Tensor,
                      in1: Optional[torch.Tensor] = None,
                      lane_flag: Optional[torch.Tensor] = None,
                      uniform_flag: bool = False,
                      digits: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """The program on torch tensors over ops/fq.py's plain functions, a
    bundle at a time in the kernel's phase order (phase A's linear ops,
    the products, phases E, E2 and E3's linear ops; each class of op
    batched over the bundle's ops; a run's bundles one after another, as
    the kernel runs them; a norm the kernel folds into phase D here in
    phase E, where decode puts it: the same value into the same register,
    which nothing reads in between): in0 [n, rows0, 14] (in1 [n, rows1,
    14]) int64 limbs,
    lane_flag [n] bool, uniform_flag a bool, digits (idx, sign) host int
    arrays -> (out [n, out_rows, 14], out_flag [n] bool or None). The
    kernel's plain twin: the tests and the card's checks hold it against
    the Python loops and the kernel; no entry point runs it. A bundle's
    schoolbooks (fq_mul_plain's, Field.is_zero's mul_norm by one, every
    tower product's leaves) go through one fq_mul_wide call and its REDCs
    through one fq_redc_plain call: each row's integers are its own."""
    n, dev = in0.shape[0], in0.device
    regs = torch.zeros((prog.nreg, n, L), dtype=torch.int64, device=dev)
    flags = torch.zeros((max(prog.nflag, 1), n), dtype=torch.bool, device=dev)
    code, off = prog.code, prog.offsets

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    regs[ix(code[off["const_regs"]:off["const_regs"] + prog.n_const])] = \
        torch.as_tensor(prog.consts, device=dev)[:, None, :].expand(-1, n, -1)
    for k, t in enumerate((in0, in1)):
        rows = prog.in_rows[k]
        if rows:
            at = off["in0" if k == 0 else "in1"]
            regs[ix(code[at:at + rows])] = t.reshape(n, rows, L).transpose(0, 1)
    if prog.lane_flag >= 0:
        flags[prog.lane_flag] = (torch.zeros(n, dtype=torch.bool, device=dev)
                                 if lane_flag is None else lane_flag.to(dev).bool())
    if prog.uniform_flag >= 0:
        flags[prog.uniform_flag] = bool(uniform_flag)
    d_idx, d_sign = digits if digits is not None else (None, None)
    pats = [F.const(p, dev) for p in (F._ZERO_PAT, F._Q_PAT, F._NEGQ_PAT)]

    for steps in _plain_plan(prog, dev):
        staged = []                     # linear results: a phase's sources read first
        for st in steps:
            op = st[0]
            if op in (ADD, SUB, NEG, NORM, SEL):
                _, d, a, b, f = st
                x = regs[a]
                if op == ADD:
                    x = x + regs[b]
                elif op == SUB:
                    x = x - regs[b]
                elif op == NEG:
                    x = -x
                elif op == NORM:
                    x = F.fq_norm(x)
                else:
                    x = torch.where(flags[f][..., None], x, regs[b])
                staged.append((regs, d, x))
            elif op in (FAND, FNOT):
                _, d, a, b, _ = st
                x = flags[a] & flags[b] if op == FAND else ~flags[a]
                staged.append((flags, d, x))
            elif op == LOAD:
                _, d, pos, rows = st
                staged.append((regs, d, regs[int(rows[int(d_idx[pos])])].clone()))
            elif op == SGN:
                _, d, pos, _ = st
                staged.append((flags, d, bool(d_sign[pos] < 0)))
            elif op == _FLUSH:
                for dst, i, x in staged:
                    dst[i] = x
                staged = []
            else:
                # every schoolbook of the bundle in one fq_mul_wide call and
                # every REDC in one fq_redc_plain call: the multiplies'
                # columns, and each tower product's leaves (wide-normalized)
                # summed by its gamma table, as fq_bilinear_plain does
                _, a, b, im, iz, dm, dz, groups = st
                xs, ys = [regs[a].reshape(-1, L)], [regs[b].reshape(-1, L)]
                for t, ra, rb, _ in groups:
                    xs.append(t[0].apply(regs[ra].permute(0, 2, 1, 3)).reshape(-1, L))
                    ys.append(t[1].apply(regs[rb].permute(0, 2, 1, 3)).reshape(-1, L))
                wide = F.fq_mul_wide(torch.cat(xs), torch.cat(ys))
                m = a.shape[0] * n
                cols, at = [wide[:m]], m
                for t, ra, _, _ in groups:
                    k = ra.shape[0] * n * t.P
                    leaves = F.fq_wide_norm(wide[at:at + k].reshape(-1, t.P, 2 * L))
                    cols.append(t[2].apply(leaves).reshape(-1, 2 * L))
                    at += k
                red = F.fq_redc_plain(torch.cat(cols))
                prod = red[:m].reshape(-1, n, L)
                if len(dm):
                    regs[dm] = prod[im]
                if len(dz):
                    y = F._carry_rounds(prod[iz], F.NORM_FULL)
                    z = torch.zeros(y.shape[:-1], dtype=torch.bool, device=dev)
                    for pat in pats:
                        z = z | torch.all(y == pat, dim=-1)
                    flags[dz] = z
                at = m
                for t, ra, _, d in groups:
                    k = ra.shape[0]
                    out = red[at:at + k * n * t.R].reshape(k, n, t.R, L)
                    regs[d] = out.permute(0, 2, 1, 3)
                    at += k * n * t.R
    out = regs[ix(code[off["out"]:off["out"] + prog.out_rows])].transpose(0, 1)
    return out.contiguous(), (flags[prog.out_flag].clone() if prog.out_flag >= 0
                              else None)
