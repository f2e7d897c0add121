"""Point formulas as programs over a register file of Fq rows: the
recorder that turns the port's own formulas into ops, the scheduler and
register allocator that turn the ops into one int32 program, and the
program's plain interpreter (run_program_plain).

The G2 ladder of hash-to-G2 and signing and the grouped Miller loop are
long loops of small dependent field operations. On the card each is one
launch of a kernel that interprets such a program (csrc/fq_points.cu,
ops/fq_points.py): the host records the loop once, per shape, and the
kernel runs every lane's whole loop out of shared memory.

Values are rows: one Fq element, 14 lazy int64 limbs (an Fq2 is two rows,
an Fq12 twelve), and flags: one bool per lane. An op is one of

- `add`, `sub`, `neg` (lazy limb arithmetic), `norm` (three carry rounds,
  ops.fq.fq_norm), `sel` (a row chosen by a flag), `load` (row
  `rows[idx[pos]]` of a table, idx a digit read from device memory),
  `sgn` (the flag sign[pos] < 0), `fand` and `fnot` on flags;
- `mul` (ops.fq.fq_mul_plain: Montgomery product of two rows) and `isz`
  (ops.fq.Field.is_zero of a row: mul_norm by Montgomery one, then the
  three-pattern compare);
- `bil`: one tower product of a compiled kind (ops/fq_tower.py::TABLES,
  no norm_in / one_col), a list of a rows and b rows to R result rows,
  ops.fq.fq_bilinear_plain's function.

Each op is an exact integer function of its inputs, so the order of
mutually independent ops changes no bit: a program computes what the
recorded formulas compute, limb for limb.

Compiling a recording: dead ops are dropped; every op goes to the first
bundle after those of its inputs (no earlier than the bundle of the op
LOOKAHEAD ops before it, which bounds how far ahead loads and line
coefficients run, and into a later one where the bundle's scratch is
full); rows and flags get registers by liveness (lowest free first, a
bundle's outputs never on a register it reads). The program: per bundle
its op counts (linear ops, multiplies, tower products) and first op;
per op eight int32 words; a pool of row lists; the constant rows.
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
MAX_LEAVES = 64                # leaf rows (x and y each) of one bundle
MAX_WIDE = 32                  # wide rows of one bundle


# ---------------------------------------------------------------------------
# Symbolic values
# ---------------------------------------------------------------------------

class S1:
    """A symbolic Fq row (one value id)."""

    __slots__ = ("rec", "v")
    shape = (1, 1, L)

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
        if tables.norm_in or tables.one_col or T.TABLES[tables.kind] is not tables:
            raise ValueError(f"{tables.name}: not a program product")
        if len(a_rows) != tables.Ca or len(b_rows) != tables.Cb:
            raise ValueError(f"{tables.name}: {len(a_rows)} x {len(b_rows)} rows")
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

    # -- Fq12 (the Miller loop's f) -------------------------------------------

    def fq12_ones(self, batch=(), device=None):
        return [self.const(r) for r in T._FQ12_ONE_NP.reshape(12, L)]

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
    """A compiled recording. `code` holds, in int32: bundles [nb, 4]
    (linear ops, multiplies, tower products, first op), ops [nops, 8],
    the row pool, then the register maps (constants, inputs 0 and 1,
    outputs); `consts` [n_const, 14] int64 the constant rows."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def describe(self) -> dict:
        """Counts of the compiled program (ops by class, bundles by what
        they hold, registers, scratch rows)."""
        return {"ops": self.n_ops, "bundles": self.n_bundles,
                "product_bundles": self.product_bundles, "muls": self.n_mul,
                "products": self.n_bil, "leaves": self.n_leaves,
                "redcs": self.n_redc, "linear": self.n_lin, "registers": self.nreg,
                "flags": self.nflag, "leaf_rows": self.nx, "wide_rows": self.ng}


def _dce(rec: Recorder, outs: Sequence[int]) -> List[tuple]:
    live = set(outs)
    keep = []
    for op in reversed(rec.ops):
        if any(d in live for d in op[1]):
            keep.append(op)
            live.update(op[2])
    return keep[::-1]


def _class_of(name: str) -> int:
    return 2 if name == "bil" else 1 if name in MULTIPLY else 0


def _compile(rec: Recorder, outs: List[int], out_flag: Optional[int],
             n_digits: int) -> Program:
    roots = outs + ([] if out_flag is None else [out_flag])
    ops = _dce(rec, roots)
    n = len(ops)

    # -- schedule --------------------------------------------------------------
    level_of: Dict[int, int] = {}       # value -> level of its defining op
    op_level = [0] * n
    used_x: List[int] = []
    used_g: List[int] = []
    for i, (name, dsts, srcs, aux) in enumerate(ops):
        e = max([level_of.get(s, -1) + 1 for s in srcs] + [0])
        if i >= LOOKAHEAD:
            e = max(e, op_level[i - LOOKAHEAD])
        if name == "bil":
            t = T.TABLES[aux]
            need_x, need_g = t.P, t.R
        elif name in MULTIPLY:
            need_x, need_g = 0, 1
        else:
            need_x = need_g = 0
        lv = e
        while True:
            while len(used_x) <= lv:
                used_x.append(0)
                used_g.append(0)
            if used_x[lv] + need_x <= MAX_LEAVES and used_g[lv] + need_g <= MAX_WIDE:
                break
            lv += 1
        used_x[lv] += need_x
        used_g[lv] += need_g
        op_level[i] = lv
        for d in dsts:
            level_of[d] = lv
    n_levels = max(op_level) + 1 if n else 0

    last_use: Dict[int, int] = {}
    for i, (_, _, srcs, _) in enumerate(ops):
        for s in srcs:
            last_use[s] = max(last_use.get(s, -1), op_level[i])
    end = n_levels
    for v in roots:
        last_use[v] = end

    by_level: List[List[int]] = [[] for _ in range(n_levels)]
    for i in range(n):
        by_level[op_level[i]].append(i)

    # -- registers -----------------------------------------------------------------
    free = {"r": [], "f": []}
    count = {"r": 0, "f": 0}
    reg: Dict[int, int] = {}

    def alloc(v: int) -> int:
        kind = rec.vkind[v]
        if free[kind]:
            r = heapq.heappop(free[kind])
        else:
            r = count[kind]
            count[kind] += 1
        reg[v] = r
        return r

    def release(v: int) -> None:
        heapq.heappush(free[rec.vkind[v]], reg[v])

    used = set(last_use)
    const_rows = [(v, a) for v, a in rec.const_rows if v in used]
    pre = list(rec.inputs[0]) + list(rec.inputs[1]) + [v for v, _ in const_rows]
    pre += [v for v in (rec.lane_flag, rec.uniform_flag) if v is not None]
    for v in pre:
        alloc(v)
    for v in pre:          # staged, never read: the register is free again
        if v not in used:
            release(v)

    bundles, words, pool = [], [], []
    n_mul = n_bil = n_lin = n_leaves = n_redc = 0
    max_items = 1
    nx = ng = 0
    for lv in range(n_levels):
        members = sorted(by_level[lv], key=lambda i: _class_of(ops[i][0]))
        counts = [0, 0, 0]
        x_off = g_off = 0
        items_a = items_b = items_c = items_d = 0
        for i in members:
            name, dsts, srcs, aux = ops[i]
            cls = _class_of(name)
            counts[cls] += 1
            d = [alloc(v) for v in dsts]
            s = [reg[v] for v in srcs]
            w = [0] * WORDS
            if cls == 0:
                n_lin += 1
                items_a += 1
                w[0] = LINEAR[name]
                w[1] = d[0]
                if name == "load":
                    w[4], w[5], w[6] = len(s), aux, len(pool)
                    pool.extend(s)
                elif name == "sgn":
                    w[5] = aux
                elif name == "sel":
                    w[4], w[2], w[3] = s
                else:
                    w[2:2 + len(s)] = s
            elif cls == 1:
                n_mul += 1
                items_b += 1
                items_d += 1
                w[0] = MULTIPLY[name]
                w[1] = d[0]
                w[2:2 + len(s)] = s          # isz: a, one, q, -q
                w[6] = g_off
                g_off += 1
            else:
                t = T.TABLES[aux]
                n_bil += 1
                n_leaves += t.P
                n_redc += t.R
                items_a += 2 * L
                items_b += t.P
                items_c += 2 * L
                items_d += t.R
                w[0] = BIL + aux
                w[1] = len(pool)
                pool.extend(s + d)
                w[2], w[3] = x_off, g_off
                x_off += t.P
                g_off += t.R
            words.append(w)
        nx, ng = max(nx, x_off), max(ng, g_off)
        max_items = max(max_items, items_a, items_b, items_c, items_d)
        first = len(words) - len(members)
        bundles.append([counts[0], counts[1], counts[2], first])
        done = {v for i in members for v in ops[i][2] if last_use[v] == lv}
        done |= {v for i in members for v in ops[i][1] if v not in used}
        for v in sorted(done):
            release(v)

    def regs_of(vs):
        return [reg[v] for v in vs]

    const_regs = [reg[v] for v, _ in const_rows]
    consts = (np.stack([a for _, a in const_rows]) if const_rows
              else np.zeros((0, L), np.int64))
    sections = {"bundles": np.asarray(bundles, np.int32).reshape(-1),
                "ops": np.asarray(words, np.int32).reshape(-1),
                "pool": np.asarray(pool, np.int32),
                "const_regs": np.asarray(const_regs, np.int32),
                "in0": np.asarray(regs_of(rec.inputs[0]), np.int32),
                "in1": np.asarray(regs_of(rec.inputs[1]), np.int32),
                "out": np.asarray(regs_of(outs), np.int32)}
    offsets, parts, at = {}, [], 0
    for k, arr in sections.items():
        offsets[k] = at
        parts.append(arr)
        at += arr.shape[0]
    product_bundles = sum(1 for b in bundles if b[1] or b[2])
    return Program(
        code=np.concatenate(parts).astype(np.int32), consts=consts, offsets=offsets,
        n_bundles=len(bundles), n_ops=len(words), nreg=count["r"], nflag=count["f"],
        nx=nx, ng=ng, n_const=len(const_regs), in_rows=(len(rec.inputs[0]),
                                                         len(rec.inputs[1])),
        out_rows=len(outs), lane_flag=reg.get(rec.lane_flag, -1),
        uniform_flag=reg.get(rec.uniform_flag, -1),
        out_flag=-1 if out_flag is None else reg[out_flag], n_digits=n_digits,
        max_items=max_items, product_bundles=product_bundles, n_mul=n_mul,
        n_bil=n_bil, n_lin=n_lin, n_leaves=n_leaves, n_redc=n_redc,
        bundles=np.asarray(bundles, np.int64).reshape(-1, 4),
        words=np.asarray(words, np.int64).reshape(-1, WORDS),
        pool=np.asarray(pool, np.int64))


# ---------------------------------------------------------------------------
# The plain interpreter
# ---------------------------------------------------------------------------

def _plain_plan(prog: Program, dev: torch.device) -> list:
    """The program's bundles as batched steps of run_program_plain, with
    their index tensors on `dev` (made once per program and device)."""
    plans = prog.__dict__.setdefault("_plans", {})
    plan = plans.get(dev)
    if plan is not None:
        return plan

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    words, pool, plan = prog.words, prog.pool, []
    for n_lin, n_mul, n_bil, first in prog.bundles:
        lin = words[first:first + n_lin]
        mul = words[first + n_lin:first + n_lin + n_mul]
        bil = words[first + n_lin + n_mul:first + n_lin + n_mul + n_bil]
        steps = []
        for code in (ADD, SUB, NEG, NORM, SEL, FAND, FNOT):
            sel = lin[lin[:, 0] == code]
            if len(sel):
                steps.append((code,) + tuple(ix(sel[:, c]) for c in (1, 2, 3, 4)))
        for w in lin[(lin[:, 0] == LOAD) | (lin[:, 0] == SGN)]:
            steps.append((int(w[0]), int(w[1]), int(w[5]), pool[w[6]:w[6] + w[4]]))
        if n_mul or n_bil:
            isz = mul[:, 0] == ISZ
            groups = []
            for kind in sorted(set(int(c) - BIL for c in bil[:, 0])):
                t = T.TABLES[kind]
                sel = bil[bil[:, 0] == BIL + kind]
                rows = np.stack([pool[w[1]:w[1] + t.Ca + t.Cb + t.R] for w in sel])
                groups.append((t, ix(rows[:, :t.Ca]), ix(rows[:, t.Ca:t.Ca + t.Cb]),
                               ix(rows[:, t.Ca + t.Cb:])))
            steps.append((MUL, ix(mul[:, 2]), ix(mul[:, 3]), ix(np.nonzero(~isz)[0]),
                          ix(np.nonzero(isz)[0]), ix(mul[~isz, 1]), ix(mul[isz, 1]),
                          groups))
        plan.append(steps)
    plans[dev] = plan
    return plan


def run_program_plain(prog: Program, in0: torch.Tensor,
                      in1: Optional[torch.Tensor] = None,
                      lane_flag: Optional[torch.Tensor] = None,
                      uniform_flag: bool = False,
                      digits: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """The program on torch tensors over ops/fq.py's plain functions, a
    bundle at a time (each class of op batched over the bundle's ops):
    in0 [n, rows0, 14] (in1 [n, rows1, 14]) int64 limbs, lane_flag [n]
    bool, uniform_flag a bool, digits (idx, sign) host int arrays ->
    (out [n, out_rows, 14], out_flag [n] bool or None). The kernel's
    plain twin: the tests and the card's checks hold it against the
    Python loops and the kernel; no entry point runs it. A bundle's
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
        staged = []                     # linear results: sources read first
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
            else:
                for dst, i, x in staged:
                    dst[i] = x
                staged = []
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
        for dst, i, x in staged:
            dst[i] = x
    out = regs[ix(code[off["out"]:off["out"] + prog.out_rows])].transpose(0, 1)
    return out.contiguous(), (flags[prog.out_flag].clone() if prog.out_flag >= 0
                              else None)
