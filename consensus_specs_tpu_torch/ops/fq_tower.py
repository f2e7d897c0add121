"""Batched Fq2/Fq6/Fq12 tower arithmetic on torch tensors (port of
consensus_specs_tpu/ops/fq_tower.py, its default "coeff" placement):

    Fq2  = Fq[u]/(u^2+1)        -> [..., 2, L]
    Fq6  = Fq2[v]/(v^3 - (1+u)) -> [..., 3, 2, L]
    Fq12 = Fq6[w]/(w^2 - v)     -> [..., 2, 3, 2, L]

plus Frobenius maps f -> f^(q^k) from host-computed coefficient tables.

Every Fq2 and Fq12 product -- fq2_mul, fq12_mul, fq12_sqr, the sparse
line multiply and the cyclotomic squaring -- is one bilinear product
(ops.fq.Bilinear): pre-sum tables alpha/beta build the leaf operands
(3, 54, 36, 39 and 30 leaves), every leaf is a double-width multiply with
one wide carry round, the gamma table recombines the wide columns, and
ONE REDC reduces each output coefficient (2 or 12). On the card that is
one kernel launch. A loop that runs nothing but such products is one
chain launch of the same kernel when a Tower runs it on CUDA tensors:
the exponentiation by a static exponent and the Miller loop's f-update
(`fq12_pow_abs`, `fq12_sqr_mul_lines`, `fq12_mul_lines`; the programs
`pow_abs_program` / `lines_program`), and the Fq2 square root's fixed
power (`fq2_pow_program`, `fq2_pow_static`). The BLS path runs the first
two inside whole-loop programs instead: bls_torch's grouped Miller loop
and final exponentiation on CUDA tensors under DEVICE are one launch
each of the point kernels (ops/fq_points.py: miller_grouped_kernel, and
final_exp_program with pow_abs's steps recorded in it).
The tables come from running the tower's Karatsuba structure
symbolically (`_SymTower`), as in the reference, and are held
equal to its arrays (or, for Fq2 and the cyclotomic squaring, to its
functions) by the tests.

Everything that reduces goes through a `Tower` over an ops.fq.Field:
`DEVICE` (the kernel for CUDA tensors, the plain version for CPU ones) or
`PLAIN`. The module-level names are `DEVICE`'s.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..crypto import bls12_381 as gt
from . import fq as F

# ---------------------------------------------------------------------------
# Host converters
# ---------------------------------------------------------------------------


def fq2_to_limbs(x: gt.Fq2) -> np.ndarray:
    return np.stack([F.to_mont(x.c0), F.to_mont(x.c1)])


def fq2_from_limbs(a) -> gt.Fq2:
    a = np.asarray(a)
    return gt.Fq2(F.from_mont(a[0]), F.from_mont(a[1]))


_FQ2_ONE_NP = fq2_to_limbs(gt.FQ2_ONE)
_FQ12_ONE_NP = np.zeros((2, 3, 2, F.L), dtype=np.int64)
_FQ12_ONE_NP[0, 0, 0] = F.to_mont(1)


# ---------------------------------------------------------------------------
# Symbolic bilinear derivation of the tower product structure
# ---------------------------------------------------------------------------

class _Lin:
    """Sparse integer linear combination over an index space."""

    __slots__ = ("d",)

    def __init__(self, d: Dict[int, int]):
        self.d = {k: v for k, v in d.items() if v != 0}

    def __add__(self, o):
        d = dict(self.d)
        for k, v in o.d.items():
            d[k] = d.get(k, 0) + v
        return _Lin(d)

    def __sub__(self, o):
        d = dict(self.d)
        for k, v in o.d.items():
            d[k] = d.get(k, 0) - v
        return _Lin(d)

    def __neg__(self):
        return _Lin({k: -v for k, v in self.d.items()})


class _SymTower:
    """The tower's Karatsuba multiplication executed symbolically: every
    base-field product becomes a recorded leaf, or is dropped when one
    operand is identically zero (how the sparse-line tables fall out)."""

    def __init__(self):
        self.leaves: List[Tuple[Dict[int, int], Dict[int, int]]] = []

    def leaf(self, x: _Lin, y: _Lin) -> _Lin:
        if not x.d or not y.d:
            return _Lin({})
        for c in list(x.d.values()) + list(y.d.values()):
            if abs(c) > 2:
                raise ValueError("pre-sum coefficient outside the budget")
        self.leaves.append((x.d, y.d))
        return _Lin({len(self.leaves) - 1: 1})

    def mul2(self, a, b):
        a0, a1 = a
        b0, b1 = b
        t0 = self.leaf(a0, b0)
        t1 = self.leaf(a1, b1)
        t2 = self.leaf(a0 + a1, b0 + b1)
        return (t0 - t1, t2 - t0 - t1)

    @staticmethod
    def mul_xi(c):
        c0, c1 = c
        return (c0 - c1, c0 + c1)

    @staticmethod
    def add2(a, b):
        return (a[0] + b[0], a[1] + b[1])

    @staticmethod
    def sub2(a, b):
        return (a[0] - b[0], a[1] - b[1])

    def mul6(self, a, b):
        a0, a1, a2 = a
        b0, b1, b2 = b
        mul2, add2, sub2, mul_xi = self.mul2, self.add2, self.sub2, self.mul_xi
        t0, t1, t2 = mul2(a0, b0), mul2(a1, b1), mul2(a2, b2)
        c0 = add2(t0, mul_xi(sub2(mul2(add2(a1, a2), add2(b1, b2)), add2(t1, t2))))
        c1 = add2(sub2(mul2(add2(a0, a1), add2(b0, b1)), add2(t0, t1)), mul_xi(t2))
        c2 = add2(sub2(mul2(add2(a0, a2), add2(b0, b2)), add2(t0, t2)), t1)
        return (c0, c1, c2)

    def add6(self, a, b):
        return tuple(self.add2(x, y) for x, y in zip(a, b))

    def sub6(self, a, b):
        return tuple(self.sub2(x, y) for x, y in zip(a, b))

    def mul6_by_v(self, a):
        return (self.mul_xi(a[2]), a[0], a[1])

    @staticmethod
    def sym(indices):
        """Symbolic fq12 operand over 12 component indices (None =
        structurally zero). Component order [w j][v i][fq2 h]."""
        def lin(k):
            return _Lin({}) if indices[k] is None else _Lin({indices[k]: 1})
        return tuple(
            tuple((lin(j * 6 + i * 2 + 0), lin(j * 6 + i * 2 + 1))
                  for i in range(3))
            for j in range(2))

    def tables(self, outs, n_a_cols: int, n_b_cols: int):
        n = len(self.leaves)
        alpha = np.zeros((n, n_a_cols), dtype=np.int64)
        beta = np.zeros((n, n_b_cols), dtype=np.int64)
        for k, (xa, xb) in enumerate(self.leaves):
            for idx, c in xa.items():
                alpha[k, idx] = c
            for idx, c in xb.items():
                beta[k, idx] = c
        gamma = np.zeros((len(outs), n), dtype=np.int64)
        for j, lin in enumerate(outs):
            for k, c in lin.d.items():
                gamma[j, k] = c
        return alpha, beta, gamma


def _flatten12(c_lo, c_hi):
    out12 = []
    for six in (c_lo, c_hi):
        for pair in six:
            out12.extend(pair)
    return out12


def _derive_fq12_tables():
    """Full product: 54 leaves."""
    s = _SymTower()
    a0, a1 = s.sym(list(range(12)))
    b0, b1 = s.sym(list(range(12)))
    t0 = s.mul6(a0, b0)
    t1 = s.mul6(a1, b1)
    mid = s.sub6(s.mul6(s.add6(a0, a1), s.add6(b0, b1)), s.add6(t0, t1))
    c_lo = s.add6(t0, s.mul6_by_v(t1))
    return s.tables(_flatten12(c_lo, mid), 12, 12)


def _derive_fq12_sqr_tables():
    """Complex-method squaring over Fq6: t = c0*c1,
    a^2 = ((c0+c1)(c0+v*c1) - t - v*t) + 2t*w -- 36 leaves."""
    s = _SymTower()
    a0, a1 = s.sym(list(range(12)))
    t = s.mul6(a0, a1)
    big = s.mul6(s.add6(a0, a1), s.add6(a0, s.mul6_by_v(a1)))
    c_lo = s.sub6(s.sub6(big, t), s.mul6_by_v(t))
    c_hi = s.add6(t, t)
    return s.tables(_flatten12(c_lo, c_hi), 12, 12)


# Sparse line l = c_a + c_v*v + c_vw*(v*w); b columns are the 6 Fq
# coefficients [c_a.0, c_a.1, c_v.0, c_v.1, c_vw.0, c_vw.1].
_LINE_COLS = [0, 1, 2, 3, None, None, None, None, 4, 5, None, None]


def _derive_fq12_line_tables():
    """The full Karatsuba structure with the line's 6 zero components
    dropped: 39 leaves."""
    s = _SymTower()
    a0, a1 = s.sym(list(range(12)))
    b0, b1 = s.sym(_LINE_COLS)
    t0 = s.mul6(a0, b0)
    t1 = s.mul6(a1, b1)
    mid = s.sub6(s.mul6(s.add6(a0, a1), s.add6(b0, b1)), s.add6(t0, t1))
    c_lo = s.add6(t0, s.mul6_by_v(t1))
    return s.tables(_flatten12(c_lo, mid), 12, 6)


def _derive_fq2_tables():
    """Karatsuba over Fq2: leaves a0 b0, a1 b1, (a0 + a1)(b0 + b1);
    outputs t0 - t1 and t2 - t0 - t1."""
    s = _SymTower()
    a = (_Lin({0: 1}), _Lin({1: 1}))
    return s.tables(list(s.mul2(a, a)), 2, 2)


_ONE_COL = 12      # the cyclotomic squaring's b column holding Montgomery one


def _derive_cyclo_sqr_tables():
    """Granger-Scott squaring in the cyclotomic subgroup over
    Fq4 = Fq2[s]/(s^2 - xi), f = A + B y + C y^2 (y = w, s = w^3):
    A' = 3A^2 - 2conj(A), B' = 3sC^2 + 2conj(B), C' = 3B^2 - 2conj(C).
    Each Fq4 square (x0 + x1 s)^2 = (m1 - m2 - xi m2) + 2 m2 s with
    m1 = (x0 + x1)(x0 + xi x1), m2 = x0 x1: six Fq2 Karatsuba products,
    18 leaves. The +-2z passthrough enters as 12 reduction-free leaves
    z x one (b's column 12 is Montgomery one), so the single output REDC
    also re-reduces it: 30 leaves. Component z_e, the coefficient of w^e,
    is stored at [j = e % 2, i = e // 2], flat index j*6 + i*2 + h, in
    both the input and the output."""
    s = _SymTower()

    def flat(e, h):
        return (e % 2) * 6 + (e // 2) * 2 + h

    z = [(_Lin({flat(e, 0): 1}), _Lin({flat(e, 1): 1})) for e in range(6)]
    pairs = [(z[0], z[3]), (z[1], z[4]), (z[2], z[5])]        # A, B, C
    lhs = [s.add2(x0, x1) for x0, x1 in pairs] + [x0 for x0, _ in pairs]
    rhs = ([s.add2(x0, s.mul_xi(x1)) for x0, x1 in pairs]
           + [x1 for _, x1 in pairs])
    prods = [s.mul2(x, y) for x, y in zip(lhs, rhs)]
    sq = []
    for k in range(3):
        m1, m2 = prods[k], prods[3 + k]
        sq.append((s.sub2(s.sub2(m1, m2), s.mul_xi(m2)), s.add2(m2, m2)))
    A2, B2, C2 = sq
    one = _Lin({_ONE_COL: 1})
    zw = [(s.leaf(c0, one), s.leaf(c1, one)) for c0, c1 in z]

    def x3(t):
        return s.add2(s.add2(t, t), t)

    def x2(t):
        return s.add2(t, t)

    out = [None] * 6
    out[0] = s.sub2(x3(A2[0]), x2(zw[0]))
    out[3] = s.add2(x3(A2[1]), x2(zw[3]))
    out[1] = s.add2(x3(s.mul_xi(C2[1])), x2(zw[1]))
    out[4] = s.sub2(x3(C2[0]), x2(zw[4]))
    out[2] = s.sub2(x3(B2[0]), x2(zw[2]))
    out[5] = s.add2(x3(B2[1]), x2(zw[5]))
    outs = [None] * 12
    for e in range(6):
        for h in range(2):
            outs[flat(e, h)] = out[e][h]
    return s.tables(outs, 12, _ONE_COL + 1)


def _check_budget(alpha, beta, gamma, name: str):
    """Pre-sum fan-in <= 8 and gamma fan-in <= 64: the laziness budget
    that keeps the leaf operands and fq_redc's input columns in range."""
    if (int(np.abs(gamma).sum(axis=1).max()) > 64
            or int(np.abs(alpha).sum(axis=1).max()) > 8
            or int(np.abs(beta).sum(axis=1).max()) > 8):
        raise ValueError(f"{name} tables exceed the fq laziness budget")


def _bilinear_tables(derive, name, kind, **options) -> F.Bilinear:
    alpha, beta, gamma = derive()
    _check_budget(alpha, beta, gamma, name)
    return F.Bilinear(alpha, beta, gamma, name, kind, **options)


# The kernel compiles these five in, in this order (csrc/fq_tables.cuh,
# written by ops/fq_tables_gen.py): TABLES[t.kind] is t.
_FQ2_T = _bilinear_tables(_derive_fq2_tables, "fq2_mul", 0)
_MUL_T = _bilinear_tables(_derive_fq12_tables, "fq12_mul", 1)
_SQR_T = _bilinear_tables(_derive_fq12_sqr_tables, "fq12_sqr", 2)
_LINE_T = _bilinear_tables(_derive_fq12_line_tables, "fq12_mul_line", 3)
_CYCLO_T = _bilinear_tables(_derive_cyclo_sqr_tables, "fq12_cyclo_sqr", 4,
                            norm_in=True, one_col=True)
TABLES = (_FQ2_T, _MUL_T, _SQR_T, _LINE_T, _CYCLO_T)   # then the chain's own kinds (fq.KIND_MUL ...)


# ---------------------------------------------------------------------------
# Chain programs (ops.fq.chain_program): the reference's loops of tower
# products, step for step
# ---------------------------------------------------------------------------

_PROGRAMS: Dict[tuple, np.ndarray] = {}


def pow_abs_program(bits_np: np.ndarray) -> np.ndarray:
    """f^e for a static exponent (MSB first), f cyclotomic, as the
    reference's _pow_abs computes it: per set bit after the MSB, a run of
    cyclotomic squarings and one multiply by f (the base); then the
    squarings of the trailing zeros."""
    key = ("pow", bytes(np.asarray(bits_np, dtype=np.uint8)))
    prog = _PROGRAMS.get(key)
    if prog is None:
        positions = np.nonzero(bits_np)[0]
        if positions.size < 1 or positions[0] != 0:
            raise ValueError("exponent MSB must be set")
        steps, prev = [], 0
        for p in positions[1:]:
            steps += [(_CYCLO_T, F.SRC_ACC)] * int(p - prev) + [(_MUL_T, F.SRC_BASE)]
            prev = int(p)
        steps += [(_CYCLO_T, F.SRC_ACC)] * (int(bits_np.shape[0]) - 1 - prev)
        prog = _PROGRAMS[key] = F.chain_program(steps)
    return prog


def step_name(code) -> str:
    """A chain step's name: its tower product's, or ops.fq.STEP_NAMES'."""
    kind = int(code) & F.KIND_MASK
    return TABLES[kind].name if kind < F.KIND_MUL else F.STEP_NAMES[kind]


def lines_program(n_lines: int, square: bool) -> np.ndarray:
    """The Miller loop's f-update over n_lines sparse lines: (with
    `square`, one Fq12 squaring first, the doubling step) then one line
    multiply by slice p of the lines operand, p = 0 .. n_lines - 1."""
    key = ("lines", n_lines, square)
    prog = _PROGRAMS.get(key)
    if prog is None:
        steps = [(_SQR_T, F.SRC_ACC)] if square else []
        steps += [(_LINE_T, F.SRC_OPERAND + p) for p in range(n_lines)]
        prog = _PROGRAMS[key] = F.chain_program(steps)
    return prog


def fq2_pow_program(bits_np: np.ndarray) -> np.ndarray:
    """a^e on an Fq2 accumulator that starts as one, a the base, per bit
    MSB first: Tower.fq2_sqr, and fq2_mul by the base on a set bit (the
    reference's square-and-select walk, decompress.py:147
    _fq2_pow_static, multiplying only on the set bits)."""
    key = ("fq2_pow", bytes(np.asarray(bits_np, dtype=np.uint8)))
    prog = _PROGRAMS.get(key)
    if prog is None:
        steps = []
        for bit in bits_np:
            steps.append((F.KIND_SQR2, F.SRC_ACC))
            if bit:
                steps.append((_FQ2_T, F.SRC_BASE))
        prog = _PROGRAMS[key] = F.chain_program(steps)
    return prog


def _frob_tables():
    """Basis element v^i w^j = w^(2i+j) picks up xi^((q^k-1)(2i+j)/6)."""
    tables = {}
    for k in (1, 2, 3):
        coeffs = np.zeros((2, 3, 2, F.L), dtype=np.int64)
        for j in range(2):
            for i in range(3):
                e = 2 * i + j
                coeffs[j, i] = fq2_to_limbs(gt.XI ** ((gt.q ** k - 1) * e // 6))
        tables[k] = coeffs
    return tables


_FROB = _frob_tables()


# ---------------------------------------------------------------------------
# Reduction-free layer: linear ops and layouts
# ---------------------------------------------------------------------------

def fq2(c0, c1):
    return torch.stack([c0, c1], dim=-2)


def fq2_add(a, b):
    return a + b


def fq2_sub(a, b):
    return a - b


def fq2_neg(a):
    return -a


def fq2_conj(a):
    return torch.cat([a[..., 0:1, :], -a[..., 1:2, :]], dim=-2)


def fq2_mul_xi(a):
    """(1 + u)(c0 + c1 u) = (c0 - c1) + (c0 + c1) u."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return fq2(a0 - a1, a0 + a1)


def fq2_select(cond, a, b):
    return torch.where(cond[..., None, None], a, b)


def fq2_zeros(shape, device):
    return torch.zeros(tuple(shape) + (2, F.L), dtype=torch.int64, device=device)


def fq2_ones(shape, device):
    return F.const(_FQ2_ONE_NP, device).expand(tuple(shape) + (2, F.L))


def fq6(c0, c1, c2):
    return torch.stack([c0, c1, c2], dim=-3)


def _c(a, i):
    return a[..., i, :, :]


def fq6_mul_by_v(a):
    """(c0 + c1 v + c2 v^2) v = c2 xi + c0 v + c1 v^2."""
    return fq6(fq2_mul_xi(_c(a, 2)), _c(a, 0), _c(a, 1))


def fq12(c0, c1):
    return torch.stack([c0, c1], dim=-4)


def _h(a, i):
    return a[..., i, :, :, :]


def fq12_conj(a):
    return torch.cat([a[..., 0:1, :, :, :], -a[..., 1:2, :, :, :]], dim=-4)


def fq12_ones(shape, device):
    return F.const(_FQ12_ONE_NP, device).expand(tuple(shape) + (2, 3, 2, F.L))


# ---------------------------------------------------------------------------
# The tower over one field route
# ---------------------------------------------------------------------------

class Tower:
    """Fq2/Fq6/Fq12 operations that reduce, over a Field's mul/redc."""

    def __init__(self, field: F.Field):
        self.F = field

    # -- Fq2 -----------------------------------------------------------------

    def fq2_mul(self, a, b):
        """Karatsuba: 3 leaves, the 2 recombined coefficients reduce once
        each."""
        return self.F.bilinear(a, b, _FQ2_T)

    def fq2_sqr(self, a):
        """(a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u."""
        return F.fq2_sqr_by(self.F.mul, a)

    def fq2_pow_static(self, a, bits_np):
        """a^e, e a static bit array (MSB first): per bit a squaring, and
        a multiply by a on a set bit. One chain (fq2_pow_program) where
        the field chains its powers, else the loop."""
        one = fq2_ones(a.shape[:-2], a.device)
        if self.F.chain_powers:
            return self.F.bilinear_chain(one, fq2_pow_program(bits_np), TABLES, a)
        acc = one
        for bit in bits_np:
            acc = self.fq2_sqr(acc)
            if bit:
                acc = self.fq2_mul(acc, a)
        return acc

    def fq2_scale(self, a, s):
        """a * s, s an Fq element [..., L]."""
        return self.F.mul(a, s[..., None, :])

    def fq2_inv(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        pair = torch.stack([a0, a1], dim=-2)
        nrm = self.F.mul(pair, pair)
        inv_norm = self.F.inv(nrm[..., 0, :] + nrm[..., 1, :])
        out = self.F.mul(pair, inv_norm[..., None, :])
        return fq2(out[..., 0, :], -out[..., 1, :])

    def fq2_is_zero(self, a):
        return torch.all(self.F.is_zero(a), dim=-1)

    def fq2_eq(self, a, b):
        return torch.all(self.F.is_zero(a - b), dim=-1)

    # -- Fq6 -----------------------------------------------------------------

    def fq6_mul(self, a, b):
        m = self.fq2_mul
        a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
        b0, b1, b2 = _c(b, 0), _c(b, 1), _c(b, 2)
        t0, t1, t2 = m(a0, b0), m(a1, b1), m(a2, b2)
        c0 = t0 + fq2_mul_xi(m(a1 + a2, b1 + b2) - (t1 + t2))
        c1 = (m(a0 + a1, b0 + b1) - (t0 + t1)) + fq2_mul_xi(t2)
        c2 = (m(a0 + a2, b0 + b2) - (t0 + t2)) + t1
        return fq6(c0, c1, c2)

    def fq6_sqr(self, a):
        return self.fq6_mul(a, a)

    def fq6_scale_fq2(self, a, s):
        return self.fq2_mul(a, s[..., None, :, :])

    def fq6_inv(self, a):
        m, sq = self.fq2_mul, self.fq2_sqr
        a0, a1, a2 = _c(a, 0), _c(a, 1), _c(a, 2)
        t0 = sq(a0) - fq2_mul_xi(m(a1, a2))
        t1 = fq2_mul_xi(sq(a2)) - m(a0, a1)
        t2 = sq(a1) - m(a0, a2)
        denom = m(a0, t0) + fq2_mul_xi(m(a2, t1) + m(a1, t2))
        inv_d = self.fq2_inv(denom)
        return fq6(m(t0, inv_d), m(t1, inv_d), m(t2, inv_d))

    # -- Fq12 ----------------------------------------------------------------

    def _fq12_product(self, tables, av, bv):
        """One bilinear product over [..., 12, L] coefficient views ->
        [..., 2, 3, 2, L]."""
        cv = self.F.bilinear(av, bv, tables)
        return cv.reshape(cv.shape[:-2] + (2, 3, 2, F.L))

    def fq12_mul(self, a, b):
        """54 leaves, 12 REDC lanes, one bilinear product."""
        return self._fq12_product(_MUL_T, a.reshape(a.shape[:-4] + (12, F.L)),
                                  b.reshape(b.shape[:-4] + (12, F.L)))

    def fq12_sqr(self, a):
        """Complex-method squaring: 36 leaves, 12 REDC lanes."""
        av = a.reshape(a.shape[:-4] + (12, F.L))
        return self._fq12_product(_SQR_T, av, av)

    def fq12_mul_line(self, f, c_a, c_v, c_vw):
        """f * (c_a + c_v*v + c_vw*(v*w)), the Miller-loop line multiply:
        39 leaves, 12 REDC lanes. c_* are Fq2 [..., 2, L]."""
        fv = f.reshape(f.shape[:-4] + (12, F.L))
        bv = torch.cat([c_a, c_v, c_vw], dim=-2)             # [..., 6, L]
        return self._fq12_product(_LINE_T, fv, bv)

    def fq12_cyclo_sqr(self, a):
        """Granger-Scott squaring in the cyclotomic subgroup (valid for
        elements past the final exponentiation's easy part): 30 leaves,
        12 REDC lanes. The input's three carry rounds (the reference's
        fq_norm before the leaves) are the tables' norm_in, inside the
        product, and Montgomery one is their extra b column."""
        av = a.reshape(a.shape[:-4] + (12, F.L))
        return self._fq12_product(_CYCLO_T, av, av)

    def _fq12_chain(self, f, program, base=None, operand=None):
        """One chain on the Fq12 accumulator f [..., 2, 3, 2, L]."""
        fv = f.reshape(f.shape[:-4] + (12, F.L))
        bv = None if base is None else base.reshape(base.shape[:-4] + (12, F.L))
        cv = self.F.bilinear_chain(fv, program, TABLES, bv, operand)
        return cv.reshape(cv.shape[:-2] + (2, 3, 2, F.L))

    def fq12_pow_abs(self, f, bits_np):
        """f^e, e a static exponent (bit array, MSB first), f in the
        cyclotomic subgroup: the reference's _pow_abs (runs of Granger-Scott
        squarings, one multiply by f per set bit) as one chain."""
        return self._fq12_chain(f, pow_abs_program(bits_np), base=f)

    def fq12_sqr_mul_lines(self, f, c_a, c_v, c_vw):
        """The Miller loop's doubling-step update, f^2 * l_0 * ... *
        l_{P-1}, as one chain: c_* [..., P, 2, L], line p's coefficients
        at [..., p, :, :]."""
        return self._fq12_chain(f, lines_program(c_a.shape[-3], True),
                                operand=torch.cat([c_a, c_v, c_vw], dim=-2))

    def fq12_mul_lines(self, f, c_a, c_v, c_vw):
        """The addition step's update, f * l_0 * ... * l_{P-1}, as one
        chain."""
        return self._fq12_chain(f, lines_program(c_a.shape[-3], False),
                                operand=torch.cat([c_a, c_v, c_vw], dim=-2))

    fq12_conj = staticmethod(fq12_conj)

    def fq12_inv(self, a):
        a0, a1 = _h(a, 0), _h(a, 1)
        denom = self.fq6_mul(a0, a0) - fq6_mul_by_v(self.fq6_mul(a1, a1))
        inv_d = self.fq6_inv(denom)
        return fq12(self.fq6_mul(a0, inv_d), -self.fq6_mul(a1, inv_d))

    def fq12_eq(self, a, b):
        return torch.all(self.F.is_zero(a - b), dim=-1).all(-1).all(-1)

    def fq12_frobenius(self, a, k: int):
        if k % 2 == 1:
            c = torch.cat([a[..., 0:1, :], -a[..., 1:2, :]], dim=-2)
        else:
            c = a
        return self.fq2_mul(c, F.const(_FROB[k], a.device))


DEVICE = Tower(F.DEVICE)
PLAIN = Tower(F.PLAIN)

fq2_mul = DEVICE.fq2_mul
fq2_sqr = DEVICE.fq2_sqr
fq2_scale = DEVICE.fq2_scale
fq2_inv = DEVICE.fq2_inv
fq2_pow_static = DEVICE.fq2_pow_static
fq2_is_zero = DEVICE.fq2_is_zero
fq2_eq = DEVICE.fq2_eq
fq6_mul = DEVICE.fq6_mul
fq6_sqr = DEVICE.fq6_sqr
fq6_scale_fq2 = DEVICE.fq6_scale_fq2
fq6_inv = DEVICE.fq6_inv
fq12_mul = DEVICE.fq12_mul
fq12_sqr = DEVICE.fq12_sqr
fq12_mul_line = DEVICE.fq12_mul_line
fq12_cyclo_sqr = DEVICE.fq12_cyclo_sqr
fq12_pow_abs = DEVICE.fq12_pow_abs
fq12_sqr_mul_lines = DEVICE.fq12_sqr_mul_lines
fq12_mul_lines = DEVICE.fq12_mul_lines
fq12_inv = DEVICE.fq12_inv
fq12_eq = DEVICE.fq12_eq
fq12_frobenius = DEVICE.fq12_frobenius
