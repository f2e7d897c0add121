"""Jacobian point ops and windowed signed-digit scalar multiplication over
a generic field-ops namespace `fo` (port of
consensus_specs_tpu/ops/scalar_mul.py, its default windowed backend at
w = 4).

`fo` provides mul, sqr, add, sub, neg, inv, select, is_zero, zeros(batch,
device), ones(batch, device) and val_ndim (1 for Fq, 2 for Fq2);
ops/bls_torch.py builds G1_OPS and G2_OPS.

The scalar is a host int at every call site, so its Joye-Tunstall
recoding runs in exact host arithmetic: odd k' = k or k + 1 becomes
ceil(nbits/w) + 1 odd digits in {+-1, .., +-(2^w - 1)}. The device side
builds the odd multiples [1P, 3P, .., (2^w - 1)P], then runs m - 1 trips
of w doublings and one table add. Where the reference selects on traced
digits (the sign of a digit, the even-k fixup), the port branches in
Python on the host digit: the same values reach the same operations.

`jac_scalar_mul` (double-and-add over `scalar_bits`) is the plain oracle
the windowed multiply is held against, and `sequential_adds` /
`sequential_doubles` its cost model; no entry point selects it, and
there is no backend switch or window knob.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Jacobian point ops (a = 0 curves)
# ---------------------------------------------------------------------------

def jac_infinity(fo, batch, device):
    """The point at infinity: (0, 1, 0)."""
    return (fo.zeros(batch, device), fo.ones(batch, device),
            fo.zeros(batch, device))


def jac_double(fo, p):
    """2P; P = O and Y = 0 give Z3 = 2YZ = 0."""
    X, Y, Z = p
    A = fo.sqr(X)
    B = fo.sqr(Y)
    C = fo.sqr(B)
    D = fo.sub(fo.sqr(fo.add(X, B)), fo.add(A, C))
    D = fo.add(D, D)
    E = fo.add(fo.add(A, A), A)
    Fv = fo.sqr(E)
    X3 = fo.sub(Fv, fo.add(D, D))
    C8 = fo.add(C, C)
    C8 = fo.add(C8, C8)
    C8 = fo.add(C8, C8)
    Y3 = fo.sub(fo.mul(E, fo.sub(D, X3)), C8)
    Z3 = fo.mul(Y, Z)
    Z3 = fo.add(Z3, Z3)
    return (X3, Y3, Z3)


def jac_add(fo, p1, p2):
    """P1 + P2 with every special case (either infinity, P1 == P2 ->
    double, P1 == -P2 -> infinity) resolved by selects, batch-wise."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    inf1 = fo.is_zero(Z1)
    inf2 = fo.is_zero(Z2)
    Z1Z1 = fo.sqr(Z1)
    Z2Z2 = fo.sqr(Z2)
    U1 = fo.mul(X1, Z2Z2)
    U2 = fo.mul(X2, Z1Z1)
    S1 = fo.mul(fo.mul(Y1, Z2), Z2Z2)
    S2 = fo.mul(fo.mul(Y2, Z1), Z1Z1)
    H = fo.sub(U2, U1)
    Rr = fo.sub(S2, S1)
    Rr = fo.add(Rr, Rr)
    h_zero = fo.is_zero(H)
    r_zero = fo.is_zero(Rr)
    H2 = fo.add(H, H)
    I = fo.sqr(H2)  # noqa: E741
    J = fo.mul(H, I)
    V = fo.mul(U1, I)
    X3 = fo.sub(fo.sub(fo.sqr(Rr), J), fo.add(V, V))
    S1J = fo.mul(S1, J)
    Y3 = fo.sub(fo.mul(Rr, fo.sub(V, X3)), fo.add(S1J, S1J))
    Z3 = fo.mul(fo.sub(fo.sqr(fo.add(Z1, Z2)), fo.add(Z1Z1, Z2Z2)), H)
    out = (X3, Y3, Z3)
    dbl = jac_double(fo, p1)
    batch = X1.shape[:-fo.val_ndim]
    inf = jac_infinity(fo, batch, X1.device)
    both = ~inf1 & ~inf2
    out = tuple(fo.select(both & h_zero & r_zero, d, o) for d, o in zip(dbl, out))
    out = tuple(fo.select(both & h_zero & ~r_zero, i, o) for i, o in zip(inf, out))
    out = tuple(fo.select(inf1, b, o) for b, o in zip(p2, out))
    out = tuple(fo.select(inf2, a, o) for a, o in zip(p1, out))
    return out


def jac_to_affine(fo, p):
    """Jacobian -> (x, y, is_infinity); x/y are garbage when infinite."""
    X, Y, Z = p
    zi = fo.inv(Z)
    zi2 = fo.sqr(zi)
    x = fo.mul(X, zi2)
    y = fo.mul(Y, fo.mul(zi2, zi))
    return x, y, fo.is_zero(Z)


def _lift_affine(fo, aff, inf=None):
    """Affine (x, y) -> Jacobian (x, y, 1); elements flagged in `inf` lift
    to z = 0 instead."""
    x, y = aff
    batch = x.shape[:-fo.val_ndim]
    z = fo.ones(batch, x.device)
    if inf is not None:
        z = fo.select(inf, fo.zeros(batch, x.device), z)
    return (x, y, z)


def jac_scalar_mul(fo, aff, bits, inf=None):
    """[k]P for affine P, k given MSB-first as an [nbits] host bit array
    (scalar_bits): double-and-add, the plain oracle of the windowed
    multiply. No entry point selects it. Where the reference selects the
    add on a traced bit, the port branches on the host bit: the kept value
    is the same."""
    lifted = _lift_affine(fo, aff, inf)
    acc = jac_infinity(fo, lifted[0].shape[:-fo.val_ndim], lifted[0].device)
    for bit in np.asarray(bits):
        acc = jac_double(fo, acc)
        if bit == 1:
            acc = jac_add(fo, acc, lifted)
    return acc


# ---------------------------------------------------------------------------
# Host recoding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def scalar_bits(k: int, width: int = 256) -> np.ndarray:
    """MSB-first [width] uint8 bit array of k (read-only, memoized): the
    double-and-add input."""
    if not 0 <= k < (1 << width):
        raise ValueError(f"scalar {k} out of range for {width} bits")
    raw = np.frombuffer(int(k).to_bytes((width + 7) // 8, "big"), np.uint8)
    bits = np.unpackbits(raw)[-width:]
    bits.flags.writeable = False
    return bits


class SignedWindows(NamedTuple):
    """Host-recoded signed windows of one scalar, MSB window first."""
    idx: np.ndarray        # [m] int32: odd-multiple table index (|d| - 1) / 2
    sign: np.ndarray       # [m] int32: +1 / -1
    correction: bool       # subtract P once after the loop (k was even)
    w: int
    nbits: int


def n_windows(nbits: int, w: int) -> int:
    """Digit count of the fixed-length recoding: ceil(nbits/w) + 1."""
    return -(-nbits // w) + 1


@functools.lru_cache(maxsize=256)
def recode_signed_windows(k: int, nbits: int, w: int) -> SignedWindows:
    """Fixed-length Joye-Tunstall recoding of k over `nbits`: k' = k (odd)
    or k + 1 (even, correction set) becomes n_windows(nbits, w) odd digits
    d_i = (k' mod 2^{w+1}) - 2^w, k' <- (k' - d_i) / 2^w; the last is +1.
    The reconstruction is checked in exact host arithmetic."""
    if not (w >= 1 and 0 <= k < (1 << nbits)):
        raise ValueError(f"scalar {k} out of range for {nbits} bits, w={w}")
    correction = (k % 2 == 0)
    n = k + 1 if correction else k
    m = n_windows(nbits, w)
    digits = []
    for _ in range(m - 1):
        d = (n & ((1 << (w + 1)) - 1)) - (1 << w)
        digits.append(d)
        n = (n - d) >> w
    digits.append(n)
    value = 0
    for d in reversed(digits):
        value = (value << w) + d
    if n != 1 or value != (k + 1 if correction else k) or any(
            d % 2 == 0 or abs(d) >= (1 << w) for d in digits):
        raise AssertionError(f"recoding of {k} failed")
    digits_msb = np.array(digits[::-1], dtype=np.int64)
    idx = ((np.abs(digits_msb) - 1) // 2).astype(np.int32)
    sign = np.where(digits_msb < 0, -1, 1).astype(np.int32)
    idx.flags.writeable = False
    sign.flags.writeable = False
    return SignedWindows(idx, sign, correction, w, nbits)


# ---------------------------------------------------------------------------
# Device loop
# ---------------------------------------------------------------------------

def build_odd_multiples(fo, p_jac, w: int):
    """[1P, 3P, .., (2^w - 1)P] for a batched Jacobian P: one doubling
    (2P) and a 2^{w-1} - 1 add chain, as a list of Jacobian points."""
    entries = [p_jac]
    if 2 ** (w - 1) > 1:
        p2 = jac_double(fo, p_jac)
        for _ in range(2 ** (w - 1) - 1):
            entries.append(jac_add(fo, entries[-1], p2))
    return entries


def windowed_scalar_mul(fo, aff, rec: SignedWindows, inf=None):
    """[k]P for an affine batch aff = (x, y) and one host-recoded scalar
    (Jacobian out). `inf` marks batch elements that are the point at
    infinity."""
    lifted = _lift_affine(fo, aff, inf)
    table = build_odd_multiples(fo, lifted, rec.w)

    def entry(i):
        tx, ty, tz = table[int(rec.idx[i])]
        if rec.sign[i] < 0:
            ty = fo.neg(ty)
        return (tx, ty, tz)

    acc = entry(0)
    for i in range(1, int(rec.idx.shape[0])):
        for _ in range(rec.w):
            acc = jac_double(fo, acc)
        acc = jac_add(fo, acc, entry(i))
    if rec.correction:
        acc = jac_add(fo, acc, (lifted[0], fo.neg(lifted[1]), lifted[2]))
    return acc


# ---------------------------------------------------------------------------
# Cost model: the dependent chains of one scalar multiply
# ---------------------------------------------------------------------------

def sequential_adds(backend: str, nbits: int, w: Optional[int] = None) -> int:
    """Length of the dependent jac_add chain of one scalar multiply:
    "double_add" (jac_scalar_mul) or "window" (windowed_scalar_mul, w)."""
    if backend == "double_add":
        return nbits
    assert backend == "window" and w is not None
    return (2 ** (w - 1) - 1) + (n_windows(nbits, w) - 1) + 1


def sequential_doubles(backend: str, nbits: int, w: Optional[int] = None) -> int:
    """Dependent jac_double chain length (the windowed multiply pays up to
    w - 1 extra from rounding nbits up to whole windows, plus the table's
    2P)."""
    if backend == "double_add":
        return nbits
    assert backend == "window" and w is not None
    return (1 if w > 1 else 0) + w * (n_windows(nbits, w) - 1)
