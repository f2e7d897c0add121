"""Exact uint64/128-bit integer helpers on int64 tensors
(port of consensus_specs_tpu/ops/intmath.py).

torch has no uint64 arithmetic, so a uint64 lives in an int64 tensor as
its bit pattern. Addition, subtraction, multiplication (mod 2**64), and/or/
xor and left shift are the same on both readings; what differs is made
explicit here: unsigned compare and min/max (flip the sign bit), the
unsigned sort key, the logical right shift, and unsigned division.
"""
from __future__ import annotations

import torch

_SIGN = -(1 << 63)            # the int64 with only bit 63 set
_U32_MASK = 0xFFFFFFFF


def u64_key(x: torch.Tensor) -> torch.Tensor:
    """Signed key whose order is x's unsigned order (x ^ 1 << 63)."""
    return x ^ _SIGN


def ult(a, b) -> torch.Tensor:
    return u64_key(a) < u64_key(b)


def ule(a, b) -> torch.Tensor:
    return u64_key(a) <= u64_key(b)


def umax(a, b) -> torch.Tensor:
    return torch.where(ult(a, b), b, a)


def umin(a, b) -> torch.Tensor:
    return torch.where(ult(a, b), a, b)


def umax_reduce(x: torch.Tensor) -> torch.Tensor:
    """Unsigned max over a non-empty 1-D tensor."""
    return u64_key(u64_key(x).max())


def ushr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of uint64 bit patterns by a constant 0 <= k < 64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def udivmod_u64(n: torch.Tensor, d):
    """Unsigned (n // d, n % d) for uint64 bit patterns, d >= 1.

    d >= 2**63: the quotient is 0 or 1. d < 2**63: divide the
    non-negative n >> 1 (logical) by d, double, and correct once — the
    remainder of that estimate is below 2d, so one compare settles it."""
    d = torch.as_tensor(d, dtype=torch.int64, device=n.device)
    big = d < 0
    q_big = ule(d, n).to(torch.int64)
    d_small = torch.where(big, torch.ones_like(d), d)
    q = (ushr(n, 1) // d_small) << 1
    r = n - q * d_small
    fix = ule(d_small, r)
    q = torch.where(fix, q + 1, q)
    q = torch.where(big, q_big, q)
    r = n - q * d
    return q, r


def mulwide_u64(a: torch.Tensor, b: torch.Tensor):
    """Full 64x64 -> 128 product of uint64 bit patterns, as (hi, lo)."""
    a0 = a & _U32_MASK
    a1 = ushr(a, 32)
    b0 = b & _U32_MASK
    b1 = ushr(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + p10
    carry_mid = ult(mid, p01).to(torch.int64)          # wrapped past 2**64
    lo = p00 + (mid << 32)
    carry_lo = ult(lo, p00).to(torch.int64)
    hi = p11 + ushr(mid, 32) + (carry_mid << 32) + carry_lo
    return hi, lo


def muldiv_u64(a: torch.Tensor, b: torch.Tensor, d) -> torch.Tensor:
    """Exact a * b // d through the 128-bit product, d >= 1; the caller
    guarantees the quotient fits 64 bits. Restoring division over the
    low word, the remainder seeded with hi mod d (the reference's
    insurance for hi >= d, kept so every input gives its result)."""
    hi, lo = mulwide_u64(a, b)
    d = torch.as_tensor(d, dtype=torch.int64, device=hi.device)
    _, rem = udivmod_u64(hi, d)
    quot = torch.zeros_like(hi)
    for i in range(64):
        bit = (lo >> (63 - i)) & 1
        top = ushr(rem, 63)                       # bit shifted past 64
        rem2 = (rem << 1) | bit
        ge = (top == 1) | ule(d, rem2)
        rem = torch.where(ge, rem2 - d, rem2)     # wrapping subtract is exact
        quot = (quot << 1) | ge.to(torch.int64)
    return quot


def isqrt_u64(n: torch.Tensor) -> torch.Tensor:
    """Integer square root of uint64 bit patterns, in the reference's
    operation order: a float64 seed (the correctly rounded value of n,
    its two 32-bit halves summed once), at least 1; three Newton steps
    x <- (x + n // x) >> 1; one step down where x*x > n and one up where
    (x+1)*(x+1) <= n, both products wrapping mod 2**64; 0 for n = 0.

    Exact below (2**32 - 1)**2; from there up the wrapped (x+1)*(x+1)
    gives 2**32, as the reference does (the epoch program's total
    balances never get there)."""
    n = torch.as_tensor(n, dtype=torch.int64)
    as_float = (ushr(n, 32).to(torch.float64) * 4294967296.0
                + (n & _U32_MASK).to(torch.float64))
    x = torch.sqrt(as_float).to(torch.int64)
    x = torch.clamp(x, min=1)
    for _ in range(3):
        # x reaches 0 only where n == 0 (masked below): divide by 1 there
        x = ushr(x + udivmod_u64(n, torch.clamp(x, min=1))[0], 1)
    x = torch.where(ult(n, x * x), x - 1, x)
    up = x + 1
    x = torch.where(ule(up * up, n), up, x)
    return torch.where(n == 0, torch.zeros_like(x), x)
