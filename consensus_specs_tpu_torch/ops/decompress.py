"""Batched G1/G2 point decompression on torch tensors (port of
consensus_specs_tpu/ops/decompress.py).

The byte parse is vectorized numpy (flags, x mod 2^381 into 29-bit limbs);
the field math -- Montgomery lift, y^2 = x^3 + b, the square root by a
static-exponent power, the sign choice -- runs batched on the device. The
accepted and rejected encodings are the bignum grammar's exactly
(crypto/bls12_381.py decompress_g1/decompress_g2): c flag set, infinity
iff b with a = 0 and x = 0, x < q, on the curve; for G2 the second half's
flag bits clear.

Where the reference's G2 ladder selects per bit of the static exponent,
the port multiplies only on the set bits (a host branch on a host bit):
the same values reach the same operations.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..crypto import bls12_381 as gt
from ..device import resolve
from . import fq as F
from . import fq_tower as T

_FLAG_A = 0x20
_FLAG_B = 0x40
_FLAG_C = 0x80

_HALF_Q_NP = F.int_to_limbs((F.Q - 1) // 2)        # y > (q-1)/2 <=> a_flag 1
_R2_NP = F.int_to_limbs(F.R2_MONT)
_ONE_RAW_NP = F.int_to_limbs(1)                    # Montgomery-mul by this = mont -> raw
_FOUR_MONT_NP = F.to_mont(4)


# ---------------------------------------------------------------------------
# Host: vectorized byte parsing
# ---------------------------------------------------------------------------

def parse_g1_bytes(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]:
    """[N, 48] uint8 big-endian compressed points ->
    (x_limbs [N, L] int64 raw (not Montgomery), a_flag [N] bool,
     is_infinity [N] bool, wellformed [N] bool).

    wellformed covers the flag grammar only; x < q and the curve check
    need field math and happen on the device."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    top = data[:, 0]
    c_flag = (top & _FLAG_C) != 0
    b_flag = (top & _FLAG_B) != 0
    a_flag = (top & _FLAG_A) != 0

    stripped = data.copy()
    stripped[:, 0] &= 0x1F                        # x = z mod 2^381
    le = stripped[:, ::-1].copy()                 # byte 0 = LSB
    words = le.view("<u8").reshape(n, 6)          # w[j] = bits [64j, 64j+64)
    limbs = np.zeros((n, F.L), dtype=np.int64)
    for i in range(F.L):
        bit = F.B * i
        j, off = bit // 64, bit % 64
        lo = words[:, j] >> np.uint64(off)
        if off > 64 - F.B and j + 1 < 6:
            lo = lo | (words[:, j + 1] << np.uint64(64 - off))
        limbs[:, i] = (lo & np.uint64(F.MASK)).astype(np.int64)

    x_is_zero = ~np.any(limbs, axis=1)
    is_infinity = b_flag
    wellformed = c_flag & (~b_flag | (~a_flag & x_is_zero))
    return limbs, a_flag, is_infinity, wellformed


def parse_g2_bytes(data: np.ndarray):
    """[N, 96] uint8 -> (x_limbs [N, 2, L] raw (c0, c1), a_flag1 [N] bool,
    is_infinity [N] bool, wellformed [N] bool). The wire order is
    z1 (flags | x.c1) || z2 (x.c0)."""
    data = np.asarray(data, dtype=np.uint8)
    c1_limbs, a_flag1, b_flag1, wf1 = parse_g1_bytes(data[:, :48])
    z2_top_clear = (data[:, 48] & 0xE0) == 0
    c0_limbs, _, _, _ = parse_g1_bytes(
        np.concatenate([data[:, 48:49] & 0x1F, data[:, 49:]], axis=1))
    c0_zero = ~np.any(c0_limbs, axis=1)
    wellformed = wf1 & z2_top_clear & (~b_flag1 | c0_zero)
    x = np.stack([c0_limbs, c1_limbs], axis=1)
    return x, a_flag1, b_flag1, wellformed


# ---------------------------------------------------------------------------
# Device: lift, square root, sign
# ---------------------------------------------------------------------------

def _fq_gt(a_canon, b_limbs_np: np.ndarray):
    """canonical limbs a > constant b, lexicographic from the top limb."""
    gt_ = torch.zeros(a_canon.shape[:-1], dtype=torch.bool, device=a_canon.device)
    eq = torch.ones(a_canon.shape[:-1], dtype=torch.bool, device=a_canon.device)
    for i in range(F.L - 1, -1, -1):
        ai = a_canon[..., i]
        b = int(b_limbs_np[i])
        gt_ = gt_ | (eq & (ai > b))
        eq = eq & (ai == b)
    return gt_


def _lt_q(x_raw):
    """Raw limbs x < q: the sign of the fully propagated x - q."""
    d = F._carry_rounds(x_raw - F.const(F._Q_NP, x_raw.device), F.NORM_FULL)
    return d[..., -1] < 0


def _g1_decompress_traced(x_raw, a_flag):
    """x_raw [..., L] raw limbs, a_flag [...] bool ->
    (x_mont, y_mont [..., L], valid [...] bool), valid = x < q and on the
    curve. The flag grammar is the host's (parse_g1_bytes)."""
    dev = x_raw.device
    x_lt_q = _lt_q(x_raw)
    x = F.fq_mul(x_raw, F.const(_R2_NP, dev))             # Montgomery lift
    y2 = F.fq_mul(F.fq_sqr(x), x) + F.const(_FOUR_MONT_NP, dev)
    y = F.fq_sqrt_candidate(y2)
    on_curve = F.fq_is_zero(F.fq_sqr(y) - y2)
    y_canon = F.fq_canon(F.fq_mul(y, F.const(_ONE_RAW_NP, dev)))
    flip = _fq_gt(y_canon, _HALF_Q_NP) != a_flag
    y = F.fq_select(flip, -y, y)
    return x, y, x_lt_q & on_curve


def _g2_constants():
    """The 4 even eighth roots of unity, the inverses of their square
    roots (the fourth roots the candidate divides by), and G2_B."""
    even_roots = [gt.EIGHTH_ROOTS[k] for k in (0, 2, 4, 6)]
    fourth_inv = [gt.FQ2_ONE / gt.EIGHTH_ROOTS[k] for k in (0, 1, 2, 3)]
    return ([T.fq2_to_limbs(r) for r in even_roots],
            [T.fq2_to_limbs(r) for r in fourth_inv],
            T.fq2_to_limbs(gt.G2_B))


_EVEN_ROOTS_NP, _FOURTH_INV_NP, _G2_B_NP = _g2_constants()
_SQRT2_EXP_BITS = F._exp_bits((gt.q ** 2 + 7) // 16)


def _fq2_pow_static(a, bits_np: np.ndarray):
    """a^e, per bit MSB first: square, and multiply on a set bit; one
    chain launch for a CUDA tensor (Tower.fq2_pow_static)."""
    return T.fq2_pow_static(a, bits_np)


def _fq2_sign_flip(y, a_flag):
    """Whether to negate y so the result equals the bignum
    modular_squareroot-then-a_flag composition: for c1 != 0,
    (c1 > (q-1)/2) == a_flag after the flip; for c1 == 0 the flag is
    insensitive and (c0 > (q-1)/2) == NOT a_flag."""
    raw = F.fq_mul(y, F.const(_ONE_RAW_NP, y.device))
    c0 = F.fq_canon(raw[..., 0, :])
    c1 = F.fq_canon(raw[..., 1, :])
    c1_zero = ~torch.any(c1 != 0, dim=-1)
    c0_gt = _fq_gt(c0, _HALF_Q_NP)
    c1_gt = _fq_gt(c1, _HALF_Q_NP)
    return torch.where(c1_zero, c0_gt == a_flag, c1_gt != a_flag)


def _g2_decompress_traced(x_raw, a_flag):
    """x_raw [N, 2, L] raw limbs (c0, c1), a_flag [N] bool ->
    (x_mont, y_mont [N, 2, L], valid [N] bool)."""
    dev = x_raw.device
    x_lt_q = _lt_q(x_raw[:, 0]) & _lt_q(x_raw[:, 1])
    r2 = F.const(_R2_NP, dev)
    x = T.fq2(F.fq_mul(x_raw[:, 0], r2), F.fq_mul(x_raw[:, 1], r2))
    y2 = T.fq2_mul(T.fq2_sqr(x), x) + F.const(_G2_B_NP, dev)

    cand = _fq2_pow_static(y2, _SQRT2_EXP_BITS)      # y2^((q^2+7)/16)
    check = T.fq2_mul(T.fq2_sqr(cand), T.fq2_inv(y2))

    # which even eighth root the check equals (if any) picks the fourth
    # root to divide out; no match = not a square = off the curve
    y = torch.zeros_like(cand)
    matched = torch.zeros(cand.shape[0], dtype=torch.bool, device=dev)
    for k in range(4):
        hit = T.fq2_eq(check, F.const(_EVEN_ROOTS_NP[k], dev))
        yk = T.fq2_mul(cand, F.const(_FOURTH_INV_NP[k], dev))
        y = T.fq2_select(hit & ~matched, yk, y)
        matched = matched | hit

    y = T.fq2_select(_fq2_sign_flip(y, a_flag), -y, y)
    return x, y, x_lt_q & matched


def g1_decompress_batch(data: np.ndarray, device="cuda"):
    """[N, 48] uint8 -> (x_mont [N, L], y_mont [N, L] on `device`, valid
    [N] bool, is_infinity [N] bool as numpy). valid is False for any
    malformed encoding; infinity reports valid with is_infinity set."""
    dev = resolve(device)
    limbs, a_flag, is_inf, wellformed = parse_g1_bytes(data)
    x, y, valid = _g1_decompress_traced(
        torch.from_numpy(limbs).to(dev), torch.from_numpy(a_flag).to(dev))
    valid = valid.cpu().numpy() & wellformed & ~is_inf
    return x, y, valid | (wellformed & is_inf), is_inf


def g2_decompress_batch(data: np.ndarray, device="cuda"):
    """[N, 96] uint8 -> (x_mont [N, 2, L], y_mont [N, 2, L] on `device`,
    valid [N], is_infinity [N] numpy bools), the bignum grammar's
    accept/reject set."""
    dev = resolve(device)
    x_raw, a_flag, is_inf, wellformed = parse_g2_bytes(data)
    x, y, valid = _g2_decompress_traced(
        torch.from_numpy(x_raw).to(dev), torch.from_numpy(a_flag).to(dev))
    valid = valid.cpu().numpy() & wellformed & ~is_inf
    return x, y, valid | (wellformed & is_inf), is_inf
