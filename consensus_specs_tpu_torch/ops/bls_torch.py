"""Batched BLS12-381 curve and pairing on torch tensors, and the signature
backend over them (port of consensus_specs_tpu/ops/bls_jax.py).

The device computes, over the lazy-limb Montgomery tower (ops/fq.py,
ops/fq_tower.py): G1/G2 decompression and aggregation trees, the G2
cofactor multiply of hash-to-G2, the grouped Miller loop (one Fq12
accumulator per group, shared squarings) and one batched final
exponentiation computing f^(3 (q^12 - 1) / r) -- the cube is harmless for
product-is-one checks. The host stages bytes: parsing, the
try-and-increment search of hash-to-G2, compression, int <-> limb.

Algorithms, formulas and operation order are the reference's, so limbs
compare bit for bit with it. What differs:

- The reference's `lax.fori_loop` / `lax.cond` over the static bits of |z|
  and of the exponents are Python loops with Python `if`.
- The reference pads batch shapes to powers of two to bound its jit cache
  (`stage_group_arrays`, the group axis of stage 1, `hash_to_g2_batch`).
  The port runs eagerly and pads the group axis of a grouped pairing only
  (`stage_group_arrays`, copies of the last member, shared by
  `_grouped_pairing_dispatch` and the streaming firehose, so ring offsets
  and occupancy count as in the reference); each group is computed on its
  own lanes, so verdicts and values are unchanged. The committee axis of
  an aggregation tree is padded to a power of two too (with infinity
  points), because the tree halves it; message counts are not padded.
- The pairing functions and g2_scalar_mul take `tower=`:
  `fq_tower.DEVICE` (the default: the hand-written kernels for CUDA
  tensors, the plain versions for CPU tensors) or `fq_tower.PLAIN` (the
  plain versions everywhere), which lets a run on the card hold the
  kernel route against the plain one. Under DEVICE on the card the G2
  ladder of g2_scalar_mul, the grouped Miller loop and the final
  exponentiation are one launch each, and the decompressions' addition
  trees a few (programs of ops/fq_points.py).

TorchBackend has JaxBackend's surface and verdicts; it is not registered
as a backend of the reference.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..crypto import bls12_381 as gt
from ..device import resolve
from . import decompress as decomp
from . import fq as F
from . import fq_tower as T
from . import scalar_mul as SM
from .scalar_mul import jac_add, jac_to_affine

SCALAR_WINDOW = 4
_SMALL = {n: F.to_mont(n) for n in (2, 3, 8, 9, 27, 36)}


# Field-ops namespaces of the point layer (ops/scalar_mul.py): G1 over Fq,
# G2 over Fq2.
G1_OPS = SimpleNamespace(
    mul=F.fq_mul, sqr=F.fq_sqr, add=F.fq_add, sub=F.fq_sub, neg=F.fq_neg,
    inv=F.fq_inv, select=F.fq_select, is_zero=F.fq_is_zero,
    zeros=F.fq_zeros, ones=F.fq_ones, val_ndim=1)

def g2_ops(tower: T.Tower) -> SimpleNamespace:
    """The G2 namespace over a tower's Fq2 arithmetic."""
    return SimpleNamespace(
        mul=tower.fq2_mul, sqr=tower.fq2_sqr, add=T.fq2_add, sub=T.fq2_sub,
        neg=T.fq2_neg, inv=tower.fq2_inv, select=T.fq2_select,
        is_zero=tower.fq2_is_zero, zeros=T.fq2_zeros, ones=T.fq2_ones, val_ndim=2)


G2_OPS = g2_ops(T.DEVICE)


# ---------------------------------------------------------------------------
# Miller loop: R on E'(Fq2) in homogeneous projective coordinates, lines in
# sparse Fq2-coefficient form (scaled by w^3 and Fq2 factors that the final
# exponentiation's easy part kills)
# ---------------------------------------------------------------------------

_Z_TAIL_BITS = [int(b) for b in bin(gt.BLS_X)[3:]]
_Z_BITS = np.frombuffer(bin(gt.BLS_X)[2:].encode(), dtype=np.uint8) - ord("0")
_ZP1_BITS = np.frombuffer(bin(gt.BLS_X + 1)[2:].encode(), dtype=np.uint8) - ord("0")


def _muli(tw: T.Tower, a, n: int):
    """Fq2 element times a small static integer."""
    return tw.fq2_scale(a, F.const(_SMALL[n], a.device))


def _dbl_lines(tw: T.Tower, X, Y, Z, xp, yp):
    """Tangent at R = (X, Y, Z), scaled by 2YZ^2 w^3:
    c_a = 3X^3 - 2Y^2 Z, c_v = -3X^2 Z xp, c_vw = 2YZ^2 yp; and 2R."""
    m, sq = tw.fq2_mul, tw.fq2_sqr
    X2 = sq(X)
    Y2 = sq(Y)
    YZ = m(Y, Z)
    X3c = m(X2, X)
    c_a = _muli(tw, X3c, 3) - _muli(tw, m(Y2, Z), 2)
    c_v = -tw.fq2_scale(_muli(tw, m(X2, Z), 3), xp)
    c_vw = tw.fq2_scale(_muli(tw, m(YZ, Z), 2), yp)
    X4 = sq(X2)
    Z2 = sq(Z)
    Xn = _muli(tw, m(YZ, _muli(tw, X4, 9) - _muli(tw, m(m(X, Y2), Z), 8)), 2)
    Yn = ((_muli(tw, m(m(X3c, Y2), Z), 36) - _muli(tw, m(X4, X2), 27))
          - _muli(tw, m(sq(Y2), Z2), 8))
    Zn = _muli(tw, m(m(Y2, Y), m(Z2, Z)), 8)
    return c_a, c_v, c_vw, Xn, Yn, Zn


def _add_lines(tw: T.Tower, X, Y, Z, xq, yq, xp, yp):
    """Chord through R and Q = (xq, yq), scaled by D w^3 with
    N = Y - yq Z, D = X - xq Z: c_a = N xq - yq D, c_v = -N xp,
    c_vw = D yp; and R + Q."""
    m, sq = tw.fq2_mul, tw.fq2_sqr
    N = Y - m(yq, Z)
    D = X - m(xq, Z)
    c_a = m(N, xq) - m(yq, D)
    c_v = -tw.fq2_scale(N, xp)
    c_vw = tw.fq2_scale(D, yp)
    D2 = sq(D)
    E = (m(sq(N), Z) - m(D2, X)) - m(m(D2, xq), Z)
    Xn = m(D, E)
    Yn = m(N, m(X, D2) - E) - m(Y, m(D2, D))
    Zn = m(m(D2, D), Z)
    return c_a, c_v, c_vw, Xn, Yn, Zn


def miller_loop_batch(g1_aff, g2_aff, tower: T.Tower = T.DEVICE):
    """Independent Miller loops f_{|z|,Q}(P), conjugated for the negative
    parameter. g1_aff [..., 2, L] (x, y) in Fq, g2_aff [..., 2, 2, L] (x, y)
    in Fq2, affine -> [..., 2, 3, 2, L]. The differential oracle of
    miller_loop_grouped."""
    tw = tower
    xp, yp = g1_aff[..., 0, :], g1_aff[..., 1, :]
    xq, yq = g2_aff[..., 0, :, :], g2_aff[..., 1, :, :]
    batch, dev = xp.shape[:-1], xp.device
    f, X, Y, Z = T.fq12_ones(batch, dev), xq, yq, T.fq2_ones(batch, dev)
    for bit in _Z_TAIL_BITS:
        c_a, c_v, c_vw, X, Y, Z = _dbl_lines(tw, X, Y, Z, xp, yp)
        f = tw.fq12_mul_line(tw.fq12_sqr(f), c_a, c_v, c_vw)
        if bit:
            c_a, c_v, c_vw, X, Y, Z = _add_lines(tw, X, Y, Z, xq, yq, xp, yp)
            f = tw.fq12_mul_line(f, c_a, c_v, c_vw)
    return T.fq12_conj(f)


def miller_loop_grouped(g1_aff, g2_aff, tower: T.Tower = T.DEVICE):
    """Shared-squaring multi-pairing: g1 [G, P, 2, L], g2 [G, P, 2, 2, L]
    -> [G, 2, 3, 2, L] with f_g = prod_p f_{|z|,Q_gp}(P_gp): per bit one
    Fq12 squaring per group and P sparse line multiplies, the f-update of
    each step one chain (Tower.fq12_sqr_mul_lines / fq12_mul_lines). For
    CUDA tensors under fq_tower.DEVICE the whole loop is one launch of the
    grouped Miller kernel (ops/fq_points.py), with the same limbs."""
    if tower is T.DEVICE and g1_aff.is_cuda:
        from . import fq_points
        return fq_points.miller_grouped_cuda(g1_aff, g2_aff)
    tw = tower
    xp, yp = g1_aff[..., 0, :], g1_aff[..., 1, :]            # [G, P, L]
    xq, yq = g2_aff[..., 0, :, :], g2_aff[..., 1, :, :]      # [G, P, 2, L]
    G, P, dev = xp.shape[0], xp.shape[1], xp.device
    f, X, Y, Z = T.fq12_ones((G,), dev), xq, yq, T.fq2_ones((G, P), dev)
    for bit in _Z_TAIL_BITS:
        c_a, c_v, c_vw, X, Y, Z = _dbl_lines(tw, X, Y, Z, xp, yp)
        f = tw.fq12_sqr_mul_lines(f, c_a, c_v, c_vw)
        if bit:
            c_a, c_v, c_vw, X, Y, Z = _add_lines(tw, X, Y, Z, xq, yq, xp, yp)
            f = tw.fq12_mul_lines(f, c_a, c_v, c_vw)
    return T.fq12_conj(f)


# ---------------------------------------------------------------------------
# Final exponentiation: f -> f^(3 (q^12 - 1) / r)
# ---------------------------------------------------------------------------

def final_exponentiation_3x(f, tower: T.Tower = T.DEVICE):
    """f^(3 (q^12-1)/r): the easy part by conjugation, inversion and
    Frobenius; the hard part through 3 (q^4-q^2+1)/r =
    (z-1)^2 (z+q) (z^2+q^2-1) + 3 (z < 0), with x^z = conj(x^|z|) in the
    cyclotomic subgroup. `tower` is a Tower, or ops/fq_program.py's
    Recorder (which records these steps into the final exponentiation's
    program). For CUDA tensors under fq_tower.DEVICE it is one launch of
    that program (ops/fq_points.py), with the same limbs."""
    if tower is T.DEVICE and f.is_cuda:
        from . import fq_points
        return fq_points.final_exp_cuda(f)[0]
    tw = tower
    f1 = tw.fq12_mul(tw.fq12_conj(f), tw.fq12_inv(f))      # f^(q^6 - 1)
    f2 = tw.fq12_mul(tw.fq12_frobenius(f1, 2), f1)         # ^(q^2 + 1)

    def pow_zm1(x):                                        # x^(z-1)
        return tw.fq12_conj(tw.fq12_pow_abs(x, _ZP1_BITS))

    a = pow_zm1(pow_zm1(f2))
    b = tw.fq12_mul(tw.fq12_conj(tw.fq12_pow_abs(a, _Z_BITS)),
                    tw.fq12_frobenius(a, 1))
    c = tw.fq12_mul(
        tw.fq12_mul(
            tw.fq12_conj(tw.fq12_pow_abs(tw.fq12_conj(tw.fq12_pow_abs(b, _Z_BITS)),
                                         _Z_BITS)),
            tw.fq12_frobenius(b, 2)),
        tw.fq12_conj(b))
    f2_cubed = tw.fq12_mul(tw.fq12_cyclo_sqr(f2), f2)
    return tw.fq12_mul(c, f2_cubed)


def _grouped_verdict(f, tower: T.Tower = T.DEVICE):
    """[G, 2, 3, 2, L] group Miller values -> [G] bool through one batched
    final exponentiation: one launch of its program for CUDA tensors
    under fq_tower.DEVICE."""
    if tower is T.DEVICE and f.is_cuda:
        from . import fq_points
        return fq_points.final_exp_cuda(f)[1]
    res = final_exponentiation_3x(f, tower)
    return tower.fq12_eq(res, T.fq12_ones((f.shape[0],), f.device))


def _group_product_is_one(fs, tower: T.Tower = T.DEVICE):
    """fs [G, P, 2, 3, 2, L] separate Miller values -> [G] bool: the
    within-group product, then one batched final exponentiation (the
    oracle of the shared-squaring grouped path)."""
    G, P = fs.shape[0], fs.shape[1]
    f = T.fq12_ones((G,), fs.device)
    for p in range(P):
        f = tower.fq12_mul(f, fs[:, p])
    res = final_exponentiation_3x(f, tower)
    return tower.fq12_eq(res, T.fq12_ones((G,), fs.device))


def grouped_pairing_check(g1, g2, tower: T.Tower = T.DEVICE):
    """[G] independent product-of-pairings checks: g1 [G, P, 2, L],
    g2 [G, P, 2, 2, L]; group g passes iff prod_p e(P_gp, Q_gp) == 1.
    For CUDA tensors under fq_tower.DEVICE: two launches, the Miller
    loop's and the final exponentiation's."""
    return _grouped_verdict(miller_loop_grouped(g1, g2, tower), tower)


def pairing_product_is_one(g1_batch, g2_batch, tower: T.Tower = T.DEVICE):
    """prod_i e(P_i, Q_i) == 1 for g1 [N, 2, L], g2 [N, 2, 2, L] -> [1]."""
    return grouped_pairing_check(g1_batch[None], g2_batch[None], tower)


# ---------------------------------------------------------------------------
# Decompression + aggregation trees, scalar multiplication
# ---------------------------------------------------------------------------

def _jacobian_or_infinity(select, x, y, is_inf, one):
    """Affine points -> Jacobian, infinity where flagged ((0, 1, 0))."""
    zero = torch.zeros_like(x)
    one = one.expand(x.shape)
    return (select(is_inf, zero, x), select(is_inf, one, y),
            select(is_inf, zero, one))


def _g1_decompress_aggregate_grouped(x_raw, a_flag, is_inf):
    """Decompression and one addition tree per group: x_raw [G, C, L]
    (C a power of two), flags [G, C] -> (x_aff [G, L], y_aff [G, L],
    inf [G], all_valid [G]). Infinity members add the identity;
    all_valid ANDs the range and curve checks of the others. For CUDA
    tensors the tree and jac_to_affine are programs of the point kernels
    (ops/fq_points.py::point_tree_cuda), a few levels a launch."""
    x, y, valid = decomp._g1_decompress_traced(x_raw, a_flag)
    all_valid = torch.all(valid | is_inf, dim=1)
    cur = _jacobian_or_infinity(F.fq_select, x, y, is_inf,
                                F.const(F._ONE_MONT, x.device))
    if x.is_cuda:
        from . import fq_points
        x_aff, y_aff, inf = fq_points.point_tree_cuda("g1", torch.stack(cur, dim=-2))
        return x_aff, y_aff, inf, all_valid
    while cur[0].shape[1] > 1:
        cur = jac_add(G1_OPS, tuple(c[:, 0::2] for c in cur),
                      tuple(c[:, 1::2] for c in cur))
    x_aff, y_aff, inf = jac_to_affine(G1_OPS, tuple(c[:, 0] for c in cur))
    return x_aff, y_aff, inf, all_valid


def _g2_decompress_aggregate(x_raw, a_flag, is_inf):
    """G2 decompression (Fq2 square-root ladder) and one addition tree:
    x_raw [N, 2, L] (N a power of two) -> (x_aff, y_aff [2, L], inf,
    all_valid). For CUDA tensors the tree and jac_to_affine are programs
    of the point kernels, as in the G1 tree."""
    x, y, valid = decomp._g2_decompress_traced(x_raw, a_flag)
    all_valid = torch.all(valid | is_inf)
    cur = _jacobian_or_infinity(T.fq2_select, x, y, is_inf,
                                F.const(T._FQ2_ONE_NP, x.device))
    if x.is_cuda:
        from . import fq_points
        x_aff, y_aff, inf = fq_points.point_tree_cuda("g2", torch.stack(cur, dim=-3)[None])
        return x_aff[0], y_aff[0], inf[0], all_valid
    while cur[0].shape[0] > 1:
        cur = jac_add(G2_OPS, tuple(c[0::2] for c in cur),
                      tuple(c[1::2] for c in cur))
    x_aff, y_aff, inf = jac_to_affine(G2_OPS, tuple(c[0] for c in cur))
    return x_aff, y_aff, inf, all_valid


def g1_scalar_mul(aff_x, aff_y, k: int, nbits: int = 256):
    """[k]P over a batch of affine G1 points (k shared) -> (x, y, is_inf)
    affine, windowed signed digits at w = 4."""
    rec = SM.recode_signed_windows(int(k), nbits, SCALAR_WINDOW)
    return jac_to_affine(G1_OPS, SM.windowed_scalar_mul(
        G1_OPS, (aff_x, aff_y), rec))


def g2_scalar_mul(aff_x, aff_y, k: int, nbits: int = 256,
                  tower: T.Tower = T.DEVICE):
    """G2 twin of g1_scalar_mul: aff_x, aff_y [..., 2, L]. For CUDA
    tensors under fq_tower.DEVICE the whole walk, table, windows,
    correction and inversion, is one launch of the ladder kernel
    (ops/fq_points.py); for CPU tensors and under another tower it is the
    windowed loop over that tower's G2 ops. The limbs are the same."""
    rec = SM.recode_signed_windows(int(k), nbits, SCALAR_WINDOW)
    if tower is T.DEVICE and (aff_x.is_cuda or aff_y.is_cuda):
        from . import fq_points
        batch = aff_x.shape[:-2]
        x, y, inf = fq_points.g2_ladder_cuda(aff_x.reshape(-1, 2, F.L),
                                             aff_y.reshape(-1, 2, F.L), None, rec)
        return (x.reshape(batch + (2, F.L)), y.reshape(batch + (2, F.L)),
                inf.reshape(batch))
    ops = G2_OPS if tower is T.DEVICE else g2_ops(tower)
    return jac_to_affine(ops, SM.windowed_scalar_mul(ops, (aff_x, aff_y), rec))


_G2_COFACTOR_NBITS = gt.G2_COFACTOR.bit_length()
_HASH_BATCH_MIN = 8        # below this, per-message host bignum hashing


def hash_to_g2_batch(requests, device="cuda"):
    """[(message_hash, domain)] -> [(Fq2, Fq2)] == gt.hash_to_g2 per pair:
    the try-and-increment search on the host, the ~507-bit cofactor
    multiply as one batched device scalar mul."""
    if not requests:
        return []
    dev = resolve(device)
    arr = np.stack([g2_to_limbs(gt.hash_to_g2_candidate(mh, dom))
                    for mh, dom in requests])                 # [n, 2, 2, L]
    x, y, inf = g2_scalar_mul(_tensor(arr[:, 0], dev), _tensor(arr[:, 1], dev),
                              gt.G2_COFACTOR, nbits=_G2_COFACTOR_NBITS)
    x, y, inf = x.cpu().numpy(), y.cpu().numpy(), inf.cpu().numpy()
    if inf.any():
        raise AssertionError("cofactor-cleared hash point cannot be infinity")
    return [(T.fq2_from_limbs(x[k]), T.fq2_from_limbs(y[k]))
            for k in range(len(requests))]


# ---------------------------------------------------------------------------
# Host staging
# ---------------------------------------------------------------------------

def g1_to_limbs(pt) -> np.ndarray:
    x, y = pt
    return np.stack([F.to_mont(x), F.to_mont(y)])


def g2_to_limbs(pt) -> np.ndarray:
    x, y = pt
    return np.stack([T.fq2_to_limbs(x), T.fq2_to_limbs(y)])


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def stage_group_arrays(stacks, count: int):
    """[(g1 [count,2,L], g2 [count,2,2,L])] per group -> padded
    (g1 [G,count,2,L], g2 [G,count,2,2,L]) numpy batch arrays, G the next
    power of two, copies of the last member filling the tail. The one
    batch-shape staging point of _grouped_pairing_dispatch and the
    streaming firehose (streaming/pipeline.py): both launch the same
    shapes, and occupancy (real against padded groups) counts the same."""
    g = _next_pow2(len(stacks))
    g1 = np.zeros((g, count, 2, F.L), np.int64)
    g2 = np.zeros((g, count, 2, 2, F.L), np.int64)
    for k in range(g):
        a, b = stacks[min(k, len(stacks) - 1)]
        g1[k] = a
        g2[k] = b
    return g1, g2


def _grouped_pairing_dispatch(groups, dev: torch.device,
                              tower: T.Tower = T.DEVICE) -> dict:
    """[(key, [(g1 [2,L], g2 [2,2,L])...])] -> {key: verdict}: groups
    bucketed by pair count, each bucket padded by stage_group_arrays, one
    grouped check per bucket, every bucket launched before any verdict is
    read back."""
    by_count: dict = {}
    for key, pairs in groups:
        by_count.setdefault(len(pairs), []).append((key, pairs))
    launched = []
    for count, members in by_count.items():
        g1, g2 = stage_group_arrays(
            [(np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs]))
             for _, pairs in members], count)
        telemetry.counter("bls.grouped.launches").inc()
        telemetry.counter("bls.grouped.groups").inc(len(members))
        telemetry.histogram("bls.grouped.occupancy").observe(len(members))
        launched.append((members, grouped_pairing_check(
            _tensor(g1, dev), _tensor(g2, dev), tower)))
    verdicts = {}
    for members, ok in launched:
        ok = ok.cpu().numpy()
        for k, (key, _) in enumerate(members):
            verdicts[key] = bool(ok[k])
    return verdicts


def stage_example_groups(n_groups: int, n_distinct: int = 8):
    """Host-stage n_groups spec-shaped pair triples (-G1 / sig, pk0 /
    H(m), pk1 / H(m)) with real signatures, so every group verifies: the
    firehose's example traffic (the reference's bench and smoke batches).
    Only `n_distinct` groups are signed with the host bignum code, then
    tiled: the device work does not depend on the values. The aggregate
    of the two signatures is the one signature under the sum of the keys,
    the same point the reference's aggregate gives, so the limbs equal
    the reference's. -> (g1 [n,3,2,L], g2 [n,3,2,2,L]) numpy."""
    if n_groups > n_distinct:
        g1d, g2d = stage_example_groups(n_distinct, n_distinct)
        reps = -(-n_groups // n_distinct)
        return (np.tile(g1d, (reps, 1, 1, 1))[:n_groups],
                np.tile(g2d, (reps, 1, 1, 1, 1))[:n_groups])
    g1 = np.zeros((n_groups, 3, 2, F.L), np.int64)
    g2 = np.zeros((n_groups, 3, 2, 2, F.L), np.int64)
    for g in range(n_groups):
        msg = bytes([g % 256]) * 32
        k0, k1 = 2 * g + 1, 2 * g + 2
        agg = gt.sign(msg, (k0 + k1) % gt.r, 1)
        h = gt.hash_to_g2(msg, 1)
        pairs = [(gt.ec_neg(gt.G1_GEN), gt.decompress_g2(agg))]
        pairs += [(gt.decompress_g1(gt.privtopub(k)), h) for k in (k0, k1)]
        g1[g] = np.stack([g1_to_limbs(a) for a, _ in pairs])
        g2[g] = np.stack([g2_to_limbs(b) for _, b in pairs])
    return g1, g2


def _decompress_and_aggregate(encodings, dev, *, enc_len, label, parse,
                              coord_shape, aggregate, compress, infinity):
    """Stage, pad to a power of two with infinity, aggregate on the
    device, reject exactly what the bignum oracle rejects."""
    if not encodings:
        return infinity()
    if not all(len(bytes(e)) == enc_len for e in encodings):
        raise AssertionError(f"{label} must be {enc_len} bytes")
    data = np.stack([np.frombuffer(bytes(e), np.uint8) for e in encodings])
    x_raw, a_flag, is_inf, wellformed = parse(data)
    if not bool(wellformed.all()):
        raise AssertionError(f"malformed {label} encoding")
    n = data.shape[0]
    pad = _next_pow2(n) - n
    if pad:
        x_raw = np.concatenate([x_raw, np.zeros((pad,) + coord_shape, np.int64)])
        a_flag = np.concatenate([a_flag, np.zeros(pad, bool)])
        is_inf = np.concatenate([is_inf, np.ones(pad, bool)])
    x, y, inf, all_valid = aggregate(
        _tensor(x_raw, dev), _tensor(a_flag, dev), _tensor(is_inf, dev))
    if not bool(all_valid.all()):
        raise AssertionError(f"{label} not on curve / out of range")
    if bool(inf.all()):
        return infinity()
    return compress(x.cpu().numpy(), y.cpu().numpy())


def _g1_aggregate_one(x_raw, a_flag, is_inf):
    x, y, inf, ok = _g1_decompress_aggregate_grouped(
        x_raw[None], a_flag[None], is_inf[None])
    return x[0], y[0], inf[0], ok[0]


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------

class TorchBackend:
    """Device BLS backend with JaxBackend's surface and byte-level
    behaviour: the same verdicts, aggregates and signatures as the bignum
    oracle. Curve math runs on `device` ("cuda" by default; raises
    without CUDA -- pass "cpu" for the plain path)."""

    def __init__(self, device="cuda"):
        self.device = resolve(device)

    # -- verification -------------------------------------------------------

    def _check_pairs(self, pairs: Sequence[Tuple[object, object]]) -> bool:
        pairs = [(a, b) for a, b in pairs if a is not None and b is not None]
        if not pairs:
            return True
        g1 = np.stack([g1_to_limbs(a) for a, _ in pairs])
        g2 = np.stack([g2_to_limbs(b) for _, b in pairs])
        return bool(pairing_product_is_one(
            _tensor(g1, self.device), _tensor(g2, self.device)).cpu()[0])

    def verify(self, pubkey: bytes, message_hash: bytes, signature: bytes,
               domain: int) -> bool:
        return self.verify_multiple([pubkey], [message_hash], signature, domain)

    @staticmethod
    def _stage_pairs(pubkeys, message_hashes, signature, domain,
                     hash_cache: Optional[dict] = None):
        """One aggregate-verify's pairing inputs [(-G1, sig), (pk_i,
        H(m_i))...], infinity pairs dropped; None when an encoding or the
        lengths are bad (verdict False)."""
        try:
            if len(pubkeys) != len(message_hashes):
                return None
            pairs = [(gt.ec_neg(gt.G1_GEN), gt.decompress_g2(signature))]
            for pk, mh in zip(pubkeys, message_hashes):
                key = (bytes(mh), int(domain))
                h = (hash_cache[key] if hash_cache and key in hash_cache
                     else gt.hash_to_g2(mh, domain))
                pairs.append((gt.decompress_g1(pk), h))
        except AssertionError:
            return None
        return [(a, b) for a, b in pairs if a is not None and b is not None]

    def verify_multiple(self, pubkeys, message_hashes, signature,
                        domain: int) -> bool:
        pairs = self._stage_pairs(pubkeys, message_hashes, signature, domain)
        if pairs is None:
            return False
        return self._check_pairs(pairs)

    def _hash_points(self, wanted):
        """{(message, domain): hashed point}, batched on the device from
        _HASH_BATCH_MIN distinct pairs up, per message on the host below."""
        if len(wanted) >= _HASH_BATCH_MIN:
            return dict(zip(wanted, hash_to_g2_batch(wanted, self.device)))
        return {key: gt.hash_to_g2(*key) for key in wanted}

    def verify_multiple_batch(self, items) -> List[bool]:
        """Independent aggregate-verifies (pubkeys, message_hashes,
        signature, domain): verify_multiple's verdict per item, items
        grouped by surviving pair count into grouped device checks."""
        wanted = list(dict.fromkeys(
            (bytes(mh), int(domain))
            for _, mhs, _, domain in items for mh in mhs))
        hash_cache = (dict(zip(wanted, hash_to_g2_batch(wanted, self.device)))
                      if len(wanted) >= _HASH_BATCH_MIN else None)
        results = [False] * len(items)
        groups = []
        for i, item in enumerate(items):
            pairs = self._stage_pairs(*item, hash_cache=hash_cache)
            if pairs is None:
                continue
            if not pairs:
                results[i] = True
                continue
            groups.append((i, [(g1_to_limbs(a), g2_to_limbs(b))
                               for a, b in pairs]))
        for i, ok in _grouped_pairing_dispatch(groups, self.device).items():
            results[i] = ok
        return results

    def verify_indexed_batch(self, items) -> List[bool]:
        """A block's indexed-attestation checks, every device stage batched
        across the block. Items are (pubkey_sets, message_hashes,
        signature, domain) with one pubkey set per message; verdicts equal
        [verify_multiple(aggregates of the sets, ...)]."""
        results, groups = self.stage_indexed_batch(items)
        for i, ok in _grouped_pairing_dispatch(groups, self.device).items():
            results[i] = ok
        return results

    # Stages 1-3 and the staging of stage 4, in order; each reads and
    # extends one SimpleNamespace (items, results, agg, sig_pts, hashed,
    # groups). A caller that times the stages runs them one by one.
    INDEXED_STAGES = ("stage_pubkeys", "stage_signatures", "stage_messages",
                      "stage_pairs")

    def stage_indexed_batch(self, items):
        """Stages 1-3 of verify_indexed_batch -> (results, groups):
        results[i] is False (malformed), True (empty product) or None (a
        pairing check is still needed), groups = [(i, [(g1 [2,L],
        g2 [2,2,L])...])] is the pairing work of stage 4."""
        st = self.indexed_state(items)
        for stage in self.INDEXED_STAGES:
            getattr(self, stage)(st)
        return st.results, st.groups

    @staticmethod
    def indexed_state(items):
        return SimpleNamespace(items=items, results=[None] * len(items),
                               agg={}, sig_pts={}, hashed={}, groups=[])

    def stage_pubkeys(self, st) -> None:
        """Stage 1: every set of every item decompressed and aggregated,
        one grouped device program per padded committee size. st.agg maps
        (item, set) -> [2, L] limbs, or None for infinity."""
        by_c: dict = {}
        for i, (pubkey_sets, mhs, _sig, _domain) in enumerate(st.items):
            if len(pubkey_sets) != len(mhs):
                st.results[i] = False
                continue
            sets = []
            for s, pubkeys in enumerate(pubkey_sets):
                if any(len(bytes(p)) != 48 for p in pubkeys):
                    st.results[i] = False
                    break
                if pubkeys:
                    sets.append((i, s, [bytes(p) for p in pubkeys]))
            if st.results[i] is None:
                for member in sets:
                    by_c.setdefault(_next_pow2(len(member[2])), []).append(member)
        for c, members in by_c.items():
            g = len(members)
            x_raw = np.zeros((g, c, F.L), np.int64)
            a_flag = np.zeros((g, c), bool)
            is_inf = np.ones((g, c), bool)
            bad = np.zeros(g, bool)
            for k, (_, _, pubkeys) in enumerate(members):
                data = np.stack([np.frombuffer(p, np.uint8) for p in pubkeys])
                xr, af, inf, wf = decomp.parse_g1_bytes(data)
                if not wf.all():
                    bad[k] = True
                    continue
                m = len(pubkeys)
                x_raw[k, :m], a_flag[k, :m], is_inf[k, :m] = xr, af, inf
            dev = self.device
            x, y, inf, valid = _g1_decompress_aggregate_grouped(
                _tensor(x_raw, dev), _tensor(a_flag, dev), _tensor(is_inf, dev))
            x, y = x.cpu().numpy(), y.cpu().numpy()
            inf, valid = inf.cpu().numpy(), valid.cpu().numpy()
            for k, (i, s, _) in enumerate(members):
                if bad[k] or not valid[k]:
                    st.results[i] = False
                else:
                    st.agg[(i, s)] = None if inf[k] else np.stack([x[k], y[k]])

    def stage_signatures(self, st) -> None:
        """Stage 2: the signatures of the live items, one batched G2
        decompression. st.sig_pts maps item -> [2, 2, L] or None."""
        sig_ok = []
        for i, item in enumerate(st.items):
            if st.results[i] is None:
                if len(bytes(item[2])) == 96:
                    sig_ok.append(i)
                else:
                    st.results[i] = False
        if not sig_ok:
            return
        data = np.stack([np.frombuffer(bytes(st.items[i][2]), np.uint8)
                         for i in sig_ok])
        x, y, valid, inf = decomp.g2_decompress_batch(data, self.device)
        x, y = x.cpu().numpy(), y.cpu().numpy()
        for k, i in enumerate(sig_ok):
            if not valid[k]:
                st.results[i] = False
            else:
                st.sig_pts[i] = None if inf[k] else np.stack([x[k], y[k]])

    def stage_messages(self, st) -> None:
        """Stage 3: hash_to_G2 of the distinct (message, domain) pairs whose
        pair survives (an empty set drops its pair)."""
        wanted = list(dict.fromkeys(
            (bytes(mh), int(item[3]))
            for i, item in enumerate(st.items) if st.results[i] is None
            for s, mh in enumerate(item[1]) if (i, s) in st.agg))
        st.hashed = self._hash_points(wanted)

    def stage_pairs(self, st) -> None:
        """The pairing inputs of stage 4: [(-G1, sig), (aggregate_k,
        H(m_k))...] per live item, infinity pairs dropped; an item left
        with no pair is an empty product (True)."""
        neg_g1 = g1_to_limbs(gt.ec_neg(gt.G1_GEN))
        for i, (_, mhs, _, domain) in enumerate(st.items):
            if st.results[i] is not None:
                continue
            pairs = []
            if st.sig_pts[i] is not None:
                pairs.append((neg_g1, st.sig_pts[i]))
            for s, mh in enumerate(mhs):
                a = st.agg.get((i, s))          # absent = empty set = infinity
                if a is not None:
                    pairs.append((a, g2_to_limbs(st.hashed[(bytes(mh), int(domain))])))
            if not pairs:
                st.results[i] = True
            else:
                st.groups.append((i, pairs))

    # -- aggregation --------------------------------------------------------

    def aggregate_pubkeys(self, pubkeys: Sequence[bytes]) -> bytes:
        """EC sum of compressed G1 pubkeys; decompression and the addition
        tree on the device. Raises AssertionError on what the oracle
        rejects."""
        return _decompress_and_aggregate(
            pubkeys, self.device, enc_len=48, label="pubkey",
            parse=decomp.parse_g1_bytes, coord_shape=(F.L,),
            aggregate=_g1_aggregate_one,
            compress=lambda x, y: gt.compress_g1((F.from_mont(x), F.from_mont(y))),
            infinity=lambda: gt.compress_g1(None))

    def aggregate_signatures(self, signatures: Sequence[bytes]) -> bytes:
        """EC sum of compressed G2 signatures, like aggregate_pubkeys."""
        return _decompress_and_aggregate(
            signatures, self.device, enc_len=96, label="signature",
            parse=decomp.parse_g2_bytes, coord_shape=(2, F.L),
            aggregate=_g2_decompress_aggregate,
            compress=lambda x, y: gt.compress_g2(
                (T.fq2_from_limbs(x), T.fq2_from_limbs(y))),
            infinity=lambda: gt.compress_g2(None))

    # -- signing ------------------------------------------------------------

    def sign(self, message_hash: bytes, privkey: int, domain: int) -> bytes:
        k = privkey % gt.r
        if k == 0:
            return gt.compress_g2(None)
        hx, hy = g2_to_limbs(gt.hash_to_g2(message_hash, domain))
        x, y, inf = g2_scalar_mul(_tensor(hx, self.device),
                                  _tensor(hy, self.device), k)
        if bool(inf):
            raise AssertionError("signature point at infinity")
        return gt.compress_g2((T.fq2_from_limbs(x.cpu().numpy()),
                               T.fq2_from_limbs(y.cpu().numpy())))

    def privtopub(self, privkey: int) -> bytes:
        k = privkey % gt.r
        if k == 0:
            return gt.compress_g1(None)
        gx, gy = g1_to_limbs(gt.G1_GEN)
        x, y, inf = g1_scalar_mul(_tensor(gx, self.device),
                                  _tensor(gy, self.device), k)
        if bool(inf):
            raise AssertionError("public key at infinity")
        return gt.compress_g1((F.from_mont(x.cpu().numpy()),
                               F.from_mont(y.cpu().numpy())))
