"""Wrappers of the hand-written Montgomery kernels (csrc/fq_mont.cu).

`fq_mul_cuda`, `fq_redc_cuda` and `fq_bilinear_cuda` compute
ops.fq.fq_mul_plain, fq_redc_plain and fq_bilinear_plain bit for bit;
ops.fq.fq_mul / fq_redc / fq_bilinear route CUDA tensors here and CPU
tensors to the plain versions. Operands may be broadcast views: each is
passed with its own strides over the lane axes (0 where it is broadcast),
never copied. Each entry point keeps its own launch counter, with a
histogram of lanes per launch.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import fq as F
from ._nvcc import load_library

L = 14
MAX_DIMS = 4                      # lane axes a launch takes (after merging)
_LAYOUT_LEN = 1 + MAX_DIMS + 2 * (MAX_DIMS + 2)

# The work of one lane (see the source's header). fq_mul does 196
# schoolbook products and 15 per REDC step over 14 steps, fq_redc the
# REDC's 210. Each product of two ~29-bit limbs needs at least one 32 x 32
# -> 64-bit multiply-add (IMAD.WIDE) on Hopper, which has no 64-bit
# multiplier. Bytes: each input read once, the output written once.
PRODUCTS_PER_LANE = {"fq_mul": 14 * 14 + 14 * 15, "fq_redc": 14 * 15}
BYTES_PER_LANE = {"fq_mul": 3 * L * 8, "fq_redc": (2 * L + L) * 8}


def bilinear_work(P: int, R: int, Ca: int, Cb: int):
    """(limb products, bytes) of one lane of a bilinear product: P
    schoolbooks of 196 products and R REDCs of 210; Ca + Cb input
    coefficients read and R output coefficients written, 112 bytes each
    (Cb = 0 where b is a itself)."""
    return P * L * L + R * L * 15, (Ca + Cb + R) * L * 8


def bound_ms(name: str, lanes: int, imad_per_s: float, bytes_per_s: float,
             P: int = 0, R: int = 0, Ca: int = 0, Cb: int = 0):
    """(ms, "operations" | "bytes"): the least time for `lanes` lanes of
    entry point `name` (for "fq_bilinear", of the product with P leaves,
    R outputs and Ca + Cb input coefficients): its products at one
    IMAD.WIDE each at the 32-bit multiply-add rate, or its bytes at the
    memory rate, whichever is longer."""
    if name == "fq_bilinear":
        products, nbytes = bilinear_work(P, R, Ca, Cb)
    else:
        products, nbytes = PRODUCTS_PER_LANE[name], BYTES_PER_LANE[name]
    ops_ms = products * lanes / imad_per_s * 1e3
    bytes_ms = nbytes * lanes / bytes_per_s * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class _Counter:
    """Launches of one entry point: one per launch, nowhere else. `lanes`
    counts them by lanes per launch (by (table, lanes) for fq_bilinear)."""

    def __init__(self) -> None:
        self.launches = 0
        self.lanes = collections.Counter()

    def record(self, key) -> None:
        self.launches += 1
        self.lanes[key] += 1

    def reset(self) -> None:
        self.launches = 0
        self.lanes.clear()


mul_counter = _Counter()
redc_counter = _Counter()
bilinear_counter = _Counter()

_P = ctypes.c_void_p
_LAYOUT = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = {
    "fq_mul": [_P, _P, _P, ctypes.c_longlong, _LAYOUT, ctypes.c_int, _P],
    "fq_redc": [_P, _P, ctypes.c_longlong, _LAYOUT, _P],
    "fq_bilinear": [_P, _P, _P, _P, _P, ctypes.c_longlong, _LAYOUT,
                    ctypes.POINTER(ctypes.c_int), _P],
    "fq_empty": [_P],
}
_fns = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load_library("fq_mont"), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(t: torch.Tensor, what: str) -> torch.Tensor:
    """t as it is handed to a kernel: a CUDA int64 tensor with contiguous
    limbs (its shape is checked where its plan is made)."""
    if not t.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {t.device}")
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64 limbs, got {t.dtype}")
    return t if t.stride(-1) == 1 else t.contiguous()


def _rows(t: torch.Tensor, rows: tuple, what: str) -> None:
    if t.dim() < len(rows) or tuple(t.shape[t.dim() - len(rows):]) != rows:
        raise ValueError(f"{what}: expected [..., {', '.join(map(str, rows))}],"
                         f" got {tuple(t.shape)}")


def _layout(batch: tuple, views) -> ctypes.Array:
    """The kernels' layout argument: the lane axes of `batch` (size-1
    axes dropped, neighbours merged where every view allows) and each
    view's strides over them, its coefficient stride and whether all its
    rows start 16-byte aligned. views: one or two tensors of shape
    batch + (C, L) or batch + (W,)."""
    nb = len(batch)
    dims = []
    for d in range(nb):
        if batch[d] == 1:
            continue
        st = [v.stride(d) for v in views]
        if dims and all(p == s * batch[d] for p, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * batch[d], st)
        else:
            dims.append((batch[d], st))
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{len(dims)} lane axes that do not merge "
                         f"(at most {MAX_DIMS})")
    pad = MAX_DIMS - len(dims)
    vals = [len(dims)] + [s for s, _ in dims] + [1] * pad
    for k in range(2):
        if k < len(views):
            v = views[k]
            st = [s[k] for _, s in dims] + [0] * pad
            cst = v.stride(-2) if v.dim() > nb + 1 else 0
            vec16 = v.data_ptr() % 16 == 0 and all(x % 2 == 0 for x in st + [cst])
            vals += st + [cst, int(vec16)]
        else:
            vals += [0] * (MAX_DIMS + 2)
    return (ctypes.c_longlong * _LAYOUT_LEN)(*vals)


def _lanes_of(batch: tuple) -> int:
    n = math.prod(batch)
    if n >= 1 << 31:
        raise ValueError(f"{n} lanes: a launch takes fewer than 2^31")
    return n


# Launch plans, keyed by the operands' shapes, strides and 16-byte
# alignment: (output shape, lanes, layout). The main path repeats a few
# dozen operand shapes thousands of times, so each is worked out once.
_PLANS = {}
_MAX_PLANS = 4096


def _plan(key, make):
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        plan = _PLANS[key] = make()
    return plan


def _call(name: str, dev: torch.device, *args) -> None:
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _call(name, dev, *args)
    err = _launcher(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def fq_mul_cuda(a: torch.Tensor, b: torch.Tensor,
                norm_full: bool = False) -> torch.Tensor:
    """[..., 14] x [..., 14] int64 Montgomery limbs (broadcast) on one
    CUDA device -> [..., 14] lazy limbs of a*b*R^-1 (fq_mul_plain's), or
    with norm_full its unique signed-top limbs (fq_mul_norm_plain's)."""
    a, b = _check(a, "fq_mul"), _check(b, "fq_mul")
    if a.device != b.device:
        raise ValueError(f"fq_mul: operands on {a.device} and {b.device}")

    def make():
        _rows(a, (L,), "fq_mul")
        _rows(b, (L,), "fq_mul")
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return shape, _lanes_of(shape[:-1]), _layout(
            shape[:-1], (a.expand(shape), b.expand(shape)))

    shape, n, layout = _plan(("mul", a.shape, a.stride(), a.data_ptr() & 15,
                              b.shape, b.stride(), b.data_ptr() & 15), make)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if n:
        _call("fq_mul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
              n, layout, int(norm_full))
        mul_counter.record(n)
    return out


def fq_redc_cuda(cols: torch.Tensor) -> torch.Tensor:
    """[..., 28] int64 wide columns on a CUDA device -> [..., 14] lazy
    limbs of value cols * R^-1 mod q."""
    cols = _check(cols, "fq_redc")

    def make():
        _rows(cols, (2 * L,), "fq_redc")
        batch = cols.shape[:-1]
        return batch + (L,), _lanes_of(batch), _layout(batch, (cols,))

    shape, n, layout = _plan(("redc", cols.shape, cols.stride(),
                              cols.data_ptr() & 15), make)
    out = torch.empty(shape, dtype=torch.int64, device=cols.device)
    if n:
        _call("fq_redc", cols.device, cols.data_ptr(), out.data_ptr(), n,
              layout)
        redc_counter.record(n)
    return out


# Per (tables, device): Montgomery one's and the packed tables' device
# addresses (ops.fq.const keeps both tensors alive), and the shape array.
_TABLES = {}


def _tables_on(tables: F.Bilinear, dev: torch.device):
    key = (tables.name, dev.index)
    hit = _TABLES.get(key)
    if hit is None:
        shape = (ctypes.c_int * 7)(tables.P, tables.R, tables.Ca, tables.Cb,
                                   int(tables.one_col), int(tables.norm_in),
                                   len(tables.packed))
        hit = _TABLES[key] = (F.const(F._ONE_MONT, dev).data_ptr(),
                              F.const(tables.packed, dev).data_ptr(), shape)
    return hit


def fq_bilinear_cuda(av: torch.Tensor, bv: torch.Tensor,
                     tables: F.Bilinear) -> torch.Tensor:
    """One tower product in one launch: av [..., Ca, 14], bv [..., Cb, 14]
    int64 lazy limbs (batch axes broadcast) on one CUDA device ->
    [..., R, 14], fq_bilinear_plain's limbs. The tables live on the device
    from their first use there."""
    av, bv = _check(av, tables.name), _check(bv, tables.name)
    if av.device != bv.device:
        raise ValueError(f"{tables.name}: operands on {av.device} and {bv.device}")

    def make():
        _rows(av, (tables.Ca, L), tables.name)
        _rows(bv, (tables.Cb, L), tables.name)
        batch = tuple(torch.broadcast_shapes(av.shape[:-2], bv.shape[:-2]))
        return batch + (tables.R, L), _lanes_of(batch), _layout(
            batch, (av.expand(batch + (tables.Ca, L)),
                    bv.expand(batch + (tables.Cb, L))))

    shape, n, layout = _plan(
        (tables.name, av.shape, av.stride(), av.data_ptr() & 15,
         bv.shape, bv.stride(), bv.data_ptr() & 15), make)
    out = torch.empty(shape, dtype=torch.int64, device=av.device)
    if n:
        one, table, shape_arg = _tables_on(tables, av.device)
        _call("fq_bilinear", av.device, av.data_ptr(), bv.data_ptr(), one,
              table, out.data_ptr(), n, layout, shape_arg)
        bilinear_counter.record((tables.name, n))
    return out


def empty_launch() -> None:
    """One launch of an empty kernel on the current device and stream:
    the floor that no launch beats (timed beside the kernels; never
    counted)."""
    _call("fq_empty", torch.device("cuda", torch.cuda.current_device()))
