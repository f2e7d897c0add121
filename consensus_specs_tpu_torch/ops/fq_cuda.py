"""Wrappers of the hand-written Montgomery kernels (csrc/fq_mont.cu).

`fq_mul_cuda` and `fq_redc_cuda` compute ops.fq.fq_mul_plain and
ops.fq.fq_redc_plain, bit for bit, one thread per lane. ops.fq.fq_mul and
ops.fq.fq_redc route CUDA tensors here and CPU tensors to the plain
versions. Each entry point keeps its own launch counter.
"""
from __future__ import annotations

import ctypes

import torch

from ._nvcc import load_library

L = 14

# The work of one lane (see the source's header). fq_mul does 196
# schoolbook products and 15 per REDC step over 14 steps, fq_redc the
# REDC's 210. Each product of two ~29-bit limbs needs at least one 32 x 32
# -> 64-bit multiply-add (IMAD.WIDE) on Hopper, which has no 64-bit
# multiplier. Bytes: each input read once, the output written once.
PRODUCTS_PER_LANE = {"fq_mul": 14 * 14 + 14 * 15, "fq_redc": 14 * 15}
BYTES_PER_LANE = {"fq_mul": 3 * L * 8, "fq_redc": (2 * L + L) * 8}


def bound_ms(name: str, lanes: int, imad_per_s: float, bytes_per_s: float):
    """(ms, "operations" | "bytes"): the least time for `lanes` lanes of
    entry point `name`: its products at one IMAD.WIDE each at the 32-bit
    multiply-add rate, or its bytes at the memory rate, whichever is
    longer."""
    ops_ms = PRODUCTS_PER_LANE[name] * lanes / imad_per_s * 1e3
    bytes_ms = BYTES_PER_LANE[name] * lanes / bytes_per_s * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class _Counter:
    """Launch count of one entry point: one per launch, nowhere else."""

    def __init__(self) -> None:
        self.launches = 0


mul_counter = _Counter()
redc_counter = _Counter()

_fns = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load_library("fq_mont"), f"{name}_launch")
        n_ptrs = 3 if name == "fq_mul" else 2
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _lanes(t: torch.Tensor, width: int, what: str) -> torch.Tensor:
    if not t.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {t.device}")
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64 limbs, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] != width:
        raise ValueError(f"{what}: expected [..., {width}], got {tuple(t.shape)}")
    return t.contiguous()


def _launch(name: str, counter: _Counter, out: torch.Tensor, *ins) -> None:
    n = out.numel() // L
    if n == 0:
        return
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _launcher(name)(*[t.data_ptr() for t in ins], out.data_ptr(),
                              n, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    counter.launches += 1


def fq_mul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 14] x [..., 14] int64 Montgomery limbs (broadcast) on one
    CUDA device -> [..., 14] lazy limbs of a*b*R^-1."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = _lanes(a.expand(shape), L, "fq_mul")
    b = _lanes(b.expand(shape), L, "fq_mul")
    if a.device != b.device:
        raise ValueError(f"fq_mul: operands on {a.device} and {b.device}")
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    _launch("fq_mul", mul_counter, out, a, b)
    return out


def fq_redc_cuda(cols: torch.Tensor) -> torch.Tensor:
    """[..., 28] int64 wide columns on a CUDA device -> [..., 14] lazy
    limbs of value cols * R^-1 mod q."""
    cols = _lanes(cols, 2 * L, "fq_redc")
    out = torch.empty(cols.shape[:-1] + (L,), dtype=torch.int64,
                      device=cols.device)
    _launch("fq_redc", redc_counter, out, cols)
    return out
