"""Wrappers of the hand-written Montgomery kernels (csrc/fq_mont.cu).

`fq_mul_cuda`, `fq_redc_cuda`, `fq_bilinear_cuda` and
`fq_bilinear_chain_cuda` compute ops.fq.fq_mul_plain, fq_redc_plain,
fq_bilinear_plain and fq_bilinear_chain_plain bit for bit; ops.fq's
routed entry points send CUDA tensors here and CPU tensors to the plain
versions. A single tower product is a chain of one step of the same
kernel; a chain's program is uploaded to the device once and has no
length limit. Operands may be broadcast views: each is passed with its own
strides over the lane axes (0 where it is broadcast), never copied. Each
entry point keeps its own launch counter, with a histogram of lanes per
launch.
"""
from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from . import fq as F
from . import fq_tower as T
from ._nvcc import load_library

L = 14
MAX_DIMS = 4                      # lane axes a launch takes (after merging)
MAX_OPERANDS = 3
# ndim, sizes, per operand (strides, coefficient stride, vec16), then the
# operands' slice strides
_LAYOUT_LEN = 1 + MAX_DIMS + MAX_OPERANDS * (MAX_DIMS + 2) + MAX_OPERANDS
PHASES = 4                        # clock stamps per chain step

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


def step_products(code, tables) -> int:
    """Limb products of one chain step: a tower product's P schoolbooks
    and R REDCs, an fq_mul's one of each (two for an Fq2 squaring), none
    for norm, store and load."""
    kind = int(code) & F.KIND_MASK
    if kind < F.KIND_MUL:
        t = tables[kind]
        return t.P * L * L + t.R * L * 15
    return {F.KIND_MUL: 1, F.KIND_SQR2: 2}.get(kind, 0) * PRODUCTS_PER_LANE["fq_mul"]


def program_ca(program, tables) -> int:
    """The accumulator's coefficients a program multiplies (that of its
    first product)."""
    for c in program:
        kind = int(c) & F.KIND_MASK
        if kind < F.KIND_MUL:
            return tables[kind].Ca
        if kind in F.STEP_CA:
            return F.STEP_CA[kind]
    raise ValueError("a program without products")


def chain_work(program, tables, Cb: int = 0, S: int = 0, Cs: int = 0):
    """(limb products, bytes) of one lane of a chain: every step's
    products; the accumulator, the base (Cb coefficients) and the operand
    (S x Cs; 0 for a table the program fills) read once and the
    accumulator written once."""
    products = sum(step_products(c, tables) for c in program)
    return products, (2 * program_ca(program, tables) + Cb + S * Cs) * L * 8


def _bound(products, nbytes, lanes, imad_per_s, bytes_per_s):
    ops_ms = products * lanes / imad_per_s * 1e3
    bytes_ms = nbytes * lanes / bytes_per_s * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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
    return _bound(products, nbytes, lanes, imad_per_s, bytes_per_s)


def chain_bound_ms(program, tables, lanes: int, imad_per_s: float,
                   bytes_per_s: float, Cb: int = 0, S: int = 0, Cs: int = 0):
    """bound_ms of a chain (chain_work's products and bytes)."""
    return _bound(*chain_work(program, tables, Cb, S, Cs), lanes, imad_per_s,
                  bytes_per_s)


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
chain_counter = _Counter()        # lanes keyed by (steps, lanes)

_P = ctypes.c_void_p
_LAYOUT = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = {
    "fq_mul": [_P, _P, _P, ctypes.c_longlong, _LAYOUT, ctypes.c_int, _P],
    "fq_redc": [_P, _P, ctypes.c_longlong, _LAYOUT, _P],
    "fq_chain": [_P, _P, _P, _P, ctypes.c_longlong, _LAYOUT,
                 ctypes.POINTER(ctypes.c_int), _P, ctypes.c_int,
                 ctypes.POINTER(ctypes.c_int), _P, ctypes.POINTER(ctypes.c_int), _P],
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
    axes dropped, neighbours merged where every view allows), each view's
    strides over them, its coefficient stride and whether all its rows
    start 16-byte aligned, then each view's slice stride. views: up to
    three tensors (None for an absent one) of shape batch + (W,),
    batch + (C, L) or batch + (S, C, L)."""
    nb = len(batch)
    present = [v for v in views if v is not None]
    dims = []
    for d in range(nb):
        if batch[d] == 1:
            continue
        st = [v.stride(d) for v in present]
        if dims and all(p == s * batch[d] for p, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * batch[d], st)
        else:
            dims.append((batch[d], st))
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{len(dims)} lane axes that do not merge "
                         f"(at most {MAX_DIMS})")
    pad = MAX_DIMS - len(dims)
    vals = [len(dims)] + [s for s, _ in dims] + [1] * pad
    slices = []
    k = 0
    for v in list(views) + [None] * (MAX_OPERANDS - len(views)):
        if v is None:
            vals += [0] * (MAX_DIMS + 2)
            slices.append(0)
            continue
        st = [s[k] for _, s in dims] + [0] * pad
        cst = v.stride(-2) if v.dim() > nb + 1 else 0
        sst = v.stride(-3) if v.dim() > nb + 2 else 0
        vec16 = v.data_ptr() % 16 == 0 and all(x % 2 == 0 for x in st + [cst, sst])
        vals += st + [cst, int(vec16)]
        slices.append(sst)
        k += 1
    return (ctypes.c_longlong * _LAYOUT_LEN)(*(vals + slices))


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


def _check_step(code, Ca, Cb, S, Cs, table, tables, what):
    """A step against the chain's shapes (csrc/fq_mont.cu check_program):
    raises ValueError where the kernel cannot run it."""
    kind, src = int(code) & F.KIND_MASK, int(code) >> F.KIND_BITS
    if code < 0 or kind >= F.N_KINDS:
        raise ValueError(f"{what}: code {int(code)}: no step of that kind")
    name = T.step_name(code)
    slot = F.SRC_OPERAND <= src < F.SRC_OPERAND + S
    if kind >= F.KIND_NORM:
        ok = (src == F.SRC_ACC if kind == F.KIND_NORM
              else slot and Cs == Ca and (table or kind == F.KIND_LOAD))
    else:
        if kind < F.KIND_MUL:
            t = tables[kind]
            tCa, tR, tCb, squares = t.Ca, t.R, t.Cb, t.norm_in or t.one_col
        else:
            tCa = tR = tCb = F.STEP_CA[kind]
            squares = kind == F.KIND_SQR2
        ok = tCa == tR == Ca and (
            (src == F.SRC_ACC and tCb == Ca)
            or (not squares and ((src == F.SRC_BASE and tCb == Cb)
                                 or (slot and tCb == Cs))))
    if not ok:
        raise ValueError(f"{what}: {name} (kind {kind}) with b from source {src}"
                         f" (Ca {Ca}, Cb {Cb}, {S} slots of {Cs} rows"
                         f"{', a table' if table else ''})")


def _chain_plan(acc, codes, base, operand):
    """(output shape, lanes, layout, dims, program) of a chain launch: the
    program (int32 codes) and the operands' shapes checked against its
    steps, the program as the launcher's array. Without an operand the
    program's slots are a table of acc's shape."""
    if codes.ndim != 1 or codes.shape[0] < 1:
        raise ValueError(f"a chain takes at least one step, got {codes.shape}")
    if acc.dim() < 2:
        raise ValueError(f"a chain's accumulator [..., Ca, 14], got {tuple(acc.shape)}")
    Ca = acc.shape[-2]
    what = f"chain of {codes.shape[0]} steps"
    _rows(acc, (Ca, L), what)
    Cb = S = Cs = 0
    table = operand is None
    if base is not None:
        Cb = base.shape[-2]
        _rows(base, (Cb, L), what)
    if operand is not None:
        if operand.dim() < 3:
            raise ValueError(f"{what}: operand {tuple(operand.shape)}")
        S, Cs = operand.shape[-3], operand.shape[-2]
        _rows(operand, (S, Cs, L), what)
    else:
        S = F.program_slots(codes)
        Cs = Ca if S else 0
    for c in codes:
        _check_step(c, Ca, Cb, S, Cs, table, T.TABLES, what)
    batches = [acc.shape[:-2]]
    batches += [] if base is None else [base.shape[:-2]]
    batches += [] if operand is None else [operand.shape[:-3]]
    batch = tuple(torch.broadcast_shapes(*batches))
    views = (acc.expand(batch + (Ca, L)),
             None if base is None else base.expand(batch + (Cb, L)),
             None if operand is None else operand.expand(batch + (S, Cs, L)))
    return (batch + (Ca, L), _lanes_of(batch), _layout(batch, views),
            (ctypes.c_int * 5)(Ca, Cb, S, Cs, int(not table)),
            (ctypes.c_int * codes.shape[0])(*codes.tolist()))


def _key(t):
    return None if t is None else (t.shape, t.stride(), t.data_ptr() & 15)


# Programs in device memory, keyed by their codes and the device: each is
# uploaded once (the main path runs a few dozen programs thousands of times).
_DEVICE_PROGRAMS = {}


def _device_program(codes: np.ndarray, dev: torch.device) -> torch.Tensor:
    key = (codes.tobytes(), dev)
    prog = _DEVICE_PROGRAMS.get(key)
    if prog is None:
        if len(_DEVICE_PROGRAMS) >= _MAX_PLANS:
            _DEVICE_PROGRAMS.clear()
        prog = _DEVICE_PROGRAMS[key] = torch.from_numpy(codes.copy()).to(dev)
    return prog


def _chain(acc, program, tables, base, operand, stamps=None, shape=None):
    """One launch of the chain kernel -> (output, lanes). tables: where
    the program has tower products, the products the kernel has compiled
    in (ops/fq_tower.py::TABLES, csrc/fq_tables.cuh). shape: None, or a
    4-int ctypes array that receives the launch's groups flag, threads,
    lanes a block and blocks."""
    codes = np.ascontiguousarray(program, dtype=np.int32)
    if tables is not T.TABLES and bool(((codes & F.KIND_MASK) < F.KIND_MUL).any()) and (
            tables is None or len(tables) != len(T.TABLES)
            or any(a is not b for a, b in zip(tables, T.TABLES))):
        raise ValueError("a chain runs the compiled products, fq_tower.TABLES")
    ts = [t for t in (acc, base, operand) if t is not None]
    acc, base, operand = (None if t is None else _check(t, "fq_chain")
                          for t in (acc, base, operand))
    if any(t.device != acc.device for t in ts):
        raise ValueError(f"fq_chain: operands on {[str(t.device) for t in ts]}")
    out_shape, n, layout, dims, prog = _plan(
        ("chain", codes.tobytes(), codes.shape, _key(acc), _key(base), _key(operand)),
        lambda: _chain_plan(acc, codes, base, operand))
    out = torch.empty(out_shape, dtype=torch.int64, device=acc.device)
    if n:
        prog_dev = _device_program(codes, acc.device)
        _call("fq_chain", acc.device, acc.data_ptr(),
              0 if base is None else base.data_ptr(),
              0 if operand is None else operand.data_ptr(), out.data_ptr(), n,
              layout, prog, prog_dev.data_ptr(), len(prog), dims,
              0 if stamps is None else stamps.data_ptr(), shape)
    return out, n


def fq_bilinear_chain_cuda(acc: torch.Tensor, program, tables,
                           base=None, operand=None) -> torch.Tensor:
    """A program of steps in one launch: acc [..., Ca, 14], base
    [..., Cb, 14], operand [..., S, Cs, 14] int64 lazy limbs (batch axes
    broadcast) on one CUDA device -> [..., Ca, 14],
    fq_bilinear_chain_plain's limbs. program: ops.fq.chain_program codes;
    tables: the compiled products by kind (ops/fq_tower.py::TABLES), or
    None for a program without tower products."""
    out, n = _chain(acc, program, tables, base, operand)
    if n:
        chain_counter.record((len(program), n))
    return out


def chain_launch_shape(acc, program, tables, base=None, operand=None) -> dict:
    """The launcher's shape of this chain: {"groups", "threads",
    "lanes_per_block", "blocks"} (one launch, not counted)."""
    shape = (ctypes.c_int * 4)()
    _chain(acc, program, tables, base, operand, shape=shape)
    return {"groups": bool(shape[0]), "threads": shape[1],
            "lanes_per_block": shape[2], "blocks": shape[3]}


def chain_phase_clocks(acc: torch.Tensor, program, tables, base=None,
                       operand=None) -> np.ndarray:
    """[steps, 4] SM clock cycles of phases A-D (pre-sums, leaves or
    schoolbooks, gamma sums, REDCs; a norm, store or load all in A) of
    each step in block 0 of one chain launch (clock64() after each
    phase's barrier). A measurement: the launch is not counted."""
    stamps = torch.zeros(1 + PHASES * len(program), dtype=torch.int64,
                         device=acc.device)
    _chain(acc, program, tables, base, operand, stamps)
    s = stamps.cpu().numpy()
    return np.diff(s).reshape(len(program), PHASES)


_ONE_STEP = {}                    # a single product's program, by (kind, source)


def fq_bilinear_cuda(av: torch.Tensor, bv: torch.Tensor,
                     tables: F.Bilinear) -> torch.Tensor:
    """One tower product in one launch, a chain of one step: av
    [..., Ca, 14], bv [..., Cb, 14] int64 lazy limbs (batch axes
    broadcast) on one CUDA device -> [..., R, 14], fq_bilinear_plain's
    limbs. b is the accumulator itself where bv is av (a square), else
    the chain's base; a product with norm_in or one_col takes bv is av."""
    if T.TABLES[tables.kind] is not tables:
        raise ValueError(f"{tables.name}: not a compiled product (fq_tower.TABLES)")
    if bv is not av and (tables.norm_in or tables.one_col):
        raise ValueError(f"{tables.name} squares its operand: pass bv is av")
    src = F.SRC_ACC if bv is av else F.SRC_BASE
    program = _ONE_STEP.get((tables.kind, src))
    if program is None:
        program = _ONE_STEP[(tables.kind, src)] = F.chain_program([(tables, src)])
    out, n = _chain(av, program, T.TABLES, None if bv is av else bv, None)
    if n:
        bilinear_counter.record((tables.name, n))
    return out


def empty_launch() -> None:
    """One launch of an empty kernel on the current device and stream:
    the floor that no launch beats (timed beside the kernels; never
    counted)."""
    _call("fq_empty", torch.device("cuda", torch.cuda.current_device()))
