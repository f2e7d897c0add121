"""The G2 ladder and the grouped Miller loop as programs, and the wrappers
of their kernels (csrc/fq_points.cu).

`ladder_program(nbits, w)` records, over ops/fq_program.py's Recorder,
what bls_torch.g2_scalar_mul computes: scalar_mul._lift_affine,
build_odd_multiples, the reference's window loop with the digits as data
(consensus_specs_tpu/ops/scalar_mul.py:275 windowed_scalar_mul: a table
load by digit, the negation selected by its sign, w jac_double and one
jac_add per window, the correction add selected by a flag) and
jac_to_affine with Field.pow_static's inversion. `miller_program(P)`
records bls_torch.miller_loop_grouped: per tail bit of |z| the port's
_dbl_lines for each pair and the f-update (one Fq12 squaring, P line
multiplies), on a set bit _add_lines and P more line multiplies, then the
conjugation. Both are built once per shape and cached.

`g2_ladder_cuda` / `miller_grouped_cuda` run a program in one launch of
its kernel; `g2_ladder_plain` / `miller_grouped_plain` run it through
fq_program.run_program_plain (the plain twin the tests and the card's
checks hold the kernel against). bls_torch routes CUDA tensors under
fq_tower.DEVICE to the kernels and keeps its Python loops for CPU
tensors and fq_tower.PLAIN; a kernel that does not build or launch
raises. Each wrapper counts its launches (`ladder_counter`,
`miller_counter`, lanes per launch).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import fq as F
from . import fq_program as FP
from . import scalar_mul as SM
from ._nvcc import load_library
from .fq_cuda import _Counter

L = F.L

# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------


def ladder_walk(fo, aff, idx, sign, correction, w: int, inf=None):
    """[k]P with the digits as data, as the reference's windowed_scalar_mul
    computes it (table load by idx[i], y negated where sign[i] < 0, the
    correction add kept where the flag is set), over ops/scalar_mul.py's
    point functions. fo: a field-ops namespace with `take` (values[idx])."""
    lifted = SM._lift_affine(fo, aff, inf)
    entries = SM.build_odd_multiples(fo, lifted, w)
    table = tuple([e[c] for e in entries] for c in range(3))

    def entry(i):
        tx, ty, tz = (fo.take(t, idx[i]) for t in table)
        ty = fo.select(sign[i] < 0, fo.neg(ty), ty)
        return (tx, ty, tz)

    acc = entry(0)
    for i in range(1, int(idx.shape[0])):
        for _ in range(w):
            acc = SM.jac_double(fo, acc)
        acc = SM.jac_add(fo, acc, entry(i))
    minus_p = (lifted[0], fo.neg(lifted[1]), lifted[2])
    fixed = SM.jac_add(fo, acc, minus_p)
    return tuple(fo.select(correction, f, a) for f, a in zip(fixed, acc))


def ladder_inputs(rec: FP.Recorder, nbits: int, w: int):
    """The ladder's inputs, in the program's order: (x, y), the infinity
    lane flag, the correction flag, the digits."""
    x, y = rec.input_fq2(0), rec.input_fq2(0)
    inf = rec.input_lane_flag()
    corr = rec.input_uniform_flag()
    return (x, y), inf, corr, FP.Digits(rec, SM.n_windows(nbits, w))


def ladder_recording(nbits: int, w: int):
    """(recorder, Jacobian [k]P, affine (x, y, is_inf)): g2_scalar_mul's
    ops for `nbits`-bit scalars at window w."""
    rec = FP.Recorder()
    fo = FP.FieldOps(rec)
    aff, inf, corr, digits = ladder_inputs(rec, nbits, w)
    acc = ladder_walk(fo, aff, digits, digits, corr, w, inf)
    return rec, acc, SM.jac_to_affine(fo, acc)


@functools.lru_cache(maxsize=None)
def ladder_program(nbits: int, w: int) -> FP.Program:
    """The program of g2_scalar_mul for every scalar of `nbits` bits at
    window w: input rows (x0, x1, y0, y1), the infinity lane flag, the
    correction flag and n_windows(nbits, w) digits -> rows (x0, x1, y0, y1)
    and the infinity flag."""
    rec, _, (xo, yo, info) = ladder_recording(nbits, w)
    return rec.compile(xo.r + yo.r, info.v, n_digits=SM.n_windows(nbits, w))


def miller_walk(rec, pairs, dbl_lines, add_lines, tail_bits):
    """The grouped Miller loop over per-pair symbolic inputs pairs =
    [(xp, yp, xq, yq)], with the port's line functions: f as 12 rows."""
    f = rec.fq12_ones()
    state = [(xq, yq, rec.fq2_ones()) for _, _, xq, yq in pairs]
    for bit in tail_bits:
        lines = []
        for p, (xp, yp, xq, yq) in enumerate(pairs):
            X, Y, Z = state[p]
            c_a, c_v, c_vw, X, Y, Z = dbl_lines(rec, X, Y, Z, xp, yp)
            lines.append((c_a, c_v, c_vw))
            state[p] = (X, Y, Z)
        f = rec.fq12_sqr_mul_lines(f, *zip(*lines))
        if bit:
            lines = []
            for p, (xp, yp, xq, yq) in enumerate(pairs):
                X, Y, Z = state[p]
                c_a, c_v, c_vw, X, Y, Z = add_lines(rec, X, Y, Z, xq, yq, xp, yp)
                lines.append((c_a, c_v, c_vw))
                state[p] = (X, Y, Z)
            f = rec.fq12_mul_lines(f, *zip(*lines))
    return rec.fq12_conj(f)


def miller_inputs(rec: FP.Recorder, P: int):
    """The Miller loop's inputs, in the program's order: per pair
    (xp, yp, xq, yq), the G1 rows of every pair first."""
    g1 = [[FP.S1(rec, v) for v in rec.input_rows(0, 2)] for _ in range(P)]
    g2 = [(rec.input_fq2(1), rec.input_fq2(1)) for _ in range(P)]
    return [(a[0], a[1], b[0], b[1]) for a, b in zip(g1, g2)]


def miller_recording(P: int):
    """(recorder, f rows): miller_loop_grouped's ops for groups of P
    pairs."""
    from . import bls_torch as BT
    rec = FP.Recorder()
    pairs = miller_inputs(rec, P)
    return rec, miller_walk(rec, pairs, BT._dbl_lines, BT._add_lines, BT._Z_TAIL_BITS)


@functools.lru_cache(maxsize=None)
def miller_program(P: int) -> FP.Program:
    """The program of miller_loop_grouped for groups of P pairs: input
    group 0 the pairs' G1 rows (xp, yp), group 1 their G2 rows (xq0, xq1,
    yq0, yq1) -> the 12 rows of the group's conjugated f."""
    rec, f = miller_recording(P)
    return rec.compile(f)


# ---------------------------------------------------------------------------
# Work and bounds
# ---------------------------------------------------------------------------

def program_work(prog: FP.Program, lanes: int):
    """(limb products, bytes) of a launch: every multiply's 196 schoolbook
    and 210 REDC products, every tower product's leaves (196 each) and
    REDCs (210 each), per lane; the inputs read and the outputs written
    once (a lane's flag one byte in, one out)."""
    products = prog.n_mul * (L * L + L * 15) + prog.n_leaves * L * L + prog.n_redc * L * 15
    rows = prog.in_rows[0] + prog.in_rows[1] + prog.out_rows
    nbytes = rows * L * 8 + (2 if prog.out_flag >= 0 else 0)
    return products * lanes, nbytes * lanes


def bound_ms(prog: FP.Program, lanes: int, imad_per_s: float,
             bytes_per_s: float):
    """(ms, "operations" | "bytes"): the launch's products at one
    IMAD.WIDE each at the 32-bit multiply-add rate, or its bytes at the
    memory rate, whichever is longer."""
    products, nbytes = program_work(prog, lanes)
    ops_ms = products / imad_per_s * 1e3
    bytes_ms = nbytes / bytes_per_s * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _digits(rec: SM.SignedWindows):
    return np.asarray(rec.idx, np.int64), np.asarray(rec.sign, np.int64)


def g2_ladder_plain(x: torch.Tensor, y: torch.Tensor, inf: Optional[torch.Tensor],
                    rec: SM.SignedWindows):
    """The ladder program through run_program_plain: x, y [n, 2, 14]
    affine limbs, inf [n] bool (None: no infinity lane) -> (x, y, is_inf)
    equal to jac_to_affine(windowed_scalar_mul(...)) bit for bit."""
    prog = ladder_program(rec.nbits, rec.w)
    n = x.shape[0]
    out, flag = FP.run_program_plain(
        prog, torch.cat([x, y], dim=-2).reshape(n, 4, L), lane_flag=inf,
        uniform_flag=rec.correction, digits=_digits(rec))
    return out[:, :2], out[:, 2:], flag


def miller_grouped_plain(g1: torch.Tensor, g2: torch.Tensor):
    """The Miller program through run_program_plain: g1 [G, P, 2, 14], g2
    [G, P, 2, 2, 14] -> [G, 2, 3, 2, 14]."""
    G, P = g1.shape[0], g1.shape[1]
    out, _ = FP.run_program_plain(miller_program(P), g1.reshape(G, 2 * P, L),
                                  g2.reshape(G, 4 * P, L))
    return out.reshape(G, 2, 3, 2, L)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

ladder_counter = _Counter()       # lanes per launch
miller_counter = _Counter()       # keyed (groups, pairs)

_HEADER = ("code", "consts", "n_bundles", "n_const", "nreg", "nflag", "nx", "ng",
           "max_items", "off_bundles", "off_ops", "off_pool", "off_const_regs",
           "off_in0", "off_in1", "off_out", "in_rows0", "in_rows1", "out_rows",
           "lane_flag", "uniform_flag", "uniform_val", "out_flag", "digit_idx",
           "digit_sign", "in0", "in1", "lane_flags", "out", "out_flags", "lanes",
           "stamps")
_fns: Dict[str, object] = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = load_library("fq_points")
        if lib.fq_points_header_len() != len(_HEADER):
            raise RuntimeError("csrc/fq_points.cu's header != ops/fq_points.py's")
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


# programs on each device, uploaded once: (program, device) -> (code, consts)
_UPLOADED: Dict[Tuple[int, torch.device], Tuple[FP.Program, torch.Tensor, torch.Tensor]] = {}
# each recoding's digit arrays on each device
_DIGITS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _uploaded(prog: FP.Program, dev: torch.device):
    key = (id(prog), dev)
    hit = _UPLOADED.get(key)
    if hit is None:
        hit = _UPLOADED[key] = (prog, torch.from_numpy(prog.code).to(dev),
                                torch.from_numpy(np.ascontiguousarray(prog.consts)).to(dev))
    return hit[1], hit[2]


def _device_digits(rec: SM.SignedWindows, dev: torch.device):
    key = (rec.idx.tobytes(), rec.sign.tobytes(), dev)
    hit = _DIGITS.get(key)
    if hit is None:
        if len(_DIGITS) >= 256:
            _DIGITS.clear()
        hit = _DIGITS[key] = tuple(torch.tensor(np.asarray(a, np.int32), device=dev)
                                   for a in (rec.idx, rec.sign))
    return hit


def _operand(t: torch.Tensor, dev: torch.device, what: str) -> torch.Tensor:
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"{what}: expected a tensor on {dev}, got {t.device}")
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64 limbs, got {t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, prog: FP.Program, dev: torch.device, n: int, ins,
            lane_flags=None, uniform_val: bool = False, digits=None,
            out_flags=None, stamps=None) -> torch.Tensor:
    code, consts = _uploaded(prog, dev)
    out = torch.empty((n, prog.out_rows, L), dtype=torch.int64, device=dev)
    ptr = {"code": code.data_ptr(), "consts": consts.data_ptr(),
           "uniform_val": int(bool(uniform_val)), "lanes": n,
           "in0": ins[0].data_ptr(), "in1": ins[1].data_ptr() if len(ins) > 1 else 0,
           "lane_flags": 0 if lane_flags is None else lane_flags.data_ptr(),
           "out": out.data_ptr(),
           "out_flags": 0 if out_flags is None else out_flags.data_ptr(),
           "digit_idx": 0 if digits is None else digits[0].data_ptr(),
           "digit_sign": 0 if digits is None else digits[1].data_ptr(),
           "stamps": 0 if stamps is None else stamps.data_ptr(),
           "in_rows0": prog.in_rows[0], "in_rows1": prog.in_rows[1]}
    for k in ("n_bundles", "n_const", "nreg", "nflag", "nx", "ng", "max_items",
              "out_rows", "lane_flag", "uniform_flag", "out_flag"):
        ptr[k] = getattr(prog, k)
    for k, v in prog.offsets.items():
        ptr[{"bundles": "off_bundles", "ops": "off_ops", "pool": "off_pool",
             "const_regs": "off_const_regs", "in0": "off_in0", "in1": "off_in1",
             "out": "off_out"}[k]] = v
    header = (ctypes.c_longlong * len(_HEADER))(*(int(ptr[k]) for k in _HEADER))
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = _launcher(name)(header, torch.cuda.current_stream().cuda_stream)
    else:
        err = _launcher(name)(header, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def g2_ladder_cuda(x: torch.Tensor, y: torch.Tensor, inf: Optional[torch.Tensor],
                   rec: SM.SignedWindows, stamps=None):
    """[k]P in one launch of g2_ladder_kernel: x, y [n, 2, 14] int64
    affine limbs on one CUDA device, inf [n] bool or None, rec the
    scalar's recoding (its digits go to the device once) -> (x, y, is_inf)
    as g2_ladder_plain gives them."""
    dev = x.device
    x, y = _operand(x, dev, "g2_ladder"), _operand(y, dev, "g2_ladder")
    n = x.shape[0]
    if x.shape[1:] != (2, L) or y.shape != x.shape:
        raise ValueError(f"g2_ladder: x {tuple(x.shape)}, y {tuple(y.shape)}")
    if inf is not None and (inf.shape != (n,) or inf.device != dev):
        raise ValueError(f"g2_ladder: infinity flags {tuple(inf.shape)} on {inf.device}")
    prog = ladder_program(rec.nbits, rec.w)
    if rec.idx.shape[0] != prog.n_digits:
        raise ValueError(f"g2_ladder: {rec.idx.shape[0]} digits for {prog.n_digits}")
    xy = torch.cat([x, y], dim=1)
    flags = None if inf is None else inf.to(torch.uint8).contiguous()
    out_flags = torch.empty(n, dtype=torch.uint8, device=dev)
    out = _launch("g2_ladder", prog, dev, n, (xy,), flags, rec.correction,
                  _device_digits(rec, dev), out_flags, stamps)
    if n:
        ladder_counter.record(n)
    return out[:, :2], out[:, 2:], out_flags.bool()


def miller_grouped_cuda(g1: torch.Tensor, g2: torch.Tensor, stamps=None) -> torch.Tensor:
    """miller_loop_grouped in one launch of miller_grouped_kernel: g1
    [G, P, 2, 14], g2 [G, P, 2, 2, 14] int64 limbs on one CUDA device ->
    [G, 2, 3, 2, 14]."""
    dev = g1.device
    g1, g2 = _operand(g1, dev, "miller_grouped"), _operand(g2, dev, "miller_grouped")
    if g1.dim() != 4 or g1.shape[2:] != (2, L) or g2.shape != g1.shape[:2] + (2, 2, L):
        raise ValueError(f"miller_grouped: g1 {tuple(g1.shape)}, g2 {tuple(g2.shape)}")
    G, P = g1.shape[0], g1.shape[1]
    out = _launch("miller_grouped", miller_program(P), dev, G, (g1, g2),
                  stamps=stamps)
    if G:
        miller_counter.record((G, P))
    return out.reshape(G, 2, 3, 2, L)


def bundle_clocks(fn, prog: FP.Program, dev) -> np.ndarray:
    """[n_bundles] SM clock cycles of each bundle in block 0 of one launch
    (fn(stamps) launches it with a stamp buffer). A measurement: the
    launch is counted by its wrapper like any other."""
    stamps = torch.zeros(1 + prog.n_bundles, dtype=torch.int64, device=dev)
    fn(stamps)
    return np.diff(stamps.cpu().numpy())
