"""Wrapper of the hand-written SHA-256 pair-hash kernel (csrc/sha256_pairs.cu).

The CUDA counterpart of consensus_specs_tpu/ops/sha256_pallas.py: the same
[N, 16] -> [N, 8] function, one thread per message. Its plain twin is
ops.sha256.sha256_pairs; ops.sha256.pair_hash_words routes CUDA tensors
here and CPU tensors there.
"""
from __future__ import annotations

import ctypes

import torch

from ._nvcc import load_library

# The work of one lane in Hopper instructions (see the source's header).
# Logic, shifts and rotates (3-input LOP3, SHF) run only on the integer
# ALU pipe: 10 per round (Sigma1, Sigma0: three rotates and one xor3 each;
# Ch, Maj: one LOP3 each) over 128 rounds, 8 per schedule step over 48.
# Adds are 3-input IADD3 (4 per round, 2 per schedule step, 16
# feed-forward) and may also issue as IMAD on the multiply-add pipe.
ALU_OPS_PER_LANE = 128 * 10 + 48 * 8
ADD_OPS_PER_LANE = 128 * 4 + 48 * 2 + 16
BYTES_PER_LANE = 64 + 32


def bound_ms(lanes: int, int_ops_per_s: float, bytes_per_s: float):
    """(ms, "operations" | "bytes"): the least time for `lanes` lanes.

    Operations: the ALU-only instructions at the 32-bit integer rate of
    one pipe, or all instructions split evenly over two pipes, whichever
    is longer. Bytes: each input read and each output written once."""
    ops = max(ALU_OPS_PER_LANE, (ALU_OPS_PER_LANE + ADD_OPS_PER_LANE) / 2)
    ops_ms = ops * lanes / int_ops_per_s * 1e3
    bytes_ms = BYTES_PER_LANE * lanes / bytes_per_s * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class _Counter:
    """Launch count of the kernel: one per launch, nowhere else."""

    def __init__(self) -> None:
        self.launches = 0


counter = _Counter()

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = load_library("sha256_pairs").sha256_pairs_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def sha256_pairs_cuda(words: torch.Tensor) -> torch.Tensor:
    """[N, 16] int32 words on a CUDA device -> [N, 8] int32 digests."""
    if not words.is_cuda:
        raise ValueError("sha256_pairs_cuda needs a CUDA tensor")
    if words.dtype != torch.int32:
        raise TypeError(f"expected int32 words, got {words.dtype}")
    if words.dim() != 2 or words.shape[1] != 16:
        raise ValueError(f"expected [N, 16] words, got {tuple(words.shape)}")
    if not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError("words must be contiguous and 16-byte aligned")
    n = words.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = fn(words.data_ptr(), out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"sha256_pairs kernel launch failed: cudaError {err}")
    counter.launches += 1
    return out
