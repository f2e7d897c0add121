"""Batched SHA-256 on torch tensors (port of consensus_specs_tpu/ops/sha256.py).

Word convention: a SHA-256 word is an int32 tensor element holding the
uint32 bit pattern, in the reference's layout ([N, 16] message words in,
[N, 8] digest words out). torch has no uint32 arithmetic on the CPU, so
the plain path widens to int64, masks every sum and rotate with
0xFFFFFFFF, and narrows back by subtracting 2**32 from values >= 2**31.

`pair_hash_words` is the Merkle pair-hash dispatcher: a CUDA tensor goes
to the hand-written kernel (ops/sha256_cuda.py, csrc/sha256_pairs.cu), a
CPU tensor to the plain `sha256_pairs` below. There is no fallback and no
switch. The reference's one-program traced reductions (merkle_reduce_words,
subtree_roots_words) inline the XLA compression; here each level is one
pair-hash call, so on the card each level is one kernel launch.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from ..utils.hash import zerohashes

# Round constants: fractional parts of cube roots of the first 64 primes.
K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

# Initial hash state: fractional parts of square roots of the first 8 primes.
H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

_M32 = 0xFFFFFFFF


def _padding_block_for_length(message_bytes: int) -> np.ndarray:
    """The final all-padding block for a message that exactly fills prior blocks."""
    blk = np.zeros(16, dtype=np.uint32)
    blk[0] = 0x80000000
    bitlen = message_bytes * 8
    blk[14] = (bitlen >> 32) & _M32
    blk[15] = bitlen & _M32
    return blk


_PAD_64 = _padding_block_for_length(64)  # padding block for 64-byte messages


# ---------------------------------------------------------------------------
# int32 bit patterns <-> the int64 working domain
# ---------------------------------------------------------------------------

def widen(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return words.to(torch.int64) & _M32


def narrow(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 bit patterns (explicit wrap)."""
    return torch.where(values >= 1 << 31, values - (1 << 32),
                       values).to(torch.int32)


def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 words -> int32 tensor of the same bit patterns."""
    w = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32).copy()).to(device)


def _doubled(x: torch.Tensor) -> torch.Tensor:
    """x in [0, 2**32) with a copy of itself in the high half: bits k..k+31
    of the result are x rotated right by k (0 <= k <= 32)."""
    return x | (x << 32)


def _compress(state, w):
    """One compression over int64 word lists (8 state, 16 message
    tensors, values in [0, 2**32)); returns the 8 new state words.

    A rotation is a shift of the doubled word. The sigma sums keep the
    doubled word's high bits: they only ever feed sums that are reduced
    mod 2**32 (every state word and schedule word is masked), and the low
    32 bits of a sum do not depend on the high bits of its terms. No sum
    leaves int64 (each term is below 2**62 in magnitude, at most four)."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i < 16:
            wi = w[i]
        else:
            x = w[(i - 15) % 16]
            y = w[(i - 2) % 16]
            xx, yy = _doubled(x), _doubled(y)
            s0 = (xx >> 7) ^ (xx >> 18) ^ (x >> 3)
            s1 = (yy >> 17) ^ (yy >> 19) ^ (y >> 10)
            wi = (w[i % 16] + s0 + w[(i - 7) % 16] + s1) & _M32
            w[i % 16] = wi
        ee, aa = _doubled(e), _doubled(a)
        S1 = (ee >> 6) ^ (ee >> 11) ^ (ee >> 25)
        ch = g ^ (e & (f ^ g))
        t1 = h + S1 + ch + (wi + int(K[i]))
        S0 = (aa >> 2) ^ (aa >> 13) ^ (aa >> 22)
        maj = (a & b) | (c & (a | b))
        a, b, c, d, e, f, g, h = ((t1 + S0 + maj) & _M32, a, b, c,
                                  (d + t1) & _M32, e, f, g)
    return [(s + t) & _M32 for s, t in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_blocks(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression. state: [..., 8] int32, block: [..., 16] int32."""
    s = widen(state)
    m = widen(block)
    out = _compress([s[..., i] for i in range(8)],
                    [m[..., i] for i in range(16)])
    return narrow(torch.stack(out, dim=-1))


def _h0_state(batch, device):
    return [torch.full(batch, int(v), dtype=torch.int64, device=device)
            for v in H0]


def sha256_pairs(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SHA-256 of N 64-byte messages: [N, 16] int32 -> [N, 8].

    Two compressions: the data block, then the constant padding block.
    This is the plain twin of the CUDA kernel; pair_hash_words calls it
    only for CPU tensors."""
    m = widen(words)
    batch = m.shape[:-1]
    state = _h0_state(batch, m.device)
    mid = _compress(state, [m[..., i] for i in range(16)])
    pad = [torch.full(batch, int(v), dtype=torch.int64, device=m.device)
           for v in _PAD_64]
    return narrow(torch.stack(_compress(mid, pad), dim=-1))


def sha256_single_block(words: torch.Tensor) -> torch.Tensor:
    """Hash messages that (with padding) fit one block: [..., 16] -> [..., 8].

    The caller has placed the 0x80 terminator and bit length into the
    words (see pad_to_single_block). Used by the shuffle."""
    m = widen(words)
    state = _h0_state(m.shape[:-1], m.device)
    out = _compress(state, [m[..., i] for i in range(16)])
    return narrow(torch.stack(out, dim=-1))


def pad_to_single_block(data: np.ndarray, message_bytes: int) -> np.ndarray:
    """Pad [..., message_bytes] uint8 arrays (<=55 bytes) into [..., 16]
    uint32 blocks (numpy; words_tensor uploads them)."""
    if message_bytes > 55:
        raise ValueError("a single block holds at most 55 message bytes")
    padded = np.zeros(data.shape[:-1] + (64,), dtype=np.uint8)
    padded[..., :message_bytes] = data
    padded[..., message_bytes] = 0x80
    bitlen = message_bytes * 8
    padded[..., 62] = (bitlen >> 8) & 0xFF
    padded[..., 63] = bitlen & 0xFF
    return bytes_to_words(padded)


# ---------------------------------------------------------------------------
# bytes <-> big-endian uint32 word bridging (host)
# ---------------------------------------------------------------------------

def bytes_to_words(data: np.ndarray) -> np.ndarray:
    """[..., 4k] uint8 -> [..., k] uint32 big-endian words."""
    if data.dtype != np.uint8 or data.shape[-1] % 4:
        raise ValueError("expected [..., 4k] uint8")
    return data.reshape(data.shape[:-1] + (-1, 4)).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32)


def words_to_bytes(words) -> np.ndarray:
    """[..., k] words (numpy, or an int32 tensor of bit patterns) ->
    [..., 4k] uint8 big-endian."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    words = np.asarray(words)
    if words.dtype == np.int32:
        words = words.view(np.uint32)
    words = words.astype(np.uint32)
    out = np.empty(words.shape + (4,), dtype=np.uint8)
    out[..., 0] = words >> 24
    out[..., 1] = (words >> 16) & 0xFF
    out[..., 2] = (words >> 8) & 0xFF
    out[..., 3] = words & 0xFF
    return out.reshape(words.shape[:-1] + (-1,))


def sha256_many(messages: np.ndarray, device="cuda") -> np.ndarray:
    """SHA-256 of N equal-length messages on `device`: [N, L] uint8 ->
    [N, 32] uint8, any L. The standard padded multi-block layout is built
    on the host; the blocks are compressed in sequence (sha256_blocks),
    each over all N messages at once."""
    dev = resolve(device)
    n, length = messages.shape
    n_blocks = (length + 9 + 63) // 64
    padded = np.zeros((n, n_blocks * 64), dtype=np.uint8)
    padded[:, :length] = messages
    padded[:, length] = 0x80
    padded[:, -8:] = np.frombuffer((length * 8).to_bytes(8, "big"), dtype=np.uint8)
    words = words_tensor(bytes_to_words(padded).reshape(n, n_blocks, 16), dev)
    state = narrow(torch.stack(_h0_state((n,), dev), dim=-1))
    for i in range(n_blocks):
        state = sha256_blocks(state, words[:, i, :])
    return words_to_bytes(state)


# ---------------------------------------------------------------------------
# Merkle pair hash and reductions
# ---------------------------------------------------------------------------

PairFn = Callable[[torch.Tensor], torch.Tensor]


def pair_hash_words(words: torch.Tensor) -> torch.Tensor:
    """[N, 16] int32 words -> [N, 8] digests.

    A CUDA tensor launches the hand-written kernel (raising if it cannot
    build or launch); a CPU tensor takes the plain sha256_pairs."""
    if words.is_cuda:
        from .sha256_cuda import sha256_pairs_cuda
        return sha256_pairs_cuda(words)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return sha256_pairs(words)


def zerohash_words(depth: int) -> np.ndarray:
    """[8] uint32 big-endian words of the depth-`depth` zero-subtree root."""
    return bytes_to_words(np.frombuffer(zerohashes[depth], dtype=np.uint8))


def zerohash_rows(depth: int, k: int, device) -> torch.Tensor:
    """[k, 8] int32 rows, every row the depth-`depth` zero-subtree root."""
    return words_tensor(zerohash_words(depth), device).expand(k, 8)


def merkle_reduce_words(chunks: torch.Tensor,
                        pair_fn: Optional[PairFn] = None) -> torch.Tensor:
    """[N, 8] chunk rows -> [8] root words (N >= 1), one pair-hash call
    per level. Odd levels pad with the zero-subtree root of that depth,
    which is SSZ merkleize's virtual zero-chunk padding."""
    fn = pair_fn or pair_hash_words
    level = chunks
    depth = 0
    while level.shape[0] > 1:
        if level.shape[0] % 2 == 1:
            level = torch.cat([level, zerohash_rows(depth, 1, level.device)])
        level = fn(level.reshape(-1, 16))
        depth += 1
    return level[0]


def subtree_roots_words(leaves: torch.Tensor,
                        pair_fn: Optional[PairFn] = None) -> torch.Tensor:
    """[V, P, 8] per-element subtrees -> [V, 8] roots; P a power of two.
    Every level of all V subtrees is one (V*P/2)-lane pair-hash call."""
    fn = pair_fn or pair_hash_words
    V, P, _ = leaves.shape
    if P & (P - 1):
        raise ValueError("pad the element chunk count to a power of two")
    level = leaves
    while level.shape[1] > 1:
        level = fn(level.reshape(-1, 16)).reshape(V, level.shape[1] // 2, 8)
    return level[:, 0, :]


def merkle_root_device(leaves: torch.Tensor, depth: int,
                       pair_fn: Optional[PairFn] = None) -> torch.Tensor:
    """Root words [8] of a power-of-two tree over [N, 8] leaf rows,
    N == 2**depth: one pair-hash call per level (on the card, one
    sha256_pairs launch)."""
    fn = pair_fn or pair_hash_words
    if leaves.shape[0] != 1 << depth:
        raise ValueError(f"{leaves.shape[0]} leaves for a tree of depth {depth}")
    level = leaves
    for _ in range(depth):
        level = fn(level.reshape(-1, 16))
    return level[0]


def merkle_root_from_leaves_device(leaves_bytes: Sequence[bytes], pad_to: int,
                                   device="cuda") -> bytes:
    """Merkle root of 32-byte leaves zero-padded to `pad_to` (a power of
    two), every level on `device`."""
    dev = resolve(device)
    n = len(leaves_bytes)
    if pad_to < 1 or pad_to & (pad_to - 1) or n > pad_to:
        raise ValueError(f"{n} leaves cannot pad to {pad_to}")
    depth = (pad_to - 1).bit_length()
    if n == 0:
        return zerohashes[depth]
    arr = np.zeros((pad_to, 32), dtype=np.uint8)
    arr[:n] = np.frombuffer(b"".join(leaves_bytes), dtype=np.uint8).reshape(n, 32)
    root = merkle_root_device(words_tensor(bytes_to_words(arr), dev), depth)
    return words_to_bytes(root).tobytes()
