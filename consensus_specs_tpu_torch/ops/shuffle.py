"""Swap-or-not shuffle on torch tensors (port of consensus_specs_tpu/ops/shuffle.py).

The positional form of the network, as in the reference: each round is an
involution on positions, f_r(p) = (pivot_r - p) mod n iff the decision bit
at max(p, f_r(p)) is set, and X[f_r(p)] over all p is
roll(reverse(X), pivot + 1) — contiguous data movement, no gather. Applying
C[p] <- C[f_r(p)] with the rounds in reverse order leaves
C[p] = get_shuffled_index(p).

All rounds * ceil(n/256) round digests come from one batched single-block
SHA-256 call (plain torch: the reference computes them in XLA, not in a
Pallas kernel). The decision bits are expanded one round at a time inside
the round loop, so the [rounds, n] bit matrix (about 90 MB as bool at 1M
validators) is never held whole. Pivots are computed on the host with
hashlib, where the 64-bit modular reduction is free.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..device import resolve
from .sha256 import bytes_to_words, sha256_single_block, widen, words_tensor

_MAX_N = 1 << 30

# bit k of digest word j's 32 bits decides position 32j + k: byte k // 8
# of the big-endian word, bit k % 8 of that byte
_BIT_SHIFTS = np.array([24 - 8 * (k // 8) + k % 8 for k in range(32)],
                       dtype=np.int64)


def _round_digests(seed_words: torch.Tensor, n: int,
                   rounds: int) -> torch.Tensor:
    """[rounds, ceil(n/256), 8] int32 digests of seed ‖ round ‖ block index.

    Message layout (big-endian words): w0..w7 = seed; byte 32 = round,
    bytes 33..36 = block index little-endian, byte 37 = 0x80 terminator,
    w15 = bit length (37*8)."""
    dev = seed_words.device
    n_blocks = (n + 255) // 256
    blk = torch.arange(n_blocks, dtype=torch.int64, device=dev)[None, :]
    rnd = torch.arange(rounds, dtype=torch.int64, device=dev)[:, None]
    w8 = ((rnd << 24) | ((blk & 0xFF) << 16) | (((blk >> 8) & 0xFF) << 8)
          | ((blk >> 16) & 0xFF))
    w9 = ((((blk >> 24) & 0xFF) << 24) | (0x80 << 16)).expand(rounds, n_blocks)
    zeros = torch.zeros((rounds, n_blocks), dtype=torch.int64, device=dev)
    w15 = torch.full((rounds, n_blocks), 37 * 8, dtype=torch.int64, device=dev)
    seed = widen(seed_words)
    words = torch.stack(
        [seed[i].expand(rounds, n_blocks) for i in range(8)]
        + [w8.expand(rounds, n_blocks), w9, zeros, zeros, zeros, zeros,
           zeros, w15], dim=-1)
    return sha256_single_block(words.to(torch.int32))


def _round_bits(digests_r: torch.Tensor, n: int) -> torch.Tensor:
    """[ceil(n/256), 8] digests of one round -> [n] bool decision bits."""
    shifts = torch.from_numpy(_BIT_SHIFTS).to(digests_r.device)
    bits = (widen(digests_r)[..., None] >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def host_pivots(seed: bytes, n: int, rounds: int) -> np.ndarray:
    """Per-round pivots: the round hash's first 8 bytes, little-endian,
    mod n."""
    pivots = np.empty(rounds, dtype=np.int32)
    for r in range(rounds):
        digest = hashlib.sha256(seed + bytes([r])).digest()
        pivots[r] = int.from_bytes(digest[:8], "little") % n
    return pivots


def _shuffle_rounds(seed_words: torch.Tensor, pivots: np.ndarray, n: int,
                    rounds: int) -> torch.Tensor:
    """seed_words: [8] int32 (big-endian seed); pivots: [rounds] host ints.
    Returns perm [n] int32 with perm[p] = image of index p."""
    digests = _round_digests(seed_words, n, rounds)
    pos = torch.arange(n, dtype=torch.int32, device=seed_words.device)
    C = pos
    for k in range(rounds):
        r = rounds - 1 - k          # reverse round order -> forward permutation
        pivot = int(pivots[r])
        flip = pivot - pos
        flip = torch.where(flip < 0, flip + n, flip)
        shift = pivot + 1
        C_flip = torch.roll(C.flip(0), shift)
        bits_r = _round_bits(digests[r], n)
        bits_flip = torch.roll(bits_r.flip(0), shift)
        bit_at_max = torch.where(pos >= flip, bits_r, bits_flip)
        C = torch.where(bit_at_max, C_flip, C)
    return C


def shuffle_permutation_on_device(seed: bytes, index_count: int, rounds: int,
                                  device="cuda") -> torch.Tensor:
    """perm[i] == get_shuffled_index(i, index_count, seed), an int32 tensor
    on `device`. Only the 32-byte seed and the pivots come from the host."""
    dev = resolve(device)
    n = int(index_count)
    if not 0 < n < _MAX_N:
        raise ValueError(f"index_count must be in (0, 2**30), got {n}")
    seed_words = words_tensor(
        bytes_to_words(np.frombuffer(seed, dtype=np.uint8)), dev)
    return _shuffle_rounds(seed_words, host_pivots(seed, n, rounds), n, rounds)


def shuffle_permutation_device(seed: bytes, index_count: int, rounds: int,
                               device="cuda") -> np.ndarray:
    """Host-facing wrapper: the same permutation as numpy int64."""
    return shuffle_permutation_on_device(
        seed, index_count, rounds, device).cpu().numpy().astype(np.int64)
