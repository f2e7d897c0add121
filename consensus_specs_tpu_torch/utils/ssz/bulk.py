"""Registry and balances roots from device-resident columns
(port of the device half of consensus_specs_tpu/utils/ssz/bulk.py).

Columns: pubkeys [V, 48] and withdrawal credentials [V, 32] uint8; epochs,
effective balance and balances [V] int64 holding uint64 bit patterns;
slashed [V] bool. Every pair hash — each validator's pubkey chunk pair,
the levels of its 8-leaf field subtree, every list-tree level and the
mix_in_length hash — goes through `pair_fn`, which defaults to
ops.sha256.pair_hash_words (the CUDA kernel for CUDA tensors). The checks
pass the plain ops.sha256.sha256_pairs to drive the same path without it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops.intmath import ushr
from ...ops.sha256 import (PairFn, bytes_to_words, merkle_reduce_words,
                           narrow, pair_hash_words, subtree_roots_words,
                           words_tensor, words_to_bytes)
from ..hash import ZERO_BYTES32, sha256


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of int64 values in [0, 2**32) (little-endian value bytes
    -> big-endian SHA word); the result stays in the int64 domain."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def _u64_halves_words(col: torch.Tensor):
    """[V] uint64 bit patterns -> (w0, w1) int64 SHA words of the value's
    little-endian bytes 0..3 and 4..7."""
    return _bswap32(col & 0xFFFFFFFF), _bswap32(ushr(col, 32))


def _u64_col_words(col: torch.Tensor) -> torch.Tensor:
    """[V] uint64 -> [V, 8] int32 words of each value's one-chunk leaf
    (little-endian bytes 0..7, zero bytes 8..31)."""
    w0, w1 = _u64_halves_words(col.to(torch.int64))
    zero = torch.zeros_like(w0)
    return narrow(torch.stack([w0, w1] + [zero] * 6, dim=-1))


def _u8_mat_words(mat: torch.Tensor) -> torch.Tensor:
    """[..., 4k] uint8 -> [..., k] int32 big-endian words."""
    m = mat.to(torch.int64).reshape(mat.shape[:-1] + (-1, 4))
    return narrow((m[..., 0] << 24) | (m[..., 1] << 16)
                  | (m[..., 2] << 8) | m[..., 3])


def _length_chunk_words(n: int) -> np.ndarray:
    """[1, 8] words of SSZ mix_in_length's little-endian length chunk."""
    chunk = np.zeros(32, dtype=np.uint8)
    chunk[:8] = np.frombuffer(int(n).to_bytes(8, "little"), np.uint8)
    return bytes_to_words(chunk)[None, :]


def mix_in_length(root_words: torch.Tensor, length: int,
                  pair_fn: Optional[PairFn] = None) -> torch.Tensor:
    """[8] root words -> [8] words of sha256(root ‖ length chunk), hashed
    on the root's device."""
    fn = pair_fn or pair_hash_words
    length_words = words_tensor(_length_chunk_words(length), root_words.device)
    return fn(torch.cat([root_words[None, :], length_words], dim=1))[0]


def _registry_leaf_words(pubkeys, wc, act_elig, act, exit_ep, withdrawable,
                         slashed, eff_balance,
                         pair_fn: Optional[PairFn] = None) -> torch.Tensor:
    """SoA validator columns -> [V, 8] per-validator root words (the
    leaves of the registry list tree)."""
    fn = pair_fn or pair_hash_words
    V = pubkeys.shape[0]
    # pubkey: Bytes48 -> two chunks -> one pair hash
    pk_padded = torch.cat(
        [pubkeys, torch.zeros((V, 16), dtype=pubkeys.dtype,
                              device=pubkeys.device)], dim=1)
    pk_root = fn(_u8_mat_words(pk_padded))                        # [V, 8]
    leaves = torch.stack([
        pk_root,
        _u8_mat_words(wc),
        _u64_col_words(act_elig),
        _u64_col_words(act),
        _u64_col_words(exit_ep),
        _u64_col_words(withdrawable),
        _u64_col_words(slashed.to(torch.int64)),   # bool chunk: byte0 = 0/1
        _u64_col_words(eff_balance),
    ], dim=1)                                                     # [V, 8, 8]
    return subtree_roots_words(leaves, fn)                        # [V, 8]


def _balances_chunk_words(balances: torch.Tensor) -> torch.Tensor:
    """[V] uint64 -> [C, 8] int32 SSZ pack chunk words (4 values per
    32-byte chunk) — level 0 of the balances list tree."""
    col = balances.to(torch.int64)
    pad = (-col.shape[0]) % 4
    if pad:
        col = torch.cat([col, torch.zeros(pad, dtype=torch.int64,
                                          device=col.device)])
    w0, w1 = _u64_halves_words(col)
    return narrow(torch.stack([w0, w1], dim=-1).reshape(-1, 8))


def _list_root_words(chunks: torch.Tensor, length: int,
                     pair_fn: Optional[PairFn]) -> torch.Tensor:
    return mix_in_length(merkle_reduce_words(chunks, pair_fn), length, pair_fn)


def _empty_list_root() -> bytes:
    """mix_in_length(merkleize([]), 0): the root of an empty list."""
    return sha256(ZERO_BYTES32 + ZERO_BYTES32)


def registry_and_balances_roots_device(
        pubkeys, withdrawal_credentials, activation_eligibility_epoch,
        activation_epoch, exit_epoch, withdrawable_epoch, slashed,
        effective_balance, balances,
        pair_fn: Optional[PairFn] = None):
    """(registry_root, balances_root) as 32-byte strings, computed on the
    columns' device; only the 64 bytes of roots come back. An empty list
    short-circuits to the empty-list root without touching the device."""
    V = pubkeys.shape[0]
    if V == 0:
        r1 = _empty_list_root()
    else:
        leaves = _registry_leaf_words(
            pubkeys, withdrawal_credentials, activation_eligibility_epoch,
            activation_epoch, exit_epoch, withdrawable_epoch, slashed,
            effective_balance, pair_fn)
        r1 = words_to_bytes(_list_root_words(leaves, V, pair_fn)).tobytes()
    n_bal = balances.shape[0]
    if n_bal == 0:
        r2 = _empty_list_root()
    else:
        r2 = words_to_bytes(_list_root_words(
            _balances_chunk_words(balances), n_bal, pair_fn)).tobytes()
    return r1, r2


# level 0 of the registry and balances incremental forests (resident.py)
registry_leaf_words_device = _registry_leaf_words
balances_chunk_words_device = _balances_chunk_words
