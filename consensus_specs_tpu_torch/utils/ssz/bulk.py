"""Bulk hash_tree_root for the big state vectors (port of
consensus_specs_tpu/utils/ssz/bulk.py: the host half and the device half).

Host half. The recursive object-model Merkleizer (impl.hash_tree_root)
walks every element through Python; the functions below compute the same
roots from columns: a List[Container] of fixed-size basic/BytesN fields
becomes a [V, P, 32] chunk array built with numpy column ops and reduced
level by level, basic lists pack straight into [C, 32] chunk matrices, and
Bytes32 vectors already are chunk matrices. `hash_tree_root_bulk` mirrors
impl.hash_tree_root's dispatch and routes any shape it cannot vectorize
back through the recursive oracle, so it is bit-identical by construction.

Every hashing function takes the caller's `device` (and optionally
`pair_fn`): a level of at least _DEVICE_MIN_PAIRS pairs goes through
ops.sha256.pair_hash_words on that device (the CUDA kernel for a CUDA
device, the plain twin on the CPU; `pair_fn` replaces it, as the checks
do); smaller levels, and every level when `device` is None, stay on
hashlib. A content-keyed memo turns unchanged subtrees into dict hits.

Tree handles. build_chunk_tree(chunks, device, pair_fn) keeps a chunk
matrix's Merkle levels resident on `device` (utils/ssz/incremental.py)
and re-hashes only the root paths of updated or appended rows; its memo
entries are evicted together with the forest's invalidation.

Device half. Registry and balances roots from device-resident columns:
pubkeys [V, 48] and withdrawal credentials [V, 32] uint8; epochs,
effective balance and balances [V] int64 holding uint64 bit patterns;
slashed [V] bool. Every pair hash -- each validator's pubkey chunk pair,
the levels of its 8-leaf field subtree, every list-tree level and the
mix_in_length hash -- goes through `pair_fn`, which defaults to
ops.sha256.pair_hash_words.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ...device import resolve
from ...ops.intmath import ushr
from ...ops.sha256 import (PairFn, bytes_to_words, merkle_reduce_words,
                           narrow, pair_hash_words, subtree_roots_words,
                           words_tensor, words_to_bytes)
from ..hash import ZERO_BYTES32, sha256, zerohashes
from . import impl
from .typing import (
    is_bool_type, is_bytesn_type, is_container_type, is_list_kind,
    is_list_type, is_uint_type, is_vector_type, read_elem_type,
    uint_byte_size)

# below this many 64-byte pair inputs a level stays on hashlib: the device
# route pays an upload, a launch per level and a download
_DEVICE_MIN_PAIRS = 1 << 15


# ---------------------------------------------------------------------------
# Array-level hashing primitives (host half)
# ---------------------------------------------------------------------------

def hash_pairs_array(pairs: np.ndarray, device=None,
                     pair_fn: Optional[PairFn] = None) -> np.ndarray:
    """[N, 64] uint8 -> [N, 32] uint8 SHA-256.

    With a `device`, a batch of at least _DEVICE_MIN_PAIRS pairs is hashed
    there in one pair_fn call (default ops.sha256.pair_hash_words: the
    kernel on a CUDA device). The reference pads device batches to a power
    of two for its jit cache; the kernel has no shape cache, so the batch
    goes as it is."""
    n = pairs.shape[0]
    if device is not None and n >= _DEVICE_MIN_PAIRS:
        fn = pair_fn or pair_hash_words
        words = words_tensor(bytes_to_words(np.ascontiguousarray(pairs)),
                             resolve(device))
        return words_to_bytes(fn(words))
    sha = hashlib.sha256
    # an all-identical level (a vector filled with one root, e.g. the
    # genesis active-index roots) hashes once -- O(n) check, no sort
    if n >= 64 and (pairs == pairs[0]).all():
        row = np.frombuffer(sha(pairs[0].tobytes()).digest(), np.uint8)
        out = np.empty((n, 32), dtype=np.uint8)
        out[:] = row
        return out
    buf = pairs.tobytes()
    digests = b"".join(sha(buf[64 * i:64 * i + 64]).digest()
                       for i in range(n))
    return np.frombuffer(digests, np.uint8).reshape(n, 32)


# Content-keyed merkleization memo. sha256 trees are pure functions of
# their input bytes, so (kind, raw bytes) -> result is sound whatever
# device or pair function computed it. The per-slot full-state root
# recomputes every field subtree while process_slot changed only a handful
# of entries; the memo turns each unchanged subtree into one key build plus
# a dict hit. Bounded by accumulated key bytes and cleared wholesale when
# exceeded (the next state root repopulates the live set).
_MEMO_MAX_BYTES = 96 * 1024 * 1024
_MEMO_MAX_KEY = _MEMO_MAX_BYTES // 16   # one entry must never dominate the cap
_MEMO_MIN_CHUNKS = 64         # below this, hashing is cheaper than keying
_memo: dict = {}
_memo_bytes = 0


def _memo_put(kind, key: bytes, value) -> None:
    global _memo_bytes
    if _memo_bytes > _MEMO_MAX_BYTES:
        _memo.clear()
        _memo_bytes = 0
    _memo[(kind, key)] = value
    _memo_bytes += len(key) + len(value) + 64


def _memo_evict(kind, key: bytes) -> None:
    """Drop one memo entry (mirror of _memo_put's accounting). The tree
    handles call it when a forest invalidates a leaf range: the entries
    they inserted for the superseded content come out at once instead of
    lingering until the wholesale cap clear."""
    global _memo_bytes
    value = _memo.pop((kind, key), None)
    if value is not None:
        _memo_bytes = max(0, _memo_bytes - (len(key) + len(value) + 64))


def clear_memo() -> None:
    """Forget every memoized subtree (a check that must hash everything
    again through another pair function starts from here)."""
    global _memo_bytes
    _memo.clear()
    _memo_bytes = 0


def _zero_chunk_rows(n: int, depth: int) -> np.ndarray:
    row = np.frombuffer(zerohashes[depth], dtype=np.uint8)
    return np.broadcast_to(row, (n, 32))


def merkleize_chunk_array(chunks: np.ndarray, device=None,
                          pair_fn: Optional[PairFn] = None) -> bytes:
    """Root over an [N, 32] uint8 chunk matrix (next-pow2 zero padding),
    identical to merkle.merkleize_chunks on the equivalent byte list.

    Pairs of zero-subtree roots hash to the next zero-subtree root by
    definition, so they are filled from the zerohash table instead of
    hashed: the big state vectors are mostly zero-suffixed."""
    n = chunks.shape[0]
    if n == 0:
        return ZERO_BYTES32
    key = None
    if _MEMO_MIN_CHUNKS <= n and n * 32 <= _MEMO_MAX_KEY:
        key = chunks.tobytes()
        hit = _memo.get(("mca", key))
        if hit is not None:
            return hit
    level = np.ascontiguousarray(chunks)
    depth = 0
    while level.shape[0] > 1:
        if level.shape[0] % 2 == 1:
            level = np.concatenate([level, _zero_chunk_rows(1, depth)])
        pairs = level.reshape(-1, 64)
        zero_pair = np.frombuffer(zerohashes[depth] * 2, dtype=np.uint8)
        nonzero = ~np.all(pairs == zero_pair, axis=1)
        depth += 1
        nxt = np.empty((pairs.shape[0], 32), dtype=np.uint8)
        nxt[:] = np.frombuffer(zerohashes[depth], np.uint8)
        if nonzero.any():
            nxt[nonzero] = hash_pairs_array(pairs[nonzero], device, pair_fn)
        level = nxt
    root = level[0].tobytes()
    if key is not None:
        _memo_put("mca", key, root)
    return root


def subtree_roots_batch(leaves: np.ndarray, device=None,
                        pair_fn: Optional[PairFn] = None) -> np.ndarray:
    """[V, P, 32] uint8 (P a power of two) -> [V, 32] subtree roots.

    All V subtrees descend one level per hash call: the [V, P/2, 64] array
    flattens into one (V*P/2)-lane batch, so the device sees
    registry-sized batches even though each element's tree is tiny."""
    V, P, _ = leaves.shape
    assert P & (P - 1) == 0, "pad element chunk count to a power of two"
    key = None
    if _MEMO_MIN_CHUNKS <= V * P and V * P * 32 <= _MEMO_MAX_KEY:
        key = leaves.tobytes()
        hit = _memo.get((("srb", P), key))
        if hit is not None:
            return np.frombuffer(hit, np.uint8).reshape(V, 32).copy()
    level = leaves
    while level.shape[1] > 1:
        level = hash_pairs_array(
            level.reshape(-1, 64), device, pair_fn).reshape(
                V, level.shape[1] // 2, 32)
    roots = level[:, 0, :]
    if key is not None:
        _memo_put(("srb", P), key, np.ascontiguousarray(roots).tobytes())
    return roots


# ---------------------------------------------------------------------------
# Tree-handle API: build -> update(leaf_idx, rows) -> root
#
# merkleize_chunk_array answers one-shot roots; a caller that OWNS a chunk
# matrix and changes a few rows at a time gets a persistent handle instead:
# the incremental forest (utils/ssz/incremental.py) keeps every tree level
# resident on the device and re-hashes only the dirty root paths,
# O(dirty * log N) pair lanes a root instead of O(N).
# ---------------------------------------------------------------------------

class ChunkTreeHandle:
    """Incremental root over an [N, 32] uint8 chunk matrix, its forest on
    `device` (the kernel pair hash on a CUDA device unless `pair_fn`
    replaces it).

    Keeps a host mirror of the chunks (updates come from the host) so the
    content-keyed memo stays coherent: `root()` inserts its result under
    the current content key as merkleize_chunk_array does, and every
    invalidation (update / append) EVICTS the entries this handle put
    there. Forest invalidation and memo eviction move together, so a stale
    root is never served for superseded content. A rejected update (the
    forest validates before it writes) leaves mirror and forest as they
    were."""

    def __init__(self, chunks: np.ndarray, device="cuda",
                 pair_fn: Optional[PairFn] = None):
        from .incremental import tree_from_chunks
        self._chunks = np.array(chunks, dtype=np.uint8)   # owned host mirror
        if self._chunks.ndim != 2 or self._chunks.shape[1] != 32:
            raise ValueError(f"expected [n, 32] chunks, got {self._chunks.shape}")
        self.tree = tree_from_chunks(self._chunks, pair_fn, device)
        self._memo_keys: list = []
        self._memo_stale = True   # content not yet offered to the memo

    @property
    def n(self) -> int:
        return self._chunks.shape[0]

    def root(self) -> bytes:
        root = self.tree.root()
        n = self.n
        # offer the root to the shared memo ONCE per content generation:
        # the O(N) key build must not recur on every steady-state root
        if (self._memo_stale and _MEMO_MIN_CHUNKS <= n
                and n * 32 <= _MEMO_MAX_KEY):
            key = self._chunks.tobytes()
            if ("mca", key) not in _memo:
                _memo_put("mca", key, root)
                self._memo_keys.append(("mca", key))
            self._memo_stale = False
        return root

    def _rows_words(self, rows: np.ndarray) -> torch.Tensor:
        words = (bytes_to_words(rows) if rows.shape[0]
                 else np.zeros((0, 8), np.uint32))
        return words_tensor(words, self.tree.device)

    def update(self, leaf_idx, rows: np.ndarray) -> None:
        """Overwrite chunk rows; O(len(leaf_idx) * log N) re-hash."""
        rows = np.asarray(rows, np.uint8).reshape(-1, 32)
        self.invalidate_memo()
        # the forest validates (unique, in range) BEFORE it writes: a
        # rejected update must leave mirror and forest consistent, or the
        # next root() would memoize the old root under the new content key
        self.tree.update(leaf_idx, self._rows_words(rows))
        self._chunks[np.asarray(leaf_idx, np.int64)] = rows

    def append(self, rows: np.ndarray) -> None:
        """Grow the chunk matrix (crossing padded powers of two included)."""
        rows = np.asarray(rows, np.uint8).reshape(-1, 32)
        self.invalidate_memo()
        self.tree.append(self._rows_words(rows))
        self._chunks = np.concatenate([self._chunks, rows])

    def invalidate_memo(self) -> None:
        """Evict every memo entry this handle inserted (its content is
        about to be superseded)."""
        for kind, key in self._memo_keys:
            _memo_evict(kind, key)
        self._memo_keys.clear()
        self._memo_stale = True


def build_chunk_tree(chunks: np.ndarray, device="cuda",
                     pair_fn: Optional[PairFn] = None) -> ChunkTreeHandle:
    """Tree-handle entry point (`build` of build -> update -> root)."""
    return ChunkTreeHandle(chunks, device, pair_fn)


# ---------------------------------------------------------------------------
# Column -> chunk builders (numpy, no per-element Python)
# ---------------------------------------------------------------------------

def uint_column_chunks(values: Sequence[int], byte_len: int) -> np.ndarray:
    """[V] ints -> [V, 32] one-chunk-per-value little-endian leaves."""
    v = len(values)
    out = np.zeros((v, 32), dtype=np.uint8)
    if byte_len <= 8:
        col = np.asarray(values, dtype=np.uint64)
        out[:, :8] = col.astype("<u8").view(np.uint8).reshape(v, 8)
    else:
        for i, x in enumerate(values):  # uint128/uint256 columns are rare
            out[i, :byte_len] = np.frombuffer(
                int(x).to_bytes(byte_len, "little"), np.uint8)
    return out


def bool_column_chunks(values: Sequence[bool]) -> np.ndarray:
    v = len(values)
    out = np.zeros((v, 32), dtype=np.uint8)
    out[:, 0] = np.asarray(values, dtype=np.uint8)
    return out


def bytes_column_matrix(values: Sequence[bytes], length: int) -> np.ndarray:
    """[V] equal-length byte strings -> [V, length] uint8."""
    joined = b"".join(values)
    return np.frombuffer(joined, dtype=np.uint8).reshape(len(values), length)


def bytesn_column_leaves(values: Sequence[bytes], length: int, device=None,
                         pair_fn: Optional[PairFn] = None) -> np.ndarray:
    """[V] Bytes[N] values -> [V, 32] hash_tree_root leaves (the mini-tree
    of N > 32 hashed in one batch per level: Bytes48 -> 1 level, Bytes96
    -> 2)."""
    mat = bytes_column_matrix(values, length)
    v = mat.shape[0]
    n_chunks = (length + 31) // 32
    if n_chunks == 1:
        out = np.zeros((v, 32), dtype=np.uint8)
        out[:, :length] = mat
        return out
    pad = 1
    while pad < n_chunks:
        pad *= 2
    chunks = np.zeros((v, pad, 32), dtype=np.uint8)
    flat = chunks.reshape(v, pad * 32)
    flat[:, :length] = mat
    return subtree_roots_batch(chunks, device, pair_fn)


def pack_basic_list_chunks(values: Sequence[Any], elem_type: Any) -> np.ndarray:
    """Pack a basic-element series into its [C, 32] chunk matrix (SSZ
    pack)."""
    if isinstance(values, bytes):
        data = np.frombuffer(values, dtype=np.uint8)
    elif is_bool_type(elem_type):
        data = np.asarray(values, dtype=np.uint8)
    else:
        size = uint_byte_size(elem_type)
        if size == 8:
            data = np.asarray(values, dtype=np.uint64).astype("<u8").view(np.uint8)
        else:
            data = np.frombuffer(
                b"".join(int(x).to_bytes(size, "little") for x in values), np.uint8)
    n = data.shape[0]
    c = max(1, (n + 31) // 32)
    out = np.zeros((c, 32), dtype=np.uint8)
    out.reshape(-1)[:n] = data
    return out


# ---------------------------------------------------------------------------
# Container-list fast path
# ---------------------------------------------------------------------------

def _is_fast_field(typ: Any) -> bool:
    return is_uint_type(typ) or is_bool_type(typ) or is_bytesn_type(typ)


def container_list_is_fast(elem_type: Any) -> bool:
    return is_container_type(elem_type) and all(
        _is_fast_field(t) for t in elem_type.get_field_types())


def container_column_leaves(columns: Dict[str, Any], elem_type: Any,
                            count: int, device=None,
                            pair_fn: Optional[PairFn] = None) -> np.ndarray:
    """Columns (field name -> [V] sequence) -> [V, P, 32] leaf array."""
    fields = elem_type.get_fields()
    pad = 1
    while pad < len(fields):
        pad *= 2
    leaves = np.zeros((count, pad, 32), dtype=np.uint8)
    for k, (name, ftyp) in enumerate(fields):
        col = columns[name]
        if is_uint_type(ftyp):
            leaves[:, k, :] = uint_column_chunks(col, uint_byte_size(ftyp))
        elif is_bool_type(ftyp):
            leaves[:, k, :] = bool_column_chunks(col)
        elif is_bytesn_type(ftyp):
            leaves[:, k, :] = bytesn_column_leaves(col, ftyp.length, device,
                                                   pair_fn)
        else:
            raise TypeError(f"not a fast column field: {ftyp}")
    return leaves


def container_list_roots(objs: Sequence[Any], elem_type: Any, device=None,
                         pair_fn: Optional[PairFn] = None) -> np.ndarray:
    """[V] container objects -> [V, 32] element hash_tree_roots (bulk)."""
    columns = {
        name: [getattr(o, name) for o in objs]
        for name, _ in elem_type.get_fields()
    }
    leaves = container_column_leaves(columns, elem_type, len(objs), device,
                                     pair_fn)
    return subtree_roots_batch(leaves, device, pair_fn)


# ---------------------------------------------------------------------------
# Generic bulk dispatcher
# ---------------------------------------------------------------------------

def hash_tree_root_bulk(obj: Any, typ: Any = None, device=None,
                        pair_fn: Optional[PairFn] = None) -> bytes:
    """Same value as impl.hash_tree_root, with batched fast paths for big
    homogeneous collections. Falls back to the recursive oracle for
    anything it can't vectorize."""
    if typ is None:
        return impl.hash_tree_root(obj)

    if impl.is_bottom_layer_kind(typ) and not impl.is_basic_type(typ):
        chunks = pack_basic_list_chunks(obj, read_elem_type(typ))
        root = merkleize_chunk_array(chunks, device, pair_fn)
        return impl.mix_in_length(root, len(obj)) if is_list_kind(typ) else root

    if is_list_type(typ) or is_vector_type(typ):
        elem = typ.elem_type
        n = len(obj)
        if n == 0:
            leaves: Optional[np.ndarray] = np.zeros((0, 32), dtype=np.uint8)
        elif container_list_is_fast(elem):
            leaves = container_list_roots(list(obj), elem, device, pair_fn)
        elif is_bytesn_type(elem):
            leaves = bytesn_column_leaves([bytes(x) for x in obj], elem.length,
                                          device, pair_fn)
        else:
            leaves = np.stack([
                np.frombuffer(hash_tree_root_bulk(v, elem, device, pair_fn),
                              np.uint8)
                for v in obj])
        root = merkleize_chunk_array(leaves, device, pair_fn)
        return impl.mix_in_length(root, n) if is_list_kind(typ) else root

    if is_container_type(typ):
        leaves = np.stack([
            np.frombuffer(hash_tree_root_bulk(v, t, device, pair_fn), np.uint8)
            for v, t in obj.get_typed_values()])
        return merkleize_chunk_array(leaves, device, pair_fn)

    return impl.hash_tree_root(obj, typ)


def state_root_bulk(state: Any, device=None,
                    pair_fn: Optional[PairFn] = None) -> bytes:
    """BeaconState hash_tree_root via the bulk paths."""
    return hash_tree_root_bulk(state, state.__class__, device, pair_fn)


# ---------------------------------------------------------------------------
# SoA direct path (no object extraction at all)
# ---------------------------------------------------------------------------

def validator_leaf_chunks(
        pubkeys: np.ndarray, withdrawal_credentials: np.ndarray,
        activation_eligibility_epoch: np.ndarray, activation_epoch: np.ndarray,
        exit_epoch: np.ndarray, withdrawable_epoch: np.ndarray,
        slashed: np.ndarray, effective_balance: np.ndarray, device=None,
        pair_fn: Optional[PairFn] = None) -> np.ndarray:
    """[V, 8, 32] per-validator field-chunk subtrees from SoA arrays;
    subtree_roots_batch of the result gives each Validator's
    hash_tree_root. Shared by the registry root below and the resident
    core's dirty-leaf recompute."""
    V = pubkeys.shape[0]
    leaves = np.zeros((V, 8, 32), dtype=np.uint8)
    pk = np.zeros((V, 2, 32), dtype=np.uint8)
    pk.reshape(V, 64)[:, :48] = pubkeys
    leaves[:, 0, :] = subtree_roots_batch(pk, device, pair_fn)
    leaves[:, 1, :] = withdrawal_credentials
    for k, col in ((2, activation_eligibility_epoch), (3, activation_epoch),
                   (4, exit_epoch), (5, withdrawable_epoch)):
        leaves[:, k, :8] = np.asarray(col, dtype=np.uint64).astype(
            "<u8").view(np.uint8).reshape(V, 8)
    leaves[:, 6, 0] = np.asarray(slashed, dtype=np.uint8)
    leaves[:, 7, :8] = np.asarray(effective_balance, dtype=np.uint64).astype(
        "<u8").view(np.uint8).reshape(V, 8)
    return leaves


def validator_registry_root_from_columns(
        pubkeys: np.ndarray, withdrawal_credentials: np.ndarray,
        activation_eligibility_epoch: np.ndarray, activation_epoch: np.ndarray,
        exit_epoch: np.ndarray, withdrawable_epoch: np.ndarray,
        slashed: np.ndarray, effective_balance: np.ndarray, device=None,
        pair_fn: Optional[PairFn] = None) -> bytes:
    """List[Validator] root straight from SoA arrays (pubkeys [V,48] uint8,
    withdrawal_credentials [V,32] uint8, epochs/balances [V] uint64,
    slashed [V] bool): no per-validator Python."""
    V = pubkeys.shape[0]
    leaves = validator_leaf_chunks(
        pubkeys, withdrawal_credentials, activation_eligibility_epoch,
        activation_epoch, exit_epoch, withdrawable_epoch, slashed,
        effective_balance, device, pair_fn)
    roots = subtree_roots_batch(leaves, device, pair_fn)
    return impl.mix_in_length(merkleize_chunk_array(roots, device, pair_fn), V)


def uint64_list_root_from_column(values: np.ndarray, device=None,
                                 pair_fn: Optional[PairFn] = None) -> bytes:
    """List[uint64] root straight from a [V] uint64 array."""
    v = np.asarray(values, dtype=np.uint64)
    n = v.shape[0]
    c = max(1, (n * 8 + 31) // 32)
    out = np.zeros((c, 32), dtype=np.uint8)
    out.reshape(-1)[:n * 8] = v.astype("<u8").view(np.uint8)
    return impl.mix_in_length(merkleize_chunk_array(out, device, pair_fn), n)


# ---------------------------------------------------------------------------
# Device half: roots from device-resident columns
# ---------------------------------------------------------------------------


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
