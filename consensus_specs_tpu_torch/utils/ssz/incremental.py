"""Persistent, device-resident incremental Merkle forest
(port of consensus_specs_tpu/utils/ssz/incremental.py).

Every level of a tree stays resident as an [n_level, 8] int32 word tensor
and an update re-hashes only the root paths of the changed leaves: one
batched pair-hash call per level, O(dirty * log V) lanes instead of O(V).

Semantics are SSZ merkleize: the leaf count pads virtually to the next
power of two with zero chunks. Stored level d holds ceil(n / 2**d) rows;
rows beyond are virtual and equal zerohashes[d]. A full build pads each
odd level with that zero row before pairing, and an update whose parent
has no stored right child pairs the left child with it.

The reference donates each level buffer to a jitted scatter so XLA
rewrites it in place; here the scatter is an in-place `index_copy_` on the
resident level tensor. Dirty index sets still pad to the next power of
two (repeating the last index: duplicate lanes hash and write identical
rows), which keeps the pair-lane accounting identical to the reference's.

Process-wide forest accounting goes to the telemetry registry as the
reference's does: `merkle.forest.pair_lanes` (pair lanes hashed),
`merkle.forest.launches` (pair-hash calls, one per level an operation
touches; one per shard on a sharded level) and `merkle.forest.builds`
(full builds). The per-tree attributes (`last_pairs_per_level`,
`total_pairs_hashed`, `builds`) stay the view of one tree.

`ShardedIncrementalMerkleTree` is the forest under a serving mesh
(parallel/sharding.py): per-shard subtree levels on their shard, the cap
replicated.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...device import resolve
from ...parallel.exchange import Replicated, Sharded
from ...ops.sha256 import (PairFn, bytes_to_words, pair_hash_words,
                           words_tensor, words_to_bytes, zerohash_rows)
from ...telemetry import counter as _tele_counter
from ..hash import ZERO_BYTES32
from ..merkle import next_power_of_two, tree_depth

_PAIR_LANES = _tele_counter("merkle.forest.pair_lanes")
_PAIR_LAUNCHES = _tele_counter("merkle.forest.launches")
_FOREST_BUILDS = _tele_counter("merkle.forest.builds")


def _pad_pow2_indices(idx: np.ndarray) -> np.ndarray:
    """Pad an index vector to the next power of two by repeating its last
    entry."""
    m = next_power_of_two(idx.shape[0])
    if m == idx.shape[0]:
        return idx
    return np.concatenate([idx, np.full(m - idx.shape[0], idx[-1], idx.dtype)])


class IncrementalMerkleTree:
    """All levels of one pow2-padded SSZ Merkle tree, resident on the
    leaves' device.

    build:  IncrementalMerkleTree(leaf_words)   [n, 8] int32 words
    update: tree.update(leaf_idx, rows_words)   O(dirty * log n) lanes
    append: tree.append(rows_words)             grow, incl. past the padded pow2
    root:   tree.root_words() -> [8] on device; tree.root() -> 32 bytes

    List-kind callers mix the length in themselves. The tree owns
    `leaf_words` (level 0 is updated in place).
    """

    def __init__(self, leaf_words: torch.Tensor,
                 pair_fn: Optional[PairFn] = None):
        if leaf_words.dim() != 2 or leaf_words.shape[1] != 8 \
                or leaf_words.dtype != torch.int32:
            raise ValueError(f"expected [n, 8] int32 leaf words, got "
                             f"{tuple(leaf_words.shape)} {leaf_words.dtype}")
        self._pair_fn = pair_fn or pair_hash_words
        self.last_pairs_per_level: List[int] = []
        self.total_pairs_hashed = 0
        self.builds = 0
        self.levels: List[torch.Tensor] = [leaf_words.contiguous()]
        self._build()

    @property
    def n(self) -> int:
        return int(self.levels[0].shape[0])

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    @property
    def device(self) -> torch.device:
        return self.levels[0].device

    def _count(self, depth: int, lanes: int, launches: int = 1) -> None:
        while len(self.last_pairs_per_level) <= depth:
            self.last_pairs_per_level.append(0)
        self.last_pairs_per_level[depth] += lanes
        self.total_pairs_hashed += lanes
        _PAIR_LANES.inc(lanes)
        _PAIR_LAUNCHES.inc(launches)

    # -- full build (the epoch-boundary degenerate case) --------------------

    def _build(self) -> None:
        self.builds += 1
        _FOREST_BUILDS.inc()
        self.last_pairs_per_level = []
        level = self.levels[0]
        del self.levels[1:]
        for d in range(tree_depth(level.shape[0])):
            if level.shape[0] % 2:
                level = torch.cat([level, zerohash_rows(d, 1, self.device)])
            pairs = level.reshape(-1, 16)
            level = self._pair_fn(pairs)
            self._count(d, pairs.shape[0])
            self.levels.append(level)

    # -- incremental paths --------------------------------------------------

    def update(self, leaf_idx, rows_words: torch.Tensor) -> None:
        """Overwrite leaves and re-hash only their root paths.

        leaf_idx: [k] unique in-range ints (host); rows_words: [k, 8] int32
        on the tree's device."""
        idx = np.asarray(leaf_idx, dtype=np.int64).reshape(-1)
        rows = rows_words.reshape(-1, 8)
        if idx.shape[0] != rows.shape[0]:
            raise ValueError(f"{idx.shape[0]} indices for {rows.shape[0]} rows")
        self.last_pairs_per_level = []
        if idx.shape[0] == 0:
            return
        dirty = np.unique(idx)
        if dirty.shape[0] != idx.shape[0]:
            raise ValueError("duplicate leaf indices")
        if dirty[0] < 0 or dirty[-1] >= self.n:
            raise IndexError(f"leaf index out of range (n={self.n}); "
                             f"grow via append()")
        self.levels[0].index_copy_(
            0, torch.from_numpy(idx).to(self.device), rows)
        self._rehash_paths(dirty)

    def append(self, rows_words: torch.Tensor) -> None:
        """Append leaves, growing past the padded power of two when needed:
        every level extends with zero-subtree rows, new top levels appear
        as the padded depth deepens, and only the appended leaves' root
        paths re-hash (their ancestor chains cover every row whose value
        changes, including old odd tails that used to pair with a zero
        row)."""
        rows = rows_words.reshape(-1, 8)
        k = int(rows.shape[0])
        self.last_pairs_per_level = []
        if k == 0:
            return
        old_n = self.n
        new_n = old_n + k
        self.levels[0] = (rows.contiguous() if old_n == 0
                          else torch.cat([self.levels[0], rows]))
        for d in range(1, tree_depth(new_n) + 1):
            n_d = (new_n + (1 << d) - 1) >> d
            if d < len(self.levels):
                short = n_d - self.levels[d].shape[0]
                if short > 0:
                    self.levels[d] = torch.cat(
                        [self.levels[d], zerohash_rows(d, short, self.device)])
            else:
                # rows off the appended leaves' paths cover only virtual
                # zero leaves, whose value the zero-subtree root already is
                self.levels.append(
                    zerohash_rows(d, n_d, self.device).contiguous())
        self._rehash_paths(np.arange(old_n, new_n, dtype=np.int64))

    def _rehash_paths(self, dirty: np.ndarray) -> None:
        """Re-hash the ancestor rows of `dirty` leaves, one batched pair-hash
        call per level."""
        for d in range(self.depth):
            parents = np.unique(dirty >> 1)
            lanes = _pad_pow2_indices(parents)
            level = self.levels[d]
            n_d = level.shape[0]
            ri = lanes * 2 + 1
            left = level[torch.from_numpy(lanes * 2).to(self.device)]
            right = level[torch.from_numpy(np.minimum(ri, n_d - 1)).to(self.device)]
            virtual = ri >= n_d            # odd tail: right child is a zero row
            if virtual.any():
                right = torch.where(
                    torch.from_numpy(virtual).to(self.device)[:, None],
                    zerohash_rows(d, 1, self.device), right)
            digests = self._pair_fn(torch.cat([left, right], dim=1))
            self.levels[d + 1].index_copy_(
                0, torch.from_numpy(lanes).to(self.device), digests)
            self._count(d, int(lanes.shape[0]))
            dirty = parents

    # -- root ---------------------------------------------------------------

    def root_words(self) -> torch.Tensor:
        """[8] root words on the tree's device (zero chunk when empty)."""
        if self.n == 0:
            return torch.zeros(8, dtype=torch.int32, device=self.device)
        return self.levels[-1][0]

    def root(self) -> bytes:
        """The pow2-padded merkleize root as 32 bytes."""
        if self.n == 0:
            return ZERO_BYTES32
        return words_to_bytes(self.root_words()).tobytes()


class ShardedIncrementalMerkleTree(IncrementalMerkleTree):
    """The forest under a validator-axis ServingMesh: per-shard subtree
    levels stay on their shard (`Sharded`), a small replicated cap
    (`Replicated`) joins the shard roots, and update/append scatter only
    into the owning shard.

    Layout contract against the single-device tree: every level
    MATERIALIZES its pow2 padding (zerohash rows) instead of keeping it
    virtual, so capacity is always next_power_of_two(logical n), a
    multiple of the mesh size once it reaches it (both are powers of
    two). A level is sharded while its row count divides the mesh and
    replicated above. Padding rows equal the virtual zerohash rows they
    replace, so every stored node and the root are bit-identical to the
    single-device tree, at the same pair lanes per level.

    leaf_words: [rows, 8] int32 words (a tensor, or the mesh's placed
    level 0); with `logical_n`, rows must already be
    next_power_of_two(logical_n) (the mesh's leaf builders give that),
    otherwise they are zero-padded here. pair_fn None: the pair hash on
    each shard's device (the CUDA kernel on a card).
    """

    def __init__(self, leaf_words, placement, pair_fn: Optional[PairFn] = None,
                 logical_n: int = None):
        self._placement = placement
        self._exchange = placement.exchange
        self._pair_fn = pair_fn or pair_hash_words
        self._build_pair_fn = pair_fn
        rows = leaf_words.rows if isinstance(leaf_words, (Sharded, Replicated)) \
            else int(leaf_words.shape[0])
        if logical_n is None:
            logical_n = rows
            cap = next_power_of_two(max(rows, 1))
            if cap > rows:
                full = placement.gather(leaf_words)
                leaf_words = torch.cat([full, torch.zeros(
                    (cap - rows, 8), dtype=torch.int32, device=full.device)])
        elif rows != next_power_of_two(max(logical_n, 1)):
            raise ValueError(f"{rows} leaf rows for a logical count of {logical_n}")
        self._n = int(logical_n)
        self.last_pairs_per_level = []
        self.total_pairs_hashed = 0
        self.builds = 0
        self.levels = [placement.place(leaf_words)]
        self._build()

    @property
    def n(self) -> int:
        return self._n

    @property
    def device(self) -> torch.device:
        return self._placement.home

    def _build(self) -> None:
        self.builds += 1
        _FOREST_BUILDS.inc()
        self.last_pairs_per_level = []
        self.levels, lanes, launches = self._placement.forest_build(
            self.levels[0], self._build_pair_fn)
        for d, (k, m) in enumerate(zip(lanes, launches)):
            self._count(d, k, m)

    def _rows_of(self, level, idx: np.ndarray) -> torch.Tensor:
        """Rows `idx` of a level on the home device."""
        if isinstance(level, Replicated):
            return level.copies[0][torch.from_numpy(idx).to(level.copies[0].device)]
        return self._exchange.take(level, idx)

    def update(self, leaf_idx, rows_words) -> None:
        """Overwrite leaves (rows on any device) and re-hash only their
        root paths, each row written into its owning shard."""
        idx = np.asarray(leaf_idx, dtype=np.int64).reshape(-1)
        rows = rows_words.reshape(-1, 8)
        if idx.shape[0] != rows.shape[0]:
            raise ValueError(f"{idx.shape[0]} indices for {rows.shape[0]} rows")
        self.last_pairs_per_level = []
        if idx.shape[0] == 0:
            return
        dirty = np.unique(idx)
        if dirty.shape[0] != idx.shape[0]:
            raise ValueError("duplicate leaf indices")
        if dirty[0] < 0 or dirty[-1] >= self.n:
            raise IndexError(f"leaf index out of range (n={self.n}); "
                             f"grow via append()")
        self._exchange.put(self.levels[0], idx, rows)
        self._rehash_paths(dirty)

    def append(self, rows_words) -> None:
        """Append leaves: written into the materialized padding while it
        lasts; crossing the padded power of two grows every level with
        zerohash rows (they cover only virtual zero leaves), places each
        level again on the mesh (the one step that moves rows between
        shards) and deepens the cap."""
        rows = rows_words.reshape(-1, 8)
        k = int(rows.shape[0])
        self.last_pairs_per_level = []
        if k == 0:
            return
        old_n, new_n = self._n, self._n + k
        mesh = self._placement
        if new_n > self.levels[0].rows:
            new_cap = next_power_of_two(new_n)
            home = mesh.home
            for d, level in enumerate(self.levels):
                n_d = new_cap >> d
                full = mesh.gather(level)
                self.levels[d] = mesh.place(torch.cat(
                    [full, zerohash_rows(d, n_d - full.shape[0], home)]))
            for d in range(len(self.levels), tree_depth(new_cap) + 1):
                self.levels.append(mesh.place(
                    zerohash_rows(d, new_cap >> d, home).contiguous()))
        self._n = new_n
        idx = np.arange(old_n, new_n, dtype=np.int64)
        self._exchange.put(self.levels[0], idx, rows)
        self._rehash_paths(idx)

    def _rehash_paths(self, dirty: np.ndarray) -> None:
        """Re-hash the ancestor rows of `dirty` leaves: per level, the
        same pow2-padded lane set as the single-device tree, each shard
        hashing the lanes of its own rows (one launch a shard that has
        any); the cap's lanes are hashed on home and written into every
        copy."""
        for d in range(self.depth):
            parents = np.unique(dirty >> 1)
            lanes = _pad_pow2_indices(parents)
            level, nxt = self.levels[d], self.levels[d + 1]
            launches = 0
            if isinstance(nxt, Sharded):
                offs = nxt.offsets()
                owner = np.searchsorted(offs, lanes, side="right") - 1
                for s in np.unique(owner):
                    local = lanes[owner == s] - offs[s]
                    child = level.shards[s]
                    dev = child.device
                    pairs = torch.cat([
                        child[torch.from_numpy(local * 2).to(dev)],
                        child[torch.from_numpy(local * 2 + 1).to(dev)]], dim=1)
                    nxt.shards[s].index_copy_(0, torch.from_numpy(local).to(dev),
                                              self._pair_fn(pairs))
                    launches += 1
            else:
                pairs = torch.cat([self._rows_of(level, lanes * 2),
                                   self._rows_of(level, lanes * 2 + 1)], dim=1)
                self._exchange.put(nxt, lanes, self._pair_fn(pairs))
                launches = 1
            self._count(d, int(lanes.shape[0]), launches)
            dirty = parents

    def root_words(self) -> torch.Tensor:
        """[8] root words on the home device (zero chunk when empty)."""
        if self.n == 0:
            return torch.zeros(8, dtype=torch.int32, device=self.device)
        return self._placement.gather(self.levels[-1])[0]


def tree_from_chunks(chunks: np.ndarray, pair_fn: Optional[PairFn] = None,
                     device="cuda") -> IncrementalMerkleTree:
    """[n, 32] uint8 chunk matrix -> forest on `device`."""
    dev = resolve(device)
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    if chunks.ndim != 2 or chunks.shape[1] != 32:
        raise ValueError(f"expected [n, 32] chunks, got {chunks.shape}")
    words = (np.zeros((0, 8), np.uint32) if chunks.shape[0] == 0
             else bytes_to_words(chunks))
    return IncrementalMerkleTree(words_tensor(words, dev), pair_fn=pair_fn)
