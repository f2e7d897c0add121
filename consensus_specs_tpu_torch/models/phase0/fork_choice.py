"""LMD-GHOST fork choice: Store + head selection, with the vote
scatter-add on the device (port of
consensus_specs_tpu/models/phase0/fork_choice.py).

Capability parity with the spec's fork-choice document
(specs/core/0_fork-choice.md:59-105): a `Store` of observed blocks and
attestations, `get_ancestor`, and `lmd_ghost` head selection weighted by
effective balance with ties broken by the lexicographically higher root.

The store flattens its block DAG into parent-pointer arrays. Head
selection is then:

  1. direct vote weight per block: ONE int64 `index_add_` over the [V]
     latest-message arrays on the spec's device ("cuda" by default;
     effective balances of at most 32 ETH in Gwei sum far below 2^63 at
     any realistic V, so int64 is exact),
  2. subtree weights: one reverse-topological sweep on the host over the
     small block array (blocks are appended parent-first, so a reverse
     linear scan is a valid reverse-topological order),
  3. head walk on the host: descend from the justified root picking the
     max (subtree_weight, root) child each step.

The [V] arrays stay numpy on the host, so `on_attestation`'s rule --
a higher slot wins, the first observation wins ties -- is the
reference's, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...device import resolve


@dataclass
class LatestMessage:
    """A validator's latest attestation vote (highest slot wins; first
    observation wins ties — reference get_latest_attestation contract)."""
    slot: int
    beacon_block_root: bytes


@dataclass
class Store:
    """Observed chain data, flattened for array-at-once fork choice.

    Blocks must be added parent-first (the reference requires recursively
    verified ancestors before processing a block, 0_fork-choice.md:38-41, so
    topological insertion order is guaranteed by the protocol).

    Latest messages live in flat [V] arrays (`msg_target` block index or -1,
    `msg_slot`), grown on demand — attestation intake and the vote
    scatter-add are pure array ops, with no per-validator Python on the
    fork-choice hot path.
    """
    genesis_root: bytes = b""
    # flattened block DAG
    block_index: Dict[bytes, int] = field(default_factory=dict)
    roots: List[bytes] = field(default_factory=list)
    slots: List[int] = field(default_factory=list)
    parents: List[int] = field(default_factory=list)     # index; -1 for genesis
    blocks: List[object] = field(default_factory=list)   # BeaconBlock objects
    children: List[List[int]] = field(default_factory=list)
    # latest attestation message per validator: [V] arrays, -1 = no message
    msg_target: np.ndarray = field(
        default_factory=lambda: np.full(0, -1, dtype=np.int64))
    msg_slot: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    # justification bookkeeping (highest seen)
    justified_root: bytes = b""
    finalized_root: bytes = b""

    def _grow_messages(self, size: int) -> None:
        if size > self.msg_target.shape[0]:
            pad = size - self.msg_target.shape[0]
            self.msg_target = np.concatenate(
                [self.msg_target, np.full(pad, -1, dtype=np.int64)])
            self.msg_slot = np.concatenate(
                [self.msg_slot, np.zeros(pad, dtype=np.int64)])

    @property
    def latest_messages(self) -> Dict[int, LatestMessage]:
        """Object view of the message arrays (oracle path / inspection)."""
        return {
            int(v): LatestMessage(slot=int(self.msg_slot[v]),
                                  beacon_block_root=self.roots[int(self.msg_target[v])])
            for v in np.nonzero(self.msg_target >= 0)[0]
        }

    # -- block/attestation intake -------------------------------------------

    def add_block(self, root: bytes, block, parent_root: Optional[bytes]) -> int:
        assert root not in self.block_index, "duplicate block"
        if parent_root is None:
            parent = -1
            self.genesis_root = root
            if not self.justified_root:
                self.justified_root = root
                self.finalized_root = root
        else:
            assert parent_root in self.block_index, "parent not processed"
            parent = self.block_index[parent_root]
        idx = len(self.roots)
        self.block_index[root] = idx
        self.roots.append(root)
        self.slots.append(int(block.slot))
        self.parents.append(parent)
        self.blocks.append(block)
        self.children.append([])
        if parent >= 0:
            self.children[parent].append(idx)
        return idx

    def on_attestation(self, validator_indices: Sequence[int],
                       beacon_block_root: bytes, slot: int) -> None:
        """Record latest messages for the attesting validators (vectorized:
        one masked write over the [V] arrays, however large the committee).
        ZERO_HASH targets alias the genesis block (0_fork-choice.md:105-109);
        a higher slot wins, first observation wins ties."""
        if beacon_block_root == b"\x00" * 32:
            beacon_block_root = self.genesis_root
        if beacon_block_root not in self.block_index:
            return  # unviable target: not yet observed
        target = self.block_index[beacon_block_root]
        idx = np.asarray(validator_indices, dtype=np.int64)
        if idx.size == 0:
            return
        self._grow_messages(int(idx.max()) + 1)
        newer = (self.msg_target[idx] < 0) | (int(slot) > self.msg_slot[idx])
        take = idx[newer]
        self.msg_target[take] = target
        self.msg_slot[take] = int(slot)

    # -- reference-shaped object walk (oracle path) -------------------------

    def get_parent(self, idx: int) -> int:
        return self.parents[idx]

    def get_ancestor(self, idx: int, slot: int) -> Optional[int]:
        """Index of the ancestor of block `idx` at `slot`; None if above it.
        Iterative (the reference's recursion, 0_fork-choice.md:61-69, is
        depth-bounded only by chain length)."""
        while idx >= 0:
            if self.slots[idx] == slot:
                return idx
            if self.slots[idx] < slot:
                return None
            idx = self.parents[idx]
        return None


def lmd_ghost_reference(store: Store, effective_balances: Sequence[int],
                        active_indices: Sequence[int],
                        start_root: bytes) -> bytes:
    """Object-model LMD-GHOST (the oracle): per-child vote counting through
    get_ancestor, ties by lexicographically higher root
    (0_fork-choice.md:78-103). O(V * B * depth), host only — test scale."""
    targets = [
        (int(v), store.block_index[store.latest_messages[int(v)].beacon_block_root])
        for v in active_indices if int(v) in store.latest_messages
    ]

    def vote_count(block_idx: int) -> int:
        blk_slot = store.slots[block_idx]
        return sum(
            int(effective_balances[v])
            for v, tgt in targets
            if store.get_ancestor(tgt, blk_slot) == block_idx
        )

    head = store.block_index[start_root]
    while True:
        kids = store.children[head]
        if not kids:
            return store.roots[head]
        head = max(kids, key=lambda i: (vote_count(i), store.roots[i]))


def subtree_weights(store: Store, effective_balances,
                    active_indices: Sequence[int], device="cuda") -> np.ndarray:
    """[B] uint64 subtree vote weight per block.

    Direct weights by ONE int64 scatter-add over the [V] latest-message
    arrays on `device` ("cuda" by default; raises without a card): every
    validator adds its balance to its target, or 0 when it is inactive
    or has no message, so nothing is read back before the sum. Subtree
    accumulation by a reverse-topological sweep over the block array on
    the host."""
    dev = resolve(device)
    B = len(store.roots)
    direct = np.zeros(B, dtype=np.uint64)
    V = store.msg_target.shape[0]
    if V and B:
        balances = np.zeros(V, dtype=np.uint64)
        n = min(V, len(effective_balances))
        balances[:n] = np.asarray(effective_balances[:n], dtype=np.uint64)
        idx = np.asarray(active_indices, dtype=np.int64)
        idx = idx[idx < V]
        target = torch.from_numpy(store.msg_target).to(dev)
        active = torch.zeros(V, dtype=torch.bool, device=dev)
        active[torch.from_numpy(idx).to(dev)] = True
        weight = torch.from_numpy(balances.view(np.int64)).to(dev)
        voting = active & (target >= 0)
        sums = torch.zeros(B, dtype=torch.int64, device=dev)
        sums.index_add_(0, target.clamp(min=0),
                        torch.where(voting, weight, torch.zeros_like(weight)))
        direct = sums.cpu().numpy().view(np.uint64)
    acc = direct.copy()
    parents = np.asarray(store.parents)
    for i in range(B - 1, 0, -1):
        p = parents[i]
        if p >= 0:
            acc[p] += acc[i]
    return acc


def lmd_ghost(store: Store, effective_balances: Sequence[int],
              active_indices: Sequence[int], start_root: bytes,
              device="cuda") -> bytes:
    """Vectorized LMD-GHOST head selection. Same result as the reference
    walk: a block's vote count there is exactly the sum of balances whose
    latest target lies in its subtree (get_ancestor(target, block.slot)
    == block <=> block is an ancestor-or-self of target, for
    tree-structured stores)."""
    weights = subtree_weights(store, effective_balances, active_indices,
                              device)
    head = store.block_index[start_root]
    while True:
        kids = store.children[head]
        if not kids:
            return store.roots[head]
        head = max(kids, key=lambda i: (int(weights[i]), store.roots[i]))


def get_head(spec, store: Store, justified_state) -> bytes:
    """Head from the justified state's registry (the spec's
    `lmd_ghost(store, justified_head_state, justified_head)`), the votes
    summed on the spec's device."""
    epoch = spec.slot_to_epoch(justified_state.slot)
    active = spec.get_active_validator_indices(justified_state, epoch)
    balances = [v.effective_balance for v in justified_state.validator_registry]
    return lmd_ghost(store, balances, active, store.justified_root,
                     spec.device)
