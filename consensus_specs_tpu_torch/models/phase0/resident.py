"""Device-resident registry, balances and their Merkle forests across slots
and epoch boundaries (port of the device half of
consensus_specs_tpu/models/phase0/resident.py::ResidentCore).

`ResidentColumns` keeps on the device the validator columns, the pubkey
[V, 48] and withdrawal-credential [V, 32] byte matrices, and the registry
and balances incremental forests:

  * enter()                   builds both forests from the columns;
  * apply_balances(idx, vals) the per-slot balance scatter plus the dirty
                              path update of the balances forest;
  * roots()                   (registry_root, balances_root), each list
                              root mixed with the length V;
  * epoch_boundary(scal, inp, seed)
                              the epoch program in place on the columns,
                              the next epoch's shuffle of the active
                              indices, and a full forest rebuild (the
                              boundary dirties every balance leaf, as in
                              ResidentCore.process_epoch_resident).

The object-model half of ResidentCore (spec overrides, fallback blocks,
input distillation, checkpoints, the mesh) is not ported here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...convert import columns_from_numpy
from ...device import resolve
from ...ops.intmath import udivmod_u64, ule, ult
from ...ops.sha256 import PairFn, words_to_bytes
from ...ops.shuffle import shuffle_permutation_on_device
from ...utils.ssz.bulk import (balances_chunk_words_device, mix_in_length,
                               registry_leaf_words_device)
from ...utils.ssz.incremental import IncrementalMerkleTree
from .epoch_soa import (EpochConfig, EpochInputs, EpochScalars,
                        epoch_transition_device)


class ResidentColumns:
    """The resident device core of one beacon state (V >= 1 validators).

    cols: ValidatorColumns of numpy arrays (uint64/bool); pubkeys [V, 48]
    and withdrawal_credentials [V, 32] uint8 numpy. Everything is uploaded
    once to `device`. pair_fn replaces the pair hash (default: the CUDA
    kernel on a CUDA device); the checks pass the plain twin."""

    def __init__(self, cfg: EpochConfig, cols, pubkeys: np.ndarray,
                 withdrawal_credentials: np.ndarray, shuffle_round_count: int,
                 *, device="cuda", pair_fn: Optional[PairFn] = None):
        self.device = resolve(device)
        self.cfg = cfg
        self.cols, _, _ = columns_from_numpy(cols, device=self.device)
        self.v = int(self.cols.balance.shape[0])
        if self.v == 0:
            raise ValueError("ResidentColumns needs at least one validator")
        if pubkeys.shape != (self.v, 48) or \
                withdrawal_credentials.shape != (self.v, 32):
            raise ValueError("pubkeys must be [V, 48] and withdrawal "
                             "credentials [V, 32]")
        self.pubkeys = torch.from_numpy(
            np.ascontiguousarray(pubkeys, np.uint8)).to(self.device)
        self.withdrawal_credentials = torch.from_numpy(
            np.ascontiguousarray(withdrawal_credentials, np.uint8)).to(self.device)
        self.shuffle_round_count = int(shuffle_round_count)
        self._pair_fn = pair_fn
        self.registry_forest: Optional[IncrementalMerkleTree] = None
        self.balances_forest: Optional[IncrementalMerkleTree] = None
        self.active_indices: Optional[torch.Tensor] = None

    def enter(self) -> None:
        """Build both forests from the resident columns."""
        c = self.cols
        self.registry_forest = IncrementalMerkleTree(
            registry_leaf_words_device(
                self.pubkeys, self.withdrawal_credentials,
                c.activation_eligibility_epoch, c.activation_epoch,
                c.exit_epoch, c.withdrawable_epoch, c.slashed,
                c.effective_balance, self._pair_fn),
            self._pair_fn)
        self.balances_forest = IncrementalMerkleTree(
            balances_chunk_words_device(c.balance), self._pair_fn)

    def apply_balances(self, idx, values) -> None:
        """Set balance[idx] = values (uint64) and re-hash the dirty paths.

        idx: [k] unique validator indices (host); values: [k] uint64."""
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        vals = np.asarray(values, dtype=np.uint64).reshape(-1)
        if idx.shape != vals.shape:
            raise ValueError(f"{idx.shape[0]} indices for {vals.shape[0]} values")
        if idx.shape[0] == 0:
            return
        if np.unique(idx).shape[0] != idx.shape[0]:
            raise ValueError("duplicate validator indices")
        if idx.min() < 0 or idx.max() >= self.v:
            raise IndexError(f"validator index out of range (V={self.v})")
        bal = self.cols.balance
        bal.index_copy_(0, torch.from_numpy(idx).to(self.device),
                        torch.from_numpy(vals.view(np.int64)).to(self.device))
        chunks = np.unique(idx // 4)
        pos = chunks[:, None] * 4 + np.arange(4)[None, :]
        valid = torch.from_numpy(pos < self.v).to(self.device)
        gathered = torch.where(
            valid, bal[torch.from_numpy(np.minimum(pos, self.v - 1)).to(self.device)], 0)
        self.balances_forest.update(
            chunks, balances_chunk_words_device(gathered.reshape(-1)))

    def roots(self):
        """(registry_root, balances_root) as 32-byte strings: both list
        roots mixed with the length V on the device, 64 bytes downloaded."""
        out = words_to_bytes(torch.stack([
            mix_in_length(self.registry_forest.root_words(), self.v, self._pair_fn),
            mix_in_length(self.balances_forest.root_words(), self.v, self._pair_fn)]))
        return out[0].tobytes(), out[1].tobytes()

    def epoch_boundary(self, scal: EpochScalars, inp: EpochInputs,
                       seed: bytes):
        """Run the epoch program in place on the resident columns, shuffle
        the next epoch's active indices with `seed`, and rebuild both
        forests. Returns (scalars', report, permutation); the active
        indices the permutation is over stay in self.active_indices."""
        _, new_scal, report = epoch_transition_device(
            self.cfg, self.cols, scal, inp)
        next_epoch = udivmod_u64(new_scal.slot, self.cfg.SLOTS_PER_EPOCH)[0] + 1
        c = self.cols
        active = ule(c.activation_epoch, next_epoch) & ult(next_epoch, c.exit_epoch)
        self.active_indices = torch.nonzero(active).reshape(-1)
        n = int(self.active_indices.shape[0])
        perm = (shuffle_permutation_on_device(
                    seed, n, self.shuffle_round_count, self.device)
                if n else torch.zeros(0, dtype=torch.int32, device=self.device))
        self.enter()
        return new_scal, report, perm
