"""Device-resident registry, balances and their Merkle forests across slots,
blocks and epoch boundaries (port of
consensus_specs_tpu/models/phase0/resident.py).

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
                              ResidentCore.process_epoch_resident);
  * write_rows(np_cols, old_n, dirty, pk_new, wc_new)
                              changed rows scattered in, appended rows
                              concatenated (the forests are the caller's).

`ResidentCore(spec, state)` is the object-model half on top of it: the
spec-method overrides that answer registry reads from host mirrors, the
per-slot full state root, blocks (registry-mutating ones through the
object path with incremental re-entry), the epoch boundary distilled from
the mirrors, and checkpoints. The boundary's epoch program runs through
the guarded dispatch (`ResidentCore._epoch_dispatch`: fault injection,
the integrity tripwire, a deadline when one is set); the program updates
the resident columns in place, so a failure after it was entered is
fatal and names `CheckpointStore.restore` as the way back.

`ResidentCore(spec, state, mesh=ServingMesh(...))` (parallel/sharding.py)
serves the same loop across a validator-axis mesh: `MeshResidentColumns`
holds the columns padded to a mesh multiple with inert rows and sharded,
the identity matrices sharded, and sharded forests (per-shard subtree
levels on their shard, the cap replicated); deposits scatter into the
inert padding and re-place only when the padded capacity grows. A
failure of the sharded boundary before the program was entered walks the
degradation ladder to its `single_device` rung
(`ResidentCore.degrade_to_single_device`), and the boundary runs again
on one device. Roots and bytes are bit-identical to the single-device
core's.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Optional

import numpy as np
import torch

from ... import convert
from ... import telemetry
from ...convert import columns_from_numpy, to_numpy, to_tensor
from ...device import resolve
from ...ops.intmath import udivmod_u64, ule, ult
from ...ops.sha256 import PairFn, words_to_bytes
from ...ops.shuffle import shuffle_permutation_on_device
from ...resilience import dispatch as _rdispatch
from ...resilience import integrity as _integrity
from ...resilience.errors import (CheckpointCorrupt, DispatchError,
                                  FatalDispatchError)
from ...telemetry import watchdog as _watchdog
from ...utils.ssz import bulk
from ...utils.ssz import impl as ssz_impl
from ...utils.ssz.bulk import (balances_chunk_words_device, mix_in_length,
                               registry_leaf_words_device)
from ...utils.ssz.incremental import (IncrementalMerkleTree,
                                      ShardedIncrementalMerkleTree)
from . import helpers as helpers_mod
from .epoch_soa import (EpochConfig, EpochInputs, EpochScalars,
                        ValidatorColumns, build_epoch_context,
                        build_epoch_inputs, columns_np_from_state,
                        epoch_transition_device, inert_column_tail,
                        pad_epoch_inputs, pad_validator_columns,
                        process_crosslinks_vectorized,
                        scalars_from_state, _apply_justification,
                        _apply_validator_columns, _write_back_scalars)


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
        self._put(self.cols.balance, idx,
                  torch.from_numpy(vals.view(np.int64)).to(self.device))
        chunks = np.unique(idx // 4)
        self.balances_forest.update(chunks, self._balance_chunk_words(chunks))

    def _balance_chunk_words(self, chunks: np.ndarray) -> torch.Tensor:
        """[k, 8] words of the balances list's pack chunks `chunks` (4
        values each, zero past the list end), from the device column."""
        pos = chunks[:, None] * 4 + np.arange(4)[None, :]
        valid = torch.from_numpy(pos < self.v).to(self.device)
        gathered = torch.where(valid, self._take(
            self.cols.balance, np.minimum(pos, self.v - 1).reshape(-1)
        ).reshape(pos.shape), 0)
        return balances_chunk_words_device(gathered.reshape(-1))

    def _registry_leaf_words(self, idx: np.ndarray) -> torch.Tensor:
        """[k, 8] registry leaves (Validator roots) of validators `idx`."""
        idx = np.asarray(idx, np.int64)
        c = self.cols
        return registry_leaf_words_device(
            self._take(self.pubkeys, idx),
            self._take(self.withdrawal_credentials, idx),
            *(self._take(getattr(c, f), idx) for f in self._LEAF_FIELDS),
            self._pair_fn)

    # -- row access: one device here, the mesh's shards in MeshResidentColumns

    def _take(self, col, idx: np.ndarray) -> torch.Tensor:
        return col[torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)]

    def _put(self, col, idx: np.ndarray, values: torch.Tensor) -> None:
        col.index_copy_(0, torch.from_numpy(np.asarray(idx, np.int64)).to(self.device),
                        values)

    def _grow(self, col, rows: torch.Tensor, old_n: int, field: Optional[str]):
        """`col` with `rows` appended after logical row old_n (`field`
        names the ValidatorColumns field, None for an identity matrix)."""
        return torch.cat([col, rows.to(self.device)])

    def numpy_cols(self) -> Dict[str, np.ndarray]:
        """One download of the logical [V] columns (uint64 restored)."""
        return {f: to_numpy(getattr(self.cols, f))[:self.v]
                for f in ValidatorColumns._fields}

    # registry-leaf fields: everything the Validator container Merkleizes
    # except the separate balances list (pubkey/wc never change in place)
    _LEAF_FIELDS = ("activation_eligibility_epoch", "activation_epoch",
                    "exit_epoch", "withdrawable_epoch", "slashed",
                    "effective_balance")

    def write_rows(self, np_cols, old_n: int, dirty, pubkeys_new: np.ndarray,
                   wc_new: np.ndarray) -> None:
        """Bring the resident columns and forests up to the numpy columns
        `np_cols` after a host-side change of the registry: rows dirty[f]
        (indices below old_n) of each column are scattered in, rows
        old_n.. of every column and the identity rows pubkeys_new
        [k, 48] / wc_new [k, 32] are appended on the device (no re-upload
        of the rest). Built forests re-hash only the touched leaves' root
        paths and append-grow for new validators, crossing padded powers
        of two included: O(dirty * log V)."""
        new_n = int(np_cols["balance"].shape[0])
        dev = self.device
        cols = {}
        for f in ValidatorColumns._fields:
            col = getattr(self.cols, f)
            idx = np.asarray(dirty[f], np.int64)
            if idx.size:
                self._put(col, idx, to_tensor(np_cols[f][idx], dev))
            if new_n > old_n:
                col = self._grow(col, to_tensor(np_cols[f][old_n:], dev), old_n, f)
            cols[f] = col
        self.cols = ValidatorColumns(**cols)
        if new_n > old_n:
            self.pubkeys = self._grow(self.pubkeys, torch.from_numpy(
                np.ascontiguousarray(pubkeys_new, np.uint8)), old_n, None)
            self.withdrawal_credentials = self._grow(
                self.withdrawal_credentials, torch.from_numpy(
                    np.ascontiguousarray(wc_new, np.uint8)), old_n, None)
        self.v = new_n
        if self.registry_forest is None:
            return
        reg_dirty = np.unique(np.concatenate(
            [np.asarray(dirty[f], np.int64) for f in self._LEAF_FIELDS]))
        if reg_dirty.size:
            self.registry_forest.update(
                reg_dirty, self._registry_leaf_words(reg_dirty))
        if new_n > old_n:
            self.registry_forest.append(
                self._registry_leaf_words(np.arange(old_n, new_n)))
        old_c, new_c = max(1, -(-old_n // 4)), max(1, -(-new_n // 4))
        chunk_dirty = np.asarray(dirty["balance"], np.int64) // 4
        if new_n > old_n and old_n % 4:
            # growth refills the old partial tail chunk in place
            chunk_dirty = np.concatenate([chunk_dirty, [old_n // 4]])
        chunk_dirty = np.unique(chunk_dirty)
        if chunk_dirty.size:
            self.balances_forest.update(
                chunk_dirty, self._balance_chunk_words(chunk_dirty))
        if new_c > old_c:
            self.balances_forest.append(
                self._balance_chunk_words(np.arange(old_c, new_c)))

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


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A host tensor over numpy rows (uint64 as its int64 bit pattern)."""
    arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr.view(np.int64) if arr.dtype == np.uint64 else arr)


class MeshResidentColumns(ResidentColumns):
    """ResidentColumns under a ServingMesh (parallel/sharding.py): the
    columns padded to mesh.pad_rows(V) with inert rows
    (epoch_soa.inert_column_tail) and row-sharded, the pubkey and
    withdrawal-credential matrices sharded with zero padding rows, the
    forests ShardedIncrementalMerkleTree built from the mesh's leaf
    builders. `v` stays the logical count; rows are read and written
    through the mesh's exchange, in their owning shard. The epoch
    boundary runs through ResidentCore (ServingMesh.epoch_transition)."""

    def __init__(self, cfg: EpochConfig, cols, pubkeys: np.ndarray,
                 withdrawal_credentials: np.ndarray, shuffle_round_count: int,
                 *, mesh, pair_fn: Optional[PairFn] = None):
        self.mesh = mesh
        self.device = mesh.home
        self.cfg = cfg
        self.v = int(np.asarray(cols.balance).shape[0])
        if self.v == 0:
            raise ValueError("ResidentColumns needs at least one validator")
        if pubkeys.shape != (self.v, 48) or \
                withdrawal_credentials.shape != (self.v, 32):
            raise ValueError("pubkeys must be [V, 48] and withdrawal "
                             "credentials [V, 32]")
        k = mesh.pad_rows(self.v) - self.v
        far = cfg.FAR_FUTURE_EPOCH
        self.cols = ValidatorColumns(**{
            f: mesh.shard(_host_tensor(np.concatenate(
                [np.asarray(getattr(cols, f)), inert_column_tail(f, k, far)])))
            for f in ValidatorColumns._fields})
        self.pubkeys, self.withdrawal_credentials = (
            mesh.shard(_host_tensor(np.concatenate(
                [np.asarray(m, np.uint8), np.zeros((k, m.shape[1]), np.uint8)])))
            for m in (pubkeys, withdrawal_credentials))
        self.shuffle_round_count = int(shuffle_round_count)
        self._pair_fn = pair_fn
        self.registry_forest: Optional[ShardedIncrementalMerkleTree] = None
        self.balances_forest: Optional[ShardedIncrementalMerkleTree] = None
        self.active_indices = None

    def enter(self) -> None:
        """Build both sharded forests from the resident shards."""
        c, m, pf = self.cols, self.mesh, self._pair_fn
        self.registry_forest = ShardedIncrementalMerkleTree(
            m.registry_forest_leaves(
                self.pubkeys, self.withdrawal_credentials,
                c.activation_eligibility_epoch, c.activation_epoch,
                c.exit_epoch, c.withdrawable_epoch, c.slashed,
                c.effective_balance, v_count=self.v, pair_fn=pf),
            m, pair_fn=pf, logical_n=self.v)
        self.balances_forest = ShardedIncrementalMerkleTree(
            m.balances_forest_chunks(c.balance, self.v), m, pair_fn=pf,
            logical_n=max(1, -(-self.v // 4)))

    def epoch_boundary(self, scal, inp, seed):
        raise NotImplementedError(
            "the sharded boundary runs through ResidentCore "
            "(ServingMesh.epoch_transition)")

    def _take(self, col, idx: np.ndarray) -> torch.Tensor:
        return self.mesh.exchange.take(col, idx)

    def _put(self, col, idx: np.ndarray, values: torch.Tensor) -> None:
        self.mesh.exchange.put(col, idx, values)

    def _grow(self, col, rows: torch.Tensor, old_n: int, field: Optional[str]):
        """The reference's _grow_sharded: the new rows go into the inert
        padding slots; when the padded capacity must reach the next mesh
        multiple, inert rows extend it and every shard is laid out again
        (the only step that re-places, once per mesh multiple of growth,
        not per deposit)."""
        ex = self.mesh.exchange
        new_n = old_n + int(rows.shape[0])
        vp_new = self.mesh.pad_rows(new_n)
        if vp_new > col.rows:
            k = vp_new - col.rows
            tail = (_host_tensor(inert_column_tail(field, k, self.cfg.FAR_FUTURE_EPOCH))
                    if field is not None else
                    torch.zeros((k,) + tuple(col.shape[1:]), dtype=col.dtype))
            col = ex.repartition(list(col.shards) + [tail], vp_new)
        ex.put(col, np.arange(old_n, new_n), rows)
        return col


# ===========================================================================
# The object-model half: ResidentCore
# ===========================================================================

# Mirror columns the host-side spec logic reads between boundaries.
_MIRROR_FIELDS = ("activation_epoch", "exit_epoch", "effective_balance",
                  "slashed")
_ALL_FIELDS = ValidatorColumns._fields


def light_state_from_bytes(spec, data: bytes):
    """Serialized BeaconState -> a BeaconState with every field
    deserialized EXCEPT validator_registry/balances (left empty: in a
    checkpoint-resumed resident pipeline those live as device columns,
    and materializing a million Validator objects is the cost this path
    exists to avoid)."""
    from ...utils.ssz.columns import container_field_spans
    from ...utils.ssz.impl import deserialize

    spans = container_field_spans(data, spec.BeaconState)
    state = spec.BeaconState()
    for name, typ in zip(spec.BeaconState.get_field_names(),
                         spec.BeaconState.get_field_types()):
        if name in ("validator_registry", "balances"):
            continue
        lo, hi = spans[name]
        setattr(state, name, deserialize(bytes(data[lo:hi]), typ))
    return state


def _common_path_block(block) -> bool:
    """True when the block touches no registry/balance state on the host
    side (header/randao/eth1/attestations only)."""
    b = block.body
    return not (len(b.proposer_slashings) or len(b.attester_slashings)
                or len(b.deposits) or len(b.voluntary_exits)
                or len(b.transfers))


_CORE_SEQ = itertools.count()


class ResidentCore:
    """Holds the registry/balances on the spec's device across slots,
    blocks and epochs.

    The device columns, identity matrices and forests are a
    ResidentColumns; small host numpy MIRRORS of the columns the host-side
    spec logic reads (activation/exit epochs, effective balance, slashed)
    back spec-method overrides (`get_active_validator_indices`,
    `compute_committee`, `get_total_balance`, `effective_balance_of`), so
    the unmodified process_block / process_attestation code runs against
    stale object numerics without touching them. The overrides and the
    module's state-root hook are installed on the (cached) spec while the
    core is resident: end with exit(), or _uninstall() for a light core,
    in a `finally`.

    self.timings holds the last boundary's {"stage", "device",
    "refresh"} seconds, read from the telemetry spans of those parts
    (host clock, each part's device work waited for at its end). The
    registry holds at least one validator
    (ResidentColumns).

    `mesh` (a parallel.sharding.ServingMesh, default None: one device)
    serves the columns, identities and forests sharded over the mesh
    (MeshResidentColumns) with the same roots and bytes."""

    def __init__(self, spec, state, mesh=None):
        if spec._insert_after_registry_updates or spec._insert_after_final_updates:
            raise NotImplementedError(
                "resident mode covers the phase-0 fused epoch program")
        self._init_common(spec, light=False, mesh=mesh)
        self._enter(state)

    def _init_common(self, spec, light: bool, mesh=None) -> None:
        self.spec = spec
        self._mesh = mesh
        self.device = spec.device
        self.cfg = EpochConfig.from_spec(spec)
        self.timings: Dict[str, float] = {}
        self._tkey = f"resident{next(_CORE_SEQ)}"   # watchdog key prefix
        self._saved_methods: Dict[str, object] = {}
        self._saved_root_backend = None
        self._installed = False
        self._active_idx_memo: Dict[int, np.ndarray] = {}
        # id-keyed PendingAttestation root memo: the lists only ever APPEND
        # between boundaries and rotate at final updates, so per-slot state
        # roots re-merkleize only the new tail. Entries keep a strong ref so
        # an id cannot be recycled while memoized.
        self._att_root_memo: Dict[int, tuple] = {}
        self._light = light

    # -- residency lifecycle ------------------------------------------------

    @classmethod
    def from_checkpoint(cls, spec, state_bytes: bytes, mesh=None) -> "ResidentCore":
        """Resume a serialized BeaconState straight into residency without
        materializing the registry: the big fields parse as strided-view
        columns (utils/ssz/columns.py), everything else deserializes into
        a LIGHT state whose validator_registry/balances stay empty; the
        device columns are the authority. The bytes are logical, so any
        `mesh` (or none) restores them, whatever mesh wrote them.

        A light core drives slots and epoch boundaries; blocks and exit()
        need the object registry and are the standard entry's job.

        Truncated or garbage bytes raise the typed `CheckpointCorrupt` up
        front, never an opaque struct/index error from deep inside the
        offset-grammar walkers."""
        if spec._insert_after_registry_updates or spec._insert_after_final_updates:
            raise NotImplementedError(
                "resident mode covers the phase-0 fused epoch program")
        from ...utils.ssz.columns import state_columns_from_bytes
        from ...utils.ssz.impl import fixed_byte_size, is_fixed_size
        if not isinstance(state_bytes, (bytes, bytearray, memoryview)):
            raise CheckpointCorrupt(
                f"checkpoint payload must be bytes, got "
                f"{type(state_bytes).__name__}")
        # length floor BEFORE any parsing: every fixed field plus one
        # 4-byte offset per variable field must fit
        floor = sum(
            fixed_byte_size(t) if is_fixed_size(t) else 4
            for t in spec.BeaconState.get_field_types())
        if len(state_bytes) < floor:
            raise CheckpointCorrupt(
                f"checkpoint truncated: {len(state_bytes)} bytes < the "
                f"{floor}-byte BeaconState fixed-part floor")
        try:
            np_cols = state_columns_from_bytes(state_bytes, spec)
            state = light_state_from_bytes(spec, state_bytes)
        except Exception as exc:
            # the SSZ walkers reject garbage with Assertion/Index/Value/
            # struct errors at whatever depth the framing first breaks;
            # surface ONE typed class with the cause chained
            raise CheckpointCorrupt(
                f"checkpoint bytes do not parse as a serialized "
                f"BeaconState: {type(exc).__name__}: {exc}") from exc
        core = cls.__new__(cls)
        core._init_common(spec, light=True, mesh=mesh)
        core._enter(state, np_cols=np_cols)
        return core

    def _enter(self, state, np_cols: Optional[dict] = None) -> None:
        self.state = state
        if np_cols is None:
            np_cols = dict(columns_np_from_state(state))
            n = len(state.validator_registry)
            pk = np.zeros((n, 48), np.uint8)
            wc = np.zeros((n, 32), np.uint8)
            for i, v in enumerate(state.validator_registry):
                pk[i] = np.frombuffer(bytes(v.pubkey), np.uint8)
                wc[i] = np.frombuffer(bytes(v.withdrawal_credentials), np.uint8)
            np_cols["pubkey"] = pk
            np_cols["withdrawal_credentials"] = wc
        self.mirrors: Dict[str, np.ndarray] = {
            f: np_cols[f].copy() for f in _MIRROR_FIELDS}
        # identity columns never change while resident: keep host copies
        # for the checkpoint WRITE path alongside the device uploads
        self._pk_np = np.asarray(np_cols["pubkey"])
        self._wc_np = np.asarray(np_cols["withdrawal_credentials"])
        cols = ValidatorColumns(**{f: np_cols[f] for f in _ALL_FIELDS})
        rounds = int(self.spec.SHUFFLE_ROUND_COUNT)
        if self._mesh is not None:
            self.res = MeshResidentColumns(
                self.cfg, cols, self._pk_np, self._wc_np, rounds,
                mesh=self._mesh, pair_fn=self.spec.pair_fn)
        else:
            self.res = ResidentColumns(
                self.cfg, cols, self._pk_np, self._wc_np, rounds,
                device=self.device, pair_fn=self.spec.pair_fn)
        # the forests are built on the first root request
        self._big_roots: Optional[tuple] = None
        self._active_idx_memo.clear()
        self._install()

    def exit(self):
        """Materialize the device columns back into the object state and
        restore the spec; returns the (now fully concrete) state. The spec
        overrides come off even when the device is gone."""
        if self._light:
            # refuse BEFORE touching the teardown: a refused exit must not
            # strip the residency overrides as a side effect
            raise NotImplementedError(
                "a checkpoint-resumed (light) resident state has no object "
                "registry to materialize into; serialize via "
                "checkpoint_bytes() instead")
        try:
            _apply_validator_columns(
                self.state, ValidatorColumns(**self._materialize_np_cols()))
            # _apply_validator_columns skips `slashed` (the epoch program
            # never writes it); the object copy is already authoritative.
        finally:
            self._uninstall()
        return self.state

    @property
    def cols(self) -> ValidatorColumns:
        """The resident device columns (Sharded under a mesh, padded)."""
        return self.res.cols

    def _materialize_np_cols(self) -> Dict[str, np.ndarray]:
        """One download of the device columns as a host dict of numpy
        arrays (uint64 restored from the bit patterns), cut to the logical
        validator count: a mesh's inert padding rows never reach the host's
        consumers."""
        return self.res.numpy_cols()

    def checkpoint_bytes(self) -> bytes:
        """Serialize the resident state WITHOUT materializing the registry:
        the device columns come down once and assemble vectorized into the
        `List[Validator]`/balances payloads; the small fields serialize
        from the (light or object) host state. With from_checkpoint this
        round-trips the original bytes when no transition ran."""
        from ...utils.ssz.columns import state_bytes_from_columns
        np_cols = self._materialize_np_cols()
        np_cols["pubkey"] = self._pk_np
        np_cols["withdrawal_credentials"] = self._wc_np
        return state_bytes_from_columns(self.state, np_cols, self.spec)

    def suspended(self):
        """Context manager: temporarily restore the unpatched spec (e.g.
        to run an independent object-model state while resident)."""
        @contextlib.contextmanager
        def _cm():
            self._uninstall()
            try:
                yield
            finally:
                self._install()
        return _cm()

    def _fallback_block(self, state, block) -> None:
        """Exit -> unmodified object-path block -> INCREMENTAL re-enter.

        Correctness stays the object path's by construction. Re-entry diffs
        the columns the block changed against the pre-block snapshot,
        scatters only those rows into the device columns, and re-hashes
        only the touched validators' root paths: O(dirty * log V)."""
        old_np = self._materialize_np_cols()
        try:
            _apply_validator_columns(self.state, ValidatorColumns(**old_np))
        finally:
            self._uninstall()
        self.spec.process_block(state, block)
        self._reenter_incremental(state, old_np)

    def _reenter_incremental(self, state, old_np: Dict[str, np.ndarray]) -> None:
        """Resume residency after an object-path block by diffing columns
        against the pre-block snapshot: changed rows scatter into the device
        columns, appended validators (deposits) extend them, and the forests
        invalidate at leaf granularity (append-grow included)."""
        self.state = state
        np_cols = dict(columns_np_from_state(state))
        old_n = old_np["balance"].shape[0]
        new_n = np_cols["balance"].shape[0]
        grown = new_n - old_n
        assert grown >= 0, "the registry never shrinks (spec invariant)"
        pk_new = np.zeros((grown, 48), np.uint8)
        wc_new = np.zeros((grown, 32), np.uint8)
        for i, v in enumerate(state.validator_registry[old_n:]):
            pk_new[i] = np.frombuffer(bytes(v.pubkey), np.uint8)
            wc_new[i] = np.frombuffer(bytes(v.withdrawal_credentials), np.uint8)
        if grown:
            self._pk_np = np.concatenate([self._pk_np, pk_new])
            self._wc_np = np.concatenate([self._wc_np, wc_new])
        dirty = {f: np.nonzero(np_cols[f][:old_n] != old_np[f])[0]
                 for f in _ALL_FIELDS}
        self.res.write_rows(np_cols, old_n, dirty, pk_new, wc_new)
        self.mirrors = {f: np_cols[f].copy() for f in _MIRROR_FIELDS}
        self._active_idx_memo.clear()
        self._big_roots = None
        self._install()

    # -- spec-method overrides ----------------------------------------------

    def _install(self) -> None:
        if self._installed:
            return
        spec, saved = self.spec, self._saved_methods

        # The mirrors describe self.state ONLY: every override that
        # receives a state delegates any other state (a differential
        # reference copy, a side state) to the saved object-path original.
        # They read self.mirrors at call time (re-entry replaces the dict).

        def get_active_validator_indices(state, epoch):
            if state is not self.state:
                return saved["get_active_validator_indices"](state, epoch)
            memo = self._active_idx_memo.get(int(epoch))
            if memo is None:
                m = self.mirrors
                e = np.uint64(int(epoch))
                memo = np.nonzero((m["activation_epoch"] <= e)
                                  & (e < m["exit_epoch"]))[0]
                if len(self._active_idx_memo) > 8:
                    self._active_idx_memo.clear()
                self._active_idx_memo[int(epoch)] = memo
            return memo

        def compute_committee(indices, seed, index, count):
            # state-free by signature: fully determined by the caller's
            # indices/seed, so no aliasing guard is possible or needed
            n = len(indices)
            start, end = (n * index) // count, (n * (index + 1)) // count
            perm = spec.get_shuffle_permutation(n, seed)
            return np.asarray(indices)[perm[start:end]].tolist()

        def get_total_balance(state, indices):
            if state is not self.state:
                return saved["get_total_balance"](state, indices)
            # callers pass lists, sets, or arrays
            idx = np.fromiter(indices, dtype=np.int64)
            return max(int(self.mirrors["effective_balance"][idx].sum()), 1)

        def effective_balance_of(state, index):
            if state is not self.state:
                return saved["effective_balance_of"](state, index)
            return int(self.mirrors["effective_balance"][index])

        # Proposer sampling and final updates need no clones: the shared
        # implementations read through get_active_validator_indices /
        # effective_balance_of (helpers.py), which resolve to these.
        overrides = {
            "get_active_validator_indices": get_active_validator_indices,
            "compute_committee": compute_committee,
            "get_total_balance": get_total_balance,
            "effective_balance_of": effective_balance_of,
        }
        for name, fn in overrides.items():
            saved[name] = getattr(spec, name)
            setattr(spec, name, fn)
        self._saved_root_backend = helpers_mod._state_root_backend
        helpers_mod.set_state_root_backend(self._state_root)
        self._installed = True

    def _uninstall(self) -> None:
        if not self._installed:
            return
        for name, fn in self._saved_methods.items():
            setattr(self.spec, name, fn)
        self._saved_methods.clear()
        helpers_mod.set_state_root_backend(self._saved_root_backend)
        self._saved_root_backend = None
        self._installed = False

    # -- state roots --------------------------------------------------------

    def _registry_balances_roots(self):
        """(registry_root, balances_root) from the incremental forests.

        The first request after an (epoch-boundary or entry) invalidation
        builds both forests from the device columns, one pair-hash launch
        per level; every request between boundaries is cached, or
        O(dirty * log V) after a fallback block's leaf updates."""
        if self._big_roots is None:
            if self.res.registry_forest is None:
                self.res.enter()
            self._big_roots = self.res.roots()
        return self._big_roots

    def _state_root(self, state):
        """Full BeaconState root: device roots for the two registry-scale
        fields (cached until the columns change), bulk-memoized roots for
        everything else. Same leaf layout as impl.hash_tree_root.

        Declines (-> saved backend / recursive oracle) for any state other
        than the resident one: the device columns describe THIS state only."""
        if state is not self.state:
            return (self._saved_root_backend(state)
                    if self._saved_root_backend is not None else None)
        reg_root, bal_root = self._registry_balances_roots()
        dev, pf = self.device, self.spec.pair_fn
        leaves = []
        for (value, typ), name in zip(state.get_typed_values(),
                                      state.get_field_names()):
            if name == "validator_registry":
                leaves.append(reg_root)
            elif name == "balances":
                leaves.append(bal_root)
            elif name in ("previous_epoch_attestations",
                          "current_epoch_attestations"):
                leaves.append(self._att_list_root(value, typ))
            else:
                leaves.append(bulk.hash_tree_root_bulk(value, typ, dev, pf))
        arr = np.stack([np.frombuffer(r, np.uint8) for r in leaves])
        return bulk.merkleize_chunk_array(arr, dev, pf)

    def _att_list_root(self, atts, typ) -> bytes:
        """List[PendingAttestation] root with element roots memoized by
        object identity (append-only lists; same value as
        bulk.hash_tree_root_bulk's list branch)."""
        elem_t = typ.elem_type
        memo = self._att_root_memo
        dev, pf = self.device, self.spec.pair_fn
        if not atts:
            leaves = np.zeros((0, 32), dtype=np.uint8)
        else:
            rows = []
            for a in atts:
                ent = memo.get(id(a))
                if ent is None or ent[0] is not a:
                    ent = memo[id(a)] = (
                        a, np.frombuffer(
                            bulk.hash_tree_root_bulk(a, elem_t, dev, pf),
                            np.uint8))
                rows.append(ent[1])
            leaves = np.stack(rows)
        return ssz_impl.mix_in_length(
            bulk.merkleize_chunk_array(leaves, dev, pf), len(atts))

    # -- transition drive ---------------------------------------------------

    def state_transition(self, state, block):
        if self._light:
            # fail loudly BEFORE process_slots mutates state: block
            # processing reads the object registry, which a
            # checkpoint-resumed core deliberately never built
            raise NotImplementedError(
                "a checkpoint-resumed (light) resident core drives slots "
                "and epoch boundaries only; blocks need the object "
                "registry -- resume via the standard ResidentCore entry")
        self.process_slots(state, block.slot)
        if _common_path_block(block):
            self.spec.process_block(state, block)
        else:
            self._fallback_block(state, block)
        return state

    def process_slots(self, state, slot: int) -> None:
        assert state.slot <= slot
        while state.slot < slot:
            self._process_slot(state)
            if (state.slot + 1) % self.spec.SLOTS_PER_EPOCH == 0:
                self.process_epoch_resident(state)
            state.slot += 1

    def _process_slot(self, state) -> None:
        spec = self.spec
        with telemetry.span("resident.slot_root"):
            root = self._state_root(state)
        state.latest_state_roots[state.slot % spec.SLOTS_PER_HISTORICAL_ROOT] = root
        if state.latest_block_header.state_root == spec.ZERO_HASH:
            state.latest_block_header.state_root = root
        state.latest_block_roots[state.slot % spec.SLOTS_PER_HISTORICAL_ROOT] = \
            spec.signing_root(state.latest_block_header)

    def degrade_to_single_device(self) -> None:
        """The degradation ladder's bottom rung (resilience/dispatch.py):
        abandon the serving mesh and re-enter on the spec's device, one
        download of the logical columns and an unsharded upload, the
        forests rebuilt at the next root request. Deliberate and reported
        (span "resident.degrade_single_device"), so the core's watchdog
        layout keys are forgotten rather than tripped. Idempotent on one
        device."""
        if self._mesh is None:
            return
        with telemetry.span("resident.degrade_single_device"):
            np_cols = self._materialize_np_cols()
            self._mesh = None
            self.res = ResidentColumns(
                self.cfg, ValidatorColumns(**np_cols), self._pk_np, self._wc_np,
                int(self.spec.SHUFFLE_ROUND_COUNT), device=self.device,
                pair_fn=self.spec.pair_fn)
            self._big_roots = None
            for key in (f"{self._tkey}.epoch.cols", f"{self._tkey}.forest.reg.l0",
                        f"{self._tkey}.forest.bal.l0"):
                _watchdog.forget(key)

    def _epoch_dispatch(self, scal, inp):
        """The boundary's epoch program through the guarded dispatch, with
        `epoch_output_check` armed while tripwires are on: on one device
        under the reference's key `(tkey, "epoch", V)`, on a mesh through
        ServingMesh.epoch_transition (`("mesh.epoch", size, Vp, cfg)`,
        the [V] facts padded to Vp with neutral rows per attempt).

        The program updates the resident columns in place (the reference
        donates them), so both sites take retries=0: a transient raised
        before the call is still retried on the intact columns (the
        guard's pre-dispatch allowance), but a failure after the program
        was entered (a tripwired output, an unsalvaged deadline miss)
        leaves columns that are neither the old nor a trusted new state,
        and is fatal with `consumed_inputs` set: the way back is a
        checkpoint (`resilience.CheckpointStore.restore`) and a replay of
        the slots since. A failure that left the columns intact walks the
        degradation ladder: its `single_device` rung runs
        degrade_to_single_device (a no-op on one device) and the boundary
        is dispatched again; at the bottom it is fatal."""
        check = (_integrity.epoch_output_check
                 if _integrity.tripwires_enabled() else None)
        ladder = _rdispatch.ladder()
        while True:
            try:
                if self._mesh is not None:
                    inp_p = pad_epoch_inputs(inp, self.res.cols.balance.rows)
                    return self._mesh.epoch_transition(
                        self.cfg, self.res.cols, scal, inp_p, check=check)
                return _rdispatch.guarded_dispatch(
                    (self._tkey, "epoch", self.res.v), epoch_transition_device,
                    self.cfg, self.res.cols, scal, inp, check=check, retries=0)
            except FatalDispatchError:
                raise
            except DispatchError as exc:
                if exc.consumed_inputs:
                    raise FatalDispatchError(
                        f"epoch dispatch failed after the program updated the "
                        f"resident columns in place ({exc}); restore via "
                        f"resilience.CheckpointStore.restore",
                        key=exc.key, attempts=exc.attempts) from exc
                ladder.register_single_device(self.degrade_to_single_device)
                try:
                    rung = ladder.degrade(reason=type(exc).__name__)
                finally:
                    ladder.unregister_single_device(self.degrade_to_single_device)
                if rung is None:
                    raise FatalDispatchError(
                        f"epoch boundary dispatch failed with the degradation "
                        f"ladder exhausted: {exc}", key=exc.key,
                        attempts=exc.attempts, consumed_inputs=False) from exc

    def process_epoch_resident(self, state) -> None:
        """The boundary transition on resident columns, under telemetry
        spans: "resident.stage" (host distillation off the mirrors,
        uploads included), "resident.device" (the epoch program in place
        on the resident columns), "resident.refresh" (scalar and mirror
        downloads, byte-rooted final updates, forest rebuild and roots).
        Each span waits at its exit for the device work it fenced.
        self.timings gets their seconds (zeros with telemetry off). The
        re-layout watchdog holds the chained columns under one key."""
        spec, dev = self.spec, self.device
        with telemetry.span("resident.stage") as sp_stage:
            current_epoch = spec.get_current_epoch(state)
            previous_epoch = spec.get_previous_epoch(state)
            ctx = build_epoch_context(spec, state, dict(
                self.mirrors,
                activation_eligibility_epoch=None,  # unused by the context
                withdrawable_epoch=None,
                balance=None))
            process_crosslinks_vectorized(spec, state, ctx)
            _, scal, inp = convert.columns_from_numpy(
                None, scalars_from_state(state),
                build_epoch_inputs(spec, state, ctx), dev)
            sp_stage.fence(scal, inp)   # uploads land in "resident.stage"

        with telemetry.span("resident.device") as sp_dev:
            # the columns are updated in place: no second copy of the
            # registry; input and output fingerprints must match
            _watchdog.layout_check(f"{self._tkey}.epoch.cols", self.res.cols)
            dev_cols, dev_scal, dev_report = self._epoch_dispatch(scal, inp)
            self.res.cols = dev_cols
            _watchdog.layout_check(f"{self._tkey}.epoch.cols", self.res.cols)
            sp_dev.fence(self.res.cols, dev_scal, dev_report)

        with telemetry.span("resident.refresh") as sp_ref:
            # the boundary dirties every leaf (rewards touch all balances):
            # degenerate to a full forest rebuild
            self.res.registry_forest = None
            self.res.balances_forest = None
            self._big_roots = None
            self._active_idx_memo.clear()
            _, new_scal, report = convert.columns_to_numpy(
                None, dev_scal, dev_report)
            _apply_justification(spec, state, new_scal, report,
                                 previous_epoch, current_epoch)
            _write_back_scalars(state, new_scal)
            # refresh ONLY the columns host logic reads; slashed never
            # changes in the epoch program, balances stay device-only
            for f in ("activation_epoch", "exit_epoch", "effective_balance"):
                self.mirrors[f] = to_numpy(getattr(self.res.cols, f))[:self.res.v]
            spec.final_updates_byte_rooted(state)   # reads the overrides
            # prune attestation-root memo entries the rotation dropped
            live = {id(a) for a in state.previous_epoch_attestations}
            live.update(id(a) for a in state.current_epoch_attestations)
            self._att_root_memo = {k: v for k, v in self._att_root_memo.items()
                                   if k in live}
            self._registry_balances_roots()      # rebuild + cache the roots
        self.timings = {"stage": sp_stage.duration, "device": sp_dev.duration,
                        "refresh": sp_ref.duration}
