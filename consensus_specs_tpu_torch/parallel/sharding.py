"""Validator-axis sharding of the serving path (port of
consensus_specs_tpu/parallel/sharding.py).

Placement contract, the reference's (the registry is the protocol's
embarrassingly parallel axis):
  - every `[V]` column of ValidatorColumns / EpochInputs is row-sharded
    over the mesh (`exchange.Sharded`, one tensor per shard);
  - scalars and the two per-shard crosslink tables are replicated: each
    shard's program reads its own device's copy.

The reference compiles one SPMD program per placement and lets XLA insert
the collectives. The port shards explicitly in one process: the epoch
program runs per shard (epoch_soa._epoch_rows) and every step where a
row depends on other rows goes through the mesh's `ShardExchange`
(parallel/exchange.py). A mesh is an ordered list of `torch.device`s
whose length is a power of two; a device may repeat, so ["cpu"] * 8
rehearses the reference's 8-device mesh and ["cuda:0"] * 4 a 4-way mesh
on one card.

The reference's `ServingMesh.from_env` (its environment switch) is not
ported: a caller passes `mesh=` explicitly. Its jaxpr contract
registrations (TRACE_CONTRACTS, MEM_CONTRACTS) are tooling of the JAX
package's analyzers and are not ported either.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from ..models.phase0.epoch_soa import (EpochInputs, EpochScalars,
                                       ValidatorColumns,
                                       epoch_transition_shards)
from ..resilience import faults as _faults
from ..resilience.dispatch import guarded_dispatch
from ..utils.merkle import next_power_of_two
from ..utils.ssz.bulk import (balances_chunk_words_device,
                              registry_leaf_words_device)
from .exchange import (Replicated, ShardExchange, Sharded, canonical_device,
                       is_placed)

SHARD_V = "v"              # a level or column row-sharded over the mesh
REPLICATED = "replicated"  # a copy on every shard's device


def visible_devices() -> List[torch.device]:
    """The CUDA devices this process sees, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def validator_mesh(devices=None, n: int = None) -> List[torch.device]:
    """The shard device list of a validator-axis mesh. With no `devices`,
    the visible CUDA devices routed through the fault harness's
    device-loss filter (resilience/faults.py `mesh=lose:<k>`), so a
    simulated loss surfaces here, at mesh construction, like a missing
    card. Asked for more devices than there are, it raises: it never
    repeats a device by itself (repeats come only from a list the caller
    passes)."""
    if devices is None:
        devices = _faults.filter_devices(visible_devices())
    devices = [torch.device(d) for d in devices]
    if n is not None:
        if len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        devices = devices[:n]
    return devices


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor as it is, or numpy (uint64 as its int64 bit pattern) on
    `device`."""
    if isinstance(x, torch.Tensor):
        return x
    from ..convert import to_tensor
    return to_tensor(np.asarray(x), torch.device(device))


def _tree_map(fn, tree):
    """fn over the leaves of dicts, tuples (named ones kept), lists;
    Sharded / Replicated values are leaves."""
    if is_placed(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree)


def _tree_leaves(tree) -> list:
    if is_placed(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def _devices_of(mesh) -> List[torch.device]:
    return list(mesh.devices) if hasattr(mesh, "devices") else \
        [torch.device(d) for d in mesh]


def shard_epoch_state(mesh: "ServingMesh", cols, scal, inp):
    """Place one epoch step's inputs per the contract above: [V] columns
    and participation facts Sharded, the scalars and the two crosslink
    tables Replicated. Accepts tensors or the numpy form of
    synthetic_epoch_state; V must divide the mesh (pad first:
    epoch_soa.pad_validator_columns / pad_epoch_inputs)."""
    cols_s = ValidatorColumns(*(mesh.shard(x) for x in cols))
    scal_s = EpochScalars(*(mesh.replicate(x) for x in scal))
    n_vcols = len(EpochInputs._fields) - 2
    inp_s = EpochInputs(
        *(mesh.shard(x) for x in inp[:n_vcols]),
        shard_att_balance=mesh.replicate(inp.shard_att_balance),
        shard_comm_balance=mesh.replicate(inp.shard_comm_balance))
    return cols_s, scal_s, inp_s


class HostGrid(NamedTuple):
    """A ("host", "v") arrangement of shard devices: grid[h] lists host
    h's devices. `flat` is the flattened (host, v) order the validator
    axis shards over."""
    grid: tuple

    @property
    def shape(self) -> tuple:
        return (len(self.grid), len(self.grid[0]))

    @property
    def flat(self) -> List[torch.device]:
        return [d for row in self.grid for d in row]


def hierarchical_mesh(devices=None, hosts: int = None) -> HostGrid:
    """A ("host", "v") grid for multi-host topologies: the outer axis
    spans hosts, the inner the devices within a host. The heavy validator
    axis shards over the flattened (host, v) product, so the per-device
    partial reductions combine within a host first. One process sees one
    host, so `hosts` (default 1) groups the list, as the reference's
    virtual meshes do (8 devices as 2 x 4)."""
    devices = visible_devices() if devices is None else \
        [torch.device(d) for d in devices]
    hosts = 1 if hosts is None else int(hosts)
    if hosts < 1 or len(devices) % hosts:
        raise ValueError(f"{len(devices)} devices do not tile {hosts} hosts evenly")
    per = len(devices) // hosts
    return HostGrid(tuple(tuple(devices[h * per:(h + 1) * per])
                          for h in range(hosts)))


def shard_hierarchical(grid: HostGrid, tree):
    """Shard every leaf's leading axis over the flattened (host, v)
    product of a hierarchical_mesh; 0-d leaves replicate."""
    return shard_leading_axis(ServingMesh(grid.flat), tree)


def pow2_pad_rows(n: int, mesh_size: int) -> int:
    """The next power of two >= max(n, 1): because the mesh size is a
    power of two, a multiple of it whenever it is at least the mesh size.
    The row count the sharded forests materialize per level, and the
    append-grow target."""
    if mesh_size < 1 or mesh_size & (mesh_size - 1):
        raise ValueError(f"mesh size must be a power of two, got {mesh_size}")
    return next_power_of_two(max(n, 1))


def pad_leading_pow2(x, mesh):
    """Zero-pad a tensor's leading axis to pow2_pad_rows so it becomes
    shardable over the mesh (returned as is when it already is); callers
    that need non-zero padding (inert validator rows) pad themselves."""
    n = int(x.shape[0])
    m = pow2_pad_rows(n, len(_devices_of(mesh)))
    if m == n:
        return x
    return torch.cat([x, torch.zeros((m - n,) + tuple(x.shape[1:]),
                                     dtype=x.dtype, device=x.device)])


def shard_leading_axis(mesh, tree):
    """Shard every leaf's LEADING axis over the mesh; 0-d leaves
    replicate. The placement of the two other parallel axes: the pairing
    groups of grouped_pairing_check and the leaves of the Merkle forests.

    A leading axis must divide the mesh size: pad explicitly first
    (`pad_leading_pow2`); a non-divisible axis raises, naming the pad."""
    devices = _devices_of(mesh)
    size = len(devices)
    for leaf in _tree_leaves(tree):
        if is_placed(leaf):
            continue
        shape = tuple(getattr(leaf, "shape", ()))
        n = shape[0] if shape else None
        if n is not None and n % size:
            if size & (size - 1) == 0:
                hint = next_power_of_two(max(n, 1))
                while hint % size:
                    hint *= 2
                how = f"e.g. pad_leading_pow2 to {hint} rows"
            else:
                how = f"e.g. zero-pad to {-(-n // size) * size} rows"
            raise ValueError(
                f"shard_leading_axis: leading axis of {n} rows does not "
                f"divide the {size}-device mesh -- pad first ({how})")
    ex = mesh.exchange if hasattr(mesh, "exchange") else ShardExchange(devices)

    def place(x):
        if is_placed(x):
            return x
        t = _as_tensor(x, ex.home)
        return ex.split(t) if t.dim() >= 1 else ex.replicate(t)
    return _tree_map(place, tree)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, Sharded):
        return np.concatenate([s.detach().cpu().numpy() for s in x.shards])
    if isinstance(x, Replicated):
        return x.copies[0].detach().cpu().numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trees_bitwise_equal(a, b) -> bool:
    """Leafwise dtype / shape / value equality of two trees on the host;
    a Sharded value compares as its shards concatenated, a Replicated one
    as its copy (every copy must agree)."""
    for t in (a, b):
        for leaf in _tree_leaves(t):
            if isinstance(leaf, Replicated) and any(
                    not torch.equal(c.cpu(), leaf.copies[0].cpu()) for c in leaf.copies):
                return False
    la, lb = _tree_leaves(a), _tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        xn, yn = _to_numpy(x), _to_numpy(y)
        if xn.dtype != yn.dtype or xn.shape != yn.shape or not (xn == yn).all():
            return False
    return True


class ServingMesh:
    """Placement layer of the resident serving loop.

    Every `[Vp]` validator column and participation fact is row-sharded
    (Vp is the logical count padded to a multiple of the mesh size with
    INERT rows, epoch_soa.pad_validator_columns); scalars, the crosslink
    tables and the epoch report are replicated; forest levels are sharded
    while their row count divides the mesh and replicated above (the
    small cap). The epoch program writes its sharded columns in place,
    so consecutive boundaries chain on the same shards with no re-layout.
    """

    shard_v = SHARD_V
    replicated = REPLICATED

    def __init__(self, devices: Sequence):
        devs = [canonical_device(resolve(d)) for d in devices]
        n = len(devs)
        if n < 1 or n & (n - 1):
            raise ValueError(f"serving mesh size must be a power of two, got {n}")
        self.devices = tuple(devs)
        self.exchange = ShardExchange(devs)

    def __repr__(self):
        return f"ServingMesh({[str(d) for d in self.devices]})"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct_devices(self) -> int:
        return len(set(self.devices))

    @classmethod
    def create(cls, n: int = None, devices=None) -> "ServingMesh":
        return cls(validator_mesh(devices, n=n))

    @classmethod
    def available(cls, max_n: int = None, devices=None) -> Optional["ServingMesh"]:
        """The largest power-of-two mesh the SURVIVING devices allow (the
        visible CUDA devices, or `devices`, through the fault harness's
        device-loss filter): the restore-after-hardware-loss entry. None
        when fewer than 2 devices remain."""
        devs = list(_faults.filter_devices(
            visible_devices() if devices is None else
            [torch.device(d) for d in devices]))
        limit = len(devs) if max_n is None else min(len(devs), max_n)
        n = 1
        while n * 2 <= limit:
            n *= 2
        if n <= 1:
            return None
        # already filtered: validator_mesh must not spend a second loss
        return cls(validator_mesh(devices=devs, n=n))

    # -- padding and placement -------------------------------------------------

    def pad_rows(self, n: int) -> int:
        """Smallest multiple of the mesh size >= n (the padded column
        length Vp of a logical registry of n validators)."""
        return -(-n // self.size) * self.size

    def row_sharding(self, rows: int) -> str:
        """Forest-level placement: sharded while the row count divides the
        mesh, replicated for the cap levels above."""
        return self.shard_v if rows and rows % self.size == 0 else self.replicated

    def shard(self, x) -> Sharded:
        """A [R, ...] tensor (or numpy) split into R / size rows a shard."""
        if isinstance(x, Sharded):
            return x
        return self.exchange.split(_as_tensor(x, self.home))

    def replicate(self, x) -> Replicated:
        if isinstance(x, Replicated):
            return x
        return self.exchange.replicate(_as_tensor(x, self.home))

    def place(self, x):
        """`x` (a tensor, Sharded or Replicated) per row_sharding of its row
        count, as it is when it is placed so already."""
        rows = x.rows if is_placed(x) else int(x.shape[0])
        if self.row_sharding(rows) == self.shard_v:
            return x if isinstance(x, Sharded) else self.shard(self.gather(x))
        return x if isinstance(x, Replicated) else self.replicate(self.gather(x))

    def gather(self, x, device=None) -> torch.Tensor:
        if not is_placed(x):
            return x if device is None else self.exchange.copy(x, device)
        return self.exchange.gather(x, device)

    # -- epoch program ---------------------------------------------------------

    def epoch_transition(self, cfg, cols: ValidatorColumns, scal, inp, check=None):
        """The epoch program over the mesh: Sharded `[Vp]` columns in,
        the same shards updated in place out, so consecutive boundaries
        chain with zero re-layout. `scal` and the crosslink tables may be
        plain tensors (any device), Replicated or Sharded; they are
        replicated, and each shard reads its own copy. The [Vp] facts may
        be plain tensors or Sharded. Returns (cols, scal', report), scal'
        and report on the home device (every shard computes the same
        values).

        Through the resilience guard under ("mesh.epoch", size, Vp, cfg):
        the program writes its inputs in place, so the site never retries
        a failure after the program was entered (retries=0; the guard
        records consumed_inputs)."""
        vp = int(cols.balance.rows)
        n_vcols = len(EpochInputs._fields) - 2
        scal = EpochScalars(*(self._replicated(x) for x in scal))
        inp = EpochInputs(*(self.shard(x) for x in inp[:n_vcols]),
                          *(self._replicated(x) for x in inp[n_vcols:]))
        key = ("mesh.epoch", self.size, vp, cfg)
        return guarded_dispatch(key, self._epoch, cfg, cols, scal, inp,
                                check=check, retries=0)

    def _replicated(self, x) -> Replicated:
        return self.replicate(self.gather(x) if isinstance(x, Sharded) else x)

    def _epoch(self, cfg, cols, scal, inp):
        n = self.size
        shard_cols = [ValidatorColumns(*(c.shards[i] for c in cols)) for i in range(n)]
        shard_scal = [EpochScalars(*(s.copies[i] for s in scal)) for i in range(n)]
        shard_inp = [EpochInputs(*(x.shards[i] if isinstance(x, Sharded) else x.copies[i]
                                   for x in inp)) for i in range(n)]
        _, scals, reports = epoch_transition_shards(
            cfg, shard_cols, shard_scal, shard_inp, self.exchange)
        return cols, scals[0], reports[0]

    # -- forest level-0 builders -----------------------------------------------

    def registry_forest_leaves(self, pubkeys, withdrawal_credentials,
                               activation_eligibility_epoch, activation_epoch,
                               exit_epoch, withdrawable_epoch, slashed,
                               effective_balance, v_count: int, pair_fn=None):
        """[P2, 8] level-0 rows of the registry forest from padded Sharded
        `[Vp]` columns, P2 = pow2_pad_rows(v_count): each shard hashes its
        own validators (rows at or past the LOGICAL count masked to the
        SSZ virtual zero rows), then the rows are laid out again as P2
        rows placed per row_sharding. Guarded under ("mesh.regleaves",
        size, Vp, P2)."""
        vp = int(pubkeys.rows)
        p2 = pow2_pad_rows(v_count, self.size)
        args = (pubkeys, withdrawal_credentials, activation_eligibility_epoch,
                activation_epoch, exit_epoch, withdrawable_epoch, slashed,
                effective_balance)

        def build(*cols):
            offs = cols[0].offsets()
            parts = []
            for i in range(self.size):
                shard = [c.shards[i] for c in cols]
                leaves = registry_leaf_words_device(*shard, pair_fn)
                row = torch.arange(leaves.shape[0], device=leaves.device) + offs[i]
                parts.append(torch.where((row < v_count)[:, None], leaves, 0))
            return self._layout(parts, p2)
        return guarded_dispatch(("mesh.regleaves", self.size, vp, p2), build, *args)

    def balances_forest_chunks(self, balances: Sharded, v_count: int):
        """[P2c, 8] level-0 rows of the balances forest from the padded
        Sharded `[Vp]` balance column, P2c = pow2_pad_rows(ceil(v_count /
        4)). Inert rows hold balance 0, which is the SSZ pack's virtual
        zero padding, so only the rows are laid out again (4 balances a
        chunk, each shard packing its own chunks). Guarded under
        ("mesh.balchunks", size, Vp, P2c)."""
        vp = int(balances.rows)
        c = max(1, -(-v_count // 4))
        p2 = pow2_pad_rows(c, self.size)

        def build(bal):
            if self.row_sharding(p2) == self.shard_v:
                pieces = self.exchange.repartition(bal.shards, 4 * p2)
                return Sharded(tuple(balances_chunk_words_device(s)
                                     for s in pieces.shards))
            return self.replicate(balances_chunk_words_device(
                self._home_rows(bal.shards, 4 * p2)))
        return guarded_dispatch(("mesh.balchunks", self.size, vp, p2), build, balances)

    def _home_rows(self, parts, rows: int) -> torch.Tensor:
        """The concatenation of per-shard row blocks, zero-filled or cut
        to `rows`, on the home device."""
        return self.exchange.repartition(parts, rows, [rows]).shards[0]

    def _layout(self, parts, rows: int):
        """Per-shard row blocks (their concatenation, zero-filled or cut
        to `rows`) placed per row_sharding(rows)."""
        if self.row_sharding(rows) == self.shard_v:
            return self.exchange.repartition(parts, rows)
        return self.replicate(self._home_rows(parts, rows))

    # -- forest build ----------------------------------------------------------

    def forest_build(self, level0, pair_fn=None):
        """Every level of a pow2-capacity forest from its placed level 0:
        sharded levels hash shard-locally (one pair-hash launch a shard),
        the level whose rows reach the mesh size joins the shard roots on
        home and the cap levels are hashed there and replicated. ->
        (levels, lanes per level, launches per level). Guarded under
        ("mesh.forest_build", size, capacity)."""
        from ..ops.sha256 import pair_hash_words
        fn = pair_fn or pair_hash_words
        capacity = int(level0.rows)
        if capacity & (capacity - 1):
            raise ValueError(f"forest capacity must be a power of two, got {capacity}")

        def build(level):
            levels, lanes, launches = [level], [], []
            while level.rows > 1:
                half = level.rows // 2
                if isinstance(level, Sharded) and self.row_sharding(half) == self.shard_v:
                    level = Sharded(tuple(fn(s.reshape(-1, 16)) for s in level.shards))
                    launches.append(self.size)
                else:
                    level = self.replicate(fn(self.gather(level).reshape(-1, 16)))
                    launches.append(1)
                lanes.append(half)
                levels.append(level)
            return levels, lanes, launches
        return guarded_dispatch(("mesh.forest_build", self.size, capacity), build, level0)

    # -- the attestation axis --------------------------------------------------

    def grouped_pairing_check(self, g1, g2) -> torch.Tensor:
        """The grouped pairing with its groups split over the shards
        (shard_leading_axis: G must divide the mesh), each shard's
        ops/bls_torch.py::grouped_pairing_check on its own device, every
        shard launched before any verdict is read; -> [G] bool verdicts in
        order on the home device."""
        from ..ops import bls_torch
        g1_s, g2_s = shard_leading_axis(self, (g1, g2))
        verdicts = [bls_torch.grouped_pairing_check(a, b)
                    for a, b in zip(g1_s.shards, g2_s.shards)]
        return self.exchange.gather(Sharded(tuple(verdicts)))
