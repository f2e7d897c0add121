"""Sharded and replicated values, and the one helper every cross-shard
value goes through.

The JAX package gets its validator-axis sharding from XLA's SPMD
partitioner: a jitted program over NamedShardings, with the collectives
the partitioner inserts. PyTorch has no such partitioner, so the port
shards explicitly, in one process (the reference's single-controller
model):

  * `Sharded(shards)` -- a row-sharded value: one tensor per shard, each
    on its shard's device, holding consecutive rows of the logical value
    (shard i of an evenly sharded [R] value holds rows [i*R/n, (i+1)*R/n));
  * `Replicated(copies)` -- the same tensor once on every shard's device;
  * `ShardExchange(devices)` -- every value that crosses shards (a
    reduction's partials, a scatter into another shard's rows, the
    activation queue's sort keys, a forest's shard roots joining the cap)
    moves through `ShardExchange.copy`, the one copy of the port's
    sharded code. Shards may share a device (["cpu"] * 8 rehearses the
    reference's 8-device mesh; ["cuda:0"] * 4 rehearses a mesh on one
    card): they are still separate tensors with separate storage, and
    the code is the code a host with several cards runs. Only a
    peer-to-peer copy between two cards is not exercised then.

A one-device exchange is the single-device case of the same code: its
reductions and scatters are the plain single-tensor operations.

With `fence` set the exchange synchronizes the devices around each step
and adds its wall time to `seconds` (`steps` counts the steps and
`copies` the tensors moved between two devices, always): the share of a
sharded program spent crossing shards.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.intmath import umax


class Sharded(NamedTuple):
    """A row-sharded value: shards[i] holds the next rows, on its device."""
    shards: Tuple[torch.Tensor, ...]

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    @property
    def rows(self) -> int:
        return sum(int(s.shape[0]) for s in self.shards)

    @property
    def shape(self) -> tuple:
        return (self.rows,) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def offsets(self) -> List[int]:
        """Row offset of each shard, and the total, as n + 1 ints."""
        return [0] + np.cumsum([int(s.shape[0]) for s in self.shards]).tolist()


class Replicated(NamedTuple):
    """One tensor, copied once to every shard's device."""
    copies: Tuple[torch.Tensor, ...]

    @property
    def rows(self) -> int:
        return int(self.copies[0].shape[0])


def is_placed(x) -> bool:
    return isinstance(x, (Sharded, Replicated))


def canonical_device(d) -> torch.device:
    """`d` with its index: "cuda" is the current card, so that a tensor's
    device compares equal to the shard device it lives on."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class ShardExchange:
    """Cross-shard steps over an ordered list of shard devices (repeats
    allowed). The first device is home: reductions combine there, and
    replicated results are computed there and copied out."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a shard exchange needs at least one device")
        self.n = len(self.devices)
        self.home = self.devices[0]
        self.fence = False
        self.seconds = 0.0
        self.steps = 0
        self.copies = 0

    # -- the one copy ---------------------------------------------------------

    def copy(self, t: torch.Tensor, device) -> torch.Tensor:
        """`t` on `device`: the copy every cross-shard value goes through
        (no copy when it is there already)."""
        device = canonical_device(device)
        if t.device == device:
            return t
        self.copies += 1
        return t.to(device)

    def _begin(self):
        self.steps += 1
        if not self.fence:
            return None
        self._sync()
        return time.perf_counter()

    def _end(self, t0) -> None:
        if t0 is not None:
            self._sync()
            self.seconds += time.perf_counter() - t0

    def _sync(self) -> None:
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    # -- placement --------------------------------------------------------------

    def split(self, t: torch.Tensor) -> Sharded:
        """Rows of `t` split evenly over the shards, each piece a tensor of
        its own on its shard's device."""
        rows = int(t.shape[0])
        if rows % self.n:
            raise ValueError(f"{rows} rows do not split over {self.n} shards")
        cnt = rows // self.n
        t0 = self._begin()
        out = []
        for i, dev in enumerate(self.devices):
            piece = t[i * cnt:(i + 1) * cnt]
            moved = self.copy(piece, dev)
            out.append(moved.clone() if moved is piece else moved)
        self._end(t0)
        return Sharded(tuple(out))

    def replicate(self, t: torch.Tensor) -> Replicated:
        """`t` copied once to every shard's device (a tensor of its own on
        each, the home copy included)."""
        t0 = self._begin()
        out = []
        for dev in self.devices:
            moved = self.copy(t, dev)
            out.append(moved.clone() if moved is t else moved)
        self._end(t0)
        return Replicated(tuple(out))

    def gather(self, x, device=None) -> torch.Tensor:
        """The whole value on `device` (default home): a Sharded value's
        shards concatenated in order, a Replicated value's home copy."""
        device = self.home if device is None else canonical_device(device)
        if isinstance(x, Replicated):
            return self.copy(x.copies[0], device)
        t0 = self._begin()
        parts = [self.copy(s, device) for s in x.shards]
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        self._end(t0)
        return out

    def take(self, x: Sharded, idx: np.ndarray, device=None) -> torch.Tensor:
        """Rows `idx` (global indices, host ints) of a Sharded value, in
        the order given, on `device` (default home)."""
        device = self.home if device is None else canonical_device(device)
        idx = np.asarray(idx, np.int64).reshape(-1)
        offs = x.offsets()
        owner = np.searchsorted(offs, idx, side="right") - 1
        t0 = self._begin()
        out = torch.empty((idx.shape[0],) + tuple(x.shards[0].shape[1:]),
                          dtype=x.dtype, device=device)
        for s in np.unique(owner):
            sel = np.nonzero(owner == s)[0]
            shard = x.shards[s]
            rows = shard[torch.from_numpy(idx[sel] - offs[s]).to(shard.device)]
            out[torch.from_numpy(sel).to(device)] = self.copy(rows, device)
        self._end(t0)
        return out

    def put(self, x, idx: np.ndarray, rows: torch.Tensor) -> None:
        """Write `rows` (any device) at global rows `idx` (host ints,
        unique) in place: into the owning shard of a Sharded value, into
        every copy of a Replicated one."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        if idx.shape[0] == 0:
            return
        t0 = self._begin()
        if isinstance(x, Replicated):
            for c in x.copies:
                c.index_copy_(0, torch.from_numpy(idx).to(c.device),
                              self.copy(rows, c.device))
        else:
            offs = x.offsets()
            owner = np.searchsorted(offs, idx, side="right") - 1
            for s in np.unique(owner):
                sel = np.nonzero(owner == s)[0]
                shard = x.shards[s]
                part = rows[torch.from_numpy(sel).to(rows.device)] \
                    if sel.shape[0] != idx.shape[0] else rows
                shard.index_copy_(0, torch.from_numpy(idx[sel] - offs[s]).to(shard.device),
                                  self.copy(part, shard.device))
        self._end(t0)

    def repartition(self, parts: Sequence[torch.Tensor], total: int,
                    counts: Sequence[int] = None) -> Sharded:
        """The rows of `parts` (their concatenation, zero-filled or cut to
        `total` rows) laid out again as shards of `counts` rows (evenly by
        default), each on its shard's device."""
        if counts is None:
            if total % self.n:
                raise ValueError(f"{total} rows do not split over {self.n} shards")
            counts = [total // self.n] * self.n
        offs = [0] + np.cumsum([int(p.shape[0]) for p in parts]).tolist()
        tail = tuple(parts[0].shape[1:])
        t0 = self._begin()
        out, lo = [], 0
        for cnt, dev in zip(counts, self.devices):
            hi, pieces, have = lo + cnt, [], 0
            for s, p in enumerate(parts):
                a, b = max(lo, offs[s]), min(hi, offs[s + 1])
                if a < b:
                    pieces.append(self.copy(p[a - offs[s]:b - offs[s]], dev))
                    have += b - a
            if have < cnt:
                pieces.append(torch.zeros((cnt - have,) + tail, dtype=parts[0].dtype,
                                          device=dev))
            out.append(torch.cat(pieces) if len(pieces) > 1 else pieces[0].clone())
            lo = hi
        self._end(t0)
        return Sharded(tuple(out))

    # -- collectives of the epoch program ------------------------------------

    def sum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Elementwise sum of the shards' partials (int64, mod 2**64), on
        every shard's device."""
        if self.n == 1:
            return [parts[0]]
        t0 = self._begin()
        total = parts[0]
        for p in parts[1:]:
            total = total + self.copy(p, self.home)
        out = [self.copy(total, dev) for dev in self.devices]
        self._end(t0)
        return out

    def umax(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The unsigned (uint64 bit pattern) maximum of the partials, on
        every shard's device."""
        if self.n == 1:
            return [parts[0]]
        t0 = self._begin()
        best = parts[0]
        for p in parts[1:]:
            best = umax(best, self.copy(p, self.home))
        out = [self.copy(best, dev) for dev in self.devices]
        self._end(t0)
        return out

    def prefix(self, parts: Sequence[torch.Tensor]):
        """-> per shard (total, exclusive prefix): the elementwise sum of
        every shard's partials and of the shards' before it."""
        if self.n == 1:
            return [(parts[0], torch.zeros_like(parts[0]))]
        t0 = self._begin()
        stacked = torch.stack([self.copy(p, self.home) for p in parts])
        incl = torch.cumsum(stacked, 0)
        total = incl[-1]
        out = [(self.copy(total, dev), self.copy(incl[i] - stacked[i], dev))
               for i, dev in enumerate(self.devices)]
        self._end(t0)
        return out

    def scatter_add(self, parts) -> List[torch.Tensor]:
        """parts[s] = (idx, values, rows): shard s (of `rows` rows) adds
        values at GLOBAL row indices idx. -> per shard the [rows] sums of
        every shard's values that land in its rows."""
        if self.n == 1:
            idx, vals, rows = parts[0]
            return [torch.zeros(rows, dtype=vals.dtype,
                                device=vals.device).index_add(0, idx, vals)]
        t0 = self._begin()
        offs = [0] + np.cumsum([p[2] for p in parts]).tolist()
        out = []
        for d, dev in enumerate(self.devices):
            rows = parts[d][2]
            acc = torch.zeros(rows, dtype=parts[0][1].dtype, device=dev)
            for idx, vals, _ in parts:
                local = idx - offs[d]
                hit = (local >= 0) & (local < rows)
                acc.index_add_(0, self.copy(torch.where(hit, local, 0), dev),
                               self.copy(torch.where(hit, vals, 0), dev))
            out.append(acc)
        self._end(t0)
        return out

    def rank(self, keys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each row's position in the stable ascending sort of all shards'
        keys (in row order), back on its shard's device."""
        t0 = self._begin()
        allk = keys[0] if self.n == 1 else torch.cat(
            [self.copy(k, self.home) for k in keys])
        order = torch.argsort(allk, stable=True)
        pos = torch.empty_like(order)
        pos[order] = torch.arange(allk.shape[0], dtype=order.dtype,
                                  device=order.device)
        if self.n == 1:
            out = [pos]
        else:
            out, lo = [], 0
            for k, dev in zip(keys, self.devices):
                out.append(self.copy(pos[lo:lo + k.shape[0]], dev))
                lo += int(k.shape[0])
        self._end(t0)
        return out
