"""Seeded, scriptable fault injection for the serving loop (port of
consensus_specs_tpu/resilience/faults.py).

`set_schedule(text)` arms the harness; `set_schedule(None)` disarms it,
and then every site is one module-global read. Faults inject at the
seams the serving loop already has:

  * **dispatch** -- resilience/dispatch.py consults `on_dispatch(key)`
    before every guarded launch (the watchdog's keys);
  * **checkpoint I/O** -- resilience/checkpoint.py routes every framed
    write through `on_checkpoint_write` and every read through
    `on_checkpoint_read`;
  * **mesh construction** -- parallel/sharding.py routes the visible
    device list through `filter_devices` (simulated device loss).

Schedule grammar (`;`-separated entries), the reference's:

    seed=<int>                         RNG seed for randomized mutations
    <site>@<n>=<action>[:<param>]      fire on the n-th matching call
    <site>@<a>-<b>=<action>[:<param>]  fire on matching calls a..b

`<n>` counts matching invocations from 1; `@<a>-<b>` is an inclusive
range. Sites:

    dispatch[:<glob>]   fnmatch glob over str(key); default `*`
    ckpt.write          the framed checkpoint bytes about to be written
    ckpt.read           the framed checkpoint bytes just read
    mesh                the device list a serving mesh is planned from

Actions by site:

    dispatch:   raise             transient error before the call
                fatal             non-retryable error before the call
                hang:<ms>         wedge the dispatch for <ms> (through the
                                  guard's injectable sleep)
                poison[:<leaf>]   corrupt output leaf <leaf> (default 0)
    ckpt.write: truncate:<k>      drop the last <k> bytes (a silent media
                                  error: the write still "succeeds")
                bitflip[:<i>]     flip one bit (byte <i>, or seeded-random)
                crash[:<frac>]    write only <frac> of the bytes, then raise
                                  SimulatedCrash (no rename)
    ckpt.read:  truncate:<k> / bitflip[:<i>]   the same, read side
    mesh:       lose:<k>          drop the last <k> devices

Example, a bad day at the epoch boundary:

    set_schedule("seed=7;dispatch:*epoch*@1=raise;"
                 "dispatch:*epoch*@2=poison:6;ckpt.write@2=truncate:33")

Every injected fault increments `resilience.faults_injected` and a
per-action counter (`resilience.faults.raise`, ...), both `always=True`.
"""
from __future__ import annotations

import fnmatch
import random
import threading
from typing import List, Optional, Tuple

from .errors import InjectedFault, SimulatedCrash

_lock = threading.Lock()
_schedule: Optional["_Schedule"] = None


class Fault:
    """One armed injection: `(action, param)` plus its source entry."""

    __slots__ = ("action", "param", "entry")

    def __init__(self, action: str, param, entry: str):
        self.action = action
        self.param = param
        self.entry = entry

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Fault({self.entry!r})"


class _Entry:
    __slots__ = ("site", "glob", "lo", "hi", "action", "param",
                 "matches", "text")

    def __init__(self, site, glob, lo, hi, action, param, text):
        self.site = site
        self.glob = glob
        self.lo = lo
        self.hi = hi
        self.action = action
        self.param = param
        self.matches = 0        # matching invocations seen so far
        self.text = text


class _Schedule:
    def __init__(self, entries: List[_Entry], seed: int):
        self.entries = entries
        self.seed = seed
        self._rng = random.Random(seed)

    def rng(self) -> random.Random:
        return self._rng

    def query(self, site: str, match_text: str = "") -> Optional[Fault]:
        """The n-th matching call fires the entry armed for n (the first
        entry wins when several cover the same call; every matching
        entry counts the call)."""
        fired = None
        with _lock:
            for e in self.entries:
                if e.site != site:
                    continue
                if e.glob is not None and not fnmatch.fnmatch(match_text,
                                                              e.glob):
                    continue
                e.matches += 1
                if fired is None and e.lo <= e.matches <= e.hi:
                    fired = Fault(e.action, e.param, e.text)
        return fired


_SITES = ("dispatch", "ckpt.write", "ckpt.read", "mesh")
_ACTIONS = {
    "dispatch": ("raise", "fatal", "hang", "poison"),
    "ckpt.write": ("truncate", "bitflip", "crash"),
    "ckpt.read": ("truncate", "bitflip"),
    "mesh": ("lose",),
}


def parse_schedule(text: str) -> _Schedule:
    """Parse the grammar above; a malformed schedule raises ValueError
    naming the entry (a drill that silently runs fault-free is worse
    than one that refuses to start)."""
    entries: List[_Entry] = []
    seed = 0
    for raw in text.split(";"):
        part = raw.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[5:])
            continue
        try:
            lhs, rhs = part.split("=", 1)
            site_occ, _, occ = lhs.rpartition("@")
            site, _, glob = site_occ.partition(":")
            site = site.strip()
            if site not in _SITES:
                raise ValueError(f"unknown site {site!r} "
                                 f"(expected one of {_SITES})")
            if glob and site != "dispatch":
                raise ValueError(f"only dispatch takes a key glob, "
                                 f"got {site!r}:{glob!r}")
            if "-" in occ:
                lo_s, hi_s = occ.split("-", 1)
                lo, hi = int(lo_s), int(hi_s)
            else:
                lo = hi = int(occ)
            if lo < 1 or hi < lo:
                raise ValueError(f"bad occurrence range {occ!r}")
            action, _, param = rhs.partition(":")
            action = action.strip()
            if action not in _ACTIONS[site]:
                raise ValueError(
                    f"action {action!r} invalid for site {site!r} "
                    f"(expected one of {_ACTIONS[site]})")
            entries.append(_Entry(
                site, (glob or "*") if site == "dispatch" else None,
                lo, hi, action, param or None, part))
        except Exception as exc:
            raise ValueError(f"malformed fault schedule entry {part!r}: "
                             f"{exc}") from exc
    return _Schedule(entries, seed)


# ---------------------------------------------------------------------------
# Activation / lookup
# ---------------------------------------------------------------------------

def set_schedule(text: Optional[str]) -> None:
    """Arm `text` for this process (None disarms). Occurrence counters
    start from zero on every call, so each drill phase counts afresh."""
    global _schedule
    _schedule = parse_schedule(text) if text is not None else None


def active() -> bool:
    """True when a fault schedule is armed."""
    return _schedule is not None


def _count(action: str) -> None:
    from .. import telemetry
    telemetry.counter("resilience.faults_injected", always=True).inc()
    telemetry.counter(f"resilience.faults.{action}", always=True).inc()


# ---------------------------------------------------------------------------
# Injection sites
# ---------------------------------------------------------------------------

def on_dispatch(key) -> Optional[Fault]:
    """Consulted by guarded_dispatch before each attempt. The returned
    fault is acted on by the guard (raise / hang / poison need its
    cooperation); counting happens here."""
    sched = _schedule
    if sched is None:
        return None
    fault = sched.query("dispatch", str(key))
    if fault is not None:
        _count(fault.action)
    return fault


def raise_injected(key, fault: Fault) -> None:
    """Raise a raise/fatal fault with the status word the classifier
    sorts it by: INTERNAL is transient, INVALID_ARGUMENT fatal."""
    if fault.action == "raise":
        raise InjectedFault(
            f"INTERNAL: injected transient failure at {key!r} "
            f"({fault.entry})")
    raise InjectedFault(
        f"INVALID_ARGUMENT: injected fatal failure at {key!r} "
        f"({fault.entry})")


def tree_leaves(tree) -> list:
    """The leaves of an output tree in the order the reference's
    `jax.tree_util.tree_flatten` gives for the same structure: tuples
    (namedtuples included) and lists in order, dicts by sorted key, None
    as an empty subtree, everything else a leaf."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _replace_leaf(tree, idx: int, new):
    """A copy of `tree` (same containers, same other leaves) with the
    leaf at flat index `idx` replaced by `new`; -> (tree, leaves used)."""
    if tree is None:
        return None, 0
    if isinstance(tree, (tuple, list, dict)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        out, used = {}, 0
        for k in keys:
            out[k], n = _replace_leaf(tree[k], idx - used, new)
            used += n
        if isinstance(tree, dict):
            return out, used
        items = [out[k] for k in keys]
        if hasattr(tree, "_fields"):
            return type(tree)(*items), used
        return type(tree)(items), used
    return (new if idx == 0 else tree), 1


def _bad_value(leaf):
    """The corrupt value for `leaf`'s dtype: NaN for floats, True for
    bools, -1 for int64 (the all-ones bit pattern: uint64's maximum, as
    every uint64 of the port is held in int64), else the dtype maximum."""
    import torch
    if leaf.dtype.is_floating_point:
        return float("nan")
    if leaf.dtype == torch.bool:
        return True
    if leaf.dtype == torch.int64:
        return -1
    return torch.iinfo(leaf.dtype).max


def poison_tree(out, leaf_spec):
    """Corrupt one output leaf: element 0 of leaf `leaf_spec` (a flat
    index in the order of `tree_leaves`, clamped to the last leaf;
    default 0) is set to `_bad_value`. Returns a NEW tree: the one leaf
    is cloned, nothing is written in place."""
    idx = int(leaf_spec) if leaf_spec else 0
    leaves = tree_leaves(out)
    idx = min(idx, len(leaves) - 1)
    poisoned = leaves[idx].clone()
    poisoned.view(-1)[0] = _bad_value(poisoned)
    return _replace_leaf(out, idx, poisoned)[0]


def _mutate_bytes(data: bytes, fault: Fault, rng: random.Random) -> bytes:
    if fault.action == "truncate":
        k = int(fault.param or 1)
        return data[:max(0, len(data) - k)]
    if fault.action == "bitflip":
        if not data:
            return data
        i = int(fault.param) if fault.param else rng.randrange(len(data))
        i = min(i, len(data) - 1)
        buf = bytearray(data)
        buf[i] ^= 1 << rng.randrange(8)
        return bytes(buf)
    raise AssertionError(fault.action)


def on_checkpoint_write(data: bytes) -> Tuple[bytes, bool]:
    """-> (bytes to actually write, crash_mid_write). With a `crash`
    fault the bytes are a prefix; the caller writes them and raises
    SimulatedCrash without renaming (`CheckpointStore.save`)."""
    sched = _schedule
    if sched is None:
        return data, False
    fault = sched.query("ckpt.write")
    if fault is None:
        return data, False
    _count(fault.action)
    if fault.action == "crash":
        frac = float(fault.param) if fault.param else 0.5
        return data[:int(len(data) * frac)], True
    return _mutate_bytes(data, fault, sched.rng()), False


def on_checkpoint_read(data: bytes) -> bytes:
    sched = _schedule
    if sched is None:
        return data
    fault = sched.query("ckpt.read")
    if fault is None:
        return data
    _count(fault.action)
    return _mutate_bytes(data, fault, sched.rng())


def filter_devices(devices):
    """Simulated device loss at mesh-construction time: a `mesh=lose:<k>`
    fault drops the last k devices, clamped to keep at least one (total
    loss is a process kill, which the checkpoint store's restore covers).
    The caller re-plans its mesh from what is left: ServingMesh.available
    rounds down to a power of two."""
    sched = _schedule
    if sched is None:
        return devices
    fault = sched.query("mesh")
    if fault is None:
        return devices
    _count(fault.action)
    k = int(fault.param or 1)
    return list(devices)[:max(1, len(devices) - k)]


__all__ = ["Fault", "active", "set_schedule", "parse_schedule",
           "on_dispatch", "raise_injected", "poison_tree", "tree_leaves",
           "on_checkpoint_write", "on_checkpoint_read", "filter_devices",
           "InjectedFault", "SimulatedCrash"]
