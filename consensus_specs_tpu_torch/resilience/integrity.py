"""Output-integrity tripwires (port of
consensus_specs_tpu/resilience/integrity.py).

The reference's value-range analyzer proves at trace time that every
epoch output stays inside a declared hull: balances below 2^45,
effective balances at most MAX_EFFECTIVE_BALANCE, slots and epochs
below their ceilings. A poisoned device buffer (a flipped bit in memory,
an injected `poison` fault) breaks exactly those proofs at run time, so
the hulls make a cheap tripwire: `epoch_output_check` answers "is every
finitely bounded output leaf inside its hull?" with one chain of torch
reductions on the output's device and ONE bool read to the host. A False
becomes `CorruptOutput` in the guarded dispatch instead of a corrupt
state root.

The port has no range analyzer: the hulls are constants copied from the
reference's declarations (`declared_epoch_hulls`,
`declared_epoch_scalar_hulls`; tests/test_torch_resilience.py holds them
equal to the reference's functions). uint64 leaves are int64 bit
patterns, so every compare goes through ops/intmath.py's `ule`: a plain
`<=` would read the all-ones poison (-1) as in range.

The resident epoch boundary arms the check while `tripwires_enabled()`
(default on; `set_tripwires(False)` turns it off).
"""
from __future__ import annotations

from typing import Dict, Optional

from ..ops.intmath import ule
from .faults import tree_leaves

_U64_MAX = (1 << 64) - 1

# the reference's declared input hulls of the epoch program (outputs
# chain into the next boundary's inputs, so they must re-enter them)
_EPOCH_HULLS = {
    "activation_eligibility_epoch": (0, _U64_MAX),
    "activation_epoch": (0, _U64_MAX),
    "exit_epoch": (0, _U64_MAX),
    "withdrawable_epoch": (0, _U64_MAX),
    "slashed": (0, 1),
    "effective_balance": (0, 32 * 10 ** 9),
    "balance": (0, 1 << 45),
}
_EPOCH_SCALAR_HULLS = {
    "slot": (0, 1 << 24),
    "previous_justified_epoch": (0, 1 << 19),
    "current_justified_epoch": (0, 1 << 19),
    "justification_bitfield": (0, _U64_MAX),
    "finalized_epoch": (0, 1 << 19),
    "latest_start_shard": (0, 1023),
    "latest_slashed_balances": (0, 1 << 59),
}

_enabled = True


def set_tripwires(enabled: Optional[bool]) -> None:
    """Arm (True, and None: the default) or disarm the resident epoch
    boundary's tripwire."""
    global _enabled
    _enabled = True if enabled is None else bool(enabled)


def tripwires_enabled() -> bool:
    return _enabled


def declared_epoch_hulls() -> Dict[str, tuple]:
    """The per-column hulls {field: (lo, hi)} of ValidatorColumns."""
    return dict(_EPOCH_HULLS)


def declared_epoch_scalar_hulls() -> Dict[str, tuple]:
    """The EpochScalars hulls. The justification bitfield spans all of
    uint64, so a range check cannot see a flip there: in-hull corruption
    is invisible to a hull check by construction."""
    return dict(_EPOCH_SCALAR_HULLS)


def _finite_items(hulls: Dict[str, tuple]) -> tuple:
    """The hulls with a finite bound, sorted by field: full-uint64 hulls
    (FAR_FUTURE_EPOCH sentinels, the bitfield) are vacuous."""
    return tuple(sorted((f, hull) for f, hull in hulls.items()
                        if hull[1] < _U64_MAX))


def _in_hulls(tree, items, ok):
    """ok AND every uint64 leaf named in `items` at most its hull's
    upper bound, as a device bool (no host read). Bool leaves are their
    own hull; every declared lower bound is 0, which a uint64 cannot go
    below."""
    import torch
    for f, (_, hi) in items:
        leaf = getattr(tree, f)
        # a serving mesh's column is one tensor a shard (parallel/exchange.py)
        for part in getattr(leaf, "shards", (leaf,)):
            if part.dtype != torch.bool:
                ok = ok & ule(part, hi).all().to(ok.device)
    return ok


def epoch_output_check(out) -> bool:
    """Tripwire for the epoch program's output `(cols, scal, report)`:
    every ValidatorColumns leaf and every EpochScalars leaf with a finite
    declared hull lies inside it. True when the output is clean.

    One chain of reductions on the columns' device (a sharded column's
    shards each reduced on theirs) and one bool read: the only host
    synchronization of the check."""
    import torch
    cols, scal = out[0], (out[1] if len(out) > 1 else None)
    home = getattr(cols.balance, "shards", (cols.balance,))[0].device
    ok = torch.ones((), dtype=torch.bool, device=home)
    ok = _in_hulls(cols, _finite_items(_EPOCH_HULLS), ok)
    if scal is not None:
        ok = _in_hulls(scal, _finite_items(_EPOCH_SCALAR_HULLS), ok)
    return bool(ok)


def finite_check(tree) -> bool:
    """NaN/inf tripwire for float-bearing outputs: True when every float
    leaf of `tree` is finite (one bool read)."""
    import torch
    floats = [leaf for leaf in tree_leaves(tree)
              if isinstance(leaf, torch.Tensor) and leaf.dtype.is_floating_point]
    if not floats:
        return True
    ok = torch.isfinite(floats[0]).all()
    for leaf in floats[1:]:
        ok = ok & torch.isfinite(leaf).all().to(ok.device)
    return bool(ok)
