"""Carry state between the reference's forms and the port's.

The reference's ValidatorColumns / EpochScalars / EpochInputs /
EpochReport, as numpy arrays (uint64, bool, int32), become the port's
NamedTuples of tensors and back. uint64 values cross as their bit
patterns (an int64 view), so a round trip is exact.

Serialized SSZ (a BeaconState or BeaconBlock written by the JAX package,
or by anything else that speaks SSZ) becomes the port's containers:
state_from_bytes / block_from_bytes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve
from .parallel.exchange import Sharded
from .models.phase0.epoch_soa import (EpochInputs, EpochReport, EpochScalars,
                                      ValidatorColumns)


def to_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array (uint64 as its int64 bit pattern, bool, int32, int64)
    -> a tensor on `device`."""
    a = np.asarray(x)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype not in (np.bool_, np.int32, np.int64):
        raise TypeError(f"unexpected column dtype {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(device)   # keeps 0-d


def to_numpy(t) -> np.ndarray:
    """A tensor -> a numpy copy (int64 viewed back as uint64). A Sharded
    value (parallel/exchange.py) comes down shard by shard, in row
    order."""
    if isinstance(t, Sharded):
        return np.concatenate([to_numpy(s) for s in t.shards])
    a = t.detach().to("cpu", copy=True).numpy()   # never a view of live state
    return a.view(np.uint64) if a.dtype == np.int64 else a


def _convert(src, cls, fn):
    return cls(**{f: fn(getattr(src, f)) for f in cls._fields})


def columns_from_numpy(cols=None, scal=None, inp=None, device="cuda"):
    """numpy (cols, scal, inp) -> the port's tensors on `device`; any of
    them may be None (the host distillation's scalars and inputs come
    without columns). Fields are read by name, so the reference's
    NamedTuples (after np.asarray of each field) work as they are."""
    dev = resolve(device)
    conv = lambda x: to_tensor(x, dev)  # noqa: E731
    out_cols = None if cols is None else _convert(cols, ValidatorColumns, conv)
    out_scal = None if scal is None else _convert(scal, EpochScalars, conv)
    out_inp = None if inp is None else _convert(inp, EpochInputs, conv)
    return out_cols, out_scal, out_inp


def columns_to_numpy(cols: Optional[ValidatorColumns] = None,
                     scal: Optional[EpochScalars] = None,
                     report: Optional[EpochReport] = None):
    """The port's tensors -> numpy (uint64 bit patterns restored); any of
    them may be None. The epoch program's scalars and report come back as
    uint64 scalars and a bool report, the form
    epoch_soa._apply_justification reads."""
    np_cols = None if cols is None else _convert(cols, ValidatorColumns, to_numpy)
    np_scal = None if scal is None else _convert(scal, EpochScalars, to_numpy)
    np_rep = None if report is None else _convert(report, EpochReport, to_numpy)
    return np_cols, np_scal, np_rep


def state_from_bytes(spec, data: bytes):
    """Serialized BeaconState -> the port's BeaconState of `spec`."""
    from .utils.ssz.impl import deserialize
    return deserialize(bytes(data), spec.BeaconState)


def block_from_bytes(spec, data: bytes):
    """Serialized BeaconBlock -> the port's BeaconBlock of `spec`."""
    from .utils.ssz.impl import deserialize
    return deserialize(bytes(data), spec.BeaconBlock)


def limbs_from_numpy(arr, device="cuda") -> torch.Tensor:
    """The reference's BLS limb arrays (numpy int64 [..., 14] Fq,
    [..., 2, 14] Fq2 or affine G1, [..., 2, 3, 2, 14] Fq12, ...) -> an
    int64 tensor of the same shape on `device`."""
    a = np.asarray(arr)
    if a.dtype != np.int64:
        raise TypeError(f"expected int64 limbs, got {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(resolve(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Port limb tensor -> numpy int64 of the same shape (a copy)."""
    return t.detach().to("cpu", copy=True).numpy()
