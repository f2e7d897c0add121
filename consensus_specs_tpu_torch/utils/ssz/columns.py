"""Checkpoint fast path: serialized SSZ state bytes -> SoA numpy columns
(own copy of consensus_specs_tpu/utils/ssz/columns.py).

The production pipeline keeps the validator registry as device-resident
columns; states arrive from disk or the wire as SSZ bytes (the reference's
checkpoint form — `BeaconState` is trivially serializable, SURVEY §5 /
specs/simple-serialize.md). Resuming through the object model means
materializing V Python `Validator` objects and walking them attribute by
attribute (`epoch_soa.columns_np_from_state`) — the measured distill floor
at 1M validators. This module goes straight from bytes to columns with
strided numpy views: the registry is a [V, stride] byte matrix (Validator
is fixed-size, so `List[Validator]` serializes as concatenated records,
specs/simple-serialize.md:79-133), each field a constant-offset column
slice.

Field offsets and the record stride are derived from the container type at
call time, so phase-1's appended custody fields (models/phase1/containers)
shift nothing by hand — the stride grows and the phase-0 offsets stay put
(the reference's append-only field contract, 1_custody-game.md:210-246).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .impl import fixed_byte_size, is_fixed_size, series_field_spans
from .typing import is_container_type, is_uint_type


def fixed_field_layout(typ: Any) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """Fixed-size container -> ({field: (offset, size)}, record stride)."""
    assert is_container_type(typ) and is_fixed_size(typ), \
        "layout only exists for fixed-size containers"
    layout: Dict[str, Tuple[int, int]] = {}
    pos = 0
    for name, t in zip(typ.get_field_names(), typ.get_field_types()):
        size = fixed_byte_size(t)
        layout[name] = (pos, size)
        pos += size
    return layout, pos


def container_field_spans(data: bytes, typ: Any) -> Dict[str, Tuple[int, int]]:
    """Byte span of every top-level field of a serialized container, via
    the one shared offset-grammar walker (impl.series_field_spans — the
    same code path _decode_series validates with)."""
    assert is_container_type(typ)
    return dict(zip(typ.get_field_names(),
                    series_field_spans(data, typ.get_field_types())))


def _u64_column(recs: np.ndarray, off: int) -> np.ndarray:
    return np.ascontiguousarray(recs[:, off:off + 8]).view("<u8").ravel()


def registry_columns_from_bytes(reg_bytes, validator_type: Any
                                ) -> Dict[str, np.ndarray]:
    """Serialized `List[Validator]` payload -> numpy column per field.

    uint64 fields come back as [V] uint64, the slashed bool as [V] bool,
    byte-vector fields (pubkey, withdrawal_credentials) as [V, size] uint8."""
    layout, stride = fixed_field_layout(validator_type)
    n = len(reg_bytes)
    # Checkpoint-integrity checks are real raises, not asserts: the module
    # contract is that a corrupted checkpoint MUST fail here, and python -O
    # strips asserts (same convention as fq_tower's _check_budget).
    if n % stride != 0:
        raise ValueError("registry payload is not a whole number of records")
    recs = np.frombuffer(reg_bytes, dtype=np.uint8).reshape(n // stride, stride)
    cols: Dict[str, np.ndarray] = {}
    for name, t in zip(validator_type.get_field_names(),
                       validator_type.get_field_types()):
        off, size = layout[name]
        if t is bool:
            raw = recs[:, off]
            # strict like deserialize_basic: a corrupted checkpoint must
            # fail here, not resume with a silently-true flag
            if not ((raw == 0) | (raw == 1)).all():
                raise ValueError(f"{name}: invalid bool encoding")
            cols[name] = raw.astype(bool)
        elif is_uint_type(t):
            assert size == 8, f"{name}: only uint64 columns are supported"
            cols[name] = _u64_column(recs, off)
        else:
            cols[name] = recs[:, off:off + size].copy()
    return cols


def registry_bytes_from_columns(np_cols: Dict[str, np.ndarray],
                                validator_type: Any) -> bytes:
    """Inverse of registry_columns_from_bytes: SoA columns -> the
    serialized `List[Validator]` payload, one vectorized record assembly
    (no per-validator Python)."""
    layout, stride = fixed_field_layout(validator_type)
    n = len(np_cols["slashed"])
    recs = np.zeros((n, stride), dtype=np.uint8)
    for name, t in zip(validator_type.get_field_names(),
                       validator_type.get_field_types()):
        off, size = layout[name]
        col = np_cols[name]
        if t is bool:
            recs[:, off] = np.asarray(col, dtype=np.uint8)
        elif is_uint_type(t):
            recs[:, off:off + 8] = np.asarray(col, dtype=np.uint64).astype(
                "<u8").view(np.uint8).reshape(n, 8)
        else:
            recs[:, off:off + size] = col
    return recs.tobytes()


def state_bytes_from_columns(light_state, np_cols: Dict[str, np.ndarray],
                             spec) -> bytes:
    """(light state, registry/balances columns) -> serialized BeaconState.

    The checkpoint WRITE path of the resident pipeline: every small field
    serializes from the light state through the normal encoder, the two
    registry-scale fields assemble straight from columns — the exact
    inverse of (light_state_from_bytes, state_columns_from_bytes), so
    enter->exit round-trips byte-identically (tests/test_resident.py).
    Offset grammar mirrors impl._encode_series."""
    from .impl import BYTES_PER_LENGTH_OFFSET, serialize

    typ = spec.BeaconState
    parts = []
    for name, t in zip(typ.get_field_names(), typ.get_field_types()):
        if name == "validator_registry":
            parts.append((False, registry_bytes_from_columns(
                np_cols, spec.Validator)))
        elif name == "balances":
            parts.append((False, np.asarray(
                np_cols["balance"], dtype=np.uint64).astype("<u8").tobytes()))
        else:
            parts.append((is_fixed_size(t),
                          serialize(getattr(light_state, name), t)))
    fixed_len = sum(len(s) if fixed else BYTES_PER_LENGTH_OFFSET
                    for fixed, s in parts)
    offset = fixed_len
    fixed_parts, variable_parts = [], []
    for fixed, s in parts:
        if fixed:
            fixed_parts.append(s)
        else:
            fixed_parts.append(offset.to_bytes(BYTES_PER_LENGTH_OFFSET, "little"))
            variable_parts.append(s)
            offset += len(s)
    return b"".join(fixed_parts + variable_parts)


def state_columns_from_bytes(state_bytes: bytes, spec) -> Dict[str, np.ndarray]:
    """Serialized `BeaconState` -> the epoch-pipeline column dict
    (same keys/dtypes as `epoch_soa.columns_np_from_state`, plus the
    registry's identity columns) without materializing any Python objects."""
    spans = container_field_spans(state_bytes, spec.BeaconState)
    lo, hi = spans["validator_registry"]
    # memoryview slice: no copy of the ~121 MB/1M-validator payload — the
    # only copies are the per-column materializations
    cols = registry_columns_from_bytes(memoryview(state_bytes)[lo:hi],
                                       spec.Validator)
    lo, hi = spans["balances"]
    if (hi - lo) % 8 != 0:
        raise ValueError("balances payload is not a whole number of uint64s")
    cols["balance"] = np.frombuffer(state_bytes, dtype="<u8",
                                    count=(hi - lo) // 8, offset=lo).copy()
    if cols["slashed"].shape != cols["balance"].shape:
        raise ValueError("registry and balances lengths disagree")
    return cols
