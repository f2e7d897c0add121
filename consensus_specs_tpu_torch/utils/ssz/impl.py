"""SSZ serialization, deserialization, and Merkleization (2019 / v0.6-era rules).

Wire format (per consensus-specs specs/simple-serialize.md:79-133): fixed-size
parts inline, variable-size parts appended after the fixed region with 4-byte
little-endian offsets interleaved at their field positions.

Hash-tree-root (per consensus-specs specs/simple-serialize.md:139-158): pack
basic series into 32-byte chunks, merkleize with power-of-two zero-padding,
`mix_in_length` for list kinds; `signing_root` drops the final field.

Merkleization is routed through utils.merkle.merkleize_chunks (hashlib, one
call per level); the registry-scale roots take utils/ssz/bulk.py instead.
Own copy of consensus_specs_tpu/utils/ssz/impl.py.

Capability parity: consensus-specs test_libs/pyspec/eth2spec/utils/ssz/ssz_impl.py:1-163
(re-designed; adds full deserialize(), which the reference lacks).
"""
from __future__ import annotations

from typing import Any, Dict, List as PyList, Tuple

from ..hash import sha256
from ..merkle import merkleize_chunks
from .typing import (
    Container,
    infer_type, is_bool_type, is_bytes_type, is_bytesn_type,
    is_container_type, is_list_kind, is_list_type, is_uint_type,
    is_vector_kind, is_vector_type, read_elem_type, uint, uint_byte_size,
)

BYTES_PER_LENGTH_OFFSET = 4


def is_basic_type(typ: Any) -> bool:
    return is_uint_type(typ) or is_bool_type(typ)


def serialize_basic(value: Any, typ: Any) -> bytes:
    if is_uint_type(typ):
        return int(value).to_bytes(uint_byte_size(typ), "little")
    if is_bool_type(typ):
        return b"\x01" if value else b"\x00"
    raise TypeError(f"not a basic type: {typ}")


def deserialize_basic(data: bytes, typ: Any) -> Any:
    if is_uint_type(typ):
        v = int.from_bytes(data, "little")
        return typ(v) if issubclass(typ, uint) else v
    if is_bool_type(typ):
        assert data in (b"\x00", b"\x01"), "invalid bool encoding"
        return data == b"\x01"
    raise TypeError(f"not a basic type: {typ}")


def is_fixed_size(typ: Any) -> bool:
    if is_basic_type(typ):
        return True
    if is_list_kind(typ):
        return False
    if is_vector_kind(typ):
        return is_bytesn_type(typ) or is_fixed_size(typ.elem_type)
    if is_container_type(typ):
        return all(is_fixed_size(t) for t in typ.get_field_types())
    raise TypeError(f"unsupported type: {typ}")


def fixed_byte_size(typ: Any) -> int:
    """Serialized length of a fixed-size type."""
    if is_basic_type(typ):
        return uint_byte_size(typ) if is_uint_type(typ) else 1
    if is_bytesn_type(typ):
        return typ.length
    if is_vector_type(typ):
        return typ.length * fixed_byte_size(typ.elem_type)
    if is_container_type(typ):
        return sum(fixed_byte_size(t) for t in typ.get_field_types())
    raise TypeError(f"not fixed-size: {typ}")


def serialize(obj: Any, typ: Any = None) -> bytes:
    if typ is None:
        typ = infer_type(obj)
    if is_basic_type(typ):
        return serialize_basic(obj, typ)
    if is_list_kind(typ) or is_vector_kind(typ):
        if isinstance(obj, bytes):
            return bytes(obj)
        return _encode_series(list(obj), [read_elem_type(typ)] * len(obj))
    if is_container_type(typ):
        return _encode_series(obj.get_field_values(), typ.get_field_types())
    raise TypeError(f"unsupported type: {typ}")


def _encode_series(values: PyList[Any], types: PyList[Any]) -> bytes:
    parts = [(is_fixed_size(t), serialize(v, t)) for v, t in zip(values, types)]
    fixed_len = sum(len(s) if fixed else BYTES_PER_LENGTH_OFFSET for fixed, s in parts)
    total = fixed_len + sum(len(s) for fixed, s in parts if not fixed)
    assert total < 2 ** (BYTES_PER_LENGTH_OFFSET * 8)

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


# ---------------------------------------------------------------------------
# Deserialization (capability the reference only has via its debug codecs)
# ---------------------------------------------------------------------------

def deserialize(data: bytes, typ: Any) -> Any:
    if is_basic_type(typ):
        assert len(data) == fixed_byte_size(typ)
        return deserialize_basic(data, typ)
    if is_bytes_type(typ):
        return bytes(data)
    if is_bytesn_type(typ):
        return typ(data)
    if is_list_type(typ):
        return _decode_homogeneous(data, typ.elem_type, count=None)
    if is_vector_type(typ):
        return typ(_decode_homogeneous(data, typ.elem_type, count=typ.length))
    if is_container_type(typ):
        values = _decode_series(data, typ.get_field_types())
        return typ(**dict(zip(typ.get_field_names(), values)))
    raise TypeError(f"unsupported type: {typ}")


def _decode_homogeneous(data: bytes, elem_type: Any, count: Any) -> PyList[Any]:
    if is_fixed_size(elem_type):
        size = fixed_byte_size(elem_type)
        assert size > 0 and len(data) % size == 0, "length not a multiple of element size"
        n = len(data) // size
        if count is not None:
            assert n == count, f"expected {count} elements, got {n}"
        return [deserialize(data[i * size:(i + 1) * size], elem_type) for i in range(n)]
    # variable-size elements: leading offset table
    if len(data) == 0:
        assert count is None or count == 0, f"expected {count} elements, got empty data"
        return []
    first = int.from_bytes(data[:BYTES_PER_LENGTH_OFFSET], "little")
    assert first % BYTES_PER_LENGTH_OFFSET == 0, "first offset not offset-table aligned"
    n = first // BYTES_PER_LENGTH_OFFSET
    if count is not None:
        assert n == count, f"expected {count} elements, got {n}"
    w = BYTES_PER_LENGTH_OFFSET
    offsets = [int.from_bytes(data[i * w:(i + 1) * w], "little") for i in range(n)] + [len(data)]
    assert offsets[0] == n * w, "offset table size mismatch"
    for i in range(n):
        assert offsets[i] <= offsets[i + 1], "offsets not monotonic"
    return [deserialize(data[offsets[i]:offsets[i + 1]], elem_type) for i in range(n)]


def series_field_spans(data: bytes, types: PyList[Any]
                       ) -> PyList[Tuple[int, int]]:
    """Byte span of each field of a serialized field sequence — the SSZ
    offset grammar (fixed fields in order; variable fields hold 4-byte
    offsets partitioning the tail monotonically), shared by _decode_series
    and the checkpoint fast path (utils/ssz/columns.py)."""
    pos = 0
    spans: PyList[Any] = []
    pending: PyList[int] = []        # indices of variable-size fields
    for k, t in enumerate(types):
        if is_fixed_size(t):
            size = fixed_byte_size(t)
            spans.append((pos, pos + size))
            pos += size
        else:
            spans.append(int.from_bytes(data[pos:pos + 4], "little"))
            pending.append(k)
            pos += 4
    if pending:
        assert spans[pending[0]] == pos, \
            "first offset must point to end of fixed region"
        ends = [spans[k] for k in pending[1:]] + [len(data)]
        for k, end in zip(pending, ends):
            off = spans[k]
            assert off <= end <= len(data), "offsets not monotonic / out of bounds"
            spans[k] = (off, end)
    else:
        assert pos == len(data), "trailing bytes after fixed-size container"
    return spans


def _decode_series(data: bytes, types: PyList[Any]) -> PyList[Any]:
    spans = series_field_spans(data, types)
    return [deserialize(data[a:b], t) for (a, b), t in zip(spans, types)]


# ---------------------------------------------------------------------------
# Hash tree root
# ---------------------------------------------------------------------------

def pack(values: Any, subtype: Any) -> bytes:
    if isinstance(values, bytes):
        return bytes(values)
    return b"".join(serialize_basic(v, subtype) for v in values)


def chunkify(data: bytes) -> PyList[bytes]:
    data += b"\x00" * (-len(data) % 32)
    return [data[i:i + 32] for i in range(0, len(data), 32)] or [b"\x00" * 32]


def mix_in_length(root: bytes, length: int) -> bytes:
    return sha256(root + length.to_bytes(32, "little"))


def is_bottom_layer_kind(typ: Any) -> bool:
    return is_basic_type(typ) or (
        (is_list_kind(typ) or is_vector_kind(typ)) and is_basic_type(read_elem_type(typ))
    )


_BASIC, _PACKED, _SERIES, _CONTAINER = range(4)
# type -> (kind, element type, mixes in its length): the type predicates'
# answers, read once a type (List[T] and Vector[T, N] are cached classes)
_root_kinds: Dict[Any, Tuple[int, Any, bool]] = {}


def _root_kind(typ: Any) -> Tuple[int, Any, bool]:
    kind = _root_kinds.get(typ)
    if kind is None:
        if is_bottom_layer_kind(typ):
            kind = ((_BASIC, None, False) if is_basic_type(typ)
                    else (_PACKED, read_elem_type(typ), is_list_kind(typ)))
        elif is_list_type(typ) or is_vector_type(typ):
            kind = (_SERIES, typ.elem_type, is_list_type(typ))
        elif is_container_type(typ):
            kind = (_CONTAINER, None, False)
        else:
            raise TypeError(f"unsupported type: {typ}")
        _root_kinds[typ] = kind
    return kind


def hash_tree_root(obj: Any, typ: Any = None) -> bytes:
    if typ is None:
        typ = infer_type(obj)
    kind, elem, mix = _root_kind(typ)
    if kind == _BASIC:
        leaves = chunkify(serialize_basic(obj, typ))
    elif kind == _PACKED:
        leaves = chunkify(pack(obj, elem))
    elif kind == _SERIES:
        leaves = [hash_tree_root(v, elem) for v in obj]
    else:
        leaves = [hash_tree_root(v, t) for v, t in obj.get_typed_values()]
    if mix:
        return mix_in_length(merkleize_chunks(leaves), len(obj))
    return merkleize_chunks(leaves)


def signing_root(obj: Container, typ: Any = None) -> bytes:
    if typ is None:
        typ = obj.__class__
    assert is_container_type(typ)
    leaves = [hash_tree_root(v, t) for v, t in obj.get_typed_values()[:-1]]
    return merkleize_chunks(leaves)
