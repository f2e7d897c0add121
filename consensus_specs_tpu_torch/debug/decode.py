"""Decode YAML/JSON-friendly structures back into SSZ values.

Capability parity: consensus-specs test_libs/pyspec/eth2spec/debug/decode.py:10-39.
"""
from __future__ import annotations

from typing import Any

from ..utils.ssz.typing import (
    is_bool_type, is_bytes_type, is_bytesn_type, is_container_type,
    is_list_type, is_uint_type, is_vector_type,
)


def decode(data: Any, typ: Any) -> Any:
    if is_uint_type(typ):
        return int(data) if typ is int else typ(int(data))
    if is_bool_type(typ):
        assert data in (True, False)
        return data
    if is_list_type(typ):
        return [decode(element, typ.elem_type) for element in data]
    if is_vector_type(typ):
        return typ([decode(element, typ.elem_type) for element in data])
    if is_bytes_type(typ):
        return bytes.fromhex(data[2:])
    if is_bytesn_type(typ):
        return typ(bytes.fromhex(data[2:]))
    if is_container_type(typ):
        temp = {}
        for field, subtype in typ.get_fields():
            temp[field] = decode(data[field], subtype)
            if field + "_hash_tree_root" in data:
                from ..utils.ssz.impl import hash_tree_root
                assert data[field + "_hash_tree_root"][2:] == hash_tree_root(temp[field], subtype).hex()
        return typ(**temp)
    raise TypeError(f"cannot decode {data!r} as {typ}")
