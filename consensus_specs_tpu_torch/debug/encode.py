"""Encode SSZ values into YAML/JSON-friendly plain structures.

Capability parity: consensus-specs test_libs/pyspec/eth2spec/debug/encode.py:9-36.
Big uints (>64 bit) are emitted as decimal strings so YAML consumers don't
lose precision; bytes become 0x-hex; containers become dicts (insertion order
= field order).
"""
from __future__ import annotations

from typing import Any

from ..utils.ssz.impl import hash_tree_root, signing_root
from ..utils.ssz.typing import (
    Container, infer_type, is_bool_type, is_bytes_type, is_bytesn_type,
    is_container_type, is_list_type, is_uint_type, is_vector_type, uint_byte_size,
)


def encode(value: Any, typ: Any = None, include_hash_tree_roots: bool = False) -> Any:
    if typ is None:
        typ = infer_type(value)
    if is_uint_type(typ):
        if uint_byte_size(typ) > 8:
            return str(int(value))  # avoid YAML 64-bit overflow
        return int(value)
    if is_bool_type(typ):
        return bool(value)
    if is_list_type(typ) or is_vector_type(typ):
        return [encode(element, typ.elem_type, include_hash_tree_roots) for element in value]
    if is_bytes_type(typ) or is_bytesn_type(typ):
        return "0x" + bytes(value).hex()
    if is_container_type(typ):
        ret = {}
        for field, subtype in typ.get_fields():
            ret[field] = encode(getattr(value, field), subtype, include_hash_tree_roots)
            if include_hash_tree_roots:
                ret[field + "_hash_tree_root"] = "0x" + hash_tree_root(getattr(value, field), subtype).hex()
        if include_hash_tree_roots:
            ret["hash_tree_root"] = "0x" + hash_tree_root(value, typ).hex()
        return ret
    raise TypeError(f"cannot encode {value!r} as {typ}")


def encode_with_signing_root(value: Container) -> Any:
    ret = encode(value, value.__class__)
    ret["signing_root"] = "0x" + signing_root(value).hex()
    return ret
