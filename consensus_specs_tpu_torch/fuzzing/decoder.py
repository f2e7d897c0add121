"""Spec SSZ types <-> sedes descriptors + value translation.

Mirror of the reference's pyssz bridge
(consensus-specs test_libs/pyspec/eth2spec/fuzzing/decoder.py:5-84:
translate_typ / translate_value), retargeted at the in-repo independent
codec (fuzzing/sedes.py).
"""
from __future__ import annotations

from typing import Any

from ..utils.ssz.typing import (
    is_bool_type, is_bytes_type, is_bytesn_type, is_container_type,
    is_list_type, is_uint_type, is_vector_type, uint_byte_size)
from . import sedes as s


def translate_type(typ: Any) -> s.Sedes:
    """Spec SSZ type -> sedes descriptor."""
    if is_bool_type(typ):
        return s.Boolean()
    if is_uint_type(typ):
        return s.UInt(uint_byte_size(typ))
    if is_bytesn_type(typ):
        return s.FixedBytes(typ.length)
    if is_bytes_type(typ):
        return s.RawBytes()
    if is_vector_type(typ):
        return s.FixedList(translate_type(typ.elem_type), typ.length)
    if is_list_type(typ):
        return s.HomogeneousList(translate_type(typ.elem_type))
    if is_container_type(typ):
        return s.Schema([(name, translate_type(ftyp))
                         for name, ftyp in typ.get_fields()])
    raise TypeError(f"untranslatable type: {typ}")


def translate_value(value: Any, typ: Any) -> Any:
    """Sedes-decoded plain value -> spec-typed value (dicts -> containers,
    lists -> typed vectors, ints -> uintN)."""
    if is_bool_type(typ):
        return bool(value)
    if is_uint_type(typ):
        return value if typ is int else typ(value)
    if is_bytesn_type(typ):
        return typ(value)
    if is_bytes_type(typ):
        return bytes(value)
    if is_vector_type(typ):
        return typ([translate_value(v, typ.elem_type) for v in value])
    if is_list_type(typ):
        return [translate_value(v, typ.elem_type) for v in value]
    if is_container_type(typ):
        return typ(**{
            name: translate_value(value[name], ftyp)
            for name, ftyp in typ.get_fields()
        })
    raise TypeError(f"untranslatable type: {typ}")
