"""Randomized SSZ object factory — fuel for ssz_static vectors and fuzzing.

Capability parity with the reference's random_value module
(consensus-specs test_libs/pyspec/eth2spec/debug/random_value.py:20-121):
six randomization modes over the full SSZ type algebra (uintN, bool, bytes,
Bytes[N], List[T], Vector[T, N], Container), with switches for chaos (type-
invalid magnitudes) and max-list-length padding. Expressed over this
framework's own type predicates (utils/ssz/typing.py) rather than the
reference's typing_inspect machinery.
"""
from __future__ import annotations

from enum import Enum
from random import Random
from typing import Any

from ..utils.ssz.typing import (
    is_bool_type, is_bytes_type, is_bytesn_type, is_container_type,
    is_list_type, is_uint_type, is_vector_type, uint_byte_size)

# variable-length collections get lengths in this band unless told otherwise
DEFAULT_MAX_LIST_LEN = 10
LENGTHY_MIN = 50
LENGTHY_MAX = 100


class RandomizationMode(Enum):
    RANDOM = 0     # uniform values, random list lengths
    ZERO = 1       # canonical zero value everywhere
    MAX = 2        # all-ones / max values
    NIL = 3        # empty lists, zero scalars
    ONE = 4        # single-element lists, small scalars
    LENGTHY = 5    # long lists (50-100 elements)

    def is_changing(self) -> bool:
        return self in (RandomizationMode.RANDOM, RandomizationMode.LENGTHY)


def get_random_ssz_object(rng: Random, typ: Any,
                          mode: RandomizationMode = RandomizationMode.RANDOM,
                          chaos: bool = False,
                          max_list_length: int = DEFAULT_MAX_LIST_LEN) -> Any:
    """Build an instance of `typ` according to `mode`.

    chaos=True occasionally ignores the mode (picking a random one per node)
    and lets uints exceed/violate nothing structurally — structure stays
    type-valid so serializers can round-trip, matching the reference's use
    (its chaos flag also only perturbs mode selection per node).
    """
    if chaos:
        mode = rng.choice(list(RandomizationMode))

    if is_bool_type(typ):
        if mode == RandomizationMode.ZERO or mode == RandomizationMode.NIL:
            return False
        if mode == RandomizationMode.MAX:
            return True
        if mode == RandomizationMode.ONE:
            return True
        return rng.random() < 0.5

    if is_uint_type(typ):
        size = uint_byte_size(typ)
        if mode == RandomizationMode.ZERO or mode == RandomizationMode.NIL:
            return typ(0) if isinstance(typ, type) else 0
        if mode == RandomizationMode.MAX:
            return typ((1 << (size * 8)) - 1)
        if mode == RandomizationMode.ONE:
            return typ(1)
        return typ(rng.randrange(1 << (size * 8)))

    if is_bytesn_type(typ):
        n = typ.length
        return typ(_random_bytes(rng, n, mode))

    if is_bytes_type(typ):
        n = _collection_length(rng, mode, max_list_length)
        return _random_bytes(rng, n, mode)

    if is_vector_type(typ):
        return typ([
            get_random_ssz_object(rng, typ.elem_type, mode, chaos, max_list_length)
            for _ in range(typ.length)
        ])

    if is_list_type(typ):
        n = _collection_length(rng, mode, max_list_length)
        return [
            get_random_ssz_object(rng, typ.elem_type, mode, chaos, max_list_length)
            for _ in range(n)
        ]

    if is_container_type(typ):
        return typ(**{
            field: get_random_ssz_object(rng, ftyp, mode, chaos, max_list_length)
            for field, ftyp in typ.get_fields()
        })

    raise TypeError(f"cannot randomize type: {typ}")


def _collection_length(rng: Random, mode: RandomizationMode, max_len: int) -> int:
    if mode == RandomizationMode.ZERO or mode == RandomizationMode.NIL:
        return 0   # ZERO means the canonical zero value: empty collections
    if mode == RandomizationMode.ONE:
        return 1
    if mode == RandomizationMode.LENGTHY:
        return rng.randrange(LENGTHY_MIN, LENGTHY_MAX + 1)
    if mode == RandomizationMode.MAX:
        return max_len
    return rng.randrange(max_len + 1)


def _random_bytes(rng: Random, n: int, mode: RandomizationMode) -> bytes:
    if mode == RandomizationMode.ZERO or mode == RandomizationMode.NIL:
        return b"\x00" * n
    if mode == RandomizationMode.MAX:
        return b"\xff" * n
    if mode == RandomizationMode.ONE:
        return b"\x01" * n
    return bytes(rng.randrange(256) for _ in range(n))


def get_mode_by_name(name: str) -> RandomizationMode:
    return {
        "random": RandomizationMode.RANDOM,
        "zero": RandomizationMode.ZERO,
        "max": RandomizationMode.MAX,
        "nil": RandomizationMode.NIL,
        "one": RandomizationMode.ONE,
        "lengthy": RandomizationMode.LENGTHY,
    }[name]
