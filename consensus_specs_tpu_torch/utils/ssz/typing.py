"""SSZ type system (2019 / spec-v0.6-era semantics), re-designed for Python 3.12.

Value model matches the reference pyspec so spec code reads naturally:
- uints are `int` subclasses with bounds checks; bare `int` means uint64.
- lists are plain Python lists; the *type* (`List[T]`) carries element info.
- `Vector[T, N]` / `Bytes[N]` are parametrized, cached classes.
- `Container` derives fields from class annotations, zero-defaults missing
  fields, and compares by hash_tree_root.

Capability parity: consensus-specs test_libs/pyspec/eth2spec/utils/ssz/ssz_typing.py
(re-designed: `__class_getitem__` + type cache instead of metaclass __getitem__,
full uint64 class instead of NewType, deserialization support).
Own copy of consensus_specs_tpu/utils/ssz/typing.py. A Container instance
takes attributes beyond its fields (the spec pins memos such as
`state._proposer_memo` on a state); only the declared fields serialize.
"""
from __future__ import annotations

from typing import Any, Dict, List as PyList, Tuple


# ---------------------------------------------------------------------------
# Unsigned integers
# ---------------------------------------------------------------------------

class uint(int):
    byte_len = 0

    def __new__(cls, value: int = 0):
        if cls.byte_len == 0:
            raise TypeError("bare uint is abstract; use uint8..uint256")
        value = int(value)
        if value < 0:
            raise ValueError(f"{cls.__name__} must be non-negative")
        if value.bit_length() > cls.byte_len * 8:
            raise ValueError(f"value out of bounds for {cls.__name__}")
        return super().__new__(cls, value)


class uint8(uint):
    byte_len = 1


class uint16(uint):
    byte_len = 2


class uint32(uint):
    byte_len = 4


class uint64(uint):
    byte_len = 8


class uint128(uint):
    byte_len = 16


class uint256(uint):
    byte_len = 32


byte = uint8

_UINT_BY_SIZE = {1: uint8, 2: uint16, 4: uint32, 8: uint64, 16: uint128, 32: uint256}


def is_uint_type(typ: Any) -> bool:
    return isinstance(typ, type) and issubclass(typ, int) and not issubclass(typ, bool)


def uint_byte_size(typ: Any) -> int:
    if isinstance(typ, type) and issubclass(typ, uint):
        if typ.byte_len == 0:
            raise TypeError("bare uint is abstract; use uint8..uint256")
        return typ.byte_len
    if isinstance(typ, type) and issubclass(typ, int):
        return 8  # bare int defaults to uint64
    raise TypeError(f"not a uint type: {typ}")


def is_bool_type(typ: Any) -> bool:
    return isinstance(typ, type) and issubclass(typ, bool)


# ---------------------------------------------------------------------------
# List[T] — variable-length; values are plain Python lists
# ---------------------------------------------------------------------------

class List:
    """Type-form only: ``List[uint64]`` is a descriptor, values are ``list``."""

    elem_type: Any = None
    _cache: Dict[Any, type] = {}

    def __class_getitem__(cls, elem_type: Any) -> type:
        key = _type_key(elem_type)
        if key not in cls._cache:
            name = f"List[{_type_name(elem_type)}]"
            cls._cache[key] = type(name, (List,), {"elem_type": elem_type})
        return cls._cache[key]


def is_list_type(typ: Any) -> bool:
    return isinstance(typ, type) and issubclass(typ, List) and typ.elem_type is not None


def is_bytes_type(typ: Any) -> bool:
    # variable-length byte string; exclude Bytes[N]
    return typ is bytes


def is_list_kind(typ: Any) -> bool:
    return is_list_type(typ) or is_bytes_type(typ)


# ---------------------------------------------------------------------------
# Vector[T, N]
# ---------------------------------------------------------------------------

class Vector:
    elem_type: Any = None
    length: int = 0
    _cache: Dict[Any, type] = {}

    def __class_getitem__(cls, params: Tuple[Any, int]) -> type:
        if not isinstance(params, tuple) or len(params) != 2:
            raise TypeError("Vector[elem_type, length]")
        elem_type, length = params
        length = int(length)
        key = (_type_key(elem_type), length)
        if key not in cls._cache:
            name = f"Vector[{_type_name(elem_type)},{length}]"
            cls._cache[key] = type(name, (Vector,), {"elem_type": elem_type, "length": length})
        return cls._cache[key]

    def __init__(self, *args: Any):
        cls = self.__class__
        if cls.elem_type is None:
            raise TypeError("cannot instantiate unparametrized Vector")
        explicit_seq = len(args) == 1 and isinstance(args[0], (list, tuple))
        if explicit_seq:
            args = tuple(args[0])
        if len(args) == 0 and not explicit_seq:
            self.items = [get_zero_value(cls.elem_type) for _ in range(cls.length)]
        elif len(args) == cls.length:
            self.items = list(args)
        else:
            raise TypeError(f"{cls.__name__} cannot hold {len(args)} items")

    def __getitem__(self, i):
        return self.items[i]

    def __setitem__(self, i, v):
        self.items[i] = v

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return self.__class__.length

    def __eq__(self, other):
        if isinstance(other, Vector):
            return self.items == other.items
        if isinstance(other, (list, tuple)):
            return self.items == list(other)
        return NotImplemented

    def __repr__(self):
        return f"{self.__class__.__name__}({self.items!r})"

    def copy(self) -> "Vector":
        return self.__class__([copy_value(v) for v in self.items])


def is_vector_type(typ: Any) -> bool:
    return isinstance(typ, type) and issubclass(typ, Vector) and typ.elem_type is not None


# ---------------------------------------------------------------------------
# Bytes[N] — fixed-size byte vectors
# ---------------------------------------------------------------------------

class Bytes(bytes):
    length: int = 0
    _cache: Dict[int, type] = {}

    def __class_getitem__(cls, n: int) -> type:
        n = int(n)
        if n not in cls._cache:
            cls._cache[n] = type(f"Bytes{n}", (Bytes,), {"length": n})
        return cls._cache[n]

    def __new__(cls, value: Any = None):
        if cls.length == 0 and cls is Bytes:
            raise TypeError("cannot instantiate unparametrized Bytes")
        if value is None:
            value = b"\x00" * cls.length
        elif isinstance(value, int):
            value = bytes([value])
        elif isinstance(value, (list, tuple)):
            value = bytes(value)
        if len(value) != cls.length:
            raise TypeError(f"Bytes{cls.length} got {len(value)} bytes")
        return super().__new__(cls, value)


Bytes1 = Bytes[1]
Bytes4 = Bytes[4]
Bytes8 = Bytes[8]
Bytes32 = Bytes[32]
Bytes48 = Bytes[48]
Bytes96 = Bytes[96]


def is_bytesn_type(typ: Any) -> bool:
    return isinstance(typ, type) and issubclass(typ, Bytes) and typ is not Bytes


def is_vector_kind(typ: Any) -> bool:
    return is_vector_type(typ) or is_bytesn_type(typ)


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------

class Container:
    """Fields come from class annotations; missing kwargs get zero values."""

    def __init__(self, **kwargs: Any):
        cls = self.__class__
        for field, typ in cls.get_fields():
            if field in kwargs:
                setattr(self, field, kwargs.pop(field))
            else:
                setattr(self, field, get_zero_value(typ))
        if kwargs:
            raise TypeError(f"unknown fields for {cls.__name__}: {sorted(kwargs)}")

    @classmethod
    def get_fields(cls) -> PyList[Tuple[str, Any]]:
        cached = cls.__dict__.get("_fields_cache")
        if cached is not None:
            return cached
        # walk the MRO so phase-1 containers can append fields via subclassing
        fields: Dict[str, Any] = {}
        for klass in reversed(cls.__mro__):
            for name, typ in getattr(klass, "__annotations__", {}).items():
                if isinstance(typ, str):
                    # PEP 563 stringified annotation: resolve against the
                    # defining module so `from __future__ import annotations`
                    # spec modules still work.
                    import sys
                    typ = eval(typ, vars(sys.modules[klass.__module__]))  # noqa: S307
                fields[name] = typ
        result = list(fields.items())
        cls._fields_cache = result
        return result

    @classmethod
    def get_field_names(cls) -> PyList[str]:
        return [f for f, _ in cls.get_fields()]

    @classmethod
    def get_field_types(cls) -> PyList[Any]:
        return [t for _, t in cls.get_fields()]

    def get_field_values(self) -> PyList[Any]:
        return [getattr(self, f) for f in self.get_field_names()]

    def get_typed_values(self) -> PyList[Tuple[Any, Any]]:
        return list(zip(self.get_field_values(), self.get_field_types()))

    def serialize(self) -> bytes:
        from .impl import serialize
        return serialize(self, self.__class__)

    def hash_tree_root(self) -> bytes:
        from .impl import hash_tree_root
        return hash_tree_root(self, self.__class__)

    def signing_root(self) -> bytes:
        from .impl import signing_root
        return signing_root(self, self.__class__)

    def copy(self) -> "Container":
        return self.__class__(**{f: copy_value(getattr(self, f)) for f in self.get_field_names()})

    def __eq__(self, other):
        if not isinstance(other, Container):
            return NotImplemented
        return self.hash_tree_root() == other.hash_tree_root()

    def __hash__(self):
        return hash(self.hash_tree_root())

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)!r}" for f in self.get_field_names())
        return f"{self.__class__.__name__}({inner})"


def is_container_type(typ: Any) -> bool:
    return isinstance(typ, type) and issubclass(typ, Container)


# ---------------------------------------------------------------------------
# Zero values, copying, inference
# ---------------------------------------------------------------------------

def get_zero_value(typ: Any) -> Any:
    if is_bool_type(typ):
        return False
    if is_uint_type(typ):
        return typ(0) if issubclass(typ, uint) else 0
    if is_list_type(typ):
        return []
    if is_bytes_type(typ):
        return b""
    if is_bytesn_type(typ):
        return typ()
    if is_vector_type(typ):
        return typ()
    if is_container_type(typ):
        return typ()
    raise TypeError(f"no zero value for {typ}")


def copy_value(v: Any) -> Any:
    if isinstance(v, (Container, Vector)):
        return v.copy()
    if isinstance(v, list):
        return [copy_value(x) for x in v]
    return v  # ints, bytes: immutable


def infer_type(obj: Any) -> Any:
    if isinstance(obj, bool):
        return bool
    if isinstance(obj, uint):
        return obj.__class__
    if isinstance(obj, int):
        return uint64
    if isinstance(obj, (Container, Vector, Bytes)):
        return obj.__class__
    if isinstance(obj, bytes):
        return bytes
    if isinstance(obj, list):
        if len(obj) == 0:
            raise TypeError("cannot infer element type of empty list; pass typ=")
        return List[infer_type(obj[0])]
    raise TypeError(f"cannot infer SSZ type of {obj!r}")


def read_elem_type(typ: Any) -> Any:
    if typ is bytes or is_bytesn_type(typ):
        return byte
    if is_list_type(typ) or is_vector_type(typ):
        return typ.elem_type
    raise TypeError(f"not a series type: {typ}")


def _type_key(typ: Any) -> Any:
    return typ


def _type_name(typ: Any) -> str:
    return getattr(typ, "__name__", str(typ))
