"""A second SSZ codec: sedes descriptors with their own decode loop.

Deliberately independent of utils/ssz/impl.py — different object model
(descriptor instances, not type dispatch), different traversal (explicit
work-stack offset resolution instead of recursion through type
predicates). Differential tests feed both codecs the same bytes; any
divergence is a bug in one of them. Wire rules per
consensus-specs specs/simple-serialize.md:79-133.
"""
from __future__ import annotations

from typing import Any, List, Tuple

OFFSET_WIDTH = 4


class Sedes:
    fixed_size: Any = None   # int byte length, or None = variable

    def encode(self, value) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes):
        raise NotImplementedError


class UInt(Sedes):
    def __init__(self, byte_length: int):
        self.fixed_size = byte_length

    def encode(self, value) -> bytes:
        return int(value).to_bytes(self.fixed_size, "little")

    def decode(self, data: bytes) -> int:
        if len(data) != self.fixed_size:
            raise ValueError("uint length mismatch")
        return int.from_bytes(data, "little")


class Boolean(Sedes):
    fixed_size = 1

    def encode(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def decode(self, data: bytes) -> bool:
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise ValueError("invalid boolean byte")


class RawBytes(Sedes):
    """Variable-length byte string."""

    def encode(self, value) -> bytes:
        return bytes(value)

    def decode(self, data: bytes) -> bytes:
        return bytes(data)


class FixedBytes(Sedes):
    def __init__(self, length: int):
        self.fixed_size = length

    def encode(self, value) -> bytes:
        value = bytes(value)
        if len(value) != self.fixed_size:
            raise ValueError("fixed-bytes length mismatch")
        return value

    def decode(self, data: bytes) -> bytes:
        if len(data) != self.fixed_size:
            raise ValueError("fixed-bytes length mismatch")
        return bytes(data)


def _split_series(data: bytes, members: List[Sedes]) -> List[bytes]:
    """Slice a serialized series into per-member byte windows using the
    offset table interleaved in the fixed region."""
    windows: List[Tuple[int, Any]] = []   # (member position, slice-or-offset)
    cursor = 0
    variable_positions = []
    for k, sedes in enumerate(members):
        if sedes.fixed_size is not None:
            windows.append((k, data[cursor:cursor + sedes.fixed_size]))
            if cursor + sedes.fixed_size > len(data):
                raise ValueError("series truncated")
            cursor += sedes.fixed_size
        else:
            raw = data[cursor:cursor + OFFSET_WIDTH]
            if len(raw) != OFFSET_WIDTH:
                raise ValueError("offset truncated")
            windows.append((k, int.from_bytes(raw, "little")))
            variable_positions.append(len(windows) - 1)
            cursor += OFFSET_WIDTH
    if variable_positions:
        first = windows[variable_positions[0]][1]
        if first != cursor:
            raise ValueError("first offset does not close the fixed region")
    elif cursor != len(data):
        raise ValueError("trailing bytes after fixed series")
    bounds = [windows[p][1] for p in variable_positions] + [len(data)]
    for a, b in zip(bounds, bounds[1:]):
        if a > b or b > len(data):
            raise ValueError("offsets not monotonic")
    for slot, (a, b) in zip(variable_positions, zip(bounds, bounds[1:])):
        k, _ = windows[slot]
        windows[slot] = (k, data[a:b])
    return [w for _, w in windows]


class HomogeneousList(Sedes):
    def __init__(self, element: Sedes):
        self.element = element

    def encode(self, value) -> bytes:
        encoded = [self.element.encode(v) for v in value]
        if self.element.fixed_size is not None:
            return b"".join(encoded)
        head = b""
        pos = OFFSET_WIDTH * len(encoded)
        for piece in encoded:
            head += pos.to_bytes(OFFSET_WIDTH, "little")
            pos += len(piece)
        return head + b"".join(encoded)

    def decode(self, data: bytes) -> list:
        if self.element.fixed_size is not None:
            size = self.element.fixed_size
            if size == 0 or len(data) % size:
                raise ValueError("list not a multiple of element size")
            return [self.element.decode(data[i:i + size])
                    for i in range(0, len(data), size)]
        if not data:
            return []
        first = int.from_bytes(data[:OFFSET_WIDTH], "little")
        if first > len(data):
            # bound BEFORE deriving count: a 4-byte hostile offset would
            # otherwise size a ~2^30-entry member list pre-validation
            raise ValueError("first offset beyond input")
        if first % OFFSET_WIDTH:
            raise ValueError("misaligned offset table")
        count = first // OFFSET_WIDTH
        members = [self.element] * count
        return [self.element.decode(w) for w in _split_series(data, members)]


class FixedList(HomogeneousList):
    def __init__(self, element: Sedes, length: int):
        super().__init__(element)
        self.length = length
        if element.fixed_size is not None:
            self.fixed_size = element.fixed_size * length

    def encode(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError("vector length mismatch")
        return super().encode(value)

    def decode(self, data: bytes) -> list:
        out = super().decode(data)
        if len(out) != self.length:
            raise ValueError("vector length mismatch")
        return out


class Schema(Sedes):
    """A named-field series (container)."""

    def __init__(self, fields: List[Tuple[str, Sedes]]):
        self.fields = fields
        if all(s.fixed_size is not None for _, s in fields):
            self.fixed_size = sum(s.fixed_size for _, s in fields)

    def encode(self, value: dict) -> bytes:
        head, tail = b"", b""
        fixed_len = sum(
            s.fixed_size if s.fixed_size is not None else OFFSET_WIDTH
            for _, s in self.fields)
        pos = fixed_len
        for name, sedes in self.fields:
            piece = sedes.encode(value[name])
            if sedes.fixed_size is not None:
                head += piece
            else:
                head += pos.to_bytes(OFFSET_WIDTH, "little")
                tail += piece
                pos += len(piece)
        return head + tail

    def decode(self, data: bytes) -> dict:
        windows = _split_series(data, [s for _, s in self.fields])
        return {name: sedes.decode(window)
                for (name, sedes), window in zip(self.fields, windows)}
