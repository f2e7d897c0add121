"""Wire message envelope (copy of consensus_specs_tpu/networking/messaging.py;
host code, no device work).

Contract: the networking spec's messaging.md:21-45 — a message is
(compression nibble, encoding nibble, uint64 body length, body). The two
nibbles pack into one byte (compression high, encoding low); the length is
little-endian per SSZ numeric convention. "Clients MUST ignore messages
with malformed bodies" — decode therefore reports malformation via a typed
error the caller can drop, never by crashing.

Also provides the raw-TCP `ETH` prefix for non-libp2p transports
(rpc-interface.md:87-89).
"""
from __future__ import annotations

from typing import Tuple

COMPRESSION_NONE = 0x0
ENCODING_SSZ = 0x1

TCP_PREFIX = b"ETH"          # 0x455448, raw-TCP disambiguation prefix

_HEADER_LEN = 1 + 8          # packed nibbles + uint64 length


class MessageEnvelopeError(ValueError):
    """Malformed envelope — the spec says to ignore such messages."""


def encode_message(body: bytes, compression: int = COMPRESSION_NONE,
                   encoding: int = ENCODING_SSZ) -> bytes:
    if not 0 <= compression <= 0xF or not 0 <= encoding <= 0xF:
        raise ValueError("nibble out of range")
    header = bytes([(compression << 4) | encoding])
    return header + len(body).to_bytes(8, "little") + bytes(body)


def decode_message(data: bytes) -> Tuple[int, int, bytes]:
    """-> (compression, encoding, body). Raises MessageEnvelopeError on any
    malformation (short header, unknown nibble, length mismatch)."""
    if len(data) < _HEADER_LEN:
        raise MessageEnvelopeError("short envelope")
    compression = data[0] >> 4
    encoding = data[0] & 0xF
    if compression != COMPRESSION_NONE:
        raise MessageEnvelopeError(f"unknown compression nibble {compression}")
    if encoding != ENCODING_SSZ:
        raise MessageEnvelopeError(f"unknown encoding nibble {encoding}")
    length = int.from_bytes(data[1:9], "little")
    body = data[_HEADER_LEN:]
    if len(body) != length:
        raise MessageEnvelopeError(
            f"length field {length} != body length {len(body)}")
    return compression, encoding, body


def frame_tcp(message: bytes) -> bytes:
    """Prefix for raw-TCP transports (pre-libp2p interop)."""
    return TCP_PREFIX + message


def unframe_tcp(data: bytes) -> bytes:
    if not data.startswith(TCP_PREFIX):
        raise MessageEnvelopeError("missing ETH prefix")
    return data[len(TCP_PREFIX):]
