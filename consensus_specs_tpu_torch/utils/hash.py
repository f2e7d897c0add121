"""SHA-256 (hashlib) and the zero-subtree table.

Own copy of consensus_specs_tpu/utils/hash.py's constants: zerohashes[i]
is the root of a depth-i tree of zero chunks."""
from __future__ import annotations

import hashlib
from typing import List

ZERO_BYTES32 = b"\x00" * 32


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


_MAX_ZERO_DEPTH = 64
zerohashes: List[bytes] = [ZERO_BYTES32]
for _ in range(_MAX_ZERO_DEPTH):
    zerohashes.append(sha256(zerohashes[-1] + zerohashes[-1]))
