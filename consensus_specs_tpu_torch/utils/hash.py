"""SHA-256 (hashlib), the spec's `hash`, and the zero-subtree table
(own copy of consensus_specs_tpu/utils/hash.py).

`hash_pairs` is the host pair hasher: a plain function over a list of
64-byte blocks. The device batches of the big Merkle levels go through
utils/ssz/bulk.py::hash_pairs_array instead; there is no pluggable
backend."""
from __future__ import annotations

import hashlib
from typing import List

ZERO_BYTES32 = b"\x00" * 32


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def hash_eth2(data: bytes) -> bytes:
    """The spec's `hash` function: SHA-256."""
    return sha256(data)


def hash_pairs(blocks: List[bytes]) -> List[bytes]:
    """Hash many 64-byte blocks (one Merkle level) with hashlib."""
    h = hashlib.sha256
    return [h(b).digest() for b in blocks]


# zerohashes[i] = root of a depth-i tree of zero chunks
_MAX_ZERO_DEPTH = 64
zerohashes: List[bytes] = [ZERO_BYTES32]
for _ in range(_MAX_ZERO_DEPTH):
    zerohashes.append(sha256(zerohashes[-1] + zerohashes[-1]))
