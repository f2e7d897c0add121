"""Merkle tree utilities (own copy of consensus_specs_tpu/utils/merkle.py).

`merkleize_chunks` pads the chunk count to the next power of two with zero
chunks and reduces pairwise, one `hash_pairs` call per level.
"""
from __future__ import annotations

from typing import Sequence

from .hash import ZERO_BYTES32, hash_pairs, sha256, zerohashes


def next_power_of_two(v: int) -> int:
    if v <= 0:
        return 1
    return 1 << (v - 1).bit_length()


def tree_depth(count: int) -> int:
    """Levels of the power-of-two-padded tree over `count` chunks (SSZ
    merkleize padding): 0 and 1 chunks need no hashing, everything else
    pads up to next_power_of_two. The incremental forest's append-grow
    deepens by exactly the levels this adds."""
    return (next_power_of_two(count) - 1).bit_length()


def merkleize_chunks(chunks: Sequence[bytes]) -> bytes:
    """Root of the power-of-two-padded binary tree over 32-byte chunks."""
    count = len(chunks)
    if count == 0:
        return ZERO_BYTES32
    depth_needed = tree_depth(count)
    level = list(chunks)
    depth = 0
    while len(level) > 1 or depth < depth_needed:
        if len(level) % 2 == 1:
            level.append(zerohashes[depth])
        level = hash_pairs([level[i] + level[i + 1] for i in range(0, len(level), 2)])
        depth += 1
    return level[0]


def verify_merkle_branch(leaf: bytes, proof: Sequence[bytes], depth: int, index: int, root: bytes) -> bool:
    """Check a Merkle branch against a root (spec: verify_merkle_branch)."""
    value = leaf
    for i in range(depth):
        if index // (2 ** i) % 2:
            value = sha256(proof[i] + value)
        else:
            value = sha256(value + proof[i])
    return value == root
