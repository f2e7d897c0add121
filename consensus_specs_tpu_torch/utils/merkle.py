"""Tree-shape helpers (own copy of consensus_specs_tpu/utils/merkle.py's)."""
from __future__ import annotations


def next_power_of_two(v: int) -> int:
    if v <= 0:
        return 1
    return 1 << (v - 1).bit_length()


def tree_depth(count: int) -> int:
    """Levels of the power-of-two-padded tree over `count` chunks (SSZ
    merkleize padding): 0 and 1 chunks need no hashing, everything else
    pads up to next_power_of_two."""
    return (next_power_of_two(count) - 1).bit_length()
