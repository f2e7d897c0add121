"""Validator-axis sharding (port of consensus_specs_tpu/parallel/): the
serving mesh, the placement helpers and the cross-shard exchange.

`exchange.py` holds the Sharded / Replicated value types and the one
helper every cross-shard value goes through; `sharding.py` the mesh and
its programs. The sharding names load on first use (the epoch program
and the forests import `exchange` while sharding.py imports them).
"""
from .exchange import Replicated, ShardExchange, Sharded  # noqa: F401

_SHARDING_NAMES = (
    "ServingMesh", "hierarchical_mesh", "pad_leading_pow2", "pow2_pad_rows",
    "shard_epoch_state", "shard_hierarchical", "shard_leading_axis",
    "trees_bitwise_equal", "validator_mesh", "visible_devices")


def __getattr__(name):
    if name in _SHARDING_NAMES:
        from . import sharding
        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Replicated", "ShardExchange", "Sharded", *_SHARDING_NAMES]
