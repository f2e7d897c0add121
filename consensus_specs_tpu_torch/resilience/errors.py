"""Typed errors of the resident core (port of the part of
consensus_specs_tpu/resilience/errors.py that ResidentCore raises), so a
caller branches on type, never on message text. Imports nothing of the
package.
"""
from __future__ import annotations


class CheckpointCorrupt(Exception):
    """A checkpoint payload failed validation: state bytes that do not
    parse as a serialized BeaconState (`ResidentCore.from_checkpoint`'s
    up-front validation)."""
