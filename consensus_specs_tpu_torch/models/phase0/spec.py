"""Phase0Spec: one object per preset bundling constants, types, functions
and the device (port of consensus_specs_tpu/models/phase0/spec.py).

Constants are attributes, SSZ classes are attributes, and every spec
function from helpers/epoch/block/genesis/validator is bound as a method. The spec
also names the device its batched work runs on: the committee shuffle
from 2^13 indices up, the large hash batches of utils/ssz/bulk.py, and
the resident core built on it. "cuda" is the default and raises without
a card; the tests pass device="cpu". `pair_fn` replaces the pair hash of
that device route (the checks pass the plain twin); None is the kernel.
"""
from __future__ import annotations

import inspect
from types import MethodType, ModuleType
from typing import Dict, Optional, Union

from ...crypto import bls
from ...device import resolve
from ...ops.sha256 import PairFn
from ...utils.config import Preset, load_preset
from . import block as block_mod
from . import containers
from . import epoch as epoch_mod
from . import genesis as genesis_mod
from . import helpers as helpers_mod
from . import validator as validator_mod

_FUNCTION_MODULES = (helpers_mod, epoch_mod, block_mod, genesis_mod, validator_mod)


class Phase0Spec:
    """Executable phase-0 spec for a single constant preset."""

    def __init__(self, preset: Preset, device="cuda",
                 pair_fn: Optional[PairFn] = None):
        self.config = preset
        self.name = preset.name
        self.device = resolve(device)
        self.pair_fn = pair_fn

        # Constants (preset values + derived/initial values)
        for key, value in preset.items():
            setattr(self, key, value)
        self.GENESIS_EPOCH = self.GENESIS_SLOT // self.SLOTS_PER_EPOCH
        self.ZERO_HASH = b"\x00" * 32

        # Crypto boundary: the module, so the global bls_active switch and
        # backend selection apply to all spec objects at once.
        self.bls = bls

        # SSZ container types specialized to this preset's shapes
        self.container_types: Dict[str, type] = containers.build_types(self)
        for type_name, typ in self.container_types.items():
            setattr(self, type_name, typ)

        # Spec functions -> bound methods
        for mod in _FUNCTION_MODULES:
            self._bind_module(mod)

        # Insert hooks and appended operation families of later phases
        # (empty in phase 0; process_epoch / process_operations read them)
        self._insert_after_registry_updates = []
        self._insert_after_final_updates = []
        self._extra_block_operations = []   # (body_attr, max_count, handler)

        # Deferred-verification sink: when process_operations batches a
        # block's attestation signature checks, validate_indexed_attestation
        # appends (pubkey_sets, message_hashes, signature, domain) here
        # instead of verifying inline (block.process_attestations_batched)
        self._att_verify_sink = None

        # Streaming firehose hook: a streaming.StreamingVerifier installed
        # here serves the sink's verdicts from its cross-slot queue and
        # verdict cache instead of a per-block verify_indexed_batch
        # (block.process_attestations_batched)
        self._streaming_verifier = None

        # Caches
        self._hash_cache: Dict[bytes, bytes] = {}
        self._perm_cache: Dict = {}

    def _bind_module(self, mod: ModuleType) -> None:
        for fn_name, fn in vars(mod).items():
            if fn_name.startswith("_") or not inspect.isfunction(fn):
                continue
            if getattr(fn, "__module__", None) != mod.__name__:
                continue  # skip imports like np helpers
            params = list(inspect.signature(fn).parameters)
            if params and params[0] == "spec":
                setattr(self, fn_name, MethodType(fn, self))

    def clear_caches(self) -> None:
        self._hash_cache.clear()
        self._perm_cache.clear()

    def __repr__(self):
        return f"Phase0Spec(preset={self.name!r}, device={str(self.device)!r})"


_spec_cache: Dict[tuple, Phase0Spec] = {}


def get_spec(preset: Union[str, Preset] = "minimal", device="cuda") -> Phase0Spec:
    """Build (and cache per preset and device) the phase-0 spec for a
    preset name or Preset object."""
    if isinstance(preset, Preset):
        return Phase0Spec(preset, device)
    key = (preset, str(resolve(device)))
    if key not in _spec_cache:
        _spec_cache[key] = Phase0Spec(load_preset(preset), device)
    return _spec_cache[key]
