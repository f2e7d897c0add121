"""Phase1Spec: phase 0 + custody game + shard chains for one preset.

The reference merges three spec docs into one compiled module — later
phases win name clashes, SSZ containers append fields, `# @label` markers
splice epoch/block code (consensus-specs scripts/build_spec.py:189-219).
Phase1Spec realizes the same merge by subclassing Phase0Spec: appended
containers subclass phase-0 containers, epoch inserts go through the
phase-0 hook lists, and the five custody operation families register on
the process_operations extension hook (ordered after all phase-0 ops,
1_custody-game.md:330).

Port of consensus_specs_tpu/models/phase1/spec.py. The spec names its
device and pair hash as Phase0Spec does ("cuda" by default, raising
without a card; `pair_fn=None` is the kernel); custody and shard
signatures go through `spec.bls`.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

from ...device import resolve
from ...ops.sha256 import PairFn
from ...utils.config import Preset, load_preset
from ..phase0.spec import Phase0Spec
from . import constants as c1
from . import containers as containers1
from . import custody as custody_mod
from . import shard as shard_mod


class Phase1Spec(Phase0Spec):
    """Executable phase-1 spec for a single constant preset."""

    phase = "phase1"

    def __init__(self, preset: Preset, device="cuda",
                 pair_fn: Optional[PairFn] = None):
        super().__init__(preset, device, pair_fn)

        # Phase-1 constants (global in the 2019 spec; minimal preset shrinks
        # the long custody windows so tests can cross period boundaries)
        for key, value in {**c1.CUSTODY_CONSTANTS, **c1.SHARD_CONSTANTS}.items():
            setattr(self, key, value)
        if preset.name == "minimal":
            for key, value in c1.MINIMAL_OVERRIDES.items():
                setattr(self, key, value)

        # Containers: new custody/shard types + field-appended phase-0 types
        # (extending the classes Phase0Spec already built — one identity per
        # type per spec, so isinstance stays coherent across phases)
        phase1_types = containers1.build_types(self, self.container_types)
        self.container_types.update(phase1_types)
        for name, typ in phase1_types.items():
            setattr(self, name, typ)

        # Custody + shard functions as bound methods
        self._bind_module(custody_mod)
        self._bind_module(shard_mod)

        # Epoch inserts (@process_reveal_deadlines /
        # @process_challenge_deadlines / @after_process_final_updates)
        self._insert_after_registry_updates = [
            self.process_reveal_deadlines,
            self.process_challenge_deadlines,
        ]
        self._insert_after_final_updates = [self.after_process_final_updates]

        # Operation families appended after all phase-0 ops, spec order
        self._extra_block_operations = [
            ("custody_key_reveals", self.MAX_CUSTODY_KEY_REVEALS,
             self.process_custody_key_reveal),
            ("early_derived_secret_reveals", self.MAX_EARLY_DERIVED_SECRET_REVEALS,
             self.process_early_derived_secret_reveal),
            ("custody_chunk_challenges", self.MAX_CUSTODY_CHUNK_CHALLENGES,
             self.process_chunk_challenge),
            ("custody_bit_challenges", self.MAX_CUSTODY_BIT_CHALLENGES,
             self.process_bit_challenge),
            ("custody_responses", self.MAX_CUSTODY_RESPONSES,
             self.process_custody_response),
        ]

    def __repr__(self):
        return f"Phase1Spec(preset={self.name!r}, device={str(self.device)!r})"


_spec_cache: Dict[tuple, Phase1Spec] = {}


def get_spec(preset: Union[str, Preset] = "minimal", device="cuda") -> Phase1Spec:
    """Build (and cache per preset and device) the phase-1 spec for a
    preset name or Preset object."""
    if isinstance(preset, Preset):
        return Phase1Spec(preset, device)
    key = (preset, str(resolve(device)))
    if key not in _spec_cache:
        _spec_cache[key] = Phase1Spec(load_preset(preset), device)
    return _spec_cache[key]
