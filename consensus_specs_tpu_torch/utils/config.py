"""Constant presets: immutable config objects loaded from configs/*.yaml
(own copy of consensus_specs_tpu/utils/config.py).

A preset is a frozen mapping; spec objects (types whose Vector lengths
depend on constants, and the functions that close over them) are built per
preset by the spec factory (models/phase0/spec.py) and cached, so two
presets coexist as two spec objects instead of mutated module globals.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import yaml

_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs")


class Preset:
    """Frozen namespace of protocol constants. `cfg.SLOTS_PER_EPOCH` etc."""

    def __init__(self, name: str, constants: Dict[str, Any]):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_constants", dict(constants))
        for k, v in constants.items():
            object.__setattr__(self, k, v)

    def __setattr__(self, key: str, value: Any):
        raise AttributeError("Preset is immutable")

    def __getitem__(self, key: str) -> Any:
        return self._constants[key]

    def __contains__(self, key: str) -> bool:
        return key in self._constants

    def keys(self):
        return self._constants.keys()

    def items(self):
        return self._constants.items()

    def __repr__(self):
        return f"Preset({self.name!r}, {len(self._constants)} constants)"


def _parse_value(key: str, value: Any) -> Any:
    if isinstance(value, str) and value.startswith("0x"):
        return bytes.fromhex(value[2:])
    return value


def load_preset_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        raw = yaml.safe_load(f)
    return {k: _parse_value(k, v) for k, v in raw.items()}


_preset_cache: Dict[str, Preset] = {}


def load_preset(name_or_path: str) -> Preset:
    """Load a preset by name ('mainnet'/'minimal') or explicit YAML path."""
    if name_or_path in _preset_cache:
        return _preset_cache[name_or_path]
    path = name_or_path
    name = os.path.splitext(os.path.basename(path))[0]
    if not os.path.exists(path):
        path = os.path.join(_CONFIG_DIR, f"{name_or_path}.yaml")
        name = name_or_path
    preset = Preset(name, load_preset_file(path))
    _preset_cache[name_or_path] = preset
    return preset


_timeline_cache: Dict[str, Dict[str, int]] = {}


def load_fork_timeline(name_or_path: str = "mainnet") -> Dict[str, int]:
    """Fork-scheduling axis of the config system: fork name -> activation
    epoch, loaded from configs/fork_timelines/ (by name, or an explicit
    YAML path). Every call returns a fresh copy of the cached mapping."""
    if name_or_path not in _timeline_cache:
        path = name_or_path
        if not os.path.exists(path):
            path = os.path.join(_CONFIG_DIR, "fork_timelines",
                                f"{name_or_path}.yaml")
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        timeline = {str(k): int(v) for k, v in raw.items()}
        assert "phase0" in timeline, "a fork timeline must schedule phase0"
        _timeline_cache[name_or_path] = timeline
    return dict(_timeline_cache[name_or_path])


def fork_at_epoch(timeline: Dict[str, int], epoch: int) -> str:
    """The latest fork whose activation epoch is <= `epoch`."""
    live = [(e, name) for name, e in timeline.items() if e <= epoch]
    assert live, f"epoch {epoch} precedes every scheduled fork"
    return max(live)[1]


def mainnet() -> Preset:
    return load_preset("mainnet")


def minimal() -> Preset:
    return load_preset("minimal")
