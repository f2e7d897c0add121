"""Preset constants from configs/{mainnet,minimal}.yaml.

A small loader for the fields the epoch program and the shuffle need
(the reference's utils/config.py builds whole spec objects; the port
reads the same YAML files and returns plain dicts)."""
from __future__ import annotations

import os
from typing import Any, Dict

import yaml

_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs")


def load_preset(name_or_path: str) -> Dict[str, Any]:
    """Constants of a preset by name ('mainnet'/'minimal') or YAML path,
    plus the derived GENESIS_EPOCH (GENESIS_SLOT // SLOTS_PER_EPOCH)."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_CONFIG_DIR, f"{name_or_path}.yaml")
    with open(path) as f:
        consts = yaml.safe_load(f)
    consts["GENESIS_EPOCH"] = consts["GENESIS_SLOT"] // consts["SLOTS_PER_EPOCH"]
    return consts
