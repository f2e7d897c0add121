"""Bridge: scenario tables -> suite test_cases.

The reference reflects over `test_*` functions per module
(gen_from_tests/gen.py:3-26); here the tables are data already, so the
bridge simply runs each synthesized entry under generator_mode=True with
BLS on (vectors must carry real signatures unless a row forces otherwise)
and collects the emitted artifact dicts. Port of
consensus_specs_tpu/generators/from_tables.py: the tables are the port's
own (`TABLE_ROOT`), and each row's spec runs on `device`.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional


def cases_from_table(module_name: str, preset: str, phase: str = "phase0",
                     bls_default: bool = True,
                     device="cuda") -> List[Dict[str, Any]]:
    mod = importlib.import_module(module_name)
    out: List[Dict[str, Any]] = []
    for name in sorted(vars(mod)):
        if not name.startswith("test_"):
            continue
        fn = getattr(mod, name)
        if not callable(fn):
            continue
        artifact: Optional[Dict[str, Any]] = fn(
            generator_mode=True, phase=phase, preset=preset,
            bls_active=bls_default, device=device)
        if artifact is not None:
            out.append(artifact)
    return out


TABLE_ROOT = "consensus_specs_tpu_torch.testing.cases"


def table(name: str) -> str:
    return f"{TABLE_ROOT}.{name}"
