"""Suite model, YAML rendering, and the generator CLI driver.

Format contract: consensus-specs specs/test_formats/README.md:104-130 (the
suite header) and :172-188 (the `<runner>/<handler>/<suite>.yaml` layout).
The reference's driver is gen_base/gen_runner.py:49-115; this one adds
--preset and --runner filters and writes all suites in-process (the
reference shells out per generator with a venv each). Port of
consensus_specs_tpu/generators/base.py: `--device` names the device the
specs run on (default the card), and `--accel` installs the bulk state root
on that device for the run, the argument that replaces the JAX package's
accelerated-test environment switch.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence

import yaml

from ..device import resolve
from ..models.phase0.helpers import install_bulk_state_root, set_state_root_backend


@dataclass
class Suite:
    title: str
    summary: str
    config: str                      # preset name the cases ran under
    runner: str                      # directory level 1
    handler: str                     # directory level 2
    test_cases: List[Dict[str, Any]]
    forks_timeline: str = "testing"
    forks: List[str] = field(default_factory=lambda: ["phase0"])

    @property
    def filename(self) -> str:
        return f"{self.handler}_{self.config}.yaml"

    def as_document(self) -> Dict[str, Any]:
        return {
            "title": self.title,
            "summary": self.summary,
            "forks_timeline": self.forks_timeline,
            "forks": list(self.forks),
            "config": self.config,
            "runner": self.runner,
            "handler": self.handler,
            "test_cases": self.test_cases,
        }


# yaml.safe_dump's documents through libyaml's emitter where PyYAML was
# built with it: the same bytes (tests/test_torch_generators.py holds every
# family's file to the JAX package's), several times faster on the
# 100 MB mainnet ssz_static suites.
_SAFE_DUMPER = getattr(yaml, "CSafeDumper", yaml.SafeDumper)

SuiteCreator = Callable[..., Suite]   # (preset name, device=) -> Suite


def write_suite(out_root: str, suite: Suite) -> str:
    path = os.path.join(out_root, "tests", suite.runner, suite.handler)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, suite.filename)
    with open(target, "w") as fh:
        yaml.dump(suite.as_document(), fh, Dumper=_SAFE_DUMPER, default_flow_style=None,
                  sort_keys=False, width=10 ** 9)
    return target


def run_generator(name: str, creators: Sequence[SuiteCreator],
                  argv: Sequence[str] = None) -> List[str]:
    """CLI driver: `-o <dir>` required, `-p <preset>` repeatable (default
    both), `--dry` lists suites without writing, `--device` (default cuda;
    raises without a card) and `--accel` (the bulk state root on that
    device for the run)."""
    parser = argparse.ArgumentParser(prog=f"gen-{name}")
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-p", "--preset", action="append",
                        default=None, help="preset(s) to emit (default: minimal+mainnet)")
    parser.add_argument("--dry", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="device the specs run on (default: cuda)")
    parser.add_argument("--accel", action="store_true",
                        help="root states with the bulk state root on --device")
    args = parser.parse_args(argv)
    presets = args.preset or ["minimal", "mainnet"]
    device = resolve(args.device)

    if args.accel:
        install_bulk_state_root(device=device)
    try:
        written = []
        for preset in presets:
            for creator in creators:
                t0 = time.time()
                suite = creator(preset, device=device)
                if suite is None or not suite.test_cases:
                    continue
                if args.dry:
                    print(f"[{name}] would write {suite.runner}/{suite.handler}/"
                          f"{suite.filename} ({len(suite.test_cases)} cases)")
                    continue
                target = write_suite(args.output_dir, suite)
                written.append(target)
                print(f"[{name}] {target}: {len(suite.test_cases)} cases "
                      f"({time.time() - t0:.1f}s)", file=sys.stderr)
        return written
    finally:
        if args.accel:
            set_state_root_backend(None)
