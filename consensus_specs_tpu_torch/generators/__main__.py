"""CLI: emit conformance-vector YAML suites.

    python -m consensus_specs_tpu_torch.generators -o <outdir> [-p minimal]
        [--family operations] [--device cuda|cpu] [--accel]

Equivalent of the reference's `make gen_yaml_tests` (Makefile:43,87-104),
in one process. Families: operations, epoch_processing, sanity, shuffling,
bls, ssz_static, ssz_generic. The specs run on `--device` (the card unless
the caller says `cpu`); `--accel` roots the states with the bulk state root
on that device for the run (base.run_generator).
"""
from __future__ import annotations

import sys

from .base import run_generator
from . import suites


FAMILIES = {
    "operations": suites.operations_creators,
    "epoch_processing": suites.epoch_processing_creators,
    "sanity": suites.sanity_creators,
    "shuffling": lambda: [suites.shuffling_suite],
    "bls": suites.bls_creators,
    "ssz_static": lambda: [suites.ssz_static_suite,
                           suites.ssz_static_phase1_suite],
    "ssz_generic": lambda: [suites.ssz_generic_suite],
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    family = "all"
    if "--family" in argv:
        i = argv.index("--family")
        family = argv[i + 1]
        del argv[i:i + 2]
    if family == "all":
        creators = suites.all_creators()
    else:
        creators = FAMILIES[family]()
    run_generator(family, creators, argv)


if __name__ == "__main__":
    main()
