"""The port's spec-test corpus (consensus_specs_tpu_torch.testing: context,
factories, keys, runners and the 12 scenario tables of cases/) held against
the JAX package's on the CPU.

Every row of every table runs in generator mode at the minimal preset, on
phase 0 and on phase 1 where the row allows it, through both packages
(the port's spec on device="cpu"). The artifacts must be equal, and so must
their YAML text: a numpy or torch scalar leaking into a vector would pass
the first comparison and fail the second. BLS is off, except in the rows
that force it on (`bls=True`), which sign and verify through each
package's bignum "python" backend. Then the signature-bearing rows (the
`bls=True` rows and the success rows of tests/test_bls_corpus_jax.py) run
again with BLS on."""
import importlib

import pytest
import yaml


from _bls_backend import python_bls  # noqa: F401
from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

TABLES = ("attestation", "attester_slashing", "block_header", "deposit",
          "proposer_slashing", "transfer", "voluntary_exit", "crosslinks",
          "registry_updates", "sanity_blocks", "sanity_slots", "finality")


def _module(package: str, table: str):
    return importlib.import_module(f"{package}.testing.cases.{table}")


def _rows():
    for table in TABLES:
        for case in _module("consensus_specs_tpu_torch", table).CASES:
            yield table, case


ROWS = [(table, case.name, phase) for table, case in _rows()
        for phase in case.phases]
SIGNED_SUCCESS = [("attestation", "success"), ("block_header", "success_block_header"),
                  ("proposer_slashing", "success"), ("deposit", "new_deposit"),
                  ("voluntary_exit", "success")]
BLS_ROWS = SIGNED_SUCCESS + [(table, case.name) for table, case in _rows()
                             if case.bls is True]


def _both(table: str, name: str, phase: str, bls_active: bool):
    port = getattr(_module("consensus_specs_tpu_torch", table), f"test_{name}")(
        generator_mode=True, phase=phase, preset="minimal", bls_active=bls_active,
        device="cpu")
    ref = getattr(_module("consensus_specs_tpu", table), f"test_{name}")(
        generator_mode=True, phase=phase, preset="minimal", bls_active=bls_active)
    return port, ref


def _yaml(artifact) -> str:
    """yaml.safe_dump's text (the safe representer refuses any type it does
    not know, a numpy or torch scalar among them), through libyaml's
    emitter for speed."""
    return yaml.dump(artifact, Dumper=yaml.CSafeDumper, sort_keys=False)


def _same_artifacts(port, ref):
    assert ref is not None
    assert port == ref
    assert _yaml(port) == _yaml(ref)


def test_corpus_shape():
    """98 rows in 12 tables, 12 of them forcing BLS on, 2 phase-0 only."""
    rows = list(_rows())
    assert len(rows) == 98
    assert sum(case.bls is True for _, case in rows) == 12
    assert sum(case.phases == ("phase0",) for _, case in rows) == 2
    assert len(ROWS) == 98 + 96 and len(BLS_ROWS) == 17
    for table in TABLES:
        port = _module("consensus_specs_tpu_torch", table)
        ref = _module("consensus_specs_tpu", table)
        assert [c.name for c in port.CASES] == [c.name for c in ref.CASES]


@pytest.mark.parametrize("table,name,phase", ROWS,
                         ids=[f"{t}:{n}:{p}" for t, n, p in ROWS])
def test_row_matches_the_jax_package(table, name, phase, python_bls):
    _same_artifacts(*_both(table, name, phase, bls_active=False))


@pytest.mark.parametrize("table,name", BLS_ROWS, ids=[f"{t}:{n}" for t, n in BLS_ROWS])
def test_row_with_bls_matches_the_jax_package(table, name, python_bls):
    port, ref = _both(table, name, "phase0", bls_active=True)
    _same_artifacts(port, ref)
    if (table, name) in SIGNED_SUCCESS:
        assert port["post"] is not None
