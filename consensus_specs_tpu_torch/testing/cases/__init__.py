"""Table-driven scenario corpus.

Every operation/epoch handler gets a table of `Case` rows instead of a file
of near-identical test functions: a row names the scenario, stages the
state, builds (and optionally perturbs + re-signs) the operation, and says
whether the handler must accept or reject. One engine turns rows into

  - pytest functions (``install_pytests`` synthesizes ``test_<name>``
    entries with the spec/state/BLS decorator stack), and
  - vector-generator cases (the same rows run under ``generator_mode=True``
    through the yield protocol — see testing/generators).

Scenario coverage tracks the reference corpus case-for-case
(consensus-specs test_libs/pyspec/eth2spec/test/phase_0/…); the expression
is this framework's own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from ..context import always_bls, never_bls, spec_state_test, with_phases

ALL_PHASES = ("phase0", "phase1")
PHASE0_ONLY = ("phase0",)


@dataclass
class Case:
    """One scenario row: how to build the op, and what the handler must do."""
    name: str
    build: Callable[[Any, Any], Any]          # (spec, state) -> operation
    valid: bool = True
    bls: Optional[bool] = None                # None: either; True/False: forced
    phases: Tuple[str, ...] = ALL_PHASES
    run_kwargs: Dict[str, Any] = field(default_factory=dict)


def accept(name: str, build, **kw) -> Case:
    return Case(name=name, build=build, valid=True, **kw)


def reject(name: str, build, **kw) -> Case:
    return Case(name=name, build=build, valid=False, **kw)


def perturbed(factory, *mutators, resign=None):
    """Compose a build function: make the op, apply mutators, optionally
    re-sign. `resign(spec, state, op)` runs only when BLS signing matters —
    mutators usually invalidate any existing signature."""
    def build(spec, state):
        op = factory(spec, state)
        for m in mutators:
            m(spec, state, op)
        if resign is not None:
            resign(spec, state, op)
        return op
    return build


def install_pytests(module_globals: Dict[str, Any], cases: Iterable[Case],
                    execute) -> None:
    """Synthesize decorated ``test_<name>`` pytest entries from a table.

    `execute(spec, state, case)` must be a generator (the yield protocol);
    the standard decorator stack (phase fan-out, genesis state injection,
    BLS switching) wraps each synthesized function.
    """
    for case in cases:
        def scenario(spec, state, _case=case):
            yield from execute(spec, state, _case)
        scenario.__name__ = f"test_{case.name}"

        wrapped = spec_state_test(scenario)
        if case.bls is True:
            wrapped = always_bls(wrapped)
        elif case.bls is False:
            wrapped = never_bls(wrapped)
        wrapped = with_phases(list(case.phases))(wrapped)
        wrapped.__name__ = f"test_{case.name}"
        if wrapped.__name__ in module_globals:
            raise ValueError(f"duplicate case name: {case.name}")
        module_globals[wrapped.__name__] = wrapped


def case_index(cases: Iterable[Case]) -> Dict[str, Case]:
    return {c.name: c for c in cases}
