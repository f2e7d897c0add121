"""Spec/state injection, BLS switching, and phase fan-out decorators.

Capability parity: consensus-specs test_libs/pyspec/eth2spec/test/context.py.
Differences: specs are per-preset objects (not mutated module globals), so the
decorators also accept a preset name; phase fan-out resolves specs through the
models registry. Port of consensus_specs_tpu/testing/context.py: the preset is
chosen only through the `preset=` keyword (no environment switch), and the
spec runs on `device=` ("cuda" unless the caller says otherwise; without a
card that default raises, as every entry point of the port does).
"""
from __future__ import annotations

from ..crypto import bls
from ..models import phase0
from .utils import spectest, with_tags

# BLS is off by default in unit tests, for speed — signature-semantics tests
# opt in via @always_bls (reference context.py:20-27).
DEFAULT_BLS_ACTIVE = False

DEFAULT_PRESET = "minimal"


def _resolve_spec(phase: str, preset: str, device="cuda"):
    if phase == "phase0":
        return phase0.get_spec(preset, device)
    if phase == "phase1":
        from ..models import phase1
        return phase1.get_spec(preset, device)
    raise KeyError(f"unknown phase {phase!r}")


def with_state(fn):
    def entry(*args, **kw):
        if "spec" not in kw:
            raise TypeError("spec decorator must come before state decorator")
        from .factories import seed_genesis_state  # late: factories imports context
        spec = kw["spec"]
        kw["state"] = seed_genesis_state(spec, spec.SLOTS_PER_EPOCH * 8)
        return fn(*args, **kw)
    entry.__name__ = fn.__name__
    return entry


def expect_assertion_error(fn):
    bad = False
    try:
        fn()
        bad = True
    except AssertionError:
        pass
    except IndexError:
        # Out-of-range list access counts as a failed transition, same as the
        # reference's convention (context.py:35-46).
        pass
    if bad:
        raise AssertionError("expected an assertion error, but got none.")


bls_ignored = with_tags({"bls_setting": 2})
bls_required = with_tags({"bls_setting": 1})


def bls_switch(fn):
    def entry(*args, **kw):
        old_state = bls.bls_active
        bls.bls_active = kw.pop("bls_active", DEFAULT_BLS_ACTIVE)
        try:
            return fn(*args, **kw)
        finally:
            bls.bls_active = old_state
    entry.__name__ = fn.__name__
    return entry


def never_bls(fn):
    def entry(*args, **kw):
        kw["bls_active"] = False
        return fn(*args, **kw)
    entry.__name__ = fn.__name__
    return bls_ignored(entry)


def always_bls(fn):
    def entry(*args, **kw):
        kw["bls_active"] = True
        return fn(*args, **kw)
    entry.__name__ = fn.__name__
    return bls_required(entry)


def spec_state_test(fn):
    return with_state(bls_switch(spectest()(fn)))


all_phases = ["phase0", "phase1"]


def with_phases(phases):
    """Run a test against each phase's spec for the active preset, on the
    `device=` keyword's device."""
    def decorator(fn):
        def wrapper(*args, **kw):
            run_phases = phases
            if "phase" in kw:
                phase = kw.pop("phase")
                if phase not in phases:
                    return None
                run_phases = [phase]
            preset = kw.pop("preset", DEFAULT_PRESET)
            device = kw.pop("device", "cuda")
            ret = None
            for phase in run_phases:
                try:
                    spec = _resolve_spec(phase, preset, device)
                except ImportError:
                    continue  # phase not built yet
                kw["spec"] = spec
                ret = fn(*args, **kw)
            return ret
        wrapper.__name__ = fn.__name__
        return wrapper
    return decorator


def with_all_phases(fn):
    return with_phases(all_phases)(fn)


def with_all_phases_except(exclusion_phases):
    def decorator(fn):
        return with_phases([p for p in all_phases if p not in exclusion_phases])(fn)
    return decorator


def with_phase0(fn):
    return with_phases(["phase0"])(fn)
