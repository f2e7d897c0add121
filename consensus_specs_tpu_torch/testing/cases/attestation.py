"""process_attestation scenario table.

Validity rules probed per consensus-specs specs/core/0_beacon-chain.md:1692-1727
(inclusion window, FFG source consistency, crosslink lineage, bitfield
shape, aggregate signature); scenario coverage tracks the reference's
attestation corpus case-for-case.
"""
from __future__ import annotations

from copy import deepcopy

from .. import factories as f
from ..runners import run_attestation_processing
from . import PHASE0_ONLY, Case, install_pytests

# -- staging ----------------------------------------------------------------


def includable(spec, state, *, signed=True):
    """Attestation + state moved past the inclusion delay."""
    att = f.new_attestation(spec, state, signed=signed)
    state.slot += spec.MIN_ATTESTATION_INCLUSION_DELAY
    return att


def from_closed_epoch(spec, state, *, signed=True):
    """Attestation made in one epoch, state rolled into the next."""
    f.advance_epoch(spec, state)
    f.transition_with_empty_block(spec, state)
    att = f.new_attestation(spec, state, signed=signed)
    for _ in range(spec.MIN_ATTESTATION_INCLUSION_DELAY):
        f.advance_slots(spec, state)
    f.transition_with_empty_block(spec, state)
    return att


def _with_justification(spec, state):
    """Plant a justification history so source-epoch scenarios have both a
    previous and a current justified checkpoint to play against."""
    state.slot = spec.SLOTS_PER_EPOCH * 5
    state.finalized_epoch = 2
    state.previous_justified_epoch = 3
    state.current_justified_epoch = 4
    return f.new_attestation(spec, state, slot=(spec.SLOTS_PER_EPOCH * 3) + 1)


def _mut(apply):
    """Lift an attestation mutation into the (spec, state, op) shape."""
    return lambda spec, state, att: apply(att)


def _resign(spec, state, att):
    f.endorse(spec, state, att)


# -- table ------------------------------------------------------------------


CASES = [
    Case("success",
         build=lambda spec, state: includable(spec, state)),

    Case("success_previous_epoch",
         build=lambda spec, state: _previous_epoch_inclusion(spec, state)),

    Case("success_since_max_epochs_per_crosslink",
         build=lambda spec, state: _stale_crosslink_window(spec, state)),

    Case("invalid_attestation_signature", valid=False, bls=True,
         build=lambda spec, state: includable(spec, state, signed=False)),

    Case("before_inclusion_delay", valid=False,
         build=lambda spec, state: f.new_attestation(spec, state, signed=True)),

    Case("after_epoch_slots", valid=False,
         build=lambda spec, state: _past_inclusion_window(spec, state)),

    Case("old_source_epoch", valid=False,
         build=lambda spec, state: _tamper_justified(
             spec, state, lambda att: _dec(att, "source_epoch"))),

    Case("wrong_shard", valid=False,
         build=lambda spec, state: _tampered(
             spec, state, lambda att: _inc(att.data.crosslink, "shard"))),

    Case("new_source_epoch", valid=False,
         build=lambda spec, state: _tampered(
             spec, state, lambda att: _inc(att.data, "source_epoch"))),

    Case("source_root_is_target_root", valid=False,
         build=lambda spec, state: _tampered(
             spec, state,
             lambda att: setattr(att.data, "source_root", att.data.target_root))),

    Case("invalid_current_source_root", valid=False,
         build=lambda spec, state: _cross_justified_roots(spec, state)),

    Case("bad_source_root", valid=False,
         build=lambda spec, state: _tampered(
             spec, state,
             lambda att: setattr(att.data, "source_root", b"\x42" * 32))),

    Case("non_zero_crosslink_data_root", valid=False, phases=PHASE0_ONLY,
         build=lambda spec, state: _tampered(
             spec, state,
             lambda att: setattr(att.data.crosslink, "data_root", b"\x42" * 32))),

    Case("bad_parent_crosslink", valid=False,
         build=lambda spec, state: _tampered_next_epoch(
             spec, state,
             lambda att: setattr(att.data.crosslink, "parent_root", b"\x27" * 32))),

    Case("bad_crosslink_start_epoch", valid=False,
         build=lambda spec, state: _tampered_next_epoch(
             spec, state, lambda att: _inc(att.data.crosslink, "start_epoch"))),

    Case("bad_crosslink_end_epoch", valid=False,
         build=lambda spec, state: _tampered_next_epoch(
             spec, state, lambda att: _inc(att.data.crosslink, "end_epoch"))),

    Case("inconsistent_bitfields", valid=False,
         build=lambda spec, state: _tampered(
             spec, state,
             lambda att: setattr(att, "custody_bitfield",
                                 deepcopy(att.aggregation_bitfield) + b"\x00"))),

    Case("non_empty_custody_bitfield", valid=False, phases=PHASE0_ONLY,
         build=lambda spec, state: _tampered(
             spec, state,
             lambda att: setattr(att, "custody_bitfield",
                                 deepcopy(att.aggregation_bitfield)))),

    Case("empty_aggregation_bitfield",   # allowed: an empty vote still records
         build=lambda spec, state: _tampered(
             spec, state,
             lambda att: setattr(att, "aggregation_bitfield",
                                 b"\x00" * len(att.aggregation_bitfield)))),
]


# -- staging bodies ---------------------------------------------------------


def _inc(obj, attr):
    setattr(obj, attr, getattr(obj, attr) + 1)


def _dec(att, attr):
    setattr(att.data, attr, getattr(att.data, attr) - 1)


def _previous_epoch_inclusion(spec, state):
    att = f.new_attestation(spec, state, signed=True)
    f.advance_epoch(spec, state)
    f.transition_with_empty_block(spec, state)
    return att


def _stale_crosslink_window(spec, state):
    for _ in range(spec.MAX_EPOCHS_PER_CROSSLINK + 2):
        f.advance_epoch(spec, state)
    f.transition_with_empty_block(spec, state)
    att = f.new_attestation(spec, state, signed=True)
    data = att.data
    assert data.crosslink.end_epoch - data.crosslink.start_epoch \
        == spec.MAX_EPOCHS_PER_CROSSLINK
    for _ in range(spec.MIN_ATTESTATION_INCLUSION_DELAY):
        f.advance_slots(spec, state)
    f.transition_with_empty_block(spec, state)
    return att


def _past_inclusion_window(spec, state):
    att = f.new_attestation(spec, state, signed=True)
    spec.process_slots(state, state.slot + spec.SLOTS_PER_EPOCH + 1)
    f.transition_with_empty_block(spec, state)
    return att


def _tampered(spec, state, mutate):
    att = includable(spec, state, signed=False)
    mutate(att)
    _resign(spec, state, att)
    return att


def _tampered_next_epoch(spec, state, mutate):
    att = from_closed_epoch(spec, state)
    mutate(att)
    return att


def _tamper_justified(spec, state, mutate):
    att = _with_justification(spec, state)
    assert att.data.source_epoch == state.previous_justified_epoch
    mutate(att)
    _resign(spec, state, att)
    return att


def _cross_justified_roots(spec, state):
    state.slot = spec.SLOTS_PER_EPOCH * 5
    state.finalized_epoch = 2
    state.previous_justified_epoch = 3
    state.previous_justified_root = b"\x01" * 32
    state.current_justified_epoch = 4
    state.current_justified_root = b"\xff" * 32
    att = f.new_attestation(spec, state, slot=(spec.SLOTS_PER_EPOCH * 3) + 1)
    state.slot += spec.MIN_ATTESTATION_INCLUSION_DELAY
    assert att.data.source_root == state.previous_justified_root
    att.data.source_root = state.current_justified_root  # wrong checkpoint's root
    _resign(spec, state, att)
    return att


# -- engine hookup ----------------------------------------------------------


def execute(spec, state, case):
    attestation = case.build(spec, state)
    yield from run_attestation_processing(spec, state, attestation, case.valid)


install_pytests(globals(), CASES, execute)
