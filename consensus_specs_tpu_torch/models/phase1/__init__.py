"""Phase 1: custody game + shard data chains on top of phase 0.

The reference compiles three markdown docs into one module with
field-appended containers and `# @label` code inserts
(consensus-specs scripts/build_spec.py:189-219). Here Phase1Spec subclasses
Phase0Spec: appended container fields come from Container subclassing (the
SSZ type system walks the MRO), epoch inserts from the phase-0 hook lists,
and the five custody operation families from the process_operations
extension hook.

Port of consensus_specs_tpu/models/phase1/: `Phase1Spec(preset,
device="cuda", pair_fn=None)` runs on the card unless told otherwise.
"""
from .spec import Phase1Spec, get_spec  # noqa: F401
