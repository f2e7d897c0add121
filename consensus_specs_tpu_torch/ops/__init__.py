"""Port counterpart of consensus_specs_tpu/ops/."""
