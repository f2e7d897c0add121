"""Port counterpart of consensus_specs_tpu/models/phase0/."""
