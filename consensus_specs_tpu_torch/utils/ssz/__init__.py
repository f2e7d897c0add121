"""Port counterpart of consensus_specs_tpu/utils/ssz/."""
