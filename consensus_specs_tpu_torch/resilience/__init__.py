"""Port counterpart of consensus_specs_tpu/resilience/ (the typed errors
the resident core raises)."""
