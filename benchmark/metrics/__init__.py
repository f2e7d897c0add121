"""One reader a metric: `read(facts) -> float | None`."""
