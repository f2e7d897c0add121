"""firehose.flush_ms: mean milliseconds of a flush() (the benchmark's span
around it): the partial batches, the wait for the newest batch and the one
read of the verdict ring."""


def read(f):
    n, total = f.spans.get("bench.flush", (0, 0.0))
    return total * 1e3 / n if n else None
