"""firehose.host_ms_per_batch: host milliseconds inside submit_staged and
pump() (the benchmark's spans around them) per batch the window
dispatched: the streaming layer's host cost of a batch."""


def read(f):
    spans = f.spans
    if not f.batches or "bench.submit" not in spans:
        return None
    host = spans["bench.submit"][1] + spans.get("bench.pump", (0, 0.0))[1]
    return host * 1e3 / f.batches
