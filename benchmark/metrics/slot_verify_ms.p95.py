"""slot_verify_ms.p95: the 95th percentile (numpy's linear interpolation)
over every slot burst of the window of the time from the burst's first
submit to its flush's return (host clock): the attestation deadline a node
must meet."""
import numpy as np


def read(f):
    return float(np.percentile(f.bursts_ms, 95)) if f.bursts_ms else None
