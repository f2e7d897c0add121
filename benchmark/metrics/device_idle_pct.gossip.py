"""device_idle_pct.gossip: 100 x (1 - device busy / traced window), busy
the union of the device's kernels and copies in the torch.profiler trace."""


def read(f):
    t = f.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
