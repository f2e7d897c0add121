"""pairing_roofline: the least time of the window's grouped pairings, from
the algorithm (benchmark/counts.py: Miller loop and final exponentiation
per group and pair, Fq products at the card's 32-bit integer rate), as a
share of the device time of the two kernels that run them
(miller_grouped_kernel; g2_ladder_kernel, which runs the final
exponentiation's program). Only real groups count, not padding."""
from benchmark import counts

KERNELS = ("miller_grouped_kernel", "g2_ladder_kernel")


def read(f):
    peak = counts.peaks(f.device_kind)
    t = f.trace
    if peak is None or t is None or not f.groups:
        return None
    spent = t.kernel_s(*KERNELS)
    if spent <= 0:
        return None
    least = counts.pairing_ops(f.groups, f.pairs_per_group) / peak["int32_ops_per_s"]
    return 100.0 * least / spent
