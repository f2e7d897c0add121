"""Input generators of the benchmark's traffic kinds: plain NumPy and the
reference's bignum BLS, from the run's seed, importing nothing of the
program."""

import numpy as np


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of one input stream of a run: the same (seed, stream)
    gives the same draws, for any whole seed."""
    return np.random.default_rng([int(seed) % (1 << 63), int(int(seed) < 0), stream])
