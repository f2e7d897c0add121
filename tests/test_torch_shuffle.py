"""Port's swap-or-not permutation (consensus_specs_tpu_torch.ops.shuffle) ==
the JAX package's device permutation and host pivots."""
import numpy as np
import pytest

from consensus_specs_tpu.ops import shuffle as JSH
from consensus_specs_tpu_torch.ops import shuffle as TSH

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("n", [1, 2, 100, 1000])
def test_permutation_matches_jax(n):
    seed = bytes(np.random.default_rng(n).integers(0, 256, 32, dtype=np.uint8))
    assert (TSH.host_pivots(seed, n, 90) == JSH.host_pivots(seed, n, 90)).all()
    got = TSH.shuffle_permutation_device(seed, n, 90, device="cpu")
    assert (got == JSH.shuffle_permutation_device(seed, n, 90)).all()
    assert sorted(got.tolist()) == list(range(n))


def test_permutation_minimal_rounds_crosses_digest_blocks():
    """n = 700 spans three 256-position digest blocks; 10 rounds is the
    minimal preset's SHUFFLE_ROUND_COUNT."""
    seed = bytes(range(32))
    got = TSH.shuffle_permutation_on_device(seed, 700, 10, device="cpu")
    assert (got.numpy() == np.asarray(
        JSH.shuffle_permutation_on_device(seed, 700, 10))).all()


def test_rejects_out_of_range_counts():
    with pytest.raises(ValueError):
        TSH.shuffle_permutation_on_device(bytes(32), 0, 90, device="cpu")
