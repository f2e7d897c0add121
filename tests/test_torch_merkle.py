"""Port's Merkleization (consensus_specs_tpu_torch.utils.ssz) == the JAX
package's: registry/balances roots from columns, the per-level reductions,
and the incremental forest's levels, roots and pair-lane counts under the
update patterns of tests/test_incremental_merkle.py."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import sha256 as JS
from consensus_specs_tpu.utils.ssz import bulk as JB
from consensus_specs_tpu.utils.ssz.incremental import (
    tree_from_chunks as j_tree_from_chunks)
from consensus_specs_tpu_torch.ops import sha256 as TS
from consensus_specs_tpu_torch.utils.merkle import tree_depth
from consensus_specs_tpu_torch.utils.ssz import bulk as TB
from consensus_specs_tpu_torch.utils.ssz.incremental import (
    tree_from_chunks as t_tree_from_chunks)

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

FAR = 2 ** 64 - 1


def _columns(V, seed):
    rng = np.random.default_rng(seed)

    def epochs():
        return np.where(rng.random(V) < 0.3, FAR,
                        rng.integers(0, 2 ** 40, V)).astype(np.uint64)

    return dict(
        pubkeys=rng.integers(0, 256, (V, 48), dtype=np.uint8),
        withdrawal_credentials=rng.integers(0, 256, (V, 32), dtype=np.uint8),
        activation_eligibility_epoch=epochs(),
        activation_epoch=epochs(),
        exit_epoch=epochs(),
        withdrawable_epoch=epochs(),
        slashed=rng.random(V) < 0.2,
        effective_balance=rng.integers(0, 2 ** 64, V, dtype=np.uint64),
        balances=rng.integers(0, 2 ** 64, V, dtype=np.uint64),
    )


def _tensor(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)


def _rand_chunks(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def _rows(chunks):
    return TS.words_tensor(TS.bytes_to_words(chunks), "cpu")


@pytest.mark.parametrize("V", [0, 1, 5, 64, 1000])
def test_registry_and_balances_roots_match_jax(V):
    cols = _columns(V, V)
    want = JB.registry_and_balances_roots_device(*cols.values())
    got = TB.registry_and_balances_roots_device(
        *[_tensor(c) for c in cols.values()])
    assert got == want


@pytest.mark.parametrize("n", [1, 2, 3, 7, 33])
def test_reductions_match_reference_host_merkleizer(n):
    """merkle_reduce_words / subtree_roots_words == the reference's numpy
    Merkleizers (merkleize_chunk_array, subtree_roots_batch), which its
    own tests pin to its device reductions."""
    rng = np.random.default_rng(n)
    chunks = _rand_chunks(rng, n)
    got = TS.merkle_reduce_words(_rows(chunks))
    assert TS.words_to_bytes(got).tobytes() == JB.merkleize_chunk_array(chunks)
    leaves = rng.integers(0, 256, (n, 8, 32), dtype=np.uint8)
    got = TS.subtree_roots_words(
        TS.words_tensor(TS.bytes_to_words(leaves), "cpu"))
    assert (TS.words_to_bytes(got) == JB.subtree_roots_batch(leaves)).all()


# ---------------------------------------------------------------------------
# Incremental forest: both trees driven side by side
# ---------------------------------------------------------------------------

class _Pair:
    """A JAX tree and a port tree over the same chunks."""

    def __init__(self, chunks):
        self.j = j_tree_from_chunks(chunks)
        self.t = t_tree_from_chunks(chunks, device="cpu")
        self.check()

    def update(self, idx, chunks):
        self.j.update(idx, JS.bytes_to_words(chunks))
        self.t.update(idx, _rows(chunks))
        self.check()

    def append(self, chunks):
        self.j.append(JS.bytes_to_words(chunks))
        self.t.append(_rows(chunks))
        self.check()

    def check(self):
        assert self.t.root() == self.j.root()
        assert len(self.t.levels) == len(self.j.levels)
        for lt, lj in zip(self.t.levels, self.j.levels):
            assert (lt.numpy().view(np.uint32) == np.asarray(lj)).all()
        assert self.t.last_pairs_per_level == self.j.last_pairs_per_level
        assert self.t.total_pairs_hashed == self.j.total_pairs_hashed


@pytest.mark.parametrize("n", [0, 1, 2, 5, 33, 257])
def test_forest_build_matches_jax(n):
    _Pair(_rand_chunks(np.random.default_rng(n), n))


def test_forest_single_leaf_updates():
    rng = np.random.default_rng(1)
    p = _Pair(_rand_chunks(rng, 97))
    for leaf in (0, 1, 50, 95, 96):          # both edges incl. the odd tail
        p.update([leaf], _rand_chunks(rng, 1))


def test_forest_dense_stripes():
    rng = np.random.default_rng(2)
    p = _Pair(_rand_chunks(rng, 300))
    for start, width in ((0, 64), (100, 37), (250, 50)):
        p.update(np.arange(start, start + width), _rand_chunks(rng, width))


def test_forest_repeated_updates_to_same_leaf():
    rng = np.random.default_rng(3)
    p = _Pair(_rand_chunks(rng, 64))
    for _ in range(4):
        p.update([17], _rand_chunks(rng, 1))


def test_forest_all_dirty_epoch_boundary_shape():
    rng = np.random.default_rng(6)
    p = _Pair(_rand_chunks(rng, 130))
    p.update(np.arange(130), _rand_chunks(rng, 130))


def test_forest_append_grow_crossing_power_of_two():
    rng = np.random.default_rng(4)
    p = _Pair(_rand_chunks(rng, 5))
    n = 5
    for k in (2, 1, 4, 9, 50):               # crosses 8, 16, 64
        p.append(_rand_chunks(rng, k))
        n += k
        assert p.t.depth == tree_depth(n)
    idx = np.array([0, 6, 7, 8, n - 1])
    p.update(idx, _rand_chunks(rng, idx.shape[0]))


def test_forest_append_from_empty():
    rng = np.random.default_rng(5)
    p = _Pair(np.zeros((0, 32), np.uint8))
    p.append(_rand_chunks(rng, 3))


def test_forest_rejects_bad_indices():
    tree = t_tree_from_chunks(_rand_chunks(np.random.default_rng(9), 10),
                              device="cpu")
    row = _rows(_rand_chunks(np.random.default_rng(9), 2))
    with pytest.raises(ValueError):
        tree.update([3, 3], row)
    with pytest.raises(IndexError):
        tree.update([3, 10], row)
