"""Port's SHA-256 (consensus_specs_tpu_torch.ops.sha256) == the JAX package's
XLA form == its Pallas kernel (interpret mode) == hashlib, bit for bit.

Inputs are made with numpy from a seed and handed to both sides; the
tolerance is zero (integer words)."""
import hashlib

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import sha256 as JS
from consensus_specs_tpu.ops.sha256_pallas import sha256_pairs_pallas
from consensus_specs_tpu_torch.ops import sha256 as TS
from consensus_specs_tpu_torch.ops.sha256_cuda import sha256_pairs_cuda

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 5, 128, 300])
def test_pairs_match_jax_xla_and_pallas(n):
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint32)
    got = _u32(TS.sha256_pairs(TS.words_tensor(words, "cpu")))
    assert (got == np.asarray(JS.sha256_pairs(words))).all()
    assert (got == np.asarray(sha256_pairs_pallas(words))).all()


def test_pair_hash_words_on_cpu_matches_hashlib():
    msgs = [bytes(range(64)), b"\x00" * 64, b"\xff" * 64]
    words = np.stack([
        TS.bytes_to_words(np.frombuffer(m, dtype=np.uint8)) for m in msgs])
    got = TS.pair_hash_words(TS.words_tensor(words, "cpu"))
    for k, m in enumerate(msgs):
        assert TS.words_to_bytes(got[k]).tobytes() == hashlib.sha256(m).digest()


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain path itself."""
    with pytest.raises(ValueError):
        sha256_pairs_cuda(torch.zeros((4, 16), dtype=torch.int32))


@pytest.mark.parametrize("length", [1, 33, 37, 55])
def test_single_block_matches_jax(length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, (64, length), dtype=np.uint8)
    padded = TS.pad_to_single_block(data, length)
    assert (padded == JS.pad_to_single_block(data, length)).all()
    got = _u32(TS.sha256_single_block(TS.words_tensor(padded, "cpu")))
    assert (got == np.asarray(JS.sha256_single_block(padded))).all()
    for k in range(3):
        assert (TS.words_to_bytes(got[k]).tobytes()
                == hashlib.sha256(data[k].tobytes()).digest())


def test_sha256_blocks_matches_jax():
    rng = np.random.default_rng(11)
    state = rng.integers(0, 2 ** 32, (50, 8), dtype=np.uint32)
    block = rng.integers(0, 2 ** 32, (50, 16), dtype=np.uint32)
    got = _u32(TS.sha256_blocks(TS.words_tensor(state, "cpu"),
                                TS.words_tensor(block, "cpu")))
    assert (got == np.asarray(JS.sha256_blocks(state, block))).all()


def test_zerohash_words_match_jax():
    for d in range(41):
        assert (TS.zerohash_words(d) == JS.zerohash_words(d)).all(), d


def test_int32_bit_pattern_round_trip_high_words():
    """Words >= 2**31 live as negative int32 and come back unchanged."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (40, 64), dtype=np.uint8)
    data[:, 0] |= 0x80                       # every first word >= 2**31
    words = TS.bytes_to_words(data)
    assert (words == JS.bytes_to_words(data)).all()
    t = TS.words_tensor(words, "cpu")
    assert t.dtype == torch.int32 and bool((t[:, 0] < 0).all())
    assert (TS.words_to_bytes(t) == data).all()
    assert (TS.words_to_bytes(words) == JS.words_to_bytes(words)).all()
    wide = TS.widen(t)
    assert int(wide.min()) >= 0 and int(wide.max()) < 2 ** 32
    assert torch.equal(TS.narrow(wide), t)


def test_sha256_many_matches_jax_and_hashlib():
    """Equal-length messages of any length, block by block (the lengths
    cross the one-block limit of 55 bytes and the 64-byte boundary)."""
    rng = np.random.default_rng(1)
    for length in (1, 33, 55, 56, 64, 65, 128, 200):
        msgs = rng.integers(0, 256, (5, length), dtype=np.uint8)
        got = TS.sha256_many(msgs, device="cpu")
        assert got.shape == (5, 32) and got.dtype == np.uint8
        assert (got == JS.sha256_many(msgs)).all(), length
        for i in range(5):
            assert got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


def test_device_merkle_root_matches_jax_and_host():
    from consensus_specs_tpu.utils.hash import zerohashes
    from consensus_specs_tpu.utils.merkle import merkleize_chunks
    rng = np.random.default_rng(3)
    for n, pad_to in ((1, 1), (3, 4), (8, 8), (5, 16), (100, 128)):
        leaves = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]
        got = TS.merkle_root_from_leaves_device(leaves, pad_to, device="cpu")
        assert got == JS.merkle_root_from_leaves_device(leaves, pad_to)
        assert got == merkleize_chunks(leaves + [b"\x00" * 32] * (pad_to - n))
    assert TS.merkle_root_from_leaves_device([], 8, device="cpu") == zerohashes[3]
    words = rng.integers(0, 2 ** 32, (16, 8), dtype=np.uint32)
    got = TS.merkle_root_device(TS.words_tensor(words, "cpu"), 4)
    assert (_u32(got) == np.asarray(JS.merkle_root_device(words, 4))).all()
    with pytest.raises(ValueError):
        TS.merkle_root_device(TS.words_tensor(words, "cpu"), 3)
    with pytest.raises(ValueError):
        TS.merkle_root_from_leaves_device([b"\x00" * 32] * 3, 6, device="cpu")
