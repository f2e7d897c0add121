"""Port's uint64/128-bit helpers (consensus_specs_tpu_torch.ops.intmath) ==
the JAX package's == Python bigints, over int64 bit patterns."""
import math

import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import intmath as JI
from consensus_specs_tpu_torch.ops import intmath as TI

from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

_EDGES = [0, 1, 2, 3, 2 ** 32 - 1, 2 ** 32, 2 ** 62, 2 ** 63 - 1, 2 ** 63,
          2 ** 63 + 1, 2 ** 64 - 2, 2 ** 64 - 1]
# the epoch program's magnitudes: 1M validators' Gwei totals, base rewards
_REAL = [32_000_000_000, 16_000_000_000, 1_000_000 * 32_000_000_000,
         10 ** 12, 2_846_049, 178_885]


def _t(xs) -> torch.Tensor:
    return torch.from_numpy(np.array(xs, dtype=np.uint64).view(np.int64))


def _u(t: torch.Tensor):
    return [int(v) for v in t.numpy().view(np.uint64)]


def _operands(seed, n=500):
    rng = np.random.default_rng(seed)
    vals = _EDGES + _REAL
    a = np.array(vals * len(vals) + list(rng.integers(0, 2 ** 64, n, dtype=np.uint64)),
                 dtype=np.uint64)
    b = np.array([v for v in vals for _ in vals]
                 + list(rng.integers(0, 2 ** 64, n, dtype=np.uint64)), dtype=np.uint64)
    return a, b


def test_mulwide_matches_bigints_and_jax():
    a, b = _operands(1)
    hi, lo = TI.mulwide_u64(_t(a), _t(b))
    for x, y, h, l in zip(a, b, _u(hi), _u(lo)):
        assert (h << 64) | l == int(x) * int(y)
    jh, jl = JI.mulwide_u64(a, b)
    assert _u(hi) == [int(v) for v in np.asarray(jh)]
    assert _u(lo) == [int(v) for v in np.asarray(jl)]


def test_muldiv_matches_bigints_where_quotient_fits():
    a, b = _operands(2)
    rng = np.random.default_rng(3)
    d = []
    for x, y in zip(a, b):
        lo_d = int(x) * int(y) // 2 ** 64 + 1     # smallest d with a fitting quotient
        d.append(int(rng.integers(lo_d, 2 ** 64, dtype=np.uint64, endpoint=False))
                 if lo_d < 2 ** 64 else 2 ** 64 - 1)
    got = _u(TI.muldiv_u64(_t(a), _t(b), _t(d)))
    for x, y, z, q in zip(a, b, d, got):
        if int(x) * int(y) // z < 2 ** 64:
            assert q == int(x) * int(y) // z
    assert got == [int(v) for v in np.asarray(
        JI.muldiv_u64(a, b, np.array(d, dtype=np.uint64)))]


def test_muldiv_matches_jax_on_any_divisor():
    """Bit-identical to the reference also where the quotient overflows
    (both seed the remainder with hi mod d)."""
    a, b = _operands(4)
    rng = np.random.default_rng(5)
    d = np.array(list(rng.integers(1, 2 ** 64, a.shape[0] - 6, dtype=np.uint64))
                 + [1, 2, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, 3], dtype=np.uint64)
    got = _u(TI.muldiv_u64(_t(a), _t(b), _t(d)))
    assert got == [int(v) for v in np.asarray(JI.muldiv_u64(a, b, d))]


def test_muldiv_scalar_divisor_like_epoch_program():
    rng = np.random.default_rng(6)
    base = rng.integers(0, 2_000_000, 300).astype(np.uint64)
    att = np.uint64(900_000 * 32_000_000_000)
    total = np.uint64(1_000_000 * 32_000_000_000)
    got = _u(TI.muldiv_u64(_t(base), torch.tensor(int(att)), torch.tensor(int(total))))
    assert got == [int(x) * int(att) // int(total) for x in base]


def test_isqrt_exact_floor_root():
    """Exact floor roots everywhere below (2**32-1)**2, where the
    reference's wrapping (x+1)**2 correction cannot wrap."""
    rng = np.random.default_rng(7)
    top = (2 ** 32 - 1) ** 2
    xs = np.array([v for v in _EDGES + _REAL if v < top] + [top - 1]
                  + [k * k + e for k in (1, 2 ** 16, 2 ** 31, 2 ** 32 - 2)
                     for e in (-1, 0, 1)]
                  + list(rng.integers(0, top, 3000, dtype=np.uint64)),
                  dtype=np.uint64)
    got = _u(TI.isqrt_u64(_t(xs)))
    assert got == [math.isqrt(int(x)) for x in xs]


def test_isqrt_matches_jax_below_its_range_limit():
    """The reference seeds from float64 and corrects with a wrapping
    (x+1)**2; below (2**32-1)**2 the two agree everywhere."""
    rng = np.random.default_rng(8)
    xs = np.array([v for v in _EDGES + _REAL if v < (2 ** 32 - 1) ** 2]
                  + list(rng.integers(0, (2 ** 32 - 1) ** 2, 3000, dtype=np.uint64)),
                  dtype=np.uint64)
    assert _u(TI.isqrt_u64(_t(xs))) == [int(v) for v in np.asarray(JI.isqrt_u64(xs))]


def test_isqrt_divergence_from_jax_at_top_of_range():
    """The port equals the reference on all of [0, 2**64), the top of the
    range included: for n >= (2**32-1)**2 both return 2**32 (the wrapped
    (x+1)**2 correction), one more than the exact root. Edges, squares
    and their neighbours, float64 rounding ties and random values over
    the whole range."""
    rng = np.random.default_rng(9)
    top = (2 ** 32 - 1) ** 2
    ties = [(1 << 53) + 1, (1 << 54) + 2, (1 << 63) + (1 << 10) + 1,
            (1 << 64) - (1 << 11) - 1, (1 << 64) - (1 << 10)]
    xs = np.array(_EDGES + _REAL + ties + [top - 1, top, top + 1]
                  + [k * k + e for k in (1, 2 ** 16, 2 ** 26 + 3, 2 ** 31,
                                         2 ** 32 - 2, 2 ** 32 - 1)
                     for e in (-1, 0, 1)]
                  + list(rng.integers(0, 2 ** 64, 5000, dtype=np.uint64))
                  + list(rng.integers(top, 2 ** 64, 500, dtype=np.uint64)),
                  dtype=np.uint64)
    want = [int(v) for v in np.asarray(JI.isqrt_u64(xs))]
    assert _u(TI.isqrt_u64(_t(xs))) == want
    assert want[_EDGES.index(2 ** 64 - 1)] == 2 ** 32


@pytest.mark.parametrize("k", [0, 1, 31, 32, 63])
def test_ushr_is_logical(k):
    xs = np.array(_EDGES, dtype=np.uint64)
    assert _u(TI.ushr(_t(xs), k)) == [int(v) >> k for v in xs]


def test_unsigned_compare_minmax_and_divmod():
    xs = np.array(_EDGES, dtype=np.uint64)
    ys = np.roll(xs, 3)
    t, u = _t(xs), _t(ys)
    assert TI.ult(t, u).tolist() == [int(a) < int(b) for a, b in zip(xs, ys)]
    assert TI.ule(t, u).tolist() == [int(a) <= int(b) for a, b in zip(xs, ys)]
    assert _u(TI.umax(t, u)) == [max(int(a), int(b)) for a, b in zip(xs, ys)]
    assert _u(TI.umin(t, u)) == [min(int(a), int(b)) for a, b in zip(xs, ys)]
    assert _u(TI.umax_reduce(t).reshape(1)) == [2 ** 64 - 1]
    d = np.array([1, 2, 3, 7, 2 ** 32 + 1, 2 ** 62 + 5, 2 ** 63 - 1, 2 ** 63,
                  2 ** 63 + 7, 2 ** 64 - 2, 2 ** 64 - 1, 5], dtype=np.uint64)
    q, r = TI.udivmod_u64(t, _t(d))
    assert _u(q) == [int(a) // int(b) for a, b in zip(xs, d)]
    assert _u(r) == [int(a) % int(b) for a, b in zip(xs, d)]
