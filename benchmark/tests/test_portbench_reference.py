"""The reference against the scheme's definitions, at small sizes: the
fast point arithmetic that makes a pool gives the reference's points; the
verdict by secret key is the pairing check's."""
import numpy as np

from benchmark.gen import curve, rng_of
from benchmark.gen.gossip import make_pool
from benchmark.reference import bls12_381 as bls
from benchmark.reference import gossip as G


def test_fast_points_are_the_reference_points():
    h = bls.hash_to_g2(b"\x42" * 32, 2)
    assert curve.hash_to_g2(b"\x42" * 32, 2) == h
    k = bls.r - 98765
    assert curve.mul(h, k) == bls.ec_mul(h, k)
    assert curve.mul(bls.G1_GEN, k) == bls.ec_mul(bls.G1_GEN, k)
    want, p = [], bls.ec_mul(bls.G1_GEN, 5)
    for _ in range(6):
        want.append(p)
        p = bls.ec_add(p, bls.G1_GEN)
    assert curve.progression(bls.ec_mul(bls.G1_GEN, 5), bls.G1_GEN, 6) == want


def test_pool_verdicts_are_the_pairing_checks():
    pool = make_pool(2 ** 31 + 9, 64, 1, 2, 4, 4, 2)
    want = G.expected_verdicts(pool)
    assert want.sum() == 6 and (~want == pool.bad).all()
    for i in (int(np.flatnonzero(pool.bad)[0]), int(np.flatnonzero(~pool.bad)[0])):
        sets, msgs, sig, domain = pool.items[i]
        assert sets[1] == [] and bls.verify(sets[0][0], msgs[0], sig, domain) == want[i]
        assert bls.privtopub(pool.sk0 + int(pool.validator[i])) == sets[0][0]
    assert G.spot_check(pool, rng_of(1, 2), 3, 1) == 0
    assert (G.control_verdicts(pool) != want).sum() == 2
