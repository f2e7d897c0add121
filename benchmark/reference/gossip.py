"""The verdicts a pool of gossip attestations must get, worked out with
the reference's bignum BLS (benchmark/reference/bls12_381.py).

A single-signer attestation verifies iff its signature is its key's
signature on its message: with pk = sk G1, e(pk, H(m)) = e(G1, sig) holds
exactly when sig = sk H(m), since the pairing is non-degenerate on these
prime-order groups. So the verdict of item i is whether its signature's
bytes equal the compressed sk_i H(m_i). The pool's generator produced
those points by additions along the key progression; `spot_check`
recomputes a seeded sample of them by scalar multiplication, and runs the
pairing check itself (`verify`) on a few items, so each run ties the
verdicts to the scheme's own definition.
"""
from __future__ import annotations

import numpy as np

from . import bls12_381 as bls


def expected_verdicts(pool) -> np.ndarray:
    """[n] bool: each item's signature is its own key's."""
    return np.array([item[2] == own for item, own in zip(pool.items, pool.honest)])


def control_verdicts(pool) -> np.ndarray:
    """The control: the same items with the signature check left out, so
    any well-formed compressed signature passes (another member's
    included)."""
    return np.array([len(item[2]) == 96 and item[2][0] & 0x80 != 0
                     for item in pool.items])


def spot_check(pool, rng, n_mul: int, n_pairing: int) -> int:
    """Items of a seeded sample whose verdict the definition contradicts:
    n_mul items by scalar multiplication sk H(m) against the pool's
    signatures, n_pairing items (one carrying another's signature where
    the pool has one) by the pairing check itself."""
    want = expected_verdicts(pool)
    n = len(pool.items)
    wrong = 0
    for i in rng.choice(n, min(n_mul, n), replace=False):
        h = pool.hashes[int(pool.committee[i])]
        own = bls.compress_g2(bls.ec_mul(h, pool.sk0 + int(pool.validator[i])))
        wrong += int((pool.items[i][2] == own) != want[i])
    bad = np.flatnonzero(pool.bad)
    picks = list(rng.choice(bad, min(1, bad.size, n_pairing), replace=False))
    picks += list(rng.choice(n, max(0, n_pairing - len(picks)), replace=False))
    for i in picks:
        sets, msgs, sig, domain = pool.items[i]
        wrong += int(bls.verify(sets[0][0], msgs[0], sig, domain) != want[i])
    return wrong
