"""Seeded pool of single-signer gossip attestations, signed with the
reference's bignum BLS (benchmark/reference/bls12_381.py).

A pool holds `slots` slots of `committees` committees of `size` distinct
validators each; every member signs its committee's message (the honest
majority's vote), and a seeded `1 / bad_one_in` of the attestations carry
another member's signature instead of their own. An attestation is a
phase-0 indexed verification item: a custody-bit-0 set of one key, an
empty custody-bit-1 set, the two message hashes, the signature and the
domain, so it stages to two pairs.

Keys run in an arithmetic progression over the validator index
(sk_v = sk_0 + v), and a committee is a run of consecutive validators, so
each next pubkey is one point addition of G1 to the last and each next
signature one addition of H(message): a pool costs one hash to G2 and two
scalar multiplications a committee, and one addition in each group an
attestation.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from . import curve, rng_of
from ..reference import bls12_381 as bls


class Pool(NamedTuple):
    items: List[tuple]        # (pubkey_sets, message_hashes, signature, domain)
    slot_of: np.ndarray       # [n] slot of each item
    validator: np.ndarray     # [n] validator index of each item's key
    committee: np.ndarray     # [n] global committee index (slot * committees + c)
    honest: List[bytes]       # [n] each key's own signature on its message
    hashes: list              # [slots * committees] H(message) points
    bad: np.ndarray           # [n] bool: the item carries another signature
    sk0: int


def make_pool(seed: int, validators: int, slots: int, committees: int, size: int,
              bad_one_in: int, domain: int) -> Pool:
    rng = rng_of(seed, 1)
    total = slots * committees * size
    if total > validators:
        raise ValueError(f"a pool of {total} attestations needs {total} distinct "
                         f"validators; the registry has {validators}")
    sk0 = int.from_bytes(rng.bytes(32), "big") % (bls.r - validators - 1) + 1
    first = int(rng.integers(0, validators - total + 1))
    items, honest, hashes = [], [], []
    slot_of, vidx, comm = [], [], []
    bad = np.zeros(total, bool)
    bad[rng.choice(total, total // bad_one_in, replace=False)] = True
    for k in range(slots * committees):
        m0, m1 = rng.bytes(32), rng.bytes(32)
        h = curve.hash_to_g2(m0, domain)
        hashes.append(h)
        v0 = first + k * size
        pks = curve.progression(curve.mul(bls.G1_GEN, sk0 + v0), bls.G1_GEN, size)
        sigs = [bls.compress_g2(s) for s in
                curve.progression(curve.mul(h, sk0 + v0), h, size)]
        for j in range(size):
            i = len(items)
            own = sigs[j]
            honest.append(own)
            items.append(([[bls.compress_g1(pks[j])], []], [m0, m1],
                          sigs[(j + 1) % size] if bad[i] else own, domain))
            slot_of.append(k // committees)
            vidx.append(v0 + j)
            comm.append(k)
    return Pool(items, np.array(slot_of), np.array(vidx), np.array(comm), honest,
                hashes, bad, sk0)
