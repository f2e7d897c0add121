"""Deterministic test keypairs: privkey = index + 1.

Capability parity: consensus-specs test_libs/pyspec/eth2spec/test/helpers/keys.py.
Pubkeys derive from our own BLS ground truth (py_ecc is not present); derived
lazily and grown on demand so the minimal preset doesn't pay for 1024 keys.
"""
from __future__ import annotations

from typing import Dict, List

from ..crypto.bls12_381 import privtopub


class _KeyStore:
    def __init__(self):
        self._privkeys: List[int] = []
        self._pubkeys: List[bytes] = []
        self._pub_to_priv: Dict[bytes, int] = {}

    def _ensure(self, n: int) -> None:
        while len(self._privkeys) < n:
            privkey = len(self._privkeys) + 1
            pubkey = privtopub(privkey)
            self._privkeys.append(privkey)
            self._pubkeys.append(pubkey)
            self._pub_to_priv[pubkey] = privkey

    def privkey(self, index: int) -> int:
        self._ensure(index + 1)
        return self._privkeys[index]

    def pubkey(self, index: int) -> bytes:
        self._ensure(index + 1)
        return self._pubkeys[index]

    def privkey_for_pubkey(self, pubkey: bytes) -> int:
        return self._pub_to_priv[bytes(pubkey)]


_store = _KeyStore()


class _LazySeq:
    """Indexable view over the growing keystore (privkeys[i] / pubkeys[i]).

    Unbounded and lazy, so negative indices and open-ended slices have no
    meaning — they raise instead of silently depending on generation order.
    """

    def __init__(self, getter):
        self._getter = getter

    def __getitem__(self, index):
        if isinstance(index, slice):
            if index.stop is None or (index.start or 0) < 0 or index.stop < 0:
                raise IndexError("lazy key sequence: slice needs explicit non-negative bounds")
            return [self._getter(i) for i in range(index.start or 0, index.stop, index.step or 1)]
        if index < 0:
            raise IndexError("lazy key sequence has no end; use an explicit index")
        return self._getter(index)


privkeys = _LazySeq(_store.privkey)
pubkeys = _LazySeq(_store.pubkey)


def pubkey_to_privkey(pubkey: bytes) -> int:
    return _store.privkey_for_pubkey(pubkey)
