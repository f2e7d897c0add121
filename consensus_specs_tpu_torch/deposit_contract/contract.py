"""Incremental deposit Merkle accumulator (the on-chain algorithm; port of
consensus_specs_tpu/deposit_contract/contract.py).

The contract keeps O(log n) state: one `branch` node per tree level plus a
counter. Each deposit leaf is the SSZ hash_tree_root of its DepositData —
computed here exactly the way the EVM code hand-rolls it (pubkey padded to
two chunks, signature as a three-chunk subtree, amount as a little-endian
64-bit chunk) so the differential test against the framework's generic SSZ
Merkleizer proves both sides agree byte-for-byte (the upstream contract's
tests/contracts/test_deposit.py does the same cross-check against pyspec).

The contract itself is host code over utils/hash.py. `deposit_data_roots`
is the port's batch of the same leaves on a device: every message of the
fixed chunk shapes is 64 bytes, so each of its four levels is one pair
hash, on the card one launch of csrc/sha256_pairs.cu.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve
from ..ops.sha256 import bytes_to_words, pair_hash_words, words_tensor, words_to_bytes
from ..utils.hash import sha256

TREE_DEPTH = 32
MIN_DEPOSIT_GWEI = 1_000_000_000
FULL_DEPOSIT_GWEI = 32_000_000_000
CHAIN_START_FULL_DEPOSIT_THRESHOLD = 2 ** 16
SECONDS_PER_DAY = 86_400
MAX_DEPOSIT_COUNT = 2 ** TREE_DEPTH - 1


def _le64(value: int) -> bytes:
    assert 0 <= value < 2 ** 64
    return value.to_bytes(8, "little")


def deposit_data_root(pubkey: bytes, withdrawal_credentials: bytes,
                      amount_gwei: int, signature: bytes) -> bytes:
    """hash_tree_root(DepositData) the way the contract computes it:
    fixed-shape chunk tree, no generic SSZ machinery on chain."""
    pubkey_root = sha256(pubkey + b"\x00" * 16)
    signature_root = sha256(
        sha256(signature[:64])
        + sha256(signature[64:96] + b"\x00" * 32)
    )
    return sha256(
        sha256(pubkey_root + withdrawal_credentials)
        + sha256(_le64(amount_gwei) + b"\x00" * 24 + signature_root)
    )


def deposit_data_roots(pubkeys: np.ndarray, withdrawal_credentials: np.ndarray,
                       amounts_gwei: np.ndarray, signatures: np.ndarray,
                       device="cuda") -> np.ndarray:
    """[n, 32] uint8: `deposit_data_root` of n deposits, given as columns
    [n, 48] / [n, 32] uint8, [n] uint64, [n, 96] uint8, hashed on
    `device` in four pair-hash calls: (the padded pubkey, the signature's
    two 64-byte halves), the signature root, (pubkey root + credentials,
    amount chunk + signature root), the leaf."""
    dev = resolve(device)
    n = pubkeys.shape[0]
    pk = np.zeros((n, 64), np.uint8)
    pk[:, :48] = pubkeys
    sig = np.zeros((n, 128), np.uint8)
    sig[:, :96] = signatures
    amount = np.zeros((n, 32), np.uint8)
    amount[:, :8] = np.ascontiguousarray(amounts_gwei, dtype="<u8").view(
        np.uint8).reshape(n, 8)

    def words(a):
        return words_tensor(bytes_to_words(a), dev)

    first = pair_hash_words(torch.cat([words(pk), words(sig).reshape(2 * n, 16)]))
    sig_root = pair_hash_words(first[n:].reshape(n, 16))
    halves = pair_hash_words(torch.cat([
        torch.cat([first[:n], words(np.ascontiguousarray(withdrawal_credentials, np.uint8))], 1),
        torch.cat([words(amount), sig_root], 1)]))
    return words_to_bytes(pair_hash_words(torch.cat([halves[:n], halves[n:]], 1)))


@dataclass
class DepositEvent:
    pubkey: bytes
    withdrawal_credentials: bytes
    amount: bytes            # little-endian 8 bytes, as logged on chain
    signature: bytes
    merkle_tree_index: bytes


@dataclass
class Eth2GenesisEvent:
    deposit_root: bytes
    deposit_count: bytes
    time: bytes


class DepositContract:
    """The registration contract's state machine."""

    def __init__(self):
        self._zerohashes: List[bytes] = [b"\x00" * 32]
        for _ in range(TREE_DEPTH - 1):
            self._zerohashes.append(
                sha256(self._zerohashes[-1] + self._zerohashes[-1]))
        self._branch: List[bytes] = [b"\x00" * 32] * TREE_DEPTH
        self.deposit_count = 0
        self.full_deposit_count = 0
        self.chain_started = False
        self.logs: List[object] = []

    # -- views --------------------------------------------------------------

    def get_deposit_root(self) -> bytes:
        node = b"\x00" * 32
        size = self.deposit_count
        for level in range(TREE_DEPTH):
            if size & 1:
                node = sha256(self._branch[level] + node)
            else:
                node = sha256(node + self._zerohashes[level])
            size >>= 1
        return node

    def get_deposit_count(self) -> bytes:
        return _le64(self.deposit_count)

    # -- transactions -------------------------------------------------------

    def deposit(self, pubkey: bytes, withdrawal_credentials: bytes,
                signature: bytes, value_gwei: int,
                timestamp: int = 0) -> Optional[Eth2GenesisEvent]:
        assert self.deposit_count < MAX_DEPOSIT_COUNT
        assert len(pubkey) == 48
        assert len(withdrawal_credentials) == 32
        assert len(signature) == 96
        assert value_gwei >= MIN_DEPOSIT_GWEI

        index = self.deposit_count
        leaf = deposit_data_root(pubkey, withdrawal_credentials, value_gwei,
                                 signature)

        # fold the new leaf into the branch: climb while the subtree at
        # each level is complete (trailing-one positions of index+1)
        node = leaf
        size = index + 1
        level = 0
        while size & 1 == 0:
            node = sha256(self._branch[level] + node)
            size >>= 1
            level += 1
        self._branch[level] = node

        self.deposit_count += 1
        self.logs.append(DepositEvent(
            pubkey=pubkey,
            withdrawal_credentials=withdrawal_credentials,
            amount=_le64(value_gwei),
            signature=signature,
            merkle_tree_index=_le64(index),
        ))

        if value_gwei >= FULL_DEPOSIT_GWEI:
            self.full_deposit_count += 1
            if self.full_deposit_count == CHAIN_START_FULL_DEPOSIT_THRESHOLD:
                boundary = (timestamp - timestamp % SECONDS_PER_DAY
                            + 2 * SECONDS_PER_DAY)
                event = Eth2GenesisEvent(
                    deposit_root=self.get_deposit_root(),
                    deposit_count=_le64(self.deposit_count),
                    time=_le64(boundary),
                )
                self.logs.append(event)
                self.chain_started = True
                return event
        return None
