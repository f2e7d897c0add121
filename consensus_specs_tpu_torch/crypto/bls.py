"""BLS12-381 signature boundary with switchable backends (port of
consensus_specs_tpu/crypto/bls.py).

Five spec-facing functions behind a global on/off switch: when
`bls_active` is False every verify returns True and sign returns a stub,
the mode unit tests run in. The active path calls the selected backend.
The default backend is "torch", ops/bls_torch.py::TorchBackend on
"cuda" (it raises without a card). "python" is the bignum oracle of
crypto/bls12_381.py (PythonBackend, about a second a verify on the host):
it runs only where a caller names it with `set_backend("python")`, never
as a fallback. `register_backend` adds others, such as a TorchBackend on
the CPU for the tests.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

bls_active = True

STUB_SIGNATURE = b"\x11" * 96
STUB_PUBKEY = b"\x22" * 48


class _Backend:
    """A BLS implementation: point aggregation + pairing checks + signing."""

    def verify(self, pubkey: bytes, message_hash: bytes, signature: bytes, domain: int) -> bool:
        raise NotImplementedError

    def verify_multiple(self, pubkeys: Sequence[bytes], message_hashes: Sequence[bytes],
                        signature: bytes, domain: int) -> bool:
        raise NotImplementedError

    def aggregate_pubkeys(self, pubkeys: Sequence[bytes]) -> bytes:
        raise NotImplementedError

    def aggregate_signatures(self, signatures: Sequence[bytes]) -> bytes:
        raise NotImplementedError

    def sign(self, message_hash: bytes, privkey: int, domain: int) -> bytes:
        raise NotImplementedError


_backends: Dict[str, Callable[[], _Backend]] = {}
_active_backend_name = "torch"
_backend_cache: Dict[str, _Backend] = {}


def register_backend(name: str, factory: Callable[[], _Backend]) -> None:
    _backends[name] = factory


def set_backend(name: str) -> None:
    global _active_backend_name
    if name not in _backends:
        raise KeyError(f"unknown BLS backend {name!r}; registered: {sorted(_backends)}")
    if name not in _backend_cache:
        # instantiate now so a missing/broken backend fails at selection time
        _backend_cache[name] = _backends[name]()
    _active_backend_name = name


def get_backend() -> _Backend:
    name = _active_backend_name
    if name not in _backend_cache:
        _backend_cache[name] = _backends[name]()
    return _backend_cache[name]


def _register_builtin_backends() -> None:
    def torch_factory() -> _Backend:
        from ..ops.bls_torch import TorchBackend
        return TorchBackend(device="cuda")

    def python_factory() -> _Backend:
        from . import bls12_381
        return bls12_381.PythonBackend()

    register_backend("torch", torch_factory)
    register_backend("python", python_factory)


_register_builtin_backends()


# ---------------------------------------------------------------------------
# The five spec-facing functions
# ---------------------------------------------------------------------------

def bls_verify(pubkey: bytes, message_hash: bytes, signature: bytes, domain: int) -> bool:
    if not bls_active:
        return True
    return get_backend().verify(bytes(pubkey), bytes(message_hash), bytes(signature), int(domain))


def bls_verify_multiple(pubkeys: Sequence[bytes], message_hashes: Sequence[bytes],
                        signature: bytes, domain: int) -> bool:
    if not bls_active:
        return True
    return get_backend().verify_multiple(
        [bytes(p) for p in pubkeys], [bytes(m) for m in message_hashes], bytes(signature), int(domain))


def bls_aggregate_pubkeys(pubkeys: Sequence[bytes]) -> bytes:
    if not bls_active:
        return STUB_PUBKEY
    return get_backend().aggregate_pubkeys([bytes(p) for p in pubkeys])


def bls_aggregate_signatures(signatures: Sequence[bytes]) -> bytes:
    if not bls_active:
        return STUB_SIGNATURE
    return get_backend().aggregate_signatures([bytes(s) for s in signatures])


def bls_sign(message_hash: bytes, privkey: int, domain: int) -> bytes:
    if not bls_active:
        return STUB_SIGNATURE
    return get_backend().sign(bytes(message_hash), int(privkey), int(domain))
