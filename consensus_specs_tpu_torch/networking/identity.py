"""Node identification: records, peer ids, multiaddrs (port of
consensus_specs_tpu/networking/identity.py).

Contract: the networking spec's node-identification.md:11-27 — nodes
advertise ENR-style records carrying at least (ip, tcp port, public key);
receivers MUST verify record signatures and the peer id is the SHA2-256
multihash of the public key. Port defaults to 9000.

Adaptation notes: EIP-778 signs records with secp256k1; this framework's
crypto stack is BLS12-381 (the only curve the protocol itself needs), so
records sign with the standard bls backend boundary (crypto/bls) over the
record's content digest — same verify-or-disconnect contract, no second
curve implementation hauled in for a transport detail. On the default
"torch" backend the signature and the pairing run on the card.

One departure from the reference: `verify` reads False for a missing,
malformed or wrong signature or key, as there, but an error of the card
(resilience/dispatch.py::is_device_fault) propagates: read as a bad
signature it would disconnect every peer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..crypto import bls
from ..resilience.dispatch import is_device_fault
from ..utils.hash import sha256

DEFAULT_TCP_PORT = 9000
ENR_SIGNING_DOMAIN = 0x454E52   # "ENR"

_MULTIHASH_SHA256 = bytes([0x12, 0x20])   # sha2-256, 32 bytes


@dataclass
class NodeRecord:
    """The addressable identity a node gossips about itself."""
    ip: str
    pubkey: bytes                      # BLS public key (48 bytes)
    tcp_port: int = DEFAULT_TCP_PORT
    udp_port: Optional[int] = None     # discv5 side-channel
    seq: int = 0                       # record sequence number (EIP-778 semantics)
    signature: bytes = field(default=b"", repr=False)

    def content_digest(self) -> bytes:
        parts = [
            self.ip.encode(),
            int(self.tcp_port).to_bytes(2, "little"),
            int(self.udp_port or 0).to_bytes(2, "little"),
            int(self.seq).to_bytes(8, "little"),
            bytes(self.pubkey),
        ]
        return sha256(b"\x00".join(parts))

    def sign(self, privkey: int) -> "NodeRecord":
        self.signature = bls.bls_sign(
            self.content_digest(), privkey, ENR_SIGNING_DOMAIN)
        return self

    def verify(self) -> bool:
        """MUST-verify gate: a False here means disconnect the peer."""
        if not self.signature:
            return False
        try:
            return bls.bls_verify(bytes(self.pubkey), self.content_digest(),
                                  bytes(self.signature), ENR_SIGNING_DOMAIN)
        except Exception as exc:
            if is_device_fault(exc):
                raise
            return False


def peer_id(pubkey: bytes) -> bytes:
    """SHA2-256 multihash of the public key (node-identification.md:23-25)."""
    return _MULTIHASH_SHA256 + sha256(bytes(pubkey))


def multiaddr(record: NodeRecord) -> str:
    """The libp2p dial address derivable from a record's keys."""
    return f"/ip4/{record.ip}/tcp/{record.tcp_port}/p2p/{peer_id(record.pubkey).hex()}"
