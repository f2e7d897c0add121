"""Gossipsub model: parameters, topics, and an in-process router (copy of
consensus_specs_tpu/networking/gossip.py over the port's utils/hash.py).

Contract: the networking spec's libp2p-standardization.md:72-158:
the standardized mesh parameters (:86-105), the `beacon_block` /
`beacon_attestation` topics plus per-shard-subnet attestation topics
(:109-127), SHA2-256 topic hashes (:107-108), SSZ message payloads with a
512 KB cap (:131-139).

The router is deliberately transport-free: nodes subscribe handlers and
publish SSZ bytes; propagation is synchronous, deduplicated by message
digest (gossipsub's seen-cache), and capped at the spec's message size.
It is the multi-node test backend — the same role the minimal preset plays
for state-transition tests (SURVEY.md §4 "the minimal preset is the fake
backend").

One departure from the reference: a subscriber that fails is counted in
`handler_failures` and the sweep goes on, except for an error of the card
(resilience/dispatch.py::is_device_fault), which propagates out of
`publish` (the message is un-marked as seen, as for any escape).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Set, Tuple

from ..resilience.dispatch import is_device_fault
from ..utils.hash import sha256

GOSSIPSUB_PROTOCOL_ID = "/eth/serenity/gossipsub/1.0.0"

TOPIC_BEACON_BLOCK = "beacon_block"
TOPIC_BEACON_ATTESTATION = "beacon_attestation"

MAX_GOSSIP_MESSAGE_BYTES = 512 * 1024


@dataclass(frozen=True)
class GossipParams:
    """Standardized mesh parameters (libp2p-standardization.md:86-105)."""
    mesh_size: int = 6        # D
    mesh_lo: int = 4          # D_lo
    mesh_high: int = 12       # D_high
    gossip_lazy: int = 6      # D_lazy
    fanout_ttl: int = 60      # seconds
    gossip_history: int = 3   # heartbeats
    heartbeat_interval: int = 1  # seconds


def shard_attestation_topic(shard: int, shard_subnet_count: int) -> str:
    """`shard{shard % SHARD_SUBNET_COUNT}_attestation` (:123-127)."""
    return f"shard{shard % shard_subnet_count}_attestation"


def topic_hash(topic: str) -> bytes:
    """Topics travel as SHA2-256 hashes of the topic string (:107-108)."""
    return sha256(topic.encode())


class GossipRouter:
    """In-process pubsub fabric shared by a set of model nodes.

    subscribe() registers (node, handler) on a topic; publish() delivers the
    payload to every OTHER subscriber exactly once per unique message
    (seen-cache dedup — re-publishing an already-seen message, as a
    forwarding node would, is a no-op)."""

    def __init__(self, params: GossipParams = GossipParams()):
        self.params = params
        self._subs: Dict[bytes, List[Tuple[str, Callable[[str, bytes], None]]]] = {}
        self._seen: Set[bytes] = set()
        self.delivered = 0   # observability: total handler invocations
        self.dropped_oversize = 0
        self.handler_failures = 0

    def subscribe(self, node_id: str, topic: str,
                  handler: Callable[[str, bytes], None]) -> None:
        self._subs.setdefault(topic_hash(topic), []).append((node_id, handler))

    def publish(self, node_id: str, topic: str, payload: bytes) -> int:
        """-> number of peers the message reached (0 if duplicate/oversize —
        oversize messages are dropped, as a gossipsub router would drop
        them, and counted in dropped_oversize)."""
        if len(payload) > MAX_GOSSIP_MESSAGE_BYTES:
            self.dropped_oversize += 1
            return 0
        digest = sha256(topic_hash(topic) + payload)
        if digest in self._seen:
            return 0
        # mark seen BEFORE the delivery sweep: a handler that synchronously
        # republishes the same message (the forwarding pattern) must hit the
        # duplicate check, not re-enter a nested sweep. If the sweep itself
        # escapes (a device fault in a handler), un-mark so a
        # half-delivered message is not permanently blacklisted.
        self._seen.add(digest)
        reached = 0
        try:
            for sub_id, handler in self._subs.get(topic_hash(topic), []):
                if sub_id == node_id:
                    continue
                try:
                    handler(topic, payload)
                    reached += 1
                except Exception as exc:
                    # a peer's handler failing is that peer's problem:
                    # delivery to the others proceeds, observably counted;
                    # a fault of the card is everyone's, and propagates
                    if is_device_fault(exc):
                        raise
                    self.handler_failures += 1
        except BaseException:
            self._seen.discard(digest)
            raise
        self.delivered += reached
        return reached
