"""Networking model (port of consensus_specs_tpu/networking/): the
gossipsub router that carries attestations to the streaming firehose.
The message envelope, RPC and node-identity modules are still to port."""
from .gossip import (  # noqa: F401
    GOSSIPSUB_PROTOCOL_ID, GossipParams, GossipRouter, TOPIC_BEACON_ATTESTATION,
    TOPIC_BEACON_BLOCK, shard_attestation_topic, topic_hash)
