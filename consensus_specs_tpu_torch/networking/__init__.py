"""Executable model of the Eth 2.0 networking specs (port of
consensus_specs_tpu/networking/):

- messaging.py   — message envelope codec (messaging.md:21-45)
- rpc.py         — RPC-over-stream request/response protocol + methods
  (rpc-interface.md:36-285)
- gossip.py      — gossipsub parameters, topics, in-process router; it
  carries attestations to the streaming firehose
  (libp2p-standardization.md:72-158)
- identity.py    — node records, peer ids, multiaddrs; records sign and
  verify through crypto/bls (node-identification.md:11-27)

No sockets: transport is an injectable byte-pipe abstraction. The codecs
are host code; a handler, a subscriber or a record's verify may run on
the card, and an error of the card propagates out of each of them
(resilience/dispatch.py::is_device_fault).
"""
from .messaging import (  # noqa: F401
    COMPRESSION_NONE, ENCODING_SSZ, MessageEnvelopeError, decode_message,
    encode_message)
from .identity import NodeRecord, multiaddr, peer_id  # noqa: F401
from .gossip import (  # noqa: F401
    GOSSIPSUB_PROTOCOL_ID, GossipParams, GossipRouter, TOPIC_BEACON_ATTESTATION,
    TOPIC_BEACON_BLOCK, shard_attestation_topic, topic_hash)
from .rpc import (  # noqa: F401
    RPC_PROTOCOL_ID, Goodbye, Hello, RpcError, RpcNode, loopback_pair)
