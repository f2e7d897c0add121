"""RPC-over-stream protocol: wrappers, methods, dispatch, loopback transport
(port of consensus_specs_tpu/networking/rpc.py over the port's SSZ codec).

Contract: the networking spec's rpc-interface.md — protocol id
`/eth/serenity/beacon/rpc/1` (:36), request wrapper (id, method_id, body)
and response wrapper (id, response_code, result) (:40-56), JSON-RPC-2.0-
style id semantics with out-of-order responses allowed (:58-68), reserved
response codes (:76-85), and the method set: hello 0 (:92-117), goodbye 1
(:140-156), get_status 2 (:160-182), beacon_block_roots 10 (:186-208),
beacon_block_headers 11 (:210-240), beacon_block_bodies 12 (:244-264),
beacon_chain_state 13 (:268-285, wire format TBD upstream — reserved here).

Bodies are SSZ containers from the framework's own type system; the
request's union-typed `body` (:56) is modeled as method-id-tagged SSZ
bytes, which is exactly how a union discriminates on the wire. Transports
are injected; `loopback_pair` wires two nodes memory-to-memory for tests.

One departure from the reference: a handler may run on the card, and an
error of the card (resilience/dispatch.py::is_device_fault) propagates
out of `handle_wire` instead of becoming SERVER_ERROR. Python errors of a
handler still answer SERVER_ERROR, and malformed wires their parse codes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ..utils.ssz.impl import deserialize, serialize
from ..utils.ssz.typing import (
    Bytes32, Container, List as SSZList, uint8, uint16, uint64)
from ..resilience.dispatch import is_device_fault
from .messaging import decode_message, encode_message

RPC_PROTOCOL_ID = "/eth/serenity/beacon/rpc/1"

# Reserved response codes (:76-85)
OK = 0
PARSE_ERROR = 10
INVALID_REQUEST = 20
METHOD_NOT_FOUND = 30
SERVER_ERROR = 40

GOODBYE_SHUTDOWN = 1
GOODBYE_IRRELEVANT_NETWORK = 2
GOODBYE_FAULT = 3


# ---------------------------------------------------------------------------
# Wire wrappers (:40-56)
# ---------------------------------------------------------------------------

class Request(Container):
    id: uint64
    method_id: uint16
    body: bytes            # SSZ of the method's request container


class Response(Container):
    id: uint64
    response_code: uint16
    result: bytes          # SSZ of the method's response container (may be empty)


# ---------------------------------------------------------------------------
# Method bodies
# ---------------------------------------------------------------------------

class Hello(Container):                      # method 0 (:92-117)
    network_id: uint8
    chain_id: uint64
    latest_finalized_root: Bytes32
    latest_finalized_epoch: uint64
    best_root: Bytes32
    best_slot: uint64


class Goodbye(Container):                    # method 1 (:140-156)
    reason: uint64


class Status(Container):                     # method 2 (:160-182)
    sha: Bytes32
    user_agent: bytes
    timestamp: uint64


class BlockRootsRequest(Container):          # method 10 (:186-208)
    start_slot: uint64
    count: uint64


class BlockRootSlot(Container):
    block_root: Bytes32
    slot: uint64


class BlockRootsResponse(Container):
    roots: SSZList[BlockRootSlot]


class BlockHeadersRequest(Container):        # method 11 (:210-240)
    start_root: Bytes32
    start_slot: uint64
    max_headers: uint64
    skip_slots: uint64


class BlockHeadersResponse(Container):
    headers: bytes         # SSZ of List[BeaconBlockHeader] (preset-shaped spec type)


class BlockBodiesRequest(Container):         # method 12 (:244-264)
    block_roots: SSZList[Bytes32]


class BlockBodiesResponse(Container):
    block_bodies: bytes    # SSZ of List[BeaconBlockBody] (preset-shaped spec type)


MAX_BLOCK_ROOTS_COUNT = 32768   # (:208)

HELLO, GOODBYE, GET_STATUS = 0, 1, 2
BEACON_BLOCK_ROOTS, BEACON_BLOCK_HEADERS, BEACON_BLOCK_BODIES = 10, 11, 12
BEACON_CHAIN_STATE = 13         # wire format TBD upstream; id reserved

METHOD_TYPES: Dict[int, Tuple[type, Optional[type]]] = {
    HELLO: (Hello, Hello),
    GOODBYE: (Goodbye, None),
    GET_STATUS: (Status, Status),
    BEACON_BLOCK_ROOTS: (BlockRootsRequest, BlockRootsResponse),
    BEACON_BLOCK_HEADERS: (BlockHeadersRequest, BlockHeadersResponse),
    BEACON_BLOCK_BODIES: (BlockBodiesRequest, BlockBodiesResponse),
}


class RpcError(Exception):
    def __init__(self, code: int, message: str = ""):
        super().__init__(message or f"rpc error {code}")
        self.code = code


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------

class RpcNode:
    """One endpoint of the RPC protocol.

    Handlers are `fn(request_container) -> response_container | None`;
    `call` sends a request through the attached transport and returns the
    decoded response container (or raises RpcError with the peer's code).
    Ids are per-connection monotonic (:62-64); responses match on id, so a
    transport MAY deliver them out of order (:66-68)."""

    def __init__(self, name: str = "node"):
        self.name = name
        self._handlers: Dict[int, Callable[[Any], Any]] = {}
        self._types: Dict[int, Tuple[Optional[type], Optional[type]]] = \
            dict(METHOD_TYPES)
        self._send: Optional[Callable[[bytes], bytes]] = None
        self._next_id = 0
        self.said_goodbye: Optional[int] = None

        # built-in: goodbye just records the reason (:150-156)
        def _on_goodbye(body: Goodbye):
            self.said_goodbye = int(body.reason)
            return None
        self._handlers[GOODBYE] = _on_goodbye

    def register(self, method_id: int, handler: Callable[[Any], Any],
                 req_type: Optional[type] = None,
                 resp_type: Optional[type] = None) -> None:
        """Attach a handler; for method ids outside METHOD_TYPES (custom or
        reserved ones like BEACON_CHAIN_STATE) pass the body/result
        container types here — without them the handler receives raw bytes
        and must return raw bytes (the union stays untyped on this node)."""
        self._handlers[method_id] = handler
        if req_type is not None or resp_type is not None:
            self._types[method_id] = (req_type, resp_type)
        else:
            # registering with no types marks the method as known-but-
            # untyped on this node: bodies/results travel as raw bytes
            self._types.setdefault(method_id, (None, None))

    def attach(self, send: Callable[[bytes], bytes]) -> None:
        """send(wire_request_bytes) -> wire_response_bytes."""
        self._send = send

    # -- client side --------------------------------------------------------

    def call(self, method_id: int, body: Any) -> Any:
        assert self._send is not None, "no transport attached"
        if method_id not in self._types:
            raise RpcError(METHOD_NOT_FOUND,
                           f"no body types known for method {method_id}; "
                           "register(..., req_type=, resp_type=) first")
        req_type, resp_type = self._types[method_id]
        if req_type is None:
            body_bytes = bytes(body)
        else:
            assert isinstance(body, req_type), f"body must be {req_type.__name__}"
            body_bytes = serialize(body, req_type)
        req_id = self._next_id
        self._next_id += 1
        wire = encode_message(serialize(
            Request(id=req_id, method_id=method_id, body=body_bytes), Request))
        _, _, resp_bytes = decode_message(self._send(wire))
        resp = deserialize(resp_bytes, Response)
        if int(resp.id) != req_id:
            raise RpcError(INVALID_REQUEST, "response id mismatch")
        if int(resp.response_code) != OK:
            raise RpcError(int(resp.response_code))
        if resp_type is None:
            return bytes(resp.result) or None
        return deserialize(bytes(resp.result), resp_type)

    # -- server side --------------------------------------------------------

    def handle_wire(self, data: bytes) -> bytes:
        """Decode request -> dispatch -> encoded response. Error paths map
        to the reserved response codes; malformed ids echo 0."""
        req_id = 0
        try:
            _, _, payload = decode_message(data)
            req = deserialize(payload, Request)
            req_id = int(req.id)
        except Exception:
            return self._respond(req_id, PARSE_ERROR, b"")
        method = int(req.method_id)
        if method not in self._handlers:
            return self._respond(req_id, METHOD_NOT_FOUND, b"")
        req_type, resp_type = self._types.get(method, (None, None))
        try:
            body = (deserialize(bytes(req.body), req_type)
                    if req_type is not None else bytes(req.body))
        except Exception:
            return self._respond(req_id, INVALID_REQUEST, b"")
        try:
            result = self._handlers[method](body)
            if result is None:
                out = b""
            elif resp_type is None:
                out = bytes(result)   # untyped method: handler returns bytes
            else:
                out = serialize(result, resp_type)
        except RpcError as err:
            return self._respond(req_id, err.code, b"")
        except Exception as exc:
            if is_device_fault(exc):
                raise
            return self._respond(req_id, SERVER_ERROR, b"")
        return self._respond(req_id, OK, out)

    @staticmethod
    def _respond(req_id: int, code: int, result: bytes) -> bytes:
        return encode_message(serialize(
            Response(id=req_id, response_code=code, result=result), Response))


def loopback_pair(a_name: str = "a", b_name: str = "b") -> Tuple[RpcNode, RpcNode]:
    """Two nodes wired memory-to-memory: a.call() dispatches on b and vice
    versa — the in-process transport the test corpus drives."""
    a, b = RpcNode(a_name), RpcNode(b_name)
    a.attach(b.handle_wire)
    b.attach(a.handle_wire)
    return a, b


# ---------------------------------------------------------------------------
# Handshake policy (:119-138)
# ---------------------------------------------------------------------------

def should_disconnect(mine: Hello, theirs: Hello,
                      my_root_at_epoch: Callable[[int], Optional[bytes]]) -> bool:
    """The two SHOULD-disconnect conditions after the hello exchange:
    different network, or the peer's finalized root not being our chain's
    root at that epoch (my_root_at_epoch -> None when unknown)."""
    if int(theirs.network_id) != int(mine.network_id):
        return True
    known = my_root_at_epoch(int(theirs.latest_finalized_epoch))
    if known is not None and bytes(known) != bytes(theirs.latest_finalized_root):
        return True
    return False
