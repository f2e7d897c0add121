"""The port's networking (consensus_specs_tpu_torch.networking) == the JAX
package's, case for case of tests/test_networking.py: the same inputs
through both packages, every wire, code, digest and signature equal byte
for byte.

RPC wires are recorded at the transport: a recording loopback pair holds
each request and response of the port against the reference's. Node
records sign and verify on the bignum "python" backend of both packages
(tests/_bls_backend.py). Then the port's one departure: an error of the
card raised in an RPC handler, a record's verify or a gossip subscriber
propagates (resilience/dispatch.py::is_device_fault), while Python errors
and malformed input keep the reference's codes and verdicts."""
import pytest

from consensus_specs_tpu import networking as JN
from consensus_specs_tpu.networking import messaging as JM
from consensus_specs_tpu.networking import rpc as JR
from consensus_specs_tpu.testing.keys import privkeys, pubkeys
from consensus_specs_tpu.utils.ssz import impl as JSSZ
from consensus_specs_tpu_torch import networking as PN
from consensus_specs_tpu_torch.crypto import bls as PBLS
from consensus_specs_tpu_torch.networking import messaging as PM
from consensus_specs_tpu_torch.networking import rpc as PR
from consensus_specs_tpu_torch.resilience.dispatch import is_device_fault
from consensus_specs_tpu_torch.utils.ssz import impl as PSSZ

from _bls_backend import python_bls  # noqa: F401
from _release_jax import release_jax_programs, torch_one_thread  # noqa: F401 (autouse)

SIDES = ((JN, JM, JR), (PN, PM, PR))
CUDA_FAULT = "CUDA error: an illegal memory access was encountered"


def _both(fn):
    """fn(networking, messaging, rpc) on the reference and on the port."""
    return [fn(*side) for side in SIDES]


def _recorded_pair(N, R):
    """loopback_pair whose transport records (request, response) wires."""
    a, b = N.loopback_pair()
    wires = []

    def via(dst):
        def send(data):
            out = dst.handle_wire(data)
            wires.append((data, out))
            return out
        return send
    a.attach(via(b))
    b.attach(via(a))
    return a, b, wires


def _raises(fn, exc):
    with pytest.raises(exc) as err:
        fn()
    return type(err.value).__name__, str(err.value), getattr(err.value, "code", None)


# ---------------------------------------------------------------------------
# Envelope
# ---------------------------------------------------------------------------

def test_envelope_roundtrip():
    body = b"\x01\x02\x03" * 100
    wire_j, wire_p = _both(lambda N, M, R: M.encode_message(body))
    assert wire_p == wire_j
    assert PM.decode_message(wire_p) == JM.decode_message(wire_j) \
        == (PM.COMPRESSION_NONE, PM.ENCODING_SSZ, body)
    assert (PM.COMPRESSION_NONE, PM.ENCODING_SSZ, PM.TCP_PREFIX) == \
        (JM.COMPRESSION_NONE, JM.ENCODING_SSZ, JM.TCP_PREFIX)
    assert _raises(lambda: PM.encode_message(b"", compression=16), ValueError) == \
        _raises(lambda: JM.encode_message(b"", compression=16), ValueError)


@pytest.mark.parametrize("mutate", [
    lambda w: w[:5],                                   # short header
    lambda w: bytes([0x12]) + w[1:],                   # unknown compression
    lambda w: bytes([0x02]) + w[1:],                   # unknown encoding
    lambda w: w[:-1],                                  # truncated body
    lambda w: w + b"\x00",                             # trailing junk
], ids=["short", "compression", "encoding", "truncated", "trailing"])
def test_malformed_envelopes_are_ignorable(mutate):
    wire = mutate(JM.encode_message(b"payload"))
    got_j, got_p = _both(lambda N, M, R: _raises(
        lambda: M.decode_message(wire), M.MessageEnvelopeError))
    assert got_p == got_j
    assert issubclass(PM.MessageEnvelopeError, ValueError)


def test_tcp_prefix():
    framed_j, framed_p = _both(lambda N, M, R: M.frame_tcp(M.encode_message(b"x")))
    assert framed_p == framed_j and framed_p[:3] == bytes.fromhex("455448")
    assert PM.unframe_tcp(framed_p) == JM.unframe_tcp(framed_j)
    assert _raises(lambda: PM.unframe_tcp(b"BTC" + b"rest"), PM.MessageEnvelopeError) \
        == _raises(lambda: JM.unframe_tcp(b"BTC" + b"rest"), JM.MessageEnvelopeError)


# ---------------------------------------------------------------------------
# RPC
# ---------------------------------------------------------------------------

def _hello(R, net=1, slot=64):
    return R.Hello(network_id=net, chain_id=1,
                   latest_finalized_root=b"\x0a" * 32,
                   latest_finalized_epoch=2,
                   best_root=b"\x0b" * 32, best_slot=slot)


def test_constants_and_method_table():
    for name in ("RPC_PROTOCOL_ID", "OK", "PARSE_ERROR", "INVALID_REQUEST",
                 "METHOD_NOT_FOUND", "SERVER_ERROR", "GOODBYE_SHUTDOWN",
                 "GOODBYE_IRRELEVANT_NETWORK", "GOODBYE_FAULT",
                 "MAX_BLOCK_ROOTS_COUNT", "HELLO", "GOODBYE", "GET_STATUS",
                 "BEACON_BLOCK_ROOTS", "BEACON_BLOCK_HEADERS",
                 "BEACON_BLOCK_BODIES", "BEACON_CHAIN_STATE"):
        assert getattr(PR, name) == getattr(JR, name), name
    table = {m: tuple(t and t.__name__ for t in ts) for m, ts in JR.METHOD_TYPES.items()}
    assert {m: tuple(t and t.__name__ for t in ts)
            for m, ts in PR.METHOD_TYPES.items()} == table


def test_hello_exchange_and_id_matching():
    def run(N, M, R):
        a, b, wires = _recorded_pair(N, R)
        b.register(R.HELLO, lambda h: _hello(R, net=1, slot=128))
        first = a.call(R.HELLO, _hello(R))
        second = a.call(R.HELLO, _hello(R))
        return (JSSZ.serialize(first, JR.Hello) if R is JR else
                PSSZ.serialize(first, PR.Hello)), int(second.best_slot), a._next_id, wires
    (hj, sj, nj, wj), (hp, sp, np_, wp) = _both(run)
    assert (hp, sp, np_) == (hj, sj, nj) and sp == 128 and np_ == 2
    assert wp == wj and len(wp) == 2


def test_goodbye_records_reason_and_returns_empty():
    def run(N, M, R):
        a, b, wires = _recorded_pair(N, R)
        return a.call(R.GOODBYE, R.Goodbye(reason=2)), b.said_goodbye, wires
    got_j, got_p = _both(run)
    assert got_p == got_j and got_p[:2] == (None, 2)


def test_method_not_found_code():
    def run(N, M, R):
        a, _, wires = _recorded_pair(N, R)
        got = _raises(lambda: a.call(R.BEACON_BLOCK_ROOTS,
                                     R.BlockRootsRequest(start_slot=0, count=10)),
                      R.RpcError)
        return got, wires
    got_j, got_p = _both(run)
    assert got_p == got_j and got_p[0][2] == PR.METHOD_NOT_FOUND


def test_block_roots_request_response():
    def run(N, M, R):
        a, b, wires = _recorded_pair(N, R)

        def serve(req):
            assert int(req.count) <= R.MAX_BLOCK_ROOTS_COUNT
            return R.BlockRootsResponse(roots=[
                R.BlockRootSlot(block_root=bytes([s]) * 32, slot=s)
                for s in range(int(req.start_slot), int(req.start_slot) + 3)])
        b.register(R.BEACON_BLOCK_ROOTS, serve)
        resp = a.call(R.BEACON_BLOCK_ROOTS, R.BlockRootsRequest(start_slot=5, count=3))
        return [(int(r.slot), bytes(r.block_root)) for r in resp.roots], wires
    got_j, got_p = _both(run)
    assert got_p == got_j and [s for s, _ in got_p[0]] == [5, 6, 7]


def test_headers_and_bodies_methods_carry_opaque_ssz():
    """Methods 11 and 12 carry their lists as SSZ bytes (the preset's
    types); the wrappers and the request containers are equal bytes."""
    def run(N, M, R):
        a, b, wires = _recorded_pair(N, R)
        b.register(R.BEACON_BLOCK_HEADERS,
                   lambda req: R.BlockHeadersResponse(headers=bytes(req.start_root) * 2))
        b.register(R.BEACON_BLOCK_BODIES,
                   lambda req: R.BlockBodiesResponse(
                       block_bodies=b"".join(bytes(r) for r in req.block_roots)))
        h = a.call(R.BEACON_BLOCK_HEADERS, R.BlockHeadersRequest(
            start_root=b"\x07" * 32, start_slot=3, max_headers=4, skip_slots=1))
        bb = a.call(R.BEACON_BLOCK_BODIES, R.BlockBodiesRequest(
            block_roots=[b"\x01" * 32, b"\x02" * 32]))
        return bytes(h.headers), bytes(bb.block_bodies), wires
    got_j, got_p = _both(run)
    assert got_p == got_j and got_p[0] == b"\x07" * 64


def test_server_error_maps_to_code():
    def run(N, M, R):
        a, b, wires = _recorded_pair(N, R)
        b.register(R.GET_STATUS, lambda s: 1 / 0)
        return _raises(lambda: a.call(R.GET_STATUS, R.Status(
            sha=b"\x00" * 32, user_agent=b"t", timestamp=0)), R.RpcError), wires
    got_j, got_p = _both(run)
    assert got_p == got_j and got_p[0][2] == PR.SERVER_ERROR


@pytest.mark.parametrize("wire", [
    b"\xff" * 40,                                       # not an envelope
    JM.encode_message(b"\x01\x02"),                     # envelope, body not a Request
], ids=["garbage", "short-request"])
def test_parse_error_on_garbage_wire(wire):
    resp_j = JR.RpcNode().handle_wire(wire)
    resp_p = PR.RpcNode().handle_wire(wire)
    assert resp_p == resp_j
    _, _, payload = PM.decode_message(resp_p)
    assert int(PSSZ.deserialize(payload, PR.Response).response_code) == PR.PARSE_ERROR


def test_invalid_request_on_bad_body():
    """A well-formed Request whose body is not the method's container."""
    def run(N, M, R):
        node = R.RpcNode()
        node.register(R.BEACON_BLOCK_ROOTS, lambda req: None)
        ssz = JSSZ if R is JR else PSSZ
        wire = M.encode_message(ssz.serialize(
            R.Request(id=7, method_id=R.BEACON_BLOCK_ROOTS, body=b"\x01"), R.Request))
        return node.handle_wire(wire)
    got_j, got_p = _both(run)
    assert got_p == got_j
    resp = PSSZ.deserialize(PM.decode_message(got_p)[2], PR.Response)
    assert (int(resp.id), int(resp.response_code)) == (7, PR.INVALID_REQUEST)


def test_handshake_disconnect_policy():
    def run(N, M, R):
        mine, theirs, same_net = _hello(R, net=1), _hello(R, net=2), _hello(R, net=1)
        return [R.should_disconnect(mine, theirs, lambda e: None),
                R.should_disconnect(mine, same_net, lambda e: b"\xff" * 32),
                R.should_disconnect(mine, same_net, lambda e: b"\x0a" * 32),
                R.should_disconnect(mine, same_net, lambda e: None)]
    got_j, got_p = _both(run)
    assert got_p == got_j == [True, True, False, False]


def test_untyped_method_registration_round_trips():
    def run(N, M, R):
        a, b, wires = _recorded_pair(N, R)
        b.register(R.BEACON_CHAIN_STATE, lambda raw: raw[::-1])
        refused = _raises(lambda: a.call(R.BEACON_CHAIN_STATE, b"\x01\x02"), R.RpcError)
        a.register(R.BEACON_CHAIN_STATE, lambda raw: raw)
        return refused, a.call(R.BEACON_CHAIN_STATE, b"\x01\x02"), wires
    got_j, got_p = _both(run)
    assert got_p == got_j
    assert got_p[0][2] == PR.METHOD_NOT_FOUND and got_p[1] == b"\x02\x01"


# ---------------------------------------------------------------------------
# Gossip
# ---------------------------------------------------------------------------

def test_topic_hash_and_shard_subnets():
    got_j, got_p = _both(lambda N, M, R: (
        N.topic_hash("beacon_block"), N.topic_hash(N.TOPIC_BEACON_ATTESTATION),
        N.shard_attestation_topic(shard=1029, shard_subnet_count=16),
        N.GOSSIPSUB_PROTOCOL_ID, N.GossipParams()))
    assert got_p[:4] == got_j[:4] and got_p[2] == "shard5_attestation"
    assert vars(got_p[4]) == vars(got_j[4])


def test_gossip_delivery_and_dedup():
    def run(N, M, R):
        router = N.GossipRouter()
        seen = {"a": [], "b": [], "c": []}
        for node in seen:
            router.subscribe(node, "beacon_block",
                             lambda t, p, node=node: seen[node].append(p))
        first = router.publish("a", "beacon_block", b"block-bytes")
        again = router.publish("b", "beacon_block", b"block-bytes")
        return first, again, seen, router.delivered
    got_j, got_p = _both(run)
    assert got_p == got_j and got_p[:2] == (2, 0)


def test_gossip_message_size_cap():
    def run(N, M, R):
        router = N.GossipRouter()
        router.subscribe("b", "beacon_block", lambda t, p: None)
        return (router.publish("a", "beacon_block", b"\x00" * (512 * 1024 + 1)),
                router.publish("a", "beacon_block", b"\x00" * (512 * 1024)),
                router.dropped_oversize)
    got_j, got_p = _both(run)
    assert got_p == got_j == (0, 1, 1)


def test_gossip_handler_failure_isolated():
    def run(N, M, R):
        router = N.GossipRouter()
        got = []
        router.subscribe("bad", "beacon_block",
                         lambda t, p: (_ for _ in ()).throw(RuntimeError("boom")))
        router.subscribe("good", "beacon_block", lambda t, p: got.append(p))
        return router.publish("src", "beacon_block", b"payload"), got, router.handler_failures
    got_j, got_p = _both(run)
    assert got_p == got_j == (1, [b"payload"], 1)


# ---------------------------------------------------------------------------
# Identity
# ---------------------------------------------------------------------------

def test_peer_id_multiaddr_and_digest():
    for k in range(3):
        rec = dict(ip=f"10.0.0.{k + 1}", pubkey=pubkeys[k], udp_port=30303 if k else None,
                   seq=k)
        j, p = JN.NodeRecord(**rec), PN.NodeRecord(**rec)
        assert p.content_digest() == j.content_digest()
        assert PN.peer_id(pubkeys[k]) == JN.peer_id(pubkeys[k])
        assert PN.multiaddr(p) == JN.multiaddr(j)
    pid = PN.peer_id(pubkeys[0])
    assert pid[:2] == bytes([0x12, 0x20]) and len(pid) == 34
    addr = PN.multiaddr(PN.NodeRecord(ip="10.0.0.1", pubkey=pubkeys[0]))
    assert addr.startswith("/ip4/10.0.0.1/tcp/9000/p2p/1220")
    from consensus_specs_tpu.networking import identity as JI
    from consensus_specs_tpu_torch.networking import identity as PI
    assert (PI.DEFAULT_TCP_PORT, PI.ENR_SIGNING_DOMAIN) == \
        (JI.DEFAULT_TCP_PORT, JI.ENR_SIGNING_DOMAIN)
    assert not PN.NodeRecord(ip="10.0.0.1", pubkey=pubkeys[0]).verify()   # unsigned


@pytest.mark.parametrize("case", ["signed", "seq_changed", "other_signature"])
def test_node_record_sign_verify(case, python_bls):
    """Both packages sign on "python" to the same bytes; each verdict is
    the reference's: True as signed, False after any content change or
    with another record's signature (disconnect)."""
    from consensus_specs_tpu.crypto import bls as JBLS
    old = (JBLS.bls_active, PBLS.bls_active)
    JBLS.bls_active = PBLS.bls_active = True
    try:
        j = JN.NodeRecord(ip="10.0.0.1", pubkey=pubkeys[0]).sign(privkeys[0])
        p = PN.NodeRecord(ip="10.0.0.1", pubkey=pubkeys[0]).sign(privkeys[0])
        assert p.signature == j.signature and len(p.signature) == 96
        assert p.tcp_port == 9000
        if case == "seq_changed":
            j.seq += 1
            p.seq += 1
        elif case == "other_signature":
            other = PN.NodeRecord(ip="10.0.0.2", pubkey=pubkeys[1]).sign(privkeys[1])
            j.signature = p.signature = other.signature
        assert p.verify() == j.verify() == (case == "signed")
    finally:
        JBLS.bls_active, PBLS.bls_active = old


# ---------------------------------------------------------------------------
# The device-fault rule (the port's departure)
# ---------------------------------------------------------------------------

class _FaultyBackend(PBLS._Backend):
    def __init__(self, exc):
        self.exc = exc

    def verify(self, *args):
        raise self.exc


def _with_backend(exc, fn):
    PBLS.register_backend("faulty", lambda: _FaultyBackend(exc))
    PBLS._backend_cache.pop("faulty", None)
    old = (PBLS._active_backend_name, PBLS.bls_active)
    PBLS._active_backend_name, PBLS.bls_active = "faulty", True
    try:
        return fn()
    finally:
        PBLS._active_backend_name, PBLS.bls_active = old
        PBLS._backends.pop("faulty")
        PBLS._backend_cache.pop("faulty", None)


def test_device_fault_propagates():
    """A sticky CUDA error out of an RPC handler, a record's verify and a
    gossip subscriber reaches the caller; the router un-marks the
    message and the other subscribers' counts are untouched."""
    assert is_device_fault(RuntimeError(CUDA_FAULT))
    a, b = PN.loopback_pair()

    def handler(_):
        raise RuntimeError(CUDA_FAULT)
    b.register(PR.GET_STATUS, handler)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        a.call(PR.GET_STATUS, PR.Status(sha=b"\x00" * 32, user_agent=b"t", timestamp=0))

    record = PN.NodeRecord(ip="10.0.0.1", pubkey=pubkeys[0], signature=b"\x01" * 96)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _with_backend(RuntimeError(CUDA_FAULT), record.verify)

    router = PN.GossipRouter()
    got = []
    router.subscribe("good", "beacon_block", lambda t, p: got.append(p))
    router.subscribe("card", "beacon_block", lambda t, p: handler(p))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        router.publish("src", "beacon_block", b"payload")
    assert router.handler_failures == 0
    router._subs.clear()
    router.subscribe("good", "beacon_block", lambda t, p: got.append(p))
    assert router.publish("src", "beacon_block", b"payload") == 1   # not left as seen


def test_python_errors_and_malformed_input_keep_the_reference_verdicts():
    """A ZeroDivisionError is SERVER_ERROR in RPC and a counted handler
    failure in the router; a verify that raises a Python error, or meets a
    malformed key or signature, reads False; all as in the reference."""
    assert not is_device_fault(ZeroDivisionError("division by zero"))
    a, b = PN.loopback_pair()
    b.register(PR.GET_STATUS, lambda s: 1 / 0)
    with pytest.raises(PR.RpcError) as err:
        a.call(PR.GET_STATUS, PR.Status(sha=b"\x00" * 32, user_agent=b"t", timestamp=0))
    assert err.value.code == PR.SERVER_ERROR

    router = PN.GossipRouter()
    router.subscribe("bad", "beacon_block", lambda t, p: 1 / 0)
    assert router.publish("src", "beacon_block", b"payload") == 0
    assert router.handler_failures == 1

    record = PN.NodeRecord(ip="10.0.0.1", pubkey=pubkeys[0], signature=b"\x01" * 96)
    assert _with_backend(ValueError("not a point"), record.verify) is False
    assert _with_backend(AssertionError("bad encoding"), record.verify) is False
    # malformed key and signature through the real bignum backends
    PBLS.set_backend("python")
    from consensus_specs_tpu.crypto import bls as JBLS
    j_old, JBLS._active_backend_name = JBLS._active_backend_name, "python"
    old = (JBLS.bls_active, PBLS.bls_active)
    JBLS.bls_active = PBLS.bls_active = True
    try:
        for pub, sig in ((b"\x00" * 48, b"\xc0" + b"\x00" * 95),
                         (pubkeys[0], b"\x01" * 96), (pubkeys[0][:47], b"\x01" * 96)):
            p = PN.NodeRecord(ip="10.0.0.1", pubkey=pub, signature=sig)
            j = JN.NodeRecord(ip="10.0.0.1", pubkey=pub, signature=sig)
            assert p.verify() is j.verify() is False
    finally:
        PBLS._active_backend_name = "torch"
        JBLS._active_backend_name = j_old
        JBLS.bls_active, PBLS.bls_active = old
