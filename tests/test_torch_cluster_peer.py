"""The cluster's peer plane over loopback, across packages: a port
``PeerBackend`` (``IngestServer(peer=)``) answering a JAX ``PeerDialer``
and a JAX one answering a port dialer, beside the two one-package
pairings. A recording proxy sits between dialer and server; every pairing
must move the same bytes both ways as the JAX pair does: the
``PEER_HELLO`` with its token and ``CAP_CRC``, the vote and its sealed
reply, the new leader's sealed append and its ack, and the
``peer_frames_corrupt`` count a flipped bit earns. Raw sockets check the
refusals (a wrong token, a peer frame before the hello: ERROR and close)
and the HELLO/WELCOME negotiation of ``CAP_PEER``. The frame codec itself
(``TestPeerFrames``/``TestPeerFrameCrc`` of ``tests/test_cluster.py``) is
held by ``tests/test_torch_net_protocol.py``."""

import asyncio
import itertools

import pytest

from tests._torch_cluster import PACKAGES, mod
from tests._torch_net import Proxy, reset_counters

TOKEN = b"cluster-secret"


async def _until(cond, timeout=10.0):
    end = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > end:
            raise AssertionError("condition not reached")
        await asyncio.sleep(0.005)


def _node(pkg, node_id, peers, d):
    return mod(pkg, "cluster.node").RaftNode(
        node_id, peers, str(d), heartbeat_s=10.0, election_timeout_s=30.0,
        seed=7 + node_id)


async def _scenario(server_pkg, dialer_pkg, tmp):
    """Dialer node 1 elects itself with node 0's vote (a two-node
    cluster), replicates its noop, then sends one sealed frame with a bit
    flipped. Returns the proxy's bytes and both nodes' outcome."""
    reset_counters()
    srv_node = _node(server_pkg, 0, {0: "127.0.0.1:1", 1: "127.0.0.1:1"},
                     tmp / "s")
    auth = mod(server_pkg, "cluster.auth").ClusterAuth(TOKEN)
    server = mod(server_pkg, "net.server")
    srv = server.IngestServer(srv_node,
                              peer=server.PeerBackend(srv_node, auth))
    port = await srv.start()
    proxy = Proxy(port)
    pport = await proxy.start()
    node = _node(dialer_pkg, 1, {0: f"127.0.0.1:{pport}",
                                 1: "127.0.0.1:1"}, tmp / "d")
    dialer = mod(dialer_pkg, "cluster.dialer").PeerDialer(
        node, mod(dialer_pkg, "cluster.auth").ClusterAuth(TOKEN))
    try:
        node._start_election(node.now())
        dialer.pump_outbox()
        await _until(lambda: node.role == "leader")
        dialer.pump_outbox()                  # the noop's append
        await _until(lambda: node.commit == 1)
        P = mod(dialer_pkg, "net.protocol")
        bad = bytearray(P.crc_seal(P.encode_peer_append(
            1, term=node.term, prev_idx=1, prev_term=node.term,
            commit=1, round_no=99, entries=[])))
        bad[-1] ^= 0x01
        dialer._conns[0].write(bytes(bad))
        await _until(lambda: srv_node.stats["peer_frames_corrupt"] == 1)
        out = {
            "c2s": bytes(proxy.data["c2s"]),
            "s2c": bytes(proxy.data["s2c"]),
            "server": (srv_node.term, srv_node.voted_for, srv_node.log,
                       srv_node.commit, dict(srv_node.stats)),
            "dialer": (node.term, node.role, node.log, node.commit,
                       dict(node.stats)),
            "dialer_stats": dict(dialer.stats),
            "crc_on": dict(dialer._crc_on),
            "refusals": dict(srv.refusals),
            "cluster": srv.peer.status_snapshot()["last_idx"],
        }
    finally:
        await dialer.close()
        await proxy.stop()
        await srv.stop()
    return out


@pytest.fixture(scope="module")
def pairings(tmp_path_factory):
    runs = {}
    for server_pkg, dialer_pkg in itertools.product(PACKAGES, PACKAGES):
        tmp = tmp_path_factory.mktemp(f"{server_pkg}-{dialer_pkg}")
        runs[(server_pkg, dialer_pkg)] = asyncio.run(
            _scenario(server_pkg, dialer_pkg, tmp))
    return runs


@pytest.mark.parametrize("pairing", [
    ("raft_tpu_torch", "raft_tpu"), ("raft_tpu", "raft_tpu_torch"),
    ("raft_tpu_torch", "raft_tpu_torch")], ids="-".join)
def test_peer_plane_bytes_equal_the_jax_pair(pairings, pairing):
    want = pairings[("raft_tpu", "raft_tpu")]
    got = pairings[pairing]
    for k in want:
        assert got[k] == want[k], k


def test_peer_plane_round_trips_and_counts_the_flip(pairings):
    run = pairings[("raft_tpu_torch", "raft_tpu")]
    P = mod("raft_tpu", "net.protocol")
    c2s = P.FrameDecoder().feed(run["c2s"])
    s2c = P.FrameDecoder().feed(run["s2c"])
    kinds = [k & ~P.CRC_FLAG for k, _ in c2s]
    assert kinds[:3] == [P.PEER_HELLO, P.PEER_VOTE, P.PEER_APPEND]
    assert P.decode_peer_hello_caps(c2s[0][1]) == (1, 0, TOKEN, P.CAP_CRC)
    assert not c2s[1][0] & P.CRC_FLAG        # sent before the latch
    assert c2s[2][0] & P.CRC_FLAG            # sealed once it latched
    assert all(k & P.CRC_FLAG for k, _ in s2c)
    opened = [P.crc_open(k, p) for k, p in s2c]
    assert [b for b, _, ok in opened if ok] == [P.PEER_VOTE_REPLY,
                                                P.PEER_APPEND_REPLY]
    assert P.decode_peer_vote_reply(opened[0][1])[:3] == (0, 1, True)
    assert P.decode_peer_append_reply(opened[1][1])[2:4] == (True, 1)
    assert run["server"][4]["peer_frames_corrupt"] == 1
    assert run["refusals"] == {"peer_frame_corrupt": 1}
    assert run["dialer"][1] == "leader" and run["dialer"][3] == 1
    assert run["crc_on"] == {0: True}
    assert run["cluster"] == 1               # the noop reached node 0


async def _raw(server_pkg, tmp, frames):
    """Send ``frames`` on a raw connection to a peer-armed server of
    ``server_pkg``; return every byte it sent back before closing."""
    reset_counters()
    node = _node(server_pkg, 0, {0: "127.0.0.1:1", 1: "127.0.0.1:1"}, tmp)
    server = mod(server_pkg, "net.server")
    srv = server.IngestServer(node, peer=server.PeerBackend(
        node, mod(server_pkg, "cluster.auth").ClusterAuth(TOKEN)))
    port = await srv.start()
    try:
        r, w = await asyncio.open_connection("127.0.0.1", port)
        for f in frames:
            w.write(f)
        await w.drain()
        got = await asyncio.wait_for(r.read(1 << 16), 10)
        w.close()
        return got, node.term, dict(srv.refusals)
    finally:
        await srv.stop()


@pytest.mark.parametrize("case", ["wrong_token", "no_hello", "hello_caps"])
def test_refusals_and_cap_peer_negotiation_equal(tmp_path, case):
    P = mod("raft_tpu", "net.protocol")
    vote = P.encode_peer_vote(1, term=3, last_idx=0, last_term=0)
    frames = {
        "wrong_token": [P.encode_peer_hello(1, token=b"nope", last_idx=0)],
        "no_hello": [vote],
        "hello_caps": [P.encode_hello(
            {}, caps=P.CAP_PEER | P.CAP_TRACE | P.CAP_TXN)],
    }[case]
    got = {pkg: asyncio.run(_raw(pkg, tmp_path / pkg, frames))
           for pkg in PACKAGES}
    assert got["raft_tpu_torch"] == got["raft_tpu"]
    blob, term, refusals = got["raft_tpu_torch"]
    (kind, payload), = P.FrameDecoder().feed(blob)
    if case == "hello_caps":
        assert kind == P.WELCOME
        assert P.decode_welcome_caps(payload)[2] == P.CAP_PEER
        return
    assert kind == P.ERROR and term == 0     # nothing reached the node
    msg = P.decode_error(payload)[1]
    assert ("token mismatch" in msg if case == "wrong_token"
            else "before PEER_HELLO" in msg)
    assert refusals == {"protocol_error": 1}
