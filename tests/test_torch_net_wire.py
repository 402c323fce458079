"""The port's wire tier (``raft_tpu_torch.net``) end to end on the CPU:
``tests/test_net_wire.py``'s cases through the port's loopback server and
client, the deterministic ones held equal to the JAX package's run;
interop across the packages (the port's client against JAX's server and
JAX's client against the port's, every frame of a serial session equal
in all four pairings); the port's ``txn_commit`` against JAX's server
armed with JAX's own ``TxnCoordinator``; ``txn=`` accepted and the
``peer=`` refusal; and the TXN_* / PEER_* frames a server without them
answers as JAX's does."""

import asyncio
import struct

import pytest

from tests._torch_net import (
    Proxy,
    engine_cfg,
    pkg,
    reset_counters,
    serve,
)

JX, PT = pkg("raft_tpu"), pkg("raft_tpu_torch")


def _kv_engine(ns, **kw):
    e = ns.engine(engine_cfg(ns, **kw))
    kv = ns.ReplicatedKV(e)
    e.run_until_leader()
    return e, kv


# ------------------------------------------------------------ end to end
def _submit_then_reads(ns):
    e, kv = _kv_engine(ns, admission_max_writes=64, admission_max_reads=64)

    async def scenario(srv, port):
        c = await ns.net.WireClient("127.0.0.1", port).connect()
        assert (c.entry_bytes, c.groups) == (e.cfg.entry_bytes, 1)
        r = await c.submit(b"k1", b"v1")
        assert e.is_durable(r.seq)
        lin = await c.read(b"k1")
        ses = await c.read(b"k1", cls="session")
        floor = dict(c.session.floor)
        await c.close()
        return (r.seq, r.floor, lin.value, lin.cls, lin.index, ses.value,
                ses.cls, ses.index, floor, srv.stats())

    return serve(ns, ns.net.EngineBackend(e, kv), scenario)


def test_submit_then_reads_all_classes_equal_to_jax():
    got = _submit_then_reads(PT)
    assert got == _submit_then_reads(JX)
    seq, _, lin, cls, _, ses, scls, _, floor, stats = got
    assert lin == ses == b"v1" and cls in ("read_index", "lease")
    assert scls == "session" and floor[0] >= seq
    assert stats["requests_total"] == {"hello": 1, "submit": 1, "read": 2}
    assert stats["responses_total"] == 3 and stats["refusals"] == {}
    assert stats["bytes_in"] > 0 and stats["bytes_out"] > 0


def test_missing_key_reads_none():
    e, kv = _kv_engine(PT)

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port).connect()
        out = await c.read(b"ghost")
        await c.close()
        return out

    assert serve(PT, PT.net.EngineBackend(e, kv), scenario).value is None


def test_router_backend_routes_groups_and_batches():
    cfg = engine_cfg(PT, admission_max_writes=8)
    eng = PT.multi(cfg, 4)
    router = PT.Router(eng, drive=False)
    skv = PT.ShardedKV(eng, router)
    eng.seed_leaders()

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port).connect()
        outs = await asyncio.gather(*[
            c.submit(b"k%d" % i, b"v%d" % i) for i in range(8)])
        assert {o.group for o in outs} == {
            router.group_of(b"k%d" % i) for i in range(8)}
        batch = await c.submit_many(
            [(b"k0", b"b%d" % i) for i in range(3 * 8)])
        assert batch.accepted + batch.shed == 24
        assert batch.shed > 0
        assert batch.floors[router.group_of(b"k0")] >= 1
        out = await c.read(b"k1")
        assert out.value == b"v1"
        await c.close()
        return srv.stats()

    stats = serve(PT, PT.net.RouterBackend(router, skv), scenario)
    assert stats["requests_total"]["submit_batch"] == 1
    assert stats["refusals"].get("depth", 0) > 0


def test_drive_true_router_rejected_with_jax_message():
    msgs = []
    for ns in (JX, PT):
        eng = ns.multi(engine_cfg(ns), 2)
        with pytest.raises(ValueError, match="drive=False") as ei:
            ns.net.RouterBackend(ns.Router(eng))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------- staged ingest
def test_wire_batches_enter_tick_loop_pre_packed():
    cfg = engine_cfg(PT, fuse_k=8, prevote=True)
    e = PT.engine(cfg)
    e.run_until_leader()
    payload = bytes(cfg.entry_bytes)

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port, pool=2).connect()
        outs = await asyncio.gather(
            *[c.submit(b"", payload) for _ in range(64)])
        assert len(outs) == 64
        await c.close()
        return srv.stats()

    stats = serve(PT, PT.net.EngineBackend(e), scenario,
                  drive_quantum_s=cfg.fuse_k * cfg.heartbeat_period)
    assert stats["wire_staged_batches"] > 0
    assert stats["tick_staged_batches"] == 0
    assert e.fused_launches > 0
    assert e.fused_ticks >= 2 * e.fused_launches
    assert (stats["wire_staged_batches"]
            + stats["tick_tail_batches"]) >= 64 // cfg.batch_size


# --------------------------------------------------------- backpressure
def test_refusals_typed_and_retry_after_honored():
    e, kv = _kv_engine(PT, admission_max_writes=2)
    max_backoff = 0.02

    async def scenario(srv, port):
        c = await PT.net.WireClient(
            "127.0.0.1", port, retries=12, base_backoff_s=0.001,
            max_backoff_s=max_backoff).connect()
        outs = await asyncio.gather(
            *[c.submit(b"k", b"v%d" % i) for i in range(12)],
            return_exceptions=True)
        await c.close()
        ok = [o for o in outs if not isinstance(o, Exception)]
        assert all(isinstance(o, PT.net.WireRefused) for o in outs
                   if isinstance(o, Exception))
        return srv.stats(), ok, list(c.last_delays), c.stats

    stats, ok, delays, cstats = serve(PT, PT.net.EngineBackend(e, kv),
                                      scenario)
    assert stats["refusals"].get("depth", 0) > 0
    assert len(ok) >= 1 and cstats["retries"] > 0
    floor = min(e.cfg.heartbeat_period, max_backoff)
    assert delays and all(d >= floor - 1e-9 for d in delays)


def test_wire_backlog_bound_refuses_never_queues():
    e = PT.engine(engine_cfg(PT))
    e.run_until_leader()

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port, retries=0).connect()
        outs = await asyncio.gather(
            *[c.submit(b"", bytes(e.cfg.entry_bytes)) for _ in range(12)],
            return_exceptions=True)
        refused = [o for o in outs if isinstance(o, PT.net.WireRefused)]
        assert refused and all(o.reason == "wire_backlog" for o in refused)
        await c.close()
        return srv.stats()

    stats = serve(PT, PT.net.EngineBackend(e), scenario, max_pending=2)
    assert stats["refusals"]["wire_backlog"] >= 1
    assert stats["awaiting_writes"] == 0


def _raw_exchange(ns, frames, **server_kw):
    """Send ``frames`` on a raw socket to ``ns``'s server; return every
    frame it answers until it closes (or 0.5 s of silence) and its stats."""
    e = ns.engine(engine_cfg(ns))
    e.run_until_leader()

    async def scenario(srv, port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for f in frames:
            writer.write(f)
        await writer.drain()
        buf, closed = b"", False
        while True:
            try:
                data = await asyncio.wait_for(reader.read(1 << 16), 0.5)
            except asyncio.TimeoutError:
                break
            if not data:
                closed = True
                break
            buf += data
        writer.close()
        return ns.P.FrameDecoder().feed(buf), closed, srv.stats()

    return serve(ns, ns.net.EngineBackend(e), scenario, **server_kw)


def _refusals(stats):
    return stats["refusals"], stats["requests_total"]


def test_unknown_frame_kind_closes_connection_as_jax():
    P = JX.P
    got = _raw_exchange(PT, [P.encode_frame(99, b"")])
    want = _raw_exchange(JX, [P.encode_frame(99, b"")])
    assert got[:2] == want[:2]
    assert _refusals(got[2]) == _refusals(want[2])
    frames, closed, stats = got
    assert frames and frames[0][0] == P.ERROR and closed
    assert stats["refusals"]["protocol_error"] == 1


def test_oversized_frame_refused_and_connection_closed():
    e = PT.engine(engine_cfg(PT))
    e.run_until_leader()

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port,
                                    max_frame_bytes=1 << 20).connect()
        with pytest.raises(PT.net.WireDisconnected):
            await c.submit(b"k", bytes(8192))
        await c.close()
        return srv.stats()

    stats = serve(PT, PT.net.EngineBackend(e), scenario,
                  max_frame_bytes=1024)
    assert stats["refusals"]["protocol_error"] == 1


def _txn_and_peer_frames():
    P = JX.P
    return [
        ("txn_begin", [P.encode_txn_begin(1)]),
        ("txn_commit", [P.encode_txn_commit(2, 7, [(b"k", b"v")],
                                            [(b"j", None)])]),
        ("txn_abort", [P.encode_txn_abort(3, 7)]),
        ("txn_status", [P.encode_txn_status(4, 7)]),
        ("peer_hello", [P.encode_peer_hello(1, b"tok", 5,
                                            caps=P.CAP_CRC)]),
        ("peer_vote", [P.encode_peer_vote(1, 2, 3, 4, prevote=True)]),
        ("peer_append", [P.encode_peer_append(1, 2, 3, 4, 5, 6,
                                              [(2, bytes(9))])]),
        ("peer_snap_ack", [P.encode_peer_snap_ack(1, 2, 3)]),
        ("peer_vote_crc_ok", [P.crc_seal(P.encode_peer_vote(1, 2, 3, 4))]),
        ("peer_vote_crc_bad_then_submit", [
            P.crc_seal(P.encode_peer_vote(1, 2, 3, 4))[:-1] + b"\x00",
            P.encode_hello({}), P.encode_submit(9, b"", bytes(32))]),
        ("traced_txn_begin", [P.encode_txn_begin(5, trace=(1, 2, True))]),
    ]


@pytest.mark.parametrize("case", _txn_and_peer_frames(), ids=lambda c: c[0])
def test_txn_and_peer_frames_answered_as_jax_without_them(case):
    """Without a coordinator or a peer backend, JAX's server answers a
    TXN_* or PEER_* frame as an unknown kind (ERROR, close) and drops a
    CRC-sealed peer frame whose trailer fails (counted, stream kept);
    the port's answers every one the same, byte for byte."""
    name, frames = case
    got = _raw_exchange(PT, frames)
    want = _raw_exchange(JX, frames)
    assert got[:2] == want[:2]
    assert _refusals(got[2]) == _refusals(want[2])
    if name.endswith("crc_bad_then_submit"):
        assert got[2]["refusals"] == {"peer_frame_corrupt": 1}
        assert [k for k, _ in got[0]] == [JX.P.WELCOME, JX.P.OK]
    else:
        assert got[1] and got[0][0][0] == JX.P.ERROR


def test_txn_and_peer_arguments_name_their_roadmap_items():
    """Both tiers are ported, so neither argument names a ROADMAP item any
    more: ``txn=`` (A17c) and ``peer=`` (A17d) each arm the server
    (``test_torch_txn_wire.py`` and ``test_torch_cluster_peer.py`` drive
    them), as JAX's ``IngestServer`` takes them."""
    e = PT.engine(engine_cfg(PT))
    backend = PT.net.EngineBackend(e)
    coord, peer = object(), object()
    assert PT.net.IngestServer(backend, txn=coord).txn is coord
    assert PT.net.IngestServer(backend, peer=peer).peer is peer
    srv = PT.net.IngestServer(backend, txn=None, peer=None)
    assert srv.txn is None and srv.peer is None
    jsrv = JX.net.IngestServer(JX.net.EngineBackend(JX.engine(
        engine_cfg(JX))), peer=peer)
    assert jsrv.peer is peer


# ------------------------------------------------------- session tokens
def _session_carry(ns):
    e, kv = _kv_engine(ns, admission_max_writes=64)

    async def scenario(srv, port):
        c1 = await ns.net.WireClient("127.0.0.1", port).connect()
        r = await c1.submit(b"sk", b"sv1")
        s1 = await c1.read(b"sk", cls="session")
        token = dict(c1.session.floor)
        await c1.close()
        c2 = await ns.net.WireClient(
            "127.0.0.1", port,
            session=ns.ReadSession.from_floors(token)).connect()
        s2 = await c2.read(b"sk", cls="session")
        await c2.close()
        c3 = await ns.net.WireClient(
            "127.0.0.1", port, retries=0,
            session=ns.ReadSession.from_floors({0: 10_000})).connect()
        with pytest.raises(ns.net.WireRefused) as ei:
            await c3.read(b"sk", cls="session")
        await c3.close()
        return (r.seq, s1.value, token, s2.index, s2.value,
                ei.value.reason, srv.stats()["refusals"])

    return serve(ns, ns.net.EngineBackend(e, kv), scenario)


def test_reconnect_and_resume_carries_token_equal_to_jax():
    got = _session_carry(PT)
    assert got == _session_carry(JX)
    seq, v1, token, idx2, v2, reason, refusals = got
    assert v1 == v2 == b"sv1" and token[0] >= seq and idx2 >= token[0]
    assert reason == "read_lagging" and refusals["read_lagging"] == 1


# ------------------------------------------------------- obs + /status
def test_net_status_section_and_counters():
    e, kv = _kv_engine(PT)
    reg, board = PT.MetricsRegistry(), PT.StatusBoard()

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port).connect()
        await c.submit(b"k", b"v")
        await c.read(b"k")
        await c.close()

    serve(PT, PT.net.EngineBackend(e, kv), scenario, registry=reg,
          status_board=board)
    net = board.compose()["net"]
    assert net["requests_total"]["submit"] == 1
    assert net["bytes_in"] > 0 and net["bytes_out"] > 0
    assert net["draining"] is True
    req = reg.counter("raft_net_requests_total",
                      "wire requests by frame kind", ("kind",))
    assert req.value(kind="submit") == 1 and req.value(kind="read") == 1
    by = reg.counter("raft_net_bytes_total", "wire bytes by direction",
                     ("dir",))
    assert by.value(dir="in") > 0 and by.value(dir="out") > 0


def test_spans_annotate_wire_ops():
    e, kv = _kv_engine(PT)
    spans = PT.SpanTracker()

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port).connect()
        await c.submit(b"k", b"v")
        await c.read(b"k")
        await c.close()

    serve(PT, PT.net.EngineBackend(e, kv), scenario, spans=spans)
    wire = [sp for sp in spans.spans if sp.op.startswith("wire_")]
    assert len(wire) == 2
    for sp in wire:
        assert sp.terminal and sp.state == "ok"
        assert {"wire_recv", "wire_ingest", "wire_sent"} <= {
            n for _, n, _ in sp.annotations}


# -------------------------------------------------- cross-package interop
def _interop(client_ns, server_ns):
    """One serial session of ``client_ns``'s client against
    ``server_ns``'s server through a recording proxy: (results, frames
    client to server, frames server to client, server stats)."""
    reset_counters()
    e, kv = _kv_engine(server_ns, admission_max_writes=2, seed=4)

    async def main():
        srv = server_ns.net.IngestServer(server_ns.net.EngineBackend(e, kv))
        sport = await srv.start()
        proxy = Proxy(sport)
        port = await proxy.start()
        c = await client_ns.net.WireClient("127.0.0.1", port,
                                           retries=0).connect()
        out = [(c.entry_bytes, c.groups)]
        for i in range(6):
            r = await c.submit(b"ik%d" % (i % 2), b"iv%d" % i)
            out.append(("ok", r.group, r.seq, r.floor, r.attempts))
            for cls in ("linearizable", "session"):
                o = await c.read(b"ik0", cls=cls)
                out.append(("rd", o.group, o.index, o.cls, o.value))
        b = await c.submit_many([(b"ik1", b"bv%d" % i) for i in range(5)])
        out.append(("batch", b.accepted, b.shed, b.floors))
        out.append(("session", dict(c.session.floor), dict(c.stats)))
        await c.close()
        await proxy.stop()
        await srv.stop()
        return out, proxy.frames("c2s"), proxy.frames("s2c"), srv.stats()

    return asyncio.run(main())


def test_interop_both_ways_equal_results_and_frames():
    """Every pairing of the two packages' clients and servers gives the
    same results and the same frames, both ways, over a serial session
    (submits, both read classes, a batch partly shed by the depth
    gate)."""
    runs = {(c.name, s.name): _interop(c, s)
            for c in (JX, PT) for s in (JX, PT)}
    want = runs[("raft_tpu", "raft_tpu")]
    for pair, got in runs.items():
        assert got[0] == want[0], pair
        assert got[1] == want[1], pair
        assert got[2] == want[2], pair
        assert got[3] == want[3], pair
    out = want[0]
    assert out[-2][2] > 0                   # the batch was partly shed
    assert len(want[1]) == 1 + 6 * 3 + 1    # hello + ops + batch


def test_port_txn_commit_against_jax_coordinator():
    """The port's ``txn_commit`` / ``txn_status`` / ``txn_abort`` frames
    against JAX's server armed with JAX's own ``TxnCoordinator``: the
    frame level of A17c, held before its coordinator is ported."""
    from raft_tpu.txn import TxnCoordinator, TxnShardedKV

    eng = JX.multi(engine_cfg(JX), 4)
    router = JX.Router(eng, drive=False)
    skv = TxnShardedKV(eng, router)
    eng.seed_leaders()
    coord = TxnCoordinator(skv, decision_group=0)

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port, txn=True).connect()
        assert c._conns[0].caps & PT.P.CAP_TXN
        r = await c.txn_commit([(b"a", b"1"), (b"b", b"2")])
        assert r.status == "committed" and r.committed
        r2 = await c.txn_commit([(b"a", b"9")], expects=[(b"a", b"0")])
        assert (r2.status, r2.reason, r2.committed) == (
            "aborted", "expect_failed", False)
        assert (await c.read(b"a")).value == b"1"
        assert (await c.txn_status(r.txn_id)).status == "committed"
        assert (await c.txn_status(0xDEAD)).status == "unknown"
        ab = await c.txn_abort(0xBEEF)
        assert (ab.status, ab.reason) == ("aborted", "client_abort")
        await c.close()
        return srv.stats()

    stats = serve(JX, JX.net.RouterBackend(router, skv), scenario,
                  txn=coord, drive_quantum_s=eng.cfg.heartbeat_period)
    assert stats["pending_txns"] == 0
    assert stats["requests_total"]["txn_commit"] == 2


def test_port_server_never_speaks_cap_txn():
    eng = PT.multi(engine_cfg(PT), 4)
    router = PT.Router(eng, drive=False)
    skv = PT.ShardedKV(eng, router)
    eng.seed_leaders()

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port, txn=True).connect()
        assert not (c._conns[0].caps & PT.P.CAP_TXN)
        with pytest.raises(PT.client.WireError):
            await c.txn_commit([(b"k", b"v")])
        with pytest.raises(PT.client.WireError):
            await c.txn_status(1)
        r = await c.submit(b"k", b"v")
        assert eng.is_durable(r.group, r.seq)
        await c.close()
        return srv.stats()

    stats = serve(PT, PT.net.RouterBackend(router, skv), scenario,
                  drive_quantum_s=eng.cfg.heartbeat_period)
    assert "txn_commit" not in stats["requests_total"]


def test_wire_counters_count_as_jax():
    """``_Conn._next_cid`` and the client's trace node count from the
    same place in both packages: the span names and trace ids a run
    mints are the same."""
    reset_counters()
    got = []
    for ns in (JX, PT):
        srv = ns.server
        a = srv._Conn(None, None, 1024, wire=object())
        b = srv._Conn(None, None, 1024, wire=object())
        c = ns.net.WireClient("127.0.0.1", 1)
        got.append((a.cid, b.cid, c.trace_node, c._next_req_id))
    assert got[0] == got[1] == (1, 2, 1, 1)
    reset_counters()


def test_submit_frame_layout_is_the_codecs():
    """What the port's client puts on the wire for a submit is the JAX
    codec's frame (decoded here with JAX's decoder)."""
    P = JX.P
    e = PT.engine(engine_cfg(PT))
    e.run_until_leader()

    async def main():
        srv = PT.net.IngestServer(PT.net.EngineBackend(e))
        proxy = Proxy(await srv.start())
        c = await PT.net.WireClient("127.0.0.1",
                                    await proxy.start()).connect()
        await c.submit(b"", bytes(32))
        await c.close()
        await proxy.stop()
        await srv.stop()
        return proxy.frames("c2s")

    frames = asyncio.run(main())
    assert [k for k, _ in frames] == [P.HELLO, P.SUBMIT]
    assert P.decode_submit(frames[1][1]) == (1, b"", bytes(32))
    assert frames[0][1] == struct.pack("!H", 0)
