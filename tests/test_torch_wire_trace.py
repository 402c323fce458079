"""The port's cross-process wire trace plane on the CPU:
``tests/test_wire_trace.py``'s capability negotiation, span-join, pump
profiler, determinism and joined-forensics cases through
``raft_tpu_torch.net``; traced pairs across the packages (the port's
client with JAX's server and back), the serial wire pin equal between the
packages as well as between trace on and off, and the joined
``--explain`` of a port bundle by both packages' CLIs."""

import asyncio
import contextlib
import io
import struct
import zlib

import pytest

from tests._torch_net import engine_cfg, pkg, reset_counters, serve

JX, PT = pkg("raft_tpu"), pkg("raft_tpu_torch")


def _traced_stack(ns, engine):
    sspans, cspans = ns.SpanTracker(), ns.SpanTracker()
    reg = ns.MetricsRegistry()
    pump = ns.PumpProfiler(registry=reg)
    engine.spans = sspans
    return sspans, cspans, reg, pump


def _leader(ns, **kw):
    e = ns.engine(engine_cfg(ns, **kw))
    e.run_until_leader()
    return e


# ------------------------------------------------ capability negotiation
def test_old_client_against_new_traced_server_byte_identical():
    P = PT.P
    e = _leader(PT)
    sspans, _, reg, pump = _traced_stack(PT, e)

    async def scenario(srv, port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        old_hello = (P._HEADER.pack(P.MAGIC, P.VERSION, P.HELLO, 14)
                     + struct.pack("!H", 1) + struct.pack("!IQ", 0, 3))
        assert old_hello == P.encode_hello({0: 3})
        writer.write(old_hello)
        await writer.drain()
        data = await asyncio.wait_for(reader.read(1 << 16), 5)
        assert data == P.encode_welcome(e.cfg.entry_bytes, 1)
        writer.write(P.encode_submit(1, b"k", b"v"))
        await writer.drain()
        buf = b""
        while not buf:
            buf = await asyncio.wait_for(reader.read(1 << 16), 5)
        (kind, payload), = P.FrameDecoder().feed(buf)
        assert kind == P.OK and P.decode_ok(payload)[0] == 1
        writer.close()

    serve(PT, PT.net.EngineBackend(e, PT.ReplicatedKV(e)), scenario,
          spans=sspans, registry=reg, pump=pump)
    wire = [sp for sp in sspans.spans if sp.op == "wire_submit"]
    assert wire and wire[0].wire_trace is None


def test_new_traced_client_against_old_server_interop():
    P = JX.P
    seen_kinds = []

    async def old_server(reader, writer):
        dec = P.FrameDecoder()
        while True:
            data = await reader.read(1 << 16)
            if not data:
                break
            for kind, payload in dec.feed(data):
                seen_kinds.append(kind)
                if kind == P.HELLO:
                    assert P.decode_hello(payload) == {}
                    writer.write(P.encode_welcome(32, 1))
                elif kind == P.SUBMIT:
                    req_id, _k, _v = P.decode_submit(payload)
                    writer.write(P.encode_ok(req_id, 0, 7, 7))
            await writer.drain()
        writer.close()

    async def main():
        srv = await asyncio.start_server(old_server, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        cspans = PT.SpanTracker()
        c = await PT.net.WireClient("127.0.0.1", port,
                                    spans=cspans).connect()
        r = await c.submit(b"k", b"v")
        await c.close()
        srv.close()
        await srv.wait_closed()
        return r, cspans

    r, cspans = asyncio.run(main())
    assert r.seq == 7 and seen_kinds == [P.HELLO, P.SUBMIT]
    sp, = cspans.spans
    assert sp.state == "ok" and sp.wire_trace is not None


def _traced_pair(client_ns, server_ns):
    e = _leader(server_ns)
    sspans = server_ns.SpanTracker()
    e.spans = sspans
    cspans = client_ns.SpanTracker()

    async def scenario(srv, port):
        c = await client_ns.net.WireClient(
            "127.0.0.1", port, spans=cspans, clock=lambda: e.clock.now,
            trace_node=5).connect()
        caps = c._conns[0].caps
        await c.submit(b"k", b"v")
        await c.close()
        return caps

    caps = serve(server_ns, server_ns.net.EngineBackend(
        e, server_ns.ReplicatedKV(e)), scenario, spans=sspans)
    csp, = cspans.spans
    ssp, = [sp for sp in sspans.spans if sp.op == "wire_submit"]
    return caps, csp, ssp


@pytest.mark.parametrize("pair", [(PT, PT), (PT, JX), (JX, PT)],
                         ids=["port-port", "port-client-jax-server",
                              "jax-client-port-server"])
def test_traced_pair_negotiates_and_propagates(pair):
    caps, csp, ssp = _traced_pair(*pair)
    assert caps == PT.P.CAP_TRACE
    assert csp.wire_trace == (5 << 32) | 1
    assert ssp.wire_trace == ssp.parent_span == csp.wire_trace
    resp, = [f for _, n, f in csp.annotations if n == "response"]
    assert resp["server_span"] == ssp.span_id


# ------------------------------------------------------------ span join
def test_uninstrumented_server_does_not_advertise_trace():
    e = _leader(PT)
    cspans = PT.SpanTracker()

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port,
                                    spans=cspans).connect()
        caps = c._conns[0].caps
        await c.submit(b"", bytes(e.cfg.entry_bytes))
        await c.close()
        return caps

    assert serve(PT, PT.net.EngineBackend(e), scenario) == 0
    sp, = cspans.spans
    assert sp.state == "ok"
    assert all(f.get("server_span") is None for _, _, f in sp.annotations)


def test_connect_failure_span_is_failed_not_info():
    cspans = PT.SpanTracker()

    async def main():
        c = PT.net.WireClient("127.0.0.1", 1, retries=0, spans=cspans)
        with pytest.raises(PT.net.WireDisconnected) as ei:
            await c.submit(b"k", b"v")
        assert ei.value.sent is False
        with pytest.raises(PT.net.WireDisconnected) as ei2:
            await c.submit_many([(b"k", b"v")])
        assert ei2.value.sent is False
        await c.close()

    asyncio.run(main())
    assert [sp.state for sp in cspans.spans] == ["failed", "failed"]


def _causal_chain(ns):
    reset_counters()
    e = _leader(ns)
    sspans, cspans, reg, pump = _traced_stack(ns, e)

    async def scenario(srv, port):
        c = await ns.net.WireClient("127.0.0.1", port, spans=cspans,
                                    clock=lambda: e.clock.now).connect()
        await c.submit(b"k", b"v")
        out = await c.read(b"k")
        assert out.value == b"v"
        await c.close()

    serve(ns, ns.net.EngineBackend(e, ns.ReplicatedKV(e)), scenario,
          spans=sspans, registry=reg, pump=pump)
    return sspans, cspans


def _span_rows(tracker):
    """A span table without the wire-visible server span ids (they fold
    in the listening port, which differs from run to run)."""
    return [(sp.op, sp.client, sp.key, sp.state, sp.trace_id,
             sp.wire_trace, sp.parent_span, sp.sampled,
             [(t, n, {k: v for k, v in f.items() if k != "server_span"})
              for t, n, f in sp.annotations])
            for sp in tracker.spans]


def test_server_span_carries_engine_causal_chain_equal_to_jax():
    sspans, cspans = _causal_chain(PT)
    sub, = [sp for sp in sspans.spans if sp.op == "wire_submit"]
    names = {n for _, n, _ in sub.annotations}
    assert {"wire_recv", "wire_ingest", "queued", "ingested", "committed",
            "wire_sent"} <= names
    ing, = [f for _, n, f in sub.annotations if n == "wire_ingest"]
    assert ing["pump_iter"] >= 1 and ing["coalesce"] >= 1
    csub = [sp for sp in cspans.spans if sp.op == "client_submit"][0]
    resp, = [f for _, n, f in csub.annotations if n == "response"]
    assert resp["server_span"] == sub.span_id
    assert sub.span_id is not None and sub.span_id != sub.trace_id
    jss, jcs = _causal_chain(JX)
    assert _span_rows(sspans) == _span_rows(jss)
    assert _span_rows(cspans) == _span_rows(jcs)


def test_batch_span_stays_unit_level():
    e = _leader(PT, admission_max_writes=64)
    sspans, cspans, reg, pump = _traced_stack(PT, e)

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port, spans=cspans,
                                    clock=lambda: e.clock.now).connect()
        r = await c.submit_many([(b"", bytes(e.cfg.entry_bytes))
                                 for _ in range(8)])
        assert r.accepted == 8
        await c.close()

    serve(PT, PT.net.EngineBackend(e), scenario, spans=sspans,
          registry=reg, pump=pump)
    bsp, = [sp for sp in sspans.spans if sp.op == "wire_submit_batch"]
    assert "queued" not in [n for _, n, _ in bsp.annotations]
    assert bsp.state == "ok"
    end, = [f for _, n, f in bsp.annotations if n == "end:ok"]
    assert end["accepted"] == 8


def test_head_sampling_with_tail_override():
    e = _leader(PT, admission_max_writes=2)
    kv = PT.ReplicatedKV(e)
    cspans = PT.SpanTracker(sample_every=4)

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port, spans=cspans,
                                    retries=0,
                                    clock=lambda: e.clock.now).connect()
        for i in range(4):
            await c.submit(b"k", b"v%d" % i)
        outs = await asyncio.gather(
            *[c.submit(b"k", b"w%d" % i) for i in range(8)],
            return_exceptions=True)
        await c.close()
        return outs

    outs = serve(PT, PT.net.EngineBackend(e, kv), scenario)
    sheds = [sp for sp in cspans.spans if sp.state == "shed"]
    assert sheds and all(sp.sampled for sp in sheds)
    ok_unsampled = [sp for sp in cspans.spans
                    if sp.state == "ok" and not sp.sampled]
    assert ok_unsampled
    kept = cspans.sampled_spans()
    assert sheds[0] in kept and ok_unsampled[0] not in kept
    assert any(isinstance(o, PT.net.WireRefused) for o in outs)


def test_client_span_exactly_one_terminal_state():
    e = _leader(PT, admission_max_writes=2)
    cspans = PT.SpanTracker()

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port, spans=cspans,
                                    retries=1, base_backoff_s=0.001,
                                    max_backoff_s=0.002).connect()
        outs = await asyncio.gather(
            *[c.submit(b"k", bytes(e.cfg.entry_bytes)) for _ in range(10)],
            return_exceptions=True)
        await c.close()
        return outs

    outs = serve(PT, PT.net.EngineBackend(e), scenario)
    assert any(isinstance(o, PT.net.WireRefused) for o in outs)
    assert cspans.spans and all(sp.terminal for sp in cspans.spans)
    by_state = cspans.by_state()
    assert by_state.get("ok") and by_state.get("shed")
    shed = [sp for sp in cspans.spans if sp.state == "shed"][0]
    assert shed.refusal_reasons
    assert {"attempt", "refused", "backoff"} <= {
        n for _, n, _ in shed.annotations}
    with pytest.raises(RuntimeError, match="already terminal"):
        shed.finish("ok", 0.0)


# -------------------------------------------------------- pump profiler
def test_server_pump_section_and_registry():
    e = _leader(PT, admission_max_writes=64)
    reg = PT.MetricsRegistry()
    pump = PT.PumpProfiler(registry=reg)

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port).connect()
        await asyncio.gather(*[c.submit(b"", bytes(e.cfg.entry_bytes))
                               for _ in range(16)])
        await c.close()
        return srv.stats()

    ps = serve(PT, PT.net.EngineBackend(e), scenario, registry=reg,
               pump=pump)["pump"]
    assert ps["iters"] >= 1 and ps["coverage"] >= 0.90
    assert set(ps["us_per_iter"]) >= {"coalesce", "ingest", "drive",
                                      "sweep", "flush"}
    assert ps["coalesce_batch"]["n"] >= 1
    assert ps["coalesce_batch"]["p99"] >= ps["coalesce_batch"]["p50"]
    assert ps["queue_age_us"]["n"] >= 16
    hist = reg.get("raft_net_pump_phase_seconds")
    assert hist is not None
    assert hist.summary(phase="drive")["count"] >= ps["iters"]
    assert reg.get("raft_net_coalesce_batch") is not None
    assert reg.get("raft_net_frame_queue_age_seconds") is not None


def test_pump_profiler_costs_zero_extra_device_fetches():
    def run(profiled: bool):
        e = _leader(PT, admission_max_writes=64, seed=3)
        fetches = [0]
        orig = e._fetch
        e._fetch = lambda x: (
            fetches.__setitem__(0, fetches[0] + 1), orig(x))[1]
        pump = PT.PumpProfiler() if profiled else None

        async def scenario(srv, port):
            c = await PT.net.WireClient("127.0.0.1", port).connect()
            for _ in range(6):
                await c.submit(b"", bytes(e.cfg.entry_bytes))
            await c.close()

        serve(PT, PT.net.EngineBackend(e), scenario, pump=pump)
        return fetches[0], int(e.commit_watermark)

    f_on, wm_on = run(True)
    f_off, wm_off = run(False)
    assert wm_on == wm_off >= 6 and f_on == f_off


# ----------------------------------------------------------- determinism
def serial_run(ns, traced: bool):
    """``tests/test_wire_trace.py``'s serial scenario (one connection, 12
    submits and 4 reads, seed 9): (commit watermark, per-op CRC, the
    applied values of the three keys)."""
    e = ns.engine(engine_cfg(ns, admission_max_writes=64, seed=9))
    kv = ns.ReplicatedKV(e)
    e.run_until_leader()
    srv_kw, cli_kw = {}, {}
    if traced:
        sspans, cspans, reg, pump = _traced_stack(ns, e)
        srv_kw = dict(spans=sspans, registry=reg, pump=pump)
        cli_kw = dict(spans=cspans, clock=lambda: e.clock.now)

    async def scenario(srv, port):
        c = await ns.net.WireClient("127.0.0.1", port, **cli_kw).connect()
        trace = []
        for i in range(12):
            r = await c.submit(b"dk%d" % (i % 3), b"dv%d" % i)
            trace.append(("ok", r.group, r.seq, r.floor))
            if i % 3 == 0:
                o = await c.read(b"dk0")
                trace.append(("rd", o.index, o.value))
        await c.close()
        return trace

    trace = serve(ns, ns.net.EngineBackend(e, kv), scenario, **srv_kw)
    crc = 0
    for item in trace:
        crc = zlib.crc32(repr(item).encode(), crc)
    return (int(e.commit_watermark), crc, kv.get(b"dk0"), kv.get(b"dk1"),
            kv.get(b"dk2"))


def test_serial_wire_pin_equal_to_jax_trace_on_and_off():
    """The determinism pin across packages: the watermark, the per-op
    CRC and the applied values are the JAX package's, with the trace
    plane armed and absent."""
    want = serial_run(JX, False)
    assert serial_run(PT, True) == serial_run(PT, False) == want
    assert serial_run(JX, True) == want
    assert want[0] >= 12 and want[2:] == (b"dv9", b"dv10", b"dv11")


# ----------------------------------------------------- joined forensics
def _explain(main, paths):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--explain", *paths])
    assert rc == 0
    return buf.getvalue()


def _port_explain(paths):
    from raft_tpu_torch.obs.__main__ import main

    return _explain(main, paths)


def _write_side(tmp_path, name, tracker):
    from raft_tpu_torch.obs.forensics import write_bundle

    return write_bundle(str(tmp_path), kind=name, seed=0, expected="-",
                        verdict="-", spans=tracker, extra={"side": name})


def test_refused_op_one_causal_chain_from_artifacts(tmp_path):
    e = _leader(PT, admission_max_writes=2)
    sspans, cspans, reg, pump = _traced_stack(PT, e)

    async def scenario(srv, port):
        c = await PT.net.WireClient("127.0.0.1", port, spans=cspans,
                                    retries=0,
                                    clock=lambda: e.clock.now).connect()
        outs = await asyncio.gather(
            *[c.submit(b"jk", bytes(e.cfg.entry_bytes)) for _ in range(8)],
            return_exceptions=True)
        await c.close()
        return outs

    outs = serve(PT, PT.net.EngineBackend(e), scenario, spans=sspans,
                 registry=reg, pump=pump)
    assert any(isinstance(o, PT.net.WireRefused) for o in outs)
    text = _port_explain([_write_side(tmp_path, "client", cspans),
                          _write_side(tmp_path, "server", sspans)])
    shed = [sp for sp in cspans.spans if sp.state == "shed"][0]
    block = text[text.index(f"trace 0x{shed.wire_trace:x}"):]
    block = block.split("\ntrace 0x")[0]
    assert "-> shed (depth)" in block
    i_att = block.index("[client]"), block.index("attempt")
    assert block.index("[server]") > i_att[0]
    assert i_att[1] < block.index("wire_ingest") < block.index("end:shed")
    assert "refused reason=depth" in block


def test_redialed_op_one_causal_chain_across_two_servers(tmp_path):
    cfg = engine_cfg(PT, admission_max_writes=16)

    class HintedBackend(PT.net.RouterBackend):
        def leader_hint(self, group):
            return "replica:1"

    eng_a, eng_b = PT.multi(cfg, 1), PT.multi(cfg, 1)
    eng_b.seed_leaders()
    spans_a, spans_b, cspans = (PT.SpanTracker(), PT.SpanTracker(),
                                PT.SpanTracker())
    eng_a.spans, eng_b.spans = spans_a, spans_b

    async def main():
        srv_a = PT.net.IngestServer(
            HintedBackend(PT.Router(eng_a, drive=False)), spans=spans_a)
        srv_b = PT.net.IngestServer(
            PT.net.RouterBackend(PT.Router(eng_b, drive=False)),
            spans=spans_b)
        port_a, port_b = await srv_a.start(), await srv_b.start()
        c = await PT.net.WireClient(
            "127.0.0.1", port_a, spans=cspans, retries=3,
            base_backoff_s=0.001, max_backoff_s=0.002,
            addr_map={"replica:1": ("localhost", port_b)},
            clock=lambda: eng_b.clock.now).connect()
        r = await c.submit(b"rk", bytes(cfg.entry_bytes))
        stats = c.stats.copy()
        await c.close()
        await srv_a.stop()
        await srv_b.stop()
        return r, stats

    r, stats = asyncio.run(main())
    assert stats["redials"] == 1 and eng_b.is_durable(r.group, r.seq)
    text = _port_explain([_write_side(tmp_path, "client", cspans),
                          _write_side(tmp_path, "server_a", spans_a),
                          _write_side(tmp_path, "server_b", spans_b)])
    sp, = cspans.spans
    block = text[text.index(f"trace 0x{sp.wire_trace:x}"):]
    assert "1 client op(s), 2 server span(s)" in text
    body = block.split("\n", 1)[1]
    assert "redial target=replica:1" in body
    assert body.index("attempt n=1") < body.index("not_leader")
    assert (body.index("redial") < body.index("attempt n=2")
            < body.index("end:ok"))
    assert body.index("end:shed") < body.index("attempt n=2")


def test_wire_drill_bundle_self_joins_in_both_clis(tmp_path):
    """The port drill's one bundle carries both span tables: a plain
    ``--explain`` of it appends the joined view, in the port's CLI and in
    JAX's (the bundle format is shared)."""
    from raft_tpu.obs.__main__ import main as jmain

    rep = PT.runner.wire_run(3, clients=2, ops_per_phase=4,
                             bundle_dir=str(tmp_path), device="cpu")
    assert rep.bundle_path is not None and rep.verdict == "LINEARIZABLE"
    for text in (_port_explain([rep.bundle_path]),
                 _explain(jmain, [rep.bundle_path])):
        assert "joined wire forensics" in text
        assert "client op(s)" in text


def test_joined_explain_rejects_non_bundles(tmp_path):
    p = tmp_path / "junk.json"
    p.write_text("{}")
    with pytest.raises(SystemExit):
        _port_explain([str(p), str(p)])
