"""The ops surface of the port (``raft_tpu_torch.obs.serve``) against the
JAX package's: ``StatusBoard`` semantics through both packages, JAX
``tests/test_serve.py``'s ``test_serve_single_engine_status_and_
unattached_endpoints`` on the port's engine, and both packages' servers
answering every endpoint with the same status code and body while their
engines run in lock step (the full plane attached). With the compile
and memory watches attached, ``/compile``, ``/memory`` and ``/status``
serve them and ``/profile`` captures while the engine ticks on another
thread (JAX ``tests/test_serve.py``'s ``test_compile_memory_profile_
endpoints``, with its 400 answers and a 409 while a capture runs);
``serve_demo(device="cpu")`` and ``python -m raft_tpu_torch.obs --serve``
run for about a second. The two tests that checked the refusals before
the planes were ported keep their names.
Every server binds ``127.0.0.1``, port 0."""

import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from raft_tpu.obs.serve import OpsServer as JOps
from raft_tpu.obs.serve import StatusBoard as JBoard
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs.__main__ import main as obs_main
from raft_tpu_torch.obs.serve import OpsServer, StatusBoard, serve_demo
from raft_tpu_torch.raft.engine import RaftEngine
from raft_tpu_torch.transport import SingleDeviceTransport
from tests.test_torch_obs_engine import ObsPair
from tests.test_torch_engine import payloads


def _get(port, path, timeout=10):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout
        ) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as ex:      # 404s carry a JSON body too
        return ex.code, ex.read().decode()


@pytest.mark.parametrize("Board", [JBoard, StatusBoard], ids=["jax", "torch"])
def test_publish_compose_sections(Board):
    b = Board()
    assert b.compose() == {"board_generation": 0}
    b.publish({"t_virtual": 1.0, "leaders": {}})
    b.publish({"0": "open"}, section="breakers")
    snap = b.compose()
    assert snap == {"t_virtual": 1.0, "leaders": {},
                    "breakers": {"0": "open"}, "board_generation": 2}


@pytest.mark.parametrize("Board", [JBoard, StatusBoard], ids=["jax", "torch"])
def test_reader_holds_consistent_snapshot(Board):
    b = Board()
    b.publish({"v": 1})
    old = b.compose()
    b.publish({"v": 2})
    assert old["v"] == 1 and b.compose()["v"] == 2


def test_serve_single_engine_status_and_unattached_endpoints():
    cfg = RaftConfig(n_replicas=3, entry_bytes=32, batch_size=4,
                     log_capacity=64, transport="single")
    e = RaftEngine(cfg, SingleDeviceTransport(cfg, device="cpu"))
    board = StatusBoard()
    e.status_board = board
    e.run_until_leader()
    seq = e.submit(bytes(cfg.entry_bytes))
    e.run_until_committed(seq)
    with OpsServer(board=board, port=0) as srv:
        st, body = _get(srv.port, "/status")
        snap = json.loads(body)
        assert st == 200 and snap["groups"] == 1
        assert snap["commit_watermark"]["0"] >= 1
        assert snap["leaders"]["0"]["replica"] == e.leader_id
        # unattached planes answer 404, not 500
        assert _get(srv.port, "/metrics")[0] == 404
        assert _get(srv.port, "/slo")[0] == 404


ENDPOINTS = ("/status", "/metrics", "/slo", "/healthz", "/compile",
             "/memory", "/nope")


def test_both_servers_answer_alike_during_a_run():
    """Both engines in lock step with the full plane; mid-run and at the
    end, every endpoint of the two servers answers the same code and
    body (``/status`` is the board's snapshot plus the audit summary)."""
    p = ObsPair(31)
    (jstack, jboard), (tstack, tboard) = p.planes
    servers = [
        cls(board=board, registry=stack.registry, slo=stack.slo,
            auditor=stack.audit, spans=stack.spans, port=0)
        for cls, (stack, board) in ((JOps, p.planes[0]), (OpsServer,
                                                          p.planes[1]))
    ]
    for s in servers:
        s.start()
    try:
        p.until_leader()
        for round_no in range(3):
            seqs = p.submit_spanned(payloads(6, 31 + round_no))
            p.until_committed(seqs[-1])
            for path in ENDPOINTS:
                got = [_get(s.port, path) for s in servers]
                if path == "/nope":
                    # the endpoint list differs only by what the body says
                    assert got[0][0] == got[1][0] == 404
                    continue
                assert got[1] == got[0], path
        st, body = _get(servers[1].port, "/status")
        snap = json.loads(body)
        assert st == 200 and snap == json.loads(json.dumps(
            tboard.compose() | {"audit": tstack.audit.summary()}))
        assert snap["audit"]["violations_total"] == 0
        st, text = _get(servers[1].port, "/metrics")
        from raft_tpu_torch.obs.registry import parse_prometheus
        parsed = parse_prometheus(text)
        assert parsed["raft_commits_total"][(("group", "0"),)] == \
            p.t.committed_total
        assert json.loads(_get(servers[1].port, "/healthz")[1])[
            "status"] == "ok"
    finally:
        for s in servers:
            s.stop()


def test_profile_endpoint_refuses_naming_a16b(tmp_path):
    """The lifted ``/profile`` (and ``/compile``, ``/memory``, ``/status``
    with the watches attached): JAX's endpoint test on the port's engine,
    on the CPU."""
    import threading

    from raft_tpu_torch.obs import profiling
    from raft_tpu_torch.obs.compile import (
        CompileWatch,
        RetraceSentinel,
        labeled,
    )
    from raft_tpu_torch.obs.memory import MemoryWatch
    from raft_tpu_torch.obs.registry import MetricsRegistry
    from raft_tpu_torch.obs.spans import SpanTracker

    cfg = RaftConfig(n_replicas=3, entry_bytes=32, batch_size=4,
                     log_capacity=64, transport="single")
    e = RaftEngine(cfg, SingleDeviceTransport(cfg, device="cpu"))
    board = StatusBoard()
    e.status_board = board
    e.spans = spans = SpanTracker()
    watch = CompileWatch(registry=MetricsRegistry()).install()
    sentinel = RetraceSentinel(watch)
    mem = MemoryWatch()
    mem.watch_engine(e)
    stop = threading.Event()
    try:
        e.run_until_leader()
        sp = spans.begin("write", e.clock.now, client=0, key=b"k")
        spans.current = sp
        seq = e.submit(bytes(cfg.entry_bytes))
        spans.current = None
        e.run_until_committed(seq)
        sp.finish("ok", e.clock.now)
        labeled("probe", lambda x: x * 3)(torch.ones(11))
        sentinel.freeze()

        def driver():
            while not stop.is_set():
                e.run_for(2 * cfg.heartbeat_period)
                time.sleep(0.005)

        th = threading.Thread(target=driver, daemon=True)
        with OpsServer(board=board, compile_watch=watch, memory=mem,
                       spans=spans, profile_dir=str(tmp_path),
                       port=0) as srv:
            st, body = _get(srv.port, "/compile")
            comp = json.loads(body)
            assert st == 200
            assert comp["programs"]["single.replicate"]["launches"] > 0
            assert comp["programs"]["probe"]["traces"] == 1
            assert comp["sentinel"]["frozen"] is True
            st, body = _get(srv.port, "/memory")
            m = json.loads(body)
            assert st == 200 and m["census"]["n_arrays"] > 0
            assert "engine.state.log_payload" in m["census"]["by_label"]
            snap = json.loads(_get(srv.port, "/status")[1])
            assert snap["compile"]["frozen"] is True
            assert snap["memory"]["live_bytes"] > 0
            th.start()
            st, body = _get(srv.port, "/profile?seconds=0.2", timeout=120)
            assert st == 200, body
            res = json.loads(body)
            art = json.loads(open(res["artifact"]).read())
            assert art["format"] == profiling.PROFILE_FORMAT
            assert res["n_span_events"] > 0
            assert res["artifact"].startswith(str(tmp_path))
            for bad in ("bogus", "nan", "inf"):
                st, body = _get(srv.port, f"/profile?seconds={bad}")
                assert st == 400
                assert "finite" in json.loads(body)["error"]
            # a capture in flight answers 409
            release = threading.Event()
            hold = threading.Thread(target=profiling.capture_profile, args=(
                0.0,), kwargs=dict(profile_dir=str(tmp_path / "held"),
                                   sleep=lambda s: release.wait(30)))
            hold.start()
            while not profiling.capture_active():
                time.sleep(0.01)
            st, body = _get(srv.port, "/profile?seconds=0.1")
            release.set()
            hold.join(60)
            assert st == 409 and "in flight" in json.loads(body)["error"]
    finally:
        stop.set()
        watch.uninstall()


def test_serve_demo_serves_the_lifted_demo(capsys):
    """The lifted demo: ``serve_demo(device="cpu")`` boots the
    ``MultiEngine`` with both watches and serves while it drives traffic,
    and ``python -m raft_tpu_torch.obs --serve`` runs it. The demo serves
    until the test stops it (``stop=``), and the queries wait for the
    demo's first commit (``raft_commits_total`` on ``/metrics``): on a
    loaded machine the serving thread may not have driven a window, nor
    the server stayed up, within any fixed wall-clock window."""
    import io
    import threading

    from raft_tpu_torch.obs.registry import parse_prometheus

    out, box, stop = io.StringIO(), {}, threading.Event()
    th = threading.Thread(target=lambda: box.update(r=serve_demo(
        port=0, groups=2, out=out, device="cpu", stop=stop)))
    th.start()
    try:
        t0 = time.monotonic()
        while "127.0.0.1:" not in out.getvalue():
            assert th.is_alive() and time.monotonic() - t0 < 300
            time.sleep(0.02)
        port = int(out.getvalue().split("127.0.0.1:")[1].split(" ")[0])
        while True:
            st, text = _get(port, "/metrics", timeout=300)
            commits = parse_prometheus(text).get("raft_commits_total", {})
            if st == 200 and sum(commits.values()) > 0:
                break
            assert th.is_alive() and time.monotonic() - t0 < 300
            time.sleep(0.02)
        answers = {p: _get(port, p, timeout=300)
                   for p in ("/compile", "/memory", "/status")}
    finally:
        stop.set()
        th.join(300)
    assert not th.is_alive()
    for path, (st, body) in answers.items():
        assert st == 200, path
    comp = json.loads(answers["/compile"][1])
    assert comp["programs"]["group.replicate"]["launches"] > 0
    mem = json.loads(answers["/memory"][1])
    assert any(k.startswith("multi.state.")
               for k in mem["census"]["by_label"])
    status = json.loads(answers["/status"][1])
    assert "compile" in status and "memory" in status
    res = box["r"]
    assert res["submitted"] > 0 and res["committed"] > 0
    assert res["violations"] == 0 and res["compile_violations"] == 0
    assert obs_main(["--serve", "--port", "0", "--serve-groups", "2",
                     "--serve-duration", "0.5", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "ops endpoint on http://127.0.0.1:" in lines[0]
    got = json.loads(lines[-1])
    assert got["submitted"] > 0 and got["violations"] == 0
