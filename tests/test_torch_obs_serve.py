"""The ops surface of the port (``raft_tpu_torch.obs.serve``) against the
JAX package's: ``StatusBoard`` semantics through both packages, JAX
``tests/test_serve.py``'s ``test_serve_single_engine_status_and_
unattached_endpoints`` on the port's engine, and both packages' servers
answering every endpoint with the same status code and body while their
engines run in lock step (the full plane attached). The port's
``/profile`` and ``serve_demo`` refuse, naming ROADMAP A16b and A14.
Every server binds ``127.0.0.1``, port 0."""

import json
import urllib.error
import urllib.request

import pytest

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


def test_profile_endpoint_refuses_naming_a16b():
    with OpsServer(board=StatusBoard(), port=0) as srv:
        st, body = _get(srv.port, "/profile?seconds=0.1")
    assert st == 501
    assert "ROADMAP A16b" in json.loads(body)["error"]


def test_serve_demo_refuses_naming_a14():
    with pytest.raises(NotImplementedError, match="ROADMAP A14, A16b"):
        serve_demo(port=0, groups=2, duration_s=0.1)
    with pytest.raises(SystemExit, match="ROADMAP A14, A16b"):
        obs_main(["--serve"])
