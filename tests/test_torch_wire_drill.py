"""The port's wire drill (``raft_tpu_torch.chaos.runner.wire_run``) and the
wire seam (``raft_tpu_torch.cluster.netfault``) on the CPU against the JAX
package. The drill's interleaving over real sockets is outside seeded
replay, so it is held by the checker's verdict and JAX's pinned
invariants (``tests/test_net_wire.py:400-423``), with the op total equal
to JAX's, traced and untraced; the CLI's ``--wire`` exits 0; and the two
packages' ``FaultyConn`` deliver the same bytes and count the same faults
under one plan."""

import asyncio
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests._torch_chaos import jax_run
from tests._torch_net import pkg

ROOT = Path(__file__).resolve().parent.parent
JX, PT = pkg("raft_tpu"), pkg("raft_tpu_torch")


def _check_invariants(rep, traced):
    assert rep.verdict == "LINEARIZABLE"
    assert all(c.verdict == "LINEARIZABLE" for c in rep.per_class.values())
    assert rep.shed_writes >= 1
    assert rep.not_leader_frames >= 1
    assert rep.leader_kills == 1
    assert rep.wire_refusals.get("depth", 0) >= 1
    assert rep.op_counts.get("ok", 0) > 50
    assert rep.commit_digest
    assert rep.traced is traced
    if traced:
        assert rep.client_spans == rep.ops
        assert rep.server_spans >= rep.ops
        assert rep.pump is not None and rep.pump["coverage"] >= 0.9
    else:
        assert rep.client_spans == 0 and rep.pump is None


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "untraced"])
def test_wire_drill_seed7_holds_jax_invariants(traced):
    rep = PT.runner.wire_run(7, trace=traced, device="cpu")
    _check_invariants(rep, traced)
    want = jax_run("wire_run", 7, trace=traced)
    assert rep.ops == want["ops"] == 144
    assert want["verdict"] == rep.verdict
    assert set(rep.per_class) == set(want["per_class"])
    assert rep.repro == ("python -m raft_tpu_torch.chaos --wire --seed 7"
                         + ("" if traced else " (untraced)"))
    assert rep.net["requests_total"]["hello"] == 5    # 4 clients + flood


def test_wire_drill_needs_the_card_unless_the_cpu_is_named():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the drill would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.runner.wire_run(7)


def test_cli_wire_seed7_exits_zero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.chaos", "--wire", "--seed",
         "7", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert '"verdict": "LINEARIZABLE"' in r.stdout.splitlines()[-1]
    assert "raft_tpu." not in r.stderr


# ------------------------------------------------------------ the seam
def _frames():
    P = JX.P
    out = []
    for i in range(24):
        if i % 3 == 0:
            out.append(P.encode_peer_append(
                1, 2, i, 1, i, i, [(2, bytes([i]) * (40 + i))] * 3))
        elif i % 3 == 1:
            out.append(P.encode_peer_vote(1, i, i, 1))
        else:
            out.append(P.encode_ok(i, 0, i, i))
    return out


def _faulty_run(mod_name, root, plan):
    """Two connections (a redial) through ``mod_name``'s ``FaultyConn``
    for peer 1 under ``plan``: (bytes each connection delivered, the
    NetFaults stats, the published stats file)."""
    nf = importlib.import_module(mod_name)
    nf.write_net_plan(root, plan)
    faults = nf.NetFaults(root)

    async def main():
        got = []

        async def sink(reader, writer):
            buf = b""
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                buf += data
            got.append(buf)
            writer.close()

        srv = await asyncio.start_server(sink, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        for k in range(2):
            conn = await nf.dial("127.0.0.1", port, faults=faults, peer=1)
            for f in _frames():
                conn.write(f)
            await conn.drain()
            await asyncio.sleep(0.02)
            conn.close()
            for _ in range(200):          # the sink saw this one's EOF
                if len(got) > k:
                    break
                await asyncio.sleep(0.01)
        srv.close()
        await srv.wait_closed()
        return got

    delivered = asyncio.run(main())
    faults._publish(force=True)
    return delivered, dict(faults.stats), nf.read_net_stats(root)


@pytest.mark.parametrize("plan", [
    {"seed": 3, "dup_every": 3, "corrupt_every": 4, "torn_every": 9},
    {"seed": 5, "dup_every": 2, "corrupt_every": 3, "replay_redial": True},
], ids=["torn_dup_corrupt", "dup_corrupt_replay"])
def test_faulty_conn_equal_to_jax(tmp_path, plan):
    want = _faulty_run("raft_tpu.cluster.netfault", str(tmp_path / "j"),
                       plan)
    got = _faulty_run("raft_tpu_torch.cluster.netfault",
                      str(tmp_path / "t"), plan)
    assert got == want
    delivered, stats, published = got
    assert published == stats
    assert stats["frames_dup"] > 0 and stats["frames_corrupt_injected"] > 0
    if "torn_every" in plan:
        assert stats["conns_torn"] > 0
    else:
        assert stats["frames_replayed"] > 0
    assert sum(map(len, delivered)) > 0


def test_plan_merge_and_passthrough_equal_to_jax(tmp_path):
    from raft_tpu.cluster import netfault as J
    from raft_tpu_torch.cluster import netfault as T

    for mod, d in ((J, tmp_path / "j"), (T, tmp_path / "t")):
        mod.write_net_plan(str(d), {"seed": 1, "deny": [2]})
        mod.merge_net_plan(str(d), {"deny": None, "dup_every": 2,
                                    "to": {"3": {"torn_every": 5}}})
    assert ((tmp_path / "t" / "net.json").read_bytes()
            == (tmp_path / "j" / "net.json").read_bytes())
    fj, ft = J.NetFaults(str(tmp_path / "j")), T.NetFaults(str(tmp_path / "t"))
    for peer, client in ((None, False), (3, False), (1, True)):
        assert ft.plan_for(peer, client) == fj.plan_for(peer, client)
    assert ft.plan_for(None, client=True) is None
    assert T.read_net_stats(str(tmp_path / "none")) == {}


def _faulted_server(ns, nf, root):
    """Four serial submits through ``ns``'s server whose accepted
    connections ride ``nf.NetFaults(root)`` under a client-scoped plan
    that duplicates every second frame: (results, the faults' stats)."""
    from tests._torch_net import engine_cfg, serve

    nf.write_net_plan(root, {"seed": 2, "clients": True, "dup_every": 2})
    faults = nf.NetFaults(root)
    e = ns.engine(engine_cfg(ns))
    e.run_until_leader()

    async def scenario(srv, port):
        c = await ns.net.WireClient("127.0.0.1", port).connect()
        out = [(r.seq, r.floor) for r in
               [await c.submit(b"", bytes(32)) for _ in range(4)]]
        await c.close()
        return out

    out = serve(ns, ns.net.EngineBackend(e), scenario, netfaults=faults)
    return out, dict(faults.stats)


def test_server_wraps_every_connection_in_the_seam(tmp_path):
    from raft_tpu.cluster import netfault as J
    from raft_tpu_torch.cluster import netfault as T

    got = _faulted_server(PT, T, str(tmp_path / "t"))
    assert got == _faulted_server(JX, J, str(tmp_path / "j"))
    out, stats = got
    assert [s for s, _ in out] == [1, 2, 3, 4]
    assert stats["conns"] == 1 and stats["frames_dup"] >= 2


def test_exports_are_jax_names():
    """``raft_tpu_torch.net`` exports JAX's ``__all__``, minus nothing,
    and the chaos package exports the wire drill beside the other
    runners."""
    import raft_tpu.net as jnet
    import raft_tpu_torch.chaos as tchaos
    import raft_tpu_torch.net as tnet

    assert tnet.__all__ == jnet.__all__
    for name in tnet.__all__:
        assert getattr(tnet, name).__module__.startswith("raft_tpu_torch.")
    assert {"wire_run", "WireReport"} <= set(tchaos.__all__)
