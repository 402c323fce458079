"""The port's engine on the one-process replica mesh: ONE
``raft_tpu_torch.raft.RaftEngine`` over ``ReplicaMeshTransport`` of
``ReplicaMesh(["cpu"] * R·P)`` in this process, against the JAX
``RaftEngine`` over ``TpuMeshTransport(cfg, jax.devices()[:R·P])`` (the
virtual CPU devices of tests/conftest.py) and the port's single-device
engine, on the same seeds and schedules.

The schedules are tests/_mesh_ranks.py's ``SCENARIOS``, the JAX
package's mesh-engine cases (tests/test_engine_mesh.py: submit and read
back, failover, slow-follower heal, lapped rejoin, RS(5,3) on 5 blocks,
RS(4,2) on 4 x 2, grow and shrink; the restart with its vote log and
checkpoint; fuse_k 8 against 1; the recorded event ring; the chaos
schedule of tests/test_chaos.py and the slow-follower windows of
tests/test_differential_faults.py). At every
scenario's end the nodelog lines, terms, roles, watermark, leader, the
whole state, the committed bytes and the scenario's own reads equal the
JAX engine's, and every block's leaves equal its part of the JAX state
(``cut_row``), bit for bit. The reads are made as the JAX tests make
them, on the state alone (``committed_payloads(e.state, r)``): a
``BlockState`` carries its transport as its view.

The pins: no ``torch.distributed`` group exists, the collectives copy
nothing to the host, the engine's host reads are no more than the
single-device engine's on the same schedule, and ``make_transport``
decides as JAX's."""

import logging

import jax
import numpy as np
import pytest
import torch.distributed as dist

import raft_tpu.transport.tpu_mesh as jax_tpu_mesh
from raft_tpu.config import RaftConfig as JConfig
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core.state import (
    FIELDS,
    BlockState,
    committed_payloads,
    cut_row,
    log_entries,
    state_to_numpy,
)
from raft_tpu_torch.transport import (
    ReplicaMesh,
    ReplicaMeshTransport,
    SingleDeviceTransport,
)
from tests import _mesh_ranks as mr
from tests import test_torch_engine_mesh as em
from tests import test_torch_mesh2d as m2
from tests._torch_faults import MESH_CHAOS, check_chaos_invariants, mesh_chaos

assert_same = em.assert_same


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_mesh_programs():
    """JAX's mesh programs are cached process-wide: this module traces
    its own and leaves none behind."""
    jax.clear_caches()
    jax_tpu_mesh._PROGRAMS.clear()
    yield
    jax.clear_caches()
    jax_tpu_mesh._PROGRAMS.clear()


class StateOps(mr.PortOps):
    """The reads of JAX's tests, on the state alone."""

    def committed(self, e, r):
        return [bytes(p) for p in committed_payloads(e.state, r)]

    def log_entries(self, e, r, lo, hi):
        return [bytes(p) for p in log_entries(e.state, r, lo, hi)]

    def reconstruct(self, e, rows, lo, hi):
        from raft_tpu_torch.ec.reconstruct import reconstruct
        from raft_tpu_torch.ec.rs import RSCode

        code = RSCode(e.cfg.rows, e.cfg.rs_k)
        return [bytes(p) for p in reconstruct(e.state, code, rows, lo, hi)]

    def whole(self, e):
        return state_to_numpy(e.state)


def mesh_make(P: int = 1):
    return mr.port_make(
        "tpu_mesh",
        lambda cfg: ReplicaMeshTransport(
            cfg, ReplicaMesh(["cpu"] * cfg.rows * P), payload_shards=P),
        None if P == 1 else dict(payload_shards=P))


#: scenario -> (observations, engine) of its run on the CPU blocks, kept
#: for the cases that compare a second run of the port against it
_BLOCK_RUNS: dict = {}


def block_run(name, tmp_path_factory, P: int = 1):
    if name not in _BLOCK_RUNS:
        _BLOCK_RUNS[name] = mr.run_scenario(
            name, mesh_make(P), StateOps(),
            str(tmp_path_factory.mktemp("blocks")))
    return _BLOCK_RUNS[name]


def check(name, tmp_path_factory, P: int = 1) -> dict:
    """The scenario on one engine over the CPU blocks, held against the
    JAX mesh engine (and the single-device engine against it too);
    returns the scenario's result."""
    if P == 1:
        jobs, sobs = em.reference(name, tmp_path_factory)
    else:
        jobs, sobs = m2.reference(name)
    obs, e = block_run(name, tmp_path_factory, P)
    assert not dist.is_initialized()
    assert isinstance(e.state, BlockState) and e.t.processes == 1
    assert e.t.comm_host_copies() == 0, "a collective copied to the host"
    assert_same(obs["final"], jobs["final"], f"blocks {name}")
    assert_same(obs["result"], jobs["result"], f"blocks {name}")
    jwhole = {f: np.asarray(v, np.int32)
              for f, v in jobs["final"]["whole"].items()}
    for g in range(len(e.t.devices)):
        assert_same({f: getattr(e.state, f)[g].numpy() for f in FIELDS},
                    cut_row(jwhole, g, P), f"block {g} {name}")
    assert_same(sobs["final"], jobs["final"], f"single {name}")
    return obs["result"]


class TestEngineOnOneProcessMesh:
    """tests/test_engine_mesh.py:43 TestEngineOnMesh."""

    def test_submit_commits_and_reads_back(self, tmp_path_factory):
        res = check("submit", tmp_path_factory)
        assert res["got"] == [res["ps"]] * 3

    def test_failover_preserves_committed_entries(self, tmp_path_factory):
        res = check("failover", tmp_path_factory)
        assert res["got"] == res["ps"]

    def test_slow_follower_heals(self, tmp_path_factory):
        res = check("slow_heal", tmp_path_factory)
        assert res["before"] < res["wm"]
        assert res["after"] >= 6

    def test_lapped_replica_rejoins_via_snapshot(self, tmp_path_factory):
        res = check("lapped", tmp_path_factory)
        assert res["match"] >= 48
        assert res["got"] == res["want"]


class TestECOnOneProcessMesh:
    """tests/test_engine_mesh.py:101 TestECOnMesh (RS(5,3), 5 blocks) and
    :140 TestECWithPayloadShardsOnMesh (RS(4,2), 4 x 2 blocks)."""

    def test_submit_commit_reconstruct_roundtrip(self, tmp_path_factory):
        res = check("ec_roundtrip", tmp_path_factory)
        assert res["got"] == [res["ps"]] * 3

    def test_healing_by_reconstruction(self, tmp_path_factory):
        res = check("ec_heal", tmp_path_factory)
        assert res["before"] < 8 <= res["after"]
        assert res["got"] == res["ps"]

    def test_payload_shards_roundtrip(self, tmp_path_factory):
        res = check("ec2d_roundtrip", tmp_path_factory, P=2)
        assert res["got"] == [res["ps"]] * 3

    def test_payload_shards_slow_follower_heals(self, tmp_path_factory):
        res = check("ec2d_heal", tmp_path_factory, P=2)
        assert res["after"] >= 6 and res["got"] == res["ps"]


def test_grow_and_shrink_on_one_process_mesh(tmp_path_factory):
    """tests/test_engine_mesh.py:196: spare rows sit on their blocks from
    the start; a fourth voter joins, heals and leaves."""
    res = check("membership", tmp_path_factory)
    assert res["added"] == (True, 4)
    assert res["joiner"][0] >= res["joiner"][1] - 4
    assert res["removed"] == (False, 3)
    final = res["committed"][res["leader"]]
    for r in range(3):
        got = res["committed"][r]
        assert got == final[:len(got)], f"replica {r}"


def test_save_and_restore(tmp_path_factory):
    """tests/test_restart.py:43 with a vote log: the checkpoint member
    for member and the vote log byte for byte as the JAX engine's, and
    the restored engine reads back what was committed."""
    res = check("restart", tmp_path_factory)
    assert res["votes"]
    assert res["restored"] == [res["pre"]] * 3
    assert res["tails"] == [res["pre"] + res["post"]] * 3


def test_fused_window_equals_single_ticks(tmp_path_factory):
    """tests/test_fused_ticks.py:394: fuse_k 8 equals fuse_k 1 (log,
    stamps, clock, lines), with fusion engaged, run eagerly."""
    res = check("fused", tmp_path_factory)
    one, eight = res[1], res[8]
    assert eight["launches"] > 0 and one["launches"] == 0
    assert_same(eight["whole"]["log_payload"], one["whole"]["log_payload"])
    assert eight["commit_time"] == one["commit_time"]
    assert eight["lines"] == one["lines"]


def test_one_recorded_event_ring(tmp_path_factory):
    """tests/test_device_obs.py:486: the recorded programs on every
    block give the host's elect/commit lines, and the engine's one ring
    (block 0's) packs as the JAX engine's."""
    res = check("device_obs", tmp_path_factory)
    assert res["dev"] == res["host"] and res["dev"]


@pytest.mark.parametrize("name", ["ec_restart", "pipeline",
                                  "pipeline_ec"])
def test_more_mesh_scenarios(name, tmp_path_factory):
    """tests/test_restart.py:163 (the EC cluster's checkpoint and
    restore) and tests/test_pipeline.py:54, :85 (``submit_pipelined`` on
    the mesh, the scanned path on the CPU)."""
    res = check(name, tmp_path_factory)
    assert res["durable"] if "pipeline" in name else \
        res["after"] == res["pre"] + res["post"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slow_follower_differential(seed, tmp_path_factory):
    """tests/test_differential_faults.py:70-96, its mesh case
    (``mk_engine(mesh=True)``, :44-54, JAX's one-process
    ``TpuMeshTransport``): the engine half equal to the JAX engine's, and
    every replica's committed log the golden oracle's."""
    from raft_tpu.golden import GoldenCluster

    res = check(f"slow_window_{seed}", tmp_path_factory)
    ps = res["ps"]
    c = GoldenCluster(3, seed=seed)
    g_lead = c.run_until_leader()
    slow_name = f"Server{(int(g_lead.id.removeprefix('Server')) + 1) % 3}"
    c.set_slow(slow_name, True)
    for p in ps[:5]:
        g_lead.client_append(p)
    em._golden_settle(c)
    c.set_slow(slow_name, False)
    for p in ps[5:]:
        g_lead.client_append(p)
    em._golden_settle(c)
    for r in range(3):
        assert res["committed"][r] == ps, f"engine replica {r}"
    assert g_lead.committed_payloads() == res["committed"][res["leader"]]


def test_chaos_over_one_process_mesh(tmp_path_factory):
    """tests/test_chaos.py:266 ``test_chaos_over_mesh_transport`` on JAX's
    one-process ``TpuMeshTransport``: the chaos schedule (crashes, slow
    windows, campaigns, partitions and membership changes;
    ``Random(61000)``, 7 phases of 35 s) on one engine over 5 CPU blocks
    for ``max_replicas=5``. Its nodelog lines, majority-side snapshots,
    committed payloads, leaders by term, every block's leaves and the
    whole state equal the JAX engine's (compared in ``check``), and the
    run upholds ``check_invariants``."""
    res = check("chaos", tmp_path_factory)
    check_chaos_invariants(res, 5)
    assert res["snaps"] and res["watermark"] >= 1


def test_chaos_fused_equals_single_ticks(tmp_path_factory):
    """The port's own case: the chaos schedule at ``fuse_k`` 8 on the
    one-process mesh equals it at ``fuse_k`` 1 (lines, commit stamps,
    committed bytes, the chaos outcome and every block's leaves), with
    fusion engaged. Fusion may change when work runs, never what
    commits."""
    one_obs, one = block_run("chaos", tmp_path_factory)
    e = mesh_make()(dict(MESH_CHAOS, fuse_k=8), recorder=True)
    out = mesh_chaos(e, StateOps().committed)
    assert e.fused_launches > 0 and one.fused_launches == 0
    assert e.lines == one.lines
    assert e.commit_time == one.commit_time
    assert_same(out, one_obs["result"], "chaos fuse_k 8")
    assert_same(mr.final_obs(e, StateOps()), one_obs["final"],
                "chaos fuse_k 8 final")


def _count_reads(t) -> dict:
    """Count the engine's host reads through transport ``t``: ``fetch``
    and the gathering fetches."""
    counts = {"reads": 0}
    for name in ("fetch", "fetch_rows", "fetch_row", "fetch_row_lanes",
                 "gather_window", "log_terms"):
        inner = getattr(t, name, None)
        if inner is None:
            continue

        def wrapped(*a, _inner=inner, **kw):
            counts["reads"] += 1
            return _inner(*a, **kw)
        setattr(t, name, wrapped)
    return counts


def test_host_reads_are_no_more_than_the_single_device_engines():
    """The same schedule (election, 40 entries, a slow follower and its
    heal) on one engine over 3 CPU blocks and on the single-device
    engine: the same lines and leader ticks, and no more host reads a
    leader tick on the mesh."""
    from raft_tpu_torch.raft import RaftEngine

    kw = dict(n_replicas=3, entry_bytes=16, batch_size=4, log_capacity=128,
              seed=3)
    out = {}
    for kind, make in (
            ("single", lambda c: SingleDeviceTransport(c, device="cpu")),
            ("mesh", lambda c: ReplicaMeshTransport(
                c, ReplicaMesh(["cpu"] * 3)))):
        cfg = TConfig(**kw, transport="tpu_mesh")
        t = make(cfg)
        lines = []
        e = RaftEngine(cfg, t, trace=lines.append)
        counts = _count_reads(t)
        lead = e.run_until_leader()
        e.set_slow((lead + 1) % 3, True)
        seqs = [e.submit(p) for p in mr.payloads(40, seed=4)]
        e.run_until_committed(seqs[-1])
        e.set_slow((lead + 1) % 3, False)
        e.run_for(3 * cfg.heartbeat_period)
        out[kind] = (lines, e._tick_count, counts["reads"])
    assert out["mesh"][0] == out["single"][0]
    assert out["mesh"][1] == out["single"][1] > 0
    assert out["mesh"][2] <= out["single"][2]


class TestMakeTransportDecidesAsJax:
    """``make_transport(cfg, devices=)`` against JAX's
    ``make_transport(cfg, devices)`` (tests/test_engine_mesh.py:175)."""

    KW = dict(n_replicas=3, entry_bytes=16, batch_size=4, log_capacity=64)

    def _both(self, caplog, n_devices, **kw):
        from raft_tpu.transport import make_transport as jmake
        from raft_tpu_torch.transport import make_transport

        with caplog.at_level(logging.WARNING):
            jt = jmake(JConfig(**self.KW, **kw),
                       devices=jax.devices()[:n_devices])
            tt = make_transport(TConfig(**self.KW, **kw), device="cpu",
                                devices=["cpu"] * n_devices)
        return jt, tt

    @pytest.mark.parametrize("transport", ["tpu_mesh", "multihost"])
    def test_enough_devices_give_the_one_process_mesh(self, caplog,
                                                      transport):
        jt, tt = self._both(caplog, 4, transport=transport)
        assert type(jt).__name__ == "TpuMeshTransport"
        assert isinstance(tt, ReplicaMeshTransport)
        assert len(tt.devices) == 3 and tt.processes == 1
        assert not caplog.records

    def test_too_few_devices_fall_back_with_jaxs_text(self, caplog):
        """The counterpart of JAX's ``test_fallback_warns``: 3 x 4 payload
        shards over 8 devices."""
        jt, tt = self._both(caplog, 8, transport="tpu_mesh",
                            payload_shards=4)
        assert type(jt).__name__ == "SingleDeviceTransport"
        assert isinstance(tt, SingleDeviceTransport)
        said = {r.name: r.getMessage() for r in caplog.records
                if "falling back" in r.getMessage()}
        assert said["raft_tpu_torch.transport.base"] == \
            said["raft_tpu.transport.base"]
        assert "needs 12 devices (3 replicas x 4 payload shards) but only " \
               "8 are visible" in said["raft_tpu.transport.base"]

    def test_headroom_is_refused_with_jaxs_text(self, caplog):
        with pytest.raises(ValueError) as want:
            self._both(caplog, 5, transport="tpu_mesh", max_replicas=5)
        from raft_tpu_torch.transport import make_transport

        with pytest.raises(ValueError) as got:
            make_transport(TConfig(**self.KW, transport="tpu_mesh",
                                   max_replicas=5), device="cpu",
                           devices=["cpu"] * 5)
        assert str(got.value) == str(want.value)
        assert "need 5 devices (5 replica rows x 1 payload shards), got 3" \
            in str(got.value)

    def test_multihost_with_too_few_devices_falls_back(self, caplog):
        jt, tt = self._both(caplog, 2, transport="multihost")
        assert isinstance(tt, SingleDeviceTransport)
        said = [r.getMessage() for r in caplog.records
                if "multihost placement unavailable" in r.getMessage()]
        assert len(said) == 2 and said[0] == said[1]
