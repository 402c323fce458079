"""The port's engine over the mesh: ``raft_tpu_torch.raft.RaftEngine`` as R
lock-step mirrors, one a spawned gloo rank on the CPU, each rank holding
its own replica row (``MeshTransport``), against the JAX ``RaftEngine`` on
``TpuMeshTransport`` (the virtual CPU devices of tests/conftest.py) and
against the port's own single-device engine, on the same seeds and
schedules.

The schedules are the JAX package's mesh-engine cases, written once in
``tests/_mesh_ranks.py`` against the engine API: tests/test_engine_mesh.py
(TestEngineOnMesh, TestECOnMesh, TestMembershipOverMesh), the two mesh
restarts of tests/test_restart.py, the mesh pipeline cases of
tests/test_pipeline.py, the mesh slow-follower shape of
tests/test_differential_faults.py, TestMeshFused of
tests/test_fused_ticks.py (fuse_k 8 against 1) and
test_mesh_recorded_byte_compat of tests/test_device_obs.py. On every rank,
at every scenario's end, the nodelog lines, terms, roles, watermark and
leader, the gathered whole state, the committed bytes and the scenario's
own reads equal the JAX engine's, and that rank's own state leaves equal
its row of the JAX state (``cut_row``), bit for bit; the single-device
engine gives the same. Each case then applies the JAX test's assertions to
the port's results. The rank sets run once per module (3 and 5 ranks).
"""

import logging
import re

import jax
import numpy as np
import pytest

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.raft import RaftEngine as JEngine
from raft_tpu.transport import TpuMeshTransport
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core.state import FIELDS, cut_row
from raft_tpu_torch.transport import SingleDeviceTransport
from raft_tpu_torch.transport.launch import run_ranks
from tests import _mesh_ranks as mr

NAMES = {w: [n for n, (size, _) in mr.SCENARIOS.items() if size == w]
         for w in (3, 5)}


@pytest.fixture(scope="module")
def ranks3():
    return run_ranks(mr.engine_scenarios, 3, (NAMES[3],), timeout=400)


@pytest.fixture(scope="module")
def ranks5():
    return run_ranks(mr.engine_scenarios, 5, (NAMES[5],), timeout=400)


class JaxOps:
    """The JAX engine's reads for the shared scenarios (one process: the
    mesh state is addressable whole)."""

    def rows(self, e, leaf):
        return np.asarray(getattr(e.state, leaf))

    def committed(self, e, r):
        from raft_tpu.core.state import committed_payloads

        return [bytes(p) for p in committed_payloads(e.state, r)]

    def log_entries(self, e, r, lo, hi):
        from raft_tpu.core.state import log_entries

        return [bytes(p) for p in log_entries(e.state, r, lo, hi)]

    def reconstruct(self, e, rows, lo, hi):
        from raft_tpu.ec.reconstruct import reconstruct
        from raft_tpu.ec.rs import RSCode

        code = RSCode(e.cfg.rows, e.cfg.rs_k)
        return [bytes(p) for p in reconstruct(e.state, code, rows, lo, hi)]

    def packed(self, e):
        from raft_tpu.obs.device import packed_flush

        return np.asarray(packed_flush(e._dev_ring))

    def whole(self, e):
        return {f: np.asarray(getattr(e.state, f)) for f in FIELDS}

    def recorder(self):
        from raft_tpu.obs import FlightRecorder

        return FlightRecorder()


def jax_make(over, restore=None, recorder=False, vote_log=None):
    cfg = JConfig(**{**mr.BASE, **over, "transport": "tpu_mesh"})
    t = TpuMeshTransport(cfg, jax.devices()[:cfg.rows])
    lines = []
    kw = dict(trace=lines.append, vote_log=vote_log,
              recorder=JaxOps().recorder() if recorder else None)
    if restore is not None:
        e = JEngine.restore(cfg, restore, t, **kw)
    else:
        e = JEngine(cfg, t, **kw)
    e.lines = lines
    return e


_RUNS: dict = {}


def reference(name, tmp_path_factory):
    """(JAX mesh engine, port single-device engine) observations of one
    scenario, run once per module."""
    if name not in _RUNS:
        jobs, _ = mr.run_scenario(name, jax_make, JaxOps(),
                                  str(tmp_path_factory.mktemp("jax")))
        single = mr.port_make("single", lambda cfg: SingleDeviceTransport(
            cfg, device="cpu"))
        sobs, _ = mr.run_scenario(name, single, mr.PortOps(),
                                  str(tmp_path_factory.mktemp("single")))
        _RUNS[name] = (jobs, sobs)
    return _RUNS[name]


def assert_same(got, want, path="obs"):
    """Deep, exact equality of observations (lists, dicts, bytes, ints,
    numpy arrays)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            f"{path}: {len(got)} != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, f"{path}: {got.shape} {want.shape}"
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


def check(name, ranks, tmp_path_factory) -> dict:
    """Every rank of the mirrored port against the JAX mesh engine, and
    the port's single-device engine too; returns rank 0's result."""
    jobs, sobs = reference(name, tmp_path_factory)
    jwhole = jobs["final"]["whole"]
    for rank, robs in enumerate(ranks):
        got = robs[name]
        assert_same(got["final"], jobs["final"], f"rank {rank} {name}")
        assert_same(got["result"], jobs["result"], f"rank {rank} {name}")
        mine = cut_row({f: np.asarray(v, np.int32)
                        for f, v in jwhole.items()}, rank)
        assert_same(got["local"], mine, f"rank {rank} {name} own row")
    assert_same(sobs["final"], jobs["final"], f"single {name}")
    assert_same(sobs["result"], jobs["result"], f"single {name}")
    return ranks[0][name]["result"]


class TestEngineOnMesh:
    def test_submit_commits_and_reads_back(self, ranks3, tmp_path_factory):
        res = check("submit", ranks3, tmp_path_factory)
        assert res["got"] == [res["ps"]] * 3

    def test_failover_preserves_committed_entries(self, ranks3,
                                                  tmp_path_factory):
        res = check("failover", ranks3, tmp_path_factory)
        assert res["got"] == res["ps"]

    def test_slow_follower_heals(self, ranks3, tmp_path_factory):
        res = check("slow_heal", ranks3, tmp_path_factory)
        assert res["before"] < res["wm"]
        assert res["after"] >= 6

    def test_lapped_replica_rejoins_via_snapshot(self, ranks3,
                                                 tmp_path_factory):
        res = check("lapped", ranks3, tmp_path_factory)
        assert res["match"] >= 48
        assert res["got"] == res["want"]


class TestECOnMesh:
    def test_submit_commit_reconstruct_roundtrip(self, ranks5,
                                                 tmp_path_factory):
        res = check("ec_roundtrip", ranks5, tmp_path_factory)
        assert res["got"] == [res["ps"]] * 3

    def test_healing_by_reconstruction(self, ranks5, tmp_path_factory):
        res = check("ec_heal", ranks5, tmp_path_factory)
        assert res["before"] < 8 <= res["after"]
        assert res["got"] == res["ps"]


class TestMeshFallbackIsLoud:
    def test_fallback_warns(self, caplog):
        """Outside a process group of ``rows`` ranks both packages fall
        back to the resident layout, loudly (the JAX case: too few
        devices for the payload shards)."""
        from raft_tpu.transport import make_transport as jmake
        from raft_tpu.transport.device import SingleDeviceTransport as JS
        from raft_tpu_torch.transport import make_transport

        kw = dict(n_replicas=3, entry_bytes=16, batch_size=4,
                  log_capacity=64, transport="tpu_mesh", payload_shards=4)
        with caplog.at_level(logging.WARNING):
            jt = jmake(JConfig(**kw))
            tt = make_transport(TConfig(**kw), device="cpu")
        assert isinstance(jt, JS) and isinstance(tt, SingleDeviceTransport)
        warned = [r for r in caplog.records if "falling back" in r.message]
        assert {r.name for r in warned} == {"raft_tpu.transport.base",
                                            "raft_tpu_torch.transport.base"}

    def test_fallback_names_the_payload_shards(self, caplog):
        """Both packages' warnings name the mesh they wanted, ``n_replicas
        x payload_shards`` (12 ranks here, 12 devices in JAX)."""
        from raft_tpu.transport import make_transport as jmake
        from raft_tpu_torch.transport import make_transport

        kw = dict(n_replicas=3, entry_bytes=16, batch_size=4,
                  log_capacity=64, transport="tpu_mesh", payload_shards=4)
        with caplog.at_level(logging.WARNING):
            jmake(JConfig(**kw))
            make_transport(TConfig(**kw), device="cpu")
        warned = {r.name: r.message for r in caplog.records
                  if "falling back" in r.message}
        for name in ("raft_tpu.transport.base",
                     "raft_tpu_torch.transport.base"):
            assert re.search(r"needs (an initialised process group of )?"
                             r"12 ", warned[name]), warned[name]
            assert "(3 replicas x 4 payload shards)" in warned[name]


def test_one_row_a_rank_keeps_its_collectives():
    """The 1-D mesh's communication is unchanged by the second axis: on 3
    ranks, the column collectives, gathering fetches and leader ticks from
    the election's end to a settled commit of 40 entries (at the tick
    path's shape and the kernel-eligible one) are the counts the mesh
    engine made before it (167, 65, 14 and 39, 20, 5), with no row-group
    collective."""
    outs = run_ranks(mr.collectives_1d, 3, timeout=240)
    assert outs == [{"tick": (167, 65, 14, 0),
                     "kernel": (39, 20, 5, 0)}] * 3


class TestMembershipOverMesh:
    def test_grow_and_shrink_on_virtual_mesh(self, ranks5,
                                             tmp_path_factory):
        res = check("membership", ranks5, tmp_path_factory)
        assert res["added"] == (True, 4)
        assert res["joiner"][0] >= res["joiner"][1] - 4
        assert res["removed"] == (False, 3)
        final = res["committed"][res["leader"]]
        for r in range(3):
            got = res["committed"][r]
            assert got == final[:len(got)], f"replica {r}"


def test_restart_over_mesh_transport(ranks3, tmp_path_factory):
    """tests/test_restart.py:43, with a vote log: every rank writes its
    own vote log byte for byte as the JAX engine's, and the JAX engine's
    checkpoint, member for member."""
    res = check("restart", ranks3, tmp_path_factory)
    assert res["votes"]
    assert res["wm0"] == len(res["pre"])
    assert res["restored"] == [res["pre"]] * 3
    assert res["tails"] == [res["pre"] + res["post"]] * 3


def test_restart_ec_cluster_over_mesh(ranks5, tmp_path_factory):
    """tests/test_restart.py:163."""
    res = check("ec_restart", ranks5, tmp_path_factory)
    assert res["wm0"] == 15 and res["data"] == res["pre"]
    assert res["after"] == res["pre"] + res["post"]


def test_pipeline_commits_all_and_replicas_agree_mesh(ranks3,
                                                      tmp_path_factory):
    """tests/test_pipeline.py:54, its mesh case."""
    res = check("pipeline", ranks3, tmp_path_factory)
    assert res["durable"] and res["lead_commit"] == 640
    for r in range(3):
        got = res["tails"][r]
        assert got == res["ps"][-len(got):], f"replica {r} diverges"


def test_pipeline_ec_over_mesh(ranks5, tmp_path_factory):
    """tests/test_pipeline.py:85."""
    res = check("pipeline_ec", ranks5, tmp_path_factory)
    assert res["durable"]
    assert res["got"] == res["ps"][res["lo"] - 1:res["hi"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slow_follower_differential_mesh(seed, ranks3, tmp_path_factory):
    """tests/test_differential_faults.py:70-96, its mesh case: the engine
    half equal to the JAX engine's, and every replica's committed log the
    golden oracle's."""
    from raft_tpu.golden import GoldenCluster

    res = check(f"slow_window_{seed}", ranks3, tmp_path_factory)
    ps = res["ps"]
    c = GoldenCluster(3, seed=seed)
    g_lead = c.run_until_leader()
    slow_name = f"Server{(int(g_lead.id.removeprefix('Server')) + 1) % 3}"
    c.set_slow(slow_name, True)
    for p in ps[:5]:
        g_lead.client_append(p)
    _golden_settle(c)
    c.set_slow(slow_name, False)
    for p in ps[5:]:
        g_lead.client_append(p)
    _golden_settle(c)
    for r in range(3):
        assert res["committed"][r] == ps, f"engine replica {r}"
    assert g_lead.committed_payloads() == res["committed"][res["leader"]]


def _golden_settle(c, ticks=6):
    for _ in range(ticks):
        lead = c.leader()
        if lead is None:
            break
        c._leader_tick(lead)


def test_mesh_fused_program_equivalent(ranks3, tmp_path_factory):
    """tests/test_fused_ticks.py:394 TestMeshFused: fuse_k 8 on the mesh
    equals fuse_k 1 (same log, same stamps, same clock), with fusion
    engaged on every rank."""
    res = check("fused", ranks3, tmp_path_factory)
    one, eight = res[1], res[8]
    assert one["durable"] and eight["durable"]
    assert eight["launches"] > 0 and one["launches"] == 0
    assert_same(eight["whole"]["log_payload"], one["whole"]["log_payload"])
    assert eight["commit_time"] == one["commit_time"]
    assert eight["now"] == one["now"]
    assert eight["lines"] == one["lines"]


def test_mesh_recorded_byte_compat(ranks3, tmp_path_factory):
    """tests/test_device_obs.py:486: the recorded mesh programs give the
    host's elect/commit lines, and every rank's packed ring equals the
    JAX engine's (compared in ``check``)."""
    res = check("device_obs", ranks3, tmp_path_factory)
    assert res["dev"] == res["host"] and res["dev"]
