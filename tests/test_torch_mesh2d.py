"""The port's 2-D payload mesh (``payload_shards = 2``): ``MeshTransport``
and ``RaftEngine`` as R x P gloo ranks on the CPU, rank ``g = r*P + p``
holding replica row ``r``'s vectors and terms and lane block ``g`` of the
payload, against the JAX package's ``TpuMeshTransport`` on a 2-D
``(replica, pshard)`` mesh of the virtual CPU devices (tests/conftest.py,
8 devices) and against the port's single-device engine.

One spawn of 6 ranks (3 x 2) and one of 8 (4 x 2) run everything
(``tests/_mesh_ranks.py`` ``mesh2d_rank``):

- the transport alone, stage by stage, every rank's leaves equal to its
  part of the JAX mesh state (``cut_row(..., g, 2)``) and its infos to
  JAX's: tests/test_mesh.py:32, :65, :77 at (3, 2) and (4, 2);
  tests/test_step_mesh.py:64 ``test_mesh_fused_step_matches_single[2]``,
  the saturated flight of its pipeline class (:115) at P = 2, and the
  fused K-tick scan (``replicate_fused``, the staging words cut to the
  rank's slice);
- the engine on the schedules of tests/test_torch_engine_mesh.py
  (TestEngineOnMesh's four cases, the restart with its vote log and
  checkpoint file, the pipelined chunk, fuse_k 8 against 1, the recorded
  run's packed ring) at 3 x 2, and TestECWithPayloadShardsOnMesh
  (tests/test_engine_mesh.py:140, RS(4,2) x 2) and membership at
  ``n_replicas=3, max_replicas=4`` x 2 on 8 ranks; at every scenario's
  end each rank's lines, terms, roles, watermark, gathered whole state
  (full width), committed bytes and own leaves equal the JAX engine's,
  and the single-device engine gives the same;
- ``make_transport``'s decision for each config inside the group, equal
  to JAX's over as many devices as the group has ranks;
- a forced desync on a rank of pshard column 1: ``MirrorDesyncError`` on
  every rank, naming all six digests.
"""

import logging
import tempfile

import jax
import numpy as np
import pytest

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core.state import fold_batch as jfold_batch
from raft_tpu.raft import RaftEngine as JEngine
from raft_tpu.transport import TpuMeshTransport
from raft_tpu_torch.core.state import FIELDS, cut_row, stack_rows
from raft_tpu_torch.transport import SingleDeviceTransport
from raft_tpu_torch.transport.launch import run_ranks
from tests import _mesh_ranks as mr
from tests._torch_port import pallas_interpret
from tests.test_torch_engine_mesh import JaxOps, assert_same
from tests.test_torch_mesh import _fused_scan, _j_apply

P = 2
B = 128


def _batch(vals, rows, entry=8):
    data = np.repeat(np.asarray(vals, np.uint8)[:, None], entry, axis=1)
    return np.asarray(jfold_batch(data, rows))


def _rand_batch(seed, count, rows, entry=8):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (B, entry), dtype=np.uint8)
    data[count:] = 0
    return np.asarray(jfold_batch(data, rows))


def _small(n):
    """tests/test_mesh.py's ``cfg`` fixture at (n, 2)."""
    return dict(n_replicas=n, entry_bytes=8, batch_size=4, log_capacity=64,
                payload_shards=P)


def _mesh_programs(n):
    """tests/test_mesh.py:32 (mesh equals single device), :65 (the
    election quorum) and :77 (the scan) as stages."""
    on, off = [True] * n, [False] * n
    slow1 = off[:-1] + [True]

    def rep(vals, count, slow):
        return dict(op="replicate", payload=_batch(vals, n), count=count,
                    leader=0, term=1, alive=on, slow=slow, dispatch=None)

    T = 5
    vals = np.arange(T * 4, dtype=np.uint8).reshape(T, 4)
    data = np.repeat(vals[..., None], 8, axis=2)
    scan = np.stack([np.asarray(jfold_batch(data[i], n)) for i in range(T)])
    vote = dict(op="vote", cand=0, term=1, alive=on, dispatch=None)
    return {
        f"matches_single_{n}": (_small(n), [
            vote, rep([1, 2, 3, 4], 4, off), rep([5, 6, 0, 0], 2, slow1),
            rep([0] * 4, 0, off)]),
        f"election_quorum_{n}": (_small(n), [
            dict(op="vote", cand=2, term=1, alive=on, dispatch=None),
            dict(op="vote", cand=0, term=1, alive=on, dispatch=None),
            dict(op="vote", cand=0, term=2, alive=on, dispatch=None)]),
        f"scan_{n}": (_small(n), [
            vote, dict(op="replicate_many", payloads=scan, counts=[4] * T,
                       leader=0, term=1, alive=on, slow=off,
                       dispatch=None)]),
    }


def _step_programs():
    """tests/test_step_mesh.py:64 at ps = 2, the saturated flight of its
    pipeline class (:115) at P = 2, and the fused K-tick scan."""
    on, off = [True] * 3, [False] * 3
    slow1 = [False, False, True]

    def step(seed, count, slow):
        return dict(op="replicate", payload=_rand_batch(seed, B, 3),
                    count=count, leader=0, term=1, alive=on, slow=slow,
                    repair=False, term_floor=1, dispatch="step")

    vote = dict(op="vote", cand=0, term=1, alive=on, dispatch=None)
    base = dict(n_replicas=3, entry_bytes=8, batch_size=B, payload_shards=P)
    return {
        "fused_step": (dict(base, log_capacity=512), [
            vote, step(1, B, off), step(2, B, slow1), step(3, 0, off)]),
        "saturated_pipeline": (dict(base, log_capacity=1024), [
            vote, dict(op="pipeline",
                       wins=np.stack([_rand_batch(200 + t, B, 3)
                                      for t in range(7)]),
                       counts=[B] * 7, leader=0, term=1, alive=on,
                       slow=off, term_floor=1, dispatch="pipeline")]),
        "fused_scan": (dict(base, log_capacity=1024), _fused_scan()),
    }


PROGRAMS6 = {**_mesh_programs(3), **_step_programs()}
PROGRAMS8 = _mesh_programs(4)
NAMES6 = ["submit", "failover", "slow_heal", "lapped", "restart",
          "pipeline", "fused", "device_obs"]
NAMES8 = ["ec2d_roundtrip", "ec2d_heal", "membership4"]

KW = dict(entry_bytes=16, batch_size=4, log_capacity=64)
#: make_transport's cases inside a group of 6 and of 8 ranks, and (a
#: (config, payload_shards) pair) MeshTransport built directly
DECISIONS = {
    6: [dict(KW, n_replicas=3, payload_shards=2, transport="tpu_mesh"),
        dict(KW, n_replicas=3, max_replicas=4, payload_shards=2,
             transport="tpu_mesh"),
        dict(KW, n_replicas=3, max_replicas=5, transport="tpu_mesh"),
        dict(KW, n_replicas=4, payload_shards=2, transport="tpu_mesh"),
        dict(KW, n_replicas=3, payload_shards=2, transport="multihost"),
        dict(KW, n_replicas=3, max_replicas=4, payload_shards=2,
             transport="multihost"),
        (dict(KW, n_replicas=3, transport="tpu_mesh"), 2),
        (dict(KW, n_replicas=2, entry_bytes=8, transport="tpu_mesh"), 3),
        (dict(KW, n_replicas=3, transport="tpu_mesh"), 4)],
    8: [dict(KW, n_replicas=4, payload_shards=2, transport="tpu_mesh"),
        dict(KW, n_replicas=3, max_replicas=4, payload_shards=2,
             transport="tpu_mesh"),
        dict(KW, n_replicas=4, payload_shards=2, transport="multihost")],
}
DESYNC_RANK = 3          # replica row 1, pshard column 1


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_traces_after():
    """The JAX 2-D references below trace ``TpuMeshTransport`` programs
    whose dispatch the JAX package's own tests witness at trace time
    (``tests/test_step_mesh.py``, ``step_mesh.LAST_DISPATCH``); a later
    test in the same process must trace them afresh, so JAX's caches are
    cleared when this module ends."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def ranks6():
    return run_ranks(mr.mesh2d_rank, 6,
                     (PROGRAMS6, NAMES6, DECISIONS[6], DESYNC_RANK),
                     timeout=420)


@pytest.fixture(scope="module")
def ranks8():
    return run_ranks(mr.mesh2d_rank, 8, (PROGRAMS8, NAMES8, DECISIONS[8]),
                     timeout=420)


def _check_program(ranks, name, cfg_kw, stages):
    """``stages`` through the JAX 2-D mesh, every rank's leaves (its part
    of the JAX state) and infos held against it after every stage."""
    cfg = JConfig(**cfg_kw)
    world = cfg.rows * P
    with pallas_interpret():
        tr = TpuMeshTransport(cfg, jax.devices()[:world])
        st = tr.init()
        for i, stage in enumerate(stages):
            st, info = _j_apply(tr, st, stage)
            want = {f: np.asarray(getattr(st, f)) for f in FIELDS}
            parts = []
            for g in range(world):
                leaves, tinfo, dispatch = ranks[g]["programs"][name][i]
                msg = f"{name} stage {i} ({stage['op']}) rank {g}"
                assert dispatch == stage["dispatch"], msg
                cut = cut_row(want, g, P)
                for f in FIELDS:
                    np.testing.assert_array_equal(leaves[f], cut[f],
                                                  f"{msg} state.{f}")
                fields = info if isinstance(info, dict) else info._asdict()
                assert sorted(tinfo) == sorted(fields), msg
                for f, v in fields.items():
                    np.testing.assert_array_equal(tinfo[f], np.asarray(v),
                                                  f"{msg} info.{f}")
                parts.append(leaves)
            back = stack_rows(parts, P)
            for f in FIELDS:
                np.testing.assert_array_equal(back[f], want[f], f)
    return st


@pytest.mark.parametrize("n", [3, 4])
def test_mesh_matches_single_device(n, ranks6, ranks8):
    """tests/test_mesh.py:32 at (n, 2)."""
    ranks = ranks6 if n == 3 else ranks8
    st = _check_program(ranks, f"matches_single_{n}",
                        *_mesh_programs(n)[f"matches_single_{n}"])
    assert int(np.asarray(st.commit_index)[0]) == 6


@pytest.mark.parametrize("n", [3, 4])
def test_mesh_election_quorum(n, ranks6, ranks8):
    """tests/test_mesh.py:65 at (n, 2): every vote count equal to JAX's."""
    ranks = ranks6 if n == 3 else ranks8
    name = f"election_quorum_{n}"
    _check_program(ranks, name, *_mesh_programs(n)[name])
    votes = [int(ranks[0]["programs"][name][i][1]["votes"])
             for i in range(3)]
    assert votes == [n, 0, n]


@pytest.mark.parametrize("n", [3, 4])
def test_mesh_scan_replication(n, ranks6, ranks8):
    """tests/test_mesh.py:77 at (n, 2)."""
    ranks = ranks6 if n == 3 else ranks8
    name = f"scan_{n}"
    _check_program(ranks, name, *_mesh_programs(n)[name])
    commits = ranks[0]["programs"][name][1][1]["commit_index"]
    assert commits.tolist() == [4 * (i + 1) for i in range(5)]


def test_mesh_fused_step_matches_single(ranks6):
    """tests/test_step_mesh.py:64 ``[2]``: K2·mesh's twin on every rank's
    slice (one word of the two), the dispatch witnessed."""
    st = _check_program(ranks6, "fused_step",
                        *_step_programs()["fused_step"])
    assert int(np.asarray(st.commit_index)[0]) == 2 * B


def test_saturated_pipeline_matches_single(ranks6):
    """tests/test_step_mesh.py:115 ``test_saturated_pipeline_matches_
    single`` at P = 2: one mesh flight on every rank's slice."""
    st = _check_program(ranks6, "saturated_pipeline",
                        *_step_programs()["saturated_pipeline"])
    assert (np.asarray(st.commit_index) == 7 * B).all()


def test_fused_scan_takes_the_rank_slice(ranks6):
    """``replicate_fused`` on the 2-D mesh: each rank scans its slice of
    the staging words, as JAX's ``P(None, None, "pshard")`` splits them."""
    st = _check_program(ranks6, "fused_scan",
                        *_step_programs()["fused_scan"])
    assert int(np.asarray(st.commit_index)[0]) == 11 * B + 50


# ------------------------------------------------------------- the engine

def jax_make(over, restore=None, recorder=False, vote_log=None):
    cfg = JConfig(**{**mr.BASE, "payload_shards": P, **over,
                     "transport": "tpu_mesh"})
    t = TpuMeshTransport(cfg, jax.devices()[:cfg.rows * P])
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


def reference(name):
    """(JAX 2-D mesh engine, port single-device engine) observations of
    one scenario, run once per module."""
    if name not in _RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            jobs, _ = mr.run_scenario(name, jax_make, JaxOps(), tmp)
        single = mr.port_make("single", lambda cfg: SingleDeviceTransport(
            cfg, device="cpu"), dict(payload_shards=P))
        with tempfile.TemporaryDirectory() as tmp:
            sobs, _ = mr.run_scenario(name, single, mr.PortOps(), tmp)
        _RUNS[name] = (jobs, sobs)
    return _RUNS[name]


def check(name, ranks) -> dict:
    """Every rank of the 2-D mirrored port against the JAX 2-D mesh
    engine, and the port's single-device engine too; returns rank 0's
    result."""
    jobs, sobs = reference(name)
    jwhole = {f: np.asarray(v, np.int32)
              for f, v in jobs["final"]["whole"].items()}
    for g, robs in enumerate(ranks):
        got = robs["engine"][name]
        assert_same(got["final"], jobs["final"], f"rank {g} {name}")
        assert_same(got["result"], jobs["result"], f"rank {g} {name}")
        assert_same(got["local"], cut_row(jwhole, g, P),
                    f"rank {g} {name} own slice")
    assert_same(sobs["final"], jobs["final"], f"single {name}")
    assert_same(sobs["result"], jobs["result"], f"single {name}")
    return ranks[0]["engine"][name]["result"]


class TestEngineOnMesh2D:
    """tests/test_engine_mesh.py:43 at 3 x 2."""

    def test_submit_commits_and_reads_back(self, ranks6):
        res = check("submit", ranks6)
        assert res["got"] == [res["ps"]] * 3

    def test_failover_preserves_committed_entries(self, ranks6):
        res = check("failover", ranks6)
        assert res["got"] == res["ps"]

    def test_slow_follower_heals(self, ranks6):
        res = check("slow_heal", ranks6)
        assert res["before"] < res["wm"]
        assert res["after"] >= 6

    def test_lapped_replica_rejoins_via_snapshot(self, ranks6):
        res = check("lapped", ranks6)
        assert res["match"] >= 48
        assert res["got"] == res["want"]


class TestECWithPayloadShardsOnMesh:
    """tests/test_engine_mesh.py:140: RS(4,2) with the shard words split
    two ways, on 8 ranks."""

    def test_submit_commit_reconstruct_roundtrip(self, ranks8):
        res = check("ec2d_roundtrip", ranks8)
        assert res["got"] == [res["ps"]] * 3

    def test_slow_follower_commit_and_heal(self, ranks8):
        res = check("ec2d_heal", ranks8)
        assert res["before"] < 6 <= res["after"]
        assert res["got"] == res["ps"]


def test_membership_grow_and_shrink_2d(ranks8):
    """tests/test_engine_mesh.py:189 at ``max_replicas=4`` x 2: the spare
    row's two ranks join as a voter and leave."""
    res = check("membership4", ranks8)
    assert res["added"] == (True, 4)
    assert res["joiner"][0] >= res["joiner"][1] - 4
    assert res["removed"] == (False, 3)
    final = res["committed"][res["leader"]]
    for r in range(3):
        got = res["committed"][r]
        assert got == final[:len(got)], f"replica {r}"


def test_restart_2d(ranks6):
    """tests/test_restart.py:43 at 3 x 2: every rank's vote log (its own
    file) and the checkpoint, member for member, equal the JAX engine's;
    restore puts every rank's slice back."""
    res = check("restart", ranks6)
    assert res["votes"]
    assert res["wm0"] == len(res["pre"])
    assert res["restored"] == [res["pre"]] * 3
    assert res["tails"] == [res["pre"] + res["post"]] * 3


def test_pipeline_2d(ranks6):
    """tests/test_pipeline.py:54, its mesh case at 3 x 2."""
    res = check("pipeline", ranks6)
    assert res["durable"] and res["lead_commit"] == 640
    for r in range(3):
        got = res["tails"][r]
        assert got == res["ps"][-len(got):], f"replica {r} diverges"


def test_fused_k8_equals_k1_2d(ranks6):
    """tests/test_fused_ticks.py:394 at 3 x 2: fuse_k 8 equals 1, fusion
    engaged on every rank, the staging words cut to each rank's slice."""
    res = check("fused", ranks6)
    one, eight = res[1], res[8]
    assert one["durable"] and eight["durable"]
    assert eight["launches"] > 0 and one["launches"] == 0
    assert_same(eight["whole"]["log_payload"], one["whole"]["log_payload"])
    assert eight["commit_time"] == one["commit_time"]
    assert eight["lines"] == one["lines"]


def test_recorded_2d(ranks6):
    """tests/test_device_obs.py:486 at 3 x 2: every rank's packed event
    ring equals the JAX engine's (compared in ``check``), and gives the
    host's elect/commit lines."""
    res = check("device_obs", ranks6)
    assert res["dev"] == res["host"] and res["dev"]


# -------------------------------------------------- transport decisions

def _jax_decision(case, n_devices):
    from raft_tpu.transport import make_transport as jmake

    devices = jax.devices()[:n_devices]
    try:
        if isinstance(case, dict):
            t = jmake(JConfig(**case), devices=devices)
        else:
            t = TpuMeshTransport(JConfig(**case[0]), devices,
                                 payload_shards=case[1])
    except ValueError as ex:
        return f"ValueError: {ex}"
    return {"TpuMeshTransport": "MeshTransport"}.get(type(t).__name__,
                                                     type(t).__name__)


@pytest.mark.parametrize("world", [6, 8])
def test_make_transport_decides_as_jax(world, ranks6, ranks8, caplog):
    """Inside a group of 6 and of 8 ranks, ``make_transport`` gives the
    transport (or raises the ``ValueError`` text) JAX's gives over as many
    devices, headroom included, on every rank; so does ``MeshTransport``
    built directly with a ``payload_shards`` override (words that do not
    divide, too few ranks)."""
    ranks = ranks6 if world == 6 else ranks8
    with caplog.at_level(logging.WARNING):
        want = [_jax_decision(kw, world) for kw in DECISIONS[world]]
    for g, out in enumerate(ranks):
        assert out["decisions"] == want, f"rank {g}"
    assert "ValueError: need 8 devices (4 replica rows x 2 payload " \
           "shards), got 6" in want
    if world == 6:
        assert want[-2:] == [
            "ValueError: per-entry stored words (2) must divide evenly "
            "over 3 payload shards",
            "ValueError: need 12 devices (3 replica rows x 4 payload "
            "shards), got 6"]


def test_desync_on_column_1_fail_stops_every_rank(ranks6):
    """tests/test_multiprocess.py:510 on the 2-D mesh: rank 3 (row 1,
    pshard 1) perturbs a host mirror; every rank of both columns raises
    ``MirrorDesyncError`` naming the same six digests."""
    digests = set()
    for g, out in enumerate(ranks6):
        d = out["desync"]
        assert d["synced"] == 8, g
        assert d["caught"] is not None, f"rank {g} never detected it"
        assert "per-process digests" in d["caught"]
        named = d["caught"].split("per-process digests ")[1].split(" (")[0]
        assert len(named.strip("[]").split(",")) == 6
        digests.add(named)
    assert len(digests) == 1
