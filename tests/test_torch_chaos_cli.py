"""``python -m raft_tpu_torch.chaos`` against ``python -m raft_tpu.chaos``
(argument errors, result lines, the forensics run of
``.claude/skills/verify``; ``tests/test_device_obs.py:475``), every drill
flag reaching its runner (the cluster drills' result lines against JAX's
over one report), the device rule (the card unless ``--device cpu``, no
fallback), ``ChaosTransport``'s seam, and the bookkeeping of the graph
pool (``core.graphs.POOL``) that hands a crashed engine's rings, staging
buffer and CUDA graph sets to the restored one. Graph sets are captured
only on the card, so here a set is built over the CPU tensors and the
test checks who gets it."""

import json
import os

import numpy as np
import pytest
import torch

from raft_tpu.chaos.__main__ import main as jmain
from raft_tpu_torch.chaos.__main__ import main as tmain
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core import graphs
from raft_tpu_torch.raft import RaftEngine
from raft_tpu_torch.transport.device import SingleDeviceTransport

BAD_ARGS = [
    ["--multi", "--broken", "dirty_reads"],
    ["--overload-recovery", "5", "--multi"],
    ["--membership", "--multi"],
    ["--read-plane", "--multi"],
    ["--reconfig", "--overload"],
    ["--migration", "--reconfig"],
    ["--segments", "--migration"],
    ["--broken", "lease_skew"],
    ["--broken", "txn_dirty_read"],
    ["--txn", "--multi"],
    ["--txn-extra"],
    ["--reads", "--membership"],
    ["--wire", "--reads"],
    ["--cluster", "--wire"],
    ["--broken", "fsync_lies"],
    ["--cluster-storage", "--cluster-net"],
    ["--broken", "peer_no_crc"],
    ["--cluster-net", "--txn"],
    ["--cluster", "--multi"],
    ["--cluster-storage", "--broken", "peer_no_crc"],
    ["--cluster-net", "--broken", "wal_skip_corrupt"],
    ["--broken", "lease_stale_round"],
    ["--broken", "wal_skip_corrupt"],
    ["--broken", "no_such_variant"],
]


def error_line(main, argv, capsys):
    with pytest.raises(SystemExit) as ex:
        main(argv)
    err = capsys.readouterr().err.strip().splitlines()[-1]
    return ex.value.code, err.split(": error: ", 1)[1]


@pytest.mark.parametrize("argv", BAD_ARGS, ids=" ".join)
def test_argument_errors_match_jax(argv, capsys):
    assert error_line(tmain, argv, capsys) == error_line(jmain, argv,
                                                         capsys)


@pytest.mark.parametrize("flag,item", [
    ("--wire", "A17b"), ("--txn", "A17c"), ("--cluster", "A17d"),
    ("--cluster-storage", "A17d"), ("--cluster-net", "A17d")])
def test_unported_drills_name_their_roadmap_item(flag, item, capsys,
                                                monkeypatch):
    """Every drill of the JAX CLI is ported: no flag exits naming a
    ROADMAP item any more (the CLI has no ``NOT_PORTED`` table). Each
    flag reaches its runner (stubbed here; ``test_torch_wire_drill.py``,
    ``test_torch_txn_drill.py`` and ``test_torch_cluster_*.py`` run the
    drills themselves): ``--wire`` on ``--device``, ``--txn`` on two
    shards of it, and the cluster drills, which hold no tensor, with
    JAX's arguments and no device."""
    import raft_tpu_torch.chaos.__main__ as cli

    assert not hasattr(cli, "NOT_PORTED")

    class Reached(Exception):
        pass

    def stub(seed, **kw):
        mesh = kw.get("mesh")
        raise Reached(seed, kw.get("device"),
                      None if mesh is None else len(mesh.devices),
                      sorted(kw))

    for name in ("wire_run", "txn_run", "cluster_run", "cluster_storage_run",
                 "cluster_net_run"):
        monkeypatch.setattr(cli, name, stub)
    with pytest.raises(Reached) as ex:
        tmain([flag, "--device", "cpu"])
    assert "not ported" not in capsys.readouterr().err
    seed, device, shards, keys = ex.value.args
    assert seed == 0
    if item == "A17b":
        assert (device, shards) == ("cpu", None)
    elif item == "A17c":
        assert (device, shards) == ("cpu", 2)
    else:
        assert device is None and shards is None
        assert {"nodes", "clients", "keys", "step_budget",
                "blackbox_dir"} <= set(keys)
        assert ("broken" in keys) == (flag != "--cluster")


class _Check:
    def __init__(self, verdict):
        self.verdict = verdict


def _fake_report(flag, broken, healthy):
    """One report object of the drill's shape, fed to both CLIs."""
    from types import SimpleNamespace

    verdict = "LINEARIZABLE" if healthy else "VIOLATION"
    fields = dict(
        verdict=verdict, per_class={"lease": _Check(verdict)}, ops=9,
        op_counts={"write": 5}, nodes=3, kills=1, restarts=2,
        partitions=1, pauses=1, flood_ops=32, generation=2,
        segments_adopted=3, segments_resealed=0, snap_chunks_in=4,
        rejoined=True, incarnations=2, failovers=0, handoff_ok=healthy,
        wal_truncated=1, manifest_fallbacks=1, segment_reconstructs=1,
        disk_full_sheds=2, stalls=1, eio_exit=97, eio_cert={"errno": 5},
        fsync_after_eio=0, digest_ok=True, digest_detail="ok",
        storage_ok=healthy, net_ok=healthy, frames_delayed=1,
        frames_dup=1, frames_reordered=1, frames_replayed=1,
        conns_torn=1, corrupt_injected=1, corrupt_dropped=1,
        stale_round_ignored=1, demotions=1, reelected=True,
        reelect_s=0.5, dialer_drops=0, redials=1, broken=broken,
        caught=(None if broken is None else healthy),
        caught_by="checker", base_dir="/x")
    rep = SimpleNamespace(**fields)
    rep.summary = lambda: f"{flag} summary"
    return rep


@pytest.mark.parametrize("argv", [
    ["--cluster"], ["--cluster-storage"],
    ["--cluster-storage", "--broken", "fsync_lies"],
    ["--cluster-net"], ["--cluster-net", "--broken", "peer_no_crc"]],
    ids=" ".join)
@pytest.mark.parametrize("healthy", [True, False])
def test_cluster_result_lines_and_exit_codes_equal_jax(argv, healthy,
                                                       capsys, monkeypatch):
    """Over one report, both CLIs print the same summary and JSON result
    line and exit alike (a caught lie is success under ``--broken``)."""
    import raft_tpu.chaos.__main__ as jcli
    import raft_tpu_torch.chaos.__main__ as tcli

    broken = argv[2] if len(argv) > 2 else None
    rep = _fake_report(argv[0], broken, healthy)
    fn = {"--cluster": "cluster_run", "--cluster-storage":
          "cluster_storage_run", "--cluster-net": "cluster_net_run"}[argv[0]]
    out = []
    for cli, main in ((jcli, jmain), (tcli, tmain)):
        monkeypatch.setattr(cli, fn, lambda seed, **kw: rep)
        rc = main(argv)
        out.append((rc, capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[1][0] == (0 if healthy else 1)


def test_cluster_broken_env_line_equals_jax(capsys, monkeypatch):
    """``ClusterBroken`` (children cannot spawn) is the fast-fail
    contract: one ``BROKEN_ENV`` line and exit 1, as JAX's."""
    import raft_tpu.chaos.__main__ as jcli
    import raft_tpu_torch.chaos.__main__ as tcli
    from raft_tpu.cluster import ClusterBroken as JBroken
    from raft_tpu_torch.cluster import ClusterBroken as TBroken

    out = []
    for cli, main, exc in ((jcli, jmain, JBroken), (tcli, tmain, TBroken)):
        def boom(seed, _exc=exc, **kw):
            raise _exc("3 consecutive young child deaths\nmore")

        monkeypatch.setattr(cli, "cluster_run", boom)
        out.append((main(["--cluster"]), capsys.readouterr().out))
    assert out[0] == out[1]
    assert json.loads(out[1][1])["verdict"] == "BROKEN_ENV"


def test_cluster_net_flag_runs_a_caught_lie(capsys):
    """One cluster drill end to end through the port's CLI: the
    ``peer_no_crc`` variant (three real children, ~5 s) is caught by the
    digest plane, which is the flag's success."""
    rc, line = result_line(tmain, ["--cluster-net", "--seed", "7",
                                   "--broken", "peer_no_crc"], capsys)
    assert rc == 0
    assert line["caught"] is True and line["caught_by"] == "digest"
    import shutil

    shutil.rmtree(line["base_dir"], ignore_errors=True)


def result_line(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_rejected_seed_writes_a_bundle_and_matches_jax(tmp_path, capsys):
    argv = ["--seed", "0", "--phases", "8", "--keys", "2", "--broken",
            "dirty_reads", "--observe"]
    rc, line = result_line(tmain, argv + ["--bundle-dir",
                                          str(tmp_path / "port"),
                                          "--device", "cpu"], capsys)
    jrc, jline = result_line(jmain, argv + ["--bundle-dir",
                                            str(tmp_path / "jax")], capsys)
    assert rc == jrc == 0
    assert line == jline and line["verdict"] == "VIOLATION"
    assert os.listdir(tmp_path / "port") == ["bundle_torture_seed0.json"]


def test_observe_compile_result_line_keeps_jax_keys(capsys):
    argv = ["--seed", "17", "--phases", "6", "--observe-compile"]
    rc, line = result_line(tmain, argv + ["--device", "cpu"], capsys)
    jrc, jline = result_line(jmain, argv, capsys)
    assert rc == jrc == 0
    assert list(line) == list(jline)
    assert line["compile_violations"] == 0 == jline["compile_violations"]
    line.pop("compiles"), jline.pop("compiles")   # captures, not traces
    assert line == jline


def test_observe_device_flag_runs(capsys):
    assert tmain(["--seed", "3", "--phases", "2", "--observe-device",
                  "--device", "cpu"]) == 0


def test_migration_flag_runs_on_two_shards_of_the_device(capsys):
    rc, line = result_line(tmain, ["--migration", "--seed", "0",
                                   "--groups", "4", "--clients", "2",
                                   "--keys", "4", "--device", "cpu"], capsys)
    assert rc == 0 and line["n_shards"] == 2 and line["progress_ok"]


def test_runners_need_the_card_unless_the_cpu_is_named():
    from raft_tpu_torch.chaos import torture_run, torture_run_multi

    if torch.cuda.is_available():
        pytest.skip("a card is present: the runners would use it")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        torture_run(0, phases=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torture_run_multi(0, phases=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["--seed", "0", "--phases", "1"])


def test_chaos_transport_forwards_the_seam_and_hides_the_flight():
    from raft_tpu_torch.chaos import ChaosTransport

    cfg = RaftConfig(n_replicas=3, entry_bytes=16, batch_size=4,
                     log_capacity=64, transport="single")
    base = SingleDeviceTransport(cfg, device="cpu")
    ct = ChaosTransport(base, seed=1)
    assert not hasattr(ct, "replicate_pipeline")
    assert hasattr(base, "replicate_pipeline")
    assert ct.device is base.device and ct.comm is base.comm
    assert ct.resident and ct.processes == 1
    st = ct.init()
    np.testing.assert_array_equal(ct.fetch_rows(st.term), base.fetch_rows(
        st.term))
    assert ct.exchange_digest(5).tolist() == [5]
    assert not hasattr(ct, "fetch_row_lanes")    # absent on the base too
    e = RaftEngine(cfg, ct)
    assert e.run_until_leader() is not None


# ------------------------------------------------------------ graph pool
CFG = RaftConfig(n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=128,
                 transport="single", seed=3, fuse_k=4)


@pytest.fixture
def pool():
    graphs.POOL.clear()
    yield graphs.POOL
    graphs.POOL.clear()


def drive(e, n=24):
    e.run_until_leader()
    seqs = [e.submit(bytes([i + 1]) * CFG.entry_bytes) for i in range(n)]
    e.run_for(40.0)
    assert all(e.is_durable(s) for s in seqs)
    return e


def with_graph_set(e):
    """A ``FusedGraphs`` holding one set over ``e``'s rings and staging
    buffer, as the card's first fused launch leaves it."""
    fg = graphs.FusedGraphs(CFG.rows, CFG.commit_quorum, "cpu")
    staging = e._fused_driver.staging.buf
    assert staging is not None
    key = ("none", CFG.batch_size, CFG.shard_words, staging.shape[0], False)
    fg.sets[key] = graphs._GraphSet(e.state, staging)
    e.t.graphs = e.t._held.graphs = fg
    return fg, key


def restored(path, trace=None):
    return RaftEngine.restore(CFG, path, SingleDeviceTransport(CFG,
                                                               device="cpu"),
                              trace=trace)


def test_a_restored_engine_adopts_the_released_set(pool, tmp_path):
    a = drive(RaftEngine(CFG, SingleDeviceTransport(CFG, device="cpu")))
    fg, key = with_graph_set(a)
    rings = (a.state.log_term, a.state.log_payload)
    staging = a._fused_driver.staging.buf
    path = str(tmp_path / "a.npz")
    a.save_checkpoint(path)
    a.t.release()
    assert a.t.graphs is None and len(pool.free) == 1
    lines = []
    b = restored(path, lines.append)
    assert pool.lent == 1 and pool.free == []
    assert b.t.graphs is fg and fg.recaptures == 0
    assert b.state.log_term is rings[0] and b.state.log_payload is rings[1]
    drive(b)
    assert b._fused_driver.staging.buf is staging
    assert fg.sets[key].holds(b.state, b._fused_driver.staging.buf, None)
    # the same restore with lending off: every line and byte equal
    pool.enabled = False
    try:
        plain_lines = []
        c = drive(restored(path, plain_lines.append))
    finally:
        pool.enabled = True
    assert c.state.log_payload is not rings[1] and c.t.graphs is None
    assert lines == plain_lines
    for f in ("term", "commit_index", "last_index", "log_term",
              "log_payload"):
        assert torch.equal(getattr(b.state, f), getattr(c.state, f)), f


def test_two_live_engines_never_share_a_set(pool, tmp_path):
    a = drive(RaftEngine(CFG, SingleDeviceTransport(CFG, device="cpu")))
    with_graph_set(a)
    # a is alive and has not released: nothing of it is lent
    c = RaftEngine(CFG, SingleDeviceTransport(CFG, device="cpu"))
    assert c.state.log_payload is not a.state.log_payload
    assert c.t.graphs is None and pool.lent == 0
    payload = a.state.log_payload
    a.t.release()
    d = RaftEngine(CFG, SingleDeviceTransport(CFG, device="cpu"))
    e = RaftEngine(CFG, SingleDeviceTransport(CFG, device="cpu"))
    assert d.state.log_payload is payload
    assert e.state.log_payload is not payload and e.t.graphs is None
    assert pool.lent == 1
    assert int(d.state.log_payload.abs().sum()) == 0   # handed out zeroed
    # another shape never takes it
    other = RaftConfig(n_replicas=3, entry_bytes=32, batch_size=4,
                       log_capacity=256, transport="single")
    d.t.release()
    f = RaftEngine(other, SingleDeviceTransport(other, device="cpu"))
    assert f.state.log_payload is not payload and len(pool.free) == 1


def test_crash_cycles_lend_through_the_pool(pool):
    from raft_tpu_torch.chaos import torture_run

    rep = torture_run(17, phases=6, device="cpu")
    assert rep.crashes >= 1 and pool.lent == rep.crashes
    pool.enabled = False
    try:
        plain = torture_run(17, phases=6, device="cpu")
    finally:
        pool.enabled = True
    assert (plain.commit_digest, plain.nemesis_log, plain.op_counts) == \
        (rep.commit_digest, rep.nemesis_log, rep.op_counts)


def test_a_finished_run_lends_its_last_engine_to_the_next(pool):
    from raft_tpu_torch.chaos import torture_run

    first = torture_run(17, phases=6, device="cpu")
    assert pool.lent == first.crashes and len(pool.free) == 1
    payload = pool.free[0].rings[1]
    second = torture_run(17, phases=6, device="cpu")
    assert pool.lent == 2 * first.crashes + 1
    assert pool.free[0].rings[1] is payload    # the same rings throughout
    assert second.commit_digest == first.commit_digest
