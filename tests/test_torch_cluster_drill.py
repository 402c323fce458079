"""The port's multi-process cluster drill (``cluster_run``, seed 0): three
real ``python -m raft_tpu_torch.cluster.child`` processes under kill -9, a
partition, an open-loop burst, SIGSTOP/SIGCONT and a restart that adopts
its sealed segments. It must meet every receipt
``tests/test_cluster.py::TestClusterDrill`` asserts of JAX's, and its
verdict and boolean receipts must equal a JAX run's of the same seed in
this environment (``tests/_torch_cluster.py``). The supervisor's spawn
keeps the card out of every child's sight."""

import os
import shutil
import subprocess
import sys

import pytest

from tests._torch_cluster import jax_drill, receipts, run_drill


@pytest.fixture(scope="module")
def cluster_drill():
    rep = run_drill("raft_tpu_torch", "cluster_run", 0)
    yield rep
    shutil.rmtree(rep.base_dir, ignore_errors=True)


def test_seed0_linearizable_under_process_faults(cluster_drill):
    rep = cluster_drill
    assert rep.verdict == "LINEARIZABLE"
    for cls, res in rep.per_class.items():
        assert res.verdict == "LINEARIZABLE", (cls, res)
    assert rep.nodes == 3
    assert rep.kills >= 1 and rep.partitions >= 1 and rep.pauses >= 1
    assert rep.ops > 0 and rep.flood_ops > 0


def test_restart_rides_the_durable_handoff(cluster_drill):
    rep = cluster_drill
    assert rep.handoff_ok, rep.summary()
    assert rep.generation >= 2
    assert rep.segments_adopted >= 1
    assert rep.segments_resealed == 0
    assert rep.snap_chunks_in >= 1
    assert rep.rejoined
    assert rep.incarnations >= 2


def test_explain_renders_merged_process_timeline(cluster_drill):
    from raft_tpu_torch.obs.__main__ import _explain_any

    text = _explain_any(os.path.join(cluster_drill.base_dir, "blackbox"))
    assert "merged timeline" in text
    assert "process incarnations" in text
    assert "cluster_kill9" in text
    assert "child_start" in text
    assert "cluster_spawn" in text


def test_receipts_equal_the_jax_run(cluster_drill):
    want, summary = jax_drill("cluster_run", 0)
    assert receipts("cluster_run", cluster_drill) == want, summary
    assert cluster_drill.repro == \
        "python -m raft_tpu_torch.chaos --cluster --seed 0"


def test_children_run_without_the_card(tmp_path, monkeypatch):
    """A replica is a pure host state machine: ``spawn`` runs
    ``python -m raft_tpu_torch.cluster.child`` with the repo on its path
    and ``CUDA_VISIBLE_DEVICES`` empty, so no child opens a CUDA context;
    with ``rendezvous_root`` a kill publishes the death certificate."""
    from raft_tpu_torch.cluster import supervisor

    seen = {}

    class FakePopen:
        pid = 4242

        def __init__(self, argv, env, stdout, stderr):
            seen["argv"], seen["env"] = argv, env
            stdout.close()

        def poll(self):
            return None

        def send_signal(self, sig):
            seen["signal"] = sig

        def wait(self, timeout=None):
            return -9

    monkeypatch.setattr(supervisor.subprocess, "Popen", FakePopen)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    sup = supervisor.ClusterSupervisor(
        3, str(tmp_path / "c"), rendezvous_root=str(tmp_path / "rv"))
    sup.spawn(1, wait_ready=False)
    assert seen["argv"][:3] == [sys.executable, "-m",
                                "raft_tpu_torch.cluster.child"]
    assert seen["argv"][3:] == ["--spec", sup.spec_path, "--node", "1"]
    assert seen["env"]["CUDA_VISIBLE_DEVICES"] == ""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert root in seen["env"]["PYTHONPATH"].split(os.pathsep)
    sup.kill9(1)
    assert list(sup._rendezvous.declared_dead()) == [1]
    assert sup.death_certificate(1) is None


def test_child_entry_point_parses_jax_s_arguments():
    r = subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.cluster.child", "--help"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0
    assert "--spec" in r.stdout and "--node" in r.stdout
