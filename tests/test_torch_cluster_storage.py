"""The port's storage-fault drill over the multi-process cluster
(``cluster_storage_run``, seed 5, and its two broken variants): the lying
disk (``FaultyIO``) under three real child processes, composed with a
partition, kill -9, restart on rotten dirs and a mid-run fsync EIO. It
must meet what ``tests/test_cluster.py::TestClusterStorageDrill`` and
``TestClusterStorageBrokenVariants`` assert of JAX's, and its verdict and
boolean receipts must equal a JAX run's of the same seed here
(``tests/_torch_cluster.py``). The EIO pair (``fail_stop_ok`` and the
node's exit code) is held equal to JAX's value, not to True: in this
environment both packages' fail-stopped child hangs in ``server.stop()``
(ROADMAP §C, baseline failures)."""

import shutil

import pytest

from tests._torch_cluster import jax_drill, receipts, run_drill


@pytest.fixture(scope="module")
def storage_drill():
    rep = run_drill("raft_tpu_torch", "cluster_storage_run", 5)
    yield rep
    shutil.rmtree(rep.base_dir, ignore_errors=True)


def test_seed5_linearizable_under_the_lying_disk(storage_drill):
    rep = storage_drill
    assert rep.verdict == "LINEARIZABLE"
    for cls, res in rep.per_class.items():
        assert res.verdict == "LINEARIZABLE", (cls, res)
    assert rep.kills >= 1 and rep.partitions >= 1
    assert rep.restarts >= 2
    assert rep.digest_ok, rep.digest_detail


def test_recovery_receipts_all_present(storage_drill):
    rep = storage_drill
    want, summary = jax_drill("cluster_storage_run", 5)
    assert rep.storage_ok == want["storage_ok"], (rep.summary(), summary)
    assert rep.wal_truncated >= 1
    assert rep.manifest_fallbacks >= 1
    assert rep.segment_reconstructs >= 1
    assert rep.disk_full_sheds >= 1
    assert rep.stalls >= 1
    assert rep.handoff_ok
    assert rep.segments_resealed == 0


def test_eio_fail_stop_publishes_the_certificate(storage_drill):
    rep = storage_drill
    want, summary = jax_drill("cluster_storage_run", 5)
    assert (rep.fail_stop_ok, rep.eio_exit) == (
        want["fail_stop_ok"], want["eio_exit"]), (rep.summary(), summary)
    assert rep.eio_cert and rep.eio_cert["errno"] == 5
    assert rep.fsync_after_eio == 0


def test_receipts_equal_the_jax_run(storage_drill):
    want, summary = jax_drill("cluster_storage_run", 5)
    assert receipts("cluster_storage_run", storage_drill) == want, summary
    assert storage_drill.repro == (
        "python -m raft_tpu_torch.chaos --cluster-storage --seed 5")


@pytest.mark.parametrize("broken,caught_by", [
    ("fsync_lies", "checker"), ("wal_skip_corrupt", "digest")])
def test_broken_variant_is_caught(broken, caught_by):
    rep = run_drill("raft_tpu_torch", "cluster_storage_run", 5,
                    broken=broken)
    try:
        assert rep.caught is True
        assert rep.caught_by == caught_by
        if broken == "fsync_lies":
            assert rep.verdict == "VIOLATION"
        else:
            assert not rep.digest_ok
            assert "DIVERGED" in rep.digest_detail
        want, summary = jax_drill("cluster_storage_run", 5, broken=broken)
        assert receipts("cluster_storage_run", rep) == want, summary
        assert rep.repro.endswith(f"--seed 5 --broken {broken}")
    finally:
        shutil.rmtree(rep.base_dir, ignore_errors=True)
