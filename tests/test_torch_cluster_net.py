"""The port's network-fault drill over the multi-process cluster
(``cluster_net_run``, seed 7, and its two broken variants): latency,
trickle, torn frames, duplicates, reorders, cross-redial replays and bit
corruption on every peer link, an asymmetric partition of the leader,
kill -9 and a restart that adopts. It must meet what
``tests/test_cluster.py::TestClusterNetDrill`` and
``TestClusterNetBrokenVariants`` assert of JAX's, and its verdict and
boolean receipts must equal a JAX run's of the same seed here
(``tests/_torch_cluster.py``).

The file is out of tier 1 (``slow``): in the second of three runs of the
tier-1 xdist command over the cluster files,
``test_receipts_equal_the_jax_run`` failed on the JAX run's side, and the
healthy drill's commit digests diverge now and then in both packages. A
leader streams unsealed ``PEER_SNAP_CHUNK`` frames to a peer it never
heard back from on its own link, and the drill's corruption then lands
in that peer's log (ROADMAP §C)."""

import os
import shutil

import pytest

from tests._torch_cluster import jax_drill, receipts, run_drill

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def net_drill():
    rep = run_drill("raft_tpu_torch", "cluster_net_run", 7)
    yield rep
    shutil.rmtree(rep.base_dir, ignore_errors=True)


def test_seed7_linearizable_under_the_lying_network(net_drill):
    rep = net_drill
    assert rep.verdict == "LINEARIZABLE"
    for cls, res in rep.per_class.items():
        assert res.verdict == "LINEARIZABLE", (cls, res)
    assert rep.digest_ok, rep.digest_detail
    assert rep.kills >= 1 and rep.partitions >= 1


def test_wire_fault_receipts_all_present(net_drill):
    rep = net_drill
    assert rep.net_ok, rep.summary()
    assert rep.frames_delayed >= 1
    assert rep.frames_dup >= 1
    assert rep.conns_torn >= 1
    assert rep.redials >= 1
    assert rep.corrupt_injected >= 1
    assert rep.corrupt_dropped >= 1
    assert rep.stale_round_ignored >= 1
    assert rep.demotions >= 1
    assert rep.reelected and rep.reelect_s is not None


def test_restart_rides_the_durable_handoff(net_drill):
    rep = net_drill
    assert rep.handoff_ok, rep.summary()
    assert rep.generation >= 2
    assert rep.segments_adopted >= 1
    assert rep.rejoined


def test_dialer_diagnostics_surface_in_status_and_explain(net_drill):
    from raft_tpu_torch.obs.__main__ import _explain_any

    rep = net_drill
    assert any("dialer" in st for st in rep.statuses.values() if st)
    assert sum(int(st.get("dialer", {}).get("dials", 0))
               for st in rep.statuses.values() if st) >= 1
    text = _explain_any(os.path.join(rep.base_dir, "blackbox"))
    assert "net_faults_armed" in text
    assert "peer_redial" in text


def test_receipts_equal_the_jax_run(net_drill):
    want, summary = jax_drill("cluster_net_run", 7)
    assert receipts("cluster_net_run", net_drill) == want, summary
    assert net_drill.repro == \
        "python -m raft_tpu_torch.chaos --cluster-net --seed 7"


def _broken(broken):
    rep = run_drill("raft_tpu_torch", "cluster_net_run", 7, broken=broken)
    try:
        want, summary = jax_drill("cluster_net_run", 7, broken=broken)
        return rep, receipts("cluster_net_run", rep), want, summary
    finally:
        shutil.rmtree(rep.base_dir, ignore_errors=True)


def test_peer_no_crc_is_caught_by_the_digest_plane():
    rep, got, want, summary = _broken("peer_no_crc")
    assert rep.caught is True
    assert rep.caught_by == "digest"
    assert not rep.digest_ok
    assert "DIVERGED" in rep.digest_detail
    assert got == want, summary


def test_lease_stale_round_is_caught_by_the_checker():
    """The variant provokes its stale lease read by timing (a reply-delay
    ramp, then a one-sided partition) and misses it in some runs of
    either package, each run alone (JAX's 1 of 2, the port's 1 of 3)."""
    rep, got, want, summary = _broken("lease_stale_round")
    assert rep.caught is True
    assert rep.caught_by == "checker"
    assert rep.verdict == "VIOLATION"
    assert got == want, summary
