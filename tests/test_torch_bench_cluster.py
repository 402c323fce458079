"""The port's ``cluster`` leg against ``bench.py``'s on the CPU: the same
four rows with the same keys (``tests/_torch_bench.py``), every write of
the goodput row acknowledged, the peer-RTT fault injected and lifted, the
leader killed, and both restarts caught up with the survivors. Each leg
runs 3 replica processes (host code only)."""

from _torch_bench import rows, same_keys


def test_cluster_matches_jax():
    j, t = rows("cluster")
    assert set(t) == set(j) == {"goodput", "latency", "kill9", "handoff"}
    for k in ("goodput", "latency", "kill9", "handoff"):
        same_keys(j[k], t[k], f"cluster.{k}")
    for side in (j, t):
        assert side["goodput"]["entries"] == 900
        assert side["latency"]["injected_peer_delay_ms"] == 5
        assert side["handoff"]["handoff_caught_up"]
        assert side["handoff"]["reseal_caught_up"]
        assert side["handoff"]["segments_resealed"] == 0
    assert t["kill9"]["rate_x_capacity"] == 2.0
