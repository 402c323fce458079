"""The port's host-driven bench legs against ``bench.py``'s on the CPU
(``tests/_torch_bench.py``): the same row keys, the virtual-clock figures
equal exactly, the committed totals and protocol counts equal, and the
attribution columns tiling the tick."""

import raft_tpu_torch.bench as tb
from _torch_bench import rows, same_keys, small


# ----------------------------------------------------------- the host legs
def test_c1_loopback_matches_jax():
    j, t = rows("c1_loopback")
    same_keys(j, t, "c1_loopback")
    assert t["virtual_commit_p50_s"] == j["virtual_commit_p50_s"]


def test_c5_storm_matches_jax_exactly():
    """Every field of both storm variants is a virtual-clock figure or a
    count: equal exactly."""
    j, t = rows("c5_storm")
    same_keys(j, t, "c5_storm")
    assert t == j


def test_read_index_matches_jax():
    j, t = rows("read_index")
    same_keys(j, t, "read_index")
    assert t["batched_extra_rounds"] == j["batched_extra_rounds"] == 0
    assert t["metrics"] == j["metrics"]


def test_read_scale_matches_jax():
    j, t = rows("read_scale")
    same_keys(j, t, "read_scale")
    for cls in ("read_index", "lease", "follower", "session"):
        for k in ("reads", "write_fraction", "read_rounds_extra",
                  "lease_serves", "served_by_replica", "replicas_serving"):
            assert t[cls].get(k) == j[cls].get(k), (cls, k)
    assert t["lease"]["read_rounds_extra"] == 0
    assert t["classes"] == j["classes"]


def test_client_chunk_matches_jax():
    """One ring a chunk on both; off the card neither engine takes the
    lapped launch, and both say so in the same error field."""
    j, t = rows("client_chunk")
    same_keys(j, t, "client_chunk")
    assert t["chunk_entries"] == j["chunk_entries"] == 512
    assert t["lapped_chunk"] == j["lapped_chunk"]
    assert "error" in t["lapped_chunk"]


def test_client_chunk_lapped_launch_taken_where_the_flight_runs(
        monkeypatch):
    """With the engine's flight gate open (as on the card) the lapped
    backlog rides ONE launch of 8·C/B steps, and the row has no error."""
    import raft_tpu_torch.raft.engine as eng

    monkeypatch.setattr(eng, "_pipeline_backend_ok", lambda *a: True)
    with small():
        t = tb.bench_client_latency("cpu")
    assert t["lapped_chunk"]["chunk_entries"] == 8 * 512
    assert "error" not in t["lapped_chunk"]


def test_attribution_matches_jax():
    j, t = rows("attribution")
    same_keys(j, t, "attribution")
    for k in ("ticks", "leader_ticks", "entries_per_tick"):
        assert t[k] == j[k], k
    for k in ("records", "dropped"):
        assert t["device_obs"][k] == j["device_obs"][k], k
    for k in ("audit_violations", "status_generations",
              "slo_commit_digest_n"):
        assert t["online_plane"][k] == j["online_plane"][k], k
    assert set(t["columns_us"]) == set(j["columns_us"])
    # the boundary-marked phases tile the tick
    assert 0.9 <= t["attribution_coverage"] <= 1.1


def test_fusion_matches_jax():
    """Each K drains the same backlog in the same protocol ticks and
    launches (the virtual clock decides both)."""
    j, t = rows("fusion")
    same_keys(j, t, "fusion")
    for k in ("K1", "K8", "K64", "K256"):
        for f in ("K", "ticks", "launches", "ticks_per_launch"):
            assert t[k][f] == j[k][f], (k, f)


def test_overload_matches_jax_exactly():
    """The admission policy on the virtual clock: every figure equal."""
    j, t = rows("overload")
    same_keys(j, t, "overload")
    for mult in ("x1", "x2", "x5"):
        assert t[mult] == j[mult], mult


def test_reconfig_matches_jax():
    """Rejoin ladder and latency dip on the virtual clock: the tick-derived
    figures equal exactly (the walls and the seal rate are host time)."""
    j, t = rows("reconfig")
    same_keys(j, t, "reconfig")
    host = {"rejoin_wall_ms", "seal_entries_per_sec"}
    for k in ("wipe_log64", "wipe_log256", "wipe_log1024", "wipe_log4096"):
        assert {f: v for f, v in t[k].items() if f not in host} == \
            {f: v for f, v in j[k].items() if f not in host}, k
    for k in ("wipe_ladder", "latency_dip"):
        assert {f: v for f, v in t[k].items() if f != "note"} == \
            {f: v for f, v in j[k].items() if f != "note"}, k
