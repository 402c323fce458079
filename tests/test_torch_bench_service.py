"""The port's service and multi-group bench legs (``macro``, ``txn``,
``multi_group``, ``group_shard``) against ``bench.py``'s on the CPU
(``tests/_torch_bench.py``): the same row keys, and equal deterministic
fields. The wire legs' socket interleaving is outside seeded replay, so
their counts are held by invariants, not equality."""

from _torch_bench import rows, same_keys


def test_macro_matches_jax():
    j, t = rows("macro")
    same_keys(j, t, "macro")
    for k in ("entries", "groups", "batch", "entry_bytes"):
        assert t["inproc"][k] == j["inproc"][k], k
    assert t["wire"]["entries"] == j["wire"]["entries"] == 16384
    assert t["wire"]["shed_rate"] == 0.0
    assert t["wire_traced"]["entries"] == j["wire_traced"]["entries"]
    kill = t["leader_kill"]
    assert kill["leader_killed"] and kill["leader_recovered"]
    assert kill["depth_bound_held"]


def test_txn_matches_jax():
    """Every request was issued and answered: no outcome unknown, and the
    transfers either committed or aborted on a failed expectation."""
    j, t = rows("txn")
    same_keys(j, t, "txn")
    for k in ("connections", "requests", "wire_batch", "groups"):
        assert t[k] == j[k], k
    assert t["txn_unknown"] == j["txn_unknown"] == 0
    assert t["txns"] == t["txn_committed"] + t["txn_aborted"]
    assert t["txn_committed"] > 0


def test_multi_group_matches_jax():
    """The G-sweep commits the same entries at the same virtual-clock
    latencies, under the same leader placement."""
    j, t = rows("multi_group")
    same_keys(j, t, "multi_group")
    for g in ("G1", "G4", "G16"):
        for k in ("groups", "entries", "virtual_commit_p50_s",
                  "virtual_commit_p99_s", "leader_spread", "batch",
                  "entry_bytes", "scan_steps"):
            assert t[g][k] == j[g][k], (g, k)


def test_group_shard_matches_jax():
    """The sharded sweep's rows: JAX's keys plus ``device``, which names
    where both shards ran (the JAX sweep's deadline cuts it after G = 64,
    so its G = 64 row is the one compared field by field); the migration
    row, which the JAX run's deadline skipped, has its keys too."""
    j, t = rows("group_shard")
    assert set(t) == {"single_g16_us_per_group_tick", "G64", "G256",
                      "G1024", "migration"}
    for g in ("G64", "G256", "G1024"):
        same_keys(j["G64"], t[g], f"group_shard.{g}", port_only=("device",))
        assert t[g]["launches_per_tick"] == 1.0
    assert t["G64"]["device"] == "cpu (both shards)"
    for k in ("groups", "fused_ticks", "entries", "batch",
              "entry_bytes", "virtual_commit_p50_s", "leader_spread"):
        assert t["G64"][k] == j["G64"][k], k
    assert t["G64"]["shards"] == 2        # JAX's: the 8 virtual devices
    assert isinstance(t["single_g16_us_per_group_tick"], float)
    assert set(t["migration"]) == {"groups", "moves", "first_move_ms",
                                   "steady_move_ms", "committed_after_move",
                                   "device"}
    assert [set(m) for m in t["migration"]["moves"]] == \
        [{"group", "src", "dst", "catch_up_s"}] * 2
