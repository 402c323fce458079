"""The port's deterministic chaos drills against the JAX package's: the
read scale-out drill (``tests/test_read_scale.py:521``, ``:532``), the
sealed-segment storage nemesis (``tests/test_tiered.py:500``, with every
shard and manifest file the same length as JAX's), the group-migration
drill on two shards (``tests/test_group_shard.py:502``: the port's
``GroupMesh(["cpu", "cpu"])`` against JAX's mesh of two virtual devices)
and the multi-Raft torture with the group-sharded layout on and off
(``:554``). Each report equals JAX's field by field, history included."""

import os
import re
import tempfile

import pytest

from raft_tpu_torch.chaos import LINEARIZABLE, VIOLATION
from raft_tpu_torch.transport.group_mesh import GroupMesh
from tests._torch_chaos import (
    assert_same,
    env,
    jax_run,
    port_run,
    run_traced,
)

CPU2 = ["cpu", "cpu"]


def test_reads_drill_matches_jax():
    got, rep = port_run("reads_run", 3)
    assert_same(got, jax_run("reads_run", 3))
    assert rep.verdict == LINEARIZABLE, rep.summary()
    assert set(rep.per_class) == {"lease", "read_index", "session"}
    assert rep.refused_stale >= 1 and rep.stale_served == 0
    assert rep.lease_serves > 0 and rep.session_serves > 0
    assert not rep.audit_violations


def test_broken_lease_skew_caught_as_jax_catches_it():
    got, rep = port_run("reads_run", 3, broken="lease_skew")
    assert_same(got, jax_run("reads_run", 3, broken="lease_skew"))
    assert rep.stale_served >= 1
    assert rep.per_class["lease"].verdict == VIOLATION
    assert rep.audit_violations and rep.caught
    assert rep.verdict == VIOLATION


def _tier_files(root):
    """(path below the tier directory, size) of every file under
    ``root``, with the directories' random suffixes taken out."""
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            out.append((re.sub(r"tier_[^/]*", "tier_", rel),
                        os.path.getsize(os.path.join(d, f))))
    return sorted(out)


def test_segment_drill_matches_jax_file_for_file(tmp_path, monkeypatch):
    made = []
    real = tempfile.mkdtemp

    def mkdtemp(suffix=None, prefix=None, dir=None):
        if prefix != "raft_segdrill_":
            return real(suffix, prefix, dir)
        made.append(str(tmp_path / f"drill{len(made)}"))
        os.makedirs(made[-1])
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    got, rep = port_run("segment_storage_run", 7)
    want = run_traced("raft_tpu", "segment_storage_run", 7)[0]
    assert_same(got, want)
    assert len(made) == 2
    port_files, jax_files = _tier_files(made[0]), _tier_files(made[1])
    assert any(p.endswith(".s0") for p, _ in port_files)
    assert port_files == jax_files
    assert rep.verdict == LINEARIZABLE, rep.summary()
    assert rep.rejoined and rep.recovered_via_rs
    assert rep.tier["segment_reconstructs"] > 0
    assert rep.tier["segments_lost"] == 0 and rep.chunks_shipped > 0
    assert {"flip_bit", "drop_shard", "torn_spill"} <= {
        f.split("(")[0] for f in rep.faults}


def test_migration_drill_on_two_shards_matches_jax(monkeypatch):
    import jax

    kw = dict(n_groups=4, n_moves=2, clients=2, keys=4)
    got, rep = port_run("migration_run", 0, mesh=GroupMesh(CPU2), **kw)
    two = jax.devices()[:2]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: two)
    want = run_traced("raft_tpu", "migration_run", 0, **kw)[0]
    assert_same(got, want)
    assert rep.verdict == LINEARIZABLE and rep.progress_ok
    assert len(rep.moves) == 2 and rep.n_shards == 2
    assert all(m["resume_s"] is not None for m in rep.moves)


def test_migration_without_a_mesh_raises_jax_text():
    from raft_tpu_torch.chaos import migration_run

    with pytest.raises(RuntimeError, match="needs a sharded layout"):
        migration_run(0, n_groups=4, n_moves=1, device="cpu")


def test_multi_torture_gshard_on_vs_off_matches_jax():
    plain, _ = port_run("torture_run_multi", 0, n_groups=4, phases=6)
    with env(RAFT_TPU_GSHARD="1"):
        sharded, rep = port_run("torture_run_multi", 0, n_groups=4,
                                phases=6, mesh=GroupMesh(CPU2))
    want = jax_run("torture_run_multi", 0, n_groups=4, phases=6)
    assert_same(plain, want)
    assert_same(sharded, want)
    assert rep.verdict == LINEARIZABLE
