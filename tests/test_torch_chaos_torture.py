"""The port's torture runners against the JAX package's, seed for seed
(``tests/test_torture.py``'s tier-1 cases): the same report fields, the
same nemesis log and message counts, and the same client history, op by
op with its virtual times (``tests/_torch_chaos.py``). The port runs on
the CPU here; ``chip_smoke.py``'s ``chaos_path`` holds the card to it.

Also ``TestMirroredStore`` over the port's store, and the durable files a
crash-cycle run leaves (checkpoint mirrors, their previous generation and
the vote log) equal in size to the JAX run's: ``flip_bit`` draws its
position from the file length, so a length that differed would fork the
seeded stream."""

import os
import random

import numpy as np
import pytest

from raft_tpu_torch.chaos import LINEARIZABLE, VIOLATION, MirroredStore
from tests._torch_chaos import assert_same, jax_run, port_run

PINNED_SEEDS = [2, 3, 5]


def held(fn, *args, **kw):
    """The port's run, equal to JAX's; returns the port's report."""
    got, rep = port_run(fn, *args, **kw)
    assert_same(got, jax_run(fn, *args, **kw))
    return rep


def _assert_linearizable(rep):
    assert rep.verdict == LINEARIZABLE, rep.summary()
    assert rep.op_counts.get("ok", 0) >= 10, rep.summary()


def test_torture_pinned_seeds_match_jax_and_cover_every_fault_plane():
    reps = [held("torture_run", s, phases=10) for s in PINNED_SEEDS]
    assert any(r.crashes > 0 for r in reps)
    assert any(r.msg_stats.get("drop", 0) > 0 for r in reps)
    assert any(r.msg_stats.get("dup", 0) > 0 for r in reps)
    assert any(r.msg_stats.get("delivered", 0) > 0 for r in reps)
    assert any("storage" in line and "none" not in line
               for r in reps for line in r.nemesis_log
               if "crash_restart" in line)
    for r in reps:
        _assert_linearizable(r)
        assert r.repro.startswith("python -m raft_tpu_torch.chaos --seed")


def test_torture_multi_router_matches_jax():
    rep = held("torture_run_multi", 0, n_groups=4, phases=8)
    _assert_linearizable(rep)
    assert rep.msg_stats == {} and rep.crashes == 0


@pytest.mark.parametrize("seed", [0, 4])
def test_broken_client_variant_rejected_as_jax_rejects_it(seed):
    rep = held("torture_run", seed, phases=10, keys=2, broken="dirty_reads")
    assert rep.verdict == VIOLATION, rep.summary()
    assert rep.check.key is not None
    assert "--broken dirty_reads" in rep.repro


@pytest.mark.parametrize("seed", [0, 9])
def test_overload_torture_matches_jax(seed):
    rep = held("torture_run", seed, phases=10, overload=True)
    _assert_linearizable(rep)
    assert rep.open_loop_ops > 100 and rep.shed_ops > 0
    assert rep.op_counts.get("fail", 0) >= rep.shed_ops


def test_overload_recovery_matches_jax():
    rep = held("overload_run", 0, rate_mult=5.0)
    assert rep.verdict == LINEARIZABLE, rep.summary()
    assert rep.queue_depth_max <= rep.depth_bound
    assert rep.depth_high_water <= rep.depth_bound
    assert rep.recovery_ok and rep.recovered_in_s <= rep.recovery_window_s
    assert sum(rep.shed.values()) > 0
    assert rep.queue_delay_p99_overload_s >= 4.0


def test_overload_multi_router_matches_jax():
    rep = held("torture_run_multi", 3, n_groups=4, phases=8, overload=True)
    _assert_linearizable(rep)
    assert rep.open_loop_ops > 0


def test_crash_cycle_files_equal_jax_in_size(tmp_path):
    """Seed 3 runs three crash cycles with storage faults: every file of
    the durable store ends the same length in both packages."""
    from raft_tpu.chaos.runner import torture_run as jtorture
    from raft_tpu_torch.chaos.runner import torture_run

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    j = jtorture(3, phases=6, workdir=str(jdir))
    t = torture_run(3, phases=6, workdir=str(tdir), device="cpu")
    assert t.crashes == j.crashes >= 1
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert "ckpt.m0.npz" in names and "votes.wal" in names
    for name in names:
        assert os.path.getsize(tdir / name) == os.path.getsize(jdir / name), \
            name


# ------------------------------------------------- storage recovery unit
class _FakeEngine:
    """Just enough engine surface for MirroredStore.save, writing through
    either package's ``EngineCheckpoint``."""

    def __init__(self, path_payload, ckpt=None):
        self._payloads = path_payload
        if ckpt is None:
            import raft_tpu_torch.ckpt as ckpt
        self.ckpt = ckpt

    def save_checkpoint(self, path):
        n = self._payloads.pop(0)
        ents = np.zeros((n, 8), np.uint8)
        self.ckpt.EngineCheckpoint(
            snap=self.ckpt.Snapshot(1, n, ents, np.ones(n, np.int32)),
            terms=np.ones(3, np.int32),
            voted_for=np.full(3, -1, np.int32),
        ).save(path)


class TestMirroredStore:
    def test_bit_flip_detected_and_other_mirror_wins(self, tmp_path):
        store = MirroredStore(str(tmp_path), mirrors=2)
        store.save(_FakeEngine([5]))
        store.flip_bit(0, random.Random(7))
        path, wm, rejected = store.load_best()
        assert rejected == [0]
        assert path == store.mirror_path(1)
        assert wm == 5

    def test_rollback_outranked_by_current_generation(self, tmp_path):
        store = MirroredStore(str(tmp_path), mirrors=2)
        store.save(_FakeEngine([5]))
        store.save(_FakeEngine([5]))
        assert store.rollback(0)
        path, wm, rejected = store.load_best()
        assert rejected == []
        assert path == store.mirror_path(1)
        assert wm == 5

    def test_all_mirrors_corrupt_refuses(self, tmp_path):
        store = MirroredStore(str(tmp_path), mirrors=2)
        store.save(_FakeEngine([3]))
        rng = random.Random(1)
        store.flip_bit(0, rng)
        store.flip_bit(1, rng)
        with pytest.raises(RuntimeError, match="no healthy"):
            store.load_best()

    def test_wipe_node_erases_identity_in_every_generation(self, tmp_path):
        from raft_tpu_torch.ckpt import EngineCheckpoint, VoteLog

        store = MirroredStore(str(tmp_path), mirrors=2)
        log = VoteLog(store.votelog_path)
        log.record_many([(0, 3, 1), (1, 4, 2)])
        log.close()
        store.save(_FakeEngine([5]))
        store.save(_FakeEngine([5]))
        store.wipe_node(1)
        for i in range(2):
            ck = EngineCheckpoint.load(store.mirror_path(i))
            assert int(ck.terms[1]) == 0 and int(ck.voted_for[1]) == -1
            assert int(ck.terms[0]) == 1
        _, _, rejected = store.load_best()
        assert rejected == []
        assert store.rollback(0)
        ck = EngineCheckpoint.load(store.mirror_path(0))
        assert int(ck.terms[1]) == 0
        out = VoteLog.replay(store.votelog_path)
        assert 1 not in out and out[0] == (3, 1)

    def test_torn_votelog_trimmed_on_reopen(self, tmp_path):
        from raft_tpu_torch.ckpt import VoteLog

        store = MirroredStore(str(tmp_path), mirrors=2)
        log = VoteLog(store.votelog_path)
        log.record_many([(0, 3, 1), (1, 3, 1)])
        log.close()
        store.tear_votelog(random.Random(9))
        log2 = VoteLog(store.votelog_path)
        log2.record_many([(2, 4, 0)])
        log2.close()
        out = VoteLog.replay(store.votelog_path)
        assert out == {0: (3, 1), 1: (3, 1), 2: (4, 0)}

    def test_store_files_and_faults_equal_jax(self, tmp_path):
        """The same saves and faults through both packages' stores: the
        same file lengths, the same flipped position, the same verdicts."""
        import raft_tpu.ckpt as jckpt
        from raft_tpu.chaos.storage import MirroredStore as JStore
        from raft_tpu.ckpt import VoteLog as JVoteLog
        from raft_tpu_torch.ckpt import VoteLog

        out = []
        for name, cls, ckpt, vl in (("jax", JStore, jckpt, JVoteLog),
                                    ("port", MirroredStore, None, VoteLog)):
            store = cls(str(tmp_path / name), mirrors=2)
            log = vl(store.votelog_path)
            log.record_many([(0, 3, 1), (1, 4, 2)])
            log.close()
            store.save(_FakeEngine([5, 7], ckpt))
            store.save(_FakeEngine([7], ckpt))
            rng = random.Random(11)
            store.tear_votelog(rng)
            store.flip_bit(1, rng)
            store.wipe_node(2)
            sizes = {f: os.path.getsize(os.path.join(store.root, f))
                     for f in sorted(os.listdir(store.root))}
            blobs = {f: open(os.path.join(store.root, f), "rb").read()
                     for f in sizes if f.endswith(".wal")}
            out.append((sizes, blobs, store.load_best()[1:],
                        rng.random(), store.generation))
        assert out[0] == out[1]


# ------------------------------------------------- the sweeps (slow tier)
@pytest.mark.slow
@pytest.mark.parametrize("mult", [2.0, 4.0, 6.0, 8.0, 10.0])
def test_overload_recovery_sweep_matches_jax(mult):
    rep = held("overload_run", 1, rate_mult=mult)
    assert rep.verdict == LINEARIZABLE and rep.recovery_ok
    assert rep.queue_depth_max <= rep.depth_bound


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(12))
def test_overload_torture_sweep_matches_jax(seed):
    _assert_linearizable(held("torture_run", seed, phases=12,
                              overload=True))


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(24))
def test_torture_sweep_matches_jax(seed):
    _assert_linearizable(held("torture_run", seed, phases=12))


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(6))
def test_torture_multi_sweep_matches_jax(seed):
    _assert_linearizable(held("torture_run_multi", seed, n_groups=4,
                              phases=10))
