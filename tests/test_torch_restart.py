"""Whole-process restart (``RaftEngine.save_checkpoint`` /
``RaftEngine.restore``) through the port's engine against the JAX engine.

The single-device cases of ``tests/test_restart.py``, each run by both
engines in lock step (``Pair``): the checkpoint each engine writes holds
the same arrays, each restored engine equals the other event for event
(nodelog, rng, heap, stamps, every state leaf, the archive, the apply
stream), and a checkpoint written by either engine restores the other
(the restored pair then runs on from one file). 3 replicas with 16-byte
entries, or RS(5,3) with 12-byte entries; B = 4, C = 32 or 64. The two
mesh restarts of the JAX tests run on the port's mirrored ranks in
tests/test_torch_engine_mesh.py.
"""

import numpy as np
import pytest

from raft_tpu.ckpt import EngineCheckpoint as JCheckpoint
from raft_tpu_torch.ckpt import EngineCheckpoint as TCheckpoint
from raft_tpu_torch.ckpt import Snapshot as TSnapshot
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core.state import committed_payloads, log_entries
from raft_tpu_torch.ec.reconstruct import reconstruct
from raft_tpu_torch.ec.rs import RSCode
from raft_tpu_torch.raft import RaftEngine as TEngine
from tests.test_torch_engine import Pair, payloads, transports

PLAIN = dict(n_replicas=3, entry_bytes=16, batch_size=4, log_capacity=64)
EC = dict(n_replicas=5, entry_bytes=12, batch_size=4, log_capacity=64,
          rs_k=3, rs_m=2)


def save_both(p, tmp_path, tag="ck"):
    """Each engine saves its checkpoint; the two files hold equal arrays."""
    paths = (str(tmp_path / f"{tag}_j.npz"), str(tmp_path / f"{tag}_t.npz"))
    p.j.save_checkpoint(paths[0])
    p.t.save_checkpoint(paths[1])
    with np.load(paths[0]) as jz, np.load(paths[1]) as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for f in jz.files:
            assert tz[f].dtype == jz[f].dtype, f
            np.testing.assert_array_equal(tz[f], jz[f], err_msg=f)
    return paths


def committed_tail(e, r):
    hi = int(e.state.commit_index[r])
    lo = max(1, hi - e.state.capacity + 1)
    return [bytes(x) for x in log_entries(e.state, r, lo, hi)]


def test_restart_preserves_committed_log_and_continues(tmp_path):
    p = Pair(0, **PLAIN)
    p.until_leader()
    pre = payloads(10, 1, entry=16)
    seqs = p.submit(pre)
    p.until_committed(seqs[-1])
    term_before = int(p.t.state.term.max())
    p2 = Pair(0, restore_from=save_both(p, tmp_path), **PLAIN)
    assert p2.t.commit_watermark == len(pre)
    assert sum("restored from checkpoint to 10" in ln for ln in p2.tl) == 3
    for r in range(3):
        assert [bytes(x) for x in committed_payloads(p2.t.state, r)] == pre
    p2.until_leader()
    assert p2.t.leader_term > term_before
    post = payloads(5, 2, entry=16)
    s2 = p2.submit(post)
    p2.until_committed(s2[-1])
    p2.run_for(3 * p2.t.cfg.heartbeat_period)
    p2.check_all()
    for r in range(3):
        assert committed_tail(p2.t, r) == pre + post, f"replica {r}"


def test_restart_votedfor_round_trips(tmp_path):
    p = Pair(5, **PLAIN)
    p.until_leader()
    voted = p.t.state.voted_for.numpy().copy()
    terms = p.t.state.term.numpy().copy()
    p2 = Pair(5, restore_from=save_both(p, tmp_path), **PLAIN)
    np.testing.assert_array_equal(p2.t.state.voted_for.numpy(), voted)
    np.testing.assert_array_equal(p2.t.state.term.numpy(), terms)
    p2.check_all()


def test_restart_with_lapped_ring(tmp_path):
    kw = {**PLAIN, "log_capacity": 32}
    p = Pair(0, **kw)
    p.until_leader()
    pre = payloads(100, 3, entry=16)
    p.both("submit_pipelined", pre)
    p2 = Pair(0, restore_from=save_both(p, tmp_path), replay=True, **kw)
    assert p2.t.commit_watermark == 100
    assert p2.starts[1] == 100 - 2 * 32 + 1      # the archive keeps 2x C
    tail = committed_tail(p2.t, 0)
    assert tail == pre[-len(tail):]
    p2.until_leader()
    post = payloads(8, 4, entry=16)
    s = p2.both("submit_pipelined", post)
    assert all(p2.t.is_durable(x) for x in s)
    assert committed_tail(p2.t, p2.t.leader_id)[-8:] == post
    p2.check_all()


def test_restart_ec_cluster(tmp_path):
    """The snapshot holds FULL entries; restore re-encodes every replica's
    shard row (on the device in the port, with the host codec in JAX) and
    reconstruction reads the same bytes back."""
    p = Pair(0, **EC)
    p.until_leader()
    pre = payloads(20, 6, entry=12)
    seqs = p.both("submit_pipelined", pre)
    assert all(p.t.is_durable(s) for s in seqs)
    p2 = Pair(0, restore_from=save_both(p, tmp_path), **EC)
    assert p2.t.commit_watermark == 20
    p2.check_all()
    data = reconstruct(p2.t.state, RSCode(5, 3), [1, 3, 4], 1, 20)
    assert [bytes(x) for x in data] == pre
    p2.until_leader()
    post = payloads(4, 7, entry=12)
    s2 = p2.both("submit_pipelined", post)
    assert all(p2.t.is_durable(x) for x in s2)
    p2.run_for(3 * p2.t.cfg.heartbeat_period)
    p2.check_all()
    assert [bytes(x) for x in p2.t.committed_entries(1, 24)] == pre + post


@pytest.mark.parametrize("kw", [PLAIN, EC], ids=["plain", "ec"])
@pytest.mark.parametrize("source", ["jax", "torch"])
def test_checkpoint_restores_in_the_other_engine(tmp_path, kw, source):
    """A checkpoint the JAX engine wrote restores the port's engine (and
    the reverse): both engines restored from the ONE file stay equal."""
    p = Pair(11, **kw)
    p.until_leader()
    pre = payloads(24, 12, entry=kw["entry_bytes"])
    seqs = p.submit(pre)
    p.until_committed(seqs[-1])
    path = save_both(p, tmp_path)[0 if source == "jax" else 1]
    p2 = Pair(11, restore_from=(path, path), **kw)
    p2.until_leader()
    post = payloads(8, 13, entry=kw["entry_bytes"])
    s2 = p2.submit(post)
    p2.until_committed(s2[-1])
    p2.check_all()
    assert [bytes(x) for x in p2.t.committed_entries(1, 32)] == pre + post


def test_restore_rejects_mismatched_config(tmp_path):
    p = Pair(0, **PLAIN)
    p.until_leader()
    p.until_committed(p.submit(payloads(3, 5, entry=16))[-1])
    path = save_both(p, tmp_path)[1]
    bad = dict(PLAIN, n_replicas=5, transport="single")
    with pytest.raises(ValueError):
        TEngine.restore(TConfig(**bad), path, transports(bad)[1])
    wide = dict(PLAIN, entry_bytes=32, transport="single")
    with pytest.raises(ValueError, match="entry size"):
        TEngine.restore(TConfig(**wide), path, transports(wide)[1])


def test_empty_checkpoint_round_trips(tmp_path):
    p = Pair(9, **PLAIN)
    p2 = Pair(9, restore_from=save_both(p, tmp_path), **PLAIN)
    assert p2.t.commit_watermark == 0
    p2.until_leader()
    s = p2.submit(payloads(3, 10, entry=16))
    p2.until_committed(s[-1])
    p2.check_all()


def test_save_checkpoint_backfills_interior_hole(tmp_path):
    p = Pair(11, **PLAIN)
    p.until_leader()
    for e in (p.j, p.t):
        orig = e._archive_committed
        skip = [True]

        def flaky(r, lo, hi, orig=orig, skip=skip):
            if skip[0]:          # the commit-time archive gives up once
                skip[0] = False
                return
            orig(r, lo, hi)

        e._archive_committed = flaky
    s1 = p.submit(payloads(4, 12, entry=16))
    p.until_committed(s1[-1])
    s2 = p.submit(payloads(4, 13, entry=16))
    p.until_committed(s2[-1])
    p2 = Pair(11, restore_from=save_both(p, tmp_path), **PLAIN)
    assert p2.t.store.covers(1, p.t.commit_watermark)
    p2.check_all()


def test_save_checkpoint_refuses_unrecoverable_hole(tmp_path):
    p = Pair(14, **PLAIN)
    p.until_leader()
    s1 = p.submit(payloads(6, 15, entry=16))
    p.until_committed(s1[-1])
    for e in (p.j, p.t):
        del e.store._slots[2], e.store._slots[3]
        e._backfill_archive = lambda idx, quiet=False: False
    for e in (p.j, p.t):
        with pytest.raises(RuntimeError, match="not archived"):
            e.save_checkpoint(str(tmp_path / "refused.npz"))


def _based_checkpoint(tmp_path, cls):
    ps = payloads(8, 17, entry=16)
    path = str(tmp_path / f"based_{cls.__module__.split('.')[0]}.npz")
    cls(snap=TSnapshot(5, 12, np.frombuffer(b"".join(ps), np.uint8).reshape(
            8, 16), np.full(8, 3, np.int32)),
        terms=np.full(3, 3, np.int32),
        voted_for=np.full(3, -1, np.int32)).save(path)
    return path, ps


@pytest.mark.parametrize("cls", [JCheckpoint, TCheckpoint],
                         ids=["jax-written", "torch-written"])
def test_read_below_snapshot_base_rejected(tmp_path, cls):
    """A checkpoint whose snapshot starts above index 1: the restored range
    reads back, anything below the base is refused."""
    path, ps = _based_checkpoint(tmp_path, cls)
    kw = {**PLAIN, "log_capacity": 16}
    p = Pair(16, restore_from=(path, path), **kw)
    e = p.t
    assert e.commit_watermark == 12
    np.testing.assert_array_equal(
        e.committed_entries(5, 12),
        np.frombuffer(b"".join(ps), np.uint8).reshape(8, 16))
    for lo, hi in ((1, 12), (4, 6)):
        with pytest.raises(ValueError, match="checkpoint store"):
            e.committed_entries(lo, hi)
    p.check_all(read_back=False)


def test_resave_after_restore_never_fabricates_history(tmp_path):
    path, ps = _based_checkpoint(tmp_path, TCheckpoint)
    kw = {**PLAIN, "log_capacity": 16}
    for elect in (False, True):
        p = Pair(18, restore_from=(path, path), **kw)
        if elect:
            p.until_leader()
        out = save_both(p, tmp_path, f"resave{elect}")
        ck = TCheckpoint.load(out[1])
        assert ck.snap.base_index == 5
        np.testing.assert_array_equal(
            ck.snap.entries,
            np.frombuffer(b"".join(ps), np.uint8).reshape(8, 16))
    p = Pair(18, restore_from=(path, path), **kw)
    p.until_leader()
    seen = []
    start = p.t.register_apply(lambda i, b: seen.append((i, bytes(b))),
                               replay=True)
    assert start == 5
    assert seen == list(zip(range(5, 13), ps))
