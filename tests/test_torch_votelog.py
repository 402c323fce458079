"""The vote log (``raft_tpu_torch.ckpt.votelog``) against the JAX package's
(``raft_tpu.ckpt.votelog``): the file format is the same byte for byte, so
a log written by either package replays in the other, and the engine's
durability fences (``vote_log=``) write the same records at the same
transitions as the JAX engine's.

The cases of ``tests/test_votelog.py``: the file cases run with each
package writing and each reading; the engine cases run both engines in
lock step (``Pair``: nodelog, rng, heap and the vote log files equal after
every event) at 3 replicas, 16-byte entries, B = 4, C = 64.
"""

import shutil

import numpy as np
import pytest
import torch

from raft_tpu.ckpt import VoteLog as JVoteLog
from raft_tpu.ckpt import merge_restored as jmerge
from raft_tpu_torch.ckpt import VoteLog as TVoteLog
from raft_tpu_torch.ckpt import merge_restored as tmerge
from raft_tpu_torch.core.state import state_from_numpy, state_to_numpy
from tests.test_torch_engine import Pair, payloads

KW = dict(n_replicas=3, entry_bytes=16, batch_size=4, log_capacity=64)
LOGS = {"jax": JVoteLog, "torch": TVoteLog}
#: (writer, reader): each package reads the other's files
WAYS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]
ways = pytest.mark.parametrize("writer,reader", WAYS,
                               ids=[f"{w}-{r}" for w, r in WAYS])


@ways
def test_roundtrip_last_record_wins(tmp_path, writer, reader):
    p = str(tmp_path / "v.log")
    vl = LOGS[writer](p)
    vl.record_many([(0, 1, 2), (1, 1, 2), (2, 1, -1)])
    vl.record_many([(2, 3, 0)])
    vl.close()
    assert LOGS[reader].replay(p) == {0: (1, 2), 1: (1, 2), 2: (3, 0)}


def test_files_are_byte_identical(tmp_path):
    """The same records, appended, truncated and appended again, leave the
    same bytes on disk in both packages."""
    out = {}
    for name, cls in LOGS.items():
        p = str(tmp_path / f"{name}.log")
        vl = cls(p)
        vl.record_many([(0, 5, 1), (1, 5, 1)])
        vl.record_many([(2, 9, -1)])
        vl.truncate()
        vl.record_many([(1, 11, 2)])
        vl.close()
        out[name] = open(p, "rb").read()
    assert out["torch"] == out["jax"]


@ways
def test_torn_trailing_record_ignored(tmp_path, writer, reader):
    p = str(tmp_path / "v.log")
    vl = LOGS[writer](p)
    vl.record_many([(0, 5, 1)])
    vl.close()
    with open(p, "ab") as f:
        f.write(b"\x01\x02\x03")          # crash mid-append
    assert LOGS[reader].replay(p) == {0: (5, 1)}


@ways
def test_truncate_resets(tmp_path, writer, reader):
    p = str(tmp_path / "v.log")
    vl = LOGS[writer](p)
    vl.record_many([(0, 5, 1)])
    vl.truncate()
    vl.record_many([(1, 7, 0)])
    vl.close()
    assert LOGS[reader].replay(p) == {1: (7, 0)}


def test_missing_file_empty(tmp_path):
    assert TVoteLog.replay(str(tmp_path / "absent.log")) == {}


@ways
def test_merge_higher_term_wins(tmp_path, writer, reader):
    p = str(tmp_path / "v.log")
    vl = LOGS[writer](p)
    vl.record_many([(0, 9, 2), (1, 1, 0)])
    vl.close()
    merge = tmerge if reader == "torch" else jmerge
    terms, vf = merge(3, np.array([3, 3, 3], np.int64),
                      np.array([1, 1, 1], np.int64), p)
    assert list(terms) == [9, 3, 3]       # replica 1's stale record lost
    assert list(vf) == [2, 1, 1]


def test_corrupt_header_refused(tmp_path):
    p = str(tmp_path / "bad.log")
    with open(p, "wb") as f:
        f.write(b"GARBAGE-HEADER")
    with pytest.raises(ValueError, match="bad header"):
        TVoteLog(p)


@ways
def test_torn_creation_header_recovers(tmp_path, writer, reader):
    p = str(tmp_path / "torn.log")
    with open(p, "wb") as f:
        f.write(b"RTV")                   # crash mid-first-header-write
    vl = LOGS[writer](p)                  # rewrites the header cleanly
    vl.record_many([(0, 4, 1)])
    vl.close()
    assert LOGS[reader].replay(p) == {0: (4, 1)}


@ways
def test_truncate_is_atomic_and_appendable(tmp_path, writer, reader):
    p = str(tmp_path / "t.log")
    vl = LOGS[writer](p)
    vl.record_many([(0, 2, 1), (1, 2, 1)])
    vl.truncate()
    vl.record_many([(2, 5, 0)])
    vl.close()
    assert LOGS[reader].replay(p) == {2: (5, 0)}
    vl2 = LOGS[reader](p)                 # reopened by the other package
    vl2.record_many([(0, 6, 2)])
    vl2.close()
    assert LOGS[writer].replay(p) == {2: (5, 0), 0: (6, 2)}


@ways
def test_torn_record_trimmed_on_reopen(tmp_path, writer, reader):
    p = str(tmp_path / "v.log")
    vl = LOGS[writer](p)
    vl.record_many([(0, 5, 1)])
    vl.close()
    with open(p, "ab") as f:
        f.write(b"\x01\x02\x03")          # crash mid-append
    vl = LOGS[reader](p)                  # reopen after the crash
    vl.record_many([(1, 7, 0)])
    vl.close()
    assert LOGS[writer].replay(p) == {0: (5, 1), 1: (7, 0)}


# ------------------------------------------------------------ the engines
def _logs(tmp_path, tag=""):
    return (str(tmp_path / f"j{tag}.vlog"), str(tmp_path / f"t{tag}.vlog"))


def _probe_votes(e, cand, term):
    """Votes a fresh vote round for ``cand`` in ``term`` would get, on a
    copy of the port engine's state (the engine's own state is kept)."""
    st = state_from_numpy(state_to_numpy(e.state), "cpu")
    _, info = e.t.request_votes(st, cand, term, torch.ones(3, dtype=bool))
    return int(info.votes)


def test_crash_between_vote_and_checkpoint(tmp_path):
    """A vote is granted, the process dies before any checkpoint and
    restarts: nobody votes again in that term. Both engines replay the
    same records, and the restarted pair runs on in lock step."""
    logs = _logs(tmp_path)
    p = Pair(3, vote_logs=logs, **KW)
    lead = p.until_leader()
    T = p.t.leader_term
    vf1 = p.t.state.voted_for.numpy().copy()
    assert (vf1 == lead).all()
    other = (lead + 1) % 3
    # without the log a restart forgets the votes and double-votes
    amnesiac = Pair(3, **KW)
    assert _probe_votes(amnesiac.t, other, T) == 3
    p2 = Pair(3, vote_logs=logs, **KW)    # the restart: no checkpoint
    np.testing.assert_array_equal(p2.t.state.voted_for.numpy(), vf1)
    assert (p2.t.terms == T).all()
    assert any("vote log replayed" in ln for ln in p2.tl)
    assert _probe_votes(p2.t, other, T) == 0
    p2.until_leader()
    assert p2.t.leader_term > T
    p2.check_all()


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_engine_replays_the_other_packages_log(tmp_path, source):
    """A vote log the JAX engine wrote restarts the port's engine (and the
    reverse) exactly as it restarts the engine that wrote it."""
    p = Pair(4, vote_logs=_logs(tmp_path), **KW)
    p.until_leader()
    p.submit(payloads(4, 4, entry=16))
    p.run_for(10.0)
    src = p.vote_logs[0 if source == "jax" else 1]
    logs = _logs(tmp_path, "2")
    for dst in logs:
        shutil.copyfile(src, dst)
    p2 = Pair(4, vote_logs=logs, **KW)
    np.testing.assert_array_equal(p2.t.terms, p.t.terms)
    np.testing.assert_array_equal(p2.t.state.voted_for.numpy(),
                                  p.t.state.voted_for.numpy())
    p2.until_leader()
    p2.check_all()


def test_step_down_and_adoption_are_durable(tmp_path):
    logs = _logs(tmp_path)
    p = Pair(5, vote_logs=logs, **KW)
    lead = p.until_leader()
    T1 = p.t.leader_term
    seqs = p.submit(payloads(4, 6, entry=16))
    p.until_committed(seqs[-1])
    p.both("force_campaign", (lead + 1) % 3)   # deposes lead at a higher term
    T2 = p.t.leader_term
    assert T2 > T1
    p2 = Pair(5, vote_logs=logs, **KW)          # crash before any checkpoint
    assert (p2.t.terms >= T2).all()


def test_checkpoint_rotates_wal_and_overlay_restores(tmp_path):
    logs = _logs(tmp_path)
    p = Pair(7, vote_logs=logs, **KW)
    lead = p.until_leader()
    seqs = p.submit(payloads(4, 8, entry=16))
    p.until_committed(seqs[-1])
    cks = (str(tmp_path / "j.npz"), str(tmp_path / "t.npz"))
    p.j.save_checkpoint(cks[0])
    p.t.save_checkpoint(cks[1])                 # rotates the WAL
    assert TVoteLog.replay(logs[1]) == {}
    p.check()
    T_ck = p.t.leader_term
    p.both("force_campaign", (lead + 1) % 3)    # post-checkpoint transition
    T_new = p.t.leader_term
    vf_new = p.t.state.voted_for.numpy().copy()
    assert T_new > T_ck
    p2 = Pair(7, vote_logs=logs, restore_from=cks, **KW)
    assert (p2.t.terms >= T_new).all()           # the WAL overlay wins
    np.testing.assert_array_equal(p2.t.state.voted_for.numpy(), vf_new)
    assert p2.t.commit_watermark == 4
    p2.until_leader()
    s = p2.submit(payloads(2, 9, entry=16))
    p2.until_committed(s[-1])
    p2.check_all()


def test_submit_pipelined_persists_before_commit(tmp_path):
    """The scanned chunk's term adoptions reach the log before
    ``_advance_commit`` makes anything observable, as on the tick path."""
    p = Pair(3, vote_logs=_logs(tmp_path), **KW)
    p.until_leader()
    e = p.t
    order = []
    real_persist, real_adv = e._persist_votes, e._advance_commit

    def spy_persist(*a, **k):
        order.append("persist")
        return real_persist(*a, **k)

    def spy_adv(*a, **k):
        order.append("commit")
        return real_adv(*a, **k)

    e._persist_votes, e._advance_commit = spy_persist, spy_adv
    ps = payloads(8, 30, entry=16)
    p.j.submit_pipelined(ps)
    e.submit_pipelined(ps)
    e._persist_votes, e._advance_commit = real_persist, real_adv
    assert "persist" in order and "commit" in order
    assert order.index("persist") < order.index("commit")
    p.check_all()
