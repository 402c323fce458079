"""Membership changes through the port's engine (``RaftEngine`` with
``max_replicas`` headroom, ROADMAP A9c) against the JAX engine.

The cases of ``tests/test_membership.py``, each run by both engines in
lock step (``Pair``: after every event the rng, the heap, the nodelog
lines, terms, roles, the member/learner masks, the pending and staged
changes and the read plane are equal; at the ends of a case every state
leaf, the stamps, the archive and the apply stream too): single-server
adds and removes that activate when appended, one change at a time, the
removed leader's step-down, rollbacks on a leadership change and on a
truncation, the new majority deciding the appending step, learners
(never counted, promoted once caught up), wipe and replace, an
erasure-coded 5 -> 6 -> 5 at RS(6,3), and checkpoints with learners and
removed voters restoring either engine from either package's file. The
JAX flight recorder's one-leader-per-term check reads the nodelog lines
here. 3 of 5 rows (or 4), 16-byte entries (24 where a learner bitmap
rides the entry), B = 4, C = 256 (8 for the backpressure cases); the EC
cases 5 of 6 rows, 24-byte entries, C = 64. On the CPU the port's
kernel wrappers run their plain versions.
"""

import re

import numpy as np
import pytest
import torch

from raft_tpu.core import state as jst
from raft_tpu_torch.core import state as tst
from raft_tpu_torch.core.state import committed_payloads
from tests._torch_port import assert_states_equal
from tests.test_torch_engine import Pair, payloads, transports
from tests.test_torch_restart import save_both

HEAD = dict(n_replicas=3, max_replicas=5, entry_bytes=16, batch_size=4,
            log_capacity=256)
HB = 2.0   # heartbeat_period


def pair(seed, **over):
    return Pair(seed, **{**HEAD, **over})


def pair9(seed, **over):
    """Learner-carrying configuration entries need 20 bytes."""
    return pair(seed, **{"entry_bytes": 24, **over})


def ps(p, n, seed):
    return payloads(n, seed, entry=p.kw["entry_bytes"])


def drain(p, items):
    seqs = p.submit(items)
    p.until_committed(seqs[-1])
    return seqs


def committed(e, r):
    return [bytes(x) for x in committed_payloads(e.state, r)]


def leaders_by_term(lines):
    """term -> the rows that logged winning it."""
    out = {}
    for ln in lines:
        m = re.match(r"\[Server(\d+):(\d+):", ln)
        if m and ln.endswith("state changed to leader"):
            out.setdefault(int(m.group(2)), set()).add(int(m.group(1)))
    return out


def one_leader_per_term(p):
    assert all(len(v) == 1 for v in leaders_by_term(p.tl).values())


# ------------------------------------------------------------ validation
def test_needs_headroom():
    p = Pair(0, n_replicas=3, entry_bytes=16, batch_size=4, log_capacity=256)
    p.until_leader()
    name, msg = p.both_raise("add_voter", 3)
    assert name == "ValueError" and "out of range" in msg


def test_ec_headroom_provisions_the_full_code():
    """RS(max_replicas, k): shard i lives on row i for good."""
    kw = dict(n_replicas=5, max_replicas=7, rs_k=3, rs_m=2, entry_bytes=24,
              batch_size=4, log_capacity=64)
    p = Pair(0, **kw)
    assert p.t.cfg.rows == 7
    assert (p.t._code.n, p.t._code.k) == (p.j._code.n, p.j._code.k) == (7, 3)


def test_one_change_at_a_time():
    p = pair(1)
    lead = p.until_leader()
    others = [r for r in range(3) if r != lead]
    p.both("partition", [[lead, 3, 4], others])
    p.both("add_voter", 3)
    p.run_for(2 * HB)
    assert p.t._pending_config is not None
    name, msg = p.both_raise("add_voter", 4)
    assert name == "RuntimeError" and "already in flight" in msg
    p.both("heal_partition")
    p.run_for(6 * HB)
    assert p.t._pending_config is None and p.t.member[3]
    s2 = p.both("add_voter", 4)
    p.until_committed(s2)
    assert int(p.t.member.sum()) == 5
    p.check_all()


def test_bounds_and_duplicates():
    p = pair(2)
    p.until_leader()
    for call, arg in (("add_voter", 7), ("add_voter", 0),
                      ("remove_server", 4), ("add_learner", 0),
                      ("promote", 3)):
        assert p.both_raise(call, arg)[0] == "ValueError"


def test_second_change_refused_before_its_ingest_tick():
    p = pair(12)
    p.until_leader()
    p.both("add_voter", 3)                 # queued, not yet ingested
    name, msg = p.both_raise("add_voter", 4)
    assert "already in flight" in msg


def test_spare_rows_never_participate():
    p = pair(3)
    p.until_leader()
    drain(p, ps(p, 6, 30))
    for r in (3, 4):
        assert p.t.roles[r] == "follower" and int(p.t.terms[r]) == 0
        assert not p.t.member[r] and int(p.t.state.last_index[r]) == 0
    p.check_all()


# -------------------------------------------------------------- lifecycle
def test_grow_3_to_5_then_shrink_to_4():
    p = pair(4)
    p.until_leader()
    drain(p, ps(p, 6, 40))
    s_add = p.both("add_voter", 3)
    mid = p.submit(ps(p, 4, 41))
    p.until_committed(s_add)
    assert p.t.member[3]
    p.until_committed(mid[-1])
    s_add2 = p.both("add_voter", 4)
    mid2 = p.submit(ps(p, 4, 42))
    p.until_committed(s_add2)
    p.until_committed(mid2[-1])
    assert int(p.t.member.sum()) == 5
    p.run_for(6 * HB)
    for r in (3, 4):
        assert int(p.t.state.commit_index[r]) >= p.t.commit_watermark - 4
    p.check_all()
    # quorum 3 of 5: two dead voters do not stall commit
    a = (p.t.leader_id + 1) % 3
    p.both("fail", 3)
    p.both("fail", a)
    post = p.submit(ps(p, 3, 43))
    p.until_committed(post[-1])
    p.both("recover", 3)
    p.both("recover", a)
    p.run_for(4 * HB)
    victim = next(r for r in range(5)
                  if p.t.member[r] and r != p.t.leader_id)
    s_rm = p.both("remove_server", victim)
    tail = p.submit(ps(p, 3, 44))
    p.until_committed(s_rm)
    p.until_committed(tail[-1])
    assert int(p.t.member.sum()) == 4 and not p.t.member[victim]
    t_before = int(p.t.terms[victim])
    p.run_for(120.0)
    assert int(p.t.terms[victim]) == t_before
    one_leader_per_term(p)
    final = committed(p.t, p.t.leader_id)
    for r in range(5):
        if p.t.member[r]:
            got = committed(p.t, r)
            assert got == final[:len(got)]
    p.until_committed(p.submit(ps(p, 1, 45))[-1])
    p.check_all()


def test_removed_leader_steps_down_after_commit():
    p = pair(5)
    lead = p.until_leader()
    drain(p, ps(p, 4, 50))
    s_rm = p.both("remove_server", lead)
    p.until_committed(s_rm)
    assert not p.t.member[lead]
    assert any(ln.endswith("step down to follower (removed)") for ln in p.tl)
    p.until_leader()
    assert p.t.leader_id != lead and p.t.member[p.t.leader_id]
    drain(p, ps(p, 3, 51))
    t0 = int(p.t.terms[lead])
    p.run_for(120.0)
    assert int(p.t.terms[lead]) == t0
    p.check_all()


def test_uncommitted_change_rolls_back_on_leadership_change():
    p = pair(6, max_replicas=4)
    lead = p.until_leader()
    drain(p, ps(p, 4, 60))
    p.run_for(4 * HB)
    others = [r for r in range(3) if r != lead]
    p.both("partition", [[lead], others + [3]])
    s_add = p.both("add_voter", 3)
    p.run_for(3 * HB)
    assert p.t._pending_config is not None and int(p.t.member.sum()) == 4
    p.run_for(120.0)
    assert p.t.leader_id in others and p.t._pending_config is None
    assert int(p.t.member.sum()) == 3 and not p.t.is_durable(s_add)
    assert any(ln.endswith("uncommitted configuration rolled back")
               for ln in p.tl)
    p.both("heal_partition")
    p.run_for(8 * HB)
    s_retry = p.both("add_voter", 3)
    p.until_committed(s_retry)
    drain(p, ps(p, 3, 61))
    p.check_all()


def test_config_entry_commits_under_the_new_majority():
    """The appending step counts under the NEW voter plane: two acks do
    not commit a 3 -> 4 add whose majority is 3."""
    p = pair(8, max_replicas=4)
    lead = p.until_leader()
    drain(p, ps(p, 3, 80))
    f1 = next(r for r in range(3) if r != lead)
    p.both("fail", f1)
    p.both("fail", 3)
    s_add = p.both("add_voter", 3)
    p.run_for(6 * HB)
    assert p.t._pending_config is not None and not p.t.is_durable(s_add)
    assert int(p.t.member.sum()) == 4
    p.both("recover", f1)
    p.until_committed(s_add)
    assert p.t._pending_config is None
    p.check_all()


def test_winner_holding_the_config_entry_keeps_it():
    p = pair(9, max_replicas=4)
    lead = p.until_leader()
    drain(p, ps(p, 3, 90))
    p.run_for(3 * HB)
    others = [r for r in range(3) if r != lead]
    p.both("fail", others[1])
    p.both("fail", 3)
    s_add = p.both("add_voter", 3)
    p.run_for(3 * HB)
    assert p.t._pending_config is not None and not p.t.is_durable(s_add)
    p.both("fail", lead)
    p.both("recover", others[1])
    p.both("recover", 3)
    p.until_leader()
    assert p.t.leader_id == others[0] and int(p.t.member.sum()) == 4
    drain(p, ps(p, 2, 91))
    assert p.t.is_durable(s_add) and p.t._pending_config is None
    p.check_all()


def test_partition_auto_isolates_spare_rows():
    p = pair(10)
    lead = p.until_leader()
    loner = (lead + 1) % 3
    rest = [r for r in range(3) if r != loner]
    p.both("partition", [[loner], rest])
    assert not p.t.connectivity[3, 0]
    p.both("heal_partition")
    p.until_committed(p.submit(ps(p, 1, 100))[-1])
    name, msg = p.both_raise("partition", [[0, 1]])
    assert "every member" in msg
    p.check_all()


def test_ring_backpressure_defers_the_entry_and_its_mask():
    p = pair(13, max_replicas=4, log_capacity=8)
    lead = p.until_leader()
    others = [r for r in range(3) if r != lead]
    for f in others:
        p.both("fail", f)
    p.submit(ps(p, 8, 130))
    p.run_for(6 * HB)
    assert p.t.in_flight_count == 8
    s_add = p.both("add_voter", 3)
    p.run_for(6 * HB)
    assert p.t._pending_config is None and int(p.t.member.sum()) == 3
    for f in others:
        p.both("recover", f)
    p.until_committed(s_add, limit=900.0)
    assert int(p.t.member.sum()) == 4
    p.check_all()


def test_removed_member_ack_does_not_count():
    p = pair(14, n_replicas=4, max_replicas=4)
    lead = p.until_leader()
    drain(p, ps(p, 3, 140))
    others = [r for r in range(4) if r != lead]
    for r in others[1:]:
        p.both("set_slow", r, True)
    s_rm = p.both("remove_server", others[0])
    p.run_for(6 * HB)
    assert p.t._pending_config is not None and not p.t.is_durable(s_rm)
    assert int(p.t.member.sum()) == 3
    for r in others[1:]:
        p.both("set_slow", r, False)
    p.until_committed(s_rm)
    assert p.t._pending_config is None
    p.check_all()


def test_truncated_config_entry_rolls_back():
    p = pair(15, max_replicas=4, log_capacity=8)
    lead = p.until_leader()
    others = [r for r in range(3) if r != lead]
    for f in others:
        p.both("fail", f)
    p.submit(ps(p, 7, 150))
    p.run_for(6 * HB)
    p.both("fail", 3)
    s_add = p.both("add_voter", 3)
    p.run_for(3 * HB)
    assert p.t._pending_config is not None and int(p.t.member.sum()) == 4
    for f in others:
        p.both("recover", f)
        p.both("set_slow", f, True)
    p.both("force_campaign", others[0])
    p.run_for(2 * HB)
    p.until_leader()
    p.run_for(6 * HB)
    assert p.t._pending_config is None and int(p.t.member.sum()) == 3
    assert not p.t.is_durable(s_add)
    assert any(ln.endswith("(entry truncated)") for ln in p.tl)
    for f in others:
        p.both("set_slow", f, False)
    p.until_committed(p.submit(ps(p, 1, 151))[-1], limit=900.0)
    p.both("recover", 3)
    s2 = p.both("add_voter", 3)
    p.until_committed(s2, limit=900.0)
    assert int(p.t.member.sum()) == 4
    p.check_all()


# --------------------------------------------------- erasure-coded (RS(6,3))
EC6 = dict(n_replicas=5, max_replicas=6, rs_k=3, rs_m=2, entry_bytes=24,
           batch_size=4, log_capacity=64)


def read_all(e):
    """The client data committed, configuration entries taken out."""
    return [bytes(x) for x in e.committed_entries(1, e.commit_watermark)
            if not bytes(x).startswith(b"RCFG")]


def test_ec_grow_5_to_6_then_shrink():
    p = Pair(31, **EC6)
    assert p.t._code.n == 6 and p.t.cfg.commit_quorum == 4
    p.until_leader()
    pre = payloads(8, 310, entry=24)
    p.until_committed(p.submit(pre)[-1])
    assert read_all(p.t) == pre
    s_add = p.both("add_voter", 5)
    mid = payloads(4, 311, entry=24)
    mseq = p.submit(mid)
    p.until_committed(s_add)
    assert int(p.t.member.sum()) == 6
    p.until_committed(mseq[-1])
    expect = pre + mid
    assert read_all(p.t) == expect
    p.run_for(8 * HB)
    assert int(p.t.state.commit_index[5]) >= p.t.commit_watermark - 4
    assert any("healed by reconstruction" in ln
               for ln in p.tl if ln.startswith("[Server5:"))
    p.check_all()
    lead = p.t.leader_id
    dead = [r for r in range(5) if r != lead][:2]
    for r in dead:
        p.both("fail", r)
    post = payloads(4, 312, entry=24)
    p.until_committed(p.submit(post)[-1], limit=900.0)
    expect += post
    assert read_all(p.t) == expect
    for r in dead:
        p.both("recover", r)
    p.run_for(8 * HB)
    victim = next(r for r in range(6)
                  if p.t.member[r] and r != p.t.leader_id)
    s_rm = p.both("remove_server", victim)
    tail = payloads(4, 313, entry=24)
    tseq = p.submit(tail)
    p.until_committed(s_rm, limit=900.0)
    p.until_committed(tseq[-1], limit=900.0)
    expect += tail
    assert int(p.t.member.sum()) == 5 and read_all(p.t) == expect
    extra = next(r for r in range(6)
                 if p.t.member[r] and r != p.t.leader_id)
    p.both("remove_server", extra)
    p.run_for(8 * HB)
    assert int(p.t.member.sum()) == 4
    last = next(r for r in range(6)
                if p.t.member[r] and r != p.t.leader_id)
    name, msg = p.both_raise("remove_server", last)
    assert "commit quorum" in msg
    one_leader_per_term(p)
    p.until_committed(p.submit(payloads(1, 314, entry=24))[-1], limit=900.0)
    p.check_all()


def test_ec_removed_rows_shards_still_serve_reads():
    p = Pair(32, **EC6)
    p.until_leader()
    pre = payloads(6, 320, entry=24)
    p.until_committed(p.submit(pre)[-1])
    victim = next(r for r in range(5)
                  if p.t.member[r] and r != p.t.leader_id)
    p.until_committed(p.both("remove_server", victim))
    members = [r for r in range(6)
               if p.t.member[r] and r != p.t.leader_id]
    for m in members[:2]:
        p.both("fail", m)
    assert read_all(p.t)[:len(pre)] == pre == read_all(p.j)[:len(pre)]
    p.check_all()


# ---------------------------------------------------------- learner phase
def test_learner_replicates_but_never_votes_or_campaigns():
    p = pair9(20)
    p.until_leader()
    drain(p, ps(p, 6, 200))
    p.until_committed(p.both("add_learner", 3))
    assert p.t.learner[3] and not p.t.member[3]
    drain(p, ps(p, 4, 201))
    p.run_for(6 * HB)
    assert int(p.t.state.commit_index[3]) >= p.t.commit_watermark - 4
    got = committed(p.t, 3)
    assert got == committed(p.t, p.t.leader_id)[:len(got)]
    p.both("force_campaign", 3)
    assert p.t.roles[3] == "follower"
    assert not p.t._voter_reach(p.t.leader_id)[3]
    assert bool(p.t._reach(p.t.leader_id)[3])
    p.check_all()


@pytest.mark.parametrize("flavor", ["learner", "voter"])
def test_quorum_neutrality_of_learners(flavor):
    """A down joiner plus a dead voter: commits go on with the joiner a
    learner, and stall with it an immediate voter."""
    p = pair9(21 if flavor == "learner" else 22)
    p.until_leader()
    drain(p, ps(p, 4, 210))
    p.both("fail", 3)
    p.until_committed(p.both("add_learner" if flavor == "learner"
                             else "add_voter", 3))
    victim = next(r for r in range(3) if r != p.t.leader_id)
    p.both("fail", victim)
    probe = p.submit(ps(p, 3, 211))
    if flavor == "learner":
        p.until_committed(probe[-1], limit=300.0)
    else:
        p.run_for(40 * HB)
        assert not p.t.is_durable(probe[-1])
    p.check_all()


def test_promote_gated_on_lag_then_succeeds():
    p = pair9(23, promote_max_lag=2)
    p.until_leader()
    drain(p, ps(p, 4, 230))
    p.both("fail", 3)
    p.until_committed(p.both("add_learner", 3))
    drain(p, ps(p, 6, 231))
    assert p.both_raise("promote", 3)[0] == "LearnerLagging"
    p.both("recover", 3)
    p.run_for(8 * HB)
    p.until_committed(p.both("promote", 3))
    assert p.t.member[3] and not p.t.learner[3]
    p.check_all()


def test_add_server_is_learner_then_promote():
    p = pair9(24)
    p.until_leader()
    drain(p, ps(p, 6, 240))
    s = p.both("add_server", 3)
    assert p.t._staged_config == [("promote", 3)]
    p.until_committed(s)
    assert p.t.learner[3] and int(p.t.member.sum()) == 3
    p.until(lambda e: e.member[3])       # run_until_voter, event by event
    assert not p.t.learner[3] and int(p.t.member.sum()) == 4
    assert any(ln.endswith("promoted from learner to voter") for ln in p.tl)
    drain(p, ps(p, 3, 241))
    p.both("run_until_voter", 3)         # already a voter: returns at once
    p.check_all()


def test_remove_learner_is_quorum_free():
    p = pair9(26)
    p.until_leader()
    p.until_committed(p.both("add_learner", 3))
    p.until_committed(p.both("remove_server", 3))
    assert not p.t.learner[3] and int(p.t.member.sum()) == 3
    assert any(ln.endswith("learner removed from configuration")
               for ln in p.tl)
    p.check_all()


def test_removed_leader_refuses_reads_and_the_client_redials():
    p = pair9(27)
    lead = p.until_leader()
    drain(p, ps(p, 4, 270))
    p.until_committed(p.both("remove_server", lead))
    assert not p.t.member[lead]
    for call in ("submit_read", "read_linearizable"):
        assert p.both_raise(call, lead)[0] == "LinearizableReadRefused"
    p.until_leader()
    assert p.t.leader_id != lead
    drain(p, ps(p, 2, 271))
    tk = p.both("submit_read")
    p.run_for(2 * HB)
    assert p.both("read_confirmed", tk) is not None
    p.check_all()


def test_pending_ticket_dies_with_the_leadership():
    p = pair9(28, prevote=False)
    lead = p.until_leader()
    drain(p, ps(p, 3, 280))
    tk = p.both("submit_read")
    p.both("force_campaign", next(r for r in range(3) if r != lead))
    assert p.t.roles[lead] != "leader"
    assert p.both_raise("read_confirmed", tk)[0] == "LinearizableReadRefused"
    p.check_all()


# ---------------------------------------------------------- wipe / replace
def test_wipe_requires_dead_and_guards_recover():
    p = pair9(29)
    p.until_leader()
    drain(p, ps(p, 4, 290))
    victim = next(r for r in range(3) if r != p.t.leader_id)
    assert "alive" in p.both_raise("wipe", victim)[1]
    p.both("fail", victim)
    p.both("wipe", victim)
    assert int(p.t.state.last_index[victim]) == 0
    assert int(p.t.terms[victim]) == 0 and p.t._wiped[victim]
    p.both("recover", victim)
    assert not p.t.alive[victim]
    p.check_all(read_back=False)


def _ladder(p, victim, cond):
    """Advance a replace ladder a heartbeat at a time, recovering the
    wiped row whenever it is refused (legal once the removal commits)."""
    end = p.t.clock.now + 900.0
    while p.t.clock.now < end:
        if not p.t.alive[victim]:
            p.both("recover", victim)
        if cond():
            return
        p.run_for(HB)
    raise AssertionError(f"ladder stalled: member={p.t.member}, "
                         f"learner={p.t.learner}, "
                         f"staged={p.t._staged_config}")


def test_replace_ladder_rejoins_from_nothing():
    p = pair9(30)
    p.until_leader()
    drain(p, ps(p, 6, 300))
    victim = next(r for r in range(3) if r != p.t.leader_id)
    p.both("fail", victim)
    p.both("wipe", victim)
    p.both("replace", victim, victim)
    assert p.t._staged_config == [("add_learner", victim),
                                  ("promote", victim)]
    _ladder(p, victim, lambda: p.t.alive[victim] and p.t.member[victim])
    p.run_for(6 * HB)
    got = committed(p.t, victim)
    assert got and got == committed(p.t, p.t.leader_id)[:len(got)]
    drain(p, ps(p, 2, 301))
    p.check_all()


def test_replace_into_a_spare_row():
    p = pair9(31)
    p.until_leader()
    drain(p, ps(p, 4, 310))
    victim = next(r for r in range(3) if r != p.t.leader_id)
    p.both("fail", victim)
    p.both("wipe", victim)
    p.both("replace", victim, 3)
    end = p.t.clock.now + 900.0
    while not p.t.member[3] and p.t.clock.now < end:
        p.run_for(4 * HB)
    assert p.t.member[3] and not p.t.member[victim]
    assert int(p.t.member.sum()) == 3
    drain(p, ps(p, 2, 311))
    p.check_all()


def test_replace_requires_a_dead_member():
    p = pair9(32)
    p.until_leader()
    assert "alive" in p.both_raise("replace", 1, 3)[1]
    assert "not a member" in p.both_raise("replace", 4, 3)[1]


def test_wiped_flag_survives_the_uncommitted_removal_window():
    p = pair9(33)
    p.until_leader()
    drain(p, ps(p, 4, 330))
    p.run_for(4 * HB)
    victim = next(r for r in range(3) if r != p.t.leader_id)
    other = next(r for r in range(3) if r not in (victim, p.t.leader_id))
    p.both("fail", victim)
    p.both("wipe", victim)
    p.both("set_slow", other, True)
    s_rm = p.both("replace", victim, victim)
    p.run_for(4 * HB)
    assert p.t._pending_config is not None and not p.t.member[victim]
    p.both("recover", victim)
    assert not p.t.alive[victim]
    p.both("set_slow", other, False)
    p.until_committed(s_rm)
    p.both("recover", victim)
    assert p.t.alive[victim]
    p.check_all()


# --------------------------------------------------- the packed voter mask
def test_packed_membership_mask_round_trip():
    member = np.array([True, True, False, False])
    learner = np.array([False, False, True, False])
    packed = tst.pack_membership(member, learner)
    np.testing.assert_array_equal(packed,
                                  jst.pack_membership(member, learner))
    assert packed.tolist() == [tst.VOTER_BIT, tst.VOTER_BIT,
                               tst.LEARNER_BIT, 0]
    np.testing.assert_array_equal(
        tst.membership_voters(torch.from_numpy(packed)).numpy(), member)
    b = torch.from_numpy(member)
    assert tst.membership_voters(b) is b
    with pytest.raises(ValueError, match="both voter and learner"):
        tst.pack_membership(np.array([True]), np.array([True]))


@pytest.mark.parametrize("repair", [True, False])
def test_packed_mask_equals_its_voter_plane_in_the_step(repair):
    """A step (the general path, or K2's plain version) and a flight
    (K3/K4's plain versions) under the packed voter|learner mask equal
    the same call under its bool voter plane: a learner row hears the
    window and its match never counts."""
    kw = dict(n_replicas=3, max_replicas=5, entry_bytes=16, batch_size=4,
              log_capacity=16)
    tr = transports(kw)[1]
    member = np.array([True, True, True, False, False])
    learner = np.array([False, False, False, True, False])
    alive = torch.tensor([True, False, True, True, False])
    slow = torch.zeros(5, dtype=torch.bool)
    data = np.random.default_rng(7).integers(0, 256, (16, 16), np.uint8)
    pay = tst.fold_batch(data, 5, device="cpu").reshape(4, 4, -1)
    outs = []
    for mask in (torch.from_numpy(member),
                 torch.from_numpy(tst.pack_membership(member, learner))):
        st = tr.init()
        st, _ = tr.request_votes(st, 0, 1, alive)
        st, info = tr.replicate(st, pay[0], 4, 0, 1, alive, slow,
                                repair=True, member=mask, term_floor=1)
        st, info2 = tr.replicate(st, pay[1], 4, 0, 1, alive, slow,
                                 repair=repair, member=mask, term_floor=1)
        st, info3 = tr.replicate_pipeline(
            st, pay[2:], torch.tensor([4, 4], dtype=torch.int32), 0, 1,
            alive, slow, member=mask, term_floor=1, allow_turnover=False)
        outs.append((st, info, info2, info3))
    (s0, *i0), (s1, *i1) = outs
    assert_states_equal(s0, s1, "packed vs bool")
    for a, b in zip(i0, i1):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(i0[1].match[3]) == 0          # the learner's ack: not counted
    assert int(s0.last_index[3]) == int(s0.last_index[0]) == 16


# ------------------------------------------------ checkpoints, across packages
@pytest.mark.parametrize("across", [False, True])
def test_learner_and_removed_voter_survive_a_restart(tmp_path, across):
    """A checkpoint with a learner (row 3) and a removed voter restores
    both engines; with ``across`` each engine restores from the other
    package's file."""
    p = pair9(25)
    lead = p.until_leader()
    drain(p, ps(p, 4, 250))
    victim = next(r for r in range(3) if r != lead)
    p.until_committed(p.both("remove_server", victim))
    p.until_committed(p.both("add_learner", 3))
    p.run_for(4 * HB)
    jp, tp = save_both(p, tmp_path)
    p2 = pair9(25, restore_from=(tp, jp) if across else (jp, tp))
    assert p2.t.learner[3] and not p2.t.member[3]
    assert not p2.t.member[victim] and int(p2.t.member.sum()) == 2
    p2.until_leader()
    drain(p2, ps(p2, 3, 251))
    p2.run_for(6 * HB)
    p2.until_committed(p2.both("promote", 3))
    assert p2.t.member[3]
    p2.check_all()


def test_membership_survives_a_checkpoint_restart(tmp_path):
    p = pair(7)
    p.until_leader()
    drain(p, ps(p, 4, 70))
    p.until_committed(p.both("add_voter", 3))
    drain(p, ps(p, 3, 71))
    p2 = pair(7, restore_from=save_both(p, tmp_path))
    assert int(p2.t.member.sum()) == 4 and p2.t.member[3]
    p2.until_leader()
    drain(p2, ps(p2, 3, 72))
    p2.both("fail", (p2.t.leader_id + 1) % 3)
    p2.until_committed(p2.submit(ps(p2, 1, 73))[-1])
    p2.check_all()
