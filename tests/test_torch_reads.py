"""Linearizable reads and leader leases through the port's engine
(ROADMAP A9d) against the JAX engine.

The cases of ``tests/test_read_api.py`` (``TestLinearizableReads``,
``TestBatchedReadIndex``, ``TestTicketEvictionAndBuckets``) and
``tests/test_read_scale.py`` (``TestEngineLease``), each run by both
engines in lock step (``Pair``: after every event the rng, the heap, the
nodelog lines, the ticket table and its (row, term) buckets, the
eviction floor, the per-row commit views, the lease grants and the read
classes are equal; every returned read index equal), plus the admission
TTL sweep, the lease clock's skew, a learner's acks confirming nothing,
and the vote-log fence of ``read_linearizable`` (the confirming round's
term adoptions reach both vote logs, byte-identical, before the read
returns). Rounds are counted on both transports. 3 (or 5) replicas, 12-
to 24-byte entries, B = 4, C = 64 or 128.
"""

import numpy as np
import pytest

from raft_tpu.raft import RaftEngine as JEngine
from raft_tpu_torch.raft import RaftEngine as TEngine
from tests.test_torch_engine import Pair, payloads
from tests.test_torch_restart import save_both

R3 = dict(n_replicas=3, entry_bytes=12, batch_size=4, log_capacity=64)
LEASE = dict(n_replicas=3, entry_bytes=16, batch_size=4, log_capacity=64,
             prevote=True, read_lease=True)
HB = 2.0


def commit_some(p, n=4, seed=0):
    seqs = p.submit(payloads(n, seed, entry=p.kw["entry_bytes"]))
    p.until_committed(seqs[-1])
    return seqs


@pytest.fixture
def rounds(monkeypatch):
    """rounds(p) counts ``replicate`` calls on both engines' transports
    (the patch is undone after the test: transports are shared)."""

    def attach(p):
        calls = [0, 0]
        for i, e in enumerate((p.j, p.t)):
            orig = e.t.replicate

            def counting(*a, _i=i, _orig=orig, **k):
                calls[_i] += 1
                return _orig(*a, **k)

            monkeypatch.setattr(e.t, "replicate", counting)
        return calls

    return attach


# ------------------------------------------------------ ReadIndex (§6.4)
def test_read_index_confirms_and_serves(rounds):
    p = Pair(21, **R3)
    p.until_leader()
    commit_some(p, 3, 21)
    calls = rounds(p)
    idx = p.both("read_linearizable")
    assert idx == p.t.commit_watermark >= 1 and calls == [1, 1]
    assert p.t.read_class_counts == {"read_index": 1}
    p.check_all()


def test_refused_without_leader():
    p = Pair(22, **R3)
    name, msg = p.both_raise("read_linearizable")
    assert name == "LinearizableReadRefused" and "not a live" in msg
    assert p.both_raise("submit_read")[0] == "LinearizableReadRefused"


def test_minority_leader_cannot_serve_while_majority_commits():
    p = Pair(23, **{**R3, "log_capacity": 128})
    old = p.until_leader()
    commit_some(p, 2, 23)
    pre_wm = p.t.commit_watermark
    others = [r for r in range(3) if r != old]
    p.both("partition", [[old], others])
    assert "quorum" in p.both_raise("read_linearizable", old)[1]
    for _ in range(60):
        if p.t.leader_id in others:
            break
        p.run_for(5.0)
    new = p.t.leader_id
    assert new in others and p.t.roles[old] == "leader"
    p.until_committed(p.submit(payloads(1, 24, entry=12))[-1], limit=900.0)
    assert p.both_raise("read_linearizable", old)[0] == \
        "LinearizableReadRefused"
    idx = p.both("read_linearizable", new)
    assert idx >= pre_wm + 1
    p.both("heal_partition")
    p.run_for(6 * HB)
    assert p.t.roles[old] != "leader"
    assert p.both("read_linearizable") >= idx
    p.check_all()


# --------------------------------------------------------- batched reads
def test_reads_ride_write_rounds_for_free(rounds):
    p = Pair(31, **R3)
    p.until_leader()
    commit_some(p, 4, 4)
    wm0 = p.t.commit_watermark
    calls = rounds(p)
    tickets = [p.both("submit_read") for _ in range(16)]
    assert calls == [0, 0]
    assert p.both("read_confirmed", tickets[0]) is None
    seqs = p.submit(payloads(4, 5, entry=12))
    p.until_committed(seqs[-1])
    writes = list(calls)
    got = [p.both("read_confirmed", t) for t in tickets[1:]]
    assert all(g is not None and g >= wm0 for g in got)
    assert calls == writes
    p.check_all()


def test_idle_cluster_one_round_serves_all(rounds):
    p = Pair(32, **R3)
    p.until_leader()
    commit_some(p, 4, 6)
    tickets = [p.both("submit_read") for _ in range(8)]
    calls = rounds(p)
    idx = p.both("read_linearizable")
    assert calls == [1, 1]
    got = [p.both("read_confirmed", t) for t in tickets]
    assert all(g is not None and g <= idx for g in got)
    assert not p.t._reads and not p.t._read_buckets
    p.check_all()


def test_leadership_loss_refuses_queued_reads():
    p = Pair(33, **R3)
    lead = p.until_leader()
    commit_some(p, 4, 7)
    tickets = [p.both("submit_read") for _ in range(4)]
    p.both("fail", lead)
    p.until_leader()
    for t in tickets:
        assert p.both_raise("read_confirmed", t)[0] == \
            "LinearizableReadRefused"
    p.check_all()


def test_minority_leader_cannot_queue_or_confirm():
    p = Pair(34, **{**R3, "n_replicas": 5})
    lead = p.until_leader()
    commit_some(p, 4, 8)
    pre = p.both("submit_read")
    others = [q for q in range(5) if q != lead]
    p.both("partition", [[lead, others[0]], others[1:]])
    p.run_for(6 * HB)
    if pre in p.t._reads and p.t.roles[lead] == "leader":
        assert p.both("read_confirmed", pre) is None
    else:
        assert p.both_raise("read_confirmed", pre)[0] == \
            "LinearizableReadRefused"
    assert p.both_raise("submit_read", lead)[0] == "LinearizableReadRefused"
    p.check_all()


# ---------------------------------------------- ticket eviction, buckets
def _cap(monkeypatch, n):
    for cls in (JEngine, TEngine):
        monkeypatch.setattr(cls, "READ_TICKET_CAP", n)


def test_evicted_ticket_raises_ticket_evicted(monkeypatch):
    p = Pair(41, **R3)
    p.until_leader()
    commit_some(p, 4, 9)
    _cap(monkeypatch, 16)
    first = p.both("submit_read")
    for _ in range(16 + 4):
        p.both("submit_read")
    assert first < p.t._read_evict_floor
    assert p.both_raise("read_confirmed", first)[0] == "TicketEvicted"
    assert p.both_raise("read_confirmed", 10 ** 9)[0] == "KeyError"
    from raft_tpu_torch.raft.engine import (
        LinearizableReadRefused,
        TicketEvicted,
    )
    assert issubclass(TicketEvicted, LinearizableReadRefused)


def test_confirmation_touches_only_its_bucket():
    p = Pair(42, **R3)
    lead = p.until_leader()
    commit_some(p, 4, 10)
    tickets = [p.both("submit_read") for _ in range(8)]
    term = int(p.t.lead_terms[lead])
    assert p.t._read_buckets == {(lead, term): set(tickets)}
    p.until_committed(p.submit(payloads(1, 11, entry=12))[-1])
    assert (lead, term) not in p.t._read_buckets
    assert all(p.both("read_confirmed", t) is not None for t in tickets)
    assert not p.t._reads and not p.t._read_buckets


def test_eviction_keeps_buckets_consistent(monkeypatch):
    p = Pair(43, **R3)
    lead = p.until_leader()
    commit_some(p, 4, 12)
    _cap(monkeypatch, 8)
    for _ in range(3 * 8):
        p.both("submit_read")
    assert len(p.t._reads) == 8
    assert p.t._read_buckets[(lead, int(p.t.lead_terms[lead]))] == \
        set(p.t._reads)


def test_admission_ttl_sweep_and_read_bound():
    """With ``admission_max_reads`` the bound refuses arrivals past it
    (``Overloaded``), and tickets idle past the TTL are evicted at the
    next arrival (they poll as ``TicketEvicted``)."""
    p = Pair(44, **{**R3, "admission_max_reads": 4})
    p.until_leader()
    commit_some(p, 4, 13)
    old = [p.both("submit_read") for _ in range(4)]
    name, msg = p.both_raise("submit_read")
    assert name == "Overloaded"
    ttl = TEngine.READ_TICKET_TTL_FACTOR * p.t.cfg.follower_timeout[1]
    p.run_for(ttl + 1.0)
    fresh = p.both("submit_read")
    assert p.t._read_evict_floor == old[-1] + 1
    for t in old:
        assert p.both_raise("read_confirmed", t)[0] == "TicketEvicted"
    p.run_for(2 * HB)
    assert p.both("read_confirmed", fresh) is not None
    assert p.t.admission.report().read_classes == \
        p.j.admission.report().read_classes == {"read_index": 1}
    p.check_all()


# ---------------------------------------------------------------- leases
def test_lease_read_zero_rounds(rounds):
    p = Pair(51, **LEASE)
    p.until_leader()
    commit_some(p, 6)
    calls = rounds(p)
    idx = p.both("read_linearizable")
    assert calls == [0, 0] and idx == p.t.commit_watermark
    tk = p.both("submit_read")
    assert p.both("read_ticket_class", tk) == "lease"
    assert p.both("read_confirmed", tk) == idx
    assert p.both("read_ticket_class", tk) is None
    assert calls == [0, 0] and p.t.read_class_counts["lease"] >= 2
    p.check_all()


def test_without_a_lease_reads_pay_a_round(rounds):
    p = Pair(51, **{**LEASE, "read_lease": False})
    p.until_leader()
    commit_some(p, 6)
    calls = rounds(p)
    p.both("read_linearizable")
    assert calls == [1, 1]
    assert p.t.read_class_counts == {"read_index": 1}
    assert p.both("lease_read_index", p.t.leader_id) is None


def test_fresh_leader_gate_needs_a_current_term_commit(rounds):
    p = Pair(52, **LEASE)
    lead = p.until_leader()
    commit_some(p, 6)
    p.both("fail", lead)
    p.until_leader()
    p.both("recover", lead)
    p.run_for(4 * HB)
    calls = rounds(p)
    p.both("read_linearizable")
    assert calls == [1, 1]
    commit_some(p, 2, 9)
    calls[:] = [0, 0]
    p.both("read_linearizable")
    assert calls == [0, 0]
    p.check_all()


def test_partitioned_leader_lease_expires_then_refuses():
    p = Pair(53, **LEASE)
    lead = p.until_leader()
    commit_some(p, 6)
    others = [r for r in range(3) if r != lead]
    p.both("partition", [[lead], others])
    assert p.both("read_linearizable", lead) == p.t.commit_watermark
    p.run_for(p.t.cfg.follower_timeout[0] + 1.0)
    assert p.both_raise("read_linearizable", lead)[0] == \
        "LinearizableReadRefused"
    p.check_all()


def test_lease_clock_skew():
    """A slow lease clock (rate 1/drift) holds the lease longer on the
    true clock, a fast one (rate drift) expires it sooner: both engines
    serve and refuse at the same instants."""
    p = Pair(54, **LEASE)
    lead = p.until_leader()
    commit_some(p, 6)
    p.both("set_lease_rate", lead, 2.0)
    others = [r for r in range(3) if r != lead]
    p.both("partition", [[lead], others])
    served = []
    for _ in range(6):
        p.run_for(0.5)
        served.append(p.t.lease_read_index(lead) is not None)
        assert p.both("lease_read_index", lead) == \
            p.j.lease_read_index(lead)
    assert served[0] and not served[-1]
    p.both("set_lease_rate", lead, 1.0)
    p.check_all()


def test_restart_drops_the_lease(tmp_path):
    p = Pair(55, **LEASE)
    p.until_leader()
    commit_some(p, 6)
    assert p.both("lease_read_index", p.t.leader_id) is not None
    p2 = Pair(55, restore_from=save_both(p, tmp_path), **LEASE)
    for r in range(3):
        assert p2.both("lease_read_index", r) is None
    p2.until_leader()
    commit_some(p2, 2, 56)
    assert p2.both("read_linearizable") == p2.t.commit_watermark


# ------------------------------------------------------ the vote-log fence
def test_read_round_fences_its_term_adoptions(tmp_path):
    """A follower that missed an election rejoins; the first thing the
    new leader runs is a ReadIndex round, in which that follower adopts
    the new term: the adoption is in both vote logs (byte-identical)
    when ``read_linearizable`` returns."""
    logs = (str(tmp_path / "j.vlog"), str(tmp_path / "t.vlog"))
    p = Pair(61, vote_logs=logs, **{**R3, "n_replicas": 5})
    lead = p.until_leader()
    commit_some(p, 4, 61)
    lag = (lead + 1) % 5
    p.both("fail", lag)
    p.both("fail", lead)
    p.until_leader()
    assert int(p.t.terms[lag]) < p.t.leader_term
    p.both("recover", lag)
    before = open(logs[1], "rb").read()
    p.both("read_linearizable")
    after = open(logs[1], "rb").read()
    assert after != before and after.startswith(before)
    assert int(p.t.terms[lag]) == p.t.leader_term
    assert int(p.t._persisted_terms[lag]) == p.t.leader_term
    np.testing.assert_array_equal(p.t._persisted_terms, p.j._persisted_terms)
    p.check_all()


def test_a_learners_ack_confirms_nothing():
    """Leader + learner reachable, both other voters dead: no round
    confirms a queued read, and a new read is refused (1 of 3 voters),
    although the learner hears every round."""
    p = Pair(62, **{**R3, "max_replicas": 4, "entry_bytes": 24})
    lead = p.until_leader()
    commit_some(p, 4, 62)
    p.until_committed(p.both("add_learner", 3))
    p.run_for(4 * HB)
    tk = p.both("submit_read")
    for r in range(3):
        if r != lead:
            p.both("fail", r)
    p.run_for(4 * HB)
    assert p.t.roles[lead] == "leader" and p.t.learner[3]
    assert p.both("read_confirmed", tk) is None
    name, msg = p.both_raise("read_linearizable")
    assert "quorum unreachable (1 of 3 members)" in msg
    assert p.both("lease_read_index", lead) is None
    p.check_all()
