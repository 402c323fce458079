"""The worked examples on the port's engine (``raft_tpu_torch.examples``:
``ReplicatedKV``, ``SessionedStateMachine``, ``ReplicatedCounter``,
ROADMAP A10) against the JAX package's (``raft_tpu.examples``).

The entry codec first: ``encode_op`` / ``decode_op`` / ``apply_op`` byte
for byte, ops 3-6 (the transaction plane's) ignored on apply. Then the
cases of ``tests/test_apply_kv.py`` and ``tests/test_sessions.py``, each
store built over both engines in lock step (``Pair``): every seq,
request id, value, read index and error equal, and the engines' own
checks after every event. 3 (or 5 under RS(5,3)) replicas, 24- to
64-byte entries, B = 4, C = 64 or 256.
"""

import random

import numpy as np

from raft_tpu.examples import kv as jkv_mod
from raft_tpu.examples import sessions as jsess
from raft_tpu_torch.examples import kv as tkv_mod
from raft_tpu_torch.examples import sessions as tsess
from tests.test_torch_engine import Pair
from tests.test_torch_restart import save_both

KV = dict(n_replicas=3, entry_bytes=64, batch_size=4, log_capacity=64)
SESS = dict(n_replicas=3, entry_bytes=24, batch_size=4, log_capacity=64)


def kvs(p, replay=False):
    return (jkv_mod.ReplicatedKV(p.j, replay=replay),
            tkv_mod.ReplicatedKV(p.t, replay=replay))


def counters(p, replay=False):
    return (jsess.ReplicatedCounter(p.j, replay=replay),
            tsess.ReplicatedCounter(p.t, replay=replay))


def same(objs, name, *args, **kw):
    got = [getattr(o, name)(*args, **kw) for o in objs]
    assert got[0] == got[1], (name, got)
    return got[1]


def same_raise(objs, name, *args):
    got = []
    for o in objs:
        try:
            getattr(o, name)(*args)
        except Exception as ex:   # compared below
            got.append((type(ex).__name__, str(ex)))
        else:
            got.append(None)
    assert got[0] is not None and got[0] == got[1], got
    return got[1]


# ------------------------------------------------------------- the codec
def test_entry_codec_is_byte_equal():
    rng = np.random.default_rng(3)
    for _ in range(200):
        op = int(rng.integers(0, 8))
        k = rng.integers(0, 256, int(rng.integers(0, 20)), np.uint8).tobytes()
        v = rng.integers(0, 256, int(rng.integers(0, 30)), np.uint8).tobytes()
        size = int(rng.integers(5, 64))
        got = []
        for mod in (jkv_mod, tkv_mod):
            try:
                got.append(mod.encode_op(size, op, k, v))
            except ValueError as ex:
                got.append(str(ex))
        assert got[0] == got[1]
        if isinstance(got[0], bytes):
            assert tkv_mod.decode_op(got[1]) == jkv_mod.decode_op(got[0])
            dj, dt = {b"x": b"y"}, {b"x": b"y"}
            jkv_mod.apply_op(dj, got[0])
            tkv_mod.apply_op(dt, got[1])
            assert dj == dt
            if op not in (1, 2):          # 0 pads; 3-6 are the txn plane's
                assert dt == {b"x": b"y"}


def test_session_entry_is_byte_equal():
    p = Pair(0, **SESS)
    sms = (jsess.SessionedStateMachine(p.j, lambda x: None),
           tsess.SessionedStateMachine(p.t, lambda x: None))
    for cid, req, operand in [(1, 1, 5), (7, 2**40, -3), (2**63, 9, 0)]:
        assert same(sms, "encode", cid, req, operand)
    assert "reserved" in same_raise(sms, "encode", 0, 1, 1)[1]


# ---------------------------------------------------------- ReplicatedKV
def test_set_get_delete_and_linearizable_get():
    p = Pair(1, **KV)
    kv = kvs(p)
    p.until_leader()
    same(kv, "set", b"color", b"green")
    s2 = same(kv, "set", b"shape", b"hexagon")
    p.until_committed(s2)
    assert same(kv, "get", b"color") == b"green"
    same(kv, "delete", b"color")
    s4 = same(kv, "set", b"shape", b"circle")
    assert same(kv, "get", b"shape") == b"hexagon"   # not yet committed
    p.until_committed(s4)
    assert same(kv, "get", b"color") is None
    assert same(kv, "get", b"shape") == b"circle"
    assert same(kv, "__len__") == 1
    assert same(kv, "linearizable_get", b"shape") == b"circle"
    p.check()
    assert kv[1].last_applied == kv[0].last_applied == p.t.commit_watermark
    assert "bytes" in same_raise(kv, "set", b"k" * 40, b"v" * 40)[1]
    p.check_all()


def test_linearizable_get_refused_on_a_minority():
    p = Pair(2, **KV)
    kv = kvs(p)
    old = p.until_leader()
    p.until_committed(same(kv, "set", b"owner", b"old"))
    p.both("partition", [[old], [r for r in range(3) if r != old]])
    assert same_raise(kv, "linearizable_get", b"owner")[0] == \
        "LinearizableReadRefused"
    p.check_all()


def test_kv_restart_replays_state(tmp_path):
    p = Pair(3, **KV)
    kv = kvs(p)
    p.until_leader()
    same(kv, "set", b"a", b"1")
    same(kv, "set", b"b", b"2")
    p.until_committed(same(kv, "delete", b"a"))
    p2 = Pair(3, restore_from=save_both(p, tmp_path), **KV)
    kv2 = kvs(p2, replay=True)
    assert same(kv2, "get", b"a") is None
    assert same(kv2, "get", b"b") == b"2"
    assert kv2[1].last_applied == p2.t.commit_watermark
    p2.until_leader()
    p2.until_committed(same(kv2, "set", b"c", b"3"))
    assert same(kv2, "get", b"c") == b"3"
    p2.check_all()


def test_kv_over_an_ec_cluster():
    p = Pair(4, n_replicas=5, rs_k=3, rs_m=2, entry_bytes=60, batch_size=4,
             log_capacity=64)
    kv = kvs(p)
    p.until_leader()
    seqs = [same(kv, "set", f"k{i}".encode(), f"v{i}".encode())
            for i in range(12)]
    p.until_committed(seqs[-1])
    for i in range(12):
        assert same(kv, "get", f"k{i}".encode()) == f"v{i}".encode()
    assert same(kv, "linearizable_get", b"k3") == b"v3"
    p.check_all()


def test_apply_gap_backfills_and_resumes(monkeypatch):
    """A transient archive gap pauses the apply cursor; the next drain
    backfills it and the stores catch up in order."""
    p = Pair(5, **KV)
    kv = kvs(p)
    p.until_leader()
    for e in (p.j, p.t):
        orig = e._archive_committed
        left = [2]

        def flaky(r, lo, hi, _orig=orig, _left=left):
            if _left[0] > 0:
                _left[0] -= 1
                return
            _orig(r, lo, hi)

        monkeypatch.setattr(e, "_archive_committed", flaky)
    s1 = [same(kv, "set", bytes([65 + i]), b"1") for i in range(3)]
    p.until_committed(s1[-1])
    assert kv[1].last_applied == kv[0].last_applied == 0
    s2 = [same(kv, "set", bytes([70 + i]), b"2") for i in range(3)]
    p.until_committed(s2[-1])
    assert kv[1].last_applied == kv[0].last_applied == 6
    assert same(kv, "get", b"A") == b"1"


# ----------------------------------------------------- ReplicatedCounter
def test_increments_apply_exactly_once():
    p = Pair(6, **SESS)
    ctr = counters(p)
    p.until_leader()
    seqs = [same(ctr, "add", client_id=7, amount=5)[0] for _ in range(4)]
    p.until_committed(seqs[-1])
    assert ctr[1].value == ctr[0].value == 20
    assert ctr[1].duplicates_dropped == 0


def test_committed_retry_is_deduplicated():
    p = Pair(7, **SESS)
    ctr = counters(p)
    p.until_leader()
    s1, req = same(ctr, "add", client_id=3, amount=10)
    s2, _ = same(ctr, "add", client_id=3, amount=10, request_id=req)
    p.until_committed(s2)
    assert p.t.is_durable(s1) and p.t.is_durable(s2)
    assert ctr[1].value == ctr[0].value == 10
    assert ctr[1].duplicates_dropped == ctr[0].duplicates_dropped == 1
    same(ctr, "add", client_id=1, amount=2, request_id=1)
    s3, _ = same(ctr, "add", client_id=2, amount=3, request_id=1)
    p.until_committed(s3)
    assert ctr[1].value == ctr[0].value == 15
    p.check_all()


def test_retry_after_a_leader_crash_applies_once():
    p = Pair(8, **SESS)
    ctr = counters(p)
    lead = p.until_leader()
    s1, req = same(ctr, "add", client_id=9, amount=100)
    p.until_committed(s1)
    p.both("fail", lead)
    p.until_leader()
    s2, _ = same(ctr, "add", client_id=9, amount=100, request_id=req)
    p.until_committed(s2)
    assert ctr[1].value == ctr[0].value == 100
    assert ctr[1].duplicates_dropped == 1
    p.check_all()


def test_dedup_table_survives_a_restart(tmp_path):
    p = Pair(9, **SESS)
    ctr = counters(p)
    p.until_leader()
    s1, req = same(ctr, "add", client_id=4, amount=7)
    s2, _ = same(ctr, "add", client_id=4, amount=7, request_id=req)
    p.until_committed(s2)
    p2 = Pair(9, restore_from=save_both(p, tmp_path), **SESS)
    ctr2 = counters(p2, replay=True)
    assert ctr2[1].value == ctr2[0].value == 7
    assert ctr2[1].duplicates_dropped == 1
    p2.until_leader()
    s3, _ = same(ctr2, "add", client_id=4, amount=7, request_id=req)
    p2.until_committed(s3)
    assert ctr2[1].value == 7
    s4, req4 = same(ctr2, "add", client_id=4, amount=5)
    assert req4 > req
    p2.until_committed(s4)
    assert ctr2[1].value == ctr2[0].value == 12
    assert same((ctr2[0]._sm, ctr2[1]._sm), "last_request", 4) == req4
    p2.check_all()


def test_counter_under_churn_with_blind_retries(tmp_path):
    """Random crashes and elections while clients blind-retry: both
    stores count every (client, request) at most once, bounded by the
    durable and submitted sums, and equal a fresh replay of the log."""
    rng = random.Random(77)
    p = Pair(10, **{**SESS, "log_capacity": 256})
    ctr = counters(p)
    p.until_leader()
    amount, seqs = {}, {}
    for _ in range(8):
        for _ in range(rng.randrange(1, 4)):
            client, amt = rng.randrange(1, 4), rng.randrange(1, 10)
            seq, req = same(ctr, "add", client, amt)
            amount[(client, req)] = amt
            seqs.setdefault((client, req), []).append(seq)
            if rng.random() < 0.5:
                s2, _ = same(ctr, "add", client, amt, request_id=req)
                seqs[(client, req)].append(s2)
        action = rng.choice(["kill_leader", "campaign", "none"])
        if action == "kill_leader" and p.t.leader_id is not None:
            victim = p.t.leader_id
            p.both("fail", victim)
            p.until_leader()
            p.both("recover", victim)
        elif action == "campaign":
            p.both("force_campaign", rng.randrange(3))
        p.run_for(60.0)
    s, _ = same(ctr, "add", client_id=9, amount=0)
    p.until_committed(s)
    p.run_for(8.0)
    durable = sum(a for k, a in amount.items()
                  if any(p.t.is_durable(q) for q in seqs[k]))
    assert durable <= ctr[1].value == ctr[0].value <= sum(amount.values())
    p2 = Pair(10, restore_from=save_both(p, tmp_path),
              **{**SESS, "log_capacity": 256})
    ctr2 = counters(p2, replay=True)
    assert ctr2[1].value == ctr2[0].value == ctr[1].value
    p.check_all()


def test_retry_does_not_regress_the_id_allocator():
    p = Pair(11, **SESS)
    ctr = counters(p)
    p.until_leader()
    _, r1 = same(ctr, "add", client_id=5, amount=1)
    _, r2 = same(ctr, "add", client_id=5, amount=2)
    same(ctr, "add", client_id=5, amount=1, request_id=r1)
    s4, r4 = same(ctr, "add", client_id=5, amount=4)
    assert r4 > r2
    p.until_committed(s4)
    assert ctr[1].value == ctr[0].value == 7
