"""The port's transaction plane (``raft_tpu_torch.txn``) against the JAX
package's on the CPU: ``tests/test_txn.py``'s ``TestOps``,
``TestCoordinator`` and ``TestSubmitManyPin`` through both packages, at
its sizes (G = 4, 32-byte entries, B = 4, C = 256). Exact: the encoded
entries byte for byte (each package's decoder reads the other's), and
after every scenario the lock tables, staged intents, decision maps,
applied maps and cursors, every group's committed log bytes, the
handles' states, statuses and reasons, the refusals raised, the virtual
clock, the metric series, the SLO digests and the ``txn`` status section.
Each case also keeps the JAX test's own asserts on the port's run."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

def pkg(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    multi = m("multi.engine")

    def engine(cfg, G):
        if name == "raft_tpu_torch":
            return multi.MultiEngine(cfg, G, device="cpu")
        return multi.MultiEngine(cfg, G)

    txn = m("txn")
    return SimpleNamespace(
        name=name, RaftConfig=m("config").RaftConfig, engine=engine,
        Router=m("multi.router").Router, T=m("txn.ops"),
        TxnShardedKV=txn.TxnShardedKV, TxnCoordinator=txn.TxnCoordinator,
        TxnItem=txn.TxnItem, LockConflict=txn.LockConflict,
        Overloaded=m("admission").Overloaded, kv=m("examples.kv"),
        MetricsRegistry=m("obs.registry").MetricsRegistry,
        StatusBoard=m("obs.serve").StatusBoard,
        SLObjective=m("obs.slo").SLObjective,
        SloTracker=m("obs.slo").SloTracker,
    )


JX, PT = pkg("raft_tpu"), pkg("raft_tpu_torch")


def _cfg(ns, **kw):
    base = dict(n_replicas=3, entry_bytes=32, batch_size=4,
                log_capacity=256, transport="single", seed=0)
    base.update(kw)
    return ns.RaftConfig(**base)


def _stack(ns, G=4, ttl_s=None, coord_broken=None, **cfg_kw):
    eng = ns.engine(_cfg(ns, **cfg_kw), G)
    router = ns.Router(eng, drive=False)
    skv = ns.TxnShardedKV(eng, router)
    eng.seed_leaders()
    coord = ns.TxnCoordinator(skv, decision_group=0, ttl_s=ttl_s,
                              broken=coord_broken)
    return eng, router, skv, coord


def _distinct_group_keys(router, n=2):
    seen, out, i = set(), [], 0
    while len(out) < n:
        k = b"t%d" % i
        g = router.group_of(k)
        if g not in seen:
            seen.add(g)
            out.append(k)
        i += 1
    return out


def _settle(eng, coord, *handles, limit=400):
    hb = eng.cfg.heartbeat_period
    for _ in range(limit):
        eng.run_for(2 * hb)
        coord.poll_all()
        if all(coord.poll(h) for h in handles):
            return
    raise AssertionError(
        "handles did not settle: "
        + str([(h.txn_id, h.state, h.status) for h in handles]))


def _drain_resolves(eng, coord, limit=400):
    hb = eng.cfg.heartbeat_period
    for _ in range(limit):
        if not coord._resolves:
            return
        eng.run_for(2 * hb)
        coord.poll_all()
    raise AssertionError("resolver handles did not drain")


def _plain(v):
    if isinstance(v, dict):
        return {_plain(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _handle(h):
    return _plain({s: getattr(h, s) for s in type(h).__slots__
                   if s != "items"})


def _refusal(ex):
    return (type(ex).__name__, ex.reason, ex.retry_after_s,
            getattr(ex, "key", None), getattr(ex, "holder", None),
            getattr(ex, "group", None), str(ex))


def _state(eng, skv, coord, *handles):
    """Everything the scenario leaves behind, as plain values."""
    logs = []
    for g in range(eng.G):
        wm = int(eng.commit_watermark[g])
        logs.append((wm, [(i, eng._archive[g][i])
                          for i in sorted(eng._archive[g]) if i <= wm]))
    metrics = {}
    if eng.metrics is not None:
        for name in ("raft_txn_total", "raft_txn_locks_total"):
            m = eng.metrics.get(name)
            metrics[name] = None if m is None else sorted(m.series())
    slo = None
    if eng.slo is not None:
        slo = {k: (d.n, d.total, d.max, d.counts.tolist())
               for k, d in sorted(eng.slo.digests.items(),
                                  key=lambda kv: repr(kv[0]))}
    board = (None if eng.status_board is None
             else eng.status_board.compose().get("txn"))
    return _plain({
        "locks": [{k: (lk.txn_id, lk.deadline, lk.flags, lk.value)
                   for k, lk in t.items()} for t in skv.locks],
        "data": [dict(d) for d in skv._data],
        "decisions": dict(skv._decisions),
        "last_applied": list(skv.last_applied),
        "lock_stats": skv.lock_stats(),
        "logs": logs,
        "applied_index": list(eng.applied_index),
        "status": coord.status_snapshot(),
        "clock": eng.clock.now,
        "handles": [_handle(h) for h in handles],
        "metrics": metrics, "slo": slo, "board": board,
    })


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], f"{k}: {got[k]!r} != {want[k]!r}"


def both(scenario):
    """Run ``scenario(ns)`` through both packages, hold the results equal
    field by field, and return the port's."""
    want, got = scenario(JX), scenario(PT)
    _same(got, want)
    return got


# --------------------------------------------------------- entry encodings
def _encodings(ns):
    T = ns.T
    return [
        T.encode_lock(32, 7, b"k1", b"v9", 12.5),
        T.encode_lock(32, 8, b"k2", None, 3.0, delete=True),
        T.encode_lock(32, 9, b"k3", None, 1.0),
        T.encode_lock(32, 0xFFFFFFFF, b"k" * 8, b"v" * 8, 1e300 / 7.0),
        T.encode_release(32, True, 5),
        T.encode_release(32, False, 6),
        T.encode_decision(32, 11, True, 0b1010),
        T.encode_decision(32, 12, False, 0b1),
        T.encode_decision(64, 13, True, 0xFFFFFFFF),
    ]


class TestOps:
    def test_encodings_equal_jax_byte_for_byte(self):
        got, want = _encodings(PT), _encodings(JX)
        assert got == want
        assert (PT.T.OP_LOCK, PT.T.OP_COMMIT, PT.T.OP_ABORT,
                PT.T.OP_DECIDE) == (JX.T.OP_LOCK, JX.T.OP_COMMIT,
                                    JX.T.OP_ABORT, JX.T.OP_DECIDE) == (
                                        3, 4, 5, 6)
        assert (PT.T.FLAG_WRITE, PT.T.FLAG_DELETE) == (
            JX.T.FLAG_WRITE, JX.T.FLAG_DELETE)
        # each package's decoders read the other's entries
        for enc, dec in ((got, JX.T), (want, PT.T)):
            for e in enc[:4]:
                assert tuple(dec.decode_lock(e)) == tuple(
                    PT.T.decode_lock(e))
            assert [dec.decode_release(e) for e in enc[4:6]] == [
                (True, 5), (False, 6)]
            assert [tuple(dec.decode_decision(e)) for e in enc[6:]] == [
                (11, True, 0b1010), (12, False, 1),
                (13, True, 0xFFFFFFFF)]

    def test_lock_roundtrip_write_delete_readonly(self):
        T = PT.T
        rec = T.decode_lock(T.encode_lock(32, 7, b"k1", b"v9", 12.5))
        assert rec == (7, 12.5, T.FLAG_WRITE, b"k1", b"v9")
        rec = T.decode_lock(
            T.encode_lock(32, 8, b"k2", None, 3.0, delete=True))
        assert rec.flags == T.FLAG_WRITE | T.FLAG_DELETE
        assert (rec.txn_id, rec.key, rec.value) == (8, b"k2", b"")
        rec = T.decode_lock(T.encode_lock(32, 9, b"k3", None, 1.0))
        assert rec.flags == 0 and rec.value == b""

    def test_txn_ops_invisible_to_plain_kv(self):
        for ns in (JX, PT):
            data = {b"x": b"1"}
            for payload in _encodings(PT)[:3] + _encodings(PT)[4:8]:
                assert ns.kv.decode_op(payload) == (0, b"", None)
                ns.kv.apply_op(data, payload)
            assert data == {b"x": b"1"}

    @pytest.mark.parametrize("args", [
        (32, 1, b"k" * 20, b"v" * 20, 1.0),
        (32, 1, b"k" * 300, None, 1.0),
        (512, 1, b"k", b"v" * 300, 1.0)], ids=["entry", "key", "value"])
    def test_oversized_lock_refused_as_jax(self, args):
        msgs = []
        for ns in (JX, PT):
            with pytest.raises(ValueError) as ei:
                ns.T.encode_lock(*args)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]

    def test_lock_conflict_is_overloaded_as_jax(self):
        got = [_refusal(ns.LockConflict(b"k", 3, 0.25, group=2))
               for ns in (JX, PT)]
        assert got[0] == got[1]
        assert issubclass(PT.LockConflict, PT.Overloaded)


# --------------------------------------------------- store and coordinator
def _commit_atomicity(ns):
    eng, router, skv, coord = _stack(ns)
    ka, kb = _distinct_group_keys(router)
    h = coord.run([ns.TxnItem(ka, b"1"), ns.TxnItem(kb, b"2")])
    return _state(eng, skv, coord, h)


def _abort_applies_nothing(ns):
    eng, router, skv, coord = _stack(ns)
    ka, kb = _distinct_group_keys(router)
    h = coord.run([ns.TxnItem(ka, b"1", expect=None),
                   ns.TxnItem(kb, b"2", expect=b"nope")])
    return _state(eng, skv, coord, h)


def _racing(ns):
    eng, router, skv, coord = _stack(ns)
    (k,) = _distinct_group_keys(router, 1)
    h1 = coord.begin([ns.TxnItem(k, b"first")])
    h2 = coord.begin([ns.TxnItem(k, b"second")])
    _settle(eng, coord, h1, h2)
    return _state(eng, skv, coord, h1, h2)


def _live_lock(ns):
    eng, router, skv, coord = _stack(ns)
    (k,) = _distinct_group_keys(router, 1)
    h = coord.begin([ns.TxnItem(k, b"x")])
    hb = eng.cfg.heartbeat_period
    for _ in range(200):
        if skv.lock_of(k)[1] is not None:
            break
        eng.run_for(2 * hb)
    locked = skv.lock_of(k)[1] is not None
    refusals = []
    with pytest.raises(ns.LockConflict) as ei:
        skv.set(k, b"plain")
    refusals.append(_refusal(ei.value))
    with pytest.raises(ns.LockConflict) as ei:
        coord.begin([ns.TxnItem(k, b"other")])
    refusals.append(_refusal(ei.value))
    _settle(eng, coord, h)
    after = _plain(skv.set(k, b"plain"))
    out = _state(eng, skv, coord, h)
    out.update(locked=locked, refusals=refusals, after=after)
    return out


def _crash_restore(ns):
    eng, router, skv, coord = _stack(ns)
    ka, kb = _distinct_group_keys(router)
    h = coord.run([ns.TxnItem(ka, b"1"), ns.TxnItem(kb, b"2")])
    c2 = ns.TxnCoordinator(skv, decision_group=0, coord_id=7)
    r = c2.resolve_txn(h.txn_id)
    _settle(eng, c2, r)
    out = _state(eng, skv, coord, h, r)
    out["c2"] = _plain(c2.status_snapshot())
    return out


def _ttl_expiry(ns):
    eng, router, skv, coord = _stack(ns, ttl_s=None)
    coord.ttl_s = 10.0 * eng.cfg.heartbeat_period
    (k,) = _distinct_group_keys(router, 1)
    h = coord.begin([ns.TxnItem(k, b"ghost")])
    hb = eng.cfg.heartbeat_period
    for _ in range(200):
        if skv.lock_of(k)[1] is not None:
            break
        eng.run_for(2 * hb)
    eng.run_for(12.0 * hb)
    with pytest.raises(ns.LockConflict) as ei:
        coord.begin([ns.TxnItem(k, b"new")])
    refusal = _refusal(ei.value)
    resolved = coord.ttl_resolved
    _drain_resolves(eng, coord)
    decided = _plain(skv.decision(h.txn_id))
    h2 = coord.run([ns.TxnItem(k, b"new")])
    out = _state(eng, skv, coord, h, h2)
    out.update(refusal=refusal, resolved=resolved, decided=decided)
    return out


def _observability(ns):
    eng, router, skv, coord = _stack(ns)
    eng.metrics = ns.MetricsRegistry()
    eng.slo = ns.SloTracker(objectives=(
        ns.SLObjective("txn_commit_fast", "txn_commit",
                       threshold_s=100.0 * eng.cfg.heartbeat_period),))
    eng.status_board = ns.StatusBoard()
    ka, kb = _distinct_group_keys(router)
    h1 = coord.run([ns.TxnItem(ka, b"1"), ns.TxnItem(kb, b"2")])
    h2 = coord.run([ns.TxnItem(ka, b"9", expect=b"wrong")])
    return _state(eng, skv, coord, h1, h2)


class TestCoordinator:
    def test_commit_atomicity_across_groups(self):
        s = both(_commit_atomicity)
        (h,) = s["handles"]
        assert h["status"] == "committed" and h["final"] is True
        assert sorted(v for d in s["data"] for v in d.values()) == [
            b"1", b"2"]
        assert s["lock_stats"]["held"] == 0
        assert s["decisions"][h["txn_id"]][0] is True
        assert len(h["groups"]) == 2

    def test_abort_applies_nothing(self):
        s = both(_abort_applies_nothing)
        (h,) = s["handles"]
        assert h["status"] == "aborted" and h["reason"] == "expect_failed"
        assert all(not d for d in s["data"])
        assert s["lock_stats"]["held"] == 0
        assert s["decisions"][h["txn_id"]][0] is False

    def test_racing_prewrites_first_lock_wins(self):
        s = both(_racing)
        h1, h2 = s["handles"]
        assert h1["status"] == "committed"
        assert h2["status"] == "aborted" and h2["reason"] == "lock_lost"
        assert [v for d in s["data"] for v in d.values()] == [b"first"]
        assert s["lock_stats"]["lost"] >= 1

    def test_live_lock_refuses_writers_and_txns(self):
        s = both(_live_lock)
        assert s["locked"]
        assert all(r[0] == "LockConflict" and r[2] > 0
                   for r in s["refusals"])
        assert s["handles"][0]["status"] == "committed"

    def test_crash_restore_replays_same_verdict(self):
        s = both(_crash_restore)
        h, r = s["handles"]
        assert h["status"] == "committed"
        assert r["status"] == "committed" and r["final"] is True
        assert sorted(v for d in s["data"] for v in d.values()) == [
            b"1", b"2"]

    def test_ttl_expiry_resolves_abandoned_txn(self):
        s = both(_ttl_expiry)
        assert s["refusal"][0] == "LockConflict" and s["resolved"] == 1
        assert s["decided"] is not None and s["decided"][0] is False
        assert s["handles"][1]["status"] == "committed"
        assert [v for d in s["data"] for v in d.values()] == [b"new"]

    def test_observability_counters_slo_and_status(self):
        s = both(_observability)
        total = dict(s["metrics"]["raft_txn_total"])
        assert total[("committed", "0")] == 1
        assert total[("aborted", "0")] == 1
        assert sum(v for _, v in s["metrics"]["raft_txn_locks_total"]) >= 3
        assert s["slo"][("txn_commit", 0)][0] >= 1
        assert s["board"]["committed"] == 1
        assert s["board"]["aborted"] == 1
        assert s["board"]["held"] == 0


# ------------------------------------------- submit_many placement contract
def _partial(ns):
    eng = ns.engine(_cfg(ns), 2)
    router = ns.Router(eng, drive=False)
    eng.seed_leaders()
    orig = eng.submit_to_leader
    n = {"calls": 0}

    def flaky(g, payload):
        n["calls"] += 1
        if n["calls"] == 3:
            raise ns.Overloaded("depth", eng.cfg.heartbeat_period, group=g)
        return orig(g, payload)

    eng.submit_to_leader = flaky
    items = [(b"pin", (b"p%d" % i).ljust(32, b".")) for i in range(5)]
    with pytest.raises(ns.Overloaded) as ei:
        router.submit_many(items)
    return _plain({"partial": ei.value.partial,
                   "refusal": _refusal(ei.value),
                   "queues": [[(seq, bytes(p)) for seq, p in eng._queue[g]]
                              for g in range(eng.G)]})


def _resume(ns):
    eng = ns.engine(_cfg(ns), 2)
    router = ns.Router(eng)
    eng.seed_leaders()
    orig = eng.submit_to_leader
    placed = []
    n = {"calls": 0}

    def flaky(g, payload):
        n["calls"] += 1
        if n["calls"] == 3:
            raise ns.Overloaded("depth", eng.cfg.heartbeat_period, group=g)
        seq = orig(g, payload)
        placed.append(bytes(payload))
        return seq

    eng.submit_to_leader = flaky
    items = [(b"pin", (b"q%d" % i).ljust(32, b".")) for i in range(5)]
    out = router.submit_many(items)
    return _plain({"out": out, "placed": placed, "calls": n["calls"],
                   "clock": eng.clock.now,
                   "watermarks": list(eng.commit_watermark)})


class TestSubmitManyPin:
    def test_partial_carries_alignment_no_double_queue(self):
        s = both(_partial)
        assert len(s["partial"]) == 5
        assert [p is not None for p in s["partial"]] == [
            True, True, False, False, False]

    def test_driving_retry_resumes_from_first_unplaced(self):
        s = both(_resume)
        assert all(p is not None for p in s["out"])
        assert len({seq for _, seq in s["out"]}) == 5
        assert sorted(s["placed"]) == sorted(
            (b"q%d" % i).ljust(32, b".") for i in range(5))
