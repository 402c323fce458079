"""The port's multi-Raft plane (``raft_tpu_torch.multi``: ``MultiEngine``,
``Router``, ``Rebalancer``; ``examples.kv_sharded.ShardedKV``) against the
JAX package's: the same ``RaftConfig``, seed and calls, and equal results
in every group — nodelog lines, the event heap and every group's rng
after every event, roles, terms, watermarks, queues, every state leaf,
committed bytes, commit stamps and the apply stream.

``MPair`` runs one deployment through both engines in lock step (the
multi-group ``tests/test_torch_engine.py`` ``Pair``). The cases rerun
``tests/test_multi_raft.py`` (``TestMultiEngine``, ``TestRouter``,
``TestGoldenDifferential``), ``test_read_scale.py`` ``TestMultiReads``,
``test_fused_ticks.py`` ``TestMultiFused`` (``fuse_k`` 8 equal to 1),
``test_admission.py``'s multi and Router cases and
``test_group_shard.py``'s resident-layout cases through both packages,
and pin the port's refusals. Small shapes (3 replicas, 2-4 groups, B =
4-8, C = 16-256); the port runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from raft_tpu.admission import CircuitOpen as JCircuitOpen
from raft_tpu.admission import Overloaded as JOverloaded
from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.examples.kv import encode_op as jencode_op
from raft_tpu.examples.kv_sharded import ShardedKV as JShardedKV
from raft_tpu.faults import FaultEvent as JFaultEvent
from raft_tpu.faults import FaultPlan as JFaultPlan
from raft_tpu.multi import MultiEngine as JMulti
from raft_tpu.multi import NotLeader as JNotLeader
from raft_tpu.multi import ReadLagging as JReadLagging
from raft_tpu.multi import ReadSession as JSession
from raft_tpu.multi import Router as JRouter
from raft_tpu_torch.admission import CircuitOpen, Overloaded
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core.state import committed_payloads
from raft_tpu_torch.examples.kv import encode_op
from raft_tpu_torch.examples.kv_sharded import ShardedKV
from raft_tpu_torch.faults import FaultEvent, FaultPlan
from raft_tpu_torch.golden import GoldenCluster
from raft_tpu_torch.multi import (
    GROUP_AXIS_TRANSPORTS,
    MultiEngine,
    NotLeader,
    ReadLagging,
    ReadSession,
    Rebalancer,
    Router,
    UnsupportedGroupTransport,
    UnsupportedMembership,
)
from raft_tpu_torch.raft import RaftEngine
from raft_tpu_torch.transport import SingleDeviceTransport
from tests._torch_port import assert_states_equal

ENTRY = 64
BASE = dict(n_replicas=3, entry_bytes=ENTRY, batch_size=8, log_capacity=256,
            transport="single", seed=5)


def payloads(n, seed, entry=ENTRY):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, entry, np.uint8).tobytes() for _ in range(n)]


class MPair:
    """One multi-group deployment run by both engines, in lock step.

    ``over`` overrides ``BASE``; ``recorders`` is a (JAX, port) pair of
    flight recorders; ``apply`` registers an apply callback on every
    group of both engines (their streams must stay equal); ``meshes`` a
    (JAX ``Mesh``, port ``GroupMesh``) pair for the sharded layout."""

    def __init__(self, G, recorders=(None, None), apply=False,
                 meshes=(None, None), **over):
        self.kw = {**BASE, **over}
        self.G = G
        self.jl, self.tl = [], []
        self.j = JMulti(JConfig(**self.kw), G, trace=self.jl.append,
                        recorder=recorders[0], mesh=meshes[0])
        self.t = MultiEngine(TConfig(**self.kw), G, trace=self.tl.append,
                             recorder=recorders[1], mesh=meshes[1],
                             device="cpu")
        self.japp = [[] for _ in range(G)]
        self.tapp = [[] for _ in range(G)]
        if apply:
            for g in range(G):
                for e, out in ((self.j, self.japp), (self.t, self.tapp)):
                    e.register_apply(
                        g, lambda i, p, out=out, g=g: out[g].append((i, p)))
        self.check()

    @property
    def engines(self):
        return (self.j, self.t)

    def both(self, name, *args, **kw):
        got = [getattr(e, name)(*args, **kw) for e in self.engines]
        assert got[0] == got[1], f"{name}: {got}"
        self.check()
        return got[1]

    def both_raise(self, name, *args, **kw):
        """``name`` raises in both engines with the same exception class
        name and message; returns the port's exception."""
        got, exc = [], None
        for e in self.engines:
            try:
                getattr(e, name)(*args, **kw)
            except Exception as ex:   # compared below, never swallowed
                got.append((type(ex).__name__, str(ex)))
                exc = ex
            else:
                got.append(None)
        assert got[0] is not None and got[0] == got[1], f"{name}: {got}"
        self.check()
        return exc

    def submit_all(self, sched):
        """{g: [payload, ...]} -> {g: last seq}, submitted on both."""
        last = {}
        for g, ps in sched.items():
            for p in ps:
                last[g] = self.both("submit", g, p)
        return last

    def step(self, horizon=None):
        assert self.j.step_event(horizon) == self.t.step_event(horizon)
        self.check()

    def until(self, cond, limit=600.0):
        end = self.j.clock.now + limit
        while not cond(self.j) and self.j.clock.now < end and self.j._q:
            self.step()
        assert cond(self.j) and cond(self.t)

    def until_leader(self, g):
        self.until(lambda e: e.leader_id[g] is not None)
        return self.t.leader_id[g]

    def until_committed(self, g, seq, limit=600.0):
        self.until(lambda e: e.is_durable(g, seq), limit)

    def run_for(self, seconds):
        """``run_for`` event by event (with its horizon, so fused windows
        fire as in ``run_for``), checked after each."""
        end = self.j.clock.now + seconds
        while self.j._q and self.j._q[0][0] <= end:
            self.step(horizon=end)
        for e in self.engines:
            e.clock.now = max(e.clock.now, end)
        self.check()

    def check(self):
        """What every event must leave equal (host state only)."""
        j, t = self.j, self.t
        assert self.tl == self.jl, "nodelog lines"
        assert t._q == j._q, "event heap"
        assert [r.getstate() for r in t.rngs] == \
            [r.getstate() for r in j.rngs], "rng streams"
        assert t.clock.now == j.clock.now
        assert t.roles == j.roles
        assert t.leader_id == j.leader_id
        for f in ("terms", "lead_terms", "commit_watermark", "alive", "slow",
                  "connectivity", "applied_index", "_row_commit",
                  "_lease_ok_term", "_match_host", "committed_total"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                          err_msg=f)
        for f in ("_queue", "_seq_events", "fused_launches", "fused_ticks",
                  "shed_by_group", "read_class_counts", "_track_match",
                  "migrations", "transport_mode", "n_shards"):
            assert getattr(t, f) == getattr(j, f), f
        assert self.tapp == self.japp, "apply streams"

    def check_all(self):
        """Everything: the host checks, every state leaf of every group,
        committed bytes, stamps, latencies, buffers and archives."""
        self.check()
        j, t = self.j, self.t
        if t._gshard is None:
            assert_states_equal(j.state, t.state, "group state")
        else:
            got = t._gshard.gather_state(t.state)
            for f, v in got.items():
                np.testing.assert_array_equal(
                    v, np.asarray(getattr(j.state, f)), err_msg=f)
        np.testing.assert_array_equal(t._slot, j._slot)
        np.testing.assert_array_equal(t._phys_group, j._phys_group)
        for g in range(self.G):
            assert t.committed_payloads(g) == j.committed_payloads(g), g
        for f in ("commit_time", "submit_time", "_seq_at_index",
                  "_uncommitted", "_archive", "_durable_ranges"):
            assert getattr(t, f) == getattr(j, f), f
        np.testing.assert_array_equal(t._archive_floor, j._archive_floor)
        np.testing.assert_array_equal(t.commit_latencies(),
                                      j.commit_latencies())
        assert t._status_snapshot() == j._status_snapshot()


# ------------------------------------------------------------ the engine
class TestMultiEngine:
    def test_committed_bytes_match_single_engine_per_group(self):
        """G = 4 groups with distinct schedules through both multi
        engines in lock step; every group's committed log also equals a
        lone port ``RaftEngine`` fed the same schedule."""
        G = 4
        p = MPair(G, apply=True)
        p.both("seed_leaders")
        assert all(l is not None for l in p.t.leader_id)
        assert p.t.leader_spread() == p.j.leader_spread()
        assert len(p.t.leader_spread()) == 3
        sched = {g: payloads(10 + g, seed=100 + g) for g in range(G)}
        last = p.submit_all(sched)
        for g in range(G):
            p.until_committed(g, last[g])
        p.check_all()
        cfg = TConfig(**BASE)
        for g in range(G):
            got = p.t.committed_payloads(g)
            assert got == sched[g], f"group {g} committed bytes"
            assert [b for _, b in p.tapp[g]] == sched[g]
            se = RaftEngine(cfg, SingleDeviceTransport(cfg, device="cpu"))
            se.run_until_leader()
            for pl in sched[g]:
                sq = se.submit(pl)
            se.run_until_committed(sq)
            assert got == [bytes(r) for r in
                           committed_payloads(se.state, se.leader_id)]

    def test_same_tick_rounds_share_launches(self):
        """Seeded leaders tick in lock step: a round of traffic across
        all groups rides shared launches, the same launches in both."""
        G = 4
        counted = []
        for e in (JMulti(JConfig(**BASE), G),
                  MultiEngine(TConfig(**BASE), G, device="cpu")):
            e.seed_leaders()
            box = [0, 0]
            orig = e._replicate

            def counting(state, pays, counts, leaders, lterms, *a,
                         orig=orig, box=box):
                box[0] += 1
                box[1] += int((np.asarray(lterms) > 0).sum())
                return orig(state, pays, counts, leaders, lterms, *a)

            e._replicate = counting
            last = {}
            for g in range(G):
                for pl in payloads(16, seed=g):
                    last[g] = e.submit(g, pl)
            for g in range(G):
                e.run_until_committed(g, last[g])
            counted.append(tuple(box))
        assert counted[0] == counted[1]
        launches, covered = counted[1]
        assert launches > 0 and covered >= 2 * launches

    def test_partition_independence(self):
        """One group loses quorum: its commits stall and its elections
        churn alone; sibling groups keep committing."""
        G = 3
        p = MPair(G)
        p.both("seed_leaders")
        last = p.submit_all({g: payloads(4, seed=g) for g in range(G)})
        for g in range(G):
            p.until_committed(g, last[g])
        wm = [int(w) for w in p.t.commit_watermark]
        p.both("partition", 1, [[0], [1], [2]])
        before = {g: int(p.t.terms[g].max()) for g in range(G)}
        last = p.submit_all({g: payloads(3, seed=10 + g) for g in range(G)})
        p.run_for(150.0)
        assert int(p.t.commit_watermark[1]) == wm[1]
        for g in (0, 2):
            assert p.t.is_durable(g, last[g])
            assert int(p.t.terms[g].max()) == before[g]
        assert int(p.t.terms[1].max()) > before[1]
        p.both("heal_partition", 1)
        p.until_leader(1)
        s = p.both("submit", 1, payloads(1, seed=99)[0])
        p.until_committed(1, s)
        p.check_all()

    def test_same_instant_split_brain_ticks_both_survive(self):
        """A stale minority leader and the current leader of one group
        tick on one instant: the second rides a follow-up round and both
        heartbeat chains re-arm."""
        p = MPair(1)
        p.both("seed_leaders")
        lead = p.t.leader_id[0]
        other = (lead + 1) % 3
        p.both("partition", 0, [[lead], [x for x in range(3) if x != lead]])
        for e in p.engines:
            e.roles[0][other] = "leader"
            e.terms[0, other] = e.lead_terms[0, other] = (
                int(e.lead_terms[0, lead]) + 1)
        p.both("_fire_leader_ticks", [(0, lead), (0, other)])
        rearmed = {(g, r) for (_, _, kind, g, r) in p.t._q if kind == "l"}
        assert (0, lead) in rearmed and (0, other) in rearmed
        p.check_all()

    def test_fault_plan_group_scope(self):
        """``FaultPlan`` events with a ``group`` scope hit only that
        group; unscoped events hit every group."""
        p = MPair(3)
        p.both("seed_leaders")
        now = p.t.clock.now
        p.j.schedule_faults(JFaultPlan([
            JFaultEvent(now + 1.0, "slow", 2, group=1),
            JFaultEvent(now + 2.0, "kill", 0)]))
        p.t.schedule_faults(FaultPlan([
            FaultEvent(now + 1.0, "slow", 2, group=1),
            FaultEvent(now + 2.0, "kill", 0)]))
        p.run_for(3.0)
        assert p.t.slow[1, 2] and not p.t.slow[0, 2] and not p.t.slow[2, 2]
        assert not p.t.alive[:, 0].any()
        p.check_all()

    @pytest.mark.parametrize("groups", [[[0, 1], [1, 2]], [[0], [2]]],
                             ids=["overlap", "gap"])
    def test_partition_rejects_overlap_and_gaps(self, groups):
        p = MPair(2)
        assert isinstance(p.both_raise("partition", 0, groups), ValueError)

    def test_rebalance_skips_behind_target_without_deposing(self):
        p = MPair(1)
        p.both("seed_leaders")
        p.both("fail", 0, 0)
        p.until_leader(0)
        s = p.both("submit", 0, payloads(1, seed=21)[0])
        p.until_committed(0, s)
        p.both("recover", 0, 0)
        incumbent = p.t.leader_id[0]
        assert p.both("rebalance") == 0
        assert p.t.leader_id[0] == incumbent
        p.check_all()

    def test_rebalance_respreads_leadership(self):
        p = MPair(4)
        p.both("seed_leaders")
        p.both("fail", 0, 0)
        p.until_leader(0)
        p.both("recover", 0, 0)
        last = p.both("submit", 0, payloads(1, seed=7)[0])
        p.until_committed(0, last)
        p.run_for(3 * p.t.cfg.heartbeat_period)
        assert p.t.leader_id[0] != 0
        assert p.both("rebalance") >= 1
        assert p.t.leader_id[0] == 0
        p.check_all()

    def test_apply_stream_blocks_archive_sweep_and_replay_refusal(self):
        """``test_group_shard.py``'s bounded-history cases on the
        resident layout: the sweep bounds the archive at 2C, an apply
        stream pins it at its cursor, and a late replay refuses."""
        p = MPair(1, apply=True, batch_size=4, log_capacity=8)
        p.both("seed_leaders")
        n = 3 * 2 * 8
        last = None
        for pl in payloads(n, seed=6):
            last = p.both("submit", 0, pl)
            if last % 8 == 0:
                p.until_committed(0, last)
        p.until_committed(0, last)
        assert [i for i, _ in p.tapp[0]] == list(range(1, n + 1))
        assert int(p.t._archive_floor[0]) > 1
        exc = p.both_raise("register_apply", 0, lambda i, b: None,
                           replay=True)
        assert "retention horizon" in str(exc)
        p.check_all()


# ------------------------------------------------------------ the router
class TestRouter:
    def _pair(self, G=4, **over):
        p = MPair(G, **over)
        p.both("seed_leaders")
        return p, JRouter(p.j), Router(p.t)

    def test_key_affinity_stable_and_bucketed(self):
        p, jr, tr = self._pair()
        keys = [f"key-{i}".encode() for i in range(64)]
        groups = [tr.group_of(k) for k in keys]
        assert groups == [jr.group_of(k) for k in keys]
        assert len(set(groups)) > 1
        items = [(k, bytes(ENTRY)) for k in keys]
        placed = tr.submit_many(items)
        assert placed == jr.submit_many(items)
        assert [g for g, _ in placed] == groups
        for g, s in placed:
            p.until_committed(g, s)
        p.check_all()

    def test_notleader_retry_and_sharded_kv(self):
        p = MPair(4)
        p.both("seed_leaders")
        jkv, tkv = JShardedKV(p.j), ShardedKV(p.t)
        g, s = tkv.set(b"alpha", b"1")
        assert (g, s) == jkv.set(b"alpha", b"1")
        p.until_committed(g, s)
        assert tkv.get(b"alpha") == jkv.get(b"alpha") == b"1"
        assert tkv.linearizable_get(b"alpha") == \
            jkv.linearizable_get(b"alpha") == b"1"
        p.both("fail", g, p.t.leader_id[g])
        with pytest.raises(JNotLeader):
            JRouter(p.j, drive=False, max_retries=0).submit(b"alpha",
                                                            bytes(ENTRY))
        with pytest.raises(NotLeader):
            Router(p.t, drive=False, max_retries=0).submit(b"alpha",
                                                           bytes(ENTRY))
        g2, s2 = tkv.set(b"alpha", b"2")
        assert (g2, s2) == jkv.set(b"alpha", b"2") and g2 == g
        p.until_committed(g, s2)
        assert tkv.get(b"alpha") == jkv.get(b"alpha") == b"2"
        assert len(tkv) == len(jkv) and tkv._data == jkv._data
        p.check_all()

    def test_retry_drives_past_minority_leader(self):
        p, jr, tr = self._pair(G=2)
        key = b"minority-key"
        g = tr.group_of(key)
        lead = p.t.leader_id[g]
        others = [r for r in range(3) if r != lead]
        p.both("partition", g, [[lead], others])
        assert tr.read_index(key) == jr.read_index(key)
        assert p.t.leader_id[g] in others
        p.check_all()

    def test_read_index_many_confirms_once_per_group(self):
        p, jr, tr = self._pair()
        keys = [f"rk-{i}".encode() for i in range(32)]
        for k in keys:
            g, s = tr.submit(k, bytes(ENTRY))
            assert (g, s) == jr.submit(k, bytes(ENTRY))
            p.until_committed(g, s)
        rounds = []
        for e in p.engines:
            box = [0]
            orig = e.read_index

            def counting(g, r=None, orig=orig, box=box):
                box[0] += 1
                return orig(g, r)

            e.read_index = counting
            rounds.append(box)
        out = tr.read_index_many(keys)
        assert out == jr.read_index_many(keys)
        assert rounds[0] == rounds[1] == [len({tr.group_of(k)
                                               for k in keys})]
        for k, (g, idx) in zip(keys, out):
            assert idx == int(p.t.commit_watermark[g])
        p.check_all()


# ------------------------------------------------------------ differential
class TestGoldenDifferential:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_multi_group_slow_follower_vs_oracle(self, seed):
        """The slow-follower shape on one group against the port's
        reference-semantics oracle, with sibling traffic, both engines in
        lock step."""
        ps = payloads(10, seed + 300)
        p = MPair(3, seed=seed)
        p.both("seed_leaders")
        bg = p.submit_all({g: payloads(5, seed=g) for g in (0, 2)})
        target = 1
        lead = p.t.leader_id[target]
        p.both("set_slow", target, (lead + 1) % 3, True)
        mid = p.submit_all({target: ps[:5]})[target]
        p.until_committed(target, mid)
        p.both("set_slow", target, (lead + 1) % 3, False)
        mid = p.submit_all({target: ps[5:]})[target]
        p.until_committed(target, mid)

        c = GoldenCluster(3, seed=seed)
        g_lead = c.run_until_leader()
        g_slow = f"Server{(int(g_lead.id.removeprefix('Server')) + 1) % 3}"
        c.set_slow(g_slow, True)
        for pl in ps[:5]:
            g_lead.client_append(pl)
        for _ in range(6):
            if c.leader() is None:
                break
            c._leader_tick(c.leader())
        c.set_slow(g_slow, False)
        for pl in ps[5:]:
            g_lead.client_append(pl)
        for _ in range(6):
            if c.leader() is None:
                break
            c._leader_tick(c.leader())
        golden = c.nodes[g_lead.id].committed_payloads()
        assert golden == ps
        assert p.t.committed_payloads(target) == golden
        for g in (0, 2):
            assert p.t.is_durable(g, bg[g])
        p.check_all()


# ------------------------------------------------------------ fusion
class TestMultiFused:
    def _drive(self, fuse_k, G=3):
        p = MPair(G, apply=True, entry_bytes=32, batch_size=8,
                  log_capacity=128, seed=9, fuse_k=fuse_k)
        p.both("seed_leaders")
        rng = np.random.default_rng(5)
        last = {}
        for g in range(G):
            for _ in range(24 + g * 8):   # uneven backlogs: one group
                #   drains into count-0 heartbeat steps mid-window
                last[g] = p.both("submit", g, rng.integers(
                    0, 256, 32, np.uint8).tobytes())
        p.run_for(24 * p.t.cfg.heartbeat_period)
        for g in range(G):
            assert p.t.is_durable(g, last[g])
        p.check_all()
        return p.t

    def test_shared_window_equals_tick_path(self):
        """The fused window at ``fuse_k`` 8 in both packages, equal to
        each other after every event and, in committed bytes, stamps,
        clock, terms and heap, to ``fuse_k`` 1."""
        a = self._drive(1)
        b = self._drive(8)
        assert b.fused_launches > 0 and a.fused_launches == 0
        for g in range(3):
            assert a.committed_payloads(g) == b.committed_payloads(g)
            assert a.commit_time[g] == b.commit_time[g]
        assert a.clock.now == b.clock.now
        assert a._seq_events == b._seq_events
        assert a.terms.tolist() == b.terms.tolist()
        assert sorted(a._q) == sorted(b._q)


# ------------------------------------------------------------ reads
class TestMultiReads:
    def _stack(self, seed=7, groups=4, **over):
        kw = dict(batch_size=4, log_capacity=64, seed=seed, prevote=True,
                  read_lease=True)
        kw.update(over)
        p = MPair(groups, **kw)
        p.both("seed_leaders")
        p.submit_all({g: [bytes(ENTRY)] * 6 for g in range(groups)})
        p.run_for(30.0)
        return p, JRouter(p.j), Router(p.t)

    def test_certified_lease_zero_rounds(self):
        p, _, _ = self._stack()
        calls = []
        for e in p.engines:
            box = [0]
            orig = e._replicate_round

            def counting(active, orig=orig, box=box):
                box[0] += 1
                return orig(active)

            e._replicate_round = counting
            calls.append(box)
        idx, cls = p.both("certified_read_index", 0)
        assert cls == "lease" and calls == [[0], [0]]
        assert idx == int(p.t.commit_watermark[0])

    def test_read_any_spreads_over_replicas(self):
        p, jr, tr = self._stack()
        served = set()
        for _ in range(9):
            got = tr.read_any(b"key-a")
            assert got == jr.read_any(b"key-a")
            g, r, idx, cls = got
            assert idx == int(p.t.commit_watermark[g])
            served.add(r)
        assert served == {0, 1, 2}
        assert sum(cc.get("follower", 0) for cc in p.t.read_class_counts) > 0
        p.check_all()

    def test_default_config_follower_reads_warm_up_lazily(self):
        p, jr, tr = self._stack(seed=12, groups=2, batch_size=4,
                                prevote=False, read_lease=False)
        served = set()
        for _ in range(9):
            got = tr.read_any(b"key-a")
            assert got == jr.read_any(b"key-a")
            served.add(got[1])
        assert p.t._track_match and served == {0, 1, 2}
        p.check_all()

    def test_pinned_lagging_replica_raises_read_lagging(self):
        p, jr, tr = self._stack(seed=8)
        g = tr.group_of(b"key-a")
        laggard = next(r for r in range(3) if r != p.t.leader_id[g])
        p.both("set_slow", g, laggard, True)
        p.submit_all({g: [bytes(ENTRY)] * 4})
        p.run_for(10.0)
        with pytest.raises(JReadLagging) as je:
            jr.read_any(b"key-a", replica=laggard)
        with pytest.raises(ReadLagging) as te:
            tr.read_any(b"key-a", replica=laggard)
        assert (te.value.group, te.value.replica, te.value.lag) == \
            (je.value.group, je.value.replica, je.value.lag)
        assert te.value.lag > 0
        got = tr.read_any(b"key-a")
        assert got == jr.read_any(b"key-a") and got[1] != laggard
        p.check_all()

    def test_read_any_honors_breaker(self):
        p, jr, tr = self._stack(seed=9)
        g = tr.group_of(b"key-a")
        for _ in range(12):
            jr.breakers[g].on_failure(p.j.clock.now)
            tr.breakers[g].on_failure(p.t.clock.now)
        with pytest.raises(JCircuitOpen):
            jr.read_any(b"key-a")
        with pytest.raises(CircuitOpen) as ei:
            tr.read_any(b"key-a")
        assert ei.value.group == g
        with pytest.raises(CircuitOpen):
            tr.read_session(b"key-a", ReadSession())

    def test_session_tokens_monotone_and_lagging(self):
        p, jr, tr = self._stack(seed=10)
        g = tr.group_of(b"key-a")
        p.both("register_apply", g, lambda i, b: None)
        p.both("submit", g, encode_op(ENTRY, 1, b"key-a", b"v1"))
        assert encode_op(ENTRY, 1, b"key-a", b"v1") == \
            jencode_op(ENTRY, 1, b"key-a", b"v1")
        p.run_for(10.0)
        js, ts = JSession(), ReadSession()
        g1, idx1 = tr.read_session(b"key-a", ts)
        assert (g1, idx1) == jr.read_session(b"key-a", js)
        assert g1 == g and ts.floor == js.floor
        tr.note_write_observed(ts, g)
        jr.note_write_observed(js, g)
        g2, idx2 = tr.read_session(b"key-a", ts)
        assert (g2, idx2) == jr.read_session(b"key-a", js) and idx2 >= idx1
        ts.floor[g] = int(p.t.applied_index[g]) + 100
        with pytest.raises(ReadLagging) as ei:
            tr.read_session(b"key-a", ts)
        assert ei.value.replica is None and ei.value.lag == 100
        assert ReadSession.from_floors(ts.to_jsonable()).floor == ts.floor
        p.check_all()


# ------------------------------------------------------------ admission
def _admission_pair(G=2, **over):
    p = MPair(G, entry_bytes=32, batch_size=4, log_capacity=128, **over)
    p.both("seed_leaders")
    return p


class TestMultiAdmission:
    def test_group_queue_bound(self):
        p = _admission_pair(admission_max_writes=4)
        shed = 0
        for _ in range(10):
            exc = None
            try:
                p.t.submit(0, bytes(32))
            except Overloaded as ex:
                exc = ex
            try:
                p.j.submit(0, bytes(32))
            except JOverloaded as ex:
                assert exc is not None and str(ex) == str(exc)
                shed += 1
            else:
                assert exc is None
        assert shed == 6 and len(p.t._queue[0]) == 4
        assert p.t.shed_by_group[0] == {"depth": 6}
        p.both("submit", 1, bytes(32))
        assert p.t.shed_by_group[1] == {}
        p.check()

    def test_router_retry_budget_fails_fast(self):
        p = _admission_pair()
        counts = []
        for e, router_cls, exc in ((p.j, JRouter, JOverloaded),
                                   (p.t, Router, Overloaded)):
            router = router_cls(e, max_retries=5, retry_budget=2.0,
                                elect_limit=5.0)
            calls = [0]

            def always_overloaded(g, payload, calls=calls, exc=exc):
                calls[0] += 1
                raise exc("depth", 0.5, group=g)

            e.submit_to_leader = always_overloaded
            with pytest.raises(exc):
                router.submit(b"x4", bytes(32))
            assert router.group_of(b"x4") == 0
            counts.append((calls[0], router.budget.denied))
        assert counts[0] == counts[1] == (3, 1)
        p.check()

    def test_router_breaker_opens_then_probe_closes(self):
        p = _admission_pair()
        results = []
        for e, router_cls, exc in ((p.j, JRouter, JOverloaded),
                                   (p.t, Router, Overloaded)):
            router = router_cls(e, max_retries=1, retry_budget=64.0,
                                breaker_threshold=4, elect_limit=5.0)
            orig = e.submit_to_leader

            def always_overloaded(gg, payload, exc=exc):
                raise exc("depth", 0.5, group=gg)

            e.submit_to_leader = always_overloaded
            for _ in range(2):
                with pytest.raises(exc):
                    router.submit(b"x4", bytes(32))
            try:
                router.submit(b"x4", bytes(32))
            except Exception as ex:   # CircuitOpen of either package
                opened = (type(ex).__name__, ex.group, ex.retry_after_s)
            e.submit_to_leader = orig
            e.run_for(e.cfg.follower_timeout[1] + 1)
            g2, seq = router.submit(b"x4", bytes(32))
            e.run_until_committed(g2, seq)
            results.append((opened, g2, seq,
                            router.breakers[0].state(e.clock.now)))
        assert results[0] == results[1]
        assert results[1][0][0] == "CircuitOpen"
        assert results[1][3] == "closed"
        p.check_all()

    def test_router_sheds_overloaded_group_and_sibling_flows(self):
        p = _admission_pair(admission_max_writes=4)
        jr = JRouter(p.j, max_retries=1, retry_budget=2.0)
        tr = Router(p.t, max_retries=1, retry_budget=2.0)
        cfg = p.t.cfg
        lead = p.t.leader_id[0]
        for r in range(3):
            if r != lead:
                p.both("fail", 0, r)
        for _ in range(cfg.log_capacity // cfg.batch_size):
            for _ in range(cfg.batch_size):
                p.both("submit", 0, bytes(32))
            p.run_for(cfg.heartbeat_period)
        for _ in range(4):
            p.both("submit", 0, bytes(32))
        with pytest.raises(JOverloaded):
            jr.submit(b"x4", bytes(32))
        with pytest.raises(Overloaded):
            tr.submit(b"x4", bytes(32))
        g, seq = tr.submit(b"x0", bytes(32))
        assert (g, seq) == jr.submit(b"x0", bytes(32)) and g == 1
        p.until_committed(g, seq)
        p.check_all()

    def test_submit_many_mid_bucket_refusal_never_duplicates(self):
        p = _admission_pair(G=1, admission_max_writes=3)
        items = [(f"mk{i}".encode(), bytes(32)) for i in range(6)]
        jout = JRouter(p.j, max_retries=8, retry_budget=32.0).submit_many(
            items)
        tout = Router(p.t, max_retries=8, retry_budget=32.0).submit_many(
            items)
        assert tout == jout
        seqs = [s for _, s in tout]
        assert sorted(seqs) == seqs and len(set(seqs)) == 6
        for g, s in tout:
            p.until_committed(g, s)
        assert p.t.commit_watermark[0] >= 6
        p.check_all()


# ------------------------------------------------------------ placement
def test_rebalancer_plans_burning_group_off_hot_shard():
    """``test_group_shard.py`` ``TestRebalancer``'s pure plan: snapshot
    in, plan out (the port's copy of the host controller)."""
    from types import SimpleNamespace

    from raft_tpu.multi.rebalancer import Rebalancer as JRebalancer

    snaps = [
        {"shards": 2, "placement": {"0": 0, "1": 0, "2": 1, "3": 1},
         "queue_depth": {"0": 2, "1": 30, "2": 1, "3": 0},
         "slo_alerts": [{"slo": "commit_fast", "group": 0,
                         "severity": "page", "burn_rate": 20.0}],
         "breakers": {"0": "open", "2": "closed"}},
        {"shards": 2, "placement": {"0": 0, "1": 1},
         "queue_depth": {"0": 3, "1": 2}},
        {"shards": 2, "placement": {"0": 0, "1": 1},
         "queue_depth": {"0": 40, "1": 0}},
    ]
    reb = Rebalancer(SimpleNamespace(status_board=None))
    jreb = JRebalancer(SimpleNamespace(status_board=None))
    plans = [reb.plan(s, max_moves=2) for s in snaps]
    assert plans == [jreb.plan(s, max_moves=2) for s in snaps]
    assert plans[0] and plans[0][0]["group"] == 0
    assert (plans[0][0]["src"], plans[0][0]["dst"]) == (0, 1)
    assert plans[0][0]["partner"] == 3
    assert plans[1] == [] and plans[2] == []


def test_resident_layout_placement_and_rebalance():
    """On the resident layout every group lives on shard 0: the
    Rebalancer's plan over the engine's own snapshot is empty, the
    Router's rebalance moves leaders only, and ``migrate_group`` (which
    ``Rebalancer.step`` reaches) refuses as JAX's does."""
    p = MPair(3)
    p.both("seed_leaders")
    snap = p.t._status_snapshot()
    assert snap["shards"] == 1 and snap["transport"] == "single"
    assert set(snap["placement"].values()) == {0}
    assert Rebalancer(p.t).plan() == []
    assert Router(p.t).rebalance() == JRouter(p.j).rebalance() == {
        "leader_moves": 0, "migrations": []}
    assert p.t.groups_on_shard(0) == p.j.groups_on_shard(0) == [0, 1, 2]
    exc = p.both_raise("migrate_group", 0, 1)
    assert isinstance(exc, ValueError) and "sharded layout" in str(exc)
    with pytest.raises(ValueError, match="sharded layout"):
        Rebalancer(p.t).step(snap={**snap, "shards": 2,
                                   "placement": {"0": 0, "1": 0, "2": 1},
                                   "queue_depth": {"0": 20, "1": 10,
                                                   "2": 0}})


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("over, exc, match", [
    (dict(n_replicas=5, entry_bytes=24, rs_k=3, rs_m=2), ValueError,
     "erasure coding"),
    (dict(max_replicas=5), UnsupportedMembership, "fixed membership"),
    (dict(transport="tpu_mesh"), UnsupportedGroupTransport,
     "per-replica-row transport"),
    (dict(transport="nope"), UnsupportedGroupTransport,
     "not a known transport"),
], ids=["ec", "max_replicas", "tpu_mesh", "unknown"])
def test_refusals_match_jax(over, exc, match):
    kw = {**BASE, "entry_bytes": 16, "batch_size": 4, "log_capacity": 64,
          **over}
    with pytest.raises(exc, match=match) as te:
        MultiEngine(TConfig(**kw), 2, device="cpu")
    with pytest.raises(ValueError) as je:
        JMulti(JConfig(**kw), 2)
    assert (type(te.value).__name__, str(te.value)) == \
        (type(je.value).__name__, str(je.value))
    assert issubclass(exc, ValueError)


@pytest.mark.parametrize("how", ["transport", "env"])
def test_group_sharded_layout_degrades_on_one_device(monkeypatch, how):
    """``tests/test_group_shard.py:316`` through both packages:
    ``mesh_groups`` (or ``RAFT_TPU_GSHARD=1``) on one device degrades to
    the resident layout (one shard, placement the identity), commits, and
    ``migrate_group`` refuses naming the sharded layout. The JAX side sees
    one device as its test arranges; the port's ``device="cpu"`` is one."""
    import jax

    from raft_tpu.transport import group_mesh as jgm

    one = jax.devices()[:1]
    monkeypatch.setattr(jgm.jax, "devices", lambda: one)
    over = {}
    if how == "env":
        monkeypatch.setenv("RAFT_TPU_GSHARD", "1")
    else:
        over["transport"] = "mesh_groups"
    p = MPair(4, **over)
    for e in p.engines:
        assert (e.transport_mode, e.n_shards) == ("single", 1)
    p.both("seed_leaders")
    s = p.both("submit", 0, payloads(1, seed=1)[0])
    p.until_committed(0, s)
    p.check_all()
    exc = p.both_raise("migrate_group", 0, 0)
    assert isinstance(exc, ValueError) and "sharded layout" in str(exc)
    assert GROUP_AXIS_TRANSPORTS == ("single", "mesh_groups")


def test_cuda_by_default_with_no_fallback():
    """``MultiEngine(cfg, G)`` resolves CUDA: without a card it raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        e = MultiEngine(TConfig(**BASE), 2)
        assert e.state.term.is_cuda and e._graphs is not None
        return
    with pytest.raises(Exception, match="CUDA|cuda"):
        MultiEngine(TConfig(**BASE), 2)
    e = MultiEngine(TConfig(**BASE), 2, device="cpu")
    assert e.state.term.device.type == "cpu" and e._graphs is None
