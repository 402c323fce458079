"""The port's engine tick loop (``raft_tpu_torch.raft.RaftEngine``) against
the JAX engine (``raft_tpu.raft.RaftEngine``): the same ``RaftConfig`` and
seed, the same calls, byte-identical results — every nodelog line, the
``random.Random`` state and the event heap after every ``step_event``,
commit stamps and ``commit_latencies()``, terms, roles and the watermark,
every state leaf (so every replica's committed bytes), and the
``register_apply`` stream.

Small shapes (3 replicas, 32-byte entries, B = 8, C = 128) with one
transport per package per shape, so each JAX program compiles once. The
JAX engine runs on the CPU; the port's transport is built with
``device="cpu"`` and runs its kernels' plain versions.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from raft_tpu.ckpt import CheckpointStore as JStore
from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.golden import GoldenCluster
from raft_tpu.raft import RaftEngine as JEngine
from raft_tpu.transport import SingleDeviceTransport as JTransport
from raft_tpu_torch.ckpt import CheckpointStore as TStore
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.faults import FaultPlan
from raft_tpu_torch.raft import RaftEngine as TEngine
from raft_tpu_torch.storm import storm_once
from raft_tpu_torch.transport import SingleDeviceTransport as TTransport
from tests._torch_port import assert_states_equal

KW = dict(n_replicas=3, entry_bytes=32, batch_size=8, log_capacity=128,
          transport="single")
_TRANSPORTS: dict = {}


def transports(kw):
    """One transport per package per shape (the JAX programs compile once
    per shape)."""
    key = tuple(sorted(kw.items()))
    if key not in _TRANSPORTS:
        _TRANSPORTS[key] = (JTransport(JConfig(**kw)),
                            TTransport(TConfig(**kw), device="cpu"))
    return _TRANSPORTS[key]


def payloads(n, seed, entry=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, entry, dtype=np.uint8).tobytes()
            for _ in range(n)]


class Pair:
    """One cluster run by both engines, stepped in lock step.

    ``vote_logs`` is a (JAX path, port path) pair: each engine keeps its
    own vote log, and the two files must stay byte-identical.
    ``restore_from`` is a (JAX path, port path) pair of checkpoints: the
    engines are built by ``RaftEngine.restore`` from them. ``replay``
    registers the apply callbacks with ``replay=True``. ``recorders`` is
    a (JAX, port) pair of flight recorders handed to the constructors."""

    def __init__(self, seed=0, vote_logs=None, restore_from=None,
                 replay=False, recorders=(None, None), **over):
        self.kw = {**KW, **over}
        jt, tt = transports(self.kw)
        self.jl, self.tl = [], []
        self.vote_logs = vote_logs
        jv, tv = vote_logs if vote_logs is not None else (None, None)
        jr, tr = recorders
        jcfg, tcfg = JConfig(**self.kw, seed=seed), TConfig(**self.kw,
                                                            seed=seed)
        if restore_from is None:
            self.j = JEngine(jcfg, jt, trace=self.jl.append, vote_log=jv,
                             recorder=jr)
            self.t = TEngine(tcfg, tt, trace=self.tl.append, vote_log=tv,
                             recorder=tr)
        else:
            self.j = JEngine.restore(jcfg, restore_from[0], jt,
                                     trace=self.jl.append, vote_log=jv,
                                     recorder=jr)
            self.t = TEngine.restore(tcfg, restore_from[1], tt,
                                     trace=self.tl.append, vote_log=tv,
                                     recorder=tr)
        self.japp, self.tapp = [], []
        self.starts = (
            self.j.register_apply(lambda i, p: self.japp.append((i, p)),
                                  replay=replay),
            self.t.register_apply(lambda i, p: self.tapp.append((i, p)),
                                  replay=replay))
        assert self.starts[0] == self.starts[1]
        self.check()

    def both(self, name, *args, **kw):
        got = [getattr(e, name)(*args, **kw) for e in (self.j, self.t)]
        assert got[0] == got[1], f"{name}: {got}"
        self.check()
        return got[1]

    def both_raise(self, name, *args, **kw):
        """``name`` raises in both engines: the same exception class name
        and message. Returns the port's (name, message)."""
        got = []
        for e in (self.j, self.t):
            try:
                getattr(e, name)(*args, **kw)
            except Exception as ex:   # compared below, never swallowed
                got.append((type(ex).__name__, str(ex)))
            else:
                got.append(None)
        assert got[0] is not None and got[0] == got[1], f"{name}: {got}"
        self.check()
        return got[1]

    def submit(self, ps):
        return [self.both("submit", p) for p in ps]

    def step(self):
        assert self.j.step_event() == self.t.step_event()
        self.check()

    def until(self, cond, limit=600.0):
        end = self.j.clock.now + limit
        while not cond(self.j) and self.j.clock.now < end and self.j._q:
            self.step()
        assert cond(self.j) and cond(self.t)

    def until_leader(self):
        self.until(lambda e: e.leader_id is not None)
        return self.t.leader_id

    def until_committed(self, seq, limit=600.0):
        self.until(lambda e: e.is_durable(seq), limit)

    def run_for(self, seconds):
        """``run_for`` event by event (checked after each)."""
        end = self.j.clock.now + seconds
        while self.j._q and self.j._q[0][0] <= end:
            self.step()
        for e in (self.j, self.t):
            e.clock.now = max(e.clock.now, end)
        self.check()

    def check(self):
        """What every event must leave equal."""
        j, t = self.j, self.t
        assert t.rng.getstate() == j.rng.getstate(), "rng state"
        assert t._q == j._q, "event heap"
        assert self.tl == self.jl, "nodelog lines"
        assert t.clock.now == j.clock.now
        assert t.roles == j.roles
        np.testing.assert_array_equal(t.terms, j.terms)
        np.testing.assert_array_equal(t.lead_terms, j.lead_terms)
        assert (t.leader_id, t.leader_term, t.commit_watermark) == \
            (j.leader_id, j.leader_term, j.commit_watermark)
        assert t._steady == j._steady
        assert t._queue == j._queue
        assert t.next_event_time() == j.next_event_time()
        # the configuration and the read plane (membership, tickets, leases)
        for f in ("member", "learner", "_wiped", "_row_commit",
                  "_lease_ok_term"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                          err_msg=f)
        for f in ("_staged_config", "_config_seqs", "_pending_config",
                  "_reads", "_read_buckets", "_read_evict_floor",
                  "_next_read_ticket", "read_class_counts"):
            assert getattr(t, f) == getattr(j, f), f
        assert (t.lease is None) == (j.lease is None)
        if t.lease is not None:
            assert (t.lease._grant, t.lease._rate, t.lease.grants) == \
                (j.lease._grant, j.lease._rate, j.lease.grants)
        if self.vote_logs is not None:
            jb, tb = (open(f, "rb").read() for f in self.vote_logs)
            assert tb == jb, "vote log files"

    def check_all(self, read_back=True, archive_except=()):
        """Everything: the light checks, every state leaf, the stamps and
        latencies, the host buffers, the apply stream, and a committed
        read-back through ``committed_entries``. ``archive_except`` names
        log indices whose archived (and applied) bytes the JAX engine is
        known to get wrong on the CPU (its Pallas interpret mode); the
        caller holds the port's against the submitted bytes there."""
        self.check()
        j, t = self.j, self.t
        assert_states_equal(j.state, t.state, "engine state")
        assert t.commit_time == j.commit_time
        assert t.submit_time == j.submit_time
        np.testing.assert_array_equal(t.commit_latencies(),
                                      j.commit_latencies())
        assert t._seq_at_index == j._seq_at_index
        assert t._uncommitted == j._uncommitted
        np.testing.assert_array_equal(t._ring_floor, j._ring_floor)
        assert t._match_stall == j._match_stall
        assert (t.store.first, t.store.last) == (j.store.first, j.store.last)
        for idx in range(t.store.first, t.store.last + 1):
            if idx not in archive_except:
                assert t.store.get(idx) == j.store.get(idx), f"archive {idx}"
        assert t.applied_index == j.applied_index
        assert t.in_flight_count == j.in_flight_count
        assert t.committed_total == j.committed_total
        assert [a for a in self.tapp if a[0] not in archive_except] == \
            [a for a in self.japp if a[0] not in archive_except]
        assert [a[0] for a in self.tapp] == [a[0] for a in self.japp]
        assert [i for i, _ in self.tapp] == list(
            range(self.starts[1], t.applied_index + 1))
        wm = t.commit_watermark
        if read_back and wm:
            lo = max(1, wm - t.state.capacity + 1)
            np.testing.assert_array_equal(
                t.committed_entries(lo, wm),
                np.asarray(j.committed_entries(lo, wm)))


def committed_bytes(pair):
    """The apply stream's bytes, in log order."""
    return [p for _, p in pair.tapp]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_election(seed):
    p = Pair(seed)
    p.until_leader()
    p.run_for(10.0)
    p.check_all()


def test_submit_and_read_back():
    p = Pair(3)
    p.until_leader()
    ps = payloads(60, 3)
    seqs = p.submit(ps)
    p.until_committed(seqs[-1])
    p.both("run_for", 5.0)           # the engines' own run_for
    p.check_all()
    assert committed_bytes(p) == ps
    np.testing.assert_array_equal(
        p.t.committed_entries(1, 60),
        np.frombuffer(b"".join(ps), np.uint8).reshape(60, 32))


def test_leader_failover_with_entries_in_flight():
    p = Pair(4)
    lead = p.until_leader()
    a, b = [r for r in range(3) if r != lead]
    seqs = p.submit(payloads(12, 40))
    p.until_committed(seqs[-1])
    # A dead and B slow: the leader ingests, nothing commits
    p.both("fail", a)
    p.both("set_slow", b, True)
    p.submit(payloads(20, 41))
    p.run_for(10.0)
    assert p.t.in_flight_count > 0
    p.check_all()
    p.both("fail", lead)
    p.both("set_slow", b, False)
    p.both("recover", a)
    p.until_leader()
    seqs = p.submit(payloads(10, 42))
    p.until_committed(seqs[-1])
    p.both("recover", lead)
    p.run_for(30.0)
    p.check_all()


def test_slow_follower_heals():
    p = Pair(5)
    lead = p.until_leader()
    f = (lead + 1) % 3
    p.both("set_slow", f, True)
    seqs = p.submit(payloads(40, 5))
    p.until_committed(seqs[-1])
    p.check_all()
    p.both("set_slow", f, False)
    p.run_for(30.0)
    p.check_all()
    assert int(p.t.state.commit_index[f]) == p.t.commit_watermark


def test_dead_majority_then_recovery():
    p = Pair(6)
    lead = p.until_leader()
    others = [r for r in range(3) if r != lead]
    for r in others:
        p.both("fail", r)
    seqs = p.submit(payloads(30, 6))
    p.run_for(40.0)
    assert p.t.commit_watermark == 0
    for r in others:
        p.both("recover", r)
    p.until_committed(seqs[-1])
    p.run_for(10.0)
    p.check_all()


def test_ring_backpressure_requeues():
    """A leader whose followers hold nothing fills its ring (C = 128) and
    leaves the rest queued; re-elected in a later term, it holds a full
    ring of old-term entries and truncates a batch to unwedge it
    (``_make_room_for_current_term``), re-queuing the bytes."""
    p = Pair(7)
    lead = p.until_leader()
    a, b = [r for r in range(3) if r != lead]
    p.both("fail", a)
    p.both("set_slow", b, True)
    seqs = p.submit(payloads(200, 7))
    p.run_for(60.0)
    assert int(p.t.state.last_index[lead]) == 128
    assert len(p.t._queue) == 200 - 128
    p.both("set_slow", b, False)
    p.both("fail", b)
    p.both("fail", lead)
    p.both("recover", lead)
    p.both("recover", a)
    p.until(lambda e: any("truncated to unwedge" in ln for ln in p.jl))
    p.both("recover", b)
    p.until_committed(seqs[-1], limit=2000.0)
    p.run_for(10.0)
    p.check_all()


def test_steady_dispatch_auto_against_off():
    """The same run under both dispatch modes: each equals the JAX engine,
    and the two commit the same bytes."""
    got = {}
    for mode in ("auto", "off"):
        p = Pair(8, steady_dispatch=mode)
        lead = p.until_leader()
        seqs = p.submit(payloads(50, 8))
        p.until_committed(seqs[-1])
        p.both("set_slow", (lead + 1) % 3, True)
        seqs = p.submit(payloads(30, 9))
        p.until_committed(seqs[-1])
        p.both("set_slow", (lead + 1) % 3, False)
        p.run_for(20.0)
        p.check_all()
        got[mode] = committed_bytes(p)
    assert got["auto"] == got["off"] == payloads(50, 8) + payloads(30, 9)


def _storm_factory(cls, cfg_cls, kw):
    def make(seed, prevote, trace):
        cfg = cfg_cls(**kw, seed=seed, prevote=prevote, check_quorum=prevote)
        return cls(cfg, transports(kw)[cls is TEngine], trace=trace)
    return make


@pytest.mark.parametrize("prevote", [False, True])
def test_config5_storm(prevote):
    """BASELINE config 5's schedule (the storm plan, the leader kills, an
    entry a second) over a 200-s window at the small shape, both
    variants: the port's engine equals the JAX engine."""
    runs = [storm_once(_storm_factory(cls, cfg, KW), prevote, window=200.0,
                       measure_first_leader=not prevote)
            for cls, cfg in ((JEngine, JConfig), (TEngine, TConfig))]
    j, t = (r.pop("engine") for r in runs)
    assert runs[1].pop("trace") == runs[0].pop("trace")
    # as JSON: the first-leader figures are NaN when not measured
    assert json.dumps(runs[1], sort_keys=True) == \
        json.dumps(runs[0], sort_keys=True)
    assert t.rng.getstate() == j.rng.getstate() and t._q == j._q
    np.testing.assert_array_equal(t.terms, j.terms)
    np.testing.assert_array_equal(t.commit_latencies(), j.commit_latencies())
    assert_states_equal(j.state, t.state, "storm")
    assert runs[1]["committed"] > 0 and runs[1]["leader_kills"] == 1


def test_submit_pipelined_scan():
    """``submit_pipelined`` off the card: both engines' backend gates
    refuse the single-launch flight, so every chunk (a whole ring, then
    the tail) is a ``replicate_many`` scan of ticks."""
    p = Pair(14)
    p.until_leader()
    ps = payloads(128 + 60, 14)
    p.both("submit_pipelined", ps)
    p.check_all()
    p.until_committed(p.t._next_seq - 1)
    p.run_for(4.0)
    p.check_all()
    assert committed_bytes(p) == ps


def test_committed_log_equals_golden():
    """The port engine's committed log is byte-identical to the golden
    oracle's (the ``tests/test_golden.py`` ``TestDifferential`` join)."""
    ps = payloads(40, 12)
    c = GoldenCluster(3, seed=12)
    lead = c.run_until_leader()
    c.start_client()
    for x in ps:
        c.inject(x)
    c.run_until(c.now + 40.0)
    golden = lead.committed_payloads()[:40]
    assert len(golden) == 40
    e = TEngine(TConfig(**KW, seed=12), transports(KW)[1])
    e.run_until_leader()
    seqs = [e.submit(x) for x in ps]
    e.run_until_committed(seqs[-1])
    want = np.frombuffer(b"".join(golden), np.uint8).reshape(40, 32)
    np.testing.assert_array_equal(e.committed_entries(1, 40), want)
    for r in range(3):
        from raft_tpu_torch.core.state import committed_payloads

        np.testing.assert_array_equal(committed_payloads(e.state, r), want)


DEFERRED_CONFIGS = [
    (dict(mirror_check_every=8), "A15"),
]


@pytest.mark.parametrize("over,item", DEFERRED_CONFIGS,
                         ids=[c[1] for c in DEFERRED_CONFIGS])
def test_deferred_config_raises(over, item):
    """A configuration once deferred to its ROADMAP item now runs:
    ``mirror_check_every`` (A15, the mirror digest) folds every decision
    into the JAX engine's rolling digest, record for record, and in a
    one-process world the exchange is a no-op in both engines."""
    pair = Pair(seed=3, **over)
    pair.until_leader()
    pair.until_committed(pair.submit(payloads(12, 4))[-1])
    pair.run_for(12 * pair.t.cfg.heartbeat_period)
    assert pair.t._mirror_decisions == pair.j._mirror_decisions > 8
    assert pair.t._mirror_digest == pair.j._mirror_digest
    assert pair.t.mirror_exchanges == 0


def test_engine_without_transport_runs_on_cuda():
    """No transport: the engine builds ``make_transport(cfg)``, which runs
    on CUDA — on a machine without a card it raises, never falls back."""
    if torch.cuda.is_available():
        assert TEngine(TConfig(**KW)).state.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(TConfig(**KW))


def test_fault_plan_drives_the_engine():
    """A scripted ``FaultPlan`` (kill, slow, campaign, partition, heal)
    merged into both heaps fires identically."""
    p = Pair(13)
    lead = p.until_leader()
    f = (lead + 1) % 3
    t0 = p.t.clock.now
    plan = FaultPlan([])
    plan.add(t0 + 5.0, "slow", f).add(t0 + 15.0, "unslow", f)
    plan.add(t0 + 20.0, "campaign", f).add(t0 + 40.0, "kill", lead)
    plan.add(t0 + 70.0, "recover", lead)
    split = FaultPlan.split([[lead], [f, 3 - lead - f]], t0 + 80.0, t0 + 110.0)
    for e in (p.j, p.t):
        e.schedule_faults(plan)
        e.schedule_faults(split)
    p.submit(payloads(20, 13))
    p.run_for(150.0)
    p.check_all()
    assert any("partition healed" in ln for ln in p.tl)
    assert hashlib.sha256(b"".join(committed_bytes(p))).hexdigest()


def test_checkpoint_store_compacts_as_the_jax_store():
    """The archive the engine commits into: puts past ``max_entries``
    compact the oldest away, in both packages alike."""
    stores = (JStore(4, max_entries=50), TStore(4, max_entries=50))
    for idx in [*range(1, 120), 119, 121]:
        for st in stores:
            st.put(idx, idx.to_bytes(4, "little"), idx // 7)
    j, t = stores
    assert (t.first, t.last) == (j.first, j.last)
    for idx in range(0, 125):
        assert t.get(idx) == j.get(idx), idx
        assert t.covered_lo(idx) == j.covered_lo(idx), idx
    snap_j, snap_t = j.snapshot(80, 119), t.snapshot(80, 119)
    np.testing.assert_array_equal(snap_t.entries, snap_j.entries)
    np.testing.assert_array_equal(snap_t.terms, snap_j.terms)
