"""K-tick fusion in the port (``raft_tpu_torch.raft.steady``, the fused
scan ``core.step.fused_steady_scan`` and ``SingleDeviceTransport.
replicate_fused``) against the JAX package, on the CPU.

- the fused scan through both packages on ``tests/test_fused_ticks.py``
  ``TestEscapeExactness``'s four cases (state leaves, infos, ``escaped``,
  ``ran`` and ``halted`` equal), one of them at B = 128, C = 256 with the
  JAX Pallas K1 in interpret mode;
- ``StagingRing`` through both packages under one sequence of
  ``top_up``/``stage_tail``/``consume``/``reset``;
- both engines with ``fuse_k = 4`` on ``drive_engine``'s schedule (and
  its device-surgery escape), compared after every stage: the
  fingerprint, every nodelog line, ``fused_launches``/``fused_ticks``,
  the rng, the heap and every state leaf; the port's fused run also
  equals its own K = 1 run;
- through the port: the staging realignment, no fusion without a
  horizon, ``RAFT_TPU_FUSE_K``, and leases under fusion
  (``tests/test_read_scale.py`` ``TestFusedCompose``).

Byte equality throughout (these are integers). Small shapes: 3 replicas,
16-byte entries, B = 4, C = 64, one transport per package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.core import step as jstep
from raft_tpu.core.comm import SingleDeviceComm as JComm
from raft_tpu.raft import RaftEngine as JEngine
from raft_tpu.raft.steady import StagingRing as JStaging
from raft_tpu.transport import SingleDeviceTransport as JTransport
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core import state as tst
from raft_tpu_torch.core import step as tstep
from raft_tpu_torch.core.comm import SingleDeviceComm as TComm
from raft_tpu_torch.raft import RaftEngine as TEngine
from raft_tpu_torch.raft.steady import StagingRing as TStaging
from raft_tpu_torch.transport import SingleDeviceTransport as TTransport
from tests._torch_port import (
    assert_infos_equal,
    assert_states_equal,
    pallas_interpret,
    to_port,
)

ENTRY = 16
KW = dict(n_replicas=3, entry_bytes=ENTRY, batch_size=4, log_capacity=64,
          transport="single")
_TRANSPORTS: dict = {}


def transports(kw):
    key = tuple(sorted(kw.items()))
    if key not in _TRANSPORTS:
        _TRANSPORTS[key] = (JTransport(JConfig(**kw)),
                            TTransport(TConfig(**kw), device="cpu"))
    return _TRANSPORTS[key]


def payloads(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, ENTRY, dtype=np.uint8).tobytes()
            for _ in range(n)]


def staging_of(batches, B, W):
    """Per-batch entry lists -> the untiled staging layout i32[S, B, W]."""
    out = np.zeros((len(batches), B, W), np.int32)
    for i, ents in enumerate(batches):
        if ents:
            out[i, :len(ents)] = np.frombuffer(
                b"".join(ents), np.uint8).reshape(len(ents), -1).view(
                    np.int32)
    return out


# ---------------------------------------------------------- the fused scan
class ScanDuo:
    """One cluster in both packages; ``scan`` runs both fused scans on the
    same inputs and compares every output."""

    def __init__(self, **over):
        self.kw = {**KW, **over}
        self.jcfg = JConfig(**self.kw)
        self.R = self.jcfg.rows
        self.j = jst.init_state(self.jcfg)
        self.t = to_port(self.j)

    def scan(self, staging, counts, halted0=False, alive=None, term=1,
             start=0, member=None):
        R = self.R
        alive = np.ones(R, bool) if alive is None else np.asarray(alive)
        slow = np.zeros(R, bool)
        K = len(counts)
        self.j, ji, jesc, jran, jh = jstep.fused_steady_scan(
            JComm(R), self.jcfg.commit_quorum, self.j, jnp.asarray(staging),
            jnp.int32(start), jnp.asarray(counts, jnp.int32), jnp.int32(K),
            jnp.asarray(halted0, bool), jnp.int32(0), jnp.int32(term),
            jnp.asarray(alive), jnp.asarray(slow), jnp.int32(0),
            jnp.int32(0), None if member is None else jnp.asarray(member))
        self.t, ti, tesc, tran, th = tstep.fused_steady_scan(
            TComm(R), self.jcfg.commit_quorum, self.t,
            torch.from_numpy(staging), start,
            torch.tensor(counts, dtype=torch.int32), K, halted0, 0, term,
            torch.from_numpy(alive), torch.from_numpy(slow), 0, 0,
            None if member is None else torch.from_numpy(member))
        assert_states_equal(self.j, self.t, "fused scan")
        assert_infos_equal(ji, ti, "fused scan")
        for name, a, b in (("escaped", jesc, tesc), ("ran", jran, tran)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
            assert b.dtype == torch.int32, name
        assert th.dtype == torch.bool and bool(th) == bool(np.asarray(jh))
        return tesc.numpy(), tran.numpy(), th

    def surgery(self, row, term):
        self.j = self.j.replace(term=self.j.term.at[row].set(term))
        self.t = to_port(self.j)


def test_scan_mid_escape_is_last_executed_step():
    """A count-0 prefix, then an ingest the lone leader cannot commit: the
    escape fires at step 2 and later steps never run."""
    d = ScanDuo()
    lone = [True, False, False]
    st = staging_of([[], [], payloads(4, 3), payloads(4, 4)], 4, 4)
    esc, ran, halted = d.scan(st, [0, 0, 4, 4], alive=lone)
    assert esc.tolist() == [0, 0, 1, 0] and ran.tolist() == [1, 1, 1, 0]
    assert bool(halted)


def test_scan_higher_term_escapes_at_first_step():
    d = ScanDuo()
    d.surgery(2, 7)
    esc, ran, _ = d.scan(staging_of([payloads(4, 5), payloads(4, 6)], 4, 4),
                         [4, 4])
    assert esc.tolist() == [1, 0] and ran.tolist() == [1, 0]


def test_scan_halted_flag_threads_across_launches():
    """A launch after an unbooked escape runs as a no-op chain, with the
    previous launch's device flag as ``halted0``."""
    d = ScanDuo()
    lone = [True, False, False]
    _, _, halted = d.scan(staging_of([payloads(4, 7)], 4, 4), [4],
                          alive=lone)
    assert bool(halted)
    before = tst.state_to_numpy(d.t)
    _, ran, halted2 = d.scan(staging_of([payloads(4, 8)], 4, 4), [4],
                             halted0=bool(halted), alive=lone)
    assert ran.tolist() == [0] and bool(halted2)
    after = tst.state_to_numpy(d.t)
    for f in before:
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)


def test_scan_clean_window_through_pallas_interpret():
    """A clean window at B = 128, C = 256 (8-byte entries), the JAX
    package's K1 running as its Pallas kernel in interpret mode, started
    at a staging slot past the seam of a 3-slot ring."""
    with pallas_interpret():
        d = ScanDuo(entry_bytes=8, batch_size=128, log_capacity=256)
        rng = np.random.default_rng(11)
        st = rng.integers(-2**31, 2**31, (3, 128, 2), dtype=np.int64)
        st = st.astype(np.int32)
        esc, ran, halted = d.scan(st, [128, 128, 77], start=2)
        assert not esc.any() and ran.tolist() == [1, 1, 1]
        assert not bool(halted)
        assert int(d.t.commit_index[0]) == 128 * 2 + 77


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_scan_under_a_member_mask(packed):
    """Headroom rows outside the configuration (3 voters of 5 rows): the
    quorum counts the voter plane, given as the bool mask or packed with
    a learner (``pack_membership``), whose votes never count."""
    d = ScanDuo(max_replicas=5)
    voters = np.array([True, True, True, False, False])
    member = (tst.pack_membership(voters, np.array([0, 0, 0, 1, 0], bool))
              if packed else voters)
    st = staging_of([payloads(4, s) for s in (30, 31, 32)], 4, 4)
    esc, ran, halted = d.scan(st, [4, 0, 4], member=member,
                              alive=[True, True, False, True, True])
    assert not esc.any() and ran.tolist() == [1, 1, 1]
    assert int(d.t.commit_index[0]) == 8


# ------------------------------------------------------------ StagingRing
def test_staging_ring_equals_jax():
    """One sequence of top_up / stage_tail / consume / reset on both rings:
    the buffers and every counter stay equal."""
    B, W, S = 4, ENTRY // 4, 4
    j, t = JStaging(B, W, S), TStaging(B, W, S, device="cpu")
    queue = [(i + 1, p) for i, p in enumerate(payloads(30, 21))]

    def same():
        for f in ("consumed", "staged", "stage_events", "stage_tail_events"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.available_batches() == j.available_batches()
        assert t.free_slots() == j.free_slots()
        np.testing.assert_array_equal(t.buf.numpy(), np.asarray(j.buf))

    def both(name, *args, **kw):
        got = [getattr(x, name)(*args, **kw) for x in (j, t)]
        assert got[0] == got[1], name
        same()

    both("top_up", queue[:6], ENTRY, max_new=1)
    both("top_up", queue[:13], ENTRY)
    both("consume", 8, 5)
    queue_now = queue[8:13]
    both("stage_tail", queue_now, ENTRY, 4, 1)
    both("top_up", queue[8:30], ENTRY)
    both("consume", 3, 19)                   # mid-batch: nothing available
    both("top_up", queue[11:30], ENTRY)
    both("reset")
    both("top_up", queue[11:30], ENTRY)
    both("consume", 19, 0)                   # the queue emptied: reset


# ---------------------------------------------------- the engines in step
def make_pair(fuse_k, **over):
    kw = {**KW, **over}
    jt, tt = transports(KW)
    jl, tl = [], []
    j = JEngine(JConfig(**kw, fuse_k=fuse_k), jt, trace=jl.append)
    t = TEngine(TConfig(**kw, fuse_k=fuse_k), tt, trace=tl.append)
    return j, t, jl, tl


def set_term(e, row, term):
    """Raise one row's device term with the host mirror blind to it."""
    if isinstance(e.state.term, torch.Tensor):
        terms = e.state.term.clone()
        terms[row] = term
        e.state = e.state.replace(term=terms)
    else:
        e.state = e.state.replace(term=e.state.term.at[row].set(term))


def drive(e, surgery=False, churn=True, n_entries=37, drain_ticks=40):
    """``tests/test_fused_ticks.py``'s ``drive_engine`` schedule, yielding
    after each stage: elect, drain a backlog, idle heartbeats, then (with
    ``churn``) a leader kill, a re-election and a re-drain."""
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(8, seed=1)]
    e.run_until_committed(seqs[-1])
    e.run_for(2 * e.cfg.heartbeat_period)
    yield "warm"
    lead = e.leader_id
    more = [e.submit(p) for p in payloads(n_entries, seed=2)]
    if surgery:
        set_term(e, (lead + 1) % 3, 55)
    e.run_for(drain_ticks * e.cfg.heartbeat_period)
    yield "drain"
    e.run_for(10 * e.cfg.heartbeat_period)
    yield "idle"
    if churn:
        if e.leader_id is not None:
            e.fail(e.leader_id)
        e.run_until_leader()
        e.recover(next(p for p in range(3) if not e.alive[p]))
        tail = [e.submit(p) for p in payloads(9, seed=6)]
        e.run_for(30 * e.cfg.heartbeat_period)
        assert all(e.is_durable(s) for s in tail)
        yield "churn"
    if not surgery:
        assert all(e.is_durable(s) for s in more)


def committed(e):
    mod = tst if isinstance(e.state.term, torch.Tensor) else jst
    return [np.asarray(mod.committed_payloads(e.state, r)).tobytes()
            for r in range(3)]


def fingerprint(e):
    return dict(
        committed=committed(e),
        commit_time=dict(e.commit_time), submit_time=dict(e.submit_time),
        clock=e.clock.now, wm=e.commit_watermark,
        seq_events=e._seq_events, terms=e.terms.tolist(),
        roles=list(e.roles), leader=e.leader_id, heap=sorted(e._q),
        rng=e.rng.getstate(), steady=e._steady, queue=list(e._queue),
        fused=(e.fused_launches, e.fused_ticks),
    )


def assert_engines_equal(j, t, jl, tl, stage):
    fj, ft = fingerprint(j), fingerprint(t)
    for key in fj:
        assert ft[key] == fj[key], f"{stage}: {key}"
    assert tl == jl, f"{stage}: nodelog lines"
    assert_states_equal(j.state, t.state, stage)
    jd, td = j._fused_driver.staging, t._fused_driver.staging
    for f in ("consumed", "staged", "stage_events", "stage_tail_events"):
        assert getattr(td, f) == getattr(jd, f), f"{stage}: staging {f}"


@pytest.mark.parametrize("surgery", [False, True],
                         ids=["drain", "escape"])
def test_fused_engines_in_lock_step(surgery):
    """Both engines at fuse_k = 4 on the same schedule, equal after every
    stage; fusion engaged, and with the device surgery the escape booked
    and the surgery term won."""
    j, t, jl, tl = make_pair(4)
    kw = dict(surgery=surgery, churn=not surgery)
    for sj, st in zip(drive(j, **kw), drive(t, **kw)):
        assert sj == st
        assert_engines_equal(j, t, jl, tl, st)
    assert t.fused_launches > 0 and t.fused_ticks > 0
    if surgery:
        assert max(t.terms.tolist()) >= 55


def test_fused_port_equals_its_tick_at_a_time_run():
    """The port at fuse_k = 4 and at 1: the same committed log, stamps,
    clock, rng-driven heap and nodelog lines (fusion engaged only in
    the first)."""
    _, a, _, al = make_pair(1)
    _, b, _, bl = make_pair(4)
    for _ in zip(drive(a), drive(b)):
        pass
    assert b.fused_launches > 0 and a.fused_launches == 0
    fa, fb = fingerprint(a), fingerprint(b)
    for key in fa:
        if key != "fused":
            assert fb[key] == fa[key], key
    assert bl == al


# ------------------------------------------------------------ the port alone
def tengine(fuse_k, **over):
    cfg = TConfig(**{**KW, **over}, fuse_k=fuse_k)
    return TEngine(cfg, TTransport(cfg, device="cpu"))


def test_staging_realigns_after_tick_path_outruns_ring():
    """With fusion armed but never eligible (steady_dispatch='off' keeps
    the tick path), submits stage until the 4-slot ring fills while ticks
    keep consuming: the next top_up realigns to the queue head."""
    e = tengine(2, steady_dispatch="off")
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(40, seed=11)]
    e.run_for(30 * e.cfg.heartbeat_period)
    assert all(e.is_durable(s) for s in seqs)
    st = e._fused_driver.staging
    assert st.staged * st.B >= st.consumed or st.staged == 0
    more = [e.submit(p) for p in payloads(12, seed=12)]
    e.run_for(10 * e.cfg.heartbeat_period)
    assert all(e.is_durable(s) for s in more)
    assert st.available_batches() >= 0
    assert e.fused_launches == 0


def test_no_fusion_without_horizon():
    """Direct step_event() callers keep the one-tick cadence."""
    e = tengine(4)
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(24, seed=9)]
    while not e.is_durable(seqs[-1]):
        e.step_event()
    assert e.fused_launches == 0


def test_fuse_k_from_the_environment(monkeypatch):
    """RAFT_TPU_FUSE_K overrides the config's fuse_k, and the drain
    fuses."""
    monkeypatch.setenv("RAFT_TPU_FUSE_K", "8")
    e = tengine(1)
    assert e.fuse_k == 8 and e._fused_driver is not None
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(24, seed=13)]
    e.run_for(20 * e.cfg.heartbeat_period)
    assert all(e.is_durable(s) for s in seqs)
    assert e.fused_launches > 0


def test_lease_reads_and_fusion_byte_identity():
    """``TestFusedCompose``: fuse_k > 1 with the lease plane on keeps the
    commit stamps of the unfused run, and a lease read right after the
    fused windows is served with no replication round."""
    def run(fuse_k):
        e = tengine(fuse_k, seed=56, log_capacity=128, prevote=True,
                    read_lease=True)
        e.run_until_leader()
        rng = np.random.default_rng(3)
        seqs = []
        for _ in range(5):
            for _ in range(12):
                seqs.append(e.submit(
                    rng.integers(0, 256, ENTRY, np.uint8).tobytes()))
            e.run_for(20 * e.cfg.heartbeat_period)
        e.run_until_committed(seqs[-1])
        return e

    e1, e8 = run(1), run(8)
    assert e8.fused_ticks > 0, "fusion never engaged"
    assert e1.commit_time == e8.commit_time
    assert e1.commit_watermark == e8.commit_watermark
    calls = [0]
    orig = e8.t.replicate

    def counting(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    e8.t.replicate = counting
    assert e8.read_linearizable() == e8.commit_watermark
    assert calls[0] == 0
