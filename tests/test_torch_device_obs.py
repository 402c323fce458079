"""The port's device plane (``raft_tpu_torch.obs.device``) against the JAX
package's (``raft_tpu.obs.device``): the same seeded inputs through both,
and the rings compared byte for byte.

- the ring primitives: masked append and seq, overflow (including a step
  whose records exceed the capacity, down to capacity 1), the packed flush
  and its decode;
- the recorded steps: the recorded step's state equals the unrecorded
  step's (the general path and K2's plain version), and its ring equals
  the JAX ring; the recorded scan's ``interesting`` mask; the recorded
  fused window;
- both engines with the plane attached, in lock step (``Pair``), the
  packed flush equal after every event on the tick path, the pipelined
  path (scanned, and the flight with both backend hooks open) and at
  ``fuse_k`` 8; decoded events equal the host recorder's nodelog lines;
  overflow, epochs, the bundle and ``--explain``;
- detached, nothing changes: the same device fetches and launch counts as
  a run in a process that never loaded ``obs.device``, and exactly one
  fetch more per launch boundary when attached.

Small shapes (3 replicas, B = 8, C = 128 as ``tests/test_torch_engine``);
the JAX package runs on the CPU, the port with ``device="cpu"``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import step as jstep
from raft_tpu.core.comm import SingleDeviceComm as JComm
from raft_tpu.obs import device as jdev
from raft_tpu.obs.events import FlightRecorder as JRec
from raft_tpu_torch.core import step as tstep
from raft_tpu_torch.core.comm import SingleDeviceComm as TComm
from raft_tpu_torch.obs import device as tdev
from raft_tpu_torch.obs.events import FlightRecorder as TRec
from raft_tpu_torch.core.state import state_to_numpy
from tests._torch_port import assert_states_equal, to_port
from tests.test_torch_engine import KW, Pair, payloads, transports

ROOT = Path(__file__).resolve().parent.parent


def jpacked(ring):
    return np.asarray(jdev.packed_flush(ring))


def tpacked(ring):
    return tdev.packed_flush(ring).cpu().numpy()


def tring(cap):
    return tdev.init_ring(cap, device="cpu")


# --------------------------------------------------------- ring semantics
def test_dev_record_masked_append_and_seq():
    j, t = jdev.init_ring(8), tring(8)
    for cond in (True, False, True):
        j = jdev.dev_record(j, jnp.asarray(cond),
                            jdev.make_rec(1, 2, 3, 2, 4, 5, 6, -1))
        tdev.dev_record(t, cond, tdev.make_rec(1, 2, 3, 2, 4, 5, 6, -1,
                                               t.count))
    assert int(t.count) == 2
    buf = t.buf.numpy()
    assert buf[0, tdev.F_SEQ] == 0 and buf[1, tdev.F_SEQ] == 1
    assert (buf[2:] == 0).all()
    np.testing.assert_array_equal(tpacked(t), jpacked(j))


@pytest.mark.parametrize("cap", [1, 4])
def test_ring_overflow_keeps_seq_monotone_and_reports_dropped(cap):
    j, t = jdev.init_ring(cap), tring(cap)
    for i in range(11):
        j = jdev.dev_record(j, jnp.asarray(True),
                            jdev.make_rec(1, i, 1, 0, 0, 0, i, -1))
        tdev.dev_record(t, True, tdev.make_rec(1, i, 1, 0, 0, 0, i, -1,
                                               t.count))
    packed = tpacked(t)
    np.testing.assert_array_equal(packed, jpacked(j))
    events, count, lost, _, _ = tdev.decode_records(packed, 0)
    assert count == 11 and lost == 11 - cap
    assert [e.seq for e in events] == list(range(11 - cap, 11))
    assert [e.fields["aux"] for e in events] == list(range(11 - cap, 11))
    jev = jdev.decode_records(jpacked(j), 0)[0]
    assert [e.to_jsonable() for e in events] == [e.to_jsonable()
                                                 for e in jev]
    obs = tdev.DeviceObs(capacity=cap)
    obs.ingest(events, total=count, lost=lost,
               counters=np.zeros(5, np.int64))
    assert obs.dropped == 11 - cap and obs.laps == 11 // cap


def _cluster(R=3, B=8, C=128, E=16):
    from raft_tpu.config import RaftConfig as JConfig
    from raft_tpu.core.state import init_state as jinit

    return jinit(JConfig(n_replicas=R, entry_bytes=E, batch_size=B,
                         log_capacity=C), rows=R)


@pytest.mark.parametrize("cap", [1, 2, 64])
def test_vote_and_step_records_past_capacity(cap):
    """An election (one win, three adoptions) and a replicate step whose
    records exceed the capacity leave the JAX ring: later records
    overwrite earlier ones in order, counters and seq exact."""
    js = _cluster()
    ts = to_port(js)
    alive = np.ones(3, bool)
    jr, tr = jdev.init_ring(cap), tring(cap)
    js, jv, jr = jstep.vote_step(JComm(3), js, jnp.int32(1), jnp.int32(4),
                                 jnp.asarray(alive), ring=jr, record=True,
                                 quorum=1)
    ts, tv, tr = tstep.vote_step(TComm(3), ts, 1, 4, torch.from_numpy(alive),
                                 ring=tr, record=True, quorum=1)
    assert_states_equal(js, ts, "vote")
    np.testing.assert_array_equal(tpacked(tr), jpacked(jr))
    # a stale leader's step: the rows it reaches do not adopt, max_term
    # reports the step-down evidence
    pay = np.zeros((8, 3 * 4), np.int32)
    js2, ji, jr = jstep.replicate_step(
        JComm(3), js, jnp.asarray(pay), jnp.int32(8), jnp.int32(0),
        jnp.int32(2), jnp.asarray(alive), jnp.zeros(3, bool), ec=False,
        commit_quorum=2, repair=True, ring=jr, record=True)
    ts2, ti, tr = tstep.replicate_step(
        TComm(3), ts, torch.from_numpy(pay), 8, 0, 2,
        torch.from_numpy(alive), torch.zeros(3, dtype=torch.bool),
        commit_quorum=2, repair=True, ring=tr, record=True)
    assert_states_equal(js2, ts2, "step")
    np.testing.assert_array_equal(tpacked(tr), jpacked(jr))


# ----------------------------------------------- recorded state identity
def _batch(B, E, R, seed):
    from raft_tpu_torch.core.state import fold_batch

    data = np.random.default_rng(seed).integers(0, 256, (B, E), np.uint8)
    return fold_batch(data, R, B, device="cpu")


@pytest.mark.parametrize("steady", [False, True], ids=["general", "k2"])
def test_recorded_step_state_outputs_bit_identical(steady):
    """The recorded step's state and info equal the unrecorded step's bit
    for bit (on the general path, and on K2's plain version, which writes
    the small leaves in place), and its ring equals the JAX ring."""
    R, B, C, E = 3, 128, 256, 16
    js = _cluster(R, B, C, E)
    alive = np.ones(R, bool)
    jr = jdev.init_ring(64)
    js, _, jr = jstep.vote_step(JComm(R), js, jnp.int32(0), jnp.int32(1),
                                jnp.asarray(alive), ring=jr, record=True,
                                quorum=1)
    tr = tring(64)
    for t, a in zip(tr.tensors(), (jr.buf, jr.count, jr.tick, jr.counters)):
        t.copy_(torch.from_numpy(np.array(a)))
    kw = dict(commit_quorum=2, repair=not steady,
              term_floor=1 if steady else None)
    outs = []
    for rec in (False, True):
        ts = to_port(js)
        for i in range(3):
            extra = dict(ring=tr, record=True) if rec else {}
            out = tstep.replicate_step(
                TComm(R), ts, _batch(B, E, R, i), B - i, 0, 1,
                torch.from_numpy(alive), torch.zeros(R, dtype=torch.bool),
                **kw, **extra)
            ts, info = out[:2]
        outs.append((state_to_numpy(ts), info))
    (a, ia), (b, ib) = outs
    for f in a:
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    for f in ia._fields:
        assert torch.equal(getattr(ia, f), getattr(ib, f)), f
    for i in range(3):
        pay = jnp.asarray(_batch(B, E, R, i).numpy())
        js, _, jr = jstep.replicate_step(
            JComm(R), js, pay, jnp.int32(B - i), jnp.int32(0), jnp.int32(1),
            jnp.asarray(alive), jnp.zeros(R, bool), ec=False,
            commit_quorum=2, repair=not steady, ring=jr, record=True)
    for f in b:
        np.testing.assert_array_equal(b[f], np.asarray(getattr(js, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tpacked(tr), jpacked(jr))
    assert int(tr.count) > 1


def test_scan_interesting_mask_flags_eventful_steps():
    R, B = 3, 8
    js = _cluster(R, B)
    alive = np.ones(R, bool)
    jr = jdev.init_ring(256)
    js, _, jr = jstep.vote_step(JComm(R), js, jnp.int32(0), jnp.int32(1),
                                jnp.asarray(alive), ring=jr, record=True,
                                quorum=1)
    tr = tring(256)
    ts = to_port(js)
    for t, a in zip(tr.tensors(), (jr.buf, jr.count, jr.tick, jr.counters)):
        t.copy_(torch.from_numpy(np.array(a)))
    batch = _batch(B, 16, R, 5).numpy()
    T = 5
    pays = np.stack([batch] + [np.zeros_like(batch)] * (T - 1))
    counts = np.array([B] + [0] * (T - 1), np.int32)
    js, jinfos, jr, jint = jstep.scan_replicate(
        JComm(R), False, 2, True, js, jnp.asarray(pays), jnp.asarray(counts),
        jnp.int32(0), jnp.int32(1), jnp.asarray(alive), jnp.zeros(R, bool),
        ring=jr, record=True)
    ts, tinfos, tr, tint = tstep.scan_replicate(
        TComm(R), False, 2, True, ts, torch.from_numpy(pays),
        torch.from_numpy(counts), 0, 1, torch.from_numpy(alive),
        torch.zeros(R, dtype=torch.bool), ring=tr, record=True)
    got = tint.tolist()
    assert got == np.asarray(jint).tolist()
    assert got[0] == 1 and got[2:] == [0] * (T - 2)
    assert_states_equal(js, ts, "scan")
    np.testing.assert_array_equal(tpacked(tr), jpacked(jr))


def test_recorded_fused_window_equals_jax():
    """``fused_steady_scan(record=True)``: every tick, the masked tail too,
    advances ``tick``; masked ticks record nothing; the ring equals the
    JAX ring and the state the unrecorded window's."""
    R, B, C, E = 3, 8, 128, 16
    W = E // 4
    js = _cluster(R, B, C, E)
    alive = np.ones(R, bool)
    js, _ = jstep.vote_step(JComm(R), js, jnp.int32(0), jnp.int32(1),
                            jnp.asarray(alive))
    rng = np.random.default_rng(9)
    staging = rng.integers(-2**31, 2**31 - 1, (4, B, W), dtype=np.int64
                           ).astype(np.int32)
    counts = np.array([B, B, 3, B], np.int32)
    jr = jdev.init_ring(16)
    jout = jstep.fused_steady_scan(
        JComm(R), 2, js, jnp.asarray(staging), 1, jnp.asarray(counts), 3,
        False, 0, 1, jnp.asarray(alive), jnp.zeros(R, bool), ring=jr,
        record=True)
    tr = tring(16)
    tout = tstep.fused_steady_scan(
        TComm(R), 2, to_port(js), torch.from_numpy(staging), 1,
        torch.from_numpy(counts), 3, False, 0, 1, torch.from_numpy(alive),
        torch.zeros(R, dtype=torch.bool), ring=tr, record=True)
    plain = tstep.fused_steady_scan(
        TComm(R), 2, to_port(js), torch.from_numpy(staging), 1,
        torch.from_numpy(counts), 3, False, 0, 1, torch.from_numpy(alive),
        torch.zeros(R, dtype=torch.bool))
    assert len(tout) == 6 and len(plain) == 5
    assert_states_equal(jout[0], tout[0], "fused")
    assert_states_equal(jout[0], plain[0], "unrecorded")
    for a, b in zip(jout[2:5], tout[2:5]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    np.testing.assert_array_equal(tpacked(tr), jpacked(jout[5]))
    assert int(tr.tick) == 4


# ---------------------------------------------- engines in lock step
class DevPair(Pair):
    """A ``Pair`` with the device plane attached to both engines, the
    packed flushes compared after every event."""

    def __init__(self, seed=0, capacity=1024, **over):
        self.dev = None
        super().__init__(seed, recorders=(JRec(), TRec()), **over)
        self.dev = (self.j.attach_device_obs(capacity=capacity),
                    self.t.attach_device_obs(capacity=capacity))
        self.check()

    def check(self):
        super().check()
        if self.dev is None:
            return
        assert (self.t._dev_ring is None) == (self.j._dev_ring is None)
        if self.t._dev_ring is not None:
            np.testing.assert_array_equal(tpacked(self.t._dev_ring),
                                          jpacked(self.j._dev_ring))
        jd, td = self.dev
        assert td.to_jsonable() == jd.to_jsonable()

    def host_lines(self, e):
        return [ev.nodelog() for ev in e.recorder.events()
                if ev.kind in ("elect", "commit")]


def test_tick_path_lock_step_and_nodelog_twins():
    p = DevPair(31)
    lead = p.until_leader()
    for k in range(3):
        seqs = p.submit(payloads(8, 40 + k))
        p.until_committed(seqs[-1])
    p.both("set_slow", (lead + 1) % 3, True)
    p.submit(payloads(30, 44))
    p.run_for(5.0)
    p.both("set_slow", (lead + 1) % 3, False)
    p.run_for(10.0)
    p.check_all()
    jd, td = p.dev
    assert td.nodelog_lines() == p.host_lines(p.t) == p.host_lines(p.j)
    assert td.counters["raft_device_elections_total"]["0"] == 1
    assert td.counters["raft_device_commits_total"]["0"] == \
        p.t.commit_watermark
    assert td.counters["raft_device_repair_rounds_total"]["0"] > 0
    merged = tdev.merged_timeline(p.t.recorder, td)
    assert len(merged) == len(p.t.recorder.events()) + len(td.events)
    assert all(a.t_virtual <= b.t_virtual for a, b in zip(merged,
                                                          merged[1:]))


def test_failover_lock_step_with_step_down_and_adoptions():
    p = DevPair(32)
    lead = p.until_leader()
    seqs = p.submit(payloads(20, 50))
    p.until_committed(seqs[-1])
    p.both("fail", lead)
    p.until_leader()
    p.submit(payloads(10, 51))
    p.both("recover", lead)
    p.run_for(20.0)
    p.check_all()
    td = p.dev[1]
    assert td.of_kind("term_adopt")
    assert td.nodelog_lines() == p.host_lines(p.t)


def test_pipelined_chunks_scanned_lock_step():
    """``submit_pipelined`` off the card (a ``replicate_many`` scan per
    chunk): one device commit event per chunk, equal to the host line."""
    p = DevPair(33)
    p.until_leader()
    ps = payloads(128 + 40, 33)
    seqs = p.both("submit_pipelined", ps)
    p.run_for(4.0)
    p.check_all()
    assert all(p.t.is_durable(s) for s in seqs)
    td = p.dev[1]
    assert td.nodelog_lines() == p.host_lines(p.t)
    assert td.counters["raft_device_commits_total"]["0"] == len(ps)


def test_pipelined_flight_lock_step(monkeypatch):
    """A whole-ring flight (the JAX side's K3/K4 in Pallas interpret mode,
    the port's plain versions) recorded at chunk granularity."""
    import raft_tpu.raft.engine as jengine
    import raft_tpu_torch.raft.engine as tengine
    from tests._torch_port import pallas_interpret

    monkeypatch.setattr(jengine, "_pipeline_backend_ok", lambda: True)
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)
    p = DevPair(9, entry_bytes=8, batch_size=128, log_capacity=1024)
    p.until_leader()
    warm = p.submit(payloads(128, 10, entry=8))
    p.until_committed(warm[-1])
    p.run_for(4.0)
    with pallas_interpret():
        seqs = p.both("submit_pipelined", payloads(1024, 11, entry=8))
    p.run_for(4.0)
    p.check_all()
    assert all(p.t.is_durable(s) for s in seqs)
    td = p.dev[1]
    assert td.nodelog_lines() == p.host_lines(p.t)
    assert td.counters["raft_device_heartbeat_ticks_total"]["0"] > 8


def test_fused_k8_lock_step():
    """Both engines at ``fuse_k`` 8: the recorded windows' flushes, once
    per launch boundary, equal the JAX engine's after every event."""
    p = DevPair(34, fuse_k=8)
    p.until_leader()
    seqs = p.submit(payloads(8, 60))
    p.until_committed(seqs[-1])
    p.both("run_for", 2.0)
    seqs = p.submit(payloads(150, 61))
    period = p.t.cfg.heartbeat_period
    for _ in range(40):              # the engines' own run_for fuses
        p.both("run_for", 4 * period)
    p.check_all()
    assert p.t.fused_launches > 0
    assert all(p.t.is_durable(s) for s in seqs)
    assert p.dev[1].nodelog_lines() == p.host_lines(p.t)


def test_engine_ring_overflow_reports_dropped_keeps_decoding():
    p = DevPair(35, capacity=2)
    p.until_leader()
    seqs = p.submit(payloads(8, 70))
    p.until_committed(seqs[-1])
    td = p.dev[1]
    assert td.dropped >= 1 and td.laps >= 1
    seen = [ev.seq for ev in td.events]
    assert seen == sorted(seen)
    host = [ev.nodelog() for ev in p.t.recorder.events(kind="commit")]
    assert [ev.nodelog() for ev in td.events if ev.kind == "commit"] == host


def test_device_obs_accumulates_across_engine_epochs():
    obs = [None, None]
    totals = []
    for gen in range(2):
        p = Pair(36 + gen, recorders=(JRec(), TRec()))
        for i, e in enumerate((p.j, p.t)):
            obs[i] = e.attach_device_obs(obs[i])
        p.until_leader()
        seqs = p.submit(payloads(16, 80 + gen))
        p.until_committed(seqs[-1])
        assert obs[1].to_jsonable() == obs[0].to_jsonable()
        totals.append(obs[1].total_recorded)
    assert totals[1] > totals[0] > 0
    assert obs[1].counters["raft_device_commits_total"]["0"] == 32
    seen = [ev.seq for ev in obs[1].events]
    assert seen == sorted(seen) and len(set(seen)) == len(seen)


def test_detach_returns_to_the_unrecorded_launches():
    p = DevPair(37)
    p.until_leader()
    for e in (p.j, p.t):
        e.detach_device_obs()
    assert p.t._dev_ring is None
    seqs = p.submit(payloads(8, 90))
    p.until_committed(seqs[-1])
    p.check_all()


# ------------------------------------------------------------ forensics
def test_bundle_carries_device_ring_and_explain_interleaves(tmp_path, capsys):
    from raft_tpu.obs.__main__ import main as jmain
    from raft_tpu_torch.obs import load_bundle
    from raft_tpu_torch.obs.__main__ import main as tmain
    from raft_tpu_torch.obs.forensics import ObsStack, explain, write_bundle
    from raft_tpu_torch.raft import RaftEngine

    obs = ObsStack.build(device=True)
    cfg = transports(KW)[1].cfg
    e = RaftEngine(cfg, transports(KW)[1], recorder=obs.recorder)
    obs.attach(e)
    assert e.device_obs is obs.device
    e.run_until_leader()
    s = e.submit(b"\x01" * cfg.entry_bytes)
    e.run_until_committed(s)
    path = write_bundle(str(tmp_path), kind="torture", seed=99,
                        expected="LINEARIZABLE", verdict="VIOLATION",
                        repro="x", obs=obs)
    bundle = load_bundle(path)
    dr = bundle["device_ring"]
    assert dr is not None and dr["events"]
    assert dr["counters"]["raft_device_elections_total"]["0"] == 1
    text = explain(bundle)
    assert "device ring:" in text
    assert "[device] elect" in text or "[device] commit" in text
    json.dumps(bundle)
    outs = []
    for main in (jmain, tmain):
        assert main(["--explain", path]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and "[device]" in outs[1]


# ------------------------------------------------- detached costs nothing
_DETACHED_RUN = r"""
import json, sys
sys.path.insert(0, {root!r})
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core import ring_cuda, step_cuda
from raft_tpu_torch.raft import RaftEngine
from raft_tpu_torch.transport import SingleDeviceTransport
import numpy as np
kw = {kw!r}
cfg = RaftConfig(**kw, seed=38)
e = RaftEngine(cfg, SingleDeviceTransport(cfg, device="cpu"))
n = [0]
orig = e._fetch
def fetch(x):
    n[0] += 1
    return orig(x)
e._fetch = fetch
rng = np.random.default_rng(38)
e.run_until_leader()
seqs = [e.submit(rng.integers(0, 256, cfg.entry_bytes, np.uint8).tobytes())
        for _ in range(40)]
e.run_until_committed(seqs[-1])
e.submit_pipelined([bytes(cfg.entry_bytes)] * 50)
e.run_for(5.0)
print(json.dumps(dict(
    fetches=n[0], wm=e.commit_watermark,
    launches=dict(ring_cuda.LAUNCHES) | dict(step_cuda.LAUNCHES),
    loaded="raft_tpu_torch.obs.device" in sys.modules)))
"""


def _drive_counted(attach):
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport import SingleDeviceTransport

    cfg = RaftConfig(**KW, seed=38)
    e = RaftEngine(cfg, SingleDeviceTransport(cfg, device="cpu"))
    n = [0]
    orig = e._fetch

    def fetch(x):
        n[0] += 1
        return orig(x)

    e._fetch = fetch
    flushes = [0]
    if attach:
        e.attach_device_obs()
        inner = e._flush_device_obs

        def flush():
            flushes[0] += 1
            inner()

        e._flush_device_obs = flush
    rng = np.random.default_rng(38)
    e.run_until_leader()
    seqs = [e.submit(rng.integers(0, 256, e.cfg.entry_bytes,
                                  np.uint8).tobytes()) for _ in range(40)]
    e.run_until_committed(seqs[-1])
    e.submit_pipelined([bytes(e.cfg.entry_bytes)] * 50)
    e.run_for(5.0)
    return n[0], flushes[0], e.commit_watermark


def test_detached_fetches_and_launches_equal_a_run_without_the_module():
    """A detached engine makes the same device fetches and launches as in
    a process that never loaded ``obs.device``; attached, it makes
    exactly one more fetch per launch boundary."""
    from raft_tpu_torch.core import ring_cuda, step_cuda

    code = _DETACHED_RUN.format(root=str(ROOT), kw=KW)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    fresh = json.loads(r.stdout.strip().splitlines()[-1])
    assert fresh["loaded"] is False
    before = dict(ring_cuda.LAUNCHES) | dict(step_cuda.LAUNCHES)
    fetches, _, wm = _drive_counted(attach=False)
    after = dict(ring_cuda.LAUNCHES) | dict(step_cuda.LAUNCHES)
    assert (fetches, wm) == (fresh["fetches"], fresh["wm"])
    assert {k: after[k] - before[k] for k in after} == fresh["launches"]
    att_fetches, flushes, att_wm = _drive_counted(attach=True)
    assert att_wm == wm and flushes > 0
    assert att_fetches == fetches + flushes
