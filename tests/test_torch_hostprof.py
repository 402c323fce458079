"""Host-time attribution in the port (``raft_tpu_torch.obs.hostprof``)
against the JAX package's, and through the port's engine, on the CPU.

- ``HostProfiler`` and ``PumpProfiler`` fed one sequence of marks on a
  scripted clock give the JAX profilers' totals, per-tick splits, mark
  counts, registry series and pump stats;
- through the engine: the phases tile ``step_event``'s wall, the fused
  booking's ``host_post`` per tick is below the tick path's
  (``tests/test_fused_ticks.py`` ``test_host_post_per_tick_drops_under_
  fusion``), and a detached profiler is never synced while an attached
  one is, with the same fetches, launches and committed log either way
  (``tests/test_perf_obs.py``'s sync-counting pin).
"""

import itertools
import time

import numpy as np
import pytest

from raft_tpu.obs import hostprof as jhp
from raft_tpu.obs.registry import MetricsRegistry
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import HostProfiler, PumpProfiler
from raft_tpu_torch.obs import hostprof as thp
from raft_tpu_torch.raft import RaftEngine
from raft_tpu_torch.transport import SingleDeviceTransport

ENTRY = 16


def mk_engine(seed=0, fuse_k=1):
    cfg = RaftConfig(n_replicas=3, entry_bytes=ENTRY, batch_size=4,
                     log_capacity=64, transport="single", seed=seed,
                     fuse_k=fuse_k)
    return RaftEngine(cfg, SingleDeviceTransport(cfg, device="cpu"))


def payloads(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, ENTRY, np.uint8).tobytes()
            for _ in range(n)]


def scripted_clock(monkeypatch):
    """Both modules' ``time.perf_counter`` on one scripted clock: each
    reading advances by a different, known step. Returns its reset (call
    it before each profiler's run, so both read the same sequence)."""
    state = {}

    def reset():
        state["steps"] = itertools.count(1)
        state["now"] = 0.0

    def clock():
        state["now"] += next(state["steps"]) * 1e-6
        return state["now"]

    reset()
    for mod in (jhp, thp):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
    return reset


def test_host_profiler_equals_jax(monkeypatch):
    """The same marks on the same clock: equal totals, mark counts,
    per-tick means, splits and registry series."""
    reset = scripted_clock(monkeypatch)
    jreg, treg = MetricsRegistry(), MetricsRegistry()
    j, t = jhp.HostProfiler(registry=jreg), HostProfiler(registry=treg)
    script = [("mark", "heap_pop"), ("mark", "host_pre"), ("mark", "pack"),
              ("mark", "host_pre"), ("mark", "dispatch"), ("sync",),
              ("end",), ("mark", "host_pre"), ("begin",),
              ("mark", "heap_pop"), ("end",), ("sync",)]
    for p in (j, t):
        reset()
        for _ in range(3):
            p.tick_begin()
            for step in script:
                if step[0] == "mark":
                    p.mark(step[1])
                elif step[0] == "sync":
                    p.sync(np.zeros(3))
                elif step[0] == "begin":
                    p.tick_begin()
                else:
                    p.tick_end()
    assert t.ticks == j.ticks == 6
    assert t.totals() == j.totals()
    assert t.phase_marks == j.phase_marks
    assert t.us_per_tick() == j.us_per_tick()
    assert t.split() == j.split()
    assert treg.snapshot() == jreg.snapshot()
    assert thp.PHASES == jhp.PHASES
    assert thp.HOST_PHASE_BUCKETS == jhp.HOST_PHASE_BUCKETS


def test_pump_profiler_equals_jax(monkeypatch):
    reset = scripted_clock(monkeypatch)
    jreg, treg = MetricsRegistry(), MetricsRegistry()
    j, t = jhp.PumpProfiler(registry=jreg), PumpProfiler(registry=treg)
    for p in (j, t):
        reset()
        p.mark("coalesce")                  # outside a bracket: no-op
        p.iter_end()
        for i in range(5):
            p.iter_begin()
            for ph in ("coalesce", "ingest", "drive", "sweep"):
                p.mark(ph)
            p.observe_batch(1 + 3 * i)
            p.observe_age(2e-5 * (i + 1))
            p.note_read_decode(1e-6 * i)
            p.iter_end()
    assert t.stats() == j.stats()
    assert t.totals() == j.totals()
    assert t.coverage() == j.coverage()
    assert treg.snapshot() == jreg.snapshot()
    assert thp.PUMP_PHASES == jhp.PUMP_PHASES


def test_phases_tile_the_tick():
    """The phase columns sum to the measured ``step_event`` wall."""
    e = mk_engine(5)
    e.hostprof = hp = HostProfiler()
    e.run_until_leader()
    wall, t0n = 0.0, hp.ticks
    for b in range(8):
        seqs = [e.submit(p) for p in payloads(4, seed=20 + b)]
        t0 = time.perf_counter()
        while not e.is_durable(seqs[-1]):
            e.step_event()
        wall += time.perf_counter() - t0
    ticks = hp.ticks - t0n
    assert ticks > 0
    col_sum = sum(hp.totals().values()) / hp.ticks * ticks
    coverage = col_sum / wall
    assert 0.75 < coverage < 1.25, (coverage, hp.us_per_tick())
    assert set(hp.totals()) == set(thp.PHASES)
    host_us, dev_us = hp.split()
    assert host_us > 0 and dev_us > 0


def test_host_post_per_tick_drops_under_fusion():
    """The fused booking's host_post per tick is below the tick path's in
    the same process (one pass per launch against per-entry loops)."""
    def host_post(fuse_k):
        e = mk_engine(fuse_k=fuse_k)
        e.run_until_leader()
        warm = [e.submit(p) for p in payloads(8, seed=3)]
        e.run_for(6 * e.cfg.heartbeat_period)
        assert all(e.is_durable(s) for s in warm)
        e.hostprof = hp = HostProfiler()
        t0 = e._tick_count
        seqs = [e.submit(p) for p in payloads(32, seed=4)]
        e.run_for(20 * e.cfg.heartbeat_period)
        assert all(e.is_durable(s) for s in seqs)
        e.hostprof = None
        ticks = e._tick_count - t0
        return hp.totals().get("host_post", 0.0) / max(ticks, 1), e

    plain_s, _ = host_post(1)
    fused_s, ef = host_post(8)
    assert ef.fused_launches > 0
    assert fused_s < plain_s, (
        f"fused host_post/tick {fused_s * 1e6:.1f}us not below "
        f"tick-at-a-time {plain_s * 1e6:.1f}us")


@pytest.mark.parametrize("fuse_k", [1, 4])
def test_detached_profiler_never_syncs(monkeypatch, fuse_k):
    """Detached: not one profiler sync; attached: syncs, and the same
    fetches, replicate calls and committed log as detached."""
    syncs = [0]
    orig_sync = HostProfiler.sync

    def counting_sync(self, *values):
        syncs[0] += 1
        return orig_sync(self, *values)

    monkeypatch.setattr(HostProfiler, "sync", counting_sync)

    def run(attach):
        e = mk_engine(3, fuse_k=fuse_k)
        if attach:
            e.hostprof = HostProfiler()
        calls = {"fetch": 0, "replicate": 0, "replicate_fused": 0}
        orig_fetch = e._fetch

        def fetch(x):
            calls["fetch"] += 1
            return orig_fetch(x)

        e._fetch = fetch
        for name in ("replicate", "replicate_fused"):
            orig = getattr(e.t, name)

            def counted(*a, _orig=orig, _name=name, **k):
                calls[_name] += 1
                return _orig(*a, **k)

            setattr(e.t, name, counted)
        e.run_until_leader()
        seqs = [e.submit(p) for p in payloads(20, seed=7)]
        e.run_for(16 * e.cfg.heartbeat_period)
        assert all(e.is_durable(s) for s in seqs)
        log = e.committed_entries(1, e.commit_watermark).tobytes()
        return calls, log

    syncs[0] = 0
    off, log_off = run(False)
    assert syncs[0] == 0
    on, log_on = run(True)
    assert syncs[0] > 0
    assert on == off and log_on == log_off
    if fuse_k > 1:
        assert on["replicate_fused"] > 0
