"""The port's multi-Raft observability against the JAX package's:

- the recorded group programs (``core.step`` ``group_vote_step`` /
  ``group_replicate_step`` / ``fused_group_scan`` with ``record=True`` over
  ``obs.device.init_group_rings``) fed the same inputs as the JAX ones:
  the packed group rings byte for byte after every call (capacity 1 and
  64), the decoded events and counters, and every state leaf equal to
  the unrecorded programs';
- both ``MultiEngine``s with the device plane attached, in lock step: the
  packed flush after every event, on the tick path and at ``fuse_k`` 8;
  the decoded elect/commit lines equal the host recorder's (JAX
  ``tests/test_device_obs.py``
  ``test_decoded_device_events_match_host_nodelog_multi``);
- the host plane on the group engine: the group-tagged rendering and the
  Router's shed span (``test_obs_plane.py``), the per-group host-phase
  series (``test_perf_obs.py``), the ops server over a multi-engine run
  and the Router's breaker section (``test_serve.py``), the per-group
  tier (``test_tiered.py`` ``TestMultiTiered``), and ``ShardedKV``.

Small shapes; the port runs on the CPU (``device="cpu"``).
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.core import step as jstep
from raft_tpu.examples.kv_sharded import ShardedKV as JShardedKV
from raft_tpu.multi import MultiEngine as JMulti
from raft_tpu.multi import Router as JRouter
from raft_tpu.obs import audit as jaudit
from raft_tpu.obs import device as jdev
from raft_tpu.obs import events as jevents
from raft_tpu.obs import hostprof as jhostprof
from raft_tpu.obs import registry as jregistry
from raft_tpu.obs import serve as jserve
from raft_tpu.obs import slo as jslo
from raft_tpu.obs import spans as jspans
from raft_tpu.obs import trace as jtrace
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core import state as tst
from raft_tpu_torch.core import step as tstep
from raft_tpu_torch.examples.kv_sharded import ShardedKV
from raft_tpu_torch.multi import MultiEngine, Router
from raft_tpu_torch.obs import audit as taudit
from raft_tpu_torch.obs import device as tdev
from raft_tpu_torch.obs import events as tevents
from raft_tpu_torch.obs import hostprof as thostprof
from raft_tpu_torch.obs import registry as tregistry
from raft_tpu_torch.obs import serve as tserve
from raft_tpu_torch.obs import slo as tslo
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.obs import trace as ttrace
from tests._torch_port import (
    assert_infos_equal,
    assert_states_equal,
    pallas_interpret,
)
from tests.test_torch_multi import MPair, payloads

# ------------------------------------------------- recorded group programs
G, R, B, C = 3, 3, 4, 16
KW = dict(n_replicas=R, entry_bytes=8, batch_size=B, log_capacity=C)
W = 2
ALL = np.ones((G, R), bool)
NONE = np.zeros((G, R), bool)

J_REC = dict(rep=jax.jit(jstep.group_replicate_step(R, record=True)),
             vote=jax.jit(jstep.group_vote_step(R, record=True)),
             fused=jax.jit(jstep.fused_group_scan(R, record=True)))
T_REC = dict(rep=tstep.group_replicate_step(R, record=True),
             vote=tstep.group_vote_step(R, record=True),
             fused=tstep.fused_group_scan(R, record=True))
T_PLAIN = dict(rep=tstep.group_replicate_step(R),
               vote=tstep.group_vote_step(R),
               fused=tstep.fused_group_scan(R))


def _t(a):
    return torch.from_numpy(np.array(a))


class RecordedGroups:
    """G groups held three times — the JAX recorded programs, the port's
    recorded programs and the port's unrecorded ones — stepped in lock
    step: states, infos and (recorded) rings compared after every call."""

    def __init__(self, capacity):
        self.j = jst.init_group_state(JConfig(**KW), G)
        self.t = tst.init_group_state(TConfig(**KW), G, device="cpu")
        self.p = tst.init_group_state(TConfig(**KW), G, device="cpu")
        self.jr = jdev.init_group_rings(capacity, G)
        self.tr = tdev.init_group_rings(capacity, G, device="cpu")
        self.jg = jnp.arange(G, dtype=jnp.int32)
        self.tg = torch.arange(G, dtype=torch.int32)

    def call(self, kind, *args):
        with pallas_interpret():
            self.j, *jout = J_REC[kind](self.j, *map(jnp.asarray, args),
                                        self.jr, self.jg)
        self.jr = jout.pop()
        self.t, *tout = T_REC[kind](self.t, *map(_t, args), self.tr,
                                    self.tg)
        assert tout.pop() is self.tr          # updated in place
        self.p, *pout = T_PLAIN[kind](self.p, *map(_t, args))
        assert_states_equal(self.j, self.t, kind)
        for f in ("term", "voted_for", "last_index", "commit_index",
                  "match_index", "match_term", "log_term", "log_payload"):
            assert torch.equal(getattr(self.t, f), getattr(self.p, f)), \
                f"{kind}: recorded state.{f} differs from unrecorded"
        assert_infos_equal(jout[0], tout[0], kind)
        for a, b, c in zip(jout[1:], tout[1:], pout[1:]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert torch.equal(b, c)
        self.check_rings()
        return tout

    def check_rings(self):
        jp = np.asarray(jdev.packed_flush(self.jr))
        tp = tdev.packed_flush(self.tr).numpy()
        assert tp.shape == jp.shape == (G, self.tr.capacity + 1, tdev.REC_W)
        np.testing.assert_array_equal(tp, jp, err_msg="packed group rings")
        for g in range(G):
            je, jc, jl, jctr, jt = jdev.decode_records(jp[g], 0, 1.5)
            te, tc, tl, tctr, tt = tdev.decode_records(tp[g], 0, 1.5)
            assert [e.to_jsonable() for e in te] == \
                [e.to_jsonable() for e in je]
            assert (tc, tl, tt) == (jc, jl, jt)
            np.testing.assert_array_equal(tctr, jctr)
            assert all(e.group == g for e in te)


def _pays(seed, counts):
    rng = np.random.default_rng(seed)
    out = rng.integers(-2**31, 2**31 - 1, (G, B, W), dtype=np.int64)
    out[np.arange(B)[None, :] >= np.asarray(counts)[:, None]] = 0
    return np.tile(out.astype(np.int32), (1, 1, R))


@pytest.mark.parametrize("capacity", [1, 64])
def test_recorded_group_programs_match_jax(capacity):
    """Elections (one group masked), ingest, a slow and a dead row healed
    by the repair window, a higher-term leader deposing another (term
    adoptions, step-down evidence), a masked group, and fused windows
    with an escape and ``halted0``: rings byte for byte, the recorded
    states equal to the unrecorded ones."""
    rg = RecordedGroups(capacity)
    live = ALL.copy()
    live[2] = False
    vi = rg.call("vote", np.int32([0, 1, 0]), np.int32([1, 1, 0]), live)
    assert vi[0].votes.tolist()[:2] == [R, R]
    leaders, terms = np.int32([0, 1, 0]), np.int32([1, 1, 0])
    slow = NONE.copy()
    slow[0, 2] = True
    dead = live.copy()
    dead[1, 0 if leaders[1] != 0 else 2] = False
    for i in range(3):
        rg.call("rep", _pays(i, [B, B - 1, 0]), np.int32([B, B - 1, 0]),
                leaders, terms, dead, slow, ALL)
    for i in range(3):                  # heal: heartbeat ticks
        rg.call("rep", _pays(10 + i, [0, 0, 0]), np.int32([0, 0, 0]),
                leaders, terms, live, NONE, ALL)
    # group 2 elects in term 3; group 0's row 1 campaigns in term 2
    rg.call("vote", np.int32([1, 0, 2]), np.int32([2, 0, 3]),
            np.array([[True, True, True], [False] * 3, [True] * 3]))
    # the stale term-1 leader of group 0 ticks: step-down evidence
    rg.call("rep", _pays(20, [2, 1, 1]), np.int32([2, 1, 1]),
            np.int32([0, 1, 2]), np.int32([1, 1, 3]), ALL, NONE, ALL)
    # fused: group 0 (stale) escapes at once, the others run K ticks
    K = 4
    pays = np.random.default_rng(30).integers(
        -2**31, 2**31 - 1, (K, G, B, W)).astype(np.int32)
    counts = np.full((K, G), B, np.int32)
    _, _, _, halted = rg.call(
        "fused", pays, counts, np.int32(K), np.zeros(G, bool),
        np.int32([0, 1, 2]), np.int32([1, 1, 3]), ALL, NONE, ALL)
    assert halted.tolist() == [True, False, False]
    rg.call("fused", pays, counts, np.int32(2), halted.numpy(),
            np.int32([0, 1, 2]), np.int32([1, 1, 3]), ALL, NONE, ALL)
    if capacity == 1:        # every group's ring has lapped
        assert (tdev.packed_flush(rg.tr).numpy()[:, -1, 0] > 1).all()


# ------------------------------------------------- engines with the ring
class DevMPair(MPair):
    """Both group engines with the device plane attached: the packed
    group rings equal after every event."""

    def __init__(self, G, capacity=512, **over):
        super().__init__(G, recorders=(jevents.FlightRecorder(),
                                       tevents.FlightRecorder()), **over)
        self.j.metrics = jregistry.MetricsRegistry()
        self.t.metrics = tregistry.MetricsRegistry()
        self.jdev = self.j.attach_device_obs(capacity=capacity)
        self.tdev = self.t.attach_device_obs(capacity=capacity)
        self.check()

    def check(self):
        super().check()
        if getattr(self, "tdev", None) is None:
            return
        np.testing.assert_array_equal(
            tdev.packed_flush(self.t._dev_rings).numpy(),
            np.asarray(jdev.packed_flush(self.j._dev_rings)))
        assert [e.to_jsonable() for e in self.tdev.events] == \
            [e.to_jsonable() for e in self.jdev.events]
        assert self.tdev.counters == self.jdev.counters
        assert (self.tdev.dropped, self.tdev.total_recorded) == \
            (self.jdev.dropped, self.jdev.total_recorded)

    def check_all(self):
        super().check_all()
        assert self.t.metrics.to_prometheus() == \
            self.j.metrics.to_prometheus()
        assert self.t.recorder.to_jsonable() == self.j.recorder.to_jsonable()


def test_decoded_device_events_match_host_nodelog_multi():
    p = DevMPair(3, entry_bytes=32, batch_size=4, log_capacity=64, seed=0)
    rng = np.random.default_rng(3)
    for g in range(3):
        p.until_leader(g)
        for _ in range(2):
            s = p.both("submit", g, rng.integers(0, 256, 32,
                                                 np.uint8).tobytes())
            p.until_committed(g, s)
    for g in range(3):
        host = [ev.nodelog() for ev in p.t.recorder.events(group=g)
                if ev.kind in ("elect", "commit")]
        devl = [ev.nodelog() for ev in p.tdev.events
                if ev.group == g and ev.msg is not None]
        assert host and devl == host, f"group {g} drifted"
    snap = p.t.metrics.snapshot()
    elect = {s["labels"]["group"]: s["value"]
             for s in snap["raft_device_elections_total"]["series"]}
    assert elect == {"0": 1.0, "1": 1.0, "2": 1.0}
    p.check_all()


@pytest.mark.parametrize("capacity", [4, 512])
def test_fused_windows_record_as_jax(capacity):
    """``fuse_k`` 8 with the device plane: the recorded fused window (and
    the recorded ticks around it) leave equal rings, a lapping ring
    included, and the same committed state as the tick path."""
    p = DevMPair(3, capacity=capacity, entry_bytes=32, batch_size=8,
                 log_capacity=128, seed=9, fuse_k=8, apply=True)
    p.both("seed_leaders")
    rng = np.random.default_rng(5)
    for g in range(3):
        for _ in range(24 + 8 * g):
            p.both("submit", g, rng.integers(0, 256, 32, np.uint8).tobytes())
    p.run_for(24 * p.t.cfg.heartbeat_period)
    assert p.t.fused_launches > 0
    p.check_all()


# ------------------------------------------------- the host plane
def test_multi_engine_rendering_byte_identical():
    """The group-tagged schema renders identically in both packages, the
    recorder's lines equal the trace, and events carry the group."""
    out = []
    for M, trace, events, extra in (
            (JMulti, jtrace, jevents, {}),
            (MultiEngine, ttrace, tevents, {"device": "cpu"})):
        cfg = (JConfig if M is JMulti else TConfig)(
            n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=64,
            transport="single", seed=2)
        tr, rec = trace.TraceRecorder(), events.FlightRecorder()
        e = M(cfg, 2, trace=tr, recorder=rec, **extra)
        e.seed_leaders()
        seqs = [e.submit_to_leader(g, payloads(1, seed=g, entry=32)[0])
                for g in range(2)]
        for g, seq in enumerate(seqs):
            e.run_until_committed(g, seq)
        assert tr.lines and rec.nodelog_lines() == tr.lines
        assert all(ev.group in (0, 1) for ev in rec.events())
        out.append((tr.lines, rec.to_jsonable()))
    assert out[0] == out[1]


def test_multi_router_shed_records_reason_on_span():
    """A MultiEngine depth refusal has no engine-side span hook: the
    Router records the reason on the span, in both packages alike."""
    got = []
    for M, spans, R_, extra in (
            (JMulti, jspans, JRouter, {}),
            (MultiEngine, tspans, Router, {"device": "cpu"})):
        cfg = (JConfig if M is JMulti else TConfig)(
            n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=64,
            transport="single", seed=1, admission_max_writes=1)
        me = M(cfg, 1, **extra)
        me.seed_leaders()
        sp = spans.SpanTracker()
        router = R_(me, max_retries=0, spans=sp)
        me.submit(0, payloads(1, seed=1, entry=32)[0])
        span = sp.begin("write", me.clock.now, client=1, key=b"k")
        sp.current = span
        with pytest.raises(Exception) as ei:
            router.submit(b"k", payloads(1, seed=2, entry=32)[0])
        sp.current = None
        assert type(ei.value).__name__ == "Overloaded"
        assert "depth" in span.refusal_reasons
        got.append((span.refusal_reasons, span.annotations))
    assert got[0] == got[1]


def test_multi_engine_per_group_series_round_trip():
    """The host-phase histogram carries per-group labels in the port too,
    with the same series (label sets and counts) as JAX's, and the
    exposition round-trips."""
    seen = []
    for M, registry, hostprof, extra in (
            (JMulti, jregistry, jhostprof, {}),
            (MultiEngine, tregistry, thostprof, {"device": "cpu"})):
        cfg = (JConfig if M is JMulti else TConfig)(
            n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=64,
            transport="single", seed=2)
        me = M(cfg, 2, **extra)
        me.metrics = registry.MetricsRegistry()
        me.hostprof = hostprof.HostProfiler(registry=me.metrics)
        me.seed_leaders()
        seqs = [me.submit_to_leader(g, payloads(1, seed=g, entry=32)[0])
                for g in range(2)]
        for g, seq in enumerate(seqs):
            me.run_until_committed(g, seq)
        series = me.metrics.snapshot()["raft_host_phase_seconds"]["series"]
        assert {s["labels"]["group"] for s in series} == {"0", "1"}
        parsed = registry.parse_prometheus(me.metrics.to_prometheus())
        counts = parsed["raft_host_phase_seconds_count"]
        for s in series:
            assert counts[tuple(sorted(s["labels"].items()))] == s["count"]
        seen.append(sorted((tuple(sorted(s["labels"].items())), s["count"])
                           for s in series))
    assert seen[0] == seen[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.status, resp.read().decode()


def test_serve_smoke_multiengine_traffic():
    """The ops server over a port MultiEngine run with the full online
    plane (recorder, metrics, auditor, SLO, status board), scraped
    mid-run and after; every artifact equals the JAX engine's."""
    arts = []
    for M, cfgc, events, registry, audit, slo, serve, extra in (
            (JMulti, JConfig, jevents, jregistry, jaudit, jslo, jserve, {}),
            (MultiEngine, TConfig, tevents, tregistry, taudit, tslo, tserve,
             {"device": "cpu"})):
        cfg = cfgc(n_replicas=3, entry_bytes=32, batch_size=4,
                   log_capacity=128, transport="single")
        Gn = 3
        eng = M(cfg, Gn, recorder=events.FlightRecorder(), **extra)
        eng.metrics = registry.MetricsRegistry()
        eng.auditor = audit.SafetyAuditor(recorder=eng.recorder,
                                          registry=eng.metrics)
        eng.slo = slo.SloTracker(
            objectives=(slo.SLObjective(
                "commit_fast", "commit",
                threshold_s=2 * cfg.heartbeat_period),),
            recorder=eng.recorder, registry=eng.metrics)
        board = serve.StatusBoard()
        eng.status_board = board
        eng.seed_leaders()
        with serve.OpsServer(board=board, registry=eng.metrics,
                             slo=eng.slo, auditor=eng.auditor,
                             port=0) as srv:
            submitted = []
            for round_no in range(6):
                for g in range(Gn):
                    if eng.leader_id[g] is None:
                        continue
                    submitted.append((g, eng.submit(
                        g, f"r{round_no}g{g}".encode().ljust(32, b"\0"))))
                eng.run_for(2 * cfg.heartbeat_period)
                if round_no == 2:
                    st, body = _get(srv.port, "/status")
                    assert st == 200 and json.loads(body)["groups"] == Gn
            eng.run_until_committed(*submitted[0])
            st, body = _get(srv.port, "/healthz")
            assert st == 200 and json.loads(body)["status"] == "ok"
            st, status = _get(srv.port, "/status")
            snap = json.loads(status)
            assert set(snap["leaders"]) == {str(g) for g in range(Gn)}
            assert snap["leaders"]["0"]["term"] >= 1
            assert int(snap["commit_watermark"]["0"]) >= 1
            assert snap["audit"]["violations_total"] == 0
            st, metrics = _get(srv.port, "/metrics")
            assert st == 200
            parsed = registry.parse_prometheus(metrics)
            assert "raft_elections_total" in parsed
            st, slo_body = _get(srv.port, "/slo")
            assert json.loads(slo_body)["objectives"][0]["name"] == \
                "commit_fast"
            assert _get(srv.port, "/healthz")[0] == 200
        arts.append(dict(status=snap, metrics=metrics,
                         slo=json.loads(slo_body),
                         events=eng.recorder.to_jsonable(),
                         audit=eng.auditor.summary()))
    assert arts[0] == arts[1]


def test_router_breakers_publish_into_status():
    boards = []
    for M, serve, R_, extra in ((JMulti, jserve, JRouter, {}),
                                (MultiEngine, tserve, Router,
                                 {"device": "cpu"})):
        cfg = (JConfig if M is JMulti else TConfig)(
            n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=64,
            transport="single")
        eng = M(cfg, 2, **extra)
        eng.status_board = serve.StatusBoard()
        router = R_(eng, breaker_threshold=2)
        for _ in range(2):
            router.breakers[0].on_failure(eng.clock.now)
        snap = eng.status_board.compose()
        assert snap["breakers"] == {"0": "open", "1": "closed"}
        boards.append(snap)
    assert boards[0] == boards[1]


# ------------------------------------------------- tier and the store
def test_group_sweep_seals_and_replay_reads_back(tmp_path, monkeypatch):
    """``TestMultiTiered``: the per-group sweep seals RS-coded segments,
    and ``register_apply(replay=True)`` reads the whole history back;
    both engines in lock step write the same shard files."""
    monkeypatch.setenv("RAFT_TPU_TIERED_DIR", str(tmp_path))
    p = MPair(2, entry_bytes=32, batch_size=4, log_capacity=16, seed=21)
    p.both("seed_leaders")
    ps = payloads(100, seed=22, entry=32)
    p.submit_all({0: ps[:50]})
    p.run_for(400.0)
    p.submit_all({0: ps[50:]})
    p.run_for(600.0)
    assert int(p.t.commit_watermark[0]) == 100
    assert int(p.t._archive_floor[0]) > 1
    assert p.t.tier_stats["segments_sealed"] > 0
    got = {"j": [], "t": []}
    for k, e in (("j", p.j), ("t", p.t)):
        assert e.register_apply(0, lambda i, b, k=k: got[k].append(b),
                                replay=True) == 1
    assert got["t"] == got["j"] == ps
    assert p.t.tier_stats == p.j.tier_stats
    assert p.t.tier_stats["segment_loads"] > 0
    assert p.t._group_segments == p.j._group_segments
    jroot, troot = p.j._tier_io.root, p.t._tier_io.root
    names = sorted(os.listdir(troot))
    assert names and names == sorted(os.listdir(jroot))
    for n in names:
        with open(os.path.join(troot, n), "rb") as a, \
                open(os.path.join(jroot, n), "rb") as b:
            assert a.read() == b.read(), n
    p.check_all()


def test_sharded_kv_matches_jax():
    """``ShardedKV`` over both engines: batched sets across groups, a
    delete, local and linearizable gets, the same per-group dicts."""
    p = MPair(4, apply=False)
    p.both("seed_leaders")
    jkv, tkv = JShardedKV(p.j), ShardedKV(p.t)
    items = [(f"k{i}".encode(), f"v{i}".encode()) for i in range(24)]
    placed = tkv.set_many(items)
    assert placed == jkv.set_many(items)
    assert tkv.delete(b"k3") == jkv.delete(b"k3")
    for g, s in placed:
        p.until_committed(g, s)
    p.run_for(4 * p.t.cfg.heartbeat_period)
    keys = [k for k, _ in items]
    assert tkv.get_many(keys) == jkv.get_many(keys)
    assert tkv.get(b"k3") is None and tkv.get(b"k4") == b"v4"
    assert tkv.linearizable_get(b"k5") == jkv.linearizable_get(b"k5")
    assert tkv._data == jkv._data and tkv.last_applied == jkv.last_applied
    assert len(tkv) == len(jkv) == 23
    p.check_all()
