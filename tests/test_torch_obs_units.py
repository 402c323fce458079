"""The observability plane's units through both packages: the cases of
``tests/test_obs_plane.py`` (``TestFlightRecorderRing``,
``TestMetricsRegistry``, the single-engine ``TestSpans`` cases and
``TestNodelogByteCompat`` without its multi-engine case),
``tests/test_slo.py`` (all of it), ``tests/test_audit.py``
(``TestInvariantUnits``) and ``tests/test_faults_obs.py`` (``TestTrace``
and ``TestMetrics``), each run against ``raft_tpu.obs`` and against
``raft_tpu_torch.obs`` with the same inputs.

Every case keeps its original assertions and returns what it produced (a
recorder dump, exposition text, a snapshot); the port's run must return
exactly what the JAX package's returns, as JSON text. Engines are the
small shape of ``tests/test_obs_plane.py`` (3 replicas, 16-byte entries,
B = 4, C = 64), the port's on the CPU.
"""

import dataclasses
import json
import math
import types

import numpy as np
import pytest

import raft_tpu.admission as jadmission
import raft_tpu.ckpt as jckpt
import raft_tpu.config as jconfig
import raft_tpu.golden as jgolden
import raft_tpu.obs as jobs
import raft_tpu.obs.audit as jaudit
import raft_tpu.obs.metrics as jmetrics
import raft_tpu.obs.slo as jslo
import raft_tpu.raft as jraft
import raft_tpu.transport as jtransport
import raft_tpu_torch.admission as tadmission
import raft_tpu_torch.ckpt as tckpt
import raft_tpu_torch.config as tconfig
import raft_tpu_torch.golden as tgolden
import raft_tpu_torch.obs as tobs
import raft_tpu_torch.obs.audit as taudit
import raft_tpu_torch.obs.metrics as tmetrics
import raft_tpu_torch.obs.slo as tslo
import raft_tpu_torch.raft as traft
import raft_tpu_torch.transport as ttransport

ENTRY = 16

PKG = {
    "jax": types.SimpleNamespace(
        obs=jobs, slo=jslo, audit=jaudit, metrics=jmetrics,
        RaftConfig=jconfig.RaftConfig, RaftEngine=jraft.RaftEngine,
        transport=lambda cfg: jtransport.SingleDeviceTransport(cfg),
        Overloaded=jadmission.Overloaded,
        CheckpointStore=jckpt.CheckpointStore,
        GoldenCluster=jgolden.GoldenCluster,
    ),
    "torch": types.SimpleNamespace(
        obs=tobs, slo=tslo, audit=taudit, metrics=tmetrics,
        RaftConfig=tconfig.RaftConfig, RaftEngine=traft.RaftEngine,
        transport=lambda cfg: ttransport.SingleDeviceTransport(
            cfg, device="cpu"),
        Overloaded=tadmission.Overloaded,
        CheckpointStore=tckpt.CheckpointStore,
        GoldenCluster=tgolden.GoldenCluster,
    ),
}
_TRANSPORTS: dict = {}


def mk_engine(P, seed=0, trace=None, recorder=None, log_capacity=64, **kw):
    """``tests/test_obs_plane.py``'s engine (one transport per package
    and shape: the JAX programs compile once)."""
    shape = dict(n_replicas=3, entry_bytes=ENTRY, batch_size=4,
                 log_capacity=log_capacity, transport="single")
    key = (P.RaftConfig, tuple(sorted(shape.items())))
    if key not in _TRANSPORTS:
        _TRANSPORTS[key] = P.transport(P.RaftConfig(**shape))
    cfg = P.RaftConfig(**shape, seed=seed, **kw)
    return P.RaftEngine(cfg, _TRANSPORTS[key], trace=trace,
                        recorder=recorder)


def payloads(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, ENTRY, np.uint8).tobytes()
            for _ in range(n)]


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def as_json(x):
    def default(o):
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        if isinstance(o, (set, frozenset)):
            return sorted(o)
        if isinstance(o, bytes):
            return o.hex()
        raise TypeError(f"{type(o)} in a case's result")
    return json.dumps(x, default=default)


# ------------------------------------------------ test_obs_plane.py cases
@case
def nodelog_rendering_byte_identical(P):
    tr = P.obs.TraceRecorder()
    rec = P.obs.FlightRecorder()
    e = mk_engine(P, 7, trace=tr, recorder=rec)
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(6, seed=1)]
    e.run_until_committed(seqs[-1])
    victim = next(r for r in range(3) if r != e.leader_id)
    e.fail(victim)
    e.run_for(40.0)
    e.recover(victim)
    e.partition([[0, 1], [2]])
    e.run_for(80.0)
    e.heal_partition()
    more = [e.submit(p) for p in payloads(4, seed=2)]
    e.run_until_committed(more[-1], limit=600.0)
    assert len(tr.lines) > 10
    assert rec.nodelog_lines() == tr.lines
    return rec.to_jsonable()


@case
def event_nodelog_requires_legacy_message(P):
    ev = P.obs.Event(seq=0, t_virtual=0.0, node="Server0", group=None,
                     term=1, kind="repair_floor_raise")
    with pytest.raises(ValueError) as ex:
        ev.nodelog()
    return str(ex.value)


@case
def structured_leaders_match_string_leaders(P):
    tr = P.obs.TraceRecorder()
    rec = P.obs.FlightRecorder()
    e = mk_engine(P, 3, trace=tr, recorder=rec)
    e.run_until_leader()
    e.fail(e.leader_id)
    e.run_for(120.0)
    want = {}
    for r in tr.matching("state changed to leader"):
        want.setdefault(r.term, set()).add(r.node)
    assert rec.leaders_by_term() == want
    return sorted((t, sorted(v)) for t, v in want.items())


@case
def disabled_path_skips_device_fetch(P):
    e = mk_engine(P, 1)
    calls = [0]
    orig = e._fetch

    def counting(x):
        calls[0] += 1
        return orig(x)

    e._fetch = counting
    assert e.nodelog(0, "hello") == ""
    assert calls[0] == 0
    return calls[0]


@case
def ring_bound_and_overflow(P):
    rec = P.obs.FlightRecorder(capacity=8)
    for i in range(20):
        rec.record(node="Server0", term=i, kind="elect", t_virtual=float(i))
    assert len(rec) == 8
    assert rec.dropped == 12
    assert rec.total_recorded == 20
    assert [e.seq for e in rec.events()] == list(range(12, 20))
    return rec.to_jsonable()


@case
def queries_filter_kind_node_group(P):
    rec = P.obs.FlightRecorder()
    rec.record(node="g0/Server1", group=0, term=1, kind="elect",
               t_virtual=1.0)
    rec.record(node="g1/Server2", group=1, term=1, kind="elect",
               t_virtual=2.0)
    rec.record(node="g1/Server2", group=1, term=1, kind="kill",
               t_virtual=3.0)
    assert len(rec.events(kind="elect")) == 2
    assert len(rec.events(group=1)) == 2
    assert len(rec.events(kind="elect", group=1)) == 1
    assert rec.leaders_by_term(group=0) == {1: {"g0/Server1"}}
    return [e.to_jsonable() for e in rec.events(group=1)]


@case
def dump_roundtrip(P):
    rec = P.obs.FlightRecorder(capacity=4)
    for i in range(6):
        rec.record(node="Server0", term=i, kind="commit",
                   t_virtual=float(i), msg=f"commit index changed to {i}",
                   state="leader", commit_index=i, last_index=i)
    back = P.obs.FlightRecorder.from_jsonable(
        json.loads(json.dumps(rec.to_jsonable())))
    assert back.dropped == rec.dropped
    assert [e.nodelog() for e in back.events()] == \
        [e.nodelog() for e in rec.events()]
    return back.nodelog_lines()


@case
def engine_causal_chain(P):
    rec = P.obs.FlightRecorder()
    e = mk_engine(P, 5, recorder=rec)
    e.spans = sp = P.obs.SpanTracker()
    e.register_apply(lambda idx, b: None)
    e.run_until_leader()
    span = sp.begin("write", e.clock.now, client=1, key=b"k")
    sp.current = span
    seq = e.submit(payloads(1, seed=9)[0])
    sp.current = None
    e.run_until_committed(seq)
    span.finish("ok", e.clock.now)
    names = [a[1] for a in span.annotations]
    assert names[:3] == ["queued", "ingested", "committed"]
    assert "applied" in names
    assert span.queue_delay_s is not None
    assert span.replication_rounds is not None
    assert span.seq == seq
    return sp.to_jsonable()


@case
def double_terminal_raises(P):
    sp = P.obs.SpanTracker()
    span = sp.begin("write", 0.0)
    span.finish("ok", 1.0)
    with pytest.raises(RuntimeError) as ex:
        span.finish("failed", 2.0)
    return str(ex.value)


@case
def shed_refusal_annotates_span(P):
    e = mk_engine(P, 2, admission_max_writes=1)
    e.spans = sp = P.obs.SpanTracker()
    e.run_until_leader()
    ok = sp.begin("write", e.clock.now, client=0)
    sp.current = ok
    e.submit(payloads(1)[0])
    sp.current = None
    shed = sp.begin("write", e.clock.now, client=0)
    sp.current = shed
    with pytest.raises(P.Overloaded):
        e.submit(payloads(1, seed=1)[0])
    sp.current = None
    assert shed.refusal_reasons == ["depth"]
    return sp.to_jsonable()


@case
def perfetto_export_shape(P):
    sp = P.obs.SpanTracker()
    span = sp.begin("write", 1.0, client=3, key=b"k0", group=2)
    span.annotate("queued", 1.5, seq=4)
    span.finish("ok", 2.0)
    doc = sp.to_perfetto()
    slices = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    assert slices[0]["pid"] == 2 and slices[0]["tid"] == 3
    assert slices[0]["ts"] == 1.0e6 and slices[0]["dur"] == 1.0e6
    assert any(ev["ph"] == "i" for ev in doc["traceEvents"])
    return json.dumps(doc)


@case
def counters_gauges_histograms(P):
    reg = P.obs.MetricsRegistry()
    c = reg.counter("raft_elections_total", "wins", ("group",))
    c.inc(group="0")
    c.inc(2, group="1")
    g = reg.gauge("raft_term", "", ("group",))
    g.set_max(3, group="0")
    g.set_max(1, group="0")
    h = reg.histogram("lat", "", ("group",), buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v, group="0")
    snap = reg.snapshot()
    assert snap["raft_elections_total"]["series"][1]["value"] == 2
    assert snap["raft_term"]["series"][0]["value"] == 3
    hs = snap["lat"]["series"][0]
    assert hs["count"] == 3 and hs["buckets"]["+Inf"] == 1
    return [snap, reg.to_prometheus()]


@case
def prometheus_round_trip(P):
    reg = P.obs.MetricsRegistry()
    c = reg.counter("raft_sheds_total", "refusals", ("reason", "group"))
    c.inc(4, reason="depth", group="0")
    c.inc(1, reason="fair_share", group="0")
    reg.gauge("raft_term", "highest", ("group",)).set(7, group="0")
    h = reg.histogram("raft_commit_latency_seconds", "", ("group",),
                      buckets=(1.0, 4.0))
    for v in (0.5, 2.0, 2.5, 9.0):
        h.observe(v, group="0")
    text = reg.to_prometheus()
    parsed = P.obs.parse_prometheus(text)
    assert parsed["raft_sheds_total"][
        (("group", "0"), ("reason", "depth"))] == 4
    assert parsed["raft_term"][(("group", "0"),)] == 7
    b = parsed["raft_commit_latency_seconds_bucket"]
    assert b[(("group", "0"), ("le", "1.0"))] == 1
    assert b[(("group", "0"), ("le", "4.0"))] == 3
    assert b[(("group", "0"), ("le", "+Inf"))] == 4
    assert parsed["raft_commit_latency_seconds_count"][
        (("group", "0"),)] == 4
    assert parsed["raft_commit_latency_seconds_sum"][
        (("group", "0"),)] == pytest.approx(14.0)
    return text


@case
def prometheus_label_escaping_round_trip(P):
    reg = P.obs.MetricsRegistry()
    c = reg.counter("x_total", "", ("k",))
    for v in ("a\\nb", 'with "quotes"', "two\nlines", "trail\\"):
        c.inc(k=v)
    text = reg.to_prometheus()
    parsed = P.obs.parse_prometheus(text)
    for v in ("a\\nb", 'with "quotes"', "two\nlines", "trail\\"):
        assert parsed["x_total"][(("k", v),)] == 1, repr(v)
    return text


@case
def engine_report_carries_snapshot(P):
    rec = P.obs.FlightRecorder()
    e = mk_engine(P, 6, recorder=rec)
    e.metrics = P.obs.MetricsRegistry()
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(5, seed=3)]
    e.run_until_committed(seqs[-1])
    rep = P.obs.summarize_engine(e)
    assert rep.leader_changes >= 1
    snap = rep.metrics
    assert snap["raft_commits_total"]["series"][0]["value"] == 5
    assert snap["raft_elections_total"]["series"][0]["value"] >= 1
    assert snap["raft_commit_latency_seconds"]["series"][0]["count"] == 5
    return [dataclasses.asdict(rep), e.metrics.to_prometheus()]


# -------------------------------------------------------- test_slo.py cases
def rel_err(P):
    return P.slo._FACTOR - 1.0


@case
def digest_quantile_accuracy_bound(P):
    rng = np.random.default_rng(7)
    samples = rng.lognormal(mean=-4.0, sigma=1.5, size=20_000)
    d = P.slo.LatencyDigest()
    for v in samples:
        d.observe(float(v))
    for q in (0.5, 0.9, 0.99, 0.999):
        true = float(np.quantile(samples, q))
        est = d.quantile(q)
        assert abs(est - true) / true <= rel_err(P), (q, est, true)
    return d.to_jsonable()


@case
def digest_observe_many_matches_observe(P):
    rng = np.random.default_rng(3)
    samples = rng.lognormal(mean=-2.0, sigma=2.0, size=5_000)
    one = P.slo.LatencyDigest()
    for v in samples:
        one.observe(float(v))
    bulk = P.slo.LatencyDigest()
    bulk.observe_many(samples)
    assert (one.counts == bulk.counts).all()
    assert one.n == bulk.n
    assert math.isclose(one.total, bulk.total, rel_tol=1e-9)
    return [one.counts.tolist(), bulk.to_jsonable()]


@case
def digest_merge_equals_union(P):
    rng = np.random.default_rng(11)
    a_s = rng.lognormal(-3.0, 1.0, 3_000)
    b_s = rng.lognormal(-1.0, 1.0, 3_000)
    a, b, u = (P.slo.LatencyDigest() for _ in range(3))
    a.observe_many(a_s)
    b.observe_many(b_s)
    u.observe_many(np.concatenate([a_s, b_s]))
    a.merge(b)
    assert (a.counts == u.counts).all()
    assert a.n == u.n
    for q in (0.5, 0.99):
        assert a.quantile(q) == u.quantile(q)
    return a.to_jsonable()


@case
def digest_extremes_clamp_into_terminal_buckets(P):
    d = P.slo.LatencyDigest()
    for v in (0.0, -1.0, float("nan"), 1e12):
        d.observe(v)
    assert d.n == 4
    assert d.counts[0] == 3
    assert d.counts[-1] == 1
    assert math.isfinite(d.quantile(0.5))
    return d.counts.tolist()


@case
def digest_empty(P):
    d = P.slo.LatencyDigest()
    assert math.isnan(d.quantile(0.5))
    j = d.to_jsonable()
    assert j["n"] == 0 and j["p99"] is None
    return j


WINDOWS = ((600.0, 60.0, 10.0, "page"),)


def burn_tracker(P, **kw):
    return P.slo.SloTracker(
        objectives=(P.slo.SLObjective("lat", "commit", threshold_s=1.0,
                                      target=0.99),),
        bucket_s=10.0, windows=WINDOWS, **kw)


@case
def burn_quiet_under_target(P):
    tr = burn_tracker(P)
    for i in range(600):
        tr.observe("commit", 0.5, float(i))
    tr.evaluate(600.0)
    assert tr.alerts == [] and tr.active_alerts() == []
    return tr.snapshot()


@case
def burn_fires_on_fast_burn_and_clears(P):
    tr = burn_tracker(P)
    t = 0.0
    for i in range(700):
        t = float(i)
        tr.observe("commit", 2.0 if i % 2 else 0.5, t)
        tr.maybe_evaluate(t)
    assert any(a.kind == "fire" and a.severity == "page"
               for a in tr.alerts)
    assert tr.active_alerts()
    for i in range(120):
        t += 1.0
        tr.observe("commit", 0.5, t)
        tr.maybe_evaluate(t)
    assert not tr.active_alerts()
    assert any(a.kind == "clear" for a in tr.alerts)
    return tr.snapshot()


@case
def burn_both_windows_required(P):
    tr = burn_tracker(P)
    t = 0.0
    for i in range(580):
        t = float(i)
        tr.observe("commit", 0.5, t)
    for i in range(20):
        t += 1.0
        tr.observe("commit", 5.0, t)
    tr.evaluate(t)
    assert not tr.active_alerts()
    return tr.snapshot()


@case
def burn_alert_recorded_and_counted(P):
    rec, reg = P.obs.FlightRecorder(), P.obs.MetricsRegistry()
    tr = P.slo.SloTracker(
        objectives=(P.slo.SLObjective("lat", "commit", 1.0, 0.99),),
        recorder=rec, registry=reg, bucket_s=10.0, windows=WINDOWS)
    for i in range(700):
        tr.observe("commit", 2.0, float(i))
        tr.maybe_evaluate(float(i))
    evs = rec.events(kind="slo_alert")
    assert evs and evs[0].fields["severity"] == "page"
    assert reg.get("raft_slo_alerts_total").value(
        slo="lat", severity="page") >= 1
    return [rec.to_jsonable(), reg.to_prometheus()]


@case
def burn_per_group_isolation(P):
    tr = burn_tracker(P)
    for i in range(700):
        tr.observe("commit", 2.0, float(i), group=1)
        tr.observe("commit", 0.5, float(i), group=2)
        tr.maybe_evaluate(float(i))
    assert {a.group for a in tr.alerts if a.kind == "fire"} == {1}
    return tr.snapshot()


@case
def burn_snapshot_jsonable(P):
    tr = burn_tracker(P)
    for i in range(100):
        tr.observe("commit", 0.5 if i % 2 else 3.0, float(i))
    tr.evaluate(100.0)
    snap = tr.snapshot()
    json.dumps(snap)
    assert snap["objectives"][0]["name"] == "lat"
    grp = snap["objectives"][0]["groups"]["default"]
    assert grp["total"] == 100 and 0 < grp["good_fraction"] < 1
    assert "commit" in snap["digests"]
    return snap


@case
def slo_alert_dataclass_fields(P):
    a = P.slo.SloAlert(slo="x", group=None, severity="page", burn_rate=12.0,
                       long_s=600.0, short_s=60.0, t_virtual=5.0)
    assert a.kind == "fire"
    return dataclasses.asdict(a)


def threshold_edge(P, bad_frac, should_fire):
    tr = P.slo.SloTracker(
        objectives=(P.slo.SLObjective("lat", "commit", 1.0, 0.99),),
        bucket_s=10.0, windows=WINDOWS)
    rng = np.random.default_rng(1)
    for i in range(700):
        bad = rng.random() < bad_frac
        tr.observe("commit", 2.0 if bad else 0.5, float(i))
        tr.maybe_evaluate(float(i))
    assert bool([a for a in tr.alerts if a.kind == "fire"]) == should_fire
    return tr.snapshot()


CASES["threshold_edge_quiet"] = lambda P: threshold_edge(P, 0.0, False)
CASES["threshold_edge_burning"] = lambda P: threshold_edge(P, 0.5, True)


# ---------------------------------------------- test_audit.py invariant units
def audit_dump(a):
    return a.to_jsonable()


@case
def audit_leader_unique_trips_on_second_winner(P):
    a = P.audit.SafetyAuditor()
    a.note_elect("Server0", 3, 1.0)
    a.note_elect("Server0", 3, 2.0)
    assert a.total_violations == 0
    a.note_elect("Server1", 3, 3.0)
    assert a.by_invariant == {"leader_unique": 1}
    v = a.violations[0]
    assert v.invariant == "leader_unique" and v.t_virtual == 3.0
    return audit_dump(a)


@case
def audit_commit_monotone_trips_on_rewind(P):
    a = P.audit.SafetyAuditor()
    a.note_state([1, 1, 1], 10, 1.0)
    a.note_state([1, 1, 1], 12, 2.0)
    assert a.total_violations == 0
    a.note_state([1, 1, 1], 9, 3.0)
    assert a.by_invariant == {"commit_monotone": 1}
    a.note_state([1, 1, 1], 9, 4.0)
    assert a.total_violations == 1
    return audit_dump(a)


@case
def audit_term_monotone_trips_without_wipe(P):
    a = P.audit.SafetyAuditor()
    a.note_state([2, 5, 2], 0, 1.0)
    a.note_state([2, 4, 2], 0, 2.0)
    assert a.by_invariant == {"term_monotone": 1}
    return audit_dump(a)


@case
def audit_wipe_resets_term_watermark(P):
    a = P.audit.SafetyAuditor()
    a.note_state([2, 5, 2], 0, 1.0)
    a.note_wipe("Server1")
    a.note_state([2, 0, 2], 0, 2.0)
    assert a.total_violations == 0
    return audit_dump(a)


@case
def audit_log_matching_trips_on_refed_mismatch(P):
    a = P.audit.SafetyAuditor()
    a.note_entry(5, 2, b"alpha", 1.0)
    a.note_entry(5, 2, b"alpha", 2.0)
    assert a.total_violations == 0
    a.note_entry(5, 2, b"bravo", 3.0)
    assert a.by_invariant == {"log_matching": 1}
    return [audit_dump(a), a.commit_digest()]


@case
def audit_log_matching_covers_lazy_span_blocks(P):
    a = P.audit.SafetyAuditor()
    a.note_entry_span(10, [(1, b"p10"), (2, b"p11")], 7, 1.0, pick=1)
    a.note_entry(10, 7, b"p10", 2.0)
    assert a.total_violations == 0
    a.note_entry(11, 7, b"XXX", 3.0)
    assert a.by_invariant == {"log_matching": 1}
    a.note_commit(11, 4.0)
    return [audit_dump(a), a.commit_digest()]


@case
def audit_read_uncommitted_and_monotone(P):
    a = P.audit.SafetyAuditor()
    a.note_apply(b"k", 1, b"v1")
    a.note_apply(b"k", 2, b"v2")
    a.observe_read(7, b"k", b"v2", 1.0)
    assert a.total_violations == 0
    a.observe_read(7, b"k", b"v1", 2.0)
    assert a.by_invariant == {"read_monotone": 1}
    a.observe_read(7, b"k", b"ghost", 3.0)
    assert a.by_invariant["read_uncommitted"] == 1
    a.observe_read(8, b"k", b"v2", 4.0)
    assert a.by_invariant.get("read_monotone") == 1
    return audit_dump(a)


@case
def audit_initial_none_read_is_fine_then_stale_after_write(P):
    a = P.audit.SafetyAuditor()
    a.observe_read(1, b"k", None, 1.0)
    assert a.total_violations == 0
    a.note_apply(b"k", 3, b"v")
    a.observe_read(1, b"k", b"v", 2.0)
    a.observe_read(1, b"k", None, 3.0)
    assert a.by_invariant == {"read_monotone": 1}
    return audit_dump(a)


@case
def audit_attach_recheck_flags_rewound_restore(P):
    class _Eng:
        def __init__(self):
            self.store = P.CheckpointStore(4)
            self.commit_watermark = 3

        class clock:
            now = 9.0

    a = P.audit.SafetyAuditor()
    a.note_state([1], 8, 1.0)
    a.on_attach(_Eng())
    assert a.by_invariant == {"commit_monotone": 1}
    return audit_dump(a)


@case
def audit_violation_cap_counts_drops(P):
    a = P.audit.SafetyAuditor()
    a.VIOLATION_CAP = 4
    for t in range(8):
        a.note_elect("Server0", t, float(t))
        a.note_elect("Server1", t, float(t))
    assert len(a.violations) == 4
    assert a.total_violations == 8
    assert a.violations_dropped == 4
    return [audit_dump(a), a.summary()]


# ------------------------------------------------ test_faults_obs.py cases
@case
def trace_parse_roundtrip(P):
    rec = P.obs.TraceRecord.parse("[Server2:7:41:44][candidate]hello world")
    assert rec == P.obs.TraceRecord("Server2", 7, 41, 44, "candidate",
                                    "hello world")
    grouped = P.obs.TraceRecord.parse("[g3/Server0:2:5:6][leader]x")
    assert grouped.group == 3 and rec.group is None
    return [dataclasses.asdict(rec), dataclasses.asdict(grouped)]


@case
def trace_rejects_garbage(P):
    with pytest.raises(ValueError) as ex:
        P.obs.TraceRecord.parse("not a trace line")
    return str(ex.value)


@case
def trace_engine_lines_parse(P):
    tr = P.obs.TraceRecorder()
    e = mk_engine(P, 4, trace=tr, log_capacity=256)
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(3, seed=1)]
    e.run_until_committed(seqs[-1])
    assert len(tr) > 0
    for rec in tr.records():
        assert rec.state in ("follower", "candidate", "leader")
    return [dataclasses.asdict(r) for r in tr.records()]


@case
def trace_golden_lines_parse_with_same_schema(P):
    tr = P.obs.TraceRecorder()
    c = P.GoldenCluster(3, seed=0, trace=tr)
    c.run_until_leader()
    assert len(tr) > 0
    for rec in tr.records():
        assert rec.node.startswith("Server")
    return tr.lines


@case
def metrics_summary_counts_and_latency(P):
    tr = P.obs.TraceRecorder()
    e = mk_engine(P, 5, trace=tr, log_capacity=256)
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(10, seed=2)]
    e.run_until_committed(seqs[-1])
    rep = P.obs.summarize_engine(e, tr)
    assert rep.committed_entries == 10
    assert rep.lost_entries == 0
    assert rep.leader_changes >= 1
    assert 0 < rep.commit_latency.p50 <= rep.commit_latency.max
    assert rep.commit_latency.p99 <= 2 * e.cfg.heartbeat_period + 1e-6
    assert rep.entries_per_sec > 0
    return dataclasses.asdict(rep)


@case
def metrics_empty_latency_is_nan(P):
    s = P.metrics.LatencySummary.of(np.array([]))
    assert s.count == 0 and np.isnan(s.p50)
    return repr(s)


# ---------------------------------------------------------------- the test
@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_case(name, pkg):
    """The case through ``pkg``; through the port, its result must equal
    the JAX package's."""
    got = CASES[name](PKG[pkg])
    if pkg == "torch":
        assert as_json(got) == as_json(CASES[name](PKG["jax"]))
