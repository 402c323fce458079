"""The host observability plane attached to the port's engine against the
JAX engine with the JAX plane attached: the same ``RaftConfig``, seed and
calls, and after every event equal artifacts — the flight recorder's dump
and its ``nodelog_lines()`` against the trace, the span table, the
Prometheus text and the JSON registry snapshot, the auditor's dump,
summary and commit digest, the SLO snapshot, ``_status_snapshot()`` and
the status board. Equal means the same JSON text and the same Python type
at every leaf (a ``numpy.int64`` or a tensor where JAX has an ``int``
fails).

Covered: the tick path with a failover and a read round, the fused
booking at ``fuse_k = 8`` (JAX ``raft/steady.py``'s per-entry loop
against the port's), a ``submit_pipelined`` flight (both
``_pipeline_backend_ok`` hooks patched), a restore with the auditor
re-attached, and the no-fetch contract: with spans, metrics, auditor, SLO
and board attached and no recorder or trace, an engine fetches from the
device exactly as often as with nothing attached.

Small shapes (3 replicas, 32-byte entries, B = 8, C = 128) on the
transports of ``tests/test_torch_engine.py``.
"""

import json

import numpy as np
import pytest

from raft_tpu.obs import forensics as jforensics
from raft_tpu.obs import serve as jserve
from raft_tpu.obs import slo as jslo
from raft_tpu_torch.obs import forensics as tforensics
from raft_tpu_torch.obs import serve as tserve
from raft_tpu_torch.obs import slo as tslo
from tests._torch_port import pallas_interpret
from tests.test_torch_engine import (
    KW,
    JConfig,
    JEngine,
    Pair,
    TConfig,
    TEngine,
    payloads,
    transports,
)

PACKAGES = ((jforensics, jserve, jslo), (tforensics, tserve, tslo))


def build_plane(pkg, cfg_kw):
    forensics, serve, slo = pkg
    hb = cfg_kw.get("heartbeat_period", 2.0)
    stack = forensics.ObsStack.build(
        audit=True,
        slo_objectives=(
            slo.SLObjective("commit_fast", "commit", threshold_s=2 * hb),
            slo.SLObjective("read_fast", "read", threshold_s=hb),
        ),
    )
    return stack, serve.StatusBoard()


def attach(e, stack, board):
    stack.attach(e)
    e.status_board = board


def artifacts(e, stack, board) -> dict:
    """Every artifact of the plane, as the operator and a bundle see it."""
    return dict(
        events=stack.recorder.to_jsonable(),
        spans=stack.spans.to_jsonable(),
        perfetto=stack.spans.to_perfetto(),
        prometheus=stack.registry.to_prometheus(),
        registry=stack.registry.snapshot(),
        audit=stack.audit.to_jsonable(),
        audit_summary=stack.audit.summary(),
        commit_digest=stack.audit.commit_digest(),
        slo=stack.slo.snapshot(),
        status=e._status_snapshot(),
        board=board.compose(),
    )


def assert_same_tree(want, got, path="$"):
    """Equal values with the same type at every leaf."""
    assert type(got) is type(want), f"{path}: {type(got)} vs {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), f"{path}: keys"
        for k in want:
            assert_same_tree(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{path}: length"
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same_tree(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and want != want:
        assert got != got, path
    else:
        assert got == want, f"{path}: {got!r} vs {want!r}"


def assert_planes_equal(j, t, jplane, tplane, lines):
    """Every artifact: equal values and leaf types."""
    ja, ta = artifacts(j, *jplane), artifacts(t, *tplane)
    assert_same_tree(ja, ta)
    assert json.dumps(ta) == json.dumps(ja)
    assert tplane[0].recorder.nodelog_lines() == lines


def light_artifacts(e, stack, board, since: int) -> str:
    """The per-event comparison, as JSON text: the recorder's events from
    ``since`` on, every span's fields and annotations, and every other
    artifact whole (``check_all`` compares the full dumps)."""
    rec = stack.recorder
    return json.dumps(dict(
        head=[rec.capacity, rec.dropped, rec.total_recorded],
        events=[ev.to_jsonable() for ev in list(rec._ring)[since:]],
        spans=[[sp.trace_id, sp.op, sp.t_start, sp.state, sp.seq,
                sp.queue_delay_s, sp.replication_rounds, sp.read_class,
                sp.refusal_reasons, sp.annotations]
               for sp in stack.spans.spans],
        prometheus=stack.registry.to_prometheus(),
        audit_summary=stack.audit.summary(),
        commit_digest=stack.audit.commit_digest(),
        slo=stack.slo.snapshot(),
        status=e._status_snapshot(),
        board=board.compose(),
    ))


class ObsPair(Pair):
    """``Pair`` with the full plane attached to each engine: the recorder
    through the constructor, the rest through ``ObsStack.attach``; every
    check also compares the planes' artifacts. ``lines`` accumulates the
    trace across restores (one recorder spans them, as in JAX)."""

    def __init__(self, seed=0, planes=None, lines=None, **kw):
        self.planes = planes or tuple(
            build_plane(pkg, kw) for pkg in PACKAGES)
        self.lines0 = list(lines or [])
        super().__init__(seed, recorders=(self.planes[0][0].recorder,
                                          self.planes[1][0].recorder), **kw)
        attach(self.j, *self.planes[0])
        attach(self.t, *self.planes[1])
        self.check()

    def check(self):
        super().check()
        if getattr(self, "planes", None) is None or self.j.auditor is None:
            return
        (jstack, jb), (tstack, tb) = self.planes
        since = self.__dict__.setdefault("_seen", 0)
        assert light_artifacts(self.t, tstack, tb, since) == \
            light_artifacts(self.j, jstack, jb, since)
        self._seen = len(tstack.recorder)
        assert tstack.recorder.nodelog_lines() == self.lines0 + self.tl

    def check_all(self, read_back=True):
        super().check_all(read_back)
        assert_planes_equal(self.j, self.t, *self.planes,
                            self.lines0 + self.tl)

    def submit_spanned(self, ps, op="write"):
        """Submit each payload inside a span of its own (the caller's
        ambient trace context, as a router sets it)."""
        seqs = []
        for p in ps:
            for e, (stack, _) in zip((self.j, self.t), self.planes):
                stack.spans.current = stack.spans.begin(op, e.clock.now)
            seqs.append(self.both("submit", p))
            for stack, _ in self.planes:
                stack.spans.current = None
        return seqs

    def spanned(self, name, *args):
        """One call inside a fresh span on each side; both must agree on
        the result or on the refusal."""
        for e, (stack, _) in zip((self.j, self.t), self.planes):
            stack.spans.current = stack.spans.begin(name, e.clock.now)
        try:
            return self.both(name, *args)
        finally:
            for stack, _ in self.planes:
                stack.spans.current = None

    def run_fused(self, seconds):
        """``run_for`` event by event with the horizon set, so a fused
        engine fuses; checked after every event."""
        end = self.j.clock.now + seconds
        while self.j._q and self.j._q[0][0] <= end:
            assert self.j.step_event(horizon=end) == \
                self.t.step_event(horizon=end)
            self.check()
        for e in (self.j, self.t):
            e.clock.now = max(e.clock.now, end)
        self.check()


def spans_reach_applied(stack, seqs):
    by_seq = {sp.seq: sp for sp in stack.spans.spans if sp.seq is not None}
    for s in seqs:
        names = [a[1] for a in by_seq[s].annotations]
        assert names[:2] == ["queued", "ingested"], (s, names)
        assert "committed" in names and "applied" in names, (s, names)


def test_tick_path_failover_and_reads():
    p = ObsPair(21)
    lead = p.until_leader()
    seqs = p.submit_spanned(payloads(30, 21))
    p.until_committed(seqs[-1])
    # reads: a ticket confirmed by the next round, and an explicit round
    tk = p.spanned("submit_read")
    p.run_for(2.5)
    p.spanned("read_confirmed", tk)
    p.spanned("read_linearizable")
    # a failover with entries in flight
    a = (lead + 1) % 3
    p.both("fail", a)
    more = p.submit_spanned(payloads(12, 22))
    p.run_for(4.0)
    p.both("fail", lead)
    p.both("recover", a)
    p.until_leader()
    p.both("recover", lead)
    last = p.submit_spanned(payloads(9, 23))
    p.until_committed(last[-1])
    p.run_for(6.0)
    p.check_all()
    for stack, _ in p.planes:
        spans_reach_applied(stack, seqs + last)
        assert stack.audit.total_violations == 0
        assert len(stack.recorder.of_kind("elect")) >= 2
    tp = p.planes[1][0]
    assert tp.registry.get("raft_commits_total").value(group="0") == \
        p.t.committed_total
    assert any(sp.read_class == "read_index" for sp in tp.spans.spans)
    assert more  # submitted under the failover: durable or dropped alike


def test_fused_booking_at_fuse_k_8(monkeypatch):
    """Both engines at ``fuse_k = 8``: the fused windows' per-entry
    booking (spans, metrics, SLO, auditor span feed, the floor events
    once the ring laps) equals the JAX booking event for event."""
    import raft_tpu.raft.engine as jengine
    import raft_tpu_torch.raft.engine as tengine

    monkeypatch.setattr(jengine, "_pipeline_backend_ok", lambda: True)
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)
    p = ObsPair(22, fuse_k=8)
    p.until_leader()
    warm = p.submit_spanned(payloads(8, 30))
    p.until_committed(warm[-1])
    p.run_fused(4.0)
    seqs = p.submit_spanned(payloads(200, 31))   # past one ring lap
    p.run_fused(60.0)
    p.check_all()
    assert p.t.fused_launches > 0 and p.t.fused_ticks > p.t.fused_launches
    assert all(p.t.is_durable(s) for s in seqs)
    for stack, _ in p.planes:
        spans_reach_applied(stack, warm + seqs)
        assert stack.recorder.of_kind("repair_floor_raise")
        assert stack.audit.total_violations == 0


def test_fused_artifacts_equal_the_tick_path():
    """The port at ``fuse_k = 8`` and at 1 on one schedule: the recorder
    dump, span table and metrics text are equal, and so is the auditor's
    record apart from its count of audited events (a fused window is one
    event)."""
    got = []
    for fuse_k in (1, 8):
        cfg = TConfig(**KW, seed=23, fuse_k=fuse_k)
        stack, board = build_plane(PACKAGES[1], {})
        e = TEngine(cfg, transports(KW)[1], recorder=stack.recorder)
        attach(e, stack, board)
        e.run_until_leader()
        for x in payloads(100, 23):
            stack.spans.current = stack.spans.begin("write", e.clock.now)
            e.submit(x)
            stack.spans.current = None
        e.run_for(60.0)
        a = artifacts(e, stack, board)
        for k in ("audit", "audit_summary"):
            a[k].pop("ticks_audited")
        got.append((e.fused_launches, a))
    assert got[0][0] == 0 and got[1][0] > 0
    for k in ("events", "spans", "prometheus", "registry", "audit",
              "audit_summary", "commit_digest"):
        assert json.dumps(got[1][1][k]) == json.dumps(got[0][1][k]), k


def test_pipelined_flight_with_the_plane(monkeypatch):
    """A whole-ring ``submit_pipelined`` flight (the JAX side's K3/K4 in
    Pallas interpret mode, the port's plain versions) with the plane
    attached: commits, spans and the auditor's archive feed equal."""
    import raft_tpu.raft.engine as jengine
    import raft_tpu_torch.raft.engine as tengine

    monkeypatch.setattr(jengine, "_pipeline_backend_ok", lambda: True)
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)
    p = ObsPair(9, entry_bytes=8, batch_size=128, log_capacity=1024)
    p.until_leader()
    warm = p.submit_spanned(payloads(128, 10, entry=8))
    p.until_committed(warm[-1])
    p.run_for(4.0)
    with pallas_interpret():
        seqs = p.both("submit_pipelined", payloads(1024, 11, entry=8))
    p.run_for(4.0)
    p.check_all()
    assert all(p.t.is_durable(s) for s in seqs)
    tp = p.planes[1][0]
    assert tp.audit.total_violations == 0
    assert tp.registry.get("raft_commits_total").value(group="0") == 1152


def test_restore_reattaches_the_auditor(tmp_path):
    """A checkpoint, then both engines restored with the same planes: the
    recorder spans the cycle, ``on_attach`` re-checks the restored prefix
    against the audit record, and the run goes on equal."""
    p = ObsPair(24)
    p.until_leader()
    seqs = p.submit_spanned(payloads(40, 24))
    p.until_committed(seqs[-1])
    p.run_for(4.0)
    paths = (str(tmp_path / "j.npz"), str(tmp_path / "t.npz"))
    p.j.save_checkpoint(paths[0])
    p.t.save_checkpoint(paths[1])
    q = ObsPair(24, planes=p.planes, lines=p.tl, restore_from=paths)
    q.until_leader()
    more = q.submit_spanned(payloads(10, 25))
    q.until_committed(more[-1])
    q.run_for(4.0)
    q.check_all()
    for stack, _ in q.planes:
        assert stack.audit.total_violations == 0
        assert stack.recorder.of_kind("restore")


# --------------------------------------------------------- no-fetch contract
def counted_engine(monkeypatch, attach_plane, trace=None, recorder=None,
                   seed=25):
    cfg = TConfig(**KW, seed=seed)
    e = TEngine(cfg, transports(KW)[1], trace=trace, recorder=recorder)
    n = [0]
    orig = e._fetch

    def fetch(x):
        n[0] += 1
        return orig(x)

    monkeypatch.setattr(e, "_fetch", fetch)
    if attach_plane:
        stack, board = build_plane(PACKAGES[1], {})
        stack.attach(e)
        e.recorder = None        # spans, metrics, auditor, SLO, board only
        e.status_board = board
    return e, n


def drive(e):
    e.run_until_leader()
    seqs = [e.submit(x) for x in payloads(40, 26)]
    e.run_until_committed(seqs[-1])
    e.read_linearizable()
    e.fail(e.leader_id)
    e.run_until_leader()
    e.run_for(10.0)


def test_nodelog_without_sinks_fetches_nothing(monkeypatch):
    e, n = counted_engine(monkeypatch, attach_plane=False)
    assert e.nodelog(0, "probe") == ""
    assert n[0] == 0
    e2, n2 = counted_engine(monkeypatch, attach_plane=True)
    assert e2.nodelog(0, "probe") == "" and n2[0] == 0


def test_attached_plane_adds_no_device_fetch(monkeypatch):
    """The zero-extra-sync contract: the same run fetches as often with
    the plane attached (no recorder, no trace) as with nothing attached;
    a trace sink costs fetches, which is what the contract excludes."""
    bare, nb = counted_engine(monkeypatch, attach_plane=False)
    drive(bare)
    plane, npl = counted_engine(monkeypatch, attach_plane=True)
    drive(plane)
    assert npl[0] == nb[0] > 0
    assert plane.commit_watermark == bare.commit_watermark
    assert plane.auditor.total_violations == 0
    lines = []
    traced, nt = counted_engine(monkeypatch, attach_plane=False,
                                trace=lines.append)
    drive(traced)
    assert nt[0] > nb[0]


def test_recorder_events_equal_jax_with_no_trace():
    """A recorder without a trace callback: the engines fetch for the
    nodelog header and record identical events."""
    from raft_tpu.obs.events import FlightRecorder as JRec
    from raft_tpu_torch.obs.events import FlightRecorder as TRec

    jr, tr = JRec(), TRec()
    j = JEngine(JConfig(**KW, seed=27), transports(KW)[0], recorder=jr)
    t = TEngine(TConfig(**KW, seed=27), transports(KW)[1], recorder=tr)
    for e in (j, t):
        drive(e)
    assert json.dumps(tr.to_jsonable()) == json.dumps(jr.to_jsonable())
    assert tr.leaders_by_term() == jr.leaders_by_term()


def test_status_snapshot_is_host_only():
    p = ObsPair(28, read_lease=True, prevote=True)
    p.until_leader()
    p.submit_spanned(payloads(10, 28))
    p.run_for(6.0)
    p.spanned("read_linearizable")
    snap = p.t._status_snapshot()

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, list):
            for v in x:
                yield from leaves(v)
        else:
            yield x

    assert all(type(v) in (int, float, str, bool, type(None))
               for v in leaves(snap))
    assert "reads" in snap and "audit" in snap
    assert not isinstance(p.t.commit_watermark, np.generic)


@pytest.mark.parametrize("kind", ["write", "read"])
def test_admission_sheds_reach_spans_and_metrics(kind):
    """An admission refusal: the ambient span records the reason and
    ``raft_sheds_total{reason}`` counts it, in both packages alike."""
    over = dict(admission_max_writes=2, admission_max_reads=1)
    p = ObsPair(29, **over)
    p.until_leader()
    if kind == "write":
        p.submit_spanned(payloads(2, 29))
        for e, (stack, _) in zip((p.j, p.t), p.planes):
            stack.spans.current = stack.spans.begin("write", e.clock.now)
        p.both_raise("submit", payloads(1, 30)[0])
    else:
        p.spanned("submit_read")
        for e, (stack, _) in zip((p.j, p.t), p.planes):
            stack.spans.current = stack.spans.begin("read", e.clock.now)
        p.both_raise("submit_read")
    for stack, _ in p.planes:
        stack.spans.current = None
    p.check()
    text = p.planes[1][0].registry.to_prometheus()
    assert "raft_sheds_total" in text
