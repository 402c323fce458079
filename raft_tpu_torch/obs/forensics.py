"""Chaos forensics (port of ``raft_tpu/obs/forensics.py``): repro bundles
and failure-timeline reconstruction.

Before this module, a failing torture run left behind exactly one
artifact: a seed number to re-run. A repro bundle captures what the run
already knew at the moment the verdict came back wrong — the flight
recorder's event ring, the realized fault schedule, the client op
history, span table, metrics snapshot, seed and config — as one JSON
file, and ``explain()`` (exposed as ``python -m raft_tpu_torch.obs --explain``)
reconstructs the minimal failure timeline from it WITHOUT re-running the
seed: the last leader of each term, the faults in flight around the
violation, and the op that broke linearizability.

The JAX package's chaos runners write bundles whenever a run ends in
anything but its expected verdict and a destination is configured
(``bundle_dir=`` argument, or the ``RAFT_TPU_BUNDLE_DIR`` environment
variable); the port's runners come with ROADMAP A17. The bundle format is
the JAX package's, so either package's CLI explains either's bundles.
``ObsStack.build(device=True)`` adds the device plane (``obs.device``): a
bundle then carries the decoded device ring, which ``explain`` summarises
and interleaves into the timeline. ``compile_plane=True`` adds the
compile and memory planes (``obs.compile``, ``obs.memory``): a bundle
then carries the compile log and the memory census, which ``explain``
reads for ``RETRACE:`` and ``CENSUS GREW`` lines.

Joined wire forensics: a bundle may carry TWO span tables —
``spans`` (the process's own) and ``client_spans`` (the wire-client
side, when one process ran both ends, as the chaos wire drill does) —
and :func:`explain_joined` reconstructs ONE causal timeline per wire
op by joining span tables on ``wire_trace``: client attempt N → wire
frame → ingest batch (pump iteration) → tick/launch → completion sweep
→ response, across however many artifacts the two processes left
behind. ``python -m raft_tpu_torch.obs --explain CLIENT.json SERVER.json``
(any number of paths) is the CLI entry; nothing re-runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BUNDLE_FORMAT = "raft_tpu.obs/bundle.v1"   # shared with the JAX package


@dataclasses.dataclass
class ObsStack:
    """The per-run observability plane a run attaches: one flight
    recorder, span tracker and metrics registry, plus the safety auditor
    and SLO tracker when asked for, and with ``device=True`` the device
    plane (``obs.device.DeviceObs``, decoded at every launch boundary),
    shared by every engine the run boots (across crash-restore cycles
    too: each fresh engine gets a fresh ring, the DeviceObs accumulates),
    and with ``compile_plane=True`` the compile watch (with its retrace
    sentinel) and the memory watch."""

    recorder: Any
    spans: Any
    registry: Any
    device: Any = None
    audit: Any = None          # obs.audit.SafetyAuditor (online plane)
    slo: Any = None            # obs.slo.SloTracker (online plane)
    compile: Any = None        # obs.compile.CompileWatch (compile plane)
    memory: Any = None         # obs.memory.MemoryWatch (memory plane)

    @classmethod
    def build(cls, capacity: int = 65536, device: bool = False,
              audit: bool = False, slo_objectives=None,
              compile_plane: bool = False) -> "ObsStack":
        from raft_tpu_torch.obs.events import FlightRecorder
        from raft_tpu_torch.obs.registry import MetricsRegistry
        from raft_tpu_torch.obs.spans import SpanTracker

        dev = None
        if device:
            from raft_tpu_torch.obs.device import DeviceObs

            dev = DeviceObs()
        recorder = FlightRecorder(capacity=capacity)
        registry = MetricsRegistry()
        auditor = tracker = None
        if audit or slo_objectives is not None:
            from raft_tpu_torch.obs.audit import SafetyAuditor
            from raft_tpu_torch.obs.slo import SloTracker

            auditor = SafetyAuditor(recorder=recorder, registry=registry)
            tracker = SloTracker(
                objectives=tuple(slo_objectives or ()),
                recorder=recorder, registry=registry,
            )
        watch = memwatch = None
        if compile_plane:
            from raft_tpu_torch.obs.compile import (
                CompileWatch,
                RetraceSentinel,
            )
            from raft_tpu_torch.obs.memory import MemoryWatch

            watch = CompileWatch(recorder=recorder, registry=registry)
            RetraceSentinel(watch)
            watch.install()
            memwatch = MemoryWatch(registry=registry, recorder=recorder)
        return cls(
            recorder=recorder,
            spans=SpanTracker(),
            registry=registry,
            device=dev,
            audit=auditor,
            slo=tracker,
            compile=watch,
            memory=memwatch,
        )

    def attach(self, engine) -> None:
        """Point an engine's observability hooks at this stack."""
        engine.recorder = self.recorder
        engine.spans = self.spans
        engine.metrics = self.registry
        if self.audit is not None:
            engine.auditor = self.audit
            # re-attachment across a crash-restore cycle re-verifies
            # the restored committed state against the audit record
            self.audit.on_attach(engine)
        if self.slo is not None:
            engine.slo = self.slo
        if self.device is not None and hasattr(engine, "attach_device_obs"):
            engine.attach_device_obs(self.device)
        if self.memory is not None:
            # re-attachment replaces the previous generation's weakref
            # getters: the census follows the LIVE engine across
            # crash-restore cycles (old generations must collect away)
            self.memory.watch_engine(engine)

    def close(self) -> None:
        """Detach the process-global hook (the installed compile watch).
        Runners call this when the run ends so one run's plane never
        bleeds into the next."""
        if self.compile is not None:
            self.compile.uninstall()


def resolve_bundle_dir(bundle_dir: Optional[str]) -> Optional[str]:
    """The runner's destination policy: explicit argument, else the
    ``RAFT_TPU_BUNDLE_DIR`` environment variable, else disabled."""
    if bundle_dir is not None:
        return bundle_dir
    return os.environ.get("RAFT_TPU_BUNDLE_DIR") or None


def _b2s(b: Optional[bytes]) -> Optional[str]:
    return None if b is None else b.decode("latin1")


def history_jsonable(history) -> List[dict]:
    return [
        {
            "client": rec.client, "op": rec.op, "key": _b2s(rec.key),
            "value": _b2s(rec.value), "invoke_t": rec.invoke_t,
            "complete_t": rec.complete_t, "status": rec.status,
        }
        for rec in history.ops
    ]


def write_bundle(
    bundle_dir: str,
    *,
    kind: str,
    seed: int,
    expected: str,
    verdict: str,
    detail: str = "",
    violation_key: Optional[bytes] = None,
    repro: str = "",
    config: Optional[object] = None,
    nemesis_log: Optional[List[str]] = None,
    history=None,
    obs: Optional[ObsStack] = None,
    spans=None,
    client_spans=None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write one repro bundle; returns the bundle file path.

    ``spans`` overrides the span table when no full ObsStack exists
    (a wire-client-side artifact is just a SpanTracker); ``client_spans``
    adds the client-side table ALONGSIDE a server-side stack when one
    process ran both ends of the wire (the chaos wire drill) — the
    input :func:`explain_joined` joins on."""
    Path(bundle_dir).mkdir(parents=True, exist_ok=True)
    span_table = None
    if spans is not None:
        span_table = spans.to_jsonable()
    elif obs is not None:
        span_table = obs.spans.to_jsonable()
    bundle = {
        "format": BUNDLE_FORMAT,
        "kind": kind,
        "seed": seed,
        "expected": expected,
        "verdict": verdict,
        "detail": detail,
        "violation_key": _b2s(violation_key),
        "repro": repro,
        "config": (
            dataclasses.asdict(config) if dataclasses.is_dataclass(config)
            else config
        ),
        "faults": list(nemesis_log or []),
        "history": history_jsonable(history) if history is not None else [],
        "events": obs.recorder.to_jsonable() if obs is not None else None,
        "spans": span_table,
        "client_spans": (client_spans.to_jsonable()
                         if client_spans is not None else None),
        "metrics": obs.registry.to_json() if obs is not None else None,
        "device_ring": (
            obs.device.to_jsonable()
            if obs is not None and getattr(obs, "device", None) is not None
            else None
        ),
        "audit": (
            obs.audit.to_jsonable()
            if obs is not None and getattr(obs, "audit", None) is not None
            else None
        ),
        "slo": (
            obs.slo.snapshot()
            if obs is not None and getattr(obs, "slo", None) is not None
            else None
        ),
        "compile_log": (
            obs.compile.snapshot()
            if obs is not None
            and getattr(obs, "compile", None) is not None
            else None
        ),
        "memory": (
            obs.memory.snapshot()
            if obs is not None
            and getattr(obs, "memory", None) is not None
            else None
        ),
        "extra": extra or {},
    }
    path = Path(bundle_dir) / f"bundle_{kind}_seed{seed}.json"
    path.write_text(json.dumps(bundle))
    return str(path)


def load_bundle(path: str) -> dict:
    bundle = json.loads(Path(path).read_text())
    if bundle.get("format") != BUNDLE_FORMAT:
        raise ValueError(
            f"{path}: not a raft_tpu repro bundle "
            f"(format={bundle.get('format')!r})"
        )
    return bundle


# -------------------------------------------------- joined wire explain
def _wire_sides(bundles: List[dict]):
    """Partition every wire-traced span across the artifacts into
    (client, server) lists. The discriminator is structural, not
    positional: a span that MINTED its trace has no ``parent_span``
    (the client op root); a span that ADOPTED a remote parent is the
    server side — so it does not matter which artifact carried which
    table, or whether one bundle carried both."""
    from raft_tpu_torch.obs.spans import spans_from_jsonable

    client, server = [], []
    for b in bundles:
        for key in ("spans", "client_spans"):
            tbl = b.get(key)
            if not tbl:
                continue
            for sp in spans_from_jsonable(tbl):
                if sp.wire_trace is None:
                    continue
                (client if sp.parent_span is None else server).append(sp)
    return client, server


def _span_entries(sp, side: str):
    """(t, side, text) timeline entries for one span, in the span's
    own causal (annotation) order."""
    out = []
    label = f"begin {sp.op}"
    if sp.key:
        label += f" key={sp.key.decode('latin1')!r}"
    if side == "server" and sp.client is not None:
        label += f" ({sp.client})"
    out.append((sp.t_start, side, label))
    for t, name, fields in sp.annotations:
        if name.startswith("end:"):
            continue
        desc = name + "".join(
            f" {k}={v}" for k, v in fields.items() if v is not None
        )
        out.append((t, side, desc))
    t_end = sp.t_end if sp.t_end is not None else sp.t_start
    end = f"end:{sp.state}"
    if sp.refusal_reasons:
        end += f" refusals={','.join(sp.refusal_reasons)}"
    out.append((t_end, side, end))
    return out


def explain_joined(bundles: List[dict], max_traces: int = 64) -> str:
    """ONE causal timeline per wire op, joined across both processes'
    span tables on ``wire_trace`` — client attempt N → wire frame →
    ingest batch → tick/launch → completion sweep → response — from
    the artifacts alone (nothing re-runs). A client op with retries
    joins to SEVERAL server spans (one per wire frame); all of them
    render into the op's single timeline."""
    client, server = _wire_sides(bundles)
    by_trace: Dict[int, Tuple[list, list]] = {}
    for sp in client:
        by_trace.setdefault(sp.wire_trace, ([], []))[0].append(sp)
    for sp in server:
        by_trace.setdefault(sp.wire_trace, ([], []))[1].append(sp)
    out = [
        f"joined wire forensics: {len(by_trace)} trace(s) — "
        f"{len(client)} client op(s), {len(server)} server span(s)"
    ]

    def _severity(tid: int) -> tuple:
        # non-ok ops are the forensic signal: render them FIRST so the
        # max_traces elision can only ever drop clean ops
        cs, ss = by_trace[tid]
        ok = all(sp.state == "ok" for sp in cs + ss)
        return (1 if ok else 0, tid)

    shown = 0
    for tid in sorted(by_trace, key=_severity):
        cs, ss = by_trace[tid]
        if shown >= max_traces:
            out.append(
                f"... {len(by_trace) - shown} more trace(s) elided "
                f"(max_traces={max_traces})"
            )
            break
        shown += 1
        root = cs[0] if cs else ss[0]
        head = f"trace 0x{tid:x}: {root.op}"
        if root.key:
            head += f" key={root.key.decode('latin1')!r}"
        if cs:
            head += f" -> {cs[0].state}"
            if cs[0].refusal_reasons:
                head += f" ({cs[0].refusal_reasons[-1]})"
            if cs[0].retries:
                head += f" after {cs[0].retries} retr" + (
                    "y" if cs[0].retries == 1 else "ies")
            if cs[0].redials:
                head += f", {cs[0].redials} redial(s)"
        if not ss:
            head += " [no server span joined]"
        elif not cs:
            head += " [no client span joined]"
        out.append(head)
        # CAUSAL merge, not a timestamp sort: the virtual clock often
        # stamps a whole request/response exchange with ONE time, and
        # the two processes' clocks need not even agree — but the
        # client saga's annotation order is authoritative, and every
        # response annotation carries the answering server span's id
        # (``server_span=``), so each server span ANCHORS exactly
        # before the client entry that observed its response.
        entries = []            # (rank tuple, t, side, text)
        pos = 0
        anchor: Dict[int, int] = {}
        for sp in cs:
            base = pos
            for t, side, text in _span_entries(sp, "client"):
                entries.append(((pos, 1, 0, 0), t, side, text))
                pos += 1
            j = base + 1        # entry index of the first annotation
            for _t, name, fields in sp.annotations:
                if name.startswith("end:"):
                    continue
                ssid = fields.get("server_span")
                if ssid is not None and ssid not in anchor:
                    anchor[ssid] = j
                j += 1
        for o, sp in enumerate(ss):
            sid = sp.span_id if sp.span_id is not None else sp.trace_id
            base = anchor.get(sid, pos)
            for k, (t, side, text) in enumerate(
                _span_entries(sp, "server")
            ):
                # all of a server span's entries land just BEFORE the
                # client entry that saw its response (rank slot 0 < the
                # client's slot 1 at the same base); `o` keeps two
                # spans sharing one base — e.g. two never-answered
                # attempts — as intact blocks instead of interleaving
                # line-by-line, and `k` keeps each span's own order
                entries.append(((base, 0, o, k), t, side, text))
        entries.sort(key=lambda e: e[0])
        out.extend(
            f"  [{side}] t={t:<10.4f} {text}"
            for _rank, t, side, text in entries
        )
    return "\n".join(out)


# --------------------------------------------------------------- explain
_FAULT_T = re.compile(r"^t=(?P<t>[0-9.]+)\s+(?P<desc>.*)$")


def _suspect_op(bundle: dict) -> Optional[dict]:
    """Name the op that broke linearizability, from the recorded history
    alone (no checker re-run): on the checker's offending key, the first
    OK read whose returned value either was never written, was written
    by an op that provably failed, or was invoked only AFTER the read
    completed. Falls back to None when the heuristic finds nothing —
    the per-key timeline is still printed either way."""
    key = bundle.get("violation_key")
    if key is None:
        return None
    kops = [op for op in bundle["history"] if op["key"] == key]
    writers: Dict[Optional[str], dict] = {}
    for op in kops:
        if op["op"] in ("write", "delete"):
            val = op["value"] if op["op"] == "write" else None
            writers.setdefault(val, op)
    for op in kops:
        if op["op"] != "read" or op["status"] != "ok":
            continue
        w = writers.get(op["value"])
        if op["value"] is not None and w is None:
            return dict(op, why="read a value no client ever wrote")
        if w is None:
            continue
        if w["status"] == "fail" and op["value"] is not None:
            # None is also the key's INITIAL state, so a read of None
            # after a failed delete is perfectly linearizable — only a
            # concrete value proves the reader saw the failed writer
            return dict(
                op, why="read a value whose write provably took no effect"
            )
        if (op["complete_t"] is not None
                and w["invoke_t"] > op["complete_t"]):
            return dict(op, why="read a value written only later")
    # new-then-old inversion (the dirty-read signature): a read returns
    # value v_new, and a LATER read returns v_old whose write began
    # before v_new's write — no linearization can order both.
    ok_reads = [op for op in kops
                if op["op"] == "read" and op["status"] == "ok"]
    for i, r1 in enumerate(ok_reads):
        w1 = writers.get(r1["value"])
        if w1 is None or r1["complete_t"] is None:
            continue
        for r2 in ok_reads[i + 1:]:
            if r2["invoke_t"] < r1["complete_t"]:
                continue            # concurrent reads constrain nothing
            w2 = writers.get(r2["value"])
            if w2 is not None and w2["invoke_t"] < w1["invoke_t"]:
                return dict(
                    r2, why=(
                        f"stale read: returned {r2['value']!r} after an "
                        f"earlier read already returned the newer "
                        f"{r1['value']!r}"
                    ),
                )
    return None


def explain(bundle: dict) -> str:
    """The minimal failure timeline, reconstructed from a bundle."""
    out: List[str] = []
    out.append(
        f"{bundle['kind']} seed {bundle['seed']}: verdict "
        f"{bundle['verdict']} (expected {bundle['expected']})"
    )
    if bundle.get("detail"):
        out.append(f"  checker: {bundle['detail']}")
    if bundle.get("repro"):
        out.append(f"  repro:   {bundle['repro']}")

    # -- last leader per term (flight recorder) -------------------------
    events = bundle.get("events")
    if events and events.get("events"):
        from raft_tpu_torch.obs.events import Event

        evs = [Event.from_jsonable(d) for d in events["events"]]
        last_leader: Dict[tuple, Any] = {}
        for e in evs:
            if e.kind == "elect":
                last_leader[(e.group, e.term)] = e
        if last_leader:
            out.append("last leader per term:")
            for (g, term), e in sorted(
                last_leader.items(), key=lambda kv: (kv[0][0] or 0, kv[0][1])
            ):
                scope = f"g{g} " if g is not None else ""
                out.append(
                    f"  {scope}term {term}: {e.node} "
                    f"(elected t={e.t_virtual:.1f})"
                )
        if events.get("dropped"):
            out.append(
                f"  (ring overflowed: {events['dropped']} oldest events "
                "dropped)"
            )
    else:
        out.append("last leader per term: no flight recorder data "
                   "(run with observe=True for the full ring)")

    # -- the violating op ----------------------------------------------
    suspect = _suspect_op(bundle)
    key = bundle.get("violation_key")
    t_focus = None
    if suspect is not None:
        t_focus = suspect.get("complete_t") or suspect.get("invoke_t")
        out.append(
            f"violating op: client {suspect['client']} read "
            f"{suspect['key']!r} -> {suspect['value']!r} "
            f"[{suspect['invoke_t']:.2f}, {suspect['complete_t']:.2f}] "
            f"— {suspect['why']}"
        )
    elif key is not None:
        out.append(
            f"violating op: not isolated by heuristic; offending key "
            f"{key!r} timeline below"
        )

    # -- device plane (obs.device: in-kernel event ring) ---------------
    dev_entries = []
    dr = bundle.get("device_ring")
    if dr is not None:
        from raft_tpu_torch.obs.events import Event

        dev_evs = [Event.from_jsonable(d) for d in dr.get("events", [])]
        by_kind: Dict[str, int] = {}
        for e in dev_evs:
            by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
        kinds = ", ".join(f"{k}={n}" for k, n in sorted(by_kind.items()))
        out.append(
            f"device ring: {dr.get('total_recorded', len(dev_evs))} "
            f"records ({kinds or 'none'})"
        )
        if dr.get("dropped"):
            out.append(
                f"  (ring lapped {dr.get('laps', 0)}x: "
                f"{dr['dropped']} oldest device records dropped)"
            )
        dev_entries = [
            (
                e.t_virtual,
                f"[device] {e.kind} {e.node} term={e.term}"
                + (f" commit={e.commit_index}"
                   if e.kind == "commit" else "")
                + (f" aux={e.fields.get('aux')}"
                   if e.kind in ("repair_floor", "step_down") else ""),
            )
            for e in dev_evs
        ]

    # -- compile plane (obs.compile: retraces + sentinel) ---------------
    cl = bundle.get("compile_log")
    if cl is not None:
        sent = cl.get("sentinel") or {}
        viols = sent.get("violations") or []
        post_freeze = [
            r for r in cl.get("log", [])
            if r.get("frozen") and r.get("event") in ("trace", "compile")
        ]
        out.append(
            f"compile plane: {cl.get('total_traces', 0)} traces, "
            f"{cl.get('total_compiles', 0)} compiles "
            f"({cl.get('total_compile_s', 0.0):.2f}s), "
            f"{len(viols)} hot-path violation(s)"
        )
        for v in viols[:6]:
            shapes = v.get("arg_shapes")
            out.append(
                f"  RETRACE: post-freeze {v['event']} on "
                f"{v['program']!r} at t_wall={v['t_wall']:.1f}s"
                + (f" args=({', '.join(shapes)})" if shapes else "")
            )
        if not viols and post_freeze:
            progs = sorted({r["program"] for r in post_freeze})
            out.append(
                f"  (post-freeze compiles off the hot paths: "
                f"{', '.join(progs)})"
            )

    # -- memory plane (obs.memory: census growth) -----------------------
    mem = bundle.get("memory")
    if mem is not None and mem.get("census"):
        cur, base = mem["census"], mem.get("baseline")
        line = (
            f"memory plane: {cur['n_arrays']} live buffers, "
            f"{cur['total_bytes']} bytes "
            f"(high water {mem.get('high_water_bytes', 0)})"
        )
        out.append(line)
        if base is not None:
            growth = cur["total_bytes"] - base["total_bytes"]
            if growth > 0:
                out.append(
                    f"  CENSUS GREW: {growth:+d} bytes over baseline "
                    f"({base['total_bytes']} -> {cur['total_bytes']}) — "
                    "possible leak across crash-restore/migration"
                )
        don = mem.get("donation")
        if don is not None and not don.get("engaged", True):
            out.append(
                f"  donation IGNORED on backend "
                f"{don.get('backend')!r}: {don.get('detail')}"
            )

    # -- faults in flight (device events interleaved) ------------------
    faults = []
    for line in bundle.get("faults", []):
        m = _FAULT_T.match(line)
        if m:
            faults.append((float(m["t"]), m["desc"]))
    timeline = sorted(faults + dev_entries, key=lambda f: f[0])
    if timeline:
        if t_focus is not None:
            window = [f for f in timeline if f[0] <= t_focus]
            window = window[-(6 + min(len(dev_entries), 6)):]
            label = f"timeline before t={t_focus:.1f}:"
        else:
            window = timeline[-12:]
            label = "final fault/device timeline:"
        out.append(label)
        out.extend(f"  t={t:>8.1f}  {d}" for t, d in window)

    # -- the offending key's op timeline -------------------------------
    if key is not None:
        kops = [op for op in bundle["history"] if op["key"] == key]
        out.append(f"key {key!r} history ({len(kops)} ops):")
        for op in kops:
            end = ("inf" if op["complete_t"] is None
                   else f"{op['complete_t']:.2f}")
            mark = (" <== violation" if suspect is not None
                    and op["invoke_t"] == suspect["invoke_t"]
                    and op["client"] == suspect["client"] else "")
            out.append(
                f"  c{op['client']:<4} {op['op']:<6} "
                f"{(op['value'] or ''):<12} [{op['invoke_t']:.2f}, {end}] "
                f"{op['status']}{mark}"
            )
    return "\n".join(out)
