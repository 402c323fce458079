"""Live ops surface (port of ``raft_tpu/obs/serve.py``): a lock-free
status board and a stdlib HTTP endpoint.

The metrics registry, SLO tracker and safety auditor are all host-side
state mutated by the single engine thread. This module makes them
scrapeable while the engine runs, without locks on the hot path:

- :class:`StatusBoard` — the engine publishes an IMMUTABLE snapshot
  dict at each flush boundary (one attribute assignment — atomic under
  the GIL, so the server thread always reads a complete snapshot,
  never a half-mutated engine). Publishing costs a small dict build
  from host mirrors the engine already maintains: zero device syncs,
  determinism-neutral, and a ``None`` check is the only cost when no
  board is attached.
- :class:`OpsServer` — ``http.server`` over an ephemeral (or fixed)
  port, serving:

  ==========  ==========================================================
  endpoint    body
  ==========  ==========================================================
  /metrics    Prometheus text exposition of the attached registry
  /healthz    ``{"status": "ok", ...}`` liveness (always 200 once bound)
  /slo        the SLO tracker's snapshot (objectives, digests, burn
              rates, active + recent alerts) as JSON
  /status     the board's composed snapshot: leader map, per-group
              term/commit/applied watermarks, replication lag, queue
              depths, audit summary, breaker state — plus ``compile``
              and ``memory`` summary sections when those planes are
              attached, ``tiered``/``catchup`` sections (seal
              tallies, RS reconstructs, live snapshot-chunk streams)
              when the tiered log store is configured, and a ``net``
              section (connections, draining, in-flight frames,
              bytes in/out, per-reason wire refusals, staged-ingest
              split — plus a ``pump`` block with per-phase
              µs/iteration, attribution coverage and the
              coalesce-batch / frame-queue-age percentiles when a
              ``PumpProfiler`` is attached) when a
              ``raft_tpu.net.IngestServer`` publishes to the same
              board — JSON
  /compile    the compile watch's snapshot (programs, traces, compiles,
              the event log, the retrace sentinel's verdicts)
  /memory     the memory watch's snapshot after a fresh census (the
              CUDA allocator's counters beside it on the card)
  /profile    ``?seconds=N`` (clamped to [0.05, 30], default 1):
              capture N seconds of ``torch.profiler`` trace while the
              engine runs, merged with the span export into one
              timeline artifact; answers the artifact path and event
              counts, 400 for a non-finite N, 409 while another
              capture runs
  ==========  ==========================================================

Thread-safety contract: ``/status`` and ``/healthz`` serve from
published immutable snapshots only. ``/metrics``, ``/slo`` and the
``/status`` audit fallback render live single-writer state (per-sample
values are plain in-place updates); the one racy case — a container
growing mid-render (new metric/label/digest key) — is retried a few
times scrape-side, which is the standard answer for a pull endpoint.

``python -m raft_tpu_torch.obs --serve`` boots the demo (:func:`serve_demo`):
a ``MultiEngine`` with the full online plane and the compile and memory
watches, on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


class StatusBoard:
    """Single-writer, many-reader snapshot rendezvous. Sections are
    independent publishers (the engine's ``"engine"`` section, a
    Router's ``"breakers"``): each ``publish`` swaps that section's
    snapshot reference; ``compose`` merges current references into one
    dict without touching any publisher's internals."""

    def __init__(self) -> None:
        self._sections: dict = {}
        self.generation = 0

    def publish(self, snapshot: dict, section: str = "engine") -> None:
        """Swap in ``snapshot`` (treated as immutable from here on)."""
        # rebuild the section dict instead of mutating it: readers hold
        # the OLD composed dict, which must stay internally consistent
        sections = dict(self._sections)
        sections[section] = snapshot
        self._sections = sections
        self.generation += 1

    def compose(self) -> dict:
        sections = self._sections       # one read: a consistent set
        out = dict(sections.get("engine", {}))
        for name, snap in sections.items():
            if name != "engine":
                out[name] = snap
        out["board_generation"] = self.generation
        return out


class OpsServer:
    """The ops endpoint (module docstring). ``port=0`` binds an
    ephemeral port (read ``.port`` after ``start()``)."""

    def __init__(
        self,
        board: Optional[StatusBoard] = None,
        registry=None,
        slo=None,
        auditor=None,
        compile_watch=None,
        memory=None,
        spans=None,
        profile_dir: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self.board = board
        self.registry = registry
        self.slo = slo
        self.auditor = auditor
        self.compile_watch = compile_watch
        self.memory = memory
        self.spans = spans
        self.profile_dir = profile_dir
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ serve
    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        ops = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # quiet by default
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "application/json") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            @staticmethod
            def _render_live(fn):
                """Render live single-writer state with scrape-side
                retries: a dict growing mid-iteration (new metric /
                digest key / active alert) raises RuntimeError — retry
                against the fresh state instead of 500ing the scrape."""
                for attempt in range(3):
                    try:
                        return fn()
                    except RuntimeError:
                        if attempt == 2:
                            raise

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    if ops.registry is None:
                        self._send(404, json.dumps(
                            {"error": "no metrics registry attached"}))
                        return
                    text = self._render_live(ops.registry.to_prometheus)
                    self._send(
                        200, text,
                        ctype="text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/healthz":
                    snap = ops.board.compose() if ops.board else {}
                    self._send(200, json.dumps({
                        "status": "ok" if snap else "no-engine",
                        "t_virtual": snap.get("t_virtual"),
                        "generation": snap.get("board_generation", 0),
                    }))
                elif path == "/slo":
                    if ops.slo is None:
                        self._send(404, json.dumps(
                            {"error": "no SLO tracker attached"}))
                        return
                    body = self._render_live(
                        lambda: json.dumps(ops.slo.snapshot())
                    )
                    self._send(200, body)
                elif path == "/status":
                    if ops.board is None:
                        self._send(404, json.dumps(
                            {"error": "no status board attached"}))
                        return
                    def _compose():
                        snap = ops.board.compose()
                        if (ops.auditor is not None
                                and "audit" not in snap):
                            snap["audit"] = ops.auditor.summary()
                        if (ops.compile_watch is not None
                                and "compile" not in snap):
                            snap["compile"] = ops.compile_watch.summary()
                        if (ops.memory is not None
                                and "memory" not in snap):
                            snap["memory"] = ops.memory.summary()
                        return json.dumps(snap)
                    self._send(200, self._render_live(_compose))
                elif path == "/compile":
                    if ops.compile_watch is None:
                        self._send(404, json.dumps(
                            {"error": "no compile watch attached"}))
                        return
                    body = self._render_live(
                        lambda: json.dumps(ops.compile_watch.snapshot())
                    )
                    self._send(200, body)
                elif path == "/memory":
                    if ops.memory is None:
                        self._send(404, json.dumps(
                            {"error": "no memory watch attached"}))
                        return
                    body = self._render_live(
                        lambda: json.dumps(
                            ops.memory.snapshot(census=True))
                    )
                    self._send(200, body)
                elif path == "/profile":
                    from raft_tpu_torch.obs import profiling

                    try:
                        seconds = float(
                            parse_qs(
                                urlparse(self.path).query
                            ).get("seconds", ["1"])[0]
                        )
                    except ValueError:
                        seconds = float("nan")
                    if not math.isfinite(seconds):
                        self._send(400, json.dumps(
                            {"error": "seconds must be a finite number"}))
                        return
                    seconds = min(max(seconds, 0.05), 30.0)
                    try:
                        result = profiling.capture_profile(
                            seconds, spans=ops.spans,
                            profile_dir=ops.profile_dir,
                        )
                    except profiling.CaptureBusy as ex:
                        self._send(409, json.dumps({"error": str(ex)}))
                        return
                    self._send(200, json.dumps(result))
                else:
                    self._send(404, json.dumps({
                        "error": f"unknown path {path!r}",
                        "endpoints": ["/metrics", "/healthz", "/slo",
                                      "/status", "/compile", "/memory",
                                      "/profile"],
                    }))

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="raft-tpu-ops-server",
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "OpsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def serve_demo(
    port: int = 0,
    groups: int = 4,
    duration_s: Optional[float] = None,
    out=None,
    device=None,
) -> dict:
    """``python -m raft_tpu_torch.obs --serve``: boot a demo
    ``MultiEngine`` with the full online plane attached (registry, SLO
    tracker with a commit objective, safety auditor, status board, the
    compile watch with its retrace sentinel, the memory watch), drive
    synthetic traffic, and serve the ops endpoints until ``duration_s``
    wall seconds elapse (or forever, until Ctrl-C, when ``None``). The
    engine runs on the card unless ``device="cpu"`` is passed. Returns a
    small result dict (the smoke test's hook)."""
    import time as _time

    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.multi.engine import MultiEngine
    from raft_tpu_torch.obs.audit import SafetyAuditor
    from raft_tpu_torch.obs.compile import CompileWatch, RetraceSentinel
    from raft_tpu_torch.obs.events import FlightRecorder
    from raft_tpu_torch.obs.memory import MemoryWatch
    from raft_tpu_torch.obs.registry import MetricsRegistry
    from raft_tpu_torch.obs.slo import SLObjective, SloTracker

    cfg = RaftConfig(
        n_replicas=3, entry_bytes=64, batch_size=8, log_capacity=256,
        transport="single",
    )
    eng = MultiEngine(cfg, groups, recorder=FlightRecorder(), device=device)
    eng.metrics = MetricsRegistry()
    eng.auditor = SafetyAuditor(
        recorder=eng.recorder, registry=eng.metrics,
        max_entries=2 * cfg.log_capacity,
    )
    eng.slo = SloTracker(
        objectives=(
            SLObjective("commit_fast", "commit",
                        threshold_s=2 * cfg.heartbeat_period),
        ),
        recorder=eng.recorder, registry=eng.metrics,
    )
    board = StatusBoard()
    eng.status_board = board
    watch = CompileWatch(
        recorder=eng.recorder, registry=eng.metrics
    ).install()
    RetraceSentinel(watch)
    memory = MemoryWatch(registry=eng.metrics, recorder=eng.recorder)
    memory.watch_engine(eng, name="multi")
    eng.seed_leaders()
    server = OpsServer(
        board=board, registry=eng.metrics, slo=eng.slo,
        auditor=eng.auditor, compile_watch=watch, memory=memory,
        port=port,
    )
    bound = server.start()
    line = (f"raft_tpu ops endpoint on http://127.0.0.1:{bound} "
            "(/metrics /healthz /slo /status /compile /memory "
            "/profile); Ctrl-C to stop")
    print(line, file=out, flush=True)
    t0 = _time.monotonic()
    submitted = 0
    try:
        while duration_s is None or _time.monotonic() - t0 < duration_s:
            for g in range(groups):
                if eng.leader_id[g] is None:
                    continue
                for i in range(cfg.batch_size):
                    payload = (f"g{g}op{submitted}".encode()
                               .ljust(cfg.entry_bytes, b"\0"))
                    eng.submit(g, payload[:cfg.entry_bytes])
                    submitted += 1
            eng.run_for(2 * cfg.heartbeat_period)
            if watch.sentinel is not None and not watch.sentinel.frozen:
                # warmup over: the demo's program set is built after the
                # first driven window; freeze so /compile shows the
                # sentinel armed
                watch.sentinel.freeze()
            memory.census()
            _time.sleep(0.02)        # pace the virtual cluster for wall
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        watch.uninstall()
    return {
        "port": bound,
        "submitted": submitted,
        "committed": int(eng.commit_watermark.sum()),
        "violations": eng.auditor.total_violations,
        "compiles": watch.total_compiles,
        "compile_violations": len(watch.sentinel.violations),
    }
