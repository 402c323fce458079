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
  /compile    the compile watch's snapshot; with none attached (the
              port has no compile plane before ROADMAP A16b) a 404
              with the JAX package's body
  /memory     the memory watch's snapshot, likewise 404 until A16b
  /profile    an error naming ROADMAP A16b (the on-demand profiler
              capture is not ported yet)
  ==========  ==========================================================

Thread-safety contract: ``/status`` and ``/healthz`` serve from
published immutable snapshots only. ``/metrics``, ``/slo`` and the
``/status`` audit fallback render live single-writer state (per-sample
values are plain in-place updates); the one racy case — a container
growing mid-render (new metric/label/digest key) — is retried a few
times scrape-side, which is the standard answer for a pull endpoint.

``python -m raft_tpu_torch.obs --serve`` (the JAX package's demo boots a
``MultiEngine`` with the compile and memory watches) refuses, naming
ROADMAP A16b.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


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
                    self._send(501, json.dumps({"error": str(
                        _not_ported("the on-demand profiler capture "
                                    "(/profile)", "A16b"))}))
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to raft_tpu_torch yet (ROADMAP {item})")


def serve_demo(
    port: int = 0,
    groups: int = 4,
    duration_s: Optional[float] = None,
    out=None,
) -> dict:
    """``python -m raft_tpu.obs --serve`` boots a demo multi-Raft engine
    with the compile and memory planes attached; the port has the engine
    (``multi.MultiEngine``) but not those planes yet, and this raises
    naming them rather than serving a stand-in."""
    raise _not_ported("the --serve demo (a MultiEngine with the compile "
                      "and memory watches)", "A16b")
