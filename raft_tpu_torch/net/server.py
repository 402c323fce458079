"""The batched async ingest server: the data plane's wire front end
(port of ``raft_tpu/net/server.py``).

Architecture (docs/NETWORK.md). One asyncio event loop owns everything;
the engine itself never grows a thread:

- **reader tasks** (one per connection) parse frames off the socket and
  append requests to a shared coalesce buffer — connection handling is
  fully decoupled from the tick loop, and requests arriving on ANY
  number of connections between two pump iterations land in ONE ingest
  batch.
- **the pump task** drains the coalesce buffer in one sweep (the
  batched-ingest amortization: admission, routing and staging run once
  per BATCH of wire arrivals, the same way the fused K-tick scan
  amortizes device launches), then hands control to the tick loop
  (``backend.drive``) for one drive quantum, then sweeps completions —
  durable writes and confirmed read tickets — back onto their
  connections as response frames keyed by client ``req_id``.

The staged-ingest contract: on a fused single engine
(``cfg.fuse_k > 1``), every wire submit ingested by the pump flows
through ``RaftEngine.submit``, whose ``FusedDriver.on_submit`` hook
pre-packs each completed batch into the device ``StagingRing`` — i.e.
on the NETWORK side of the host/device wall, inside the pump's ingest
phase. The tick loop then consumes staged slots by ring index and never
re-packs a wire payload; the per-phase ``StagingRing.stage_events``
split (``wire_staged_batches`` vs ``tick_staged_batches`` in
``stats()``) is the observable proof, pinned by
tests/test_torch_net_wire.py and ``chip_smoke.py``'s ``wire_path``.

Backpressure: every typed refusal the in-process stack raises —
``admission.Overloaded`` (depth / delay / fair_share / read_depth),
``NotLeader``, ``ReadLagging``, ``LinearizableReadRefused`` — maps to a
wire frame (``REFUSED`` with reason + ``retry_after_s``, or
``NOT_LEADER`` with a redial hint) written IMMEDIATELY from the ingest
phase: a refused op is never queued anywhere, preserving the gate's
provably-no-effect contract end to end. The server adds exactly one
refusal reason of its own, ``wire_backlog``: the coalesce buffer is
bounded (``max_pending``), and an arrival past the bound is refused
with the drive quantum as its retry hint rather than buffered — wire
memory stays bounded no matter how many connections pile on.

Observability: ``raft_net_requests_total{kind}`` /
``raft_net_bytes_total{dir}`` / ``raft_net_refusals_total{reason}``
counters in the attached registry, a ``net`` section published to the
``StatusBoard`` each pump flush (``/status``), and — when a
``SpanTracker`` is attached — one span per wire op annotated with
``wire_recv``/``wire_ingest``/``wire_sent``, bound as the ambient span
across the backend dispatch so the engine's own ingest/commit hooks
chain onto it (queue-vs-wire time in the Perfetto export).

Cross-process tracing (docs/OBSERVABILITY.md "Wire plane"):
a client that negotiated ``CAP_TRACE`` in the HELLO/WELCOME capability
handshake sends each request with a 17-byte trace context — the server
ADOPTS it (the wire-op span's ``wire_trace``/``parent_span``/
``sampled`` come from the context, so the server span is a child of
the client op and the two sides' tables join on the trace id) and
echoes the context on every response so the client learns the server
span id. Without the negotiated bit nothing changes: frames are
byte-identical to the pre-trace protocol (the compat pin).

Pump attribution: an attached ``obs.hostprof.PumpProfiler`` tiles
every pump iteration into boundary-marked phases (coalesce / ingest /
drive / sweep / flush, with reader-task read_decode accumulated
alongside), feeds the ``raft_net_pump_phase_seconds{phase}`` /
coalesce-batch / frame-queue-age distributions, and surfaces as the
``pump`` block of the ``net`` /status section. Pure host bookkeeping:
zero extra device syncs attached or detached.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.admission.gate import Overloaded
from raft_tpu_torch.multi.engine import NotLeader, ReadLagging
from raft_tpu_torch.net import protocol as P
from raft_tpu_torch.raft.engine import LinearizableReadRefused

_NF = None


def _netfault_mod():
    """The wire seam module (cluster/netfault.py), resolved lazily:
    net/ cannot import the cluster package at module load because
    cluster/node.py imports THIS module — the classic cycle. By the
    time a connection is accepted, the import graph is settled."""
    global _NF
    if _NF is None:
        from raft_tpu_torch.cluster import netfault

        _NF = netfault
    return _NF


class _Done:
    """A read served synchronously in the ingest phase (lease / session
    / an already-applied certified index)."""

    __slots__ = ("group", "index", "cls", "value")

    def __init__(self, group: int, index: int, cls: str, value):
        self.group = group
        self.index = index
        self.cls = cls
        self.value = value


class _Pending:
    """A read whose serve waits on the tick loop (an in-flight
    ReadIndex ticket, or an apply cursor below the certified index).
    ``poll_read`` resolves it to ``_Done`` / ``None`` / a refusal."""

    __slots__ = ("handle",)

    def __init__(self, handle):
        self.handle = handle


class EngineBackend:
    """Serve one ``RaftEngine`` (optionally with a ``ReplicatedKV``
    state machine for values). Group-less: everything is group 0.

    Submit semantics follow the engine: entries queue regardless of
    leadership and ack once durable, so a leader kill stalls acks until
    re-election instead of surfacing ``NOT_LEADER`` (that path belongs
    to :class:`RouterBackend`). Reads: ``linearizable`` (and ``any``,
    which has no replica spread to ride here) mint a ReadIndex ticket —
    zero extra rounds under a valid lease or write traffic — and
    ``session`` serves from applied state gated on the connection's
    token floor."""

    def __init__(self, engine, kv=None):
        self.engine = engine
        self.kv = kv
        self.groups = 1

    # ------------------------------------------------------------ plumbing
    @property
    def heartbeat_s(self) -> float:
        return self.engine.cfg.heartbeat_period

    def now(self) -> float:
        return self.engine.clock.now

    def drive(self, seconds: float) -> None:
        self.engine.run_for(seconds)

    def meta(self) -> Tuple[int, int]:
        return self.engine.cfg.entry_bytes, 1

    def leader_hint(self, group: int) -> str:
        lid = self.engine.leader_id
        return "" if lid is None else f"replica:{lid}"

    # ------------------------------------------------------------- writes
    def submit(self, key: bytes, value: bytes, client=None
               ) -> Tuple[int, int]:
        if self.kv is not None:
            return 0, self.kv.set(key, value, client=client)
        return 0, self.engine.submit(value, client=client)

    def is_durable(self, group: int, seq: int) -> bool:
        return self.engine.is_durable(seq)

    def commit_floor(self, group: int) -> int:
        return int(self.engine.commit_watermark)

    # -------------------------------------------------------------- reads
    def begin_read(self, cls: str, key: bytes, session: Dict[int, int],
                   client=None):
        if cls == "session":
            floor = session.get(0, 0)
            idx = int(self.engine.applied_index)
            if idx < floor:
                raise ReadLagging(0, None, floor - idx,
                                  retry_after_s=self.heartbeat_s)
            self.engine._note_read_served("session", 0.0)
            return _Done(0, idx, "session", self._value(key))
        # linearizable (``any`` rides the same ticket: one engine has
        # no replica spread to serve from)
        ticket = self.engine.submit_read()
        return _Pending((ticket, key))

    def poll_read(self, handle):
        ticket, key = handle
        idx = self.engine.read_confirmed(ticket)
        if idx is None:
            return None
        if self.kv is not None and self.kv.last_applied < idx:
            return None                      # wait for the apply cursor
        cls = self.engine.read_ticket_class(ticket) or "read_index"
        return _Done(0, idx, cls, self._value(key))

    def _value(self, key: bytes):
        return None if self.kv is None else self.kv.get(key)

    # ------------------------------------------------------ observability
    def staging_stats(self) -> Optional[Tuple[int, int]]:
        """(full-batch stage events, window-tail stage events) — the
        pump differences these around its ingest vs drive phases for
        the staged-ingest proof."""
        fd = getattr(self.engine, "_fused_driver", None)
        if fd is None:
            return None
        return fd.staging.stage_events, fd.staging.stage_tail_events

    def status(self) -> dict:
        e = self.engine
        return {
            "leader": e.leader_id,
            "commit": int(e.commit_watermark),
            "applied": int(e.applied_index),
            "queue_depth": len(e._queue),
        }


class RouterBackend:
    """Serve a ``Router`` over a ``MultiEngine`` (optionally with a
    ``ShardedKV``). The router must be built with ``drive=False``: the
    WIRE owns the retry policy — refusals surface to the client as
    typed frames instead of being retried server-side, which is the
    whole backpressure contract. Writes route by key to the group
    leader (``NOT_LEADER`` with a redial hint when the group has
    none); ``linearizable``/``any`` reads ride ``Router.read_any``
    (lease / read_index / follower serve classes, replica spread) and
    ``session`` reads ride the connection's token floors through
    ``session_read_index`` with no leader contact."""

    def __init__(self, router, skv=None):
        self.router = router
        self.engine = router.engine
        self.skv = skv
        self.groups = self.engine.G
        if router.drive:
            raise ValueError(
                "RouterBackend needs a drive=False Router: the wire "
                "client owns the retry policy (docs/NETWORK.md)"
            )

    # ------------------------------------------------------------ plumbing
    @property
    def heartbeat_s(self) -> float:
        return self.engine.cfg.heartbeat_period

    def now(self) -> float:
        return self.engine.clock.now

    def drive(self, seconds: float) -> None:
        self.engine.run_for(seconds)

    def meta(self) -> Tuple[int, int]:
        return self.engine.cfg.entry_bytes, self.engine.G

    def leader_hint(self, group: int) -> str:
        lid = self.engine.leader_id[group]
        return "" if lid is None else f"replica:{lid}"

    # ------------------------------------------------------------- writes
    def submit(self, key: bytes, value: bytes, client=None
               ) -> Tuple[int, int]:
        g = self.router.group_of(key)
        if self.skv is not None:
            from raft_tpu_torch.examples.kv import encode_op

            payload = encode_op(
                self.engine.cfg.entry_bytes, 1, key, value
            )
        else:
            payload = value
        return g, self.engine.submit_to_leader(g, payload)

    def is_durable(self, group: int, seq: int) -> bool:
        return self.engine.is_durable(group, seq)

    def commit_floor(self, group: int) -> int:
        return int(self.engine.commit_watermark[group])

    # -------------------------------------------------------------- reads
    def begin_read(self, cls: str, key: bytes, session: Dict[int, int],
                   client=None):
        if cls == "session":
            g = self.router.group_of(key)
            idx = self.engine.session_read_index(g, session.get(g, 0))
            self.engine.note_read_class(g, "session")
            return _Done(g, idx, "session", self._value(key))
        g, _replica, idx, served = self.router.read_any(key)
        if (self.skv is not None
                and int(self.engine.applied_index[g]) < idx):
            return _Pending((g, idx, served, key))
        return _Done(g, idx, served, self._value(key))

    def poll_read(self, handle):
        g, idx, served, key = handle
        if int(self.engine.applied_index[g]) < idx:
            return None
        return _Done(g, idx, served, self._value(key))

    def _value(self, key: bytes):
        return None if self.skv is None else self.skv.get(key)

    # ------------------------------------------------------ observability
    def staging_stats(self) -> Optional[Tuple[int, int]]:
        return None

    def status(self) -> dict:
        e = self.engine
        return {
            "leaders": {str(g): e.leader_id[g] for g in range(e.G)},
            "commit": {str(g): int(e.commit_watermark[g])
                       for g in range(e.G)},
        }


class _Conn:
    """One accepted connection's server-side state."""

    _next_cid = 0

    def __init__(self, reader, writer, max_frame_bytes: int,
                 wire=None):
        self.reader = reader
        self.writer = writer
        # every byte this connection moves rides the netfault seam —
        # RealConn in production, FaultyConn under the nemesis (the
        # lint gate bans direct transport calls in this file)
        self.wire = (wire if wire is not None
                     else _netfault_mod().RealConn(reader, writer))
        self.decoder = P.FrameDecoder(max_frame_bytes)
        self.session: Dict[int, int] = {}
        self.caps = 0            # negotiated capability intersection
        self.bytes_in = 0
        self.bytes_out = 0
        self.open = True
        _Conn._next_cid += 1
        self.cid = _Conn._next_cid

    def observe_floor(self, group: int, index: int) -> None:
        if index > self.session.get(group, 0):
            self.session[group] = index

    def send(self, frame: bytes) -> int:
        """Write one response frame; returns bytes written (0 when the
        connection already died — the server mirrors the count into
        ``raft_net_bytes_total{dir="out"}``)."""
        if not self.open:
            return 0
        try:
            self.wire.write(frame)
            self.bytes_out += len(frame)
            return len(frame)
        except (ConnectionError, RuntimeError):
            self.open = False
            return 0


class _Req:
    __slots__ = ("conn", "kind", "req_id", "key", "value", "cls",
                 "span", "t_in", "trace", "t_wall")

    def __init__(self, conn, kind, req_id, key, value=None, cls=None,
                 trace=None):
        self.conn = conn
        self.kind = kind
        self.req_id = req_id
        self.key = key
        self.value = value
        self.cls = cls
        self.span = None
        self.t_in = 0.0
        self.trace = trace       # (trace_id, parent span_id, sampled)
        self.t_wall = 0.0        # wall arrival stamp (pump profiler)


class _Batch:
    """One SUBMIT_BATCH frame's completion state: resolved when every
    ADMITTED entry is durable (refused entries resolved at ingest)."""

    __slots__ = ("conn", "req_id", "t_in", "remaining", "accepted",
                 "shed", "groups", "span", "trace")

    def __init__(self, req: _Req):
        self.conn = req.conn
        self.req_id = req.req_id
        self.t_in = req.t_in
        self.remaining = 0
        self.accepted = 0
        self.shed = 0
        self.groups: set = set()
        self.span = req.span
        self.trace = req.trace


class IngestServer:
    """The serving tier (module docstring). ``port=0`` binds an
    ephemeral port — read ``.port`` after ``await start()``.

    ``txn=`` takes a ``raft_tpu_torch.txn.TxnCoordinator``: it arms the
    TXN_* frames and CAP_TXN, as JAX's does. ``peer=`` (the cluster's
    ``PeerBackend``, ROADMAP A17d) is not ported yet: not None, it raises
    naming its item. Without a coordinator or a peer backend the server
    answers every TXN_* and PEER_* frame as JAX's does without them: an
    unknown kind, a connection-level ERROR and a close."""

    def __init__(
        self,
        backend,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_frame_bytes: int = P.MAX_FRAME_BYTES,
        max_pending: int = 4096,
        drive_quantum_s: Optional[float] = None,
        op_timeout_s: Optional[float] = None,
        registry=None,
        status_board=None,
        spans=None,
        pump=None,
        txn=None,
        peer=None,
        ssl=None,
        netfaults=None,
    ) -> None:
        self.backend = backend
        self.host = host
        self.port = port
        self.max_frame_bytes = max_frame_bytes
        self.max_pending = max_pending
        self.drive_quantum_s = (
            drive_quantum_s if drive_quantum_s is not None
            else backend.heartbeat_s
        )
        self.op_timeout_s = (
            op_timeout_s if op_timeout_s is not None
            else 100.0 * backend.heartbeat_s
        )
        #   VIRTUAL-clock bound on an in-flight op. A queued entry
        #   dropped across a leadership change never acks durable and
        #   its loss is not always cheaply provable, so an expired
        #   WRITE is answered with ERROR ("outcome unknown") — the one
        #   wire response that is not a typed no-effect refusal. A
        #   backend that CAN prove the loss (RaftNode's term-checked
        #   is_durable raises NotLeader) gets the typed refusal from
        #   the sweep instead of waiting out the timeout. Expired
        #   READS provably served nothing and map to NOT_LEADER.
        self.registry = registry
        self.status_board = status_board
        self.spans = spans
        self.pump = pump
        #   obs.hostprof.PumpProfiler — pump-phase attribution + the
        #   coalesce/queue-age distributions (None = detached: every
        #   profiled site costs one None check)
        self.txn = txn
        #   txn.coordinator.TxnCoordinator — arms the TXN_* frames and
        #   the CAP_TXN capability bit; the pump's sweep phase polls
        #   in-flight transactions exactly like awaited writes (None =
        #   the server predates transactions byte-for-byte)
        if peer is not None:
            raise NotImplementedError(
                "IngestServer(peer=...) is not ported to raft_tpu_torch "
                "yet: ROADMAP A17d (the cluster tier and its PeerBackend)")
        self.ssl = ssl
        #   ssl.SSLContext (cluster/auth.py server_ssl) — every byte of
        #   this port, client and peer alike, rides TLS when set
        self.netfaults = netfaults
        #   cluster.netfault.NetFaults — when set, every accepted
        #   connection is wrapped in a FaultyConn and the node's
        #   net.json plan injects wire faults under this server's
        #   writes (None = RealConn passthrough, zero overhead)

        self._server: Optional[asyncio.base_events.Server] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._conns: List[_Conn] = []
        self._pending: List[_Req] = []
        self._awaiting_writes: Dict[Tuple[int, int], _Req] = {}
        self._pending_reads: List[Tuple[_Req, object]] = []
        self._pending_txns: List[Tuple[_Req, object]] = []
        self._wakeup = asyncio.Event()
        self._running = False
        self.draining = False

        # wire counters (mirrored into the registry when attached)
        self.requests_total: Dict[str, int] = {}
        self.refusals: Dict[str, int] = {}
        self.responses_total = 0
        self.pump_iters = 0
        #   monotone pump-iteration counter — stamped into each traced
        #   op's wire_ingest annotation (ingest-batch attribution: the
        #   joined timeline can say WHICH coalesced batch carried an op)
        self.wire_staged_batches = 0
        self.tick_staged_batches = 0
        self.tick_tail_batches = 0
        #   staged-ingest accounting (fused EngineBackend only):
        #   full batches packed during the pump's INGEST phase (the
        #   network side of the wall) vs during ``backend.drive`` (the
        #   tick path — must stay 0: zero re-pack), and the per-window
        #   partial-tail packs the fused planner pays by design
        self._bytes_in_closed = 0
        self._bytes_out_closed = 0

    # ----------------------------------------------------------- lifecycle
    async def start(self) -> int:
        self._running = True
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, ssl=self.ssl
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.create_task(self._pump())
        return self.port

    async def stop(self) -> None:
        """Graceful drain: stop accepting, let in-flight completions
        finish one final sweep, then close every connection."""
        self.draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._running = False
        self._wakeup.set()
        if self._pump_task is not None:
            try:
                await self._pump_task
            except asyncio.CancelledError:
                pass
            except Exception:
                pass    # already reported by the pump's own handler
        try:
            # the promised final sweep: writes that became durable
            # after the pump's last iteration still get their ack
            # before the connections close
            self._sweep_completions()
            self._publish_status()
            await self._flush_writers()
        except Exception:
            pass        # a dead backend must not block shutdown
        for conn in self._conns:
            conn.open = False
            try:
                conn.writer.close()
            except Exception:
                pass
        self._publish_status()

    # ----------------------------------------------------- reader tasks
    async def _handle_conn(self, reader, writer) -> None:
        wire = (self.netfaults.wrap(reader, writer, client=True)
                if self.netfaults is not None else None)
        conn = _Conn(reader, writer, self.max_frame_bytes, wire=wire)
        self._conns.append(conn)
        try:
            while self._running:
                data = await conn.wire.read(1 << 16)
                if not data:
                    break
                conn.bytes_in += len(data)
                self._count_bytes("in", len(data))
                t0 = (time.perf_counter() if self.pump is not None
                      else 0.0)
                try:
                    frames = conn.decoder.feed(data)
                except P.ProtocolError as ex:
                    # unrecoverable for this stream: answer with a
                    # connection-level ERROR and close (oversized and
                    # corrupt frames both land here — refused before
                    # any buffering)
                    self._refusal("protocol_error")
                    self._send(conn, P.encode_error(0, str(ex)))
                    break
                for kind, payload in frames:
                    self._on_frame(conn, kind, payload)
                if self.pump is not None:
                    self.pump.note_read_decode(time.perf_counter() - t0)
                self._wakeup.set()
                if not conn.open:
                    # a frame handler declared the stream unrecoverable
                    # (protocol violation): flush the ERROR and close
                    try:
                        await conn.wire.drain()
                    except (ConnectionError, RuntimeError):
                        pass
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            conn.open = False
            try:
                writer.close()
            except Exception:
                pass
            if conn in self._conns:
                self._conns.remove(conn)
                self._bytes_in_closed += conn.bytes_in
                self._bytes_out_closed += conn.bytes_out
            self._wakeup.set()

    def _on_frame(self, conn: _Conn, kind: int, payload: bytes) -> None:
        try:
            if kind & P.CRC_FLAG and P.is_peer_kind(kind & ~P.CRC_FLAG):
                # only peer-plane frames are ever sealed inbound (the
                # dialer is the sole CRC sender toward this server);
                # any other kind with the bit set is an unknown kind
                # and falls through to the protocol-ERROR path below
                kind, payload, crc_ok = P.crc_open(kind, payload)
                if not crc_ok:
                    # frame-integrity failure (CAP_CRC trailer
                    # mismatch): drop UNPARSED and count — garbage must
                    # never decode into the log; Raft's retransmit
                    # re-sends what mattered on the next heartbeat
                    self._refusal("peer_frame_corrupt")
                    return
            kind, trace, payload = P.split_trace(kind, payload)
            if kind == P.HELLO:
                # reconnect-and-resume: adopt the client's session
                # floors for this connection — and negotiate
                # capabilities: WELCOME echoes the INTERSECTION of what
                # the client advertised and what we speak, appended
                # only when nonzero (a capability-less HELLO gets the
                # byte-identical pre-capability WELCOME — the compat
                # contract)
                floors, caps = P.decode_hello_caps(payload)
                for g, idx in floors.items():
                    conn.observe_floor(g, idx)
                # a server with no SpanTracker cannot honor the trace
                # capability (it would echo contexts it never
                # recorded, handing clients bogus join hints) — so it
                # does not advertise it; same for CAP_TXN without a
                # coordinator to run the frames (CAP_PEER's backend comes
                # with ROADMAP A17d)
                speak = P.CAP_TRACE if self.spans is not None else 0
                if self.txn is not None:
                    speak |= P.CAP_TXN
                conn.caps = caps & speak
                entry_bytes, groups = self.backend.meta()
                self._send(conn, P.encode_welcome(
                    entry_bytes, groups, caps=conn.caps
                ))
                self._count_request("hello")
                return
            if kind == P.SUBMIT:
                req_id, key, value = P.decode_submit(payload)
                req = _Req(conn, kind, req_id, key, value=value,
                           trace=trace)
                self._count_request("submit")
            elif kind == P.SUBMIT_BATCH:
                req_id, items = P.decode_submit_batch(payload)
                req = _Req(conn, kind, req_id, b"", value=items,
                           trace=trace)
                self._count_request("submit_batch")
            elif kind == P.READ:
                req_id, cls, key = P.decode_read(payload)
                req = _Req(conn, kind, req_id, key, cls=cls,
                           trace=trace)
                self._count_request("read")
            elif kind in (P.TXN_BEGIN, P.TXN_COMMIT, P.TXN_ABORT,
                          P.TXN_STATUS) and self.txn is not None:
                # a server WITHOUT a coordinator never advertised
                # CAP_TXN, so these kinds fall to the unknown-kind
                # close below — the additive-capability contract
                if kind == P.TXN_BEGIN:
                    req_id = P.decode_txn_begin(payload)
                    req = _Req(conn, kind, req_id, b"", trace=trace)
                elif kind == P.TXN_COMMIT:
                    req_id, txn_id, writes, expects = \
                        P.decode_txn_commit(payload)
                    req = _Req(conn, kind, req_id, b"",
                               value=(txn_id, writes, expects),
                               trace=trace)
                else:
                    req_id, txn_id = (
                        P.decode_txn_abort(payload)
                        if kind == P.TXN_ABORT
                        else P.decode_txn_status(payload)
                    )
                    req = _Req(conn, kind, req_id, b"", value=txn_id,
                               trace=trace)
                self._count_request(P.KIND_NAMES[kind])
            else:
                # a kind we do not speak (PEER_* included: this server
                # fronts no peer backend; TXN_* without a coordinator)
                # means the peer is desynced or newer than
                # us: per the protocol contract a
                # connection-level ERROR CLOSES the stream (the reader
                # loop breaks on conn.open below)
                self._refusal("protocol_error")
                self._send(conn, P.encode_error(
                    0, f"unexpected client frame kind {kind}"
                ))
                conn.open = False
                return
        except P.ProtocolError as ex:
            self._refusal("protocol_error")
            self._send(conn, P.encode_error(0, str(ex)))
            conn.open = False
            return
        if len(self._pending) >= self.max_pending:
            # wire-level backpressure: the coalesce buffer is bounded,
            # and an arrival past the bound is refused — never queued
            self._refuse(req, "wire_backlog", self.drive_quantum_s)
            return
        req.t_in = self.backend.now()
        if self.pump is not None:
            req.t_wall = time.perf_counter()
        if self.spans is not None:
            req.span = self.spans.begin(
                "wire_" + P.KIND_NAMES[kind], req.t_in,
                client=f"conn{conn.cid}", key=req.key,
            )
            # the span's wire-visible id folds in the listening port so
            # a redial saga joining spans from TWO servers can tell
            # them apart (local span counters both start at 1)
            req.span.span_id = (self.port << 32) | (req.span.trace_id
                                                    & 0xFFFFFFFF)
            # adopt the remote parent: the client op's trace id becomes
            # the join key, its span id the parent, its sampling bit
            # the head decision (the root decided — tail policy still
            # upgrades on a bad outcome)
            self.spans.adopt(req.span, req.trace)
            req.span.annotate("wire_recv", req.t_in)
        self._pending.append(req)

    # ------------------------------------------------------------ the pump
    async def _pump(self) -> None:
        while self._running:
            if not (self._pending or self._awaiting_writes
                    or self._pending_reads or self._pending_txns):
                self._wakeup.clear()
                # re-check under the cleared flag: a reader may have
                # appended between the test above and the clear
                if not self._pending:
                    await self._wakeup.wait()
                    continue
            batch, self._pending = self._pending, []
            self.pump_iters += 1
            pump = self.pump
            if pump is not None:
                # the boundary-marked iteration bracket: coalesce /
                # ingest / drive / sweep tile to iter_end's flush
                # residue (obs.hostprof.PumpProfiler)
                pump.iter_begin()
                if batch:
                    pump.observe_batch(len(batch))
                    now_w = time.perf_counter()
                    for req in batch:
                        pump.observe_age(now_w - req.t_wall)
                pump.mark("coalesce")
            try:
                if batch:
                    self._ingest(batch)
                if pump is not None:
                    pump.mark("ingest")
                # the tick loop's side of the wall: one drive quantum
                s0 = self.backend.staging_stats()
                self.backend.drive(self.drive_quantum_s)
                if s0 is not None:
                    s1 = self.backend.staging_stats()
                    self.tick_staged_batches += s1[0] - s0[0]
                    self.tick_tail_batches += s1[1] - s0[1]
                if pump is not None:
                    pump.mark("drive")
                self._sweep_completions()
                if pump is not None:
                    pump.mark("sweep")
            except Exception as ex:
                # a tick-loop crash must not strand every client on a
                # silent dead task: answer everything in flight with a
                # connection-level ERROR and shut the tier down
                import sys
                import traceback

                traceback.print_exc(file=sys.stderr)
                self._fail_all(repr(ex))
                self._running = False
                self._publish_status()
                await self._flush_writers()
                raise
            self._publish_status()
            await self._flush_writers()
            if pump is not None:
                pump.iter_end()          # residue -> the flush phase
            # yield so reader tasks can coalesce the next batch
            await asyncio.sleep(0)

    def _ingest(self, batch: List[_Req]) -> None:
        """The network side of the wall: admission, routing, staging.
        Refusals are answered inline and never queue; accepted writes
        pre-pack into the StagingRing via the submit-path hook."""
        s0 = self.backend.staging_stats()
        for req in batch:
            if not req.conn.open:
                continue
            sp = req.span
            if sp is not None:
                # ingest-batch attribution: WHICH pump iteration and
                # how many frames coalesced with this op — the joined
                # timeline's "wire frame -> ingest batch" link
                sp.annotate("wire_ingest", self.backend.now(),
                            pump_iter=self.pump_iters,
                            coalesce=len(batch))
                if self.spans is not None:
                    self.spans.current = sp
            try:
                if req.kind == P.SUBMIT:
                    self._ingest_submit(req)
                elif req.kind == P.SUBMIT_BATCH:
                    self._ingest_submit_batch(req)
                elif req.kind in (P.TXN_BEGIN, P.TXN_COMMIT,
                                  P.TXN_ABORT, P.TXN_STATUS):
                    self._ingest_txn(req)
                else:
                    self._ingest_read(req)
            except Overloaded as ex:
                self._refuse(req, ex.reason, ex.retry_after_s)
            except ReadLagging as ex:
                self._refuse(req, "read_lagging",
                             getattr(ex, "retry_after_s", None)
                             or self.drive_quantum_s)
            except NotLeader as ex:
                g = getattr(ex, "group", 0) or 0
                self._not_leader(req, g)
            except LinearizableReadRefused:
                self._not_leader(req, 0)
            except Exception as ex:     # never kill the pump
                self._finish_span(req, "failed")
                self._send(req.conn, P.encode_error(
                    req.req_id, repr(ex), trace=self._rtrace(req),
                ))
                self.responses_total += 1
            finally:
                if self.spans is not None:
                    self.spans.current = None
        if s0 is not None:
            s1 = self.backend.staging_stats()
            self.wire_staged_batches += s1[0] - s0[0]

    def _ingest_submit(self, req: _Req) -> None:
        g, seq = self.backend.submit(
            req.key, req.value, client=f"conn{req.conn.cid}"
        )
        self._awaiting_writes[(g, seq)] = req

    def _ingest_submit_batch(self, req: _Req) -> None:
        """One frame, many entries: admission runs per entry (refused
        entries are tallied, never queued — the provably-no-effect
        contract holds entry-wise), admitted entries await durability
        as one unit.

        Span altitude: a batch is ONE wire op, so its span records
        unit-level facts (wire phases, accepted/shed, floors) — the
        ambient binding is cleared around the per-entry submit loop,
        because the engine's per-seq causal hooks would otherwise pay
        O(entries) span work per frame (measured ~6% of wire goodput
        at the macro shape, against the plane's <= 5% budget; the
        single-SUBMIT path keeps the full per-entry chain)."""
        batch = _Batch(req)
        client = f"conn{req.conn.cid}"
        if self.spans is not None:
            self.spans.current = None
        for key, value in req.value:
            try:
                g, seq = self.backend.submit(key, value, client=client)
            except Overloaded as ex:
                batch.shed += 1
                self._refusal(ex.reason)
            except NotLeader:
                batch.shed += 1
                self._refusal("not_leader")
            else:
                batch.accepted += 1
                batch.remaining += 1
                batch.groups.add(g)
                self._awaiting_writes[(g, seq)] = batch
        if batch.remaining == 0:
            self._respond_batch(batch)

    def _respond_batch(self, batch: _Batch) -> None:
        floors = {g: self.backend.commit_floor(g) for g in batch.groups}
        for g, idx in floors.items():
            batch.conn.observe_floor(g, idx)
        if batch.span is not None and not batch.span.terminal:
            batch.span.annotate("wire_sent", self.backend.now())
            batch.span.finish("ok", self.backend.now(),
                              accepted=batch.accepted, shed=batch.shed)
        self._send(batch.conn, P.encode_ok_batch(
            batch.req_id, batch.accepted, batch.shed, floors,
            trace=self._rtrace(batch),
        ))
        self.responses_total += 1

    def _ingest_read(self, req: _Req) -> None:
        out = self.backend.begin_read(
            req.cls, req.key, req.conn.session,
            client=f"conn{req.conn.cid}",
        )
        if isinstance(out, _Done):
            self._serve_read(req, out)
        else:
            self._pending_reads.append((req, out.handle))

    def _ingest_txn(self, req: _Req) -> None:
        """The transactional wire ops (gated on an attached
        coordinator — HELLO never spoke CAP_TXN without one). BEGIN
        answers inline: id allocation has no effect to refuse. COMMIT
        runs the coordinator's conflict-check + prewrite fan-out —
        LockConflict IS an Overloaded, so it rides the existing typed
        REFUSED path (provably nothing queued) — then parks the handle
        for the sweep phase, exactly like an awaited write. ABORT /
        STATUS answer from the replicated decision map."""
        txn = self.txn
        if req.kind == P.TXN_BEGIN:
            self._respond_txn(req, txn.allocate(), "open")
            return
        if req.kind == P.TXN_COMMIT:
            from raft_tpu_torch.txn.coordinator import TxnItem
            txn_id, writes, expects = req.value
            items = {k: TxnItem(k, value=v, delete=v is None)
                     for k, v in writes}
            for k, v in expects:
                it = items.get(k)
                if it is None:
                    items[k] = TxnItem(k, expect=v)
                else:
                    it.has_expect, it.expect = True, v
            h = txn.begin(list(items.values()), txn_id=txn_id)
            self._pending_txns.append((req, h))
            return
        # ABORT / STATUS: the decision map is the authority
        txn_id = req.value
        d = txn.store.decision(txn_id)
        if d is not None:
            self._respond_txn(req, txn_id,
                              "committed" if d[0] else "aborted")
        elif req.kind == P.TXN_ABORT:
            # BEGIN placed nothing, so abandoning an uncommitted txn
            # is trivially effect-free
            self._respond_txn(req, txn_id, "aborted", "client_abort")
        else:
            self._respond_txn(req, txn_id, "unknown")

    def _respond_txn(self, req: _Req, txn_id: int, status: str,
                     reason: str = "") -> None:
        self._finish_span(req, "ok", txn_status=status)
        self._send(req.conn, P.encode_txn_state(
            req.req_id, txn_id, status, reason,
            trace=self._rtrace(req),
        ))
        self.responses_total += 1

    # ------------------------------------------------------- completions
    def _sweep_completions(self) -> None:
        now = self.backend.now()
        done: List[Tuple[int, int]] = []
        lost: List[Tuple[int, int]] = []
        for key in self._awaiting_writes:
            try:
                if self.backend.is_durable(*key):
                    done.append(key)
            except NotLeader:
                # the backend certifies the entry at seq is no longer
                # THIS request's entry (superseded across a leadership
                # change): provably never durable
                lost.append(key)
        for g, seq in done:
            req = self._awaiting_writes.pop((g, seq))
            if isinstance(req, _Batch):
                req.remaining -= 1
                if req.remaining == 0 and req.conn.open:
                    self._respond_batch(req)
                continue
            floor = self.backend.commit_floor(g)
            req.conn.observe_floor(g, floor)
            self._finish_span(req, "ok")
            self._send(req.conn, P.encode_ok(
                req.req_id, g, seq, floor, trace=self._rtrace(req),
            ))
            self.responses_total += 1
        for key in lost:
            req = self._awaiting_writes.pop(key, None)
            if req is None:
                continue
            if isinstance(req, _Batch):
                # one lost member poisons the whole batch: sibling
                # entries may already be durable, so neither OK_BATCH
                # nor a no-effect NOT_LEADER would be honest — ERROR,
                # like the expired path
                for k2 in [k for k, r in self._awaiting_writes.items()
                           if r is req]:
                    del self._awaiting_writes[k2]
                if req.span is not None and not req.span.terminal:
                    req.span.finish("info", now)
                if req.conn.open:
                    self._send(req.conn, P.encode_error(
                        req.req_id,
                        "write lost: entry superseded across a "
                        "leadership change",
                        trace=self._rtrace(req),
                    ))
                    self.responses_total += 1
            elif req.conn.open:
                # single write: provably no effect — the typed refusal
                # with a redial hint, exactly as if submit had refused
                self._not_leader(req, key[0])
            else:
                self._finish_span(req, "info")
        expired = [key for key, req in self._awaiting_writes.items()
                   if now - req.t_in > self.op_timeout_s
                   or not req.conn.open]
        responded: set = set()
        for key in expired:
            req = self._awaiting_writes.pop(key)
            if id(req) in responded:
                continue
            responded.add(id(req))
            if not isinstance(req, _Batch):
                self._finish_span(req, "info")
            elif req.span is not None and not req.span.terminal:
                req.span.finish("info", now)
            if req.conn.open:
                # outcome unknown: the entry may have been dropped
                # across a leadership change (never durable) — not a
                # typed no-effect refusal, so it rides ERROR
                self._send(req.conn, P.encode_error(
                    req.req_id,
                    "outcome unknown: write not durable within the "
                    "op timeout",
                    trace=self._rtrace(req),
                ))
                self.responses_total += 1
        still: List[Tuple[_Req, object]] = []
        for req, handle in self._pending_reads:
            if not req.conn.open:
                continue
            try:
                out = self.backend.poll_read(handle)
            except Overloaded as ex:
                self._refuse(req, ex.reason, ex.retry_after_s)
                continue
            except LinearizableReadRefused:
                # the ticket died with the leadership (or was evicted):
                # provably unserved — the client redials
                self._not_leader(req, 0)
                continue
            if out is None:
                if now - req.t_in > self.op_timeout_s:
                    # an unserved read has provably no effect
                    self._not_leader(req, 0)
                else:
                    still.append((req, handle))
            else:
                self._serve_read(req, out)
        self._pending_reads = still
        if self.txn is not None:
            self.txn.poll_all(now)
        if self._pending_txns:
            still_t: List[Tuple[_Req, object]] = []
            for req, h in self._pending_txns:
                if self.txn.poll(h, now):
                    if req.conn.open:
                        self._respond_txn(req, h.txn_id, h.status,
                                          h.reason)
                elif (now - req.t_in > self.op_timeout_s
                        or not req.conn.open):
                    # outcome unknown to THIS request only: the
                    # coordinator adopts the handle, so its locks
                    # resolve without waiting out the TTL (the client
                    # re-asks via TXN_STATUS)
                    self.txn.adopt(h)
                    if req.conn.open:
                        self._finish_span(req, "info")
                        self._send(req.conn, P.encode_error(
                            req.req_id,
                            "outcome unknown: transaction did not "
                            "terminate within the op timeout",
                            trace=self._rtrace(req),
                        ))
                        self.responses_total += 1
                else:
                    still_t.append((req, h))
            self._pending_txns = still_t

    def _serve_read(self, req: _Req, out: _Done) -> None:
        req.conn.observe_floor(out.group, out.index)
        self._finish_span(req, "ok", read_class=out.cls)
        self._send(req.conn, P.encode_value(
            req.req_id, out.group, out.index, out.cls, out.value,
            trace=self._rtrace(req),
        ))
        self.responses_total += 1

    # ---------------------------------------------------------- responses
    def _rtrace(self, req) -> Optional[Tuple[int, int, bool]]:
        """The response's echoed trace context: the op's trace id, OUR
        span id (the client records it — the join hint), the current
        sampling bit. None for untraced requests — their responses stay
        byte-identical to the pre-trace protocol."""
        ctx = req.trace
        if ctx is None:
            return None
        sp = req.span
        if sp is None:
            # no server span exists (a wire_backlog refusal fires
            # before span creation): echo the trace id with span id 0
            # — "no span to join", never the client's own id back
            return (ctx[0], 0, ctx[2])
        return (ctx[0],
                sp.span_id if sp.span_id is not None else sp.trace_id,
                sp.sampled)

    def _refuse(self, req: _Req, reason: str,
                retry_after_s: float) -> None:
        self._refusal(reason)
        self._finish_span(req, "shed", reason=reason)
        self._send(req.conn, P.encode_refused(
            req.req_id, reason, float(retry_after_s),
            trace=self._rtrace(req),
        ))
        self.responses_total += 1

    def _not_leader(self, req: _Req, group: int) -> None:
        self._refusal("not_leader")
        self._finish_span(req, "shed", reason="not_leader")
        self._send(req.conn, P.encode_not_leader(
            req.req_id, group, self.backend.leader_hint(group),
            trace=self._rtrace(req),
        ))
        self.responses_total += 1

    def _finish_span(self, req: _Req, state: str, **fields) -> None:
        sp = req.span
        if sp is not None and not sp.terminal:
            sp.annotate("wire_sent", self.backend.now())
            sp.finish(state, self.backend.now(), **fields)

    async def _flush_writers(self) -> None:
        for conn in list(self._conns):
            if not conn.open:
                continue
            try:
                await conn.wire.drain()
            except (ConnectionError, RuntimeError):
                conn.open = False

    def _send(self, conn: _Conn, frame: bytes) -> None:
        n = conn.send(frame)
        if n:
            self._count_bytes("out", n)

    def _fail_all(self, message: str) -> None:
        """Resolve every in-flight op with a connection-level ERROR
        (the pump died: outcomes unknown) and close the connections."""
        seen: set = set()
        for req in list(self._awaiting_writes.values()):
            if id(req) not in seen:
                seen.add(id(req))
                self._send(req.conn, P.encode_error(req.req_id,
                                                    message))
        self._awaiting_writes.clear()
        for req, _ in self._pending_reads:
            self._send(req.conn, P.encode_error(req.req_id, message))
        self._pending_reads = []
        for req, h in self._pending_txns:
            self.txn.adopt(h)
            self._send(req.conn, P.encode_error(req.req_id, message))
        self._pending_txns = []
        for req in self._pending:
            self._send(req.conn, P.encode_error(req.req_id, message))
        self._pending = []
        for conn in self._conns:
            conn.open = False

    # ------------------------------------------------------ observability
    def _count_request(self, kind: str) -> None:
        self.requests_total[kind] = self.requests_total.get(kind, 0) + 1
        if self.registry is not None:
            self.registry.counter(
                "raft_net_requests_total",
                "wire requests by frame kind", ("kind",),
            ).inc(kind=kind)

    def _count_bytes(self, direction: str, n: int) -> None:
        if self.registry is not None:
            self.registry.counter(
                "raft_net_bytes_total",
                "wire bytes by direction", ("dir",),
            ).inc(n, dir=direction)

    def _refusal(self, reason: str) -> None:
        self.refusals[reason] = self.refusals.get(reason, 0) + 1
        if self.registry is not None:
            self.registry.counter(
                "raft_net_refusals_total",
                "wire refusals by reason", ("reason",),
            ).inc(reason=reason)

    def stats(self) -> dict:
        """The ``net`` section (``/status`` via the StatusBoard)."""
        bytes_out = self._bytes_out_closed + sum(
            c.bytes_out for c in self._conns
        )
        bytes_in = self._bytes_in_closed + sum(
            c.bytes_in for c in self._conns
        )
        out = {
            "connections": len(self._conns),
            "draining": self.draining,
            "in_flight": (len(self._pending)
                          + len(self._awaiting_writes)
                          + len(self._pending_reads)
                          + len(self._pending_txns)),
            "pending_batch": len(self._pending),
            "awaiting_writes": len(self._awaiting_writes),
            "pending_reads": len(self._pending_reads),
            "pending_txns": len(self._pending_txns),
            "bytes_in": bytes_in,
            "bytes_out": bytes_out,
            "requests_total": dict(self.requests_total),
            "responses_total": self.responses_total,
            "refusals": dict(self.refusals),
            "wire_staged_batches": self.wire_staged_batches,
            "tick_staged_batches": self.tick_staged_batches,
            "tick_tail_batches": self.tick_tail_batches,
            "pump_iters": self.pump_iters,
        }
        if self.pump is not None:
            out["pump"] = self.pump.stats()
        return out

    def _publish_status(self) -> None:
        if self.status_board is None:
            return
        self.status_board.publish(self.stats(), section="net")
        if self.txn is not None:
            self.status_board.publish(self.txn.status_snapshot(),
                                      section="txn")
