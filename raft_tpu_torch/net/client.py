"""Async wire client: pooled connections, pipelining, retry discipline
(port of ``raft_tpu/net/client.py``).

The client-side half of docs/NETWORK.md. One :class:`WireClient` holds
a pool of TCP connections to an ingest server; requests round-robin
over the pool and pipeline freely (many in flight per connection,
completed by ``req_id``), so a single client object can drive an
open-loop workload.

The overload discipline is the same three pieces the in-process Router
composes (``raft_tpu_torch.admission.retry``), because the wire changes the
transport, not the failure economics:

- ``REFUSED`` frames back off with full jitter FLOORED by the server's
  ``retry_after_s`` hint capped at ``max_backoff_s`` — the cap is the
  client's unit adapter: servers hint in their own clock (the virtual
  clock, for the test/bench deployments), and a client that trusts the
  magnitude blindly would sleep wall-seconds for virtual-seconds.
- a ``RetryBudget`` caps sustained retry traffic at a fraction of
  goodput; an exhausted budget surfaces the refusal instead of feeding
  the storm.
- ``NOT_LEADER`` frames redial: when the hint names an address the
  client knows (``addr_map``), the next attempt goes there; otherwise
  the same server is retried after a backoff (it fronts the whole
  replica set in the single-process deployments).

Session tokens: the client carries ``ReadSession`` floors
(``session``), sends them in ``HELLO`` on every (re)connect, and folds
the floor returned on each ``OK``/``VALUE`` back in — so a client that
reconnects (or a new client handed the token) keeps monotone reads and
read-your-writes across connections.

Failure semantics: a connection loss with a SUBMIT in flight raises
:class:`WireDisconnected` — the write's outcome is UNKNOWN (it may
commit) and the client will not silently retry it into a duplicate.
Reads are effect-free and reconnect-retry freely.

Tracing (docs/OBSERVABILITY.md "Wire plane"): with a
``SpanTracker`` attached (``spans=``), the client opens ONE span per
op — the whole retry saga: every attempt, backoff wait, refusal and
leader-hint redial is an annotation on that one span, and exactly one
terminal state closes it (``ok`` / ``shed`` on a typed refusal past
the discipline / ``failed`` on a server ERROR or an effect-free read
loss / ``info`` on a mid-flight write disconnect — outcome unknown).
The span's ``wire_trace`` id is minted deterministically
(``trace_node`` << 32 | local span id — no rng, the determinism
contract) and propagated in the trace context of every frame sent on a
connection that negotiated ``CAP_TRACE`` in the HELLO/WELCOME
capability handshake; against a pre-trace server the handshake yields
no capability and every op frame stays byte-identical to the pre-trace
protocol. ``clock=`` supplies the span timestamp source (the chaos
drill passes the engine's virtual clock so both sides' artifacts share
one timeline; default ``time.monotonic``).
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Dict, List, Optional

from raft_tpu_torch.admission.retry import Backoff, RetryBudget
from raft_tpu_torch.multi.router import ReadSession
from raft_tpu_torch.net import protocol as P


class WireRefused(Exception):
    """The server refused the op past the client's retry discipline
    (retries exhausted, or the retry budget ran dry). ``reason`` is the
    server's last typed refusal reason; the op took NO effect."""

    def __init__(self, reason: str, retry_after_s: float,
                 attempts: int):
        super().__init__(
            f"refused after {attempts} attempt(s): {reason} "
            f"(retry after {retry_after_s:g}s)"
        )
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.attempts = attempts


class WireDisconnected(Exception):
    """The connection died with the op in flight. For a SUBMIT the
    outcome is UNKNOWN (record it ``info``, never ``fail``) — UNLESS
    ``sent`` is False: a pure connect failure provably sent nothing,
    so the op had no effect (span state ``failed``, and retrying it is
    always safe)."""

    def __init__(self, message: str, sent: bool = True):
        super().__init__(message)
        self.sent = sent


class WireError(Exception):
    """The server answered ``ERROR`` (protocol violation, or a write
    whose outcome it could not resolve within its op timeout)."""


class SubmitResult:
    __slots__ = ("group", "seq", "floor", "attempts")

    def __init__(self, group, seq, floor, attempts):
        self.group = group
        self.seq = seq
        self.floor = floor
        self.attempts = attempts


class ReadResult:
    __slots__ = ("group", "index", "cls", "value", "attempts")

    def __init__(self, group, index, cls, value, attempts):
        self.group = group
        self.index = index
        self.cls = cls
        self.value = value
        self.attempts = attempts


class BatchResult:
    """One SUBMIT_BATCH resolution: ``accepted`` entries are DURABLE,
    ``shed`` were typed-refused at ingest (no effect). ``floors`` are
    the commit watermarks of the groups the batch touched (already
    folded into the client session)."""

    __slots__ = ("accepted", "shed", "floors")

    def __init__(self, accepted, shed, floors):
        self.accepted = accepted
        self.shed = shed
        self.floors = floors


class TxnResult:
    """One transaction's resolution. ``status`` is ``"committed"`` /
    ``"aborted"`` / ``"unknown"`` — an abort is an OUTCOME the caller
    inspects, not an error (``reason`` says why: ``lock_lost`` /
    ``expect_failed`` / ``prewrite_refused`` / ``ttl_expired``).
    ``unknown`` only comes from :meth:`WireClient.txn_status`: no
    decision is recorded yet."""

    __slots__ = ("txn_id", "status", "reason", "attempts")

    def __init__(self, txn_id, status, reason, attempts):
        self.txn_id = txn_id
        self.status = status
        self.reason = reason
        self.attempts = attempts

    @property
    def committed(self) -> bool:
        return self.status == "committed"


class _PoolConn:
    """One pooled connection: writer + a reader task dispatching
    response frames to per-request futures by ``req_id``."""

    def __init__(self, client: "WireClient"):
        self.client = client
        self.reader = None
        self.writer = None
        self.pending: Dict[int, asyncio.Future] = {}
        self.open = False
        self.welcome: Optional[tuple] = None
        self.caps = 0            # negotiated capability intersection
        self._task: Optional[asyncio.Task] = None

    async def connect(self, host: str, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            host, port
        )
        self.open = True
        self._task = asyncio.get_running_loop().create_task(self._read())
        # HELLO carries the session floors (reconnect-and-resume) and —
        # when tracing is armed — the CAP_TRACE advertisement; an
        # un-instrumented client emits the pre-capability HELLO
        # byte-for-byte
        fut = self._expect_welcome()
        caps = P.CAP_TRACE if self.client.spans is not None else 0
        if self.client.txn_enabled:
            caps |= P.CAP_TXN
        self.writer.write(P.encode_hello(self.client.session.floor,
                                         caps=caps))
        await self.writer.drain()
        entry_bytes, groups, server_caps = await fut
        self.welcome = (entry_bytes, groups)
        # trace contexts flow only when BOTH sides speak them: a
        # pre-trace server echoes nothing and every subsequent frame
        # stays byte-identical to the pre-trace protocol
        self.caps = caps & server_caps
        self.client.stats["connects"] += 1

    def _expect_welcome(self) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self.pending[-1] = fut           # WELCOME has no req_id
        return fut

    async def _read(self) -> None:
        decoder = P.FrameDecoder(self.client.max_frame_bytes)
        try:
            while True:
                data = await self.reader.read(1 << 16)
                if not data:
                    break
                for kind, payload in decoder.feed(data):
                    self._dispatch(kind, payload)
        except (ConnectionError, P.ProtocolError):
            pass
        finally:
            self.open = False
            for fut in self.pending.values():
                if not fut.done():
                    fut.set_exception(WireDisconnected(
                        "connection lost with ops in flight"
                    ))
            self.pending.clear()
            try:
                self.writer.close()
            except Exception:
                pass

    def _dispatch(self, kind: int, payload: bytes) -> None:
        kind, ctx, payload = P.split_trace(kind, payload)
        #   the echoed trace context (trace id, SERVER span id, final
        #   sampling bit) rides along to the retry loop so the client
        #   span can record which server span answered each attempt
        if kind == P.WELCOME:
            fut = self.pending.pop(-1, None)
            if fut is not None and not fut.done():
                fut.set_result(P.decode_welcome_caps(payload))
            return
        if kind == P.OK:
            req_id, group, seq, floor = P.decode_ok(payload)
            self.client.session.observe(group, floor)
            result = ("ok", (group, seq, floor), ctx)
        elif kind == P.VALUE:
            req_id, group, index, cls, value = P.decode_value(payload)
            self.client.session.observe(group, index)
            result = ("value", (group, index, cls, value), ctx)
        elif kind == P.OK_BATCH:
            req_id, accepted, shed, floors = P.decode_ok_batch(payload)
            for g, idx in floors.items():
                self.client.session.observe(g, idx)
            result = ("ok_batch", (accepted, shed, floors), ctx)
        elif kind == P.REFUSED:
            req_id, reason, retry_after = P.decode_refused(payload)
            result = ("refused", (reason, retry_after), ctx)
        elif kind == P.NOT_LEADER:
            req_id, group, hint = P.decode_not_leader(payload)
            result = ("not_leader", (group, hint), ctx)
        elif kind == P.TXN_STATE:
            req_id, txn_id, status, reason = P.decode_txn_state(payload)
            result = ("txn_state", (txn_id, status, reason), ctx)
        elif kind == P.ERROR:
            req_id, message = P.decode_error(payload)
            if req_id == 0:
                return                   # connection-level: _read ends
            result = ("error", message, ctx)
        else:
            return
        fut = self.pending.pop(req_id, None)
        if fut is not None and not fut.done():
            fut.set_result(result)

    async def request(self, req_id: int, frame: bytes):
        fut = asyncio.get_running_loop().create_future()
        self.pending[req_id] = fut
        try:
            self.writer.write(frame)
            await self.writer.drain()
        except (ConnectionError, RuntimeError):
            self.pending.pop(req_id, None)
            self.open = False
            raise WireDisconnected("connection lost on send")
        return await fut

    def close(self) -> None:
        self.open = False
        if self._task is not None:
            self._task.cancel()
        try:
            self.writer.close()
        except Exception:
            pass


class WireClient:
    """Pooled async client (module docstring).

    ``addr_map`` maps leader-hint strings (``"replica:N"`` or
    addresses) to ``(host, port)`` targets for the redial path; without
    it a ``NOT_LEADER`` retries the same server after a backoff.

    ``spans``/``clock``/``trace_node`` arm the client side of the wire
    trace plane (module docstring): one span per op on ``spans``,
    timestamped by ``clock``, trace ids minted under ``trace_node``
    (default: a process-wide instance counter — deterministic, no
    rng)."""

    _next_node = 0

    def __init__(
        self,
        host: str,
        port: int,
        *,
        pool: int = 1,
        session: Optional[ReadSession] = None,
        retries: int = 8,
        base_backoff_s: float = 0.002,
        max_backoff_s: float = 0.05,
        budget: Optional[RetryBudget] = None,
        addr_map: Optional[Dict[str, tuple]] = None,
        max_frame_bytes: int = P.MAX_FRAME_BYTES,
        rng: Optional[random.Random] = None,
        sleep=None,
        spans=None,
        clock=None,
        trace_node: Optional[int] = None,
        txn: bool = False,
    ) -> None:
        self.host = host
        self.port = port
        self.pool_size = max(1, pool)
        self.session = session if session is not None else ReadSession()
        self.retries = retries
        self.backoff = Backoff(
            base_s=base_backoff_s, max_s=max_backoff_s,
            rng=rng if rng is not None else random.Random(0),
        )
        self.budget = budget if budget is not None else RetryBudget()
        self.addr_map = addr_map or {}
        self.max_frame_bytes = max_frame_bytes
        self._sleep = sleep if sleep is not None else asyncio.sleep
        self.spans = spans
        self._clock = clock
        #   txn=True advertises CAP_TXN in HELLO (the additive-
        #   capability contract: an un-opted client's HELLO stays
        #   byte-identical to the pre-txn protocol)
        self.txn_enabled = txn
        if trace_node is None:
            WireClient._next_node += 1
            trace_node = WireClient._next_node
        self.trace_node = int(trace_node) & 0xFFFFFFFF
        self._conns: List[Optional[_PoolConn]] = [None] * self.pool_size
        self._rr = 0
        self._connect_fails = 0     # consecutive dead dials (failover)
        self._failover_idx = 0
        self._next_req_id = 1
        self.entry_bytes: Optional[int] = None
        self.groups: Optional[int] = None
        self.stats = {
            "connects": 0, "retries": 0, "sheds": 0, "not_leader": 0,
            "redials": 0, "budget_denied": 0,
        }
        self.last_delays: List[float] = []
        #   backoff delays actually honored, newest last (bounded) —
        #   how tests assert the retry_after_s floor without clocks

    # ------------------------------------------------------------- tracing
    def _now(self) -> float:
        return self._clock() if self._clock is not None \
            else time.monotonic()

    def _begin_span(self, op: str, key: bytes):
        """One client span per op (None when tracing is off). The
        cross-process trace id is deterministic: node << 32 | the local
        span id — unique across clients without an rng draw."""
        if self.spans is None:
            return None
        sp = self.spans.begin(op, self._now(), client=self.trace_node,
                              key=key)
        sp.wire_trace = (self.trace_node << 32) | (sp.trace_id
                                                   & 0xFFFFFFFF)
        return sp

    def _ctx(self, sp, conn: _PoolConn):
        """The trace context for one frame — only on a connection that
        negotiated CAP_TRACE (otherwise None: the frame encodes
        byte-identically to the pre-trace protocol)."""
        if sp is None or not (conn.caps & P.CAP_TRACE):
            return None
        return (sp.wire_trace, sp.wire_trace, sp.sampled)

    def _finish_at(self, sp, state: str, **fields) -> None:
        if sp is not None and not sp.terminal:
            sp.finish(state, self._now(), **fields)

    @staticmethod
    def _sid(rctx) -> Optional[int]:
        """The answering server's span id from an echoed context (0 =
        the server had no span to join — annotate nothing)."""
        return rctx[1] if rctx is not None and rctx[1] else None

    # ----------------------------------------------------------- lifecycle
    async def connect(self) -> "WireClient":
        for i in range(self.pool_size):
            await self._ensure_conn(i)
        return self

    async def _ensure_conn(self, i: int) -> _PoolConn:
        conn = self._conns[i]
        if conn is not None and conn.open:
            return conn
        conn = _PoolConn(self)
        await conn.connect(self.host, self.port)
        self._connect_fails = 0
        self._conns[i] = conn
        if conn.welcome is not None:
            self.entry_bytes, self.groups = conn.welcome
        return conn

    async def close(self) -> None:
        for conn in self._conns:
            if conn is not None:
                conn.close()
        self._conns = [None] * self.pool_size
        await asyncio.sleep(0)

    async def _pick(self) -> _PoolConn:
        self._rr = (self._rr + 1) % self.pool_size
        return await self._ensure_conn(self._rr)

    # ------------------------------------------------------------ requests
    async def submit(self, key: bytes, value: bytes) -> SubmitResult:
        """One durable write. Retries typed refusals under the backoff
        + budget discipline; raises :class:`WireRefused` past it,
        :class:`WireDisconnected` on a mid-flight connection loss (the
        write may still commit — never auto-resubmitted), and
        :class:`WireError` when the server could not resolve the
        outcome."""
        sp = self._begin_span("client_submit", key)
        try:
            out = await self._with_retries(
                lambda req_id, trace: P.encode_submit(
                    req_id, key, value,
                    max_frame_bytes=self.max_frame_bytes, trace=trace,
                ),
                self._parse_submit,
                reconnect_retry=False,
                sp=sp,
            )
        except WireRefused as ex:
            self._finish_at(sp, "shed", reason=ex.reason,
                            attempts=ex.attempts)
            raise
        except WireDisconnected as ex:
            # outcome UNKNOWN (the write may still commit) only if a
            # frame may have left the client; a pure connect failure
            # provably had no effect
            self._finish_at(sp, "info" if ex.sent else "failed")
            raise
        except WireError:
            self._finish_at(sp, "failed")
            raise
        except asyncio.CancelledError:
            self._finish_at(sp, "info")      # shutdown mid-op: unknown
            raise
        except BaseException:
            # anything else (e.g. FrameTooLarge when the trace context
            # pushes a near-bound payload over) raised before a frame
            # left: the span still closes exactly once
            self._finish_at(sp, "failed")
            raise
        if sp is not None:
            sp.group = out.group
            sp.annotate("floor", self._now(), group=out.group,
                        floor=out.floor)     # the session-token carry
        self._finish_at(sp, "ok", attempts=out.attempts, seq=out.seq)
        return out

    async def submit_many(self, items) -> BatchResult:
        """Many writes in ONE frame (the batched-ingest amortization —
        docs/NETWORK.md). Single attempt, no retry wrapper: per-entry
        refusals come back AS data (``BatchResult.shed``), because a
        partially-admitted batch must not be resubmitted whole. Raises
        :class:`WireDisconnected` on a mid-flight connection loss (the
        admitted part may still commit)."""
        sp = self._begin_span("client_submit_batch", b"")
        req_id = self._next_req_id
        self._next_req_id += 1
        try:
            conn = await self._pick()
        except OSError as ex:
            # connect failure before anything was sent: typed, so
            # callers handle one exception family for conn loss
            self._finish_at(sp, "failed")
            raise WireDisconnected(
                f"cannot connect to {self.host}:{self.port}: {ex}",
                sent=False,
            )
        if sp is not None:
            sp.annotate("attempt", self._now(), n=1, entries=len(items))
        try:
            tag, body, rctx = await conn.request(
                req_id, P.encode_submit_batch(
                    req_id, items,
                    max_frame_bytes=self.max_frame_bytes,
                    trace=self._ctx(sp, conn),
                ))
        except WireDisconnected as ex:
            # admitted part may commit — unless nothing was ever sent
            self._finish_at(sp, "info" if ex.sent else "failed")
            raise
        except asyncio.CancelledError:
            self._finish_at(sp, "info")
            raise
        except BaseException:
            self._finish_at(sp, "failed")    # e.g. encode failure
            raise
        if tag == "ok_batch":
            accepted, shed, floors = body
            self.budget.on_success()
            if shed:
                self.stats["sheds"] += shed
            if sp is not None:
                for g, idx in sorted(floors.items()):
                    sp.annotate("floor", self._now(), group=g,
                                floor=idx)
                if rctx is not None:
                    sp.annotate("response", self._now(), tag=tag,
                                server_span=self._sid(rctx))
            self._finish_at(sp, "ok", accepted=accepted, shed=shed)
            return BatchResult(accepted, shed, floors)
        if tag == "error":
            if sp is not None and rctx is not None:
                sp.annotate("server_error", self._now(),
                            server_span=self._sid(rctx))
            self._finish_at(sp, "failed")
            raise WireError(body)
        if tag == "refused":
            # the whole frame was refused before ingest (wire_backlog:
            # the server's bounded coalesce buffer) — nothing queued
            reason, retry_after = body
            self.stats["sheds"] += 1
            self._finish_at(sp, "shed", reason=reason, attempts=1)
            raise WireRefused(reason, retry_after, 1)
        self._finish_at(sp, "shed", reason="batch_unresolved",
                        attempts=1)
        raise WireRefused("batch_unresolved", 0.0, 1)

    async def read(self, key: bytes,
                   cls: str = "linearizable") -> ReadResult:
        """One read under ``cls`` (``linearizable`` / ``any`` /
        ``session`` — the served class comes back on the result).
        Reads are effect-free, so connection losses reconnect-retry."""
        sp = self._begin_span("client_read", key)
        try:
            out = await self._with_retries(
                lambda req_id, trace: P.encode_read(
                    req_id, cls, key,
                    max_frame_bytes=self.max_frame_bytes, trace=trace,
                ),
                self._parse_read,
                reconnect_retry=True,
                sp=sp,
            )
        except WireRefused as ex:
            self._finish_at(sp, "shed", reason=ex.reason,
                            attempts=ex.attempts)
            raise
        except BaseException:
            # an unserved read is provably effect-free whatever killed
            # it (disconnect, server error, cancellation, encode
            # failure) — one terminal, always
            self._finish_at(sp, "failed")
            raise
        if sp is not None:
            sp.group = out.group
            sp.read_class = out.cls
            sp.annotate("floor", self._now(), group=out.group,
                        floor=out.index)
        self._finish_at(sp, "ok", attempts=out.attempts,
                        read_class=out.cls, index=out.index)
        return out

    @staticmethod
    def _parse_submit(tag: str, body, attempts: int):
        if tag != "ok":
            return None
        group, seq, floor = body
        return SubmitResult(group, seq, floor, attempts)

    @staticmethod
    def _parse_read(tag: str, body, attempts: int):
        if tag != "value":
            return None
        group, index, cls, value = body
        return ReadResult(group, index, cls, value, attempts)

    async def _with_retries(self, build, parse, reconnect_retry: bool,
                            sp=None):
        last_reason, last_hint = "unknown", 0.0
        attempt = 0
        while True:
            attempt += 1
            req_id = self._next_req_id
            self._next_req_id += 1
            try:
                conn = await self._pick()
            except OSError as ex:
                # connect failure: NOTHING was sent, so retrying is
                # safe even for writes — a refused dial (server
                # restarting, redial target not up yet) rides the
                # same backoff instead of leaking a raw OSError
                if attempt <= self.retries:
                    self.stats["retries"] += 1
                    # a server that answers NOTHING can never hint the
                    # leader — after two dead dials, fail over to the
                    # next address in the map (cluster mode: a killed
                    # node's clients must find the survivors)
                    self._connect_fails += 1
                    if self._connect_fails >= 2:
                        self._failover(sp)
                    delay = self.backoff.delay(attempt - 1)
                    if sp is not None:
                        sp.retries += 1
                        sp.annotate("backoff", self._now(),
                                    delay_s=delay,
                                    cause="connect_failed")
                    await self._sleep(delay)
                    continue
                raise WireDisconnected(
                    f"cannot connect to {self.host}:{self.port}: {ex}",
                    sent=False,
                )
            if sp is not None:
                sp.annotate("attempt", self._now(), n=attempt)
            try:
                tag, body, rctx = await conn.request(
                    req_id, build(req_id, self._ctx(sp, conn))
                )
            except WireDisconnected:
                if reconnect_retry and attempt <= self.retries:
                    if sp is not None:
                        sp.annotate("reconnect", self._now(), n=attempt)
                    continue
                raise
            out = parse(tag, body, attempt)
            if out is not None:
                self.budget.on_success()
                if sp is not None and rctx is not None:
                    sp.annotate("response", self._now(), tag=tag,
                                server_span=self._sid(rctx))
                return out
            if tag == "error":
                if sp is not None and rctx is not None:
                    # the ERROR-answering server span must still be
                    # joinable in the forensics timeline
                    sp.annotate("server_error", self._now(),
                                server_span=self._sid(rctx))
                raise WireError(body)
            if tag == "refused":
                last_reason, last_hint = body
                self.stats["sheds"] += 1
                if sp is not None:
                    sp.refusal_reasons.append(last_reason)
                    sp.annotate("refused", self._now(),
                                reason=last_reason,
                                retry_after_s=last_hint,
                                server_span=self._sid(rctx))
            elif tag == "not_leader":
                group, hint = body
                last_reason, last_hint = "not_leader", 0.0
                self.stats["not_leader"] += 1
                if sp is not None:
                    sp.refusal_reasons.append("not_leader")
                    sp.annotate("not_leader", self._now(), group=group,
                                hint=hint,
                                server_span=self._sid(rctx))
                self._maybe_redial(hint, sp)
            if attempt > self.retries:
                raise WireRefused(last_reason, last_hint, attempt)
            if not self.budget.try_spend():
                self.stats["budget_denied"] += 1
                raise WireRefused(last_reason, last_hint, attempt)
            self.stats["retries"] += 1
            delay = self.backoff.delay(
                attempt - 1, last_hint if last_hint > 0 else None
            )
            if len(self.last_delays) >= 256:
                del self.last_delays[:128]
            self.last_delays.append(delay)
            if sp is not None:
                sp.retries += 1
                sp.annotate("backoff", self._now(), delay_s=delay)
            await self._sleep(delay)

    def _maybe_redial(self, hint: str, sp) -> None:
        """Leader-hint redial: repoint the pool (closing the old conns
        — an orphaned socket per redial would leak across a flappy
        election). Hints resolve through ``addr_map`` first (symbolic
        names like ``replica:2``), then as literal ``host:port``
        addresses — the cluster tier's nodes hint each other's wire
        addresses directly, so redial works past loopback with no
        pre-shared map."""
        target = self.addr_map.get(hint)
        if target is None and ":" in hint:
            host, _, port = hint.rpartition(":")
            try:
                target = (host, int(port))
            except ValueError:
                target = None
        if target is None or target == (self.host, self.port):
            return
        self._repoint(target)
        self.stats["redials"] += 1
        if sp is not None:
            sp.redials += 1
            sp.annotate("redial", self._now(), target=hint)

    def _failover(self, sp) -> None:
        """Dead-server failover: round-robin to the next DISTINCT
        address in ``addr_map``. Redial-by-hint cannot work when the
        server is gone (no frame, no hint) — this is the blind half of
        the multi-server story; the survivors' ``NOT_LEADER`` hints
        take over once anything answers."""
        ring = sorted(set(tuple(v) for v in self.addr_map.values()))
        cur = (self.host, self.port)
        others = [a for a in ring if a != cur]
        if not others:
            return
        nxt = others[(self._failover_idx) % len(others)]
        self._failover_idx += 1
        self._connect_fails = 0
        self._repoint(nxt)
        self.stats["failovers"] = self.stats.get("failovers", 0) + 1
        if sp is not None:
            sp.annotate("failover", self._now(),
                        target=f"{nxt[0]}:{nxt[1]}")

    def _repoint(self, target) -> None:
        self.host, self.port = target
        for old in self._conns:
            if old is not None:
                old.close()
        self._conns = [None] * self.pool_size

    # --------------------------------------------------------- transactions
    async def txn_commit(self, writes, expects=()) -> TxnResult:
        """One cross-group transaction: ``writes`` = [(key, new value |
        None to delete)] staged under replicated locks, ``expects`` =
        [(key, committed value | None for expect-absent)] certified
        under them (docs/TXN.md). BEGIN allocates the server-side txn
        id; TXN_COMMIT is the single effectful frame.

        Retry discipline: a typed refusal (``txn_lock``, admission
        sheds, ``not_leader``) provably queued NOTHING, so the loop
        backs off under the usual budget and re-opens with a FRESH txn
        id. A connection loss before COMMIT is sent retries freely
        (BEGIN has no effect); from the COMMIT send onward the outcome
        is UNKNOWN — :class:`WireDisconnected` surfaces it and
        :meth:`txn_status` resolves it. ``aborted`` comes back as a
        RESULT, not an exception: certification failures are an outcome
        the application inspects. Requires ``txn=True`` and a server
        that spoke ``CAP_TXN`` back."""
        key0 = writes[0][0] if writes \
            else (expects[0][0] if expects else b"")
        sp = self._begin_span("client_txn", key0)
        try:
            out = await self._txn_commit_loop(writes, expects, sp)
        except WireRefused as ex:
            self._finish_at(sp, "shed", reason=ex.reason,
                            attempts=ex.attempts)
            raise
        except WireDisconnected as ex:
            self._finish_at(sp, "info" if ex.sent else "failed")
            raise
        except asyncio.CancelledError:
            self._finish_at(sp, "info")
            raise
        except BaseException:
            self._finish_at(sp, "failed")
            raise
        self._finish_at(sp, "ok", status=out.status,
                        attempts=out.attempts)
        return out

    async def _txn_commit_loop(self, writes, expects, sp) -> TxnResult:
        last_reason, last_hint = "unknown", 0.0
        attempt = 0
        while True:
            attempt += 1
            try:
                conn = await self._pick()
            except OSError as ex:
                if attempt <= self.retries:
                    self.stats["retries"] += 1
                    delay = self.backoff.delay(attempt - 1)
                    if sp is not None:
                        sp.retries += 1
                        sp.annotate("backoff", self._now(),
                                    delay_s=delay,
                                    cause="connect_failed")
                    await self._sleep(delay)
                    continue
                raise WireDisconnected(
                    f"cannot connect to {self.host}:{self.port}: {ex}",
                    sent=False,
                )
            if not (conn.caps & P.CAP_TXN):
                raise WireError(
                    "server did not negotiate CAP_TXN (no transaction "
                    "coordinator attached, or txn=False on this client)"
                )
            if sp is not None:
                sp.annotate("attempt", self._now(), n=attempt)
            # BEGIN allocates an id and nothing else: a disconnect
            # here provably left no effect, so it retries freely
            req_id = self._next_req_id
            self._next_req_id += 1
            try:
                tag, body, rctx = await conn.request(
                    req_id, P.encode_txn_begin(
                        req_id, trace=self._ctx(sp, conn),
                    ))
            except WireDisconnected:
                if attempt <= self.retries:
                    if sp is not None:
                        sp.annotate("reconnect", self._now(), n=attempt)
                    continue
                raise
            if tag == "txn_state":
                txn_id = body[0]
                if sp is not None:
                    sp.annotate("txn_open", self._now(), txn=txn_id)
                # the effectful frame: from here a disconnect is
                # outcome UNKNOWN (WireDisconnected bubbles)
                req_id = self._next_req_id
                self._next_req_id += 1
                tag, body, rctx = await conn.request(
                    req_id, P.encode_txn_commit(
                        req_id, txn_id, writes, expects,
                        max_frame_bytes=self.max_frame_bytes,
                        trace=self._ctx(sp, conn),
                    ))
                if tag == "txn_state":
                    txn_id, status, reason = body
                    self.budget.on_success()
                    if sp is not None and rctx is not None:
                        sp.annotate("response", self._now(), tag=tag,
                                    server_span=self._sid(rctx))
                    return TxnResult(txn_id, status, reason, attempt)
            if tag == "error":
                if sp is not None and rctx is not None:
                    sp.annotate("server_error", self._now(),
                                server_span=self._sid(rctx))
                raise WireError(body)
            if tag == "refused":
                # typed: nothing queued — the next attempt re-BEGINs
                # under a fresh txn id
                last_reason, last_hint = body
                self.stats["sheds"] += 1
                if sp is not None:
                    sp.refusal_reasons.append(last_reason)
                    sp.annotate("refused", self._now(),
                                reason=last_reason,
                                retry_after_s=last_hint,
                                server_span=self._sid(rctx))
            elif tag == "not_leader":
                group, hint = body
                last_reason, last_hint = "not_leader", 0.0
                self.stats["not_leader"] += 1
                if sp is not None:
                    sp.refusal_reasons.append("not_leader")
                    sp.annotate("not_leader", self._now(), group=group,
                                hint=hint,
                                server_span=self._sid(rctx))
                self._maybe_redial(hint, sp)
            if attempt > self.retries:
                raise WireRefused(last_reason, last_hint, attempt)
            if not self.budget.try_spend():
                self.stats["budget_denied"] += 1
                raise WireRefused(last_reason, last_hint, attempt)
            self.stats["retries"] += 1
            delay = self.backoff.delay(
                attempt - 1, last_hint if last_hint > 0 else None
            )
            if len(self.last_delays) >= 256:
                del self.last_delays[:128]
            self.last_delays.append(delay)
            if sp is not None:
                sp.retries += 1
                sp.annotate("backoff", self._now(), delay_s=delay)
            await self._sleep(delay)

    async def txn_status(self, txn_id: int) -> TxnResult:
        """Decision lookup (effect-free, reconnect-retries): how a
        :meth:`txn_commit` that died mid-flight resolves its outcome.
        ``unknown`` means no decision is recorded YET — an undecided
        transaction's locks fall to the server's TTL resolver, so
        re-ask after its ``ttl_s``."""
        return await self._txn_query(
            "client_txn_status", P.encode_txn_status, txn_id
        )

    async def txn_abort(self, txn_id: int) -> TxnResult:
        """Abandon an open (never-committed) transaction. BEGIN placed
        nothing server-side, so this is trivially effect-free; a txn
        with a recorded decision answers with THAT verdict instead."""
        return await self._txn_query(
            "client_txn_abort", P.encode_txn_abort, txn_id
        )

    async def _txn_query(self, op: str, enc, txn_id: int) -> TxnResult:
        sp = self._begin_span(op, b"")

        def parse(tag, body, attempts):
            if tag != "txn_state":
                return None
            tid, status, reason = body
            return TxnResult(tid, status, reason, attempts)

        try:
            conn = await self._pick()
            if not (conn.caps & P.CAP_TXN):
                raise WireError(
                    "server did not negotiate CAP_TXN (no transaction "
                    "coordinator attached, or txn=False on this "
                    "client)"
                )
            out = await self._with_retries(
                lambda req_id, trace: enc(req_id, txn_id, trace=trace),
                parse, reconnect_retry=True, sp=sp,
            )
        except WireRefused as ex:
            self._finish_at(sp, "shed", reason=ex.reason,
                            attempts=ex.attempts)
            raise
        except BaseException:
            self._finish_at(sp, "failed")
            raise
        self._finish_at(sp, "ok", status=out.status,
                        attempts=out.attempts)
        return out
