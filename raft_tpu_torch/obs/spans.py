"""Causal op tracing (port of ``raft_tpu/obs/spans.py``): one span per
client operation, Dapper-style.

A :class:`Span` is the lifetime of ONE client op — submit / linearizable
read — carrying a trace id that propagates through every layer it
crosses: ``Router._with_leader`` (retries, redials, breaker fast-fails),
the admission gate (refusal reasons), ``RaftEngine.submit`` /
``submit_read`` (queueing), ingest (queue delay), commit (replication
rounds) and apply. Each layer *annotates* the span; whoever observes the
op's outcome records exactly one terminal state.

Propagation model: the engines are single-threaded event loops, so the
ambient ``SpanTracker.current`` slot is the trace context — the caller
sets it around the client call (the in-process analogue of a trace-id
header) and the engine binds the span to its sequence number / read
ticket from there. After that the causal chain is keyed by seq → log
index → apply, no ambient state needed.

Cross-process propagation (the wire, docs/OBSERVABILITY.md "Wire
plane"): a span that crosses a process boundary carries ``wire_trace``
— the cross-process trace id minted by the CLIENT side
(``net.client.WireClient``) and propagated in every negotiated frame's
trace context — and, on the adopting (server) side, ``parent_span``,
the remote parent's span id. Joining the two sides' span tables on
``wire_trace`` reconstructs one causal timeline per op
(``obs.forensics.explain_joined``).

Sampling: ``sampled`` is the Dapper head-sampling bit — decided at the
root (``SpanTracker(sample_every=N)`` keeps every Nth trace;
default 1 = everything) and propagated in the wire context so both
sides agree. The TAIL policy overrides the head decision in
:meth:`Span.finish`: an op that ends in anything but ``ok``, or whose
duration exceeds the tracker's ``slow_s`` threshold, is ALWAYS sampled
— slow/refused/unknown-outcome ops never vanish into the sampling
noise, which is what makes a sampled span table forensically sound.

Terminal states:

- ``ok``      — outcome observed (write durable, read served).
- ``failed``  — refused with provably no effect (NotLeader, refused
  read, circuit open).
- ``shed``    — refused by admission (a ``failed`` specialized by cause).
- ``info``    — outcome unknown (crash window, client gave up).

Export: ``to_perfetto()`` emits Chrome/Perfetto trace JSON on the
VIRTUAL clock (virtual seconds scaled into the microsecond ``ts`` field
1:1), so a whole torture run loads into ``ui.perfetto.dev`` as a
timeline — spans as slices per client track, annotations as instants.

Determinism contract: same as the flight recorder — pure host
bookkeeping, no rng, no device traffic; a seeded run replays
byte-identically with the tracker attached or absent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

TERMINAL_STATES = ("ok", "failed", "shed", "info")


@dataclasses.dataclass
class Span:
    trace_id: int
    op: str                          # "write" | "delete" | "read" | ...
    t_start: float
    client: Optional[object] = None
    key: Optional[bytes] = None
    group: Optional[int] = None
    state: str = "open"              # "open" -> one of TERMINAL_STATES
    t_end: Optional[float] = None
    seq: Optional[int] = None        # engine sequence number, once bound
    ticket: Optional[int] = None     # read ticket, once bound
    retries: int = 0                 # refusals retried (router/client)
    redials: int = 0                 # leadership redials (router)
    queue_delay_s: Optional[float] = None     # submit -> ingest
    replication_rounds: Optional[int] = None  # ingest -> commit, in ticks
    #   for reads, the rounds the serve paid END TO END: 0 = fully
    #   local (lease serve, session serve, follower serve certified by
    #   a valid lease), 1 = a dedicated ReadIndex confirmation round
    read_class: Optional[str] = None
    #   served read class (docs/READS.md matrix): "lease" |
    #   "read_index" | "follower" | "session"; None for writes and
    #   never-served reads
    wire_trace: Optional[int] = None
    #   cross-process trace id (client-minted, rides every negotiated
    #   wire frame) — the join key between the two sides' span tables
    parent_span: Optional[int] = None
    #   remote parent's span id (set on the ADOPTING side: the server
    #   span whose parent is the client op span)
    span_id: Optional[int] = None
    #   this span's WIRE-VISIBLE id, when it differs from the local
    #   trace_id: client roots use wire_trace; a server composes its
    #   listening port into the id so two servers' spans stay
    #   distinguishable in a joined timeline (port << 32 | local id)
    sampled: bool = True
    #   head-sampling decision (tail policy may flip it True in finish)
    slow_s: Optional[float] = None
    #   tail-sampling slowness threshold (copied from the tracker at
    #   begin; None = duration never forces sampling)
    refusal_reasons: List[str] = dataclasses.field(default_factory=list)
    annotations: List[Tuple[float, str, Dict[str, Any]]] = \
        dataclasses.field(default_factory=list)

    @property
    def terminal(self) -> bool:
        return self.state != "open"

    def annotate(self, name: str, t: float, **fields: Any) -> None:
        self.annotations.append((t, name, fields))

    def finish(self, state: str, t: Optional[float], **fields: Any) -> None:
        """Record the span's single terminal state. A second terminal
        transition is a harness bug (an op resolved twice) and raises —
        the contract holds for EVERY span population, engine-side and
        wire-client-side alike (tests/test_wire_trace.py pins the
        client paths). Tail sampling happens here: a non-``ok`` outcome
        or a duration past ``slow_s`` forces ``sampled`` True, whatever
        the head decision said."""
        if state not in TERMINAL_STATES:
            raise ValueError(f"not a terminal span state: {state!r}")
        if self.terminal:
            raise RuntimeError(
                f"span {self.trace_id} already terminal "
                f"({self.state!r}); second terminal {state!r}"
            )
        self.state = state
        self.t_end = t                # None = unbounded (info at give-up)
        if state != "ok":
            self.sampled = True       # tail policy: bad outcomes always
        elif (self.slow_s is not None and t is not None
                and t - self.t_start >= self.slow_s):
            self.sampled = True       # tail policy: slow ops always
        if fields:
            self.annotate(f"end:{state}", t if t is not None else
                          self.t_start, **fields)

    def to_jsonable(self) -> dict:
        d = dataclasses.asdict(self)
        if self.key is not None:
            d["key"] = self.key.decode("latin1")
        d["annotations"] = [
            [t, name, fields] for t, name, fields in self.annotations
        ]
        return d


class SpanTracker:
    """Mints, binds and collects spans for one engine stack.

    ``current`` is the ambient trace context (see module docstring); the
    ``note_*`` hooks are what the engine calls at each causal step — all
    tolerant of unbound ids, so instrumented engines keep working for
    callers that never open spans.

    ``sample_every=N`` head-samples every Nth span (deterministic
    counter, no rng — the determinism contract); ``slow_s`` arms the
    tail policy's slowness override (module docstring)."""

    def __init__(self, sample_every: int = 1,
                 slow_s: Optional[float] = None) -> None:
        self.spans: List[Span] = []
        self.current: Optional[Span] = None
        self.sample_every = max(1, int(sample_every))
        self.slow_s = slow_s
        self._next_id = 1
        self._begun = 0
        self._by_seq: Dict[int, Span] = {}
        self._by_idx: Dict[int, Span] = {}
        self._by_ticket: Dict[int, Span] = {}

    def begin(
        self,
        op: str,
        t: float,
        client: Optional[object] = None,
        key: Optional[bytes] = None,
        group: Optional[int] = None,
    ) -> Span:
        sp = Span(
            trace_id=self._next_id, op=op, t_start=t,
            client=client, key=key, group=group,
            sampled=(self._begun % self.sample_every == 0),
            slow_s=self.slow_s,
        )
        self._next_id += 1
        self._begun += 1
        self.spans.append(sp)
        return sp

    def adopt(self, sp: Span,
              ctx: Optional[Tuple[int, int, bool]]) -> Span:
        """Adopt a remote trace context onto ``sp`` (the server side of
        the wire join): the context's trace id becomes the join key,
        its span id the parent, and its sampling bit OVERRIDES the
        local head decision — the root decided (tail policy still
        applies at finish)."""
        if ctx is not None:
            sp.wire_trace, sp.parent_span, sp.sampled = ctx
        return sp

    # ------------------------------------------------ engine-side hooks
    def note_submit(self, seq: int, t: float) -> None:
        """``RaftEngine.submit`` minted ``seq`` for the current span."""
        sp = self.current
        if sp is None:
            return
        sp.seq = seq
        sp.annotate("queued", t, seq=seq)
        self._by_seq[seq] = sp

    def note_ingest(self, seq: int, idx: int, t: float, tick: int) -> None:
        """The leader tick moved ``seq`` from the host queue into the
        replicated log at ``idx``."""
        sp = self._by_seq.get(seq)
        if sp is None:
            return
        sp.queue_delay_s = t - sp.t_start
        sp.annotate("ingested", t, index=idx, tick=tick,
                    queue_delay_s=sp.queue_delay_s)
        sp._ingest_tick = tick          # type: ignore[attr-defined]
        self._by_idx[idx] = sp

    def note_commit(self, seq: int, t: float, tick: int) -> None:
        sp = self._by_seq.pop(seq, None)
        if sp is None:
            return
        t0 = getattr(sp, "_ingest_tick", None)
        sp.replication_rounds = (tick - t0) if t0 is not None else None
        sp.annotate("committed", t, rounds=sp.replication_rounds)

    def note_apply(self, idx: int, t: float) -> None:
        sp = self._by_idx.pop(idx, None)
        if sp is not None:
            sp.annotate("applied", t)

    def note_refusal(self, reason: str, t: float) -> None:
        """An admission gate / engine refusal hit the current span."""
        sp = self.current
        if sp is not None:
            sp.refusal_reasons.append(reason)
            sp.annotate("refused", t, reason=reason)

    def note_read_ticket(self, ticket: int, t: float) -> None:
        sp = self.current
        if sp is None:
            return
        sp.ticket = ticket
        sp.annotate("ticket", t, ticket=ticket)
        self._by_ticket[ticket] = sp

    def note_read_confirmed(self, ticket: int, idx: int, t: float,
                            cls: Optional[str] = None,
                            rounds: Optional[int] = None) -> None:
        sp = self._by_ticket.pop(ticket, None)
        if sp is not None:
            if cls is not None:
                sp.read_class = cls
            if rounds is not None:
                sp.replication_rounds = rounds
            sp.annotate("confirmed", t, read_index=idx, read_class=cls)

    def note_read_served(self, cls: str, t: float,
                         index: Optional[int] = None,
                         rounds: Optional[int] = None,
                         group: Optional[int] = None) -> None:
        """The current span's read was SERVED under class ``cls``
        (docs/READS.md): stamps the class and the replication rounds
        the read paid end to end — ``rounds=0`` is the span-verified
        zero-round contract (lease and session serves always; follower
        serves when their certification rode a valid lease)."""
        sp = self.current
        if sp is None:
            return
        sp.read_class = cls
        if rounds is not None:
            sp.replication_rounds = rounds
        sp.annotate("served", t, read_class=cls, index=index,
                    rounds=rounds, group=group)

    def note_read_refused(self, ticket: Optional[int], reason: str,
                          t: float) -> None:
        sp = (self._by_ticket.pop(ticket, None) if ticket is not None
              else self.current)
        if sp is not None:
            sp.refusal_reasons.append(reason)
            sp.annotate("refused", t, reason=reason)

    # -------------------------------------------------------- inspection
    def __len__(self) -> int:
        return len(self.spans)

    def open_spans(self) -> List[Span]:
        return [sp for sp in self.spans if not sp.terminal]

    def by_state(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for sp in self.spans:
            out[sp.state] = out.get(sp.state, 0) + 1
        return out

    def sampled_spans(self) -> List[Span]:
        """The spans the sampling policy kept: head-sampled plus every
        tail-promoted one (non-``ok`` terminal or slow — the capture a
        forensics bundle embeds when sampling is on)."""
        return [sp for sp in self.spans if sp.sampled]

    # ------------------------------------------------------------ export
    def to_jsonable(self, sampled_only: bool = False) -> dict:
        spans = self.sampled_spans() if sampled_only else self.spans
        return {"spans": [sp.to_jsonable() for sp in spans]}

    def to_perfetto(self) -> dict:
        """Chrome/Perfetto trace JSON on the virtual clock: pid = raft
        group (0 for single-group), tid = client id; spans are ``X``
        slices, annotations ``i`` instants. ``ts`` is microseconds, so
        virtual seconds are scaled 1e6 and a 300-virtual-second run
        spans a readable 5-minute timeline. The spans are read from a
        snapshot of the table, so an engine thread that keeps opening
        spans (a ``/profile`` capture while it runs) cannot keep the
        export from ending."""
        evs: List[dict] = []
        pids = set()
        for sp in list(self.spans):
            pid = sp.group if sp.group is not None else 0
            tid = sp.client if isinstance(sp.client, int) else 0
            pids.add(pid)
            t_end = sp.t_end if sp.t_end is not None else sp.t_start
            name = sp.op
            if sp.key is not None:
                name = f"{sp.op} {sp.key.decode('latin1')}"
            evs.append({
                "name": name, "cat": "op", "ph": "X",
                "ts": sp.t_start * 1e6,
                "dur": max((t_end - sp.t_start) * 1e6, 1.0),
                "pid": pid, "tid": tid,
                "args": {
                    "trace_id": sp.trace_id, "state": sp.state,
                    "seq": sp.seq, "retries": sp.retries,
                    "redials": sp.redials,
                    "queue_delay_s": sp.queue_delay_s,
                    "replication_rounds": sp.replication_rounds,
                    "read_class": sp.read_class,
                    "refusals": sp.refusal_reasons,
                    "wire_trace": sp.wire_trace,
                    "parent_span": sp.parent_span,
                },
            })
            for t, aname, fields in sp.annotations:
                evs.append({
                    "name": aname, "cat": "annotation", "ph": "i",
                    "ts": t * 1e6, "pid": pid, "tid": tid, "s": "t",
                    "args": dict(fields, trace_id=sp.trace_id),
                })
        for pid in sorted(pids):
            evs.append({
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": f"raft group {pid}"},
            })
        return {"traceEvents": evs, "displayTimeUnit": "ms"}


def spans_from_jsonable(d: dict) -> List[Span]:
    """Rehydrate spans from a forensics bundle (keys back to bytes)."""
    out = []
    for sd in d.get("spans", []):
        sd = dict(sd)
        if sd.get("key") is not None:
            sd["key"] = sd["key"].encode("latin1")
        sd["annotations"] = [
            (t, name, fields) for t, name, fields in sd["annotations"]
        ]
        out.append(Span(**sd))
    return out
