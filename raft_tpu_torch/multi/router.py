"""Key-routed client surface over a ``MultiEngine`` (a copy of
``raft_tpu/multi/router.py``: host code, over the port's ``admission``
and ``multi.engine``).

The router is the sharding front end: it hashes each key onto one of the
G consensus groups (stable, process-independent — CRC32 of the key
bytes), fans submits/reads out to the owning group's leader, and owns
the ``NotLeader`` retry loop so callers never see a leadership gap
unless the group truly cannot elect.

Batched entry points (``submit_many`` / ``read_index_many``) bucket
requests by group first: each group's entries land in the group's queue
in caller order (per-key ordering is preserved — a key always maps to
the same group), and leadership is confirmed once per *group*, not once
per request. With the engine's same-tick launch fusion, a bucketed
submit burst across all G groups then replicates via shared batched
launches rather than G independent dispatch streams.

The retry loop carries the full client-side overload discipline
(``admission.retry``): jittered exponential
backoff between attempts, a router-wide retry BUDGET (a token bucket
refilled by successes — sustained retry traffic is capped at a fraction
of goodput, so a refusal wave cannot amplify itself), and a per-group
circuit breaker that converts repeated ``NotLeader`` / ``Overloaded``
refusals into fast-fail ``CircuitOpen`` until a cooldown-gated probe
succeeds.
"""

from __future__ import annotations

import random
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.admission import (
    Backoff,
    CircuitBreaker,
    CircuitOpen,
    Overloaded,
    RetryBudget,
)
from raft_tpu_torch.multi.engine import MultiEngine, NotLeader, ReadLagging


class ReadSession:
    """Client-side session token: per-group commit-index floors
    (docs/READS.md). Carried by a client across requests, it buys
    MONOTONE READS and READ-YOUR-WRITES from any sufficiently
    caught-up replica with zero leader contact: a serve below the
    floor is refused (``ReadLagging``), a serve at/above it raises the
    floor. The token is just integers — serializable, shardable, and
    exactly the per-(client, key) watermark bookkeeping the online
    auditor (``obs.audit``) maintains server-side to falsify it."""

    def __init__(self) -> None:
        self.floor: Dict[int, int] = {}

    def observe(self, group: int, index: int) -> None:
        """The client observed state at ``index`` (a served read, or a
        write it saw acknowledged durable): the floor only rises."""
        if index > self.floor.get(group, 0):
            self.floor[group] = index

    def to_jsonable(self) -> dict:
        return {str(g): int(i) for g, i in self.floor.items()}

    @classmethod
    def from_floors(cls, floors) -> "ReadSession":
        """Rebuild a session from serialized floors (``to_jsonable``
        output, or the plain ``{group: index}`` dict the wire protocol
        carries in HELLO frames — docs/NETWORK.md): the token really is
        just integers, so a client handing its floors to a fresh
        connection, process, or host keeps monotone reads and
        read-your-writes across the move."""
        s = cls()
        for g, idx in (floors or {}).items():
            s.observe(int(g), int(idx))
        return s


class Router:
    """Key -> group routing + per-group refusal/retry discipline.

    ``drive=True`` (default, the in-process deployment): on a refusal
    (``NotLeader`` from a leadership gap, ``Overloaded`` from a group's
    bounded queue) the router backs off — driving the engine's event
    loop for the jittered delay, the in-process analogue of a client
    sleeping then redialing — and retries, spending from the retry
    budget. ``drive=False`` re-raises on the first refusal and applies
    none of the discipline (an external driver owns the event loop AND
    the retry policy; without driving, a retry is guaranteed to see
    identical state).

    Defaults derive from the engine's config: backoff base = one
    heartbeat period, capped at the max election timeout (so a
    NotLeader retry naturally spans an election window); breaker
    cooldown = the max election timeout; budget = ``retry_budget``
    tokens refilled ``retry_refill`` per success."""

    def __init__(
        self, engine: MultiEngine, max_retries: int = 8, drive: bool = True,
        elect_limit: float = 600.0,
        retry_budget: float = 32.0, retry_refill: float = 0.5,
        breaker_threshold: int = 8, breaker_cooldown_s: Optional[float] = None,
        spans=None,
    ):
        self.engine = engine
        self.max_retries = max_retries
        self.drive = drive
        self.elect_limit = elect_limit
        self.spans = spans
        #   obs.spans.SpanTracker (None = off): _with_leader annotates
        #   the ambient span with every retry / redial / breaker
        #   fast-fail, so a client op's span shows the full refusal
        #   discipline it rode through (docs/OBSERVABILITY.md).
        cfg = engine.cfg
        self.backoff = Backoff(
            base_s=cfg.heartbeat_period, max_s=cfg.follower_timeout[1],
            rng=random.Random(f"router:{cfg.seed}"),
        )
        self.budget = RetryBudget(
            capacity=retry_budget, refill_per_success=retry_refill,
        )
        cooldown = (breaker_cooldown_s if breaker_cooldown_s is not None
                    else cfg.follower_timeout[1])
        self.breakers = [
            CircuitBreaker(
                failure_threshold=breaker_threshold, cooldown_s=cooldown,
                on_transition=self._breaker_transition(g),
            )
            for g in range(engine.G)
        ]
        self._breaker_states = ["closed"] * engine.G
        self._rr: Dict[int, int] = {}
        #   per-group round-robin cursor for read_any's serve-target
        #   spread (host-only state; reads are stateless server-side)

    def _breaker_transition(self, g: int):
        """Breaker open/half_open/close transitions into the engine's
        flight recorder (a previously-silent client-side plane). Bound
        lazily so a recorder attached after construction still sees
        them; the engine clock stamps the event (breaker success paths
        carry no timestamp of their own). With a status board attached
        to the engine (obs.serve), the per-group breaker states also
        publish as the ``breakers`` section of ``/status``."""
        def _note(state: str, _now: float, g=g) -> None:
            rec = getattr(self.engine, "recorder", None)
            if rec is not None:
                rec.record(
                    node=f"g{g}/client", group=g, term=-1,
                    kind=f"breaker_{state}",
                    t_virtual=self.engine.clock.now, state="client",
                )
            self._breaker_states[g] = state
            board = getattr(self.engine, "status_board", None)
            if board is not None:
                board.publish(
                    {str(gg): s
                     for gg, s in enumerate(self._breaker_states)},
                    section="breakers",
                )
            sp = self.spans.current if self.spans is not None else None
            if sp is not None:
                sp.annotate(f"breaker_{state}", self.engine.clock.now,
                            group=g)
        return _note

    # --------------------------------------------------------- placement
    def rebalance(self, max_moves: Optional[int] = None) -> dict:
        """Drive BOTH placement planes from the online signals: leader
        respread within replica rows (``MultiEngine.rebalance`` — the
        §5.4.1-gated round-robin campaigns) and, on the sharded layout,
        group→shard migration planned by the StatusBoard-fed
        :class:`multi.rebalancer.Rebalancer` (burn-rate alerts,
        queue depths, this router's own published breaker states).
        Returns ``{"leader_moves": n, "migrations": [...]}``."""
        from raft_tpu_torch.multi.rebalancer import Rebalancer

        leader_moves = self.engine.rebalance(max_moves)
        migrations = []
        if self.engine.n_shards > 1:
            if not hasattr(self, "_rebalancer"):
                self._rebalancer = Rebalancer(self.engine)
            migrations = self._rebalancer.step(
                max_moves=max_moves if max_moves is not None else 1
            )
        return {"leader_moves": leader_moves, "migrations": migrations}

    # ------------------------------------------------------------- routing
    def group_of(self, key: bytes) -> int:
        """Stable key -> group hash. CRC32 rather than ``hash()``:
        Python's string hashing is salted per process, and a sharded
        store's placement must agree across restarts and processes."""
        return zlib.crc32(key) % self.engine.G

    def _with_leader(self, g: int, fn: Callable):
        """Run ``fn`` under group ``g``'s refusal/retry discipline:
        breaker gate, jittered backoff, retry budget, redial."""
        breaker = self.breakers[g]
        sp = self.spans.current if self.spans is not None else None
        if self.drive and not breaker.allow(self.engine.clock.now):
            # fast-fail without touching the engine: the group refused
            # repeatedly and its cooldown has not elapsed (the next
            # allowed call after cooldown is the half-open probe)
            if sp is not None:
                sp.refusal_reasons.append("circuit_open")
                sp.annotate("circuit_open", self.engine.clock.now, group=g)
            raise CircuitOpen(breaker.retry_after(self.engine.clock.now), g)
        for attempt in range(self.max_retries + 1):
            try:
                out = fn()
            except (NotLeader, Overloaded) as ex:
                if sp is not None:
                    reason = getattr(ex, "reason", "not_leader")
                    sp.refusal_reasons.append(reason)
                    #   MultiEngine's depth refusal has no engine-side
                    #   span hook (unlike RaftEngine's note_refusal), so
                    #   the router records the reason — an admission
                    #   shed must close its span as "shed", not "failed"
                    sp.annotate(
                        "refusal", self.engine.clock.now, group=g,
                        attempt=attempt, kind=type(ex).__name__,
                        reason=reason,
                    )
                if not self.drive:
                    # without driving, nothing changes engine state
                    # between attempts (single-threaded host) — a retry
                    # is guaranteed identical, so fail on first refusal
                    # (and the external driver owns the retry policy)
                    raise
                breaker.on_failure(self.engine.clock.now)
                if attempt >= self.max_retries:
                    raise
                if not self.budget.try_spend():
                    # retry budget exhausted: retries are capped at a
                    # fraction of goodput — surface the refusal instead
                    # of feeding the overload
                    if sp is not None:
                        sp.annotate(
                            "retry_budget_exhausted",
                            self.engine.clock.now, group=g,
                        )
                    raise
                if sp is not None:
                    sp.retries += 1
                delay = self.backoff.delay(
                    attempt, getattr(ex, "retry_after_s", None)
                )
                if (isinstance(ex, NotLeader)
                        and self.engine.leader_id[g] is not None):
                    # a leader is still ROUTED but cannot confirm (the
                    # minority side of a partition: quorum unreachable /
                    # deposed mid-round): a short backoff would redial
                    # frozen state — drive a full election window so
                    # the majority side can elect; its winner replaces
                    # leader_id[g] and the retry redials it.
                    delay = max(delay, self.engine.cfg.follower_timeout[1])
                self.engine.run_for(delay)
                if (isinstance(ex, NotLeader)
                        and self.engine.leader_id[g] is None):
                    # leaderless: drive the event loop until the group
                    # re-elects (the redial); a group that cannot elect
                    # lets run_until_leader's own NotLeader propagate
                    if sp is not None:
                        sp.redials += 1
                        sp.annotate("redial", self.engine.clock.now,
                                    group=g)
                    self.engine.run_until_leader(g, limit=self.elect_limit)
                if not breaker.allow(self.engine.clock.now):
                    if sp is not None:
                        sp.refusal_reasons.append("circuit_open")
                        sp.annotate("circuit_open", self.engine.clock.now,
                                    group=g)
                    raise CircuitOpen(
                        breaker.retry_after(self.engine.clock.now), g
                    )
            else:
                if self.drive:
                    breaker.on_success(self.engine.clock.now)
                    self.budget.on_success()
                return out
        raise AssertionError("unreachable")

    # ------------------------------------------------------------- submits
    def submit(self, key: bytes, payload: bytes) -> Tuple[int, int]:
        """Route one entry to its key's group leader; returns
        ``(group, seq)`` — durable once ``engine.is_durable(group, seq)``."""
        g = self.group_of(key)
        seq = self._with_leader(
            g, lambda: self.engine.submit_to_leader(g, payload)
        )
        return g, seq

    def submit_many(
        self, items: Sequence[Tuple[bytes, bytes]]
    ) -> List[Tuple[int, int]]:
        """Batched submit: bucket ``(key, payload)`` pairs by group, then
        submit each bucket under ONE leadership check + retry. Returns
        ``(group, seq)`` per item, aligned with the input order; within
        a group, queue order is input order (per-key ordering holds
        because a key's group is fixed).

        Partial failure: buckets are placed sequentially, and a bucket
        that exhausts its retries does NOT un-place earlier buckets'
        entries (they are already queued and will commit). The raised
        ``NotLeader`` / ``Overloaded`` carries the aligned results so
        far as ``.partial`` (None = unplaced item) — await those seqs
        rather than resubmitting them. A bucket refused mid-way (a
        bounded queue filling between items) resumes from its first
        UNPLACED item on retry, so a retried bucket can never queue an
        entry twice.

        The txn plane's prewrite fan-out (``txn.coordinator``) depends
        on exactly this contract: a partially placed prewrite must
        keep its placed lock entries (they will apply, first-lock-wins
        arbitrates) while the coordinator pivots the transaction to a
        replicated ABORT decision — double-queuing a lock entry would
        make the release roll-forward double-apply its staged intent.
        ``tests/test_txn.py`` pins never-double-queued directly."""
        buckets: Dict[int, List[int]] = {}
        for i, (key, _) in enumerate(items):
            buckets.setdefault(self.group_of(key), []).append(i)
        out: List[Optional[Tuple[int, int]]] = [None] * len(items)

        for g, idxs in buckets.items():
            def _submit_bucket(g=g, idxs=idxs):
                # leader checked once per bucket; entries then ride the
                # ordinary queue (ticks batch them across groups).
                # Placement lands in ``out`` item by item so a retry
                # after a mid-bucket refusal resumes, never re-submits.
                r = self.engine.leader_id[g]
                if r is None:
                    raise NotLeader(g)
                for i in idxs:
                    if out[i] is None:
                        out[i] = (g, self.engine.submit_to_leader(
                            g, items[i][1]
                        ))
            try:
                self._with_leader(g, _submit_bucket)
            except (NotLeader, Overloaded) as ex:
                ex.partial = out
                raise
        return out

    # --------------------------------------------------------------- reads
    def read_index(self, key: bytes) -> Tuple[int, int]:
        """Confirm leadership of the key's group (engine ``read_index``,
        §6.4) and return ``(group, read_index)``: a linearizable read of
        the key must serve from state applied to at least that index."""
        g = self.group_of(key)
        idx = self._with_leader(g, lambda: self.engine.read_index(g))
        return g, idx

    def read_index_many(
        self, keys: Sequence[bytes]
    ) -> List[Tuple[int, int]]:
        """Batched ReadIndex: ONE leadership confirmation round per
        distinct group covers every key routed to it (the multi-group
        analogue of the single engine's batched ``submit_read``).
        Returns ``(group, read_index)`` aligned with ``keys``."""
        groups = [self.group_of(k) for k in keys]
        per_group: Dict[int, int] = {}
        for g in set(groups):
            per_group[g] = self._with_leader(
                g, lambda g=g: self.engine.read_index(g)
            )
        return [(g, per_group[g]) for g in groups]

    # ------------------------------------------------ read scale-out
    def _read_breaker_gate(self, g: int) -> None:
        """Reads honor the same per-group breaker the write discipline
        trips: a group refusing repeatedly fast-fails its reads too
        instead of piling load onto a struggling leader."""
        if not self.drive:
            return
        breaker = self.breakers[g]
        if not breaker.allow(self.engine.clock.now):
            sp = self.spans.current if self.spans is not None else None
            if sp is not None:
                sp.refusal_reasons.append("circuit_open")
                sp.annotate("circuit_open", self.engine.clock.now,
                            group=g)
            raise CircuitOpen(
                breaker.retry_after(self.engine.clock.now), g
            )

    def read_any(
        self, key: bytes, replica: Optional[int] = None,
    ) -> Tuple[int, int, int, str]:
        """Linearizable read spread across the key's group replicas:
        the LEADER certifies the read index once — zero rounds under a
        valid lease, one quorum round otherwise — and the serve target
        round-robins over the group's live, caught-up rows, turning
        read throughput from O(leaders) into O(replicas)
        (docs/READS.md). Returns ``(group, replica, index, class)``;
        the value must be served from state applied to >= index.

        Staleness discipline: a row whose verified replication cursor
        lags the certified index beyond ``cfg.session_lag`` is SKIPPED;
        rows inside the bound but not yet at the index are skipped too
        (they cannot serve AT the index). When no row qualifies — the
        certifying leader always does, so this means leadership moved
        mid-call — the smallest-lag ``ReadLagging`` surfaces, typed,
        instead of a silent redial loop. ``replica`` pins the serve
        target: its ``ReadLagging`` propagates to the caller verbatim
        (the tested refusal path alongside NotLeader / CircuitOpen)."""
        g = self.group_of(key)
        eng = self.engine
        self._read_breaker_gate(g)
        # certify ONCE per call — the rounds it cost (0 under a valid
        # lease, 1 classic) is the whole read's replication cost, and
        # the span records exactly that
        idx, cert = self._with_leader(
            g, lambda: eng.certified_read_index(g)
        )
        rounds = 0 if cert == "lease" else 1
        lead = eng.leader_id[g]
        if replica is not None:
            # pinned serve target: its staleness refusal surfaces
            # verbatim (typed, never a silent redial loop)
            if replica == lead:
                cls = cert
            else:
                lag = (idx if not eng.alive[g, replica]
                       else eng.replica_lag(g, replica, idx))
                if lag > 0:
                    raise ReadLagging(
                        g, replica, lag,
                        retry_after_s=eng.cfg.heartbeat_period,
                    )
                cls = "follower"
            eng.note_read_class(g, cls)
            self._note_read_span(g, idx, cls, rounds)
            return g, replica, idx, cls
        n = eng.cfg.n_replicas
        max_lag = eng.cfg.session_lag
        start = self._rr.get(g, 0)
        self._rr[g] = (start + 1) % n
        best: Optional[ReadLagging] = None
        for k in range(n):
            r = (start + k) % n
            if not eng.alive[g, r]:
                continue
            lag = eng.replica_lag(g, r, idx)
            if lag == 0:
                cls = cert if r == lead else "follower"
                eng.note_read_class(g, cls)
                self._note_read_span(g, idx, cls, rounds)
                return g, r, idx, cls
            if lag <= max_lag and (best is None or lag < best.lag):
                best = ReadLagging(
                    g, r, lag, retry_after_s=eng.cfg.heartbeat_period
                )
        if best is not None:
            raise best
        # not even the certifying leader qualified: leadership moved
        # between certification and the serve scan — a NotLeader redial
        # situation, not a staleness one (ReadLagging's replica=None
        # form is reserved for session apply-stream lag)
        raise NotLeader(
            g, f"group {g}: leadership moved mid-read (no replica "
               f"qualifies for certified index {idx})"
        )

    def read_session(
        self, key: bytes, session: ReadSession,
    ) -> Tuple[int, int]:
        """Session-consistent read: serve the key's group from APPLIED
        state with NO leader contact at all, gated only on the group's
        apply cursor having passed the client's session floor (monotone
        reads / read-your-writes — docs/READS.md read-class matrix).
        Returns ``(group, index)`` and raises the session floor to the
        served index; ``ReadLagging`` (``replica=None``) when the apply
        stream lags the token."""
        g = self.group_of(key)
        eng = self.engine
        self._read_breaker_gate(g)
        idx = eng.session_read_index(g, session.floor.get(g, 0))
        session.observe(g, idx)
        eng.note_read_class(g, "session")
        self._note_read_span(g, idx, "session", rounds=0)
        return g, idx

    def note_write_observed(
        self, session: ReadSession, group: int,
    ) -> None:
        """Fold a durably-acknowledged write into the session token:
        the group's commit watermark at observation time bounds the
        write's index from above, so a floor at the watermark buys
        read-your-writes for it."""
        session.observe(group, int(self.engine.commit_watermark[group]))

    def _note_read_span(self, g: int, idx: int, cls: str,
                        rounds: int) -> None:
        """``rounds`` is the replication rounds THIS read actually
        paid end to end: 0 for lease/session serves and for follower
        serves certified by a valid lease, 1 when certification ran a
        classic ReadIndex round."""
        if self.spans is None or self.spans.current is None:
            return
        self.spans.note_read_served(
            cls, self.engine.clock.now, index=idx, rounds=rounds,
            group=g,
        )
