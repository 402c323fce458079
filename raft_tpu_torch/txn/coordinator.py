"""The coordinator plane: pollable 2PC over the group engines (port of
``raft_tpu/txn/coordinator.py``).

One transaction (docs/TXN.md):

1. **BEGIN** — allocate a txn id, refuse immediately (typed,
   provably-no-effect :class:`txn.ops.LockConflict`) if any target key
   is under a LIVE foreign lock. An EXPIRED foreign lock kicks the
   TTL/status-check resolver instead of wedging the writer.
2. **PREWRITE** — LOCK entries fan out through
   ``Router.submit_many``'s group bucketing (one leadership check per
   group, never-double-queued on retry — the ``.partial`` contract
   pinned in tests/test_txn.py). A bucket refused mid-batch dooms the
   transaction: the placed prewrites flow through the normal
   decide-abort-release path so no lock leaks.
3. **VALIDATE** — once every prewrite is durable AND applied, the
   coordinator checks it actually HOLDS each lock (a concurrent
   prewrite that applied first wins the key) and that every ``expect``
   still matches the committed value (optimistic validation — the key
   is locked, so the value is stable until release).
4. **DECIDE** — one ``OP_DECIDE`` entry replicated in the designated
   decision group. The APPLIED decision is authoritative: if a TTL
   resolver raced us and aborted first, first-decision-wins means we
   converge to ITS verdict — coordinator crash-restore replays to the
   same verdict because the decision group's log is the serialization
   point.
5. **RELEASE** — COMMIT/ABORT entries fan out to every participant
   group; staged intents roll forward or vanish atomically per group.

The coordinator never blocks: ``poll`` advances one handle a step at a
time (the ingest server drives it from the pump's sweep phase; the
blocking ``run`` wrapper drives the engine itself). Refusals on the
decision/release submits back off under the ``admission.retry``
discipline (full-jitter ``Backoff`` floored by the server hint, a
``RetryBudget`` shaping sustained retry traffic).

Observability: ``raft_txn_total{outcome}`` (committed / aborted /
lock_conflict), ``raft_txn_locks_total`` (store apply), a ``txn``
StatusBoard section, commit latency into the SLO digest
(``txn_commit``), and span annotations (``txn_begin`` /
``txn_prewrite`` / ``txn_decision`` / ``txn_done``) on the ambient op
span so ``obs --explain`` renders a cross-group transaction as one
causal timeline.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from raft_tpu_torch.admission.gate import Overloaded
from raft_tpu_torch.admission.retry import Backoff, RetryBudget
from raft_tpu_torch.multi.engine import NotLeader, ReadLagging
from raft_tpu_torch.txn import ops as T

_UNSET = object()


class TxnItem:
    """One key's part in a transaction: an optional staged write
    (``value`` / ``delete``) and an optional validation ``expect``
    (the committed value the coordinator must still observe under the
    lock — ``None`` means "expect absent")."""

    __slots__ = ("key", "value", "delete", "expect", "has_expect")

    def __init__(self, key: bytes, value: Optional[bytes] = None,
                 delete: bool = False, expect=_UNSET):
        self.key = key
        self.value = value
        self.delete = delete
        self.has_expect = expect is not _UNSET
        self.expect = None if expect is _UNSET else expect


class TxnHandle:
    """One in-flight transaction's coordinator state. Advance with
    ``TxnCoordinator.poll``; terminal when ``status`` is set
    (``"committed"`` / ``"aborted"``)."""

    __slots__ = ("txn_id", "items", "groups", "mask", "prewrites",
                 "doomed", "proposed", "final", "decision_seq",
                 "decision_wm", "released", "state", "status", "reason",
                 "t_begin", "not_before", "attempts", "resolve")

    def __init__(self, txn_id: int, items: List[TxnItem],
                 t_begin: float):
        self.txn_id = txn_id
        self.items = items
        self.groups: List[int] = []
        self.mask = 0
        self.prewrites: List[list] = []    # [group, seq, wm|None]
        self.doomed: Optional[str] = None
        self.proposed: Optional[bool] = None
        self.final: Optional[bool] = None
        self.decision_seq: Optional[int] = None
        self.decision_wm: Optional[int] = None
        self.released: Dict[int, Optional[list]] = {}
        self.state = "prewrite"
        self.status: Optional[str] = None
        self.reason = ""
        self.t_begin = t_begin
        self.not_before = 0.0
        self.attempts = 0
        self.resolve = False

    @property
    def done(self) -> bool:
        return self.status is not None


class TxnCoordinator:
    """2PC coordinator over a :class:`txn.store.TxnShardedKV` (module
    docstring). ``coord_id`` namespaces txn ids so independent
    coordinators never collide; ``ttl_s`` bounds how long a dead
    coordinator's locks block writers before the status-check path
    aborts them. ``broken="txn_partial_commit"`` disables lock
    validation — the coordinator that commits after a failed prewrite,
    which the serializability checker must catch."""

    def __init__(self, store, decision_group: int = 0,
                 ttl_s: Optional[float] = None, coord_id: int = 0,
                 broken: Optional[str] = None,
                 lease_reads: bool = False):
        self.store = store
        self.router = store.router
        self.engine = store.engine
        self.spans = self.router.spans
        if self.engine.G > 32:
            raise ValueError("txn group masks support at most 32 groups")
        self.decision_group = decision_group
        hb = self.engine.cfg.heartbeat_period
        self.ttl_s = ttl_s if ttl_s is not None else 60.0 * hb
        self.coord_id = coord_id
        self.broken = broken
        self.backoff = Backoff(base_s=hb, max_s=20.0 * hb,
                               rng=random.Random(coord_id + 1))
        self.budget = RetryBudget()
        self._next = 0
        self._resolves: List[TxnHandle] = []
        self.committed = 0
        self.aborted = 0
        self.lock_conflicts = 0
        self.ttl_resolved = 0
        self.lease_reads = lease_reads
        self.read_certs: Dict[str, int] = {"lease": 0, "read_index": 0}

    # --------------------------------------------------- validated reads
    def validated_read(self, key: bytes) -> Optional[bytes]:
        """Basis read for a transaction's ``expects``: certify the read
        index on the key's group through the participant leader's
        certified path — ZERO quorum rounds when that leader holds a
        valid lease (the read-plane fast path, ``cfg.read_lease``), one
        classic ReadIndex quorum round otherwise — then serve from
        applied state at or past the certified index. The expect a
        transaction later validates under its lock is thereby anchored
        to a LINEARIZABLE observation, not a maybe-stale applied map.

        With ``lease_reads=False`` (the default) this degrades to the
        plain applied read so callers need no branching; armed, it
        raises ``NotLeader`` / ``ReadLagging`` exactly like the router
        reads (typed, retryable) and counts each certification class in
        ``read_certs``."""
        if not self.lease_reads:
            return self.store.get(key)
        g = self.router.group_of(key)
        idx, cert = self.engine.certified_read_index(g)
        self.read_certs[cert] = self.read_certs.get(cert, 0) + 1
        self.engine.note_read_class(g, cert)
        applied = self.store.last_applied[g]
        if applied < idx:
            raise ReadLagging(
                g, None, idx - applied,
                retry_after_s=self.engine.cfg.heartbeat_period,
            )
        return self.store.get(key)

    # ----------------------------------------------------------- allocate
    def allocate(self) -> int:
        """A fresh txn id: ``coord_id`` in the high bits so concurrent
        coordinators allocate disjoint ids without coordination."""
        self._next += 1
        return ((self.coord_id & 0xFFF) << 20) | (self._next & 0xFFFFF)

    # -------------------------------------------------------------- begin
    def begin(self, items: List[TxnItem],
              txn_id: Optional[int] = None) -> TxnHandle:
        """Conflict-check + prewrite fan-out. Raises
        :class:`txn.ops.LockConflict` (typed, nothing queued) when a
        live foreign lock covers a key, and plain
        ``NotLeader``/``Overloaded`` when NO prewrite could be placed.
        A PARTIALLY placed prewrite returns a doomed handle that
        aborts through the normal decide/release path."""
        now = self.engine.clock.now
        if txn_id is None:
            txn_id = self.allocate()
        for it in items:
            g, lk = self.store.lock_of(it.key)
            if lk is None or lk.txn_id == txn_id:
                continue
            if lk.expired(now):
                # a dead coordinator's lock: kick the status-check
                # resolver, refuse THIS attempt with a short hint
                self.resolve_txn(lk.txn_id)
                self._count("lock_conflict")
                raise T.LockConflict(
                    it.key, lk.txn_id,
                    2.0 * self.engine.cfg.heartbeat_period, group=g,
                )
            self._count("lock_conflict")
            raise T.LockConflict(
                it.key, lk.txn_id,
                max(lk.deadline - now,
                    self.engine.cfg.heartbeat_period),
                group=g,
            )
        h = TxnHandle(txn_id, items, now)
        eb = self.engine.cfg.entry_bytes
        deadline = now + self.ttl_s
        wire = [
            (it.key, T.encode_lock(eb, txn_id, it.key, it.value,
                                   deadline, delete=it.delete))
            for it in items
        ]
        self._annotate("txn_begin", txn=txn_id, keys=len(items))
        try:
            placed = self.router.submit_many(wire)
        except (NotLeader, Overloaded) as ex:
            partial = [p for p in (getattr(ex, "partial", None) or [])
                       if p is not None]
            if not partial:
                # provably no effect: surface the typed refusal whole
                raise
            # some prewrites landed: the txn is doomed but its locks
            # must still resolve — run it through decide(abort)/release
            h.prewrites = [[g, seq, None] for g, seq in partial]
            h.doomed = "prewrite_refused"
        else:
            h.prewrites = [[g, seq, None] for g, seq in placed]
        h.groups = sorted({g for g, _, _ in h.prewrites})
        h.mask = 0
        for g in h.groups:
            h.mask |= 1 << g
        self._annotate("txn_prewrite", txn=txn_id,
                       groups=len(h.groups))
        return h

    # ------------------------------------------------------------ resolve
    def resolve_txn(self, txn_id: int,
                    mask: Optional[int] = None) -> TxnHandle:
        """The status-check path: roll a (possibly dead) coordinator's
        txn forward or back. A recorded decision replays to the SAME
        verdict; an undecided txn is aborted — first-decision-wins in
        the store makes the race against a live coordinator safe."""
        now = self.engine.clock.now
        h = TxnHandle(txn_id, [], now)
        h.resolve = True
        d = self.store.decision(txn_id)
        if mask is None:
            mask = d[1] if d is not None else self._observed_mask(txn_id)
        h.mask = mask
        h.groups = [g for g in range(self.engine.G) if mask & (1 << g)]
        if d is not None:
            h.final = d[0]
            h.state = "release"
            h.released = {g: None for g in h.groups}
        else:
            h.proposed = False
            h.reason = "ttl_expired"
            h.state = "decide"
            self.ttl_resolved += 1
        self._resolves.append(h)
        return h

    def _observed_mask(self, txn_id: int) -> int:
        mask = 0
        for g in range(self.engine.G):
            if any(lk.txn_id == txn_id
                   for lk in self.store.locks[g].values()):
                mask |= 1 << g
        return mask

    # --------------------------------------------------------------- poll
    def poll(self, h: TxnHandle, now: Optional[float] = None) -> bool:
        """Advance one handle one step; True when terminal. Never
        drives the engine — the caller owns the tick loop."""
        if h.done:
            return True
        if now is None:
            now = self.engine.clock.now
        if now < h.not_before:
            return False
        if h.state == "prewrite":
            self._poll_prewrite(h)
        if h.state == "decide":
            self._poll_decide(h, now)
        if h.state == "release":
            self._poll_release(h, now)
        return h.done

    def adopt(self, h: TxnHandle) -> None:
        """Hand a handle to the coordinator's own polling (``poll_all``)
        — how the ingest server orphans a timed-out or disconnected
        transaction WITHOUT wedging its locks until the TTL."""
        if not h.done:
            self._resolves.append(h)

    def poll_all(self, now: Optional[float] = None) -> None:
        """Advance every internal resolver handle (the server pump and
        the blocking ``run`` call this each sweep)."""
        if not self._resolves:
            return
        if now is None:
            now = self.engine.clock.now
        self._resolves = [h for h in self._resolves
                          if not self.poll(h, now)]

    def _poll_prewrite(self, h: TxnHandle) -> None:
        e = self.engine
        for p in h.prewrites:
            if p[2] is None and e.is_durable(p[0], p[1]):
                p[2] = int(e.commit_watermark[p[0]])
        if not all(p[2] is not None
                   and int(e.applied_index[p[0]]) >= p[2]
                   for p in h.prewrites):
            return
        # every prewrite applied: validate
        if h.doomed is not None and self.broken != "txn_partial_commit":
            h.proposed, h.reason = False, h.doomed
        else:
            h.proposed, h.reason = True, ""
            for it in h.items:
                g = self.router.group_of(it.key)
                if (not self.store.lock_owned(h.txn_id, it.key)
                        and self.broken != "txn_partial_commit"):
                    # a concurrent prewrite won the key: abort
                    h.proposed, h.reason = False, "lock_lost"
                    break
                if (it.has_expect
                        and self.store._data[g].get(it.key)
                        != it.expect):
                    h.proposed, h.reason = False, "expect_failed"
                    break
        h.state = "decide"

    def _poll_decide(self, h: TxnHandle, now: float) -> None:
        e = self.engine
        dg = self.decision_group
        if h.decision_seq is None:
            payload = T.encode_decision(
                e.cfg.entry_bytes, h.txn_id, bool(h.proposed), h.mask
            )
            try:
                h.decision_seq = e.submit_to_leader(dg, payload)
            except (NotLeader, Overloaded) as ex:
                self._backoff(h, now, ex)
                return
            return
        if h.decision_wm is None:
            if e.is_durable(dg, h.decision_seq):
                h.decision_wm = int(e.commit_watermark[dg])
            return
        if int(e.applied_index[dg]) < h.decision_wm:
            return
        d = self.store.decision(h.txn_id)
        if d is None:
            return                       # decision group apply lag
        # the APPLIED decision is authoritative (a racing resolver may
        # have decided first — first-wins replays every restart to the
        # same verdict)
        h.final = d[0]
        h.state = "release"
        h.released = {g: None for g in h.groups}
        self._annotate("txn_decision", txn=h.txn_id,
                       commit=bool(h.final))

    def _poll_release(self, h: TxnHandle, now: float) -> None:
        e = self.engine
        payload = None
        for g in h.groups:
            entry = h.released[g]
            if entry is None:
                if payload is None:
                    payload = T.encode_release(
                        e.cfg.entry_bytes, bool(h.final), h.txn_id
                    )
                try:
                    h.released[g] = [e.submit_to_leader(g, payload),
                                     None]
                except (NotLeader, Overloaded) as ex:
                    self._backoff(h, now, ex)
                    continue
            entry = h.released[g]
            if entry is not None and entry[1] is None \
                    and e.is_durable(g, entry[0]):
                entry[1] = int(e.commit_watermark[g])
        if not all(v is not None and v[1] is not None
                   and int(e.applied_index[g]) >= v[1]
                   for g, v in h.released.items()):
            return
        h.status = "committed" if h.final else "aborted"
        self.budget.on_success()
        if not h.resolve:
            self._count(h.status)
            if h.final and self.engine.slo is not None:
                self.engine.slo.observe(
                    "txn_commit", now - h.t_begin, now,
                    group=self.decision_group,
                )
        self._annotate("txn_done", txn=h.txn_id, status=h.status)
        self.publish_status()

    # ------------------------------------------------------------ helpers
    def _backoff(self, h: TxnHandle, now: float, ex) -> None:
        h.attempts += 1
        hint = getattr(ex, "retry_after_s", None)
        if not self.budget.try_spend():
            h.not_before = now + self.backoff.max_s
            return
        h.not_before = now + self.backoff.delay(h.attempts - 1, hint)

    def run(self, items: List[TxnItem],
            limit_s: float = 600.0) -> TxnHandle:
        """Blocking convenience: begin + drive the engine until the
        transaction terminates (tests and the in-process drill; the
        wire path polls from the server pump instead)."""
        h = self.begin(items)
        e = self.engine
        deadline = e.clock.now + limit_s
        while not self.poll(h):
            if e.clock.now > deadline:
                raise RuntimeError(
                    f"txn {h.txn_id} did not terminate within "
                    f"{limit_s}s (state {h.state})"
                )
            e.run_for(e.cfg.heartbeat_period)
            self.poll_all()
        return h

    def _count(self, outcome: str) -> None:
        if outcome == "committed":
            self.committed += 1
        elif outcome == "aborted":
            self.aborted += 1
        else:
            self.lock_conflicts += 1
        self.engine._metric_inc(
            self.decision_group, "raft_txn_total",
            "transactions by outcome", outcome=outcome,
        )

    def _annotate(self, name: str, **fields) -> None:
        sp = self.spans.current if self.spans is not None else None
        if sp is not None and not sp.terminal:
            sp.annotate(name, self.engine.clock.now, **fields)

    def status_snapshot(self) -> dict:
        out = {
            "committed": self.committed,
            "aborted": self.aborted,
            "lock_conflicts": self.lock_conflicts,
            "ttl_resolved": self.ttl_resolved,
            "open_resolves": len(self._resolves),
            "decision_group": self.decision_group,
            "ttl_s": self.ttl_s,
        }
        if self.lease_reads:
            out["read_certs"] = dict(self.read_certs)
        out.update(self.store.lock_stats())
        return out

    def publish_status(self) -> None:
        board = getattr(self.engine, "status_board", None)
        if board is not None:
            board.publish(self.status_snapshot(), section="txn")
