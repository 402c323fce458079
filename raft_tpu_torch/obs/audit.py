"""Online safety auditor (port of ``raft_tpu/obs/audit.py``): Raft
invariants checked DURING the run.

Every safety verdict before this module was post-hoc — the Wing–Gong
checker and the forensics bundles speak only after a seeded run ends. A
production deployment needs the cheap half of that assurance LIVE:
Ongaro's dissertation frames Leader Completeness / Log Matching /
State-Machine Safety as invariants over watermarks that are incremental
to check, and Jepsen-style monotonicity auditing catches the classic
stale-read classes at a fraction of a full linearizability search.

:class:`SafetyAuditor` attaches to ``RaftEngine`` / ``MultiEngine`` like
the other observability planes (``engine.auditor``, ``None`` = off;
every hook is a guarded host-side call — no rng, no device fetches, so
seeded runs replay byte-identically audited or not). Invariants:

==================  =====================================================
invariant           checked when
==================  =====================================================
leader_unique       an election win is recorded: at most one winner per
                    (group, term) — Election Safety, online
commit_monotone     every tick: the group's commit watermark never
                    regresses (also re-checked when the auditor is
                    re-attached across a crash-restore cycle)
term_monotone       every tick: no replica's term regresses (a ``wipe``
                    legally resets a row — the engine reports it)
log_matching        a committed index is re-fed (re-archive after
                    failover, restore overlap): its (term, payload CRC)
                    must equal what was recorded when it first committed
                    — committed-prefix immutability, the online face of
                    Log Matching / State-Machine Safety
read_uncommitted    a served read returns a value that was never applied
                    for its key — a dirty read, caught at serve time
read_monotone       a client's served read reflects an OLDER applied
                    state than one it already observed for that key —
                    the per-client monotone-read watermark inversion
==================  =====================================================

A violation raises no exception — a production auditor must never take
the service down on its own evidence. It appends a typed
:class:`AuditViolation`, records a ``kind="audit_violation"`` event into
the flight recorder, and bumps
``raft_audit_violations_total{invariant}`` when a registry is attached.

The committed-prefix CRC record doubles as the determinism witness: the
auditor's :meth:`commit_digest` reproduces the chaos runner's
``TortureReport.commit_digest`` formula from its own incremental
records, and the falsifiability tests pin the two equal — so the
auditor provably watched the same committed log the offline checker
judged. Entry records are bounded by the same floor-aware sweep as
``ckpt.CheckpointStore`` (``max_entries``); fused K-tick launches feed
whole spans lazily (O(1) per launch), matching ``put_span``.
"""

from __future__ import annotations

import bisect
import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

#: per-key applied-value history bound (values retained per key for the
#: read-audit lookups; below the floor a read audit degrades gracefully)
APPLIED_CAP = 4096


@dataclasses.dataclass(frozen=True)
class AuditViolation:
    """One typed online invariant violation."""

    invariant: str            # table in the module docstring
    t_virtual: float
    group: Optional[int]
    node: Optional[str]       # "Server2", "g1/Server0", "client:3", ...
    detail: str
    fields: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_jsonable(self) -> dict:
        d = dataclasses.asdict(self)
        if not d["fields"]:
            del d["fields"]
        return d


def _pcrc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


class _EntryLedger:
    """Bounded per-group record of the committed prefix: idx ->
    (term, payload CRC), plus lazily-resolved span blocks (the fused
    launch feed). Mirrors ``CheckpointStore``'s floor-aware retention
    so the auditor's digest coverage matches the archive's."""

    def __init__(self, max_entries: Optional[int]) -> None:
        self.max_entries = max_entries
        self.slots: Dict[int, Tuple[Optional[int], int]] = {}
        self.spans: Dict[int, tuple] = {}    # lo -> (hi, items, term, pick)
        self.span_los: List[int] = []
        self.last = 0
        self.first = 1

    def put(self, idx: int, term: Optional[int], crc: int) -> None:
        self.slots[idx] = (term, crc)
        self.last = max(self.last, idx)
        self._sweep()

    def put_span(self, lo: int, items, term: int, pick) -> None:
        if not len(items):
            return
        if lo not in self.spans:
            bisect.insort(self.span_los, lo)
        self.spans[lo] = (lo + len(items) - 1, items, term, pick)
        self.last = max(self.last, lo + len(items) - 1)
        self._sweep()

    def _sweep(self) -> None:
        if self.max_entries is None:
            return
        floor = self.last - self.max_entries
        while self.first <= floor:
            self.slots.pop(self.first, None)
            self.first += 1
        while self.span_los and \
                self.spans[self.span_los[0]][0] < self.first:
            del self.spans[self.span_los.pop(0)]

    def get(self, idx: int) -> Optional[Tuple[Optional[int], int]]:
        """(term, payload CRC) or None; span entries resolve lazily."""
        if idx < self.first:
            return None
        got = self.slots.get(idx)
        if got is not None:
            return got
        if not self.span_los:
            return None
        i = bisect.bisect_right(self.span_los, idx) - 1
        if i < 0:
            return None
        lo = self.span_los[i]
        hi, items, term, pick = self.spans[lo]
        if idx > hi:
            return None
        rec = items[idx - lo]
        return (term, _pcrc(rec if pick is None else rec[pick]))

    def covered_lo(self, hi: int) -> int:
        if self.get(hi) is None:
            return hi + 1
        lo = hi
        while lo - 1 >= 1 and self.get(lo - 1) is not None:
            lo -= 1
        return lo


class SafetyAuditor:
    """The online invariant checker (module docstring). One instance
    spans crash-restore cycles like the flight recorder: the chaos
    runner re-attaches it to each restored engine, and the attach hook
    re-verifies the restored state against the records."""

    VIOLATION_CAP = 1024
    #: default entry-record retention when no engine archive is adopted
    #: (``on_attach`` aligns the cap to the engine's CheckpointStore so
    #: digest coverage matches the archive's); bounded BY DEFAULT — a
    #: long production run must not grow auditor memory without bound.
    DEFAULT_MAX_ENTRIES = 1 << 16

    def __init__(self, recorder=None, registry=None,
                 max_entries: Optional[int] = DEFAULT_MAX_ENTRIES) -> None:
        self.recorder = recorder
        self.registry = registry
        self.max_entries = max_entries
        self.violations: List[AuditViolation] = []
        self.violations_dropped = 0
        self.by_invariant: Dict[str, int] = {}
        self._leaders: Dict[Tuple[Optional[int], int], str] = {}
        self._commit_hwm: Dict[Optional[int], int] = {}
        self._term_hwm: Dict[Tuple[Optional[int], str], int] = {}
        self._ledgers: Dict[Optional[int], _EntryLedger] = {}
        self._applied: Dict[Tuple[Optional[int], bytes], dict] = {}
        #   (group, key) -> {value (bytes|None) -> apply index}; bounded
        #   per key by APPLIED_CAP with an eviction floor
        self._applied_floor: Dict[Tuple[Optional[int], bytes], int] = {}
        self._read_hwm: Dict[Tuple[int, Optional[int], bytes], int] = {}
        #   (client, group, key) -> highest applied index observed
        self.ticks_audited = 0

    # --------------------------------------------------------- emission
    def _violate(self, invariant: str, t: float, detail: str,
                 group: Optional[int] = None, node: Optional[str] = None,
                 **fields) -> None:
        self.by_invariant[invariant] = (
            self.by_invariant.get(invariant, 0) + 1
        )
        v = AuditViolation(
            invariant=invariant, t_virtual=t, group=group, node=node,
            detail=detail, fields=fields,
        )
        if len(self.violations) >= self.VIOLATION_CAP:
            self.violations_dropped += 1
        else:
            self.violations.append(v)
        if self.recorder is not None:
            self.recorder.record(
                node=node or "auditor", term=0, kind="audit_violation",
                t_virtual=t, group=group, invariant=invariant,
                detail=detail, **fields,
            )
        if self.registry is not None:
            self.registry.counter(
                "raft_audit_violations_total",
                "online safety invariant violations", ("invariant",),
            ).inc(invariant=invariant)

    @property
    def total_violations(self) -> int:
        return len(self.violations) + self.violations_dropped

    # ----------------------------------------------------- engine hooks
    def note_elect(self, node: str, term: int, t: float,
                   group: Optional[int] = None) -> None:
        """An election win was recorded; Election Safety demands at most
        one winner per (group, term)."""
        key = (group, term)
        prev = self._leaders.get(key)
        if prev is not None and prev != node:
            self._violate(
                "leader_unique", t,
                f"term {term} won by {node} but already won by {prev}",
                group=group, node=node, term=term, previous=prev,
            )
        self._leaders[key] = node

    def note_wipe(self, node: str, group: Optional[int] = None) -> None:
        """A row's durable identity was destroyed (``engine.wipe``): its
        term legally resets to 0 — the monotonicity watermark resets
        with it."""
        self._term_hwm.pop((group, node), None)

    def note_commit(self, watermark: int, t: float,
                    group: Optional[int] = None) -> None:
        """A commit advance was booked; the watermark must be monotone
        per group."""
        hwm = self._commit_hwm.get(group, 0)
        if watermark < hwm:
            self._violate(
                "commit_monotone", t,
                f"commit watermark advanced to {watermark} below the "
                f"recorded high-water {hwm}",
                group=group, watermark=watermark, high_water=hwm,
            )
        else:
            self._commit_hwm[group] = watermark

    def note_entry(self, idx: int, term: Optional[int], payload: bytes,
                   t: float, group: Optional[int] = None) -> None:
        """A committed entry's bytes were archived. First sighting is
        recorded; a RE-feed (failover re-archive, restore overlap) must
        match the record byte-for-byte — committed-prefix immutability."""
        led = self._ledgers.get(group)
        if led is None:
            led = self._ledgers[group] = _EntryLedger(self.max_entries)
        crc = _pcrc(payload)
        prev = led.get(idx)
        if prev is not None and (
            prev[1] != crc
            or (term is not None and prev[0] is not None
                and prev[0] != term)
        ):
            self._violate(
                "log_matching", t,
                f"committed index {idx} re-fed with term={term} "
                f"crc={crc:08x}, previously term={prev[0]} "
                f"crc={prev[1]:08x}",
                group=group, index=idx,
            )
            return                       # keep the first sighting
        led.put(idx, term, crc)

    def note_entries(self, entries, t: float,
                     group: Optional[int] = None) -> None:
        """Bulk archive feed for the tick path: ``entries`` is a list of
        ``(idx, payload, term)`` in ascending index order. Fresh
        contiguous same-term runs above the ledger tail become ONE lazy
        span block (O(1) amortized — the <= 5% overhead contract at the
        headline batch size); anything overlapping the record goes
        through the per-entry immutability compare."""
        if not entries:
            return
        led = self._ledgers.get(group)
        if led is None:
            led = self._ledgers[group] = _EntryLedger(self.max_entries)
        i, n = 0, len(entries)
        while i < n:
            idx0, _, term0 = entries[i]
            if idx0 <= led.last:
                self.note_entry(idx0, term0, entries[i][1], t,
                                group=group)
                i += 1
                continue
            j = i + 1
            while (j < n and entries[j][2] == term0
                   and entries[j][0] == entries[j - 1][0] + 1):
                j += 1
            led.put_span(idx0, [p for _, p, _ in entries[i:j]], term0,
                         None)
            i = j

    def note_entry_span(self, lo: int, items, term: int, t: float,
                        pick=None, group: Optional[int] = None) -> None:
        """Whole-range feed for the fused K-tick booking path — O(1) per
        launch (entries resolve lazily), mirroring
        ``CheckpointStore.put_span``. Fresh indices only by contract
        (the fused drain commits fresh tail entries), so no per-entry
        immutability compare happens here."""
        led = self._ledgers.get(group)
        if led is None:
            led = self._ledgers[group] = _EntryLedger(self.max_entries)
        led.put_span(lo, items, term, pick)

    def note_state(self, terms, watermark: int, t: float,
                   group: Optional[int] = None,
                   node_prefix: str = "Server") -> None:
        """Per-tick scan of host mirrors the engine already maintains:
        per-replica term monotonicity plus the watermark-regression
        check (catches a rewind that ``note_commit`` — which only sees
        advances — cannot)."""
        self.ticks_audited += 1
        for r, term in enumerate(terms):
            term = int(term)
            key = (group, f"{node_prefix}{r}")
            hwm = self._term_hwm.get(key, 0)
            if term < hwm:
                self._violate(
                    "term_monotone", t,
                    f"{node_prefix}{r} term regressed {hwm} -> {term} "
                    "without a wipe",
                    group=group, node=f"{node_prefix}{r}",
                    high_water=hwm, term=term,
                )
                self._term_hwm[key] = term     # re-anchor; report once
            elif term > hwm:
                self._term_hwm[key] = term
        hwm = self._commit_hwm.get(group, 0)
        if watermark < hwm:
            self._violate(
                "commit_monotone", t,
                f"commit watermark regressed {hwm} -> {watermark}",
                group=group, watermark=int(watermark), high_water=hwm,
            )
            self._commit_hwm[group] = int(watermark)   # report once
        else:
            self._commit_hwm[group] = int(watermark)

    def on_attach(self, engine) -> None:
        """Re-attachment across a crash-restore cycle: the restored
        engine's committed state must extend — never contradict — the
        recorded prefix. Overlapping archived entries are compared
        (a rollback that resurrected different committed bytes trips
        ``log_matching``); a restored watermark below the record trips
        ``commit_monotone``."""
        store = getattr(engine, "store", None)
        wm = getattr(engine, "commit_watermark", None)
        if store is None or wm is None or isinstance(wm, (list,)):
            return
        try:
            wm = int(wm)
        except TypeError:          # MultiEngine vector: per-group checks
            return                 # ride the per-tick note_state instead
        if getattr(store, "max_entries", None):
            # adopt the archive's retention horizon so the auditor's
            # digest coverage (covered_lo) tracks the store's exactly —
            # the cross-check against TortureReport.commit_digest
            # depends on the two sweeping identically
            self.max_entries = store.max_entries
            led0 = self._ledgers.get(None)
            if led0 is not None:
                led0.max_entries = store.max_entries
                led0._sweep()
        t = float(engine.clock.now)
        hwm = self._commit_hwm.get(None, 0)
        if wm < hwm:
            self._violate(
                "commit_monotone", t,
                f"restored commit watermark {wm} below the recorded "
                f"high-water {hwm}",
                watermark=wm, high_water=hwm,
            )
        led = self._ledgers.get(None)
        if led is not None:
            lo = max(led.first, store.first)
            for idx in range(lo, min(wm, led.last) + 1):
                ent = store.get(idx)
                if ent is None:
                    continue
                self.note_entry(idx, ent[1], ent[0], t)

    # ------------------------------------------------- workload hooks
    def note_apply(self, key: bytes, index: int, value: Optional[bytes],
                   group: Optional[int] = None) -> None:
        """A committed entry was applied to the key-value state machine:
        record value -> apply index for the read audits (``value=None``
        records a delete). Bounded per key (APPLIED_CAP)."""
        akey = (group, key)
        hist = self._applied.get(akey)
        if hist is None:
            hist = self._applied[akey] = {}
        hist[value] = index
        if len(hist) > APPLIED_CAP:
            old_v = next(iter(hist))
            self._applied_floor[akey] = max(
                self._applied_floor.get(akey, 0), hist.pop(old_v)
            )

    def observe_read(self, client: int, key: bytes,
                     value: Optional[bytes], t: float,
                     group: Optional[int] = None) -> None:
        """A read was SERVED to ``client``: audit it online. The served
        value's applied index is its watermark; ``None`` with no
        recorded delete is the key's initial state (watermark 0)."""
        akey = (group, key)
        hist = self._applied.get(akey, {})
        w = hist.get(value)
        if w is None:
            floor = self._applied_floor.get(akey, 0)
            if floor > 0:
                # evicted history (None included: an old delete record
                # may have been swept): cannot distinguish "never
                # applied" from "applied long ago" — treat as the floor
                # and let the monotone check below decide
                w = floor
            elif value is None:
                w = 0                     # initial state
            else:
                self._violate(
                    "read_uncommitted", t,
                    f"client {client} read {value!r} for key {key!r}: "
                    "value was never applied (dirty read of "
                    "uncommitted state)",
                    group=group, node=f"client:{client}",
                    client=client,
                )
                return
        rkey = (client, group, key)
        hwm = self._read_hwm.get(rkey, 0)
        if w < hwm:
            self._violate(
                "read_monotone", t,
                f"client {client} read key {key!r} at applied index {w} "
                f"after already observing index {hwm} (stale-read "
                "inversion)",
                group=group, node=f"client:{client}", client=client,
                watermark=w, high_water=hwm,
            )
        else:
            self._read_hwm[rkey] = w

    # ------------------------------------------------------- queries
    def commit_digest(self, group: Optional[int] = None) -> str:
        """The committed-prefix CRC, reproduced from the auditor's own
        incremental records with the chaos runner's exact formula
        (``_SingleTorture.commit_digest``) — the cross-check that pins
        the auditor to the same log the offline checker judged. The
        cross-check contract is SINGLE-ENGINE (``group=None``; the
        attach hook aligns retention to the engine's archive); per-group
        digests are auditor-internal fingerprints — the multi runner's
        report digest uses a term-free formula they deliberately do not
        chase."""
        wm = self._commit_hwm.get(group, 0)
        crc = zlib.crc32(f"wm:{wm}".encode())
        led = self._ledgers.get(group)
        if wm and led is not None:
            for idx in range(led.covered_lo(wm), wm + 1):
                ent = led.get(idx)
                if ent is not None:
                    crc = zlib.crc32(
                        f"{idx}:{ent[0]}:{ent[1]:08x}".encode(), crc
                    )
        return f"{crc:08x}"

    def summary(self) -> dict:
        """Compact state for ``/status`` snapshots (cheap: counters plus
        a copy of the most recent violations)."""
        return {
            "violations_total": self.total_violations,
            "by_invariant": dict(self.by_invariant),
            "ticks_audited": self.ticks_audited,
            "recent": [v.to_jsonable() for v in self.violations[-5:]],
        }

    def to_jsonable(self) -> dict:
        """Full dump for forensics bundles."""
        return {
            "violations_total": self.total_violations,
            "violations_dropped": self.violations_dropped,
            "by_invariant": dict(self.by_invariant),
            "ticks_audited": self.ticks_audited,
            "commit_hwm": {
                str(g): wm for g, wm in sorted(
                    self._commit_hwm.items(), key=lambda kv: str(kv[0])
                )
            },
            "violations": [v.to_jsonable() for v in self.violations],
        }
