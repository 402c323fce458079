"""The flight recorder (port of ``raft_tpu/obs/events.py``): a typed,
bounded ring of structured events.

Until this module, the whole stack was observed through ONE channel: the
reference's nodelog strings (main.go:399-401), asserted on by substring
grep (``TraceRecorder.matching("state changed to leader")``). The flight
recorder keeps that string as a *rendering* — ``Event.nodelog()`` is
byte-identical to the legacy line, because the line format is the
differential-test join key with the golden model and must not drift —
but the record itself is typed: ``Event(seq, t_virtual, node, group,
term, kind, fields)``, queryable without string surgery.

Ring semantics: the recorder holds the most recent ``capacity`` events.
``seq`` keeps rising monotonically past overflow and ``dropped`` counts
evictions, so a consumer can always tell "quiet run" from "ring wrapped
and the head is gone" (the forensics bundle records both).

Determinism contract: recording is pure host-side bookkeeping — no rng,
no device traffic — so any seeded run replays byte-identically with the
recorder attached or absent. The *emitters* honor the other half: with
no recorder and no trace callback attached, ``RaftEngine.nodelog`` skips
its device fetch entirely (the disabled path costs no device syncs).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

#: Ordered (substring-prefix, kind) catalog for classifying legacy
#: nodelog messages into event kinds. First match wins; call sites may
#: always pass an explicit ``kind`` instead. Kept here — not in the
#: engine — so the golden model and multi engine classify identically.
_KIND_CATALOG = (
    ("state changed to leader", "elect"),
    ("state changed to candidate", "candidate"),
    ("step down to follower", "step_down"),
    ("commit index changed to", "commit"),
    ("configuration committed at", "config_commit"),
    ("promoted from learner to voter", "promote"),
    ("added to configuration as learner", "learner_add"),
    ("added to configuration", "config_add"),
    ("removed from configuration", "config_remove"),
    ("learner removed from configuration", "learner_remove"),
    ("admission shedding ON", "shed_start"),
    ("admission shedding OFF", "shed_stop"),
    ("killed", "kill"),
    ("recover refused", "recover_refused"),
    ("recovered", "recover"),
    ("wiped", "wipe"),
    ("partition installed", "partition"),
    ("partition healed", "heal"),
    ("snapshot installed to", "snapshot_install"),
    ("healed by reconstruction to", "repair"),
    ("suffix re-served to", "repair"),
    ("injected candidacy suppressed by pre-vote", "prevote_suppress"),
    ("pre-vote failed", "prevote_fail"),
    ("vote log replayed", "votelog_replay"),
    ("restored from checkpoint", "restore"),
    ("apply replay is partial", "apply_partial"),
)


def kind_of(msg: str) -> str:
    """Classify a legacy nodelog message into an event kind (``"log"``
    when unrecognized — the event is still recorded and renderable)."""
    for prefix, kind in _KIND_CATALOG:
        if msg.startswith(prefix):
            return kind
    return "log"


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured observability event.

    Events that originate at a legacy nodelog call site carry ``msg``
    plus the full nodelog header fields (``commit_index``,
    ``last_index``, ``state``) and render byte-identically via
    ``nodelog()``. Events from the previously-silent transitions
    (repair floor raises, breaker state changes, ...) carry ``msg=None``
    and structured ``fields`` only — they never enter the legacy trace
    stream, which must not drift."""

    seq: int                     # recorder-monotone, survives ring overflow
    t_virtual: float             # engine virtual-clock seconds
    node: str                    # "Server3", "g2/Server0", "g1/client", ...
    group: Optional[int]         # multi-Raft group scope; None = single
    term: int
    kind: str
    state: str = ""              # role at emission ("leader", ...)
    commit_index: Optional[int] = None
    last_index: Optional[int] = None
    msg: Optional[str] = None    # legacy nodelog message, when one exists
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def nodelog(self) -> str:
        """The legacy rendering — byte-identical to the pre-recorder
        ``trace`` callback line for events emitted from nodelog sites."""
        if self.msg is None:
            raise ValueError(
                f"event kind {self.kind!r} has no nodelog rendering "
                "(it never entered the legacy trace stream)"
            )
        return (
            f"[{self.node}:{self.term}:{self.commit_index}:"
            f"{self.last_index}][{self.state}]{self.msg}"
        )

    def to_jsonable(self) -> dict:
        d = dataclasses.asdict(self)
        if not d["fields"]:
            del d["fields"]
        return d

    @classmethod
    def from_jsonable(cls, d: dict) -> "Event":
        return cls(**{**{"fields": {}}, **d})


class FlightRecorder:
    """Bounded ring of :class:`Event` with structured query helpers —
    the replacement for grepping ``TraceRecorder.lines``."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._next_seq = 0
        self.dropped = 0

    def record(
        self,
        *,
        node: str,
        term: int,
        kind: Optional[str] = None,
        t_virtual: float = 0.0,
        state: str = "",
        group: Optional[int] = None,
        commit_index: Optional[int] = None,
        last_index: Optional[int] = None,
        msg: Optional[str] = None,
        **fields: Any,
    ) -> Event:
        """Append one event; oldest events fall off past ``capacity``
        (counted in ``dropped``). ``kind=None`` classifies from ``msg``."""
        if kind is None:
            kind = kind_of(msg) if msg is not None else "event"
        ev = Event(
            seq=self._next_seq, t_virtual=t_virtual, node=node,
            group=group, term=term, kind=kind, state=state,
            commit_index=commit_index, last_index=last_index,
            msg=msg, fields=fields,
        )
        self._next_seq += 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)
        return ev

    # ------------------------------------------------------------ queries
    def __len__(self) -> int:
        return len(self._ring)

    @property
    def total_recorded(self) -> int:
        return self._next_seq

    def events(
        self,
        kind: Optional[str] = None,
        node: Optional[str] = None,
        group: Optional[int] = None,
    ) -> List[Event]:
        out: Iterable[Event] = self._ring
        if kind is not None:
            out = (e for e in out if e.kind == kind)
        if node is not None:
            out = (e for e in out if e.node == node)
        if group is not None:
            out = (e for e in out if e.group == group)
        return list(out)

    def of_kind(self, *kinds: str) -> List[Event]:
        want = set(kinds)
        return [e for e in self._ring if e.kind in want]

    def nodelog_lines(self) -> List[str]:
        """The legacy trace stream re-rendered from the ring (events
        that never had a nodelog line are skipped)."""
        return [e.nodelog() for e in self._ring if e.msg is not None]

    def leaders_by_term(
        self, group: Optional[int] = None
    ) -> Dict[int, set]:
        """term -> nodes that recorded an election win in that term
        (optionally scoped to one multi-Raft group). Election Safety is
        ``all(len(v) <= 1 for v in ...values())`` — the structured
        replacement for ``TraceRecorder.leaders_by_term``."""
        out: Dict[int, set] = {}
        for e in self.events(kind="elect", group=group):
            out.setdefault(e.term, set()).add(e.node)
        return out

    def last_leader_per_term(
        self, group: Optional[int] = None
    ) -> Dict[int, Event]:
        """term -> the LAST election-win event of that term (forensics:
        who held each term when things went wrong)."""
        out: Dict[int, Event] = {}
        for e in self.events(kind="elect", group=group):
            out[e.term] = e
        return out

    # --------------------------------------------------------- (de)serial
    def to_jsonable(self) -> dict:
        return {
            "capacity": self.capacity,
            "dropped": self.dropped,
            "total_recorded": self._next_seq,
            "events": [e.to_jsonable() for e in self._ring],
        }

    @classmethod
    def from_jsonable(cls, d: dict) -> "FlightRecorder":
        rec = cls(capacity=d["capacity"])
        rec.dropped = d.get("dropped", 0)
        rec._next_seq = d.get("total_recorded", len(d["events"]))
        for ed in d["events"]:
            rec._ring.append(Event.from_jsonable(ed))
        return rec
