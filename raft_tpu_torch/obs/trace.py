"""Trace capture in the reference's nodelog schema (port of
``raft_tpu/obs/trace.py``).

Format (main.go:399-401): ``[Id:Term:CommitIndex:LastApplied][state]msg``.
Both the golden model and the engine emit it through their ``trace``
callbacks; a ``TraceRecorder`` is that callback plus parsing/filtering for
assertions (e.g. Election Safety: at most one leader transition per term).

Multi-Raft runs (``raft_tpu.multi``) tag the id field with the consensus
group — ``g3/Server0`` — which parses as an ordinary node id here;
``TraceRecord.group`` recovers the scope so per-group assertions (e.g.
Election Safety per group) filter without string surgery.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterator, List, Optional

_LINE = re.compile(
    r"^\[(?P<id>[^:\]]+):(?P<term>-?\d+):(?P<commit>-?\d+):(?P<last>-?\d+)\]"
    r"\[(?P<state>[a-z]+)\](?P<msg>.*)$"
)


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    node: str
    term: int
    commit_index: int
    last_index: int
    state: str
    message: str

    @classmethod
    def parse(cls, line: str) -> "TraceRecord":
        m = _LINE.match(line)
        if not m:
            raise ValueError(f"not a nodelog line: {line!r}")
        return cls(
            node=m["id"],
            term=int(m["term"]),
            commit_index=int(m["commit"]),
            last_index=int(m["last"]),
            state=m["state"],
            message=m["msg"],
        )

    @property
    def group(self) -> Optional[int]:
        """Raft-group scope of a multi-Raft nodelog line (``gN/ServerR``
        ids, ``multi.MultiEngine.nodelog``); None for single-group
        lines."""
        m = re.match(r"^g(\d+)/", self.node)
        return int(m.group(1)) if m else None


class TraceRecorder:
    """Callable sink for nodelog lines with query helpers."""

    def __init__(self) -> None:
        self.lines: List[str] = []

    def __call__(self, line: str) -> None:
        self.lines.append(line)

    def __len__(self) -> int:
        return len(self.lines)

    def records(self) -> Iterator[TraceRecord]:
        return (TraceRecord.parse(line) for line in self.lines)

    def matching(self, substring: str) -> List[TraceRecord]:
        return [r for r in self.records() if substring in r.message]

    def leaders_by_term(self) -> dict[int, set]:
        """term -> nodes that logged a leader transition in that term. The
        Election Safety assertion is: every value set has size <= 1."""
        out: dict[int, set] = {}
        for r in self.matching("state changed to leader"):
            out.setdefault(r.term, set()).add(r.node)
        return out
