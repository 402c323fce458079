"""Incremental snapshot shipping: chunked, resumable catch-up streams.

The old install path was monolithic: a ring-lapped replica got the
whole clamped committed range written in ONE host action inside one
leader tick — free on the virtual clock, but a real deployment pays
the full transfer where it hurts (the leader's tick loop), and the
PR-4 wipe ladder grows with what has to move. This module makes the
install a *stream*:

- the catch-up range is shipped in ``chunk_entries``-sized chunks,
  at most ``budget`` chunks per leader tick — the budget comes from
  the admission gate's catch-up lane (``AdmissionGate.catchup_chunks``)
  so a congested write lane throttles catch-up to a trickle instead of
  being stalled by it;
- the stream is RESUMABLE by construction: each installed chunk
  advances the replica's device ``match_index``, and the next tick's
  plan starts at ``match + 1`` — a leader change, a follower kill
  mid-stream, or an engine restart all resume from the last acked
  chunk with no shipper state needed (the device match IS the ack
  cursor);
- per-replica stream stats (starts, resumes, chunks, spans) feed the
  ``/status`` tiered section and ``raft_snapshot_chunks_total``.

The shipper itself holds only bookkeeping, never bytes: chunk payloads
are read from the (possibly tiered) checkpoint store at install time,
so a stream deep into sealed history pages segments through the
store's cache instead of materializing the whole range.

A copy of ``raft_tpu/ckpt/ship.py`` (host only), kept in this
package so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class StreamState:
    """One replica's in-flight catch-up stream (bookkeeping only)."""

    base: int                  # first index this stream started from
    next: int                  # next index to ship (last acked + 1)
    goal: int                  # committed index the stream is chasing
    chunks: int = 0            # chunks installed so far
    resumes: int = 0           # times the stream restarted mid-range


class SnapshotShipper:
    """Plans per-tick chunk windows for lapped replicas' catch-up."""

    def __init__(self, chunk_entries: int):
        if chunk_entries < 1:
            raise ValueError("chunk_entries must be >= 1")
        self.chunk_entries = chunk_entries
        self.streams: Dict[int, StreamState] = {}
        self.chunks_total = 0
        self.streams_started = 0
        self.streams_finished = 0

    def plan(
        self, replica: int, cursor: int, goal: int, budget: int
    ) -> List[Tuple[int, int]]:
        """Chunk windows to install for ``replica`` this tick.

        ``cursor`` is the replica's next needed index (``match + 1``,
        clamped by the caller to the ring-fitting tail); ``goal`` the
        committed index to chase. Returns up to ``budget`` contiguous
        ``(lo, hi)`` chunks. Detects stream starts and mid-range
        resumes (a cursor that moved backwards means the follower lost
        device state and re-laps — the stream restarts from the new
        cursor; a cursor ahead of ``next`` means chunks acked while we
        were not looking, which is the normal resume-after-kill shape).
        """
        st = self.streams.get(replica)
        if st is None:
            st = StreamState(base=cursor, next=cursor, goal=goal)
            self.streams[replica] = st
            self.streams_started += 1
        elif cursor != st.next:
            st.resumes += 1
            st.next = cursor
        st.goal = goal
        out: List[Tuple[int, int]] = []
        nxt = st.next
        for _ in range(max(0, budget)):
            if nxt > goal:
                break
            hi = min(nxt + self.chunk_entries - 1, goal)
            out.append((nxt, hi))
            nxt = hi + 1
        return out

    def acked(self, replica: int, through: int) -> None:
        """One chunk installed through index ``through``."""
        st = self.streams[replica]
        st.next = through + 1
        st.chunks += 1
        self.chunks_total += 1

    def finish(self, replica: int) -> None:
        """The replica is back inside the repair window's reach — the
        stream is done (the window serves the remainder)."""
        if self.streams.pop(replica, None) is not None:
            self.streams_finished += 1

    def is_streaming(self, replica: int) -> bool:
        return replica in self.streams

    def summary(self) -> dict:
        """The ``/status`` catch-up section."""
        return {
            "active": {
                str(r): {
                    "base": st.base, "next": st.next, "goal": st.goal,
                    "chunks": st.chunks, "resumes": st.resumes,
                }
                for r, st in self.streams.items()
            },
            "chunk_entries": self.chunk_entries,
            "chunks_total": self.chunks_total,
            "streams_started": self.streams_started,
            "streams_finished": self.streams_finished,
        }
