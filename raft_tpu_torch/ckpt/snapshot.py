"""Checkpoint data and the committed-entry archive (port of
``raft_tpu/ckpt/snapshot.py``, host only).

- ``CheckpointStore`` — host-side archive of committed entries (payload
  bytes + per-entry term). The engine feeds it at commit time from its
  ingest buffer, falling back to a device read of the just-committed
  window; entries older than ``max_entries`` are compacted away.
- ``Snapshot`` — a contiguous committed slice ``[base_index, last_index]``
  with terms.
- ``EngineCheckpoint`` — the durable whole-cluster state.

Both are data here. Not ported yet: their ``.npz`` files
(``save``/``load``), ``install_snapshot``/``install_snapshot_all``
(writing a snapshot into a replica's ring), the store's checkpoint floor
and ``set_floor`` (restore) — ROADMAP A9b — and its span blocks (the
fused K-tick booking path, A11).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Snapshot:
    """A committed, contiguous log slice — (term, committed prefix) state.

    ``entries`` are FULL entry bytes (not shards) so one snapshot serves
    both plain and erasure-coded clusters: install re-encodes the target
    replica's shard rows on demand.
    """

    base_index: int        # first included log index (1-based)
    last_index: int        # last included log index
    entries: np.ndarray    # u8[last-base+1, entry_bytes]
    terms: np.ndarray      # i32[last-base+1]

    @property
    def last_term(self) -> int:
        return int(self.terms[-1]) if self.terms.size else 0


@dataclasses.dataclass
class EngineCheckpoint:
    """Durable whole-cluster state: the fields the reference *comments* as
    persistent but never writes (Term/Voted/Log, main.go:18-21), actually
    written to disk. One file restarts the whole engine process:
    per-replica term and votedFor (the Raft persistence obligation — a
    restarted replica must not double-vote in a term it already voted in)
    plus the archived committed tail. This captures checkpoint-TIME
    state; the transition-time half of the obligation (a crash between a
    vote and the next checkpoint) is ``ckpt.votelog.VoteLog``, which the
    engine appends to before acting on any vote/term transition."""

    snap: Snapshot         # committed contiguous tail (may be empty)
    terms: np.ndarray      # i32[R] per-replica current term
    voted_for: np.ndarray  # i32[R] per-replica votedFor (NO_VOTE = -1)
    member: Optional[np.ndarray] = None  # bool[R] configuration at save
    #   time (membership-change clusters); None on older checkpoints or
    #   fixed-membership clusters (= all rows are members)
    learner: Optional[np.ndarray] = None  # bool[R] non-voting learners at
    #   save time (dissertation §4.2.1); None on older checkpoints (= no
    #   learners, the only configuration they could express)


class CheckpointStore:
    """Append-only host archive of committed entries.

    This is the durable state the reference never writes anywhere: the
    committed log survives here even after the device ring laps it, so a
    long-dead replica can be re-seeded. (In a multi-host deployment each
    host would persist its own replica's feed; in this single-process
    engine one store serves the cluster.) Retention is ``max_entries``
    in RAM (the JAX package's ``ckpt.tiered.TieredStore`` subclass, not
    ported yet, seals the same horizon to disk instead).
    """

    def __init__(self, entry_bytes: int, max_entries: Optional[int] = None):
        self.entry_bytes = entry_bytes
        self.max_entries = max_entries
        self._slots: Dict[int, Tuple[bytes, int]] = {}  # idx -> (bytes, term)
        self.last = 0
        self._first = 1  # compaction floor: indices below it were evicted

    def put(self, idx: int, payload: bytes, term: int) -> None:
        self._slots[idx] = (payload, term)
        self.last = max(self.last, idx)
        self._sweep()

    def _sweep(self) -> None:
        if self.max_entries is None:
            return
        # indices arrive monotonically, so eviction is an incremental
        # floor sweep — amortized O(1) per put
        floor = self.last - self.max_entries
        while self._first <= floor:
            self._slots.pop(self._first, None)
            self._first += 1

    def get(self, idx: int) -> Optional[Tuple[bytes, int]]:
        """(payload, term) for one archived index; None when compacted
        away or never archived."""
        if idx < self._first:
            return None
        return self._slots.get(idx)

    @property
    def first(self) -> int:
        """Compaction floor: indices below it were evicted by the
        ``max_entries`` sweep. An absent index AT or ABOVE this floor was
        never archived (a hole), not compacted."""
        return self._first

    def covers(self, lo: int, hi: int) -> bool:
        return hi >= lo and all(
            self.get(i) is not None for i in range(lo, hi + 1)
        )

    def covered_lo(self, hi: int, floor: int = 1) -> int:
        """Smallest ``lo >= floor`` such that [lo, hi] is contiguously
        archived (``hi + 1`` when even ``hi`` itself is missing).
        ``floor`` bounds the walk."""
        if self.get(hi) is None:
            return hi + 1
        lo = hi
        while lo - 1 >= floor and self.get(lo - 1) is not None:
            lo -= 1
        return lo

    def snapshot(self, lo: int, hi: int) -> Snapshot:
        assert self.covers(lo, hi), f"store does not cover [{lo}, {hi}]"
        ents = np.frombuffer(
            b"".join(self.get(i)[0] for i in range(lo, hi + 1)), np.uint8
        ).reshape(hi - lo + 1, self.entry_bytes)
        terms = np.asarray(
            [self.get(i)[1] for i in range(lo, hi + 1)], np.int32
        )
        return Snapshot(lo, hi, ents, terms)
