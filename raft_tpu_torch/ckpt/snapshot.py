"""Checkpoint / snapshot-install: rejoin for replicas the ring has lapped
(port of ``raft_tpu/ckpt/snapshot.py``).

A replica lagging by >= log_capacity entries can never be log-healed:
the leader's ring no longer holds the entries its next
consistency-checked window would need (the horizon clamp in
``core.step``), and under EC every donor's ring has lapped too
(``ec.reconstruct.heal_replica`` raises). This module is Raft's
InstallSnapshot for both cases:

- ``CheckpointStore`` — host-side archive of committed entries (payload
  bytes + per-entry term). The engine feeds it at commit time from its
  ingest buffer, falling back to a device read of the just-committed
  window; entries older than ``max_entries`` are compacted away.
- ``Snapshot`` — a contiguous committed slice ``[base_index, last_index]``
  with terms, serializable to one ``.npz`` file (``save``/``load``).
- ``EngineCheckpoint`` — the durable whole-cluster state, one ``.npz``.
- ``install_snapshot`` — writes the snapshot's ring-fitting tail into a
  replica's lane block (re-encoding RS shards when EC is on) and advances
  its match/commit to the snapshot index, via the same chunked window
  install the EC heal path uses. The repair window then covers
  (snapshot_index, leader_last] — which ring backpressure guarantees is
  less than one capacity.

The ``.npz`` layouts are the JAX package's, key for key and dtype for
dtype, so a snapshot or checkpoint written by either package loads in the
other. One difference of mechanism, none of result: under EC the shard
rows are encoded on the state's device with ``ec.kernels.encode_device``
(kernel K6 on the card, its plain ``encode_bitwise`` on the CPU) where the
JAX package uses its C++ host codec (``RSCode.encode_host``); the bytes
are the same. The tiered archive (``ckpt.tiered.TieredStore``) subclasses
``CheckpointStore``.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from raft_tpu_torch.core.state import ReplicaState
from raft_tpu_torch.ec.kernels import encode_device
from raft_tpu_torch.ec.reconstruct import install_entries


def _atomic_savez(path: str, **arrays) -> None:
    """Write an .npz to exactly ``path`` (no implicit extension), via a
    temp file + ``os.replace``: a crash mid-write must never clobber the
    previous good checkpoint — losing the old durable state on an
    interrupted save is precisely the failure persistence exists to
    prevent. A file handle (not a path) stops np.savez appending '.npz'."""
    parent = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())   # survive power loss, not just a crash:
            # without the fsync, delayed allocation can journal the rename
            # while the data blocks are still unflushed — a truncated file
            # under the final name after reboot
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # fsync the directory too: without it the rename itself may not be
    # journaled at power loss, and the path would still resolve to the old
    # checkpoint after reboot — the caller already treated the new state
    # (e.g. a vote) as durable by then. Outside the cleanup try: the
    # replace has succeeded, so tmp must not be unlinked on a dir-fsync
    # error.
    dfd = os.open(parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


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

    def save(self, path: str) -> None:
        _atomic_savez(
            path,
            base_index=self.base_index,
            last_index=self.last_index,
            entries=self.entries,
            terms=self.terms,
        )

    @classmethod
    def load(cls, path: str) -> "Snapshot":
        with np.load(path) as z:
            return cls(
                base_index=int(z["base_index"]),
                last_index=int(z["last_index"]),
                entries=np.asarray(z["entries"], np.uint8),
                terms=np.asarray(z["terms"], np.int32),
            )


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

    def save(self, path: str) -> None:
        member = (
            self.member if self.member is not None
            else np.ones_like(self.terms, bool)
        )
        learner = (
            self.learner if self.learner is not None
            else np.zeros_like(self.terms, bool)
        )
        _atomic_savez(
            path,
            base_index=self.snap.base_index,
            last_index=self.snap.last_index,
            entries=self.snap.entries,
            terms=self.snap.terms,
            replica_terms=self.terms,
            voted_for=self.voted_for,
            member=np.asarray(member, bool),
            learner=np.asarray(learner, bool),
        )

    @classmethod
    def load(cls, path: str) -> "EngineCheckpoint":
        with np.load(path) as z:
            snap = Snapshot(
                base_index=int(z["base_index"]),
                last_index=int(z["last_index"]),
                entries=np.asarray(z["entries"], np.uint8),
                terms=np.asarray(z["terms"], np.int32),
            )
            return cls(
                snap=snap,
                terms=np.asarray(z["replica_terms"], np.int32),
                voted_for=np.asarray(z["voted_for"], np.int32),
                member=(
                    np.asarray(z["member"], bool) if "member" in z else None
                ),
                learner=(
                    np.asarray(z["learner"], bool) if "learner" in z
                    else None
                ),
            )


class CheckpointStore:
    """Append-only host archive of committed entries.

    This is the durable state the reference never writes anywhere: the
    committed log survives here even after the device ring laps it, so a
    long-dead replica can be re-seeded. (In a multi-host deployment each
    host would persist its own replica's feed; in this single-process
    engine one store serves the cluster.) Retention is ``max_entries``
    in RAM (the ``ckpt.tiered.TieredStore`` subclass seals the same horizon
    into RS-coded on-disk segments instead).
    """

    def __init__(self, entry_bytes: int, max_entries: Optional[int] = None):
        self.entry_bytes = entry_bytes
        self.max_entries = max_entries
        self._slots: Dict[int, Tuple[bytes, int]] = {}  # idx -> (bytes, term)
        self._spans: Dict[int, tuple] = {}
        #   lo -> (hi, items, term, pick): whole committed RANGES
        #   archived as one block (put_span — the fused K-tick booking
        #   path), sliced lazily on read. ``items`` is any indexable of
        #   per-entry records; ``pick`` selects the payload field (None
        #   = the record IS the payload bytes). Never mutated after
        #   insertion; ``_slots`` takes precedence on overlap (a later
        #   single-index put, e.g. an archive backfill, wins).
        self._span_los: list = []      # sorted keys of _spans (bisect)
        self.last = 0
        self._first = 1  # compaction floor: indices below it were evicted

    def put(self, idx: int, payload: bytes, term: int) -> None:
        self._slots[idx] = (payload, term)
        self.last = max(self.last, idx)
        self._sweep()

    def put_span(self, lo: int, items, term: int,
                 pick: Optional[int] = None) -> None:
        """Archive the contiguous committed range ``[lo, lo+len(items))``
        as ONE block — O(1) per launch instead of O(entries): the fused
        steady drain hands the queue slice it just committed straight
        in (``pick=1`` selects the payload out of (seq, payload)
        records), and reads slice it lazily. Same retention and
        compaction semantics as per-index puts."""
        if not len(items):
            return
        fresh = lo not in self._spans
        self._spans[lo] = (lo + len(items) - 1, items, term, pick)
        if fresh:
            # a repeated lo replaces the block in place — inserting a
            # duplicate key into the sorted list would leave a dangling
            # entry for the retention sweep to KeyError on
            bisect.insort(self._span_los, lo)
        self.last = max(self.last, lo + len(items) - 1)
        self._sweep()

    def _sweep(self) -> None:
        if self.max_entries is None:
            return
        # indices arrive monotonically, so eviction is an incremental
        # floor sweep — amortized O(1) per put; span blocks drop whole
        # once fully below the floor (partially-below blocks stay, the
        # ``get`` floor guard hides their compacted prefix)
        floor = self.last - self.max_entries
        while self._first <= floor:
            self._slots.pop(self._first, None)
            self._first += 1
        self._drop_dead_spans()

    def _drop_dead_spans(self) -> None:
        self._drop_spans_below(self._first)

    def _drop_spans_below(self, floor: int) -> None:
        """Drop span blocks that lie WHOLLY below ``floor`` (a block
        straddling it stays — its compacted prefix is hidden by the
        caller's floor guard). Shared by the retention sweep and the
        tiered store's seal-time hot-tier eviction (``ckpt.tiered``,
        whose floor is the sealed boundary, not the compaction floor)."""
        while self._span_los and \
                self._spans[self._span_los[0]][0] < floor:
            del self._spans[self._span_los.pop(0)]

    def _span_entry(self, idx: int) -> Optional[Tuple[bytes, int]]:
        if not self._span_los:
            return None
        i = bisect.bisect_right(self._span_los, idx) - 1
        if i < 0:
            return None
        lo = self._span_los[i]
        hi, items, term, pick = self._spans[lo]
        if idx > hi:
            return None
        rec = items[idx - lo]
        return (rec if pick is None else rec[pick], term)

    def get(self, idx: int) -> Optional[Tuple[bytes, int]]:
        """(payload, term) for one archived index; None when compacted
        away or never archived."""
        if idx < self._first:
            return None
        got = self._slots.get(idx)
        if got is not None:
            return got
        return self._span_entry(idx)

    @property
    def first(self) -> int:
        """Compaction floor: indices below it were evicted by the
        ``max_entries`` sweep. An absent index AT or ABOVE this floor was
        never archived (a hole), not compacted."""
        return self._first

    @property
    def checkpoint_floor(self) -> int:
        """First index ``save_checkpoint`` should consider including.
        For the plain in-RAM store this is just the compaction floor; the
        tiered store overrides it so checkpoints stay O(ring capacity)
        even though its coverage reaches arbitrarily deep into sealed
        segments (deep history restores from the segment tier's own
        files, not from a checkpoint that would grow with history)."""
        return self._first

    def set_floor(self, first: int) -> None:
        """Raise the compaction floor explicitly (never lowers). The
        restore path uses this to record that history below a restored
        snapshot's ``base_index`` was compacted BEFORE the checkpoint was
        written — without it, a later ``save_checkpoint`` would treat the
        absent indices as a recoverable hole and try to backfill them
        from ring slots that never held those entries."""
        if first <= self._first:
            return
        for k in [k for k in self._slots if k < first]:
            del self._slots[k]
        self._first = first
        self._drop_dead_spans()

    def covers(self, lo: int, hi: int) -> bool:
        return hi >= lo and all(
            self.get(i) is not None for i in range(lo, hi + 1)
        )

    def covered_lo(self, hi: int, floor: int = 1) -> int:
        """Smallest ``lo >= floor`` such that [lo, hi] is contiguously
        archived (``hi + 1`` when even ``hi`` itself is missing).
        ``floor`` bounds the walk: a caller that will clamp the result
        anyway (``save_checkpoint`` at the checkpoint floor) must not
        page the tiered store's ENTIRE sealed history through the
        segment cache just to discard it."""
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


def _ring_tail(snap: Snapshot, cap: int):
    """The snapshot tail that fits a capacity-``cap`` ring: (start index,
    entries, terms). Standard log compaction — slots below the installed
    range keep stale bytes nothing will ever read (consistency probes only
    look at the window prev point, which the install covers)."""
    n = snap.entries.shape[0]
    keep = min(n, cap)
    return (
        snap.last_index - keep + 1,
        snap.entries[n - keep:],
        snap.terms[n - keep:],
    )


def _shard_rows(state: ReplicaState, code, ents: np.ndarray) -> torch.Tensor:
    """u8[n, N, Sk]: every replica's RS shard row of ``ents``, encoded on
    the state's device (K6 on the card, ``encode_bitwise`` on the CPU)."""
    return encode_device(code, torch.from_numpy(
        np.require(ents, requirements=["C", "W"])).to(state.device))


def install_snapshot(
    state: ReplicaState,
    replica: int,
    snap: Snapshot,
    leader_term: int,
    batch: int,
    code=None,
    view=None,
) -> ReplicaState:
    """Install a snapshot into one replica's row; returns the new state.

    Only the ring-fitting tail is materialized (``_ring_tail``). ``code``
    re-encodes the replica's RS shard row when the cluster is
    erasure-coded. On the mesh (``view``) only the ranks holding the row
    write (no collective; on the 2-D mesh each its byte slice,
    ``install_entries``); the others return their state unchanged.
    """
    if view is not None and view.local_row(replica) is None:
        return state
    start, ents, terms = _ring_tail(snap, state.capacity)
    payload = ents if code is None else _shard_rows(state, code, ents)[replica]
    return install_entries(
        state, replica, start, payload, terms, leader_term,
        commit_to=snap.last_index, batch=batch, view=view,
    )


def install_snapshot_all(
    state: ReplicaState,
    snap: Snapshot,
    leader_term: int,
    batch: int,
    code=None,
    rows=None,
    view=None,
) -> ReplicaState:
    """``install_snapshot`` into EVERY replica row (the whole-cluster
    restore path), encoding the tail once — per-replica ``install_snapshot``
    would redo the full RS encode R times for R shard rows it already
    produced. ``rows`` is the cluster's row count (default: the state's);
    on the mesh (``view``) each rank installs the row it holds."""
    start, ents, terms = _ring_tail(snap, state.capacity)
    shard_rows = None if code is None else _shard_rows(state, code, ents)
    n_rows = state.term.shape[0] if rows is None else rows
    for r in range(n_rows):
        payload = ents if shard_rows is None else shard_rows[r]
        state = install_entries(
            state, r, start, payload, terms, leader_term,
            commit_to=snap.last_index, batch=batch, view=view,
        )
    return state
