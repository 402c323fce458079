"""Write-ahead durability for (term, votedFor) — the transition-time half
of Raft's persistence obligation.

The reference *comments* Term/Voted as persistent data but never writes
them (main.go:18-21). ``EngineCheckpoint`` persists them at checkpoint
time; this module closes the remaining window: a crash **between** a vote
and the next checkpoint must not let a restarted replica vote twice in a
term it already voted in, or regress below a term it acted in. The engine
appends a record here on every vote round, term adoption, and step-down
*before* acting on the transition's outcome.

Why "after the device step, before the host acts" is the right fence: the
paper requires persisting before *sending* the vote response, because in a
message-passing system the response escapes the voter's failure domain the
moment it is sent. Here the vote grant and its consumption happen inside
one collective device step within one OS process — nothing outside the
process can observe the outcome until the host engine acts on it (promotes
a leader, acks a client, writes the archive). Persisting between the step
and any such action therefore gives exactly the paper's guarantee with
respect to every externally observable behavior. (On a multi-host
deployment each host passes its own ``VoteLog`` path and the same fence
holds per failure domain.)

Record format: a 6-byte magic header, then fixed 16-byte little-endian
records ``(replica: i32, term: i64, voted_for: i32)``. Appends are batched
per transition (one ``write`` + one ``fsync``); replay tolerates a torn
trailing record (crash mid-append keeps the previous good prefix).

A copy of ``raft_tpu/ckpt/votelog.py`` (host only), kept in this
package so the port imports nothing of the JAX package. The file
format is the same byte for byte: a log written by either package
replays in the other.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple

_MAGIC = b"RTVL1\n"
_REC = struct.Struct("<iqi")


def _fsync_dir(path: str) -> None:
    fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class VoteLog:
    """Append-only fsync'd log of (replica, term, voted_for) transitions."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size > 0:
            with open(path, "rb") as f:
                head = f.read(len(_MAGIC))
            if size < len(_MAGIC) and _MAGIC.startswith(head):
                # torn header from a crash during first creation: nothing
                # could have been recorded yet; start over
                size = 0
            elif head != _MAGIC:
                # a full-size foreign/corrupt header: appending would make
                # every fsync'd record silently unreadable on replay —
                # the exact double-vote hazard this log prevents. Refuse.
                raise ValueError(
                    f"{path} exists but is not a vote log (bad header); "
                    "refusing to append unreadable durability records"
                )
        if size > 0:
            # A crash mid-append can leave a torn trailing record. Replay
            # ignores it — but appending AFTER it would start every new
            # record at a misaligned offset, and replay's fixed 16-byte
            # framing would then parse across the torn boundary, silently
            # garbling every subsequent fsync'd record: the exact
            # double-vote hazard this log exists to prevent. Trim to the
            # last whole-record boundary before appending.
            aligned = (
                len(_MAGIC)
                + ((size - len(_MAGIC)) // _REC.size) * _REC.size
            )
            if aligned != size:
                with open(path, "r+b") as f:
                    f.truncate(aligned)
                    f.flush()
                    os.fsync(f.fileno())
        self._f = open(path, "ab" if size > 0 else "wb")
        if size == 0:
            self._f.write(_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
            _fsync_dir(path)   # pin the dirent too: data fsync alone does
            # not survive a crash that loses the directory entry, and a
            # vanished log replays as {} — the double-vote this file exists
            # to prevent

    def record_many(self, rows) -> None:
        """Durably append transitions for several replicas at once:
        ``rows`` iterates (replica, term, voted_for). One write + one
        fsync for the batch — the records become durable together, which
        is sound because the engine only acts after the call returns."""
        buf = b"".join(_REC.pack(int(r), int(t), int(v)) for r, t, v in rows)
        if not buf:
            return
        self._f.write(buf)
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()

    def truncate(self) -> None:
        """Reset to empty (header only) — called after a full checkpoint
        makes the accumulated records redundant. Atomic (temp file +
        rename): a crash mid-truncate must leave either the old full log
        or the new empty one, never a torn header."""
        import tempfile

        self._f.close()
        parent = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=parent, suffix=".vlog.tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(_MAGIC)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(self.path)
        self._f = open(self.path, "ab")

    @staticmethod
    def replay(path: str) -> Dict[int, Tuple[int, int]]:
        """Read the log back: replica -> (term, voted_for) of its last
        durable transition. Empty dict when the file is missing/empty.
        A torn trailing record (crash mid-append) is ignored."""
        out: Dict[int, Tuple[int, int]] = {}
        try:
            with open(path, "rb") as f:
                head = f.read(len(_MAGIC))
                if head != _MAGIC:
                    return out
                data = f.read()
        except FileNotFoundError:
            return out
        n = len(data) // _REC.size
        for i in range(n):
            r, t, v = _REC.unpack_from(data, i * _REC.size)
            out[r] = (t, v)
        return out


def merge_restored(
    n_replicas: int,
    terms,
    voted_for,
    log_path: Optional[str],
):
    """Overlay a vote log's replayed transitions onto checkpoint-restored
    (terms, voted_for) arrays: for each replica the record with the higher
    term wins (same term: the vote log wins — it is the more recent write,
    and within one term votedFor only moves NO_VOTE -> candidate)."""
    if log_path is None:
        return terms, voted_for
    for r, (t, v) in VoteLog.replay(log_path).items():
        if 0 <= r < n_replicas and t >= int(terms[r]):
            terms[r] = t
            voted_for[r] = v
    return terms, voted_for
