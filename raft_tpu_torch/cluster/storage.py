"""The storage VFS seam: every durable write the cluster tier makes (port
of ``raft_tpu/cluster/storage.py``, whole).

Every durable byte of the cluster tier goes through this seam:
``cluster/node.py`` (the WAL, the vote file, the death certificate) and
``ckpt/tiered.py`` (segment shards, CRC sidecars, the manifest) route
their writes through a :class:`RealIO`, and a drill child swaps in a
:class:`FaultyIO` that injects, seed-driven:

- **torn / short writes** — un-fsynced bytes live in a RAM buffer and
  only a seed-chosen *prefix* "leaks" to the real file (the simulated
  page cache); ``kill -9`` before the next fsync leaves a genuinely
  torn tail, at a record boundary or mid-record, exactly like a real
  crash during a write-back.
- **post-fsync bit flips** — silent media corruption *after* fsync
  returned: the WAL's per-record CRC must truncate to the last valid
  prefix, the shard sidecars must reject and reconstruct.
- **fsync raising EIO exactly once** — the PostgreSQL fsyncgate
  lesson: after a failed fsync the page cache state is UNKNOWABLE, so
  the only sound response is FAIL-STOP (publish a death certificate
  and exit), never retry-fsync-and-carry-on. ``fsync_after_eio`` in
  the stats file counts retries; the drill pins it at zero.
- **disk full** — ``write`` raises :class:`DiskFull` inside a wall
  clock window; the node converts it to a typed shed/refusal (no
  corruption, no ack).
- **fsync stalls** — a slow disk: every Nth fsync sleeps on the event
  loop thread, composing with the lease clock and the stall watchdog.

The fault plan is ``disk.json`` in the node's data dir (written by the
drill, re-read on mtime change so faults can be armed against a LIVE
process); observed fault counters go to ``disk-stats.json`` beside it.
Module-level helpers at the bottom are the *drill-side* corruptions
applied between ``kill -9`` and restart (tear a WAL tail, flip a
mid-file bit, tear the manifest, flip a sealed data shard). The plan
and stats files are the JAX package's.

Import discipline: this module imports nothing from the package
(``ckpt/tiered.py`` resolves it lazily), so the
``tiered -> storage -> cluster/__init__ -> node -> tiered`` chain
never deadlocks on a partially-initialized module.
"""

from __future__ import annotations

import errno
import json
import os
import random
import tempfile
import time
from typing import Optional


class DiskFull(OSError):
    """The disk refused the write (ENOSPC). Nothing was persisted by
    the failing call; the caller must shed typed, never ack."""

    def __init__(self, path: str):
        super().__init__(errno.ENOSPC, "injected disk full", path)


class DiskFailStop(RuntimeError):
    """fsync reported EIO: the page cache state is unknowable and the
    node must fail-stop (death certificate + exit), never retry."""


def atomic_write(path: str, blob: bytes) -> None:
    """temp file + ``os.replace``: a crash mid-write leaves either the
    old file or the new one under the final name, never a torn half."""
    parent = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _RealAppend:
    """Append handle over a real fd: write-through, real fsync."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")

    def write(self, blob: bytes) -> None:
        self._f.write(blob)

    def fsync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class RealIO:
    """The production storage backend: direct OS calls, no faults."""

    def open_append(self, path: str) -> _RealAppend:
        return _RealAppend(path)

    def atomic_write(self, path: str, blob: bytes) -> None:
        atomic_write(path, blob)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def unlink(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def is_full(self) -> bool:
        return False


class _FaultyAppend:
    """Append handle with a simulated page cache (module docstring).

    ``pending`` holds bytes written but not fsynced; a seed-chosen
    prefix of it "leaks" to the real file on every write (``torn``
    plans), so a ``kill -9`` leaves exactly what a real crash would:
    everything fsynced, plus an arbitrary — possibly mid-record —
    prefix of what was not."""

    def __init__(self, io: "FaultyIO", path: str):
        self.io = io
        self.path = path
        self._f = open(path, "ab")
        self._pending = bytearray()
        self._leaked = 0          # bytes of pending already in the file

    def write(self, blob: bytes) -> None:
        self.io._on_write(self.path)          # may raise DiskFull
        self._pending += blob
        plan = self.io.plan
        if plan.get("torn") and self._pending:
            # the simulated page cache writes back a seed-chosen prefix
            # of the un-fsynced tail — monotone per fsync epoch, so the
            # file only ever grows between fsyncs
            want = self.io.rng.randrange(0, len(self._pending) + 1)
            if want > self._leaked:
                self._f.write(bytes(self._pending[self._leaked:want]))
                self._f.flush()
                self._leaked = want

    def fsync(self) -> None:
        lies = self.io._on_fsync(self.path)    # may raise OSError(EIO)
        if lies:
            return          # claimed durable; bytes stay in RAM only
        if self._pending:
            self._f.write(bytes(self._pending[self._leaked:]))
            self._pending.clear()
            self._leaked = 0
        self._f.flush()
        os.fsync(self._f.fileno())
        self.io._after_fsync(self._f, self.path)

    def close(self) -> None:
        # close models a crash for un-fsynced bytes: they are NOT
        # flushed (the WAL rewrite path replaces the file wholesale
        # right after, and a real close would quietly un-tear the tail)
        try:
            self._f.close()
        except OSError:
            pass


class FaultyIO(RealIO):
    """Plan-driven lying disk (module docstring). ``root`` is the node
    data dir holding ``disk.json`` (the plan) and ``disk-stats.json``
    (observed fault counters, written via REAL atomic writes)."""

    _POLL_S = 0.05      # plan mtime re-check cadence

    def __init__(self, root: str):
        self.root = root
        self.plan_path = os.path.join(root, "disk.json")
        self.stats_path = os.path.join(root, "disk-stats.json")
        self.plan: dict = {}
        self._plan_mtime = -1.0
        self._next_poll = 0.0
        self.rng = random.Random(0)
        self.stats = {
            "writes": 0, "fsyncs": 0, "eio_raised": 0,
            "fsync_after_eio": 0, "flips": 0, "stalls": 0,
            "full_writes_refused": 0,
        }
        self._eio_fired = False
        self._reload(force=True)

    # ------------------------------------------------------------ plan
    def _reload(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now < self._next_poll:
            return
        self._next_poll = now + self._POLL_S
        try:
            mtime = os.stat(self.plan_path).st_mtime
        except OSError:
            self.plan, self._plan_mtime = {}, -1.0
            return
        if mtime == self._plan_mtime:
            return
        self._plan_mtime = mtime
        try:
            with open(self.plan_path) as f:
                self.plan = json.load(f)
        except (OSError, ValueError):
            return              # torn plan write: keep the old plan
        self.rng = random.Random(self.plan.get("seed", 0))

    def _publish(self) -> None:
        try:
            atomic_write(self.stats_path,
                         json.dumps(self.stats).encode())
        except OSError:
            pass

    # ----------------------------------------------------------- hooks
    def _on_write(self, path: str) -> None:
        self._reload()
        self.stats["writes"] += 1
        full_until = self.plan.get("full_until_ts")
        if full_until is not None and time.time() < float(full_until):
            self.stats["full_writes_refused"] += 1
            self._publish()
            raise DiskFull(path)

    def _on_fsync(self, path: str) -> bool:
        """Count one fsync; inject EIO / stalls; returns True when the
        plan says to LIE (claim durability without persisting)."""
        self._reload()
        if self._eio_fired:
            # the fsyncgate tooth: any fsync call after the EIO is a
            # retry the fail-stop contract forbids — count it loudly
            self.stats["fsync_after_eio"] += 1
            self._publish()
            raise OSError(errno.EIO, "injected EIO (retry after EIO)",
                          path)
        self.stats["fsyncs"] += 1
        plan = self.plan
        every = int(plan.get("stall_every", 0) or 0)
        if every > 0 and self.stats["fsyncs"] % every == 0:
            self.stats["stalls"] += 1
            self._publish()
            time.sleep(float(plan.get("stall_s", 0.05)))
        if plan.get("eio_arm") and not self._eio_fired:
            self._eio_fired = True
            self.stats["eio_raised"] += 1
            self._publish()
            raise OSError(errno.EIO, "injected EIO at fsync", path)
        if plan.get("fsync_lies"):
            return True
        return False

    def _after_fsync(self, f, path: str) -> None:
        """Post-fsync media corruption: flip one seed-chosen bit in the
        durable file — fsync RETURNED, then the platter lied."""
        flips = self.plan.get("flip_after_fsync") or []
        if self.stats["fsyncs"] not in flips:
            return
        try:
            size = os.path.getsize(path)
            if size < 2:
                return
            pos = self.rng.randrange(size // 2, size)
            with open(path, "r+b") as g:
                g.seek(pos)
                byte = g.read(1)
                g.seek(pos)
                g.write(bytes([byte[0] ^ (1 << self.rng.randrange(8))]))
            self.stats["flips"] += 1
            self._publish()
        except OSError:
            pass

    # ------------------------------------------------------------ seam
    def open_append(self, path: str) -> _FaultyAppend:
        return _FaultyAppend(self, path)

    def is_full(self) -> bool:
        self._reload()
        full_until = self.plan.get("full_until_ts")
        return full_until is not None and time.time() < float(full_until)


# ===================================================================
# Drill-side corruption helpers: applied to a DEAD node's files
# between kill -9 and restart (the injection window where recovery,
# not steady state, is on trial).

def tear_file_tail(path: str, drop_bytes: int) -> int:
    """Truncate ``drop_bytes`` off the file tail (a torn final write
    that never fsynced); returns the new size, or -1 when the file is
    missing/too small to tear."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return -1
    if size <= drop_bytes:
        return -1
    with open(path, "r+b") as f:
        f.truncate(size - drop_bytes)
    return size - drop_bytes


def flip_file_bit(path: str, rng: random.Random,
                  lo_frac: float = 0.4, hi_frac: float = 0.8) -> int:
    """Flip one bit at a seed-chosen offset inside the middle of the
    file (mid-file rot, NOT the tail — the recovery path must truncate
    at the corruption, never skip it); returns the offset, -1 when the
    file is too small."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return -1
    if size < 8:
        return -1
    pos = rng.randrange(int(size * lo_frac), max(int(size * hi_frac),
                                                 int(size * lo_frac) + 1))
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ (1 << rng.randrange(8))]))
    return pos


def torn_truncate(path: str, frac: float = 0.5) -> bool:
    """Truncate a file to ``frac`` of its size — the half-written
    state a NON-atomic writer leaves behind (what manifest recovery's
    previous-generation fallback exists for)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size < 2:
        return False
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * frac)))
    return True


def flip_sealed_shard(segments_dir: str, rng: random.Random,
                      row: int = 0) -> Optional[str]:
    """Flip one payload bit in a sealed DATA shard (row < k) of the
    OLDEST segment, leaving its CRC sidecar stale — the read path must
    reject the shard and reconstruct through the RS decode
    (``segment_reconstructs`` > 0 is the drill's witness). Returns the
    shard path, or None when no sealed segment exists."""
    try:
        names = sorted(n for n in os.listdir(segments_dir)
                       if n.startswith("seg-") and n.endswith(f".s{row}"))
    except OSError:
        return None
    if not names:
        return None
    p = os.path.join(segments_dir, names[0])
    try:
        size = os.path.getsize(p)
        if size < 64:
            return None
        pos = rng.randrange(size // 2, size)    # payload region
        with open(p, "r+b") as f:
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ (1 << rng.randrange(8))]))
    except OSError:
        return None
    return p


def write_plan(data_dir: str, plan: dict) -> str:
    """Write/replace a node's ``disk.json`` fault plan (atomic, real);
    a LIVE FaultyIO picks it up on the next write/fsync poll."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, "disk.json")
    atomic_write(path, json.dumps(plan).encode())
    return path


def read_disk_stats(data_dir: str) -> dict:
    """The FaultyIO's published fault counters (empty when absent)."""
    try:
        with open(os.path.join(data_dir, "disk-stats.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}
