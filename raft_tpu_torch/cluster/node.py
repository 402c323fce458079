"""The host-level replica: one Raft role machine per OS process (port of
``raft_tpu/cluster/node.py``; its WAL records, vote file, commit digest and
``ctrl-<id>.json`` deny-lists are the JAX package's byte for byte).

This is the cluster counterpart of ``raft.engine.RaftEngine``. The
in-process engines replicate by device collectives inside ONE process;
a :class:`RaftNode` replicates by ``PEER_*`` frames over TCP — real
AppendEntries, real RequestVote, a real commit quorum counted from
real sockets — so the fault model finally includes the one thing the
torture harness could never drive before: the OS killing a replica.

Design decisions, and why:

- **Pure host state machine.** Roles, timers, the log, and the KV live
  in plain Python on the event-loop thread; no device state, no
  threads, no locks. Frames arrive on reader tasks and are handled
  synchronously (:meth:`on_peer_frame` returns the reply frames for
  the same connection); timers advance in :meth:`tick`, driven by the
  child's ticker task and by the ingest pump's ``drive``. One replica
  per process means the per-replica work is a handful of dict ops per
  frame — the wire, not the CPU, is the bound.
- **The log is a list; acked entries are WAL'd; cold history is the
  tiered store.** The authoritative log (including the uncommitted
  tail) is a RAM list of ``(term, record)``, but every entry this
  node ever lets a QUORUM count — entries a follower acknowledges in
  an append reply, entries the leader counts as its own quorum
  member — is first appended to a flat, per-record-CRC'd write-ahead
  log (``wal.bin``, fsynced before the ack; group commit coalesces
  the fsyncs of one ingest sweep) in the node's data dir. Raft's
  commit safety assumes voters keep their acked log across restarts;
  without the WAL a single ``kill -9`` of one replica could roll an
  acked quorum back below a committed entry and elect a leader
  missing a client-acked write. Every durable byte goes through the
  ``cluster/storage.py`` VFS seam, so the nemesis plane can swap in
  a lying disk (torn writes, bit rot, EIO, ENOSPC, stalls) under
  the real recovery paths; fsync EIO FAIL-STOPS the node with a
  death certificate — never a retry (docs/CLUSTER.md). Every COMMITTED
  entry is additionally mirrored into a :class:`TieredStore`, whose
  sweep seals cold segments to disk as RS-coded shards; the WAL is
  rotated down to the unsealed suffix as sealing advances, so it
  stays one hot-tier long. A restarted node adopts the prior
  generation's sealed segments by manifest (``adopt=True`` — zero
  re-seals), replays them into the KV, replays
  the WAL suffix into the LOG (not the KV: the commit watermark is
  re-derived from leader contact, never guessed), and streams any
  remainder via the resumable catch-up stream, which resumes from
  the sealed floor because ``PEER_HELLO`` carries it.
- **ReadIndex over heartbeat rounds.** Every append carries the
  leader's ``round_no``; followers echo it. A linearizable read mints
  a ticket pinned at (commit, round+1); a majority of SUCCESSFUL
  echoes at or past that round certifies leadership after the ticket
  was minted — the same confirmation rule as docs/READS.md, carried
  peer-to-peer. A leader holding a fresh majority serves reads with
  zero waiting; the lease clock runs from the SEND time of the acked
  round (never reply arrival, so RTT cannot stretch the window), and
  the lease bound itself rests on vote stickiness: a follower in
  live leader contact ignores RequestVote for the minimum election
  timeout (§4.2.3), so no rival can be elected inside a lease whose
  duration is clamped strictly below that timeout. Neither leases
  nor ReadIndex tickets are honored until an entry of the leader's
  CURRENT term has committed (the §6.4 / §8 fresh-leader rule): a
  new leader's commit may lag writes its predecessor already acked.
- **Partitions are deny-lists.** The process nemesis writes
  ``ctrl-<id>.json`` (``{"deny": [peer ids]}``) into the node dir; the
  node polls it each tick and drops matching traffic both ways. No
  root, no iptables — and heals by deleting the file.

Record format (``REC_BYTES`` fixed): ``u8 klen | key | u16 vlen |
value``, zero-padded; ``klen == 0`` is the leadership noop. Fixed-size
records keep the TieredStore's entry math trivial and match the
engine's fixed ``entry_bytes`` convention.
"""

from __future__ import annotations

import collections
import errno
import json
import os
import random
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.admission.gate import Overloaded
from raft_tpu_torch.ckpt.tiered import TieredStore
from raft_tpu_torch.cluster import storage as vfs
from raft_tpu_torch.cluster.storage import DiskFailStop, DiskFull, RealIO
from raft_tpu_torch.errors import NotLeader, ReadLagging
from raft_tpu_torch.net import protocol as P
from raft_tpu_torch.net.server import _Done, _Pending
from raft_tpu_torch.obs import blackbox

REC_BYTES = 64

# wal.bin record: kind (1 = append) | index | term | crc32 | payload.
# The CRC covers header-sans-crc + payload, so replay can tell a torn
# or bit-rotted record from a valid one anywhere in the file — not
# just at the tail — and truncate to the last valid prefix.
_WAL_REC = struct.Struct("!BQII")
_WAL_HDR = struct.Struct("!BQI")
_WAL_APPEND = 1

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


def pack_record(key: bytes, value: bytes,
                rec_bytes: int = REC_BYTES) -> bytes:
    if 3 + len(key) + len(value) > rec_bytes:
        raise ValueError("record overflow")
    rec = struct.pack("!B", len(key)) + key + struct.pack(
        "!H", len(value)) + value
    return rec + b"\x00" * (rec_bytes - len(rec))


def unpack_record(rec: bytes) -> Optional[Tuple[bytes, bytes]]:
    klen = rec[0]
    if klen == 0:
        return None                                  # leadership noop
    key = rec[1:1 + klen]
    (vlen,) = struct.unpack_from("!H", rec, 1 + klen)
    return key, rec[3 + klen:3 + klen + vlen]


class RaftNode:
    """One replica process's consensus state + the ingest-server
    backend surface (module docstring).

    ``peers`` maps EVERY node id (including ``node_id``) to its
    ``"host:port"`` wire address — the single port each process serves
    clients AND peers on; ``leader_hint`` returns the believed
    leader's address verbatim, which is what lets a client redial past
    loopback."""

    def __init__(
        self,
        node_id: int,
        peers: Dict[int, str],
        data_dir: str,
        *,
        heartbeat_s: float = 0.05,
        election_timeout_s: float = 0.3,
        lease_s: Optional[float] = None,
        max_append: int = 64,
        snap_chunk: int = 128,
        snap_threshold: Optional[int] = None,
        hot_entries: int = 256,
        segment_entries: int = 64,
        seed: Optional[int] = None,
        wal_fsync: bool = True,
        io=None,
        wal_group_commit: bool = False,
        digest_every: int = 16,
    ):
        self.node_id = node_id
        self.peers = dict(peers)
        self.others = sorted(p for p in self.peers if p != node_id)
        self.majority = len(self.peers) // 2 + 1
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.hb_s = heartbeat_s
        self.timeout_base = election_timeout_s
        # the lease is only sound strictly inside the vote-stickiness
        # window (the MINIMUM election timeout, measured from append
        # SEND time) — clamp rather than trust configuration
        want_lease = lease_s if lease_s is not None else 4 * heartbeat_s
        self.lease_s = min(want_lease, 0.8 * election_timeout_s)
        self.wal_fsync = wal_fsync
        self.wal_group_commit = wal_group_commit
        self.max_append = max_append
        self.snap_chunk = snap_chunk
        self.snap_threshold = (snap_threshold if snap_threshold is not None
                               else 2 * snap_chunk)
        self._rng = random.Random(seed if seed is not None
                                  else (os.getpid() << 8) | node_id)

        # ------------------------------------------------- durable state
        # every durable byte this node writes goes through ONE storage
        # backend — the seam the nemesis plane swaps a lying disk into
        self._io = io if io is not None else RealIO()
        self.failed = False      # fail-stopped on an unknowable disk
        self.term = 0
        self.voted_for: Optional[int] = None
        self.generation = 1
        self.store = TieredStore(
            REC_BYTES, os.path.join(data_dir, "segments"),
            hot_entries=hot_entries, segment_entries=segment_entries,
            adopt=True, io_backend=self._io,
        )
        self._load_vote()

        # -------------------------------------------------- volatile state
        self.role = FOLLOWER
        self.leader_id: Optional[int] = None
        self.log: List[Tuple[int, bytes]] = []       # log[0] = index 1
        self.kv: Dict[bytes, bytes] = {}
        self.commit = 0
        self.applied = 0
        self._wal_path = os.path.join(data_dir, "wal.bin")
        self._wal_f = None       # opened by _wal_rewrite in replay
        self._wal_hi = 0         # highest index FSYNC-durable in the WAL
        self._wal_written = 0    # highest index written (maybe unsynced)
        self._wal_records = 0    # records in the file (rotation clock)
        self._wal_deferred: List[Tuple] = []   # acks gated on the fsync
        # the wal_skip_corrupt broken variant: replay SKIPS a corrupt
        # record instead of truncating — the classic recovery bug the
        # commit-digest plane exists to catch (env-gated so only the
        # nemesis drill can arm it)
        self._wal_skip_corrupt = bool(
            os.environ.get("RAFT_TPU_WAL_SKIP_CORRUPT"))
        # the lease_stale_round broken variant: append replies credit
        # lease evidence at ARRIVAL time regardless of which round they
        # echo — the bug the round-stamped lease clock exists to
        # prevent (a delayed or replayed reply stretches the lease past
        # a rival's election). Env-gated so only the network-nemesis
        # drill can arm it.
        self._lease_stale_round = bool(
            os.environ.get("RAFT_TPU_LEASE_STALE_ROUND"))
        # commit-digest audit plane: a rolling crc32 over every applied
        # (idx, term, record), checkpointed at fixed indices — replicas
        # applying the same prefix MUST agree byte-for-byte, so any
        # recovery path that silently diverges the log trips this even
        # when Raft's (index, term) checks all pass
        self.digest_every = max(1, digest_every)
        self._digest = 0
        self._digest_ckpts: collections.deque = collections.deque(
            maxlen=8)
        self.stats: Dict[str, int] = {
            "elections": 0, "terms_won": 0, "appends_in": 0,
            "appends_out": 0, "snap_chunks_in": 0, "snap_chunks_out": 0,
            "reads_lease": 0, "reads_read_index": 0, "denied_frames": 0,
            "wal_fsyncs": 0, "wal_truncated_records": 0,
            "wal_skipped_corrupt": 0, "disk_full_shed": 0,
            "peer_frames_corrupt": 0, "leader_demotions": 0,
            "stale_round_ignored": 0,
        }
        self._replay_adopted()

        now = time.monotonic()
        self.last_heard = now
        self.timeout = self._new_timeout()
        self.outbox: List[Tuple[int, bytes]] = []    # (peer id, frame)
        # the partition plan (net.json deny keys + the legacy
        # ctrl-<id>.json alias): `deny` blocks both directions,
        # `deny_to` only our sends, `deny_from` only our receives —
        # the asymmetric halves a real one-directional blackhole needs
        self.deny: set = set()
        self.deny_to: set = set()
        self.deny_from: set = set()
        self._plan_mtimes: Tuple = (None, None)

        # leader bookkeeping (reset on every election win)
        self._lead_since = now   # CheckQuorum grace floor (see tick)
        self.next_idx: Dict[int, int] = {}
        self.match_idx: Dict[int, int] = {}
        self.hb_round = 0
        self.peer_round: Dict[int, int] = {}     # highest echoed round
        self.ack_at: Dict[int, float] = {}       # SEND time of the
        #   freshest successfully acked round per peer — the lease
        #   clock runs from when the append left, not when the reply
        #   arrived, so RTT can only SHRINK the lease, never stretch it
        self._round_sent: Dict[int, float] = {}  # round -> send stamp
        self.last_hb = 0.0
        self.snap_mode: set = set()              # peers in catch-up stream
        self._snap_sent: Dict[int, float] = {}   # last chunk send time
        self.votes: set = set()
        self._dirty = False      # un-broadcast appended entries exist
        self._reads: Dict[int, Tuple[int, int, bytes]] = {}
        self._next_ticket = 1
        self._submit_terms: Dict[int, int] = {}  # seq -> term at submit

    # ----------------------------------------------------- durable state
    def _vote_path(self) -> str:
        return os.path.join(self.data_dir, "vote.json")

    def _persist_vote(self) -> None:
        self._io.atomic_write(self._vote_path(), json.dumps({
            "term": self.term, "voted_for": self.voted_for,
            "generation": self.generation,
        }).encode())

    def _load_vote(self) -> None:
        try:
            with open(self._vote_path()) as f:
                v = json.load(f)
            self.term = int(v["term"])
            self.voted_for = v["voted_for"]
            self.generation = int(v.get("generation", 0)) + 1
        except (OSError, ValueError, KeyError):
            pass
        self._persist_vote()

    def _replay_adopted(self) -> None:
        """Rebuild log + KV from the adopted sealed prefix, then the
        log (NOT the KV) from the WAL suffix.

        The sealed prefix is committed by construction (only committed
        entries are ever mirrored to the store), so it replays into
        both log and KV and sets the commit/applied floor. The WAL
        holds every entry this node ever let a quorum count — acked
        appends, the leader's own quorum share — including entries
        that were still uncommitted at the kill: those replay into the
        LOG ONLY, with replace semantics for logged conflict
        truncations, and the commit watermark is re-derived from
        leader contact. This is the invariant Raft's commit safety
        stands on: a voter's acked log survives restart, so a restart
        can never roll a commit quorum back below a client-acked
        entry."""
        hi = self.store._sealed_hi
        for i in range(1, hi + 1):
            got = self.store.get(i)
            if got is None:        # segment lost below k shards: the
                break              # stream re-replicates from here
            rec, term = got
            self.log.append((term, rec))
            kvv = unpack_record(rec)
            if kvv is not None:
                self.kv[kvv[0]] = kvv[1]
            self.commit = self.applied = i
            self._digest_update(i, term, rec)
        self.log = self.log[: self.commit]
        for idx, term, rec in self._wal_scan():
            if idx <= self.commit:
                continue               # sealed prefix is authoritative
            if self._wal_skip_corrupt:
                # BROKEN (drill-armed): blind append — a skipped corrupt
                # record shifts every later record down one index, and
                # Raft's (index, term) checks cannot see it. Only the
                # commit-digest plane can.
                self.log.append((term, rec))
                continue
            if idx > self.last_idx + 1:
                break                  # torn tail: stream re-replicates
            if idx <= self.last_idx:
                del self.log[idx - 1:]     # a logged truncation
            self.log.append((term, rec))
        self.store.apply_cursor = self.applied
        # normalize: drop stale replace records and any torn tail, and
        # leave an open append handle at the live suffix
        self._wal_rewrite(self.commit)

    # ------------------------------------------------- write-ahead log
    def _wal_pack(self, i: int) -> bytes:
        term, rec = self.log[i - 1]
        hdr = _WAL_HDR.pack(_WAL_APPEND, i, term)
        return _WAL_REC.pack(_WAL_APPEND, i, term,
                             zlib.crc32(hdr + rec)) + rec

    def _wal_scan(self):
        """Yield ``(idx, term, rec)`` append records; stops at the
        first record whose CRC does not verify — torn tail, mid-file
        bit rot, or unknown kind alike — truncating replay to the last
        valid prefix. NEVER skips past corruption: a skipped record
        shifts every later index and silently diverges the log (the
        ``wal_skip_corrupt`` broken variant exists to prove the digest
        plane catches exactly that)."""
        try:
            blob = self._io.read_bytes(self._wal_path)
        except OSError:
            return
        off, step = 0, _WAL_REC.size + REC_BYTES
        while off + step <= len(blob):
            kind, idx, term, crc = _WAL_REC.unpack_from(blob, off)
            rec = blob[off + _WAL_REC.size: off + step]
            ok = (kind == _WAL_APPEND
                  and crc == zlib.crc32(_WAL_HDR.pack(kind, idx, term)
                                        + rec))
            if not ok:
                if self._wal_skip_corrupt:       # BROKEN (drill-armed)
                    self.stats["wal_skipped_corrupt"] += 1
                    off += step
                    continue
                self.stats["wal_truncated_records"] += (
                    len(blob) - off) // step
                blackbox.mark("wal_truncate", node=self.node_id,
                              at_record=off // step)
                return
            yield idx, term, rec
            off += step

    def _wal_rewrite(self, keep_above: int) -> None:
        """Rewrite the WAL to exactly ``log[keep_above:]`` (atomic),
        then reopen for appending — the rotation and the restart
        normalization share this path."""
        if self._wal_f is not None:
            self._wal_f.close()
        blob = b"".join(
            self._wal_pack(i)
            for i in range(keep_above + 1, self.last_idx + 1)
        )
        self._io.atomic_write(self._wal_path, blob)
        self._wal_f = self._io.open_append(self._wal_path)
        self._wal_records = self.last_idx - keep_above
        self._wal_hi = self._wal_written = self.last_idx
        if self.wal_fsync:
            self._wal_fsync_once("wal_rewrite")

    def _wal_fsync_once(self, where: str) -> None:
        """The ONLY fsync call site for the WAL handle. EIO here means
        the kernel may have dropped dirty pages we can never see again
        (the PostgreSQL fsyncgate lesson): the one sound response is
        FAIL-STOP — publish a death certificate and die — because a
        retried fsync that returns clean would certify bytes that are
        gone."""
        try:
            self._wal_f.fsync()
        except OSError as ex:
            if getattr(ex, "errno", None) == errno.EIO:
                self._fail_stop(where, ex)
            raise
        self.stats["wal_fsyncs"] += 1

    def _fail_stop(self, where: str, ex: BaseException) -> None:
        """Publish a death certificate (via a REAL write — the faulty
        seam must not get a second chance to lie about it) and refuse
        all further work. The supervisor reads the certificate to tell
        'disk genuinely broken' from 'crashed while recovering'."""
        self.failed = True
        try:
            vfs.atomic_write(
                os.path.join(self.data_dir, "death.json"),
                json.dumps({
                    "node": self.node_id, "pid": os.getpid(),
                    "where": where, "errno": getattr(ex, "errno", None),
                    "error": str(ex), "term": self.term,
                    "commit": self.commit, "wal_hi": self._wal_hi,
                    "ts": time.time(),
                }).encode())
        except OSError:
            pass
        blackbox.mark("disk_fail_stop", node=self.node_id, where=where,
                      error=str(ex))
        raise DiskFailStop(f"{where}: {ex}") from ex

    def _wal_extend(self, upto: int, *, defer: bool = False) -> bool:
        """Write ``log[.. upto]`` into the WAL. With ``defer`` False
        the records are fsynced before returning (one fsync per call —
        per frame / per broadcast, not per entry) and the result is
        True. With ``defer`` True (group commit) the write lands but
        the fsync is left for :meth:`flush_wal`, which the peer
        backend schedules once per ingest sweep — every frame handled
        in the sweep shares ONE fsync, and every ack gated on it is
        withheld until that fsync returns. Raises :class:`DiskFull`
        with nothing acked when the disk refuses the write."""
        if upto > self._wal_written:
            self._wal_f.write(b"".join(
                self._wal_pack(i)
                for i in range(self._wal_written + 1, upto + 1)
            ))
            self._wal_records += upto - self._wal_written
            self._wal_written = upto
        if self._wal_written <= self._wal_hi:
            return True                      # already durable
        if defer and self.wal_group_commit:
            return False
        self._wal_sync()
        return True

    def _wal_sync(self) -> None:
        """Promote everything written to fsync-durable, then rotate if
        sealing has moved the durable floor past most of the file."""
        if self.wal_fsync:
            self._wal_fsync_once("wal_fsync")
        self._wal_hi = self._wal_written
        # rotation: sealing moved the durable floor up — shed the
        # sealed prefix (and accumulated replace records) once the
        # file is mostly history
        sealed = self.store._sealed_hi
        if self._wal_records > 2 * max(1, self.last_idx - sealed) + 256:
            self._wal_rewrite(sealed)

    def flush_wal(self) -> List[Tuple[int, bytes]]:
        """Group commit's release point: ONE fsync promotes every
        record written since the last flush, then the acks that were
        deferred on it are built and returned as ``(peer, frame)``
        pairs. Acks stamped with a superseded term are dropped — the
        reply would be rejected anyway, and the entries it vouched for
        may have been truncated by the new term's appends."""
        if self.failed:
            raise DiskFailStop("node has fail-stopped")
        if self._wal_written > self._wal_hi:
            self._wal_sync()
        if not self._wal_deferred:
            return []
        out: List[Tuple[int, bytes]] = []
        for term, peer, tag, a, b in self._wal_deferred:
            if term != self.term:
                continue
            if tag == "append":
                out.append((peer, P.encode_peer_append_reply(
                    self.node_id, self.term, True, a, b)))
            else:
                out.append((peer, P.encode_peer_snap_ack(
                    self.node_id, self.term, a)))
        self._wal_deferred = []
        return out

    def wal_flush_pending(self) -> bool:
        return (self._wal_written > self._wal_hi
                or bool(self._wal_deferred))

    # -------------------------------------------------------- log helpers
    @property
    def last_idx(self) -> int:
        return len(self.log)

    def term_at(self, idx: int) -> int:
        if idx == 0:
            return 0
        return self.log[idx - 1][0]

    def _new_timeout(self) -> float:
        return self.timeout_base * (1.0 + self._rng.random())

    # ------------------------------------------------------------- timers
    def tick(self, now: float) -> None:
        if self.failed:
            # fail-stopped: the ticker must see this and exit the
            # process — a node whose disk state is unknowable serves
            # nothing, votes for nothing, acks nothing
            raise DiskFailStop("node has fail-stopped")
        self._poll_ctrl()
        if self.role == LEADER:
            if self._dirty or now - self.last_hb >= self.hb_s:
                self._broadcast_appends(now, heartbeat=True)
                self._dirty = False
            self._advance_commit(now)
            self._check_quorum(now)
        elif now - self.last_heard >= self.timeout:
            self._start_election(now)

    def _check_quorum(self, now: float) -> None:
        """CheckQuorum: a leader whose REPLY quorum — the majority-th
        freshest successful append ack, the exact evidence the lease
        counts — has been stale for a full election timeout steps
        down. Under an asymmetric partition (our appends deliver, the
        replies blackhole) the followers still hear a live leader, so
        vote stickiness keeps suppressing elections and a send-only
        leader would wedge the cluster forever: it can neither commit
        (no acks) nor be replaced (no timeouts). Demoting on stale
        acks breaks the wedge — the ex-leader goes silent, follower
        timers expire, a connected majority elects. ``_lead_since``
        floors every peer's ack age so a fresh leader gets one full
        timeout of grace before its first demotion check; the lease
        itself still runs on raw ``ack_at`` (never seeded — a floor
        there would fabricate lease evidence)."""
        if self.majority < 2:
            return
        ages = sorted(
            now - max(self.ack_at.get(p, -1e9), self._lead_since)
            for p in self.others)
        if ages[self.majority - 2] <= self.timeout_base:
            return
        self.stats["leader_demotions"] += 1
        blackbox.mark("leader_demote", node=self.node_id,
                      term=self.term,
                      stale_s=round(ages[self.majority - 2], 3))
        self._step_down(self.term, now)
        # drop the self-belief too: stickiness must not make this node
        # refuse the very election its demotion exists to allow
        self.leader_id = None

    def _poll_ctrl(self) -> None:
        """Poll the partition plan: ``net.json`` (the merged network
        fault plan — deny keys are its symmetric-deny special case)
        plus the legacy ``ctrl-<id>.json`` alias, union'd so existing
        drills run unchanged."""
        paths = (os.path.join(self.data_dir, "net.json"),
                 os.path.join(self.data_dir,
                              f"ctrl-{self.node_id}.json"))
        mtimes = []
        for path in paths:
            try:
                mtimes.append(os.stat(path).st_mtime)
            except OSError:
                mtimes.append(None)
        if tuple(mtimes) == self._plan_mtimes:
            return
        self._plan_mtimes = tuple(mtimes)
        deny: set = set()
        deny_to: set = set()
        deny_from: set = set()
        for path in paths:
            try:
                with open(path) as f:
                    plan = json.load(f)
            except (OSError, ValueError):
                continue
            deny |= set(plan.get("deny", []))
            deny_to |= set(plan.get("deny_to", []))
            deny_from |= set(plan.get("deny_from", []))
        if (deny, deny_to, deny_from) == (
                self.deny, self.deny_to, self.deny_from):
            return
        self.deny, self.deny_to, self.deny_from = deny, deny_to, deny_from
        if deny or deny_to or deny_from:
            blackbox.mark("ctrl_deny", node=self.node_id,
                          deny=sorted(deny), deny_to=sorted(deny_to),
                          deny_from=sorted(deny_from))
        else:
            blackbox.mark("ctrl_heal", node=self.node_id)

    # ---------------------------------------------------------- elections
    def _start_election(self, now: float) -> None:
        self.term += 1
        self.role = CANDIDATE
        self.voted_for = self.node_id
        self.leader_id = None
        self._persist_vote()
        self.votes = {self.node_id}
        self.last_heard = now
        self.timeout = self._new_timeout()
        self.stats["elections"] += 1
        blackbox.mark("election_start", node=self.node_id,
                      term=self.term)
        for p in self.others:
            self._to(p, P.encode_peer_vote(
                self.node_id, self.term, self.last_idx,
                self.term_at(self.last_idx),
            ))

    def _become_leader(self, now: float) -> None:
        self.role = LEADER
        self.leader_id = self.node_id
        self._lead_since = now
        self.stats["terms_won"] += 1
        self.next_idx = {p: self.last_idx + 1 for p in self.others}
        self.match_idx = {p: 0 for p in self.others}
        self.hb_round = 0
        self.peer_round = {p: 0 for p in self.others}
        self.ack_at = {}
        self._round_sent = {}
        self.snap_mode = set()
        self._snap_sent = {}
        blackbox.mark("leader_won", node=self.node_id, term=self.term)
        # the noop: commits an entry of the CURRENT term, which is what
        # lets _advance_commit move the watermark over prior-term tails
        self.log.append((self.term, pack_record(b"", b"")))
        self._broadcast_appends(now, heartbeat=True)

    def _step_down(self, term: int, now: float) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_vote()
        if self.role != FOLLOWER:
            blackbox.mark("step_down", node=self.node_id, term=term)
        self.role = FOLLOWER
        self.last_heard = now
        self.timeout = self._new_timeout()

    # ------------------------------------------------------- leader sends
    def _broadcast_appends(self, now: float, heartbeat: bool = False
                           ) -> None:
        self.last_hb = now
        self.hb_round += 1
        # the round's send stamp: a successful echo of round R proves
        # the follower's election timer was reset no earlier than this
        # moment, so lease recency is measured from here (reply RTT
        # can only make the lease MORE conservative)
        self._round_sent[self.hb_round] = now
        self._round_sent.pop(self.hb_round - 4096, None)
        # the leader is a quorum member too: its own log share must be
        # WAL-durable before any follower ack can complete a commit
        try:
            self._wal_extend(self.last_idx)
        except DiskFull:
            # a full disk stalls the leader's OWN quorum share (it
            # stays at _wal_hi, so commit cannot ride un-persisted
            # entries) but heartbeats keep flowing — leadership is not
            # forfeited over ENOSPC
            self.stats["disk_full_shed"] += 1
        for p in self.others:
            if p in self.snap_mode:
                # the stream paces itself on acks — but a chunk (or its
                # ack) lost to a partition, drop, or process death would
                # stall it forever, so re-send from the recorded match
                # after a few silent heartbeats: resumable-by-match-index
                if now - self._snap_sent.get(p, 0.0) > 4 * self.hb_s:
                    self._send_snap_chunk(p)
                continue
            nxt = self.next_idx.get(p, self.last_idx + 1)
            if (self.commit - self.match_idx.get(p, 0)
                    > self.snap_threshold):
                self._start_snap(p)
                continue
            ents = [self.log[i - 1]
                    for i in range(nxt, min(self.last_idx,
                                            nxt + self.max_append - 1) + 1)]
            self._to(p, P.encode_peer_append(
                self.node_id, self.term, nxt - 1, self.term_at(nxt - 1),
                self.commit, self.hb_round, ents,
            ))
            self.stats["appends_out"] += 1

    def _start_snap(self, p: int) -> None:
        self.snap_mode.add(p)
        blackbox.mark("snap_stream_start", node=self.node_id, peer=p,
                      match=self.match_idx.get(p, 0), commit=self.commit)
        self._send_snap_chunk(p)

    def _send_snap_chunk(self, p: int) -> None:
        base = self.match_idx.get(p, 0) + 1
        hi = min(self.commit, base + self.snap_chunk - 1)
        if base > hi:
            self.snap_mode.discard(p)
            self.next_idx[p] = self.match_idx.get(p, 0) + 1
            return
        ents = [self.log[i - 1] for i in range(base, hi + 1)]
        self._to(p, P.encode_peer_snap_chunk(
            self.node_id, self.term, base, self.commit, self.commit,
            ents,
        ))
        self._snap_sent[p] = time.monotonic()
        self.stats["snap_chunks_out"] += 1

    def _advance_commit(self, now: float) -> None:
        if self.role != LEADER:
            return
        matches = sorted(
            [self.match_idx.get(p, 0) for p in self.others]
            # the leader's own quorum share is its WAL-DURABLE floor,
            # not its RAM tail: an entry submitted but not yet
            # broadcast (hence not yet fsynced) must not count
            + [min(self.last_idx, self._wal_hi)],
            reverse=True,
        )
        n = matches[self.majority - 1]
        if n > self.commit and self.term_at(n) == self.term:
            self.commit = n
            self._apply_committed()

    def _apply_committed(self) -> None:
        while self.applied < self.commit:
            self.applied += 1
            term, rec = self.log[self.applied - 1]
            kvv = unpack_record(rec)
            if kvv is not None:
                self.kv[kvv[0]] = kvv[1]
            self._digest_update(self.applied, term, rec)
            # mirror into the durable tier: only committed entries ever
            # reach the store, so adoption after a crash never resurrects
            # an uncommitted suffix
            self.store.apply_cursor = self.applied
            self.store.put(self.applied, rec, term=term)

    def _digest_update(self, idx: int, term: int, rec: bytes) -> None:
        """Fold one applied entry into the rolling commit digest and
        checkpoint at fixed indices — every replica that applied the
        same prefix holds the same digest at the same checkpoint, so
        the drill's cross-node comparison needs no synchronized
        snapshot, only one overlapping checkpoint index."""
        self._digest = zlib.crc32(
            struct.pack("!QI", idx, term) + rec, self._digest)
        if idx % self.digest_every == 0:
            self._digest_ckpts.append((idx, self._digest))

    # --------------------------------------------------------- lease math
    def _quorum_recency(self, now: float) -> float:
        """Age of the freshest MAJORITY of successful append acks,
        measured from the SEND time of each acked round (self counts
        as age 0). Below ``lease_s`` — clamped under the minimum
        election timeout — every member of that majority had its
        election timer reset inside the stickiness window, so no rival
        leader can have been elected: any vote quorum intersects this
        ack quorum, and the intersection refuses votes (``_on_vote``)
        until at least ``timeout_base`` past its timer reset."""
        ages = sorted(now - self.ack_at.get(p, -1e9) for p in self.others)
        return ages[self.majority - 2] if self.majority >= 2 else 0.0

    def has_lease(self, now: float) -> bool:
        return (self.role == LEADER
                and self._quorum_recency(now) < self.lease_s)

    # ------------------------------------------------------ inbound frames
    def on_peer_frame(self, kind: int, payload: bytes) -> List[bytes]:
        """Handle one peer frame; returns reply frames for the SAME
        connection. Called from reader tasks — same thread as tick."""
        now = time.monotonic()
        if self.failed:
            return []      # fail-stopped: the ticker is about to exit
        sender = struct.unpack_from("!I", payload)[0]
        if sender in self.deny or sender in self.deny_from:
            self.stats["denied_frames"] += 1
            return []
        if kind == P.PEER_VOTE:
            return self._on_vote(payload, now)
        if kind == P.PEER_VOTE_REPLY:
            return self._on_vote_reply(payload, now)
        if kind == P.PEER_APPEND:
            return self._on_append(payload, now)
        if kind == P.PEER_APPEND_REPLY:
            return self._on_append_reply(payload, now)
        if kind == P.PEER_SNAP_CHUNK:
            return self._on_snap_chunk(payload, now)
        if kind == P.PEER_SNAP_ACK:
            return self._on_snap_ack(payload, now)
        raise P.ProtocolError(f"unexpected peer frame kind {kind}")

    def on_peer_hello(self, peer_id: int, last_idx: int) -> List[bytes]:
        """An inbound peer identified itself; its durable floor seeds
        ``match`` so a restarted follower's catch-up stream starts at
        the adopted segments' edge, not at zero. The floor is
        AUTHORITATIVE downward too: a fresh hello advertising less than
        the recorded match means the peer restarted and lost its RAM
        tail — keeping the stale-high match would base every snapshot
        chunk past the follower's log forever (the ping-pong this
        branch exists to kill). Lowering match is always safe: it only
        delays commit advancement, never regresses it."""
        if self.role == LEADER and peer_id in self.match_idx:
            cur = self.match_idx[peer_id]
            if cur == 0 and last_idx > 0:
                self.match_idx[peer_id] = min(last_idx, self.commit)
                self.next_idx[peer_id] = self.match_idx[peer_id] + 1
            elif last_idx < cur:
                self.match_idx[peer_id] = last_idx
                self.next_idx[peer_id] = last_idx + 1
                # restart the stream from the REAL floor
                self.snap_mode.discard(peer_id)
        return []

    def _on_vote(self, payload: bytes, now: float) -> List[bytes]:
        cand, term, last_idx, last_term, _pv = P.decode_peer_vote(payload)
        if (self.role == FOLLOWER and self.leader_id is not None
                and now - self.last_heard < self.timeout_base):
            # §4.2.3 stickiness: a follower in live leader contact
            # ignores RequestVote outright — no term bump, no grant.
            # This is the other half of the lease bound (see
            # _quorum_recency): without it, a long-partitioned peer
            # could be elected by followers the leaseholder acked
            # moments ago, and a lease read would race the new
            # leader's first write
            return [P.encode_peer_vote_reply(self.node_id, self.term,
                                             False)]
        if term > self.term:
            self._step_down(term, now)
        up_to_date = (last_term, last_idx) >= (
            self.term_at(self.last_idx), self.last_idx)
        granted = (term == self.term
                   and self.voted_for in (None, cand)
                   and up_to_date)
        if granted:
            self.voted_for = cand
            self._persist_vote()
            self.last_heard = now
        return [P.encode_peer_vote_reply(self.node_id, self.term,
                                         granted)]

    def _on_vote_reply(self, payload: bytes, now: float) -> List[bytes]:
        voter, term, granted, _pv = P.decode_peer_vote_reply(payload)
        if term > self.term:
            self._step_down(term, now)
            return []
        if (self.role == CANDIDATE and term == self.term and granted):
            self.votes.add(voter)
            if len(self.votes) >= self.majority:
                self._become_leader(now)
        return []

    def _on_append(self, payload: bytes, now: float) -> List[bytes]:
        (leader, term, prev_idx, prev_term, commit, round_no,
         entries) = P.decode_peer_append(payload)
        self.stats["appends_in"] += 1
        if term < self.term:
            return [P.encode_peer_append_reply(
                self.node_id, self.term, False, self.last_idx, round_no)]
        self._step_down(term, now)
        self.leader_id = leader
        if prev_idx > self.last_idx or (
                prev_idx > 0 and self.term_at(prev_idx) != prev_term):
            # divergent / missing prefix: reply our last index as the
            # rewind hint (one round per divergent tail)
            return [P.encode_peer_append_reply(
                self.node_id, self.term, False,
                min(self.last_idx, prev_idx - 1), round_no)]
        idx = prev_idx
        for ent_term, rec in entries:
            idx += 1
            if idx <= self.last_idx:
                if self.log[idx - 1][0] == ent_term:
                    continue
                del self.log[idx - 1:]       # conflict: truncate suffix
                self._wal_hi = min(self._wal_hi, idx - 1)
                self._wal_written = min(self._wal_written, idx - 1)
            self.log.append((ent_term, rec))
        match = prev_idx + len(entries)
        # durable BEFORE the ack: the reply lets the leader count this
        # log into a commit quorum, so it must survive our kill -9
        try:
            synced = self._wal_extend(self.last_idx, defer=True)
        except DiskFull:
            # nothing was persisted and nothing may be acked: report
            # our durable floor so the leader retries from there
            self.stats["disk_full_shed"] += 1
            return [P.encode_peer_append_reply(
                self.node_id, self.term, False,
                min(self._wal_hi, prev_idx), round_no)]
        if commit > self.commit:
            # clamp to the last entry THIS append validated, not
            # last_idx: a retained tail past `match` has not been
            # term-checked against the leader yet (§5.3's "index of
            # last new entry" rule)
            self.commit = min(commit, match)
            self._apply_committed()
        if not synced:
            # group commit: the ack waits for the sweep's shared fsync
            self._wal_deferred.append(
                (self.term, leader, "append", match, round_no))
            return []
        return [P.encode_peer_append_reply(
            self.node_id, self.term, True, match, round_no)]

    def _on_append_reply(self, payload: bytes, now: float) -> List[bytes]:
        (follower, term, ok, match_idx, round_no
         ) = P.decode_peer_append_reply(payload)
        if term > self.term:
            self._step_down(term, now)
            return []
        if self.role != LEADER or term != self.term:
            return []
        if ok:
            # leadership evidence (lease clock, ReadIndex round
            # certification) rides SUCCESSFUL replies only — a
            # log-mismatch reply proves nothing about what the
            # follower accepted — and the lease clock records the
            # SEND stamp of the acked round, so reply latency can
            # never stretch the window past a partitioned peer's
            # earliest legal election
            sent = self._round_sent.get(round_no)
            if self._lease_stale_round:
                # BROKEN (chaos drill): clock leadership evidence off
                # REPLY ARRIVAL, any round. A reply delayed in flight —
                # or replayed by the network across a redial — from a
                # long-superseded round now refreshes the lease as if
                # the follower acked just now, so a deposed leader can
                # keep serving "lease" reads the new leader has already
                # overwritten. The per-class checker catches the stale
                # read.
                self.ack_at[follower] = now
            elif sent is None:
                # round too old to have a send stamp (pruned) or never
                # sent by THIS leadership: a duplicated/reordered reply
                # proves nothing about recency — count and ignore
                self.stats["stale_round_ignored"] += 1
            elif sent > self.ack_at.get(follower, -1e9):
                self.ack_at[follower] = sent
            elif round_no <= self.peer_round.get(follower, 0):
                self.stats["stale_round_ignored"] += 1
            if round_no > self.peer_round.get(follower, 0):
                self.peer_round[follower] = round_no
            if match_idx > self.match_idx.get(follower, 0):
                self.match_idx[follower] = match_idx
            self.next_idx[follower] = max(
                self.next_idx.get(follower, 1), match_idx + 1)
            self._advance_commit(now)
        else:
            self.next_idx[follower] = max(1, min(
                self.next_idx.get(follower, 1) - 1, match_idx + 1))
        return []

    def _on_snap_chunk(self, payload: bytes, now: float) -> List[bytes]:
        (leader, term, base, _total, commit, entries
         ) = P.decode_peer_snap_chunk(payload)
        self.stats["snap_chunks_in"] += 1
        if term < self.term:
            return []
        self._step_down(term, now)
        self.leader_id = leader
        if base > self.last_idx + 1:
            # a gap (we restarted mid-stream and lost the RAM tail):
            # re-ack the COMMITTED floor — committed entries are the
            # only prefix guaranteed to match the leader's log, so
            # that is the largest match we may claim unvalidated
            return [P.encode_peer_snap_ack(self.node_id, self.term,
                                           self.commit)]
        # the chunk overlaps (or extends) our log: term-check the
        # overlap exactly like AppendEntries. A follower whose log
        # extends past the base with a deposed leader's uncommitted
        # tail must truncate at the first conflicting term — never
        # re-ack that tail as matched
        idx = base - 1
        for ent_term, rec in entries:
            idx += 1
            if idx <= self.last_idx:
                if self.log[idx - 1][0] == ent_term:
                    continue
                del self.log[idx - 1:]       # conflict: truncate suffix
                self._wal_hi = min(self._wal_hi, idx - 1)
                self._wal_written = min(self._wal_written, idx - 1)
            self.log.append((ent_term, rec))
        validated = base - 1 + len(entries)
        # durable BEFORE the ack (the leader treats snap acks as
        # authoritative match — a quorum count may ride on this)
        try:
            synced = self._wal_extend(self.last_idx, defer=True)
        except DiskFull:
            # ack nothing: the stream re-sends the chunk after a few
            # silent heartbeats, by which time the disk may have room
            self.stats["disk_full_shed"] += 1
            return []
        if commit > self.commit:
            # clamp to the chunk's end: a retained tail past it has
            # not been term-checked against the leader yet
            self.commit = min(commit, validated)
            self._apply_committed()
        # the ack claims exactly the VALIDATED prefix, never a raw
        # last_idx that may include an unchecked suffix
        if not synced:
            self._wal_deferred.append(
                (self.term, leader, "snap",
                 max(validated, self.commit), 0))
            return []
        return [P.encode_peer_snap_ack(self.node_id, self.term,
                                       max(validated, self.commit))]

    def _on_snap_ack(self, payload: bytes, now: float) -> List[bytes]:
        follower, term, match_idx = P.decode_peer_snap_ack(payload)
        if term > self.term:
            self._step_down(term, now)
            return []
        if self.role != LEADER or term != self.term:
            return []
        # no ack_at refresh here: snap acks carry no round number, so
        # there is no send stamp to clock a lease from — a streaming
        # peer contributes catch-up progress, not lease evidence
        if follower in self.snap_mode:
            # a snap ack carries the follower's literal last_idx — it
            # is AUTHORITATIVE, downward included: a follower that
            # restarted mid-stream reports the floor it really has,
            # and the next chunk must base there or loop forever
            self.match_idx[follower] = match_idx
        elif match_idx > self.match_idx.get(follower, 0):
            self.match_idx[follower] = match_idx
        self._advance_commit(now)
        if follower in self.snap_mode:
            if self.match_idx[follower] >= self.commit:
                self.snap_mode.discard(follower)
                self.next_idx[follower] = self.match_idx[follower] + 1
                blackbox.mark("snap_stream_done", node=self.node_id,
                              peer=follower, match=match_idx)
            else:
                self._send_snap_chunk(follower)
        return []

    def _to(self, peer: int, frame: bytes) -> None:
        if peer in self.deny or peer in self.deny_to:
            self.stats["denied_frames"] += 1
            return
        self.outbox.append((peer, frame))

    # ===================================================== backend surface
    # the ingest-server duck type (net/server.py): the SAME wire tier
    # that fronts the in-process engines serves this node to clients.
    @property
    def heartbeat_s(self) -> float:
        return self.hb_s

    def now(self) -> float:
        return time.monotonic()

    def drive(self, seconds: float) -> None:
        # real clock: one timer pass per pump iteration (the ticker
        # task paces the idle path; reader tasks already handled frames)
        self.tick(time.monotonic())

    def meta(self) -> Tuple[int, int]:
        return REC_BYTES, 1

    def leader_hint(self, group: int) -> str:
        lid = self.leader_id
        return "" if lid is None else self.peers.get(lid, "")

    def submit(self, key: bytes, value: bytes, client=None
               ) -> Tuple[int, int]:
        if self.role != LEADER:
            raise NotLeader(0, "not the leader")
        if self._io.is_full():
            # ENOSPC is a SHED, never a corruption: refuse typed (the
            # ingest tier turns Overloaded into a REFUSED frame with a
            # retry hint) rather than accept an entry whose WAL write
            # is known to fail
            self.stats["disk_full_shed"] += 1
            raise Overloaded("disk_full", retry_after_s=4 * self.hb_s)
        self.log.append((self.term, pack_record(key, value)))
        # remember WHICH entry was promised at this index: durability
        # must later be certified for this term's entry, not whatever
        # a successor leader committed at the same index
        self._submit_terms[self.last_idx] = self.term
        self._dirty = True       # next tick broadcasts without waiting
        return 0, self.last_idx

    def is_durable(self, group: int, seq: int) -> bool:
        want = self._submit_terms.get(seq)
        if want is not None and (seq > self.last_idx
                                 or self.term_at(seq) != want):
            # the submitted entry was truncated or replaced across a
            # leadership change: it can never commit, and `commit >=
            # seq` now certifies a DIFFERENT entry — acking it would
            # be a durability lie to the client
            self._submit_terms.pop(seq, None)
            raise NotLeader(0, "entry lost to a leadership change")
        if self.commit >= seq:
            self._submit_terms.pop(seq, None)
            return True
        return False

    def commit_floor(self, group: int) -> int:
        return self.commit

    def begin_read(self, cls: str, key: bytes, session: Dict[int, int],
                   client=None):
        now = time.monotonic()
        if cls == "session":
            floor = session.get(0, 0)
            if self.applied < floor:
                raise ReadLagging(0, None, floor - self.applied,
                                  retry_after_s=self.hb_s)
            return _Done(0, self.applied, "session", self.kv.get(key))
        if self.role != LEADER:
            raise NotLeader(0, "reads need the leader")
        if self.term_at(self.commit) != self.term:
            # fresh leader: until an entry of THIS term commits, the
            # commit watermark may lag writes the previous leader
            # already acked — a read pinned here could miss them (the
            # ReadIndex precondition, §6.4 / §8). The leadership noop
            # commits within a round; the client retries after it
            raise ReadLagging(0, None, 1, retry_after_s=self.hb_s)
        if self.has_lease(now):
            self.stats["reads_lease"] += 1
            return _Done(0, self.applied, "lease", self.kv.get(key))
        ticket = self._next_ticket
        self._next_ticket += 1
        # certify: a majority must echo a round minted AFTER this point
        self._reads[ticket] = (self.commit, self.hb_round + 1, key)
        return _Pending(ticket)

    def poll_read(self, handle):
        got = self._reads.get(handle)
        if got is None:
            raise NotLeader(0, "read ticket lost to a leadership change")
        read_idx, need_round, key = got
        if self.role != LEADER:
            self._reads.pop(handle, None)
            raise NotLeader(0, "stepped down mid-read")
        echoes = sum(1 for p in self.others
                     if self.peer_round.get(p, 0) >= need_round)
        if echoes + 1 < self.majority or self.applied < read_idx:
            return None
        self._reads.pop(handle, None)
        self.stats["reads_read_index"] += 1
        return _Done(0, read_idx, "read_index", self.kv.get(key))

    def staging_stats(self):
        return None

    def status(self) -> dict:
        return {
            "node": self.node_id, "role": self.role, "term": self.term,
            "leader": self.leader_id, "commit": self.commit,
            "applied": self.applied, "last_idx": self.last_idx,
            "wal_hi": self._wal_hi,
            "wal_written": self._wal_written,
            "generation": self.generation,
            "digest": self._digest,
            "digest_ckpts": list(self._digest_ckpts),
            "tier": self.store.tier_summary(),
            **{k: v for k, v in self.stats.items()},
        }
