"""The network seam: every peer and client byte the cluster tier moves
(port of ``raft_tpu/cluster/netfault.py``, line for line).

The storage seam (``cluster/storage.py``) sits under every durable
write; this module is the symmetric seam for the wire. Production code
in ``net/server.py`` and ``cluster/dialer.py``
never touches an asyncio transport directly (an AST gate in
``tests/test_torch_import.py`` pins the discipline) — it reads and
writes through a :class:`RealConn`, and a drill swaps in a
:class:`FaultyConn` that injects, seed-driven and at frame granularity
(every ``write`` on these conns is exactly one encoded frame):

- **latency + jitter** — each frame is released ``delay_ms`` (plus
  uniform ``jitter_ms``) after it was written, FIFO per connection.
- **bandwidth trickle** — ``bw_bytes_s`` serializes frames through a
  token-bucket clock, so a 64 KiB snap chunk takes real wall time.
- **torn frames / connection resets** — every ``torn_every``-th frame
  is cut mid-frame: a prefix goes out, then the connection closes. The
  receiver's ``FrameDecoder`` holds the torn tail until EOF — exactly
  what a mid-write RST leaves behind.
- **duplicate delivery** — every ``dup_every``-th frame is delivered
  twice; with ``replay_redial``, the tail of the PREVIOUS connection
  incarnation's traffic is replayed onto the next redial (the classic
  at-least-once retransmit a reconnecting transport produces).
- **reorder windows** — every ``reorder_every``-th frame is held an
  extra ``reorder_hold_ms`` OUTSIDE the FIFO clamp, so frames written
  after it overtake it.
- **post-header byte corruption** — every ``corrupt_every``-th large
  frame has one bit flipped near its tail (inside the final record's
  payload/padding, past every length prefix): the frame still decodes,
  the bytes differ — the silent-corruption class only a frame CRC
  (``CAP_CRC``, net/protocol.py) can catch.

The fault plan is ``net.json`` in the node's data dir, re-read on
mtime change so faults arm against a LIVE process; observed counters
go to ``net-stats.json`` beside it. The same file carries the node's
partition plan (``deny`` / ``deny_to`` / ``deny_from`` keys, polled by
``cluster/node.py`` — the old ``ctrl-<id>.json`` file stays honored as
an alias): a symmetric deny is just the degenerate fault plan. Client
connections ride the seam too but are faulted only when the plan sets
``"clients": true`` — peer-wire faults must not be confused with
client-visible ones by default.

Import discipline: stdlib only (``atomic_write`` is resolved lazily
from ``cluster/storage.py``, which itself imports nothing from the
cluster package), so ``net/server.py`` can import this module lazily
without completing the whole cluster package first.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import random
import time
from typing import Deque, Dict, List, Optional

#: plan keys that actually arm wire faults (deny/seed/clients/to are
#: routing + scoping, not faults — a plan carrying only those is a
#: clean passthrough)
_FAULT_KEYS = ("delay_ms", "jitter_ms", "bw_bytes_s", "torn_every",
               "dup_every", "reorder_every", "corrupt_every",
               "replay_redial")

#: frames at least this long are corruption candidates: the flip lands
#: in the final record's payload/padding, far past every header and
#: length prefix, so the frame still DECODES — the silent class
_CORRUPT_MIN_FRAME = 96

#: never replay frames longer than this across a redial (a snap chunk
#: replay is modeled by dup_every; redial replay targets the small
#: control frames a retransmitting transport actually duplicates)
_REPLAY_MAX_FRAME = 4096


class RealConn:
    """Production transport: direct StreamReader/StreamWriter calls —
    the ONE place (with :class:`FaultyConn`) allowed to touch them."""

    def __init__(self, reader, writer):
        self._r = reader
        self._w = writer
        self.peer: Optional[int] = None   # set after PEER_HELLO auth

    async def read(self, n: int) -> bytes:
        return await self._r.read(n)

    def write(self, frame: bytes) -> None:
        self._w.write(frame)

    async def drain(self) -> None:
        await self._w.drain()

    def close(self) -> None:
        try:
            self._w.close()
        except Exception:
            pass


class FaultyConn(RealConn):
    """Plan-driven lying network under one connection (module
    docstring). Faults apply on the WRITE path at frame granularity;
    reads pass through — both directions of every peer link are
    covered because every process wraps its own outbound side."""

    def __init__(self, net: "NetFaults", reader, writer, *,
                 peer: Optional[int] = None, client: bool = False):
        super().__init__(reader, writer)
        self.net = net
        self.peer = peer
        self.client = client
        self._last_t = 0.0        # FIFO release clock (loop time)
        self._writes = 0
        self._dead = False
        self._replay: List[bytes] = []
        if peer is not None:
            self._replay = net._take_replay(peer)

    # ----------------------------------------------------------- write
    def write(self, frame: bytes) -> None:
        if self._dead or not frame:
            return
        net = self.net
        plan = net.plan_for(self.peer, client=self.client)
        loop = asyncio.get_running_loop()
        now = loop.time()
        if plan is None:
            # passthrough — but never overtake a still-scheduled tail
            if self._last_t > now:
                loop.call_at(self._last_t, self._deliver, frame, -1)
            else:
                self._deliver(frame, -1)
            return
        if self._replay and self._writes >= 1:
            # cross-incarnation duplication: the previous connection's
            # tail arrives again AFTER this conn authenticated (the
            # replayed frames rode an authed stream the first time too)
            dup, self._replay = self._replay, []
            net.stats["frames_replayed"] += len(dup)
            for old in dup:
                self._schedule(loop, now, plan, old, tear=-1)
        self._writes += 1
        rng = net.rng
        tear = -1
        if (not self.client and len(frame) > 24
                and net._fire(plan, "torn_every")):
            tear = rng.randrange(9, len(frame))
        if tear < 0 and net._fire(plan, "dup_every"):
            net.stats["frames_dup"] += 1
            self._schedule(loop, now, plan, frame, tear=-1)
        if (tear < 0 and len(frame) >= _CORRUPT_MIN_FRAME
                and net._fire(plan, "corrupt_every")):
            blob = bytearray(frame)
            pos = len(blob) - 1 - rng.randrange(0, 12)
            blob[pos] ^= 1 << rng.randrange(8)
            frame = bytes(blob)
            net.stats["frames_corrupt_injected"] += 1
        if self.peer is not None and tear < 0 and plan.get(
                "replay_redial") and len(frame) <= _REPLAY_MAX_FRAME:
            net._note_sent(self.peer, frame)
        self._schedule(loop, now, plan, frame, tear=tear)
        net._publish()

    def _schedule(self, loop, now: float, plan: dict, frame: bytes,
                  tear: int) -> None:
        net = self.net
        hold = float(plan.get("delay_ms", 0) or 0) / 1e3
        jitter = float(plan.get("jitter_ms", 0) or 0) / 1e3
        if jitter:
            hold += net.rng.uniform(0.0, jitter)
        if net._fire(plan, "reorder_every"):
            # held OUTSIDE the FIFO clamp: later frames overtake it
            net.stats["frames_reordered"] += 1
            release = now + hold + float(
                plan.get("reorder_hold_ms", 50) or 50) / 1e3
        else:
            release = max(now + hold, self._last_t)
            bw = float(plan.get("bw_bytes_s", 0) or 0)
            if bw > 0:
                release += len(frame) / bw
            self._last_t = release
        if release <= now + 1e-4 and tear < 0:
            self._deliver(frame, -1)
            return
        net.stats["frames_delayed"] += 1
        loop.call_at(release, self._deliver, frame, tear)

    def _deliver(self, frame: bytes, tear: int) -> None:
        if self._dead:
            return
        try:
            if tear >= 0:
                # mid-frame cut: the prefix flushes, then FIN — the
                # receiver's decoder keeps the torn tail until EOF
                self._w.write(frame[:tear])
                self._dead = True
                self.net.stats["conns_torn"] += 1
                self.net._publish(force=True)
                self._w.close()
            else:
                self._w.write(frame)
        except (ConnectionError, RuntimeError):
            self._dead = True

    def close(self) -> None:
        self._dead = True
        super().close()


class NetFaults:
    """Per-node fault manager: owns the ``net.json`` plan (mtime-
    polled), the seeded RNG, the every-N fault clocks (global across
    connections, so fault cadence survives redials), the previous-
    incarnation replay buffers, and the published counters."""

    _POLL_S = 0.05      # plan mtime re-check cadence
    _PUB_S = 0.25       # stats publish throttle

    def __init__(self, root: str):
        self.root = root
        self.plan_path = os.path.join(root, "net.json")
        self.stats_path = os.path.join(root, "net-stats.json")
        self.plan: dict = {}
        self._plan_mtime = -1.0
        self._next_poll = 0.0
        self._next_pub = 0.0
        self.rng = random.Random(0)
        self.stats = {
            "conns": 0, "frames_delayed": 0, "frames_dup": 0,
            "frames_reordered": 0, "frames_corrupt_injected": 0,
            "frames_replayed": 0, "conns_torn": 0,
        }
        self._clocks: Dict[str, int] = {}
        self._sent: Dict[int, Deque[bytes]] = {}
        self._reload(force=True)

    # ------------------------------------------------------------ seam
    def wrap(self, reader, writer, *, peer: Optional[int] = None,
             client: bool = False) -> FaultyConn:
        self.stats["conns"] += 1
        return FaultyConn(self, reader, writer, peer=peer,
                          client=client)

    def plan_for(self, peer: Optional[int],
                 client: bool = False) -> Optional[dict]:
        """The merged fault plan for one stream, or None when no wire
        fault is armed for it (deny keys are the NODE's business —
        cluster/node.py polls the same file)."""
        self._reload()
        p = self.plan
        if not p:
            return None
        if client and not p.get("clients"):
            return None
        base = {k: v for k, v in p.items() if k in _FAULT_KEYS
                or k == "reorder_hold_ms"}
        if peer is not None:
            over = p.get("to", {}).get(str(peer))
            if over:
                base.update(over)
        if not any(base.get(k) for k in _FAULT_KEYS):
            return None
        return base

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

    def _publish(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now < self._next_pub:
            return
        self._next_pub = now + self._PUB_S
        from raft_tpu_torch.cluster.storage import atomic_write

        try:
            atomic_write(self.stats_path,
                         json.dumps(self.stats).encode())
        except OSError:
            pass

    # ----------------------------------------------------------- hooks
    def _fire(self, plan: dict, key: str) -> bool:
        every = int(plan.get(key, 0) or 0)
        if every <= 0:
            return False
        self._clocks[key] = self._clocks.get(key, 0) + 1
        return self._clocks[key] % every == 0

    def _note_sent(self, peer: int, frame: bytes) -> None:
        self._sent.setdefault(
            peer, collections.deque(maxlen=2)).append(frame)

    def _take_replay(self, peer: int) -> List[bytes]:
        self._reload()
        if not self.plan.get("replay_redial"):
            return []
        got = self._sent.pop(peer, None)
        return list(got) if got else []


async def dial(host: str, port: int, *, ssl=None,
               faults: Optional[NetFaults] = None,
               peer: Optional[int] = None) -> RealConn:
    """Open one outbound connection THROUGH the seam — the only dialer
    the cluster tier uses (the lint gate bans raw open_connection in
    cluster/dialer.py)."""
    reader, writer = await asyncio.open_connection(host, port, ssl=ssl)
    if faults is not None:
        return faults.wrap(reader, writer, peer=peer)
    conn = RealConn(reader, writer)
    conn.peer = peer
    return conn


# ===================================================================
# Drill-side helpers (mirror cluster/storage.py's write_plan /
# read_disk_stats): the harness writes/merges a node's plan, a LIVE
# NetFaults picks it up on the next poll.

def write_net_plan(data_dir: str, plan: dict) -> str:
    """Write/replace a node's ``net.json`` fault plan (atomic, real)."""
    from raft_tpu_torch.cluster.storage import atomic_write

    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, "net.json")
    atomic_write(path, json.dumps(plan).encode())
    return path


def merge_net_plan(data_dir: str, patch: dict) -> dict:
    """Merge ``patch`` into a node's existing ``net.json`` (top-level
    keys; a key set to None is removed) — how the supervisor folds a
    partition's deny keys into a plan whose wire faults stay live."""
    path = os.path.join(data_dir, "net.json")
    try:
        with open(path) as f:
            plan = json.load(f)
    except (OSError, ValueError):
        plan = {}
    for k, v in patch.items():
        if v is None:
            plan.pop(k, None)
        else:
            plan[k] = v
    write_net_plan(data_dir, plan)
    return plan


def read_net_stats(data_dir: str) -> dict:
    """The NetFaults' published fault counters (empty when absent)."""
    try:
        with open(os.path.join(data_dir, "net-stats.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}
