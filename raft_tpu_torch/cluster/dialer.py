"""Outbound peer connections: dial, authenticate, reconnect, pump (port
of ``raft_tpu/cluster/dialer.py``).

Each node keeps at most ONE outbound connection per peer, dialed to
the peer's single wire port (the same ``IngestServer`` that fronts
clients — ``PEER_HELLO`` instead of ``HELLO`` as the first frame is
what marks the stream as replica traffic). The leader-hint redial the
client tier grew on loopback generalizes here into its
real shape: addresses are ``host:port`` strings from the cluster
spec, reconnects back off exponentially, and a peer that died is
simply re-dialed when the next frame wants out — process death is an
expected state, not an error path.

Flow control is deliberately simple: frames for a DOWN peer are
dropped past a small bounded buffer (Raft retransmits by design — the
next heartbeat re-sends whatever mattered), so a dead peer can never
balloon the sender's memory. Drops and redials are first-class
diagnostics (``stats`` + blackbox marks surfaced into the node's
status snapshot): under a trickle or partition fault they are the
first thing anyone needs to see. Replies to inbound frames ride the
same connection they arrived on (the server side handles that); this
module only carries the node's proactive traffic — vote requests,
appends, snapshot chunks.

Every byte rides the ``cluster/netfault.py`` seam (``dial`` +
conn objects — the AST gate in tests/test_torch_import.py bans raw transports
here), so the network nemesis covers this side of every peer link.
Frame integrity is negotiated per connection: the hello advertises
``CAP_CRC``; once the peer's first CRC-flagged frame arrives (proof
the other side speaks it), outbound frames are sealed too. A failed
CRC drops the frame unparsed and counts ``peer_frames_corrupt`` —
never decodes garbage into the log.
"""

from __future__ import annotations

import asyncio
import os
from typing import Dict, List

from raft_tpu_torch.cluster import netfault as NF
from raft_tpu_torch.net import protocol as P
from raft_tpu_torch.obs import blackbox

MAX_BUFFERED = 64          # frames queued per down peer before dropping


class PeerDialer:
    def __init__(self, node, auth, *, backoff_s: float = 0.05,
                 max_backoff_s: float = 1.0, netfaults=None):
        self.node = node
        self.auth = auth
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.netfaults = netfaults
        self._conns: Dict[int, NF.RealConn] = {}
        self._tasks: Dict[int, asyncio.Task] = {}
        self._buf: Dict[int, List[bytes]] = {}
        # CRC latch, STICKY per peer id (not per connection): once a
        # peer proved it speaks flagged frames, every later redial
        # seals from the first buffered frame on — otherwise each
        # reconnect would reopen an unsealed window for the corruption
        # nemesis until the first reply came back
        self._crc_on: Dict[int, bool] = {}
        self._dialed: set = set()            # peers dialed at least once
        self.stats = {"dials": 0, "redials": 0, "drops": 0,
                      "frames_out": 0, "frames_in": 0}
        self._no_crc = bool(os.environ.get("RAFT_TPU_PEER_NO_CRC"))
        self._closed = False

    # ------------------------------------------------------------ sending
    def pump_outbox(self) -> None:
        """Drain the node's outbox — called from tick/drive, sync (the
        asyncio transport buffers the write)."""
        if not self.node.outbox:
            return
        out, self.node.outbox = self.node.outbox, []
        for peer, frame in out:
            self.send(peer, frame)

    def send(self, peer: int, frame: bytes) -> None:
        if (self._closed or peer in self.node.deny
                or peer in getattr(self.node, "deny_to", ())):
            return
        conn = self._conns.get(peer)
        if conn is not None:
            try:
                conn.write(P.crc_seal(frame)
                           if self._crc_on.get(peer) else frame)
                self.stats["frames_out"] += 1
                return
            except (ConnectionError, RuntimeError):
                self._drop_conn(peer)
        buf = self._buf.setdefault(peer, [])
        if len(buf) >= MAX_BUFFERED:
            buf.pop(0)
            self.stats["drops"] += 1
            if self.stats["drops"] % 32 == 1:
                # rate-limited: the first drop (and every 32nd) is a
                # journal event — under a trickle fault this is the
                # diagnostic, not noise
                blackbox.mark("peer_buf_drop", node=self.node.node_id,
                              peer=peer, drops=self.stats["drops"])
        buf.append(frame)
        self._ensure_dialing(peer)

    # ----------------------------------------------------------- dialing
    def _ensure_dialing(self, peer: int) -> None:
        t = self._tasks.get(peer)
        if t is None or t.done():
            self._tasks[peer] = asyncio.get_running_loop().create_task(
                self._dial_loop(peer)
            )

    async def _dial_loop(self, peer: int) -> None:
        delay = self.backoff_s
        while not self._closed and self._buf.get(peer):
            addr = self.node.peers.get(peer, "")
            host, _, port = addr.rpartition(":")
            try:
                conn = await NF.dial(
                    host or "127.0.0.1", int(port),
                    ssl=self.auth.client_ssl(),
                    faults=self.netfaults, peer=peer,
                )
            except (OSError, ValueError):
                await asyncio.sleep(delay)
                delay = min(delay * 2, self.max_backoff_s)
                continue
            self.stats["dials"] += 1
            if peer in self._dialed:
                self.stats["redials"] += 1
                blackbox.mark("peer_redial", node=self.node.node_id,
                              peer=peer, dials=self.stats["dials"])
            self._dialed.add(peer)
            conn.write(P.encode_peer_hello(
                self.node.node_id, self.auth.token,
                self.node.store._sealed_hi,
                caps=0 if self._no_crc else P.CAP_CRC,
            ))
            self._conns[peer] = conn
            for frame in self._buf.pop(peer, []):
                conn.write(P.crc_seal(frame)
                           if self._crc_on.get(peer) else frame)
                self.stats["frames_out"] += 1
            asyncio.get_running_loop().create_task(
                self._read_loop(peer, conn)
            )
            return

    async def _read_loop(self, peer: int, conn) -> None:
        """Replies from the peer's server (vote replies, append acks,
        snap acks) come back on our outbound connection."""
        decoder = P.FrameDecoder()
        try:
            while not self._closed:
                data = await conn.read(1 << 16)
                if not data:
                    break
                for kind, payload in decoder.feed(data):
                    self.stats["frames_in"] += 1
                    if kind & P.CRC_FLAG and not self._no_crc:
                        # the peer PROVED it speaks CRC frames: start
                        # sealing our own sends on this connection
                        self._crc_on[peer] = True
                    kind, payload, crc_ok = P.crc_open(kind, payload)
                    if not crc_ok:
                        # integrity failure: drop unparsed, count, let
                        # the next heartbeat retransmit
                        self.node.stats["peer_frames_corrupt"] += 1
                        continue
                    kind, _tr, payload = P.split_trace(kind, payload)
                    if kind == P.ERROR:
                        # auth rejection or protocol desync: log and
                        # drop the conn (the dial loop will retry)
                        _rid, msg = P.decode_error(payload)
                        blackbox.mark("peer_conn_error",
                                      node=self.node.node_id,
                                      peer=peer, error=msg)
                        return
                    for reply in self.node.on_peer_frame(kind, payload):
                        conn.write(P.crc_seal(reply)
                                   if self._crc_on.get(peer)
                                   else reply)
        except (ConnectionError, P.ProtocolError,
                asyncio.IncompleteReadError):
            pass
        finally:
            self._drop_conn(peer)

    def _drop_conn(self, peer: int) -> None:
        conn = self._conns.pop(peer, None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    async def close(self) -> None:
        self._closed = True
        for peer in list(self._conns):
            self._drop_conn(peer)
        for t in self._tasks.values():
            t.cancel()
