"""Exactly-once client sessions over an at-least-once log — the standard
Raft client-session pattern (Raft dissertation §6.3), layered on the
engine's honest durability contract (the port's copy of
``raft_tpu/examples/sessions.py``: the same entry format over
``raft_tpu_torch.raft.RaftEngine``).

``RaftEngine.submit`` documents that entries queued across a leadership
change may be dropped, and that clients resubmit (raft/engine.py). Naive
resubmission gives AT-LEAST-ONCE application: if the ack was lost but the
entry actually committed, the retry applies twice — fine for idempotent
SETs (examples.kv), wrong for counters, appends, or transfers.

``SessionedStateMachine`` closes the loop: every operation carries a
(client id, request id); the state machine remembers the highest request
id applied per client and IGNORES re-applications, so a client can retry
blindly until durable and the operation still applies exactly once.
The dedup table is part of the state machine — rebuilt by the same log
replay that rebuilds the data, so restarts preserve exactly-once too.

``ReplicatedCounter`` is the worked non-idempotent application.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, Optional, Tuple

from raft_tpu_torch.raft.engine import RaftEngine

_HDR = struct.Struct("<QQq")   # client_id, request_id, operand


class SessionedStateMachine:
    """Apply-stream wrapper delivering each (client, request) at most once.

    ``apply_op(operand)`` runs only for the first committed occurrence of
    a (client_id, request_id) pair; later occurrences (client retries that
    both committed) are dropped. Request ids must be monotonically
    increasing per client — the standard session contract."""

    def __init__(
        self,
        engine: RaftEngine,
        apply_op: Callable[[int], None],
        replay: bool = False,
    ):
        if engine.cfg.entry_bytes < _HDR.size:
            raise ValueError(
                f"session ops need {_HDR.size}-byte entries, "
                f"config has {engine.cfg.entry_bytes}"
            )
        self.engine = engine
        self._apply_op = apply_op
        self._last_req: Dict[int, int] = {}     # client id -> request id
        self.duplicates_dropped = 0
        engine.register_apply(self._apply, replay=replay)

    def encode(self, client_id: int, request_id: int, operand: int) -> bytes:
        if client_id == 0:
            # 0 marks padding/probe entries; an op encoded with it would
            # commit but never apply — reject at the source
            raise ValueError("client id 0 is reserved for padding entries")
        size = self.engine.cfg.entry_bytes
        body = _HDR.pack(client_id, request_id, operand)
        if len(body) > size:
            raise ValueError(f"entries are {size} bytes, op needs {len(body)}")
        return body + bytes(size - len(body))

    def last_request(self, client_id: int) -> int:
        """Highest request id applied for ``client_id`` (0 if none) —
        restart path: clients derive their next id from this."""
        return self._last_req.get(client_id, 0)

    def _apply(self, index: int, payload: bytes) -> None:
        client, req, operand = _HDR.unpack_from(payload)
        if client == 0:
            return                               # padding / probe entries
        if self._last_req.get(client, -1) >= req:
            self.duplicates_dropped += 1         # committed retry: drop
            return
        # apply BEFORE recording: a raising apply_op must not mark the op
        # applied, or every retry/replay would be dropped and the op lost
        self._apply_op(operand)
        self._last_req[client] = req


class ReplicatedCounter:
    """A non-idempotent state machine (sum of increments) with
    exactly-once semantics under blind client retries."""

    def __init__(self, engine: RaftEngine, replay: bool = False):
        self.engine = engine
        self.value = 0
        self._sm = SessionedStateMachine(engine, self._add, replay=replay)
        # replay runs synchronously above: seed the id allocator from the
        # rebuilt dedup table so a post-restart add() never reuses an
        # already-applied request id (which would be silently dropped)
        self._next_req: Dict[int, int] = dict(self._sm._last_req)

    def _add(self, operand: int) -> None:
        self.value += operand

    def add(self, client_id: int, amount: int,
            request_id: Optional[int] = None) -> Tuple[int, int]:
        """Submit an increment; returns (engine seq, request id). Safe to
        call again with the SAME request id if durability was never
        observed — the session layer deduplicates committed retries."""
        if request_id is None:
            request_id = self._next_req.get(client_id, 0) + 1
        # max, not overwrite: retrying an OLD id must not regress the
        # allocator into handing out already-used ids for new ops
        self._next_req[client_id] = max(
            self._next_req.get(client_id, 0), request_id
        )
        seq = self.engine.submit(
            self._sm.encode(client_id, request_id, amount)
        )
        return seq, request_id

    @property
    def duplicates_dropped(self) -> int:
        return self._sm.duplicates_dropped
