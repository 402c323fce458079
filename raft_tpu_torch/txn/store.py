"""The participant plane: a lock-aware sharded KV state machine (port
of ``raft_tpu/txn/store.py`` over the port's ``ShardedKV``).

``TxnShardedKV`` extends ``examples.kv_sharded.ShardedKV`` with the
four transactional ops of ``txn.ops`` — locks and staged intents are
REPLICATED state (they live in the groups' own logs and rebuild on
replay exactly like the data), so participant crash recovery falls out
of machinery that already exists rather than a side-channel.

Per-group lock table semantics (all pure functions of log order, so
every replica converges):

- ``OP_LOCK``: first lock to apply wins the key. A later LOCK by a
  DIFFERENT txn applies as nothing — the losing coordinator discovers
  the loss at validation (``lock_owned``) and must abort. A re-applied
  LOCK by the same txn refreshes the staged intent (idempotent).
- ``OP_COMMIT``: every lock held by the txn in this group rolls
  forward — staged writes/deletes land in the data map — and releases.
- ``OP_ABORT``: the txn's locks release, intents discarded.
- ``OP_DECIDE`` (decision group only): first decision for a txn id
  wins; later ones are ignored. The decision's APPLY POSITION is the
  transaction's serialization point — ``decision()`` returns it, and
  the serializability checker replays committed transactions in
  exactly this order (the commit-order witness).

Plain ops (SET/DELETE) apply unchanged. ``set``/``delete`` on a key
under a LIVE foreign lock refuse with :class:`txn.ops.LockConflict`
before anything queues — a best-effort gate against applied state (a
lock that lands between the check and the apply is the usual admission
race; mixed workloads that need strict exclusion route writes through
transactions, docs/TXN.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.examples.kv import apply_op
from raft_tpu_torch.examples.kv_sharded import ShardedKV
from raft_tpu_torch.txn import ops as T


class Lock:
    """One held lock: owner txn, TTL deadline, staged intent."""

    __slots__ = ("txn_id", "deadline", "flags", "value")

    def __init__(self, txn_id: int, deadline: float, flags: int,
                 value: bytes):
        self.txn_id = txn_id
        self.deadline = deadline
        self.flags = flags
        self.value = value

    def expired(self, now: float) -> bool:
        return now >= self.deadline


class TxnShardedKV(ShardedKV):
    """Sharded KV + replicated per-group lock tables + the decision
    map (module docstring). ``decision_group`` names the Raft group
    that carries ``OP_DECIDE`` records; everything else about the
    store is ``ShardedKV``."""

    def __init__(self, engine, router=None, replay: bool = False,
                 decision_group: int = 0, broken: Optional[str] = None):
        # state the apply closures touch must exist BEFORE the base
        # constructor registers them (replay=True applies immediately)
        self.locks: List[Dict[bytes, Lock]] = [
            {} for _ in range(engine.G)
        ]
        self._decisions: Dict[int, Tuple[bool, int, int]] = {}
        self._decision_pos = 0
        self.decision_group = decision_group
        self.locks_acquired = 0
        self.locks_lost = 0
        self.broken = broken
        #   "txn_dirty_read": reads serve STAGED lock intents — the
        #   read-uncommitted fault the serializability checker must
        #   catch (chaos --broken txn_dirty_read)
        self._replaying = replay
        super().__init__(engine, router, replay)
        self._replaying = False

    # ------------------------------------------------------ state machine
    def _make_apply(self, g: int):
        def _apply(index: int, payload: bytes) -> None:
            op = payload[0] if payload else 0
            if op in T.TXN_OPS:
                self._apply_txn(g, payload)
            else:
                apply_op(self._data[g], payload)
            self.last_applied[g] = index
        return _apply

    def _apply_txn(self, g: int, payload: bytes) -> None:
        op = payload[0]
        if op == T.OP_LOCK:
            rec = T.decode_lock(payload)
            cur = self.locks[g].get(rec.key)
            if cur is None or cur.txn_id == rec.txn_id:
                self.locks[g][rec.key] = Lock(
                    rec.txn_id, rec.deadline, rec.flags, rec.value
                )
                if cur is None:
                    self.locks_acquired += 1
                    if not self._replaying:
                        self.engine._metric_inc(
                            g, "raft_txn_locks_total",
                            "txn locks acquired (replicated apply)",
                        )
            else:
                self.locks_lost += 1       # first lock won; this one
                return                     # applies as nothing
        elif op in (T.OP_COMMIT, T.OP_ABORT):
            commit, txn_id = T.decode_release(payload)
            held = [k for k, lk in self.locks[g].items()
                    if lk.txn_id == txn_id]
            for k in held:
                lk = self.locks[g].pop(k)
                if commit and lk.flags & T.FLAG_WRITE:
                    if lk.flags & T.FLAG_DELETE:
                        self._data[g].pop(k, None)
                    else:
                        self._data[g][k] = lk.value
        elif op == T.OP_DECIDE:
            rec = T.decode_decision(payload)
            if rec.txn_id not in self._decisions:
                # first decision wins — a replay, a duplicate submit or
                # a racing resolver all converge to the same verdict
                self._decisions[rec.txn_id] = (
                    rec.commit, rec.group_mask, self._decision_pos
                )
                self._decision_pos += 1

    # ------------------------------------------------------------- queries
    def decision(self, txn_id: int):
        """``(commit, group_mask, position)`` for a decided txn, else
        None. ``position`` is the decision's apply order in the
        decision group — the commit-order witness the checker replays."""
        return self._decisions.get(txn_id)

    def lock_of(self, key: bytes) -> Tuple[int, Optional[Lock]]:
        g = self.router.group_of(key)
        return g, self.locks[g].get(key)

    def lock_owned(self, txn_id: int, key: bytes) -> bool:
        _, lk = self.lock_of(key)
        return lk is not None and lk.txn_id == txn_id

    def blocking_lock(self, key: bytes, txn_id: int, now: float):
        """The LIVE foreign lock covering ``key``, else None. Expired
        locks do not block (the TTL path resolves them); own locks do
        not block."""
        g, lk = self.lock_of(key)
        if (lk is None or lk.txn_id == txn_id or lk.expired(now)):
            return None
        return lk

    def lock_stats(self) -> dict:
        return {
            "held": sum(len(t) for t in self.locks),
            "acquired": self.locks_acquired,
            "lost": self.locks_lost,
            "decisions": len(self._decisions),
        }

    # ------------------------------------------------------------- client
    def get(self, key: bytes) -> Optional[bytes]:
        if self.broken == "txn_dirty_read":
            g, lk = self.lock_of(key)
            if lk is not None and lk.flags & T.FLAG_WRITE:
                # BROKEN: serve the staged, UNCOMMITTED intent
                return (None if lk.flags & T.FLAG_DELETE else lk.value)
        return super().get(key)

    def set(self, key: bytes, value: bytes) -> Tuple[int, int]:
        self._refuse_if_locked(key)
        return super().set(key, value)

    def delete(self, key: bytes) -> Tuple[int, int]:
        self._refuse_if_locked(key)
        return super().delete(key)

    def _refuse_if_locked(self, key: bytes) -> None:
        now = self.engine.clock.now
        lk = self.blocking_lock(key, -1, now)
        if lk is not None:
            g = self.router.group_of(key)
            raise T.LockConflict(
                key, lk.txn_id,
                max(lk.deadline - now, self.engine.cfg.heartbeat_period),
                group=g,
            )
