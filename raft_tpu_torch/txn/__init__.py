"""Cross-group transactions: a replicated 2PC coordinator plane over
multi-Raft (docs/TXN.md; the port of ``raft_tpu/txn/``, host code over
the port's ``MultiEngine`` and ``Router``: it adds no device code, the
plane rides the engine's group programs).

- ``txn.ops`` — transactional log-entry encodings (LOCK / COMMIT /
  ABORT / DECIDE) extending ``examples.kv``'s op space, plus the typed
  :class:`LockConflict` refusal.
- ``txn.store`` — :class:`TxnShardedKV`: the participant plane (per-
  group replicated lock tables, staged intents, the decision map).
- ``txn.coordinator`` — :class:`TxnCoordinator`: pollable BEGIN →
  prewrite fan-out → replicated decision → release, with the TTL /
  status-check resolver for dead coordinators.
"""

from raft_tpu_torch.txn.coordinator import TxnCoordinator, TxnHandle, TxnItem
from raft_tpu_torch.txn.ops import LockConflict
from raft_tpu_torch.txn.store import TxnShardedKV

__all__ = [
    "LockConflict",
    "TxnCoordinator",
    "TxnHandle",
    "TxnItem",
    "TxnShardedKV",
]
