"""Checkpoint data, the committed-entry archive and the snapshot shipper's
bookkeeping (port of ``raft_tpu/ckpt``, the parts the engine's tick loop
uses). Snapshot install, the vote log and the tiered store are not
ported yet (ROADMAP A9b, A13)."""

from raft_tpu_torch.ckpt.ship import SnapshotShipper
from raft_tpu_torch.ckpt.snapshot import (
    CheckpointStore,
    EngineCheckpoint,
    Snapshot,
)

__all__ = [
    "CheckpointStore",
    "EngineCheckpoint",
    "Snapshot",
    "SnapshotShipper",
]
