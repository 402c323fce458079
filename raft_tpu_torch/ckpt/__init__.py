"""Checkpoints, snapshot install, the committed-entry archive, the snapshot
shipper's bookkeeping and the vote log (port of ``raft_tpu/ckpt``). The
tiered store (``TieredStore``) is ROADMAP A13."""

from raft_tpu_torch.ckpt.ship import SnapshotShipper
from raft_tpu_torch.ckpt.snapshot import (
    CheckpointStore,
    EngineCheckpoint,
    Snapshot,
    install_snapshot,
    install_snapshot_all,
)
from raft_tpu_torch.ckpt.votelog import VoteLog, merge_restored

__all__ = [
    "CheckpointStore",
    "EngineCheckpoint",
    "Snapshot",
    "SnapshotShipper",
    "VoteLog",
    "install_snapshot",
    "install_snapshot_all",
    "merge_restored",
]
