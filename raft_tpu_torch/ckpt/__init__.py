"""Checkpoints, snapshot install, the committed-entry archive, the snapshot
shipper's bookkeeping, the vote log and the tiered archive (``TieredStore``:
a hot RAM tail over RS-coded on-disk segments) (port of
``raft_tpu/ckpt``)."""

from raft_tpu_torch.ckpt.ship import SnapshotShipper
from raft_tpu_torch.ckpt.snapshot import (
    CheckpointStore,
    EngineCheckpoint,
    Snapshot,
    install_snapshot,
    install_snapshot_all,
)
from raft_tpu_torch.ckpt.tiered import SegmentCorrupt, SegmentIO, TieredStore
from raft_tpu_torch.ckpt.votelog import VoteLog, merge_restored

__all__ = [
    "CheckpointStore",
    "EngineCheckpoint",
    "SegmentCorrupt",
    "SegmentIO",
    "Snapshot",
    "SnapshotShipper",
    "TieredStore",
    "VoteLog",
    "install_snapshot",
    "install_snapshot_all",
    "merge_restored",
]
