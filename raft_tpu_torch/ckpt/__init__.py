"""Checkpoints, snapshot install, the committed-entry archive, the snapshot
shipper's bookkeeping, the vote log and the tiered archive (``TieredStore``:
a hot RAM tail over RS-coded on-disk segments) (port of
``raft_tpu/ckpt``)."""

from raft_tpu_torch._lazy import exports

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

# resolved on first use (``raft_tpu_torch._lazy``): the tiered store loads
# without the device-side snapshot install
__getattr__ = exports(__name__, {
    "CheckpointStore": "snapshot", "EngineCheckpoint": "snapshot",
    "Snapshot": "snapshot", "install_snapshot": "snapshot",
    "install_snapshot_all": "snapshot", "SegmentCorrupt": "tiered",
    "SegmentIO": "tiered", "TieredStore": "tiered",
    "SnapshotShipper": "ship", "VoteLog": "votelog",
    "merge_restored": "votelog",
})
