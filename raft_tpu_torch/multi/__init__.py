"""Multi-Raft on the port (``raft_tpu/multi``): G independent consensus
groups as one batched device program (``MultiEngine``, resident on one
device or split over a ``transport.group_mesh.GroupMesh``) behind a
key-routed sharding front end (``Router``) with a StatusBoard-driven
placement controller (``Rebalancer``). See ``multi.engine`` for the
design notes."""

from raft_tpu_torch.multi.engine import (
    GROUP_AXIS_TRANSPORTS,
    MultiEngine,
    NotLeader,
    ReadLagging,
    UnsupportedGroupTransport,
    UnsupportedMembership,
)
from raft_tpu_torch.multi.rebalancer import Rebalancer
from raft_tpu_torch.multi.router import ReadSession, Router

__all__ = [
    "GROUP_AXIS_TRANSPORTS",
    "MultiEngine",
    "NotLeader",
    "ReadLagging",
    "ReadSession",
    "Rebalancer",
    "Router",
    "UnsupportedGroupTransport",
    "UnsupportedMembership",
]
