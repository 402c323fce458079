"""The cluster engine (port of ``raft_tpu/raft``): ``RaftEngine`` on the
port's transports (ROADMAP A9a-A9e), the leader-lease table
(``raft.lease``) and the shared commit-stamp ledger."""

from raft_tpu_torch.raft.engine import RaftEngine, VirtualClock

__all__ = ["RaftEngine", "VirtualClock"]
