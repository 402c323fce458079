"""The cluster engine (port of ``raft_tpu/raft``): the tick loop of
``RaftEngine`` on the port's transports (ROADMAP A9a), and the shared
commit-stamp ledger."""

from raft_tpu_torch.raft.engine import RaftEngine, VirtualClock

__all__ = ["RaftEngine", "VirtualClock"]
