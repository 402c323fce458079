"""The ``Transport`` plugin boundary (port of ``raft_tpu/transport/base.py``).

A transport owns where replica state lives and how the collective steps
run. This slice ports the resident single-device transport; the mesh and
multihost placements wait for the distributed slice.
"""

from __future__ import annotations

from typing import Protocol, Tuple

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.state import ReplicaState
from raft_tpu_torch.core.step import RepInfo, VoteInfo


class Transport(Protocol):
    cfg: RaftConfig

    def init(self) -> ReplicaState:
        """Fresh cluster state placed for this backend."""
        ...

    def replicate(self, state: ReplicaState, client_payload, client_count,
                  leader, leader_term, alive, slow, repair: bool = True,
                  member=None, repair_floor=0, floor_prev_term=0,
                  term_floor=None) -> Tuple[ReplicaState, RepInfo]:
        ...

    def request_votes(self, state: ReplicaState, candidate, cand_term,
                      alive) -> Tuple[ReplicaState, VoteInfo]:
        ...


def make_transport(cfg: RaftConfig, device=None) -> "Transport":
    """Build the configured device transport (``"single"`` only so far)."""
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    if cfg.transport == "single":
        return SingleDeviceTransport(cfg, device=device)
    raise ValueError(
        f"transport {cfg.transport!r} is not ported yet; the port runs the "
        "resident layout (transport='single')")
