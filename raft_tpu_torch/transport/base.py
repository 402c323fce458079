"""The ``Transport`` plugin boundary (port of ``raft_tpu/transport/base.py``).

A transport owns where replica state lives and how the collective steps
run: ``SingleDeviceTransport`` holds every row on one device,
``MeshTransport`` one row per rank of a ``torch.distributed`` group
(``"tpu_mesh"``, and ``"multihost"``: the same mesh over the world group,
one process a failure domain, ``transport.multihost``).
"""

from __future__ import annotations

import logging
from typing import Protocol, Tuple

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.state import ReplicaState
from raft_tpu_torch.core.step import RepInfo, VoteInfo


class Transport(Protocol):
    cfg: RaftConfig

    def init(self) -> ReplicaState:
        """Fresh cluster state placed for this backend."""
        ...

    def local_row(self, row: int):
        """Index of replica ``row`` in the state this process holds, or
        None when another process holds it."""
        ...

    def commit_index(self, state: ReplicaState, row: int) -> int:
        """Replica ``row``'s commit index, wherever that row is held."""
        ...

    def replicate(self, state: ReplicaState, client_payload, client_count,
                  leader, leader_term, alive, slow, repair: bool = True,
                  member=None, repair_floor=0, floor_prev_term=0,
                  term_floor=None) -> Tuple[ReplicaState, RepInfo]:
        ...

    def request_votes(self, state: ReplicaState, candidate, cand_term,
                      alive) -> Tuple[ReplicaState, VoteInfo]:
        ...


logger = logging.getLogger(__name__)


def make_transport(cfg: RaftConfig, device=None) -> "Transport":
    """Build the configured device transport. ``"tpu_mesh"`` gives a
    ``MeshTransport`` over the world group when an initialised process
    group has ``cfg.rows`` ranks; otherwise, as the JAX package does when
    too few devices are visible, it warns and falls back to the resident
    layout, which runs the same program with the same kernels on one
    device."""
    import torch.distributed as dist

    from raft_tpu_torch.transport.device import SingleDeviceTransport

    if cfg.transport == "single":
        return SingleDeviceTransport(cfg, device=device)
    if cfg.transport == "tpu_mesh":
        from raft_tpu_torch.transport.mesh import MeshTransport

        ranks = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 0)
        if ranks == cfg.rows:
            return MeshTransport(cfg, device=device)
        # Loud on purpose: a run that believes it ran on a mesh must not
        # silently have run resident.
        logger.warning(
            "tpu_mesh transport needs an initialised process group of %d "
            "ranks (one replica row each) but %s; falling back to "
            "SingleDeviceTransport", cfg.rows,
            f"the group has {ranks}" if ranks else "none is initialised")
        return SingleDeviceTransport(cfg, device=device)
    if cfg.transport == "multihost":
        from raft_tpu_torch.transport.multihost import (
            multihost_transport,
            world_size,
        )

        try:
            # only placement may fall back; a config error from the
            # transport itself propagates, as for tpu_mesh
            return multihost_transport(cfg, device=device)
        except ValueError as e:
            if world_size() == cfg.rows:
                raise
            logger.warning(
                "multihost placement unavailable (%s); falling back to "
                "SingleDeviceTransport", e)
            return SingleDeviceTransport(cfg, device=device)
    raise ValueError(
        f"transport {cfg.transport!r} is not ported yet; the port runs "
        "transport='single', 'tpu_mesh' or 'multihost'")
