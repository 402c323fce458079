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
    """Build the configured device transport, deciding as the JAX
    package's ``make_transport`` does (``raft_tpu/transport/base.py``).
    ``"tpu_mesh"`` needs ``n_replicas * payload_shards`` ranks: inside an
    initialised process group of that many it gives a ``MeshTransport``
    over the world group, which raises JAX's ``ValueError`` when the
    config has membership headroom (``cfg.rows`` rows need ``rows * P``
    ranks; build such a mesh with ``MeshTransport(cfg, ...)`` in a world
    of that size). Otherwise, as the JAX package does when too few
    devices are visible, it warns and falls back to the resident layout,
    which runs the same program with the same kernels on one device.
    ``"multihost"`` falls back only when placement fails."""
    import torch.distributed as dist

    from raft_tpu_torch.transport.device import SingleDeviceTransport

    if cfg.transport == "tpu_mesh":
        from raft_tpu_torch.transport.mesh import (
            MeshTransport,
            check_mesh_size,
        )

        ranks = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 0)
        need = cfg.n_replicas * cfg.payload_shards
        if ranks >= need:
            # JAX hands the transport the first ``need`` devices, whose
            # size check refuses a config with headroom; a process world
            # has no ranks to leave out, so a larger one is refused by
            # the transport's own check
            check_mesh_size(cfg.rows, cfg.payload_shards, need)
            return MeshTransport(cfg, device=device,
                                 payload_shards=cfg.payload_shards)
        # Loud on purpose: a run that believes it ran on a mesh must not
        # silently have run resident.
        logger.warning(
            "tpu_mesh transport needs an initialised process group of %d "
            "ranks (%d replicas x %d payload shards) but %s; falling back "
            "to SingleDeviceTransport", need, cfg.n_replicas,
            cfg.payload_shards,
            f"the group has {ranks}" if ranks else "none is initialised")
        return SingleDeviceTransport(cfg, device=device)
    if cfg.transport == "multihost":
        from raft_tpu_torch.transport.multihost import (
            multihost_transport,
            replica_devices_across_hosts,
        )

        try:
            # only placement may fall back; a config error from the
            # transport itself propagates, as for tpu_mesh
            replica_devices_across_hosts(cfg.n_replicas, cfg.payload_shards)
        except ValueError as e:
            logger.warning(
                "multihost placement unavailable (%s); falling back to "
                "SingleDeviceTransport", e)
            return SingleDeviceTransport(cfg, device=device)
        return multihost_transport(cfg, device=device)
    if cfg.transport == "single":
        return SingleDeviceTransport(cfg, device=device)
    if cfg.transport == "loopback":
        raise ValueError(
            "the loopback golden model is host-side, not a device "
            "transport; use raft_tpu_torch.golden directly (it exists for "
            "differential tests)")
    raise ValueError(f"unknown device transport {cfg.transport!r}")
