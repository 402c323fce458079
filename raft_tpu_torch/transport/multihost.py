"""Replica rows placed across failure domains (port of
``raft_tpu/transport/multihost.py``).

The reference's "network" is a map of Go channels inside one process, so
all three replicas die together. Here each replica row lives in its own
OS process, a rank of a ``torch.distributed`` gloo group, and every
process runs the FULL engine as a mirrored deterministic event loop:

    from raft_tpu_torch.transport.multihost import (
        initialize_multihost, multihost_transport,
    )
    initialize_multihost("tcp://host0:29500", num_processes=R,
                         process_id=i)           # no-op if R == 1
    t = multihost_transport(cfg)                 # this rank's row
    eng = RaftEngine(cfg, t, vote_log=f"votes-{i}.log")

Every process has the same config and seed, so the same timers fire and
the same decisions are taken, and every process issues the same
collectives in the same order: the data-plane steps (``MeshTransport``)
and the host reads of other rows (``fetch_rows``, the gathering fetch).
``RaftConfig.mirror_check_every`` folds each decision into a rolling
digest and exchanges it across the processes every that many decisions
(``RaftEngine._verify_mirror_digest``): a divergence becomes a
``MirrorDesyncError`` on every process, and an exchange that does not
complete within ``mirror_exchange_timeout_s`` does too.

The recovery contract is the JAX package's, as far as this part of the
port goes:

1. **Detection.** A peer that stops stalls the next collective; the
   bounded digest exchange turns that into a fail-stop.
2. **Re-formation is a restart** of the process group over the processes
   that remain: ``transport.reform.Rendezvous`` agrees on the survivors,
   the coordinator (``Epoch.init_method``, the next
   ``initialize_multihost`` address) and the checkpoint to restore.
3. **State comes from stable storage.** Checkpoints are cluster-wide
   (every process archives every commit: ``save_checkpoint`` writes the
   whole cluster's file) and every process writes its OWN vote log (give
   each rank its own ``vote_log`` path), so any surviving process can
   restore the cluster (``RaftEngine.restore`` puts each rank's row back
   in place).
4. **Durability fences acks**: an entry is acknowledged once a checkpoint
   covering it is on disk.

Placement (``replica_devices_across_hosts``) takes the JAX rules over any
objects that carry ``process_index``. This port's mesh holds one lane
slice of a row a rank: a world of ``rows * payload_shards`` ranks places
replica r on ranks ``r*P .. r*P + P - 1``, and the placement treats those
P ranks as one host (a replica's payload shards never span hosts, as in
JAX). A launcher must keep them so: start the P ranks of a replica on one
host, since a host failure takes the whole replica, never part of it.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple, Optional, Sequence

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import blackbox
from raft_tpu_torch.transport.mesh import MeshTransport, check_mesh_size


class RankDevice(NamedTuple):
    """One rank of the process group as a placement target: its id and
    its failure domain (its replica row's host: rank g of a world of
    ``payload_shards`` ranks a row is on host ``g // payload_shards``)."""

    id: int
    process_index: int


def world_size() -> int:
    """Ranks of the initialised default process group (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def initialize_multihost(init_method: Optional[str] = None,
                         num_processes: int = 1, process_id: int = 0,
                         timeout_s: float = 600.0) -> None:
    """Join this process to the gloo group of ``num_processes`` ranks at
    ``init_method`` (``tcp://host:port`` or ``file://path``) as rank
    ``process_id``; a no-op for one process."""
    if num_processes <= 1:
        return
    import torch.distributed as dist

    # write-before-block (obs.blackbox): the rendezvous is the first
    # cross-process wait; a dead peer or a wrong address hangs here
    blackbox.mark("distributed_init", coordinator=str(init_method),
                  num_processes=num_processes, process_id=process_id)
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    blackbox.mark("distributed_init_done", process_id=process_id)


def replica_devices_across_hosts(n_replicas: int, payload_shards: int = 1,
                                 devices: Optional[Sequence] = None) -> list:
    """Pick ``n_replicas * payload_shards`` devices so that each replica's
    block comes from a distinct process where possible (the JAX rules,
    ``multihost.py:149``): with at least ``n_replicas`` processes replica
    i's block is taken wholly from one process; with fewer, replicas are
    dealt over the processes, least used first; one process gives its
    flat device list. A replica's payload shards never span processes:
    ``ValueError`` when no process has a free block. ``devices`` defaults
    to this group's ranks (``RankDevice``)."""
    if devices is None:
        blackbox.mark("device_enum", n_replicas=n_replicas,
                      payload_shards=payload_shards)
        devices = [RankDevice(g, g // payload_shards)
                   for g in range(world_size())]
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    procs = sorted(by_proc)
    if len(procs) == 1:
        flat = by_proc[procs[0]]
        need = n_replicas * payload_shards
        if len(flat) < need:
            raise ValueError(
                f"need {need} devices, single process has {len(flat)}")
        return flat[:need]
    picked = []
    # greedy block placement: the least-used process that still has a
    # whole block free, ties toward more free devices (places on uneven
    # fabrics where a rigid round-robin would dead-end)
    used = {p: 0 for p in procs}
    cursor = {p: 0 for p in procs}
    for r in range(n_replicas):
        viable = [p for p in procs
                  if len(by_proc[p]) - cursor[p] >= payload_shards]
        if not viable:
            free = {p: len(by_proc[p]) - cursor[p] for p in procs}
            raise ValueError(
                f"replica {r}: no process has {payload_shards} free "
                f"devices (free per process: {free}); a replica's payload "
                "shards must stay on one process")
        p = min(viable,
                key=lambda q: (used[q], -(len(by_proc[q]) - cursor[q])))
        at = cursor[p]
        picked.extend(by_proc[p][at:at + payload_shards])
        cursor[p] = at + payload_shards
        used[p] += 1
    return picked


def multihost_transport(cfg: RaftConfig, device=None,
                        payload_shards: Optional[int] = None
                        ) -> MeshTransport:
    """A ``MeshTransport`` over the world group, this rank holding its
    part of its replica row on ``device`` (CUDA unless ``device="cpu"``):
    JAX's ``multihost_transport`` (``multihost.py:225``). The world must
    be ``rows * P`` ranks (``P = payload_shards``, default
    ``cfg.payload_shards``), ranks ``r*P .. r*P + P - 1`` holding replica
    r; a launcher must keep those P ranks on one host. Raises
    ``ValueError`` when placement fails (too few ranks for the
    ``n_replicas`` replicas) and the transport's own size errors (a world
    that is not ``rows * P``, membership headroom included)."""
    shards = cfg.payload_shards if payload_shards is None else payload_shards
    placed = replica_devices_across_hosts(cfg.n_replicas, shards)
    # JAX's transport checks the placed devices: headroom rows are short
    check_mesh_size(cfg.rows, shards, len(placed))
    return MeshTransport(cfg, device=device, payload_shards=shards)
