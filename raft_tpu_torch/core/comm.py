"""Replica-axis communication (port of ``raft_tpu/core/comm.py``).

The protocol steps of ``core.step`` reach other replica rows only through
this interface — ``replica_ids``, ``local``, ``all_gather``,
``select_row`` and ``leader_cols`` — so one body runs in two placements:

- ``SingleDeviceComm`` (``comm.py:87``): all R rows resident on one
  device (L = R); the "collectives" are plain indexing.
- ``MeshComm`` (``comm.py:112``): one replica row per rank of a
  ``torch.distributed`` process group (L = 1); on the 2-D mesh one lane
  slice of a row per rank, the replica collectives running over the
  ranks that hold the same slice of every row.

Indices may be Python ints or 0-d device tensors; a tensor index goes
through ``index_select``, which never reads the value back to the host.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch


def take(x: torch.Tensor, idx, dim: int = 0) -> torch.Tensor:
    """``x`` indexed at one position along ``dim`` with no host sync."""
    if isinstance(idx, torch.Tensor):
        return x.index_select(dim, idx.reshape(1).long()).squeeze(dim)
    return x.select(dim, int(idx))


def take_groups(x: torch.Tensor, idx: torch.Tensor,
                dim: int = 1) -> torch.Tensor:
    """The batched ``take``: for every group g, ``x[g]`` indexed at
    ``idx[g]`` along ``dim`` (``x`` [G, ...], ``idx`` [G]) — one
    ``gather``, no host sync."""
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    size = list(x.shape)
    size[dim] = 1
    index = idx.long().reshape(shape).expand(size)
    return x.gather(dim, index).squeeze(dim)


class SingleDeviceComm:
    """All R replica rows resident on one device (L == R)."""

    def __init__(self, n_replicas: int):
        self.n_replicas = n_replicas

    def replica_ids(self, device) -> torch.Tensor:
        return torch.arange(self.n_replicas, dtype=torch.int32, device=device)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def select_row(self, x: torch.Tensor, idx) -> torch.Tensor:
        return take(x, idx, 0)

    def leader_cols(self, win: torch.Tensor, leader, w: int) -> torch.Tensor:
        """Every replica's lane block replaced by the leader's:
        [B, L*w] -> [B, L*w]."""
        blocks = win.reshape(win.shape[0], self.n_replicas, w)
        return take(blocks, leader, 1).repeat(1, self.n_replicas)

    def group_leader_cols(self, win: torch.Tensor, leaders: torch.Tensor,
                          w: int) -> torch.Tensor:
        """``leader_cols`` per group: [G, B, L*w] with ``leaders`` [G]."""
        G, B = win.shape[:2]
        blocks = win.reshape(G, B, self.n_replicas, w)
        return take_groups(blocks, leaders, 2).repeat(1, 1, self.n_replicas)


class MeshComm:
    """One replica row per rank of a ``torch.distributed`` group (L = 1).

    The group (the default group when None) must be a gloo group of
    ``n_replicas * payload_shards`` ranks: the mesh has run only so, on
    the CPU or with every rank sharing one GPU. Rank ``g`` of the group
    holds replica row ``g // P`` and lane slice ``g % P`` of it
    (``P = payload_shards``, the JAX package's ``(replica, pshard)``
    mesh). The replica collectives (``all_gather``, ``broadcast_host``,
    ``select_row``, ``leader_cols``) run over the rank's pshard
    *column*, the ranks ``{r*P + p : r}``, whose subgroup rank is the
    replica row (``rank``): the counterpart of JAX's ``MeshComm(rows,
    "replica")`` under a 2-D ``shard_map``. ``all_gather_lanes`` runs
    over the rank's *row*, ``{r*P + q : q}``, for reads that reassemble a
    row's lanes. At P = 1 the column is the group itself and there is no
    row group: the groups and collectives are those of the 1-D mesh.

    Each collective is one list-form ``dist.all_gather`` (or one
    broadcast). A CUDA operand is staged through a host copy and the
    result put back on the operand's device, since gloo's collectives
    move host memory. Bool operands travel as uint8. Every rank must make
    the same calls in the same order, as the mirrored programs of the
    transport do. The mirror digest exchange (``exchange_int64``) runs
    over every rank of the group on a gloo group of its own, with
    ``exchange_timeout_s`` as its timeout."""

    def __init__(self, n_replicas: int, group=None,
                 exchange_timeout_s: float = 60.0, payload_shards: int = 1):
        import torch.distributed as dist

        P = payload_shards
        size = dist.get_world_size(group)
        if size != n_replicas * P:
            raise ValueError(
                f"MeshComm over {n_replicas} replicas x {P} payload shards "
                f"needs a process group of {n_replicas * P} ranks, got "
                f"{size}")
        backend = dist.get_backend(group)
        if backend != "gloo":
            raise ValueError(
                f"MeshComm runs over a gloo group, got {backend!r}: a "
                "device backend (NCCL, one GPU per rank) is not tried yet "
                "(ROADMAP A15b)")
        self.n_replicas = n_replicas
        self.payload_shards = P
        self.group_rank = dist.get_rank(group)
        self.rank = self.group_rank // P          # the replica row
        self.pshard = self.group_rank % P         # the lane slice
        self.collectives = 0
        self.collective_s = 0.0
        #   replica (column) collectives made and the host seconds spent
        #   in them (the mesh engine's per-tick communication cost)
        self.row_collectives = 0
        self.row_collective_s = 0.0
        #   the same for the row-group gathers (2-D mesh only)
        ranks = None if group is None else dist.get_process_group_ranks(
            group)
        world = list(range(size)) if ranks is None else list(ranks)
        # Every rank creates every group, in one order, before any
        # collective: ``new_group`` is a collective of the whole world.
        # At P = 1 the column is ``group`` itself and no row group exists.
        # The mirror digest rides a gloo group of its own, so an exchange
        # never interleaves with a data-plane collective; its timeout is
        # the exchange bound.
        self.group = group
        self._row_group = None
        if P > 1:
            cols = [dist.new_group(ranks=world[p::P], backend="gloo")
                    for p in range(P)]
            rows = [dist.new_group(ranks=world[r * P:(r + 1) * P],
                                   backend="gloo")
                    for r in range(n_replicas)]
            self.group = cols[self.pshard]
            self._row_group = rows[self.rank]
        self._digest_group = dist.new_group(
            ranks=ranks, backend="gloo",
            timeout=datetime.timedelta(seconds=exchange_timeout_s))

    def replica_ids(self, device) -> torch.Tensor:
        return torch.full((1,), self.rank, dtype=torch.int32, device=device)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.rank:self.rank + 1]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...] per-rank values -> [R, ...] on every rank."""
        import torch.distributed as dist

        src = x.contiguous()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        if src.is_cuda:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.n_replicas)]
        t0 = time.perf_counter()
        dist.all_gather(parts, src, group=self.group)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return torch.cat(parts, 0).to(device=x.device, dtype=x.dtype)

    def all_gather_host(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather`` with the result on the host, for decisions taken
        there: one copy of the operand to the host, none back."""
        return self.all_gather(x.cpu())

    def all_gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """Every lane slice of this rank's row on the host: [..., w] per
        rank -> [..., P*w], slice p at lanes [p*w, (p+1)*w) (one gather
        over the row group; ``x`` on the host at P = 1)."""
        import torch.distributed as dist

        if self._row_group is None:
            return x.detach().cpu()
        src = x.detach().to("cpu", copy=True).contiguous()
        dtype = src.dtype
        if dtype == torch.bool:
            src = src.to(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(self.payload_shards)]
        t0 = time.perf_counter()
        dist.all_gather(parts, src, group=self._row_group)
        self.row_collective_s += time.perf_counter() - t0
        self.row_collectives += 1
        return torch.cat(parts, -1).to(dtype)

    def broadcast_host(self, x: torch.Tensor, row: int) -> torch.Tensor:
        """Rank ``row``'s ``x`` on the host of every rank: every rank
        passes its own ``x`` of the same shape and dtype (the other
        ranks' values are overwritten)."""
        import torch.distributed as dist

        buf = x.detach().to("cpu", copy=True).contiguous()
        dtype = buf.dtype
        if dtype == torch.bool:
            buf = buf.to(torch.uint8)
        src = row if self.group is None else dist.get_global_rank(
            self.group, row)
        t0 = time.perf_counter()
        dist.broadcast(buf, src=src, group=self.group)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return buf.to(dtype)

    def exchange_int64(self, value: int) -> np.ndarray:
        """One int64 from every rank of the group (all R*P), in rank
        order, over the digest group (the mirror digest exchange;
        ``RaftEngine``)."""
        import torch.distributed as dist

        mine = torch.tensor([int(value)], dtype=torch.int64)
        parts = [torch.empty_like(mine)
                 for _ in range(self.n_replicas * self.payload_shards)]
        dist.all_gather(parts, mine, group=self._digest_group)
        return torch.cat(parts).numpy()

    def select_row(self, x: torch.Tensor, idx) -> torch.Tensor:
        return take(self.all_gather(x), idx, 0)

    def leader_cols(self, win: torch.Tensor, leader, w: int) -> torch.Tensor:
        """The leader rank's lane block [B, w] (``w`` = the local lanes)."""
        blocks = self.all_gather(win[None])           # [R, B, w]
        return take(blocks, leader, 0)
