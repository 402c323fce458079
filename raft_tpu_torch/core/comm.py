"""Replica-axis communication (port of ``raft_tpu/core/comm.py``).

The protocol steps of ``core.step`` reach other replica rows only through
this interface — ``replica_ids``, ``local``, ``all_gather``,
``select_row`` and ``leader_cols`` — so one body runs in two placements:

- ``SingleDeviceComm`` (``comm.py:87``): all R rows resident on one
  device (L = R); the "collectives" are plain indexing.
- ``MeshComm`` (``comm.py:112``): one replica row per rank of a
  ``torch.distributed`` process group (L = 1, the rank is the row); the
  collectives are ``dist.all_gather`` over that group.

Indices may be Python ints or 0-d device tensors; a tensor index goes
through ``index_select``, which never reads the value back to the host.
"""

from __future__ import annotations

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

    Each collective is one list-form ``dist.all_gather`` on ``group`` (the
    default group when None), which must be a gloo group of
    ``n_replicas`` ranks: the mesh has run only so, R processes on the CPU
    or sharing one GPU. A CUDA operand is staged through a host copy and
    the result put back on the operand's device, since gloo's collectives
    move host memory. Bool operands travel as uint8. Every rank must make
    the same calls in the same order, as the mirrored programs of the
    transport do."""

    def __init__(self, n_replicas: int, group=None):
        import torch.distributed as dist

        size = dist.get_world_size(group)
        if size != n_replicas:
            raise ValueError(
                f"MeshComm over {n_replicas} replicas needs a process "
                f"group of {n_replicas} ranks, got {size}")
        backend = dist.get_backend(group)
        if backend != "gloo":
            raise ValueError(
                f"MeshComm runs over a gloo group, got {backend!r}: a "
                "device backend (NCCL, one GPU per rank) is not tried yet "
                "(ROADMAP A15)")
        self.n_replicas = n_replicas
        self.group = group
        self.rank = dist.get_rank(group)

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
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, 0).to(device=x.device, dtype=x.dtype)

    def all_gather_host(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather`` with the result on the host, for decisions taken
        there: one copy of the operand to the host, none back."""
        return self.all_gather(x.cpu())

    def select_row(self, x: torch.Tensor, idx) -> torch.Tensor:
        return take(self.all_gather(x), idx, 0)

    def leader_cols(self, win: torch.Tensor, leader, w: int) -> torch.Tensor:
        """The leader rank's lane block [B, w] (``w`` = the local lanes)."""
        blocks = self.all_gather(win[None])           # [R, B, w]
        return take(blocks, leader, 0)
