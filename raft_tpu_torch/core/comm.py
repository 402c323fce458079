"""Replica-axis communication on the resident layout (port of
``raft_tpu/core/comm.py:87`` ``SingleDeviceComm``).

All R replica rows live on one device, so the "collectives" are plain
indexing. Indices may be Python ints or 0-d device tensors; a tensor index
goes through ``index_select``, which never reads the value back to the
host. The mesh placement waits for the distributed slice.
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
