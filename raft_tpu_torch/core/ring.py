"""Ring-buffer window access (port of ``raft_tpu/core/ring.py``).

Torch twins of the JAX package's XLA formulations. A window of B slots
starting at slot ``s`` covers slots ``(s + j) % C`` for j in [0, B): the
wraparound that the JAX code assembles from two contiguous pieces and a
rotation is one modular index here, with the same result on every lane
the caller's mask keeps. ``C >= 2B`` (RaftConfig) guarantees the B slots
are distinct, so an indexed copy has no colliding writes.

Writes update the buffer **in place** and return it. ``s`` and ``count``
may be Python ints or 0-d tensors on the buffer's device (no host sync).
These are also the plain versions the ring kernel (``core.ring_cuda``)
is held against.
"""

from __future__ import annotations

import torch


def window_slots(s, B: int, C: int, device) -> torch.Tensor:
    """int64[B] ring slots of a window starting at slot ``s``."""
    j = torch.arange(B, device=device, dtype=torch.int64)
    return (s + j) % C


def write_window_cols_xla(buf: torch.Tensor, win: torch.Tensor, s, count,
                          lane_sel: torch.Tensor) -> torch.Tensor:
    """Masked write of slot-major window ``win`` [B, M] into ``buf`` [C, M]
    at slots [s, s+B) mod C: rows j < count, lanes where ``lane_sel``."""
    C, B = buf.shape[0], win.shape[0]
    idx = window_slots(s, B, C, buf.device)
    j = torch.arange(B, device=buf.device, dtype=torch.int32)
    sel = (j < count)[:, None] & lane_sel[None, :]
    cur = buf.index_select(0, idx)
    buf.index_copy_(0, idx, torch.where(sel, win, cur))
    return buf


def read_window_cols(buf: torch.Tensor, s, B: int) -> torch.Tensor:
    """Slot-major window [s, s+B) mod C of ``buf`` [C, M] -> [B, M]."""
    return buf.index_select(0, window_slots(s, B, buf.shape[0], buf.device))


def write_window_rows(buf: torch.Tensor, win_t: torch.Tensor, s, count,
                      accept: torch.Tensor) -> torch.Tensor:
    """Masked write of a per-slot value window ``win_t`` [B] into the
    row-major ``buf`` [L, C]: rows where ``accept``, window rows j < count."""
    C, B = buf.shape[1], win_t.shape[0]
    idx = window_slots(s, B, C, buf.device)
    j = torch.arange(B, device=buf.device, dtype=torch.int32)
    sel = accept[:, None] & (j < count)[None, :]
    cur = buf.index_select(1, idx)
    buf.index_copy_(1, idx, torch.where(sel, win_t[None, :], cur))
    return buf


def read_window(buf: torch.Tensor, s, B: int) -> torch.Tensor:
    """Window [s, s+B) mod C of row-major ``buf`` [L, C, ...] -> [L, B, ...]."""
    return buf.index_select(1, window_slots(s, B, buf.shape[1], buf.device))
