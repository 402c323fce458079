"""Ring-buffer window access (port of ``raft_tpu/core/ring.py``).

Torch twins of the JAX package's XLA formulations. A window of B slots
starting at slot ``s`` covers slots ``(s + j) % C`` for j in [0, B): the
wraparound that the JAX code assembles from two contiguous pieces and a
rotation is one modular index here, with the same result on every lane
the caller's mask keeps. ``C >= 2B`` (RaftConfig) guarantees the B slots
are distinct, so an indexed copy has no colliding writes.

The ``group_*`` twins take a leading group axis G on every operand
(``s``, ``count`` i32[G]), as ``jax.vmap`` of the JAX functions would;
``write_window_cols_xla`` takes either form.

Writes update the buffer **in place** and return it. ``s`` and ``count``
may be Python ints or tensors on the buffer's device (no host sync).
These are also the plain versions the ring kernels (``core.ring_cuda``)
are held against.
"""

from __future__ import annotations

import torch


def window_slots(s, B: int, C: int, device) -> torch.Tensor:
    """int64[B] ring slots of a window starting at slot ``s``."""
    j = torch.arange(B, device=device, dtype=torch.int64)
    return (s + j) % C


def per_group(x, G: int, device, dtype=torch.int64) -> torch.Tensor:
    """A per-group operand — an int, a sequence, a 0-d or a [G] tensor —
    as ``dtype``[G] on ``device``. A tensor or an int never goes through
    a host copy (which would wait for the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(-1).expand(G)
    if isinstance(x, int):
        return torch.full((G,), x, dtype=dtype, device=device)
    return torch.as_tensor(x).to(device=device, dtype=dtype).reshape(
        -1).expand(G)


def group_window_slots(s, B: int, C: int, G: int, device) -> torch.Tensor:
    """int64[G, B] ring slots of each group's window (starts ``s`` [G])."""
    j = torch.arange(B, device=device, dtype=torch.int64)
    return (per_group(s, G, device)[:, None] + j) % C


def write_window_cols_xla(buf: torch.Tensor, win: torch.Tensor, s, count,
                          lane_sel: torch.Tensor) -> torch.Tensor:
    """Masked write of slot-major window ``win`` [B, M] into ``buf`` [C, M]
    at slots [s, s+B) mod C: rows j < count, lanes where ``lane_sel`` [M].
    With a leading group axis (``buf`` [G, C, M], ``win`` [G, B, M],
    ``lane_sel`` [G, M], ``s``/``count`` [G]) each group writes its own
    window. The plain version of kernel K5."""
    if buf.dim() == 2:
        write_window_cols_xla(buf[None], win[None], s, count, lane_sel[None])
        return buf
    G, C, M = buf.shape
    B = win.shape[1]
    idx = group_window_slots(s, B, C, G, buf.device)[:, :, None].expand(
        G, B, M)
    j = torch.arange(B, device=buf.device, dtype=torch.int64)
    rows = j[None, :] < per_group(count, G, buf.device)[:, None]
    sel = rows[:, :, None] & lane_sel[:, None, :]
    buf.scatter_(1, idx, torch.where(sel, win, buf.gather(1, idx)))
    return buf


def read_window_cols(buf: torch.Tensor, s, B: int) -> torch.Tensor:
    """Slot-major window [s, s+B) mod C of ``buf`` [C, M] -> [B, M]."""
    return buf.index_select(0, window_slots(s, B, buf.shape[0], buf.device))


def group_read_window_cols(buf: torch.Tensor, s, B: int) -> torch.Tensor:
    """Each group's window of ``buf`` [G, C, M] at ``s`` [G] -> [G, B, M]."""
    G, C, M = buf.shape
    idx = group_window_slots(s, B, C, G, buf.device)
    return buf.gather(1, idx[:, :, None].expand(G, B, M))


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


def group_write_window_rows(buf: torch.Tensor, win_t: torch.Tensor, s,
                            count, accept: torch.Tensor) -> torch.Tensor:
    """``write_window_rows`` per group: ``buf`` [G, L, C], ``win_t``
    [G, B], ``s``/``count`` [G], ``accept`` [G, L]."""
    G, L, C = buf.shape
    B = win_t.shape[1]
    idx = group_window_slots(s, B, C, G, buf.device)[:, None, :].expand(
        G, L, B)
    j = torch.arange(B, device=buf.device, dtype=torch.int64)
    rows = j[None, :] < per_group(count, G, buf.device)[:, None]
    sel = accept[:, :, None] & rows[:, None, :]
    buf.scatter_(2, idx, torch.where(sel, win_t[:, None, :],
                                     buf.gather(2, idx)))
    return buf


def read_window(buf: torch.Tensor, s, B: int) -> torch.Tensor:
    """Window [s, s+B) mod C of row-major ``buf`` [L, C, ...] -> [L, B, ...]."""
    return buf.index_select(1, window_slots(s, B, buf.shape[1], buf.device))


def group_read_window(buf: torch.Tensor, s, B: int) -> torch.Tensor:
    """Each group's window of row-major ``buf`` [G, L, C] at ``s`` [G]
    -> [G, L, B]."""
    G, L, C = buf.shape
    idx = group_window_slots(s, B, C, G, buf.device)
    return buf.gather(2, idx[:, None, :].expand(G, L, B))
