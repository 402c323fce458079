"""The ring kernels (port of ``raft_tpu/core/ring_pallas.py``).

- K1 ``write_window_both`` (``write_window_both_tpu`` :145) writes a B-row
  window into the payload ring and the term ring in place, and returns
  the per-row Raft §5.3 conflict flags. Its plain version,
  ``write_window_both_plain``, is built from the ring twins of
  ``core.ring`` — the JAX package's XLA formulation of this step.
- K5 ``write_window_cols`` (``write_window_cols_tpu`` :208) is the masked
  payload window write with a per-lane mask, for one ring or, with a
  leading group axis, for G rings in one launch (the group programs of
  ``core.step``). Its plain version is ``core.ring.write_window_cols_xla``.

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/ring.cu`` (whose comments state the design and the bound); on a
CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from raft_tpu_torch import cuda_build
from raft_tpu_torch.core.ring import (
    per_group,
    read_window,
    write_window_cols_xla,
    write_window_rows,
)

#: kernel launches, counted where each wrapper launches its kernel
LAUNCHES = {"write_window_both": 0, "write_window_cols": 0}


def write_window_terms_plain(buf_t, win_t, s, count, ws, accept,
                             last_index) -> torch.Tensor:
    """The term half of K1's plain version: the window's terms into
    ``buf_t`` where ``accept``, and any_mm int32[L] (1 = a row holds an
    entry of another term inside the window)."""
    B = win_t.shape[0]
    j = torch.arange(B, device=buf_t.device, dtype=torch.int32)
    my_win_t = read_window(buf_t, s, B)                     # [L, B] old terms
    exists = (ws + j)[None, :] <= last_index[:, None]
    mismatch = exists & (my_win_t != win_t[None, :]) & (j < count)[None, :]
    write_window_rows(buf_t, win_t, s, count, accept)
    return mismatch.any(dim=1).to(torch.int32)


def write_window_both_plain(buf_p, buf_t, win, win_t, s, count, ws, accept,
                            last_index) -> torch.Tensor:
    """The plain version of K1: the XLA formulation of
    ``core/step.py:369-382``. Returns any_mm int32[L] (1 = conflict)."""
    L = buf_t.shape[0]
    write_window_cols_xla(buf_p, win, s, count,
                          accept.repeat_interleave(win.shape[1] // L))
    return write_window_terms_plain(buf_t, win_t, s, count, ws, accept,
                                    last_index)


def _scalar(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(x), dtype=torch.int32, device=device)


def vec4_ok(M: int, L: int, *tensors) -> bool:
    """Whether a kernel may move 16-byte lane vectors: each replica's lane
    block is a whole number of int4s and every row starts 16-byte aligned."""
    return M % 4 == 0 and (M // L) % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def vec2_ok(W: int, *tensors) -> bool:
    """Whether the parity-mode row writer may move 8-byte word pairs: the
    shard width W is even (so every window and ring row, a whole number of
    shards, is too) and every tensor starts 8-byte aligned."""
    return W % 2 == 0 and all(t.data_ptr() % 8 == 0 for t in tensors)


def write_window_both(buf_p: torch.Tensor, buf_t: torch.Tensor,
                      win: torch.Tensor, win_t: torch.Tensor, s, count, ws,
                      accept: torch.Tensor,
                      last_index: torch.Tensor) -> torch.Tensor:
    """In-place masked write of window ``win`` [B, M] / ``win_t`` [B] into
    ``buf_p`` [C, M] and ``buf_t`` [L, C] at slots [s, s+count) mod C,
    rows where ``accept`` [L]; returns any_mm int32[L], nonzero for a row
    with an existing entry (``ws + j <= last_index``) of another term inside
    the window. ``s``, ``count``, ``ws``: ints or 0-d tensors."""
    if not buf_p.is_cuda:
        return write_window_both_plain(buf_p, buf_t, win, win_t, s, count, ws,
                                       accept, last_index)
    dev = buf_p.device
    L, C = buf_t.shape
    B, M = win.shape
    if L > 32 or M % L or 2 * B > C or buf_p.shape != (C, M):
        raise ValueError(f"unsupported ring shapes: buf_p {tuple(buf_p.shape)}"
                         f" buf_t {tuple(buf_t.shape)} win {tuple(win.shape)}")
    for name, t in (("buf_p", buf_p), ("buf_t", buf_t), ("win", win)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous int32 on {dev}")
    win_t = win_t.to(device=dev, dtype=torch.int32).contiguous()
    acc = accept.to(device=dev, dtype=torch.bool).contiguous()
    last = last_index.to(device=dev, dtype=torch.int32).contiguous()
    s_t, c_t, ws_t = (_scalar(x, dev) for x in (s, count, ws))
    mm = torch.zeros(L, dtype=torch.int32, device=dev)
    lib = cuda_build.lib("ring")
    rc = lib.rt_write_window_both(
        buf_p.data_ptr(), buf_t.data_ptr(), win.data_ptr(), win_t.data_ptr(),
        s_t.data_ptr(), c_t.data_ptr(), ws_t.data_ptr(), acc.data_ptr(),
        last.data_ptr(), mm.data_ptr(), C, M, L, B,
        int(vec4_ok(M, L, buf_p, win)), cuda_build.stream_of(buf_p))
    cuda_build.check("ring", rc, "write_window_both")
    LAUNCHES["write_window_both"] += 1
    return mm


def write_window_cols(buf: torch.Tensor, win: torch.Tensor, s, count,
                      lane_sel: torch.Tensor) -> torch.Tensor:
    """In-place masked write of window ``win`` [B, M] into ``buf`` [C, M]
    at slots [s, s+B) mod C: window rows j < count, lanes where
    ``lane_sel`` [M]. With a leading group axis — ``buf`` [G, C, M],
    ``win`` [G, B, M], ``lane_sel`` [G, M], ``s``/``count`` [G] device
    tensors — one launch writes every group's window. ``s`` and ``count``
    are never read back to the host. Returns ``buf``."""
    if not buf.is_cuda:
        return write_window_cols_xla(buf, win, s, count, lane_sel)
    dev = buf.device
    grouped = buf.dim() == 3
    G = buf.shape[0] if grouped else 1
    C, M = buf.shape[-2:]
    B = win.shape[-2]
    lead = (G,) if grouped else ()
    if (buf.dim() not in (2, 3) or tuple(win.shape) != lead + (B, M)
            or tuple(lane_sel.shape) != lead + (M,) or 2 * B > C
            or G * B * M >= 2 ** 31):
        raise ValueError(f"unsupported window write: buf {tuple(buf.shape)} "
                         f"win {tuple(win.shape)} lane_sel "
                         f"{tuple(lane_sel.shape)}")
    for name, t in (("buf", buf), ("win", win)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous int32 on {dev}")
    sel = lane_sel.to(device=dev, dtype=torch.bool).contiguous()
    s_t, c_t = (per_group(x, G, dev, torch.int32).contiguous()
                for x in (s, count))
    rc = cuda_build.lib("ring").rt_write_window_cols(
        buf.data_ptr(), win.data_ptr(), s_t.data_ptr(), c_t.data_ptr(),
        sel.data_ptr(), C, M, B, G, int(vec4_ok(M, 1, buf, win)),
        cuda_build.stream_of(buf))
    cuda_build.check("ring", rc, "write_window_cols")
    LAUNCHES["write_window_cols"] += 1
    return buf
