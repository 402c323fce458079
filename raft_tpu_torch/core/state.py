"""Replica-major device state (port of ``raft_tpu/core/state.py``).

The layout is the JAX package's, tensor for tensor, so a state carries
across with ``state_from_numpy`` / ``state_to_numpy``:

- six int32[R] protocol vectors (term, vote, last/commit index, verified
  match index and the term that match is valid for);
- the term ring ``log_term`` int32[R, C];
- the payload ring ``log_payload`` int32[C, R*W]: slot-major, replica r's
  bytes for slot c are lanes [r*W, (r+1)*W) of row c, W = shard_bytes // 4
  words, packed little-endian exactly as numpy's ``view(np.int32)``.

On the mesh transport each rank holds one row of that layout (R = 1:
vectors [1], ``log_term`` [1, C], ``log_payload`` [C, W]); ``cut_row`` and
``stack_rows`` carry between the two.

Log indices are 1-based; index i lives in ring slot ``(i - 1) % C``.

The device step functions update the two rings **in place** and return a
state holding them, so a state passed to a step is consumed: keep a
``clone()`` where the old value is still needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig

NO_VOTE = -1

# Packed membership mask bits (learner phase, dissertation §4.2.1): bit 0
# marks a VOTER of the current configuration, bit 1 a non-voting LEARNER.
VOTER_BIT = 1
LEARNER_BIT = 2

#: field order of the leaves, shared by the numpy carry-across pair
FIELDS = ("term", "voted_for", "last_index", "commit_index", "match_index",
          "match_term", "log_term", "log_payload")


def pack_membership(member: np.ndarray, learner: np.ndarray) -> np.ndarray:
    """Host masks (voters, learners) -> packed int32[R] membership mask."""
    m = np.asarray(member, bool)
    l = np.asarray(learner, bool)
    if (m & l).any():
        raise ValueError("a row cannot be both voter and learner")
    return m.astype(np.int32) * VOTER_BIT + l.astype(np.int32) * LEARNER_BIT


def membership_voters(mask: torch.Tensor) -> torch.Tensor:
    """The bool voter mask of a membership mask: identity for bool masks,
    the ``VOTER_BIT`` plane of a packed int mask."""
    if mask.dtype == torch.bool:
        return mask
    return (mask & VOTER_BIT) != 0


@dataclasses.dataclass
class ReplicaState:
    """All per-replica durable + volatile state, replica-major (R rows,
    C ring slots, W int32 words per entry per replica)."""

    term: torch.Tensor          # i32[R]
    voted_for: torch.Tensor     # i32[R]  -1 = no vote this term
    last_index: torch.Tensor    # i32[R]  index of the last entry (0 = empty)
    commit_index: torch.Tensor  # i32[R]
    match_index: torch.Tensor   # i32[R]  highest index verified consistent
    #                                     with the current leader
    match_term: torch.Tensor    # i32[R]  leader term match_index is valid for
    log_term: torch.Tensor      # i32[R, C]
    log_payload: torch.Tensor   # i32[C, R*W]

    @property
    def capacity(self) -> int:
        return self.log_term.shape[-1]

    @property
    def words_per_entry(self) -> int:
        return self.log_payload.shape[1] // self.term.shape[0]

    @property
    def device(self) -> torch.device:
        return self.log_payload.device

    def replace(self, **changes) -> "ReplicaState":
        return dataclasses.replace(self, **changes)

    def clone(self) -> "ReplicaState":
        return ReplicaState(*(getattr(self, f).clone() for f in FIELDS))


def init_state(cfg: RaftConfig, rows: Optional[int] = None,
               device="cuda") -> ReplicaState:
    """Zero state for ``rows`` replica rows (default ``cfg.rows``): term 0,
    no vote, empty log, commit 0."""
    r = cfg.rows if rows is None else rows
    c, w = cfg.log_capacity, cfg.shard_words

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return ReplicaState(
        term=zeros(r),
        voted_for=torch.full((r,), NO_VOTE, dtype=torch.int32, device=device),
        last_index=zeros(r),
        commit_index=zeros(r),
        match_index=zeros(r),
        match_term=zeros(r),
        log_term=zeros(r, c),
        log_payload=zeros(c, r * w),
    )


def init_group_state(cfg: RaftConfig, n_groups: int,
                     rows: Optional[int] = None,
                     device="cuda") -> ReplicaState:
    """Zero state for ``n_groups`` independent Raft groups as one batched
    state: every leaf of ``init_state`` gains a leading group axis G
    (``log_term`` [G, R, C], ``log_payload`` [G, C, R*W]), so the group
    programs of ``core.step`` move all G groups in one batched call. The
    shape-derived properties (``words_per_entry``) assume the unbatched
    layout: slice a group out with ``group_view`` first."""
    one = init_state(cfg, rows, device)
    return ReplicaState(*(
        getattr(one, f).unsqueeze(0).repeat(
            (n_groups,) + (1,) * getattr(one, f).dim())
        for f in FIELDS))


def group_view(state: ReplicaState, g: int) -> ReplicaState:
    """Group ``g`` of a group-batched state as an unbatched state. Its
    leaves are views sharing the batched storage: a step run on the view
    updates the group in place; ``clone()`` it to keep a copy."""
    return ReplicaState(*(getattr(state, f)[g] for f in FIELDS))


def as_group(state: ReplicaState) -> ReplicaState:
    """An unbatched state as a group-batched one with G = 1 (views); the
    inverse of ``group_view(state, 0)``."""
    return ReplicaState(*(getattr(state, f)[None] for f in FIELDS))


def state_from_numpy(fields: dict, device="cuda") -> ReplicaState:
    """A state from numpy leaves keyed by field name — e.g. a JAX
    ``ReplicaState`` taken through ``jax.tree.map(np.asarray, ...)`` and
    ``dataclasses.asdict``-style access. Every leaf becomes int32 and keeps
    its shape, so group-batched states carry across too."""
    return ReplicaState(*(
        torch.from_numpy(np.array(fields[f], dtype=np.int32, copy=True))
        .to(device) for f in FIELDS
    ))


def state_to_numpy(state: ReplicaState) -> dict:
    """Numpy leaves keyed by field name (the inverse of
    ``state_from_numpy``)."""
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}


def cut_row(fields: dict, r: int) -> dict:
    """Replica row ``r`` of a whole-cluster state given as numpy leaves
    (``state_to_numpy``, or ``np.asarray`` of each leaf of a JAX
    ``TpuMeshTransport`` state): the rank-local state of the mesh
    transport — vectors [1], ``log_term`` [1, C], ``log_payload`` [C, W]."""
    R = np.shape(fields["term"])[0]
    W = np.shape(fields["log_payload"])[1] // R
    out = {f: np.array(fields[f][r:r + 1], dtype=np.int32)
           for f in FIELDS if f != "log_payload"}
    out["log_payload"] = np.array(
        fields["log_payload"][:, r * W:(r + 1) * W], dtype=np.int32)
    return out


def stack_rows(parts) -> dict:
    """The inverse of ``cut_row``: R rank-local numpy states, in rank
    order, stacked back into one whole-cluster state."""
    out = {f: np.concatenate([p[f] for p in parts], axis=0)
           for f in FIELDS if f != "log_payload"}
    out["log_payload"] = np.concatenate([p["log_payload"] for p in parts],
                                        axis=1)
    return out


def slot_of(index, capacity: int):
    """Ring slot of 1-based log index ``index`` (floor mod, like JAX's)."""
    return (index - 1) % capacity


def fold_batch(data: np.ndarray, rows: int, batch: int | None = None,
               device="cpu") -> torch.Tensor:
    """Host-pack a u8[n, S] entry batch into the payload format
    i32[batch, rows*W], replicating the bytes into every replica's lane
    block. Pads to ``batch``. The pack happens on the host; ``device``
    says where the result goes."""
    n, s = data.shape
    b = n if batch is None else batch
    words = np.zeros((b, s // 4), np.int32)
    if n:
        words[:n] = np.ascontiguousarray(data).view(np.int32)
    return torch.from_numpy(np.tile(words, (1, rows))).to(device)


def fold_rows(rows_u8: np.ndarray, batch: int | None = None,
              device="cpu") -> torch.Tensor:
    """Host-pack per-replica u8[L, n, Sk] payloads (distinct bytes per
    replica) into i32[batch, L*W]."""
    l, n, s = rows_u8.shape
    b = n if batch is None else batch
    out = np.zeros((b, l * (s // 4)), np.int32)
    if n:
        out[:n] = (
            np.ascontiguousarray(np.swapaxes(rows_u8, 0, 1))
            .view(np.int32).reshape(n, l * (s // 4))
        )
    return torch.from_numpy(out).to(device)


def unfold_bytes(words) -> np.ndarray:
    """i32[..., W] payload lanes -> u8[..., 4*W] bytes (host view)."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    w = np.ascontiguousarray(np.asarray(words, dtype=np.int32))
    return w.view(np.uint8).reshape(w.shape[:-1] + (w.shape[-1] * 4,))


def log_entries(state: ReplicaState, replica: int, lo: int,
                hi: int) -> np.ndarray:
    """Host read of payload bytes u8[hi-lo+1, S] for indices [lo, hi] on
    one replica row. Only the requested slots leave the device."""
    w = state.words_per_entry
    if hi < lo:
        return np.zeros((0, 4 * w), np.uint8)
    idx = torch.arange(lo, hi + 1, device=state.device, dtype=torch.int64)
    slots = (idx - 1) % state.capacity
    rows = state.log_payload[:, replica * w:(replica + 1) * w]
    return unfold_bytes(rows.index_select(0, slots))


def payload_slot_bytes(state: ReplicaState, replica: int) -> np.ndarray:
    """Host view of one replica's whole ring as bytes — u8[C, S]."""
    w = state.words_per_entry
    return unfold_bytes(state.log_payload[:, replica * w:(replica + 1) * w])


def committed_payloads(state: ReplicaState, replica: int) -> np.ndarray:
    """The committed log prefix of one replica as raw bytes [n, S]."""
    hi = int(state.commit_index[replica])
    return log_entries(state, replica, 1, hi)


def last_log_term(state: ReplicaState) -> torch.Tensor:
    """Term of each replica's last entry (0 for an empty log) — i32[R], or
    i32[G, R] for a group-batched state."""
    slot = slot_of(state.last_index.clamp(min=1), state.capacity)
    t = torch.gather(state.log_term, -1, slot[..., None].long())[..., 0]
    return torch.where(state.last_index > 0, t, 0)
