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
vectors [1], ``log_term`` [1, C], ``log_payload`` [C, W]; on the 2-D mesh
of P payload shards, rank ``g`` holds row ``g // P`` with lane block
``g``, [C, W/P]); ``cut_row`` and ``stack_rows`` carry between the two. The functions here that read or
write a given replica's row take ``view``: the row access of the
transport that placed the state (``ResidentView`` for a state that holds
every row, the default; ``transport.MeshTransport`` on the mesh, where a
read of another rank's row is a collective every rank makes and a write
lands only on the rank that holds the row).

Log indices are 1-based; index i lives in ring slot ``(i - 1) % C``.

The device step functions update the two rings **in place** and return a
state holding them, so a state passed to a step is consumed: keep a
``clone()`` where the old value is still needed.
"""

from __future__ import annotations

import dataclasses
import re
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


def host_copy(x) -> np.ndarray:
    """A host copy of a tensor (never a view of a CPU tensor that a step
    may later update in place). A CPU tensor is copied as numpy, so the
    copy keeps no tensor alive (the memory plane's census counts live
    tensors)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu":
            return x.detach().numpy().copy()
        return x.detach().cpu().numpy()
    return np.array(x)


class ResidentView:
    """Row access of a state that holds every replica row (the resident
    layout): replica r is row r, every read is a host copy and a host
    [R, ...] value is placed whole. ``MeshTransport`` has the same
    methods for one row (or one lane slice of a row) a rank."""

    resident = True

    def local_row(self, row: int):
        """Index of replica ``row`` in the state, or None when another
        process holds it."""
        return row

    def fetch_rows(self, x: torch.Tensor, dim: int = 0) -> np.ndarray:
        """Host view of every replica row of a row-sharded value (the row
        axis at ``dim``)."""
        return host_copy(x)

    def fetch_row(self, x: torch.Tensor, row: int, dim: int = 0
                  ) -> np.ndarray:
        """Host view of replica ``row`` of a row-sharded value, the row
        axis at ``dim`` removed."""
        return host_copy(x.select(dim, row))

    def place_rows(self, host, like: torch.Tensor,
                   dim: int = 0) -> torch.Tensor:
        """The rows this process holds of a host [R, ...] value (row axis
        at ``dim``), as a tensor of ``like``'s dtype and device."""
        return torch.as_tensor(np.asarray(host)).to(
            device=like.device, dtype=like.dtype).contiguous()

    def lane_slice(self, shards):
        """The bytes this process holds of a shard batch u8[N, Sk]: all
        of them (a 2-D mesh rank holds one slice)."""
        return shards


RESIDENT = ResidentView()


def init_state(cfg: RaftConfig, rows: Optional[int] = None,
               device="cuda", words: Optional[int] = None,
               rings=None) -> ReplicaState:
    """Zero state for ``rows`` replica rows (default ``cfg.rows``) of
    ``words`` payload lanes each (default ``cfg.shard_words``; a 2-D mesh
    rank holds W/P): term 0, no vote, empty log, commit 0. ``rings``
    (``log_term``, ``log_payload``), already zero, are used in place of
    new ring tensors."""
    r = cfg.rows if rows is None else rows
    c = cfg.log_capacity
    w = cfg.shard_words if words is None else words

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return ReplicaState(
        term=zeros(r),
        voted_for=torch.full((r,), NO_VOTE, dtype=torch.int32, device=device),
        last_index=zeros(r),
        commit_index=zeros(r),
        match_index=zeros(r),
        match_term=zeros(r),
        log_term=zeros(r, c) if rings is None else rings[0],
        log_payload=zeros(c, r * w) if rings is None else rings[1],
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


# --------------------------------------------------------------------------
# Group-axis mesh layout (``raft_tpu/core/state.py:218-314``): the group
# axis of a group-batched state split over a ``gshard`` mesh axis, written
# as a rule table over leaf names. A spec is a plain tuple of axis names:
# ``(GROUP_AXIS,)`` splits the leading axis, ``()`` keeps the leaf whole on
# every shard. A leaf that no rule names raises.

#: Mesh axis names of the group layout: ``gshard`` splits the group axis;
#: ``replica`` is kept for replica-row placement and has size 1 (each shard
#: holds all R rows of its groups).
GROUP_AXIS = "gshard"
REPLICA_AXIS = "replica"


def group_partition_rules():
    """The (group, replica) layout as ``(regex, spec)`` pairs over leaf
    names, matched in order: every ``ReplicaState`` leaf leads with the
    group axis, and each is named explicitly (no catch-all)."""
    return (
        # the payload ring: [G, C, R*W] — slots and lanes stay local
        (r"log_payload$", (GROUP_AXIS,)),
        # the term ring: [G, R, C]
        (r"log_term$", (GROUP_AXIS,)),
        # per-replica scalar planes — [G, R]
        (r"^(term|voted_for|last_index|commit_index"
         r"|match_index|match_term)$", (GROUP_AXIS,)),
    )


def _map_named(fn, tree, prefix: str = ""):
    """``fn(name, leaf)`` over a ``ReplicaState`` (or any dataclass) or a
    dict of leaves, names '/'-joined from the field names and keys; the
    result keeps the tree's structure."""
    def name(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: _map_named(fn, getattr(tree, f.name), name(f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, name(k)) for k, v in tree.items()}
    return fn(prefix, tree)


def match_partition_rules(rules, tree):
    """Rule table -> the tree's specs: each leaf matched by name against
    ``rules`` in order. A scalar or single-element leaf gets ``()``; a
    leaf no rule matches raises (it would otherwise be copied whole onto
    every shard)."""
    def spec_of(name, leaf):
        shape = np.shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return ()
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        raise ValueError(f"no partition rule matched leaf {name!r}")

    return _map_named(spec_of, tree)


def make_shard_and_gather_fns(mesh, specs):
    """Specs -> (shard_fns, gather_fns), in the specs' structure.
    ``mesh`` is a ``transport.group_mesh.GroupMesh``. A shard function
    takes a host array or tensor and returns one tensor a shard, each on
    its shard's device: ``(GROUP_AXIS,)`` cuts the leading axis into
    ``n_shards`` equal blocks, ``()`` copies the whole value. A gather
    function takes those parts and returns the whole value as numpy."""
    devices = list(mesh.devices)
    n = len(devices)

    def make_shard_fn(spec):
        def shard_fn(x):
            t = torch.as_tensor(np.asarray(x)) if not isinstance(
                x, torch.Tensor) else x
            if GROUP_AXIS not in spec:
                return [t.to(d, copy=True) for d in devices]
            if t.shape[0] % n:
                raise ValueError(
                    f"leading axis {t.shape[0]} does not split over "
                    f"{n} shards")
            b = t.shape[0] // n
            return [t[k * b:(k + 1) * b].to(d, copy=True).contiguous()
                    for k, d in enumerate(devices)]
        return shard_fn

    def make_gather_fn(spec):
        def gather_fn(parts):
            if GROUP_AXIS not in spec:
                return host_copy(parts[0])
            return np.concatenate([host_copy(p) for p in parts], axis=0)
        return gather_fn

    return (_map_named(lambda _, spec: make_shard_fn(spec), specs),
            _map_named(lambda _, spec: make_gather_fn(spec), specs))


def group_state_specs(cfg: RaftConfig, n_groups: int) -> ReplicaState:
    """The group-batched state's specs through the rule table, from a
    shape-only zero state (the ``meta`` device), so the specs follow the
    dataclass."""
    tmpl = init_group_state(cfg, n_groups, device="meta")
    return match_partition_rules(group_partition_rules(), tmpl)


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


def cut_row(fields: dict, r: int, payload_shards: int = 1) -> dict:
    """Rank ``r``'s part of a whole-cluster state given as numpy leaves
    (``state_to_numpy``, or ``np.asarray`` of each leaf of a JAX
    ``TpuMeshTransport`` state): the rank-local state of the mesh
    transport — vectors [1], ``log_term`` [1, C] of replica row
    ``r // payload_shards`` and ``log_payload`` [C, W/P], lane block ``r``
    of the folded [R x P x W/P] layout (at P = 1 rank r is row r)."""
    P = payload_shards
    R = np.shape(fields["term"])[0]
    w = np.shape(fields["log_payload"])[1] // (R * P)
    row = r // P
    out = {f: np.array(fields[f][row:row + 1], dtype=np.int32)
           for f in FIELDS if f != "log_payload"}
    out["log_payload"] = np.array(
        fields["log_payload"][:, r * w:(r + 1) * w], dtype=np.int32)
    return out


def stack_rows(parts, payload_shards: int = 1) -> dict:
    """The inverse of ``cut_row``: the R*P rank-local numpy states, in
    rank order, stacked back into one whole-cluster state (each row's
    vectors and terms taken from its first rank)."""
    out = {f: np.concatenate([p[f] for p in parts[::payload_shards]],
                             axis=0)
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
                hi: int, view=None) -> np.ndarray:
    """Host read of payload bytes u8[hi-lo+1, S] for indices [lo, hi] on
    one replica row. Only the requested slots leave the device; on the
    mesh (``view``) the holder's slots reach every rank, at full width
    (on the 2-D mesh stitched from the row's slices)."""
    w = state.words_per_entry
    if hi < lo:
        full = w * getattr(view, "payload_shards", 1)
        return np.zeros((0, 4 * full), np.uint8)
    idx = torch.arange(lo, hi + 1, device=state.device, dtype=torch.int64)
    slots = (idx - 1) % state.capacity
    if view is None or view.resident:
        rows = state.log_payload[:, replica * w:(replica + 1) * w]
        return unfold_bytes(rows.index_select(0, slots))
    # this rank's row [N, w] with its row axis; the holder's reaches all
    mine = state.log_payload.index_select(0, slots)[:, None]
    return unfold_bytes(view.fetch_row_lanes(mine, replica, 1))


def payload_slot_bytes(state: ReplicaState, replica: int) -> np.ndarray:
    """Host view of one replica's whole ring as bytes — u8[C, S]."""
    w = state.words_per_entry
    return unfold_bytes(state.log_payload[:, replica * w:(replica + 1) * w])


def committed_payloads(state: ReplicaState, replica: int,
                       view=None) -> np.ndarray:
    """The committed log prefix of one replica as raw bytes [n, S]."""
    view = RESIDENT if view is None else view
    hi = int(view.fetch_rows(state.commit_index)[replica])
    return log_entries(state, replica, 1, hi, view)


def last_log_term(state: ReplicaState) -> torch.Tensor:
    """Term of each replica's last entry (0 for an empty log) — i32[R], or
    i32[G, R] for a group-batched state."""
    slot = slot_of(state.last_index.clamp(min=1), state.capacity)
    t = torch.gather(state.log_term, -1, slot[..., None].long())[..., 0]
    return torch.where(state.last_index > 0, t, 0)
