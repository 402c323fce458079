"""Group-axis mesh transport: G Raft groups laid out ``(group, replica)``
over a list of devices (port of ``raft_tpu/transport/group_mesh.py``).

``MultiEngine``'s resident layout holds all G groups on one device and
moves them in one batched launch. Past a few hundred groups that is a
sharding problem, not a batching one: the group axis splits over a
``gshard`` mesh axis, and each shard runs the same group program over its
own block of groups.

Layout (``core.state.group_partition_rules``): every group-state leaf
splits its leading group axis over ``gshard``; ring slots, payload lanes
and replica rows stay shard-local, so each shard holds all R rows of its
groups and the group step bodies (``core.step.group_replicate_step``,
``group_vote_step``, ``fused_group_scan``) run unchanged on each block.
The ``replica`` axis is declared for a later replica-row spread and has
size 1. Groups are block-placed: physical slot ``s`` lives on shard
``s // (G / n_shards)``. The ENGINE owns the logical -> physical slot
table, which makes a group migration a slot permutation on the devices
(``swap_slots``) instead of a state hand-off.

What differs from the JAX transport is the mechanism, not the result:

- ``GroupMesh`` stands in for the 2-axis ``jax.sharding.Mesh`` and may
  repeat a device: two shards on ``cuda:0`` is the only sharded layout
  one card can run.
- A sharded state is a list of ``ReplicaState`` blocks, one a shard
  (``[G / n_shards, ...]`` leaves on that shard's device), where JAX has
  one global array a leaf.
- A program is one launch a shard, in shard order, where JAX makes one
  ``shard_map`` launch. Groups never communicate, so each group's result
  is the resident program's bit for bit. Results come back as one
  [G, ...] value a field in physical slot order (joined on the first
  shard's device), as JAX's ``out_specs`` give them.
- Swaps write both slots in place, so the rings keep their addresses and
  a captured CUDA graph of the fused window stays valid; a swap between
  two devices copies across.
- The compile plane's labels (``group_mesh.replicate``, ``.vote``,
  ``.fused``, ``.swap``, ``.ring_swap``) sit on the methods, where JAX
  labels the cached ``shard_map`` programs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.graphs import run_group_launch
from raft_tpu_torch.core.state import (
    FIELDS,
    GROUP_AXIS,
    REPLICA_AXIS,
    ReplicaState,
    group_state_specs,
    make_shard_and_gather_fns,
)
from raft_tpu_torch.core.step import (
    RepInfo,
    VoteInfo,
    fused_group_scan,
    group_replicate_step,
    group_vote_step,
)
from raft_tpu_torch.obs import blackbox
from raft_tpu_torch.obs.compile import labeled_method


def n_shards_for(n_groups: int, n_devices: int) -> int:
    """Largest shard count that divides G and fits the device set (block
    placement needs equal-sized shards)."""
    for d in range(min(n_groups, max(n_devices, 1)), 0, -1):
        if n_groups % d == 0:
            return d
    return 1


class GroupMesh:
    """The 2-axis ``(gshard, replica)`` mesh: ``devices`` holds one
    ``torch.device`` a shard (a device may repeat), and the replica axis
    has size 1."""

    axis_names = (GROUP_AXIS, REPLICA_AXIS)

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a GroupMesh needs at least one device")
        self.shape = {GROUP_AXIS: len(self.devices), REPLICA_AXIS: 1}

    def __repr__(self) -> str:
        return f"GroupMesh({[str(d) for d in self.devices]})"


def visible_cards() -> List[torch.device]:
    """One entry a visible CUDA card; raises without one (the port runs on
    the card unless the caller names the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; the group mesh runs on the "
            "visible cards unless mesh= or devices= names others")
    return [torch.device("cuda", i) for i in range(n)]


class GroupMeshTransport:
    """The ``transport="mesh_groups"`` backend (module docstring).

    Takes a ``GroupMesh`` (axes ``('gshard', 'replica')``) or builds one
    from ``devices``, by default the visible CUDA cards. Every program
    runs the resident engine's group callables on each shard's block, so
    the sharded and resident paths share one step body."""

    def __init__(
        self,
        cfg: RaftConfig,
        n_groups: int,
        mesh: Optional[GroupMesh] = None,
        devices: Optional[Sequence] = None,
    ):
        self.cfg = cfg
        self.G = n_groups
        R = cfg.n_replicas
        if mesh is not None:
            if GROUP_AXIS not in mesh.axis_names:
                raise ValueError(
                    f"mesh must carry a {GROUP_AXIS!r} axis "
                    f"(got {mesh.axis_names})"
                )
            self.n_shards = mesh.shape[GROUP_AXIS]
            if n_groups % self.n_shards:
                raise ValueError(
                    f"n_groups ({n_groups}) must divide evenly over the "
                    f"{self.n_shards}-way {GROUP_AXIS!r} axis"
                )
            self.mesh = mesh
        else:
            devices = (list(devices) if devices is not None
                       else visible_cards())
            self.n_shards = n_shards_for(n_groups, len(devices))
            self.mesh = GroupMesh(devices[: self.n_shards])
        # write-before-block (obs.blackbox), JAX's mark and fields
        blackbox.mark(
            "group_mesh_build", groups=n_groups, shards=self.n_shards,
            rows=R,
        )
        self.devices = self.mesh.devices
        self.groups_per_shard = n_groups // self.n_shards
        self._state_specs = group_state_specs(cfg, n_groups)
        self._shard_fns, self._gather_fns = make_shard_and_gather_fns(
            self.mesh, self._state_specs
        )
        self._programs = {
            (kind, rec): build(R, record=rec)
            for kind, build in (("replicate", group_replicate_step),
                                ("vote", group_vote_step),
                                ("fused", fused_group_scan))
            for rec in (False, True)}
        blackbox.mark("group_mesh_ready", shards=self.n_shards)

    # ------------------------------------------------------------ placement
    def shard_of_slot(self, slot: int) -> int:
        """Physical shard of physical group slot ``slot`` (block layout)."""
        return slot // self.groups_per_shard

    def shard_state(self, state: ReplicaState) -> List[ReplicaState]:
        """Place a whole group state (tensors on any device) onto the mesh
        with the rule-table layout: one block a shard, fresh copies."""
        parts = {f: getattr(self._shard_fns, f)(getattr(state, f))
                 for f in FIELDS}
        return [ReplicaState(**{f: parts[f][k] for f in FIELDS})
                for k in range(self.n_shards)]

    def gather_state(self, state: List[ReplicaState]) -> dict:
        """The whole state as numpy leaves keyed by field name
        (``core.state.state_to_numpy``'s form), physical slot order."""
        return {f: getattr(self._gather_fns, f)(
            [getattr(b, f) for b in state]) for f in FIELDS}

    def split(self, x, dim: int = 0) -> list:
        """A value with its group axis at ``dim`` as one part a shard, on
        the shard's device (a view where it already lies there). A list
        is taken as already split; a value without that axis (a scalar)
        goes to every shard whole."""
        if isinstance(x, (list, tuple)):
            return list(x)
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        if x.dim() <= dim:
            return [x.to(d) for d in self.devices]
        b = self.groups_per_shard
        return [x.narrow(dim, k * b, b).to(d)
                for k, d in enumerate(self.devices)]

    def cat(self, parts: Sequence[torch.Tensor],
            dim: int = 0) -> torch.Tensor:
        """Per-shard parts joined along their group axis ``dim`` on the
        first shard's device: the whole value in physical slot order."""
        d0 = self.devices[0]
        return torch.cat([p.to(d0) for p in parts], dim)

    def shard_payloads(self, payloads) -> list:
        """A group-leading payload batch (``[G, ...]``, or ``[K, G, ...]``
        untiled for the fused window) split over ``gshard``."""
        return self.split(payloads, 0 if payloads.ndim == 3 else 1)

    def shard_rings(self, rings) -> list:
        """The per-group event ring (``obs.device.init_group_rings``: a
        leading group axis on its four tensors) as one ring a shard, each
        a copy on the shard's device (rings are updated in place)."""
        from raft_tpu_torch.obs.device import EventRing

        parts = [self.split(t) for t in rings.tensors()]
        return [EventRing(*(p[k].clone() for p in parts))
                for k in range(self.n_shards)]

    def upload(self, host: np.ndarray, shard: int) -> torch.Tensor:
        """One host array on shard ``shard``'s device (a launch's upload
        for that shard)."""
        return torch.from_numpy(host).to(self.devices[shard])

    # ------------------------------------------------------------- programs
    def _each(self, kind: str, state, ops, rings, gids):
        """Run program ``kind`` on every shard's block with its part of
        each operand; returns (blocks, per-shard infos, per-shard outs
        after the info, rings or None)."""
        rec = rings is not None
        prog = self._programs[kind, rec]
        gids = self.split(gids) if rec else None
        blocks, infos, rest, new_rings = [], [], [], []
        for k, blk in enumerate(state):
            out = prog(blk, *(o[k] for o in ops),
                       *((rings[k], gids[k]) if rec else ()))
            if rec:
                new_rings.append(out[-1])
                out = out[:-1]
            blocks.append(out[0])
            infos.append(out[1])
            rest.append(out[2:])
        return blocks, infos, rest, (new_rings if rec else None)

    def _join(self, infos, cls, dim: int = 0):
        return cls(*(self.cat([getattr(i, f) for i in infos], dim)
                     for f in cls._fields))

    @labeled_method("group_mesh.replicate")
    def replicate(self, state, payloads, counts, leaders, lterms, eff,
                  slow, member, rings=None, gids=None):
        """One batched replicate launch on every shard: the operand
        contract of the resident ``group_replicate_step`` (every leading
        axis G, physical slot order; a list is one part a shard).
        Returns ``(state, RepInfo[G][, rings])``."""
        ops = [self.split(x) for x in (payloads, counts, leaders, lterms,
                                       eff, slow, member)]
        blocks, infos, _, rg = self._each("replicate", state, ops, rings,
                                          gids)
        out = (blocks, self._join(infos, RepInfo))
        return out if rg is None else out + (rg,)

    @labeled_method("group_mesh.vote")
    def request_votes(self, state, candidates, cterms, eff, rings=None,
                      gids=None):
        """One batched vote launch on every shard (``group_vote_step``'s
        contract). Returns ``(state, VoteInfo[G][, rings])``."""
        ops = [self.split(x) for x in (candidates, cterms, eff)]
        blocks, infos, _, rg = self._each("vote", state, ops, rings, gids)
        out = (blocks, self._join(infos, VoteInfo))
        return out if rg is None else out + (rg,)

    def _fused_out(self, blocks, infos, rest, rg):
        out = (blocks, self._join(infos, RepInfo, 1),
               self.cat([r[0] for r in rest], 1),
               self.cat([r[1] for r in rest], 1),
               self.cat([r[2] for r in rest], 0))
        return out if rg is None else out + (rg,)

    @labeled_method("group_mesh.fused")
    def replicate_fused(self, state, payloads, counts, n_run, halted0,
                        leaders, terms, alive, slow, member, rings=None,
                        gids=None):
        """The K-tick fused group window on every shard
        (``fused_group_scan``'s contract: payloads [K, G, B, W] untiled,
        counts [K, G], per-group ``halted0`` split with the groups).
        Returns ``(state, infos[K, G], escaped[K, G], ran[K, G],
        halted[G][, rings])``."""
        ops = ([self.split(payloads, 1), self.split(counts, 1),
                self.split(n_run)]
               + [self.split(x) for x in (halted0, leaders, terms, alive,
                                          slow, member)])
        return self._fused_out(*self._each("fused", state, ops, rings,
                                           gids))

    @labeled_method("group_mesh.fused")
    def replicate_fused_packed(self, state, hosts, K: int, B: int, W: int,
                               graphs=None, rings=None, gids=None):
        """The fused window from packed host inputs, one array a shard
        (``core.graphs.pack_group_launch`` at ``groups_per_shard``): one
        replay of the shard's own graph set when ``graphs``
        (``core.graphs.FusedGroupGraphs``) is given, else the uncaptured
        program from one upload a shard. Returns as
        :meth:`replicate_fused`."""
        rec = rings is not None
        prog = self._programs["fused", rec]
        blocks, infos, rest, new_rings = [], [], [], []
        for k, blk in enumerate(state):
            ring_args = (rings[k], gids[k]) if rec else ()
            if graphs is not None:
                out = graphs.run(blk, hosts[k], K, B, W, *ring_args,
                                 shard=k)
            else:
                out = run_group_launch(prog, blk, self.upload(hosts[k], k),
                                       K, B, W, *ring_args)
            if rec:
                new_rings.append(out[-1])
            blocks.append(out[0])
            infos.append(out[1])
            rest.append(out[2:5])
        return self._fused_out(blocks, infos, rest,
                               new_rings if rec else None)

    # ---------------------------------------------------------------- swaps
    def _at(self, parts, slot: int) -> torch.Tensor:
        k, i = divmod(slot, self.groups_per_shard)
        return parts[k][i]

    def _permute(self, leaves, perm) -> None:
        """New slot ``s`` takes old slot ``perm[s]``, in place on every
        leaf (each a list of per-shard parts): the moved slots are read
        first, then written, each across to its shard's device."""
        perm = np.asarray(perm, np.int64)
        if sorted(perm.tolist()) != list(range(self.G)):
            raise ValueError("perm must be a permutation of the G slots")
        moved = [int(s) for s in np.flatnonzero(perm != np.arange(self.G))]
        for parts in leaves:
            vals = [self._at(parts, int(perm[s])).clone() for s in moved]
            for s, v in zip(moved, vals):
                dst = self._at(parts, s)
                dst.copy_(v.to(dst.device))

    @labeled_method("group_mesh.swap")
    def swap_slots(self, state, perm) -> List[ReplicaState]:
        """Permute the group axis by ``perm`` (i32[G], physical order; new
        slot ``s`` holds old slot ``perm[s]``): the device side of a group
        migration. The caller (the engine's placement table) passes a
        pairwise swap, so two groups' state moves. In place: the blocks
        keep their tensors."""
        self._permute([[getattr(b, f) for b in state] for f in FIELDS], perm)
        return state

    @labeled_method("group_mesh.ring_swap")
    def swap_ring_slots(self, rings, perm) -> list:
        """The event rings ride the same slot permutation, in place
        (recorded events stay with their logical group)."""
        self._permute([[r.tensors()[i] for r in rings] for i in range(4)],
                      perm)
        return rings
