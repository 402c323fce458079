"""One-process replica mesh: one ``RaftEngine`` over R·P devices, each
replica row (on the 2-D mesh each lane slice of a row) on a device of its
own, the collectives device-to-device copies (port of the one-process
mode of ``raft_tpu/transport/tpu_mesh.py:61`` ``TpuMeshTransport``).

The JAX package builds its mesh transport over the first R·P devices of
one process: one engine whose replica rows sit on separate chips, one
``shard_map`` program a call, and a plain ``np.asarray`` for a host read
(``tpu_mesh.py:218-247``). This module is that mode; ``transport.mesh``
is the multi-process one (one gloo or NCCL rank a block).

Placement (JAX ``tpu_mesh.py:106-111``): block ``g = r*P + p`` lives on
``mesh.devices[g]`` and holds row ``r``'s six vectors [1] and term ring
[1, C] (alike on the row's P blocks, as ``P("replica")`` replicates them
over ``pshard``) and lane block ``g`` of the folded payload, [C, W/P].
The engine's state is a ``core.state.BlockState``: one ``Blocks`` a
leaf, and this transport as its view. A ``ReplicaMesh`` may repeat a
device, as ``GroupMesh`` does: two blocks on one device hold separate
storage, so one card runs the mesh as R·P blocks.

What differs from the JAX transport is the mechanism, not the result:

- A call runs the single-device protocol bodies (``core.step``,
  ``core.step_mesh``) once a block, each with its own ``BlockComm``, on
  the threads of a ``core.comm.LockStep``: one block at a time, in block
  order, meeting at every collective, where JAX traces one body under
  ``shard_map``. The steady forms reach the mesh kernels (K2·mesh,
  K3·mesh, K4·mesh) on every block; K1 writes the general path's windows.
- A collective gathers the blocks' operands onto each block's device
  (a copy within the card when they share one; PyTorch orders a copy
  between cards after its producer on both streams). No
  ``torch.distributed`` group exists, and no operand of a collective
  goes through the host. A flight (``replicate_pipeline``) reads its
  decision plane to the host once for all blocks, because K4·mesh takes
  its start slot from the host (``core.step_mesh._host_plane``).
- Every block returns the same replicated info; the call returns block
  0's. A recorded call (``ring=``) records into the caller's ring on
  block 0 and into a copy of it on every other block: every block
  computes the identical ring from gathered values, as JAX's ``P()``
  ring specs say.
- The engine's host reads of rows (``fetch_rows``, ``fetch_row``,
  ``fetch_row_lanes``, ``log_terms``) make at most one device-to-host
  copy a device; ``gather_window`` (the EC decode's donor block) and the
  writes (``place_rows``, ``on_row``) stay on the devices.
- The fused window (``replicate_fused``), JAX's jitted ``tpu_mesh.fused``
  program (``tpu_mesh.py:428``): with every block on one card
  (``replays_graphs``) a launch is one replay of a CUDA graph over all
  the blocks, one graph per launch size (``core.graphs.MeshFusedGraphs``:
  captured with the blocks' bodies on their lock-step threads and the
  capture stream current on each, so the collectives' copies are nodes
  of the graph). On the CPU, and with blocks on several cards, the
  blocks run the K ticks eagerly in lock step: a decided mode, never a
  fallback (a capture or replay that fails raises).
- ``release()`` lends the rings, staging buffer and graph set of a dead
  engine to the next transport of the same shape on the same devices
  (``core.graphs.POOL``), which replays the graphs instead of capturing
  them anew, as JAX's process-wide program cache (``tpu_mesh.py:50-58``)
  serves a second ``TpuMeshTransport``.

Several cards: ``ReplicaMesh(["cuda:0", "cuda:1", ...])`` puts the
blocks on separate cards and the collectives copy between them (peer to
peer where the cards allow it); ``chip_smoke.py --only=replica_mesh_path``
runs the phase so on a host of several cards.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.comm import BlockComm, LockStep
from raft_tpu_torch.core.state import (
    FIELDS,
    Blocks,
    BlockState,
    host_copy,
    init_state,
)
from raft_tpu_torch.core.step import (
    RepInfo,
    VoteInfo,
    fused_steady_scan,
    replicate_step,
    scan_replicate,
    vote_step,
)
from raft_tpu_torch.core.step_mesh import mesh_pipeline
from raft_tpu_torch.obs import blackbox
from raft_tpu_torch.obs.compile import labeled_method
from raft_tpu_torch.transport.group_mesh import visible_cards
from raft_tpu_torch.transport.mesh import check_mesh_size


class ReplicaMesh:
    """The devices of a one-process replica mesh, one a block (block
    ``g`` holds row ``g // P``, lane slice ``g % P``). A device may
    repeat: ``ReplicaMesh(["cuda:0"] * 3)`` is three blocks of one card,
    ``ReplicaMesh(["cpu"] * 3)`` three of the host."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a ReplicaMesh needs at least one device")

    def __repr__(self) -> str:
        return f"ReplicaMesh({[str(d) for d in self.devices]})"


class ReplicaMeshTransport:
    """The one-process ``"tpu_mesh"`` backend (module docstring). With no
    ``mesh`` the devices are the visible cards; the first
    ``cfg.rows * P`` are used, and fewer raise JAX's size error (a config
    with membership headroom needs its spare rows' devices too)."""

    resident = False
    processes = 1

    def __init__(self, cfg: RaftConfig, mesh: Optional[ReplicaMesh] = None,
                 payload_shards: Optional[int] = None):
        P = cfg.payload_shards if payload_shards is None else payload_shards
        devices = mesh.devices if mesh is not None else visible_cards()
        need = cfg.rows * P
        check_mesh_size(cfg.rows, P, min(len(devices), need))
        if cfg.shard_words % P:
            raise ValueError(
                f"per-entry stored words ({cfg.shard_words}) must divide "
                f"evenly over {P} payload shards")
        self.cfg = cfg
        self.payload_shards = P
        blackbox.mark("mesh_build", rows=cfg.rows, payload_shards=P,
                      devices=len(devices))
        self.mesh = ReplicaMesh(devices[:need])
        self.devices = self.mesh.devices
        self.device = self.devices[0]
        #   where the engine's uploads land and the replicated infos live
        self.lockstep = LockStep.for_devices(self.devices)
        self.comms = [BlockComm(self.lockstep, g, cfg.rows, P)
                      for g in range(need)]
        self._member_mode = cfg.max_replicas is not None
        self.words = cfg.shard_words // P
        #   the lanes W/P of a block's payload row
        self.replays_graphs = (self.device.type == "cuda" and all(
            d == self.device for d in self.devices))
        #   whether replicate_fused replays CUDA graphs: every block on one
        #   card; on the CPU, and with blocks on several cards, it runs
        #   the K ticks eagerly (module doc)
        self.graphs = None
        #   core.graphs.MeshFusedGraphs, built at the first fused launch
        #   (or taken over from a released transport by init())
        self._held = None
        #   what the pool may lend on (core.graphs.POOL)
        self.fetches = 0
        self.fetch_s = 0.0
        self.host_copies = 0
        #   the engine's gathering fetches, their host seconds, and the
        #   device-to-host copies they made (at most one a device each)
        blackbox.mark("mesh_ready", rows=cfg.rows)

    # ------------------------------------------------------------ placement
    def init(self) -> BlockState:
        """A fresh cluster: every block zeroed on its device. A released
        transport's rings of this shape on these devices are reused
        (zeroed), with its graphs."""
        from raft_tpu_torch.core.graphs import POOL

        cfg, n = self.cfg, len(self.devices)
        where = tuple(self.devices)
        shapes = ([(1, cfg.log_capacity)] * n
                  + [(cfg.log_capacity, self.words)] * n)
        lent = POOL.claim(self, where, cfg.rows, cfg.commit_quorum, shapes)
        if lent is not None and lent.graphs is not None:
            self.graphs = lent.graphs
            self.graphs.bind(self)
        state = BlockState.of(
            [init_state(cfg, rows=1, device=d, words=self.words,
                        rings=None if lent is None
                        else (lent.rings[g], lent.rings[n + g]))
             for g, d in enumerate(self.devices)], self)
        self._held = POOL.hold(where, cfg.rows, cfg.commit_quorum,
                               tuple(state.log_term)
                               + tuple(state.log_payload), self.graphs)
        return state

    def release(self) -> None:
        """The engine on this transport is dead: lend its rings, staging
        buffer and graphs to the next transport of this shape on these
        devices (``core.graphs.POOL``), as JAX's process-wide program
        cache serves a second ``TpuMeshTransport``. The transport must
        not be used again."""
        from raft_tpu_torch.core.graphs import POOL

        if self._held is not None:
            POOL.release(self, self._held)
        self.graphs = None
        self._held = None

    def _lanes(self, payload, g: int) -> torch.Tensor:
        """Block ``g``'s lane block of a payload on its device: a
        ``Blocks`` (``shard_rows``) gives its own part; a folded
        [..., R*W] batch its lanes [g*w, (g+1)*w); a batch of the block
        width is every block's."""
        dev = self.devices[g]
        if isinstance(payload, Blocks):
            return payload[g].to(dev).contiguous()
        payload = torch.as_tensor(payload)
        w = self.words
        if payload.shape[-1] == w:
            return payload.to(dev).contiguous()
        if payload.shape[-1] != self.cfg.rows * self.cfg.shard_words:
            raise ValueError(f"a folded batch has "
                             f"{self.cfg.rows * self.cfg.shard_words} "
                             f"lanes, got {payload.shape[-1]}")
        return payload[..., g * w:(g + 1) * w].to(dev).contiguous()

    def shard_rows(self, payload) -> Blocks:
        """A folded i32[..., R*W] batch with each block's lane block on
        its device (JAX: ``device_put`` under the payload sharding)."""
        return Blocks(self._lanes(payload, g)
                      for g in range(len(self.devices)))

    def _member(self, member):
        if member is None and self._member_mode:
            return torch.ones(self.cfg.rows, dtype=torch.bool,
                              device=self.device)
        return member

    # -------------------------------------------------------------- program
    def _rings(self, ring) -> list:
        """The ring each block records into: the caller's on block 0, a
        copy on every other block's device."""
        if ring is None:
            return [None] * len(self.devices)
        from raft_tpu_torch.obs.device import EventRing

        return [ring] + [EventRing(*(t.to(d, copy=True)
                                     for t in ring.tensors()))
                         for d in self.devices[1:]]

    def _each(self, state: BlockState, body, ring=None) -> tuple:
        """``body(g, comm, block state, ring)`` on every block in lock
        step; returns (the new BlockState, block 0's other outputs)."""
        rings = self._rings(ring)
        outs = self.lockstep.run(
            lambda g: body(g, self.comms[g], state.block(g), rings[g]))
        return (BlockState.of([o[0] for o in outs], self),) + tuple(
            outs[0][1:])

    @staticmethod
    def _rec(ring) -> dict:
        return {} if ring is None else {"ring": ring, "record": True}

    @labeled_method("tpu_mesh.replicate")
    def replicate(self, state, client_payload, client_count, leader,
                  leader_term, alive, slow, repair=True, member=None,
                  repair_floor=0, floor_prev_term=0, term_floor=None,
                  ring=None) -> Tuple[BlockState, RepInfo]:
        """One leader tick on every block: the general path (``repair``
        on or off), or, with ``term_floor``, the steady step (K2·mesh
        where the JAX package runs its mesh kernel). ``ring`` records the
        step and makes the return ``(state, info, ring)``."""
        cfg = self.cfg
        member = self._member(member)

        def body(g, comm, blk, ring_g):
            return replicate_step(
                comm, blk, self._lanes(client_payload, g), client_count,
                leader, leader_term, alive, slow, floor_prev_term,
                repair_floor, member, ec=cfg.ec_enabled,
                commit_quorum=cfg.commit_quorum, repair=bool(repair),
                term_floor=term_floor, **self._rec(ring_g))
        return self._each(state, body, ring)

    @labeled_method("tpu_mesh.replicate_many")
    def replicate_many(self, state, payloads, counts, leader, leader_term,
                       alive, slow, repair=True, member=None, repair_floor=0,
                       floor_prev_term=0,
                       term_floor=None) -> Tuple[BlockState, RepInfo]:
        """T steps (``payloads`` [T, B, R*W] or a ``Blocks``); RepInfo
        fields carry a leading [T] axis."""
        cfg = self.cfg
        member = self._member(member)

        def body(g, comm, blk, _):
            return scan_replicate(
                comm, cfg.ec_enabled, cfg.commit_quorum, bool(repair), blk,
                self._lanes(payloads, g), counts, leader, leader_term,
                alive, slow, floor_prev_term, repair_floor, member,
                term_floor=term_floor)
        return self._each(state, body)

    @labeled_method("tpu_mesh.pipeline")
    def replicate_pipeline(self, state, payloads, counts, leader, leader_term,
                           alive, slow, member=None, repair_floor=0,
                           floor_prev_term=0, term_floor=1,
                           allow_turnover=True
                           ) -> Tuple[BlockState, RepInfo]:
        """T saturated steps as one flight on every block (K4·mesh,
        K3·mesh or the K2·mesh scan, ``core.step_mesh.mesh_pipeline``);
        two launch collectives and one host read of the decision plane
        for the whole mesh. Returns the FINAL step's info only."""
        cfg = self.cfg
        member = self._member(member)

        def body(g, comm, blk, _):
            return mesh_pipeline(
                comm, blk, self._lanes(payloads, g), counts, leader,
                leader_term, alive, slow, floor_prev_term, repair_floor,
                member, term_floor, commit_quorum=cfg.commit_quorum,
                ec=cfg.ec_enabled, allow_turnover=allow_turnover)
        return self._each(state, body)

    @labeled_method("tpu_mesh.fused")
    def replicate_fused(self, state, staging, start_slot, counts, n_run,
                        halted0, leader, leader_term, alive, slow,
                        member=None, repair_floor=0, floor_prev_term=0,
                        ring=None):
        """K steady ticks with exact early exit (``fused_steady_scan``) on
        every block: ``staging`` [S, B, W] holds untiled words, every
        block's lane block on a full-copy cluster (on the 2-D mesh each
        block takes its slice). Returns ``(state, infos, escaped, ran,
        halted[, ring])``; the passed state is consumed. With every block
        on one card (``replays_graphs``) the call is one replay of a CUDA
        graph over all the blocks (``core.graphs.MeshFusedGraphs``);
        otherwise the blocks run the loop eagerly in lock step."""
        P, w = self.payload_shards, self.words
        staging = torch.as_tensor(staging)
        if self.replays_graphs:
            if member is None and self._member_mode:
                member = np.ones(self.cfg.rows, bool)
            if self.graphs is None:
                from raft_tpu_torch.core.graphs import MeshFusedGraphs

                self.graphs = MeshFusedGraphs(self)
                if self._held is not None:
                    self._held.graphs = self.graphs
            return self.graphs.run(
                self, state, staging, start_slot, counts, n_run, halted0,
                leader, leader_term, alive, slow, member, repair_floor,
                floor_prev_term, ring=ring)
        member = self._member(member)

        def body(g, comm, blk, ring_g):
            stg = staging
            if stg.shape[-1] != w:             # JAX: P(None, None, pshard)
                p = g % P
                stg = stg[..., p * w:(p + 1) * w]
            return fused_steady_scan(
                comm, self.cfg.commit_quorum, blk,
                stg.to(self.devices[g]).contiguous(), start_slot, counts,
                n_run, halted0, leader, leader_term, alive, slow,
                floor_prev_term, repair_floor, member, **self._rec(ring_g))
        return self._each(state, body, ring)

    @labeled_method("tpu_mesh.vote")
    def request_votes(self, state, candidate, cand_term, alive,
                      ring=None, quorum=0) -> Tuple[BlockState, VoteInfo]:
        """One election round on every block; ``ring`` records it (with
        ``quorum``, the engine's win threshold) and makes the return a
        triple."""
        def body(g, comm, blk, ring_g):
            if ring_g is None:
                return vote_step(comm, blk, candidate, cand_term, alive)
            return vote_step(comm, blk, candidate, cand_term, alive,
                             ring=ring_g, record=True, quorum=quorum)
        return self._each(state, body, ring)

    def record_chunk(self, ring, pre, state: BlockState, info, leader: int,
                     term: int, ticks: int) -> None:
        """The engine's chunk-granularity recording of a flight
        (``obs.device.record_replicate_events``) on every block, ``pre``
        the engine's ``obs.device.pre_of`` (a ``Pre`` of ``Blocks``); the
        caller's ring is block 0's."""
        from raft_tpu_torch.obs.device import record_replicate_events

        rings = self._rings(ring)

        def body(g):
            dev = self.devices[g]
            record_replicate_events(
                rings[g], self.comms[g], type(pre)(*(f[g] for f in pre)),
                state.block(g),
                type(info)(*(f.to(dev) for f in info)), leader, term, -1,
                repair=False, ticks=ticks)
        self.lockstep.run(body)

    # ------------------------------------------------------------ host seam
    def fetch(self, x):
        """Host copy of a replicated value (an info, the event ring)."""
        return host_copy(x)

    def _host(self, parts: List[torch.Tensor], dim: int) -> np.ndarray:
        """``parts`` joined along ``dim`` on the host, with one
        device-to-host copy a device (the parts on one device are joined
        there first)."""
        if len(parts) == 1:
            self.host_copies += 1
            return host_copy(parts[0])
        by_dev: dict = {}
        for i, p in enumerate(parts):
            by_dev.setdefault(p.device, []).append(i)
        out: list = [None] * len(parts)
        for idx in by_dev.values():
            joined = torch.cat([parts[i].detach() for i in idx], dim)
            self.host_copies += 1
            host = host_copy(joined)
            cuts = np.cumsum([parts[i].shape[dim] for i in idx])[:-1]
            for i, h in zip(idx, np.split(host, cuts, axis=dim)):
                out[i] = h
        return np.concatenate(out, axis=dim)

    def _gathering(self, op: str) -> float:
        self.fetches += 1
        blackbox.mark("allgather", id=self.fetches, op=op)
        return time.perf_counter()

    def _row_parts(self, x: Blocks) -> List[torch.Tensor]:
        """One block a row (its lane slice 0) of a row-placed value."""
        if not isinstance(x, Blocks):
            raise TypeError("the replica mesh reads row-placed values "
                            f"(core.state.Blocks), got {type(x).__name__}")
        P = self.payload_shards
        return [x[r * P] for r in range(self.cfg.rows)]

    def fetch_rows(self, x: Blocks, dim: int = 0) -> np.ndarray:
        """Host view of every row of a row-placed value (each block's
        row at ``dim``, size 1; not payload lanes)."""
        t0 = self._gathering("fetch")
        out = self._host(self._row_parts(x), dim)
        self.fetch_s += time.perf_counter() - t0
        return out

    def fetch_row(self, x: Blocks, row: int, dim: int = 0) -> np.ndarray:
        """Host view of replica ``row`` of a row-placed value (not payload
        lanes), the row axis ``dim`` removed."""
        t0 = self._gathering("fetch_row")
        out = self._host([self._row_parts(x)[row].select(dim, 0)], 0)
        self.fetch_s += time.perf_counter() - t0
        return out

    def fetch_row_lanes(self, x: Blocks, row: int,
                        dim: int = 0) -> np.ndarray:
        """``fetch_row`` of a value whose last axis is a block's payload
        lanes: replica ``row``'s value at full width, its P slices joined
        on the device of its first block."""
        t0 = self._gathering("fetch_row_lanes")
        P = self.payload_shards
        parts = [x[row * P + q].select(dim, 0) for q in range(P)]
        d0 = parts[0].device
        out = self._host([torch.cat([p.to(d0) for p in parts], -1)], 0)
        self.fetch_s += time.perf_counter() - t0
        return out

    def _row_window(self, state: BlockState, row: int, lo: int,
                    hi: int) -> torch.Tensor:
        """Replica ``row``'s payload words of log indices [lo, hi] at full
        width on ``self.device``: i32[hi-lo+1, W]."""
        P = self.payload_shards
        lanes = []
        for q in range(P):
            ring = state.log_payload[row * P + q]
            slots = (torch.arange(lo, hi + 1, device=ring.device,
                                  dtype=torch.int64) - 1) % state.capacity
            lanes.append(ring.index_select(0, slots).to(self.device))
        return torch.cat(lanes, -1)

    def gather_window(self, state: BlockState, rows: Sequence[int],
                      lo: int, hi: int) -> torch.Tensor:
        """The payload words of log indices [lo, hi] on replicas ``rows``
        at full width, gathered onto ``self.device`` with device copies:
        i32[hi-lo+1, len(rows)*W] (the EC decode's donor block)."""
        t0 = self._gathering("window")
        out = torch.stack([self._row_window(state, r, lo, hi)
                           for r in rows], 1)
        self.fetch_s += time.perf_counter() - t0
        return out.reshape(hi - lo + 1, -1).contiguous()

    def entry_words(self, state: BlockState, replica: int, lo: int,
                    hi: int) -> torch.Tensor:
        """Replica ``replica``'s payload words of log indices [lo, hi] at
        full width on ``self.device``: i32[hi-lo+1, W]
        (``core.state.log_entries``)."""
        return self.gather_window(state, [replica], lo, hi)

    def log_terms(self, state: BlockState, slots,
                  row: Optional[int] = None) -> np.ndarray:
        """Host view of the term ring at ring ``slots``: every row's
        (``[R, n]``), or replica ``row``'s (``[n]``)."""
        slots = np.asarray(slots, np.int64)

        def sel(t):
            return t.index_select(1, torch.from_numpy(slots).to(t.device))

        parts = self._row_parts(state.log_term)
        if row is None:
            t0 = self._gathering("fetch")
            out = self._host([sel(t) for t in parts], 0)
        else:
            t0 = self._gathering("fetch_row")
            out = self._host([sel(parts[row])[0]], 0)
        self.fetch_s += time.perf_counter() - t0
        return out

    def place_rows(self, host, like: Blocks, dim: int = 0) -> Blocks:
        """Each block's row of a host [R, ...] value (row axis at
        ``dim``), with ``like``'s dtype on its device."""
        h = torch.as_tensor(np.asarray(host))
        P = self.payload_shards
        return Blocks(h.narrow(dim, g // P, 1).to(device=t.device,
                                                  dtype=t.dtype).contiguous()
                      for g, t in enumerate(like))

    def lane_slice(self, shards, pshard: int = 0):
        """Lane slice ``pshard``'s bytes of a shard batch u8[N, Sk]
        (the whole batch at P = 1): bytes [p*Sk/P, (p+1)*Sk/P)."""
        P = self.payload_shards
        if P == 1:
            return shards
        sk = shards.shape[-1] // P
        return shards[..., pshard * sk:(pshard + 1) * sk]

    def on_row(self, state: BlockState, row: int, fn) -> BlockState:
        """A write to replica ``row``: ``fn(block state, 0, cut)`` on each
        of the row's P blocks, ``cut`` giving the block's byte slice of a
        shard batch (``core.state.ResidentView.on_row``)."""
        blocks = state.blocks()
        P = self.payload_shards
        for q in range(P):
            g = row * P + q
            blocks[g] = fn(blocks[g], 0,
                           lambda s, q=q: self.lane_slice(s, q))
        return BlockState.of(blocks, self)

    def gather_state(self, state: BlockState) -> dict:
        """The whole cluster's state as numpy leaves at full width
        (``core.state.state_to_numpy``'s form)."""
        out = {f: self._host(self._row_parts(getattr(state, f)), 0)
               for f in FIELDS if f != "log_payload"}
        out["log_payload"] = self._host(list(state.log_payload), 1)
        return out

    def exchange_digest(self, value: int) -> np.ndarray:
        """The mirror digests of a one-process world: this one."""
        return np.array([int(value)], np.int64)

    def local_row(self, row: int):
        """Every row is held in this process (``on_row`` writes it)."""
        return row

    def commit_index(self, state: BlockState, row: int) -> int:
        return int(self.fetch_row(state.commit_index, row))

    def collectives(self) -> int:
        """Replica collectives every block has made so far."""
        return sum(c.collectives for c in self.comms)

    def comm_host_copies(self) -> int:
        """Host copies the collectives have made (a flight's decision
        read; 0 for every other call)."""
        return sum(c.host_copies for c in self.comms)
