"""Mesh transport: one replica row per rank of a ``torch.distributed``
process group, or one lane slice of a row per rank on the 2-D mesh (port
of ``raft_tpu/transport/tpu_mesh.py:61`` ``TpuMeshTransport`` over
several processes; its one-process mode is ``transport.replica_mesh``).

Every rank constructs the transport and makes the same calls in the same
order with the same arguments, as the JAX package's mirrored programs do
under ``shard_map``; each rank holds and returns its own part of the
state and every rank gets the same replicated ``RepInfo``/``VoteInfo``.
The protocol bodies are the single-device ones (``core.step``) over
``MeshComm``: the steady forms go to the mesh kernels (``core.step_mesh``,
two launch collectives a call), the repair-capable tick and the election
run the general path on the local row, with K1 writing its windows.

``payload_shards`` P > 1 is the JAX package's 2-D ``(replica, pshard)``
mesh: a world of ``rows * P`` ranks, rank ``g = r*P + p`` holding replica
row ``r``'s vectors [1] and ``log_term`` [1, C] (the same on the row's P
ranks, as JAX's ``P("replica")`` specs replicate them over ``pshard``)
and ``log_payload`` [C, W/P], lane block ``g`` of the folded
``[R x P x W/P]`` layout (JAX :106-111). The protocol bodies never reduce
over the lanes (JAX :14-20), so each pshard column runs the 1-D mesh
program on its own slice; the replica collectives ride the column and
the reads that reassemble a row's lanes ride the row group
(``MeshComm``).

The group is NCCL with one card a rank (``launch.run_ranks(...,
backend="nccl")``, ``multihost.initialize_multihost``), where every
replica collective runs on the device, or gloo: ranks that share one GPU
(NCCL refuses two ranks on one device) or run on the CPU, as the tests
do; over gloo a CUDA operand is staged through the host (``MeshComm``).
Under NCCL the transport's device is the rank's own card (the current
CUDA device, which the launcher sets before the group exists).
Payloads may be given whole (the folded [..., R*W] batch, of which each
rank keeps its own lane block) or already cut (``shard_rows``).

This is also the engine's seam (``raft.RaftEngine`` runs one mirrored
engine a rank, ``transport.multihost``): ``fetch`` is the host copy of a
replicated value (an info, the event ring), ``fetch_rows``/``fetch_row``
the host view of every row / one row of a row-sharded value, which is a
collective every rank reaches in lock step (JAX: ``tpu_mesh.py:228``,
the reshard to fully replicated), ``fetch_row_lanes`` and
``gather_window`` the same for payload words at full width (stitched
from the row group's slices). Each makes its gather or broadcast where
the operand lies (on the card over NCCL) and then one copy of the result
to the host (``gather_window``'s stays on the device); ``place_rows``
the inverse: this rank's
row of a host [R, ...] value, and ``lane_slice`` this rank's byte slice
of a shard batch, which every payload write goes through. The recorded
programs (``ring=``) run the same steps with ``record=True``: every rank
writes the identical event ring from gathered pre- and post-states.
Nothing on the mesh is captured into a CUDA graph: a gloo collective is
a host call, and the NCCL mesh's fused window runs eagerly too. The compile plane's labels keep the JAX text
(``tpu_mesh.replicate``, ``.replicate_many``, ``.pipeline``, ``.fused``,
``.vote``) and sit on the methods, where JAX labels its cached programs.
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.comm import MeshComm
from raft_tpu_torch.core.state import (
    FIELDS,
    ReplicaState,
    host_copy,
    init_state,
    stack_rows,
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
from raft_tpu_torch.transport.device import resolve_device


def check_mesh_size(rows: int, payload_shards: int, got: int) -> None:
    """JAX's size check of a mesh (``tpu_mesh.py:74-79``): ``rows``
    replica rows of ``payload_shards`` lane slices need that many ranks
    (JAX: devices), membership headroom rows included."""
    need = rows * payload_shards
    if got != need:
        raise ValueError(
            f"need {need} devices ({rows} replica rows x "
            f"{payload_shards} payload shards), got {got}")


class MeshTransport:
    resident = False

    def __init__(self, cfg: RaftConfig, group=None, device=None,
                 payload_shards=None):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("MeshTransport needs an initialised "
                               "torch.distributed process group")
        P = cfg.payload_shards if payload_shards is None else payload_shards
        # membership headroom allocates (and places) cfg.rows replica
        # rows; spare rows idle behind the member mask until add_server
        world = dist.get_world_size(group)
        check_mesh_size(cfg.rows, P, world)
        if cfg.shard_words % P:
            raise ValueError(
                f"per-entry stored words ({cfg.shard_words}) must divide "
                f"evenly over {P} payload shards")
        self.cfg = cfg
        self.payload_shards = P
        self.device = resolve_device(device)
        if dist.get_backend(group) == "nccl":
            # NCCL moves CUDA tensors only, on the card the rank's
            # launcher made current (one card a rank)
            if self.device.type != "cuda":
                raise ValueError(
                    f"an NCCL mesh holds its rows on the ranks' cards, got "
                    f"device {str(self.device)!r}")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        # write-before-block (obs.blackbox): the group checks and the
        # groups' creation below are the mesh's first collectives
        blackbox.mark("mesh_build", rows=cfg.rows, payload_shards=P,
                      devices=world)
        self.comm = MeshComm(cfg.rows, group,
                             exchange_timeout_s=cfg.mirror_exchange_timeout_s,
                             payload_shards=P)
        self.rank = self.comm.group_rank
        self.row = self.comm.rank
        self.pshard = self.comm.pshard
        self.processes = world
        self._member_mode = cfg.max_replicas is not None
        self._words = cfg.shard_words // P
        #   the local lanes W/P of a payload row
        self.fetches = 0
        self.fetch_s = 0.0
        #   gathering fetches made (``fetch_rows``/``fetch_row``/
        #   ``fetch_row_lanes``/``gather_window``) and the host seconds
        #   they took; the blackbox journal's allgather id is ``fetches``
        blackbox.mark("mesh_ready", rows=cfg.rows)

    def init(self) -> ReplicaState:
        """This rank's part of a fresh cluster: its row's vectors and
        terms, and its [C, W/P] lane slice of the row's payload."""
        return init_state(self.cfg, rows=1, device=self.device,
                          words=self._words)

    def fetch(self, x):
        """Host copy of a replicated value (the infos, the event ring: the
        same on every rank); no communication."""
        return host_copy(x)

    def _gathering(self, op: str) -> float:
        # write-before-block: a gathering fetch is a collective every rank
        # must reach in lock step; a mirrored-loop divergence or a dead
        # peer stalls here, and the journal's id says which fetch it was
        self.fetches += 1
        blackbox.mark("allgather", id=self.fetches, op=op)
        return time.perf_counter()

    def fetch_rows(self, x: torch.Tensor, dim: int = 0) -> np.ndarray:
        """Host view of every row of a row-sharded value (this rank's row
        at ``dim``, size 1; not payload lanes): one all_gather over the
        column every rank makes in lock step."""
        t0 = self._gathering("fetch")
        out = self.comm.all_gather_host(x.detach().movedim(dim, 0))
        self.fetch_s += time.perf_counter() - t0
        return out.movedim(0, dim).contiguous().numpy()

    def fetch_row(self, x: torch.Tensor, row: int,
                  dim: int = 0) -> np.ndarray:
        """Host view of replica ``row`` of a row-sharded value (not
        payload lanes), the row axis ``dim`` removed: one broadcast from
        the rank of this column holding it."""
        t0 = self._gathering("fetch_row")
        out = self.comm.broadcast_host(x.select(dim, 0), row)
        self.fetch_s += time.perf_counter() - t0
        return out.numpy()

    def fetch_row_lanes(self, x: torch.Tensor, row: int,
                        dim: int = 0) -> np.ndarray:
        """``fetch_row`` of a value whose last axis is this rank's payload
        lanes: replica ``row``'s value at full width, its P slices
        stitched over the row group (a second collective, 2-D only)."""
        t0 = self._gathering("fetch_row_lanes")
        out = self.comm.broadcast_host(x.select(dim, 0), row, lanes=True)
        self.fetch_s += time.perf_counter() - t0
        return out.numpy()

    def gather_window(self, state: ReplicaState, rows: Sequence[int],
                      lo: int, hi: int) -> torch.Tensor:
        """The payload words of log indices [lo, hi] on replicas ``rows``
        at full width, gathered onto this rank's device:
        i32[hi-lo+1, len(rows)*W] (the EC decode's donor block). One
        all_gather over the column, and on the 2-D mesh one over the row
        group to stitch the slices, every rank makes."""
        t0 = self._gathering("window")
        slots = (torch.arange(lo, hi + 1, device=state.device,
                              dtype=torch.int64) - 1) % state.capacity
        mine = state.log_payload.index_select(0, slots)       # [N, w]
        pick = self.comm.gather_lanes(mine[None], rows)       # [k, N, W]
        out = pick.permute(1, 0, 2).reshape(hi - lo + 1, -1).to(self.device)
        self.fetch_s += time.perf_counter() - t0
        return out.contiguous()

    def place_rows(self, host, like: torch.Tensor,
                   dim: int = 0) -> torch.Tensor:
        """This rank's row of a host [R, ...] value (row axis at ``dim``),
        as a tensor of ``like``'s dtype and device (JAX: ``device_put``
        under the transport's sharding)."""
        return torch.as_tensor(np.asarray(host)).narrow(
            dim, self.row, 1).to(device=like.device,
                                 dtype=like.dtype).contiguous()

    def lane_slice(self, shards):
        """This rank's byte slice of a shard batch u8[N, Sk] (host or
        device; the whole batch at P = 1): bytes [p*Sk/P, (p+1)*Sk/P),
        the words of lane block ``g`` of the row's shard. Every payload
        write (``install_entries``) goes through it."""
        if self.payload_shards == 1:
            return shards
        sk = shards.shape[-1] // self.payload_shards
        return shards[..., self.pshard * sk:(self.pshard + 1) * sk]

    def on_row(self, state: ReplicaState, row: int, fn) -> ReplicaState:
        """A write to replica ``row``: ``fn(state, 0, lane_slice)`` on
        the ranks that hold the row (each its own slice on the 2-D mesh);
        the others return their state unchanged. No collective."""
        i = self.local_row(row)
        return state if i is None else fn(state, i, self.lane_slice)

    def log_terms(self, state: ReplicaState, slots, row=None) -> np.ndarray:
        """Host view of the term ring at ring ``slots`` (only those slots
        leave the device): every row's ``[R, n]``, gathered from every
        rank, or replica ``row``'s ``[n]``, broadcast from a rank that
        holds it."""
        sel = state.log_term.index_select(
            1, torch.from_numpy(np.asarray(slots, np.int64)).to(
                state.device))
        if row is None:
            return self.fetch_rows(sel)
        return self.fetch_row(sel, row, 0)

    def entry_words(self, state: ReplicaState, replica: int, lo: int,
                    hi: int) -> np.ndarray:
        """Replica ``replica``'s payload words of log indices [lo, hi] on
        every rank, at full width (on the 2-D mesh stitched from the
        row's slices): i32[hi-lo+1, W] on the host."""
        slots = (torch.arange(lo, hi + 1, device=state.device,
                              dtype=torch.int64) - 1) % state.capacity
        # this rank's row [N, w] with its row axis; the holder's reaches all
        mine = state.log_payload.index_select(0, slots)[:, None]
        return self.fetch_row_lanes(mine, replica, 1)

    def record_chunk(self, ring, pre, state: ReplicaState, info,
                     leader: int, term: int, ticks: int) -> None:
        """The engine's chunk-granularity recording of a flight
        (``obs.device.record_replicate_events`` over this transport's
        comm: the pre- and post-states are gathered, so every rank
        records the same events), ``pre`` the ``obs.device.pre_of`` the
        engine took before the launch."""
        from raft_tpu_torch.obs.device import record_replicate_events

        record_replicate_events(ring, self.comm, pre, state, info, leader,
                                term, -1, repair=False, ticks=ticks)

    def gather_state(self, state: ReplicaState) -> dict:
        """The whole cluster's state as numpy leaves at full width
        (``stack_rows`` of every row; one all_gather over the column a
        leaf and, on the 2-D mesh, one over the row group for the
        payload, on every rank)."""
        parts = {f: self.comm.all_gather_host(getattr(state, f)[None])
                 .numpy() for f in FIELDS if f != "log_payload"}
        lanes = self.comm.gather_lanes(state.log_payload[None],
                                       host=True).numpy()     # [R, C, W]
        return stack_rows([
            {**{f: parts[f][r] for f in parts}, "log_payload": lanes[r]}
            for r in range(self.cfg.rows)])

    def exchange_digest(self, value: int) -> np.ndarray:
        """Every rank's mirror digest (all R*P), in rank order
        (``MeshComm``'s digest group)."""
        return self.comm.exchange_int64(value)

    def local_row(self, row: int):
        """Index of replica ``row`` in this rank's state, or None when
        another rank holds it (on the 2-D mesh each of the row's P ranks
        holds its own slice of it)."""
        return 0 if row == self.row else None

    def commit_index(self, state: ReplicaState, row: int) -> int:
        """Replica ``row``'s commit index (a collective: every rank calls
        it)."""
        return int(self.comm.all_gather_host(state.commit_index)[row])

    def shard_rows(self, payload) -> torch.Tensor:
        """This rank's lane block ``g`` of a folded [..., R*W] batch, on
        the device (the north star's scatter when the blocks are RS
        shards; on the 2-D mesh a slice of one)."""
        w, g = self._words, self.rank
        payload = torch.as_tensor(payload)
        if payload.shape[-1] != self.cfg.rows * self.cfg.shard_words:
            raise ValueError(f"a folded batch has "
                             f"{self.cfg.rows * self.cfg.shard_words} "
                             f"lanes, got {payload.shape[-1]}")
        return payload[..., g * w:(g + 1) * w].to(self.device).contiguous()

    def _local(self, payload) -> torch.Tensor:
        payload = torch.as_tensor(payload)
        if payload.shape[-1] == self._words:
            return payload.to(self.device).contiguous()
        return self.shard_rows(payload)

    def _member(self, member):
        if member is None and self._member_mode:
            return torch.ones(self.cfg.rows, dtype=torch.bool,
                              device=self.device)
        return member

    @labeled_method("tpu_mesh.replicate")
    def replicate(self, state, client_payload, client_count, leader,
                  leader_term, alive, slow, repair=True, member=None,
                  repair_floor=0, floor_prev_term=0, term_floor=None,
                  ring=None) -> Tuple[ReplicaState, RepInfo]:
        """One leader tick: the general path (``repair`` on or off), or,
        with ``term_floor``, the steady step (K2·mesh where the JAX
        package runs its mesh kernel). ``ring`` records the step (every
        rank the same records) and makes the return ``(state, info,
        ring)``."""
        cfg = self.cfg
        rec = {} if ring is None else {"ring": ring, "record": True}
        return replicate_step(
            self.comm, state, self._local(client_payload), client_count,
            leader, leader_term, alive, slow, floor_prev_term, repair_floor,
            self._member(member), ec=cfg.ec_enabled,
            commit_quorum=cfg.commit_quorum, repair=bool(repair),
            term_floor=term_floor, **rec)

    @labeled_method("tpu_mesh.replicate_many")
    def replicate_many(self, state, payloads, counts, leader, leader_term,
                       alive, slow, repair=True, member=None, repair_floor=0,
                       floor_prev_term=0,
                       term_floor=None) -> Tuple[ReplicaState, RepInfo]:
        """T steps (``payloads`` [T, B, R*W] or [T, B, W]); RepInfo fields
        carry a leading [T] axis."""
        cfg = self.cfg
        return scan_replicate(
            self.comm, cfg.ec_enabled, cfg.commit_quorum, bool(repair),
            state, self._local(payloads), counts, leader, leader_term, alive,
            slow, floor_prev_term, repair_floor, self._member(member),
            term_floor=term_floor)

    @labeled_method("tpu_mesh.pipeline")
    def replicate_pipeline(self, state, payloads, counts, leader, leader_term,
                           alive, slow, member=None, repair_floor=0,
                           floor_prev_term=0, term_floor=1,
                           allow_turnover=True
                           ) -> Tuple[ReplicaState, RepInfo]:
        """T saturated steps as one flight on every rank (K4·mesh, K3·mesh
        or the K2·mesh scan, ``core.step_mesh.mesh_pipeline``; no K4·mesh
        with ``allow_turnover=False``); two launch collectives, then no
        communication. Returns the FINAL step's info only."""
        cfg = self.cfg
        return mesh_pipeline(
            self.comm, state, self._local(payloads), counts, leader,
            leader_term, alive, slow, floor_prev_term, repair_floor,
            self._member(member), term_floor,
            commit_quorum=cfg.commit_quorum, ec=cfg.ec_enabled,
            allow_turnover=allow_turnover)

    @labeled_method("tpu_mesh.fused")
    def replicate_fused(self, state, staging, start_slot, counts, n_run,
                        halted0, leader, leader_term, alive, slow,
                        member=None, repair_floor=0, floor_prev_term=0,
                        ring=None):
        """K steady ticks with exact early exit (``fused_steady_scan``)
        over the mesh: ``staging`` [S, B, W] holds untiled words, which on
        a full-copy cluster are every rank's lane block (on the 2-D mesh
        this rank takes its slice of them). Returns
        ``(state, infos, escaped, ran, halted[, ring])``. Run eagerly:
        never captured into a CUDA graph (its collectives are host
        calls)."""
        rec = {} if ring is None else {"ring": ring, "record": True}
        staging = torch.as_tensor(staging)
        if staging.shape[-1] != self._words:     # JAX: P(None, None, pshard)
            p, w = self.pshard, self._words
            staging = staging[..., p * w:(p + 1) * w].contiguous()
        return fused_steady_scan(
            self.comm, self.cfg.commit_quorum, state, staging, start_slot,
            counts, n_run, halted0, leader, leader_term, alive, slow,
            floor_prev_term, repair_floor, self._member(member), **rec)

    @labeled_method("tpu_mesh.vote")
    def request_votes(self, state, candidate, cand_term, alive,
                      ring=None, quorum=0) -> Tuple[ReplicaState, VoteInfo]:
        """One election round; ``ring`` records it (with ``quorum``, the
        engine's win threshold) and makes the return a triple."""
        if ring is not None:
            return vote_step(self.comm, state, candidate, cand_term, alive,
                             ring=ring, record=True, quorum=quorum)
        return vote_step(self.comm, state, candidate, cand_term, alive)
