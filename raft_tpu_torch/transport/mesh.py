"""Mesh transport: one replica row per rank of a ``torch.distributed``
process group (port of ``raft_tpu/transport/tpu_mesh.py:61``
``TpuMeshTransport``).

Every rank constructs the transport and makes the same calls in the same
order with the same arguments, as the JAX package's mirrored programs do
under ``shard_map``; each rank holds and returns its own row's state
(vectors [1], ``log_term`` [1, C], ``log_payload`` [C, W]) and every rank
gets the same replicated ``RepInfo``/``VoteInfo``. The protocol bodies are
the single-device ones (``core.step``) over ``MeshComm``: the steady forms
go to the mesh kernels (``core.step_mesh``, two launch collectives a
call), the repair-capable tick and the election run the general path on
the local row, with K1 writing its windows.

The group is gloo: ranks that share one GPU (NCCL refuses two ranks on
one device) or run on the CPU, as the tests do. A device backend, one GPU
per rank, is not tried yet and ``MeshComm`` refuses it.
Payloads may be given whole (the folded [..., R*W] batch, of which each
rank keeps its own lane block) or already cut (``shard_rows``).

This is also the engine's seam (``raft.RaftEngine`` runs one mirrored
engine a rank, ``transport.multihost``): ``fetch`` is the host copy of a
replicated value (an info, the event ring), ``fetch_rows``/``fetch_row``
the host view of every row / one row of a row-sharded value, which is a
collective every rank reaches in lock step (JAX: ``tpu_mesh.py:228``,
the reshard to fully replicated), ``gather_window`` the EC donors'
windows on this rank's device, and ``place_rows`` the inverse: this
rank's row of a host [R, ...] value. The recorded programs (``ring=``)
run the same steps with ``record=True``: every rank writes the identical
event ring from gathered pre- and post-states. Nothing on the mesh is
captured into a CUDA graph: a gloo collective is a host call.

Not ported yet, and refused with a ``ValueError``: ``payload_shards > 1``
(the 2-D mesh, ROADMAP A15b).
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
from raft_tpu_torch.transport.device import resolve_device


class MeshTransport:
    resident = False

    def __init__(self, cfg: RaftConfig, group=None, device=None):
        import torch.distributed as dist

        if cfg.payload_shards != 1:
            raise ValueError(
                f"payload_shards={cfg.payload_shards}: the 2-D payload "
                "mesh is not ported yet (ROADMAP A15b)")
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("MeshTransport needs an initialised "
                               "torch.distributed process group")
        self.cfg = cfg
        self.device = resolve_device(device)
        # write-before-block (obs.blackbox): the group checks and the
        # digest group's creation below are the mesh's first collectives
        blackbox.mark("mesh_build", rows=cfg.rows, payload_shards=1,
                      devices=dist.get_world_size(group))
        self.comm = MeshComm(cfg.rows, group,
                             exchange_timeout_s=cfg.mirror_exchange_timeout_s)
        self.rank = self.comm.rank
        self.processes = cfg.rows
        self._member_mode = cfg.max_replicas is not None
        self._words = cfg.shard_words
        self.fetches = 0
        self.fetch_s = 0.0
        #   gathering fetches made (``fetch_rows``/``fetch_row``/
        #   ``gather_window``) and the host seconds they took; the blackbox
        #   journal's allgather id is ``fetches``
        blackbox.mark("mesh_ready", rows=cfg.rows)

    def init(self) -> ReplicaState:
        """This rank's row of a fresh cluster."""
        return init_state(self.cfg, rows=1, device=self.device)

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
        at ``dim``, size 1): one all_gather every rank makes in lock
        step."""
        t0 = self._gathering("fetch")
        out = self.comm.all_gather_host(x.detach().movedim(dim, 0))
        self.fetch_s += time.perf_counter() - t0
        return out.movedim(0, dim).contiguous().numpy()

    def fetch_row(self, x: torch.Tensor, row: int,
                  dim: int = 0) -> np.ndarray:
        """Host view of replica ``row`` of a row-sharded value, the row
        axis ``dim`` removed: one broadcast from the rank holding it."""
        t0 = self._gathering("fetch_row")
        out = self.comm.broadcast_host(x.select(dim, 0), row)
        self.fetch_s += time.perf_counter() - t0
        return out.numpy()

    def gather_window(self, state: ReplicaState, rows: Sequence[int],
                      lo: int, hi: int) -> torch.Tensor:
        """The payload words of log indices [lo, hi] on replicas ``rows``,
        gathered onto this rank's device: i32[hi-lo+1, len(rows)*W] (the
        EC decode's donor block). One all_gather every rank makes."""
        t0 = self._gathering("window")
        slots = (torch.arange(lo, hi + 1, device=state.device,
                              dtype=torch.int64) - 1) % state.capacity
        mine = state.log_payload.index_select(0, slots)       # [N, W]
        every = self.comm.all_gather_host(mine[None])         # [R, N, W]
        pick = every.index_select(0, torch.as_tensor(list(rows),
                                                     dtype=torch.int64))
        out = pick.permute(1, 0, 2).reshape(hi - lo + 1, -1).to(self.device)
        self.fetch_s += time.perf_counter() - t0
        return out.contiguous()

    def place_rows(self, host, like: torch.Tensor,
                   dim: int = 0) -> torch.Tensor:
        """This rank's row of a host [R, ...] value (row axis at ``dim``),
        as a tensor of ``like``'s dtype and device (JAX: ``device_put``
        under the transport's sharding)."""
        return torch.as_tensor(np.asarray(host)).narrow(
            dim, self.rank, 1).to(device=like.device,
                                  dtype=like.dtype).contiguous()

    def gather_state(self, state: ReplicaState) -> dict:
        """The whole cluster's state as numpy leaves (``stack_rows`` of
        every rank's row; one all_gather a leaf, on every rank)."""
        parts = {f: self.comm.all_gather_host(getattr(state, f)[None])
                 .numpy() for f in FIELDS}
        return stack_rows([{f: parts[f][r] for f in FIELDS}
                           for r in range(self.cfg.rows)])

    def exchange_digest(self, value: int) -> np.ndarray:
        """Every rank's mirror digest, in rank order (``MeshComm``'s
        digest group)."""
        return self.comm.exchange_int64(value)

    def local_row(self, row: int):
        """Index of replica ``row`` in this rank's state, or None when
        another rank holds it."""
        return 0 if row == self.rank else None

    def commit_index(self, state: ReplicaState, row: int) -> int:
        """Replica ``row``'s commit index (a collective: every rank calls
        it)."""
        return int(self.comm.all_gather(state.commit_index)[row])

    def shard_rows(self, payload) -> torch.Tensor:
        """This rank's lane block of a folded [..., R*W] batch, on the
        device (the north star's scatter when the blocks are RS shards)."""
        w, r = self._words, self.rank
        payload = torch.as_tensor(payload)
        if payload.shape[-1] != self.cfg.rows * w:
            raise ValueError(f"a folded batch has {self.cfg.rows * w} lanes, "
                             f"got {payload.shape[-1]}")
        return payload[..., r * w:(r + 1) * w].to(self.device).contiguous()

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

    def replicate_fused(self, state, staging, start_slot, counts, n_run,
                        halted0, leader, leader_term, alive, slow,
                        member=None, repair_floor=0, floor_prev_term=0,
                        ring=None):
        """K steady ticks with exact early exit (``fused_steady_scan``)
        over the mesh: ``staging`` [S, B, W] holds untiled words, which on
        a full-copy cluster are every rank's lane block. Returns
        ``(state, infos, escaped, ran, halted[, ring])``. Run eagerly:
        never captured into a CUDA graph (its collectives are host
        calls)."""
        rec = {} if ring is None else {"ring": ring, "record": True}
        return fused_steady_scan(
            self.comm, self.cfg.commit_quorum, state, staging, start_slot,
            counts, n_run, halted0, leader, leader_term, alive, slow,
            floor_prev_term, repair_floor, self._member(member), **rec)

    def request_votes(self, state, candidate, cand_term, alive,
                      ring=None, quorum=0) -> Tuple[ReplicaState, VoteInfo]:
        """One election round; ``ring`` records it (with ``quorum``, the
        engine's win threshold) and makes the return a triple."""
        if ring is not None:
            return vote_step(self.comm, state, candidate, cand_term, alive,
                             ring=ring, record=True, quorum=quorum)
        return vote_step(self.comm, state, candidate, cand_term, alive)
