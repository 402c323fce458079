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

Not ported yet, and refused with a ``ValueError``: ``payload_shards > 1``
(the 2-D mesh) and the recorded ``ring=`` programs, which come with the
engine over the mesh (ROADMAP A15).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.comm import MeshComm
from raft_tpu_torch.core.state import ReplicaState, init_state
from raft_tpu_torch.core.step import (
    RepInfo,
    VoteInfo,
    fused_steady_scan,
    replicate_step,
    scan_replicate,
    vote_step,
)
from raft_tpu_torch.core.step_mesh import mesh_pipeline
from raft_tpu_torch.transport.device import resolve_device


def _no_ring(ring) -> None:
    if ring is not None:
        raise ValueError("the recorded mesh programs (ring=) are not ported "
                         "yet (ROADMAP A15)")


class MeshTransport:
    def __init__(self, cfg: RaftConfig, group=None, device=None):
        import torch.distributed as dist

        if cfg.payload_shards != 1:
            raise ValueError(
                f"payload_shards={cfg.payload_shards}: the 2-D payload "
                "mesh is not ported yet (ROADMAP A15)")
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("MeshTransport needs an initialised "
                               "torch.distributed process group")
        self.cfg = cfg
        self.comm = MeshComm(cfg.rows, group)
        self.rank = self.comm.rank
        self.device = resolve_device(device)
        self._member_mode = cfg.max_replicas is not None
        self._words = cfg.shard_words

    def init(self) -> ReplicaState:
        """This rank's row of a fresh cluster."""
        return init_state(self.cfg, rows=1, device=self.device)

    def fetch(self, x):
        """Host view of a value of this rank (replicated infos are the
        same on every rank)."""
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.asarray(x)

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
        package runs its mesh kernel)."""
        _no_ring(ring)
        cfg = self.cfg
        return replicate_step(
            self.comm, state, self._local(client_payload), client_count,
            leader, leader_term, alive, slow, floor_prev_term, repair_floor,
            self._member(member), ec=cfg.ec_enabled,
            commit_quorum=cfg.commit_quorum, repair=bool(repair),
            term_floor=term_floor)

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
        ``(state, infos, escaped, ran, halted)``."""
        _no_ring(ring)
        return fused_steady_scan(
            self.comm, self.cfg.commit_quorum, state, staging, start_slot,
            counts, n_run, halted0, leader, leader_term, alive, slow,
            floor_prev_term, repair_floor, self._member(member))

    def request_votes(self, state, candidate, cand_term, alive,
                      ring=None) -> Tuple[ReplicaState, VoteInfo]:
        _no_ring(ring)
        return vote_step(self.comm, state, candidate, cand_term, alive)
