"""Single-device transport: the replica axis as a resident batch axis
(port of ``raft_tpu/transport/device.py``).

All R replica rows live on one device. Entry points run on CUDA unless
the caller passes ``device="cpu"`` (which runs every kernel's plain
version); there is no fallback to the CPU when no GPU is found.

Every call consumes the state it is given: the rings are updated in place
and the returned state holds them.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.comm import SingleDeviceComm
from raft_tpu_torch.core.state import ReplicaState, init_state
from raft_tpu_torch.core.step import (
    RepInfo,
    VoteInfo,
    replicate_step,
    scan_replicate,
    vote_step,
)
from raft_tpu_torch.core.step_cuda import steady_pipeline

#: process-wide program cache, keyed like the JAX transport's: every
#: transport over the same cluster shape shares one bound step function
#: per entry point.
_PROGRAMS: dict = {}
_COMMS: dict = {}


def _comm_for(rows: int) -> SingleDeviceComm:
    if rows not in _COMMS:
        _COMMS[rows] = SingleDeviceComm(rows)
    return _COMMS[rows]


def _replicate_program(rows: int, ec: bool, commit_quorum, rep: bool):
    key = ("replicate", rows, ec, commit_quorum, rep)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = partial(replicate_step, _comm_for(rows), ec=ec,
                                 commit_quorum=commit_quorum, repair=rep)
    return _PROGRAMS[key]


def _vote_program(rows: int):
    key = ("vote", rows)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = partial(vote_step, _comm_for(rows))
    return _PROGRAMS[key]


def _replicate_many_program(rows: int, ec: bool, commit_quorum, rep: bool):
    key = ("replicate_many", rows, ec, commit_quorum, rep)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = partial(scan_replicate, _comm_for(rows), ec,
                                 commit_quorum, rep)
    return _PROGRAMS[key]


def _pipeline_program(rows: int, ec: bool, commit_quorum):
    key = ("pipeline", rows, ec, commit_quorum)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = partial(steady_pipeline,
                                 commit_quorum=commit_quorum, ec=ec)
    return _PROGRAMS[key]


def resolve_device(device=None) -> torch.device:
    """``device``, or CUDA when none is named — which must then exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on CUDA unless "
                "device='cpu' is passed explicitly")
        device = "cuda"
    return torch.device(device)


class SingleDeviceTransport:
    def __init__(self, cfg: RaftConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._member_mode = cfg.max_replicas is not None
        reps = (True,) if cfg.ec_enabled else (True, False)
        self._replicate = {
            rep: _replicate_program(cfg.rows, cfg.ec_enabled,
                                    cfg.commit_quorum, rep)
            for rep in reps
        }
        self._replicate_many = {
            rep: _replicate_many_program(cfg.rows, cfg.ec_enabled,
                                         cfg.commit_quorum, rep)
            for rep in reps
        }
        if cfg.ec_enabled:
            self._replicate[False] = self._replicate[True]
            self._replicate_many[False] = self._replicate_many[True]
        self._vote = _vote_program(cfg.rows)
        self._pipeline = _pipeline_program(cfg.rows, cfg.ec_enabled,
                                           cfg.commit_quorum)

    def init(self) -> ReplicaState:
        return init_state(self.cfg, device=self.device)

    def fetch(self, x):
        """Host view of a device value."""
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.asarray(x)

    def local_row(self, row: int) -> int:
        """Index of replica ``row`` in the state: every row is here."""
        return row

    def commit_index(self, state: ReplicaState, row: int) -> int:
        return int(state.commit_index[row])

    def _member(self, member):
        if member is None and self._member_mode:
            return torch.ones(self.cfg.rows, dtype=torch.bool,
                              device=self.device)
        return member

    def replicate(self, state, client_payload, client_count, leader,
                  leader_term, alive, slow, repair=True, member=None,
                  repair_floor=0, floor_prev_term=0,
                  term_floor=None) -> Tuple[ReplicaState, RepInfo]:
        """One leader tick. ``repair=False`` with ``term_floor`` runs the
        whole-step kernel; otherwise the general path (ring kernel)."""
        return self._replicate[bool(repair)](
            state, client_payload.to(self.device), client_count, leader,
            leader_term, alive, slow, floor_prev_term, repair_floor,
            self._member(member), term_floor=term_floor,
        )

    def replicate_many(self, state, payloads, counts, leader, leader_term,
                       alive, slow, repair=True, member=None, repair_floor=0,
                       floor_prev_term=0,
                       term_floor=None) -> Tuple[ReplicaState, RepInfo]:
        """T replication steps (``payloads`` i32[T, B, R*W], ``counts``
        i32[T]); RepInfo fields carry a leading [T] axis."""
        return self._replicate_many[bool(repair)](
            state, payloads.to(self.device), counts, leader, leader_term,
            alive, slow, floor_prev_term, repair_floor, self._member(member),
            term_floor=term_floor,
        )

    def request_votes(self, state, candidate, cand_term,
                      alive) -> Tuple[ReplicaState, VoteInfo]:
        return self._vote(state, candidate, cand_term, alive)

    def replicate_pipeline(self, state, payloads, counts, leader, leader_term,
                           alive, slow, member=None, repair_floor=0,
                           floor_prev_term=0,
                           term_floor=1) -> Tuple[ReplicaState, RepInfo]:
        """T saturated steps as one flight (kernel K3, or K4 when the flight
        turns the ring over with every row accepting — decided on the
        device). Returns the FINAL step's info only."""
        return self._pipeline(
            state, payloads, counts, leader, leader_term, alive, slow,
            floor_prev_term, repair_floor, self._member(member), term_floor,
        )
