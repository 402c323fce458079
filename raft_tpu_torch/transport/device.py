"""Single-device transport: the replica axis as a resident batch axis
(port of ``raft_tpu/transport/device.py``).

All R replica rows live on one device. Entry points run on CUDA unless
the caller passes ``device="cpu"`` (which runs every kernel's plain
version); there is no fallback to the CPU when no GPU is found.

``replicate_fused`` runs K steady ticks as one launch: on the card one
replay of a CUDA graph of the K-tick loop (``core.graphs``), on the CPU
the loop itself.

Every call consumes the state it is given: the rings are updated in place
and the returned state holds them.

``release()`` declares the engine on a transport dead (the chaos runner's
crash cycle): its rings, staging buffer and CUDA graphs go to the
process-wide pool (``core.graphs.POOL``), and the next transport of the
same shape on the same device takes them in ``init()``, so a restored
engine replays the graphs instead of capturing them anew.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.comm import SingleDeviceComm
from raft_tpu_torch.core.state import (
    ReplicaState,
    ResidentView,
    host_copy,
    init_state,
    state_to_numpy,
)
from raft_tpu_torch.core.step import (
    RepInfo,
    VoteInfo,
    fused_steady_scan,
    replicate_step,
    scan_replicate,
    vote_step,
)
from raft_tpu_torch.core.step_cuda import steady_pipeline
from raft_tpu_torch.obs.compile import labeled, labeled_method

#: process-wide program cache, keyed like the JAX transport's: every
#: transport over the same cluster shape shares one bound step function
#: per entry point, wrapped ``obs.compile.labeled`` when stored (the
#: fused window is labeled on ``replicate_fused`` as a whole, since on the
#: card it replays a graph and never reaches its partial).
_PROGRAMS: dict = {}
_COMMS: dict = {}


def _comm_for(rows: int) -> SingleDeviceComm:
    if rows not in _COMMS:
        _COMMS[rows] = SingleDeviceComm(rows)
    return _COMMS[rows]


def _replicate_program(rows: int, ec: bool, commit_quorum, rep: bool):
    key = ("replicate", rows, ec, commit_quorum, rep)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = labeled("single.replicate", partial(
            replicate_step, _comm_for(rows), ec=ec,
            commit_quorum=commit_quorum, repair=rep))
    return _PROGRAMS[key]


def _vote_program(rows: int):
    key = ("vote", rows)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = labeled("single.vote",
                                 partial(vote_step, _comm_for(rows)))
    return _PROGRAMS[key]


def _replicate_many_program(rows: int, ec: bool, commit_quorum, rep: bool):
    key = ("replicate_many", rows, ec, commit_quorum, rep)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = labeled("single.replicate_many", partial(
            scan_replicate, _comm_for(rows), ec, commit_quorum, rep))
    return _PROGRAMS[key]


def _pipeline_program(rows: int, ec: bool, commit_quorum):
    key = ("pipeline", rows, ec, commit_quorum)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = labeled("single.pipeline", partial(
            steady_pipeline, commit_quorum=commit_quorum, ec=ec))
    return _PROGRAMS[key]


def _fused_program(rows: int, commit_quorum):
    key = ("fused", rows, commit_quorum)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = partial(fused_steady_scan, _comm_for(rows),
                                 commit_quorum)
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


class SingleDeviceTransport(ResidentView):
    """The resident layout. As the engine's seam it has the mesh
    transport's row access (``core.state.ResidentView``: ``fetch_rows``,
    ``fetch_row``, ``place_rows`` and ``local_row`` are plain host copies
    and identities here) and a one-process mirror world
    (``processes`` 1, ``exchange_digest``)."""

    processes = 1

    def __init__(self, cfg: RaftConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.comm = _comm_for(cfg.rows)
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
        self._fused = _fused_program(cfg.rows, cfg.commit_quorum)
        self.graphs = None
        #   core.graphs.FusedGraphs on the card, built at the first fused
        #   launch (or taken over from a released transport by init())
        self._held = None
        #   what the pool may lend on (core.graphs.POOL): the rings init()
        #   last handed out and the graphs

    def init(self) -> ReplicaState:
        """A zero state. A released transport's rings of this shape on
        this device are reused (zeroed), with its graphs."""
        from raft_tpu_torch.core.graphs import POOL

        cfg = self.cfg
        lent = POOL.claim(
            self, self.device, cfg.rows, cfg.commit_quorum,
            (cfg.rows, cfg.log_capacity),
            (cfg.log_capacity, cfg.rows * cfg.shard_words))
        if lent is not None:
            self.graphs = lent.graphs
        state = init_state(cfg, device=self.device,
                           rings=None if lent is None else lent.rings)
        self._held = POOL.hold(self.device, cfg.rows, cfg.commit_quorum,
                               (state.log_term, state.log_payload),
                               self.graphs)
        return state

    def release(self) -> None:
        """The engine on this transport is dead: lend its rings, staging
        buffer and graphs to the next transport of this shape on this
        device (``core.graphs.POOL``). The transport must not be used
        again."""
        from raft_tpu_torch.core.graphs import POOL

        if self._held is not None:
            POOL.release(self, self._held)
        self.graphs = None
        self._held = None

    def fetch(self, x):
        """Host copy of a device value."""
        return host_copy(x)

    def gather_state(self, state: ReplicaState) -> dict:
        """The whole cluster's state as numpy leaves."""
        return state_to_numpy(state)

    def exchange_digest(self, value: int) -> np.ndarray:
        """The mirror digests of a one-process world: this one."""
        return np.array([int(value)], np.int64)

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
                  term_floor=None, ring=None) -> Tuple[ReplicaState, RepInfo]:
        """One leader tick. ``repair=False`` with ``term_floor`` runs the
        whole-step kernel; otherwise the general path (ring kernel).
        ``ring`` (``obs.device.EventRing``) records the step into it and
        makes the return ``(state, info, ring)``; ``None`` runs exactly
        the unrecorded program."""
        rec = {} if ring is None else {"ring": ring, "record": True}
        return self._replicate[bool(repair)](
            state, client_payload.to(self.device), client_count, leader,
            leader_term, alive, slow, floor_prev_term, repair_floor,
            self._member(member), term_floor=term_floor, **rec,
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

    def request_votes(self, state, candidate, cand_term, alive, ring=None,
                      quorum=0) -> Tuple[ReplicaState, VoteInfo]:
        """One election round. ``ring`` records it (the return is then a
        triple); ``quorum`` is the engine's win threshold (members // 2)
        the recorded election win uses."""
        if ring is not None:
            return self._vote(state, candidate, cand_term, alive, ring=ring,
                              record=True, quorum=quorum)
        return self._vote(state, candidate, cand_term, alive)

    def replicate_pipeline(self, state, payloads, counts, leader, leader_term,
                           alive, slow, member=None, repair_floor=0,
                           floor_prev_term=0, term_floor=1,
                           allow_turnover=True
                           ) -> Tuple[ReplicaState, RepInfo]:
        """T saturated steps as one flight (kernel K3, or K4 when the flight
        turns the ring over with every row accepting — decided on the
        device; ``allow_turnover=False`` keeps it to K3, as the JAX
        transport's flag does). Returns the FINAL step's info only."""
        return self._pipeline(
            state, payloads, counts, leader, leader_term, alive, slow,
            floor_prev_term, repair_floor, self._member(member), term_floor,
            allow_turnover=bool(allow_turnover),
        )

    @labeled_method("single.fused")
    def replicate_fused(self, state, staging, start_slot, counts, n_run,
                        halted0, leader, leader_term, alive, slow,
                        member=None, repair_floor=0, floor_prev_term=0,
                        ring=None):
        """K steady ticks with exact early exit (``fused_steady_scan``):
        ``staging`` i32[S, B, W] holds untiled payload words and
        ``start_slot``/``counts`` (i32[K])/``n_run`` select the window;
        ``halted0`` is a bool, or the ``halted`` a previous launch
        returned. Scalars and masks may be host values or tensors. On the
        card the call is one replay of a captured CUDA graph
        (``core.graphs``); on the CPU it runs the loop. ``ring``
        (``obs.device.EventRing``) records every tick into it in place
        (on the card inside the graph). Returns ``(state, infos, escaped,
        ran, halted[, ring])``; the passed state is consumed."""
        if member is None and self._member_mode:
            member = np.ones(self.cfg.rows, bool)
        if self.device.type == "cuda":
            if self.graphs is None:
                from raft_tpu_torch.core.graphs import FusedGraphs

                self.graphs = FusedGraphs(self.cfg.rows,
                                          self.cfg.commit_quorum,
                                          self.device)
                if self._held is not None:
                    self._held.graphs = self.graphs
            return self.graphs.run(
                state, staging, start_slot, counts, n_run, halted0, leader,
                leader_term, alive, slow, member, repair_floor,
                floor_prev_term, ring=ring)
        rec = {} if ring is None else {"ring": ring, "record": True}
        return self._fused(
            state, staging, start_slot, counts, n_run, halted0, leader,
            leader_term, alive, slow, floor_prev_term, repair_floor, member,
            **rec)
