"""The cluster engine's tick loop: timers and roles on the host, protocol
steps on the device (port of ``raft_tpu/raft/engine.py``, ROADMAP A9a).

One host thread owns every replica's timers and roles on a virtual clock
(a heap of timer events drawn from ``random.Random(cfg.seed)``); the
data plane is the transport's batched device program:

- a follower whose election timer fires campaigns (``_fire_follower``,
  one collective ``request_votes`` round; ``prevote`` runs the §9.6
  round on the host first);
- the leader's tick (``_fire_leader_tick``) drains up to one batch from
  the client queue into one ``replicate`` call — the repair-capable
  general path (kernel K1) until every reachable follower is verified at
  the leader's tail, then the steady step (kernel K2, behind
  ``term_floor``) while ``steady_dispatch="auto"``;
- ``submit_pipelined`` replicates whole rings of full batches as one
  flight (kernels K3/K4) on a verified-steady cluster, ``replicate_many``
  otherwise;
- commits stamp client sequence numbers, move the committed entries into
  the host archive (``ckpt.CheckpointStore``) and feed the apply stream
  (``register_apply``).

With the same ``RaftConfig`` and seed and the same sequence of calls, the
engine gives byte-identical results to the JAX engine: nodelog lines, the
rng and the event heap, commit stamps, terms and roles, committed bytes
and the apply stream. The device state is a ``ReplicaState`` of torch
tensors on the transport's device; the host mirrors are numpy, as there.
``RaftEngine(cfg)`` builds ``make_transport(cfg)``, which runs on CUDA;
pass a transport built with ``device="cpu"`` to run the plain versions.

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP
item: snapshot streaming to a ring-lapped replica, checkpoints and the
vote log (A9b); membership changes and ``max_replicas`` (A9c); reads and
leases (A9d); erasure coding (A9e); K-tick fusion (A11); the tiered
archive and the device event ring (A13); the multihost mirror digest
(A15); the flight recorder (A16). The observability hooks of the JAX
engine (``spans``, ``metrics``, ``hostprof``, ``auditor``, ``slo``,
``status_board``) come with A16, and the engine has no such attributes
until then.
"""

from __future__ import annotations

import heapq
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.admission import AdmissionGate
from raft_tpu_torch.ckpt import CheckpointStore, SnapshotShipper
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.state import (
    ReplicaState,
    fold_batch,
    last_log_term,
    log_entries,
)
from raft_tpu_torch.core.step_cuda import pick_br, shape_ok
from raft_tpu_torch.obs import profiling as _profiling
from raft_tpu_torch.raft.ledger import (
    durable_range_covers,
    evict_commit_stamps,
)
from raft_tpu_torch.transport.base import Transport, make_transport

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


def _pipeline_backend_ok(device) -> bool:
    """The single-launch pipeline chunk runs on the card only, as the JAX
    engine's runs on a TPU only (``engine.py:68``): an engine chunk spans
    the whole ring, which the JAX kernels' interpret mode cannot model,
    so on the CPU both engines take the scanned path. Tests patch this
    hook (and the JAX engine's) to drive the flight through the plain
    versions."""
    return device is not None and torch.device(device).type == "cuda"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to raft_tpu_torch yet (ROADMAP {item})")


class LinearizableReadRefused(Exception):
    """``read_linearizable`` could not confirm leadership (the JAX
    engine's exception; the read paths are ROADMAP A9d)."""


class TicketEvicted(LinearizableReadRefused):
    """A ``submit_read`` ticket was evicted before it was polled."""


class LearnerLagging(RuntimeError):
    """``promote`` refused: the learner is still too far behind."""


class MirrorDesyncError(Exception):
    """The mirrored multihost control planes' decision streams diverged."""


class VirtualClock:
    """Deterministic time source; the engine advances it to each event."""

    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


class RaftEngine:
    """One process hosting all replica control planes (the JAX engine's
    tick loop; see the module docstring for what is not ported yet).

    Fault masks (``alive``/``slow``) are first-class: a "dead" replica's
    timers do not fire and the device step ignores it; ``connectivity``
    expresses link-level partitions (``partition``/``heal_partition``).
    """

    def __init__(
        self,
        cfg: RaftConfig,
        transport: Optional[Transport] = None,
        trace: Optional[Callable[[str], None]] = None,
        vote_log: Optional[str] = None,
        recorder=None,
    ):
        self._refuse_unported(cfg, vote_log, recorder)
        self.cfg = cfg
        self.t: Transport = (transport if transport is not None
                             else make_transport(cfg))
        self._dev = getattr(self.t, "device", None)
        self.state: ReplicaState = self.t.init()
        self.rng = random.Random(cfg.seed)
        self.clock = VirtualClock()
        self._trace = trace
        self._tick_count = 0
        #   Leader ticks fired so far (the launch annotation's step)

        n = cfg.rows
        self.member = np.ones(n, bool)
        #   The configuration: fixed here (every row a voter); membership
        #   changes are ROADMAP A9c. Quorums are counted over members.
        self.roles: List[str] = [FOLLOWER] * n
        self.terms = np.zeros(n, np.int64)     # host mirror for timer logic
        self.lead_terms = np.zeros(n, np.int64)
        #   The term each replica last won an election in. Distinct from
        #   ``terms`` (highest term SEEN): a split-brain stale leader keeps
        #   ticking in its lead term, and hearing any higher term is the
        #   step-down condition.
        self.alive = np.ones(n, bool)
        self.slow = np.zeros(n, bool)
        self.connectivity = np.ones((n, n), bool)
        #   Link-level reachability: replica a exchanges messages with b
        #   iff connectivity[a, b]; composed with ``alive`` into each
        #   step's effective mask.
        self.leader_id: Optional[int] = None
        self.leader_term = 0
        self._last_heard = np.full(n, -1e18)
        #   When each replica last heard a leader's traffic (virtual
        #   clock) — the §9.6 leader-stickiness evidence for PreVote.
        self._quorum_contact_at: Dict[int, float] = {}
        #   Per-leader: when it last contacted a member majority
        #   (CheckQuorum's lease clock).
        self.commit_watermark = 0                  # committed LOG INDEX
        self.submit_time: Dict[int, float] = {}    # seq -> submit time
        self.commit_time: Dict[int, float] = {}    # seq -> commit time
        self.committed_total = 0
        #   All-time committed-entry count; ``commit_time`` is bounded
        #   (stamps past ``_commit_stamp_cap`` evict oldest-first into
        #   ``_durable_ranges``, raft.ledger), so ``is_durable`` answers
        #   for every seq ever issued.
        self.commit_stamps_evicted = 0
        self._commit_stamp_cap = 2 * cfg.log_capacity
        self._durable_ranges: List[List[int]] = []
        self._seq_at_index: Dict[int, int] = {}    # log index -> client seq
        #   Mapped at ingestion time, because log indices and sequence
        #   numbers diverge once a leadership change drops queued entries.
        self._hb_payload = None                    # cached all-zero batch
        self._uncommitted: Dict[int, Tuple[bytes, int]] = {}
        #   log index -> (full payload, ingest term): entries move from
        #   here into the archive when they commit. Bounded by ring
        #   backpressure: leader_last - commit <= log_capacity entries.
        self.store = CheckpointStore(
            cfg.entry_bytes, max_entries=2 * cfg.log_capacity
        )
        #   Host archive of the committed log (term + bytes per entry);
        #   compacts beyond 2x the ring capacity.
        self._shipper = SnapshotShipper(
            cfg.catchup_chunk_entries or cfg.batch_size
        )
        #   Incremental snapshot shipping's bookkeeping (ckpt.ship); the
        #   install itself is ROADMAP A9b.
        self._lasts_snapshot = None   # see _pre_lasts
        self._term_floor = 1   # first log index of the current leader's
        #   term (the §5.4.2 gate of the steady kernels): set to
        #   last_index+1 on every election win, clamped down when a
        #   truncation drops the tail below it.
        self._ring_floor = np.ones(n, np.int64)
        #   Per-replica smallest log index whose ring slot is guaranteed
        #   to hold that entry's real bytes (raised by truncations after a
        #   ring wrap).
        self._match_stall = [0] * n
        #   Consecutive leader ticks each replica has sat below the ring
        #   horizon without match progress (a replica that STAYS stalled
        #   is lapped and needs a snapshot install).
        self._steady = False
        #   True when the last replicate step showed every live non-slow
        #   follower fully caught up: the next step may run the steady
        #   program. Cleared by every event that can create a straggler.
        self._apply_fns: List[Tuple[Callable[[int, bytes], None], int]] = []
        #   (callback, first index it receives)
        self.applied_index = 0
        #   State-machine apply cursor (see register_apply).
        self._lost_gaps: set = set()   # unrecoverable apply gaps, logged once
        self._queue: List[Tuple[int, bytes]] = []  # pending (seq, payload)
        self.admission = AdmissionGate.from_config(cfg, self.clock)
        #   Bounded admission (None = unbounded): submit arrivals pass
        #   the gate before anything is queued, and the leader tick feeds
        #   it the head-of-queue sojourn for the delay controller.
        self._fault_events: list = []              # FaultPlan merge targets
        self._next_seq = 1
        self._q: List[Tuple[float, int, str, int]] = []  # (t, tiebreak, kind, replica)
        self._seq_events = 0
        self._timer_gen = [0] * n
        for r in range(n):
            self._arm_follower(r)

    @staticmethod
    def _refuse_unported(cfg: RaftConfig, vote_log, recorder) -> None:
        """Raise for every configuration whose code is not ported yet."""
        if cfg.max_replicas is not None:
            raise _not_ported("max_replicas (membership headroom)", "A9c")
        if cfg.ec_enabled:
            raise _not_ported("the erasure-coded engine (rs_k)", "A9e")
        if cfg.read_lease:
            raise _not_ported("read_lease (leader leases)", "A9d")
        fuse_k = max(1, int(os.environ.get("RAFT_TPU_FUSE_K", "")
                            or cfg.fuse_k))
        if fuse_k > 1:
            raise _not_ported("K-tick fusion (fuse_k > 1)", "A11")
        if os.environ.get("RAFT_TPU_TIERED_DIR", "") or cfg.tiered_log_dir:
            raise _not_ported("the tiered archive (tiered_log_dir)", "A13")
        if cfg.mirror_check_every:
            raise _not_ported("the multihost mirror digest "
                              "(mirror_check_every)", "A15")
        if vote_log is not None:
            raise _not_ported("the vote log (vote_log=)", "A9b")
        if recorder is not None:
            raise _not_ported("the flight recorder (recorder=)", "A16")

    # ------------------------------------------------------------------ util
    def _fetch(self, x) -> np.ndarray:
        """Host copy of a device value (never a view of a CPU tensor the
        steps may later update in place)."""
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True).numpy()
        return np.array(x)

    def _dev_arr(self, x) -> torch.Tensor:
        """A host mask or count vector as a tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self._dev)

    def _nodelog_at(self, r: int, msg: str, commit: int, last: int) -> str:
        """``nodelog`` with caller-supplied commit/last values."""
        if self._trace is None:
            return ""
        line = (
            f"[Server{r}:{self.terms[r]}:{commit}:{last}]"
            f"[{self.roles[r]}]{msg}"
        )
        self._trace(line)
        return line

    def nodelog(self, r: int, msg: str) -> str:
        """The reference's trace schema (main.go:399-401) — the
        differential join key: [Id:Term:CommitIndex:LastApplied][state]msg.
        With no trace sink attached the device fetch is skipped."""
        if self._trace is None:
            return ""
        ci_li = self._fetch(
            torch.stack([self.state.commit_index, self.state.last_index])
        )   # one fetch for both fields
        return self._nodelog_at(r, msg, int(ci_li[0, r]), int(ci_li[1, r]))

    def _push(self, t: float, kind: str, replica: int) -> None:
        heapq.heappush(self._q, (t, self._seq_events, kind, replica))
        self._seq_events += 1

    def _arm_follower(self, r: int) -> None:
        """Randomized election timeout (reference: uniform int 10-29 s,
        main.go:114) scaled by the configured window."""
        self._timer_gen[r] += 1
        lo, hi = self.cfg.follower_timeout
        self._push(self.clock.now + self.rng.uniform(lo, hi),
                   f"e:{self._timer_gen[r]}", r)

    def _arm_candidate(self, r: int) -> None:
        # reference: uniform 10-13 s (main.go:194)
        self._timer_gen[r] += 1
        lo, hi = self.cfg.candidate_timeout
        self._push(self.clock.now + self.rng.uniform(lo, hi),
                   f"c:{self._timer_gen[r]}", r)

    # ------------------------------------------------------------- client API
    def submit(self, payload: bytes, client=None) -> int:
        """Queue one entry; returns its sequence number. The entry is
        durable once ``is_durable(seq)``; entries queued or ingested but
        uncommitted across a leadership change may be dropped (their seq
        never becomes durable; clients resubmit). With admission
        configured an arrival the gate refuses raises
        ``admission.Overloaded`` before anything is queued."""
        if len(payload) != self.cfg.entry_bytes:
            raise ValueError(
                f"payload must be exactly {self.cfg.entry_bytes} bytes"
            )
        if self.admission is not None:
            self.admission.admit_write(len(self._queue), client)
        seq = self._next_seq
        self._next_seq += 1
        self._queue.append((seq, payload))
        self.submit_time[seq] = self.clock.now
        return seq

    def is_durable(self, seq: int) -> bool:
        if seq in self.commit_time:
            return True
        return durable_range_covers(self._durable_ranges, seq)

    def _evict_commit_stamps(self) -> None:
        """Bound the per-entry stamp dicts: past ``_commit_stamp_cap``
        retained stamps, evict oldest-first into the merged durable-seq
        intervals (``raft.ledger``)."""
        self.commit_time, self.submit_time, n = evict_commit_stamps(
            self.commit_time, self.submit_time, self._commit_stamp_cap,
            self._durable_ranges,
        )
        self.commit_stamps_evicted += n

    def _pack_entries(self, entries, padded_len: int) -> np.ndarray:
        """(seq, payload) pairs -> u8[padded_len, entry_bytes], zero-padded
        past the real entries (shared by the tick and pipelined ingest)."""
        if entries and len(entries) == padded_len:
            return np.frombuffer(
                b"".join(p for _, p in entries), np.uint8
            ).reshape(padded_len, self.cfg.entry_bytes)
        data = np.zeros((padded_len, self.cfg.entry_bytes), np.uint8)
        if entries:
            data[:len(entries)] = np.frombuffer(
                b"".join(p for _, p in entries), np.uint8
            ).reshape(len(entries), self.cfg.entry_bytes)
        return data

    def _step_down_leader(self, r: int, max_term: int) -> None:
        """A higher term exists: the leader reverts to follower
        (main.go:309-321); the device step already refused ingest/commit
        for the stale term."""
        self.roles[r] = FOLLOWER
        self.terms[r] = max_term
        if self.leader_id == r:
            self.leader_id = None
        self.nodelog(r, "step down to follower")
        self._arm_follower(r)

    def submit_pipelined(self, payloads: List[bytes]) -> List[int]:
        """High-throughput ingest: replicate and commit many batches in
        chunks of one ring, syncing to the host once per chunk. On a
        verified-steady cluster whose chunk is one whole ring of full
        batches (``_pipeline_eligible``) the chunk is ONE flight on the
        card (``transport.replicate_pipeline``: K3, or K4 when every row
        accepts); otherwise it is ``replicate_many`` (a scan of ticks).
        ``cfg.pipeline_max_laps > 1`` lets an all-accept backlog span
        several ring turnovers in one flight.

        Requires a current leader. Returns the entries' sequence numbers;
        durability reporting matches ``submit``. Entries already queued
        via ``submit`` are folded in ahead of ``payloads``."""
        cfg = self.cfg
        r = self.leader_id
        if r is None:
            raise RuntimeError("submit_pipelined requires a current leader")
        for p in payloads:  # validate all before assigning any seq
            if len(p) != cfg.entry_bytes:
                raise ValueError(
                    f"payload must be exactly {cfg.entry_bytes} bytes"
                )
        seqs = [self.submit(p) for p in payloads]
        pending, self._queue = self._queue, []
        B = cfg.batch_size
        T_ring = cfg.log_capacity // B
        while pending:
            if self.leader_id != r or not self.alive[r]:
                break
            leader_last = int(self._fetch(self.state.last_index)[r])
            eff = self._reach(r)
            steps = (
                self.state.capacity - (leader_last - self.commit_watermark)
            ) // B
            if steps <= 0:
                # ring full of uncommitted entries — the tick path must
                # drain commits first; leave the rest queued
                break
            take = min(len(pending), steps * B)
            # fixed scan length: zero-count (heartbeat) steps pad the chunk
            T = T_ring
            eligible = self._pipeline_eligible(r, take, T, leader_last, eff)
            # every row in the gate's verified accept set: the turnover
            # kernel's predicate; only that branch is certified across
            # ring laps, so the lap decision and allow_turnover share it
            all_accept = bool(eligible and self._gate_accept.all())
            if (
                all_accept and cfg.pipeline_max_laps > 1
                and len(pending) >= cfg.pipeline_max_laps * T_ring * B
            ):
                T = cfg.pipeline_max_laps * T_ring
                take = T * B
            chunk = pending[:take]
            used = -(-take // B)
            counts = np.zeros(T, np.int32)
            counts[:used] = B
            if used:
                counts[used - 1] = take - (used - 1) * B
            data = self._pack_entries(chunk, T * B)
            payload_stack = fold_batch(data, cfg.rows,
                                       device=self._dev).reshape(T, B, -1)
            pre_lasts = self._pre_lasts()
            floor, fpt = self._floor_attest(r)
            if eligible:
                # the saturated fast path: the whole chunk as ONE flight;
                # the host gate implies the kernel's feasibility
                # predicate, so every step ingests and commits a full
                # batch — verified by the commit check below
                self.state, info = self.t.replicate_pipeline(
                    self.state, payload_stack, self._dev_arr(counts), r,
                    self.leader_term, self._dev_arr(eff),
                    self._dev_arr(self.slow), member=None,
                    repair_floor=floor, floor_prev_term=fpt,
                    term_floor=self._term_floor,
                    allow_turnover=all_accept,
                )
                self._note_truncations(pre_lasts)
                final_commit = int(info.commit_index)
                if final_commit != leader_last + take:
                    # gate and kernel out of sync: account the committed
                    # prefix, truncate the orphaned suffix, re-queue the
                    # rest, then fail loudly
                    done = min(max(final_commit - leader_last, 0), take)
                    self._account_chunk_prefix(
                        r, chunk, done, leader_last, eff
                    )
                    self._truncate_uncommitted_tail(
                        leader_last + done,
                        self._fetch(self.state.last_index),
                    )
                    self._queue = (
                        list(chunk[done:]) + pending[take:] + self._queue
                    )
                    raise RuntimeError(
                        f"pipeline chunk shortfall: committed "
                        f"{final_commit}, expected {leader_last + take} "
                        "(host feasibility gate out of sync with the "
                        "kernel's launch predicate); device log "
                        "reconciled, uncommitted remainder re-queued"
                    )
                self._account_chunk_prefix(r, chunk, take, leader_last, eff)
                pending = pending[take:]
                self._update_steady(r, info.match, eff)
                if int(info.max_term) > self.leader_term:
                    self._step_down_leader(r, int(info.max_term))
                    break
                continue
            self.state, infos = self.t.replicate_many(
                self.state, payload_stack, self._dev_arr(counts), r,
                self.leader_term, self._dev_arr(eff),
                self._dev_arr(self.slow),
                repair=self._repair_program(),
                member=self._member_arg(),
                repair_floor=floor,
                floor_prev_term=fpt,
                term_floor=self._term_floor,
            )
            self._note_truncations(pre_lasts)
            # ---- one host sync for the whole chunk ----
            frontier = self._fetch(infos.frontier_len)
            max_term = int(np.max(self._fetch(infos.max_term)))
            final_commit = int(self._fetch(infos.commit_index)[-1])
            idx = leader_last
            pos = 0
            refused: List[Tuple[int, bytes]] = []
            for t in range(T):
                cnt, ing = int(counts[t]), int(frontier[t])
                for i, (seq, p) in enumerate(chunk[pos:pos + cnt]):
                    if i < ing:
                        idx += 1
                        self._seq_at_index[idx] = seq
                        self._uncommitted[idx] = (p, self.leader_term)
                    else:
                        refused.append((seq, p))
                pos += cnt
            pending = refused + pending[take:]
            self.terms[eff] = np.maximum(self.terms[eff], self.leader_term)
            self._advance_commit(r, final_commit)
            self._update_steady(r, infos.match[-1], eff)
            if max_term > self.leader_term:
                # deposed mid-chunk: hand the rest back to the queue
                self._step_down_leader(r, max_term)
                break
            if refused:
                break  # no progress is possible right now; don't spin
        self._queue = pending + self._queue
        if self.leader_id == r:
            self._reset_heard_timers(r)
        return seqs

    def _account_chunk_prefix(self, r: int, chunk, n: int,
                              leader_last: int, eff) -> None:
        """Durable accounting for the first ``n`` entries of a pipeline
        chunk at contiguous indices after ``leader_last``: seq and payload
        bookkeeping, term adoption, then the commit advance. Shared by the
        fast path's success and shortfall branches."""
        for i, (seq, p) in enumerate(chunk[:n]):
            idx = leader_last + 1 + i
            self._seq_at_index[idx] = seq
            self._uncommitted[idx] = (p, self.leader_term)
        self.terms[eff] = np.maximum(self.terms[eff], self.leader_term)
        self._advance_commit(r, leader_last + n)

    def _pipeline_eligible(self, r: int, take: int, T: int,
                           leader_last: int, eff) -> bool:
        """Host gate for the single-launch pipeline chunk; it IMPLIES the
        kernel's launch-feasibility predicate, so the flight ingests and
        commits a full batch every step:

        - the transport has the flight, it runs on the card
          (``_pipeline_backend_ok``) and the shapes are the kernels'
          (``shape_ok``: 128 divides B and C);
        - the chunk is exactly one full ring of full batches;
        - the cluster is VERIFIED steady and fully committed, with the
          start slot aligned to the kernels' row block (``pick_br``);
        - the accept set (every reachable non-slow row whose device log
          provably matches the leader's through ``leader_last``) meets
          the commit quorum, and no reachable row holds a higher term.
        """
        cfg = self.cfg
        B = cfg.batch_size
        if not (
            getattr(self.t, "replicate_pipeline", None) is not None
            and _pipeline_backend_ok(self._dev)
            and take == T * B
            and shape_ok(cfg.log_capacity, B)
            and self._steady
            and self.commit_watermark == leader_last
        ):
            return False
        if leader_last % pick_br(B, cfg.log_capacity) != 0:
            return False
        if np.any(self.terms[eff] > self.leader_term):
            return False
        lasts, matches, mterms, dterms = self._fetch(torch.stack([
            self.state.last_index, self.state.match_index,
            self.state.match_term, self.state.term,
        ]))
        verified = (
            (lasts == leader_last) & (dterms <= self.leader_term)
            & (
                (leader_last == 0)   # empty prefix: no prev point
                | ((mterms == self.leader_term) & (matches >= leader_last))
            )
        )
        # the leader's own row needs no verified match, only a current
        # term and the expected tail
        verified[r] = (
            lasts[r] == leader_last and dterms[r] <= self.leader_term
        )
        accept = eff & ~self.slow & verified
        # stashed for the caller: the lap gate and allow_turnover must
        # see the SAME accept set this gate counted
        self._gate_accept = accept
        return int(accept.sum()) >= cfg.commit_quorum

    @property
    def in_flight_count(self) -> int:
        """Entries ingested into the leader's log but not yet committed."""
        return sum(
            1 for seq in self._seq_at_index.values()
            if seq not in self.commit_time
        )

    # --------------------------------------------------- reads (ROADMAP A9d)
    def submit_read(self, r: Optional[int] = None) -> int:
        raise _not_ported("submit_read (batched ReadIndex)", "A9d")

    def read_confirmed(self, ticket: int) -> Optional[int]:
        raise _not_ported("read_confirmed (batched ReadIndex)", "A9d")

    def read_linearizable(self, r: Optional[int] = None) -> int:
        raise _not_ported("read_linearizable (ReadIndex)", "A9d")

    def lease_read_index(self, r: int) -> Optional[int]:
        raise _not_ported("lease_read_index (leader leases)", "A9d")

    # ---------------------------------------------- membership (ROADMAP A9c)
    def _member_arg(self):
        """The membership mask for device steps: None on a
        fixed-membership cluster (the steps count the static quorum);
        the mask forms of ``max_replicas`` clusters are ROADMAP A9c."""
        return None

    def add_learner(self, r: int) -> int:
        raise _not_ported("add_learner", "A9c")

    def promote(self, r: int) -> int:
        raise _not_ported("promote", "A9c")

    def add_server(self, r: int) -> int:
        raise _not_ported("add_server", "A9c")

    def add_voter(self, r: int) -> int:
        raise _not_ported("add_voter", "A9c")

    def remove_server(self, r: int) -> int:
        raise _not_ported("remove_server", "A9c")

    def replace(self, dead: int, spare: int) -> int:
        raise _not_ported("replace", "A9c")

    def run_until_voter(self, r: int, limit: float = 600.0) -> None:
        raise _not_ported("run_until_voter", "A9c")

    def wipe(self, r: int) -> None:
        raise _not_ported("wipe", "A9c")

    # --------------------------------------- device observability (A13)
    def attach_device_obs(self, obs=None, capacity: int = 4096):
        raise _not_ported("attach_device_obs (the device event ring)",
                          "A13")

    # ---------------------------------------------------------- fault toggles
    def fail(self, r: int) -> None:
        """Silence a replica (crash). Its timers stop; the device step
        masks it out."""
        self._steady = False
        self.alive[r] = False
        if self.leader_id == r:
            self.leader_id = None
        self.roles[r] = FOLLOWER
        self.nodelog(r, "killed")

    def recover(self, r: int) -> None:
        self._steady = False
        self.alive[r] = True
        self.roles[r] = FOLLOWER
        self.nodelog(r, "recovered")
        self._arm_follower(r)

    def set_slow(self, r: int, is_slow: bool) -> None:
        """Induced-slow follower: receives traffic, appends nothing (stale
        matchIndex — BASELINE config 4)."""
        self._steady = False
        self.slow[r] = is_slow

    def force_campaign(self, r: int) -> None:
        """Disruptive candidacy regardless of a live leader: term bump +
        vote round (the election-storm injection, BASELINE config 5)."""
        if not self.alive[r] or not self.member[r]:
            return
        if self.roles[r] == LEADER and self.leader_id == r:
            return  # a leader bumping itself is a no-op disruption
        if self.cfg.prevote and not self._prevote_wins(r):
            # §9.6: the stickiness clause refuses the disruption while a
            # live leader is heartbeating
            self.nodelog(r, "injected candidacy suppressed by pre-vote")
            return
        self.roles[r] = CANDIDATE
        self.terms[r] += 1
        self.nodelog(r, "state changed to candidate (injected)")
        self._campaign(r)  # every _campaign outcome re-arms the right timer

    def _reach(self, src: int) -> np.ndarray:
        """Effective alive mask for a REPLICATION step sourced at ``src``:
        a live member, link-reachable from it (``src`` included)."""
        return self.alive & self.connectivity[src] & self.member

    def _voter_reach(self, src: int) -> np.ndarray:
        """Reachable live VOTERS from ``src`` — the mask every vote round
        and CheckQuorum counts over (the same as ``_reach`` while the
        configuration has no learners, ROADMAP A9c)."""
        return self.alive & self.connectivity[src] & self.member

    def _pre_lasts(self):
        """last_index as of the previous step's end — the cached copy from
        _note_truncations when no host-side mutation touched last_index
        since, else one fresh fetch."""
        if self._lasts_snapshot is not None:
            return self._lasts_snapshot
        return self._fetch(self.state.last_index)

    def _floor_attest(self, r: int):
        """(repair_floor, attested term of floor-1) for leader ``r``: the
        truncation floor raised to the lap horizon ``last - capacity + 1``;
        the attested term comes from the archive (0 when unattestable)."""
        cap = self.state.capacity
        lap = int(self._pre_lasts()[r]) - cap + 1
        floor = max(int(self._ring_floor[r]), lap)
        if floor <= 1:
            return floor, 0
        ent = self.store.get(floor - 1)
        return floor, (ent[1] if ent is not None else 0)

    def _note_truncations(self, pre_lasts) -> None:
        """Bump a row's ring-validity floor when a step truncated its log
        (§5.3 conflict): indices above ``pre_last - capacity`` were
        provably never overwritten by a wrapped generation."""
        post = self._fetch(self.state.last_index)
        shrunk = np.flatnonzero(post < np.asarray(pre_lasts))
        for q in shrunk:
            q = int(q)
            self._ring_floor[q] = max(
                self._ring_floor[q],
                int(pre_lasts[q]) - self.state.capacity + 1,
            )
        self._lasts_snapshot = post

    def partition(self, groups) -> None:
        """Install a link-level partition: replicas exchange messages only
        within their group (every member in exactly one group)."""
        n = self.cfg.rows
        listed = sorted(x for g in groups for x in g)
        if len(set(listed)) != len(listed) or not all(
            0 <= x < n for x in listed
        ):
            raise ValueError("groups must not repeat or exceed row range")
        missing = [x for x in range(n) if x not in set(listed)]
        if any(self.member[x] for x in missing):
            raise ValueError(
                f"groups must cover every member; missing {missing}"
            )
        groups = list(groups) + [[x] for x in missing]
        self._steady = False
        self.connectivity = np.zeros((n, n), bool)
        for g in groups:
            for a in g:
                for b in g:
                    self.connectivity[a, b] = True
        self.nodelog(0, f"partition installed: {[sorted(g) for g in groups]}")

    def heal_partition(self) -> None:
        n = self.cfg.rows
        self._steady = False
        self.connectivity = np.ones((n, n), bool)
        self.nodelog(0, "partition healed")

    def schedule_faults(self, plan) -> None:
        """Merge a ``faults.FaultPlan`` into the event heap; events fire at
        their absolute virtual-clock times, interleaved deterministically
        with protocol timers."""
        base = len(self._fault_events)
        self._fault_events.extend(plan.events)
        for i, ev in enumerate(plan.events):
            self._push(ev.t, f"f:{base + i}", ev.replica)

    # ------------------------------------------------------------- event loop
    def step_event(self, horizon: Optional[float] = None) -> bool:
        """Advance the clock to the next timer and handle it. ``horizon``
        is accepted for the JAX signature: it only matters to K-tick
        fusion (ROADMAP A11)."""
        if not self._q:
            return False
        t, _, kind, r = heapq.heappop(self._q)
        self.clock.now = max(self.clock.now, t)
        tag, _, gen = kind.partition(":")
        if tag in ("e", "c") and int(gen) != self._timer_gen[r]:
            return True   # stale timer generation (reset since armed)
        if tag == "e":
            self._fire_follower(r)
        elif tag == "c":
            self._fire_candidate(r)
        elif tag == "l":
            self._fire_leader_tick(r)
        elif tag == "f":
            ev = self._fault_events[int(gen)]
            {
                "kill": self.fail,
                "recover": self.recover,
                "slow": lambda p: self.set_slow(p, True),
                "unslow": lambda p: self.set_slow(p, False),
                "campaign": self.force_campaign,
                "partition": lambda p: self.partition(ev.groups),
                "heal_partition": lambda p: self.heal_partition(),
            }[ev.action](ev.replica)
        return True

    def next_event_time(self) -> Optional[float]:
        """Virtual-clock time of the next pending event, or None."""
        return self._q[0][0] if self._q else None

    def run_for(self, seconds: float, max_events: int = 100_000) -> None:
        end = self.clock.now + seconds
        for _ in range(max_events):
            if not self._q or self._q[0][0] > end:
                break
            self.step_event(horizon=end)
        self.clock.now = max(self.clock.now, end)

    def run_until_leader(self, limit: float = 600.0) -> int:
        end = self.clock.now + limit
        while self.leader_id is None and self.clock.now < end and self._q:
            self.step_event()
        assert self.leader_id is not None, "no leader elected within limit"
        return self.leader_id

    def run_until_committed(self, seq: int, limit: float = 600.0) -> None:
        """Run until client entry ``seq`` is durable (see ``submit``)."""
        end = self.clock.now + limit
        while not self.is_durable(seq) and self.clock.now < end and self._q:
            self.step_event()
        assert self.is_durable(seq), (
            f"seq {seq} not committed (watermark {self.commit_watermark})"
        )

    # ----------------------------------------------------------- role actions
    def _fire_follower(self, r: int) -> None:
        """Election timeout (main.go:171-177): follower -> candidate."""
        if not self.alive[r] or self.roles[r] != FOLLOWER or not self.member[r]:
            return
        if self.cfg.prevote and not self._prevote_wins(r):
            # §9.6: a would-be loser neither bumps its term nor disturbs
            # anyone — it stays a follower and tries again later
            self.nodelog(r, "pre-vote failed; staying follower")
            self._arm_follower(r)
            return
        self.roles[r] = CANDIDATE
        self.terms[r] += 1
        self.nodelog(r, "state changed to candidate")
        self._campaign(r)

    def _fire_candidate(self, r: int) -> None:
        """Candidate re-election timeout (main.go:248-251): term+1, retry."""
        if not self.alive[r] or self.roles[r] != CANDIDATE or not self.member[r]:
            return
        if self.cfg.prevote and not self._prevote_wins(r):
            self.roles[r] = FOLLOWER
            self.nodelog(r, "pre-vote failed; state changed to follower")
            self._arm_follower(r)
            return
        self.terms[r] += 1
        self._campaign(r)

    def _prevote_wins(self, r: int) -> bool:
        """§9.6 PreVote round, host-side and NON-BINDING: would a member
        majority grant ``r`` a vote at term+1? A grantor refuses when it
        already sits at/above that term, when its log is more up to date,
        or when it heard a live leader within the minimum election
        timeout (leader stickiness). Nothing changes on the device."""
        eff = self._voter_reach(r)
        lasts, last_terms = self._fetch(torch.stack(
            [self.state.last_index, last_log_term(self.state)]))
        cand_key = (int(last_terms[r]), int(lasts[r]))
        cand_term = int(self.terms[r]) + 1
        stick = self.cfg.follower_timeout[0]
        grants = 0
        for p in np.flatnonzero(eff):
            p = int(p)
            if int(self.terms[p]) >= cand_term:
                continue
            if (int(last_terms[p]), int(lasts[p])) > cand_key:
                continue
            if p != r and self.clock.now - self._last_heard[p] < stick:
                continue
            grants += 1
        return grants > int(self.member.sum()) // 2

    def _campaign(self, r: int) -> None:
        """One collective vote round (replaces the serial poll,
        main.go:253-284)."""
        cand_term = int(self.terms[r])
        eff = self._voter_reach(r)
        self.state, info = self.t.request_votes(
            self.state, r, cand_term, self._dev_arr(eff)
        )
        votes = int(info.votes)
        max_term = int(info.max_term)
        self.terms[eff] = np.maximum(self.terms[eff], cand_term)
        if max_term > cand_term:
            # someone is ahead; fall back to follower in the newer term
            self.terms[r] = max_term
            self.roles[r] = FOLLOWER
            self._arm_follower(r)
            return
        if votes > int(self.member.sum()) // 2:   # main.go:273, over members
            if self.leader_id != r:
                # A different leader's log may differ above the commit
                # watermark: drop the index->seq mappings of uncommitted
                # entries (their seqs read as lost), and the ingest-buffer
                # entries no replica's log still holds.
                self._seq_at_index = {
                    i: s for i, s in self._seq_at_index.items()
                    if i <= self.commit_watermark
                }
                above = sorted(
                    i for i in self._uncommitted if i > self.commit_watermark
                )
                if above:
                    idx = np.asarray(above)
                    slots = (idx - 1) % self.state.capacity
                    terms_all = self._fetch(self.state.log_term)[:, slots]
                    lasts = self._fetch(self.state.last_index)
                    for col, i in enumerate(above):
                        buf_t = self._uncommitted[i][1]
                        held = (
                            (lasts >= i) & (terms_all[:, col] == buf_t)
                        ).any()
                        if not held:
                            del self._uncommitted[i]
            self.roles[r] = LEADER
            self.leader_id = r
            self.leader_term = cand_term
            self.lead_terms[r] = cand_term
            self._quorum_contact_at[r] = self.clock.now  # CheckQuorum lease
            self._steady = False   # matches reset per term; repair re-verifies
            # §5.4.2 floor for the steady program: everything this leader
            # appends from here on carries cand_term
            self._term_floor = int(self._pre_lasts()[r]) + 1
            # demote stale leaders this election could REACH (across a
            # partition a deposed-in-name leader keeps ticking)
            for p in range(self.cfg.rows):
                if p != r and self.roles[p] == LEADER and self.connectivity[r, p]:
                    self.roles[p] = FOLLOWER
                    self._arm_follower(p)
            self.nodelog(r, "state changed to leader")
            self._push(self.clock.now, f"l:{self._timer_gen[r]}", r)
        else:
            self._arm_candidate(r)

    def _fire_leader_tick(self, r: int) -> None:
        """One leader tick (main.go:332-395): batch ingest + replicate +
        commit, then re-arm. Also the followers' heartbeat: every heard
        replica's election timer resets. Any replica in the leader role
        ticks in its own term; only the routed leader (``leader_id``)
        drains the client queue and runs heal bookkeeping."""
        if not self.alive[r] or self.roles[r] != LEADER:
            return
        term = int(self.lead_terms[r])
        if int(self.terms[r]) > term:
            # heard a higher term since winning: step down instead
            self._step_down_leader(r, int(self.terms[r]))
            return
        cfg = self.cfg
        self._tick_count += 1
        if cfg.check_quorum:
            # §9.6 CheckQuorum: a leader cut off from a voter majority for
            # a full minimum election timeout demotes itself
            if int(self._voter_reach(r).sum()) > int(self.member.sum()) // 2:
                self._quorum_contact_at[r] = self.clock.now
            elif (self.clock.now
                    - self._quorum_contact_at.setdefault(r, self.clock.now)
                    >= cfg.follower_timeout[0]):
                self.roles[r] = FOLLOWER
                if self.leader_id == r:
                    self.leader_id = None
                self.nodelog(
                    r, "step down to follower (lost quorum contact)"
                )
                self._arm_follower(r)
                return
        B = cfg.batch_size
        routed = self.leader_id == r
        eff = self._reach(r)
        if routed and self.admission is not None:
            # the delay controller's head-of-queue sojourn (0 on an empty
            # queue, which is what exits the shedding state)
            head_delay = 0.0
            if self._queue:
                head_delay = self.clock.now - self.submit_time.get(
                    self._queue[0][0], self.clock.now
                )
            transition = self.admission.observe_delay(head_delay)
            if transition == "shed_start":
                self.nodelog(
                    r, f"admission shedding ON (head delay "
                    f"{head_delay:.1f}s >= target "
                    f"{self.admission.target_delay_s:g}s for a full "
                    f"interval)"
                )
            elif transition == "shed_stop":
                self.nodelog(r, "admission shedding OFF (delay back "
                                "under target)")
        if routed:
            # before the batch is taken: it may prepend re-queued entries
            self._make_room_for_current_term(r, term)
        take = min(len(self._queue), B) if routed else 0
        if take == 0:
            if self._hb_payload is None:
                self._hb_payload = torch.zeros(
                    (B, cfg.rows * cfg.shard_words), dtype=torch.int32,
                    device=self._dev,
                )
            payload = self._hb_payload
        else:
            # pack only the real entries; fold_batch pads to B
            payload = fold_batch(
                self._pack_entries(self._queue[:take], take),
                cfg.rows, B, device=self._dev,
            )
        pre_lasts = self._pre_lasts()
        floor, fpt = self._floor_attest(r)
        repair = self._repair_program()
        with _profiling.launch_annotation("leader_tick", self._tick_count):
            self.state, info = self.t.replicate(
                self.state, payload, take, r, term, self._dev_arr(eff),
                self._dev_arr(self.slow), repair=repair,
                member=self._member_arg(),
                repair_floor=floor, floor_prev_term=fpt,
                term_floor=self._term_floor,
            )
        self._note_truncations(pre_lasts)
        max_term = int(info.max_term)
        if max_term > term:
            # nothing was consumed from the queue: the device step refused
            # ingest/commit for the stale term
            self._step_down_leader(r, max_term)
            return
        # heard replicas adopted the leader's term on device
        self.terms[eff] = np.maximum(self.terms[eff], term)
        # ring backpressure: the step ingests at most `room` entries;
        # anything it left behind stays queued for a later tick
        ingested = int(info.frontier_len)
        if ingested:
            last = int(self._fetch(self.state.last_index)[r])  # post-ingest
            base = last - ingested
            chunk = self._queue[:ingested]
            self._seq_at_index.update(
                zip(range(base + 1, last + 1), (s for s, _ in chunk))
            )
            self._uncommitted.update(
                (base + 1 + i, (p, term)) for i, (_, p) in enumerate(chunk)
            )
            self._queue = self._queue[ingested:]
        self._advance_commit(r, int(info.commit_index))
        if routed:
            # heal bookkeeping and the shared steady flag belong to the
            # routed leader only
            self._snapshot_heal(r, info)
            self._update_steady(r, info.match, eff)
        self._reset_heard_timers(r)
        self._push(self.clock.now + cfg.heartbeat_period, "l:x", r)

    def _truncate_uncommitted_tail(self, cut: int, lasts) -> int:
        """Drop every row's uncommitted entries above ``cut`` (re-queuing
        the bytes the host still holds so they commit at fresh indices),
        bump ring-validity floors for every truncated row, clamp device
        last/match everywhere, and invalidate the lasts cache. ``lasts``
        is the pre-truncation last_index vector. Returns the number of
        re-queued entries. Callers guarantee cut >= commit_watermark."""
        assert cut >= self.commit_watermark
        cap = self.state.capacity
        old_max = int(np.max(np.asarray(lasts)))
        requeue = []
        for i in range(cut + 1, old_max + 1):
            ent = self._uncommitted.pop(i, None)
            seq = self._seq_at_index.pop(i, None)
            if ent is not None and seq is not None:
                requeue.append((seq, ent[0]))
        self._queue = requeue + self._queue
        for q in range(self.cfg.rows):
            if int(lasts[q]) > cut:
                self._ring_floor[q] = max(
                    self._ring_floor[q], int(lasts[q]) - cap + 1
                )
        cut_t = torch.tensor(cut, dtype=self.state.last_index.dtype,
                             device=self.state.device)
        self.state = self.state.replace(
            last_index=torch.minimum(self.state.last_index, cut_t),
            match_index=torch.minimum(self.state.match_index, cut_t),
        )
        self._lasts_snapshot = None
        self._steady = False
        # re-appends land at cut+1 under the current term
        self._term_floor = min(self._term_floor, cut + 1)
        return len(requeue)

    def _make_room_for_current_term(self, r: int, term: int) -> None:
        """Escape the bounded-log §5.4.2 deadlock: when the ring is FULL
        of uncommitted OLD-term entries, nothing can commit or append.
        The leader truncates one batch of its never-acked tail
        cluster-wide and re-queues the bytes it still holds."""
        cap = self.state.capacity
        lasts = self._pre_lasts()
        last = int(lasts[r])
        if last - self.commit_watermark < cap:
            return                        # room exists: no deadlock
        tail_term = int(
            self._fetch(self.state.log_term)[r, (last - 1) % cap]
        )
        if tail_term >= term:
            return                        # current-term tail commits normally
        drop = min(self.cfg.batch_size, last - self.commit_watermark)
        cut = last - drop
        n = self._truncate_uncommitted_tail(cut, lasts)
        self.nodelog(
            r, f"old-term tail ({cut}, {last}] truncated to unwedge "
            f"the full ring; {n} entries re-queued"
        )

    def _repair_program(self) -> bool:
        """Which step program the next replicate runs: the repair-capable
        one unless the cluster is verified steady AND the config opts into
        the steady-dispatch fast path (cfg.steady_dispatch)."""
        if self.cfg.steady_dispatch == "off":
            return True
        return not self._steady

    def _effective_match(self, term: int, match) -> np.ndarray:
        """Host view of the step's verified match vector. The JAX engine
        fills learner rows in from device state here; without learners
        (ROADMAP A9c) it is the step's vector as is."""
        return self._fetch(match)

    def _update_steady(self, r: int, match, eff=None) -> None:
        """After a replicate step: every live non-slow reachable follower
        verified up to the leader's tail -> the next step may run the
        steady program. ``match`` stays a device value until read, so the
        "off" mode skips the host sync."""
        if self.cfg.steady_dispatch == "off":
            return  # _repair_program never reads _steady
        match = self._effective_match(int(self.lead_terms[r]), match)
        others = (self.alive if eff is None else eff) & ~self.slow
        others[r] = False
        leader_last = int(self._fetch(self.state.last_index)[r])
        self._steady = bool((match[others] >= leader_last).all())

    def _advance_commit(self, r: int, commit: int) -> None:
        """Host bookkeeping for a device-reported commit advance: stamp
        durable seqs, archive, prune buffers, feed the apply stream."""
        if commit <= self.commit_watermark:
            return
        old_wm = self.commit_watermark
        now = self.clock.now
        sq_get = self._seq_at_index.get
        ct = self.commit_time
        for idx in range(self.commit_watermark + 1, commit + 1):
            seq = sq_get(idx)
            if seq is not None and seq not in ct:
                ct[seq] = now
                self.committed_total += 1
        self._archive_committed(r, self.commit_watermark + 1, commit)
        self.commit_watermark = commit
        self.nodelog(r, f"commit index changed to {commit}")
        for idx in range(old_wm + 1, commit + 1):
            self._uncommitted.pop(idx, None)
            self._seq_at_index.pop(idx, None)
        self._evict_commit_stamps()
        self._drain_apply()

    def _reset_heard_timers(self, r: int) -> None:
        """Replication traffic is the heartbeat: every heard follower's
        election timer resets (main.go:124-127) and a candidate hearing a
        current leader steps down (main.go:204-217)."""
        self._last_heard[r] = self.clock.now
        #   the source hears itself: a live leader must refuse pre-votes
        #   against its own leadership (§9.6 stickiness)
        for p in range(self.cfg.rows):
            if p == r or not self.alive[p] or not self.connectivity[r, p]\
                    or not self.member[p]:
                continue   # unreachable replicas hear nothing
            self._last_heard[p] = self.clock.now   # §9.6 stickiness clock
            if self.roles[p] == FOLLOWER:
                self._arm_follower(p)
            elif self.roles[p] == CANDIDATE:
                self.roles[p] = FOLLOWER
                self._arm_follower(p)
            elif self.roles[p] == LEADER and self.lead_terms[r] > self.lead_terms[p]:
                # a stale leader hearing a newer leader's traffic steps
                # down (main.go:309-321); its device row already adopted
                self.roles[p] = FOLLOWER
                self.nodelog(p, "step down to follower")
                self._arm_follower(p)

    def _archive_committed(self, leader: int, lo: int, hi: int) -> None:
        """Move the just-committed range [lo, hi] into the archive. The
        primary source is the host ingest buffer, trusted only where its
        ingest term matches the committing leader's log at that index;
        the rest is read back from the leader's ring (inside it by
        construction), unless the ring never held the range."""
        slots_all = (np.arange(lo, hi + 1) - 1) % self.state.capacity
        lead_terms = self._fetch(self.state.log_term)[leader, slots_all]
        missing = []
        for i, idx in enumerate(range(lo, hi + 1)):
            ent = self._uncommitted.get(idx)
            if ent is not None and ent[1] == int(lead_terms[i]):
                self.store.put(idx, ent[0], ent[1])
            else:
                missing.append(idx)
        if not missing:
            return
        mlo, mhi = min(missing), max(missing)
        if int(self._ring_floor[leader]) > mlo:
            return  # ring never held the range; archive stays short
        terms = lead_terms[mlo - lo:mhi - lo + 1]
        data = log_entries(self.state, leader, mlo, mhi)
        for idx in missing:
            self.store.put(idx, data[idx - mlo].tobytes(),
                           int(terms[idx - mlo]))

    def _stream_snapshot(self, replica: int, lo: int,
                         hi: int) -> Optional[int]:
        raise _not_ported(
            f"streaming a snapshot of [{lo}, {hi}] to ring-lapped replica "
            f"{replica}", "A9b")

    def _snapshot_heal(self, leader: int, info) -> None:
        """Detect ring-lapped replicas (plain replication): the repair
        window cannot heal a replica whose next needed index is below the
        leader's ring horizon. After two stalled ticks (one
        leadership-change transient is forgiven) the JAX engine streams a
        snapshot (``_stream_snapshot``, ROADMAP A9b)."""
        cap = self.state.capacity
        match = self._effective_match(int(self.lead_terms[leader]), info.match)
        leader_last = int(self._fetch(self.state.last_index)[leader])
        horizon = max(leader_last - cap + 1, int(self._ring_floor[leader]))
        for p in range(self.cfg.rows):
            if (p == leader or not self.alive[p] or self.slow[p]
                    or not self.member[p]
                    or not self.connectivity[leader, p]):
                # a dead replica KEEPS its stream (resume-on-recover)
                self._match_stall[p] = 0
                continue
            if int(match[p]) + 1 >= horizon:
                self._match_stall[p] = 0
                self._shipper.finish(p)
                continue
            self._match_stall[p] += 1
            if self._match_stall[p] < 2:
                continue
            self._stream_snapshot(
                p, int(match[p]) + 1, self.commit_watermark
            )

    def register_apply(
        self, fn: Callable[[int, bytes], None], replay: bool = False
    ) -> int:
        """Register a state-machine apply callback: ``fn(index, payload)``
        is invoked for every committed entry, in log order, exactly once
        per engine lifetime. ``replay=True`` first replays the archived
        committed tail (from the oldest contiguously archived index up to
        the watermark). Returns the first index the callback will have
        seen (1 = full history)."""
        end = self.commit_watermark if not self._apply_fns else self.applied_index
        if replay and end == 0 and self.commit_watermark > 0:
            # a later registrant while the shared cursor is paused at 0:
            # anchor the replay at the watermark
            end = self.commit_watermark
        if replay and end > 0:
            lo = self.store.covered_lo(end)
            # a gap below the covered range may be transient: extend
            # coverage downward before declaring history lost
            while lo > 1 and self._backfill_archive(lo - 1, quiet=True):
                lo = self.store.covered_lo(end)
            if lo > end:
                raise ValueError(
                    f"cannot replay: committed entry {end} is not archived"
                )
            if lo > 1:
                self.nodelog(
                    0, f"apply replay is partial: history starts at {lo} "
                    "(older entries compacted or unrecoverable)"
                )
            for idx in range(lo, end + 1):
                fn(idx, self.store.get(idx)[0])
            start = end + 1
        else:
            # without replay the callback sees only entries committed
            # after registration
            start = self.commit_watermark + 1
            lo = start
        if not self._apply_fns:
            self.applied_index = max(self.applied_index, self.commit_watermark)
        self._apply_fns.append((fn, start))
        return lo

    def _drain_apply(self) -> None:
        """Feed newly committed entries to the apply callbacks, in order.
        Bytes come from the archive; a gap pauses the cursor, and each
        drain retries it (``_backfill_archive``)."""
        if not self._apply_fns:
            return
        while self.applied_index < self.commit_watermark:
            nxt = self.applied_index + 1
            ent = self.store.get(nxt)
            if ent is None:
                if not self._backfill_archive(nxt):
                    break
                ent = self.store.get(nxt)  # backfill True => present
            # advance first, then deliver to every eligible callback even
            # if one raises (collect + re-raise)
            self.applied_index += 1
            err: Optional[BaseException] = None
            for fn, fn_start in self._apply_fns:
                if self.applied_index >= fn_start:
                    try:
                        fn(self.applied_index, ent[0])
                    except Exception as ex:
                        err = err if err is not None else ex
            if err is not None:
                raise err

    def _backfill_archive(self, idx: int, quiet: bool = False) -> bool:
        """Try to fill an archive gap at committed index ``idx`` from the
        current leader's ring. False if still unavailable; a gap below the
        ring horizon gets one loud nodelog (unless ``quiet``)."""
        r = self.leader_id
        if r is None:
            return False
        lasts = self._fetch(self.state.last_index)
        recoverable = idx >= max(
            int(lasts[r]) - self.state.capacity + 1,
            int(self._ring_floor[r]),
        )
        if not recoverable:
            if not quiet and idx not in self._lost_gaps:
                self._lost_gaps.add(idx)
                self.nodelog(
                    r, f"apply stream gap at {idx} is outside every "
                    "serving ring range and was never archived: "
                    "unrecoverable; apply is wedged at this index"
                )
            return False
        hi = idx
        while hi + 1 <= self.commit_watermark and self.store.get(hi + 1) is None:
            hi += 1
        self._archive_committed(r, idx, hi)
        return self.store.get(idx) is not None

    def committed_entries(self, lo: int, hi: int) -> np.ndarray:
        """Read committed entries [lo, hi] (1-based, inclusive) as
        u8[hi-lo+1, entry_bytes] from a live replica's ring. Indices must
        be committed and still within the ring horizon."""
        if not (1 <= lo <= hi <= self.commit_watermark):
            raise ValueError(
                f"range [{lo}, {hi}] not committed "
                f"(watermark {self.commit_watermark})"
            )
        commits = self._fetch(self.state.commit_index)
        lasts = self._fetch(self.state.last_index)
        holders = [
            r for r in range(self.cfg.rows)
            if self.alive[r]
            and int(commits[r]) >= hi
            and int(lasts[r]) - self.state.capacity + 1 <= lo
            and int(self._ring_floor[r]) <= lo
        ]
        if not holders:
            raise ValueError(
                f"no live replica both committed {hi} and still retains "
                f"index {lo} in its ring; read the checkpoint store for "
                "compacted history"
            )
        return log_entries(self.state, holders[0], lo, hi)

    # -------------------------------------------- persistence (ROADMAP A9b)
    def save_checkpoint(self, path: str) -> None:
        raise _not_ported("save_checkpoint", "A9b")

    @classmethod
    def restore(cls, cfg: RaftConfig, path: str, transport=None, trace=None,
                vote_log=None, recorder=None) -> "RaftEngine":
        raise _not_ported("RaftEngine.restore", "A9b")

    def commit_latencies(self) -> np.ndarray:
        """Per-entry commit latency (seconds) for every durable entry."""
        return np.array(
            [self.commit_time[s] - self.submit_time[s] for s in self.commit_time]
        )
