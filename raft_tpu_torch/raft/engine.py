"""The cluster engine: timers and roles on the host, protocol steps on the
device (port of ``raft_tpu/raft/engine.py``, ROADMAP A9a-A9e).

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
  (``register_apply``);
- a replica the ring has lapped is streamed a snapshot of the archive in
  admission-budgeted chunks (``_stream_snapshot``);
- ``save_checkpoint`` / ``restore`` carry the durable state (the archived
  committed tail, terms, votedFor, the configuration) through one
  ``.npz`` file, and ``vote_log=`` makes every (term, votedFor)
  transition durable before the engine acts on it (``ckpt.votelog``);
- with ``max_replicas`` headroom the configuration changes one server at
  a time through log entries that activate when appended (``add_learner``,
  ``promote``, ``add_server``, ``add_voter``, ``remove_server``,
  ``replace``, ``wipe``): every device step counts its quorum over the
  voter plane, handed to the kernels as a bool mask, or packed with the
  learners (``core.state.pack_membership``) while a learner is attached;
- linearizable reads confirm leadership with a quorum round
  (``read_linearizable``: one empty round, K2 at count 0 or K1 while
  repairing), ride the write rounds in batches (``submit_read`` /
  ``read_confirmed``), or, with ``read_lease``, serve from a leader lease
  with no round at all (``raft.lease``).

With ``rs_k`` set the cluster is erasure-coded (BASELINE config 3): each
replica stores one RS(n, k) shard of every entry. The leader encodes each
batch into the folded shard layout with kernel K7 (``encode_fold_device``);
reads, archive backfills and the heal of a replica that missed windows
reconstruct from k shard rows (kernel K6 decoding the ring in place);
heals, suffix re-serves and snapshot installs re-encode on the device
(kernel K6 encode). The JAX engine encodes those with its C++ host codec;
the bytes are the same.

With the same ``RaftConfig`` and seed and the same sequence of calls, the
engine gives byte-identical results to the JAX engine: nodelog lines, the
rng and the event heap, commit stamps, terms and roles, the membership
masks, read indices, committed bytes and the apply stream. The device
state is a ``ReplicaState`` of torch tensors on the transport's device;
the host mirrors are numpy, as there. ``RaftEngine(cfg)`` builds
``make_transport(cfg)``, which runs on CUDA; pass a transport built with
``device="cpu"`` to run the plain versions.

With ``fuse_k > 1`` (or ``RAFT_TPU_FUSE_K``), ``run_for`` drives runs of
steady leader ticks K at a time (``raft.steady``): one launch of K ticks
(on the card, one replay of a captured CUDA graph) and one host pass that
books them exactly as K ticks would. ``hostprof`` takes an
``obs.hostprof.HostProfiler`` that splits each event's host time into
phases.

The host observability plane attaches as in the JAX engine:
``recorder=`` (an ``obs.events.FlightRecorder``) and the ``spans``,
``metrics``, ``auditor``, ``slo`` and ``status_board`` attributes
(``obs.forensics.ObsStack.attach`` sets them together). Every hook is
host code reading host mirrors: with no recorder and no trace attached
the engine makes exactly the device fetches it makes with nothing
attached, and the artifacts equal the JAX engine's.

With ``tiered_log_dir`` (or ``RAFT_TPU_TIERED_DIR``) the archive is a
``ckpt.TieredStore``: the hot tail in RAM, older committed entries sealed
into RS-coded segment files (the C++ host codec) under a fresh
``tier_`` subdirectory per engine, read back through the same calls, so
``register_apply(replay=True)`` reaches the whole history.
``attach_device_obs`` attaches the device plane (``obs.device``): the
ticks, vote rounds and fused windows record into an event ring on the
device and each launch boundary flushes it with one fetch; pipelined
chunks record at chunk granularity.

Over the mesh (``transport.MeshTransport``, or ``"multihost"``:
``transport.multihost``) the engine runs as R lock-step mirrors, one a
rank, each rank holding its own replica row: every rank runs this same
event loop with the same config and seed, so it takes the same decisions
and makes the same collectives. A host read of the row-sharded state goes
through the transport's gathering fetch (``_rows``: ``fetch_rows`` /
``fetch_row``, a collective on the mesh; a host copy on the resident
layout), a host write through its placement (``place_rows``,
``local_row``: a rank writes only its own row), and the EC reads decode
from the gathered donor windows. On the 2-D mesh (``payload_shards`` P >
1) each row is held by P ranks, one lane slice each: the engine is the
same, and the transport's seam stitches payload reads to full width and
cuts payload writes to the rank's slice (``lane_slice``, through
``install_entries``). Every rank must attach the same
observers (a trace, a recorder, the device plane), because ``nodelog``
and the flushes fetch only while one is attached. With
``mirror_check_every`` the decisions fold into a rolling digest that the
ranks exchange every that many decisions (``_verify_mirror_digest``): a
divergence, or an exchange that does not complete within
``mirror_exchange_timeout_s``, raises ``MirrorDesyncError`` on every
rank. In a one-process world the exchange is a no-op, as in the JAX
engine.
"""

from __future__ import annotations

import heapq
import os
import random
from itertools import islice
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.admission import AdmissionGate, Overloaded
from raft_tpu_torch.ckpt import (
    CheckpointStore,
    EngineCheckpoint,
    Snapshot,
    SnapshotShipper,
    TieredStore,
    VoteLog,
    install_snapshot,
    install_snapshot_all,
    merge_restored,
)
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.state import (
    NO_VOTE,
    ReplicaState,
    fold_batch,
    last_log_term,
    log_entries,
    pack_membership,
)
from raft_tpu_torch.core.step_cuda import pick_br, shape_ok
from raft_tpu_torch.ec.kernels import encode_device, encode_fold_device
from raft_tpu_torch.ec.reconstruct import (
    heal_replica,
    install_entries,
    reconstruct,
)
from raft_tpu_torch.ec.rs import RSCode
from raft_tpu_torch.obs import blackbox
from raft_tpu_torch.obs import profiling as _profiling
from raft_tpu_torch.raft.lease import LeaseTable
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
    # not a RuntimeError: ReplicatedKV.linearizable_get's other failure
    # mode (the apply stream paused behind an archive gap) raises
    # RuntimeError, and the two call for different recovery actions
    """``read_linearizable`` could not confirm leadership: the caller is
    not leader, was deposed during the confirmation round, or cannot
    reach a quorum of the configuration (a minority-side leader during a
    partition). The read must be retried against the real leader."""


class TicketEvicted(LinearizableReadRefused):
    """A ``submit_read`` ticket was FIFO-evicted at the outstanding-ticket
    cap (``READ_TICKET_CAP``), or idle past the admission TTL, before it
    was polled; a consumed ticket polled after the eviction floor passed
    it reads the same. The recovery is to re-issue the read."""


class LearnerLagging(RuntimeError):
    """``promote`` refused: the learner's current-term verified match is
    more than ``cfg.promote_max_lag`` entries behind the leader's last
    index (or the learner is down). The staged promotion of
    ``add_server`` / ``replace`` retries every leader tick."""


class MirrorDesyncError(Exception):
    """The mirrored multihost control planes' decision streams diverged."""


class VirtualClock:
    """Deterministic time source; the engine advances it to each event."""

    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


class RaftEngine:
    """One process hosting all replica control planes (the JAX engine's;
    see the module docstring for what is not ported yet).

    Fault masks (``alive``/``slow``) are first-class: a "dead" replica's
    timers do not fire and the device step ignores it; ``connectivity``
    expresses link-level partitions (``partition``/``heal_partition``)
    and ``member``/``learner`` the current configuration.

    ``READ_TICKET_CAP``: outstanding ``submit_read`` tickets kept before
    FIFO eviction (a class attribute, so tests reach the eviction path
    at a test-sized volume).
    """

    READ_TICKET_CAP = 1 << 16
    READ_TICKET_TTL_FACTOR = 3.0
    #   With admission configured, a ticket idle this many max election
    #   timeouts is abandoned and evicted at the gate (submit_read): the
    #   age analogue of the FIFO cap, which a smaller bound never reaches.

    def __init__(
        self,
        cfg: RaftConfig,
        transport: Optional[Transport] = None,
        trace: Optional[Callable[[str], None]] = None,
        vote_log: Optional[str] = None,
        recorder=None,
    ):
        self.cfg = cfg
        self.t: Transport = (transport if transport is not None
                             else make_transport(cfg))
        self._dev = getattr(self.t, "device", None)
        self.state: ReplicaState = self.t.init()
        self.rng = random.Random(cfg.seed)
        self.clock = VirtualClock()
        self._trace = trace
        self.recorder = recorder
        #   obs.events.FlightRecorder (None = off): every nodelog call
        #   site records a typed Event whose ``.nodelog()`` rendering is
        #   the legacy trace line, plus the transitions that have no line
        #   (_record_event). With neither a recorder nor a trace attached,
        #   nodelog skips its device fetch.
        self.spans = None
        #   obs.spans.SpanTracker (None = off): submit/submit_read bind the
        #   ambient span to their seq or ticket; ingest, commit and apply
        #   annotate it.
        self.metrics = None
        #   obs.registry.MetricsRegistry (None = off): protocol counters,
        #   gauges and the commit-latency histogram, labeled group="0".
        self.auditor = None
        #   obs.audit.SafetyAuditor (None = off): election wins, commit
        #   advances, archive feeds and tick boundaries checked against
        #   Raft's invariants during the run, from host mirrors only.
        self.slo = None
        #   obs.slo.SloTracker (None = off): commit, read and queue-delay
        #   latency digests with burn-rate evaluation on the virtual clock.
        self.status_board = None
        #   obs.serve.StatusBoard (None = off): a host-only snapshot
        #   published at each event-loop flush boundary, which the ops
        #   server reads from its own thread.
        #   None of these five fetches anything from the device.
        self.device_obs = None
        #   obs.device.DeviceObs (None = off): attach_device_obs allocates
        #   an EventRing on the transport's device that the replicate and
        #   vote launches record into (the steps' record=True mode), and
        #   every launch boundary flushes ONE packed fetch of the ring and
        #   its counters into this host plane. Detached, the engine runs
        #   exactly the unrecorded launches and fetches.
        self._dev_ring = None
        self._dev_flushed = 0
        self._dev_counters_folded = None
        self._floor_event_hwm: Dict[int, int] = {}
        #   per row: the highest repair floor a repair_floor_raise event
        #   has reported (the recorder-only event fires on a raise)
        self._tick_count = 0
        #   Leader ticks fired so far (the launch annotation's step and
        #   the span tracker's replication-round clock)
        self._mirror_digest = 0
        self._mirror_decisions = 0
        #   the rolling digest of the decision stream and its length
        #   (mirror_check_every)
        self.mirror_exchanges = 0
        self.mirror_exchange_s = 0.0
        #   completed digest exchanges and their host seconds
        self.hostprof = None
        #   obs.hostprof.HostProfiler (None = off): phase timers tiling
        #   step_event (heap_pop, host_pre, pack, dispatch, device_wait,
        #   host_post). Detached it costs one None check per site and no
        #   device sync: the profiler's synchronize is reached only
        #   through HostProfiler.sync.

        n = cfg.rows
        self.member = np.zeros(n, bool)
        self.member[: cfg.n_replicas] = True
        #   The current configuration's voters (single-server changes):
        #   rows beyond n_replicas idle masked out until a change adds
        #   them. Quorums are counted over voters; the device step gets
        #   the mask for its denominator (_member_arg).
        self.learner = np.zeros(n, bool)
        #   Non-voting learners (§4.2.1): they hear replication, repair and
        #   snapshot installs (the replication reach) but never vote,
        #   count toward a commit or CheckQuorum, or campaign.
        self._wiped = np.zeros(n, bool)
        #   Rows whose durable state ``wipe`` destroyed while a voter:
        #   ``recover`` refuses them until a removal of the row commits.
        self._staged_config: List[Tuple[str, int]] = []
        #   Deferred single-server steps ("add_learner" / "promote", row)
        #   of add_server and replace; the routed leader tick drives the
        #   head whenever no change is in flight.
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
        self._reads: Dict[int, list] = {}
        self._next_read_ticket = 0
        #   Batched ReadIndex queue: ticket -> [row, noted index, bound
        #   term, status, mint time, class].
        self._read_buckets: Dict[Tuple[int, int], set] = {}
        #   (row, bound term) -> pending tickets: a confirming round pops
        #   exactly its own bucket.
        self._read_evict_floor = 0
        #   Every ticket below this was consumed or evicted; polling one
        #   raises TicketEvicted.
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
        self._code = RSCode(cfg.rows, cfg.rs_k) if cfg.ec_enabled else None
        #   The RS(n, k) code of an erasure-coded cluster: shard i lives on
        #   row i (None without EC).
        self._uncommitted: Dict[int, Tuple[bytes, int]] = {}
        #   log index -> (full payload, ingest term): entries move from
        #   here into the archive when they commit; under EC recovered
        #   replicas are also re-served the uncommitted suffix from here
        #   (fewer than commit_quorum rows hold its shards). Bounded by
        #   ring backpressure: leader_last - commit <= log_capacity.
        tiered_root = (
            os.environ.get("RAFT_TPU_TIERED_DIR", "") or cfg.tiered_log_dir
        )
        if tiered_root:
            # Tiered archive (ckpt.tiered): hot tail in RAM, sealed
            # RS-coded segments on disk, so coverage reaches the whole
            # history at bounded RAM. Each engine seals under its own
            # fresh subdirectory (a restore rebuilds its archive from the
            # checkpoint, not from an earlier engine's segment files).
            # The environment override flips the tier without a config
            # edit; results are byte-identical either way.
            import tempfile

            os.makedirs(tiered_root, exist_ok=True)
            hot = cfg.tiered_hot_entries or 2 * cfg.log_capacity
            self.store: CheckpointStore = TieredStore(
                cfg.entry_bytes,
                root=tempfile.mkdtemp(prefix="tier_", dir=tiered_root),
                hot_entries=hot,
                segment_entries=min(hot, (
                    cfg.segment_entries
                    or max(1, cfg.log_capacity // 2)
                )),
                rs_k=cfg.segment_rs_k,
                rs_m=cfg.segment_rs_m,
                on_seal=self._note_seal,
                checkpoint_span=2 * cfg.log_capacity,
            )
        else:
            self.store = CheckpointStore(
                cfg.entry_bytes, max_entries=2 * cfg.log_capacity
            )
        #   Host archive of the committed log (term + bytes per entry);
        #   the plain store compacts beyond 2x the ring capacity, the
        #   tiered store seals that horizon to disk instead.
        self._tiered_store = self.store if tiered_root else None
        #   non-None when the archive is tiered: the apply-cursor seal
        #   ceiling and the /status tier section key off it
        self._shipper = SnapshotShipper(
            cfg.catchup_chunk_entries or cfg.batch_size
        )
        #   Incremental snapshot shipping (ckpt.ship): lapped replicas
        #   catch up in admission-budgeted chunks per leader tick
        #   (_stream_snapshot).
        self._lasts_snapshot = None   # see _pre_lasts
        self._match_snapshot = None
        #   cached host (match_index, match_term) for _effective_match,
        #   dropped whenever a step or a host-side install moves them
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
        self.fuse_k = max(
            1, int(os.environ.get("RAFT_TPU_FUSE_K", "") or cfg.fuse_k)
        )
        #   K-tick steady-state fusion (raft.steady): above 1, run_for
        #   drives runs of steady leader ticks as single launches; the
        #   environment override points a run at the fused path without
        #   touching its config. Results are byte-identical either way.
        self.fused_launches = 0
        self.fused_ticks = 0
        self._fused_driver = None
        if self.fuse_k > 1:
            from raft_tpu_torch.raft.steady import FusedDriver

            self._fused_driver = FusedDriver(self)
        self.lease = None
        if cfg.read_lease:
            # leader leases (raft.lease): every quorum round grants, and a
            # valid lease serves linearizable reads with no round; volatile
            # by design (a restored engine starts with no grants)
            self.lease = LeaseTable(
                cfg.follower_timeout[0], cfg.clock_drift_bound
            )
        self._row_commit = np.zeros(n, np.int64)
        #   The commit index each row's OWN rounds last reported: lease
        #   reads serve at it (a partitioned stale leader's view freezes).
        self._lease_ok_term = np.full(n, -1, np.int64)
        #   §6.4's gate: a lease serves only once a watermark advance rode
        #   one of r's own rounds in its current lead term.
        self.read_class_counts: Dict[str, int] = {}
        #   served reads by class (lease / read_index)
        self.admission = AdmissionGate.from_config(cfg, self.clock)
        #   Bounded admission (None = unbounded): submit and submit_read
        #   arrivals pass the gate before anything is queued, and the
        #   leader tick feeds it the head-of-queue sojourn.
        self._config_seqs: Dict[int, Tuple[tuple, tuple]] = {}
        #   seq -> ((old member, old learner), (new member, new learner))
        #   of a configuration entry not yet ingested
        self._pending_config: Optional[Tuple[int, tuple, tuple, int]] = None
        #   (log index, old masks, new masks, ingest term) of the one
        #   uncommitted change
        self._fault_events: list = []              # FaultPlan merge targets
        self._next_seq = 1
        self._q: List[Tuple[float, int, str, int]] = []  # (t, tiebreak, kind, replica)
        self._seq_events = 0
        self._timer_gen = [0] * n
        self._votelog = None
        self._persisted_terms = np.zeros(n, np.int64)
        self._persisted_vf = np.full(n, NO_VOTE, np.int64)
        if vote_log is not None:
            # transition-time durability (ckpt.votelog): replay any
            # existing records into the fresh state, so a restarted
            # process cannot vote twice in a term it voted in, then keep
            # appending at every (term, votedFor) transition
            terms = self.terms.copy()
            vf0 = self._rows(self.state.voted_for)
            terms, vf = merge_restored(n, terms, vf0.astype(np.int64),
                                       vote_log)
            if (terms != self.terms).any() or (vf != vf0).any():
                self._set_votes(terms, vf)
                for r in range(n):
                    self.nodelog(r, "vote log replayed")
            self._attach_votelog(vote_log)
        for r in range(n):
            if self.member[r]:
                self._arm_follower(r)

    # ------------------------------------------------------------------ util
    def _fetch(self, x) -> np.ndarray:
        """Host copy of a device value that every rank holds whole (an
        info, the event ring; never a view of a CPU tensor the steps may
        later update in place): the transport's ``fetch`` (JAX :173)."""
        return self.t.fetch(x)

    def _rows(self, x, dim: int = 0) -> np.ndarray:
        """Host view of every replica row of a row-sharded value (a state
        leaf, or a value computed row by row from one) with the row axis
        at ``dim``: ``_fetch`` on the resident layout; on the mesh one
        gathering fetch, a collective every rank makes in lock step (JAX:
        ``_fetch`` over a multi-process transport, ``tpu_mesh.py:228``)."""
        if self.t.resident:
            return self._fetch(x)
        return self.t.fetch_rows(x, dim)

    def _log_terms(self, idx, row: Optional[int] = None) -> np.ndarray:
        """Host view of the term ring at 1-based log indices ``idx``: every
        row's (``[R, n]``), or replica ``row``'s (``[n]``). On the resident
        layout one fetch of the whole ring, as the JAX engine reads it; on
        the mesh only the selected slots, gathered from every rank or
        broadcast from the one holding ``row``."""
        slots = (np.asarray(idx, np.int64) - 1) % self.state.capacity
        if self.t.resident:
            terms = self._fetch(self.state.log_term)
            return terms[:, slots] if row is None else terms[row, slots]
        sel = self.state.log_term.index_select(
            1, torch.from_numpy(slots).to(self.state.device))
        if row is None:
            return self.t.fetch_rows(sel)
        return self.t.fetch_row(sel, row, 0)

    def _dev_arr(self, x) -> torch.Tensor:
        """A host mask or count vector as a tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self._dev)

    def _dev_bytes(self, data: np.ndarray) -> torch.Tensor:
        """Host entry bytes u8[N, S] as a tensor on the device (the packed
        batches may be read-only views of the payload bytes)."""
        return torch.from_numpy(
            np.require(data, requirements=["C", "W"])).to(self._dev)

    def _nodelog_at(self, r: int, msg: str, commit: int, last: int,
                    kind: Optional[str] = None, **fields) -> str:
        """``nodelog`` with caller-supplied commit/last values (the fused
        booking's emission path: no device fetch mid-booking). ``commit``
        and ``last`` are Python ints; the line and the recorded event
        are :meth:`nodelog`'s."""
        rec = self.recorder
        if rec is None and self._trace is None:
            return ""
        line = (
            f"[Server{r}:{self.terms[r]}:{commit}:{last}]"
            f"[{self.roles[r]}]{msg}"
        )
        if rec is not None:
            rec.record(
                node=f"Server{r}", term=int(self.terms[r]), kind=kind,
                t_virtual=self.clock.now, state=self.roles[r],
                commit_index=commit, last_index=last, msg=msg, **fields,
            )
        if self._trace is not None:   # not truthiness: empty sinks are falsy
            self._trace(line)
        return line

    def nodelog(self, r: int, msg: str, kind: Optional[str] = None,
                **fields) -> str:
        """The reference's trace schema (main.go:399-401) — the
        differential join key: [Id:Term:CommitIndex:LastApplied][state]msg.
        With a flight recorder attached the same emission records a typed
        ``obs.events.Event`` (``kind`` explicit or classified from the
        message). With neither a recorder nor a trace attached the device
        fetch is skipped."""
        if self.recorder is None and self._trace is None:
            return ""
        ci_li = self._rows(
            torch.stack([self.state.commit_index, self.state.last_index]), 1
        )   # one fetch for both fields
        return self._nodelog_at(r, msg, int(ci_li[0, r]), int(ci_li[1, r]),
                                kind, **fields)

    def _record_event(self, r: int, kind: str, **fields) -> None:
        """Record a structured event that has no nodelog line (it never
        enters the trace stream). Reads only host mirrors."""
        if self.recorder is not None:
            self.recorder.record(
                node=f"Server{r}", term=int(self.terms[r]), kind=kind,
                t_virtual=self.clock.now, state=self.roles[r], **fields,
            )

    def _metric_inc(self, name: str, help_: str = "", **labels) -> None:
        """Guarded counter bump (no-op without a registry). The single
        engine is group "0"; extra labels (a shed ``reason``) ride along."""
        if self.metrics is None:
            return
        labels.setdefault("group", "0")
        self.metrics.counter(name, help_, tuple(labels)).inc(**labels)

    def _note_seal(self, n_entries: int) -> None:
        """Tiered-store seal callback: one segment of ``n_entries``
        committed entries was RS-coded and spilled to disk."""
        self._metric_inc(
            "raft_segments_sealed_total",
            "sealed cold-tier segments spilled to disk",
        )

    def _set_votes(self, terms: np.ndarray, vf: np.ndarray) -> None:
        """Install per-replica (term, votedFor) into the device state and
        the host term mirror (vote-log replay, restore)."""
        st = self.state
        self.state = st.replace(
            term=self.t.place_rows(terms, st.term),
            voted_for=self.t.place_rows(vf, st.voted_for),
        )
        self.terms = terms

    def _attach_votelog(self, path: str) -> None:
        self._votelog = VoteLog(path)
        self._persisted_terms = self.terms.astype(np.int64).copy()
        self._persisted_vf = self._rows(self.state.voted_for).astype(np.int64)

    def _persist_votes(self, vf: Optional[np.ndarray] = None) -> None:
        """Durably record every (term, votedFor) row that changed since
        the last record — called BEFORE the engine acts on the transition
        (the fence argument in ckpt.votelog). ``vf`` is the device
        voted_for when the caller has it (vote rounds); without it,
        adoption semantics apply: a row whose term advanced holds NO_VOTE
        in the new term (the step resets voted_for on adoption)."""
        if self._votelog is None:
            return
        rows = []
        for r in range(self.cfg.rows):
            t = int(self.terms[r])
            if vf is not None:
                v = int(vf[r])
            elif t == self._persisted_terms[r]:
                v = int(self._persisted_vf[r])
            else:
                v = NO_VOTE
            if t != self._persisted_terms[r] or v != self._persisted_vf[r]:
                rows.append((r, t, v))
                self._persisted_terms[r] = t
                self._persisted_vf[r] = v
        if rows:
            self._votelog.record_many(rows)

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
            try:
                self.admission.admit_write(len(self._queue), client)
            except Overloaded as ex:
                # refused before anything queued: the ambient span and the
                # shed counter record the reason
                if self.spans is not None:
                    self.spans.note_refusal(ex.reason, self.clock.now)
                self._metric_inc("raft_sheds_total", reason=ex.reason)
                raise
        seq = self._next_seq
        self._next_seq += 1
        self._queue.append((seq, payload))
        self.submit_time[seq] = self.clock.now
        if self.spans is not None:
            self.spans.note_submit(seq, self.clock.now)
        if self.metrics is not None:
            self.metrics.gauge(
                "raft_queue_depth_high_water",
                "max host write-queue depth observed", ("group",),
            ).set_max(len(self._queue), group="0")
        if self._fused_driver is not None:
            # stage the batch this entry completed into the device
            # staging ring (a client-side cost: the fused drain reads it
            # by slot)
            self._fused_driver.on_submit()
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
        self._persist_votes()   # adopt the term durably before acting on it
        if self.leader_id == r:
            self.leader_id = None
        if self.lease is not None:
            self.lease.break_(r)
        self.nodelog(r, "step down to follower")
        self._metric_inc("raft_term_adoptions_total")
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
        # the pipelined path owns the queue wholesale from here on, which
        # the staging mirror cannot track: detach the driver around the
        # intake (no staging copy per batch that the reset would drop)
        drv, self._fused_driver = self._fused_driver, None
        try:
            seqs = [self.submit(p) for p in payloads]
        finally:
            self._fused_driver = drv
        pending, self._queue = self._queue, []
        self._queue_replaced()
        # configuration entries do not ride a chunk (it would keep
        # committing past the entry under the stale mask): stop before
        # the first one; the tick path ingests it with the new mask
        cut = next((i for i, (q, _) in enumerate(pending)
                    if q in self._config_seqs), None)
        deferred: List[Tuple[int, bytes]] = []
        if cut is not None:
            deferred = pending[cut:]
            pending = pending[:cut]
        B = cfg.batch_size
        T_ring = cfg.log_capacity // B
        while pending:
            if self.leader_id != r or not self.alive[r]:
                break
            leader_last = int(self._rows(self.state.last_index)[r])
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
            if cfg.ec_enabled:
                # K7: the chunk's RS shard rows, folded into the log layout
                payload_stack = encode_fold_device(
                    self._code, self._dev_bytes(data)
                ).reshape(T, B, -1)
            else:
                payload_stack = fold_batch(data, cfg.rows,
                                           device=self._dev).reshape(T, B, -1)
            pre_lasts = self._pre_lasts()
            floor, fpt = self._floor_attest(r)
            dev_pre = self._dev_pre_chunk()
            if eligible:
                # the saturated fast path: the whole chunk as ONE flight;
                # the host gate implies the kernel's feasibility
                # predicate, so every step ingests and commits a full
                # batch — verified by the commit check below
                self.state, info = self.t.replicate_pipeline(
                    self.state, payload_stack, self._dev_arr(counts), r,
                    self.leader_term, self._dev_arr(eff),
                    self._dev_arr(self.slow),
                    # the flight takes the bool voter plane, never the
                    # packed form
                    member=(self._dev_arr(self.member)
                            if cfg.max_replicas is not None else None),
                    repair_floor=floor, floor_prev_term=fpt,
                    term_floor=self._term_floor,
                    allow_turnover=all_accept,
                )
                self._note_truncations(pre_lasts)
                self._dev_record_chunk(dev_pre, info, r, self.leader_term, T)
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
                        self._rows(self.state.last_index),
                    )
                    self._queue = (
                        list(chunk[done:]) + pending[take:] + deferred
                        + self._queue
                    )
                    self._queue_replaced()
                    raise RuntimeError(
                        f"pipeline chunk shortfall: committed "
                        f"{final_commit}, expected {leader_last + take} "
                        "(host feasibility gate out of sync with the "
                        "kernel's launch predicate); device log "
                        "reconciled, uncommitted remainder re-queued"
                    )
                self._account_chunk_prefix(r, chunk, take, leader_last, eff)
                pending = pending[take:]
                self._confirm_reads(
                    r, self.leader_term, eff, int(info.max_term)
                )
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
            if dev_pre is not None:
                # the scan stacks per-step infos; the chunk's transition
                # is judged against the final step's
                self._dev_record_chunk(
                    dev_pre, type(infos)(*(f[-1] for f in infos)), r,
                    self.leader_term, T,
                )
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
                        self._note_config_ingest(idx, seq, self.leader_term)
                    else:
                        refused.append((seq, p))
                pos += cnt
            pending = refused + pending[take:]
            # durability fence first, as on the tick path: the chunk's
            # term adoptions reach disk before _advance_commit acts
            self.terms[eff] = np.maximum(self.terms[eff], self.leader_term)
            self._persist_votes()
            self._advance_commit(r, final_commit)
            self._confirm_reads(r, self.leader_term, eff, max_term)
            self._update_steady(r, infos.match[-1], eff)
            if max_term > self.leader_term:
                # deposed mid-chunk: hand the rest back to the queue
                self._step_down_leader(r, max_term)
                break
            if refused:
                break  # no progress is possible right now; don't spin
        self._queue = pending + deferred + self._queue
        self._queue_replaced()
        if self.leader_id == r:
            self._reset_heard_timers(r)
        return seqs

    def _queue_replaced(self) -> None:
        """The queue was swapped or prepended to: the staging ring's
        mirror of it is void."""
        if self._fused_driver is not None:
            self._fused_driver.on_queue_replaced()

    def _account_chunk_prefix(self, r: int, chunk, n: int,
                              leader_last: int, eff) -> None:
        """Durable accounting for the first ``n`` entries of a pipeline
        chunk at contiguous indices after ``leader_last``: seq and payload
        bookkeeping, term adoption fenced to disk, then the commit
        advance. Shared by the fast path's success and shortfall
        branches."""
        for i, (seq, p) in enumerate(chunk[:n]):
            idx = leader_last + 1 + i
            self._seq_at_index[idx] = seq
            self._uncommitted[idx] = (p, self.leader_term)
        self.terms[eff] = np.maximum(self.terms[eff], self.leader_term)
        self._persist_votes()
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
        lasts, matches, mterms, dterms = self._rows(torch.stack([
            self.state.last_index, self.state.match_index,
            self.state.match_term, self.state.term,
        ]), 1)
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
        if cfg.max_replicas is not None:
            # the kernels' member quorum: a voter majority, clamped to the
            # static commit_quorum under EC; acks count over voters only
            quorum = int(self.member.sum()) // 2 + 1
            if cfg.ec_enabled:
                quorum = max(quorum, cfg.commit_quorum)
            return int((accept & self.member).sum()) >= quorum
        return int(accept.sum()) >= cfg.commit_quorum

    @property
    def in_flight_count(self) -> int:
        """Entries ingested into the leader's log but not yet committed."""
        return sum(
            1 for seq in self._seq_at_index.values()
            if seq not in self.commit_time
        )

    # ------------------------------------------------- batched ReadIndex
    def submit_read(self, r: Optional[int] = None) -> int:
        """Queue a linearizable read (batched ReadIndex over §6.4): note
        the current watermark now, and let the next successful quorum
        round (a write tick, a pipelined chunk, or an explicit
        ``read_linearizable``) confirm every queued read at once. Under
        write load a read costs no extra round; an idle cluster pays one
        empty round for the whole queue. Returns a ticket for
        ``read_confirmed``; with a valid lease the ticket is minted
        already confirmed at the leader's own commit view.

        Refusals match ``read_linearizable`` (not a live leader, deposed,
        quorum unreachable); leadership lost while a ticket waits shows
        at its next poll. With admission configured, tickets idle for
        ``READ_TICKET_TTL_FACTOR`` max election timeouts are evicted
        first, then an arrival past ``admission_max_reads`` raises
        ``admission.Overloaded``; past ``READ_TICKET_CAP`` outstanding
        tickets the oldest are FIFO-evicted (they poll as
        ``TicketEvicted``)."""
        if self.admission is not None:
            ttl = self.READ_TICKET_TTL_FACTOR * self.cfg.follower_timeout[1]
            # tickets mint in order and dict order survives deletes: the
            # front is the oldest, so stop at the first young ticket
            for tk in list(self._reads):
                if self.clock.now - self._reads[tk][4] < ttl:
                    break
                self._drop_read_ticket(tk)
                self._read_evict_floor = max(self._read_evict_floor, tk + 1)
            try:
                self.admission.admit_read(len(self._reads))
            except Overloaded as ex:
                if self.spans is not None:
                    self.spans.note_refusal(ex.reason, self.clock.now)
                self._metric_inc("raft_sheds_total", reason=ex.reason)
                raise
        if r is None:
            r = self.leader_id
        lease_idx = None
        try:
            if r is None or self.roles[r] != LEADER or not self.alive[r]:
                raise LinearizableReadRefused("not a live leader")
            if int(self.terms[r]) > int(self.lead_terms[r]):
                self._step_down_leader(r, int(self.terms[r]))
                raise LinearizableReadRefused("deposed (higher term seen)")
            # the lease before the reach check: a lease holder serves with
            # no knowledge of the cluster beyond its drift-bounded clock
            lease_idx = self.lease_read_index(r)
            if lease_idx is None:
                voters = self._voter_reach(r)
                if int(voters.sum()) <= int(self.member.sum()) // 2:
                    raise LinearizableReadRefused(
                        f"quorum unreachable ({int(voters.sum())} of "
                        f"{int(self.member.sum())} members)"
                    )
        except LinearizableReadRefused as ex:
            if self.spans is not None:
                self.spans.note_read_refused(None, str(ex), self.clock.now)
            raise
        tk = self._next_read_ticket
        self._next_read_ticket += 1
        bind = (r, int(self.lead_terms[r]))
        if lease_idx is not None:
            # a zero-round lease serve: confirmed at r's own commit view,
            # in no confirmation bucket
            self._reads[tk] = [
                r, lease_idx, bind[1], "ready", self.clock.now, "lease",
            ]
        else:
            self._reads[tk] = [
                r, self.commit_watermark, bind[1], "pending",
                self.clock.now, "read_index",
            ]
            self._read_buckets.setdefault(bind, set()).add(tk)
        n_evict = len(self._reads) - self.READ_TICKET_CAP
        if n_evict > 0:
            # FIFO past the cap: the first keys are the oldest tickets
            for old in list(islice(iter(self._reads), n_evict)):
                self._drop_read_ticket(old)
                self._read_evict_floor = max(self._read_evict_floor, old + 1)
        if self.spans is not None:
            self.spans.note_read_ticket(tk, self.clock.now)
        return tk

    def read_ticket_class(self, ticket: int) -> Optional[str]:
        """Served class of an outstanding ticket ("lease" or
        "read_index"); None once consumed or evicted."""
        rec = self._reads.get(ticket)
        if rec is None:
            return None
        return rec[5]

    def _drop_read_ticket(self, ticket: int) -> None:
        """Remove a ticket from the queue and its (row, term) bucket."""
        rec = self._reads.pop(ticket, None)
        if rec is None:
            return
        bucket = self._read_buckets.get((rec[0], rec[2]))
        if bucket is not None:
            bucket.discard(ticket)
            if not bucket:
                del self._read_buckets[(rec[0], rec[2])]

    def read_confirmed(self, ticket: int) -> Optional[int]:
        """Poll a ``submit_read`` ticket: the confirmed read index once a
        quorum round has run (serve from state applied to at least that
        index), None while pending, ``LinearizableReadRefused`` once the
        ticket's (row, term) binding can no longer confirm. Terminal
        outcomes pop the ticket."""
        rec = self._reads.get(ticket)
        if rec is None:
            if 0 <= ticket < self._read_evict_floor:
                raise TicketEvicted(
                    f"ticket {ticket} was evicted at the outstanding-read "
                    "cap before confirmation; re-issue the read"
                )
            raise KeyError(f"unknown or already-consumed ticket {ticket}")
        row, idx, tterm, st = rec[:4]
        if st == "ready":
            cls = rec[5]
            self._drop_read_ticket(ticket)
            if self.spans is not None:
                self.spans.note_read_confirmed(
                    ticket, idx, self.clock.now, cls=cls,
                    rounds=0 if cls == "lease" else None,
                )
            if self.slo is not None:
                # read latency: ticket mint -> confirmation (rec[4])
                self.slo.observe(
                    "read", self.clock.now - rec[4], self.clock.now
                )
            self._note_read_served(cls, self.clock.now - rec[4])
            return idx
        if (self.roles[row] != LEADER or not self.alive[row]
                or int(self.lead_terms[row]) != tterm
                or int(self.terms[row]) > tterm):
            self._drop_read_ticket(ticket)
            if self.spans is not None:
                self.spans.note_read_refused(
                    ticket, "leadership lost before confirmation",
                    self.clock.now,
                )
            raise LinearizableReadRefused(
                "leadership lost before confirmation"
            )
        return None

    def _lease_renew(self, r: int, term: int, eff, max_term: int) -> None:
        """A quorum round sourced at ``r`` completed: renew its lease when
        it reached a voter majority, surfaced no higher term, and no
        configuration change is in flight."""
        if self.lease is None or max_term > term:
            return
        if int((eff & self.member).sum()) <= int(self.member.sum()) // 2:
            return
        if (self._pending_config is not None or self._staged_config
                or self._config_seqs or self.learner.any()):
            return
        self.lease.grant(r, term, self.clock.now)

    def lease_read_index(self, r: int) -> Optional[int]:
        """Zero-round read index for live leader ``r`` (its own commit
        view, ``_row_commit``), or None when the lease cannot serve: the
        plane off, the lease expired or absent, a higher term seen, a
        configuration change in flight, or no commit yet in r's term
        (§6.4's fresh-leader gate). Reads only host mirrors and the
        virtual clock."""
        if self.lease is None:
            return None
        term = int(self.lead_terms[r])
        if int(self.terms[r]) > term:
            return None
        if (self._pending_config is not None or self._staged_config
                or self._config_seqs or self.learner.any()):
            return None
        if int(self._lease_ok_term[r]) != term:
            return None
        if not self.lease.valid(r, term, self.clock.now):
            return None
        return int(self._row_commit[r])

    def set_lease_rate(self, r: int, rate: float) -> None:
        """Clock-skew injection: row ``r``'s lease clock runs at ``rate``
        local seconds per true second (no-op without leases)."""
        if self.lease is not None:
            self.lease.set_rate(r, rate)

    def _note_read_served(self, cls: str, latency_s: float) -> None:
        """One read served under class ``cls`` (lease / read_index): the
        host count, ``raft_reads_total{class}`` and the per-class SLO
        latency digest."""
        self.read_class_counts[cls] = self.read_class_counts.get(cls, 0) + 1
        self._metric_inc("raft_reads_total", "reads served by class",
                         **{"class": cls})
        if self.admission is not None:
            self.admission.note_read_class(cls)
        if self.slo is not None:
            self.slo.observe(f"read_{cls}", latency_s, self.clock.now)

    def _confirm_reads(self, r: int, term: int, eff, max_term: int) -> None:
        """A quorum round sourced at ``r`` just completed: when it reached
        a voter majority and surfaced no higher term it confirms every
        read queued on ``r`` in this term (the one (r, term) bucket) and
        renews r's lease."""
        self._lease_renew(r, term, eff, max_term)
        if not self._reads:
            return
        # counted over reachable voters: learners' acks confirm nothing
        if max_term > term or (
            int((eff & self.member).sum()) <= int(self.member.sum()) // 2
        ):
            return
        bucket = self._read_buckets.pop((r, term), None)
        if not bucket:
            return
        for tk in bucket:
            rec = self._reads.get(tk)
            if rec is not None and rec[3] == "pending":
                rec[3] = "ready"

    def read_linearizable(self, r: Optional[int] = None) -> int:
        """ReadIndex (§6.4): confirm leadership, then return the commit
        index a read may be served at (from state applied to at least
        it). With a valid lease no round runs. Otherwise the leader notes
        the watermark, checks that it reaches a voter majority, and runs
        one empty replication round (``_empty_round``); a higher term in
        it deposes the leader. Raises ``LinearizableReadRefused`` when
        leadership cannot be confirmed. Reads queued by ``submit_read``
        share the round. ``r`` defaults to the routed leader; pass a row
        to probe a specific (possibly stale) leader."""
        if r is None:
            r = self.leader_id
        if r is None or self.roles[r] != LEADER or not self.alive[r]:
            raise LinearizableReadRefused("not a live leader")
        term = int(self.lead_terms[r])
        if int(self.terms[r]) > term:
            self._step_down_leader(r, int(self.terms[r]))
            raise LinearizableReadRefused("deposed (higher term seen)")
        lease_idx = self.lease_read_index(r)
        if lease_idx is not None:
            # zero rounds, no device dispatch: the lease's drift-bounded
            # validity is the leadership confirmation
            if self.spans is not None:
                self.spans.note_read_served(
                    "lease", self.clock.now, index=lease_idx, rounds=0,
                )
            self._note_read_served("lease", 0.0)
            return lease_idx
        read_index = self.commit_watermark
        eff = self._reach(r)
        # the quorum check first: it needs no round, and a minority-side
        # leader must be refused even while its side is quiet
        confirmed = int((eff & self.member).sum())
        if confirmed <= int(self.member.sum()) // 2:
            raise LinearizableReadRefused(
                f"quorum unreachable ({confirmed} of "
                f"{int(self.member.sum())} members)"
            )
        info = self._empty_round(r, term, eff)
        max_term = int(info.max_term)
        if max_term > term:
            self._step_down_leader(r, max_term)
            raise LinearizableReadRefused("deposed during confirmation")
        self.terms[eff] = np.maximum(self.terms[eff], term)
        self._persist_votes()   # the round's adoptions reach disk first
        self._advance_commit(r, int(info.commit_index))
        self._confirm_reads(r, term, eff, max_term)
        self._reset_heard_timers(r)
        if self.spans is not None:
            self.spans.note_read_served(
                "read_index", self.clock.now, index=read_index, rounds=1,
            )
        self._note_read_served("read_index", 0.0)
        return read_index

    def _empty_round(self, r: int, term: int, eff):
        """One zero-entry replication round sourced at ``r``: the device
        half of a heartbeat (the tick's take == 0 branch), K2 at count 0
        on a steady cluster, K1's general path while repairing."""
        cfg = self.cfg
        if self._hb_payload is None:
            self._hb_payload = torch.zeros(
                (cfg.batch_size, cfg.rows * cfg.shard_words),
                dtype=torch.int32, device=self._dev,
            )
        pre_lasts = self._pre_lasts()
        floor, fpt = self._floor_attest(r)
        out = self.t.replicate(
            self.state, self._hb_payload, 0, r, term, self._dev_arr(eff),
            self._dev_arr(self.slow), repair=self._repair_program(),
            member=self._member_arg(),
            repair_floor=floor, floor_prev_term=fpt,
            term_floor=self._term_floor, **self._ring_arg(),
        )
        self.state, info = out[:2]
        self._flush_device_obs()
        self._note_truncations(pre_lasts)
        return info

    def _ring_arg(self) -> dict:
        """The recorded launch's ``ring=`` while the device plane is
        attached; nothing otherwise (the unrecorded program)."""
        return {} if self._dev_ring is None else {"ring": self._dev_ring}

    # ------------------------------------------------------------- membership
    def _member_arg(self):
        """The membership mask for device steps: None on a
        fixed-membership cluster (the static quorum), the bool voter
        plane while no learner is attached, the packed voter|learner mask
        (``core.state.pack_membership``) otherwise; the step takes the
        voter plane of it on the device (``membership_voters``).
        ``replicate_pipeline`` takes the bool plane directly."""
        if self.cfg.max_replicas is None:
            return None
        if self.learner.any():
            return self._dev_arr(pack_membership(self.member, self.learner))
        return self._dev_arr(self.member)

    def _config_payload(self, member: np.ndarray,
                        learner: np.ndarray) -> bytes:
        """A configuration entry: ``RCFG``, the voter bitmap (u64 LE), and
        a learner bitmap only when the new configuration has learners."""
        bits = int(sum(1 << i for i in np.flatnonzero(member)))
        body = b"RCFG" + bits.to_bytes(8, "little")
        if np.asarray(learner, bool).any():
            lbits = int(sum(1 << i for i in np.flatnonzero(learner)))
            body += lbits.to_bytes(8, "little")
        if len(body) > self.cfg.entry_bytes:
            raise ValueError(
                "entry_bytes too small to carry a configuration entry"
            )
        return body + bytes(self.cfg.entry_bytes - len(body))

    def _change_membership(self, new_member: np.ndarray,
                           new_learner: np.ndarray) -> int:
        if self.cfg.max_replicas is None:
            raise ValueError(
                "membership change needs max_replicas headroom in RaftConfig"
            )
        if (np.asarray(new_member, bool)
                & np.asarray(new_learner, bool)).any():
            raise ValueError("a row cannot be both voter and learner")
        if self._pending_config is not None or any(
            q in self._config_seqs for q, _ in self._queue
        ):
            # one at a time (§4.1), a change still queued included
            raise RuntimeError(
                "a configuration change is already in flight; one at a "
                "time (dissertation §4.1's single-server rule)"
            )
        if self.leader_id is None:
            raise RuntimeError("membership change needs a current leader")
        seq = self.submit(self._config_payload(new_member, new_learner))
        self._config_seqs[seq] = (
            (tuple(bool(x) for x in self.member),
             tuple(bool(x) for x in self.learner)),
            (tuple(bool(x) for x in new_member),
             tuple(bool(x) for x in new_learner)),
        )
        return seq

    def add_learner(self, r: int) -> int:
        """Attach row ``r`` as a non-voting learner (§4.2.1): replicated,
        repaired and snapshot-installed like a voter, never counted.
        Returns the configuration entry's seq."""
        if not (0 <= r < self.cfg.rows):
            raise ValueError(f"replica {r} out of range (rows={self.cfg.rows})")
        if self.member[r]:
            raise ValueError(f"replica {r} is already a voter")
        if self.learner[r]:
            raise ValueError(f"replica {r} is already a learner")
        new_l = self.learner.copy()
        new_l[r] = True
        return self._change_membership(self.member.copy(), new_l)

    def _promote_lag_bound(self) -> int:
        lag = self.cfg.promote_max_lag
        return lag if lag is not None else 2 * self.cfg.batch_size

    def promote(self, r: int) -> int:
        """Promote learner ``r`` to a voter (one configuration entry).
        Raises ``LearnerLagging`` while it is down or its current-term
        verified match is more than ``promote_max_lag`` entries behind
        the leader's last index."""
        if not self.learner[r]:
            raise ValueError(f"replica {r} is not a learner")
        lead = self.leader_id
        if lead is None:
            raise RuntimeError("promotion needs a current leader")
        if not self.alive[r]:
            raise LearnerLagging(
                f"learner {r} is down; promotion requires a live, "
                "caught-up learner"
            )
        lasts_matches = self._rows(torch.stack([
            self.state.last_index, self.state.match_index,
            self.state.match_term,
        ]), 1)
        leader_last = int(lasts_matches[0, lead])
        eff_match = (
            int(lasts_matches[1, r])
            if int(lasts_matches[2, r]) == int(self.lead_terms[lead]) else 0
        )
        lag = leader_last - eff_match
        if lag > self._promote_lag_bound():
            raise LearnerLagging(
                f"learner {r} is {lag} entries behind the leader "
                f"(bound {self._promote_lag_bound()}); promote once "
                "replication / snapshot install has caught it up"
            )
        new_m = self.member.copy()
        new_m[r] = True
        new_l = self.learner.copy()
        new_l[r] = False
        return self._change_membership(new_m, new_l)

    def add_server(self, r: int) -> int:
        """Grow the cluster by one server, learner first (§4.2.1): row
        ``r`` joins as a learner (the returned seq is that entry's), is
        healed, and the leader tick promotes it once its match is within
        ``promote_max_lag``. ``run_until_voter`` waits for the promote."""
        seq = self.add_learner(r)
        self._staged_config.append(("promote", r))
        return seq

    def add_voter(self, r: int) -> int:
        """Grow the cluster by one immediate voter (a configuration entry
        that takes effect when appended). The row joins empty and counts
        against the quorum until it catches up; ``add_server`` avoids
        that."""
        if not (0 <= r < self.cfg.rows):
            raise ValueError(f"replica {r} out of range (rows={self.cfg.rows})")
        if self.member[r]:
            raise ValueError(f"replica {r} is already a member")
        new = self.member.copy()
        new[r] = True
        new_l = self.learner.copy()
        new_l[r] = False   # promoting a learner directly is allowed
        return self._change_membership(new, new_l)

    def remove_server(self, r: int) -> int:
        """Shrink the cluster by one server (voter or learner). A removed
        leader keeps leading until the entry commits, then steps down
        (§4.2.2). Under EC the voters may not fall below
        ``commit_quorum``."""
        if self.learner[r]:
            new_l = self.learner.copy()
            new_l[r] = False
            return self._change_membership(self.member.copy(), new_l)
        if not self.member[r]:
            raise ValueError(f"replica {r} is not a member")
        new = self.member.copy()
        new[r] = False
        if int(new.sum()) < 1:
            raise ValueError("cannot remove the last member")
        if self.cfg.ec_enabled and int(new.sum()) < self.cfg.commit_quorum:
            raise ValueError(
                f"removing replica {r} leaves {int(new.sum())} members, "
                f"below the EC commit quorum ({self.cfg.commit_quorum})"
            )
        return self._change_membership(new, self.learner.copy())

    def replace(self, dead: int, spare: int) -> int:
        """Replace a dead voter with ``spare``: remove ``dead`` now
        (returns that entry's seq), then, staged one change at a time,
        add ``spare`` as a learner, heal it and promote it.
        ``spare == dead`` re-admits the row under a fresh identity, the
        only way back for a row whose durable state was lost (``wipe``)."""
        if not self.member[dead]:
            raise ValueError(f"replica {dead} is not a member")
        if self.alive[dead]:
            raise ValueError(
                f"replica {dead} is alive; replace() is for dead servers "
                "(fail() it first, or use remove_server/add_server)"
            )
        if not (0 <= spare < self.cfg.rows):
            raise ValueError(f"spare {spare} out of range")
        if spare != dead and (self.member[spare] or self.learner[spare]):
            raise ValueError(f"spare {spare} is already configured")
        seq = self.remove_server(dead)
        self._staged_config.extend(
            [("add_learner", spare), ("promote", spare)]
        )
        return seq

    def _drive_staged_config(self, r: int) -> None:
        """Advance the head of the staged ladder when no change is in
        flight (the routed leader's tick); a lagging learner's promote
        waits for a later tick."""
        if not self._staged_config:
            return
        if self._pending_config is not None or any(
            q in self._config_seqs for q, _ in self._queue
        ):
            return
        kind, row = self._staged_config[0]
        if kind == "add_learner":
            if self.member[row] or self.learner[row]:
                self._staged_config.pop(0)   # already in: the ladder moves
                return
            try:
                self.add_learner(row)
            except (RuntimeError, ValueError, Overloaded):
                return   # no leader yet / admission shedding: retry later
            self._staged_config.pop(0)
        elif kind == "promote":
            if self.member[row] or not self.learner[row]:
                # already a voter, or the learner was removed or rolled
                # back under the ladder: the step is moot
                self._staged_config.pop(0)
                return
            try:
                self.promote(row)
            except LearnerLagging:
                return                       # still catching up: retry
            except (RuntimeError, ValueError, Overloaded):
                return
            self._staged_config.pop(0)

    def run_until_voter(self, r: int, limit: float = 600.0) -> None:
        """Run the event loop until row ``r`` is a voter (the end of
        ``add_server``'s ladder, or of ``replace``'s)."""
        end = self.clock.now + limit
        while not self.member[r] and self.clock.now < end and self._q:
            self.step_event()
        assert self.member[r], (
            f"replica {r} not promoted to voter within {limit}s "
            f"(learner={bool(self.learner[r])}, "
            f"staged={self._staged_config})"
        )

    def _note_config_ingest(self, idx: int, seq: int, term: int) -> None:
        """A configuration entry reached the leader's log: the new
        configuration is active from now (append-time activation, §4.1)."""
        ch = self._config_seqs.pop(seq, None)   # consumed exactly once
        if ch is None:
            return
        old, new = ch
        self._pending_config = (idx, old, new, term)
        self._apply_membership(np.array(new[0], bool),
                               np.array(new[1], bool))

    def _rollback_pending_config(self, r: int, reason: str) -> None:
        """Roll the uncommitted change back to its old masks (the entry
        left the relevant logs); its seq never reads durable."""
        _, old_masks, _, _ = self._pending_config
        self._pending_config = None
        self._apply_membership(
            np.array(old_masks[0], bool), np.array(old_masks[1], bool)
        )
        self.nodelog(r, reason)

    def _apply_membership(self, new: np.ndarray,
                          new_learner: np.ndarray) -> None:
        added = new & ~self.member
        removed = self.member & ~new
        l_added = new_learner & ~self.learner
        l_removed = self.learner & ~new_learner
        self.member = new
        self.learner = new_learner
        self._steady = False
        for p in np.flatnonzero(added):
            p = int(p)
            self.roles[p] = FOLLOWER
            if l_removed[p]:
                self.nodelog(p, "promoted from learner to voter")
            else:
                self.nodelog(p, "added to configuration")
            self._arm_follower(p)
        for p in np.flatnonzero(removed):
            p = int(p)
            self.nodelog(p, "removed from configuration")
            # _wiped clears only when the removal commits (_advance_commit):
            # an append-time activation can still roll back. A removed
            # leader keeps serving until then.
            if self.roles[p] != LEADER:
                self.roles[p] = FOLLOWER
        for p in np.flatnonzero(l_added):
            p = int(p)
            self.roles[p] = FOLLOWER
            self.nodelog(p, "added to configuration as learner")
            # learners arm no election timers: they never campaign
        for p in np.flatnonzero(l_removed & ~added):
            p = int(p)
            self.nodelog(p, "learner removed from configuration")

    # ------------------------------------------- device observability plane
    def attach_device_obs(self, obs=None, capacity: int = 4096):
        """Attach the device-resident observability plane (``obs.device``):
        later replicate and vote launches record into an event ring on
        the device (their states equal the unrecorded launches'), and
        each launch boundary flushes the ring and its counters into
        ``obs`` (a ``DeviceObs``; one is made when omitted). Passing an
        existing DeviceObs lets one plane span crash-restore cycles: each
        attachment opens a new epoch. The pipelined chunks record at
        chunk granularity (``_dev_record_chunk``). Returns the
        DeviceObs."""
        from raft_tpu_torch.obs.device import N_COUNTERS, DeviceObs, init_ring

        self.device_obs = obs if obs is not None else DeviceObs(capacity)
        self.device_obs.new_epoch()
        self._dev_ring = init_ring(self.device_obs.capacity,
                                   device=self.state.device)
        self._dev_flushed = 0
        self._dev_counters_folded = np.zeros(N_COUNTERS, np.int64)
        return self.device_obs

    def detach_device_obs(self) -> None:
        """Back to the unrecorded launches; the DeviceObs keeps everything
        already flushed."""
        self._flush_device_obs()
        self.device_obs = None
        self._dev_ring = None

    def _flush_device_obs(self) -> None:
        """One fetch per launch boundary: the packed ring (buffer, seq
        counter, metrics vector), decoded into ``obs.events.Event``s, with
        the counter deltas folded into ``self.metrics``. A pure read: no
        engine decision depends on it."""
        if self.device_obs is None or self._dev_ring is None:
            return
        from raft_tpu_torch.obs.device import (
            COUNTER_METRICS,
            decode_records,
            packed_flush,
        )

        packed = self._fetch(packed_flush(self._dev_ring))
        events, count, lost, counters, _tick = decode_records(
            packed, self._dev_flushed, t_virtual=self.clock.now,
        )
        if count == self._dev_flushed and not np.any(
            counters - self._dev_counters_folded
        ):
            return
        self.device_obs.ingest(
            events, total=count, lost=lost, counters=counters, group=None,
        )
        self._dev_flushed = count
        if self.metrics is not None:
            for i, name in enumerate(COUNTER_METRICS):
                delta = int(counters[i] - self._dev_counters_folded[i])
                if delta:
                    self.metrics.counter(
                        name, "on-device protocol counter", ("group",)
                    ).inc(delta, group="0")
        self._dev_counters_folded = counters

    def _dev_pre_chunk(self):
        """The small leaves chunk recording reads, copied out BEFORE a
        pipelined launch (the flights write them in place); None when
        the device plane is detached."""
        if self._dev_ring is None:
            return None
        from raft_tpu_torch.obs.device import pre_of

        return pre_of(self.state)

    def _dev_record_chunk(self, pre, info, r: int, term: int,
                          ticks: int) -> None:
        """Chunk-granularity recording of a pipelined launch
        (``submit_pipelined``): the flight kernels carry no per-step
        ring, so the chunk records its aggregate transition, one commit
        advance (the one host nodelog commit line a chunk produces) plus
        term adoptions, step-down evidence and counter deltas, with
        ``heartbeat_ticks`` charged the chunk's step count; then one
        flush."""
        if self._dev_ring is None or pre is None:
            return
        from raft_tpu_torch.obs.device import record_replicate_events

        # the transport's comm: on the mesh the pre- and post-states are
        # gathered, so every rank records the same events
        record_replicate_events(
            self._dev_ring, self.t.comm, pre,
            self.state, info, r, term, -1, repair=False, ticks=ticks,
        )
        self._flush_device_obs()

    # ---------------------------------------------------------- fault toggles
    def fail(self, r: int) -> None:
        """Silence a replica (crash). Its timers stop; the device step
        masks it out."""
        self._steady = False
        self.alive[r] = False
        if self.leader_id == r:
            self.leader_id = None
        self.roles[r] = FOLLOWER
        if self.lease is not None:
            self.lease.break_(r)   # a dead row's grant is dead evidence
        self.nodelog(r, "killed")

    def recover(self, r: int) -> None:
        if self._wiped[r]:
            # a wiped voter whose identity has not durably left the
            # configuration must not run again (it could vote twice in a
            # term or un-ack committed data); the flag clears when a
            # removal commits, and replace() is the way back. A quiet
            # refusal, so seeded fault schedules stay executable.
            self.nodelog(
                r, "recover refused: wiped voter must rejoin via replace()"
            )
            return
        self._steady = False
        self.alive[r] = True
        self.roles[r] = FOLLOWER
        self.nodelog(r, "recovered")
        self._arm_follower(r)

    def wipe(self, r: int) -> None:
        """Destroy a dead row's durable and volatile state (log, term,
        vote, match, commit): total disk loss. If the row was a voter it
        is marked wiped, and ``recover`` refuses it until ``replace`` has
        removed the old identity; it rejoins from nothing as a learner."""
        if self.alive[r]:
            raise ValueError(
                f"replica {r} is alive; wipe() models disk loss of a "
                "crashed server (fail() it first)"
            )
        st = self.state
        i = self.t.local_row(r)   # None: another rank holds the row
        if i is not None:
            w = st.words_per_entry
            rows = torch.arange(st.term.shape[0], device=st.device) == i

            def zeroed(v, fill=0):
                return torch.where(rows, fill, v).to(v.dtype)

            st.log_term[i].zero_()
            st.log_payload[:, i * w:(i + 1) * w].zero_()
            self.state = st.replace(
                term=zeroed(st.term),
                voted_for=zeroed(st.voted_for, NO_VOTE),
                last_index=zeroed(st.last_index),
                commit_index=zeroed(st.commit_index),
                match_index=zeroed(st.match_index),
                match_term=zeroed(st.match_term),
            )
        self.terms[r] = 0
        self.lead_terms[r] = 0
        self.roles[r] = FOLLOWER
        self._ring_floor[r] = 1
        self._match_stall[r] = 0
        self._last_heard[r] = -1e18
        self._persisted_terms[r] = 0
        self._persisted_vf[r] = NO_VOTE
        self._quorum_contact_at.pop(r, None)
        self._lasts_snapshot = None
        self._match_snapshot = None
        self._steady = False
        if self.member[r]:
            self._wiped[r] = True
        if self.auditor is not None:
            # a wipe legally resets the row's term to 0: the auditor's
            # per-node term watermark resets with it
            self.auditor.note_wipe(f"Server{r}")
        self.nodelog(r, "wiped (durable state destroyed)")

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
        a live voter or learner, link-reachable from it (``src``
        included). Every quorum count intersects it with ``member``."""
        return (
            self.alive & self.connectivity[src]
            & (self.member | self.learner)
        )

    def _voter_reach(self, src: int) -> np.ndarray:
        """Reachable live VOTERS from ``src``: the mask every vote round,
        CheckQuorum and read-quorum check counts over."""
        return self.alive & self.connectivity[src] & self.member

    def _pre_lasts(self):
        """last_index as of the previous step's end — the cached copy from
        _note_truncations when no host-side mutation touched last_index
        since, else one fresh fetch."""
        if self._lasts_snapshot is not None:
            return self._lasts_snapshot
        return self._rows(self.state.last_index)

    def _floor_attest(self, r: int):
        """(repair_floor, attested term of floor-1) for leader ``r``: the
        truncation floor raised to the lap horizon ``last - capacity + 1``;
        the attested term comes from the archive (0 when unattestable)."""
        cap = self.state.capacity
        lap = int(self._pre_lasts()[r]) - cap + 1
        floor = max(int(self._ring_floor[r]), lap)
        if (self.recorder is not None and floor > 1
                and floor > self._floor_event_hwm.get(r, 0)):
            # the repair floor rose (lap horizon or truncation): a
            # recorder-only event, no nodelog line
            self._floor_event_hwm[r] = floor
            self._record_event(
                r, "repair_floor_raise", floor=floor, lap_horizon=lap,
                ring_floor=int(self._ring_floor[r]),
            )
        if floor <= 1:
            return floor, 0
        ent = self.store.get(floor - 1)
        return floor, (ent[1] if ent is not None else 0)

    def _note_truncations(self, pre_lasts) -> None:
        """Bump a row's ring-validity floor when a step truncated its log
        (§5.3 conflict): indices above ``pre_last - capacity`` were
        provably never overwritten by a wrapped generation."""
        post = self._rows(self.state.last_index)
        shrunk = np.flatnonzero(post < np.asarray(pre_lasts))
        for q in shrunk:
            q = int(q)
            self._ring_floor[q] = max(
                self._ring_floor[q],
                int(pre_lasts[q]) - self.state.capacity + 1,
            )
        self._lasts_snapshot = post
        self._match_snapshot = None   # the step moved match state

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
        """Advance the clock to the next timer and handle it.

        ``horizon`` (set by ``run_for``) is the end of the caller's drive
        window: with ``fuse_k > 1``, a popped leader tick whose successors
        provably fit before both the horizon and the next event that
        matters is handled as one fused window (``raft.steady``) instead
        of tick by tick. Without a horizon the engine cannot know how far
        the caller meant to drive, so fusion never engages."""
        if not self._q:
            return False
        hp = self.hostprof
        if hp is not None:
            hp.tick_begin()
        t, _, kind, r = heapq.heappop(self._q)
        self.clock.now = max(self.clock.now, t)
        tag, _, gen = kind.partition(":")
        stale = tag in ("e", "c") and int(gen) != self._timer_gen[r]
        #   a stale timer generation (reset since armed): no action
        if hp is not None:
            hp.mark("heap_pop")
        if stale:
            pass
        elif tag == "e":
            self._fire_follower(r)
        elif tag == "c":
            self._fire_candidate(r)
        elif tag == "l":
            if not (
                self._fused_driver is not None
                and horizon is not None
                and self._fused_driver.fire(r, horizon)
            ):
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
        if self.cfg.mirror_check_every:
            self._mirror_digest_step(t, kind + ("|stale" if stale else ""),
                                     r)
        # the online plane's flush boundary: the invariant scan over host
        # mirrors, the SLO window evaluation and the status publish. Host
        # work only (no device fetch, no rng); before hp.tick_end, so the
        # profiler's phases still tile the event.
        if self.auditor is not None:
            self.auditor.note_state(
                self.terms, self.commit_watermark, self.clock.now
            )
        if self.slo is not None:
            self.slo.maybe_evaluate(self.clock.now)
        if self.status_board is not None:
            self.status_board.publish(self._status_snapshot())
        if hp is not None:
            hp.tick_end()
        return True

    def _status_snapshot(self) -> dict:
        """The ``/status`` snapshot (``obs.serve``): leader map,
        watermarks, replication lag (ingested, uncommitted depth), queue
        depths, audit summary. Host values only (Python ints, floats,
        str, lists and dicts, never a tensor), built fresh per publish so
        the server thread reads an immutable dict."""
        lead = self.leader_id
        snap = {
            "t_virtual": self.clock.now,
            "groups": 1,
            "leaders": {
                "0": (
                    {"replica": lead, "term": int(self.lead_terms[lead])}
                    if lead is not None else None
                )
            },
            "terms": [int(x) for x in self.terms],
            "roles": list(self.roles),
            "alive": [bool(a) for a in self.alive],
            "commit_watermark": {"0": int(self.commit_watermark)},
            "applied_index": {"0": int(self.applied_index)},
            "replication_lag": {"0": len(self._seq_at_index)},
            "queue_depth": {"0": len(self._queue)},
            "reads_pending": len(self._reads),
            "committed_total": self.committed_total,
            "fused": {
                "launches": self.fused_launches,
                "ticks": self.fused_ticks,
            },
        }
        if self.admission is not None:
            snap["shedding"] = bool(self.admission.shedding)
        if self.lease is not None or self.read_class_counts:
            reads = {"by_class": dict(self.read_class_counts)}
            if self.lease is not None and lead is not None:
                reads["lease"] = self.lease.summary(
                    lead, int(self.lead_terms[lead]), self.clock.now
                )
            snap["reads"] = reads
        if self._tiered_store is not None:
            # seal/spill tallies, host bytes, RS reconstructs
            snap["tiered"] = self._tiered_store.tier_summary()
        if self._shipper.streams or self._shipper.chunks_total:
            snap["catchup"] = self._shipper.summary()
        if self.auditor is not None:
            snap["audit"] = self.auditor.summary()
        return snap

    # ------------------------------------------------ mirror desync guard
    def _mirror_digest_step(self, t: float, kind: str, r: int) -> None:
        """Fold one decision (the popped heap event and the whole host
        mirror it leaves: roles, leader, watermark, terms and the timer
        state that drives later decisions) into the rolling digest, with
        the JAX engine's record bytes; every ``mirror_check_every``-th
        decision, exchange digests across the ranks. A divergence enters
        the digest at the very next decision, while the ranks' collectives
        still align."""
        import zlib

        rec = (
            f"{t:.9f}|{kind}|{r}|{self.commit_watermark}|"
            f"{self.leader_id}|{','.join(self.roles)}|"
            f"{self._timer_gen}|"
            f"{sorted(self._quorum_contact_at.items())}"
        ).encode() + self.terms.tobytes() + self._last_heard.tobytes()
        self._mirror_digest = zlib.crc32(rec, self._mirror_digest)
        self._mirror_decisions += 1
        if self._mirror_decisions % self.cfg.mirror_check_every == 0:
            self._verify_mirror_digest()

    def _verify_mirror_digest(self) -> None:
        """Exchange the digest with every rank (``transport.
        exchange_digest``: one int64 a rank on the digest's own gloo
        group; a no-op in a one-process world) and FAIL-STOP on a
        mismatch. The exchange runs on a worker thread bounded by
        ``cfg.mirror_exchange_timeout_s``: a rank that stalled, died or
        diverged in decision count leaves this rank waiting inside it, and
        a stall or an exchange error raises ``MirrorDesyncError`` like a
        mismatch. The stuck daemon thread is abandoned: the raise is a
        fail-stop and the process is expected to end."""
        if self.t.processes == 1:
            return
        import threading
        import time

        # write-before-block: a wedged exchange leaves this barrier, its
        # decision count and tick count as the journal's last line
        blackbox.mark(
            "barrier_enter", barrier="mirror_digest",
            decisions=self._mirror_decisions, tick=self._tick_count,
            digest=int(self._mirror_digest),
        )
        box: dict = {}

        def _exchange() -> None:
            try:
                box["digests"] = np.asarray(
                    self.t.exchange_digest(self._mirror_digest)).ravel()
            except BaseException as ex:   # surfaced on the engine thread
                box["error"] = ex

        t0 = time.perf_counter()
        th = threading.Thread(target=_exchange, daemon=True,
                              name="mirror-digest-exchange")
        th.start()
        th.join(self.cfg.mirror_exchange_timeout_s)
        if "digests" not in box:
            err = box.get("error")
            why = (
                f"failed ({err!r})" if err is not None else
                f"did not complete within "
                f"{self.cfg.mirror_exchange_timeout_s:g}s — a peer "
                "process stalled, died, or diverged in decision count"
            )
            raise MirrorDesyncError(
                f"mirror digest exchange at decision "
                f"{self._mirror_decisions} {why}. The mirrored control "
                "planes can no longer be trusted to issue matching "
                "collectives — failing stop instead of hanging."
            )
        self.mirror_exchanges += 1
        self.mirror_exchange_s += time.perf_counter() - t0
        blackbox.mark("barrier_exit", barrier="mirror_digest",
                      decisions=self._mirror_decisions)
        digests = box["digests"]
        if not (digests == digests[0]).all():
            raise MirrorDesyncError(
                f"mirrored control planes diverged at decision "
                f"{self._mirror_decisions}: per-process digests "
                f"{[int(d) for d in digests]} (this process: "
                f"{int(self._mirror_digest)}). A decision stream "
                "divergence means collective launches can no longer be "
                "trusted to match — failing stop instead of hanging."
            )

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
        lasts, last_terms = self._rows(torch.stack(
            [self.state.last_index, last_log_term(self.state)]), 1)
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
        if self._dev_ring is not None:
            self.state, info, _ = self.t.request_votes(
                self.state, r, cand_term, self._dev_arr(eff),
                ring=self._dev_ring, quorum=int(self.member.sum()) // 2,
            )
            self._flush_device_obs()
        else:
            self.state, info = self.t.request_votes(
                self.state, r, cand_term, self._dev_arr(eff)
            )
        votes = int(info.votes)
        max_term = int(info.max_term)
        self.terms[eff] = np.maximum(self.terms[eff], cand_term)
        # durability fence: every replica's (term, votedFor) transition
        # from this vote round reaches disk before the engine acts on the
        # outcome (promotion, timers, further steps) — ckpt.votelog
        self._persist_votes(self._rows(self.state.voted_for))
        if max_term > cand_term:
            # someone is ahead; fall back to follower in the newer term
            self.terms[r] = max_term
            self._persist_votes()
            self.roles[r] = FOLLOWER
            self._arm_follower(r)
            return
        if votes > int(self.member.sum()) // 2:   # main.go:273, over members
            if self.leader_id != r:
                # A different leader's log may differ above the commit
                # watermark: drop the index->seq mappings of uncommitted
                # entries (their seqs read as lost), and the ingest-buffer
                # entries no replica's log still holds.
                if (self._pending_config is not None
                        and self._pending_config[0] > self.commit_watermark):
                    # a server uses the latest configuration entry in its
                    # log: a winner holding the in-flight entry (same
                    # slot, same ingest term) keeps it; otherwise it rolls
                    # back
                    cidx, _, _, cterm = self._pending_config
                    holds = bool(
                        int(self._rows(self.state.last_index)[r]) >= cidx
                        and int(self._log_terms([cidx], r)[0]) == cterm
                    )
                    if not holds:
                        self._rollback_pending_config(
                            r, "uncommitted configuration rolled back"
                        )
                kept_cfg = (
                    self._pending_config[0]
                    if self._pending_config is not None else None
                )
                self._seq_at_index = {
                    i: s for i, s in self._seq_at_index.items()
                    if i <= self.commit_watermark or i == kept_cfg
                }
                above = sorted(
                    i for i in self._uncommitted if i > self.commit_watermark
                )
                if above:
                    terms_all = self._log_terms(above)
                    lasts = self._rows(self.state.last_index)
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
            if self.auditor is not None:
                # Election Safety, online: at most one winner per term
                self.auditor.note_elect(
                    f"Server{r}", cand_term, self.clock.now
                )
            self._metric_inc("raft_elections_total")
            if self.metrics is not None:
                self.metrics.gauge(
                    "raft_term", "highest term seen", ("group",),
                ).set_max(int(self.terms.max()), group="0")
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
        self._metric_inc("raft_heartbeat_ticks_total")
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
        if routed and (self.admission is not None or self.slo is not None):
            # the head-of-queue sojourn (0 on an empty queue, which is
            # what exits the shedding state): the delay controller's input
            # and the SLO tracker's queue-delay series
            head_delay = 0.0
            if self._queue:
                head_delay = self.clock.now - self.submit_time.get(
                    self._queue[0][0], self.clock.now
                )
            if self.slo is not None:
                self.slo.observe("queue_delay", head_delay, self.clock.now)
        if routed and self.admission is not None:
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
            # the staged ladders first: they queue at most one
            # configuration entry, which the clamp below then handles
            self._drive_staged_config(r)
            # before the batch is taken: it may prepend re-queued entries
            self._make_room_for_current_term(r, term)
        take = min(len(self._queue), B) if routed else 0
        step_member = None
        if take:
            for qi, (qseq, _) in enumerate(self._queue[:take]):
                ch = self._config_seqs.get(qseq)
                if ch is not None:
                    # append-time activation: the step that APPENDS a
                    # configuration entry already counts its commits under
                    # the new voter plane, so the batch ends at the entry;
                    # if the ring cannot take the entry this tick it stays
                    # queued and the step keeps the old mask
                    last0 = int(self._rows(self.state.last_index)[r])
                    commit0 = int(self._rows(self.state.commit_index)[r])
                    room = self.state.capacity - (last0 - commit0)
                    if room >= qi + 1:
                        take = qi + 1
                        step_member = np.array(ch[1][0], bool)
                    else:
                        take = qi    # everything before the entry only
                    break
        hp = self.hostprof
        if hp is not None:
            # pre-dispatch bookkeeping up to here is host_pre; the payload
            # build below is the ingest-batching (pack) phase
            hp.mark("host_pre")
        if take == 0:
            if self._hb_payload is None:
                self._hb_payload = torch.zeros(
                    (B, cfg.rows * cfg.shard_words), dtype=torch.int32,
                    device=self._dev,
                )
            payload = self._hb_payload
        elif cfg.ec_enabled:
            # K7: the batch's RS shard rows (row r is what replica r
            # stores), folded into the log layout on the device
            data = self._pack_entries(self._queue[:take], B)
            payload = encode_fold_device(
                self._code, self._dev_bytes(data))
        else:
            # pack only the real entries; fold_batch pads to B
            payload = fold_batch(
                self._pack_entries(self._queue[:take], take),
                cfg.rows, B, device=self._dev,
            )
        if hp is not None:
            hp.mark("pack")
        pre_lasts = self._pre_lasts()
        floor, fpt = self._floor_attest(r)
        repair = self._repair_program()
        if repair:
            self._metric_inc("raft_repair_rounds_total")
        if hp is not None:
            # the floor attest and cached-lasts fetches are part of the
            # tick's host round trip: host_pre, not device_wait
            hp.mark("host_pre")
        member_arg = (self._dev_arr(step_member) if step_member is not None
                      else self._member_arg())
        with _profiling.launch_annotation("leader_tick", self._tick_count):
            out = self.t.replicate(
                self.state, payload, take, r, term, self._dev_arr(eff),
                self._dev_arr(self.slow), repair=repair,
                member=member_arg,
                repair_floor=floor, floor_prev_term=fpt,
                term_floor=self._term_floor, **self._ring_arg(),
            )
            self.state, info = out[:2]
        if hp is not None:
            hp.mark("dispatch")
            hp.sync(self.state, info)
        # the device-plane flush AFTER the profiler's dispatch and
        # device_wait marks: its fetch syncs, and inside the dispatch
        # window it would be charged to the step
        self._flush_device_obs()
        self._note_truncations(pre_lasts)
        max_term = int(info.max_term)
        if max_term > term:
            # nothing was consumed from the queue: the device step refused
            # ingest/commit for the stale term
            self._step_down_leader(r, max_term)
            return
        # heard replicas adopted the leader's term on device
        self.terms[eff] = np.maximum(self.terms[eff], term)
        self._persist_votes()   # term adoptions reach disk before commit acts
        # ring backpressure: the step ingests at most `room` entries;
        # anything it left behind stays queued for a later tick
        ingested = int(info.frontier_len)
        if ingested:
            last = int(self._rows(self.state.last_index)[r])  # post-ingest
            base = last - ingested
            chunk = self._queue[:ingested]
            if self._config_seqs or self.spans is not None:
                for i, (seq, p) in enumerate(chunk):
                    idx = base + 1 + i
                    self._seq_at_index[idx] = seq
                    self._uncommitted[idx] = (p, term)
                    self._note_config_ingest(idx, seq, term)
                    if self.spans is not None:
                        self.spans.note_ingest(
                            seq, idx, self.clock.now, self._tick_count
                        )
            else:
                self._seq_at_index.update(
                    zip(range(base + 1, last + 1), (s for s, _ in chunk))
                )
                self._uncommitted.update(
                    (base + 1 + i, (p, term))
                    for i, (_, p) in enumerate(chunk)
                )
            self._queue = self._queue[ingested:]
            if self._fused_driver is not None:
                self._fused_driver.on_consumed(ingested)
        self._advance_commit(r, int(info.commit_index))
        # every successful tick round is also the §6.4 read confirmation
        self._confirm_reads(r, term, eff, max_term)
        if routed:
            # heal bookkeeping and the shared steady flag belong to the
            # routed leader only
            if cfg.ec_enabled:
                self._ec_heal(r, info)
            else:
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
        # an in-flight configuration entry in the truncated range leaves
        # every log: roll the membership back and drop its bytes (its seq
        # reads as lost) rather than re-queue them as a data entry
        cfg_idx = None
        if self._pending_config is not None and \
                cut < self._pending_config[0] <= old_max:
            cfg_idx = self._pending_config[0]
            self._rollback_pending_config(
                self.leader_id if self.leader_id is not None else 0,
                "uncommitted configuration rolled back (entry truncated)",
            )
        requeue = []
        for i in range(cut + 1, old_max + 1):
            ent = self._uncommitted.pop(i, None)
            seq = self._seq_at_index.pop(i, None)
            if ent is not None and seq is not None and i != cfg_idx:
                requeue.append((seq, ent[0]))
        self._queue = requeue + self._queue
        self._queue_replaced()   # a prepend breaks the staging mirror
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
        self._match_snapshot = None
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
        tail_term = int(self._log_terms([last], r)[0])
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
        """Host view of the step's verified match vector with the learner
        rows filled in from the device state: ``RepInfo.match`` counts
        voters only (a learner's ack never counts toward a commit), but
        the heals and the steady flag need a learner's real progress.
        One cached (match_index, match_term) fetch a step, and none
        without learners."""
        match = self._fetch(match)
        if self.learner.any():
            if self._match_snapshot is None:
                self._match_snapshot = self._rows(torch.stack(
                    [self.state.match_index, self.state.match_term]), 1)
            mi_mt = self._match_snapshot
            lr = self.learner
            match[lr] = np.where(mi_mt[1][lr] == term, mi_mt[0][lr], 0)
        return match

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
        leader_last = int(self._rows(self.state.last_index)[r])
        self._steady = bool((match[others] >= leader_last).all())

    def _advance_commit(self, r: int, commit: int) -> None:
        """Host bookkeeping for a device-reported commit advance: stamp
        durable seqs, archive, prune buffers, commit a pending
        configuration, feed the apply stream."""
        if commit > self._row_commit[r]:
            # r's own view of the commit index, kept for every round:
            # lease reads serve the leader's local knowledge
            self._row_commit[r] = commit
        if commit <= self.commit_watermark:
            return
        if (self.roles[r] == LEADER
                and int(self.terms[r]) == int(self.lead_terms[r])):
            # an advance riding r's own round commits a current-term
            # entry: the §6.4 lease precondition
            self._lease_ok_term[r] = int(self.lead_terms[r])
        old_wm = self.commit_watermark
        slo_lat = [] if self.slo is not None else None
        now = self.clock.now
        sq_get = self._seq_at_index.get
        st_get = self.submit_time.get
        ct = self.commit_time
        need_lat = self.metrics is not None or slo_lat is not None
        for idx in range(self.commit_watermark + 1, commit + 1):
            seq = sq_get(idx)
            if seq is not None and seq not in ct:
                ct[seq] = now
                self.committed_total += 1
                lat = (now - st_get(seq, now)) if need_lat else 0.0
                if self.spans is not None:
                    self.spans.note_commit(seq, now, self._tick_count)
                if self.metrics is not None:
                    self._metric_inc("raft_commits_total")
                    self.metrics.histogram(
                        "raft_commit_latency_seconds",
                        "submit -> durable, virtual seconds", ("group",),
                    ).observe(lat, group="0")
                if slo_lat is not None:
                    slo_lat.append(lat)
        if slo_lat:
            # one vectorized digest and window update per advance
            self.slo.observe_batch("commit", slo_lat, now)
        self._archive_committed(r, self.commit_watermark + 1, commit)
        self.commit_watermark = commit
        if self.auditor is not None:
            self.auditor.note_commit(commit, self.clock.now)
        self.nodelog(r, f"commit index changed to {commit}")
        if self._pending_config is not None and self._pending_config[0] <= commit:
            idx = self._pending_config[0]
            self._pending_config = None
            self.nodelog(r, f"configuration committed at {idx}")
            # a wiped voter's identity is gone only now that its removal
            # is durable: it may restart (as a fresh learner)
            self._wiped &= self.member
            lead = self.leader_id
            if lead is not None and not self.member[lead]:
                # the leader removed itself: with the change durable it
                # steps down (§4.2.2) and the remaining voters elect
                self.roles[lead] = FOLLOWER
                self.leader_id = None
                self.nodelog(lead, "step down to follower (removed)")
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
                    or not (self.member[p] or self.learner[p]):
                continue   # unreachable replicas hear nothing
            self._last_heard[p] = self.clock.now   # §9.6 stickiness clock
            if not self.member[p]:
                continue   # learners run no election timers
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
        construction), unless the ring never held the range. Under EC the
        rows hold only shards: the rest is reconstructed from k holders
        (the leader first), or left unarchived when fewer than k hold it."""
        lead_terms = self._log_terms(np.arange(lo, hi + 1), leader)
        missing = []
        aud = self.auditor
        fed = [] if aud is not None else None
        for i, idx in enumerate(range(lo, hi + 1)):
            ent = self._uncommitted.get(idx)
            if ent is not None and ent[1] == int(lead_terms[i]):
                self.store.put(idx, ent[0], ent[1])
                if fed is not None:
                    fed.append((idx, ent[0], ent[1]))
            else:
                missing.append(idx)
        if fed:
            # the committed-prefix immutability feed: a fresh contiguous
            # run records as one lazy span; a re-archive of a recorded
            # index is compared byte for byte
            aud.note_entries(fed, self.clock.now)
        if not missing:
            return
        mlo, mhi = min(missing), max(missing)
        terms = lead_terms[mlo - lo:mhi - lo + 1]
        try:
            if self.cfg.ec_enabled:
                commits = self._rows(self.state.commit_index)
                # a donor's ring must actually HOLD the range: slots below
                # its ring floor were never written (snapshot installs)
                donors = [
                    q
                    for q in ([leader] + [
                        p for p in range(self.cfg.rows) if p != leader
                    ])
                    if self.alive[q] and int(commits[q]) >= mhi
                    and int(self._ring_floor[q]) <= mlo
                    and self.connectivity[leader, q]
                ]
                if len(donors) < self.cfg.rs_k:
                    return
                data = reconstruct(
                    self.state, self._code, donors[: self.cfg.rs_k], mlo,
                    mhi, self.t,
                )
            else:
                if int(self._ring_floor[leader]) > mlo:
                    return  # ring never held the range; archive stays short
                data = log_entries(self.state, leader, mlo, mhi, self.t)
        except ValueError:
            return
        for idx in missing:
            payload = data[idx - mlo].tobytes()
            self.store.put(idx, payload, int(terms[idx - mlo]))
            if self.auditor is not None:
                self.auditor.note_entry(
                    idx, int(terms[idx - mlo]), payload, self.clock.now
                )

    def _catchup_budget(self) -> int:
        """Chunks the catch-up lane may ship this tick: the admission
        gate's background-lane decision (throttled to 1 while the write
        lane is congested), or the configured maximum when admission is
        disabled."""
        mx = self.cfg.catchup_max_chunks_per_tick
        if self.admission is None:
            return mx
        return self.admission.catchup_chunks(len(self._queue), mx)

    def _stream_snapshot(self, replica: int, lo: int,
                         hi: int) -> Optional[int]:
        """Ship this tick's budget of snapshot chunks toward installing
        the committed range [lo, hi] (clamped to one ring capacity) into
        ``replica`` from the archive. Returns the index the replica is
        installed through after this tick (None when nothing could ship:
        an archive gap, or an empty range). Each chunk advances the
        replica's device match, so the stream resumes from the last acked
        chunk across kills, leader changes and restarts; under EC each
        chunk is re-encoded into the replica's shard row on the device
        (``ckpt.install_snapshot``, K6 encode on the card)."""
        lo = max(lo, hi - self.state.capacity + 1, 1)
        if hi < lo:
            return None
        streaming = self._shipper.is_streaming(replica)
        prev_next = (
            self._shipper.streams[replica].next if streaming else None
        )
        raise_floor = not streaming
        chunks = self._shipper.plan(
            replica, lo, hi, self._catchup_budget()
        )
        if prev_next is not None and chunks and chunks[0][0] > prev_next:
            # the ring-tail clamp overtook the acked cursor mid-stream:
            # indices [prev_next, new cursor) were SKIPPED, not installed,
            # so the validity floor must rise past the gap
            raise_floor = True
        reached = None
        for clo, chi in chunks:
            if not self.store.covers(clo, chi):
                break      # archive gap: the replica keeps waiting
            self.state = install_snapshot(
                self.state, replica, self.store.snapshot(clo, chi),
                self.leader_term, self.cfg.batch_size, self._code, self.t,
            )
            if raise_floor:
                # only [clo, ...] onward is being written; slots below
                # this stream segment's start keep whatever they held, so
                # the floor rises once per (re)based stream
                self._ring_floor[replica] = max(
                    self._ring_floor[replica], clo
                )
                raise_floor = False
            self._shipper.acked(replica, chi)
            self._metric_inc(
                "raft_snapshot_chunks_total",
                "incremental snapshot-install chunks shipped",
            )
            reached = chi
        if reached is not None:
            self._lasts_snapshot = None  # last_index moved outside a step
            self._match_snapshot = None  # ...and so did match_index
            self.nodelog(replica, f"snapshot chunk installed to {reached}")
            if reached >= hi:
                self._metric_inc("raft_snapshot_installs_total")
                self._shipper.finish(replica)
                self.nodelog(
                    replica, f"snapshot stream complete at {hi}"
                )
        return reached

    def _snapshot_heal(self, leader: int, info) -> None:
        """Snapshot install for ring-lapped replicas (plain replication).
        The repair window cannot heal a replica whose next needed index is
        below the leader's ring horizon: its verified match stays pinned
        while everyone else progresses. After two stalled ticks (one
        leadership-change transient is forgiven) the leader streams it a
        snapshot of the committed prefix (``_stream_snapshot``) until the
        repair window reaches it again."""
        cap = self.state.capacity
        match = self._effective_match(int(self.lead_terms[leader]), info.match)
        leader_last = int(self._rows(self.state.last_index)[leader])
        # the repair window cannot serve below the leader's ring-validity
        # floor either (truncated-after-wrap slots hold junk)
        horizon = max(leader_last - cap + 1, int(self._ring_floor[leader]))
        for p in range(self.cfg.rows):
            if (p == leader or not self.alive[p] or self.slow[p]
                    or not (self.member[p] or self.learner[p])
                    or not self.connectivity[leader, p]):
                # a dead replica KEEPS its stream (resume-on-recover); a
                # deconfigured row's is abandoned
                self._match_stall[p] = 0
                if not (self.member[p] or self.learner[p]):
                    self._shipper.finish(p)
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

    def _ec_heal(self, leader: int, info) -> None:
        """Two-phase repair for erasure-coded logs. Under EC there is no
        repair window (the leader holds only its own shard row), so a live
        replica that missed windows is healed instead:

        - the committed range is reconstructed from k shard holders and
          the replica's re-encoded shards installed (``heal_replica``: K6
          decode, K6 encode, install); below every donor's ring horizon
          it is streamed a snapshot from the archive instead;
        - the uncommitted suffix is re-served from the host ingest buffer
          (fewer than commit_quorum rows hold its shards, so
          reconstruction cannot), re-encoded on the device, with its terms
          checked against the leader's log so a buffer entry superseded
          across leadership changes is never installed."""
        match = self._effective_match(int(self.lead_terms[leader]), info.match)
        n, k = self.cfg.rows, self.cfg.rs_k
        leader_last = int(self._rows(self.state.last_index)[leader])
        hi_rec = self.commit_watermark
        for p in range(n):
            if (p == leader or not self.alive[p] or self.slow[p]
                    or not self.connectivity[leader, p]
                    or not (self.member[p] or self.learner[p])):
                continue
            if match[p] >= leader_last:
                continue
            lo = int(match[p]) + 1
            if lo <= hi_rec:
                # donors are the rows whose own commit covers the range:
                # committed entries are immutable, so their shards are
                # valid even where a leadership change reset their
                # current-term match
                commits = self._rows(self.state.commit_index)
                donors = [
                    q for q in range(n)
                    if self.alive[q] and int(commits[q]) >= hi_rec
                    and self.connectivity[leader, q]
                ]
                if len(donors) < k:
                    continue
                try:
                    self.state = heal_replica(
                        self.state, self._code, p, donors[:k], lo, hi_rec,
                        self.leader_term, hi_rec, self.cfg.batch_size,
                        self.t,
                    )
                    self._lasts_snapshot = None
                    self._match_snapshot = None
                    self.nodelog(p, f"healed by reconstruction to {hi_rec}")
                except ValueError:
                    # below every donor's ring horizon: stream a snapshot
                    # of the committed prefix instead; the suffix re-serve
                    # below waits until the stream completes
                    reached = self._stream_snapshot(p, lo, hi_rec)
                    if reached is None or reached < hi_rec:
                        continue
                lo = hi_rec + 1
            if lo <= leader_last:
                idx = list(range(lo, leader_last + 1))
                missing = [i for i in idx if i not in self._uncommitted]
                if missing:
                    # the buffer lost these bytes across leadership
                    # changes: k rows whose current-term match covers the
                    # suffix rebuild them (Log Matching)
                    self._refill_uncommitted_from_shards(leader, missing)
                    missing = [i for i in idx if i not in self._uncommitted]
                if missing:
                    # still unservable: abandon the suffix if some index
                    # survives on fewer than k rows anywhere, else wait
                    # for a dead holder to recover
                    if self._ec_abandon_lost_suffix(leader, missing):
                        return
                    continue
                log_terms = self._log_terms(idx, leader)
                if any(
                    self._uncommitted[i][1] != int(t)
                    for i, t in zip(idx, log_terms)
                ):
                    continue  # superseded across a leadership change
                data = np.frombuffer(
                    b"".join(self._uncommitted[i][0] for i in idx), np.uint8
                ).reshape(len(idx), self.cfg.entry_bytes)
                if self.t.local_row(p) is not None:
                    # only the ranks holding row p encode and install
                    # (on the 2-D mesh each its byte slice of the shards)
                    shards = encode_device(
                        self._code, self._dev_bytes(data))[p]
                    self.state = install_entries(
                        self.state, p, lo, shards, log_terms,
                        self.leader_term, self.commit_watermark,
                        self.cfg.batch_size, self.t,
                    )
                self._lasts_snapshot = None
                self._match_snapshot = None
                self.nodelog(p, f"suffix re-served to {leader_last}")

    def _ec_abandon_lost_suffix(self, leader: int, missing) -> bool:
        """Liveness escape for permanently unrecoverable UNCOMMITTED
        entries: if some missing index's shards survive on fewer than k
        rows in total (dead rows included), no decode can rebuild it and
        the k+margin quorum is wedged for good. The leader truncates every
        row's tail back to just below the first such index and re-queues
        the dropped entries whose bytes it still holds. Returns True if a
        truncation happened."""
        cap = self.state.capacity
        lasts = self._rows(self.state.last_index)
        lterms = self._rows(self.state.log_term)
        first_lost = None
        for i in sorted(missing):
            slot = (i - 1) % cap
            want = int(lterms[leader, slot])
            holders = sum(
                1 for q in range(self.cfg.rows)
                if int(lasts[q]) >= i
                and int(lterms[q, slot]) == want
                and int(lasts[q]) - cap + 1 <= i
                and int(self._ring_floor[q]) <= i
            )
            if holders < self.cfg.rs_k:
                first_lost = i
                break
        if first_lost is None:
            return False
        cut = first_lost - 1
        old_last = int(lasts[leader])
        n = self._truncate_uncommitted_tail(cut, lasts)
        self.nodelog(
            leader,
            f"unrecoverable uncommitted suffix [{first_lost}, {old_last}] "
            f"abandoned (< {self.cfg.rs_k} shard holders); "
            f"{n} entries re-queued",
        )
        return True

    def _refill_uncommitted_from_shards(self, leader: int, indices) -> None:
        """Rebuild lost ingest-buffer bytes for UNCOMMITTED indices from
        k replicas whose current-term verified match covers them (their
        shards agree with the leader's log by Log Matching). Does nothing
        when fewer than k such holders exist."""
        k = self.cfg.rs_k
        lo, hi = min(indices), max(indices)
        matches = self._rows(self.state.match_index)
        mterms = self._rows(self.state.match_term)
        lasts = self._rows(self.state.last_index)
        donors = [
            q for q in range(self.cfg.rows)
            if self.alive[q] and self.connectivity[leader, q]
            and int(mterms[q]) == self.leader_term
            and int(matches[q]) >= hi
            # the donor's ring must still HOLD the range: neither lapped
            # nor below its install floor
            and int(lasts[q]) - self.state.capacity + 1 <= lo
            and int(self._ring_floor[q]) <= lo
        ]
        if len(donors) < k:
            return
        data = reconstruct(self.state, self._code, donors[:k], lo, hi,
                           self.t)
        terms = self._log_terms(np.arange(lo, hi + 1), leader)
        for i in indices:
            self._uncommitted[i] = (
                data[i - lo].tobytes(), int(terms[i - lo])
            )
        self.nodelog(
            leader, f"uncommitted suffix [{lo}, {hi}] rebuilt from shards"
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
        if self._tiered_store is not None:
            # with apply consumers registered, the tiered store seals only
            # history the apply stream has consumed: the next apply index
            # never pays a segment read
            self._tiered_store.apply_cursor = self.applied_index
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
            if self.spans is not None:
                self.spans.note_apply(self.applied_index, self.clock.now)
            err: Optional[BaseException] = None
            for fn, fn_start in self._apply_fns:
                if self.applied_index >= fn_start:
                    try:
                        fn(self.applied_index, ent[0])
                    except Exception as ex:
                        err = err if err is not None else ex
            if err is not None:
                raise err
        if self._tiered_store is not None and self._apply_fns:
            self._tiered_store.apply_cursor = self.applied_index

    def _backfill_archive(self, idx: int, quiet: bool = False) -> bool:
        """Try to fill an archive gap at committed index ``idx`` from the
        current leader's ring (or from k shard holders under EC). False if
        still unavailable; a gap below every serving ring range gets one
        loud nodelog (unless ``quiet``)."""
        r = self.leader_id
        if r is None:
            return False
        # a ring serves idx only between its floor (below it the slot was
        # never written) and its horizon (below it the slot was
        # overwritten)
        lasts = self._rows(self.state.last_index)

        def serves(q: int) -> bool:
            return idx >= max(
                int(lasts[q]) - self.state.capacity + 1,
                int(self._ring_floor[q]),
            )

        if self.cfg.ec_enabled:
            commits = self._rows(self.state.commit_index)
            holders = sum(
                1 for q in range(self.cfg.rows)
                if self.alive[q] and int(commits[q]) >= idx and serves(q)
                and self.connectivity[r, q]
            )
            recoverable = holders >= self.cfg.rs_k
        else:
            recoverable = serves(r)
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
        u8[hi-lo+1, entry_bytes] from a live replica's ring; under EC the
        window is decoded from the first k live shard holders
        (``ec.reconstruct.reconstruct``: no decode when they are the data
        rows, K6 on the ring otherwise). Indices must be committed and
        still within the ring horizon."""
        if not (1 <= lo <= hi <= self.commit_watermark):
            raise ValueError(
                f"range [{lo}, {hi}] not committed "
                f"(watermark {self.commit_watermark})"
            )
        commits = self._rows(self.state.commit_index)
        lasts = self._rows(self.state.last_index)
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
        if not self.cfg.ec_enabled:
            return log_entries(self.state, holders[0], lo, hi, self.t)
        if len(holders) < self.cfg.rs_k:
            raise ValueError(
                f"need {self.cfg.rs_k} live shard holders to decode, "
                f"have {len(holders)}"
            )
        return reconstruct(
            self.state, self._code, holders[: self.cfg.rs_k], lo, hi, self.t
        )

    # ----------------------------------------------------------- persistence
    def save_checkpoint(self, path: str) -> None:
        """Write the cluster's durable state to one ``.npz`` file (the JAX
        engine's layout): per-replica term and votedFor, the
        configuration, and the archived committed tail.
        ``RaftEngine.restore`` rebuilds a working cluster from it."""
        hi = self.commit_watermark
        floor = max(1, self.store.checkpoint_floor)
        lo = self.store.covered_lo(hi, floor)
        # an interior archive hole (the EC archive gives up when donors
        # are short) would start the contiguous coverage ABOVE it: probe
        # downward first, then refuse while committed entries above the
        # compaction floor are still missing
        while lo > floor and self._backfill_archive(lo - 1, quiet=True):
            lo = self.store.covered_lo(hi, floor)
        if hi == 0:  # nothing committed yet: empty snapshot
            snap = Snapshot(
                1, 0,
                np.zeros((0, self.cfg.entry_bytes), np.uint8),
                np.zeros(0, np.int32),
            )
        elif lo > hi:
            raise RuntimeError(
                f"committed entry {hi} is not archived; refusing to write "
                "a checkpoint that would lose committed entries"
            )
        elif lo > floor:
            holes = [
                i for i in range(floor, lo) if self.store.get(i) is None
            ]
            shown = ", ".join(map(str, holes[:8])) + (
                f", ... ({len(holes)} total)" if len(holes) > 8 else ""
            )
            raise RuntimeError(
                f"committed entries {{{shown}}} are not archived and could "
                "not be recovered; refusing to write a checkpoint that "
                "would lose committed entries"
            )
        else:
            # lo == compaction floor: history below it was compacted,
            # recorded as the snapshot's base_index
            snap = self.store.snapshot(lo, hi)
        EngineCheckpoint(
            snap=snap,
            terms=self._rows(self.state.term).astype(np.int32),
            voted_for=self._rows(self.state.voted_for).astype(np.int32),
            member=self.member.copy(),
            learner=self.learner.copy(),
        ).save(path)
        if self._votelog is not None:
            # WAL rotation: the checkpoint just captured (term, votedFor)
            self._votelog.truncate()

    @classmethod
    def restore(
        cls,
        cfg: RaftConfig,
        path: str,
        transport: Optional[Transport] = None,
        trace: Optional[Callable[[str], None]] = None,
        vote_log: Optional[str] = None,
        recorder=None,
    ) -> "RaftEngine":
        """Rebuild an engine from ``save_checkpoint`` output (the port's or
        the JAX engine's): every replica restarts as a follower holding the
        archived committed tail (RS shards re-encoded on the device when
        the cluster is erasure-coded) with its persisted term and
        votedFor, overlaid with the vote log's newer transitions; then the
        normal election path takes over. Uncommitted entries are lost."""
        ck = EngineCheckpoint.load(path)
        if ck.terms.shape != (cfg.rows,):
            raise ValueError(
                f"checkpoint has {ck.terms.shape[0]} replica rows, "
                f"config has {cfg.rows}"
            )
        if ck.snap.entries.size and ck.snap.entries.shape[1] != cfg.entry_bytes:
            raise ValueError(
                f"checkpoint entry size {ck.snap.entries.shape[1]} != "
                f"config entry_bytes {cfg.entry_bytes}"
            )
        eng = cls(cfg, transport, trace=trace, recorder=recorder)
        snap = ck.snap
        if snap.last_index >= snap.base_index:
            # history below the snapshot base was compacted before the
            # checkpoint was written: a later save_checkpoint must treat
            # its absence as compaction, not as a hole to backfill
            eng.store.set_floor(snap.base_index)
            for i in range(snap.base_index, snap.last_index + 1):
                eng.store.put(
                    i,
                    snap.entries[i - snap.base_index].tobytes(),
                    int(snap.terms[i - snap.base_index]),
                )
            # verified for term 0: the next real leader's steps re-verify
            # matches in its own term
            eng.state = install_snapshot_all(
                eng.state, snap, 0, cfg.batch_size, eng._code, cfg.rows,
                eng.t,
            )
            eng.commit_watermark = snap.last_index
            # rings are seeded only from the snapshot tail that fits one
            # capacity; reads below it must go to the checkpoint store
            eng._ring_floor[:] = max(
                snap.base_index, snap.last_index - eng.state.capacity + 1
            )
        # persisted term + votedFor, overlaid with the vote log's
        # transitions newer than the checkpoint
        terms = ck.terms.astype(np.int64).copy()
        vf = ck.voted_for.astype(np.int64).copy()
        terms, vf = merge_restored(cfg.rows, terms, vf, vote_log)
        eng._set_votes(terms, vf)
        if vote_log is not None:
            eng._attach_votelog(vote_log)
        if ck.member is not None and ck.member.shape == (cfg.rows,):
            # the committed configuration outranks cfg.n_replicas: a row
            # removed before the checkpoint does not return as a voter
            eng.member = ck.member.copy()
            for r in range(cfg.rows):
                # rows that joined after the initial config need timers
                if eng.member[r] and r >= cfg.n_replicas:
                    eng._arm_follower(r)
        if ck.learner is not None and ck.learner.shape == (cfg.rows,):
            # learners resume as learners (no timers); their catch-up
            # restarts from the restored snapshot
            eng.learner = ck.learner.copy() & ~eng.member
        for r in range(cfg.rows):
            if eng.member[r]:
                eng.nodelog(
                    r, f"restored from checkpoint to {eng.commit_watermark}")
        return eng

    def commit_latencies(self) -> np.ndarray:
        """Per-entry commit latency (seconds) for every durable entry."""
        return np.array(
            [self.commit_time[s] - self.submit_time[s] for s in self.commit_time]
        )
