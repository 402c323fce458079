"""Multi-Raft: G independent consensus groups as one batched device program
(port of ``raft_tpu/multi/engine.py``, ROADMAP A14).

A sharded store (TiKV, CockroachDB) splits its keyspace over many small
Raft groups so that no single leader, log or commit stream caps
throughput. Here all G groups' state is one group-batched
``ReplicaState`` (``core.state.init_group_state``: every leaf has a
leading group axis) on one device, and the same-instant replication
rounds of every group ride ONE launch of the group program
(``core.step.group_replicate_step``, whose payload windows go through
kernel K5) instead of G host round trips:

- **device**: one ``group_replicate_step`` / ``group_vote_step`` call per
  event-loop round covers every group active in that round; the others
  are masked to the bit-exact no-op (term 0 and a dead cluster), so one
  program serves every activity subset. With ``fuse_k > 1`` a
  ``run_for``-driven drain runs K consecutive instants of every ticking
  group's rounds as one ``fused_group_scan`` launch: on the card one
  replay of a captured CUDA graph (``core.graphs.FusedGroupGraphs``, the
  counterpart of the JAX engine's ``jax.jit`` of the scan).
- **host**: one event heap drives all G groups' timers. Each group's
  control plane (roles, terms, election draws) is a column of host state
  with its OWN seeded rng stream, so a group's elections are a lone
  engine's given the same draws; groups share launches, never protocol.

Each launch's per-group operands go up as ONE packed int32 upload (the
JAX engine hands XLA one array per operand), and a round's ``max_term``,
``commit_index``, ``frontier_len``, ``match`` and ``last_index`` come
back in ONE fetch.

``seed_leaders`` campaigns replica ``g % n_replicas`` for group ``g`` in
one batched vote launch so that no replica row serializes all G commit
streams; ``rebalance`` re-spreads leadership after faults concentrate it.

Scope, as in JAX: non-EC, fixed membership (``max_replicas=None``).
Fault masks (``fail``/``set_slow``/``partition``) are per group, and
``faults.FaultPlan`` events carry an optional ``group`` scope. Committed
bytes are archived on the host per group (bounded at ``2 *
log_capacity``; with a tier configured the sweep seals RS-coded segments
instead of dropping) for the ordered apply stream (``register_apply``).

Placement (``transport.group_mesh``): with ``transport="mesh_groups"``
(or ``RAFT_TPU_GSHARD=1``) and a mesh of more than one shard
(``mesh=GroupMesh([...])``, or the visible cards), the group axis is
split into one block a shard and every launch runs on each block. The
slot table ``_slot`` (logical group -> physical slot; ``_phys_group`` its
inverse) is the identity until ``migrate_group`` swaps two groups' slots,
and every device-facing index goes through it: operands are packed in
physical order, one upload a shard, and results are read back per
logical group. Host mirrors (queues, stamps, rngs, the heap) are
logical-indexed and never move. One shard (one device, or a G the device
set cannot split) degrades to the resident layout, as in JAX.

With the same ``RaftConfig``, seed and calls, every group's nodelog
lines, terms, roles, watermarks, state leaves, committed bytes and apply
stream equal the JAX ``MultiEngine``'s, on either layout.
``MultiEngine(cfg, G)`` runs on CUDA; pass ``device="cpu"`` (and a mesh
of CPU devices to shard) to run the plain versions.
"""

from __future__ import annotations

import heapq
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.admission import Overloaded
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.graphs import (
    FusedGroupGraphs,
    pack_group_launch,
    run_group_launch,
)
from raft_tpu_torch.core.state import (
    ReplicaState,
    group_view,
    init_group_state,
    last_log_term,
    log_entries,
)
from raft_tpu_torch.core.step import (
    fused_group_scan,
    group_replicate_step,
    group_vote_step,
)
from raft_tpu_torch.raft.engine import (
    CANDIDATE,
    FOLLOWER,
    LEADER,
    VirtualClock,
)
from raft_tpu_torch.raft.ledger import (
    durable_range_covers,
    evict_commit_stamps,
)
from raft_tpu_torch.obs.compile import labeled
from raft_tpu_torch.transport.device import resolve_device


class NotLeader(Exception):
    """A leader-required group operation (``submit_to_leader``,
    ``read_index``) found no live, confirmable leader for the target
    group. Carries ``group`` so a router can retry: drive the engine
    until the group re-elects (``run_until_leader``), then resubmit
    (``multi.router.Router``). Raised out of a batched router call,
    ``partial`` carries the per-item results placed before the failure
    (None = unplaced)."""

    def __init__(self, group: int, msg: str = ""):
        super().__init__(msg or f"group {group} has no current leader")
        self.group = group
        self.partial: Optional[list] = None


class ReadLagging(Exception):
    """A follower or session read could not be served within the
    staleness bound: the chosen replica's replication cursor (or, for a
    session read, the group's apply cursor) has not passed the required
    index. ``replica`` is None for session reads; ``lag`` is entries
    short; ``retry_after_s`` hints one replication round."""

    def __init__(self, group: int, replica: Optional[int], lag: int,
                 retry_after_s: float = 0.0):
        which = ("apply stream" if replica is None
                 else f"replica {replica}")
        super().__init__(
            f"group {group}: {which} lags the required read index by "
            f"{lag} entries"
        )
        self.group = group
        self.replica = replica
        self.lag = lag
        self.retry_after_s = retry_after_s


class UnsupportedMembership(ValueError):
    """MultiEngine runs FIXED membership only: live reconfiguration
    (``max_replicas`` headroom, learners, ``add_server``/``replace``) is
    a single-group ``RaftEngine`` capability (one static row count for
    every group keeps the launch shapes fused). A ``ValueError``
    subclass, as in JAX."""


#: Transports that carry the GROUP axis, as in JAX: "single" (resident,
#: one device) and "mesh_groups" (the group axis sharded over a
#: ``transport.group_mesh.GroupMesh``). The per-row transports
#: ("tpu_mesh", "multihost") have no group dimension.
GROUP_AXIS_TRANSPORTS = ("single", "mesh_groups")


class UnsupportedGroupTransport(ValueError):
    """Typed refusal of a transport that cannot carry the group axis (a
    per-row transport, or an unknown string): names the supported set.
    The message is the JAX package's."""

    def __init__(self, transport: str):
        known = transport in ("tpu_mesh", "multihost")
        why = (
            "is a per-replica-row transport with no group axis"
            if known else "is not a known transport"
        )
        super().__init__(
            f"MultiEngine: transport {transport!r} {why}; the group "
            f"axis is supported by {GROUP_AXIS_TRANSPORTS} (see "
            "transport.group_mesh for the (group, replica) mesh layout)"
        )
        self.transport = transport
        self.supported = GROUP_AXIS_TRANSPORTS



_PROGRAMS: Dict[tuple, object] = {}


def _programs(n_replicas: int, record: bool = False) -> tuple:
    """Process-wide (replicate, vote) group programs per cluster size and
    record mode (JAX ``multi/engine.py:172``), labeled ``group.replicate``
    / ``group.vote`` for the compile plane."""
    key = (n_replicas, record)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = (
            labeled("group.replicate",
                    group_replicate_step(n_replicas, record=record)),
            labeled("group.vote",
                    group_vote_step(n_replicas, record=record)),
        )
    return _PROGRAMS[key]


def _fused_window(state: ReplicaState, host: np.ndarray, K: int, B: int,
                  W: int, graphs=None, rings=None, gids=None):
    """One fused group window on the resident layout from its packed host
    inputs: one replay of ``graphs`` (``core.graphs.FusedGroupGraphs``) on
    the card, else the eager ``fused_group_scan`` from one upload."""
    if graphs is not None:
        return graphs.run(state, host, K, B, W, rings, gids)
    R = state.term.shape[1]
    key = (R, "fused", rings is not None)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = fused_group_scan(R, record=rings is not None)
    inp = torch.from_numpy(host).to(state.device)
    return run_group_launch(_PROGRAMS[key], state, inp, K, B, W, rings,
                            gids)


#: the fused group window as the compile plane sees it (JAX
#: ``multi/engine.py:201``): a capture on the card fires under this label
_FUSED_WINDOW = labeled("group.fused", _fused_window)


class MultiEngine:
    """G Raft groups: one host event loop, one batched device program.

    The per-group surface tracks ``RaftEngine``'s (``submit`` /
    ``is_durable`` / ``run_until_committed`` / ``register_apply`` / fault
    toggles) with a leading ``g`` argument; ``multi.router.Router`` layers
    the key-routed client surface on top.
    """

    def __init__(
        self,
        cfg: RaftConfig,
        n_groups: int,
        trace: Optional[Callable[[str], None]] = None,
        recorder=None,
        mesh=None,
        device=None,
    ):
        if cfg.ec_enabled:
            raise ValueError(
                "MultiEngine does not support erasure coding; use the "
                "single-group RaftEngine for EC clusters"
            )
        if cfg.max_replicas is not None:
            raise UnsupportedMembership(
                "MultiEngine runs fixed membership; max_replicas must be "
                "None (live reconfiguration — learners, add_server, "
                "replace — is single-group RaftEngine scope)"
            )
        transport = cfg.transport
        if transport not in GROUP_AXIS_TRANSPORTS:
            raise UnsupportedGroupTransport(transport)
        if (
            transport == "single"
            and (os.environ.get("RAFT_TPU_GSHARD", "") or "0") != "0"
        ):
            # env upgrade, as RAFT_TPU_FUSE_K: degrades right back to the
            # resident layout below when the device set cannot shard G
            transport = "mesh_groups"
        if n_groups < 1:
            raise ValueError("n_groups must be >= 1")
        self.cfg = cfg
        self.G = n_groups
        R = cfg.n_replicas
        # ---- group-axis placement (transport.group_mesh) -------------
        # mesh_groups: ``mesh`` (a GroupMesh), else ``device`` alone, else
        # the visible cards. One shard degrades to the resident layout.
        self._gshard = None
        if transport == "mesh_groups":
            from raft_tpu_torch.transport.group_mesh import (
                GroupMeshTransport,
            )

            t = GroupMeshTransport(
                cfg, n_groups, mesh=mesh,
                devices=None if device is None else [device])
            self.device = t.devices[0]
            if device is not None and \
                    torch.device(device).type != self.device.type:
                raise ValueError(
                    f"device {device!r} is not the mesh's {self.device}")
            if t.n_shards > 1:
                self._gshard = t
        else:
            self.device = resolve_device(device)
        self.transport_mode = (
            "mesh_groups" if self._gshard is not None else "single"
        )
        self.n_shards = (
            self._gshard.n_shards if self._gshard is not None else 1
        )
        self._gps = n_groups // self.n_shards   # groups a shard
        self._devices = (self._gshard.devices if self._gshard is not None
                         else [self.device])   # one a shard
        self.state = init_group_state(cfg, n_groups, device=self.device)
        #   a ReplicaState on the resident layout, one block a shard
        #   (a list) on the sharded one
        if self._gshard is not None:
            self.state = self._gshard.shard_state(self.state)
        self._slot = np.arange(n_groups)
        #   logical group -> physical device slot: the identity until a
        #   migration swaps two groups' slots
        self._phys_group = np.arange(n_groups)
        #   physical slot -> logical group (the inverse table)
        self.migrations = 0
        self._replicate, self._vote = _programs(R)
        self._member = [torch.ones((self._gps, R), dtype=torch.bool,
                                   device=d) for d in self._devices]
        self._hb_payloads = None
        #   cached all-zero batch a shard (ingest-free rounds)
        self._graphs = (FusedGroupGraphs(R, self.device)
                        if all(d.type == "cuda" for d in self._devices)
                        else None)
        #   the fused window's CUDA graphs, one set a shard (None off the
        #   card, where the window runs the eager program)
        self._last_host: Dict[str, np.ndarray] = {}
        #   the last round's one host fetch: match, last_index, frontier

        self.clock = VirtualClock()
        self._trace = trace
        self.recorder = recorder
        #   obs.events.FlightRecorder (None = off): nodelog sites record
        #   typed per-group events (node "g3/Server0", ``group`` set).
        self.metrics = None
        #   obs.registry.MetricsRegistry (None = off): per-group labeled
        #   counters (elections, commits, sheds by group).
        self.hostprof = None
        #   obs.hostprof.HostProfiler (None = off): per-tick host-time
        #   attribution; a shared launch's phases are recorded once per
        #   participating group label.
        self.auditor = None
        #   obs.audit.SafetyAuditor (None = off): election wins, commit
        #   advances, archive feeds and tick boundaries audited per group
        #   from host mirrors.
        self.slo = None
        #   obs.slo.SloTracker (None = off): per-group commit and
        #   queue-delay digests with burn-rate evaluation.
        self.status_board = None
        #   obs.serve.StatusBoard (None = off): a host-only snapshot per
        #   flush for the ops HTTP endpoint.
        self.device_obs = None
        #   obs.device.DeviceObs (None = off): one event ring per group on
        #   the device, ridden by every launch, flushed as ONE packed
        #   fetch per launch (attach_device_obs).
        self._dev_rings = None
        self._dev_gids = None
        self._dev_flushed = None
        self._dev_counters_folded = None
        self._replicate_rec = self._vote_rec = None
        self._hp_groups: set = set()
        #   groups the current tick's launches served (tick_end labels)
        self.rngs = [random.Random(f"{cfg.seed}:{g}") for g in range(n_groups)]
        #   per-group rng streams: adding groups never perturbs an
        #   existing group's election schedule

        self.roles: List[List[str]] = [[FOLLOWER] * R for _ in range(n_groups)]
        self.terms = np.zeros((n_groups, R), np.int64)
        self.lead_terms = np.zeros((n_groups, R), np.int64)
        self.alive = np.ones((n_groups, R), bool)
        self.slow = np.zeros((n_groups, R), bool)
        self.connectivity = np.ones((n_groups, R, R), bool)
        self.leader_id: List[Optional[int]] = [None] * n_groups
        self.commit_watermark = np.zeros(n_groups, np.int64)

        self._queue: List[List[Tuple[int, bytes]]] = [[] for _ in range(n_groups)]
        self._admit_cap = cfg.admission_max_writes
        #   per-group bounded admission: an arrival that finds the group's
        #   queue at the bound raises ``admission.Overloaded`` (``.group``
        #   set); the Router's backoff, budget and breaker act on it
        self.shed_by_group: List[Dict[str, int]] = [
            {} for _ in range(n_groups)
        ]
        self.depth_high_water = np.zeros(n_groups, np.int64)
        self._next_seq = [1] * n_groups
        self._seq_at_index: List[Dict[int, int]] = [{} for _ in range(n_groups)]
        self._uncommitted: List[Dict[int, Tuple[bytes, int]]] = [
            {} for _ in range(n_groups)
        ]
        self._archive: List[Dict[int, bytes]] = [{} for _ in range(n_groups)]
        #   idx -> committed payload bytes, per group: the apply stream's
        #   source, swept to the last ``2 * log_capacity`` entries and
        #   never past the apply cursor (``_evict_group_history``)
        self._archive_floor = np.ones(n_groups, np.int64)
        #   first archived index still in RAM, per group
        tiered_root = (
            os.environ.get("RAFT_TPU_TIERED_DIR", "")
            or cfg.tiered_log_dir
        )
        if tiered_root:
            # one shared SegmentIO (one directory, one RS code) with
            # group-tagged segment names: the sweep seals instead of
            # dropping, so full-history replay works at bounded RAM
            import tempfile

            from raft_tpu_torch.ckpt import SegmentIO

            os.makedirs(tiered_root, exist_ok=True)
            self._tier_io: Optional[SegmentIO] = SegmentIO(
                tempfile.mkdtemp(prefix="gtier_", dir=tiered_root),
                k=cfg.segment_rs_k, m=cfg.segment_rs_m,
            )
        else:
            self._tier_io = None
        self._group_segments: List[List[Tuple[int, int]]] = [
            [] for _ in range(n_groups)
        ]
        self._tier_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._tier_cache_order: List[Tuple[int, int]] = []
        self._tier_lost: set = set()
        #   (g, lo) of segments that failed below k shards
        self.tier_stats: Dict[str, int] = {
            "segments_sealed": 0, "entries_sealed": 0,
            "segment_loads": 0, "segment_reconstructs": 0,
            "segments_lost": 0,
        }
        self.submit_time: List[Dict[int, float]] = [{} for _ in range(n_groups)]
        self.commit_time: List[Dict[int, float]] = [{} for _ in range(n_groups)]
        #   per-group bounded stamp dicts (the single engine's eviction
        #   contract per group, raft.ledger): evicted committed seqs fold
        #   into ``_durable_ranges`` so ``is_durable`` answers for all
        self.committed_total = np.zeros(n_groups, np.int64)
        self.commit_stamps_evicted = np.zeros(n_groups, np.int64)
        self._commit_stamp_cap = 2 * cfg.log_capacity
        self._durable_ranges: List[List[List[int]]] = [
            [] for _ in range(n_groups)
        ]
        self._apply_fns: List[List[Callable[[int, bytes], None]]] = [
            [] for _ in range(n_groups)
        ]
        self.applied_index = np.zeros(n_groups, np.int64)

        # ---- read scale-out plane (off by default) ----
        self.lease = None
        if cfg.read_lease:
            from raft_tpu_torch.raft.lease import LeaseTable

            # per-(group, leader row) leases keyed (g, r); the multi
            # engine has no PreVote, so (as in JAX) its lease plane
            # assumes no disruptive candidacy inside the stickiness window
            self.lease = LeaseTable(
                cfg.follower_timeout[0], cfg.clock_drift_bound
            )
        self._row_commit = np.zeros((n_groups, R), np.int64)
        self._lease_ok_term = np.full((n_groups, R), -1, np.int64)
        self._match_host = np.zeros((n_groups, R), np.int64)
        #   per-row verified-match mirror for follower-read staleness,
        #   maintained only with the read plane armed
        self._track_match = (
            cfg.read_lease or cfg.session_max_lag is not None
        )
        self.read_class_counts: List[Dict[str, int]] = [
            {} for _ in range(n_groups)
        ]

        self._q: List[Tuple[float, int, str, int, int]] = []
        #   (t, tiebreak, kind, group, replica)
        self._seq_events = 0
        self._timer_gen = np.zeros((n_groups, R), np.int64)
        self._fault_events: list = []
        self.fuse_k = max(
            1, int(os.environ.get("RAFT_TPU_FUSE_K", "") or cfg.fuse_k)
        )
        #   K-tick fusion across same-instant groups (the environment
        #   override as in the single engine)
        self.fused_launches = 0
        self.fused_ticks = 0
        for g in range(n_groups):
            for r in range(R):
                self._arm_follower(g, r)

    # ------------------------------------------------------------------ util
    def _fetch(self, x) -> np.ndarray:
        """Host copy of a device value (never a view of a CPU tensor the
        programs may later update in place)."""
        return x.detach().to("cpu", copy=True).numpy()

    def _upload(self, host: np.ndarray, shard: int = 0) -> torch.Tensor:
        """One packed int32 host array on a shard's device: a launch's
        single upload for that shard."""
        return torch.from_numpy(host).to(self._devices[shard])

    def _blocks(self) -> List[ReplicaState]:
        """The state as one block a shard (one block when resident)."""
        return self.state if self._gshard is not None else [self.state]

    def _view(self, g: int) -> ReplicaState:
        """Logical group ``g``'s unbatched state: views of its slot."""
        k, i = divmod(int(self._slot[g]), self._gps)
        return group_view(self._blocks()[k], i)

    def _whole(self, leaf: str) -> torch.Tensor:
        """A state leaf over every group in physical slot order (the
        shards' blocks joined on the first shard's device)."""
        if self._gshard is None:
            return getattr(self.state, leaf)
        return self._gshard.cat([getattr(b, leaf) for b in self.state])

    def _launch(self, kind: str, *ops):
        """One batched ``kind`` launch ("vote" or "replicate") from
        per-shard operand lists ``ops``: through the group-mesh transport
        on the sharded layout (each shard's block), the resident program
        otherwise. The state (and the device rings) are replaced; returns
        the info, group axis in physical slot order."""
        rec = self._dev_rings is not None
        ring_args = (self._dev_rings, self._dev_gids) if rec else ()
        if self._gshard is not None:
            fn = (self._gshard.request_votes if kind == "vote"
                  else self._gshard.replicate)
            out = fn(self.state, *ops, *ring_args)
        else:
            prog = {"vote": (self._vote, self._vote_rec),
                    "replicate": (self._replicate,
                                  self._replicate_rec)}[kind][rec]
            out = prog(self.state, *(o[0] for o in ops), *ring_args)
        self.state = out[0]
        if rec:
            self._dev_rings = out[2]
        return out[1]

    def nodelog(self, g: int, r: int, msg: str,
                kind: Optional[str] = None, **fields) -> str:
        """The reference nodelog schema with a group tag in the id field:
        ``[g{G}/Server{r}:Term:Commit:Last][role]msg``. With a flight
        recorder the same emission records a typed ``obs.events.Event``
        carrying ``group=g``; with neither sink no fetch is made."""
        rec = self.recorder
        if self._trace is None and rec is None:
            return ""
        gv = self._view(g)
        ci_li = self._fetch(torch.stack(
            [gv.commit_index[r], gv.last_index[r]]))
        line = (
            f"[g{g}/Server{r}:{self.terms[g, r]}:{int(ci_li[0])}:"
            f"{int(ci_li[1])}][{self.roles[g][r]}]{msg}"
        )
        if rec is not None:
            rec.record(
                node=f"g{g}/Server{r}", group=g, term=int(self.terms[g, r]),
                kind=kind, t_virtual=self.clock.now,
                state=self.roles[g][r], commit_index=int(ci_li[0]),
                last_index=int(ci_li[1]), msg=msg, **fields,
            )
        if self._trace is not None:
            self._trace(line)
        return line

    def _metric_inc(self, g: int, name: str, help_: str = "",
                    **labels) -> None:
        """Guarded per-group counter bump (no-op without a registry)."""
        if self.metrics is None:
            return
        labels.setdefault("group", str(g))
        self.metrics.counter(name, help_, tuple(labels)).inc(**labels)

    # ------------------------------------------- device observability plane
    def attach_device_obs(self, obs=None, capacity: int = 4096):
        """Attach the device plane (``obs.device``): G per-group event
        rings (one group ring, four tensors updated in place) ride every
        replicate, vote and fused launch (the recorded group programs;
        per-group states equal the unrecorded programs'), flushed as one
        packed fetch per launch. Same contract as
        ``RaftEngine.attach_device_obs``; returns the DeviceObs."""
        from raft_tpu_torch.obs.device import (
            N_COUNTERS,
            DeviceObs,
            init_group_rings,
        )

        self.device_obs = obs if obs is not None else DeviceObs(capacity)
        self.device_obs.new_epoch()
        # ring slot s records the group resident at s: the gid operand
        # carries the logical id, and a migration swaps the ring slots
        # with the state (events stay with their logical group)
        cap, gps = self.device_obs.capacity, self._gps
        rings = [init_group_rings(cap, gps, device=d) for d in self._devices]
        gids = [torch.tensor(self._phys_group[k * gps:(k + 1) * gps],
                             dtype=torch.int32, device=d)
                for k, d in enumerate(self._devices)]
        if self._gshard is None:
            rings, gids = rings[0], gids[0]
        self._dev_rings, self._dev_gids = rings, gids
        self._dev_flushed = np.zeros(self.G, np.int64)
        self._dev_counters_folded = np.zeros((self.G, N_COUNTERS), np.int64)
        R = self.cfg.n_replicas
        self._replicate_rec, self._vote_rec = _programs(R, record=True)
        return self.device_obs

    def _flush_device_obs(self) -> None:
        """Decode every group's new records from ONE packed fetch
        (i32[G, capacity + 1, REC_W], the shards' rings joined in slot
        order; group g's ring is slot ``_slot[g]``); fold per-group
        counter deltas into the registry (``raft_device_*``)."""
        if self.device_obs is None or self._dev_rings is None:
            return
        from raft_tpu_torch.obs.device import (
            COUNTER_METRICS,
            decode_records,
            packed_flush,
        )

        if self._gshard is None:
            packed = self._fetch(packed_flush(self._dev_rings))
        else:
            packed = self._fetch(self._gshard.cat(
                [packed_flush(r) for r in self._dev_rings]))
        for g in range(self.G):
            events, count, lost, counters, _tick = decode_records(
                packed[self._slot[g]], int(self._dev_flushed[g]),
                t_virtual=self.clock.now,
            )
            if count == self._dev_flushed[g] and not np.any(
                counters - self._dev_counters_folded[g]
            ):
                continue
            self.device_obs.ingest(
                events, total=count, lost=lost, counters=counters, group=g,
            )
            self._dev_flushed[g] = count
            if self.metrics is not None:
                for i, name in enumerate(COUNTER_METRICS):
                    delta = int(
                        counters[i] - self._dev_counters_folded[g][i]
                    )
                    if delta:
                        self.metrics.counter(
                            name, "on-device protocol counter", ("group",)
                        ).inc(delta, group=str(g))
            self._dev_counters_folded[g] = counters

    def _push(self, t: float, kind: str, g: int, r: int) -> None:
        heapq.heappush(self._q, (t, self._seq_events, kind, g, r))
        self._seq_events += 1

    def _arm_follower(self, g: int, r: int) -> None:
        self._timer_gen[g, r] += 1
        lo, hi = self.cfg.follower_timeout
        self._push(
            self.clock.now + self.rngs[g].uniform(lo, hi),
            f"e:{self._timer_gen[g, r]}", g, r,
        )

    def _arm_candidate(self, g: int, r: int) -> None:
        self._timer_gen[g, r] += 1
        lo, hi = self.cfg.candidate_timeout
        self._push(
            self.clock.now + self.rngs[g].uniform(lo, hi),
            f"c:{self._timer_gen[g, r]}", g, r,
        )

    def _reach(self, g: int, src: int) -> np.ndarray:
        return self.alive[g] & self.connectivity[g, src]

    # ------------------------------------------------------------- client API
    def submit(self, g: int, payload: bytes) -> int:
        """Queue one entry on group ``g``; returns its per-group sequence
        number, durable once ``is_durable(g, seq)`` (entries in flight
        across a leadership change may be dropped and never read
        durable). With ``cfg.admission_max_writes`` set, an arrival that
        finds the group's queue at the bound raises ``Overloaded``
        (``.group`` set) before anything is queued."""
        if len(payload) != self.cfg.entry_bytes:
            raise ValueError(
                f"payload must be exactly {self.cfg.entry_bytes} bytes"
            )
        depth = len(self._queue[g])
        self.depth_high_water[g] = max(int(self.depth_high_water[g]), depth)
        if self._admit_cap is not None and depth >= self._admit_cap:
            shed = self.shed_by_group[g]
            shed["depth"] = shed.get("depth", 0) + 1
            self._metric_inc(g, "raft_sheds_total", reason="depth")
            raise Overloaded(
                "depth", self.cfg.heartbeat_period,
                f"group {g} write queue at bound {self._admit_cap}",
                group=g,
            )
        seq = self._next_seq[g]
        self._next_seq[g] += 1
        self._queue[g].append((seq, payload))
        self.submit_time[g][seq] = self.clock.now
        return seq

    def submit_to_leader(self, g: int, payload: bytes) -> int:
        """``submit`` that refuses (``NotLeader``) when the group has no
        routed leader: the router's entry point."""
        r = self.leader_id[g]
        if r is None or self.roles[g][r] != LEADER or not self.alive[g, r]:
            raise NotLeader(g)
        return self.submit(g, payload)

    def is_durable(self, g: int, seq: int) -> bool:
        if seq in self.commit_time[g]:
            return True
        return durable_range_covers(self._durable_ranges[g], seq)

    def read_index(self, g: int, r: Optional[int] = None) -> int:
        """Per-group ReadIndex (dissertation §6.4): confirm group ``g``'s
        leadership with one empty quorum round and return the commit
        index the read may serve at. ``NotLeader`` when there is no live
        leader, it is deposed during confirmation, or a member majority
        is unreachable."""
        if r is None:
            r = self.leader_id[g]
        if r is None or self.roles[g][r] != LEADER or not self.alive[g, r]:
            raise NotLeader(g)
        term = int(self.lead_terms[g, r])
        if int(self.terms[g, r]) > term:
            self._step_down_leader(g, r, int(self.terms[g, r]))
            raise NotLeader(g, f"group {g} leader deposed (higher term seen)")
        eff = self._reach(g, r)
        if int(eff.sum()) <= self.cfg.n_replicas // 2:
            raise NotLeader(
                g, f"group {g}: quorum unreachable "
                f"({int(eff.sum())} of {self.cfg.n_replicas})"
            )
        read_idx = int(self.commit_watermark[g])
        max_terms, commits = self._replicate_round({g: (r, term, 0, None)})
        if int(max_terms[g]) > term:
            self._step_down_leader(g, r, int(max_terms[g]))
            raise NotLeader(g, f"group {g} leader deposed during confirmation")
        self.terms[g][eff] = np.maximum(self.terms[g][eff], term)
        self._advance_commit(g, r, int(commits[g]))
        self._lease_renew(g, r, term, eff, int(max_terms[g]))
        if self._track_match:
            # the confirmation round carries every row's verified match:
            # a pure-read workload still warms the replica spread
            self._match_host[g] = self._last_host["match"][g]
        self._reset_heard_timers(g, r)
        return read_idx

    # -------------------------------------------------- read scale-out
    def _lease_renew(self, g: int, r: int, term: int, eff,
                     max_term: int) -> None:
        """A quorum round sourced at (g, r) completed: renew the lease
        when it reached a replica majority and heard no higher term."""
        if self.lease is None or max_term > term:
            return
        if int(eff.sum()) <= self.cfg.n_replicas // 2:
            return
        self.lease.grant((g, r), term, self.clock.now)

    def lease_read_index(self, g: int) -> Optional[int]:
        """Zero-round local read index for group ``g``'s routed leader, or
        None when the lease cannot serve (plane off, stale lease, higher
        term seen, no current-term commit yet)."""
        if self.lease is None:
            return None
        r = self.leader_id[g]
        if r is None or self.roles[g][r] != LEADER or not self.alive[g, r]:
            return None
        term = int(self.lead_terms[g, r])
        if int(self.terms[g, r]) > term:
            return None
        if int(self._lease_ok_term[g, r]) != term:
            return None
        if not self.lease.valid((g, r), term, self.clock.now):
            return None
        return int(self._row_commit[g, r])

    def certified_read_index(self, g: int) -> Tuple[int, str]:
        """``(index, "lease")`` on a valid lease, else one ReadIndex round:
        ``(index, "read_index")``; ``NotLeader`` as ``read_index``."""
        idx = self.lease_read_index(g)
        if idx is not None:
            return idx, "lease"
        return self.read_index(g), "read_index"

    def follower_read_index(self, g: int, r: int) -> Tuple[int, str]:
        """Follower-served ReadIndex: the leader certifies once (lease or
        one round), and follower ``r`` may serve only once its verified
        cursor has passed the index (``ReadLagging`` otherwise)."""
        idx, cert = self.certified_read_index(g)
        lead = self.leader_id[g]
        if r == lead:
            return idx, cert
        if not self.alive[g, r]:
            raise ReadLagging(g, r, lag=idx,
                              retry_after_s=self.cfg.heartbeat_period)
        match = int(self._match_host[g, r])
        if match < idx:
            raise ReadLagging(g, r, lag=idx - match,
                              retry_after_s=self.cfg.heartbeat_period)
        return idx, "follower"

    def session_read_index(self, g: int, floor: int) -> int:
        """Session-consistent read index: serve from the group's APPLIED
        state with no leader contact once the apply cursor has passed the
        client's session floor (``ReadLagging`` with ``replica=None``
        otherwise)."""
        idx = int(self.applied_index[g])
        if idx < floor:
            raise ReadLagging(g, None, lag=floor - idx,
                              retry_after_s=self.cfg.heartbeat_period)
        return idx

    def replica_lag(self, g: int, r: int, idx: int) -> int:
        """Entries replica ``(g, r)``'s verified cursor lags ``idx`` (0 =
        it may serve a read certified at ``idx``). The match mirror arms
        itself on the first call; until it warms, non-leader rows read as
        lagging."""
        if r == self.leader_id[g]:
            return 0
        if not self._track_match:
            self._track_match = True
        if not self.alive[g, r]:
            return idx
        return max(0, idx - int(self._match_host[g, r]))

    def note_read_class(self, g: int, cls: str) -> None:
        """One read SERVED on group ``g`` under ``cls``: host counter,
        ``raft_reads_total{class,group}``, per-class SLO digest."""
        cc = self.read_class_counts[g]
        cc[cls] = cc.get(cls, 0) + 1
        self._metric_inc(g, "raft_reads_total", "reads served by class",
                         **{"class": cls})
        if self.slo is not None:
            self.slo.observe(f"read_{cls}", 0.0, self.clock.now, group=g)

    def set_lease_rate(self, g: int, r: int, rate: float) -> None:
        """Clock-skew injection: (g, r)'s lease clock runs at ``rate``."""
        if self.lease is not None:
            self.lease.set_rate((g, r), rate)

    # ------------------------------------------------- leadership placement
    def seed_leaders(self) -> None:
        """Round-robin leadership seeding: replica ``g % n_replicas``
        campaigns for every leaderless group ``g``, all in ONE batched
        vote launch; the winners' first ticks share one instant."""
        cands = []
        for g in range(self.G):
            if self.leader_id[g] is not None:
                continue
            r = g % self.cfg.n_replicas
            if not self.alive[g, r]:
                continue
            self.roles[g][r] = CANDIDATE
            self.terms[g, r] += 1
            self.nodelog(g, r, "state changed to candidate (seeded)")
            cands.append((g, r))
        if cands:
            self._campaign_many(cands)

    def rebalance(self, max_moves: Optional[int] = None) -> int:
        """Campaign each group's round-robin target where leadership has
        drifted, skipping a target whose log is not §5.4.1 up to date
        with every reachable member (its lost campaign would depose the
        incumbent for nothing). Returns the campaigns attempted."""
        cands = []
        for g in range(self.G):
            target = g % self.cfg.n_replicas
            cur = self.leader_id[g]
            if cur is None or cur == target:
                continue
            if not self.alive[g, target] or not self.connectivity[g, target, cur]:
                continue
            eff = self._reach(g, target)
            if int(eff.sum()) <= self.cfg.n_replicas // 2:
                continue
            gv = self._view(g)
            lasts, lterms = self._fetch(
                torch.stack([gv.last_index, last_log_term(gv)]))
            tkey = (int(lterms[target]), int(lasts[target]))
            if any(
                (int(lterms[p]), int(lasts[p])) > tkey
                for p in np.flatnonzero(eff)
            ):
                continue  # target would lose the up-to-date check
            self.roles[g][target] = CANDIDATE
            self.terms[g, target] = int(self.terms[g].max()) + 1
            self.nodelog(g, target, "state changed to candidate (rebalance)")
            cands.append((g, target))
            if max_moves is not None and len(cands) >= max_moves:
                break
        if cands:
            self._campaign_many(cands)
        return len(cands)

    def leader_spread(self) -> Dict[int, int]:
        """replica row -> number of groups it currently leads."""
        out: Dict[int, int] = {}
        for lid in self.leader_id:
            if lid is not None:
                out[lid] = out.get(lid, 0) + 1
        return out

    # ------------------------------------------------- group placement
    def shard_of(self, g: int) -> int:
        """Physical shard currently holding logical group ``g`` (block
        layout over the ``gshard`` axis; always 0 on the resident
        layout)."""
        if self._gshard is None:
            return 0
        return int(self._slot[g]) // self._gps

    def groups_on_shard(self, shard: int) -> List[int]:
        """Logical groups resident on ``shard``, in slot order."""
        if self._gshard is None:
            return list(range(self.G)) if shard == 0 else []
        gps = self._gps
        return [int(self._phys_group[s])
                for s in range(shard * gps, (shard + 1) * gps)]

    def migrate_group(
        self,
        g: int,
        dst_shard: int,
        partner: Optional[int] = None,
        catch_up_s: Optional[float] = None,
    ) -> Optional[dict]:
        """Move logical group ``g`` onto ``dst_shard`` by swapping slots
        with a ``partner`` group resident there (JAX
        ``multi/engine.py:918``), in three stages:

        1. **catch-up**: drive the event loop for a bounded window
           (default two heartbeats) until neither group has uncommitted
           bookkeeping, so the move lands between rounds. Best-effort:
           the move is safe regardless.
        2. **install**: the two groups' slots swap on the devices, state
           and event-ring slices (``GroupMeshTransport.swap_slots``, in
           place); each group's rings, terms, votes and match state move
           whole, so no divergent copy exists.
        3. **release**: the placement tables swap and the ring gid map
           follows. Host mirrors are logical-indexed and never move.

        Returns a summary dict, or None when ``g`` already lives on
        ``dst_shard``. Raises on the resident layout (one shard)."""
        if self._gshard is None:
            raise ValueError(
                "migrate_group needs the sharded layout "
                "(transport='mesh_groups' with >1 shard); the resident "
                "path has a single shard"
            )
        if not (0 <= dst_shard < self.n_shards):
            raise ValueError(
                f"dst_shard {dst_shard} out of range "
                f"[0, {self.n_shards})"
            )
        src = self.shard_of(g)
        if src == dst_shard:
            return None
        if partner is None:
            # deterministic choice: the destination group with the least
            # queued work (ties by group id), the cheapest to bounce back
            partner = min(
                self.groups_on_shard(dst_shard),
                key=lambda gg: (len(self._queue[gg]), gg),
            )
        elif self.shard_of(partner) != dst_shard:
            raise ValueError(
                f"partner group {partner} is not on shard {dst_shard}"
            )
        t0 = self.clock.now
        # ---- 1. catch-up (bounded, best-effort) ----------------------
        window = (
            catch_up_s if catch_up_s is not None
            else 2 * self.cfg.heartbeat_period
        )
        end = self.clock.now + window
        while (
            (self._uncommitted[g] or self._seq_at_index[g]
             or self._uncommitted[partner] or self._seq_at_index[partner])
            and self.clock.now < end and self._q
        ):
            self.step_event()
        # ---- 2. install: the two slots swap on the devices -----------
        sa, sb = int(self._slot[g]), int(self._slot[partner])
        perm = np.arange(self.G)
        perm[[sa, sb]] = [sb, sa]
        self.state = self._gshard.swap_slots(self.state, perm)
        if self._dev_rings is not None:
            self._dev_rings = self._gshard.swap_ring_slots(
                self._dev_rings, perm
            )
        # ---- 3. release: placement tables + decode maps --------------
        self._slot[g], self._slot[partner] = sb, sa
        self._phys_group[sa], self._phys_group[sb] = (
            self._phys_group[sb], self._phys_group[sa],
        )
        if self._dev_rings is not None:
            # in place: a captured graph keeps reading the same tensor
            for s in (sa, sb):
                k, i = divmod(s, self._gps)
                self._dev_gids[k][i] = int(self._phys_group[s])
        self.migrations += 1
        self._metric_inc(g, "raft_group_migrations_total",
                         "group moves between shards")
        self.nodelog(
            g, self.leader_id[g] if self.leader_id[g] is not None else 0,
            f"migrated shard {src} -> {dst_shard} "
            f"(partner g{partner})", kind="migrate",
        )
        return {
            "group": g, "partner": partner, "src": src,
            "dst": dst_shard, "t_start": t0, "t_done": self.clock.now,
            "catch_up_s": round(self.clock.now - t0, 6),
        }

    # ---------------------------------------------------------- fault toggles
    def fail(self, g: int, r: int) -> None:
        self.alive[g, r] = False
        if self.leader_id[g] == r:
            self.leader_id[g] = None
        self.roles[g][r] = FOLLOWER
        if self.lease is not None:
            self.lease.break_((g, r))
        self.nodelog(g, r, "killed")

    def recover(self, g: int, r: int) -> None:
        self.alive[g, r] = True
        self.roles[g][r] = FOLLOWER
        self.nodelog(g, r, "recovered")
        self._arm_follower(g, r)

    def set_slow(self, g: int, r: int, is_slow: bool) -> None:
        self.slow[g, r] = is_slow

    def partition(self, g: int, groups) -> None:
        """Link-level partition of group ``g``'s replicas (the single
        engine's semantics, scoped to one group): ``groups`` must cover
        every replica exactly once."""
        R = self.cfg.n_replicas
        listed = sorted(x for grp in groups for x in grp)
        if listed != list(range(R)):
            raise ValueError(
                "groups must cover every replica exactly once (no "
                "repeats, no gaps)"
            )
        self.connectivity[g] = False
        for grp in groups:
            for a in grp:
                for b in grp:
                    self.connectivity[g, a, b] = True
        self.nodelog(g, 0, f"partition installed: {[sorted(x) for x in groups]}")

    def heal_partition(self, g: int) -> None:
        self.connectivity[g] = True
        self.nodelog(g, 0, "partition healed")

    def schedule_faults(self, plan) -> None:
        """Merge a ``faults.FaultPlan`` into the heap. An event's optional
        ``group`` scopes it to one group; ``None`` hits every group."""
        base = len(self._fault_events)
        self._fault_events.extend(plan.events)
        for i, ev in enumerate(plan.events):
            self._push(ev.t, f"f:{base + i}", -1, ev.replica)

    def _fire_fault(self, idx: int) -> None:
        ev = self._fault_events[idx]
        targets = range(self.G) if ev.group is None else (ev.group,)
        for g in targets:
            {
                "kill": lambda p: self.fail(g, p),
                "recover": lambda p: self.recover(g, p),
                "slow": lambda p: self.set_slow(g, p, True),
                "unslow": lambda p: self.set_slow(g, p, False),
                "campaign": lambda p: self.force_campaign(g, p),
                "partition": lambda p: self.partition(g, ev.groups),
                "heal_partition": lambda p: self.heal_partition(g),
            }[ev.action](ev.replica)

    def force_campaign(self, g: int, r: int) -> None:
        if not self.alive[g, r]:
            return
        if self.roles[g][r] == LEADER and self.leader_id[g] == r:
            return
        self.roles[g][r] = CANDIDATE
        self.terms[g, r] += 1
        self.nodelog(g, r, "state changed to candidate (injected)")
        self._campaign_many([(g, r)])

    # ------------------------------------------------------------- event loop
    def step_event(self, horizon: Optional[float] = None) -> bool:
        """Advance the clock to the next timer and handle it. Leader ticks
        of the SAME virtual instant are drained together into one batched
        launch; with ``fuse_k > 1`` and a ``horizon`` (``run_for``), K
        consecutive such instants fuse into one K-tick launch whenever
        the window provably holds nothing else (``_fire_fused_window``)."""
        fired = self._step_event_inner(horizon)
        if fired:
            # online plane: per-flush invariant scan, SLO evaluation and
            # status publish, from host mirrors only
            if self.auditor is not None:
                t = self.clock.now
                for g in range(self.G):
                    self.auditor.note_state(
                        self.terms[g], int(self.commit_watermark[g]), t,
                        group=g, node_prefix=f"g{g}/Server",
                    )
            if self.slo is not None:
                self.slo.maybe_evaluate(self.clock.now)
            if self.status_board is not None:
                self.status_board.publish(self._status_snapshot())
        return fired

    def _status_snapshot(self) -> dict:
        """The ``/status`` snapshot (obs.serve), host mirrors only:
        per-group leader map, watermarks, replication lag, queue depths,
        placement."""
        snap = {
            "t_virtual": self.clock.now,
            "groups": self.G,
            "leaders": {
                str(g): (
                    {
                        "replica": self.leader_id[g],
                        "term": int(
                            self.lead_terms[g, self.leader_id[g]]
                        ),
                    }
                    if self.leader_id[g] is not None else None
                )
                for g in range(self.G)
            },
            "terms": {
                str(g): [int(x) for x in self.terms[g]]
                for g in range(self.G)
            },
            "commit_watermark": {
                str(g): int(self.commit_watermark[g])
                for g in range(self.G)
            },
            "applied_index": {
                str(g): int(self.applied_index[g])
                for g in range(self.G)
            },
            "replication_lag": {
                str(g): len(self._seq_at_index[g])
                for g in range(self.G)
            },
            "queue_depth": {
                str(g): len(self._queue[g]) for g in range(self.G)
            },
            "leader_spread": {
                str(r): n for r, n in self.leader_spread().items()
            },
            "fused": {
                "launches": self.fused_launches,
                "ticks": self.fused_ticks,
            },
            "transport": self.transport_mode,
            "shards": self.n_shards,
            "placement": {
                str(g): self.shard_of(g) for g in range(self.G)
            },
            "migrations": self.migrations,
        }
        if self.lease is not None or any(self.read_class_counts):
            by_class: Dict[str, int] = {}
            for cc in self.read_class_counts:
                for cls, cnt in cc.items():
                    by_class[cls] = by_class.get(cls, 0) + cnt
            reads: dict = {"by_class": by_class}
            if self.lease is not None:
                reads["lease"] = {
                    "grants": self.lease.grants,
                    "duration_s": self.lease.effective_duration_s,
                    "valid_groups": sum(
                        1 for g in range(self.G)
                        if self.lease_read_index(g) is not None
                    ),
                }
            snap["reads"] = reads
        if self.slo is not None:
            snap["slo_alerts"] = [
                {"slo": a.slo, "group": a.group, "severity": a.severity,
                 "burn_rate": a.burn_rate}
                for a in self.slo.active_alerts()
            ]
        if self._tier_io is not None:
            snap["tiered"] = {
                "groups_with_segments": sum(
                    1 for segs in self._group_segments if segs
                ),
                "cache_bytes": self._tier_host_bytes(),
                **self.tier_stats,
            }
        if self.auditor is not None:
            snap["audit"] = self.auditor.summary()
        return snap

    def _step_event_inner(self, horizon: Optional[float] = None) -> bool:
        if not self._q:
            return False
        hp = self.hostprof
        if hp is not None:
            hp.tick_begin()
        t, _, kind, g, r = heapq.heappop(self._q)
        self.clock.now = max(self.clock.now, t)
        tag, _, gen = kind.partition(":")
        if tag == "l":
            ticks = [(g, r)]
            while self._q and self._q[0][0] == t and self._q[0][2] == "l":
                _, _, _, g2, r2 = heapq.heappop(self._q)
                ticks.append((g2, r2))
            if hp is not None:
                hp.mark("heap_pop")
                self._hp_groups = set()
            if not (
                self.fuse_k > 1 and horizon is not None
                and self._fire_fused_window(ticks, horizon)
            ):
                self._fire_leader_ticks(ticks)
            if hp is not None:
                hp.tick_end(
                    groups=sorted(str(gg) for gg in self._hp_groups)
                    or [str(gg) for gg, _ in ticks[:1]]
                )
            return True
        if hp is not None:
            hp.mark("heap_pop")
        if tag in ("e", "c") and int(gen) != self._timer_gen[g, r]:
            if hp is not None:
                hp.tick_end(groups=(str(g),))
            return True  # stale timer generation
        if tag == "e":
            self._fire_follower(g, r)
        elif tag == "c":
            self._fire_candidate(g, r)
        elif tag == "f":
            self._fire_fault(int(gen))
        if hp is not None:
            # fault events carry g=-1 (no owning group): no series
            hp.tick_end(groups=(str(g),) if tag != "f" else ())
        return True

    def run_for(self, seconds: float, max_events: int = 100_000) -> None:
        end = self.clock.now + seconds
        for _ in range(max_events):
            if not self._q or self._q[0][0] > end:
                break
            self.step_event(horizon=end)
        self.clock.now = max(self.clock.now, end)

    def run_until_leader(self, g: int, limit: float = 600.0) -> int:
        end = self.clock.now + limit
        while self.leader_id[g] is None and self.clock.now < end and self._q:
            self.step_event()
        if self.leader_id[g] is None:
            raise NotLeader(g, f"group {g}: no leader within {limit}s")
        return self.leader_id[g]

    def run_until_committed(self, g: int, seq: int, limit: float = 600.0) -> None:
        end = self.clock.now + limit
        while (
            not self.is_durable(g, seq) and self.clock.now < end and self._q
        ):
            self.step_event()
        assert self.is_durable(g, seq), (
            f"group {g} seq {seq} not committed "
            f"(watermark {self.commit_watermark[g]})"
        )

    # ----------------------------------------------------------- role actions
    def _fire_follower(self, g: int, r: int) -> None:
        if not self.alive[g, r] or self.roles[g][r] != FOLLOWER:
            return
        self.roles[g][r] = CANDIDATE
        self.terms[g, r] += 1
        self.nodelog(g, r, "state changed to candidate")
        self._campaign_many([(g, r)])

    def _fire_candidate(self, g: int, r: int) -> None:
        if not self.alive[g, r] or self.roles[g][r] != CANDIDATE:
            return
        self.terms[g, r] += 1
        self._campaign_many([(g, r)])

    def _campaign_many(self, cands: List[Tuple[int, int]]) -> None:
        """One batched vote launch for every (group, candidate) pair;
        groups without a campaign are masked to the no-op. The operands
        go up as one packed array a shard, in physical slot order, and
        the votes and max terms come back in one fetch, read per logical
        group through the slot table."""
        R, gps = self.cfg.n_replicas, self._gps
        host = np.zeros((self.n_shards, 2 + R, gps), np.int32)
        #   per shard, rows: candidates, terms, then the reach planes
        #   transposed
        for g, r in cands:
            k, i = divmod(int(self._slot[g]), gps)
            host[k, 0, i] = r
            host[k, 1, i] = int(self.terms[g, r])
            host[k, 2:, i] = self._reach(g, r)
        inps = [self._upload(host[k], k) for k in range(self.n_shards)]
        info = self._launch("vote", [x[0] for x in inps],
                            [x[1] for x in inps],
                            [x[2:].t() != 0 for x in inps])
        if self._dev_rings is not None:
            self._flush_device_obs()
        votes, max_terms = self._fetch(torch.stack(
            [info.votes, info.max_term]))[:, self._slot]
        # the packed operands, logical order
        plan = host.transpose(1, 0, 2).reshape(2 + R, self.G)[:, self._slot]
        eff = plan[2:].T != 0
        for g, r in cands:
            cand_term = int(plan[1, g])
            e = eff[g]
            self.terms[g][e] = np.maximum(self.terms[g][e], cand_term)
            if int(max_terms[g]) > cand_term:
                self.terms[g, r] = int(max_terms[g])
                self.roles[g][r] = FOLLOWER
                self._arm_follower(g, r)
                continue
            if int(votes[g]) > R // 2:
                if self.leader_id[g] != r:
                    # a different winner's log may diverge above the
                    # watermark: uncommitted index->seq mappings read as
                    # lost (their submit stamps go too); the ingest-byte
                    # buffer stays (the archive term-checks it)
                    wm = int(self.commit_watermark[g])
                    old_map = self._seq_at_index[g]
                    self._seq_at_index[g] = {
                        i: s for i, s in old_map.items() if i <= wm
                    }
                    for i, s in old_map.items():
                        if i > wm:
                            self.submit_time[g].pop(s, None)
                self.roles[g][r] = LEADER
                self.leader_id[g] = r
                self.lead_terms[g, r] = cand_term
                for p in range(R):
                    if (
                        p != r and self.roles[g][p] == LEADER
                        and self.connectivity[g, r, p]
                    ):
                        self.roles[g][p] = FOLLOWER
                        self._arm_follower(g, p)
                self.nodelog(g, r, "state changed to leader")
                if self.auditor is not None:
                    self.auditor.note_elect(
                        f"g{g}/Server{r}", cand_term, self.clock.now,
                        group=g,
                    )
                self._metric_inc(g, "raft_elections_total")
                self._push(self.clock.now, "l", g, r)
            else:
                self._arm_candidate(g, r)

    def _step_down_leader(self, g: int, r: int, max_term: int) -> None:
        self.roles[g][r] = FOLLOWER
        self.terms[g, r] = max_term
        if self.leader_id[g] == r:
            self.leader_id[g] = None
        if self.lease is not None:
            self.lease.break_((g, r))
        self.nodelog(g, r, "step down to follower")
        self._arm_follower(g, r)

    def _replicate_round(self, active: Dict[int, tuple]):
        """One batched replicate launch. ``active``: g -> (leader, term,
        take, u8[take, entry_bytes] batch or None). One packed upload a
        shard carries counts, leaders, terms, the reach and slow planes
        and (when anything is ingested) the untiled payload words, tiled
        to the lane layout on the device, all in physical slot order; ONE
        fetch brings back the round's max_term, commit_index,
        frontier_len, match and last_index (``_last_host``, logical
        order). Returns (max_term[G], commit[G]) on the host; ingest
        bookkeeping is the caller's."""
        cfg = self.cfg
        R, B, W = cfg.n_replicas, cfg.batch_size, cfg.shard_words
        n, gps = self.n_shards, self._gps
        hp = self.hostprof
        if hp is not None:
            hp.mark("host_pre")
            self._hp_groups.update(active)
        ingest = any(take for (_, _, take, _) in active.values())
        small = 3 * gps + 2 * gps * R
        host = np.zeros((n, small + (gps * B * W if ingest else 0)),
                        np.int32)
        if ingest:
            pays = host[:, small:].reshape(n, gps, B, W)
            for g, (_, _, take, data) in active.items():
                if take:
                    k, i = divmod(int(self._slot[g]), gps)
                    pays[k, i, :take] = np.ascontiguousarray(data).view(
                        np.int32)
        if hp is not None:
            hp.mark("pack")
        head = host[:, :3 * gps].reshape(n, 3, gps)  # counts, leaders, terms
        eff = host[:, 3 * gps:small].reshape(n, 2, gps, R)  # reach, slow
        for g, (r, term, take, _) in active.items():
            k, i = divmod(int(self._slot[g]), gps)
            head[k, :, i] = (take, r, term)
            eff[k, 0, i] = self._reach(g, r)
        eff[:, 1] = self.slow[self._phys_group].reshape(n, gps, R)
        if hp is not None:
            hp.mark("host_pre")
        inps = [self._upload(host[k], k) for k in range(n)]
        planes = [x[3 * gps:small].view(2, gps, R) != 0 for x in inps]
        if ingest:
            payloads = [x[small:].view(gps, B, W).repeat(1, 1, R)
                        for x in inps]
        else:
            # heartbeat / read-confirmation round: one device-resident
            # zero batch a shard instead of a fresh (G, B, R*W) buffer
            if self._hb_payloads is None:
                self._hb_payloads = [
                    torch.zeros((gps, B, R * W), dtype=torch.int32,
                                device=d) for d in self._devices]
            payloads = self._hb_payloads
        info = self._launch(
            "replicate", payloads, [x[:gps] for x in inps],
            [x[gps:2 * gps] for x in inps], [x[2 * gps:3 * gps] for x in inps],
            [p[0] for p in planes], [p[1] for p in planes], self._member)
        if hp is not None:
            hp.mark("dispatch")
            hp.sync(info.max_term, info.commit_index)
        # device-obs flush after the profiler marks (its packed fetch
        # syncs; inside the dispatch window it would misattribute)
        self._flush_device_obs()
        out = self._fetch(torch.cat([
            torch.stack([info.max_term, info.commit_index,
                         info.frontier_len], dim=1),
            info.match, self._whole("last_index")], dim=1))[self._slot]
        self._last_host = {"match": out[:, 3:3 + R],
                           "last": out[:, 3 + R:],
                           "frontier": out[:, 2]}
        return out[:, 0], out[:, 1]

    def _fused_heap_bound(self, ticking: Dict[int, int]) -> float:
        """Earliest heap event the fused window must not run past: stale
        timers and the participating groups' follower timers (re-armed by
        the window's first tick) are ignorable; anything of another
        group, a fault-plan event or an unexpected role's timer bounds
        the window."""
        bound = float("inf")
        for (te, _seq, kind, g, row) in self._q:
            tag, _, gen = kind.partition(":")
            if tag in ("e", "c") and g in ticking:
                if int(gen) != self._timer_gen[g, row]:
                    continue                       # stale: no-op pop
                if (tag == "e" and row != ticking[g]
                        and self.roles[g][row] == FOLLOWER):
                    continue                       # re-armed by tick 1
                if tag == "c" and self.roles[g][row] != CANDIDATE:
                    continue                       # draw-free no-op pop
            bound = min(bound, te)
        return bound

    def _fire_fused_window(self, ticks: List[Tuple[int, int]],
                           horizon: float) -> bool:
        """This instant's leader ticks as one fused K-tick window, ONE
        ``fused_group_scan`` launch (one graph replay on the card) over
        every ticking group's next K rounds, when the eligibility proof
        holds: each ticking group has a routed current-term leader with
        its group's highest term, no other live role, every row alive,
        connected and caught up to a fully committed log, and the window
        holds no other heap event. The booking replays the tick path's
        bookkeeping exactly (``_book_fused_window``). False = tick path."""
        cfg = self.cfg
        G, R, B, W = self.G, cfg.n_replicas, cfg.batch_size, cfg.shard_words
        hb = cfg.heartbeat_period
        if len(ticks) != len({g for g, _ in ticks}):
            return False                 # same-group split-brain instant
        ticking = {g: r for g, r in ticks}
        for g, r in ticks:
            if (self.leader_id[g] != r or self.roles[g][r] != LEADER
                    or not self.alive[g, r]):
                return False
            term = int(self.lead_terms[g, r])
            if int(self.terms[g].max()) > term:
                return False
            if any(p != r and self.roles[g][p] != FOLLOWER
                   for p in range(R)):
                return False
            if not self.alive[g].all() or not self.connectivity[g].all():
                return False
            if self.slow[g].any():
                return False
        if not any(self._queue[g] for g in ticking):
            return False                 # pure-idle cluster: tick path
        # one fetch, read per logical group through the slot table
        lasts, commits_dev = self._fetch(torch.stack(
            [self._whole("last_index"),
             self._whole("commit_index")]))[:, self._slot]
        for g in ticking:
            if not (lasts[g] == lasts[g, ticking[g]]).all():
                return False             # someone lags: repair business
            if int(lasts[g, ticking[g]]) != int(self.commit_watermark[g]):
                return False
            if not (commits_dev[g] == int(self.commit_watermark[g])).all():
                return False
        t0 = self.clock.now
        bound = self._fused_heap_bound(ticking)
        if bound <= t0:
            return False
        # incremental tick times: the tick path's ``t + hb`` float chain
        times = [t0]
        tj = t0
        while len(times) < self.fuse_k:
            tj = tj + hb
            if tj > horizon or tj >= bound:
                break
            times.append(tj)
        n = len(times)
        if n >= 2:
            n = 1 << (n.bit_length() - 1)      # power-of-two program set
        if n < 2:
            return False
        times = times[:n]
        # ---- pack: per-group per-tick batch plan + payload words -----
        # (physical slot order: the device layout, identity until a
        # migration), then one packed array a shard
        slot, phys = self._slot, self._phys_group
        counts = np.zeros((n, G), np.int32)
        payloads = np.zeros((n, G, B, W), np.int32)
        leaders = np.zeros(G, np.int32)
        terms = np.zeros(G, np.int32)
        for g, r in ticks:
            s = slot[g]
            leaders[s] = r
            terms[s] = int(self.lead_terms[g, r])
            q = self._queue[g]
            for j in range(n):
                take = min(max(len(q) - j * B, 0), B)
                counts[j, s] = take
                if take:
                    chunk = q[j * B:j * B + take]
                    payloads[j, s, :take] = np.frombuffer(
                        b"".join(p for _, p in chunk), np.uint8
                    ).reshape(take, cfg.entry_bytes).view(np.int32)
        hp = self.hostprof
        if hp is not None:
            self._hp_groups.update(ticking)
            hp.mark("host_pre")
        # groups NOT ticking this instant run masked no-op lanes (term 0
        # and a dead cluster), a leaderless group's launch treatment
        alive = self.alive[phys].copy()
        for s in range(G):
            if int(phys[s]) not in ticking:
                terms[s] = 0
                alive[s] = False
        slow, gps = self.slow[phys], self._gps
        hosts = [pack_group_launch(
            n, gps, R, B, W, n_run=n, halted0=np.zeros(gps),
            leaders=leaders[sl], terms=terms[sl], counts=counts[:, sl],
            alive=alive[sl], slow=slow[sl], member=np.ones((gps, R)),
            payloads=payloads[:, sl])
            for sl in (slice(k * gps, (k + 1) * gps)
                       for k in range(self.n_shards))]
        if hp is not None:
            hp.mark("pack")
        record = self._dev_rings is not None
        rings = (self._dev_rings, self._dev_gids) if record else ()
        if self._gshard is not None:
            out = self._gshard.replicate_fused_packed(
                self.state, hosts, n, B, W, self._graphs, *rings)
        else:
            out = _FUSED_WINDOW(self.state, hosts[0], n, B, W, self._graphs,
                                *rings)
        if record:
            (self.state, infos, escaped, ran, _halted,
             self._dev_rings) = out
        else:
            self.state, infos, escaped, ran, _halted = out
        self.fused_launches += 1
        if hp is not None:
            hp.mark("dispatch")
            hp.sync(infos.commit_index, escaped, ran)
        self._flush_device_obs()
        ci, fl, mt, esc, rn = self._fetch(torch.stack(
            [infos.commit_index, infos.frontier_len, infos.max_term,
             escaped, ran]))[:, :, slot]
        self._book_fused_window(ticks, times, ci, fl, mt, esc, rn)
        return True

    def _book_fused_window(self, ticks, times, ci, fl, mt, esc,
                           rn) -> None:
        """Replay the window's host bookkeeping tick by tick, group by
        group, in ``_fire_leader_ticks``'s exact order."""
        cfg = self.cfg
        hb = cfg.heartbeat_period
        n = len(times)
        done = {g: False for g, _ in ticks}
        qpos = {g: 0 for g, _ in ticks}
        lasts = {g: int(self.commit_watermark[g]) for g, _ in ticks}
        for j in range(n):
            t_j = times[j]
            self.clock.now = max(self.clock.now, t_j)
            self.fused_ticks += 1
            for g, r in ticks:
                if done[g] or not rn[j, g]:
                    continue
                term = int(self.lead_terms[g, r])
                escaped_now = bool(esc[j, g])
                if escaped_now and int(mt[j, g]) > term:
                    # higher term surfaced: the tick path books nothing
                    # from this round and steps the leader down
                    self._step_down_leader(g, r, int(mt[j, g]))
                    done[g] = True
                    continue
                eff = self._reach(g, r)
                self.terms[g][eff] = np.maximum(self.terms[g][eff], term)
                frontier = int(fl[j, g])
                if frontier:
                    base = lasts[g]
                    chunk = self._queue[g][qpos[g]:qpos[g] + frontier]
                    self._seq_at_index[g].update(
                        zip(range(base + 1, base + frontier + 1),
                            (s for s, _ in chunk))
                    )
                    self._uncommitted[g].update(
                        (base + 1 + i, (p, term))
                        for i, (_, p) in enumerate(chunk)
                    )
                    qpos[g] += frontier
                    lasts[g] += frontier
                self._advance_commit(g, r, int(ci[j, g]), at_last=lasts[g])
                self._lease_renew(g, r, term, eff, int(mt[j, g]))
                self._reset_heard_timers(g, r)
                last_exec = escaped_now or j == n - 1
                if last_exec:
                    self._push(t_j + hb, "l", g, r)
                    done[g] = done[g] or escaped_now
                else:
                    # intermediate push+pop pair: replay the tiebreak
                    # counter only
                    self._seq_events += 1
        for g, r in ticks:
            if qpos[g]:
                self._queue[g] = self._queue[g][qpos[g]:]
            if self._track_match and not done[g]:
                # fused eligibility proved every row caught up; the
                # window left them matching the leader's booked tail
                self._match_host[g][:] = lasts[g]

    def _nodelog_at(self, g: int, r: int, msg: str, commit: int,
                    last: int, kind: Optional[str] = None) -> str:
        """``nodelog`` with caller-supplied commit/last (the fused
        booking's emission: the same rendering, no fetch mid-booking)."""
        rec = self.recorder
        if self._trace is None and rec is None:
            return ""
        line = (
            f"[g{g}/Server{r}:{self.terms[g, r]}:{commit}:"
            f"{last}][{self.roles[g][r]}]{msg}"
        )
        if rec is not None:
            rec.record(
                node=f"g{g}/Server{r}", group=g,
                term=int(self.terms[g, r]), kind=kind,
                t_virtual=self.clock.now, state=self.roles[g][r],
                commit_index=commit, last_index=last, msg=msg,
            )
        if self._trace is not None:
            self._trace(line)
        return line

    def _fire_leader_ticks(self, ticks: List[Tuple[int, int]]) -> None:
        """All leader ticks of this virtual instant as ONE batched launch
        (ingest + repair + replicate + commit per group). Two leaders of
        the SAME group on one instant (a stale minority leader and the
        current one) cannot share a launch: the second rides an
        immediate follow-up round, keeping its heartbeat chain."""
        cfg = self.cfg
        B = cfg.batch_size
        active: Dict[int, tuple] = {}
        overflow: List[Tuple[int, int]] = []
        for g, r in ticks:
            if not self.alive[g, r] or self.roles[g][r] != LEADER:
                continue
            term = int(self.lead_terms[g, r])
            if int(self.terms[g, r]) > term:
                self._step_down_leader(g, r, int(self.terms[g, r]))
                continue
            if g in active:
                overflow.append((g, r))
                continue
            routed = self.leader_id[g] == r
            if routed and self.slo is not None:
                # head-of-queue sojourn (the single engine's delay signal)
                hd = 0.0
                if self._queue[g]:
                    hd = self.clock.now - self.submit_time[g].get(
                        self._queue[g][0][0], self.clock.now
                    )
                self.slo.observe(
                    "queue_delay", hd, self.clock.now, group=g
                )
            take = min(len(self._queue[g]), B) if routed else 0
            data = None
            if take:
                data = np.frombuffer(
                    b"".join(p for _, p in self._queue[g][:take]), np.uint8
                ).reshape(take, cfg.entry_bytes)
            active[g] = (r, term, take, data)
        if not active:
            if overflow:
                self._fire_leader_ticks(overflow)
            return
        max_terms, commits = self._replicate_round(active)
        frontier = self._last_host["frontier"]
        match_all = self._last_host["match"] if self._track_match else None
        lasts = self._last_host["last"]
        for g, (r, term, take, _) in active.items():
            if int(max_terms[g]) > term:
                # nothing was consumed: the device refused the stale term
                self._step_down_leader(g, r, int(max_terms[g]))
                continue
            e = self._reach(g, r)
            self.terms[g][e] = np.maximum(self.terms[g][e], term)
            ingested = int(frontier[g])
            if ingested:
                last = int(lasts[g, r])
                for i, (seq, p) in enumerate(self._queue[g][:ingested]):
                    idx = last - ingested + 1 + i
                    self._seq_at_index[g][idx] = seq
                    self._uncommitted[g][idx] = (p, term)
                self._queue[g] = self._queue[g][ingested:]
            self._advance_commit(g, r, int(commits[g]))
            self._lease_renew(g, r, term, e, int(max_terms[g]))
            if match_all is not None:
                self._match_host[g] = match_all[g]
            self._reset_heard_timers(g, r)
            self._push(self.clock.now + cfg.heartbeat_period, "l", g, r)
        if overflow:
            # same-group second leaders: their own round (the first
            # round may already have deposed them; the checks re-filter)
            self._fire_leader_ticks(overflow)

    def _reset_heard_timers(self, g: int, r: int) -> None:
        for p in range(self.cfg.n_replicas):
            if p == r or not self.alive[g, p] or not self.connectivity[g, r, p]:
                continue
            if self.roles[g][p] == FOLLOWER:
                self._arm_follower(g, p)
            elif self.roles[g][p] == CANDIDATE:
                self.roles[g][p] = FOLLOWER
                self._arm_follower(g, p)
            elif (
                self.roles[g][p] == LEADER
                and self.lead_terms[g, r] > self.lead_terms[g, p]
            ):
                self.roles[g][p] = FOLLOWER
                self.nodelog(g, p, "step down to follower")
                self._arm_follower(g, p)

    # ------------------------------------------------------------ commit side
    def _advance_commit(self, g: int, leader: int, commit: int,
                        at_last: Optional[int] = None) -> None:
        """Host bookkeeping for a commit advance. ``at_last`` is the fused
        booking's reconstructed leader last_index: the nodelog line then
        renders from the supplied values (``_nodelog_at``, no fetch)."""
        if commit > self._row_commit[g, leader]:
            # the leader's OWN commit view (lease reads serve at this)
            self._row_commit[g, leader] = commit
        wm = int(self.commit_watermark[g])
        if commit <= wm:
            return
        if (self.roles[g][leader] == LEADER
                and int(self.terms[g, leader])
                == int(self.lead_terms[g, leader])):
            # §6.4 fresh-leader gate: a watermark advance riding the
            # leader's own round committed a current-term entry
            self._lease_ok_term[g, leader] = int(
                self.lead_terms[g, leader]
            )
        self.committed_total[g] += commit - wm
        for idx in range(wm + 1, commit + 1):
            seq = self._seq_at_index[g].get(idx)
            if seq is not None and seq not in self.commit_time[g]:
                self.commit_time[g][seq] = self.clock.now
                self._metric_inc(g, "raft_commits_total")
                if self.metrics is not None:
                    self.metrics.histogram(
                        "raft_commit_latency_seconds",
                        "submit -> durable, virtual seconds", ("group",),
                    ).observe(
                        self.clock.now - self.submit_time[g].get(
                            seq, self.clock.now
                        ),
                        group=str(g),
                    )
                if self.slo is not None:
                    self.slo.observe(
                        "commit",
                        self.clock.now - self.submit_time[g].get(
                            seq, self.clock.now
                        ),
                        self.clock.now, group=g,
                    )
        self._archive_committed(g, leader, wm + 1, commit)
        self.commit_watermark[g] = commit
        if self.auditor is not None:
            self.auditor.note_commit(commit, self.clock.now, group=g)
        if at_last is None:
            self.nodelog(g, leader, f"commit index changed to {commit}")
        else:
            self._nodelog_at(g, leader,
                             f"commit index changed to {commit}",
                             commit, at_last)
        for idx in [i for i in self._uncommitted[g] if i <= commit]:
            del self._uncommitted[g][idx]
        for idx in [i for i in self._seq_at_index[g] if i <= commit]:
            del self._seq_at_index[g][idx]
        self._evict_commit_stamps(g)
        self._drain_apply(g)
        self._evict_group_history(g)

    def _archive_committed(self, g: int, leader: int, lo: int, hi: int) -> None:
        """Move group ``g``'s just-committed range into the host archive.

        Steady case, no fetch: a buffered entry whose ingest term is the
        committing leader's current lead term is that leader's log
        content at that index. Failover case: older-term entries are
        term-checked against ONE fetched row of the leader's term ring,
        and entries the buffer cannot serve are read back from the
        leader's payload ring."""
        term_now = int(self.lead_terms[g, leader])
        aud = self.auditor
        fed = [] if aud is not None else None
        pend = []
        for idx in range(lo, hi + 1):
            ent = self._uncommitted[g].get(idx)
            if ent is not None and ent[1] == term_now:
                self._archive[g][idx] = ent[0]
                if fed is not None:
                    fed.append((idx, ent[0], term_now))
            else:
                pend.append(idx)
        if pend:
            cap = self.cfg.log_capacity
            plo, phi = min(pend), max(pend)
            slots = (np.arange(plo, phi + 1) - 1) % cap
            lead_terms = self._fetch(self._view(g).log_term[leader])[slots]
            missing = []
            for idx in pend:
                ent = self._uncommitted[g].get(idx)
                if ent is not None and ent[1] == int(lead_terms[idx - plo]):
                    self._archive[g][idx] = ent[0]
                    if fed is not None:
                        fed.append((idx, ent[0], ent[1]))
                else:
                    missing.append(idx)
            if missing:
                mlo, mhi = min(missing), max(missing)
                data = log_entries(self._view(g), leader, mlo, mhi)
                for idx in missing:
                    payload = data[idx - mlo].tobytes()
                    self._archive[g][idx] = payload
                    if fed is not None:
                        fed.append((
                            idx, payload, int(lead_terms[idx - plo]),
                        ))
        if fed:
            # per-group committed-prefix feed with real term evidence,
            # sorted for the bulk run detection
            fed.sort()
            aud.note_entries(fed, self.clock.now, group=g)

    # --------------------------------------------- bounded history layer
    def _evict_commit_stamps(self, g: int) -> None:
        """Per-group stamp bound through the shared ledger algorithm
        (``raft.ledger.evict_commit_stamps``)."""
        self.commit_time[g], self.submit_time[g], n = evict_commit_stamps(
            self.commit_time[g], self.submit_time[g],
            self._commit_stamp_cap, self._durable_ranges[g],
        )
        self.commit_stamps_evicted[g] += n

    def _evict_group_history(self, g: int) -> None:
        """Archive retention sweep: keep the last ``2 * log_capacity``
        committed payloads of group ``g``, never past the apply stream's
        cursor. With a tier configured the swept range is SEALED first
        (one group-tagged RS-coded segment), so history stays readable
        (``_archive_get``); a range with a hole is dropped as untiered."""
        floor = int(self._archive_floor[g])
        keep_from = int(self.commit_watermark[g]) - self._commit_stamp_cap + 1
        if self._apply_fns[g]:
            keep_from = min(keep_from, int(self.applied_index[g]) + 1)
        if keep_from <= floor:
            return
        arch = self._archive[g]
        if self._tier_io is not None:
            lo, hi = floor, keep_from - 1
            if all(i in arch for i in range(lo, hi + 1)):
                ents = np.frombuffer(
                    b"".join(arch[i] for i in range(lo, hi + 1)), np.uint8
                ).reshape(hi - lo + 1, self.cfg.entry_bytes)
                self._tier_io.seal(
                    lo, hi, ents, np.zeros(hi - lo + 1, np.int32),
                    prefix=f"g{g}-",
                )
                self._group_segments[g].append((lo, hi))
                self.tier_stats["segments_sealed"] += 1
                self.tier_stats["entries_sealed"] += hi - lo + 1
        for idx in range(floor, keep_from):
            arch.pop(idx, None)
        self._archive_floor[g] = keep_from

    def _archive_get(self, g: int, idx: int) -> Optional[bytes]:
        """Group ``g``'s committed payload at ``idx``: RAM archive first,
        sealed segments below the floor (a corrupt data shard
        reconstructs through the RS decode). None = never archived or
        swept without a tier."""
        got = self._archive[g].get(idx)
        if got is not None or self._tier_io is None:
            return got
        import bisect

        segs = self._group_segments[g]
        i = bisect.bisect_right(segs, (idx, 1 << 62)) - 1
        if i < 0:
            return None
        lo, hi = segs[i]
        if not (lo <= idx <= hi):
            return None
        key = (g, lo)
        if key in self._tier_lost:
            return None
        ents = self._tier_cache.get(key)
        if ents is None:
            from raft_tpu_torch.ckpt import SegmentCorrupt

            try:
                ents, _terms, reconstructed = self._tier_io.load(
                    lo, hi, self.cfg.entry_bytes, prefix=f"g{g}-"
                )
            except SegmentCorrupt:
                self.tier_stats["segments_lost"] += 1
                self._tier_lost.add(key)
                return None
            self.tier_stats["segment_loads"] += 1
            if reconstructed:
                self.tier_stats["segment_reconstructs"] += 1
            self._tier_cache[key] = ents
            self._tier_cache_order.append(key)
            while len(self._tier_cache_order) > 2:
                self._tier_cache.pop(self._tier_cache_order.pop(0), None)
        return ents[idx - lo].tobytes()

    def _tier_host_bytes(self) -> int:
        """RAM held by the decoded segment cache."""
        return sum(e.nbytes for e in self._tier_cache.values())

    # ---------------------------------------------------- state machine
    def register_apply(
        self, g: int, fn: Callable[[int, bytes], None], replay: bool = False
    ) -> int:
        """Register group ``g``'s apply callback: ``fn(index, payload)``
        for every committed entry, in log order, exactly once.
        ``replay=True`` first replays the history from index 1 (refused
        once the retention sweep has passed index 1 with no sealed tier
        covering it). Returns the first index the callback sees."""
        if replay:
            floor = int(self._archive_floor[g])
            covered = 1 if self._group_segments[g] \
                and self._group_segments[g][0][0] == 1 else floor
            if floor > 1 and covered > 1:
                raise ValueError(
                    f"group {g}: archived history starts at index "
                    f"{floor} (retention horizon "
                    f"{self._commit_stamp_cap} entries swept the "
                    "prefix, and no sealed tier covers it); "
                    "replay=True needs the full history — rebuild "
                    "from a snapshot, then register without replay"
                )
            for idx in range(1, int(self.commit_watermark[g]) + 1):
                payload = self._archive_get(g, idx)
                if payload is None:
                    raise ValueError(
                        f"group {g}: committed entry {idx} is not "
                        "recoverable from the archive or sealed tier "
                        "(corrupt segment below k shards?); cannot "
                        "replay"
                    )
                fn(idx, payload)
            start = 1
        else:
            start = int(self.commit_watermark[g]) + 1
        if not self._apply_fns[g]:
            self.applied_index[g] = self.commit_watermark[g]
        self._apply_fns[g].append(fn)
        return start

    def _drain_apply(self, g: int) -> None:
        if not self._apply_fns[g]:
            return
        while self.applied_index[g] < self.commit_watermark[g]:
            nxt = int(self.applied_index[g]) + 1
            payload = self._archive[g][nxt]
            self.applied_index[g] = nxt
            for fn in self._apply_fns[g]:
                fn(nxt, payload)

    # ------------------------------------------------------------- read side
    def committed_payloads(self, g: int, replica: Optional[int] = None):
        """Group ``g``'s committed log as a list of payload byte strings,
        read from ``replica``'s ring (default the routed leader, else
        replica 0): the differential tests' read surface."""
        from raft_tpu_torch.core.state import committed_payloads as _cp

        if replica is None:
            replica = self.leader_id[g] if self.leader_id[g] is not None else 0
        return [bytes(row) for row in _cp(self._view(g), replica)]

    def commit_latencies(self, g: Optional[int] = None) -> np.ndarray:
        """Per-entry commit latency (virtual seconds) for every durable
        entry: one group's, or every group's pooled (``g=None``)."""
        gs = range(self.G) if g is None else (g,)
        return np.array([
            self.commit_time[gg][s] - self.submit_time[gg][s]
            for gg in gs for s in self.commit_time[gg]
        ])
