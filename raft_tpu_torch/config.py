"""Cluster / protocol configuration — the port's own copy.

The same frozen dataclass as ``raft_tpu/config.py``: every field, default
and validation rule matches it (``tests/test_torch_config_state.py`` pins
that field by field), so a configuration means the same deployment on
either package. It is copied rather than imported because the port must
not import the JAX package, not even its JAX-free modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """All knobs for a cluster.

    Timing defaults mirror the reference's hardcoded constants (in seconds):
    follower election timeout uniform 10-30 s (main.go:114), candidate
    re-election timeout uniform 10-13 s (main.go:194), leader tick 2 s
    (main.go:394), client injection 10 s (main.go:89). The host engine runs
    them against a virtual clock in tests, so the absolute values only matter
    for live runs.
    """

    # --- cluster shape ---
    n_replicas: int = 3                 # reference: 3, hardcoded (main.go:81)
    entry_bytes: int = 256              # north-star entry payload size
    batch_size: int = 1024              # entries per replication step (config 2)
    log_capacity: int = 1 << 15         # fixed device ring-buffer capacity
    # Membership-change headroom: device arrays are statically shaped, so
    # live add/remove (RaftEngine.add_server / remove_server — the
    # dissertation-§4 single-server change) needs rows allocated up front.
    # None = fixed membership at n_replicas (no spare rows, no change).
    max_replicas: Optional[int] = None
    # Learner promotion lag (entries): ``promote`` commits the voter
    # config entry only once the learner's current-term verified match is
    # within this many entries of the leader's last index — the
    # dissertation-§4.2.1 catch-up gate that keeps a far-behind joiner
    # from ever counting against the commit quorum. None = 2 * batch_size
    # (one in-flight window of slack). See docs/MEMBERSHIP.md.
    promote_max_lag: Optional[int] = None

    # --- erasure coding (config 3); k = data shards, m = parity shards ---
    # None disables EC: every replica stores the full payload, like the
    # reference's full-copy replication (main.go:344-371).
    rs_k: Optional[int] = None
    rs_m: Optional[int] = None
    # EC durability margin: an EC commit needs k + margin shard-holding
    # acks (vs plain majority when EC is off). A committed batch then
    # survives `margin` immediate replica failures (>= k shards remain for
    # reconstruction), and the §5.4.1 up-to-date vote check keeps any
    # shard-less replica from winning leadership over the holders. Plain
    # majority would be unsafe: k acks alone means ANY single holder
    # failure can make a committed entry unreconstructable.
    ec_commit_margin: int = 1

    # --- timing (seconds; reference values noted above) ---
    follower_timeout: Tuple[float, float] = (10.0, 30.0)
    candidate_timeout: Tuple[float, float] = (10.0, 13.0)
    heartbeat_period: float = 2.0
    client_period: float = 10.0

    # --- loopback-transport fidelity (golden model only) ---
    # Capacity of the oracle's bounded LogReq channels (the reference's
    # buffered channels, all cap 10, main.go:68-72): a full channel blocks
    # the golden client mid-send until a leader tick drains it. Consumed
    # by ``GoldenCluster.from_config`` / ``GoldenCluster(channel_depth=)``;
    # the device engine deliberately has no channel analogue — its
    # backpressure point is the ring (core.step's room clamp).
    channel_depth: int = 10

    # --- liveness hardening (dissertation §9.6) ---
    # prevote: a follower whose election timer fires first solicits
    #   NON-BINDING votes at term+1 (no term bump, nothing persisted) and
    #   only campaigns for real if it would win — a grantor refuses while
    #   it has heard a live leader within the minimum election timeout
    #   (leader stickiness) or holds a more up-to-date log (§5.4.1). A
    #   partitioned replica therefore stops inflating its term and cannot
    #   depose a healthy leader on heal.
    # check_quorum: a leader that cannot contact a member majority for a
    #   full minimum election timeout steps down on its own — the
    #   minority side of a partition goes quiet instead of heartbeating
    #   a stale leadership forever.
    # Both default OFF: the reference has neither, and the differential
    # suites pin the reference's election dynamics.
    prevote: bool = False
    check_quorum: bool = False

    # --- pipelined-ingest chunk size (ring turnovers per launch) ---
    # submit_pipelined's fast path runs a full ring of batches as ONE
    # kernel launch. On an all-accept steady cluster the write-only
    # turnover kernel is additionally legal across ring LAPS (every step
    # commits before its slots are revisited), so a large backlog can
    # ride a single launch spanning this many ring turnovers —
    # amortizing launch and host-sync cost k-fold (docs/PERF.md round 5
    # measured 1.13 B entries/s device-side at 8 laps). 1 = one ring per
    # launch (the conservative default). Exactly two programs compile
    # (1 lap and max laps) — the engine only takes the lapped shape when
    # the backlog covers it entirely.
    pipeline_max_laps: int = 1

    # --- multihost mirror desync guard ---
    # Every N-th control-plane decision (event-heap pop), fold the
    # decision and its observable outcome into a rolling digest and
    # exchange digests across processes; mismatch raises
    # ``MirrorDesyncError`` (fail-stop) instead of letting a divergence
    # surface as a silently wrong collective or a hang. 0 = off (the
    # single-process default; the digest fold itself is skipped too).
    mirror_check_every: int = 0
    # Bound on the digest exchange itself (seconds, wall clock). The
    # guard only compares digests at aligned decision COUNTS; if one
    # process stalls or dies between checks, the surviving side's
    # process_allgather would BE the indefinite hang the guard exists
    # to prevent (ADVICE r5 #4). The exchange runs under this timeout
    # and a stall raises MirrorDesyncError exactly like a value
    # mismatch — fail-stop either way.
    mirror_exchange_timeout_s: float = 60.0

    # --- overload admission (raft_tpu.admission; docs/OVERLOAD.md) ---
    # Bounded host-queue admission with typed refusals. Both caps default
    # None = the legacy unbounded behavior (no gate is built at all).
    # admission_max_writes: write-queue depth bound. An arrival that finds
    #   the queue at the bound is refused with ``Overloaded("depth")``
    #   before anything is queued; host memory stays bounded no matter
    #   the offered load.
    # admission_max_reads: outstanding read-ticket bound. Beyond it,
    #   ``submit_read`` refuses with ``Overloaded("read_depth")`` instead
    #   of silently FIFO-evicting someone else's ticket (the 2^16
    #   eviction cap remains as the abandoned-ticket backstop).
    admission_max_writes: Optional[int] = None
    admission_max_reads: Optional[int] = None
    # CoDel-style queue-delay controller (write lane only; virtual
    # clock): once the head-of-queue sojourn has stayed >= target for a
    # full interval, new writes are refused (``Overloaded("delay")``)
    # until an observation comes back under target. Defaults sized to
    # the reference's 2 s tick cadence — target two ticks of queueing,
    # judged over an election-timeout-scale interval.
    admission_target_delay_s: float = 4.0
    admission_interval_s: float = 30.0
    # Per-client fair-share accounting under congestion: a client whose
    # share of recently admitted writes exceeds twice its fair share is
    # refused (``Overloaded("fair_share")``) while lighter clients are
    # still admitted. Only applies to submits that carry a client id.
    admission_fair_share: bool = True

    # --- tiered log + incremental snapshot shipping (ckpt.tiered /
    # ckpt.ship; ROADMAP item 6, docs/PERF.md "Tiered log") ---
    # tiered_log_dir: root directory for sealed segments. None = the
    #   legacy in-RAM CheckpointStore archive (bounded at 2x ring
    #   capacity — history past that is EVICTED). Set = the archive
    #   seals committed-and-applied history into RS-coded on-disk
    #   segments with CRC sidecars: RAM stays bounded by the hot tail
    #   while coverage (apply replay, snapshot backfill) reaches the
    #   whole history. Env override ``RAFT_TPU_TIERED_DIR`` (read at
    #   engine construction) so chaos/bench harnesses can flip the tier
    #   without config edits; each engine seals under its own fresh
    #   subdirectory (segments are an engine-lifetime cache of durable
    #   state — a restore rebuilds its archive from the checkpoint).
    tiered_log_dir: Optional[str] = None
    # Entries per sealed segment (the seal/spill granularity). None =
    # half the ring capacity.
    segment_entries: Optional[int] = None
    # Hot-tail entries kept in RAM before sealing. None = 2x ring
    # capacity (the plain store's retention bound, so flipping the tier
    # on changes WHERE history lives, not how much stays hot — the
    # chaos byte-identity pin rides this default). Smaller values make
    # rejoin catch-up stream from the cold tier — the segment-nemesis
    # drill sets log_capacity // 2 so a corrupted segment sits squarely
    # on the rejoin path.
    tiered_hot_entries: Optional[int] = None
    # The segment tier's RS(k+m, k) code — independent of the cluster's
    # replication-side EC config: this code protects FILES on one
    # host's disk (bit rot, torn spills, a lost shard), not replicas.
    segment_rs_k: int = 4
    segment_rs_m: int = 2
    # Incremental snapshot shipping: a ring-lapped replica's catch-up
    # is streamed in chunks of this many entries (None = batch_size),
    # at most catchup_max_chunks_per_tick chunks per leader tick — and
    # the admission gate's catch-up lane cuts that to 1 while the write
    # lane is congested (docs/MEMBERSHIP.md wipe runbook), so rejoin
    # traffic coexists with foreground commits instead of stalling
    # them. Rejoin cost is thereby bounded by ring capacity / chunk
    # rate — flat in history length (the wipe_logN bench ladder).
    catchup_chunk_entries: Optional[int] = None
    catchup_max_chunks_per_tick: int = 4

    # --- read scale-out (raft.lease / multi.router; docs/READS.md) ---
    # read_lease: leader leases (dissertation §6.4.1). Every successful
    #   quorum round doubles as a lease grant; while the lease is valid
    #   (bounded by follower_timeout[0] / clock_drift_bound on the
    #   leader's OWN clock) linearizable reads serve locally with ZERO
    #   replication rounds, falling back to classic ReadIndex when the
    #   lease is stale. REQUIRES prevote: the safety argument rests on
    #   §9.6 leader stickiness (no voter grants a rival within the
    #   minimum election timeout of hearing the leader — raft.lease has
    #   the full argument). Off by default: the legacy read path is
    #   byte-identical with the plane off.
    read_lease: bool = False
    # Assumed worst-case clock-RATE error between any replica's clock
    # and true time. The lease duration divides by it, so any actual
    # skew inside [1/bound, bound] is provably absorbed; the chaos
    # clock-skew nemesis drives exactly that band, and the
    # broken="lease_skew" variant (which ignores the bound) is what a
    # stale read looks like when a deployment lies about its clocks.
    clock_drift_bound: float = 2.0
    # Follower/session read staleness bound (entries): a replica whose
    # replication cursor lags the leader-confirmed read index by more
    # than this is skipped for follower-served reads (typed
    # ``ReadLagging`` refusal, never a silent redial loop). None =
    # 2 * batch_size (one in-flight window of slack).
    session_max_lag: Optional[int] = None

    # --- K-tick steady-state fusion (ROADMAP item 2) ---
    # Ticks per fused launch: when > 1, the engine fuses runs of
    # consecutive steady-state leader ticks — heartbeat emission,
    # pending-ingest drain from the pre-packed device staging ring,
    # quorum commit advance and (host-replayed) timer bookkeeping —
    # into ONE compiled ``lax.scan`` launch of up to this many ticks,
    # escaping to the host only when a step's ``interesting`` mask
    # fires (higher term seen, ingest shortfall / ring-lap pressure,
    # commit stall) or the staging buffer drains. 1 = off (the legacy
    # one-launch-per-tick cadence). The committed log is byte-identical
    # either way (pinned by tests/test_fused_ticks.py); the win is wall
    # time — docs/PERF.md has the K sweep. Env override:
    # ``RAFT_TPU_FUSE_K`` (read at engine construction) so chaos/torture
    # harnesses can be pointed at the fused path without config edits.
    fuse_k: int = 1

    # --- steady-state program dispatch ---
    # "auto": run the repair-free step program whenever the last step showed
    #   every live non-slow follower caught up (~11% faster on the 3-replica
    #   batch-1024 headline shape);
    # "off": always run the repair-capable program — XLA's layout choices
    #   differ per shape, and for some (5-replica, batch>=4096 on v5e) the
    #   repair-capable program schedules better; docs/PERF.md has numbers.
    steady_dispatch: str = "auto"

    # --- determinism ---
    seed: int = 0

    # --- transport selection: the plugin boundary named by the north star ---
    # "tpu_mesh": one replica row per device over a Mesh axis (falls back to
    #   "single" when fewer chips than replicas are available);
    # "multihost": tpu_mesh with the replica axis placed across processes /
    #   failure domains (transport.multihost; pod deployments);
    # "single": all replica rows resident on one device.
    # The host-side golden model (reference semantics, for differential
    # tests) is not a device transport — see raft_tpu.golden.
    transport: str = "tpu_mesh"

    # --- payload-byte sharding (second mesh axis, tpu_mesh only) ---
    # Each log slot's bytes are split over this many devices (the
    # long-dimension / sequence-parallel analogue); needs
    # n_replicas * payload_shards devices.
    payload_shards: int = 1

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        # Odd cluster sizes are the useful ones (an even cluster tolerates no
        # more failures than the next odd size down) but even sizes are valid
        # Raft (majority = n//2 + 1) and arise when a mesh has an even device
        # count, so they are allowed rather than rejected.
        if self.batch_size < 1 or 2 * self.batch_size > self.log_capacity:
            # >= 2B so a window's two ring pieces never overlap (core.ring)
            raise ValueError("log_capacity must be >= 2 * batch_size")
        if self.log_capacity % self.batch_size:
            # core.ring's gather-free window rotation needs B | C
            raise ValueError("log_capacity must be a multiple of batch_size")
        if (self.rs_k is None) != (self.rs_m is None):
            raise ValueError("rs_k and rs_m must be set together")
        if self.rs_k is not None:
            if self.rs_k + self.rs_m != self.n_replicas:
                raise ValueError("RS(n,k): k+m must equal n_replicas")
            if self.entry_bytes % self.rs_k != 0:
                raise ValueError("entry_bytes must be divisible by rs_k")
            if not (0 <= self.ec_commit_margin <= self.rs_m):
                # The quorum (k + margin acks) must be satisfiable by the
                # INITIAL membership: n_replicas members means margin <=
                # n_replicas - k = rs_m, or the cluster starts wedged.
                # Under membership headroom the code has rows - k parity
                # shards and a grown cluster could hold more, but the
                # quorum is static — the initial-liveness bound governs.
                raise ValueError("ec_commit_margin must be in [0, rs_m]")
        if self.payload_shards < 1:
            raise ValueError("payload_shards must be >= 1")
        if self.channel_depth < 1:
            raise ValueError("channel_depth must be >= 1")
        if self.max_replicas is not None:
            if self.max_replicas < self.n_replicas:
                raise ValueError("max_replicas must be >= n_replicas")
            # EC + membership: the RS code is provisioned ONCE for the
            # full headroom — RS(max_replicas, rs_k) — so every row has a
            # permanently assigned shard lane and membership changes never
            # re-shard history (row == shard index is a static invariant;
            # spare rows simply start/stop receiving their already-defined
            # shards). The cost of headroom is max_replicas-k parity
            # shards per entry instead of n-k, paid at encode time and in
            # ring lanes — the TPU-native trade: static shapes, zero
            # re-encode on reconfiguration.
        if self.promote_max_lag is not None and self.promote_max_lag < 1:
            raise ValueError("promote_max_lag must be >= 1 (or None)")
        if self.steady_dispatch not in ("auto", "off"):
            raise ValueError('steady_dispatch must be "auto" or "off"')
        if self.pipeline_max_laps < 1:
            raise ValueError("pipeline_max_laps must be >= 1")
        if self.fuse_k < 1:
            raise ValueError("fuse_k must be >= 1 (1 = fusion off)")
        if self.admission_max_writes is not None and self.admission_max_writes < 1:
            raise ValueError("admission_max_writes must be >= 1 (or None)")
        if self.admission_max_reads is not None and self.admission_max_reads < 1:
            raise ValueError("admission_max_reads must be >= 1 (or None)")
        if self.admission_target_delay_s <= 0 or self.admission_interval_s <= 0:
            raise ValueError(
                "admission_target_delay_s and admission_interval_s must be > 0"
            )
        if self.mirror_exchange_timeout_s <= 0:
            raise ValueError("mirror_exchange_timeout_s must be > 0")
        if self.segment_entries is not None and self.segment_entries < 1:
            raise ValueError("segment_entries must be >= 1 (or None)")
        if self.tiered_hot_entries is not None and self.tiered_hot_entries < 1:
            raise ValueError("tiered_hot_entries must be >= 1 (or None)")
        if self.segment_rs_k < 1 or self.segment_rs_m < 1:
            # m >= 1: an unprotected cold tier would turn any single
            # shard fault into silent history loss
            raise ValueError("segment_rs_k and segment_rs_m must be >= 1")
        if self.catchup_chunk_entries is not None \
                and self.catchup_chunk_entries < 1:
            raise ValueError("catchup_chunk_entries must be >= 1 (or None)")
        if self.catchup_max_chunks_per_tick < 1:
            raise ValueError("catchup_max_chunks_per_tick must be >= 1")
        if self.clock_drift_bound < 1.0:
            raise ValueError("clock_drift_bound must be >= 1.0")
        if self.read_lease and not self.prevote:
            # the lease safety argument IS §9.6 leader stickiness: a
            # voter that heard the leader within the minimum election
            # timeout refuses rival (pre-)votes, so no rival can exist
            # inside a drift-bounded lease. Without prevote a disruptive
            # candidacy could depose mid-lease and a local serve would
            # be a stale read — refuse the configuration loudly.
            raise ValueError("read_lease requires prevote=True "
                             "(leases rest on §9.6 leader stickiness)")
        if self.session_max_lag is not None and self.session_max_lag < 1:
            raise ValueError("session_max_lag must be >= 1 (or None)")
        if self.shard_bytes % 4:
            # device payload storage is packed as int32 lanes (core.state
            # layout); each replica's per-entry bytes must fill whole words
            raise ValueError(
                "per-entry stored bytes (entry_bytes, or entry_bytes/rs_k "
                "under EC) must be a multiple of 4"
            )
        if self.shard_words % self.payload_shards:
            raise ValueError(
                "per-entry stored words must divide evenly over payload_shards"
            )

    @property
    def rows(self) -> int:
        """Device replica rows allocated (>= n_replicas when membership
        headroom is configured)."""
        return self.max_replicas if self.max_replicas is not None else self.n_replicas

    @property
    def majority(self) -> int:
        from raft_tpu_torch.quorum.commit import majority

        return majority(self.n_replicas)

    @property
    def commit_quorum(self) -> int:
        """Acks required to commit: majority, or k + margin under EC (see
        ``ec_commit_margin``)."""
        if not self.ec_enabled:
            return self.majority
        return max(self.majority, self.rs_k + self.ec_commit_margin)

    @property
    def ec_enabled(self) -> bool:
        return self.rs_k is not None

    @property
    def session_lag(self) -> int:
        """Resolved follower/session staleness bound (entries)."""
        return (self.session_max_lag if self.session_max_lag is not None
                else 2 * self.batch_size)

    @property
    def lease_duration_s(self) -> float:
        """Local-clock lease validity window: the §9.6 stickiness
        window divided by the assumed worst-case clock-rate error."""
        return self.follower_timeout[0] / self.clock_drift_bound

    @property
    def shard_bytes(self) -> int:
        """Per-replica stored bytes per entry (full copy when EC is off)."""
        return self.entry_bytes // self.rs_k if self.ec_enabled else self.entry_bytes

    @property
    def shard_words(self) -> int:
        """Per-replica stored int32 lanes per entry (device payload layout)."""
        return self.shard_bytes // 4
