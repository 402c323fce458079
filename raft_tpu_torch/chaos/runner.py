"""The torture runner: workload + nemesis + history + checker, end to end
(port of ``raft_tpu/chaos/runner.py`` up to ``txn_run``).

The port runs JAX's runners seed for seed over its own engines: every
random draw, nemesis line, history record and report field is the JAX
runner's. What differs is where they run: every runner takes
``device=`` (CUDA unless ``"cpu"`` is named; off the card it raises, it
never falls back), and ``torture_run_multi``, ``migration_run`` and
``txn_run`` take ``mesh=`` (a ``transport.GroupMesh``; two shards of one
device, ``GroupMesh(["cuda:0", "cuda:0"])`` or ``GroupMesh(["cpu",
"cpu"])``, stand in for JAX's two devices). A crash cycle hands the
dead engine's rings, staging buffer and CUDA graphs to the restored one
(``SingleDeviceTransport.release``; ``core.graphs`` keeps the pool), so
on the card a restore captures no graph anew, as JAX's process-wide
program cache compiles nothing anew; ``torture_run`` releases its last
engine too, for the next run of the shape. ``wire_run`` drives the same
multi-Raft stack through the port's wire tier (``raft_tpu_torch.net``)
over real loopback sockets, and ``txn_run`` the transaction tier
(``raft_tpu_torch.txn``) over a sharded one. The rest of the JAX module
is not ported yet: the cluster drills ``cluster_run``,
``cluster_storage_run`` and ``cluster_net_run`` (ROADMAP A17d).


``torture_run`` drives a single-group ``RaftEngine`` (with a recorded
``ReplicatedKV`` workload) and ``torture_run_multi`` a key-sharded
``MultiEngine``+``Router`` stack, through a seeded nemesis schedule —
process faults, message faults, and whole-process crash /
checkpoint-restore / restart cycles with storage faults against the
durability files — then quiesces, closes the client history, and hands
it to the linearizability checker. Every random choice (workload and
nemesis alike) derives from the one seed, so a failing run's report
carries a one-line repro: ``python -m raft_tpu_torch.chaos --seed N ...``.

Crash model. The engine is one process simulating R replicas, so a
"crash" is the loss of every replica's VOLATILE state at one instant:
queues, in-flight ops, roles, timers. Durable state is what the
durability stack had on disk — the mirrored checkpoint
(``MirroredStore``) and the vote WAL — which is exactly what
``RaftEngine.restore`` rebuilds from. The runner snapshots the durable
state at the crash instant (the archive IS the simulated disk: every
committed entry was "written" when it committed), lets the nemesis
corrupt it within the keep-one-mirror-healthy rule, restores, and
carries the virtual clock forward so history timestamps stay monotone.
Writes in flight across a crash resolve as ``info`` (they may have
committed just before the crash — the checker explores both worlds);
in-flight reads resolve as ``fail`` (a read that never returned has no
effect to account for).

Client model. Each virtual client runs ONE op at a time (serial — the
§6.3 discipline) against its own rng stream: mostly writes of fresh
values (every written value is unique, which maximizes the checker's
discriminating power: a stale read names its exact culprit), reads via
the batched ReadIndex ticket path (``submit_read``/``read_confirmed``),
and occasional deletes. ``broken="dirty_reads"`` swaps the read path
for one that serves the latest SUBMITTED (possibly uncommitted) value
without leadership confirmation — the deliberately broken variant the
checker must reject, proving the harness has teeth.

Overload model (``overload=True`` / ``overload_run``; docs/OVERLOAD.md).
The closed-loop clients above are polite — they wait for outcomes — so
they can never overrun admission. The overload phases add OPEN-LOOP
traffic: Poisson arrivals at a nemesis-chosen 2-10x multiple of the
cluster's measured ingest capacity (``batch_size / heartbeat_period``
entries/s — the most a leader tick can drain), each arrival a one-shot
write from its own client id (fully concurrent, exactly the
open-loop assumption). An arrival the admission gate refuses resolves
``fail`` at once — ``Overloaded`` is raised before anything is queued,
so failed-without-effect is SOUND and the linearizability verdict must
stay ACCEPT through the storm. Admitted arrivals resolve like any
write (ok once durable, info across a crash or at give-up). The
admission bound is what keeps the harness itself bounded: outstanding
open-loop state never exceeds the configured queue depth.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import random
import tempfile
import zlib
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.admission import Overloaded
from raft_tpu_torch.chaos.checker import (
    LINEARIZABLE,
    VIOLATION,
    CheckResult,
    check_history,
    check_read_classes,
)
from raft_tpu_torch.chaos.history import (
    DELETE,
    READ,
    WRITE,
    History,
    OpRecord,
)
from raft_tpu_torch.chaos.nemesis import (
    MembershipView,
    Nemesis,
    NemesisAction,
)
from raft_tpu_torch.chaos.storage import MirroredStore, SegmentNemesis
from raft_tpu_torch.chaos.transport import ChaosTransport
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import blackbox
from raft_tpu_torch.obs.forensics import (
    ObsStack,
    resolve_bundle_dir,
    write_bundle,
)


def poisson(rng: random.Random, lam: float) -> int:
    """One Poisson(lam) draw from a seeded stream (open-loop arrival
    counts per drive slice). Knuth's product method below ~700 (exp
    underflow bound), normal approximation above."""
    if lam <= 0:
        return 0
    if lam > 700.0:
        return max(0, int(round(rng.gauss(lam, math.sqrt(lam)))))
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


@dataclasses.dataclass
class TortureReport:
    seed: int
    check: CheckResult
    ops: int
    op_counts: Dict[str, int]
    crashes: int
    msg_stats: Dict[str, int]
    nemesis_log: List[str]
    repro: str
    shed_ops: int = 0          # admission-refused arrivals (fail, no effect)
    open_loop_ops: int = 0     # open-loop arrivals generated in total
    membership_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    #   reconfiguration ops the membership plane actually started
    #   (grow/shrink/remove_leader/replace) — coverage evidence for the
    #   pinned seeds
    commit_digest: str = ""
    #   CRC over the committed log (indices, terms, payload bytes) at
    #   run end — the byte-identity witness for the observability
    #   determinism pin (recorder on == recorder off).
    bundle_path: Optional[str] = None
    #   forensics repro bundle, written iff the verdict was unexpected
    #   AND a bundle destination was configured (obs.forensics).
    obs: Optional[ObsStack] = None
    #   the run's observability plane when ``observe=True`` (flight
    #   recorder ring + span table + metrics registry), for callers
    #   that inspect signals beyond the bundle.

    @property
    def verdict(self) -> str:
        return self.check.verdict

    def summary(self) -> str:
        line = (
            f"seed {self.seed}: {self.verdict} over {self.ops} ops "
            f"({self.op_counts}), {self.crashes} crash cycles, "
            f"msg {self.msg_stats}"
        )
        if self.membership_ops:
            line += f", membership {self.membership_ops}"
        if self.verdict != LINEARIZABLE:
            line += f"\n  {self.check.detail}\n  REPRO: {self.repro}"
        return line


def _default_cfg(seed: int) -> RaftConfig:
    return RaftConfig(
        n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=128,
        transport="single", seed=seed,
    )


def _overload_cfg(seed: int) -> RaftConfig:
    """The torture config with admission armed: bounded queues + the
    delay controller, sized to the toy cluster (capacity 2 entries/s:
    batch 4 per 2 s tick). Depth 16 = 8 s of queue at capacity; the
    delay controller targets two ticks of sojourn judged over one
    election-timeout-scale interval."""
    return dataclasses.replace(
        _default_cfg(seed),
        admission_max_writes=16,
        admission_max_reads=64,
        admission_target_delay_s=4.0,
        admission_interval_s=20.0,
    )


def _membership_cfg(base: RaftConfig) -> RaftConfig:
    """Arm a torture config for the membership plane: two spare rows of
    headroom over the 3-voter start, so grow / replace always have a
    row to admit."""
    return dataclasses.replace(base, max_replicas=5)


def _reads_cfg(base: RaftConfig) -> RaftConfig:
    """Arm a torture config for the read scale-out plane: leader
    leases (which REQUIRE prevote — the §9.6 stickiness the lease
    safety argument rests on) under the default 2x drift bound."""
    return dataclasses.replace(base, prevote=True, read_lease=True)


#: admission-flavored refusal reasons: a span whose refusal trail hit
#: one of these closes as ``shed`` (typed load shedding), anything else
#: refused closes as plain ``failed``
_SHED_REASONS = {"depth", "delay", "fair_share", "read_depth",
                 "circuit_open"}


class _SpannedOp(OpRecord):
    """An OpRecord that closes its obs span on its own terminal event —
    every resolution path in the harness (poll, give-up, crash resolve,
    quiesce, ``History.close``) already funnels through ``ok``/``fail``/
    ``info``, so hooking here guarantees the span-completeness invariant
    (exactly one terminal span state per invoked op) by construction."""

    _span = None

    def ok(self, t, value=None):
        super().ok(t, value)
        if self._span is not None and not self._span.terminal:
            self._span.finish("ok", t)
        return self

    def fail(self, t):
        super().fail(t)
        if self._span is not None and not self._span.terminal:
            shed = bool(_SHED_REASONS & set(self._span.refusal_reasons))
            self._span.finish("shed" if shed else "failed", t)
        return self

    def info(self):
        super().info()
        if self._span is not None and not self._span.terminal:
            self._span.finish("info", None)
        return self


class _ObsHistory(History):
    """A History that opens one span per invoked op (closed by the
    record's terminal event — see _SpannedOp). The stamp/append logic
    stays in History.invoke (REC_CLS + _on_invoke hooks), so observed
    and plain runs share one timestamp discipline by construction."""

    REC_CLS = _SpannedOp

    def __init__(self, spans):
        super().__init__()
        self._spans = spans

    def _on_invoke(self, rec):
        rec._span = self._spans.begin(
            rec.op, rec.invoke_t, client=rec.client, key=rec.key
        )


class _Client:
    """One serial client: at most one op outstanding, its own rng."""

    def __init__(self, cid: int, seed: int, keys: List[bytes]):
        self.cid = cid
        self.rng = random.Random(f"client:{seed}:{cid}")
        self.keys = keys
        self.rec: Optional[OpRecord] = None
        self.ticket: Optional[int] = None   # read ticket (single-engine)
        self.seq = None                     # write seq (engine-specific)
        self.counter = 0

    def fresh_value(self) -> bytes:
        self.counter += 1
        return f"c{self.cid}v{self.counter}".encode()

    def pick(self) -> tuple:
        """(op, key, value) for the next invocation."""
        key = self.rng.choice(self.keys)
        roll = self.rng.random()
        if roll < 0.45:
            return WRITE, key, self.fresh_value()
        if roll < 0.52:
            return DELETE, key, None
        return READ, key, None


class _TortureBase:
    """Shared phase loop: invoke / drive / poll / nemesis / quiesce."""

    #: virtual seconds a client waits on one op before giving up. A
    #: write dropped across a leadership change never reads durable, and
    #: a serial client with no give-up would starve the workload for the
    #: rest of the run (seed sweeps showed 3-op histories). Giving up is
    #: recorded honestly: an abandoned write resolves ``info`` (it may
    #: STILL commit later — the unbounded interval covers that), an
    #: abandoned read ``fail`` (a read that served no value has no
    #: effect); the client then moves on.
    OP_TIMEOUT_S = 90.0

    def __init__(self, seed, phases, clients, keys, phase_s,
                 observe: bool = False, observe_device: bool = False,
                 audit: bool = False, observe_compile: bool = False,
                 device=None):
        self.seed = seed
        self.device = device
        self.phases = phases
        self.phase_s = phase_s
        # sentinel opt-in via env, the RAFT_TPU_FUSE_K pattern: arm the
        # compile plane without touching the harness call sites
        observe_compile = observe_compile or (
            (os.environ.get("RAFT_TPU_COMPILE_SENTINEL", "") or "0")
            != "0"
        )
        slo_objectives = None
        if audit:
            from raft_tpu_torch.obs.slo import SLObjective

            # a generic commit objective so the SLO plane evaluates
            # burn rates during the run (alerts are passive events)
            slo_objectives = (
                SLObjective("commit_p99", "commit",
                            threshold_s=10.0, target=0.99),
            )
        self.obs: Optional[ObsStack] = (
            ObsStack.build(device=observe_device, audit=audit,
                           slo_objectives=slo_objectives,
                           compile_plane=observe_compile)
            if (observe or observe_device or audit or observe_compile)
            else None
        )
        #   observe_compile additionally attaches the XLA plane
        #   (obs.compile CompileWatch + RetraceSentinel, obs.memory
        #   census). The sentinel freezes after the warmup phase
        #   (run_phases); crash-restore cycles after that must hit the
        #   process-wide program caches or violate. Determinism-neutral
        #   like every other plane (pinned in tests/test_compile_plane).
        #   observe_device additionally attaches the device-resident
        #   plane (obs.device in-kernel rings); it implies observe.
        #   audit additionally attaches the ONLINE safety plane
        #   (obs.audit.SafetyAuditor + obs.slo.SloTracker); it also
        #   implies observe. Both are determinism-neutral: every seeded
        #   run replays byte-identically with them on or off (pinned by
        #   tests/test_obs_plane.py and tests/test_audit.py).
        #   the observability plane (flight recorder + spans + metrics;
        #   docs/OBSERVABILITY.md). Recording is determinism-neutral:
        #   every seeded run replays byte-identically with it on or off
        #   (pinned by tests/test_obs_plane.py).
        self.history = (
            _ObsHistory(self.obs.spans) if self.obs is not None
            else History()
        )
        self.keys = [f"k{i}".encode() for i in range(keys)]
        self.clients = [_Client(c, seed, self.keys) for c in range(clients)]
        self.crashes = 0
        # open-loop overload state (only driven when a runner arms it)
        self.shed_ops = 0          # admission refusals (recorded fail)
        self.ol_submitted = 0      # open-loop arrivals generated
        self._ol_rate = 0.0        # arrivals/s while a window is open
        self._ol_counter = 0
        self._ol_rng = random.Random(f"openloop:{seed}")
        self._ol_pending: List[Tuple[OpRecord, object, float]] = []
        #   (record, engine-specific seq handle, invoke time) of admitted
        #   open-loop writes awaiting durability — bounded by the
        #   admission depth bound, which is what keeps the harness's own
        #   memory bounded under any offered load

    def _ambient_span(self, rec):
        """Context manager installing ``rec``'s span as the tracker's
        ambient trace context for the duration of a client call — the
        engine's submit/submit_read hooks bind seqs and refusal reasons
        to whatever span is ambient (obs.spans)."""
        if self.obs is None or rec is None:
            return contextlib.nullcontext()
        return self._set_current(getattr(rec, "_span", None))

    @contextlib.contextmanager
    def _set_current(self, span):
        self.obs.spans.current = span
        try:
            yield
        finally:
            self.obs.spans.current = None

    def commit_digest(self) -> str:
        """CRC over the committed log at run end (engine-specific) —
        the determinism witness the observability pin compares."""
        raise NotImplementedError

    def _give_up(self, cl: _Client) -> bool:
        """Client-side op timeout (see OP_TIMEOUT_S); True if resolved."""
        rec = cl.rec
        if rec is None or self.now() - rec.invoke_t <= self.OP_TIMEOUT_S:
            return False
        if rec.op == READ:
            rec.fail(self.history.stamp(self.now()))
        else:
            rec.info()
        cl.rec, cl.ticket, cl.seq = None, None, None
        return True

    # engine adapters ----------------------------------------------------
    def now(self) -> float:
        raise NotImplementedError

    def drive(self, seconds: float) -> None:
        raise NotImplementedError

    def invoke(self, cl: _Client) -> None:
        raise NotImplementedError

    def poll(self, cl: _Client) -> None:
        raise NotImplementedError

    def apply_nemesis(self, act: NemesisAction) -> None:
        raise NotImplementedError

    def quiesce(self) -> None:
        raise NotImplementedError

    def _ol_durable(self, handle) -> bool:
        """Engine-specific durability check for an open-loop write."""
        raise NotImplementedError

    def _poll_open_loop(self) -> None:
        keep = []
        for rec, handle, t0 in self._ol_pending:
            if self._ol_durable(handle):
                rec.ok(self.history.stamp(self.now()))
            elif self.now() - t0 > self.OP_TIMEOUT_S:
                rec.info()     # may still commit: both worlds stay open
            else:
                keep.append((rec, handle, t0))
        self._ol_pending = keep

    def _resolve_open_loop_info(self) -> None:
        """Crash path: every admitted-but-unresolved open-loop write may
        or may not have committed — close as info."""
        for rec, _, _ in self._ol_pending:
            rec.info()
        self._ol_pending = []

    # the loop -----------------------------------------------------------
    def _poll_all(self) -> None:
        for cl in self.clients:
            if cl.rec is not None:
                self.poll(cl)
        if self._ol_pending:
            self._poll_open_loop()

    def _invoke_idle(self) -> None:
        for cl in self.clients:
            if cl.rec is None:
                self.invoke(cl)

    def pump_open_loop(self, dt: float) -> None:
        """Open-loop arrival hook, called once per drive slice; the
        base workload is closed-loop only (overload runners override)."""

    def pump_membership(self) -> None:
        """Membership-plane housekeeping hook, called once per drive
        slice (wipe-replace rejoin timing — see _SingleTorture)."""

    def pump_broken(self) -> None:
        """Broken-variant hook, called once per drive slice (the
        ``commit_rewind`` fault injection — see _SingleTorture)."""

    def _audit_read(self, client: int, key: bytes,
                    value, group=None) -> None:
        """Report one SERVED read to the online auditor (no-op when the
        audit plane is detached) — the serve-side half of the per-client
        monotone-read watermark."""
        obs = self.obs
        if obs is not None and obs.audit is not None:
            obs.audit.observe_read(client, key, value, self.now(),
                                   group=group)

    def membership_view(self) -> Optional[MembershipView]:
        """The nemesis's configuration snapshot; None = plane disabled
        (the default — membership kinds never enter the choice pool)."""
        return None

    def run_phases(self, nemesis: Nemesis) -> None:
        try:
            for phase_no in range(self.phases):
                self._invoke_idle()
                act = nemesis.next_action(
                    self.members(), self.alive_map(), self.partitioned,
                    self.now(), membership=self.membership_view(),
                )
                # blackbox progress mark (no-op without a journal): a
                # run killed externally mid-phase leaves WHICH phase and
                # which nemesis action it was executing in the journal
                blackbox.mark(
                    "torture_phase", phase_no=phase_no,
                    action=act.describe(),
                    t_virtual=round(self.now(), 3), ops=len(self.history),
                )
                self.apply_nemesis(act)
                # drive in slices so completions are stamped near the
                # event that produced them, not at phase granularity
                for _ in range(4):
                    self.pump_open_loop(self.phase_s / 4)
                    self.drive(self.phase_s / 4)
                    self.pump_membership()
                    self.pump_broken()
                    self._poll_all()
                    self._invoke_idle()
                if phase_no == 0:
                    self._freeze_compile_plane()
            blackbox.mark("quiesce", t_virtual=round(self.now(), 3),
                          ops=len(self.history), crashes=self.crashes)
            self.quiesce()
            self.history.close()
            obs = self.obs
            if (obs is not None and obs.memory is not None
                    and obs.memory.baseline is not None):
                # the flatness verdict must be taken NOW, while the
                # final engine generation is still alive — after the
                # run object dies the census only shows teardown
                obs.memory.final_drift = obs.memory.drift()
        finally:
            if self.obs is not None:
                self.obs.close()   # detach the process-global compile
                #                    hook; the stats stay readable

    def _freeze_compile_plane(self) -> None:
        """Warmup over (one full nemesis phase drove every program the
        run will steady-state on): pin the memory baseline and freeze
        the retrace sentinel — every later hot-path compile is a
        violation, every census drift a potential leak."""
        obs = self.obs
        if obs is None:
            return
        if obs.memory is not None:
            obs.memory.set_baseline()
        if obs.compile is not None and obs.compile.sentinel is not None:
            obs.compile.sentinel.freeze()
            blackbox.mark(
                "compile_sentinel_frozen",
                compiles=obs.compile.total_compiles,
            )


def torture_run(
    seed: int,
    phases: int = 12,
    clients: int = 3,
    keys: int = 4,
    phase_s: float = 30.0,
    cfg: Optional[RaftConfig] = None,
    workdir: Optional[str] = None,
    crash: bool = True,
    msg_faults: bool = True,
    storage_faults: bool = True,
    broken: Optional[str] = None,
    overload: bool = False,
    membership: bool = False,
    reads: bool = False,
    step_budget: int = 500_000,
    observe: bool = False,
    observe_device: bool = False,
    audit: bool = False,
    observe_compile: bool = False,
    bundle_dir: Optional[str] = None,
    blackbox_dir: Optional[str] = None,
    device=None,
) -> TortureReport:
    """One full single-engine torture run; see module docstring.
    ``device`` is the engine's (CUDA unless ``"cpu"``).
    ``observe_compile=True`` (or env ``RAFT_TPU_COMPILE_SENTINEL=1``)
    attaches the XLA compile-and-memory plane: every trace/compile is
    recorded per program label, the RetraceSentinel freezes after the
    warmup phase (any later hot-path compile is a typed violation), and
    the device-memory census baselines there (drift = leak candidate).
    Determinism-neutral like every other plane.
    ``audit=True`` attaches the ONLINE safety plane — the
    ``obs.audit.SafetyAuditor`` invariant checks plus the
    ``obs.slo.SloTracker`` latency/burn-rate plane (implies observe;
    determinism-neutral, pinned) — reachable afterwards as
    ``report.obs.audit`` / ``report.obs.slo``.
    ``overload=True`` arms admission (``_overload_cfg`` unless ``cfg``
    is given) and lets the nemesis open 2-10x open-loop arrival
    windows, composable with every other fault plane.
    ``membership=True`` arms the reconfiguration plane: a
    membership-headroom config (``_membership_cfg`` unless ``cfg`` is
    given) and nemesis grow/shrink/remove-the-leader/wipe-replace
    cycles, composed with every other plane — client-visible
    linearizability under reconfiguration is the property under test.
    ``observe=True`` attaches the observability plane (flight recorder,
    per-op spans, metrics registry — determinism-neutral, pinned);
    ``bundle_dir`` (or ``RAFT_TPU_BUNDLE_DIR``) arms forensics: a
    verdict other than LINEARIZABLE auto-writes a repro bundle that
    ``python -m raft_tpu_torch.obs --explain`` reconstructs without
    re-running the seed. ``blackbox_dir`` (or ``RAFT_TPU_BLACKBOX_DIR``)
    arms the black-box progress journal (obs.blackbox): a per-process
    append-only file of phase marks — nemesis actions, crash-restore
    cycles, quiesce, the checker — that SURVIVES both engine crash
    cycles and an external kill of the harness itself."""
    base = _overload_cfg(seed) if overload else _default_cfg(seed)
    if membership and cfg is None:
        base = _membership_cfg(base)
    if reads and cfg is None:
        base = _reads_cfg(base)
    with blackbox.journal_for(f"torture_seed{seed}", blackbox_dir):
        blackbox.mark("torture_run", seed=seed, phases=phases,
                      clients=clients, keys=keys)
        run = _SingleTorture(
            seed, phases, clients, keys, phase_s,
            cfg or base, workdir, broken, membership=membership,
            reads=reads,
            observe=observe, observe_device=observe_device, audit=audit,
            observe_compile=observe_compile, device=device,
        )
        nemesis = Nemesis(
            seed, run.cfg.rows, allow_crash=crash, allow_msg=msg_faults,
            allow_storage=storage_faults, allow_overload=overload,
            allow_membership=membership,
            allow_clock=reads,
            clock_drift_bound=run.cfg.clock_drift_bound,
        )
        run.run_phases(nemesis)
        blackbox.mark("check_history", ops=len(run.history),
                      step_budget=step_budget)
        check = check_history(run.history, step_budget=step_budget)
        blackbox.mark("check_done", verdict=check.verdict)
    flags = []
    if not crash:
        flags.append("--no-crash")
    if not msg_faults:
        flags.append("--no-msg")
    if not storage_faults:
        flags.append("--no-storage")
    if broken:
        flags.append(f"--broken {broken}")
    if overload:
        flags.append("--overload")
    if membership:
        flags.append("--membership")
    if reads:
        flags.append("--read-plane")
    if audit:
        flags.append("--audit")
    if observe_compile:
        flags.append("--observe-compile")
    repro = (
        f"python -m raft_tpu_torch.chaos --seed {seed} --phases {phases} "
        f"--clients {clients} --keys {keys} --phase-s {phase_s:g}"
        + ("".join(" " + f for f in flags))
    )
    bundle_path = _maybe_bundle(
        "torture", run, check, LINEARIZABLE, repro, nemesis.log, bundle_dir,
        extra={"crashes": run.crashes, "shed_ops": run.shed_ops,
               "open_loop_ops": run.ol_submitted,
               "membership_ops": run.membership_ops},
    )
    report = TortureReport(
        seed=seed, check=check, ops=len(run.history),
        op_counts=run.history.counts(), crashes=run.crashes,
        msg_stats=run.chaos_t.stats, nemesis_log=nemesis.log, repro=repro,
        shed_ops=run.shed_ops, open_loop_ops=run.ol_submitted,
        membership_ops=run.membership_ops,
        commit_digest=run.commit_digest(), bundle_path=bundle_path,
        obs=run.obs,
    )
    # the run is over and its engine with it: the next run of this shape
    # replays its graphs (JAX's process-wide cache serves a second run)
    run.chaos_t.t.release()
    return report


def _maybe_bundle(
    kind: str, run: "_TortureBase", check: CheckResult, expected: str,
    repro: str, nemesis_log: List[str], bundle_dir: Optional[str],
    extra: Optional[dict] = None, force_unexpected: bool = False,
) -> Optional[str]:
    """Forensics hook shared by every chaos entry point: when the run
    ended in anything but its expected verdict (or the runner flags the
    outcome unexpected for a non-verdict reason, e.g. a missed recovery
    window) and a bundle destination is configured, dump the repro
    bundle. Never raises into the run's own reporting path — a bundle
    that cannot be written (unwritable RAFT_TPU_BUNDLE_DIR, full disk)
    must not destroy the report it was meant to preserve."""
    bdir = resolve_bundle_dir(bundle_dir)
    if bdir is None or (check.verdict == expected and not force_unexpected):
        return None
    try:
        return write_bundle(
            bdir, kind=kind, seed=run.seed, expected=expected,
            verdict=check.verdict, detail=check.detail,
            violation_key=check.key, repro=repro, config=run.cfg,
            nemesis_log=nemesis_log, history=run.history, obs=run.obs,
            extra=extra,
        )
    except OSError as ex:
        import sys

        print(f"raft_tpu_torch.obs: repro bundle not written to {bdir!r}: "
              f"{ex}", file=sys.stderr)
        return None


class _SingleTorture(_TortureBase):
    def __init__(self, seed, phases, clients, keys, phase_s, cfg,
                 workdir, broken, membership: bool = False,
                 reads: bool = False,
                 observe: bool = False, observe_device: bool = False,
                 audit: bool = False, observe_compile: bool = False,
                 device=None):
        super().__init__(seed, phases, clients, keys, phase_s,
                         observe=observe, observe_device=observe_device,
                         audit=audit, observe_compile=observe_compile,
                         device=device)

        self.cfg = cfg
        self.broken = broken
        self.membership = membership
        self.reads = reads or cfg.read_lease
        #   read scale-out plane: lease-class serves come from the
        #   harness's VERSIONED applied store at the index the engine
        #   returned (_value_at) — a stale leader's frozen commit view
        #   then really serves stale bytes, exactly as its local state
        #   machine would in a deployment; the shared in-process KV
        #   would otherwise mask the staleness the skew nemesis exists
        #   to produce.
        self._vidx: Dict[bytes, List[int]] = {}
        self._vval: Dict[bytes, List[Optional[bytes]]] = {}
        self._vmax = 0
        self.membership_ops: Dict[str, int] = {}
        self._wipe_rejoin: set = set()
        #   rows awaiting recovery after a wipe-replace: a wiped row must
        #   stay down until its old voter identity leaves the
        #   configuration (the engine's recover guard), then rejoins as
        #   a fresh learner
        self._tmp = None
        if workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="raft_torture_")
            workdir = self._tmp.name
        self.store = MirroredStore(workdir, mirrors=2)
        self.storage_rng = random.Random(f"storage:{seed}")
        self.chaos_t = ChaosTransport(self._fresh_base(), seed)
        self._msg_params = None
        self.partitioned = False
        self._broken_rng = random.Random(f"broken:{seed}")
        #   the commit_rewind variant's own seeded stream (deterministic
        #   fault timing independent of the workload draws)
        self._boot_fresh()
        # dirty-read oracle for the broken variant: key -> last value
        # SUBMITTED (not committed) — exactly the cache a naive server
        # would serve reads from without waiting for consensus
        self._dirty: Dict[bytes, Optional[bytes]] = {}

    # -------------------------------------------------------------- boot
    def _boot_fresh(self) -> None:
        from raft_tpu_torch.examples.kv import ReplicatedKV
        from raft_tpu_torch.raft.engine import RaftEngine

        self.engine = RaftEngine(
            self.cfg, self.chaos_t, vote_log=self.store.votelog_path,
            recorder=self.obs.recorder if self.obs is not None else None,
        )
        if self.obs is not None:
            self.obs.attach(self.engine)
        if self.broken == "lease_skew" and self.engine.lease is not None:
            # the deliberately broken plane: drift bound ignored (a
            # deployment that assumed perfect clocks) — re-armed on
            # every boot so crash-restore cycles stay broken
            self.engine.lease.ignore_drift = True
        self.kv = ReplicatedKV(self.engine)
        self._register_audit_apply()
        self._register_version_feed()
        self.engine.run_until_leader()

    def _register_audit_apply(self) -> None:
        """With the online audit plane attached, feed every applied KV
        op to the auditor (value -> applied index per key — the lookup
        table the serve-side read audits consult). Registered AFTER the
        KV store so serve order matches apply order."""
        if self.obs is None or self.obs.audit is None:
            return
        from raft_tpu_torch.examples.kv import decode_op

        auditor = self.obs.audit

        def _feed(idx: int, payload: bytes) -> None:
            op, key, value = decode_op(payload)
            if op:
                auditor.note_apply(key, idx, value)

        self.engine.register_apply(_feed)

    def _register_version_feed(self) -> None:
        """With the read plane armed, keep a per-key VERSIONED applied
        store (idx -> value lists): lease-class reads serve from it at
        the engine's returned index (_value_at). Idempotent on replay
        (committed idx -> value is stable across crash-restore), so one
        version map spans the whole run like the auditor."""
        if not self.reads:
            return
        from raft_tpu_torch.examples.kv import decode_op

        def _feed(idx: int, payload: bytes) -> None:
            if idx <= self._vmax:
                return
            self._vmax = idx
            op, key, value = decode_op(payload)
            if op:
                self._vidx.setdefault(key, []).append(idx)
                self._vval.setdefault(key, []).append(value)

        self.engine.register_apply(_feed, replay=True)

    def _value_at(self, key: bytes, idx: int) -> Optional[bytes]:
        """The key's applied value as of log index ``idx`` — what a
        replica whose state machine stopped at ``idx`` would serve."""
        import bisect

        vi = self._vidx.get(key)
        if not vi:
            return None
        i = bisect.bisect_right(vi, idx)
        return self._vval[key][i - 1] if i else None

    def _restart(self) -> None:
        from raft_tpu_torch.examples.kv import ReplicatedKV
        from raft_tpu_torch.raft.engine import RaftEngine

        t0 = self.now()
        # write-before-block: the restore path replays checkpoints and
        # re-elects — if the process dies or wedges inside it, the
        # journal (which, being a per-process append-only file, SURVIVES
        # the engine's crash-restore cycle by construction) says so
        blackbox.mark("crash_restore", crashes=self.crashes,
                      t_virtual=round(t0, 3))
        path, _, _rejected = self.store.load_best()
        # the crashed engine is dead: its rings, staging buffer and CUDA
        # graphs go to the restored one (no capture anew on the card)
        self.chaos_t.t.release()
        old_stats = self.chaos_t.stats
        self.chaos_t = ChaosTransport(
            self._fresh_base(), self.seed * 1000 + self.crashes
        )
        for k, v in old_stats.items():   # stats survive the restart
            self.chaos_t.stats[k] += v
        self.engine = RaftEngine.restore(
            self.cfg, path, self.chaos_t,
            vote_log=self.store.votelog_path,
            recorder=self.obs.recorder if self.obs is not None else None,
        )
        if self.obs is not None:
            self.obs.attach(self.engine)
            #   one recorder/span/metric plane spans crash-restore
            #   cycles: the ring keeps pre-crash events, the restored
            #   engine keeps appending
        # carry virtual time forward: a restart must not rewind the
        # history clock (heap entries armed below t0 simply fire "now")
        self.engine.clock.now = t0
        if self.broken == "lease_skew" and self.engine.lease is not None:
            self.engine.lease.ignore_drift = True
        self.kv = ReplicatedKV(self.engine, replay=True)
        self._register_audit_apply()
        self._register_version_feed()
        if self._msg_params is not None:
            self.chaos_t.set_message_faults(*self._msg_params)
        self.partitioned = False
        self.engine.run_until_leader()

    def _fresh_base(self):
        from raft_tpu_torch.transport.device import SingleDeviceTransport

        return SingleDeviceTransport(self.cfg, device=self.device)

    # ----------------------------------------------------------- adapters
    def members(self) -> List[int]:
        return [r for r in range(self.cfg.rows) if self.engine.member[r]]

    def alive_map(self) -> Dict[int, bool]:
        return {r: bool(self.engine.alive[r]) for r in range(self.cfg.rows)}

    def now(self) -> float:
        return self.engine.clock.now

    def drive(self, seconds: float) -> None:
        self.engine.run_for(seconds)

    # ------------------------------------------------------ open loop
    @property
    def capacity_eps(self) -> float:
        """Measured ingest capacity (entries/s): a leader tick drains at
        most one batch, so batch_size per heartbeat_period is the most
        the cluster can commit sustained — the base the nemesis's 2-10x
        multipliers scale."""
        return self.cfg.batch_size / self.cfg.heartbeat_period

    def set_overload_rate(self, rate_mult: float) -> None:
        self._ol_rate = rate_mult * self.capacity_eps

    def pump_open_loop(self, dt: float) -> None:
        """Poisson(rate * dt) one-shot writers, each its own client id
        (fully concurrent — the open-loop model). A refusal resolves
        ``fail`` immediately: ``Overloaded`` raises before anything is
        queued, so no-effect is provable."""
        if self._ol_rate <= 0:
            return
        n = poisson(self._ol_rng, self._ol_rate * dt)
        for _ in range(n):
            self._ol_counter += 1
            self.ol_submitted += 1
            cid = 1000 + self._ol_counter
            key = self._ol_rng.choice(self.keys)
            value = f"ol{self._ol_counter}".encode()
            rec = self.history.invoke(cid, WRITE, key, value, self.now())
            try:
                with self._ambient_span(rec):
                    seq = self.kv.set(key, value, client=cid)
            except Overloaded:
                self.shed_ops += 1
                rec.fail(self.history.stamp(self.now()))
                continue
            self._ol_pending.append((rec, seq, self.now()))

    def _ol_durable(self, handle) -> bool:
        return self.engine.is_durable(handle)

    def commit_digest(self) -> str:
        # Composed from per-entry payload CRCs (idx : term : crc32 of
        # bytes) so the online auditor can reproduce the identical
        # digest from its own incremental records
        # (SafetyAuditor.commit_digest — the cross-check pinned by
        # tests/test_audit.py). Same coverage as before: the archive's
        # contiguous tail below the watermark.
        e = self.engine
        wm = int(e.commit_watermark)
        crc = zlib.crc32(f"wm:{wm}".encode())
        if wm:
            for idx in range(e.store.covered_lo(wm), wm + 1):
                ent = e.store.get(idx)
                if ent is not None:
                    crc = zlib.crc32(
                        f"{idx}:{ent[1]}:{zlib.crc32(ent[0]):08x}"
                        .encode(),
                        crc,
                    )
        return f"{crc:08x}"

    def pump_broken(self) -> None:
        """The broken-COMMIT variant (``broken="commit_rewind"``): a
        server whose storage layer silently loses acknowledged commits
        — the commit watermark rewinds by up to a batch and the rewound
        entries' durability stamps vanish, as if an fsync had lied.
        The device log is untouched, so the watermark re-advances on
        the next tick and applied state stays consistent: the OFFLINE
        checker usually cannot see this fault at all (no client-visible
        read serves the regression), which is exactly the
        falsifiability point — the ONLINE auditor's commit-monotonicity
        watermark must trip DURING the run
        (tests/test_audit.py::test_commit_rewind_trips_auditor_online)."""
        if self.broken != "commit_rewind":
            return
        e = self.engine
        if self._broken_rng.random() > 0.5 or e.commit_watermark < 4:
            return
        k = self._broken_rng.randint(1, min(self.cfg.batch_size,
                                            e.commit_watermark - 1))
        e.commit_watermark -= k
        # the "lost" acks: drop the newest k durability stamps (dict
        # order is stamp order) — the durability API now denies entries
        # it already acknowledged, the broken half the auditor flags
        for seq in list(e.commit_time)[-k:]:
            del e.commit_time[seq]

    def invoke(self, cl: _Client) -> None:
        from raft_tpu_torch.raft.engine import LinearizableReadRefused

        op, key, value = cl.pick()
        if op == READ:
            cl.rec = self.history.invoke(cl.cid, READ, key, None, self.now())
            if self.broken == "dirty_reads":
                # deliberately broken: no leadership confirmation, no
                # apply wait — half the reads serve the latest SUBMITTED
                # (possibly uncommitted) value, half the applied state.
                # A dirty read of an in-flight write followed by an
                # applied read of the same key before it commits (or a
                # crash that loses it) is the unjustifiable pair the
                # checker must reject.
                if cl.rng.random() < 0.5 and key in self._dirty:
                    value = self._dirty[key]
                else:
                    value = self.kv.get(key)
                self._audit_read(cl.cid, key, value)
                cl.rec.ok(self.history.stamp(self.now()), value)
                cl.rec = None
                return
            try:
                with self._ambient_span(cl.rec):
                    cl.ticket = self.engine.submit_read()
                cl.rec.read_class = self.engine.read_ticket_class(
                    cl.ticket
                )
                #   the served class (lease = zero-round local serve,
                #   read_index = quorum-confirmed) rides the OpRecord so
                #   the checker can grade each class against its own
                #   model (chaos.checker.check_read_classes)
            except (LinearizableReadRefused, Overloaded):
                # refused before any effect (read-lane admission refuses
                # before minting a ticket)
                cl.rec.fail(self.history.stamp(self.now()))
                cl.rec, cl.ticket = None, None
            return
        cl.rec = self.history.invoke(cl.cid, op, key, value, self.now())
        try:
            with self._ambient_span(cl.rec):
                cl.seq = (
                    self.kv.set(key, value, client=cl.cid) if op == WRITE
                    else self.kv.delete(key, client=cl.cid)
                )
        except Overloaded:
            # shed before queueing: provably no effect
            self.shed_ops += 1
            cl.rec.fail(self.history.stamp(self.now()))
            cl.rec, cl.seq = None, None
            return
        self._dirty[key] = value if op == WRITE else None

    def poll(self, cl: _Client) -> None:
        from raft_tpu_torch.raft.engine import LinearizableReadRefused

        if self._give_up(cl):
            return
        rec = cl.rec
        if rec.op == READ:
            if isinstance(cl.ticket, tuple):
                idx = cl.ticket[1]     # confirmed, waiting on the apply
            else:
                try:
                    idx = self.engine.read_confirmed(cl.ticket)
                except LinearizableReadRefused:
                    rec.fail(self.history.stamp(self.now()))
                    cl.rec, cl.ticket = None, None
                    return
                if idx is None:
                    return
                # confirmed; tickets are poll-once, so note the bound —
                # the value may only serve once applied state covers it
                cl.ticket = ("applied", idx)
            if self.kv.last_applied < idx:
                return
            if self.reads and getattr(rec, "read_class", None) == "lease":
                # a lease serve reads the LEADER'S OWN applied view at
                # the index its lease certified — the versioned store
                # makes a stale frozen index really serve stale bytes
                # (see __init__; this is the skew nemesis's teeth)
                value = self._value_at(rec.key, idx)
            else:
                value = self.kv.get(rec.key)
            self._audit_read(cl.cid, rec.key, value)
            rec.ok(self.history.stamp(self.now()), value)
            cl.rec, cl.ticket = None, None
            return
        if self.engine.is_durable(cl.seq):
            rec.ok(self.history.stamp(self.now()))
            cl.rec, cl.seq = None, None

    def apply_nemesis(self, act: NemesisAction) -> None:
        e = self.engine
        if act.kind == "kill":
            e.fail(act.replica)
        elif act.kind == "recover":
            e.recover(act.replica)
        elif act.kind == "slow":
            e.set_slow(act.replica, True)
        elif act.kind == "unslow":
            e.set_slow(act.replica, False)
        elif act.kind == "campaign":
            e.force_campaign(act.replica)
        elif act.kind == "partition":
            e.partition(act.groups)
            self.partitioned = True
        elif act.kind == "heal":
            e.heal_partition()
            self.partitioned = False
        elif act.kind == "plan":
            e.schedule_faults(act.plan)
        elif act.kind == "msg_on":
            self._msg_params = (act.drop, act.dup, act.delay)
            self.chaos_t.set_message_faults(*self._msg_params)
        elif act.kind == "msg_off":
            self._msg_params = None
            self.chaos_t.clear_message_faults()
        elif act.kind == "crash_restart":
            self._crash_restart(act.storage)
        elif act.kind == "overload_on":
            self.set_overload_rate(act.rate_mult)
        elif act.kind == "overload_off":
            self._ol_rate = 0.0
        elif act.kind == "skew_on":
            e.set_lease_rate(act.replica, act.rate)
        elif act.kind == "skew_off":
            e.set_lease_rate(act.replica, 1.0)
        elif act.kind == "mem_grow":
            self._mem_op("grow", lambda: e.add_server(act.replica))
        elif act.kind == "mem_shrink":
            self._mem_op("shrink", lambda: e.remove_server(act.replica))
        elif act.kind == "mem_remove_leader":
            lead = e.leader_id
            if lead is not None and e.member[lead]:
                self._mem_op(
                    "remove_leader", lambda: e.remove_server(lead)
                )
        elif act.kind == "mem_replace":
            self._mem_replace(act.replica, act.spare)

    # -------------------------------------------------- membership plane
    def membership_view(self) -> Optional[MembershipView]:
        if not self.membership:
            return None
        e = self.engine
        rows = range(self.cfg.rows)
        return MembershipView(
            voters=[r for r in rows if e.member[r]],
            learners=[r for r in rows if e.learner[r]],
            spares=[
                r for r in rows if not e.member[r] and not e.learner[r]
            ],
            leader=e.leader_id,
            in_flight=(
                e._pending_config is not None
                or bool(e._staged_config)
                or any(q in e._config_seqs for q, _ in e._queue)
            ),
        )

    def _mem_op(self, name: str, fn) -> bool:
        """Run one reconfiguration op; an engine refusal (leadership
        gap, change already in flight, admission shedding under an
        overload window) is a logged no-op — the nemesis gates on a
        snapshot that may have gone stale by apply time."""
        try:
            fn()
        except (RuntimeError, ValueError, Overloaded):
            return False
        self.membership_ops[name] = self.membership_ops.get(name, 0) + 1
        return True

    def _mem_replace(self, victim: int, spare: int) -> None:
        """The wipe-replace cycle: crash the victim if needed, start the
        replace ladder (removal now, learner re-admission + promotion
        staged behind it), and only once the ladder is ACCEPTED destroy
        the victim's durable state in full (device row + checkpoint
        mirrors + vote WAL). Ordering matters: replace() can be refused
        (leadership gap, admission shedding under a composed overload
        window), and wiping first would strand a wiped, still-configured
        voter that nothing may ever restart. A refusal therefore leaves
        an ordinary crashed — recoverable — member behind. The rejoining
        row stays down until its old identity durably leaves the
        configuration (``pump_membership`` recovers it)."""
        e = self.engine
        if not e.member[victim]:
            return
        if e.alive[victim]:
            e.fail(victim)
        if self._mem_op("replace", lambda: e.replace(victim, spare)):
            e.wipe(victim)
            self.store.wipe_node(victim)
            self._wipe_rejoin.add(spare)
            if spare != victim:
                self._wipe_rejoin.add(victim)
                #   the removed row itself restarts as an unconfigured
                #   spare once its removal commits — future grows may
                #   re-admit it

    def pump_membership(self) -> None:
        if not self._wipe_rejoin:
            return
        e = self.engine
        for v in list(self._wipe_rejoin):
            if e.alive[v]:
                self._wipe_rejoin.discard(v)
            elif not e.member[v]:
                # the old voter identity has left the configuration:
                # the row may now restart (fresh learner rejoin)
                e.recover(v)
                if e.alive[v]:
                    self._wipe_rejoin.discard(v)

    def _crash_restart(self, storage: str) -> None:
        # resolve in-flight ops against the dying engine: writes may
        # have committed unobserved (info — both worlds stay open);
        # reads never returned (fail — no effect to account for)
        for cl in self.clients:
            if cl.rec is None:
                continue
            if cl.rec.op == READ:
                cl.rec.fail(self.history.stamp(self.now()))
            else:
                cl.rec.info()
            cl.rec, cl.ticket, cl.seq = None, None, None
        self._resolve_open_loop_info()
        self.store.save(self.engine)
        if storage == "tear_votelog":
            self.store.tear_votelog(self.storage_rng)
        elif storage == "flip_bit":
            self.store.flip_bit(
                self.storage_rng.randrange(self.store.mirrors),
                self.storage_rng,
            )
        elif storage == "rollback":
            self.store.rollback(
                self.storage_rng.randrange(self.store.mirrors)
            )
        self.crashes += 1
        self._restart()

    def quiesce(self) -> None:
        """Heal every fault plane, then resolve all outstanding ops."""
        e = self.engine
        self._ol_rate = 0.0        # overload window ends with the run
        self._msg_params = None
        self.chaos_t.clear_message_faults()
        e.heal_partition()
        self.partitioned = False
        self.pump_membership()   # wiped rows that may legally restart, do
        for r in range(self.cfg.rows):
            if (e.member[r] or e.learner[r]) and not e.alive[r]:
                # recover() quietly refuses wiped still-configured voters
                # (their replace ladder may not have committed); the
                # quorum-liveness gating guarantees a live voter
                # majority without them, so the probe below still lands
                e.recover(r)
            e.set_slow(r, False)
        probe = None
        for _ in range(200):
            try:
                probe = e.submit(bytes(self.cfg.entry_bytes))
                break
            except Overloaded:
                # the gate is still draining the overload backlog; give
                # it ticks — arrivals have stopped, so depth and delay
                # both fall monotonically from here
                e.run_for(2 * self.cfg.heartbeat_period)
                self._poll_all()
        assert probe is not None, "admission never re-opened at quiesce"
        e.run_until_committed(probe, limit=3000.0)
        for _ in range(40):
            self._poll_all()
            if all(cl.rec is None for cl in self.clients):
                break
            e.run_for(4 * self.cfg.heartbeat_period)
        # anything still unresolved closes as info/fail via History.close
        for cl in self.clients:
            if cl.rec is not None and cl.rec.op == READ:
                cl.rec.fail(self.history.stamp(self.now()))
                cl.rec, cl.ticket = None, None


def torture_run_multi(
    seed: int,
    n_groups: int = 4,
    phases: int = 10,
    clients: int = 3,
    keys: int = 6,
    phase_s: float = 30.0,
    cfg: Optional[RaftConfig] = None,
    overload: bool = False,
    step_budget: int = 500_000,
    observe: bool = False,
    observe_device: bool = False,
    audit: bool = False,
    observe_compile: bool = False,
    bundle_dir: Optional[str] = None,
    blackbox_dir: Optional[str] = None,
    device=None,
    mesh=None,
) -> TortureReport:
    """Multi-Raft torture: the sharded Router/ShardedKV client surface
    under per-group process faults. No crash cycles or message faults —
    ``MultiEngine`` has no checkpoint/restore or pluggable transport yet
    (its module docstring scopes both); per-key histories across groups
    are the point: the Router must keep every key's subhistory
    linearizable while sibling groups fail independently.
    ``overload=True`` arms the per-group queue bounds and lets the
    nemesis open open-loop arrival windows routed through a no-retry
    Router (shed = ``fail``, same soundness argument as the single
    engine). ``device`` and ``mesh`` place the ``MultiEngine`` (CUDA
    unless ``"cpu"``; a ``GroupMesh`` with a ``mesh_groups`` config)."""
    with blackbox.journal_for(f"torture_multi_seed{seed}", blackbox_dir):
        blackbox.mark("torture_run_multi", seed=seed, n_groups=n_groups,
                      phases=phases)
        run = _MultiTorture(
            seed, phases, clients, keys, phase_s, cfg, n_groups,
            overload=overload, observe=observe,
            observe_device=observe_device, audit=audit,
            observe_compile=observe_compile, device=device, mesh=mesh,
        )
        nemesis = Nemesis(
            seed, run.cfg.n_replicas, allow_crash=False, allow_msg=False,
            allow_storage=False, allow_overload=overload,
        )
        run.run_phases(nemesis)
        blackbox.mark("check_history", ops=len(run.history))
        check = check_history(run.history, step_budget=step_budget)
        blackbox.mark("check_done", verdict=check.verdict)
    repro = (
        f"python -m raft_tpu_torch.chaos --seed {seed} --multi "
        f"--groups {n_groups} --phases {phases} --clients {clients} "
        f"--keys {keys} --phase-s {phase_s:g}"
        + (" --overload" if overload else "")
    )
    bundle_path = _maybe_bundle(
        "torture_multi", run, check, LINEARIZABLE, repro, nemesis.log,
        bundle_dir,
        extra={"n_groups": n_groups, "shed_ops": run.shed_ops,
               "open_loop_ops": run.ol_submitted},
    )
    return TortureReport(
        seed=seed, check=check, ops=len(run.history),
        op_counts=run.history.counts(), crashes=0,
        msg_stats={}, nemesis_log=nemesis.log, repro=repro,
        shed_ops=run.shed_ops, open_loop_ops=run.ol_submitted,
        commit_digest=run.commit_digest(), bundle_path=bundle_path,
        obs=run.obs,
    )


class _MultiTorture(_TortureBase):
    def __init__(self, seed, phases, clients, keys, phase_s, cfg, n_groups,
                 overload: bool = False, observe: bool = False,
                 observe_device: bool = False, audit: bool = False,
                 observe_compile: bool = False, device=None, mesh=None):
        super().__init__(seed, phases, clients, keys, phase_s,
                         observe=observe, observe_device=observe_device,
                         audit=audit, observe_compile=observe_compile,
                         device=device)
        from raft_tpu_torch.examples.kv_sharded import ShardedKV
        from raft_tpu_torch.multi.engine import MultiEngine
        from raft_tpu_torch.multi.router import Router

        self.cfg = cfg or RaftConfig(
            n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=128,
            transport="single", seed=seed,
            admission_max_writes=(16 if overload else None),
        )
        obs = self.obs
        self.engine = MultiEngine(
            self.cfg, n_groups,
            recorder=obs.recorder if obs is not None else None,
            mesh=mesh, device=device,
        )
        if obs is not None:
            self.engine.metrics = obs.registry
            if obs.audit is not None:
                self.engine.auditor = obs.audit
                self.engine.slo = obs.slo
            if obs.device is not None:
                self.engine.attach_device_obs(obs.device)
            if obs.memory is not None:
                # the multi path wires the stack by hand (no
                # ObsStack.attach); the memory census still needs its
                # roots or every engine buffer reads as a leak
                obs.memory.watch_engine(self.engine, name="multi")
        self.engine.seed_leaders()
        spans = obs.spans if obs is not None else None
        self.router = Router(self.engine, spans=spans)
        self._ol_router = Router(self.engine, max_retries=0, spans=spans)
        #   open-loop arrivals do not retry: a refused one-shot writer
        #   is SHED (fail, no effect) — retrying it would re-close the
        #   loop the overload model exists to open
        self.kv = ShardedKV(self.engine, self.router)
        if obs is not None and obs.audit is not None:
            from raft_tpu_torch.examples.kv import decode_op

            auditor = obs.audit

            def _make_feed(g: int):
                def _feed(idx: int, payload: bytes) -> None:
                    op, key, value = decode_op(payload)
                    if op:
                        auditor.note_apply(key, idx, value, group=g)
                return _feed

            for g in range(self.engine.G):
                self.engine.register_apply(g, _make_feed(g))
        self.partitioned = False
        self._part_group: Optional[int] = None
        self.nem_rng = random.Random(f"multi-nemesis:{seed}")

    def members(self) -> List[int]:
        return list(range(self.cfg.n_replicas))

    def alive_map(self) -> Dict[int, bool]:
        # a replica counts as dead for the kill gate if ANY group lost
        # it (faults below are applied per-group or globally)
        return {
            r: bool(self.engine.alive[:, r].all())
            for r in range(self.cfg.n_replicas)
        }

    def now(self) -> float:
        return self.engine.clock.now

    def drive(self, seconds: float) -> None:
        self.engine.run_for(seconds)

    # ------------------------------------------------------ open loop
    @property
    def capacity_eps(self) -> float:
        """Aggregate measured ingest capacity over the groups the key
        set actually routes to (each group drains at most one batch per
        tick)."""
        covered = len({self.router.group_of(k) for k in self.keys})
        return covered * self.cfg.batch_size / self.cfg.heartbeat_period

    def set_overload_rate(self, rate_mult: float) -> None:
        self._ol_rate = rate_mult * self.capacity_eps

    def pump_open_loop(self, dt: float) -> None:
        from raft_tpu_torch.examples.kv import _SET, encode_op
        from raft_tpu_torch.multi.engine import NotLeader

        if self._ol_rate <= 0:
            return
        n = poisson(self._ol_rng, self._ol_rate * dt)
        for _ in range(n):
            self._ol_counter += 1
            self.ol_submitted += 1
            cid = 1000 + self._ol_counter
            key = self._ol_rng.choice(self.keys)
            value = f"ol{self._ol_counter}".encode()
            rec = self.history.invoke(cid, WRITE, key, value, self.now())
            try:
                with self._ambient_span(rec):
                    handle = self._ol_router.submit(
                        key,
                        encode_op(self.cfg.entry_bytes, _SET, key, value),
                    )
            except Overloaded:
                self.shed_ops += 1
                rec.fail(self.history.stamp(self.now()))
                continue
            except NotLeader:
                # leadership gap, not admission — still provably no
                # effect (refused before queueing), still a clean fail
                rec.fail(self.history.stamp(self.now()))
                continue
            self._ol_pending.append((rec, handle, self.now()))

    def _ol_durable(self, handle) -> bool:
        g, seq = handle
        return self.engine.is_durable(g, seq)

    def commit_digest(self) -> str:
        return multi_commit_digest(self.engine)

    def invoke(self, cl: _Client) -> None:
        from raft_tpu_torch.multi.engine import NotLeader

        op, key, value = cl.pick()
        cl.rec = self.history.invoke(cl.cid, op, key, value, self.now())
        try:
            if op == READ:
                with self._ambient_span(cl.rec):
                    g, idx = self.router.read_index(key)
                if self.kv.last_applied[g] < idx:
                    self.drive(2 * self.cfg.heartbeat_period)
                if self.kv.last_applied[g] < idx:
                    # apply lag: no value served
                    cl.rec.fail(self.history.stamp(self.now()))
                else:
                    value = self.kv.get(key)
                    self._audit_read(cl.cid, key, value, group=g)
                    cl.rec.ok(self.history.stamp(self.now()), value)
                cl.rec = None
                return
            with self._ambient_span(cl.rec):
                cl.seq = (
                    self.kv.set(key, value) if op == WRITE
                    else self.kv.delete(key)
                )
        except (NotLeader, Overloaded) as ex:
            # nothing was queued (submit_to_leader refuses before
            # queueing; read_index confirms nothing; admission and the
            # router's breaker refuse before any effect): provably no
            # effect
            if isinstance(ex, Overloaded):
                self.shed_ops += 1
            cl.rec.fail(self.history.stamp(self.now()))
            cl.rec, cl.seq = None, None

    def poll(self, cl: _Client) -> None:
        if cl.rec is None or cl.rec.op == READ:
            return
        if self._give_up(cl):
            return
        g, seq = cl.seq
        if self.engine.is_durable(g, seq):
            cl.rec.ok(self.history.stamp(self.now()))
            cl.rec, cl.seq = None, None

    def apply_nemesis(self, act: NemesisAction) -> None:
        e = self.engine
        rng = self.nem_rng
        g = rng.randrange(e.G)
        if act.kind == "kill":
            e.fail(g, act.replica)
        elif act.kind == "recover":
            for gg in range(e.G):
                if not e.alive[gg, act.replica]:
                    e.recover(gg, act.replica)
        elif act.kind == "slow":
            e.set_slow(g, act.replica, True)
        elif act.kind == "unslow":
            for gg in range(e.G):
                e.set_slow(gg, act.replica, False)
        elif act.kind == "campaign":
            e.force_campaign(g, act.replica)
        elif act.kind == "partition":
            self._part_group = g
            e.partition(g, act.groups)
            self.partitioned = True
        elif act.kind == "heal":
            if self._part_group is not None:
                e.heal_partition(self._part_group)
            self._part_group = None
            self.partitioned = False
        elif act.kind == "plan":
            # scope the classic fragment to one group (the multi-Raft
            # FaultEvent.group field)
            from raft_tpu_torch.faults.plan import FaultPlan

            e.schedule_faults(FaultPlan([
                dataclasses.replace(ev, group=g) for ev in act.plan.events
            ]))
        elif act.kind == "overload_on":
            self.set_overload_rate(act.rate_mult)
        elif act.kind == "overload_off":
            self._ol_rate = 0.0

    def quiesce(self) -> None:
        e = self.engine
        self._ol_rate = 0.0
        for g in range(e.G):
            e.heal_partition(g)
            for r in range(self.cfg.n_replicas):
                if not e.alive[g, r]:
                    e.recover(g, r)
                e.set_slow(g, r, False)
        self.partitioned = False
        for g in range(e.G):
            e.run_until_leader(g, limit=3000.0)
        for _ in range(40):
            self._poll_all()
            if all(cl.rec is None for cl in self.clients):
                break
            e.run_for(4 * self.cfg.heartbeat_period)


# ---------------------------------------------------- overload recovery
@dataclasses.dataclass
class OverloadReport:
    """One seeded overload-and-recover scenario (``overload_run``):
    baseline -> open-loop storm at ``rate_mult`` x capacity -> arrivals
    subside -> recovery. The anti-metastability property is
    ``recovery_ok``: goodput back to >= ``recover_frac`` of the
    pre-overload baseline, with the delay controller quiet, within
    ``recovery_window_s`` virtual seconds of the storm ending — plus
    the safety half: the host queue never exceeded its bound and the
    client history (shed ops recorded as no-effect failures) checked
    linearizable."""

    seed: int
    rate_mult: float
    capacity_eps: float
    baseline_goodput: float          # committed entries/s, pre-storm
    overload_goodput: float          # committed entries/s, during
    recovery_goodput: float          # rolling goodput at recovery detect
    shed: Dict[str, int]             # gate refusals by reason
    admitted: Dict[str, int]
    open_loop_ops: int
    depth_bound: int
    depth_high_water: int            # gate-observed arrival-time max
    queue_depth_max: int             # directly sampled queue depth max
    queue_delay_p99_overload_s: float
    queue_delay_p99_recovery_s: float
    recovered_in_s: Optional[float]  # None = never within the window
    recovery_window_s: float
    recovery_ok: bool
    check: CheckResult
    ops: int
    op_counts: Dict[str, int]
    repro: str
    bundle_path: Optional[str] = None   # forensics (obs.forensics)
    obs: Optional[ObsStack] = None

    @property
    def verdict(self) -> str:
        return self.check.verdict

    def summary(self) -> str:
        rec = ("never" if self.recovered_in_s is None
               else f"{self.recovered_in_s:.0f}s")
        return (
            f"seed {self.seed} x{self.rate_mult:g}: {self.verdict}, "
            f"goodput {self.baseline_goodput:.2f}->"
            f"{self.overload_goodput:.2f}->{self.recovery_goodput:.2f} e/s, "
            f"shed {sum(self.shed.values())}/{self.open_loop_ops}, "
            f"depth max {self.queue_depth_max}/{self.depth_bound}, "
            f"recovered in {rec} (window {self.recovery_window_s:g}s)"
        )


def overload_run(
    seed: int, *args, blackbox_dir: Optional[str] = None, **kwargs,
) -> OverloadReport:
    """Journaled front door for :func:`_overload_run_impl` — the impl's
    signature and defaults are the single source of truth (everything
    but ``blackbox_dir`` forwards verbatim; see its docstring for the
    scenario). ``blackbox_dir`` / ``RAFT_TPU_BLACKBOX_DIR`` arms the
    progress journal like the other chaos entry points."""
    with blackbox.journal_for(f"overload_seed{seed}", blackbox_dir):
        blackbox.mark("overload_run", seed=seed)
        return _overload_run_impl(seed, *args, **kwargs)


def _overload_run_impl(
    seed: int,
    rate_mult: float = 5.0,
    baseline_s: float = 120.0,
    overload_s: float = 180.0,
    recovery_window_s: float = 300.0,
    recover_frac: float = 0.9,
    cfg: Optional[RaftConfig] = None,
    step_budget: int = 500_000,
    observe: bool = False,
    bundle_dir: Optional[str] = None,
    device=None,
) -> OverloadReport:
    """The deterministic overload scenario behind the acceptance
    criterion (no composed process faults — ``torture_run(overload=
    True)`` composes; this run isolates the admission story so the
    recovery assertion is crisp):

    1. *Baseline*: closed-loop clients plus a polite open-loop trickle
       at half capacity; measure goodput (committed entries/s).
    2. *Storm*: open-loop Poisson arrivals at ``rate_mult`` x measured
       capacity for ``overload_s``. The queue must never exceed its
       bound; excess arrivals shed as typed no-effect refusals.
    3. *Recovery*: arrivals drop back to the trickle. Goodput must
       return to >= ``recover_frac`` of baseline — with the delay
       controller out of its shedding state — within
       ``recovery_window_s`` (the documented recovery window,
       docs/OVERLOAD.md). A system with queues allowed to grow
       unboundedly fails exactly this: it keeps paying the backlog long
       after the storm (the metastable signature).

    The client history (closed-loop ops + every open-loop arrival, shed
    ones as ``fail``) goes through the linearizability checker like any
    torture run.
    """
    run = _SingleTorture(
        seed, 0, 2, 3, 30.0,
        cfg or _overload_cfg(seed), None, None, observe=observe,
        device=device,
    )
    e = run.engine
    gate = e.admission
    assert gate is not None, "overload_run needs admission configured"
    base_rate = 0.5 * run.capacity_eps
    slice_s = 2 * run.cfg.heartbeat_period
    depth_max = 0

    def window(seconds: float, rate: float) -> None:
        nonlocal depth_max
        run._ol_rate = rate
        t_end = run.now() + seconds
        while run.now() < t_end:
            run._invoke_idle()
            run.pump_open_loop(slice_s)
            depth_max = max(depth_max, len(e._queue))
            run.drive(slice_s)
            depth_max = max(depth_max, len(e._queue))
            run._poll_all()

    def commits_in(t0: float, t1: float) -> int:
        return sum(1 for t in e.commit_time.values() if t0 < t <= t1)

    # 1. baseline ------------------------------------------------------
    def delay_mark() -> int:
        # CUMULATIVE sample index: stable across the gate's buffer trim
        # (delay_samples drops its older half past MAX_DELAY_SAMPLES)
        return gate.delay_dropped + len(gate.delay_samples)

    t0 = run.now()
    window(baseline_s, base_rate)
    t1 = run.now()
    baseline_goodput = commits_in(t0, t1) / (t1 - t0)
    delay_mark_base = delay_mark()

    # 2. storm ---------------------------------------------------------
    window(overload_s, rate_mult * run.capacity_eps)
    t2 = run.now()
    overload_goodput = commits_in(t1, t2) / (t2 - t1)
    delay_mark_storm = delay_mark()

    # 3. recovery ------------------------------------------------------
    run._ol_rate = base_rate
    roll_s = min(60.0, recovery_window_s / 2)
    recovered_in = None
    recovery_goodput = 0.0
    while run.now() < t2 + recovery_window_s:
        window(slice_s, base_rate)
        now = run.now()
        rolling = commits_in(now - roll_s, now) / roll_s
        head_delay = 0.0
        if e._queue:
            head_delay = now - e.submit_time.get(e._queue[0][0], now)
        if (now - t2 >= roll_s
                and rolling >= recover_frac * baseline_goodput
                and not gate.shedding
                and head_delay < gate.target_delay_s):
            recovered_in = now - t2
            recovery_goodput = rolling
            break
    if recovered_in is None:
        now = run.now()
        recovery_goodput = commits_in(now - roll_s, now) / roll_s
    def delay_p99(lo: int, hi: int) -> float:
        # cumulative marks -> current buffer offsets; samples trimmed
        # away mid-phase just shrink the slice (the retained half is
        # the recent one, which is the regime the percentile reports)
        lo = max(0, lo - gate.delay_dropped)
        hi = max(0, hi - gate.delay_dropped)
        window = gate.delay_samples[lo:hi]
        if not window:
            return float("nan")
        import numpy as np

        return float(np.percentile(window, 99))

    q_p99_storm = delay_p99(delay_mark_base, delay_mark_storm)
    q_p99_rec = delay_p99(delay_mark_storm, delay_mark())

    run._ol_rate = 0.0
    run.quiesce()
    run.history.close()
    check = check_history(run.history, step_budget=step_budget)
    report = gate.report(queue_depth=len(e._queue))
    repro = (f"python -m raft_tpu_torch.chaos --seed {seed} "
             f"--overload-recovery {rate_mult:g}")
    bundle_path = _maybe_bundle(
        "overload", run, check, LINEARIZABLE, repro, [], bundle_dir,
        extra={"rate_mult": rate_mult, "recovered_in_s": recovered_in,
               "recovery_window_s": recovery_window_s,
               "shed": report.shed},
        force_unexpected=recovered_in is None,
        #   a missed recovery window is an unexpected outcome even when
        #   the history itself checks LINEARIZABLE — bundle it too
    )
    return OverloadReport(
        seed=seed, rate_mult=rate_mult, capacity_eps=run.capacity_eps,
        baseline_goodput=baseline_goodput,
        overload_goodput=overload_goodput,
        recovery_goodput=recovery_goodput,
        shed=report.shed, admitted=report.admitted,
        open_loop_ops=run.ol_submitted,
        depth_bound=gate.max_writes,
        depth_high_water=report.depth_high_water,
        queue_depth_max=depth_max,
        queue_delay_p99_overload_s=q_p99_storm,
        queue_delay_p99_recovery_s=q_p99_rec,
        recovered_in_s=recovered_in,
        recovery_window_s=recovery_window_s,
        recovery_ok=recovered_in is not None,
        check=check, ops=len(run.history),
        op_counts=run.history.counts(),
        repro=repro, bundle_path=bundle_path, obs=run.obs,
    )


# ------------------------------------------------- reconfiguration drill
@dataclasses.dataclass
class ReconfigReport:
    """One seeded deterministic reconfiguration drill (``reconfig_run``):
    grow twice through the learner phase, shrink, remove the leader,
    then wipe-replace a voter — with closed-loop client traffic flowing
    throughout. Two properties are asserted on top of the history
    verdict:

    - **availability**: after every configuration commit, a fresh write
      commits within ``availability_window_s`` VIRTUAL seconds (the
      documented resume window, docs/MEMBERSHIP.md) — ``events`` carries
      each op's measured resume time and ``availability_ok`` the
      conjunction;
    - **learner catch-up**: ``promote_s`` (fresh join) and
      ``replace_promote_s`` (rejoin-from-nothing after total durable
      loss) measure attach -> voter on the virtual clock.
    """

    seed: int
    check: CheckResult
    ops: int
    op_counts: Dict[str, int]
    events: List[dict]              # {op, t, resume_s, ok}
    promote_s: Optional[float]
    replace_promote_s: Optional[float]
    availability_window_s: float
    availability_ok: bool
    repro: str
    bundle_path: Optional[str] = None   # forensics (obs.forensics)
    obs: Optional[ObsStack] = None

    @property
    def verdict(self) -> str:
        return self.check.verdict

    def summary(self) -> str:
        evs = ", ".join(
            f"{ev['op']}:{ev['resume_s']:.0f}s" if ev["ok"]
            else f"{ev['op']}:STALLED" for ev in self.events
        )
        line = (
            f"seed {self.seed}: {self.verdict} over {self.ops} ops, "
            f"resume [{evs}] (window {self.availability_window_s:g}s), "
            f"promote {self.promote_s:.0f}s, "
            f"wipe-replace promote {self.replace_promote_s:.0f}s"
            if self.promote_s is not None
            and self.replace_promote_s is not None
            else f"seed {self.seed}: {self.verdict}, drill incomplete"
        )
        if self.verdict != LINEARIZABLE or not self.availability_ok:
            line += f"\n  REPRO: {self.repro}"
        return line


def reconfig_run(
    seed: int, *args, blackbox_dir: Optional[str] = None, **kwargs,
) -> ReconfigReport:
    """Journaled front door for :func:`_reconfig_run_impl` — the impl's
    signature and defaults are the single source of truth (everything
    but ``blackbox_dir`` forwards verbatim; see its docstring for the
    drill). ``blackbox_dir`` / ``RAFT_TPU_BLACKBOX_DIR`` arms the
    progress journal like the other chaos entry points."""
    with blackbox.journal_for(f"reconfig_seed{seed}", blackbox_dir):
        blackbox.mark("reconfig_run", seed=seed)
        return _reconfig_run_impl(seed, *args, **kwargs)


def _reconfig_run_impl(
    seed: int,
    availability_window_s: float = 120.0,
    catchup_limit_s: float = 900.0,
    cfg: Optional[RaftConfig] = None,
    step_budget: int = 500_000,
    observe: bool = False,
    bundle_dir: Optional[str] = None,
    device=None,
) -> ReconfigReport:
    """The deterministic reconfiguration scenario behind the acceptance
    criteria (no random nemesis — ``torture_run(membership=True)``
    composes; this run isolates the membership story so the
    availability assertion is crisp):

    1. *Grow 3 -> 4 -> 5*, learner-first: each ``add_server`` attaches a
       non-voting learner, heals it, auto-promotes at the lag bound.
    2. *Shrink 5 -> 4*: remove a non-leader voter.
    3. *Remove the leader*: the removed leader keeps serving until the
       entry commits, steps down, and the survivors elect (§4.2.2).
    4. *Wipe-replace*: crash a voter, destroy its durable state
       entirely (device row + mirrors + vote WAL), and ``replace`` it —
       removal, learner re-admission of the wiped row under a fresh
       identity, snapshot-install catch-up, promotion.

    After every configuration commit a probe write must commit within
    ``availability_window_s`` virtual seconds: reconfiguration is
    supposed to be something the cluster serves traffic THROUGH, not
    around.
    """
    run = _SingleTorture(
        seed, 0, 2, 3, 30.0,
        cfg or _membership_cfg(_default_cfg(seed)), None, None,
        membership=True, observe=observe, device=device,
    )
    e = run.engine
    slice_s = 2 * run.cfg.heartbeat_period
    events: List[dict] = []

    def drive(seconds: float) -> None:
        t_end = run.now() + seconds
        while run.now() < t_end:
            run._invoke_idle()
            run.drive(slice_s)
            run.pump_membership()
            run._poll_all()

    def probe_resume(op: str) -> None:
        """A config entry just committed: commit progress must resume
        inside the window."""
        t0 = run.now()
        seq = e.submit(bytes(run.cfg.entry_bytes))
        end = t0 + availability_window_s
        while not e.is_durable(seq) and run.now() < end and e._q:
            e.step_event()
        ok = e.is_durable(seq)
        events.append({
            "op": op, "t": t0,
            "resume_s": (run.now() - t0) if ok else None, "ok": ok,
        })

    def until_voter(r: int) -> Optional[float]:
        """Drive with traffic until row ``r`` is a voter; returns the
        virtual seconds it took, None on timeout."""
        t0 = run.now()
        end = t0 + catchup_limit_s
        while not e.member[r] and run.now() < end:
            drive(slice_s)
        return (run.now() - t0) if e.member[r] else None

    drive(30.0)                                      # baseline traffic

    # 1. grow 3 -> 4 -> 5 through the learner phase
    t0 = run.now()
    e.add_server(3)
    promote_s = until_voter(3)
    if promote_s is not None:
        promote_s = run.now() - t0
    probe_resume("grow")
    e.add_server(4)
    until_voter(4)
    probe_resume("grow")

    # 2. shrink 5 -> 4 (an election gap can straddle any probe window —
    # re-elect before each leader-required op instead of dying on
    # leader_id=None with an unrelated traceback)
    e.run_until_leader(limit=catchup_limit_s)
    victim = next(
        r for r in range(run.cfg.rows)
        if e.member[r] and r != e.leader_id
    )
    s_rm = e.remove_server(victim)
    e.run_until_committed(s_rm, limit=catchup_limit_s)
    probe_resume("shrink")

    # 3. remove the leader
    e.run_until_leader(limit=catchup_limit_s)
    lead = e.leader_id
    e.remove_server(lead)
    end = run.now() + catchup_limit_s
    while e.member[lead] and run.now() < end:
        drive(slice_s)
    e.run_until_leader(limit=catchup_limit_s)
    probe_resume("remove_leader")

    # 4. wipe-replace a voter (rejoin-from-nothing as a learner)
    e.run_until_leader(limit=catchup_limit_s)
    victim = next(
        r for r in range(run.cfg.rows)
        if e.member[r] and r != e.leader_id
    )
    e.fail(victim)
    e.wipe(victim)
    run.store.wipe_node(victim)
    t0 = run.now()
    e.replace(victim, victim)
    run._wipe_rejoin.add(victim)
    end = run.now() + catchup_limit_s
    while e.member[victim] and run.now() < end:
        drive(slice_s)        # the removal half of the ladder commits
    replace_promote_s = (
        until_voter(victim) if not e.member[victim] else None
    )
    if replace_promote_s is not None:
        replace_promote_s = run.now() - t0
    probe_resume("wipe_replace")

    run.quiesce()
    run.history.close()
    check = check_history(run.history, step_budget=step_budget)
    availability_ok = bool(events) and all(ev["ok"] for ev in events)
    repro = f"python -m raft_tpu_torch.chaos --reconfig --seed {seed}"
    bundle_path = _maybe_bundle(
        "reconfig", run, check, LINEARIZABLE, repro, [], bundle_dir,
        extra={"events": events, "promote_s": promote_s,
               "replace_promote_s": replace_promote_s},
        force_unexpected=not availability_ok,
    )
    return ReconfigReport(
        seed=seed, check=check, ops=len(run.history),
        op_counts=run.history.counts(), events=events,
        promote_s=promote_s, replace_promote_s=replace_promote_s,
        availability_window_s=availability_window_s,
        availability_ok=availability_ok,
        repro=repro, bundle_path=bundle_path, obs=run.obs,
    )


# --------------------------------------------- segment-nemesis drill
@dataclasses.dataclass
class SegmentReport:
    """Result of :func:`segment_storage_run` — the tiered-store
    acceptance drill: sealed segments are corrupted (torn spill, bit
    flip, dropped shard — within the keep-k rule) while a ring-lapped
    follower's only rejoin material lives in them. The claim under
    test: recovery rides the RS reconstruct path (``reconstructs`` > 0,
    never a silent garbage load), the chunked stream completes the
    rejoin, and the client history stays LINEARIZABLE throughout."""

    seed: int
    check: CheckResult
    ops: int
    op_counts: Dict[str, int]
    faults: List[str]            # injected segment faults, as applied
    tier: Dict[str, int]         # final TieredStore stats
    chunks_shipped: int          # incremental-install chunks to rejoin
    rejoined: bool               # the lapped follower caught back up
    repro: str
    bundle_path: Optional[str] = None
    obs: Optional[ObsStack] = None

    @property
    def verdict(self) -> str:
        return self.check.verdict

    @property
    def recovered_via_rs(self) -> bool:
        return self.tier.get("segment_reconstructs", 0) > 0 \
            and self.tier.get("segments_lost", 0) == 0

    def summary(self) -> str:
        line = (
            f"seed {self.seed}: {self.verdict} over {self.ops} ops, "
            f"faults [{', '.join(self.faults)}], "
            f"{self.tier.get('segment_reconstructs', 0)} RS "
            f"reconstructs, {self.chunks_shipped} chunks, "
            f"rejoined={self.rejoined}"
        )
        if self.verdict != LINEARIZABLE or not self.rejoined:
            line += f"\n  REPRO: {self.repro}"
        return line


def segment_storage_run(
    seed: int, *args, blackbox_dir: Optional[str] = None, **kwargs,
) -> SegmentReport:
    """Journaled front door for :func:`_segment_storage_run_impl`
    (see its docstring for the drill script)."""
    with blackbox.journal_for(f"segments_seed{seed}", blackbox_dir):
        blackbox.mark("segment_storage_run", seed=seed)
        return _segment_storage_run_impl(seed, *args, **kwargs)


def _segment_storage_run_impl(
    seed: int,
    catchup_limit_s: float = 600.0,
    step_budget: int = 500_000,
    observe: bool = False,
    bundle_dir: Optional[str] = None,
    device=None,
) -> SegmentReport:
    """The sealed-segment storage nemesis, scripted (no random schedule
    — the fault set is the point, like ``reconfig_run``):

    1. Client traffic builds KV state; a follower dies.
    2. Filler commits lap the ring AND spill past the (deliberately
       small, ``log_capacity // 2``) hot tail, so part of the dead
       follower's future catch-up range exists ONLY as sealed RS-coded
       segments on disk.
    3. The nemesis corrupts sealed shards — one torn spill, one bit
       flip, one dropped shard, seeded placement under the keep-k rule.
    4. The follower recovers: its rejoin streams chunks whose bytes
       must come back through CRC rejection + RS reconstruct (a store
       that loaded a corrupted shard would install garbage the KV
       differential and the checker would catch).
    5. Quiesce, close the history, check linearizability; client
       traffic keeps flowing through every phase.
    """
    cfg = dataclasses.replace(
        _default_cfg(seed),
        tiered_log_dir=tempfile.mkdtemp(prefix="raft_segdrill_"),
        tiered_hot_entries=_default_cfg(seed).log_capacity // 2,
        segment_entries=_default_cfg(seed).log_capacity // 4,
    )
    run = _SingleTorture(
        seed, 0, 2, 3, 30.0, cfg, None, None, observe=observe,
        device=device,
    )
    e = run.engine
    store = e.store
    slice_s = 2 * run.cfg.heartbeat_period
    faults: List[str] = []

    def drive(seconds: float) -> None:
        t_end = run.now() + seconds
        while run.now() < t_end:
            run._invoke_idle()
            run.drive(slice_s)
            run._poll_all()

    drive(30.0)                                     # baseline KV traffic
    victim = next(
        r for r in range(cfg.n_replicas) if r != e.leader_id
    )
    e.fail(victim)
    blackbox.mark("segment_victim_down", victim=victim)
    # lap the ring and spill sealed segments into the catch-up range:
    # zero payloads decode as KV no-ops, so the checker's world is
    # untouched while the log (and the cold tier) grows
    filler = bytes(cfg.entry_bytes)
    target = 3 * cfg.log_capacity
    while e.commit_watermark < target:
        for _ in range(2 * cfg.batch_size):
            e.submit(filler)
        drive(2 * slice_s)
    assert store.stats["segments_sealed"] > 0, \
        "drill misconfigured: nothing sealed"
    nem = SegmentNemesis(store)
    srng = random.Random(f"segments:{seed}")
    # The rejoin stream installs from the ring-fitting tail base
    # (wm - capacity + 1) and hands off to the ring-served repair
    # window at the horizon — so the segment reads happen on the FIRST
    # chunks. Put the corruption exactly there (the hot tail is
    # deliberately smaller than the ring, so that base is sealed); one
    # more fault lands anywhere for kind coverage — the crash-restore
    # leg below sweeps the whole checkpoint span through the store
    # regardless.
    path_lo = e.commit_watermark - cfg.log_capacity + 1
    path = (path_lo, path_lo + 2 * cfg.batch_size)
    # data_only on the on-path faults: a parity-shard fault recovers
    # through the systematic stitch (no decode), and this drill's pass
    # condition is precisely that the RS decode engaged
    for kind, rng_range in (("flip_bit", path), ("drop_shard", path),
                            ("torn_spill", None)):
        desc = nem.inject(
            srng, kind, within=rng_range,
            data_only=rng_range is not None,
        )
        if desc is not None:
            faults.append(desc)
            blackbox.mark("segment_fault", fault=desc)
    wm_down = e.commit_watermark
    chunks0 = e._shipper.chunks_total
    e.recover(victim)
    end = run.now() + catchup_limit_s
    while run.now() < end:
        drive(slice_s)
        if int(e._fetch(e.state.match_index)[victim]) >= wm_down:
            break
    rejoined = int(e._fetch(e.state.match_index)[victim]) >= wm_down
    chunks = e._shipper.chunks_total - chunks0
    # Crash-restore leg: checkpoint assembly reads the WHOLE checkpoint
    # span (2x ring capacity) through the store — most of it sealed
    # here — so every faulted segment on disk must come back through
    # CRC rejection + RS reconstruct or the restored cluster would
    # restart from garbage (the post-restore reads and the checker
    # would catch it).
    run._crash_restart("none")
    e = run.engine
    drive(30.0)
    tier = dict(store.stats)
    run.quiesce()
    run.history.close()
    check = check_history(run.history, step_budget=step_budget)
    repro = f"python -m raft_tpu_torch.chaos --segments --seed {seed}"
    bundle_path = _maybe_bundle(
        "segments", run, check, LINEARIZABLE, repro, faults, bundle_dir,
        extra={"faults": faults, "tier": tier, "rejoined": rejoined},
        force_unexpected=not rejoined,
    )
    return SegmentReport(
        seed=seed, check=check, ops=len(run.history),
        op_counts=run.history.counts(), faults=faults, tier=tier,
        chunks_shipped=chunks, rejoined=rejoined, repro=repro,
        bundle_path=bundle_path, obs=run.obs,
    )


# --------------------------------------------- group-migration drill
@dataclasses.dataclass
class MigrationReport:
    """Result of :func:`migration_run` — the group-shard acceptance
    drill: Rebalancer-driven group moves between mesh shards while the
    sharded-KV client workload runs, with a per-move commit-progress
    probe. ``verdict`` must stay LINEARIZABLE and every move's probe
    must land inside ``resume_window_s`` virtual seconds."""

    seed: int
    check: CheckResult
    ops: int
    op_counts: Dict[str, int]
    moves: List[dict]
    resume_window_s: float
    progress_ok: bool
    n_shards: int
    repro: str
    commit_digest: str = ""
    bundle_path: Optional[str] = None
    obs: Optional[ObsStack] = None

    @property
    def verdict(self) -> str:
        return self.check.verdict

    def summary(self) -> str:
        return (
            f"seed={self.seed} verdict={self.verdict} "
            f"moves={len(self.moves)} shards={self.n_shards} "
            f"progress_ok={self.progress_ok} ops={self.ops}"
        )


def migration_run(
    seed: int,
    n_groups: int = 8,
    n_moves: int = 3,
    resume_window_s: float = 120.0,
    clients: int = 3,
    keys: int = 8,
    cfg: Optional[RaftConfig] = None,
    step_budget: int = 500_000,
    observe: bool = False,
    bundle_dir: Optional[str] = None,
    blackbox_dir: Optional[str] = None,
    device=None,
    mesh=None,
) -> MigrationReport:
    """Migration-under-load: the deterministic drill behind the
    group-shard acceptance criteria (the randomized composition rides
    ``torture_run_multi`` under ``RAFT_TPU_GSHARD=1`` — this run
    isolates the placement story so the progress assertion is crisp).

    A sharded ``MultiEngine`` (``transport="mesh_groups"``; needs a
    ``mesh=`` of two or more shards, which may repeat one device: two
    shards of ``cuda:0`` on one card, of ``cpu`` in the tests) serves
    the ShardedKV torture workload while ``n_moves`` group migrations
    fire mid-traffic: each move is planned by the StatusBoard-fed
    :class:`raft_tpu_torch.multi.rebalancer.Rebalancer` when the load
    spread warrants one, else forced round-robin (the drill must exercise the
    move even when the synthetic load happens to be balanced). After
    every move, a probe write on the MOVED group must commit within
    ``resume_window_s`` virtual seconds, and the whole per-key history
    must check LINEARIZABLE."""
    with blackbox.journal_for(f"migration_seed{seed}", blackbox_dir):
        blackbox.mark("migration_run", seed=seed, n_groups=n_groups,
                      moves=n_moves)
        base = cfg or RaftConfig(
            n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=128,
            transport="mesh_groups", seed=seed,
        )
        run = _MultiTorture(
            seed, 0, clients, keys, 30.0, base, n_groups,
            observe=observe, device=device, mesh=mesh,
        )
        e = run.engine
        if e.n_shards < 2:
            raise RuntimeError(
                "migration_run needs a sharded layout (>= 2 devices "
                f"for the gshard axis; engine degraded to "
                f"{e.transport_mode!r})"
            )
        from raft_tpu_torch.multi.rebalancer import Rebalancer

        reb = Rebalancer(e)
        slice_s = 2 * run.cfg.heartbeat_period
        moves: List[dict] = []

        def drive(seconds: float) -> None:
            t_end = run.now() + seconds
            while run.now() < t_end:
                run._invoke_idle()
                run.drive(slice_s)
                run._poll_all()

        drive(30.0)                               # baseline traffic
        for i in range(n_moves):
            plan = reb.plan(max_moves=1)
            if plan:
                mv = e.migrate_group(plan[0]["group"], plan[0]["dst"])
                planned = True
            else:
                # balanced load: force the busiest group one shard over
                g = max(range(e.G),
                        key=lambda gg: (len(e._queue[gg]), -gg))
                mv = e.migrate_group(g, (e.shard_of(g) + 1) % e.n_shards)
                planned = False
            assert mv is not None
            blackbox.mark("migrate", group=mv["group"], src=mv["src"],
                          dst=mv["dst"])
            # progress probe ON THE MOVED GROUP: commit must resume
            # inside the window, with the client workload still running
            t0 = run.now()
            probe = e.submit(mv["group"], bytes(run.cfg.entry_bytes))
            end = t0 + resume_window_s
            while not e.is_durable(mv["group"], probe) and \
                    run.now() < end and e._q:
                e.step_event()
            mv.update({
                "planned": planned,
                "resume_s": (run.now() - t0)
                if e.is_durable(mv["group"], probe) else None,
                "ok": e.is_durable(mv["group"], probe),
            })
            moves.append(mv)
            drive(slice_s)                        # traffic between moves

        run.quiesce()
        run.history.close()
        blackbox.mark("check_history", ops=len(run.history))
        check = check_history(run.history, step_budget=step_budget)
        blackbox.mark("check_done", verdict=check.verdict)
    progress_ok = bool(moves) and all(m["ok"] for m in moves)
    repro = (
        f"python -m raft_tpu_torch.chaos --migration --seed {seed} "
        f"--groups {n_groups}"
    )
    bundle_path = _maybe_bundle(
        "migration", run, check, LINEARIZABLE, repro, [], bundle_dir,
        extra={"moves": moves, "n_shards": e.n_shards},
        force_unexpected=not progress_ok,
    )
    return MigrationReport(
        seed=seed, check=check, ops=len(run.history),
        op_counts=run.history.counts(), moves=moves,
        resume_window_s=resume_window_s, progress_ok=progress_ok,
        n_shards=e.n_shards, repro=repro,
        commit_digest=run.commit_digest(), bundle_path=bundle_path,
        obs=run.obs,
    )


# ------------------------------------------------- read scale-out drill
@dataclasses.dataclass
class ReadsReport:
    """Result of :func:`reads_run` — the read scale-out acceptance
    drill (docs/READS.md): lease churn + leader kill + clock-skew
    nemesis composed, with PER-READ-CLASS verdicts
    (``chaos.checker.check_read_classes``) instead of one blanket
    linearizability grade. The deterministic stale-probe phase is the
    falsifiability core: a partitioned, clock-skewed old leader is
    probed after a rival committed — the correct plane must REFUSE
    (``refused_stale``), the ``broken="lease_skew"`` variant serves
    the stale bytes and must be CAUGHT (lease-class VIOLATION offline,
    ``read_monotone`` online)."""

    seed: int
    per_class: Dict[str, CheckResult]
    ops: int
    op_counts: Dict[str, int]
    lease_serves: int
    read_index_serves: int
    session_serves: int
    refused_stale: int
    stale_served: int           # broken-plane stale serves observed
    leader_kills: int
    skew_log: List[str]
    audit_violations: Optional[int]
    repro: str
    broken: Optional[str] = None
    bundle_path: Optional[str] = None
    obs: Optional[ObsStack] = None

    @property
    def verdict(self) -> str:
        """Worst per-class verdict (every class must hold its own
        contract for the drill to pass)."""
        verdicts = [c.verdict for c in self.per_class.values()]
        if VIOLATION in verdicts:
            return VIOLATION
        if any(v != LINEARIZABLE for v in verdicts):
            return "UNDETERMINED"
        return LINEARIZABLE

    @property
    def caught(self) -> bool:
        """Broken-variant success: the stale serve happened AND at
        least one detector (offline per-class checker, online
        auditor) flagged it."""
        offline = self.per_class.get("lease") is not None and \
            self.per_class["lease"].verdict == VIOLATION
        online = bool(self.audit_violations)
        return self.stale_served > 0 and (offline or online)

    def summary(self) -> str:
        cls = {c: r.verdict for c, r in self.per_class.items()}
        return (
            f"seed={self.seed} classes={cls} lease={self.lease_serves} "
            f"read_index={self.read_index_serves} "
            f"session={self.session_serves} "
            f"refused_stale={self.refused_stale} "
            f"stale_served={self.stale_served} ops={self.ops}"
        )


def reads_run(
    seed: int,
    broken: Optional[str] = None,
    clients: int = 3,
    keys: int = 4,
    step_budget: int = 500_000,
    observe: bool = True,
    bundle_dir: Optional[str] = None,
    blackbox_dir: Optional[str] = None,
    device=None,
) -> ReadsReport:
    """The deterministic read scale-out drill (``--reads``): leader
    leases under write traffic, clock-skew churn across the configured
    drift band, a leader kill with lease resumption, session reads on
    commit-index tokens, and the scripted STALE-PROBE scenario —
    partition the (slow-clocked) leader away, let the majority elect
    and commit past it, then probe the old leader's lease read. The
    correct plane provably refuses (its lease expired before the rival
    could exist); ``broken="lease_skew"`` (drift bound ignored) still
    holds the lease on its slow clock, serves the frozen — now stale —
    state, and must be caught by the per-class checker and the online
    auditor. Success therefore means the OPPOSITE thing per variant,
    exactly like ``--broken dirty_reads``."""
    if broken not in (None, "lease_skew"):
        raise ValueError(f"unknown reads_run broken variant {broken!r}")
    cfg = _reads_cfg(_default_cfg(seed))
    with blackbox.journal_for(f"reads_seed{seed}", blackbox_dir):
        blackbox.mark("reads_run", seed=seed, broken=broken or "")
        run = _SingleTorture(
            seed, 0, clients, keys, 30.0, cfg, None, broken,
            reads=True, observe=observe, audit=True, device=device,
        )
        e = run.engine
        drift = cfg.clock_drift_bound
        skew_log: List[str] = []
        refused_stale = 0
        stale_served = 0
        leader_kills = 0
        session_cid = 900
        session_floor = [0]

        def session_read(key: bytes) -> None:
            """One session-consistent read: serve from applied state
            gated on the client's commit-index token, no leader
            contact (the single-engine twin of Router.read_session)."""
            rec = run.history.invoke(
                session_cid, READ, key, None, run.now()
            )
            rec.read_class = "session"
            rec.ryw_floor = session_floor[0]
            idx = int(e.applied_index)
            if idx < session_floor[0]:
                # the apply stream lags the token (ReadLagging's
                # single-engine analogue): typed refusal, no effect
                rec.fail(run.history.stamp(run.now()))
                return
            value = run._value_at(key, idx)
            rec.serve_index = idx
            session_floor[0] = max(session_floor[0], idx)
            run._audit_read(session_cid, key, value)
            rec.ok(run.history.stamp(run.now()), value)
            e._note_read_served("session", 0.0)

        def drive(seconds: float) -> None:
            t_end = run.now() + seconds
            i = 0
            while run.now() < t_end:
                run._invoke_idle()
                run.drive(2 * cfg.heartbeat_period)
                run._poll_all()
                session_read(run.keys[i % len(run.keys)])
                i += 1

        # ---- phase 1: leases under traffic --------------------------
        drive(60.0)
        blackbox.mark("reads_warmup",
                      classes=dict(e.read_class_counts))
        # ---- phase 2: skew churn across the drift band --------------
        for rate in (1.0 / drift, drift, 1.0):
            lead = e.leader_id
            if lead is not None:
                e.set_lease_rate(lead, rate)
                skew_log.append(f"t={run.now():.1f} "
                                f"skew(Server{lead}, {rate:.3f})")
            drive(30.0)
        # ---- phase 3: leader kill; lease must resume ----------------
        lead = (e.leader_id if e.leader_id is not None
                else e.run_until_leader())
        e.fail(lead)
        leader_kills += 1
        skew_log.append(f"t={run.now():.1f} kill(Server{lead})")
        e.run_until_leader()
        e.recover(lead)
        drive(45.0)
        # ---- phase 4: the stale probe (falsifiability core) ---------
        lead = (e.leader_id if e.leader_id is not None
                else e.run_until_leader())
        slow_rate = 1.0 / drift        # slowest clock INSIDE the band
        e.set_lease_rate(lead, slow_rate)
        skew_log.append(f"t={run.now():.1f} "
                        f"skew(Server{lead}, {slow_rate:.3f})")
        probe_key = run.keys[0]
        w_old = b"stale-old"
        rec = run.history.invoke(901, WRITE, probe_key, w_old, run.now())
        s1 = run.kv.set(probe_key, w_old)
        e.run_until_committed(s1)
        rec.ok(run.history.stamp(run.now()))
        others = [p for p in range(cfg.rows)
                  if e.member[p] and p != lead]
        e.partition([[lead], others])
        run.partitioned = True
        blackbox.mark("stale_probe_partition", leader=lead,
                      t_virtual=round(run.now(), 3))
        # §9.6 stickiness must elapse before any rival can be elected —
        # which is exactly why a correct lease (duration f0/drift on a
        # clock no slower than 1/drift) has expired by then
        e.run_for(cfg.follower_timeout[0] + 0.5)
        for cand in others:
            e.force_campaign(cand)
            if e.leader_id == cand:
                break
        assert e.leader_id in others, \
            "stale-probe majority election did not land"
        w_new = b"stale-new"
        rec = run.history.invoke(901, WRITE, probe_key, w_new, run.now())
        s2 = run.kv.set(probe_key, w_new)
        e.run_until_committed(s2, limit=120.0)
        rec.ok(run.history.stamp(run.now()))
        # the probe CLIENT first observes the new value through the new
        # leader (arming the auditor's monotone watermark), then probes
        # the old one
        probe_cid = 902
        rec = run.history.invoke(probe_cid, READ, probe_key, None,
                                 run.now())
        tk = e.submit_read()
        rec.read_class = e.read_ticket_class(tk)
        idx = None
        for _ in range(200):
            idx = e.read_confirmed(tk)
            if idx is not None:
                break
            e.step_event()
        assert idx is not None and run.kv.last_applied >= idx
        fresh = run.kv.get(probe_key)
        run._audit_read(probe_cid, probe_key, fresh)
        rec.ok(run.history.stamp(run.now()), fresh)
        # ---- the probe itself ---------------------------------------
        from raft_tpu_torch.raft.engine import LinearizableReadRefused

        rec = run.history.invoke(probe_cid, READ, probe_key, None,
                                 run.now())
        try:
            tk = e.submit_read(r=lead)
        except LinearizableReadRefused:
            # the CORRECT plane lands here: its lease expired before
            # the rival could be elected, and the classic fallback's
            # quorum check refuses from the minority side
            refused_stale += 1
            rec.fail(run.history.stamp(run.now()))
        else:
            cls = e.read_ticket_class(tk)
            rec.read_class = cls
            pidx = e.read_confirmed(tk)
            assert pidx is not None, \
                "old-leader ticket neither served nor refused"
            value = run._value_at(probe_key, pidx)
            if cls == "lease" and value != fresh:
                stale_served += 1
                skew_log.append(
                    f"t={run.now():.1f} STALE lease serve at idx "
                    f"{pidx}: {value!r} (fresh {fresh!r})"
                )
            run._audit_read(probe_cid, probe_key, value)
            rec.ok(run.history.stamp(run.now()), value)
        blackbox.mark("stale_probe_done", refused=refused_stale,
                      served_stale=stale_served)
        e.heal_partition()
        run.partitioned = False
        e.set_lease_rate(lead, 1.0)    # un-skew the probed row
        drive(30.0)
        run.quiesce()
        run.history.close()
        blackbox.mark("check_history", ops=len(run.history))
        per_class = check_read_classes(
            run.history, step_budget=step_budget
        )
        blackbox.mark("check_done", verdicts={
            c: r.verdict for c, r in per_class.items()
        })
    repro = (
        f"python -m raft_tpu_torch.chaos --reads --seed {seed}"
        + (f" --broken {broken}" if broken else "")
    )
    worst = next(
        (r for r in per_class.values() if r.verdict != LINEARIZABLE),
        CheckResult(LINEARIZABLE, 0),
    )
    expected = VIOLATION if broken else LINEARIZABLE
    bundle_path = _maybe_bundle(
        "reads", run, worst, expected, repro, skew_log, bundle_dir,
        extra={"refused_stale": refused_stale,
               "stale_served": stale_served,
               "classes": dict(e.read_class_counts)},
    )
    aud = (run.obs.audit.total_violations
           if run.obs is not None and run.obs.audit is not None
           else None)
    counts = e.read_class_counts
    return ReadsReport(
        seed=seed, per_class=per_class, ops=len(run.history),
        op_counts=run.history.counts(),
        lease_serves=counts.get("lease", 0),
        read_index_serves=counts.get("read_index", 0),
        session_serves=counts.get("session", 0),
        refused_stale=refused_stale, stale_served=stale_served,
        leader_kills=leader_kills, skew_log=skew_log,
        audit_violations=aud, repro=repro, broken=broken,
        bundle_path=bundle_path, obs=run.obs,
    )


def multi_commit_digest(engine) -> str:
    """CRC over every group's committed archive tail + watermark — the
    MultiEngine commit fingerprint (the single definition the multi
    open-loop runner and the wire drill both report, so their
    byte-identity pins compare the same quantity)."""
    crc = 0
    for g in range(engine.G):
        wm = int(engine.commit_watermark[g])
        crc = zlib.crc32(f"g{g}:wm:{wm}".encode(), crc)
        arch = engine._archive[g]
        for idx in sorted(i for i in arch if i <= wm):
            crc = zlib.crc32(
                arch[idx], zlib.crc32(f"{idx}".encode(), crc)
            )
    return f"{crc:08x}"


# ------------------------------------------------------- the wire drill
@dataclasses.dataclass
class WireReport:
    """Result of :func:`wire_run` — torture traffic driven through a
    REAL loopback TCP server (``raft_tpu_torch.net``) instead of in-process
    calls, with the leader-kill and overload nemeses composed. Ops are
    recorded in the same ``History`` the in-process runners use and
    graded per read class (``check_read_classes``), so the wire tier
    earns the same verdict currency as everything else: LINEARIZABLE
    or it does not ship."""

    seed: int
    per_class: Dict[str, "CheckResult"]
    ops: int
    op_counts: Dict[str, int]
    wire_refusals: Dict[str, int]
    shed_writes: int             # open-loop arrivals typed-refused
    not_leader_frames: int       # NOT_LEADER wire frames observed
    leader_kills: int
    net: dict                    # final server ``net`` stats section
    read_classes: Dict[str, int]
    repro: str
    commit_digest: str = ""      # multi_commit_digest at quiesce
    traced: bool = False         # the wire trace plane was armed
    client_spans: int = 0        # client-side span count (traced runs)
    server_spans: int = 0        # server-side wire-op span count
    pump: Optional[dict] = None  # PumpProfiler.stats() (traced runs)
    bundle_path: Optional[str] = None
    #   one bundle carrying BOTH span tables (spans + client_spans)
    #   when a bundle_dir was configured — the joined --explain input

    @property
    def verdict(self) -> str:
        verdicts = [c.verdict for c in self.per_class.values()]
        if VIOLATION in verdicts:
            return VIOLATION
        if any(v != LINEARIZABLE for v in verdicts):
            return "UNDETERMINED"
        return LINEARIZABLE

    def summary(self) -> str:
        cls = {c: r.verdict for c, r in self.per_class.items()}
        return (
            f"seed={self.seed} classes={cls} ops={self.ops} "
            f"shed={self.shed_writes} "
            f"not_leader={self.not_leader_frames} "
            f"kills={self.leader_kills} "
            f"conns={self.net.get('connections')} "
            f"bytes_in={self.net.get('bytes_in')}"
        )


def wire_run(
    seed: int,
    clients: int = 4,
    keys: int = 4,
    ops_per_phase: int = 10,
    groups: int = 2,
    step_budget: int = 500_000,
    blackbox_dir: Optional[str] = None,
    trace: bool = True,
    bundle_dir: Optional[str] = None,
    device=None,
) -> WireReport:
    """The deterministic wire-plane drill (``--wire``): a sharded
    Router stack served over a REAL loopback asyncio TCP server, with
    torture traffic arriving as wire frames. Three phases, nemeses
    composed:

    1. steady traffic — ``clients`` wire clients (own connections, own
       session tokens) running mixed writes / linearizable reads /
       session reads;
    2. LEADER KILL on the hottest group mid-traffic — clients ride
       ``NOT_LEADER`` wire refusals + backoff through the election,
       the row recovers after;
    3. OVERLOAD — an open-loop burst of one-shot writers (retry-free
       connections) past the admission depth bound: the gate's typed
       refusals surface as ``REFUSED`` wire frames, recorded ``fail``
       (provably no effect — the wire preserves the contract the
       checker leans on).

    Every client op is recorded in the shared ``History`` on the
    engine's virtual clock (the asyncio loop and the engine share one
    thread, so host execution order is real-time order — the same
    soundness argument the in-process runners make) and graded with
    ``check_read_classes``; the drill passes only if every class holds
    its contract, a shed happened, and NOT_LEADER frames were ridden
    through. No real-clock sleeps beyond the client's millisecond-scale
    jittered backoff — the run is event-driven end to end.

    ``trace=True`` (the default — the drill RUNS traced)
    arms the full wire trace plane: one client-side span per op
    (attempts/backoffs/redials), server-side wire spans adopting the
    propagated context, the pump-phase profiler, and the net metrics
    registry — all strictly additive (the determinism pin compares
    trace on vs off on a serial deterministic scenario; the drill's
    own asyncio/TCP interleaving is outside the seeded-replay domain,
    which is exactly why its verdict currency is the history checker,
    not replay identity). With a ``bundle_dir`` (argument or
    ``RAFT_TPU_BUNDLE_DIR``), a traced run writes one repro bundle
    carrying BOTH span tables — the ``--explain`` joined-forensics
    input — regardless of verdict (the artifact is the point of the
    traced drill, not a failure symptom).

    ``device`` is the ``MultiEngine``'s (CUDA unless ``"cpu"``; off the
    card it raises). The drill's interleaving over real sockets is
    outside seeded replay, so it is held by the checker's verdict and
    its pinned invariants, never field by field."""
    import asyncio

    from raft_tpu_torch.examples.kv_sharded import ShardedKV
    from raft_tpu_torch.multi.engine import MultiEngine
    from raft_tpu_torch.multi.router import Router
    from raft_tpu_torch.net import (
        IngestServer,
        RouterBackend,
        WireClient,
        WireDisconnected,
        WireRefused,
    )
    from raft_tpu_torch.net.client import WireError

    cfg = dataclasses.replace(
        _default_cfg(seed),
        admission_max_writes=8,
        admission_max_reads=64,
    )
    eng = MultiEngine(cfg, groups, device=device)
    router = Router(eng, drive=False)
    skv = ShardedKV(eng, router)
    eng.seed_leaders()
    history = History()
    key_pool = [f"wk{i}".encode() for i in range(keys)]
    rng = random.Random(f"wire:{seed}")
    leader_kills = 0
    shed_writes = 0

    # -- the wire trace plane (strictly additive; trace=False is the
    # -- byte-compatible untraced drill) ------------------------------
    client_spans = server_spans = pump = registry = None
    if trace:
        from raft_tpu_torch.obs.hostprof import PumpProfiler
        from raft_tpu_torch.obs.registry import MetricsRegistry
        from raft_tpu_torch.obs.spans import SpanTracker

        client_spans = SpanTracker()
        server_spans = SpanTracker()
        registry = MetricsRegistry()
        pump = PumpProfiler(registry=registry)
        # the engines' own causal hooks chain onto the server wire
        # spans (ambient binding across the pump's dispatch)
        eng.spans = server_spans

    def _clock() -> float:
        # both sides' spans stamp the SAME virtual clock (one thread),
        # so the joined timeline is one consistent time axis
        return eng.clock.now

    def _g(key: bytes) -> int:
        return router.group_of(key)

    async def client_ops(wc: WireClient, cid: int, n: int) -> None:
        """One serial client: the §6.3 discipline over the wire."""
        crng = random.Random(f"wire:{seed}:{cid}")
        for i in range(n):
            key = key_pool[crng.randrange(len(key_pool))]
            p = crng.random()
            if p < 0.6:
                value = f"c{cid}v{i}-{crng.randrange(1 << 20)}".encode()
                rec = history.invoke(cid, WRITE, key, value,
                                     eng.clock.now)
                try:
                    await wc.submit(key, value)
                except WireRefused:
                    # typed refusal: provably nothing queued — FAIL is
                    # sound (the gate/NotLeader contract over the wire)
                    rec.fail(history.stamp(eng.clock.now))
                except (WireDisconnected, WireError, ConnectionError):
                    rec.info()      # outcome unknown: may still commit
                else:
                    rec.ok(history.stamp(eng.clock.now))
            else:
                cls = "session" if p > 0.85 else "linearizable"
                rec = history.invoke(cid, READ, key, None,
                                     eng.clock.now)
                if cls == "session":
                    rec.ryw_floor = wc.session.floor.get(_g(key), 0)
                try:
                    out = await wc.read(key, cls=cls)
                except (WireRefused, WireError, WireDisconnected,
                        ConnectionError):
                    # an unserved read has no effect, whatever killed it
                    rec.fail(history.stamp(eng.clock.now))
                else:
                    rec.read_class = out.cls
                    rec.serve_index = out.index
                    rec.ok(history.stamp(eng.clock.now), out.value)

    async def flood(port: int, n: int) -> int:
        """Open-loop one-shot writers: no retries, unique client ids —
        the overload nemesis at the wire."""
        wc = await WireClient(
            "127.0.0.1", port, pool=1, retries=0,
            rng=random.Random(f"wire-flood:{seed}"),
            spans=client_spans, clock=_clock, trace_node=1001,
        ).connect()
        shed = 0
        async def one(j: int) -> None:
            nonlocal shed
            key = key_pool[j % len(key_pool)]
            value = f"flood{j}-{rng.randrange(1 << 20)}".encode()
            rec = history.invoke(1000 + j, WRITE, key, value,
                                 eng.clock.now)
            try:
                await wc.submit(key, value)
            except WireRefused:
                shed += 1
                rec.fail(history.stamp(eng.clock.now))
            except (WireDisconnected, WireError, ConnectionError):
                rec.info()
            else:
                rec.ok(history.stamp(eng.clock.now))
        await asyncio.gather(*[one(j) for j in range(n)])
        await wc.close()
        return shed

    async def main() -> dict:
        nonlocal leader_kills, shed_writes
        server = IngestServer(
            RouterBackend(router, skv),
            drive_quantum_s=2 * cfg.heartbeat_period,
            spans=server_spans, registry=registry, pump=pump,
        )
        port = await server.start()
        blackbox.mark("wire_serving", port=port)
        wcs = [
            await WireClient(
                "127.0.0.1", port, pool=1, retries=48,
                rng=random.Random(f"wire:{seed}:conn{cid}"),
                spans=client_spans, clock=_clock, trace_node=cid + 1,
            ).connect()
            for cid in range(clients)
        ]
        # ---- phase 1: steady wire traffic ---------------------------
        await asyncio.gather(*[
            client_ops(wc, cid, ops_per_phase)
            for cid, wc in enumerate(wcs)
        ])
        blackbox.mark("wire_steady_done", ops=len(history))
        # ---- phase 2: leader kill mid-traffic -----------------------
        hot = _g(key_pool[0])
        lead = eng.leader_id[hot]
        if lead is None:
            lead = eng.run_until_leader(hot)
        eng.fail(hot, lead)
        leader_kills += 1
        blackbox.mark("wire_leader_kill", group=hot, row=lead)
        await asyncio.gather(*[
            client_ops(wc, cid, ops_per_phase)
            for cid, wc in enumerate(wcs)
        ])
        eng.recover(hot, lead)
        blackbox.mark("wire_kill_ridden", ops=len(history))
        # ---- phase 3: open-loop overload burst ----------------------
        shed_writes = await flood(port, 3 * cfg.admission_max_writes)
        await asyncio.gather(*[
            client_ops(wc, cid, ops_per_phase)
            for cid, wc in enumerate(wcs)
        ])
        # ---- quiesce ------------------------------------------------
        for wc in wcs:
            await wc.close()
        stats = server.stats()
        nl = sum(wc.stats["not_leader"] for wc in wcs)
        await server.stop()
        return {"net": stats, "not_leader": nl}

    with blackbox.journal_for(f"wire_seed{seed}", blackbox_dir):
        blackbox.mark("wire_run", seed=seed)
        out = asyncio.run(main())
        history.close()
        blackbox.mark("check_history", ops=len(history))
        per_class = check_read_classes(history, step_budget=step_budget)
        blackbox.mark("check_done", verdicts={
            c: r.verdict for c, r in per_class.items()
        })
    counts: Dict[str, int] = {}
    for rec in history.ops:
        c = getattr(rec, "read_class", None)
        if c:
            counts[c] = counts.get(c, 0) + 1
    rep = WireReport(
        seed=seed,
        per_class=per_class,
        ops=len(history),
        op_counts=history.counts(),
        wire_refusals=dict(out["net"].get("refusals", {})),
        shed_writes=shed_writes,
        not_leader_frames=out["not_leader"],
        leader_kills=leader_kills,
        net=out["net"],
        read_classes=counts,
        repro=f"python -m raft_tpu_torch.chaos --wire --seed {seed}"
              + ("" if trace else " (untraced)"),
        commit_digest=multi_commit_digest(eng),
        traced=trace,
        client_spans=len(client_spans) if client_spans else 0,
        server_spans=(
            sum(1 for sp in server_spans.spans
                if sp.op.startswith("wire_"))
            if server_spans else 0
        ),
        pump=out["net"].get("pump"),
    )
    dest = resolve_bundle_dir(bundle_dir)
    if trace and dest is not None:
        # the traced drill's artifact: BOTH span tables in one bundle
        # (plus the op history and faults-free context) — what the
        # joined --explain consumes; written on every verdict because
        # the cross-process trace IS the deliverable here
        try:
            rep.bundle_path = write_bundle(
                dest,
                kind="wire",
                seed=seed,
                expected=LINEARIZABLE,
                verdict=rep.verdict,
                repro=rep.repro,
                config=cfg,
                history=history,
                spans=server_spans,
                client_spans=client_spans,
                extra={"side": "server+client", "net": rep.net,
                       "commit_digest": rep.commit_digest},
            )
        except OSError as ex:       # an unwritable dir must not eat
            import sys              # the report it was meant to save

            print(f"wire bundle not written: {ex}", file=sys.stderr)
    return rep


# ------------------------------------------------- transaction drill
@dataclasses.dataclass
class TxnReport:
    """Result of :func:`txn_run` — the cross-group transaction
    acceptance drill (docs/TXN.md): a transactional transfer workload
    (conserved account sum) over a sharded ``MultiEngine`` with
    single-key traffic alongside on a DISJOINT keyspace, under a
    composed nemesis — leader kill, partition, one ``migrate_group``
    mid-transaction — plus an abandoned-coordinator TTL case and a
    deliberately racing pair. ``check`` is the serializability witness
    verification (``chaos.checker.check_serializable``); ``singles``
    grades the single-key history with the linearizability checker.

    ``broken="txn_partial_commit"`` (coordinator commits after a
    failed prewrite) and ``broken="txn_dirty_read"`` (reads serve
    staged intents) must be CAUGHT: verdict VIOLATION, or the
    conserved-sum invariant broken."""

    seed: int
    check: CheckResult
    singles: CheckResult
    txns: int
    committed: int
    aborted: int
    unresolved: int
    conflicts: int
    single_ops: int
    conserved_ok: bool
    expected_total: int
    observed_total: int
    moves: List[dict]
    nemeses: List[str]
    broken: Optional[str]
    repro: str
    commit_digest: str = ""
    bundle_path: Optional[str] = None
    read_certs: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def verdict(self) -> str:
        return self.check.verdict

    @property
    def caught(self) -> bool:
        """For ``broken=`` variants: did the harness call it wrong?
        Either the witness verification finds a VIOLATION or the
        application-level conserved-sum invariant broke (the blind
        dirty-read path shows up there when the poisoned basis is not
        in the witness)."""
        return self.check.verdict == VIOLATION or not self.conserved_ok

    def summary(self) -> str:
        return (
            f"seed={self.seed} verdict={self.verdict} "
            f"txns={self.txns} committed={self.committed} "
            f"aborted={self.aborted} conflicts={self.conflicts} "
            f"conserved={self.conserved_ok} "
            f"singles={self.singles.verdict} moves={len(self.moves)}"
            + (f" broken={self.broken} caught={self.caught}"
               if self.broken else "")
        )


def txn_run(
    seed: int,
    n_groups: int = 4,
    accounts: int = 6,
    cfg: Optional[RaftConfig] = None,
    broken: Optional[str] = None,
    step_budget: int = 500_000,
    bundle_dir: Optional[str] = None,
    blackbox_dir: Optional[str] = None,
    extra_nemeses: bool = False,
    lease_reads: bool = False,
    device=None,
    mesh=None,
) -> TxnReport:
    """The deterministic transaction drill (``--txn``). Scripted
    phases, every choice seeded:

    1. seed transaction (every account <- 100) + validated transfers;
    2. abandoned coordinator: a transaction's handle is dropped after
       prewrite — its replicated locks sit until the TTL expires, and
       the next writer's status-check kicks the resolver (DECIDE-abort,
       first-decision-wins); a BLIND transfer (no wire expects; its
       read basis recorded in the witness) then lands on the freed
       keys — the ``txn_dirty_read`` store poisons that basis with the
       aborted transaction's staged intents, which the witness replay
       must reject;
    3. racing pair: two transfers sharing an account begun
       back-to-back, so BOTH prewrite and log order picks the lock
       winner — the loser must abort (``txn_partial_commit`` commits
       it anyway: a cross-group atomicity violation the replay / end
       state comparison must catch);
    4. leader kill mid-transaction (recovered), partition of a
       participant group mid-transaction (healed), and ONE
       ``migrate_group`` of a participant group mid-transaction —
       the coordinator rides typed refusals through all three;
    5. quiesce: unresolved records settle from the replicated decision
       map, every account is read back (``final_state``), the
       conserved-sum invariant is checked, and the witness + the
       single-key history are graded.

    Single-key traffic runs throughout on a DISJOINT keyspace
    (``k*`` vs ``a*``): lock-oblivious plain writes landing inside a
    lock window would genuinely break strict serializability, which is
    a documented property of the mixed deployment (docs/TXN.md), not a
    bug this drill should trip over.

    ``extra_nemeses=True`` composes the round-16 remainder nemeses
    into the same run (phase 4b): ``mem_replace`` (MultiEngine runs
    fixed membership, so the replace window is the honest
    approximation — a participant follower fails for a window and a
    "replacement" rejoins on the same row via catch-up), a
    ``wire_slow`` induced-slow-follower window (the wire fault the
    mesh transport can express: traffic received, nothing appended),
    and an open-loop ``overload`` burst through the admission gate on
    the single-key plane — each landing mid-transaction or against
    live lock traffic, named in ``nemeses``.

    ``lease_reads=True`` arms the read-plane lease path
    (``cfg.read_lease`` + prevote) and routes every transfer's basis
    read through :meth:`TxnCoordinator.validated_read`: the expects a
    transaction validates under its locks anchor to a leader-certified
    read index — zero quorum rounds when the participant leader holds
    a valid lease — instead of the bare applied map. ``read_certs``
    on the report counts the certification classes ridden.

    The run needs a sharded ``MultiEngine`` (``transport="mesh_groups"``),
    as ``migration_run`` does: ``mesh=`` is a ``transport.GroupMesh`` of
    two or more shards, which may repeat one device (two shards of
    ``cuda:0`` on one card, of ``cpu`` in the tests), and ``device`` is
    the engine's (CUDA unless ``"cpu"``; off the card it raises)."""
    from raft_tpu_torch.chaos.checker import (
        SERIALIZABLE,
        TxnRecord,
        check_serializable,
    )
    from raft_tpu_torch.chaos.history import FAIL, INFO, OK
    from raft_tpu_torch.multi.engine import MultiEngine, NotLeader, ReadLagging
    from raft_tpu_torch.multi.router import Router
    from raft_tpu_torch.txn import TxnCoordinator, TxnItem, TxnShardedKV
    from raft_tpu_torch.txn import ops as _T

    with blackbox.journal_for(f"txn_seed{seed}", blackbox_dir):
        blackbox.mark("txn_run", seed=seed, n_groups=n_groups,
                      broken=broken or "")
        base = cfg or RaftConfig(
            n_replicas=3, entry_bytes=32, batch_size=4,
            log_capacity=256, transport="mesh_groups", seed=seed,
            # the lease path rests on §9.6 leader stickiness — read_lease
            # refuses to arm without prevote (config.py validation)
            prevote=lease_reads, read_lease=lease_reads,
            # the overload window needs a gate that can actually shed:
            # a write-depth bound far above steady drill traffic but
            # inside the burst's open-loop spill
            admission_max_writes=(12 if extra_nemeses else None),
        )
        eng = MultiEngine(base, n_groups, mesh=mesh, device=device)
        if eng.n_shards < 2:
            raise RuntimeError(
                "txn_run needs a sharded layout (>= 2 devices for the "
                f"gshard axis; engine degraded to {eng.transport_mode!r})"
            )
        router = Router(eng, drive=False)
        skv = TxnShardedKV(
            eng, router,
            broken=(broken if broken == "txn_dirty_read" else None),
        )
        eng.seed_leaders()
        hb = base.heartbeat_period
        coord = TxnCoordinator(
            skv, decision_group=0, ttl_s=40.0 * hb,
            broken=(broken if broken == "txn_partial_commit" else None),
            lease_reads=lease_reads,
        )
        rng = random.Random(f"txn-drill:{seed}")
        acct = [b"a%d" % i for i in range(accounts)]
        skeys = [b"k%d" % i for i in range(6)]
        history = History()
        records: List[TxnRecord] = []
        inflight: List[tuple] = []
        moves: List[dict] = []
        nemeses: List[str] = []
        conflicts = 0
        single_count = [0]
        _single_pending: List[tuple] = []

        def now() -> float:
            return eng.clock.now

        def poll_inflight() -> None:
            nonlocal inflight
            keep = []
            for rec, h in inflight:
                if coord.poll(h, now()):
                    _finish(rec, h)
                else:
                    keep.append((rec, h))
            inflight = keep
            done = [p for p in _single_pending
                    if eng.is_durable(*p[1])]
            for rec, handle in done:
                rec.ok(history.stamp(now()))
                _single_pending.remove((rec, handle))

        def _finish(rec: TxnRecord, h) -> None:
            rec.complete_t = history.stamp(now())
            if h.status == "committed":
                d = skv.decision(h.txn_id)
                rec.status, rec.pos = OK, (d[2] if d else None)
            else:
                rec.status = FAIL

        def drive(seconds: float) -> None:
            t_end = now() + seconds
            while now() < t_end:
                eng.run_for(2 * hb)
                coord.poll_all(now())
                poll_inflight()

        def single_op() -> None:
            """One plain op on the disjoint keyspace, recorded in the
            single-key history (mixed traffic: the txn plane must not
            break the non-transactional path)."""
            key = rng.choice(skeys)
            single_count[0] += 1
            if rng.random() < 0.3:
                rec = history.invoke(7000 + single_count[0], READ, key,
                                     None, now())
                try:
                    g, idx = router.read_index(key)
                except Exception:
                    rec.fail(history.stamp(now()))
                    return
                if skv.last_applied[g] < idx:
                    drive(2 * hb)
                if skv.last_applied[g] < idx:
                    rec.fail(history.stamp(now()))
                else:
                    rec.ok(history.stamp(now()), skv.get(key))
                return
            value = b"s%d" % single_count[0]
            rec = history.invoke(7000 + single_count[0], WRITE, key,
                                 value, now())
            try:
                handle = skv.set(key, value)
            except (NotLeader, Overloaded):
                rec.fail(history.stamp(now()))
                return
            _single_pending.append((rec, handle))

        def begin_txn(writes, expects, wire_expects=True,
                      witness_expects=None, limit_s=600.0):
            """Open one transaction under the drill's retry loop.
            ``expects`` go to the coordinator (validated under locks)
            only when ``wire_expects``; the WITNESS records
            ``witness_expects`` (default: the validated set) — a blind
            transaction's observed read basis still obligates the
            serial order even though the server never certified it."""
            nonlocal conflicts
            rec = TxnRecord(
                txn_id=0, writes=dict(writes),
                expects=dict(witness_expects if witness_expects
                             is not None else expects),
                status=INFO, pos=None,
                invoke_t=history.stamp(now()),
            )
            items = []
            for k, v in writes.items():
                it = TxnItem(k, value=v, delete=v is None)
                if wire_expects and k in expects:
                    it.has_expect, it.expect = True, expects[k]
                items.append(it)
            deadline = now() + limit_s
            while True:
                try:
                    h = coord.begin(items)
                    break
                except _T.LockConflict as ex:
                    conflicts += 1
                    drive(max(ex.retry_after_s, 2 * hb))
                except (NotLeader, Overloaded):
                    drive(4 * hb)
                if now() > deadline:
                    rec.status = FAIL
                    records.append(rec)
                    return rec, None
            rec.txn_id = h.txn_id
            records.append(rec)
            inflight.append((rec, h))
            return rec, h

        def settle(*handles, limit_s=600.0) -> None:
            deadline = now() + limit_s
            while any(not h.done for h in handles if h is not None):
                if now() > deadline:
                    break
                drive(4 * hb)

        def bal(key: bytes) -> Optional[bytes]:
            """A transfer's basis read. With ``lease_reads`` armed it
            goes through the coordinator's validated path (certified
            read index, zero rounds under a valid lease), riding out
            elections and apply lag like any router read; otherwise
            the plain applied read the drill always used."""
            for _ in range(80):
                try:
                    return coord.validated_read(key)
                except (NotLeader, ReadLagging):
                    drive(4 * hb)
            return skv.get(key)

        def transfer(src: bytes, dst: bytes, mid=None):
            """One validated transfer src -> dst: read both balances,
            expect them under the locks, write the moved amounts.
            ``mid`` (if given) fires between prewrite and settle — how
            the drill lands a nemesis INSIDE a transaction window."""
            amt = rng.randint(1, 9)
            bs, bd = bal(src), bal(dst)
            writes = {
                src: str(int(bs or b"0") - amt).encode(),
                dst: str(int(bd or b"0") + amt).encode(),
            }
            rec, h = begin_txn(writes, {src: bs, dst: bd})
            if h is not None and mid is not None:
                mid(h)
            if h is not None:
                settle(h)
            single_op()
            return rec, h

        # ---- phase 1: seed + baseline --------------------------------
        blackbox.mark("txn_phase", name="seed")
        _, h0 = begin_txn({a: b"100" for a in acct}, {})
        settle(h0)
        if h0 is None or h0.status != "committed":
            raise RuntimeError("txn_run could not seed the accounts")
        for _ in range(3):
            i = rng.randrange(3, accounts)
            j = rng.randrange(3, accounts)
            while j == i:
                j = rng.randrange(3, accounts)
            transfer(acct[i], acct[j])

        # ---- phase 2: abandoned coordinator + TTL + blind basis ------
        blackbox.mark("txn_phase", name="abandon")
        ab_amt = rng.randint(1, 9)
        ab_rec, ab_h = begin_txn(
            {acct[0]: str(100 - ab_amt).encode(),
             acct[1]: str(100 + ab_amt).encode()},
            {acct[0]: bal(acct[0]), acct[1]: bal(acct[1])},
        )
        if ab_h is not None:
            # the coordinator dies here: drop the handle unpolled — its
            # locks must resolve via TTL + status-check, not our help
            inflight.remove((ab_rec, ab_h))
        drive(6 * hb)                     # prewrites apply, locks live
        for _ in range(2):                # traffic AWAY from a0..a2
            i = rng.randrange(3, accounts)
            j = rng.randrange(3, accounts)
            while j == i:
                j = rng.randrange(3, accounts)
            transfer(acct[i], acct[j])
        drive(45.0 * hb)                  # past the lock TTL
        # blind transfer a0 -> a2: basis read NOW (an expired foreign
        # lock still sits on a0 — the dirty-read store serves its
        # staged, never-committed intent), written WITHOUT server-side
        # expects, basis recorded in the witness
        b0, b2 = bal(acct[0]), bal(acct[2])
        blind_amt = rng.randint(1, 9)
        _, bh = begin_txn(
            {acct[0]: str(int(b0 or b"0") - blind_amt).encode(),
             acct[2]: str(int(b2 or b"0") + blind_amt).encode()},
            {}, wire_expects=False,
            witness_expects={acct[0]: b0, acct[2]: b2},
        )
        settle(bh)

        # ---- phase 3: racing pair ------------------------------------
        blackbox.mark("txn_phase", name="race")
        r_amt = rng.randint(1, 9)
        ba3, ba4, ba5 = bal(acct[3]), bal(acct[4]), bal(acct[5])
        _, rh1 = begin_txn(
            {acct[3]: str(int(ba3 or b"0") - r_amt).encode(),
             acct[4]: str(int(ba4 or b"0") + r_amt).encode()},
            {acct[3]: ba3, acct[4]: ba4},
        )
        # begun back-to-back: rh1's locks are not APPLIED yet, so the
        # conflict check passes and BOTH prewrite — log order picks
        # the a4 lock winner, the loser must abort (lock_lost)
        _, rh2 = begin_txn(
            {acct[4]: str(int(ba4 or b"0") - r_amt).encode(),
             acct[5]: str(int(ba5 or b"0") + r_amt).encode()},
            {acct[4]: ba4, acct[5]: ba5},
        )
        settle(rh1, rh2)

        # ---- phase 4: nemeses mid-transaction ------------------------
        blackbox.mark("txn_phase", name="nemesis")
        killed: List[tuple] = []
        parted: List[int] = []

        def kill_mid(h) -> None:
            g = h.groups[0]
            r = eng.leader_id[g]
            if r is None:
                r = 0
            r = int(r)
            eng.fail(g, r)
            killed.append((g, r))
            nemeses.append(f"kill g{g} r{r}")
            blackbox.mark("txn_nemesis", kind="kill", group=g, replica=r)

        def part_mid(h) -> None:
            g = h.groups[-1]
            r = eng.leader_id[g]
            if r is None:
                r = 0
            r = int(r)
            rest = [x for x in range(base.n_replicas) if x != r]
            eng.partition(g, [[r], rest])
            parted.append(g)
            nemeses.append(f"partition g{g} leader {r} alone")
            blackbox.mark("txn_nemesis", kind="partition", group=g)

        def move_mid(h) -> None:
            g = h.groups[0]
            mv = eng.migrate_group(g, (eng.shard_of(g) + 1)
                                   % eng.n_shards)
            if mv is not None:
                moves.append(mv)
                nemeses.append(f"migrate g{g} -> shard {mv['dst']}")
            blackbox.mark("txn_nemesis", kind="migrate", group=g,
                          ok=mv is not None)

        i, j = rng.randrange(accounts), rng.randrange(accounts)
        while j == i:
            j = rng.randrange(accounts)
        transfer(acct[i], acct[j], mid=kill_mid)
        for g, r in killed:
            eng.recover(g, r)
        transfer(acct[j], acct[i])

        i, j = rng.randrange(accounts), rng.randrange(accounts)
        while j == i:
            j = rng.randrange(accounts)
        transfer(acct[i], acct[j], mid=part_mid)
        for g in parted:
            eng.heal_partition(g)
        transfer(acct[j], acct[i])

        i, j = rng.randrange(accounts), rng.randrange(accounts)
        while j == i:
            j = rng.randrange(accounts)
        transfer(acct[i], acct[j], mid=move_mid)
        for _ in range(2):
            i = rng.randrange(accounts)
            j = rng.randrange(accounts)
            while j == i:
                j = rng.randrange(accounts)
            transfer(acct[i], acct[j])

        # ---- phase 4b: round-16 remainder nemeses (opt-in) -----------
        if extra_nemeses:
            blackbox.mark("txn_phase", name="nemesis_extra")

            def _pick_pair():
                a = rng.randrange(accounts)
                b = rng.randrange(accounts)
                while b == a:
                    b = rng.randrange(accounts)
                return a, b

            # mem_replace: MultiEngine runs FIXED membership, so the
            # replace window is approximated the only honest way the
            # layer allows — a participant FOLLOWER fails mid-txn (the
            # removed voter) and the "replacement" rejoins on the same
            # row via log catch-up. Quorum survives (2/3 up), so the
            # transaction must ride it out, not abort.
            replaced: List[tuple] = []

            def replace_mid(h) -> None:
                g = h.groups[0]
                lead = eng.leader_id[g]
                r = next(
                    (x for x in range(base.n_replicas)
                     if x != lead and eng.alive[g, x]),
                    None,
                )
                if r is None:
                    return
                eng.fail(g, r)
                replaced.append((g, r))
                nemeses.append(
                    f"mem_replace g{g} r{r} (fixed-membership window)"
                )
                blackbox.mark("txn_nemesis", kind="mem_replace",
                              group=g, replica=r)

            i, j = _pick_pair()
            transfer(acct[i], acct[j], mid=replace_mid)
            drive(6 * hb)
            for g, r in replaced:
                eng.recover(g, r)
            transfer(acct[j], acct[i])

            # wire fault: the induced-slow follower — the wire-level
            # fault the mesh transport expresses (traffic received,
            # nothing appended, matchIndex goes stale) — for a window
            # spanning a transaction's prewrite/validate.
            slowed: List[tuple] = []

            def wire_mid(h) -> None:
                g = h.groups[-1]
                lead = eng.leader_id[g]
                r = next(
                    (x for x in range(base.n_replicas) if x != lead),
                    0,
                )
                eng.set_slow(g, r, True)
                slowed.append((g, r))
                nemeses.append(f"wire_slow g{g} r{r}")
                blackbox.mark("txn_nemesis", kind="wire_slow",
                              group=g, replica=r)

            i, j = _pick_pair()
            transfer(acct[i], acct[j], mid=wire_mid)
            drive(8 * hb)
            for g, r in slowed:
                eng.set_slow(g, r, False)
            transfer(acct[j], acct[i])

            # overload window: an open-loop burst on the single-key
            # plane — submits queue faster than the drill drives, the
            # admission gate refuses the spill (typed), lock traffic
            # keeps flowing underneath.
            burst, refused = 64, 0
            for _ in range(burst):
                key = rng.choice(skeys)
                single_count[0] += 1
                value = b"o%d" % single_count[0]
                rec = history.invoke(7000 + single_count[0], WRITE,
                                     key, value, now())
                try:
                    handle = skv.set(key, value)
                except (NotLeader, Overloaded, _T.LockConflict):
                    refused += 1
                    rec.fail(history.stamp(now()))
                else:
                    _single_pending.append((rec, handle))
            nemeses.append(f"overload burst {burst} "
                           f"({refused} refused)")
            blackbox.mark("txn_nemesis", kind="overload",
                          submitted=burst, refused=refused)
            drive(12 * hb)
            i, j = _pick_pair()
            transfer(acct[i], acct[j])

        # ---- phase 5: quiesce + grade --------------------------------
        blackbox.mark("txn_phase", name="quiesce")
        for g in range(eng.G):
            eng.heal_partition(g)
            for r in range(base.n_replicas):
                if not eng.alive[g, r]:
                    eng.recover(g, r)
        for g in range(eng.G):
            eng.run_until_leader(g, limit=3000.0)
        deadline = now() + 600.0
        while (inflight or coord._resolves) and now() < deadline:
            drive(4 * hb)
        drive(8 * hb)
        # unresolved records settle from the REPLICATED decision map —
        # the same authority a restarted coordinator replays
        for rec in records:
            if rec.status == INFO:
                d = skv.decision(rec.txn_id)
                if d is not None:
                    rec.status = OK if d[0] else FAIL
                    rec.pos = d[2] if d[0] else None
        history.close()
        final_state = {a: skv.get(a) for a in acct
                       if skv.get(a) is not None}
        observed = sum(int(v) for v in final_state.values())
        expected_total = 100 * accounts
        conserved_ok = observed == expected_total
        blackbox.mark("txn_check", txns=len(records),
                      observed=observed, expected=expected_total)
        check = check_serializable(records, final_state=final_state,
                                   initial={})
        singles = check_history(history, step_budget=step_budget)
        blackbox.mark("txn_done", verdict=check.verdict,
                      singles=singles.verdict)

    committed = sum(1 for r in records if r.status == OK)
    aborted = sum(1 for r in records if r.status == FAIL)
    unresolved = sum(1 for r in records if r.status == INFO)
    repro = (
        f"python -m raft_tpu_torch.chaos --txn --seed {seed}"
        + (f" --broken {broken}" if broken else "")
        + (" --txn-extra" if extra_nemeses else "")
        + (" --txn-lease-reads" if lease_reads else "")
    )
    shim = type("_Shim", (), {
        "seed": seed, "cfg": base, "history": history, "obs": None,
    })()
    expected = SERIALIZABLE if broken is None else VIOLATION
    bundle_path = _maybe_bundle(
        "txn", shim, check, expected, repro, nemeses, bundle_dir,
        extra={"moves": moves, "conserved_ok": conserved_ok,
               "observed_total": observed,
               "coordinator": coord.status_snapshot()},
        force_unexpected=(broken is None and not conserved_ok),
    )
    return TxnReport(
        seed=seed, check=check, singles=singles, txns=len(records),
        committed=committed, aborted=aborted, unresolved=unresolved,
        conflicts=conflicts, single_ops=single_count[0],
        conserved_ok=conserved_ok, expected_total=expected_total,
        observed_total=observed, moves=moves, nemeses=nemeses,
        broken=broken, repro=repro,
        commit_digest=multi_commit_digest(eng),
        bundle_path=bundle_path,
        read_certs=dict(coord.read_certs) if lease_reads else {},
    )

