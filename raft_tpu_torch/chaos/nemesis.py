"""The nemesis: a seed-driven adversary schedule generator
(port of ``raft_tpu/chaos/nemesis.py``, line for line).

One ``random.Random(seed)`` stream decides everything the adversary
does, so a torture run is replayed exactly by its seed + config — the
one-line repro the runner prints on failure. The vocabulary composes
three fault planes:

- **process faults** — the existing ``faults.FaultPlan`` vocabulary
  (kill/recover, slow windows, disruptive candidacies, link
  partitions), emitted as real ``FaultPlan`` fragments and merged into
  the engine's event heap through ``schedule_faults`` after the plan's
  own strict majority validation (``FaultPlan.validate``);
- **message faults** — windows of transport-level drop/dup/delay
  toggled on a ``chaos.ChaosTransport``;
- **crash cycles** — whole-process crash + checkpoint-restore +
  restart, optionally composed with a storage fault against the
  durability stack (``chaos.MirroredStore``: torn vote-WAL append,
  checkpoint bit-flip, stale-file rollback);
- **overload windows** (opt-in, ``allow_overload=True`` — off by
  default so existing seeds' rng streams replay unchanged) — open-loop
  Poisson arrival storms at 2-10x the cluster's measured ingest
  capacity, composable with every other plane. The runner converts the
  rate into open-loop client traffic; admission-shed arrivals are
  recorded as sound no-effect failures, so the linearizability verdict
  must stay ACCEPT through the storm (docs/OVERLOAD.md).
- **clock-skew plane** (opt-in, ``allow_clock=True`` — off by default
  for the same replay reason) — per-replica LEASE-clock rate skew
  inside the configured drift band ``[1/clock_drift_bound,
  clock_drift_bound]``: the exact envelope the leader-lease safety
  math claims to absorb (raft.lease). A correct lease plane stays
  linearizable across every draw in the band; the
  ``broken="lease_skew"`` variant (drift bound ignored) is what a
  stale read looks like when the claim is false (docs/READS.md).
- **membership plane** (opt-in, ``allow_membership=True`` — off by
  default for the same replay reason) — seeded reconfiguration under
  fire: grow (learner-then-promote ``add_server``), shrink, removal of
  the current LEADER, and wipe-replace cycles (kill + total durable
  loss + ``replace`` rejoin-from-nothing through snapshot install as a
  learner), composed with every other plane. Every choice is gated so
  a strict majority of the *current* voter set stays alive through the
  op — the quorum-liveness rule applied to the post-change
  configuration (docs/CHAOS.md round 9).

Liveness discipline: every choice is gated so the run can quiesce —
kills never leave fewer than a majority of members alive (the same rule
``FaultPlan.validate`` enforces, applied adaptively here), partitions
always leave a majority side, and storage faults never touch the last
healthy mirror. The nemesis makes the runs *mean* something: a torture
sweep that wedges proves nothing about linearizability.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional

from raft_tpu_torch.faults.plan import FaultPlan

STORAGE_FAULTS = ("none", "tear_votelog", "flip_bit", "rollback")


@dataclasses.dataclass
class MembershipView:
    """The runner's live configuration snapshot for membership
    decisions: voter rows, learner rows, unconfigured spare rows, the
    routed leader (None between leaderships), and whether any
    configuration change is in flight (pending, queued or staged)."""

    voters: List[int]
    learners: List[int]
    spares: List[int]
    leader: Optional[int]
    in_flight: bool


@dataclasses.dataclass
class NemesisAction:
    """One adversary decision for the runner to execute."""

    kind: str                      # see Nemesis.KINDS
    replica: int = 0
    plan: Optional[FaultPlan] = None        # kind == "plan"
    groups: Optional[list] = None           # kind == "partition"
    drop: float = 0.0                       # kind == "msg_on"
    dup: float = 0.0
    delay: float = 0.0
    storage: str = "none"                   # kind == "crash_restart"
    rate_mult: float = 0.0                  # kind == "overload_on"
    spare: int = 0                          # kind == "mem_replace"
    rate: float = 1.0                       # kind == "skew_on" (lease
    #                                         clock rate, local s/true s)

    def describe(self) -> str:
        if self.kind == "skew_on":
            return f"skew_on({self.replica}, rate={self.rate:.3f})"
        if self.kind == "skew_off":
            return f"skew_off({self.replica})"
        if self.kind == "msg_on":
            return (f"msg_on(drop={self.drop:.2f}, dup={self.dup:.2f}, "
                    f"delay={self.delay:.2f})")
        if self.kind == "overload_on":
            return f"overload_on(rate={self.rate_mult:.1f}x capacity)"
        if self.kind == "crash_restart":
            return f"crash_restart(storage={self.storage})"
        if self.kind == "partition":
            return f"partition({self.groups})"
        if self.kind == "mem_replace":
            return f"mem_replace({self.replica} -> {self.spare})"
        if self.kind == "plan":
            return f"plan({[(e.t, e.action, e.replica) for e in self.plan.events]})"
        return f"{self.kind}({self.replica})"


class Nemesis:
    """Seeded adversary policy over a live cluster view.

    ``view`` duck-type (the runner adapts either engine): ``members()``
    -> list of member rows, ``alive(r)`` -> bool, ``partitioned`` flag
    maintained by the runner, ``now`` -> virtual clock.
    """

    KINDS = (
        "kill", "recover", "slow", "unslow", "campaign",
        "partition", "heal", "plan", "msg_on", "msg_off",
        "crash_restart", "overload_on", "overload_off",
        "mem_grow", "mem_shrink", "mem_remove_leader", "mem_replace",
        "skew_on", "skew_off",
        "none",
    )

    def __init__(
        self,
        seed: int,
        n_rows: int,
        allow_crash: bool = True,
        allow_msg: bool = True,
        allow_storage: bool = True,
        allow_overload: bool = False,
        allow_membership: bool = False,
        allow_clock: bool = False,
        clock_drift_bound: float = 2.0,
    ):
        self.rng = random.Random(f"nemesis:{seed}")
        self.n_rows = n_rows
        self.allow_crash = allow_crash
        self.allow_msg = allow_msg
        self.allow_storage = allow_storage
        self.allow_overload = allow_overload
        self.allow_membership = allow_membership
        self.allow_clock = allow_clock
        self.clock_drift_bound = clock_drift_bound
        #   skew_on draws lease-clock rates inside the drift band the
        #   lease plane's config CLAIMS to absorb — the adversary probes
        #   exactly the assumption, never outside it (outside it the
        #   deployment lied about its clocks, which is what the
        #   broken="lease_skew" variant models instead)
        #   off by default: adding kinds to the choice pool perturbs the
        #   decision stream, and existing pinned seeds must replay
        #   byte-identically
        self.msg_window = False
        self.overload_window = False
        self.cut: List[int] = []
        #   minority side of the active partition; kill gating consults
        #   it so kill x partition can never strand BOTH sides below
        #   quorum (see _kill_ok)
        self.log: List[str] = []

    # ------------------------------------------------------------- policy
    def _kill_ok(self, members: List[int], dead: int,
                 victim: int, partitioned: bool) -> bool:
        # mirror tests/test_chaos.py's rule: a strict majority of the
        # CURRENT membership stays alive after one more kill — and while
        # a partition is up, only minority-cut members may die: a kill
        # on the majority side would compose with the cut into no live
        # quorum on EITHER side (every write then stalls until a random
        # heal, collapsing the run's discriminating power)
        if partitioned and victim not in self.cut:
            return False
        return dead + 1 <= (len(members) - 1) // 2

    def _shrink_ok(self, victim: int, voters: List[int],
                   alive: Dict[int, bool]) -> bool:
        """A removal is admissible iff the POST-change voter set keeps a
        live strict majority — the quorum-liveness rule counted over the
        configuration the cluster is about to be in, not the initial
        ``n`` (the FaultPlan.validate membership-timeline rule, applied
        adaptively)."""
        new = [v for v in voters if v != victim]
        if len(new) < 2:
            return False
        live = sum(1 for v in new if alive.get(v, False))
        return live >= len(new) // 2 + 1

    def next_action(
        self, members: List[int], alive: Dict[int, bool],
        partitioned: bool, now: float,
        membership: Optional[MembershipView] = None,
    ) -> NemesisAction:
        rng = self.rng
        if not partitioned:
            self.cut = []   # heal or crash-restart dissolved the split
        kinds = ["kill", "recover", "slow", "unslow", "campaign",
                 "partition", "heal", "plan", "none"]
        if self.allow_msg:
            kinds += ["msg_on", "msg_off"]
        if self.allow_crash:
            kinds.append("crash_restart")
        if self.allow_overload:
            kinds += ["overload_on", "overload_off"]
        if self.allow_membership and membership is not None:
            kinds += ["mem_grow", "mem_shrink", "mem_remove_leader",
                      "mem_replace"]
        if self.allow_clock:
            kinds += ["skew_on", "skew_off"]
        kind = rng.choice(kinds)
        dead = sum(1 for r in members if not alive[r])
        victim = rng.randrange(self.n_rows)
        act = NemesisAction("none")
        if kind == "kill":
            if (victim in members and alive[victim]
                    and self._kill_ok(members, dead, victim, partitioned)):
                act = NemesisAction("kill", victim)
        elif kind == "recover":
            if not alive[victim]:
                act = NemesisAction("recover", victim)
        elif kind == "slow":
            if victim in members and alive[victim]:
                act = NemesisAction("slow", victim)
        elif kind == "unslow":
            act = NemesisAction("unslow", victim)
        elif kind == "campaign":
            act = NemesisAction("campaign", victim)
        elif kind == "partition" and not partitioned:
            # cut one LIVE member; the rest side must keep a live
            # majority of the membership or no side could ever commit
            live = [r for r in members if alive[r]]
            if len(live) - 1 > len(members) // 2:
                cut = [rng.choice(live)]      # minority side of one member
                rest = [r for r in range(self.n_rows) if r not in cut]
                self.cut = cut
                act = NemesisAction("partition", groups=[cut, rest])
        elif kind == "heal" and partitioned:
            act = NemesisAction("heal")
        elif kind == "plan":
            act = self._compose_plan(members, alive, dead, partitioned, now)
        elif kind == "msg_on" and self.allow_msg:
            self.msg_window = True
            act = NemesisAction(
                "msg_on",
                drop=rng.uniform(0.05, 0.35),
                dup=rng.uniform(0.0, 0.3),
                delay=rng.uniform(0.0, 0.25),
            )
        elif kind == "msg_off" and self.msg_window:
            self.msg_window = False
            act = NemesisAction("msg_off")
        elif kind == "crash_restart" and self.allow_crash:
            pool = STORAGE_FAULTS if self.allow_storage else ("none",)
            act = NemesisAction(
                "crash_restart", storage=rng.choice(pool)
            )
        elif kind == "overload_on" and not self.overload_window:
            # open-loop arrival storm: the ISSUE's 2-10x band over the
            # cluster's measured ingest capacity (the runner converts
            # the multiplier into a Poisson rate)
            self.overload_window = True
            act = NemesisAction(
                "overload_on", rate_mult=rng.uniform(2.0, 10.0)
            )
        elif kind == "overload_off" and self.overload_window:
            self.overload_window = False
            act = NemesisAction("overload_off")
        elif kind == "skew_on" and self.allow_clock:
            # lease-clock rate inside the configured drift band (log-
            # uniform so slow and fast clocks are equally likely; the
            # band EDGES are the interesting draws and stay reachable)
            import math

            lo = math.log(1.0 / self.clock_drift_bound)
            hi = math.log(self.clock_drift_bound)
            act = NemesisAction(
                "skew_on", victim,
                rate=math.exp(rng.uniform(lo, hi)),
            )
        elif kind == "skew_off" and self.allow_clock:
            act = NemesisAction("skew_off", victim)
        elif kind.startswith("mem_") and membership is not None:
            act = self._membership_action(
                kind, membership, alive, partitioned
            )
        self.log.append(f"t={now:.1f} {act.describe()}")
        return act

    def _membership_action(
        self, kind: str, mv: MembershipView, alive: Dict[int, bool],
        partitioned: bool,
    ) -> NemesisAction:
        """Gate and parameterize one reconfiguration op. Ops only start
        with no change in flight and no active partition (a change may
        still be MID-FLIGHT when a later partition/kill/crash lands —
        that interleaving is the point of the plane); every choice keeps
        a live strict majority of the post-change voter set."""
        rng = self.rng
        none = NemesisAction("none")
        if mv.in_flight or partitioned or mv.leader is None:
            return none
        if kind == "mem_grow":
            if not mv.spares:
                return none
            return NemesisAction("mem_grow", rng.choice(mv.spares))
        if kind == "mem_shrink":
            # learners are removable for free; voters only under the
            # post-change quorum-liveness gate (never the leader here —
            # that is mem_remove_leader's job, kept distinct so coverage
            # of the removed-leader path is seed-addressable)
            cands = list(mv.learners) + [
                v for v in mv.voters
                if v != mv.leader and self._shrink_ok(v, mv.voters, alive)
            ]
            if not cands or len(mv.voters) <= 2:
                return none
            return NemesisAction("mem_shrink", rng.choice(cands))
        if kind == "mem_remove_leader":
            if len(mv.voters) <= 2 or mv.leader not in mv.voters:
                return none
            if not self._shrink_ok(mv.leader, mv.voters, alive):
                return none
            return NemesisAction("mem_remove_leader", mv.leader)
        if kind == "mem_replace":
            # wipe-replace: kill (if needed) + total durable loss +
            # rejoin-from-nothing as a learner. Prefer an already-dead
            # voter; else a live non-leader voter the kill gate admits.
            dead_voters = [v for v in mv.voters if not alive.get(v, False)]
            if dead_voters:
                victim = rng.choice(dead_voters)
            else:
                dead = sum(1 for v in mv.voters if not alive.get(v, False))
                live = [
                    v for v in mv.voters
                    if alive.get(v, False) and v != mv.leader
                    and self._kill_ok(mv.voters, dead, v, partitioned)
                ]
                if not live:
                    return none
                victim = rng.choice(live)
            a2 = dict(alive)
            a2[victim] = False
            if not self._shrink_ok(victim, mv.voters, a2):
                return none
            spare = rng.choice(mv.spares) if mv.spares else victim
            return NemesisAction("mem_replace", victim, spare=spare)
        return none

    def _compose_plan(
        self, members: List[int], alive: Dict[int, bool], dead: int,
        partitioned: bool, now: float,
    ) -> NemesisAction:
        """A scheduled FaultPlan fragment over the next phase window —
        the classic vocabulary riding the engine's own heap, validated
        by the plan's strict majority check before it is handed over."""
        rng = self.rng
        flavor = rng.choice(["slow_window", "crash_recover", "storm"])
        live = [r for r in members if alive[r]]
        r = rng.choice(live) if live else 0
        if flavor == "slow_window" and live:
            plan = FaultPlan.slow_window(r, now + 1.0, now + rng.uniform(10, 30))
        elif flavor == "crash_recover" and live and self._kill_ok(
            members, dead, r, partitioned
        ):
            plan = FaultPlan.crash_recover(
                r, now + 1.0, now + rng.uniform(15, 40)
            )
        else:
            plan = FaultPlan.election_storm(
                len(members), now + 1.0, now + rng.uniform(10, 25),
                mean_interval=5.0, seed=rng.randrange(1 << 30),
            )
        # belt and braces: the fragment itself must pass the strict
        # majority validation (it schedules recover after kill, so the
        # adaptive gate above is the binding one). The validation counts
        # the CURRENT voter set, not the initial n — under the
        # membership plane the two diverge (FaultPlan.validate's
        # membership timeline).
        alive0 = [alive.get(r, True) for r in range(self.n_rows)]
        plan.validate(
            self.n_rows, alive=alive0, strict=True,
            membership=[(0.0, list(members))],
        )
        return NemesisAction("plan", plan=plan)
