"""Scripted fault schedules for the engine's virtual clock.

A ``FaultPlan`` is a time-ordered list of fault events; the engine merges
them into its timer heap (``RaftEngine.schedule_faults``) so faults
interleave deterministically with elections and replication ticks.

Actions:
- ``kill`` / ``recover``  — crash-stop a replica / bring it back
  (BASELINE config 4's hard variant; the engine masks it from collectives)
- ``slow`` / ``unslow``   — induced-slow follower: receives traffic,
  appends nothing, matchIndex goes stale (BASELINE config 4)
- ``campaign``            — force a disruptive candidacy: term bump + vote
  round regardless of a live leader (the randomized term bumps of
  BASELINE config 5's election storm)
- ``partition`` / ``heal_partition`` — link-level split: replicas talk
  only within their group (``groups``); the classic split-brain
  adversary the reference's always-delivering channels cannot express

A copy of ``raft_tpu/faults/plan.py`` (host only), kept in this
package so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Tuple

ACTIONS = ("kill", "recover", "slow", "unslow", "campaign",
           "partition", "heal_partition")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    t: float
    action: str
    replica: int = 0          # unused by partition/heal_partition
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None  # partition only
    group: Optional[int] = None
    #   Optional Raft-GROUP scope for multi-Raft runs
    #   (``multi.MultiEngine.schedule_faults``): the event hits only that
    #   consensus group's replicas. None = every group — and the
    #   single-group ``RaftEngine`` ignores the field entirely, so
    #   existing plans drive either engine unchanged.

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.action == "partition" and not self.groups:
            raise ValueError("partition events need non-empty groups")


@dataclasses.dataclass
class FaultPlan:
    events: List[FaultEvent] = dataclasses.field(default_factory=list)

    def add(self, t: float, action: str, replica: int) -> "FaultPlan":
        self.events.append(FaultEvent(t, action, replica))
        return self

    @classmethod
    def slow_window(cls, replica: int, start: float, stop: float) -> "FaultPlan":
        """Config 4: one follower slow for [start, stop)."""
        return cls([FaultEvent(start, "slow", replica),
                    FaultEvent(stop, "unslow", replica)])

    @classmethod
    def crash_recover(cls, replica: int, t_kill: float, t_recover: float) -> "FaultPlan":
        return cls([FaultEvent(t_kill, "kill", replica),
                    FaultEvent(t_recover, "recover", replica)])

    @classmethod
    def split(cls, groups, start: float, stop: float) -> "FaultPlan":
        """Link-level partition into ``groups`` over [start, stop)."""
        return cls([
            FaultEvent(start, "partition",
                       groups=tuple(tuple(g) for g in groups)),
            FaultEvent(stop, "heal_partition"),
        ])

    @classmethod
    def election_storm(
        cls, n_replicas: int, start: float, stop: float,
        mean_interval: float, seed: int = 0,
    ) -> "FaultPlan":
        """Config 5: randomized disruptive candidacies (term bumps) from
        random replicas at ~exponential intervals over [start, stop)."""
        rng = random.Random(seed)
        events = []
        t = start
        while True:
            t += rng.expovariate(1.0 / mean_interval)
            if t >= stop:
                break
            events.append(FaultEvent(t, "campaign", rng.randrange(n_replicas)))
        return cls(events)

    def merged(self, other: "FaultPlan") -> "FaultPlan":
        """Merge two plans into one time-ordered plan.

        Tie order is STABLE and documented: events sharing the same
        ``t`` keep ``self``'s events before ``other``'s, each side in
        its original list order (``sorted`` is stable and the key is
        ``t`` alone). The engine's heap adds its own monotone tiebreak
        on top, so same-``t`` events also FIRE in exactly this order —
        a schedule's behavior never depends on sort internals."""
        return FaultPlan(sorted(self.events + other.events, key=lambda e: e.t))

    def validate(
        self,
        n_replicas: int,
        alive=None,
        strict: bool = True,
        membership=None,
    ) -> List[FaultEvent]:
        """Check the plan's kill events against the quorum-liveness rule:
        simulated in time order (same-``t`` ties in list order, matching
        ``merged``), no ``kill`` may leave fewer than a strict majority
        of the CURRENT voter set alive — a plan that does cannot
        quiesce and proves nothing. ``alive`` optionally seeds the
        per-replica aliveness (default: all up). Returns the offending
        kill events (each treated as NOT executed for the rest of the
        walk, so later events are judged against the best repairable
        schedule); with ``strict=True`` (the default) raises
        ``ValueError`` on the first one instead.

        ``membership`` makes the rule configuration-aware (live
        reconfiguration — the round-9 membership plane): either a
        time-ordered sequence of ``(t, member_rows)`` pairs (the voter
        set from instant ``t`` on; the walk switches sets as its clock
        passes each ``t``) or a callable ``t -> member_rows``. Kills of
        NON-members never count against quorum (a dead spare or learner
        keeps no one out of office), the majority denominator is the
        current voter set's size — and a membership *transition* that
        itself strands the new set below a live majority (a shrink
        landing on mostly-dead voters) is an offense of its own,
        reported as a synthetic ``kill``-less offense via ``ValueError``
        under ``strict`` (non-strict walks skip to the next timeline
        entry, mirroring the kill handling). ``membership=None`` keeps
        the legacy fixed-membership rule bit-for-bit.

        The walk models only kill/recover (partitions and slow windows
        do not change aliveness)."""
        up = list(alive) if alive is not None else [True] * n_replicas
        if len(up) != n_replicas:
            raise ValueError(
                f"alive has {len(up)} entries for {n_replicas} replicas"
            )
        if callable(membership):
            member_at = membership
            timeline: List[Tuple[float, Tuple[int, ...]]] = []
        elif membership is not None:
            timeline = sorted(
                (float(t), tuple(m)) for t, m in membership
            )
            member_at = None
        else:
            timeline, member_at = [], None

        def members_for(t: float):
            if member_at is not None:
                return sorted(set(int(r) for r in member_at(t)))
            # before the first timeline entry takes effect, the legacy
            # rule governs (every row is a voter) — seeding with the
            # first entry would judge pre-transition kills against a
            # FUTURE configuration
            cur = tuple(range(n_replicas))
            for tt, m in timeline:
                if tt <= t:
                    cur = m
                else:
                    break
            return sorted(set(int(r) for r in cur))

        def check_transition(t: float, members) -> None:
            live = sum(1 for r in members if 0 <= r < n_replicas and up[r])
            if live < len(members) // 2 + 1:
                raise ValueError(
                    f"membership at t={t} leaves {live} of "
                    f"{len(members)} voters alive (majority is "
                    f"{len(members) // 2 + 1}); a post-shrink cluster "
                    "below live quorum cannot quiesce"
                )

        offending: List[FaultEvent] = []
        pending = list(timeline)
        for ev in sorted(self.events, key=lambda e: e.t):
            while pending and pending[0][0] <= ev.t:
                tt, m = pending.pop(0)
                if strict:
                    check_transition(tt, list(m))
            members = members_for(ev.t)
            majority = len(members) // 2 + 1
            if ev.action == "recover":
                if 0 <= ev.replica < n_replicas:
                    up[ev.replica] = True
            elif ev.action == "kill" and 0 <= ev.replica < n_replicas:
                if ev.replica not in members:
                    # spares and learners die for free: no quorum impact
                    up[ev.replica] = False
                    continue
                live = sum(1 for r in members if up[r])
                if up[ev.replica] and live - 1 < majority:
                    if strict:
                        raise ValueError(
                            f"kill of replica {ev.replica} at t={ev.t} "
                            f"leaves {live - 1} of {len(members)} voters "
                            f"alive (majority is {majority}); a plan "
                            "below majority cannot quiesce"
                        )
                    offending.append(ev)
                else:
                    up[ev.replica] = False
        if strict:
            for tt, m in pending:   # transitions after the last event
                check_transition(tt, list(m))
        return offending
