"""Server-side admission: bounded depth, delay-gated shedding, fairness.

The gate sits in front of the engine's host queues (``RaftEngine``'s
write queue and read-ticket table; ``MultiEngine``'s per-group queues)
and decides, per arrival, admit or refuse. It owns no queue itself —
callers pass the observed depth — so it composes with any queue shape
and costs O(1) per decision.

Three independent shedding reasons, checked in order:

- ``depth``      — the lane's queue is at its configured bound. The
  hard backstop: host memory stays bounded no matter what.
- ``delay``      — a CoDel-style controller (Nichols & Jacobson, CACM
  2012) adapted from packet dropping to admission: the engine reports
  the head-of-queue sojourn time each leader tick; once the delay has
  stayed above ``target_delay_s`` for a full ``interval_s``, the gate
  enters a *shedding* state and refuses new writes until an observation
  comes back under target. Depth alone cannot distinguish "full but
  draining fast" from "full and stalled"; delay is the signal that
  queueing has stopped buying anything.
- ``fair_share`` — when the write lane is congested (depth at half its
  bound, or delay-shedding), a client whose share of recently admitted
  work exceeds twice its fair share is refused while lighter clients
  are still admitted, so one hot client cannot starve the rest (the
  DAGOR-style priority idea, reduced to per-client fairness).

Reads and writes are separate priority lanes: reads occupy no ring
slots and confirm in batches for free under write load (``submit_read``),
so the delay controller governs the WRITE lane only; reads refuse only
at their own depth bound. A third, background lane —
``catchup_chunks`` — budgets snapshot-shipping chunks for lapped
replicas' rejoin streams (``ckpt.ship``): throttled to a trickle while
the write lane is congested, never refused (deferral, not shedding —
starving catch-up would be a liveness bug). Every refusal raises ``Overloaded`` with a
``retry_after_s`` hint before any state changed — provably no effect,
which is what lets the torture checker treat shed ops as clean
failures.

A copy of ``raft_tpu/admission/gate.py`` (host only), kept in this
package so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


class Overloaded(Exception):
    """The service refused new work to protect itself. Nothing was
    queued and no state changed — the op provably took no effect; retry
    after ``retry_after_s`` (with jittered backoff and a retry budget:
    ``admission.retry``). ``reason`` is one of ``depth`` / ``delay`` /
    ``fair_share`` / ``read_depth`` / ``circuit_open``; ``group`` is
    set when a multi-Raft group's queue refused.

    At the wire (``raft_tpu.net``, docs/NETWORK.md) this contract IS
    the backpressure protocol: the ingest server converts every
    ``Overloaded`` into a ``REFUSED`` frame carrying the same reason
    and ``retry_after_s`` verbatim, written before anything queues
    anywhere, and adds exactly one wire-only reason of its own
    (``wire_backlog``: the server's bounded coalesce buffer). A wire
    client floors its backoff at ``min(retry_after_s, max_backoff_s)``
    — the ``Backoff.delay`` hint semantics, unchanged."""

    def __init__(self, reason: str, retry_after_s: float,
                 detail: str = "", group: Optional[int] = None):
        super().__init__(
            f"overloaded ({reason}): retry after {retry_after_s:g}s"
            + (f" — {detail}" if detail else "")
        )
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.group = group


@dataclasses.dataclass(frozen=True)
class AdmissionReport:
    """Gate observability snapshot (``obs.metrics.EngineReport.admission``)."""

    queue_depth: int                 # write-lane depth at report time
    depth_high_water: int            # max depth observed at any arrival
    max_writes: Optional[int]        # None = write lane ungated
    max_reads: Optional[int]
    admitted: Dict[str, int]         # lane -> admitted count
    shed: Dict[str, int]             # reason -> refusal count
    shedding: bool                   # delay controller currently refusing
    queue_delay_p50_s: float         # over observed head-of-queue sojourns
    queue_delay_p99_s: float
    read_classes: Dict[str, int] = dataclasses.field(default_factory=dict)
    #   reads SERVED through the lane, by class (lease / read_index /
    #   follower / session — docs/READS.md): how much of the read load
    #   the zero-round paths absorbed vs what still paid a quorum round

    @property
    def total_shed(self) -> int:
        return sum(self.shed.values())


class AdmissionGate:
    """One engine's admission state. All times are the engine's (virtual)
    clock — the controller is deterministic under seeded runs."""

    #: head-of-queue delay samples retained for the p50/p99 report
    MAX_DELAY_SAMPLES = 4096

    def __init__(
        self,
        clock: Callable[[], float],
        max_writes: Optional[int] = None,
        max_reads: Optional[int] = None,
        target_delay_s: float = 4.0,
        interval_s: float = 30.0,
        drain_hint_s: float = 2.0,
        fair_share: bool = True,
    ):
        if max_writes is not None and max_writes < 1:
            raise ValueError("max_writes must be >= 1 (or None)")
        if max_reads is not None and max_reads < 1:
            raise ValueError("max_reads must be >= 1")
        if target_delay_s <= 0 or interval_s <= 0:
            raise ValueError("target_delay_s and interval_s must be > 0")
        self.clock = clock
        self.max_writes = max_writes
        self.max_reads = max_reads
        self.target_delay_s = target_delay_s
        self.interval_s = interval_s
        self.drain_hint_s = drain_hint_s
        #   retry-after for depth refusals: one drain opportunity (a
        #   leader tick) from now is the earliest the bound can open
        self.fair_share = fair_share

        self._first_above: Optional[float] = None
        self.shedding = False
        self.admitted: Dict[str, int] = {"write": 0, "read": 0}
        self.read_classes: Dict[str, int] = {}
        self.catchup_throttled = 0
        #   ticks the catch-up lane was cut to 1 chunk (congestion —
        #   see catchup_chunks); deferral, not refusal, so it is not a
        #   ``shed`` reason
        self.shed: Dict[str, int] = {}
        self.depth_high_water = 0
        self.delay_samples: List[float] = []
        self.delay_dropped = 0
        #   samples trimmed off the front of delay_samples so far; the
        #   cumulative index of the next sample is delay_dropped +
        #   len(delay_samples) (stable across trims — overload_run's
        #   per-phase percentile slices depend on it)
        # Per-client recent-admission shares for the fairness check:
        # counts halve every interval_s (a cheap sliding window), so
        # "hot" tracks the current regime, not all history.
        self._client_counts: Dict[object, float] = {}
        self._counts_decay_at = clock()

    @classmethod
    def from_config(cls, cfg, clock) -> Optional["AdmissionGate"]:
        """Build the gate a ``RaftConfig`` asks for; ``None`` when
        admission is fully disabled (both caps unset — the legacy
        unbounded behavior, the default)."""
        if cfg.admission_max_writes is None and cfg.admission_max_reads is None:
            return None
        return cls(
            clock,
            # max_writes=None = the write lane stays fully ungated
            # (reads-only admission must never make legacy submit()
            # calls start raising — depth, delay, AND fairness are all
            # write-lane machinery)
            max_writes=cfg.admission_max_writes,
            max_reads=cfg.admission_max_reads,
            target_delay_s=cfg.admission_target_delay_s,
            interval_s=cfg.admission_interval_s,
            drain_hint_s=cfg.heartbeat_period,
            fair_share=cfg.admission_fair_share,
        )

    # ------------------------------------------------------------ refusal
    def _refuse(self, reason: str, retry_after: float, detail: str = ""):
        self.shed[reason] = self.shed.get(reason, 0) + 1
        raise Overloaded(reason, retry_after, detail)

    # ------------------------------------------------------- write lane
    def admit_write(self, depth: int, client: object = None) -> None:
        """Admit-or-refuse one write arrival given the lane's current
        queue depth. Raises ``Overloaded`` BEFORE the caller queues
        anything; on return the caller must queue exactly one entry.
        With ``max_writes=None`` the write lane is fully ungated —
        depth, delay, and fairness all pass (the reads-only admission
        configuration must never refuse a legacy submit)."""
        self.depth_high_water = max(self.depth_high_water, depth)
        if self.max_writes is None:
            self.admitted["write"] += 1
            return
        if depth >= self.max_writes:
            self._refuse(
                "depth", self.drain_hint_s,
                f"write queue at bound {self.max_writes}",
            )
        if self.shedding:
            self._refuse(
                "delay", self.interval_s,
                f"queue delay above target {self.target_delay_s:g}s "
                f"for a full interval",
            )
        if self.fair_share and client is not None:
            self._fairness_check(depth, client)
        self.admitted["write"] += 1

    def _fairness_check(self, depth: int, client: object) -> None:
        """Refuse a hot client while the lane is congested. Shares are
        recent admitted counts, halved every ``interval_s``."""
        now = self.clock()
        while now - self._counts_decay_at >= self.interval_s:
            self._counts_decay_at += self.interval_s
            for k in list(self._client_counts):
                self._client_counts[k] *= 0.5
                if self._client_counts[k] < 0.5:
                    del self._client_counts[k]
        congested = depth >= max(1, self.max_writes // 2)
        if congested and len(self._client_counts) > 1:
            total = sum(self._client_counts.values())
            mine = self._client_counts.get(client, 0.0)
            # hot = holding at least TWICE everyone else's combined
            # recent share (i.e. a >= 2/3 supermajority of the window —
            # scale-free in the number of clients), with an absolute
            # floor so a lone early burst from a quiet lane is never
            # misread as hot
            if mine >= max(2.0 * (total - mine), 4.0):
                self._refuse(
                    "fair_share", self.drain_hint_s,
                    f"client {client!r} holds {mine:.0f} of {total:.0f} "
                    f"recent admissions",
                )
        self._client_counts[client] = self._client_counts.get(client, 0.0) + 1

    def observe_delay(self, head_delay_s: float) -> Optional[str]:
        """The engine reports the write lane's head-of-queue sojourn
        (0 when the queue is empty) once per leader tick. Drives the
        CoDel state machine; returns ``"shed_start"`` / ``"shed_stop"``
        on a transition (for the trace stream), else None. With the
        write lane ungated (``max_writes=None``) only the sample is
        recorded — the controller never sheds."""
        now = self.clock()
        if len(self.delay_samples) >= self.MAX_DELAY_SAMPLES:
            # keep the recent half: the report should reflect the
            # current regime, and the controller itself needs no
            # history. ``delay_dropped`` lets external consumers keep
            # stable cumulative sample indexes across the trim.
            drop = self.MAX_DELAY_SAMPLES // 2
            self.delay_dropped += drop
            self.delay_samples = self.delay_samples[drop:]
        self.delay_samples.append(head_delay_s)
        if self.max_writes is None:
            return None
        if head_delay_s < self.target_delay_s:
            self._first_above = None
            if self.shedding:
                self.shedding = False
                return "shed_stop"
            return None
        if self._first_above is None:
            self._first_above = now + self.interval_s
        elif now >= self._first_above and not self.shedding:
            self.shedding = True
            return "shed_start"
        return None

    # ---------------------------------------------------- catch-up lane
    def catchup_chunks(self, depth: int, max_chunks: int) -> int:
        """Chunk budget for this tick's snapshot-shipping lane
        (``ckpt.ship``): the BACKGROUND lane. Catch-up traffic is never
        refused outright (a lapped replica must eventually rejoin — a
        starved stream is a liveness bug), but while the write lane is
        congested (delay-shedding, or depth at half its bound — the
        same threshold the fairness check uses) it is throttled to one
        chunk per tick so foreground commits keep >= 90% of their
        goodput while a follower streams back in (the wipe_logN bench
        ladder's coexistence column). An ungated write lane
        (``max_writes=None``) never throttles."""
        congested = self.max_writes is not None and (
            self.shedding or depth >= max(1, self.max_writes // 2)
        )
        granted = 1 if congested else max_chunks
        self.admitted["catchup"] = (
            self.admitted.get("catchup", 0) + granted
        )
        if congested:
            self.catchup_throttled += 1
        return granted

    # -------------------------------------------------------- read lane
    def admit_read(self, outstanding: int) -> None:
        """Admit-or-refuse one read-ticket arrival given the number of
        outstanding tickets. Reads are the higher-priority lane: the
        delay controller never touches them (they occupy no ring slots
        and confirm in batches for free under write load); only their
        own depth bound refuses — which replaces silent FIFO eviction
        with an explicit, typed refusal the client can act on."""
        if self.max_reads is not None and outstanding >= self.max_reads:
            self._refuse(
                "read_depth", self.drain_hint_s,
                f"read tickets at bound {self.max_reads}",
            )
        self.admitted["read"] += 1

    def note_read_class(self, cls: str) -> None:
        """A read admitted through the lane was SERVED under ``cls``
        (the engine reports at serve time — lease and session serves
        never pay a quorum round, so the per-class split is the lane's
        capacity story, not just telemetry)."""
        self.read_classes[cls] = self.read_classes.get(cls, 0) + 1

    # ------------------------------------------------------------ report
    def report(self, queue_depth: int = 0) -> AdmissionReport:
        import numpy as np

        if self.delay_samples:
            p50 = float(np.percentile(self.delay_samples, 50))
            p99 = float(np.percentile(self.delay_samples, 99))
        else:
            p50 = p99 = float("nan")
        return AdmissionReport(
            queue_depth=queue_depth,
            depth_high_water=self.depth_high_water,
            max_writes=self.max_writes,
            max_reads=self.max_reads,
            admitted=dict(self.admitted),
            shed=dict(self.shed),
            shedding=self.shedding,
            queue_delay_p50_s=p50,
            queue_delay_p99_s=p99,
            read_classes=dict(self.read_classes),
        )
