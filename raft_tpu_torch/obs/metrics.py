"""Protocol metrics (port of ``raft_tpu/obs/metrics.py``): the BASELINE
metric set.

``BASELINE.json``'s metric is "log entries committed/sec; p50/p99 commit
latency" — computed here from the engine's per-entry submit/commit
timestamps (virtual-clock seconds for deterministic runs, wall seconds for
live ones). The reference publishes no numbers; its implied commit latency
is the 2 s replication tick (BASELINE.md)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from raft_tpu_torch.admission.gate import AdmissionReport


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    count: int
    p50: float
    p99: float
    mean: float
    max: float

    @classmethod
    def of(cls, samples: np.ndarray) -> "LatencySummary":
        if len(samples) == 0:
            return cls(0, float("nan"), float("nan"), float("nan"), float("nan"))
        return cls(
            count=len(samples),
            p50=float(np.percentile(samples, 50)),
            p99=float(np.percentile(samples, 99)),
            mean=float(np.mean(samples)),
            max=float(np.max(samples)),
        )


@dataclasses.dataclass(frozen=True)
class EngineReport:
    committed_entries: int
    elapsed_s: float
    entries_per_sec: float
    commit_latency: LatencySummary
    in_flight_entries: int     # ingested, commit pending (healthy pipeline)
    lost_entries: int          # submitted, never durable (leadership changes)
    leader_changes: int
    # Overload observability (None when admission is disabled): queue
    # depth + high-water, shed counts by reason, admitted counts, the
    # delay controller's state, and head-of-queue sojourn p50/p99 —
    # goodput is ``entries_per_sec`` above (committed work only; shed
    # arrivals never count).
    admission: Optional[AdmissionReport] = None
    # obs.registry.MetricsRegistry snapshot (None when no registry is
    # attached to the engine): the full labeled counter/gauge/histogram
    # dump — elections, heartbeats, repair rounds, sheds by reason,
    # commit-latency buckets (docs/OBSERVABILITY.md).
    metrics: Optional[dict] = None


def summarize_engine(engine, trace=None) -> EngineReport:
    """Metrics from a finished (or paused) engine run; ``trace`` is an
    optional TraceRecorder for leadership-change counting (the engine's
    attached ``recorder`` — structured ``elect`` events — is preferred
    when present)."""
    lat = engine.commit_latencies()
    elapsed = engine.clock.now
    # ``commit_time`` is a BOUNDED stamp window (oldest stamps evict
    # past the archive retention horizon — the host_post residue fix);
    # the all-time committed count lives in ``committed_total``, and
    # the eviction drops submit stamps pairwise so the lost-entry
    # arithmetic stays exact with ``commit_stamps_evicted`` added back.
    committed = getattr(engine, "committed_total", None)
    evicted = getattr(engine, "commit_stamps_evicted", 0)
    if committed is None:
        committed = len(engine.commit_time)
    leader_changes = 0
    recorder = getattr(engine, "recorder", None)
    if recorder is not None:
        leader_changes = len(recorder.events(kind="elect"))
    elif trace is not None:
        leader_changes = len(trace.matching("state changed to leader"))
    in_flight = engine.in_flight_count
    return EngineReport(
        committed_entries=committed,
        elapsed_s=elapsed,
        entries_per_sec=committed / elapsed if elapsed > 0 else float("nan"),
        commit_latency=LatencySummary.of(lat),
        in_flight_entries=in_flight,
        lost_entries=(
            len(engine.submit_time) + evicted - committed
            - len(engine._queue) - in_flight
        ),
        leader_changes=leader_changes,
        admission=(
            engine.admission.report(queue_depth=len(engine._queue))
            if getattr(engine, "admission", None) is not None else None
        ),
        metrics=(
            engine.metrics.snapshot()
            if getattr(engine, "metrics", None) is not None else None
        ),
    )
