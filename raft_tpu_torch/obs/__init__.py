"""Observability (port of ``raft_tpu/obs``): the host plane.

- ``events``    — the flight recorder: a typed, bounded ring of
  structured events whose ``Event.nodelog()`` renders the legacy nodelog
  line byte for byte.
- ``trace``     — the legacy string capture ``TraceRecorder``.
- ``spans``     — causal per-op tracing (submit, ingest, commit, apply,
  reads), exportable as Chrome/Perfetto trace JSON.
- ``registry``  — counters, gauges and histograms with labels,
  Prometheus text exposition and a JSON snapshot.
- ``audit``     — the online ``SafetyAuditor``: Raft invariants checked
  per tick and per launch while the run goes on.
- ``slo``       — streaming latency digests and multi-window burn-rate
  SLO tracking.
- ``serve``     — the ``StatusBoard`` the engine publishes to at each
  flush boundary and the stdlib-HTTP ``OpsServer`` reading it.
- ``metrics``   — the BASELINE report (entries/s, p50/p99 commit
  latency).
- ``blackbox``  — per-process progress journals and the stall watchdog.
- ``forensics`` — ``ObsStack``, repro bundles and the
  ``python -m raft_tpu_torch.obs --explain`` timeline reconstruction.
- ``hostprof``  — per-tick and per-pump-iteration host-time attribution.
- ``profiling`` — the launch annotation the engine wraps around each
  launch.

Every artifact (recorder dumps, span tables, Prometheus text, SLO and
status snapshots, bundles, journals) has the JAX package's format, so
either package's tools read either's. Not ported yet: the device event
ring (``device``, ROADMAP A13) and the compile, memory and on-demand
profiler planes (``compile``, ``memory``, ``/profile``, ROADMAP A16b).
"""

from raft_tpu_torch.obs import blackbox
from raft_tpu_torch.obs.audit import AuditViolation, SafetyAuditor
from raft_tpu_torch.obs.blackbox import (
    BlackboxJournal,
    StallWatchdog,
    explain_journal,
    explain_stall,
    read_journal,
)
from raft_tpu_torch.obs.events import Event, FlightRecorder, kind_of
from raft_tpu_torch.obs.forensics import (
    ObsStack,
    explain,
    load_bundle,
    write_bundle,
)
from raft_tpu_torch.obs.hostprof import HostProfiler, PumpProfiler
from raft_tpu_torch.obs.metrics import LatencySummary, summarize_engine
from raft_tpu_torch.obs.registry import MetricsRegistry, parse_prometheus
from raft_tpu_torch.obs.serve import OpsServer, StatusBoard, serve_demo
from raft_tpu_torch.obs.slo import (
    LatencyDigest,
    SLObjective,
    SloAlert,
    SloTracker,
)
from raft_tpu_torch.obs.spans import Span, SpanTracker
from raft_tpu_torch.obs.trace import TraceRecord, TraceRecorder

__all__ = [
    "AuditViolation",
    "BlackboxJournal",
    "Event",
    "FlightRecorder",
    "HostProfiler",
    "PumpProfiler",
    "LatencyDigest",
    "LatencySummary",
    "MetricsRegistry",
    "ObsStack",
    "OpsServer",
    "SLObjective",
    "SafetyAuditor",
    "SloAlert",
    "SloTracker",
    "Span",
    "SpanTracker",
    "StallWatchdog",
    "StatusBoard",
    "TraceRecord",
    "TraceRecorder",
    "blackbox",
    "explain",
    "explain_journal",
    "explain_stall",
    "kind_of",
    "load_bundle",
    "parse_prometheus",
    "read_journal",
    "serve_demo",
    "summarize_engine",
    "write_bundle",
]
