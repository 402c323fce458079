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
  launch, the on-demand ``torch.profiler`` capture (``/profile``) merged
  with the span export into one timeline, and the bench device-time
  helpers.
- ``compile``   — the compile plane: ``CompileWatch`` records novel call
  signatures at the labeled program seams, CUDA-graph captures and
  kernel-library builds; the ``RetraceSentinel`` turns any post-
  ``freeze()`` one on a registered hot path into a ``CompileViolation``.
- ``memory``    — the memory plane: a live-tensor census by storage with
  the CUDA allocator's view, baseline/drift leak detection, high-water
  gauges, and the in-place (donation) audit.
- ``device``    — the device plane: an event ring and a metrics vector on
  the engine's device, recorded beside the protocol steps (inside the
  fused window's CUDA graph too), flushed once per launch boundary into
  ``DeviceObs`` and interleaved with the recorder by
  ``merged_timeline``. Its names are exported lazily: an engine with no
  device plane attached never loads the module.

Every artifact (recorder dumps, span tables, Prometheus text, SLO and
status snapshots, bundles, journals) has the JAX package's format, so
either package's tools read either's (the device ring's packed flush
too).
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
from raft_tpu_torch.obs.compile import (
    CompileRecord,
    CompileViolation,
    CompileWatch,
    RecompileError,
    RetraceSentinel,
    assert_no_recompiles,
)
from raft_tpu_torch.obs.events import Event, FlightRecorder, kind_of
from raft_tpu_torch.obs.forensics import (
    ObsStack,
    explain,
    load_bundle,
    write_bundle,
)
from raft_tpu_torch.obs.hostprof import HostProfiler, PumpProfiler
from raft_tpu_torch.obs.memory import (
    DonationReport,
    MemoryCensus,
    MemoryWatch,
    audit_donation,
)
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
    "COUNTER_METRICS",
    "COUNTER_NAMES",
    "CompileRecord",
    "CompileViolation",
    "CompileWatch",
    "DeviceObs",
    "DonationReport",
    "Event",
    "EventRing",
    "FlightRecorder",
    "HostProfiler",
    "KIND_NAMES",
    "LatencyDigest",
    "LatencySummary",
    "MemoryCensus",
    "MemoryWatch",
    "MetricsRegistry",
    "ObsStack",
    "OpsServer",
    "PumpProfiler",
    "REC_W",
    "ROLE_NAMES",
    "RecompileError",
    "RetraceSentinel",
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
    "assert_no_recompiles",
    "audit_donation",
    "blackbox",
    "decode_records",
    "dev_record",
    "explain",
    "explain_journal",
    "explain_stall",
    "init_ring",
    "kind_of",
    "load_bundle",
    "merged_timeline",
    "packed_flush",
    "parse_prometheus",
    "read_journal",
    "serve_demo",
    "summarize_engine",
    "write_bundle",
]

#: the device plane's exports, loaded on first use (module doc)
_DEVICE = ("COUNTER_METRICS", "COUNTER_NAMES", "KIND_NAMES", "REC_W",
           "ROLE_NAMES", "DeviceObs", "EventRing", "decode_records",
           "dev_record", "init_ring", "merged_timeline", "packed_flush")


def __getattr__(name):
    if name in _DEVICE:
        from raft_tpu_torch.obs import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
