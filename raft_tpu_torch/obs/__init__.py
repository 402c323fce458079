"""Observability (port of ``raft_tpu/obs``): the launch annotation the
engine wraps around each replicate call (``profiling``), the host-time
attribution of an engine tick and of an ingest pump (``hostprof``), and the
latency digest (``slo.LatencyDigest``). The rest of the planes come with
ROADMAP A16."""

from raft_tpu_torch.obs.hostprof import HostProfiler, PumpProfiler

__all__ = ["HostProfiler", "PumpProfiler"]
