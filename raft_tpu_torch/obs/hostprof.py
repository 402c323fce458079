"""Host-time attribution: per-tick phase timers around the engine step
(port of ``raft_tpu/obs/hostprof.py``).

One engine tick is split into contiguous host phases on
``time.perf_counter``:

==============  ========================================================
phase           what it covers
==============  ========================================================
``heap_pop``    event-heap pop, virtual-clock advance, stale-timer check
``host_pre``    pre-dispatch bookkeeping: CheckQuorum, admission delay
                observation, staged-config drive, batch clamp, repair
                floor attest and the cached last/match fetches (a fused
                window: its eligibility proof, planning and staging)
``pack``        ingest batching: entry bytes -> the folded device batch
                (``_pack_entries`` / ``fold_batch`` / the EC encode)
``dispatch``    the transport call itself; on the card it returns after
                the launch is queued, not when it completes
``device_wait`` :meth:`HostProfiler.sync` on the step's outputs: device
                execution and queue time not already hidden under
                dispatch
``host_post``   post-step bookkeeping: truncation notes, seq->index
                mapping, commit/apply/archive, read confirmation,
                heartbeat re-arm (a fused window: its booking)
==============  ========================================================

The phases are boundary-marked (each ``mark(phase)`` attributes the time
since the previous boundary), so they tile the tick with no gaps: their
sum equals the tick's wall time up to the marking overhead itself.

Overhead contract: the profiler is host bookkeeping, and its one device
interaction, the synchronize in :meth:`HostProfiler.sync`, is reached
only from engine paths that found a profiler attached. Detached, the
engine pays one ``is None`` check per site and no sync.

With a registry attached, per-tick phase seconds also go to the
``raft_host_phase_seconds`` histogram, labeled ``(group, phase)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

#: µs-to-100ms log-spaced buckets: host phases live in the 1 µs - 1 ms
#: band on a local backend and the 10-100 ms band when dispatch is slow;
#: a registry's default buckets (0.5 s and up) would flatten both.
HOST_PHASE_BUCKETS = (
    1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1,
)

PHASES = (
    "heap_pop", "host_pre", "pack", "dispatch", "device_wait", "host_post",
)


def _cuda_device(values) -> Optional[torch.device]:
    """The device of the first CUDA tensor among ``values`` (tensors,
    tuples, lists, named tuples and dataclasses such as ``ReplicaState``,
    searched depth first), or None when every tensor lies on the CPU."""
    stack = list(values)
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                return v.device
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            stack.extend(getattr(v, f.name) for f in dataclasses.fields(v))
    return None


class HostProfiler:
    """Boundary-marking per-tick phase accumulator (see module doc).

    Attach with ``engine.hostprof = HostProfiler(registry=...)`` (the
    registry is optional: totals work standalone). The engine calls
    ``tick_begin`` / ``mark`` / ``sync`` / ``tick_end`` only when a
    profiler is attached.
    """

    def __init__(self, registry=None, buckets=HOST_PHASE_BUCKETS):
        self.registry = registry
        self._hist = (
            registry.histogram(
                "raft_host_phase_seconds",
                "host wall seconds per engine tick by phase",
                ("group", "phase"), buckets=buckets,
            )
            if registry is not None else None
        )
        self.ticks = 0
        self.phase_s: Dict[str, float] = {}
        self.phase_marks: Dict[str, int] = {}
        self._cur: Dict[str, float] = {}
        self._last: Optional[float] = None

    # ----------------------------------------------------------- marking
    def tick_begin(self) -> None:
        self._cur = {}
        self._last = time.perf_counter()

    def mark(self, phase: str) -> None:
        """Attribute the time since the previous boundary to ``phase``.
        Marking the same phase twice in one tick accumulates (the engine
        marks ``host_pre`` both before and after the pack). Outside an
        open ``tick_begin``/``tick_end`` bracket this is a no-op: a call
        path that reaches the marked engine internals without a tick
        (a ``read_linearizable`` round) must neither leak partial samples
        into the next tick nor count marks no ``tick_end`` will flush."""
        if self._last is None:
            return
        now = time.perf_counter()
        self._cur[phase] = self._cur.get(phase, 0.0) + (now - self._last)
        self.phase_marks[phase] = self.phase_marks.get(phase, 0) + 1
        self._last = now

    def sync(self, *values) -> None:
        """Wait until the step's device outputs are ready and attribute
        the wait to ``device_wait``: a synchronize of the CUDA device the
        values live on, nothing for CPU tensors (their step has finished
        when it returns). The profiler's one device interaction, and,
        like :meth:`mark`, a no-op outside an open tick bracket."""
        if self._last is None:
            return
        dev = _cuda_device(values)
        if dev is not None:
            torch.cuda.synchronize(dev)
        self.mark("device_wait")

    def tick_end(self, groups: Sequence[str] = ("0",)) -> None:
        """Close the tick: the residue since the last boundary is
        ``host_post``; the tick's phase seconds then flush into the
        totals and, with a registry, into ``raft_host_phase_seconds``
        once per group label."""
        self.mark("host_post")
        self.ticks += 1
        for phase, s in self._cur.items():
            self.phase_s[phase] = self.phase_s.get(phase, 0.0) + s
            if self._hist is not None:
                for g in groups:
                    self._hist.observe(s, group=str(g), phase=phase)
        self._cur = {}
        self._last = None

    # ----------------------------------------------------------- results
    def totals(self) -> Dict[str, float]:
        """phase -> accumulated seconds over all ticks."""
        return dict(self.phase_s)

    def us_per_tick(self) -> Dict[str, float]:
        """phase -> mean µs per tick (0 ticks -> empty)."""
        if not self.ticks:
            return {}
        return {
            p: s / self.ticks * 1e6 for p, s in sorted(self.phase_s.items())
        }

    def split(self) -> Tuple[float, float]:
        """(host_us_per_tick, device_us_per_tick): ``device_wait`` is
        the device column, every other phase is host control plane."""
        per = self.us_per_tick()
        dev = per.get("device_wait", 0.0)
        return sum(per.values()) - dev, dev


#: the pump phases that tile one ingest-server pump iteration (boundary
#: marking, as for the engine tick). ``read_decode`` is the sixth
#: attributed phase but lives in the reader tasks (socket to frame,
#: between pump iterations), so it is accumulated beside the iteration
#: bracket, not inside it, and left out of the coverage denominator.
PUMP_PHASES = (
    "read_decode", "coalesce", "ingest", "drive", "sweep", "flush",
)

#: power-of-two coalesce-batch-size buckets: one pump ingest batch is
#: 1..max_pending frames
COALESCE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


class PumpProfiler:
    """Per-iteration phase attribution for an ingest-server pump, the
    wire-side analogue of :class:`HostProfiler`.

    ==============  ====================================================
    phase           what it covers
    ==============  ====================================================
    ``read_decode`` reader tasks: socket reads -> parsed frames ->
                    coalesce-buffer appends (outside the pump bracket)
    ``coalesce``    pump-side batch swap and arrival bookkeeping
                    (queue-age observation per coalesced frame)
    ``ingest``      admission, routing and the staging pre-pack, per
                    batch of arrivals
    ``drive``       ``backend.drive``: the tick loop's quantum
    ``sweep``       completion sweep: durable writes and confirmed read
                    tickets resolved back to response frames
    ``flush``       status publish and writer drain (the residue to the
                    iteration boundary, as ``host_post`` is)
    ==============  ====================================================

    The five pump-side phases tile the iteration wall, so ``coverage()``
    is attributed/wall up to the marking overhead itself.

    Distributions: ``raft_net_pump_phase_seconds{phase}``,
    ``raft_net_coalesce_batch`` (frames per ingest batch) and
    ``raft_net_frame_queue_age_seconds`` (arrival -> ingest age per
    frame) in the attached registry, plus mergeable
    ``obs.slo.LatencyDigest`` percentiles for ``stats()``.

    Overhead contract: pure ``time.perf_counter`` bookkeeping, with no
    rng and no device interaction anywhere in the class.
    """

    def __init__(self, registry=None, buckets=HOST_PHASE_BUCKETS):
        from raft_tpu_torch.obs.slo import LatencyDigest

        self.registry = registry
        if registry is not None:
            self._hist = registry.histogram(
                "raft_net_pump_phase_seconds",
                "wall seconds per ingest-pump iteration by phase",
                ("phase",), buckets=buckets,
            )
            self._batch_hist = registry.histogram(
                "raft_net_coalesce_batch",
                "frames coalesced into one pump ingest batch",
                (), buckets=COALESCE_BUCKETS,
            )
            self._age_hist = registry.histogram(
                "raft_net_frame_queue_age_seconds",
                "coalesce-buffer residence per frame (arrival->ingest)",
                (), buckets=buckets,
            )
        else:
            self._hist = self._batch_hist = self._age_hist = None
        self.iters = 0
        self.phase_s: Dict[str, float] = {}
        self.iter_wall_s = 0.0
        self.batch_sizes = LatencyDigest()
        self.queue_age = LatencyDigest()
        self._cur: Dict[str, float] = {}
        self._t0: Optional[float] = None
        self._last: Optional[float] = None

    # ----------------------------------------------------------- marking
    def iter_begin(self) -> None:
        self._cur = {}
        self._t0 = self._last = time.perf_counter()

    def mark(self, phase: str) -> None:
        """Attribute time since the previous boundary to ``phase``
        (no-op outside an open iteration bracket, like HostProfiler)."""
        if self._last is None:
            return
        now = time.perf_counter()
        self._cur[phase] = self._cur.get(phase, 0.0) + (now - self._last)
        self._last = now

    def iter_end(self) -> None:
        """Close the iteration: the residue since the last boundary is
        ``flush``, then the iteration's seconds flush into the totals and
        the registry histogram."""
        if self._t0 is None:
            return
        self.mark("flush")
        # the flush mark's own boundary is the iteration end: one clock
        # reading, so the phases tile the wall exactly
        self.iter_wall_s += self._last - self._t0
        self.iters += 1
        for phase, s in self._cur.items():
            self.phase_s[phase] = self.phase_s.get(phase, 0.0) + s
            if self._hist is not None:
                self._hist.observe(s, phase=phase)
        self._cur = {}
        self._t0 = self._last = None

    # --------------------------------------------------- reader-side feed
    def note_read_decode(self, seconds: float) -> None:
        """Reader-task attribution: one socket read's decode and frame
        handling (accumulated outside the iteration bracket)."""
        self.phase_s["read_decode"] = (
            self.phase_s.get("read_decode", 0.0) + seconds
        )
        if self._hist is not None:
            self._hist.observe(seconds, phase="read_decode")

    def observe_batch(self, n_frames: int) -> None:
        self.batch_sizes.observe(float(n_frames))
        if self._batch_hist is not None:
            self._batch_hist.observe(n_frames)

    def observe_age(self, seconds: float) -> None:
        self.queue_age.observe(seconds)
        if self._age_hist is not None:
            self._age_hist.observe(seconds)

    # ----------------------------------------------------------- results
    def totals(self) -> Dict[str, float]:
        return dict(self.phase_s)

    def us_per_iter(self) -> Dict[str, float]:
        """phase -> mean µs per pump iteration (``read_decode`` on the
        same denominator, for comparability)."""
        if not self.iters:
            return {}
        return {
            p: s / self.iters * 1e6
            for p, s in sorted(self.phase_s.items())
        }

    def coverage(self) -> float:
        """Attributed fraction of the pump iteration wall: the tiled
        phases' sum over the bracketed wall (1.0 up to marking overhead;
        ``read_decode`` is outside both numerator and denominator)."""
        if self.iter_wall_s <= 0.0:
            return 0.0
        tiled = sum(s for p, s in self.phase_s.items()
                    if p != "read_decode")
        return tiled / self.iter_wall_s

    def stats(self) -> dict:
        """The pump block of a server's status (JSON-safe: empty digests
        report None, never NaN)."""
        def _q(dig, q, scale=1.0):
            return dig.quantile(q) * scale if dig.n else None

        per = self.us_per_iter()
        return {
            "iters": self.iters,
            "us_per_iter": {p: round(v, 2) for p, v in per.items()},
            "coverage": round(self.coverage(), 4),
            "coalesce_batch": {
                "p50": _q(self.batch_sizes, 0.5),
                "p99": _q(self.batch_sizes, 0.99),
                "max": self.batch_sizes.max if self.batch_sizes.n else None,
                "n": self.batch_sizes.n,
            },
            "queue_age_us": {
                "p50": _q(self.queue_age, 0.5, 1e6),
                "p99": _q(self.queue_age, 0.99, 1e6),
                "max": (self.queue_age.max * 1e6
                        if self.queue_age.n else None),
                "n": self.queue_age.n,
            },
        }
