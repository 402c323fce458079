"""On-demand ``torch.profiler`` capture, launch annotations and bench
device-time measurement (port of ``raft_tpu/obs/profiling.py``).

A profiler trace records the on-device execution span of each kernel,
which is exact whatever the host's dispatch latency, where wall-clock
timing of a microsecond kernel measures the host.

Bench helpers: ``device_seconds`` runs one call under a trace and returns
the device's busy time in it (the summed durations of its kernel, copy
and fill events); ``op_breakdown`` aggregates per-kernel device durations
from a trace directory for kernel-level attribution.

On-demand capture:

- :func:`launch_annotation`: a ``torch.profiler.record_function`` the
  engines wrap around each launch boundary (the fused window, the
  per-tick replicate, the batched group launch) so a capture segments by
  launch. It is the shared null context unless a capture is ACTIVE: the
  detached cost is one module-bool test per launch, no device traffic.
- :func:`capture_profile`: capture ``seconds`` of wall time while the
  engine keeps running on its own thread (the OpsServer
  ``/profile?seconds=N`` endpoint), then merge the trace with the span
  tracker's Perfetto export (``obs.spans.SpanTracker.to_perfetto``) into
  ONE timeline artifact in the JAX package's format. Destination:
  explicit argument, else ``RAFT_TPU_PROFILE_DIR``, else a temp dir. The
  capture profiles every thread (the engine's launch annotations land in
  a capture the server thread started) where this torch has that option;
  the artifact says how many CUDA kernel events and launch annotations it
  holds, so an empty device timeline never reads as a success.

What differs from the JAX module is the mechanism: the device events are
the trace's CUDA kernel and memory events, chosen by their category
(``kernel``, ``gpu_memcpy``, ``gpu_memset``; the launching calls are
``cuda_runtime`` events), not by a "TPU" process name; a program is
many kernels, so its device time is their summed durations, not one
compiled module's event (the span from the first to the last would
count the host's launch gaps, which the profiler widens).

Captures are serialized process-wide (``torch.profiler`` allows one
session): a second capture, or a capture while another profiler session
is live, raises :class:`CaptureBusy` and leaves that session running.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Optional

PROFILE_FORMAT = "raft_tpu.obs/profile.v1"

#: span-track pids are offset past any plausible device-trace pid so the
#: two timelines never collide in the merged artifact
SPAN_PID_OFFSET = 900_000

#: trace categories of the events that ran on the card
KERNEL_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def resolve_profile_dir(profile_dir: Optional[str]) -> Optional[str]:
    """Destination policy: explicit argument, else the
    ``RAFT_TPU_PROFILE_DIR`` environment variable, else None (the caller
    falls back to a temp dir)."""
    if profile_dir is not None:
        return profile_dir
    return os.environ.get("RAFT_TPU_PROFILE_DIR") or None


# ----------------------------------------------------- launch annotations
_capture_active = False
_capture_lock = threading.Lock()
#: shared detached context: nullcontext is stateless and reentrant, so
#: the per-launch detached cost stays one module-bool test + one return
_NULL = contextlib.nullcontext()


class CaptureBusy(RuntimeError):
    """A profiler capture is already in flight (one session allowed)."""


def capture_active() -> bool:
    return _capture_active


@contextlib.contextmanager
def annotating():
    """Annotate every launch inside the block (a caller that runs its own
    ``torch.profiler`` session over engine ticks)."""
    global _capture_active
    prior, _capture_active = _capture_active, True
    try:
        yield
    finally:
        _capture_active = prior


def launch_annotation(name: str, step: int):
    """A ``record_function`` span ``"{name}#{step}"`` while a capture is
    active, else the shared detached nullcontext."""
    if not _capture_active:
        return _NULL
    import torch

    return torch.profiler.record_function(f"{name}#{step}")


# ------------------------------------------------------ on-demand capture
def merge_timelines(device_events: list, span_trace: Optional[dict]) -> dict:
    """One Chrome/Perfetto artifact from a device trace and the span
    tracker's export. Span tracks are pid-offset (SPAN_PID_OFFSET) so
    both families keep their own process rows; the device trace rides
    its real (wall-clock) timebase and the span tracks their virtual
    clock — the artifact labels both so a reader isn't misled."""
    evs = list(device_events)
    n_span = 0
    if span_trace:
        for e in span_trace.get("traceEvents", []):
            e = dict(e)
            if "pid" in e:
                e["pid"] = e["pid"] + SPAN_PID_OFFSET
            if e.get("ph") == "M" and e.get("name") == "process_name":
                nm = e.get("args", {}).get("name", "")
                e["args"] = {"name": f"{nm} (virtual clock)"}
            evs.append(e)
            n_span += 1
    return {
        "format": PROFILE_FORMAT,
        "displayTimeUnit": "ms",
        "traceEvents": evs,
        "n_device_events": len(device_events),
        "n_span_events": n_span,
    }


def _session_live() -> bool:
    """True while any torch.profiler / autograd profiler session runs."""
    import torch

    return bool(torch.autograd.profiler._is_profiler_enabled)


def _profiler(cpu: bool = True):
    """A ``torch.profiler.profile`` over the CPU (and CUDA when present),
    profiling every thread where this torch can; with ``cpu=False`` over
    CUDA alone where there is a card (the host's operator events are then
    not recorded). Returns (profiler, whether it profiles all threads)."""
    import torch

    acts = []
    if cpu or not torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # the newest option set this torch accepts: every thread, and no
    # Python event objects built at stop (the trace file is all we read)
    for kw in (dict(profile_all_threads=True, trace_only=True),
               dict(profile_all_threads=True)):
        try:
            cfg = torch._C._profiler._ExperimentalConfig(**kw)
        except (TypeError, AttributeError):
            continue
        return torch.profiler.profile(activities=acts,
                                      experimental_config=cfg), True
    return torch.profiler.profile(activities=acts), False


@contextlib.contextmanager
def _session(cpu: bool = True):
    """One profiler session (serialized process-wide): yields the
    started profiler; always stopped on exit, since a leaked session
    poisons every later one. ``cpu`` as in ``_profiler``."""
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already in flight")
    try:
        if _session_live():
            raise CaptureBusy("another torch.profiler session is live")
        prof, all_threads = _profiler(cpu)
        prof.start()
        try:
            yield prof, all_threads
        finally:
            prof.stop()
    finally:
        _capture_lock.release()


def capture_profile(
    seconds: float,
    spans=None,
    profile_dir: Optional[str] = None,
    sleep: Callable[[float], None] = time.sleep,
    keep_python_frames: bool = False,
) -> dict:
    """Capture ``seconds`` of profiler trace while the engine threads
    keep running, merge with the span export, write the artifact, and
    return ``{"artifact", "raw_dir", "seconds", "n_device_events",
    "n_span_events", "n_kernel_events", "n_launch_annotations",
    "all_threads"}``. Raises :class:`CaptureBusy` when a capture (or any
    other profiler session) is already in flight.

    The merged artifact keeps the kernel/runtime/annotation events and
    drops the Python-function events (``keep_python_frames=True`` keeps
    everything); with a configured destination the raw torch trace is
    kept next to the artifact either way."""
    global _capture_active
    configured = resolve_profile_dir(profile_dir)
    raw = None
    try:
        with _session() as (prof, all_threads):
            base = configured or tempfile.mkdtemp(prefix="raft_tpu_profile_")
            os.makedirs(base, exist_ok=True)
            raw = tempfile.mkdtemp(prefix="raw_", dir=base)
            _capture_active = True
            try:
                sleep(max(seconds, 0.0))
            finally:
                _capture_active = False
        prof.export_chrome_trace(os.path.join(raw, "capture.pt.trace.json"))
        events = _load_latest_trace(raw)
        if not keep_python_frames:
            events = [e for e in events
                      if e.get("cat") != "python_function"
                      and not str(e.get("name", "")).startswith("$")]
        merged = merge_timelines(
            events, spans.to_perfetto() if spans is not None else None)
        n_kernel = sum(1 for e in events if e.get("cat") == "kernel")
        n_annot = sum(1 for e in events if e.get("cat") == "user_annotation"
                      and "#" in str(e.get("name", "")))
        merged["n_kernel_events"] = n_kernel
        merged["n_launch_annotations"] = n_annot
        merged["all_threads"] = all_threads
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(base, f"profile_{stamp}.json")
        with open(path, "w") as fh:
            json.dump(merged, fh, separators=(",", ":"))
        return {
            "artifact": path,
            # the raw trace survives only with a configured destination;
            # on the temp fallback it is deleted below
            "raw_dir": raw if configured is not None else None,
            "seconds": seconds,
            "n_device_events": merged["n_device_events"],
            "n_span_events": merged["n_span_events"],
            "n_kernel_events": n_kernel,
            "n_launch_annotations": n_annot,
            "all_threads": all_threads,
        }
    finally:
        if raw is not None and configured is None:
            shutil.rmtree(raw, ignore_errors=True)


def _load_latest_trace(trace_dir: str) -> list:
    """The events of the newest torch trace file under ``trace_dir``
    (``*.pt.trace.json``, gzipped or not)."""
    runs = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json*"),
                     recursive=True)
    if not runs:
        return []
    path = max(runs, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh).get("traceEvents", [])


def _on_device(e: dict) -> bool:
    """A trace event that ran on the card, other than ``device_seconds``'
    float64 pads."""
    return (e.get("ph") == "X" and e.get("cat") in KERNEL_CATS
            and "<double>" not in str(e.get("name", "")))


def device_seconds(
    fn: Callable, mk_args: Callable[[], tuple], warmups: int = 1,
    trace_dir: Optional[str] = None,
) -> float:
    """On-device seconds of one ``fn(*mk_args())`` call: the summed
    durations of its kernel, copy and fill events; NaN if the trace holds
    no CUDA kernel (the CPU).

    ``mk_args`` is a factory so consumed state is fresh per call. Late in
    a long process a short session can lose its first (and now and then
    its last) device records, so on the card the call sits between two
    runs of one-element float64 adds, after a pause: a type the port never
    runs on the card, whose records are dropped by name. On the card the
    session records CUDA activity alone: the host's operator events would
    multiply the trace of a call of many small launches (a T-step
    general-path scan) several times over, for nothing this sum reads.
    With ``trace_dir`` the raw trace is kept there (``op_breakdown`` reads
    it)."""
    import torch

    for _ in range(warmups):
        fn(*mk_args())
    cuda = torch.cuda.is_available()
    pad = torch.zeros(1, dtype=torch.float64, device="cuda") if cuda \
        else None

    def pads():
        if cuda:
            for _ in range(32):
                pad.add_(1)
            torch.cuda.synchronize()

    pads()
    args = mk_args()
    with _session(cpu=False) as (prof, _):
        pads()
        time.sleep(0.05)
        fn(*args)
        pads()
    tmp = trace_dir or tempfile.mkdtemp(prefix="raft_tpu_trace_")
    try:
        os.makedirs(tmp, exist_ok=True)
        prof.export_chrome_trace(os.path.join(tmp, "call.pt.trace.json"))
        durs = [float(e.get("dur", 0)) for e in _load_latest_trace(tmp)
                if _on_device(e)]
        return sum(durs) / 1e6 if durs else float("nan")
    finally:
        if trace_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def op_breakdown(trace_dir: str, top: int = 20):
    """[(kernel_name, calls, total_ms)] for the latest trace in
    ``trace_dir``, over its on-device events."""
    agg: dict = {}
    for e in _load_latest_trace(trace_dir):
        if _on_device(e):
            nm = str(e.get("name", ""))
            c, t = agg.get(nm, (0, 0.0))
            agg[nm] = (c + 1, t + float(e.get("dur", 0)))
    return [
        (nm, c, t / 1e3)
        for nm, (c, t) in sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    ]
