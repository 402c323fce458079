"""The port's capture plane (``raft_tpu_torch.obs.profiling``) against the
JAX package's (``raft_tpu.obs.profiling``).

- ``merge_timelines`` gives the same artifact, byte for byte, for the
  same device events and span export; the format and pid offset are
  JAX's.
- ``resolve_profile_dir``: argument, then ``RAFT_TPU_PROFILE_DIR``, then
  None, in both.
- One capture at a time: a second capture, or a capture while another
  ``torch.profiler`` session runs, raises ``CaptureBusy``, and the
  running session still records.
- ``capture_profile`` on the CPU while an engine ticks on another thread:
  the artifact holds the span events and that thread's launch
  annotations, and no CUDA kernel event (the artifact counts them).
- ``device_seconds`` is NaN where the trace holds no CUDA kernel (the
  CPU); ``op_breakdown`` aggregates a trace directory's kernel events.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu.obs import profiling as jprof
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import profiling as tprof
from raft_tpu_torch.obs.spans import SpanTracker
from raft_tpu_torch.raft.engine import RaftEngine
from raft_tpu_torch.transport import SingleDeviceTransport


def span_export():
    spans = SpanTracker()
    for i in range(3):
        sp = spans.begin("write", 0.5 * i, client=i, key=b"k%d" % i)
        sp.finish("ok", 0.5 * i + 0.25)
    return spans.to_perfetto()


def test_merge_timelines_byte_equal_to_jax():
    device = [
        {"ph": "M", "name": "process_name", "pid": 7,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "name": "write_window_both_kernel", "pid": 7, "tid": 3,
         "ts": 10.0, "dur": 2.5, "cat": "kernel"},
        {"ph": "X", "name": "leader_tick#4", "pid": 1, "tid": 1, "ts": 9.0,
         "dur": 5.0, "cat": "user_annotation"},
    ]
    spans = span_export()
    got = tprof.merge_timelines(device, spans)
    want = jprof.merge_timelines(device, spans)
    assert json.dumps(got) == json.dumps(want)
    assert got["n_span_events"] > 0 and got["n_device_events"] == 3
    assert json.dumps(tprof.merge_timelines(device, None)) == \
        json.dumps(jprof.merge_timelines(device, None))
    assert (tprof.PROFILE_FORMAT, tprof.SPAN_PID_OFFSET) == \
        (jprof.PROFILE_FORMAT, jprof.SPAN_PID_OFFSET)


def test_resolve_profile_dir_ladder(monkeypatch, tmp_path):
    monkeypatch.delenv("RAFT_TPU_PROFILE_DIR", raising=False)
    for mod in (jprof, tprof):
        assert mod.resolve_profile_dir(None) is None
        assert mod.resolve_profile_dir("/x") == "/x"
    monkeypatch.setenv("RAFT_TPU_PROFILE_DIR", str(tmp_path))
    for mod in (jprof, tprof):
        assert mod.resolve_profile_dir(None) == str(tmp_path)
        assert mod.resolve_profile_dir("/x") == "/x"
    monkeypatch.setenv("RAFT_TPU_PROFILE_DIR", "")
    assert tprof.resolve_profile_dir(None) is None


def test_one_capture_at_a_time(tmp_path):
    """A capture in flight makes a second raise ``CaptureBusy``; so does a
    ``torch.profiler`` session of the caller's, which keeps recording."""
    release = threading.Event()
    entered = threading.Event()
    box = {}

    def hold(_seconds):
        entered.set()
        release.wait(30)

    th = threading.Thread(target=lambda: box.update(
        r=tprof.capture_profile(0.0, profile_dir=str(tmp_path / "a"),
                                sleep=hold)))
    th.start()
    assert entered.wait(60)
    assert tprof.capture_active()
    with pytest.raises(tprof.CaptureBusy):
        tprof.capture_profile(0.0, profile_dir=str(tmp_path / "b"))
    release.set()
    th.join(60)
    assert "artifact" in box["r"] and not tprof.capture_active()
    # the caller's own session: refused, and it still records
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(tprof.CaptureBusy, match="session is live"):
            tprof.capture_profile(0.0, profile_dir=str(tmp_path / "c"))
        with torch.profiler.record_function("still_recording"):
            torch.ones(3) + 1
    assert any(ev.name == "still_recording" for ev in prof.events())
    assert not (tmp_path / "c").exists()


def test_capture_while_an_engine_thread_ticks(tmp_path):
    cfg = RaftConfig(n_replicas=3, entry_bytes=32, batch_size=4,
                     log_capacity=64, transport="single")
    e = RaftEngine(cfg, SingleDeviceTransport(cfg, device="cpu"))
    e.spans = spans = SpanTracker()
    e.run_until_leader()
    stop = threading.Event()
    errors = []

    def drive():
        try:
            while not stop.is_set():
                spans.current = spans.begin("write", e.clock.now)
                seq = e.submit(bytes(cfg.entry_bytes))
                spans.current = None
                e.run_until_committed(seq)
                time.sleep(0.002)
        except Exception as ex:          # re-raised on the test thread
            errors.append(ex)

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    try:
        res = tprof.capture_profile(0.3, spans=spans,
                                    profile_dir=str(tmp_path))
    finally:
        stop.set()
        th.join(60)
    assert not errors
    art = json.loads(open(res["artifact"]).read())
    assert art["format"] == jprof.PROFILE_FORMAT
    assert res["n_span_events"] == art["n_span_events"] > 0
    assert res["n_kernel_events"] == 0          # the CPU has no kernels
    assert res["raw_dir"] is not None and res["raw_dir"].startswith(
        str(tmp_path))
    names = [ev.get("name", "") for ev in art["traceEvents"]]
    assert not any(ev.get("cat") == "python_function"
                   for ev in art["traceEvents"])
    if res["all_threads"]:
        # the engine thread's per-tick annotations landed in a capture
        # this thread started
        assert res["n_launch_annotations"] > 0
        assert any(n.startswith("leader_tick#") for n in names)
    span_pids = {ev["pid"] for ev in art["traceEvents"][-art[
        "n_span_events"]:] if "pid" in ev}
    assert min(span_pids) >= tprof.SPAN_PID_OFFSET


def test_device_seconds_nan_without_a_kernel():
    t = tprof.device_seconds(lambda x: x * 2, lambda: (torch.ones(64),))
    assert np.isnan(t)


def test_op_breakdown_reads_a_trace_directory(tmp_path):
    evs = [
        {"ph": "X", "cat": "kernel", "name": "steady_step_kernel",
         "ts": 0.0, "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "steady_step_kernel",
         "ts": 5.0, "dur": 6.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 1.0, "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
         "dur": 50.0},
    ]
    (tmp_path / "run.pt.trace.json").write_text(
        json.dumps({"traceEvents": evs}))
    assert tprof.op_breakdown(str(tmp_path)) == [
        ("steady_step_kernel", 2, 0.01), ("Memcpy HtoD", 1, 0.001)]
    assert tprof.op_breakdown(str(tmp_path / "empty")) == []
