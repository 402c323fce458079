"""The port's benchmark (port of ``bench.py``): every leg of the JAX suite,
its kernel gates and its deadline, measured on one NVIDIA GPU.

    python -m raft_tpu_torch.bench [--deadline-s S] [--compare OLD.json]
                                   [--regress-threshold F] [--device cuda]

Output protocol (``bench.py``'s): each leg prints its own ``{"leg": name,
...}`` JSON line the moment it completes, so a deadline-cut run still
yields every finished leg; the last line is the combined object. The first
line, ``{"card": ..., "power_limit": ...}``, names the card (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``), and the combined
object carries it again, so no time in the output stands without the card
it came from.

The run's device is explicit: ``--device`` (default ``cuda``). Without a
GPU the run stops with an error unless ``--device cpu`` was given; on the
CPU every kernel wrapper runs its plain PyTorch version and the device
rows fall back to wall-clock timing (``method`` says which).

Legs, function names and row keys are ``bench.py``'s, so each row has its
counterpart (``tools/bench_diff.py`` and the port's
``raft_tpu_torch.tools.bench_diff`` read either). Where the two differ:

- **Device time.** ``device_seconds`` (``obs.profiling``) sums the
  durations of the call's CUDA kernel, copy and fill events in a
  ``torch.profiler`` trace; JAX's measures one compiled module's span. A
  T-step row is that sum over T (``method`` says so). The per-step rows of
  ``c2``/``c4``/``c3`` run ``core.step_cuda.steady_pipeline`` (one flight:
  K3's plan and write, or K3's plan then K4) over a one-window stack
  cycled for T = 512 steps (c3: the streamed EC stack, in-kernel parity),
  and the repair-capable program as T general-path steps (K1 twice a
  step). ``program`` names what the card actually ran (the flights K3 and
  K4 executed, read from the workspace counters).
- **Wall time** on the card is host time around a call followed by
  ``torch.cuda.synchronize``; the multi-group and group-shard device rows
  use CUDA events around the launch.
- **compile_count** counts, per leg, what the port's compile plane
  (``obs.compile.CompileWatch``) records: a novel argument signature at a
  ``labeled`` seam (the counterpart of a jit retrace), a CUDA-graph capture
  and a kernel-library build; ``compile_s`` their seconds.
  ``mem_high_water_bytes`` is ``obs.memory.MemoryWatch``'s census of the
  run device's live tensors at the leg's entry and exit.
- **group_shard** runs its shards on the run's one device
  (``GroupMesh([dev, dev])``), never on virtual CPU devices in a child;
  each row names the device.
- **mesh1_per_device** runs ``MeshTransport`` in a one-rank gloo group
  opened in this process.
- The combined object adds ``card``, ``power_limit``, ``build_s`` (the
  kernels' build before the first leg), ``launches_by_leg`` (each
  kernel's launches in each leg, from the wrappers' counters; the gates'
  under ``kernel_gates``), ``leg_wall_s`` and ``run_wall_s``; with
  ``--profile-legs`` also ``device_busy_by_leg`` (each leg under a
  CUDA-only profiler session: busy seconds, idle share, top kernels; the
  session slows the host, so such a run is for the idle shares).

The kernel gates run on the card only (``bench.py`` runs its gates on a TPU
only): K1 against its plain version at the gate's wrap, partial-count and
conflict cases, and the multi-lap flight (C = 4 096, T = 12, with and
without a never-accepting slow row, and at RS(5,3)) byte for byte against
the per-step K2 scan. A mismatch ends the run with a non-zero exit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from raft_tpu_torch.admission import Overloaded
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.comm import SingleDeviceComm
from raft_tpu_torch.core.state import init_state
from raft_tpu_torch.core.step import replicate_step
from raft_tpu_torch.obs.profiling import device_seconds, op_breakdown
from raft_tpu_torch.obs.registry import MetricsRegistry

REFERENCE_TICK_US = 2_000_000.0  # main.go:394 — 2 s replication tick
T_STEPS = 512                    # steps per timed flight or scan
REPS = 8                         # traced runs per config

def _dev(dev=None) -> torch.device:
    """``dev``, else CUDA, which must then exist (no CPU fallback); a
    CUDA device always with its index (the kernels' per-device workspace
    is keyed by it)."""
    from raft_tpu_torch.transport.device import resolve_device

    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def card_query() -> tuple:
    """(name, power limit) of the first GPU as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them;
    (None, None) where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None, None
    line = out.strip().splitlines()[0] if out.strip() else ""
    if "," not in line:
        return None, None
    name, limit = line.rsplit(",", 1)
    return name.strip(), limit.strip()


def _emit_leg(name: str, row: dict) -> dict:
    """Publish one leg's row the moment it completes: a deadline-cut run
    still yields every finished leg's numbers (the final combined object
    remains the last line). One JSON object per line, keyed by ``leg``."""
    print(json.dumps({"leg": name, **row}), flush=True)
    return row


#: kernel -> (module, counter key) of the wrappers' launch counters
_COUNTERS = {
    "K1": ("core.ring_cuda", "write_window_both"),
    "K5": ("core.ring_cuda", "write_window_cols"),
    "K2": ("core.step_cuda", "steady_step"),
    "K3": ("core.step_cuda", "pipeline_flight"),
    "K4": ("core.step_cuda", "turnover_flight"),
    "K2·ec": ("core.step_cuda", "steady_step_ec"),
    "K3·ec": ("core.step_cuda", "pipeline_flight_ec"),
    "K4·ec": ("core.step_cuda", "turnover_flight_ec"),
    "K2·mesh": ("core.step_cuda", "steady_step_mesh"),
    "K3·mesh": ("core.step_cuda", "pipeline_flight_mesh"),
    "K4·mesh": ("core.step_cuda", "turnover_flight_mesh"),
    "K6 encode": ("ec.kernels", "encode"),
    "K6 decode": ("ec.kernels", "decode"),
    "K7": ("ec.kernels", "encode_fold"),
}

def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by kernel."""
    import importlib

    return {k: importlib.import_module(f"raft_tpu_torch.{m}").LAUNCHES[key]
            for k, (m, key) in _COUNTERS.items()}


def _count_launches(book: dict, name: str, fn: Callable):
    """``fn()``, its kernels' launches booked to ``book[name]``."""
    before = launch_counts()
    try:
        return fn()
    finally:
        after = launch_counts()
        used = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        if used:
            book[name] = used


class _Deadline:
    """Overall run budget (``--deadline-s``): once elapsed wall time
    crosses it, every remaining leg is SKIPPED (an explicit
    ``{"skipped": "deadline"}`` row, so consumers can tell "not run" from
    "ran and failed") and the final combined JSON still prints. The budget
    is checked BETWEEN legs; a leg in flight runs to completion. Each
    leg's kernel launches are booked in ``launches`` (leg -> kernel ->
    launches), its host wall in ``walls`` (leg -> seconds), and with
    ``profile`` its device busy time in ``busy`` (``_device_busy``); its
    memory census counts the tensors on ``dev`` (every device's when
    None)."""

    def __init__(self, seconds: float | None, dev=None,
                 profile: bool = False):
        self.seconds = seconds
        self.dev = dev
        self.profile = profile
        self.t0 = time.monotonic()
        self.skipped: list = []
        self.launches: dict = {}
        self.walls: dict = {}
        self.busy: dict = {}

    @property
    def expired(self) -> bool:
        return (
            self.seconds is not None
            and time.monotonic() - self.t0 >= self.seconds
        )

    def remaining(self) -> float | None:
        if self.seconds is None:
            return None
        return max(self.seconds - (time.monotonic() - self.t0), 0.0)

    def run(self, name: str, fn: Callable[[], dict]) -> dict:
        if self.expired:
            self.skipped.append(name)
            return _emit_leg(name, {"skipped": "deadline"})
        return _emit_leg(name, self.book(
            name, lambda: _observed_leg(fn, self.dev)))

    def book(self, name: str, fn: Callable):
        """``fn()`` with its launches, wall (and device busy time) booked
        to ``name``. A leg that traces its own calls (``SELF_PROFILED``)
        is not profiled again: one profiler session at a time."""
        t0 = time.perf_counter()
        try:
            if self.profile and name not in SELF_PROFILED:
                out, self.busy[name] = _device_busy(
                    lambda: _count_launches(self.launches, name, fn))
                return out
            return _count_launches(self.launches, name, fn)
        finally:
            self.walls[name] = round(time.perf_counter() - t0, 3)


#: legs that time their programs under their own profiler sessions
#: (``bench_scan``; ``bench_rs53``'s decode)
SELF_PROFILED = ("c2_batched", "c4_slow", "c2_batch4096", "c3_rs53",
                 "mesh1_per_device")


def _device_busy(fn: Callable):
    """(``fn()``, its device time) under a CUDA-only ``torch.profiler``
    session: the summed self device time of every event by name, the top
    five kernels, and the share of the call's host wall the card was busy.
    The session's per-launch cost distorts host-clock figures, so a run
    with ``--profile-legs`` is for the idle shares, not the rows."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return out, {
        "busy_s": round(busy, 6),
        "wall_s": round(wall, 3),
        "idle_share": round(1.0 - busy / wall, 4) if wall > 0 else None,
        "top_ms": {k: round(v / 1e3, 3) for k, v in top},
    }


def _observed_leg(fn: Callable[[], dict], dev=None) -> dict:
    """Run one leg under the compile and memory planes and merge their
    accounting into the row: ``compile_count``/``compile_s`` (the
    signatures, captures and builds the leg incurred, ``obs.compile``) and
    ``mem_high_water_bytes`` (the live-tensor census, ``obs.memory``,
    taken at leg entry and exit)."""
    from raft_tpu_torch.obs.compile import CompileWatch
    from raft_tpu_torch.obs.memory import MemoryWatch

    watch = CompileWatch()
    mem = MemoryWatch()
    mem.device = None if dev is None else torch.device(dev)
    watch.install()
    try:
        mem.census()
        row = fn()
    finally:
        watch.uninstall()
    mem.census()
    if isinstance(row, dict) and "skipped" not in row:
        row.setdefault("compile_count",
                       watch.total_traces + watch.total_compiles)
        row.setdefault("compile_s", round(watch.total_compile_s, 3))
        row.setdefault("mem_high_water_bytes", mem.high_water_bytes)
    return row


def _percentiles(vals):
    v = np.asarray([x for x in vals if np.isfinite(x)])
    if v.size == 0:
        return float("nan"), float("nan")
    return float(np.percentile(v, 50)), float(np.percentile(v, 99))


def _rand_i32(rng, shape) -> np.ndarray:
    return rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                        shape, dtype=np.int32)


def make_scan(cfg: RaftConfig, slow_mask, ec: bool,
              mk_payload: Callable, xs, repair: bool = False,
              ec_code=None, payload_operand=None, dev=None):
    """T_STEPS replicate steps as ``fn(state) -> (state, commit_index)``.

    ``repair=False`` (or an EC row), on a shape the kernels serve
    (``step_cuda.shape_ok``): the saturated pipeline as ONE flight,
    ``core.step_cuda.steady_pipeline`` — K3's plan and write, or K3's plan
    then K4 when every row accepts — over a one-window stack cycled for
    all T steps (the EC row: the streamed stack of data-lane windows, the
    parity encoded in the kernel). Otherwise T steps of
    ``core.step.replicate_step`` (the general path, K1), each on
    ``mk_payload(x)`` of one ``xs`` element, or on ``payload_operand``
    when given (a constant window)."""
    from raft_tpu_torch.core.step_cuda import shape_ok, steady_pipeline

    dev = _dev(dev)
    comm = SingleDeviceComm(cfg.n_replicas)
    alive = torch.ones(cfg.n_replicas, dtype=torch.bool, device=dev)
    slow = torch.as_tensor(np.asarray(slow_mask), device=dev)
    count = cfg.batch_size

    if (not repair or ec) and shape_ok(cfg.log_capacity, cfg.batch_size):
        T = xs.shape[0]
        counts = torch.full((T,), cfg.batch_size, dtype=torch.int32,
                            device=dev)
        ec_consts = None
        if ec and ec_code is not None:
            from raft_tpu_torch.ec.kernels import (fold_data_lanes,
                                                   parity_consts)

            ec_consts = parity_consts(ec_code.n, ec_code.k)
            t_, b_, s_ = xs.shape
            wins = fold_data_lanes(xs.reshape(t_ * b_, s_)).reshape(
                t_, b_, s_ // 4)
        else:
            # non-EC rows re-ingest one constant window every step
            wins = mk_payload(xs[0])[None].contiguous()
        # turnover only where the static mask admits all-accept (an
        # induced-slow row never accepts)
        allow_turnover = not bool(np.asarray(slow_mask).any())

        def scan_fused(state):
            st, info = steady_pipeline(
                state, wins, counts, 0, 1, alive, slow, 0, 0, None, 1,
                commit_quorum=cfg.commit_quorum, ec_consts=ec_consts,
                allow_turnover=allow_turnover,
            )
            return st, info.commit_index

        scan_fused.program = "flight"
        return scan_fused

    def _body(st, win):
        st, info = replicate_step(
            comm, st, win, count, 0, 1, alive, slow,
            ec=ec, commit_quorum=cfg.commit_quorum, repair=repair,
            term_floor=(None if repair else 1),
        )
        return st, info.commit_index

    def scan(state):
        commits = []
        for t in range(xs.shape[0]):
            win = (payload_operand if payload_operand is not None
                   else mk_payload(xs[t]))
            state, c = _body(state, win)
            commits.append(c)
        return state, torch.stack(commits)

    scan.program = "general"
    return scan


def _timed_wall_call(fn, *args) -> float:
    """Wall seconds for one fn(*args), forcing a real output readback (the
    first tensor of the output copied to the host)."""
    t0 = time.perf_counter()
    out = fn(*args)
    _first_tensor(out).reshape(-1)[:1].cpu()
    return time.perf_counter() - t0


def _first_tensor(out):
    """The first tensor leaf of an output (a state's ``term``)."""
    while not isinstance(out, torch.Tensor):
        out = out[0] if isinstance(out, (tuple, list)) else out.term
    return out


def _event_seconds(fn, dev):
    """(seconds, output) of one ``fn()``: CUDA events around it on the
    card, the host clock (after the output is read back) elsewhere."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    _first_tensor(out).reshape(-1)[:1].cpu()
    return time.perf_counter() - t0, out


def _flights_run(dev):
    """(K3 flights, K4 flights) the card has executed so far."""
    from raft_tpu_torch.core import step_cuda

    if torch.device(dev).type != "cuda":
        return None
    w = step_cuda.workspace(dev)
    return int(w[step_cuda.WK_RAN3]), int(w[step_cuda.WK_RAN4])


def _ran(fn, dev, before) -> str:
    """What one call of ``fn`` ran: a ``make_scan`` program, or the
    description a caller set as ``fn.program``."""
    program = getattr(fn, "program", "flight")
    if program == "general":
        return ("general path: T steps of core.step.replicate_step "
                "(K1 twice a step)")
    if program != "flight":
        return program
    after = _flights_run(dev)
    if after is None:
        return "one flight, plain versions (CPU)"
    k3, k4 = after[0] - before[0], after[1] - before[1]
    if k4:
        return f"one flight: K3 plan, then K4 (K4 wrote {k4})"
    return f"one flight: K3 plan + write (K3 wrote {k3})"


def bench_scan(cfg: RaftConfig, fn, reps: int = REPS, dev=None) -> dict:
    """p50/p99 per-step time for one T-step program + commit sanity.
    ``reps`` can be lowered for supplementary (non-headline) rows."""
    dev = _dev(dev)
    before = _flights_run(dev)
    # the measured pipeline must actually commit its entries
    _, commits = fn(init_state(cfg, device=dev))
    got = int(commits.reshape(-1)[-1])
    assert got == T_STEPS * cfg.batch_size, (
        f"scan committed {got}, expected {T_STEPS * cfg.batch_size}"
    )
    ran = _ran(fn, dev, before)

    per_step, call_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        per_step.append(device_seconds(
            fn, lambda: (init_state(cfg, device=dev),)) * 1e6 / T_STEPS)
        call_s.append(time.perf_counter() - t0)
    method = ("device: torch.profiler, summed CUDA kernel/copy/fill "
              f"durations of one {T_STEPS}-step call / {T_STEPS} (a "
              f"profiled call, warm-up and trace export included, took "
              f"{float(np.median(call_s)):.2f} s of host time)")
    breakdown = None
    if any(np.isfinite(per_step)):
        # one extra traced rep into a KEPT trace dir so the row carries
        # per-kernel device-time attribution (obs.profiling.op_breakdown)
        import shutil
        import tempfile

        tdir = tempfile.mkdtemp(prefix="raft_tpu_torch_bench_trace_")
        try:
            if np.isfinite(
                device_seconds(fn, lambda: (init_state(cfg, device=dev),),
                               warmups=0, trace_dir=tdir)
            ):
                breakdown = [
                    {"op": nm, "calls": c, "total_ms": round(ms, 3)}
                    for nm, c, ms in op_breakdown(tdir, top=8)
                ] or None
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
    else:
        # no device trace on this platform: wall-clock whole-scan fallback
        method = (f"wall: host clock around one {T_STEPS}-step call, "
                  f"output read back / {T_STEPS}")
        per_step = []
        for _ in range(reps):
            st = init_state(cfg, device=dev)
            _sync(dev)
            per_step.append(_timed_wall_call(fn, st) * 1e6 / T_STEPS)
    p50, p99 = _percentiles(per_step)
    row = {
        "p50_us": round(p50, 3),
        "p99_us": round(p99, 3),
        "entries_per_sec": round(cfg.batch_size / p50 * 1e6, 1),
        "method": f"{method}; ran: {ran}",
    }
    if breakdown is not None:
        row["op_breakdown"] = breakdown
    return row


def _best_program(steady: dict, repair_capable: dict) -> dict:
    """Select the faster of the two step programs for a shape (the choice
    a deployment makes with ``RaftConfig.steady_dispatch``) and report
    both numbers (each row's ``method`` says what the card ran)."""
    steady["program"] = "steady (steady_dispatch=auto)"
    repair_capable["program"] = "repair_capable (steady_dispatch=off)"
    best, alt = (
        (repair_capable, steady)
        if repair_capable["p50_us"] < steady["p50_us"]
        else (steady, repair_capable)
    )
    best["p50_alt_program"] = alt["p50_us"]
    best["method"] += f"; the other program: {alt['method']}"
    return best


def _fixed_payload_scan(cfg: RaftConfig, slow_mask, rng, repair=False,
                        dev=None):
    """Plain replication: a fixed resident batch (its bytes are irrelevant
    to step cost; the write into the ring is the measured work), xs = the
    per-step index."""
    dev = _dev(dev)
    words = _rand_i32(rng, (cfg.batch_size, cfg.shard_words))
    payload = torch.as_tensor(np.tile(words, (1, cfg.n_replicas)),
                              device=dev)
    xs = torch.arange(T_STEPS, dtype=torch.int32, device=dev)
    return make_scan(cfg, slow_mask, ec=False,
                     mk_payload=lambda x: payload, xs=xs, repair=repair,
                     payload_operand=payload, dev=dev)


# --------------------------------------------------------------- config 1
def bench_loopback(n_entries: int = 400) -> dict:
    from raft_tpu_torch.golden import GoldenCluster

    c = GoldenCluster(3, seed=0)
    lead = c.run_until_leader()
    t0 = time.perf_counter()
    submit_at = {}
    done_at = {}
    for i in range(n_entries):
        lead.client_append(i.to_bytes(8, "little"))
        submit_at[i] = c.now
        # drive ticks until this entry commits (reference cadence)
        while lead.commit_index < lead.last_applied and c.step_event():
            for j in range(len(done_at), lead.commit_index):
                done_at[j] = c.now
    wall = time.perf_counter() - t0
    lat = [done_at[i] - submit_at[i] for i in done_at]
    return {
        "entries_per_sec_host": round(n_entries / wall, 1),
        "virtual_commit_p50_s": round(float(np.percentile(lat, 50)), 3),
    }


# --------------------------------------------------------------- config 3
def bench_rs53(dev=None) -> dict:
    from raft_tpu_torch.ec.kernels import (decode_device, encode_device,
                                           encode_fold_device,
                                           fold_shards_device)
    from raft_tpu_torch.ec.rs import RSCode

    dev = _dev(dev)
    cfg = RaftConfig(
        n_replicas=5, entry_bytes=264, batch_size=1024, log_capacity=1 << 15,
        rs_k=3, rs_m=2, transport="single",
    )
    code = RSCode(5, 3)
    rng = np.random.default_rng(cfg.seed)
    # per-step entry stream: the flight encodes a different batch every
    # step (in-kernel parity over the streamed data lanes)
    stream = torch.as_tensor(rng.integers(
        0, 256, (T_STEPS, cfg.batch_size, cfg.entry_bytes), dtype=np.uint8
    ), device=dev)

    # equivalence gate for the fused encode+fold (K7) against the unfused
    # encode (K6) and fold, on this device
    probe = torch.as_tensor(rng.integers(
        0, 256, (cfg.batch_size, cfg.entry_bytes), dtype=np.uint8
    ), device=dev)
    if not torch.equal(encode_fold_device(code, probe),
                       fold_shards_device(encode_device(code, probe))):
        raise AssertionError(
            "fused encode+fold diverges from reference on this backend")

    def mk_payload(x):
        return encode_fold_device(code, x)

    fn = make_scan(cfg, np.zeros(5, bool), ec=True,
                   mk_payload=mk_payload, xs=stream, ec_code=code, dev=dev)
    out = bench_scan(cfg, fn, dev=dev)

    # reconstruction-on-read: decode a B-entry window from 3 shard rows
    # (K6 on the card; its plain version on the CPU)
    rows = [1, 3, 4]
    shards = torch.as_tensor(
        rng.integers(0, 256, (3, cfg.batch_size, cfg.shard_bytes),
                     dtype=np.uint8), device=dev)

    def dec(s):
        return decode_device(code, s, rows)

    t_dec = device_seconds(dec, lambda: (shards,))
    dec_method = "device time"
    if not np.isfinite(t_dec):
        dec(shards)  # warm
        t_dec = min(_timed_wall_call(dec, shards) for _ in range(4))
        dec_method = "host wall (the trace held no device record)"
    out["method"] += f"; reconstruct_window_us: {dec_method}"
    out["entry_bytes"] = cfg.entry_bytes
    # Degraded read (a parity row serves): DEVICE time of the decode
    # kernel for the window. Systematic read (the k data rows serve):
    # HOST wall of the no-decode reorder+stitch.
    out["reconstruct_window_us"] = round(t_dec * 1e6, 1)
    sys_shards = shards.cpu().numpy()
    code.unsplit(sys_shards)  # warm
    stitch = []
    for _ in range(8):
        t0 = time.perf_counter()
        code.unsplit(sys_shards)
        stitch.append(time.perf_counter() - t0)
    out["systematic_stitch_host_us"] = round(min(stitch) * 1e6, 1)
    return out


# ------------------------------------------------- host/device attribution
def _engine(cfg, dev):
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport import SingleDeviceTransport

    return RaftEngine(cfg, SingleDeviceTransport(cfg, device=dev))


def bench_attribution(dev=None) -> dict:
    """WHERE the engine's per-tick wall time goes: the real engine tick
    loop at the headline shape with ``obs.hostprof.HostProfiler`` attached,
    each tick decomposed into contiguous host phases (heap_pop / host_pre
    / pack / dispatch / device_wait / host_post). The phases are
    boundary-marked, so they tile the tick: ``columns_us`` must sum to
    within 10% of the measured wall µs/tick (``attribution_coverage``).
    Then the device event ring on/off and the online safety/SLO plane
    on/off, each bracketed by observe-off windows."""
    from raft_tpu_torch.obs.hostprof import HostProfiler

    dev = _dev(dev)
    cfg = RaftConfig()                   # the c2 headline shape
    e = _engine(cfg, dev)
    e.metrics = MetricsRegistry()
    e.run_until_leader()
    rng = np.random.default_rng(3)

    def mk_batch():
        return [rng.integers(0, 256, cfg.entry_bytes, np.uint8).tobytes()
                for _ in range(cfg.batch_size)]

    def drive_rounds(rounds: int) -> tuple:
        """(wall_s, events, leader_ticks) over ``rounds`` one-batch commit
        rounds; the wall window covers exactly the step_event loop."""
        wall, events, n0 = 0.0, 0, e._tick_count
        for _ in range(rounds):
            seqs = [e.submit(p) for p in mk_batch()]
            t0 = time.perf_counter()
            while not e.is_durable(seqs[-1]):
                e.step_event()
                events += 1
            wall += time.perf_counter() - t0
        return wall, events, e._tick_count - n0

    # warm past the first ring lap + archive compaction
    drive_rounds(2 * cfg.log_capacity // cfg.batch_size + 2)
    ROUNDS = 24
    wall_off1, ev_off1, _ = drive_rounds(ROUNDS)        # observe-off base
    e.hostprof = hp = HostProfiler(registry=e.metrics)
    wall_on, ev_on, lt_on = drive_rounds(ROUNDS)
    assert ev_on == hp.ticks
    e.hostprof = None
    wall_off2, ev_off2, _ = drive_rounds(ROUNDS)        # off, re-measured

    per = hp.us_per_tick()
    host_us, dev_us = hp.split()
    wall_us = wall_on / max(ev_on, 1) * 1e6
    wall_us_off = min(
        wall_off1 / max(ev_off1, 1), wall_off2 / max(ev_off2, 1)
    ) * 1e6

    # -- device-resident observability (obs.device): ring on/off -------
    dev_obs = e.attach_device_obs(capacity=4096)
    drive_rounds(2)                           # warm the recorded programs
    rec0 = dev_obs.total_recorded
    wall_dev, ev_dev, _ = drive_rounds(ROUNDS)
    dev_records = dev_obs.total_recorded - rec0
    t0 = time.perf_counter()
    FLUSHES = 200
    for _ in range(FLUSHES):
        e._flush_device_obs()
    flush_us = (time.perf_counter() - t0) / FLUSHES * 1e6
    e.detach_device_obs()
    wall_dev_us = wall_dev / max(ev_dev, 1) * 1e6
    device_ring = {
        "wall_us_per_tick_ring_on": round(wall_dev_us, 3),
        "wall_us_per_tick_ring_off": round(wall_us_off, 3),
        "added_us_per_tick": round(wall_dev_us - wall_us_off, 3),
    }
    # -- online safety/SLO plane (obs.audit + obs.slo + obs.serve) -----
    from raft_tpu_torch.obs.audit import SafetyAuditor
    from raft_tpu_torch.obs.serve import StatusBoard
    from raft_tpu_torch.obs.slo import SLObjective, SloTracker

    wall_po1, ev_po1, _ = drive_rounds(ROUNDS)
    e.auditor = SafetyAuditor(
        registry=e.metrics, max_entries=2 * cfg.log_capacity
    )
    e.slo = SloTracker(
        objectives=(
            SLObjective("commit_fast", "commit",
                        threshold_s=2 * cfg.heartbeat_period),
        ),
        registry=e.metrics,
    )
    e.status_board = StatusBoard()
    drive_rounds(2)                               # warm the plane's dicts
    wall_onl, ev_onl, _ = drive_rounds(ROUNDS)
    wall_onl_us = wall_onl / max(ev_onl, 1) * 1e6
    auditor, slo_tracker, board = e.auditor, e.slo, e.status_board
    e.auditor = e.slo = e.status_board = None
    wall_po2, ev_po2, _ = drive_rounds(ROUNDS)
    wall_plane_off = min(
        wall_po1 / max(ev_po1, 1), wall_po2 / max(ev_po2, 1)
    ) * 1e6
    online_plane = {
        "wall_us_per_tick_plane_on": round(wall_onl_us, 3),
        "wall_us_per_tick_plane_off": round(wall_plane_off, 3),
        "added_us_per_tick": round(wall_onl_us - wall_plane_off, 3),
        "added_pct_of_wall": round(
            (wall_onl_us - wall_plane_off) / wall_plane_off * 100, 2
        ),
        "audit_violations": auditor.total_violations,
        "status_generations": board.generation,
        "slo_commit_digest_n": (
            slo_tracker.digests[("commit", None)].n
            if ("commit", None) in slo_tracker.digests else 0
        ),
        "note": ("safety auditor + SLO tracker + status-board publish "
                 "per tick; acceptance: added wall <= 5% at the "
                 "headline shape, 0 violations on a healthy cluster"),
    }

    device_obs_row = {
        "records": int(dev_records),
        "records_per_s": round(dev_records / max(wall_dev, 1e-9), 1),
        "dropped": dev_obs.dropped,
        "flush_us": round(flush_us, 3),
        "flush_us_per_tick_amortised": {
            f"K{k}": round(flush_us / k, 3) for k in (1, 8, 64)
        },
        "note": ("flush = one packed ring+counters fetch per launch "
                 "boundary; a K-tick fused launch pays it once per K "
                 "ticks"),
    }

    return {
        "ticks": ev_on,
        "leader_ticks": lt_on,
        "entries_per_tick": cfg.batch_size,
        "wall_us_per_leader_tick": round(
            wall_on / max(lt_on, 1) * 1e6, 3
        ),
        "wall_us_per_tick": round(wall_us, 3),
        "wall_us_per_tick_observe_off": round(wall_us_off, 3),
        "observe_overhead_us": round(wall_us - wall_us_off, 3),
        "columns_us": {k: round(v, 3) for k, v in per.items()},
        "host_us_per_tick": round(host_us, 3),
        "device_us_per_tick": round(dev_us, 3),
        "attribution_coverage": round(
            sum(per.values()) / wall_us if wall_us else float("nan"), 4
        ),
        "device_ring": device_ring,
        "device_obs": device_obs_row,
        "online_plane": online_plane,
        "metrics": e.metrics.to_json(),
        "note": ("columns_us are boundary-marked phases tiling each "
                 "step_event; their sum must land within 10% of "
                 "wall_us_per_tick (attribution_coverage ~ 1.0). "
                 "device_wait is the post-dispatch synchronization; host "
                 "fetches inside bookkeeping phases charge to those "
                 "phases"),
    }


# ---------------------------------------------------- K-tick fusion sweep
def bench_fusion(dev=None) -> dict:
    """The K-tick fused steady-state engine at the headline shape: wall
    µs/tick of the real engine drain loop for K ∈ {1, 8, 64, 256} (on the
    card each fused launch replays a CUDA graph of K ticks), with dispatch
    amortization (protocol ticks per launch), the hostprof phase columns
    per protocol tick and the device-ring wall per tick at each K. Each K
    emits its own row. Clients submit the backlog OUTSIDE the timed
    window; the window covers exactly the ``run_for`` drain."""
    from raft_tpu_torch.obs.hostprof import HostProfiler

    dev = _dev(dev)
    rows = {}
    base_wall = None
    rng = np.random.default_rng(13)
    # the engine honors RAFT_TPU_FUSE_K over cfg.fuse_k: a leftover
    # export would run every row at the env's K
    env_k = os.environ.pop("RAFT_TPU_FUSE_K", None)
    if env_k is not None:
        print(f'{{"leg": "fusion", "note": "ignoring RAFT_TPU_FUSE_K='
              f'{env_k} for the sweep"}}', flush=True)

    try:
        for K in (1, 8, 64, 256):
            cfg = RaftConfig(fuse_k=K)           # the c2 headline shape
            e = _engine(cfg, dev)
            assert e.fuse_k == K
            e.run_until_leader()
            batch = [
                rng.integers(0, 256, cfg.entry_bytes, np.uint8).tobytes()
                for _ in range(cfg.batch_size)
            ]

            def load(n_batches):
                for _ in range(n_batches):
                    for p in batch:
                        e.submit(p)

            def drain(n_batches) -> float:
                last_seq = e._next_seq - 1
                t0 = time.perf_counter()
                while not e.is_durable(last_seq):
                    e.run_for(cfg.heartbeat_period * max(n_batches, 1))
                return time.perf_counter() - t0

            # warm: captures (tick programs + fused sizes) and a ring lap
            warm = max(2 * cfg.log_capacity // cfg.batch_size, 2 * K)
            load(warm)
            drain(warm)
            ROUNDS = 3
            per_round = max(K, 8)
            t0c, f0l, f0t = e._tick_count, e.fused_launches, e.fused_ticks
            t_wall = 0.0
            for _ in range(ROUNDS):
                load(per_round)
                t_wall += drain(per_round)
            ticks = e._tick_count - t0c
            fused_t = e.fused_ticks - f0t
            launches = (e.fused_launches - f0l) + (ticks - fused_t)
            wall_us = t_wall / max(ticks, 1) * 1e6
            if K == 1:
                base_wall = wall_us

            e.hostprof = HostProfiler()
            hp = e.hostprof
            t0c = e._tick_count
            load(per_round)
            drain(per_round)
            hp_ticks = e._tick_count - t0c
            cols = {
                p: round(s / max(hp_ticks, 1) * 1e6, 3)
                for p, s in sorted(hp.totals().items())
            }
            e.hostprof = None

            e.attach_device_obs(capacity=4096)
            load(per_round)
            drain(per_round)        # warm recorded programs
            t0c = e._tick_count
            load(per_round)
            ring_wall = drain(per_round)
            ring_us = ring_wall / max(e._tick_count - t0c, 1) * 1e6
            e.detach_device_obs()

            row = {
                "K": K,
                "wall_us_per_tick": round(wall_us, 3),
                "ticks": ticks,
                "launches": launches,
                "ticks_per_launch": round(ticks / max(launches, 1), 2),
                "entries_per_sec_wall": round(
                    cfg.batch_size / wall_us * 1e6, 1
                ),
                "speedup_vs_k1": (
                    round(base_wall / wall_us, 2) if base_wall else None
                ),
                "host_phase_us_per_tick": cols,
                "wall_us_per_tick_ring_on": round(ring_us, 3),
            }
            rows[f"K{K}"] = _emit_leg(f"fusion_k{K}", row)
    finally:
        if env_k is not None:
            os.environ["RAFT_TPU_FUSE_K"] = env_k
    rows["note"] = (
        "wall µs/tick of the engine drain loop at the headline shape; "
        "K=1 is the tick-at-a-time baseline (cross-check: the "
        "attribution leg's wall_us_per_tick_observe_off). Submit + "
        "staging pre-pack ride the client side of the wall by design."
    )
    return rows


# ------------------------------------------------ client-observed latency
def bench_client_latency(dev=None) -> dict:
    """What a CLIENT of ``submit_pipelined`` experiences, wall-clock:
    submit -> durable-ack for a full-ring chunk (one K3/K4 flight on the
    card), then the lapped chunk at ``pipeline_max_laps=8``: 8 rings of
    entries in ONE launch of 8·C/B steps, with an ``error`` field when the
    lapped launch is not taken."""
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport import SingleDeviceTransport

    dev = _dev(dev)
    cfg = RaftConfig()                   # the c2 shape
    e = _engine(cfg, dev)
    e.metrics = MetricsRegistry()
    e.run_until_leader()
    rng = np.random.default_rng(7)
    n = cfg.log_capacity                 # one full-ring chunk
    mk = lambda: [rng.integers(0, 256, cfg.entry_bytes, np.uint8).tobytes()
                  for _ in range(n)]
    seqs = e.submit_pipelined(mk())      # warm
    assert e.is_durable(seqs[-1])
    samples = []
    for _ in range(3):
        ps = mk()
        t0 = time.perf_counter()
        seqs = e.submit_pipelined(ps)
        assert e.is_durable(seqs[-1])    # durable-ack fence
        samples.append(time.perf_counter() - t0)
    wall = min(samples)

    # lapped variant: pipeline_max_laps rings per launch
    LAPS = 8
    cfg_l = RaftConfig(pipeline_max_laps=LAPS)
    tl = SingleDeviceTransport(cfg_l, device=dev)
    launches = []
    _orig_pipe = tl.replicate_pipeline

    def counting(state, payloads, counts, *a, **k):
        launches.append(int(counts.shape[0]))
        return _orig_pipe(state, payloads, counts, *a, **k)

    tl.replicate_pipeline = counting
    el = RaftEngine(cfg_l, tl)
    el.run_until_leader()
    big = LAPS * cfg_l.log_capacity
    T_lap = LAPS * (cfg_l.log_capacity // cfg_l.batch_size)
    mk_big = lambda: [rng.integers(0, 256, cfg_l.entry_bytes,
                                   np.uint8).tobytes() for _ in range(big)]
    seqs = el.submit_pipelined(mk_big())     # warm
    assert el.is_durable(seqs[-1])
    lap_samples = []
    lap_error = None
    for _ in range(2):
        ps = mk_big()
        launches.clear()
        t0 = time.perf_counter()
        seqs = el.submit_pipelined(ps)
        assert el.is_durable(seqs[-1])
        if launches != [T_lap]:
            # the amortization claim holds only if the backlog rode ONE
            # lapped launch: a fallback surfaces as an error field
            lap_error = f"lapped launch not taken: launches={launches}"
            break
        lap_samples.append(time.perf_counter() - t0)
    if lap_error is None:
        lwall = min(lap_samples)
        lapped = {
            "laps": LAPS,
            "chunk_entries": big,
            "chunk_wall_ms": round(lwall * 1e3, 1),
            "wall_us_per_entry": round(lwall * 1e6 / big, 3),
            "entries_per_sec_wall": round(big / lwall, 1),
        }
    else:
        lapped = {"laps": LAPS, "error": lap_error}
    return {
        "chunk_entries": n,
        "chunk_wall_ms": round(wall * 1e3, 1),
        "wall_us_per_entry": round(wall * 1e6 / n, 3),
        "entries_per_sec_wall": round(n / wall, 1),
        "lapped_chunk": lapped,
        "metrics": e.metrics.to_json(),
        "note": ("submit->durable-ack wall incl. host durability "
                 "bookkeeping; the device-time rows measure the kernels "
                 "only"),
    }


# ----------------------------------------------------- batched ReadIndex
def bench_read_index(dev=None) -> dict:
    """Linearizable read throughput at sustained write load: serial
    ``read_linearizable`` pays one empty replication round per read, while
    ``submit_read`` queues ride the write ticks' own rounds (confirmation
    is free). Reads/s wall for both modes, plus the rounds the batched
    mode added (must be 0)."""
    dev = _dev(dev)
    cfg = RaftConfig(
        n_replicas=3, entry_bytes=256, batch_size=64, log_capacity=1 << 12,
        transport="single", seed=4,
    )
    e = _engine(cfg, dev)
    e.metrics = MetricsRegistry()
    e.run_until_leader()
    rng = np.random.default_rng(0)

    def write_round():
        seqs = [e.submit(rng.integers(0, 256, 256, np.uint8).tobytes())
                for _ in range(16)]
        e.run_until_committed(seqs[-1])

    write_round()                        # warm
    K = 32
    t0 = time.perf_counter()
    for i in range(K):
        if i % 8 == 0:
            write_round()
        e.read_linearizable()
    serial_s = time.perf_counter() - t0
    calls = [0]
    orig = e.t.replicate

    def counting(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    e.t.replicate = counting
    KB = 4096
    t0 = time.perf_counter()
    done = 0
    while done < KB:
        tickets = [e.submit_read() for _ in range(512)]
        write_round()                    # the tick confirms the queue
        base_rounds = calls[0]
        for tk in tickets:
            assert e.read_confirmed(tk) is not None
        assert calls[0] == base_rounds   # confirmation added no rounds
        done += len(tickets)
    batched_s = time.perf_counter() - t0
    e.t.replicate = orig
    return {
        "serial_reads_per_sec": round(K / serial_s, 1),
        "batched_reads_per_sec": round(KB / batched_s, 1),
        "batched_extra_rounds": 0,
        "metrics": e.metrics.to_json(),
        "note": ("batched reads confirm on the write ticks' rounds; "
                 "batched wall time includes the write traffic itself"),
    }


# ------------------------------------------------- read scale-out sweep
def bench_read_scale(dev=None) -> dict:
    """Read scale-out: a 90%-read mix over Zipf-skewed keys, one row per
    read class (wall reads/s, per-read wall p50/p99). ``read_index`` pays
    one confirmation round per read; ``lease`` serves locally with ZERO
    rounds (asserted); ``follower`` and ``session`` ride a Router over a
    4-group MultiEngine."""
    from raft_tpu_torch.multi import MultiEngine, ReadSession, Router

    dev = _dev(dev)
    N_OPS = 1200
    WRITE_EVERY = 10              # 90% reads / 10% writes
    ZIPF_S = 1.2
    N_KEYS = 64

    def zipf_keys(seed: int) -> list:
        rng = np.random.default_rng(seed)
        ranks = np.minimum(rng.zipf(ZIPF_S, N_OPS), N_KEYS) - 1
        return [b"k%03d" % int(r) for r in ranks]

    def single_row(lease: bool):
        cfg = RaftConfig(
            n_replicas=3, entry_bytes=64, batch_size=64,
            log_capacity=1 << 11, transport="single", seed=7,
            prevote=lease, read_lease=lease,
        )
        e = _engine(cfg, dev)
        e.run_until_leader()
        payload = bytes(cfg.entry_bytes)
        seqs = [e.submit(payload) for _ in range(16)]
        e.run_until_committed(seqs[-1])     # warm + first-term commit
        e.read_linearizable()               # warm the read program
        rounds = [0]
        orig = e.t.replicate

        def counting(*a, **k):
            rounds[0] += 1
            return orig(*a, **k)

        e.t.replicate = counting
        lat: list = []
        pending: list = []
        t_all = time.perf_counter()
        for i in range(N_OPS):
            if i % WRITE_EVERY == 0:
                pending.append(e.submit(payload))
                if len(pending) >= 16:
                    e.run_until_committed(pending[-1])
                    pending.clear()
            else:
                t0 = time.perf_counter()
                e.read_linearizable()
                lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_all
        e.t.replicate = orig
        n_reads = len(lat)
        lat_us = np.asarray(lat) * 1e6
        row = {
            "reads": n_reads,
            "write_fraction": round(1.0 / WRITE_EVERY, 3),
            "reads_per_sec": round(n_reads / wall, 1),
            "read_p50_us": round(float(np.percentile(lat_us, 50)), 2),
            "read_p99_us": round(float(np.percentile(lat_us, 99)), 2),
            "read_rounds": rounds[0] - _commit_rounds[0],
        }
        return row, e

    # reads' extra rounds = total rounds - the rounds the same write
    # schedule costs with NO reads at all (measured once below)
    _commit_rounds = [0]

    def write_only_rounds() -> int:
        cfg = RaftConfig(
            n_replicas=3, entry_bytes=64, batch_size=64,
            log_capacity=1 << 11, transport="single", seed=7,
        )
        e = _engine(cfg, dev)
        e.run_until_leader()
        payload = bytes(cfg.entry_bytes)
        seqs = [e.submit(payload) for _ in range(16)]
        e.run_until_committed(seqs[-1])
        calls = [0]
        orig = e.t.replicate

        def counting(*a, **k):
            calls[0] += 1
            return orig(*a, **k)

        e.t.replicate = counting
        pending = []
        for i in range(N_OPS):
            if i % WRITE_EVERY == 0:
                pending.append(e.submit(payload))
                if len(pending) >= 16:
                    e.run_until_committed(pending[-1])
                    pending.clear()
        e.t.replicate = orig
        return calls[0]

    _commit_rounds[0] = write_only_rounds()
    rows = {}
    base_row, _ = single_row(lease=False)
    base_row["read_rounds_extra"] = base_row.pop("read_rounds")
    rows["read_index"] = _emit_leg("read_scale_read_index", base_row)
    lease_row, eng = single_row(lease=True)
    extra = lease_row.pop("read_rounds")
    lease_row["read_rounds_extra"] = extra
    lease_row["lease_serves"] = eng.read_class_counts.get("lease", 0)
    lease_row["speedup_vs_read_index"] = round(
        lease_row["reads_per_sec"] / max(base_row["reads_per_sec"], 1e-9),
        2,
    )
    assert extra == 0, (
        f"lease reads paid {extra} replication rounds (must be 0)"
    )
    rows["lease"] = _emit_leg("read_scale_lease", lease_row)

    # ---- router rows: follower spread + session tokens --------------
    cfg = RaftConfig(
        n_replicas=3, entry_bytes=64, batch_size=64,
        log_capacity=1 << 11, transport="single", seed=7,
        prevote=True, read_lease=True,
    )
    eng = MultiEngine(cfg, 4, device=dev)
    eng.seed_leaders()
    router = Router(eng)
    keys = zipf_keys(1)
    payload = bytes(cfg.entry_bytes)
    for g in range(4):
        for _ in range(32):
            eng.submit(g, payload)
    eng.run_for(20.0)
    for mode in ("follower", "session"):
        session = ReadSession()
        served_by: dict = {}
        lat = []
        t_all = time.perf_counter()
        w = 0
        for i, key in enumerate(keys):
            if i % WRITE_EVERY == 0:
                g, _ = router.submit(key, payload)
                w += 1
                if w % 16 == 0:
                    eng.run_for(3 * cfg.heartbeat_period)
                continue
            t0 = time.perf_counter()
            if mode == "session":
                router.read_session(key, session)
            else:
                g, r, _, _cls = router.read_any(key)
                served_by[r] = served_by.get(r, 0) + 1
            lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_all
        lat_us = np.asarray(lat) * 1e6
        row = {
            "reads": len(lat),
            "groups": 4,
            "write_fraction": round(1.0 / WRITE_EVERY, 3),
            "zipf_s": ZIPF_S,
            "reads_per_sec": round(len(lat) / wall, 1),
            "read_p50_us": round(float(np.percentile(lat_us, 50)), 2),
            "read_p99_us": round(float(np.percentile(lat_us, 99)), 2),
        }
        if mode == "follower":
            row["served_by_replica"] = {
                str(r): n for r, n in sorted(served_by.items())
            }
            row["replicas_serving"] = len(served_by)
        rows[mode] = _emit_leg(f"read_scale_{mode}", row)
    rows["classes"] = {
        "by_class": {
            cls: sum(cc.get(cls, 0) for cc in eng.read_class_counts)
            for cls in ("lease", "follower", "session", "read_index")
        },
    }
    return rows


# ------------------------------------------------------ overload sweep
def bench_overload(dev=None) -> dict:
    """Offered-load sweep: open-loop Poisson arrivals at 1x / 2x / 5x the
    cluster's ingest capacity against an admission-gated engine on the
    VIRTUAL clock: goodput, shed rate, p50/p99 admission queue delay. The
    rows measure the admission POLICY and are deterministic."""
    import random as _random

    from raft_tpu_torch.chaos.runner import poisson
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport import SingleDeviceTransport

    dev = _dev(dev)
    cfg = RaftConfig(
        n_replicas=3, entry_bytes=64, batch_size=64, log_capacity=1 << 11,
        transport="single", seed=11,
        admission_max_writes=256, admission_max_reads=1024,
        admission_target_delay_s=4.0, admission_interval_s=20.0,
    )
    t = SingleDeviceTransport(cfg, device=dev)   # shared by the rows
    capacity = cfg.batch_size / cfg.heartbeat_period
    window_s = 240.0
    payload = bytes(cfg.entry_bytes)
    rows = {}
    for mult in (1, 2, 5):
        e = RaftEngine(cfg, t)
        e.metrics = MetricsRegistry()
        e.run_until_leader()
        rng = _random.Random(f"bench-overload:{mult}")
        slice_s = cfg.heartbeat_period
        offered = shed = 0
        t0v = e.clock.now
        while e.clock.now < t0v + window_s:
            for _ in range(poisson(rng, mult * capacity * slice_s)):
                offered += 1
                try:
                    e.submit(payload)
                except Overloaded:
                    shed += 1
            e.run_for(slice_s)
        elapsed = e.clock.now - t0v
        rep = e.admission.report(queue_depth=len(e._queue))
        rows[f"x{mult}"] = _emit_leg(f"overload_x{mult}", {
            "rate_mult": mult,
            "capacity_eps": capacity,
            "offered": offered,
            "shed": shed,
            "shed_rate": round(shed / max(offered, 1), 4),
            "goodput_eps": round(len(e.commit_time) / elapsed, 2),
            "queue_delay_p50_s": round(rep.queue_delay_p50_s, 3),
            "queue_delay_p99_s": round(rep.queue_delay_p99_s, 3),
            "depth_high_water": rep.depth_high_water,
            "depth_bound": rep.max_writes,
            "shed_by_reason": rep.shed,
            "virtual_window_s": window_s,
            "metrics": e.metrics.to_json(),
        })
    return rows


# ---------------------------------------------------- reconfiguration leg
def bench_reconfig(dev=None) -> dict:
    """Membership-change costs on the VIRTUAL clock: ``wipe_logN`` rows
    (time-to-promote a WIPED voter back through the replace ladder with a
    TIERED archive and foreground writes flowing; ``wipe_ladder``'s
    ``flat_ratio`` = rejoin(4096) / rejoin(256)), and ``latency_dip``:
    p50/p99 commit latency in a baseline window vs during a learner-first
    grow and a shrink."""
    import tempfile

    dev = _dev(dev)
    rows = {}

    rejoin_by_len = {}
    for log_len in (64, 256, 1024, 4096):
        cfg = RaftConfig(
            n_replicas=3, max_replicas=4, entry_bytes=64, batch_size=16,
            log_capacity=256, transport="single", seed=21,
            tiered_log_dir=tempfile.mkdtemp(prefix="bench_tier_"),
            tiered_hot_entries=128,   # < capacity: the catch-up stream's
            #   base reads SEALED segments
            segment_entries=64,
        )
        e = _engine(cfg, dev)
        e.run_until_leader()
        payload = bytes(cfg.entry_bytes)
        s_add = e.add_voter(3)        # row 3 joins (empty) as a voter...
        e.run_until_committed(s_add, limit=4000.0)
        seqs = e.submit_pipelined([payload] * log_len)
        e.run_until_committed(seqs[-1], limit=80000.0)

        def pump(seconds: float, rate_eps: float) -> float:
            """Open-loop foreground writes at ``rate_eps`` for ``seconds``
            virtual seconds; returns goodput over the window."""
            t0, n0 = e.clock.now, e.committed_total
            acc = 0.0
            while e.clock.now < t0 + seconds:
                acc += rate_eps * cfg.heartbeat_period
                while acc >= 1.0:
                    e.submit(payload)
                    acc -= 1.0
                e.run_for(cfg.heartbeat_period)
            dt = e.clock.now - t0
            return (e.committed_total - n0) / dt if dt > 0 else 0.0

        rate = 0.5 * cfg.batch_size / cfg.heartbeat_period
        goodput_base = pump(120.0, rate)
        e.fail(3)                     # ...then loses its disk entirely
        e.wipe(3)
        t0v, t0w = e.clock.now, time.monotonic()
        chunks0 = e._shipper.chunks_total
        e.replace(3, 3)
        removed = False
        n0 = e.committed_total
        while e.clock.now < t0v + 20000.0:
            if not e.member[3]:
                removed = True        # the removal half committed
                if not e.alive[3]:
                    e.recover(3)      # rejoin under the fresh identity
            if removed and e.member[3]:
                break                 # ...and the promotion landed
            pump(4 * cfg.heartbeat_period, rate)
        rejoin_s = e.clock.now - t0v
        goodput_catchup = (e.committed_total - n0) / max(rejoin_s, 1e-9)
        tier = e.store.tier_summary()
        seal_eps = (
            tier["entries_sealed"] / tier["seal_wall_s"]
            if tier["seal_wall_s"] > 0 else None
        )
        rejoin_by_len[log_len] = rejoin_s
        rows[f"wipe_log{log_len}"] = _emit_leg(f"reconfig_log{log_len}", {
            "log_entries": log_len,
            "rejoined": bool(removed and e.member[3]),
            "rejoin_virtual_s": round(rejoin_s, 1),
            "rejoin_wall_ms": round(
                1e3 * (time.monotonic() - t0w), 1
            ),
            "via_snapshot": log_len > cfg.log_capacity,
            "catchup_chunks": e._shipper.chunks_total - chunks0,
            "segments_sealed": tier["segments_sealed"],
            "entries_sealed": tier["entries_sealed"],
            "seal_entries_per_sec": (
                round(seal_eps, 1) if seal_eps is not None else None
            ),
            "segment_reconstructs": tier["segment_reconstructs"],
            "tier_host_bytes": tier["host_bytes"],
            "goodput_baseline_eps": round(goodput_base, 2),
            "goodput_catchup_eps": round(goodput_catchup, 2),
            "catchup_goodput_ratio": round(
                goodput_catchup / goodput_base, 3
            ) if goodput_base > 0 else None,
        })
    if 256 in rejoin_by_len and 4096 in rejoin_by_len \
            and rejoin_by_len[256] > 0:
        rows["wipe_ladder"] = _emit_leg("reconfig_wipe_ladder", {
            "flat_ratio": round(
                rejoin_by_len[4096] / rejoin_by_len[256], 3
            ),
            "rejoin_s_by_log": {
                str(k): round(v, 1) for k, v in rejoin_by_len.items()
            },
            "note": ("flat_ratio = rejoin(log 4096) / rejoin(log 256), "
                     "virtual seconds; pinned <= 1.5: rejoin cost bounded "
                     "by ring capacity + chunk rate, not history length"),
        })

    # -- commit-latency dip during grow / shrink ------------------------
    cfg = RaftConfig(
        n_replicas=3, max_replicas=5, entry_bytes=64, batch_size=16,
        log_capacity=256, transport="single", seed=22,
    )
    e = _engine(cfg, dev)
    e.run_until_leader()
    payload = bytes(cfg.entry_bytes)

    def pump_dip(seconds, bucket, until=None):
        t_end = e.clock.now + seconds
        while e.clock.now < t_end and (until is None or not until()):
            bucket.append(e.submit(payload))
            e.run_for(cfg.heartbeat_period)

    base, grow, shrink = [], [], []
    pump_dip(120.0, base)
    e.add_server(3)                              # learner-first grow
    pump_dip(2000.0, grow, until=lambda: bool(e.member[3]))
    victim = next(r for r in range(cfg.rows)
                  if e.member[r] and r != e.leader_id)
    s_rm = e.remove_server(victim)
    pump_dip(2000.0, shrink, until=lambda: e.is_durable(s_rm))
    pump_dip(30.0, shrink)                       # post-commit settling
    e.run_for(120.0)                             # drain commits

    def pcts(bucket):
        lats = [
            e.commit_time[s] - e.submit_time[s]
            for s in bucket if s in e.commit_time
        ]
        if not lats:
            return {"p50_s": None, "p99_s": None, "n": 0}
        p50, p99 = _percentiles(lats)
        return {"p50_s": round(p50, 3), "p99_s": round(p99, 3),
                "n": len(lats)}

    rows["latency_dip"] = _emit_leg("reconfig_latency_dip", {
        "baseline": pcts(base),
        "during_grow": pcts(grow),
        "during_shrink": pcts(shrink),
        "note": ("per-window p50/p99 commit latency (virtual s) of "
                 "steady 1-entry-per-tick traffic; grow window spans "
                 "learner attach -> promotion commit, shrink window "
                 "spans removal submit -> commit + 30 s"),
    })
    return rows


# ---------------------------------------------------- macro (wire) leg
def bench_macro(dev=None) -> dict:
    """The end-to-end SERVICE numbers: the same engine stack as a library
    (in-process ``Router.submit``) and as a service (the ``net`` loopback
    TCP tier):

    - ``macro_inproc``: per-entry ``Router.submit`` + drive until
      durable, wall goodput.
    - ``macro_wire``: the same shape over real TCP with batched ingest
      (``SUBMIT_BATCH`` frames, many pipelined connections): goodput,
      per-batch e2e p50/p99, shed rate, ``wire_goodput_ratio``.
    - ``macro_wire_traced``: a bracketed untraced / traced / untraced
      trio (``tracing_overhead_ratio``) and the ``PumpProfiler`` phases.
    - ``macro_leader_kill``: single-op open-loop arrivals at 2x the
      measured capacity, Zipf(1.2) keys, 15% reads, the hottest group's
      leader killed mid-window and recovered at 3/4."""
    import asyncio
    import random as _random

    from raft_tpu_torch.multi.engine import MultiEngine
    from raft_tpu_torch.multi.router import Router
    from raft_tpu_torch.net import (
        IngestServer,
        RouterBackend,
        WireClient,
        WireRefused,
    )
    from raft_tpu_torch.net.client import WireDisconnected, WireError

    dev = _dev(dev)
    G, N, B, CONNS = 4, 16384, 64, 16
    cfg = RaftConfig(
        n_replicas=3, entry_bytes=64, batch_size=B,
        log_capacity=1 << 11, transport="single", seed=11,
        admission_max_writes=512,
    )
    payload = bytes(cfg.entry_bytes)
    keys = [b"mk%d" % i for i in range(64)]
    rows: dict = {}

    def fresh_stack():
        eng = MultiEngine(cfg, G, device=dev)
        eng.seed_leaders()
        return eng

    # ---- warmup: the shared per-rows programs, once
    weng = fresh_stack()
    wrouter = Router(weng)
    for i in range(2 * B):
        wrouter.submit(keys[i % len(keys)], payload)
    weng.run_for(4 * cfg.heartbeat_period)

    # ---- row 1: the in-process library baseline ------------------------
    eng = fresh_stack()
    router = Router(eng)
    t0 = time.perf_counter()
    last = {}
    submitted = 0
    while submitted < N:
        for _ in range(4 * B):
            if submitted >= N:
                break
            g, seq = router.submit(keys[submitted % len(keys)], payload)
            last[g] = seq
            submitted += 1
        eng.run_for(cfg.heartbeat_period)
    while not all(eng.is_durable(g, s) for g, s in last.items()):
        eng.run_for(cfg.heartbeat_period)
    inproc_wall = time.perf_counter() - t0
    inproc_eps = N / inproc_wall
    rows["inproc"] = _emit_leg("macro_inproc", {
        "entries": N,
        "groups": G,
        "wall_s": round(inproc_wall, 3),
        "goodput_eps": round(inproc_eps, 1),
        "batch": B,
        "entry_bytes": cfg.entry_bytes,
    })

    # ---- row 2: the wire, batched ingest -------------------------------
    eng = fresh_stack()
    backend = RouterBackend(Router(eng, drive=False))

    async def wire_row() -> dict:
        srv = IngestServer(backend,
                           drive_quantum_s=cfg.heartbeat_period)
        port = await srv.start()
        cs = [await WireClient("127.0.0.1", port).connect()
              for _ in range(CONNS)]
        lats: list = []
        sheds = [0]
        t0 = time.perf_counter()

        async def worker(c, share):
            acked = 0
            for j in range(max(share // B, 1)):
                items = [(keys[(j * B + i) % len(keys)], payload)
                         for i in range(B)]
                b0 = time.perf_counter()
                r = await c.submit_many(items)
                lats.append((time.perf_counter() - b0) * 1e3)
                acked += r.accepted
                sheds[0] += r.shed
            return acked

        acked = sum(await asyncio.gather(
            *[worker(c, N // CONNS) for c in cs]
        ))
        wall = time.perf_counter() - t0
        for c in cs:
            await c.close()
        stats = srv.stats()
        await srv.stop()
        p50, p99 = _percentiles(lats)
        offered = acked + sheds[0]
        return {
            "entries": acked,
            "connections": CONNS,
            "wire_batch": B,
            "wall_s": round(wall, 3),
            "goodput_eps": round(acked / wall, 1),
            "wire_goodput_ratio": round(acked / wall / inproc_eps, 3),
            "e2e_p50_ms": round(p50, 2),
            "e2e_p99_ms": round(p99, 2),
            "shed_rate": round(sheds[0] / max(offered, 1), 4),
            "net_bytes_in": stats["bytes_in"],
            "net_bytes_out": stats["bytes_out"],
            "net_requests": stats["requests_total"],
        }

    wire_row_out = asyncio.run(wire_row())
    rows["wire"] = _emit_leg("macro_wire", wire_row_out)
    wire_eps = wire_row_out["goodput_eps"]

    # ---- row 2b: tracing overhead + pump attribution, bracketed --------
    def wire_window(traced: bool, n_entries: int):
        """One wire goodput window at the row-2 shape; ``traced=True``
        arms the FULL trace plane (client spans + ctx propagation, server
        span adoption, pump profiler, registry)."""
        eng = fresh_stack()
        backend = RouterBackend(Router(eng, drive=False))
        srv_kw: dict = {}
        cli_kw: dict = {}
        plane: dict = {}
        if traced:
            from raft_tpu_torch.obs.hostprof import PumpProfiler
            from raft_tpu_torch.obs.spans import SpanTracker

            sspans = SpanTracker()
            cspans = SpanTracker()
            reg = MetricsRegistry()
            pump = PumpProfiler(registry=reg)
            eng.spans = sspans
            srv_kw = dict(spans=sspans, registry=reg, pump=pump)
            cli_kw = dict(spans=cspans)
            plane = {"sspans": sspans, "cspans": cspans}

        async def run():
            srv = IngestServer(backend,
                               drive_quantum_s=cfg.heartbeat_period,
                               **srv_kw)
            port = await srv.start()
            cs = [await WireClient("127.0.0.1", port,
                                   **cli_kw).connect()
                  for _ in range(CONNS)]
            t0 = time.perf_counter()

            async def worker(c, share):
                acked = 0
                for j in range(max(share // B, 1)):
                    items = [(keys[(j * B + i) % len(keys)], payload)
                             for i in range(B)]
                    r = await c.submit_many(items)
                    acked += r.accepted
                return acked

            acked = sum(await asyncio.gather(
                *[worker(c, n_entries // CONNS) for c in cs]
            ))
            wall = time.perf_counter() - t0
            for c in cs:
                await c.close()
            stats = srv.stats()
            await srv.stop()
            return acked, wall, stats

        acked, wall, stats = asyncio.run(run())
        extras = {}
        if traced:
            extras = {
                "pump": stats.get("pump") or {},
                "client_spans": len(plane["cspans"].spans),
                "server_spans": len(plane["sspans"].spans),
            }
        return acked / wall, extras

    N2 = N // 2
    # one throwaway warm window, then ALTERNATING off/on brackets
    wire_window(False, N2)
    off1, _ = wire_window(False, N2)
    on1, tr = wire_window(True, N2)
    off2, _ = wire_window(False, N2)
    on2, _ = wire_window(True, N2)
    off3, _ = wire_window(False, N2)
    traced_eps = (on1 + on2) / 2.0
    untraced_eps = (off1 + off2 + off3) / 3.0
    pump = tr["pump"]
    cb, qa = pump.get("coalesce_batch", {}), pump.get("queue_age_us", {})
    rows["wire_traced"] = _emit_leg("macro_wire_traced", {
        "entries": N2,
        "connections": CONNS,
        "wire_batch": B,
        "traced_goodput_eps": round(traced_eps, 1),
        "untraced_goodput_eps": round(untraced_eps, 1),
        "tracing_overhead_ratio": round(traced_eps / untraced_eps, 4),
        "pump_iters": pump.get("iters"),
        "pump_coverage": pump.get("coverage"),
        "pump_us_per_iter": pump.get("us_per_iter"),
        "coalesce_batch_p50": cb.get("p50"),
        "coalesce_batch_p99": cb.get("p99"),
        "queue_age_p50_us": qa.get("p50"),
        "queue_age_p99_us": qa.get("p99"),
        "client_spans": tr["client_spans"],
        "server_spans": tr["server_spans"],
    })

    # ---- row 3: leader kill at 2x capacity, open-loop ------------------
    eng = fresh_stack()
    router3 = Router(eng, drive=False)
    backend3 = RouterBackend(router3)

    async def kill_row() -> dict:
        """Open-loop batched arrivals at 2x the MEASURED wire goodput,
        Zipf-skewed keys, a 15% single-op linearizable read stream, the
        hottest group's leader killed mid-window and recovered at 3/4."""
        srv = IngestServer(backend3,
                           drive_quantum_s=cfg.heartbeat_period,
                           max_pending=1024)
        port = await srv.start()
        conns = [
            await WireClient(
                "127.0.0.1", port, retries=2, base_backoff_s=0.001,
                max_backoff_s=0.01,
                rng=_random.Random(f"macro-kill:{i}"),
            ).connect()
            for i in range(16)
        ]
        rate_eps = 2.0 * wire_eps           # the "2x capacity" shape
        n_frames = min(int(rate_eps * 2.0 / B), 1024)   # ~2 s window
        n_reads = max(int(n_frames * 0.15), 1)
        zrng = np.random.default_rng(11)
        zipf_ids = (zrng.zipf(1.2, n_frames) - 1) % len(keys)
        lats: list = []
        read_lats: list = []
        shed = [0]
        acked_entries = [0]
        unknown = [0]
        tasks: list = []
        kills = []

        async def one_batch(i: int) -> None:
            c = conns[i % len(conns)]
            hot = keys[int(zipf_ids[i])]
            items = [(hot if k % 4 else keys[(i + k) % len(keys)],
                      payload) for k in range(B)]
            a0 = time.perf_counter()
            try:
                r = await c.submit_many(items)
            except WireRefused:
                shed[0] += B        # whole frame refused before ingest
            except (WireDisconnected, WireError):
                unknown[0] += B
            else:
                shed[0] += r.shed
                acked_entries[0] += r.accepted
                lats.append((time.perf_counter() - a0) * 1e3)

        async def one_read(j: int) -> None:
            c = conns[j % len(conns)]
            a0 = time.perf_counter()
            try:
                await c.read(keys[int(zrng.zipf(1.2) - 1) % len(keys)])
            except (WireRefused, WireDisconnected, WireError):
                shed[0] += 1
            else:
                read_lats.append((time.perf_counter() - a0) * 1e3)

        t0 = time.perf_counter()
        pace = 8                 # frames scheduled per pacing slice
        interval = pace * B / rate_eps
        next_t = t0
        issued = reads_issued = 0
        while issued < n_frames:
            nf = min(pace, n_frames - issued)
            tasks.extend(asyncio.ensure_future(one_batch(issued + k))
                         for k in range(nf))
            issued += nf
            while reads_issued * n_frames < n_reads * issued:
                tasks.append(asyncio.ensure_future(
                    one_read(reads_issued)
                ))
                reads_issued += 1
            if not kills and issued >= n_frames // 2:
                # kill the hottest group's leader mid-window
                g = router3.group_of(keys[0])
                lead = eng.leader_id[g]
                if lead is not None:
                    eng.fail(g, lead)
                    kills.append((g, lead))
            elif kills and len(kills) == 1 and issued >= 3 * n_frames // 4:
                g, lead = kills[0]
                eng.recover(g, lead)
                kills.append(("recovered", lead))
            # absolute-schedule pacing with catch-up
            next_t += interval
            delay = next_t - time.perf_counter()
            await asyncio.sleep(delay if delay > 0 else 0)
        t_gen = time.perf_counter() - t0     # arrival-generation window
        await asyncio.gather(*tasks)
        wall = time.perf_counter() - t0
        for c in conns:
            await c.close()
        stats = srv.stats()
        await srv.stop()
        p50, p99 = _percentiles(lats)
        rp50, rp99 = _percentiles(read_lats)
        offered = n_frames * B + reads_issued
        acked = acked_entries[0] + len(read_lats)
        bound = cfg.admission_max_writes
        hw = int(max(eng.depth_high_water))
        return {
            "offered_entries": offered,
            "target_x_capacity": 2.0,
            "offered_x_capacity": round(
                (offered / max(t_gen, 1e-9)) / max(wire_eps, 1e-9), 2
            ),
            "offered_x_goodput": round(
                (offered / max(t_gen, 1e-9))
                / max(acked / max(wall, 1e-9), 1e-9), 2
            ),
            "wire_capacity_eps": wire_eps,
            "connections": len(conns),
            "wire_batch": B,
            "reads_issued": reads_issued,
            "leader_killed": bool(kills),
            "leader_recovered": len(kills) == 2,
            "shed": shed[0],
            "shed_rate": round(shed[0] / max(offered, 1), 4),
            "outcome_unknown": unknown[0],
            "goodput_eps": round(acked / wall, 1),
            "e2e_p50_ms": round(p50, 2),
            "e2e_p99_ms": round(p99, 2),
            "read_p50_ms": round(rp50, 2),
            "read_p99_ms": round(rp99, 2),
            "depth_high_water": hw,
            "depth_bound": bound,
            "depth_bound_held": hw <= bound,
            "wire_refusals": stats["refusals"],
            "wall_s": round(wall, 3),
        }

    rows["leader_kill"] = _emit_leg(
        "macro_leader_kill", asyncio.run(kill_row())
    )
    return rows


# -------------------------------------------------- txn wire macro leg
def bench_txn(dev=None) -> dict:
    """Cross-group transactions on the wire: the macro wire shape with the
    2PC coordinator attached and a 90/10 single-key / transaction mix
    through the batched ingest pump. A transaction is a validated
    two-account transfer (read both, expect both, write both); a
    single-key request is a B-entry ``SUBMIT_BATCH`` frame. Txn commit
    p50/p99, committed-txn goodput, the abort rate (workload contention,
    reported ungated) and the single-key goodput beside them."""
    import asyncio
    import random as _random

    from raft_tpu_torch.multi.engine import MultiEngine
    from raft_tpu_torch.multi.router import Router
    from raft_tpu_torch.net import (
        IngestServer,
        RouterBackend,
        WireClient,
        WireRefused,
    )
    from raft_tpu_torch.net.client import WireDisconnected, WireError
    from raft_tpu_torch.txn import TxnCoordinator, TxnShardedKV

    dev = _dev(dev)
    G, B, CONNS, REQS, ACCOUNTS = 4, 64, 8, 30, 16
    cfg = RaftConfig(
        n_replicas=3, entry_bytes=64, batch_size=B,
        log_capacity=1 << 11, transport="single", seed=17,
        admission_max_writes=512,
    )
    # the wire re-encodes each write as a typed KV op inside the entry:
    # half-size values keep room for the op header + key
    payload = bytes(cfg.entry_bytes // 2)
    keys = [b"mk%d" % i for i in range(64)]
    accounts = [b"ta%d" % i for i in range(ACCOUNTS)]

    eng = MultiEngine(cfg, G, device=dev)
    router = Router(eng, drive=False)
    skv = TxnShardedKV(eng, router)
    eng.seed_leaders()
    coord = TxnCoordinator(skv, decision_group=0)

    txn_lats: list = []
    committed = [0]
    aborted = [0]
    txn_refused = [0]
    txn_unknown = [0]
    single_acked = [0]
    single_shed = [0]

    async def run_leg():
        srv = IngestServer(RouterBackend(router, skv), txn=coord,
                           drive_quantum_s=cfg.heartbeat_period)
        port = await srv.start()
        cs = [
            await WireClient(
                "127.0.0.1", port, txn=True,
                rng=_random.Random(f"bench-txn:{i}"),
            ).connect()
            for i in range(CONNS)
        ]
        for i, a in enumerate(accounts):
            await cs[i % CONNS].submit(a, b"100")

        async def one_txn(c, rng) -> None:
            src, dst = rng.sample(range(ACCOUNTS), 2)
            ka, kb = accounts[src], accounts[dst]
            try:
                va = (await c.read(ka)).value or b"0"
                vb = (await c.read(kb)).value or b"0"
            except (WireRefused, WireDisconnected, WireError):
                txn_refused[0] += 1
                return
            amt = 1 + rng.randrange(5)
            t0 = time.perf_counter()
            try:
                r = await c.txn_commit(
                    [(ka, b"%d" % (int(va) - amt)),
                     (kb, b"%d" % (int(vb) + amt))],
                    expects=[(ka, va), (kb, vb)],
                )
            except WireRefused:
                txn_refused[0] += 1
                return
            except (WireDisconnected, WireError):
                txn_unknown[0] += 1
                return
            txn_lats.append((time.perf_counter() - t0) * 1e3)
            if r.status == "committed":
                committed[0] += 1
            else:
                aborted[0] += 1

        async def one_frame(c, j: int) -> None:
            items = [(keys[(j * B + i) % len(keys)], payload)
                     for i in range(B)]
            try:
                r = await c.submit_many(items)
            except (WireRefused, WireDisconnected, WireError):
                single_shed[0] += B
            else:
                single_acked[0] += r.accepted
                single_shed[0] += r.shed

        async def worker(i: int) -> None:
            c = cs[i]
            rng = _random.Random(f"bench-txn-mix:{i}")
            for j in range(REQS):
                if rng.random() < 0.10:
                    await one_txn(c, rng)
                else:
                    await one_frame(c, j)

        t0 = time.perf_counter()
        await asyncio.gather(*[worker(i) for i in range(CONNS)])
        wall = time.perf_counter() - t0
        for c in cs:
            await c.close()
        await srv.stop()
        return wall

    wall = asyncio.run(run_leg())
    p50, p99 = _percentiles(txn_lats)
    txns = committed[0] + aborted[0]
    return {
        "connections": CONNS,
        "requests": CONNS * REQS,
        "wire_batch": B,
        "groups": G,
        "txns": txns,
        "txn_committed": committed[0],
        "txn_aborted": aborted[0],
        "txn_refused": txn_refused[0],
        "txn_unknown": txn_unknown[0],
        "abort_rate": round(aborted[0] / max(txns, 1), 4),
        "txn_p50_ms": round(p50, 2),
        "txn_p99_ms": round(p99, 2),
        "txn_goodput_eps": round(committed[0] / max(wall, 1e-9), 2),
        "single_entries": single_acked[0],
        "single_shed": single_shed[0],
        "single_goodput_eps": round(
            single_acked[0] / max(wall, 1e-9), 1
        ),
        "lock_conflicts": coord.lock_conflicts,
        "wall_s": round(wall, 3),
    }


# ------------------------------------------------- multi-process cluster
def bench_cluster(dev=None) -> dict:
    """The serving tier AS DEPLOYED: real OS processes, one replica each
    (host code only: the children import no PyTorch and see no GPU), peer
    frames over loopback TCP. Four rows, emitted incrementally:

    - ``cluster_goodput``: N unbatched single-op writes over CONNS
      connections against the 3-process cluster, beside the same shape
      against a single-process wire server on ``dev``.
    - ``cluster_latency``: the same closed loop with 5 ms ± 2 ms injected
      on every PEER link (``cluster/netfault.py``) beside clean loopback.
    - ``cluster_kill9``: open-loop arrivals at 2x the measured capacity
      with the LEADER killed -9 mid-window.
    - ``cluster_handoff``: respawn the victim on its own dirs (manifest
      adoption) vs on a WIPED dir (every segment re-sealed).

    Degrades to a ``{"skipped": "cluster_broken"}`` row where child
    processes cannot run."""
    import asyncio
    import shutil
    import tempfile as _tempfile

    from raft_tpu_torch.cluster import ClusterBroken, ClusterSupervisor
    from raft_tpu_torch.multi.engine import MultiEngine
    from raft_tpu_torch.multi.router import Router
    from raft_tpu_torch.net import (
        IngestServer,
        RouterBackend,
        WireClient,
        WireRefused,
    )
    from raft_tpu_torch.net.client import WireDisconnected, WireError

    dev = _dev(dev)
    NODES, CONNS, N = 3, 6, 900
    keys = [b"bk%d" % i for i in range(32)]
    rows: dict = {}
    _errs = (WireRefused, WireDisconnected, WireError,
             ConnectionError, OSError)

    # ---- single-process reference: the macro_wire stack, unbatched ----
    cfgw = RaftConfig(
        n_replicas=3, entry_bytes=64, batch_size=8,
        log_capacity=1 << 11, transport="single", seed=23,
        admission_max_writes=512,
    )
    payload = bytes(cfgw.entry_bytes)

    async def wire_ref() -> float:
        eng = MultiEngine(cfgw, 4, device=dev)
        eng.seed_leaders()
        srv = IngestServer(RouterBackend(Router(eng, drive=False)),
                           drive_quantum_s=cfgw.heartbeat_period)
        port = await srv.start()
        cs = [await WireClient("127.0.0.1", port).connect()
              for _ in range(CONNS)]
        t0 = time.perf_counter()

        async def w(c, n):
            ok = 0
            for j in range(n):
                try:
                    await c.submit(keys[j % len(keys)], payload)
                    ok += 1
                except _errs:
                    pass
            return ok

        acked = sum(await asyncio.gather(
            *[w(c, N // CONNS) for c in cs]
        ))
        wall = time.perf_counter() - t0
        for c in cs:
            await c.close()
        await srv.stop()
        return acked / max(wall, 1e-9)

    singleproc_eps = asyncio.run(wire_ref())

    # ---- the 3-process cluster --------------------------------------
    base = _tempfile.mkdtemp(prefix="bench-cluster-")
    sup = ClusterSupervisor(
        NODES, base, heartbeat_s=0.05, election_timeout_s=0.4,
        snap_threshold=24, segment_entries=16, hot_entries=32,
    )
    # arm the netfault plan plumbing at boot (an empty plan injects
    # nothing) so the latency row can merge a live peer-RTT fault in
    from raft_tpu_torch.cluster.netfault import write_net_plan
    for i in range(NODES):
        write_net_plan(sup.node_dir(i), {"seed": 23})
    try:
        try:
            sup.start_all()
        except ClusterBroken as ex:
            return {"skipped": "cluster_broken", "error": str(ex)}
        deadline = time.monotonic() + 15.0
        while sup.leader() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        addr_map = sup.addr_map()

        async def connect(i: int) -> WireClient:
            host, _, port = sup.addr(i).rpartition(":")
            return await WireClient(
                host, int(port), retries=40, max_backoff_s=0.25,
                addr_map=addr_map,
            ).connect()

        def commit_of(i: int) -> int:
            st = sup.status(i)
            return int(st["commit"]) if st else 0

        def wait_commit(i: int, target: int, budget_s: float) -> bool:
            end = time.monotonic() + budget_s
            while time.monotonic() < end:
                if sup.alive(i) and commit_of(i) >= target:
                    return True
                time.sleep(0.05)
            return False

        # ---- row 1: goodput ------------------------------------------
        def total_wal_fsyncs() -> int:
            return sum(int((sup.status(i) or {}).get("wal_fsyncs", 0))
                       for i in range(NODES))

        async def goodput_row() -> dict:
            cs = [await connect(i % NODES) for i in range(CONNS)]
            fsyncs0 = total_wal_fsyncs()
            t0 = time.perf_counter()

            async def w(ci, c, n):
                ok = 0
                for j in range(n):
                    try:
                        await c.submit(keys[j % len(keys)],
                                       b"c%d-%d" % (ci, j))
                        ok += 1
                    except _errs:
                        pass
                return ok

            acked = sum(await asyncio.gather(
                *[w(ci, c, N // CONNS) for ci, c in enumerate(cs)]
            ))
            wall = time.perf_counter() - t0
            for c in cs:
                await c.close()
            await asyncio.sleep(0.7)    # one status-publish period
            dsync = max(total_wal_fsyncs() - fsyncs0, 1)
            eps = acked / max(wall, 1e-9)
            return {
                "processes": NODES,
                "connections": CONNS,
                "entries": acked,
                "wall_s": round(wall, 3),
                "wal_fsync_batched": round(NODES * acked / dsync, 2),
                "cluster_goodput_eps": round(eps, 1),
                "singleproc_goodput_eps": round(singleproc_eps, 1),
                "cluster_vs_singleproc": round(
                    eps / max(singleproc_eps, 1e-9), 3
                ),
            }

        rows["goodput"] = _emit_leg("cluster_goodput",
                                    asyncio.run(goodput_row()))
        eps = max(rows["goodput"]["cluster_goodput_eps"], 1.0)

        # ---- row 2: injected peer RTT --------------------------------
        N_LAT = 240

        async def latency_probe() -> dict:
            cs = [await connect(i % NODES) for i in range(CONNS)]
            lats: list = []
            fsyncs0 = total_wal_fsyncs()
            t0 = time.perf_counter()

            async def w(ci, c, n):
                for j in range(n):
                    b0 = time.perf_counter()
                    try:
                        await c.submit(keys[j % len(keys)],
                                       b"L%d-%d" % (ci, j))
                    except _errs:
                        continue
                    lats.append((time.perf_counter() - b0) * 1e3)

            await asyncio.gather(
                *[w(ci, c, N_LAT // CONNS) for ci, c in enumerate(cs)]
            )
            wall = time.perf_counter() - t0
            for c in cs:
                await c.close()
            await asyncio.sleep(0.7)    # one status-publish period
            dsync = max(total_wal_fsyncs() - fsyncs0, 1)
            p50, p99 = _percentiles(lats)
            return {
                "acked": len(lats),
                "eps": len(lats) / max(wall, 1e-9),
                "p50_ms": p50, "p99_ms": p99,
                "fsync_batched": NODES * len(lats) / dsync,
            }

        clean = asyncio.run(latency_probe())
        # 5 ms +/- 2 ms per peer hop, peer links only
        sup.net_fault({"delay_ms": 5, "jitter_ms": 2})
        time.sleep(0.3)                 # children poll the plan ~50 ms
        rtt = asyncio.run(latency_probe())
        sup.net_fault({"delay_ms": None, "jitter_ms": None})
        time.sleep(0.3)
        rows["latency"] = _emit_leg("cluster_latency", {
            "injected_peer_delay_ms": 5,
            "injected_peer_jitter_ms": 2,
            "clean_goodput_eps": round(clean["eps"], 1),
            "cluster_rtt_goodput_eps": round(rtt["eps"], 1),
            "rtt_vs_clean": round(
                rtt["eps"] / max(clean["eps"], 1e-9), 3),
            "clean_e2e_p50_ms": round(clean["p50_ms"], 2),
            "clean_e2e_p99_ms": round(clean["p99_ms"], 2),
            "e2e_p50_ms": round(rtt["p50_ms"], 2),
            "e2e_p99_ms": round(rtt["p99_ms"], 2),
            "wal_fsync_batched_clean": round(clean["fsync_batched"], 2),
            "wal_fsync_batched": round(rtt["fsync_batched"], 2),
        })

        # ---- row 3: kill -9 at 2x ------------------------------------
        rate = 2.0 * eps
        OPS_KILL = max((int(rate * 3.0) // CONNS) * CONNS, 300)
        victim = sup.leader()
        if victim is None:
            victim = 0

        async def kill_row() -> dict:
            cs = [await connect(i % NODES) for i in range(CONNS)]
            lats: list = []
            refused = [0]
            unknown = [0]
            per_conn = OPS_KILL // CONNS
            gap = CONNS / rate
            killed_at = per_conn // 3

            async def w(ci, c):
                for j in range(per_conn):
                    if ci == 0 and j == killed_at:
                        sup.kill9(victim)
                    b0 = time.perf_counter()
                    try:
                        await c.submit(keys[j % len(keys)],
                                       b"k%d-%d" % (ci, j))
                    except WireRefused:
                        refused[0] += 1
                    except _errs:
                        unknown[0] += 1
                    else:
                        lats.append(
                            (time.perf_counter() - b0) * 1e3
                        )
                    left = gap - (time.perf_counter() - b0)
                    if left > 0:
                        await asyncio.sleep(left)

            t0 = time.perf_counter()
            await asyncio.gather(
                *[w(ci, c) for ci, c in enumerate(cs)]
            )
            wall = time.perf_counter() - t0
            for c in cs:
                await c.close()
            p50, p99 = _percentiles(lats)
            return {
                "offered": OPS_KILL,
                "rate_x_capacity": round(rate / eps, 2),
                "killed_node": victim,
                "acked": len(lats),
                "refused": refused[0],
                "outcome_unknown": unknown[0],
                "e2e_p50_ms": round(p50, 2),
                "e2e_p99_ms": round(p99, 2),
                "wall_s": round(wall, 3),
            }

        rows["kill9"] = _emit_leg("cluster_kill9",
                                  asyncio.run(kill_row()))

        # ---- row 4: restart handoff vs re-seal -----------------------
        def survivors_commit() -> int:
            return max(
                (commit_of(i) for i in range(NODES)
                 if i != victim and sup.alive(i)),
                default=0,
            )

        def timed_restart(budget_s: float = 30.0) -> dict:
            """Respawn the victim and split the clock: ``boot_s`` (start
            to ready) and ``catchup_s`` (ready to caught up)."""
            target = survivors_commit()
            t0 = time.monotonic()
            sup.restart(victim, wait_ready=True)
            t_ready = time.monotonic()
            caught = wait_commit(victim, target, budget_s)
            t_caught = time.monotonic()
            st = sup.status(victim) or {}
            tier = st.get("tier", {})
            return {
                "boot_s": round(t_ready - t0, 3),
                "catchup_s": round(t_caught - t_ready, 3),
                "total_s": round(t_caught - t0, 3),
                "caught_up": caught,
                "generation": int(st.get("generation", 0)),
                "segments_adopted": int(
                    tier.get("segments_adopted", 0)
                ),
                "segments_resealed": int(
                    tier.get("segments_resealed", 0)
                ),
            }

        handoff = timed_restart()
        sup.kill9(victim)
        shutil.rmtree(sup.node_dir(victim), ignore_errors=True)
        reseal = timed_restart()
        rows["handoff"] = _emit_leg("cluster_handoff", {
            "handoff_s": handoff["catchup_s"],
            "reseal_s": reseal["catchup_s"],
            "handoff_ratio": round(
                handoff["catchup_s"] / max(reseal["catchup_s"], 1e-9),
                3,
            ),
            "handoff_boot_s": handoff["boot_s"],
            "reseal_boot_s": reseal["boot_s"],
            "handoff_caught_up": handoff["caught_up"],
            "reseal_caught_up": reseal["caught_up"],
            "segments_adopted": handoff["segments_adopted"],
            "segments_resealed": handoff["segments_resealed"],
            "wiped_segments_adopted": reseal["segments_adopted"],
        })
    finally:
        sup.stop_all()
        shutil.rmtree(base, ignore_errors=True)
    return rows


# ------------------------------------------------- mesh per-device kernel
def bench_mesh1(rng, dev=None) -> dict:
    """Per-device overhead of the MESH program: ``MeshTransport`` (the
    host decides the flight's regime, K3·mesh/K4·mesh write, the launch
    collectives ride gloo) in a one-rank gloo group on this device,
    against ``SingleDeviceTransport`` (K3, K4) at the same shape. A
    one-rank group isolates exactly the delta the mesh formulation adds
    per device; the cross-device hop is bounded below by it."""
    import tempfile

    import torch.distributed as dist

    from raft_tpu_torch.transport import MeshTransport, SingleDeviceTransport

    dev = _dev(dev)
    cfg = RaftConfig(n_replicas=1)
    words = _rand_i32(rng, (cfg.batch_size, cfg.shard_words))
    wins = torch.as_tensor(words, device=dev)[None]   # n=1: lanes == W
    counts = torch.full((T_STEPS,), cfg.batch_size, dtype=torch.int32,
                        device=dev)
    alive = torch.ones(1, dtype=torch.bool, device=dev)
    slow = torch.zeros(1, dtype=torch.bool, device=dev)
    rows = {}
    opened = not dist.is_initialized()
    tmp = tempfile.mkdtemp(prefix="bench_mesh1_")
    if opened:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "rdv"),
            world_size=1, rank=0)
    try:
        for name, t in (
            ("mesh_of_1", MeshTransport(cfg, device=dev)),
            ("co_located", SingleDeviceTransport(cfg, device=dev)),
        ):
            def fn(state, t=t):
                st, info = t.replicate_pipeline(
                    state, wins, counts, 0, 1, alive, slow, term_floor=1,
                    allow_turnover=True,
                )
                return st, info.commit_index

            fn.program = (f"{type(t).__name__}.replicate_pipeline: one "
                          "flight (the mesh: K3·mesh or K4·mesh, the "
                          "regime decided on the host)"
                          if name == "mesh_of_1" else
                          f"{type(t).__name__}.replicate_pipeline: one "
                          "flight (K3, then K4 when every row accepts)")
            rows[name] = bench_scan(cfg, fn, reps=3, dev=dev)
    finally:
        if opened:
            dist.destroy_process_group()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "mesh_of_1": rows["mesh_of_1"],
        "co_located": rows["co_located"],
        "per_device_overhead_us": round(
            rows["mesh_of_1"]["p50_us"] - rows["co_located"]["p50_us"], 3
        ),
    }


# --------------------------------------------------------------- config 5
def bench_storm(dev=None) -> dict:
    """Election churn: commit progress through a disruptive-candidacy
    storm plus the election-timing distributions the reference's constants
    imply (time to first leader; re-election convergence after leader
    kills), run with the reference's dynamics and again with ``prevote``
    + ``check_quorum`` on over a shorter window."""
    from raft_tpu_torch.storm import HARDENED_FIELDS
    from raft_tpu_torch.transport import SingleDeviceTransport

    dev = _dev(dev)
    cfg0 = RaftConfig(
        n_replicas=3, entry_bytes=256, batch_size=64, log_capacity=1 << 12,
        transport="single",
    )
    t = SingleDeviceTransport(cfg0, device=dev)   # shared by BOTH variants
    base = bench_storm_once(prevote=False, transport=t, dev=dev)
    hardened = bench_storm_once(prevote=True, transport=t, window=400.0,
                                measure_first_leader=False, dev=dev)
    base["with_prevote_checkquorum"] = {
        k: hardened[k] for k in HARDENED_FIELDS
    }
    return base


#: the keys of ``storm.storm_once``'s result that ``bench_storm_once``'s
#: row does not carry (the run itself, read back)
_STORM_RUN_KEYS = ("commit_watermark", "apply_sha256", "ring_read_from",
                   "ring_read_sha256", "trace", "engine")


def bench_storm_once(prevote: bool, transport=None, window: float = 1000.0,
                     measure_first_leader: bool = True, dev=None) -> dict:
    """One storm variant (config 5's schedule, ``storm.storm_once``) on
    the engine over ``transport``, reduced to the bench's row."""
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.storm import storm_config, storm_once
    from raft_tpu_torch.transport import SingleDeviceTransport

    t = transport if transport is not None else SingleDeviceTransport(
        storm_config(2, prevote), device=_dev(dev))

    def make_engine(seed, pv, trace):
        return RaftEngine(storm_config(seed, pv), t, trace=trace)

    out = storm_once(make_engine, prevote, window=window,
                     measure_first_leader=measure_first_leader)
    return {k: v for k, v in out.items() if k not in _STORM_RUN_KEYS}


# ----------------------------------------------------------- kernel gates
def _ring_kernel_gate(rng, dev=None) -> None:
    """Equivalence gate for K1 (``write_window_both``) on the card: the
    wrap, partial-count and conflict cases against the plain formulation
    (the column write, the row write, the conflict check), byte for byte.
    Runs only on CUDA, where the kernel exists."""
    dev = _dev(dev)
    if dev.type == "cuda":
        ring_kernel_cases(rng, dev)


def ring_kernel_cases(rng, dev, C=1 << 15, B=1024, M=192, L=3) -> None:
    """The K1 gate's cases on ``dev`` (on the CPU the wrapper runs its
    plain version, so the cases check the gate itself)."""
    from raft_tpu_torch.core.ring import write_window_cols_xla, \
        write_window_rows
    from raft_tpu_torch.core.ring_cuda import write_window_both

    for s, count in [(0, B), (77, 1000), (C - B + 511, B), (C - 1, 300),
                     (9, 0)]:
        buf_p = _rand_i32(rng, (C, M))
        buf_t = rng.integers(1, 6, (L, C), dtype=np.int32)
        win = _rand_i32(rng, (B, M))
        win_t = rng.integers(1, 6, B, dtype=np.int32)
        accept = rng.random(L) < 0.7
        lanes = np.repeat(accept, M // L)
        ws = s + 1
        last = rng.integers(0, ws + B, L).astype(np.int32)

        def on(x, where=dev):
            return torch.tensor(x, device=where)   # a copy: written in place

        gp, gt = on(buf_p), on(buf_t)
        gmm = write_window_both(gp, gt, on(win), on(win_t), s, count, ws,
                                on(accept), on(last))
        cpu = torch.device("cpu")
        wp = write_window_cols_xla(on(buf_p, cpu), on(win, cpu), s, count,
                                   on(lanes, cpu))
        wt = write_window_rows(on(buf_t, cpu), on(win_t, cpu), s, count,
                               on(accept, cpu))
        if not torch.equal(gp.cpu(), wp):
            raise AssertionError(f"ring kernel payload diverges at s={s}")
        if not torch.equal(gt.cpu(), wt):
            raise AssertionError(f"ring kernel terms diverge at s={s}")
        widx = ws + np.arange(B)
        my_win_t = buf_t[:, (s + np.arange(B)) % C]
        want_mm = (
            (widx[None, :] <= last[:, None])
            & (my_win_t != win_t[None, :])
            & (np.arange(B) < count)[None, :]
        ).any(axis=1)
        if not np.array_equal(gmm.cpu().numpy() != 0, want_mm):
            raise AssertionError(
                f"ring kernel conflict check diverges at s={s}")


def reconstruct_probe(state, code, T, cfg):
    """Decode the ring-retained committed tail from a non-systematic
    serving subset (includes a parity row)."""
    from raft_tpu_torch.ec.reconstruct import reconstruct

    hi = T * cfg.batch_size
    lo = hi - cfg.log_capacity + 1
    return reconstruct(state, code, [1, 2, 4], lo, hi)


def _pipeline_lap_gate(rng, dev=None) -> None:
    """The lap gate (``pipeline_lap_cases``), on the card only."""
    dev = _dev(dev)
    if dev.type == "cuda":
        pipeline_lap_cases(rng, dev)


def pipeline_lap_cases(rng, dev) -> None:
    """Equivalence gate for the single-launch flight in the ring-LAP
    regime (a flight that revisits ring slots within one launch): byte
    for byte against the per-step K2 scan, on the card, in three regimes —
    turnover (all-accept), K3 forced onto the same all-accept flight
    (``allow_turnover=False``), and K3 with a never-accepting slow row —
    then the EC lane geometry (K3·ec/K4·ec against K2·ec) and a decoding
    read of the lapped EC ring."""
    from raft_tpu_torch.core.state import FIELDS, fold_batch
    from raft_tpu_torch.core.step_cuda import (steady_pipeline,
                                               steady_scan_replicate)

    cfg = RaftConfig(log_capacity=1 << 12)    # 4 blocks; T laps it 3x
    T = 12
    wins4 = torch.stack([
        fold_batch(rng.integers(
            0, 256, (cfg.batch_size, cfg.entry_bytes), dtype=np.uint8
        ), cfg.rows, device=dev)
        for _ in range(4)
    ])
    counts = torch.full((T,), cfg.batch_size, dtype=torch.int32,
                        device=dev)
    xs = torch.stack([wins4[t % 4] for t in range(T)])
    cases = [
        (np.zeros(3, bool), True),
        (np.zeros(3, bool), False),
        (np.array([False, False, True]), False),
    ]
    for slow, allow in cases:
        args = (0, 1, torch.ones(3, dtype=torch.bool, device=dev),
                torch.as_tensor(slow, device=dev), 0, 0, None, 1)
        st_s, _ = steady_scan_replicate(
            init_state(cfg, device=dev), xs, counts, *args,
            commit_quorum=None,
        )
        st_p, _ = steady_pipeline(
            init_state(cfg, device=dev), wins4, counts, *args,
            commit_quorum=None, allow_turnover=allow,
        )
        for f in FIELDS:
            if not torch.equal(getattr(st_s, f), getattr(st_p, f)):
                raise AssertionError(
                    f"pipeline lap regime diverges: {f} "
                    f"(slow={slow}, turnover={allow})")

    # the EC lane geometry over ring laps
    from raft_tpu_torch.ec.kernels import fold_data_lanes, parity_consts
    from raft_tpu_torch.ec.rs import RSCode

    ecfg = RaftConfig(n_replicas=5, entry_bytes=264, batch_size=1024,
                      log_capacity=1 << 12, rs_k=3, rs_m=2,
                      transport="single")
    consts = parity_consts(5, 3)
    raw = rng.integers(
        0, 256, (T, ecfg.batch_size, ecfg.entry_bytes), dtype=np.uint8
    )
    ewins = torch.stack([fold_data_lanes(torch.as_tensor(raw[t],
                                                         device=dev))
                         for t in range(T)])
    eargs = (0, 1, torch.ones(5, dtype=torch.bool, device=dev),
             torch.zeros(5, dtype=torch.bool, device=dev), 0, 0, None, 1)
    st_s, _ = steady_scan_replicate(
        init_state(ecfg, device=dev), ewins, counts, *eargs,
        commit_quorum=ecfg.commit_quorum, ec_consts=consts,
    )
    st_p, _ = steady_pipeline(
        init_state(ecfg, device=dev), ewins, counts, *eargs,
        commit_quorum=ecfg.commit_quorum, ec_consts=consts,
    )
    for f in ("last_index", "commit_index", "log_term", "log_payload"):
        if not torch.equal(getattr(st_s, f), getattr(st_p, f)):
            raise AssertionError(f"EC pipeline lap regime diverges: {f}")
    got = np.asarray(reconstruct_probe(st_p, RSCode(5, 3), T, ecfg))
    if not np.array_equal(
            got, raw.reshape(-1, ecfg.entry_bytes)[-ecfg.log_capacity:]):
        raise AssertionError("EC pipeline lap decode != raw bytes")


# ----------------------------------------------------------- multi-Raft
def _multi_device_scan(cfg: RaftConfig, G: int, T: int, rng,
                       dev=None) -> dict:
    """The multi-Raft DEVICE side in isolation: T batched steps of the
    group program (every group ingests+commits a full batch per step; K5
    writes each step's windows), timed as one call (CUDA events on the
    card). Step time vs G is the launch-batching story."""
    from raft_tpu_torch.core.state import init_group_state
    from raft_tpu_torch.core.step import group_replicate_step

    dev = _dev(dev)
    R, B = cfg.n_replicas, cfg.batch_size
    step = group_replicate_step(R)
    payload = torch.as_tensor(
        _rand_i32(rng, (G, B, R * cfg.shard_words)), device=dev)
    counts = torch.full((G,), B, dtype=torch.int32, device=dev)
    leaders = torch.as_tensor([g % R for g in range(G)], dtype=torch.int32,
                              device=dev)
    terms = torch.ones(G, dtype=torch.int32, device=dev)
    alive = torch.ones((G, R), dtype=torch.bool, device=dev)
    slow = torch.zeros((G, R), dtype=torch.bool, device=dev)
    member = torch.ones((G, R), dtype=torch.bool, device=dev)

    def scan(state):
        commits = []
        for _ in range(T):
            state, info = step(state, payload, counts, leaders, terms,
                               alive, slow, member)
            commits.append(info.commit_index)
        return state, torch.stack(commits)

    _, commits = scan(init_group_state(cfg, G, device=dev))
    assert int(commits[-1].min()) == T * B
    samples = []
    for _ in range(4):
        st = init_group_state(cfg, G, device=dev)
        secs, _ = _event_seconds(lambda: scan(st), dev)
        samples.append(secs)
    per_step = min(samples) / T * 1e6
    return {
        "device_scan_us_per_step": round(per_step, 3),
        "device_entries_per_sec": round(G * B / per_step * 1e6, 1),
        "scan_steps": T,
    }


def bench_multi_group(dev=None) -> dict:
    """G-sweep of the multi-Raft subsystem: G independent consensus
    groups batched into shared launches, G ∈ {1, 4, 16}. Per row:
    AGGREGATE committed entries/s (wall, submit through durable-ack) and
    the pooled virtual-clock p50/p99 commit latency, with the batched
    device scan beside it. Each G row is emitted as it completes."""
    from raft_tpu_torch.multi import MultiEngine

    dev = _dev(dev)
    rows = {}
    per_group = 2048
    for G in (1, 4, 16):
        cfg = RaftConfig(
            n_replicas=3, entry_bytes=256, batch_size=256,
            log_capacity=1 << 12, transport="single", seed=9,
        )
        e = MultiEngine(cfg, G, device=dev)
        e.seed_leaders()
        rng = np.random.default_rng(G)
        mk = lambda n: [
            rng.integers(0, 256, cfg.entry_bytes, np.uint8).tobytes()
            for _ in range(n)
        ]
        last = {}
        for g in range(G):
            for p in mk(cfg.batch_size):
                last[g] = e.submit(g, p)
        for g in range(G):
            e.run_until_committed(g, last[g])
        t_virtual0 = e.clock.now
        t0 = time.perf_counter()
        for g in range(G):
            for p in mk(per_group):
                last[g] = e.submit(g, p)
        for g in range(G):
            e.run_until_committed(g, last[g])
        wall = time.perf_counter() - t0
        total = G * per_group
        lat = np.array([
            e.commit_time[g][s] - e.submit_time[g][s]
            for g in range(G) for s in e.commit_time[g]
            if e.submit_time[g][s] >= t_virtual0
        ])
        row = {
            "groups": G,
            "entries": total,
            "entries_per_sec_wall": round(total / wall, 1),
            "wall_s": round(wall, 3),
            "virtual_commit_p50_s": round(float(np.percentile(lat, 50)), 3),
            "virtual_commit_p99_s": round(float(np.percentile(lat, 99)), 3),
            "leader_spread": {str(k): v for k, v in sorted(
                e.leader_spread().items()
            )},
            "batch": cfg.batch_size,
            "entry_bytes": cfg.entry_bytes,
            **_multi_device_scan(cfg, G, 64, rng, dev=dev),
        }
        rows[f"G{G}"] = _emit_leg(f"multi_g{G}", row)
    return rows


def _group_shard_sweep(deadline_s: float | None = None, dev=None) -> dict:
    """The sharded G-sweep: per G ∈ {64, 256, 1024}, incrementally:

    - **device row**: one K-tick fused launch through the
      ``GroupMeshTransport`` (two shards on ``dev``, one K5-writing launch
      a shard a tick) — per-group µs/tick — beside the same launch through
      the resident program (``core.step.fused_group_scan``), and the
      resident G=16 reference at this shape;
    - **engine row**: aggregate committed entries/s through the sharded
      ``MultiEngine``, ``leader_spread`` and launches per tick round;
    - **migration row** (largest completed G): a mid-load
      ``migrate_group``, host wall ms."""
    from raft_tpu_torch.core.state import init_group_state
    from raft_tpu_torch.core.step import fused_group_scan
    from raft_tpu_torch.multi import MultiEngine
    from raft_tpu_torch.transport.group_mesh import (GroupMesh,
                                                     GroupMeshTransport)

    dev = _dev(dev)
    mesh = GroupMesh([dev, dev])
    t0 = time.monotonic()

    def expired() -> bool:
        return (
            deadline_s is not None
            and time.monotonic() - t0 >= deadline_s
        )

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    rows: dict = {}
    K = 32
    mig_engine = mig_mk = None
    for G in (64, 256, 1024):
        name = f"group_shard_g{G}"
        if expired():
            rows[f"G{G}"] = _emit_leg(name, {"skipped": "deadline"})
            continue
        cfg = RaftConfig(
            n_replicas=3, entry_bytes=64, batch_size=16,
            log_capacity=1 << 10, transport="mesh_groups", seed=9,
        )
        R, B = cfg.n_replicas, cfg.batch_size
        rng = np.random.default_rng(G)
        # ---- device row: one fused K-tick launch over the shards -----
        t = GroupMeshTransport(cfg, G, mesh=mesh)
        payloads = on(_rand_i32(rng, (K, G, B, cfg.shard_words)))
        counts = on(np.full((K, G), B, np.int32))
        leaders = on(np.asarray([g % R for g in range(G)], np.int32))
        terms = on(np.ones(G, np.int32))
        alive = on(np.ones((G, R), bool))
        slow = on(np.zeros((G, R), bool))
        member = on(np.ones((G, R), bool))
        halted0 = on(np.zeros(G, bool))

        # the timed region is the LAUNCH only: the state chains from
        # launch to launch (the steady cluster keeps committing)
        def mesh_launch(st):
            return t.replicate_fused(
                st, payloads, counts, K, halted0, leaders,
                terms, alive, slow, member,
            )

        out = mesh_launch(t.shard_state(init_group_state(cfg, G,
                                                         device=dev)))
        assert int(out[1].commit_index[-1].min()) == K * B
        assert not bool(out[2].any())             # no escapes: steady
        st = out[0]
        samples = []
        for _ in range(3):
            secs, out = _event_seconds(lambda: mesh_launch(st), dev)
            samples.append(secs)
            st = out[0]
        mesh_us = min(samples) / (K * G) * 1e6
        # the same shape through the resident program on one device
        vstep = fused_group_scan(R)

        def single_launch(st, G_=G):
            return vstep(st, payloads[:, :G_], counts[:, :G_], K,
                         halted0[:G_], leaders[:G_], terms[:G_],
                         alive[:G_], slow[:G_], member[:G_])

        out = single_launch(init_group_state(cfg, G, device=dev))
        st = out[0]
        samples = []
        for _ in range(3):
            secs, out = _event_seconds(lambda: single_launch(st), dev)
            samples.append(secs)
            st = out[0]
        single_us = min(samples) / (K * G) * 1e6

        # the resident saturation REFERENCE at this shape: G=16
        if "single_g16_us_per_group_tick" not in rows:
            st16 = single_launch(init_group_state(cfg, 16, device=dev),
                                 16)[0]
            g16 = []
            for _ in range(3):
                secs, out = _event_seconds(
                    lambda: single_launch(st16, 16), dev)
                g16.append(secs)
                st16 = out[0]
            rows["single_g16_us_per_group_tick"] = round(
                min(g16) / (K * 16) * 1e6, 3
            )

        # ---- engine row: end-to-end through the sharded engine -------
        e = MultiEngine(cfg, G, mesh=mesh, device=dev)
        e.seed_leaders()
        launches = [0]
        ticks = [0]
        orig_rep = e._gshard.replicate
        orig_fire = e._fire_leader_ticks

        def counting(*a, **kw):
            launches[0] += 1
            return orig_rep(*a, **kw)

        def counting_fire(tick_list):
            ticks[0] += 1                 # one same-instant round
            return orig_fire(tick_list)

        e._gshard.replicate = counting
        e._fire_leader_ticks = counting_fire
        per_group = 64
        mk = lambda: rng.integers(
            0, 256, cfg.entry_bytes, np.uint8
        ).tobytes()
        last = {}
        for g in range(G):                        # warm one batch
            for _ in range(B):
                last[g] = e.submit(g, mk())
        for g in range(G):
            e.run_until_committed(g, last[g])
        launches[0] = ticks[0] = 0
        t_virtual0 = e.clock.now
        w0 = time.perf_counter()
        for g in range(G):
            for _ in range(per_group):
                last[g] = e.submit(g, mk())
        for g in range(G):
            e.run_until_committed(g, last[g])
        wall = time.perf_counter() - w0
        total = G * per_group
        lat = np.array([
            e.commit_time[g][s] - e.submit_time[g][s]
            for g in range(G) for s in e.commit_time[g]
            if e.submit_time[g].get(s, -1.0) >= t_virtual0
        ])
        mig_engine, mig_mk = e, mk

        rows[f"G{G}"] = _emit_leg(name, {
            "groups": G,
            "shards": e.n_shards,
            "fused_ticks": K,
            "mesh_us_per_group_tick": round(mesh_us, 3),
            "single_device_us_per_group_tick": round(single_us, 3),
            "mesh_entries_per_sec": round(B / mesh_us * 1e6, 1),
            "entries": total,
            "entries_per_sec_wall": round(total / wall, 1),
            "wall_s": round(wall, 3),
            "virtual_commit_p50_s": round(
                float(np.percentile(lat, 50)), 3
            ) if lat.size else None,
            "launches_per_tick": round(
                launches[0] / max(ticks[0], 1), 3
            ),
            "leader_spread": {str(k): v for k, v in sorted(
                e.leader_spread().items()
            )},
            "batch": B,
            "entry_bytes": cfg.entry_bytes,
            "device": f"{dev} (both shards)",
        })
    # ---- migration under load: once, on the largest completed G -----
    if mig_engine is not None and not expired():
        e, mk = mig_engine, mig_mk
        for g in range(e.G):
            e.submit(g, mk())                     # queued load
        mig_ms = []
        mvs = []
        for _ in range(2):
            m0 = time.perf_counter()
            mv = e.migrate_group(0, (e.shard_of(0) + 1) % e.n_shards)
            mig_ms.append((time.perf_counter() - m0) * 1e3)
            mvs.append(mv)
        s = e.submit(0, mk())
        e.run_until_committed(0, s)
        rows["migration"] = _emit_leg("group_shard_migration", {
            "groups": e.G,
            "moves": [
                {k: mv[k] for k in ("group", "src", "dst", "catch_up_s")}
                for mv in mvs
            ],
            "first_move_ms": round(mig_ms[0], 2),
            "steady_move_ms": round(mig_ms[1], 2),
            "committed_after_move": True,
            "device": f"{dev} (both shards)",
        })
    return rows


def bench_group_shard(deadline_s: float | None = None, dev=None) -> dict:
    """The ``group_shard`` leg: the sharded-group-axis sweep on this
    process's device, two shards side by side on it (the JAX bench
    re-runs the sweep on virtual CPU devices in a child; the port never
    does)."""
    return _group_shard_sweep(deadline_s, dev=dev)


# ------------------------------------------------------------------ main
def _build_kernels(dev) -> float | None:
    """Build the kernel libraries (``nvcc``) before the first leg, so no
    leg carries the build; seconds, or None off the card."""
    if dev.type != "cuda":
        return None
    from raft_tpu_torch import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    return round(time.perf_counter() - t0, 3)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.bench",
        description="raft_tpu_torch benchmark suite (bench.py's legs on "
                    "one GPU)")
    ap.add_argument(
        "--deadline-s", type=float, default=None,
        help="overall wall-clock budget: remaining legs are skipped "
             "once exceeded, and the final combined JSON still prints",
    )
    ap.add_argument(
        "--compare", metavar="OLD.json", default=None,
        help="after the run, diff this run's legs against a previous "
             "bench artifact (raft_tpu_torch.tools.bench_diff) and exit "
             "non-zero if any gated metric regressed past "
             "--regress-threshold",
    )
    ap.add_argument(
        "--regress-threshold", type=float, default=0.10,
        help="fractional regression gate for --compare (default 0.10)",
    )
    ap.add_argument(
        "--profile-legs", action="store_true",
        help="run each leg under a CUDA-only torch.profiler session and "
             "add its device busy time and idle share to the combined "
             "object (the session's cost distorts the rows' host "
             "figures: a run for the idle shares)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="the device every leg runs on (default cuda; there is no "
             "fallback: without a GPU pass --device cpu)",
    )
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device: the bench runs on a GPU; pass --device cpu "
            "to run the plain versions on the host")
    dev = _dev(args.device)
    card, limit = card_query() if dev.type == "cuda" else (None, None)
    print(json.dumps({"card": card, "power_limit": limit,
                      "device": str(dev)}), flush=True)
    if args.profile_legs and dev.type != "cuda":
        raise SystemExit("--profile-legs profiles the card: it needs "
                         "--device cuda")
    dl = _Deadline(args.deadline_s, dev, profile=args.profile_legs)
    build_s = None if dl.expired else _build_kernels(dev)

    rng = np.random.default_rng(0)
    if dl.expired:
        # record that the kernel-equivalence gates never ran: surviving
        # rows must not be read as gate-validated numbers
        dl.skipped.append("kernel_gates")
    else:
        dl.book("kernel_gates", lambda: (
            _ring_kernel_gate(rng, dev), _pipeline_lap_gate(rng, dev)))

    # -- config 2: the headline ------------------------------------------
    cfg2 = RaftConfig()          # 3 replicas, 256 B, batch 1024
    fn2 = None
    wall_slope = float("nan")

    def _leg_c2() -> dict:
        nonlocal fn2, wall_slope
        fn2 = _fixed_payload_scan(cfg2, np.zeros(3, bool), rng, dev=dev)
        row = _best_program(
            bench_scan(cfg2, fn2, dev=dev),
            bench_scan(
                cfg2,
                _fixed_payload_scan(cfg2, np.zeros(3, bool), rng,
                                    repair=True, dev=dev),
                dev=dev,
            ),
        )

        # wall-clock cross-check (upper bound: the host's launch work
        # amortized / T)
        def run_wall():
            st = init_state(cfg2, device=dev)
            _sync(dev)
            return _timed_wall_call(fn2, st)
        run_wall()
        wall_slope = min(run_wall() for _ in range(6)) / T_STEPS * 1e6
        return row

    c2 = dl.run("c2_batched", _leg_c2)

    # -- config 4: 5 replicas, 1 slow follower ---------------------------
    cfg4 = RaftConfig(n_replicas=5)
    slow4 = np.zeros(5, bool)
    slow4[4] = True
    c4 = dl.run("c4_slow", lambda: _best_program(
        bench_scan(cfg4, _fixed_payload_scan(cfg4, slow4, rng, dev=dev),
                   dev=dev),
        bench_scan(
            cfg4, _fixed_payload_scan(cfg4, slow4, rng, repair=True,
                                      dev=dev),
            dev=dev,
        ),
    ))

    # -- supplementary: batch-scaling throughput -------------------------
    def _leg_c2x() -> dict:
        cfg2x = RaftConfig(batch_size=4096, log_capacity=1 << 15)
        row = _best_program(
            bench_scan(
                cfg2x, _fixed_payload_scan(cfg2x, np.zeros(3, bool), rng,
                                           dev=dev),
                reps=3, dev=dev,
            ),
            bench_scan(
                cfg2x,
                _fixed_payload_scan(cfg2x, np.zeros(3, bool), rng,
                                    repair=True, dev=dev),
                reps=3, dev=dev,
            ),
        )
        row["log_capacity"] = cfg2x.log_capacity
        cfg2x_big = RaftConfig(batch_size=4096, log_capacity=1 << 17)
        row["p50_us_ring131k"] = _best_program(
            bench_scan(
                cfg2x_big,
                _fixed_payload_scan(cfg2x_big, np.zeros(3, bool), rng,
                                    dev=dev),
                reps=3, dev=dev,
            ),
            bench_scan(
                cfg2x_big,
                _fixed_payload_scan(cfg2x_big, np.zeros(3, bool), rng,
                                    repair=True, dev=dev),
                reps=3, dev=dev,
            ),
        )["p50_us"]
        return row

    c2x = dl.run("c2_batch4096", _leg_c2x)

    configs = {
        "c2_batched": c2,
        "c2_batch4096": c2x,
        "c4_slow": c4,
    }
    for name, leg in (
        ("c1_loopback", bench_loopback),
        ("c3_rs53", lambda: bench_rs53(dev)),
        ("c5_storm", lambda: bench_storm(dev)),
        ("mesh1_per_device", lambda: bench_mesh1(rng, dev)),
        ("read_index", lambda: bench_read_index(dev)),
        ("read_scale", lambda: bench_read_scale(dev)),
        ("client_chunk", lambda: bench_client_latency(dev)),
        ("attribution", lambda: bench_attribution(dev)),
        ("fusion", lambda: bench_fusion(dev)),
        ("overload", lambda: bench_overload(dev)),
        ("reconfig", lambda: bench_reconfig(dev)),
        ("macro", lambda: bench_macro(dev)),
        ("txn", lambda: bench_txn(dev)),
        ("cluster", lambda: bench_cluster(dev)),
    ):
        configs[name] = dl.run(name, leg)
    if dl.expired:
        dl.skipped.append("multi_group")
        configs["multi_group"] = _emit_leg(
            "multi_group", {"skipped": "deadline"}
        )
    else:
        configs["multi_group"] = dl.book(
            "multi_group", lambda: bench_multi_group(dev))
    if dl.expired:
        dl.skipped.append("group_shard")
        configs["group_shard"] = _emit_leg(
            "group_shard", {"skipped": "deadline"}
        )
    else:
        # the sharded sweep inherits the REMAINING budget (it
        # self-truncates per G)
        configs["group_shard"] = dl.book("group_shard", lambda: (
            bench_group_shard(dl.remaining(), dev)))

    # Deadline-degraded runs carry nulls for the headline fields rather
    # than dying with no JSON at all.
    have_c2 = c2 is not None and "p50_us" in c2
    out = {
        "metric": "commit_p50_latency",
        "value": c2["p50_us"] if have_c2 else None,
        "unit": "us",
        "vs_baseline": (
            round(REFERENCE_TICK_US / c2["p50_us"], 1) if have_c2 else None
        ),
        "p99_us": c2["p99_us"] if have_c2 else None,
        "entries_per_sec": c2["entries_per_sec"] if have_c2 else None,
        "batch": cfg2.batch_size,
        "entry_bytes": cfg2.entry_bytes,
        "n_replicas": cfg2.n_replicas,
        "backend": dev.type,
        "method": (
            f"torch.profiler {c2['method'].split(':')[0]}-time over "
            f"{T_STEPS}-step flights (summed CUDA kernel, copy and fill "
            "durations, not a module span)"
            if have_c2 else None
        ),
        "wall_slope_us": (
            round(wall_slope, 3) if np.isfinite(wall_slope) else None
        ),
        "card": card,
        "power_limit": limit,
        "build_s": build_s,
        "launches_by_leg": dl.launches,
        "leg_wall_s": dl.walls,
        "run_wall_s": round(time.monotonic() - dl.t0, 3),
        "configs": configs,
    }
    if dl.profile:
        out["device_busy_by_leg"] = dl.busy
    if dl.seconds is not None:
        out["deadline_s"] = dl.seconds
        out["deadline_skipped"] = dl.skipped
    print(json.dumps(out), flush=True)

    if args.compare:
        # regression gate: the delta table goes to stderr so stdout stays
        # a clean JSON-lines stream; a gated regression exits 1
        from raft_tpu_torch.tools.bench_diff import (
            _flatten_legs,
            compare_runs,
            format_table,
            load_bench,
        )

        deltas, regressions = compare_runs(
            load_bench(args.compare), _flatten_legs(out),
            args.regress_threshold,
        )
        print(format_table(deltas, args.regress_threshold),
              file=sys.stderr)
        if regressions:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
