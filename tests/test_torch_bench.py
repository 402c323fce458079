"""The port's bench (``raft_tpu_torch.bench``) against ``bench.py`` on the
CPU: the deadline contract of ``tests/test_bench_deadline.py`` run on the
port, the refusal to run off the card unless asked, the kernel gates'
cases, and each device and host leg's row against the JAX leg's at the
same small size (``tests/_torch_bench.py``): the same row keys, and equal
deterministic fields — commit counts (both benches assert them), the
virtual-clock figures exactly, checker-style verdicts exactly. The
service legs are in ``test_torch_bench_service.py`` and
``test_torch_bench_cluster.py``."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import raft_tpu_torch.bench as tb
from _torch_bench import rows, same_keys, small

ROOT = Path(__file__).resolve().parent.parent


def _run_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "raft_tpu_torch.bench", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)


# ------------------------------------------------------------ the harness
def test_deadline_zero_skips_all_legs_and_emits_valid_json():
    """``python -m raft_tpu_torch.bench --device cpu --deadline-s 0``:
    every leg an explicit skip row, the gates recorded as skipped, the
    combined object valid with null headline fields."""
    r = _run_cli("--device", "cpu", "--deadline-s", "0")
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    rows_ = [json.loads(ln) for ln in lines]      # every line parses
    final = rows_[-1]
    assert final["metric"] == "commit_p50_latency"
    assert final["value"] is None                 # nulls, not absence
    assert final["deadline_s"] == 0.0
    assert final["backend"] == "cpu"
    assert final["card"] is None and final["power_limit"] is None
    legs = {r["leg"]: r for r in rows_ if "leg" in r}
    assert legs and all(r.get("skipped") == "deadline" for r in legs.values())
    assert set(final["deadline_skipped"]) == set(legs) | {"kernel_gates"}
    assert all(
        final["configs"][name].get("skipped") == "deadline" for name in legs
    )
    # the same legs, in the same order, as bench.py's main
    assert list(legs) == [
        "c2_batched", "c4_slow", "c2_batch4096", "c1_loopback", "c3_rs53",
        "c5_storm", "mesh1_per_device", "read_index", "read_scale",
        "client_chunk", "attribution", "fusion", "overload", "reconfig",
        "macro", "txn", "cluster", "multi_group", "group_shard"]
    assert rows_[0] == {"card": None, "power_limit": None, "device": "cpu"}


def test_no_gpu_means_an_error_not_the_cpu():
    """Without ``--device cpu`` a machine with no GPU stops the run with an
    error and prints no result."""
    r = _run_cli("--deadline-s", "0")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout.strip() == ""


def test_deadline_object_contract():
    dl = tb._Deadline(None)
    assert not dl.expired                         # no budget: never expires
    row = dl.run("x", lambda: {"v": 1})
    assert row["v"] == 1
    assert {"compile_count", "compile_s",
            "mem_high_water_bytes"} <= set(row)
    assert "x" in dl.walls and dl.launches == {}  # the CPU launches none

    dl = tb._Deadline(1e-9)
    time.sleep(0.01)
    assert dl.expired
    # a SKIPPED leg stays a bare skip marker
    assert dl.run("y", lambda: {"v": 1}) == {"skipped": "deadline"}
    assert dl.skipped == ["y"]


def test_compile_count_counts_novel_signatures():
    """On the port ``compile_count`` counts the compile plane's events: a
    labeled seam's first call with a novel signature is one."""
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.transport import SingleDeviceTransport

    cfg = RaftConfig(n_replicas=3, entry_bytes=8, batch_size=8,
                     log_capacity=64, seed=31)

    def leg():
        t = SingleDeviceTransport(cfg, device="cpu")
        st = t.init()
        alive = torch.ones(3, dtype=torch.bool)
        st, _ = t.request_votes(st, 0, 1, alive)
        return {"done": True}

    row = tb._observed_leg(leg, "cpu")
    assert row["compile_count"] >= 1
    assert tb._observed_leg(leg, "cpu")["compile_count"] == 0


def test_kernel_gates_run_only_on_the_card():
    """On the CPU the gates return at once (JAX's run only on a TPU); their
    cases run on any device, the wrapper's plain version there."""
    rng = np.random.default_rng(0)
    assert tb._ring_kernel_gate(rng, "cpu") is None
    assert tb._pipeline_lap_gate(rng, "cpu") is None
    tb.ring_kernel_cases(rng, torch.device("cpu"), C=1 << 12, B=256, M=48)


def test_pipeline_lap_cases_hold_on_the_plain_versions():
    """The lap gate's cases (C = 4 096, T = 12, with and without a slow
    row, and at RS(5,3)) hold the plain flight against the plain per-step
    scan and the EC decode against the raw bytes."""
    tb.pipeline_lap_cases(np.random.default_rng(0), torch.device("cpu"))


# --------------------------------------------------------- the device legs
@pytest.mark.parametrize("leg", ["c2_batched", "c4_slow", "c2_batch4096"])
def test_program_rows_match_jax(leg):
    """Both programs committed T·B (each bench asserts it inside
    ``bench_scan``); the rows carry the JAX row's keys, ``program`` names
    one of the two programs and ``method`` says how it was timed."""
    j, t = rows(leg)
    same_keys(j, t, leg)
    assert t["program"] in ("steady (steady_dispatch=auto)",
                            "repair_capable (steady_dispatch=off)")
    assert t["method"].startswith("wall: ")       # no trace on the CPU
    assert j["method"] == "wall"


def test_bench_scan_commit_sanity_fails_loudly():
    """A program that commits less than T·B is refused, not timed."""
    from raft_tpu_torch.config import RaftConfig

    with small(False):
        cfg = RaftConfig(n_replicas=3, entry_bytes=8, batch_size=128,
                         log_capacity=512)

        def lazy(state):
            return state, torch.zeros(tb.T_STEPS, dtype=torch.int32)

        with pytest.raises(AssertionError, match="scan committed 0"):
            tb.bench_scan(cfg, lazy, reps=1, dev="cpu")


def test_c3_rs53_matches_jax():
    j, t = rows("c3_rs53")
    same_keys(j, t, "c3_rs53")
    assert t["entry_bytes"] == j["entry_bytes"] == 264


def test_mesh1_matches_jax():
    j, t = rows("mesh1_per_device")
    same_keys(j, t, "mesh1_per_device")
    assert "MeshTransport" in t["mesh_of_1"]["method"]
    assert "SingleDeviceTransport" in t["co_located"]["method"]
