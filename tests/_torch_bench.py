"""Shared runners of the bench tests (tests/test_torch_bench*.py): each leg
of ``bench.py`` and its counterpart in ``raft_tpu_torch.bench`` run once per
test process, on the CPU, at the same small size, and the two rows are
kept for the tests to compare.

The headline shape (``RaftConfig()``) is cut to 8-byte entries, B = 128,
C = 512 on both sides (``small()`` swaps each module's ``RaftConfig`` for
one with those defaults; fields a leg passes explicitly stand), and the
T-step programs run T = 8 steps on both (``T_STEPS``). Every other leg
runs at its own size, which is small already."""

from __future__ import annotations

import contextlib

import numpy as np

import bench as jb
import raft_tpu_torch.bench as tb
from raft_tpu.config import RaftConfig as JConfig
from raft_tpu_torch.config import RaftConfig as TConfig

CPU = "cpu"
SMALL = dict(entry_bytes=8, batch_size=128, log_capacity=512)
T_SMALL = 8

#: the harness columns ``_observed_leg`` adds to an executed row
HARNESS = {"compile_count", "compile_s", "mem_high_water_bytes"}


@contextlib.contextmanager
def small(headline: bool = True):
    """Both modules at the test size: ``T_STEPS`` = 8 and, with
    ``headline``, the headline config cut to ``SMALL``."""
    saved = [(m, n, getattr(m, n)) for m in (jb, tb)
             for n in ("T_STEPS", "RaftConfig")]
    try:
        for m in (jb, tb):
            m.T_STEPS = T_SMALL
        if headline:
            jb.RaftConfig = lambda **kw: JConfig(**{**SMALL, **kw})
            tb.RaftConfig = lambda **kw: TConfig(**{**SMALL, **kw})
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _programs(mod, n_replicas, slow, reps, **cfg_kw):
    """``main``'s two-program row (``_best_program`` over the steady and
    the repair-capable ``_fixed_payload_scan``), as both mains build it."""
    cfg = mod.RaftConfig(n_replicas=n_replicas, **cfg_kw)
    rng = np.random.default_rng(0)
    kw = {"dev": CPU} if mod is tb else {}
    scans = [mod._fixed_payload_scan(cfg, slow, rng, repair=r, **kw)
             for r in (False, True)]
    rows = [mod.bench_scan(cfg, fn, reps=reps, **kw) for fn in scans]
    return mod._best_program(*rows)


def _c2x(mod):
    row = _programs(mod, 3, np.zeros(3, bool), 1, batch_size=4096,
                    log_capacity=1 << 15)
    row["log_capacity"] = 1 << 15
    row["p50_us_ring131k"] = _programs(
        mod, 3, np.zeros(3, bool), 1, batch_size=4096,
        log_capacity=1 << 17)["p50_us"]
    return row


def _slow4():
    s = np.zeros(5, bool)
    s[4] = True
    return s


#: leg -> (headline cut?, the JAX call, the port call)
LEGS = {
    "c2_batched": (True, lambda: _programs(jb, 3, np.zeros(3, bool), 2),
                   lambda: _programs(tb, 3, np.zeros(3, bool), 2)),
    "c4_slow": (True, lambda: _programs(jb, 5, _slow4(), 2),
                lambda: _programs(tb, 5, _slow4(), 2)),
    "c2_batch4096": (True, lambda: _c2x(jb), lambda: _c2x(tb)),
    "c1_loopback": (False, lambda: jb.bench_loopback(100),
                    lambda: tb.bench_loopback(100)),
    "c3_rs53": (False, jb.bench_rs53, lambda: tb.bench_rs53(CPU)),
    "c5_storm": (False, jb.bench_storm, lambda: tb.bench_storm(CPU)),
    "mesh1_per_device": (
        True, lambda: jb.bench_mesh1(np.random.default_rng(0)),
        lambda: tb.bench_mesh1(np.random.default_rng(0), CPU)),
    "read_index": (False, jb.bench_read_index,
                   lambda: tb.bench_read_index(CPU)),
    "read_scale": (False, jb.bench_read_scale,
                   lambda: tb.bench_read_scale(CPU)),
    "client_chunk": (True, jb.bench_client_latency,
                     lambda: tb.bench_client_latency(CPU)),
    "attribution": (True, jb.bench_attribution,
                    lambda: tb.bench_attribution(CPU)),
    "fusion": (True, jb.bench_fusion, lambda: tb.bench_fusion(CPU)),
    "overload": (False, jb.bench_overload, lambda: tb.bench_overload(CPU)),
    "reconfig": (False, jb.bench_reconfig, lambda: tb.bench_reconfig(CPU)),
    "macro": (False, jb.bench_macro, lambda: tb.bench_macro(CPU)),
    "txn": (False, jb.bench_txn, lambda: tb.bench_txn(CPU)),
    "cluster": (False, jb.bench_cluster, lambda: tb.bench_cluster(CPU)),
    "multi_group": (False, jb.bench_multi_group,
                    lambda: tb.bench_multi_group(CPU)),
    # the JAX sweep on the test process's virtual devices, cut by its
    # deadline after G = 64; the port's whole sweep on two CPU shards
    "group_shard": (False, lambda: jb._group_shard_sweep(2.0),
                    lambda: tb._group_shard_sweep(None, CPU)),
}

_ROWS: dict = {}


def rows(leg: str) -> tuple:
    """(JAX row, port row) of ``leg``, run once per process."""
    if leg not in _ROWS:
        headline, jfn, tfn = LEGS[leg]
        with small(headline):
            _ROWS[leg] = (jfn(), tfn())
    return _ROWS[leg]


#: nested dicts keyed by data (replica ids, refusal reasons, request
#: kinds, metric names), not by the row's schema
DATA_KEYED = ("metrics", "leader_spread", "served_by_replica",
              "shed_by_reason", "net_requests", "wire_refusals")


def keys(row) -> set:
    return set(row) - HARNESS if isinstance(row, dict) else set()


def same_keys(j, t, what, port_only=()):
    """Row keys equal at every level of nested dicts (``port_only`` names
    the keys the port's row adds, each a requirement of the port)."""
    assert keys(t) == keys(j) | set(port_only), (
        f"{what}: port {sorted(keys(t) - keys(j))} jax "
        f"{sorted(keys(j) - keys(t))}")
    for k in keys(j):
        if isinstance(j[k], dict) and isinstance(t.get(k), dict) \
                and k not in DATA_KEYED:
            same_keys(j[k], t[k], f"{what}.{k}")
