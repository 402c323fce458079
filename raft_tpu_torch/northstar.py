"""North-star device runs: ``run_device`` (port of ``northstar.py``'s
``run_device``) and ``run_device_ec``, the RS(5,3) erasure-coded run of
BASELINE config 3 (``bench.py`` ``bench_rs53`` with the lap gate's
read-back).

The deterministic entry stream (``numpy.random.default_rng(seed)``, 256 B
entries at the north-star config) is pushed through
``SingleDeviceTransport.replicate_pipeline`` in chunks of ``CHUNK_STEPS``
full batches — one K3/K4 flight each — or, given a ``MeshTransport``,
through every rank's ``replicate_pipeline`` (K3·mesh/K4·mesh), each rank
reading back its own row. After every chunk the just-committed
window is read back from the follower rows (row 1 unless told otherwise)
and folded into a SHA-256 per row in commit order, beside the SHA-256 of
the submitted entries. The same stream through the JAX package (or its golden
oracle) must give the same digest; only the tests join the two.

``run_device_ec`` streams seeded entries as data-lane windows
(``ec.kernels.fold_data_lanes``) through 32-step flights of
``core.step_cuda.steady_pipeline`` with the in-kernel parity table: K3
decides on the device and K4 turns the ring over, each writing the parity
lanes itself. After every flight the committed window is reconstructed
from every read set (any k rows; a set other than the data rows decodes
with K6) and hashed in commit order beside the input's SHA-256.

``run_device(..., measure_latency=True)`` also reports the p50 and p99 of
per-step time over separate probe flights (CUDA events on the card, the
host clock on the CPU), as the JAX ``northstar.run_device`` does.

``run_golden`` feeds the same stream through the port's golden oracle
(``raft_tpu_torch.golden``, the reference's semantics) and hashes its
committed log in commit order: the digest the device run must match.

Run: python -m raft_tpu_torch.northstar [--entries N] [--seed S]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.state import ReplicaState, fold_batch, log_entries
from raft_tpu_torch.core.step_cuda import steady_pipeline
from raft_tpu_torch.ec.kernels import fold_data_lanes, parity_consts
from raft_tpu_torch.ec.reconstruct import reconstruct
from raft_tpu_torch.ec.rs import RSCode
from raft_tpu_torch.transport.device import SingleDeviceTransport

CHUNK_STEPS = 32     # steps per flight; the ring holds one chunk


class DeviceRun(NamedTuple):
    digest: str            # SHA-256 of row ``rows[0]``'s read-back (None on a
    #                        mesh rank that does not hold it)
    wall_s: float
    state: ReplicaState    # the cluster after the last flight
    input_digest: str      # SHA-256 of the submitted entries, in log order
    row_digests: dict      # follower row -> SHA-256 of its read-back
    p50_us: float = float("nan")   # per-step time of the probe flights
    p99_us: float = float("nan")
    latency_method: str = "skipped"  # "device", "wall" or "skipped"


class ECDeviceRun(NamedTuple):
    set_digests: dict      # read set (tuple of rows) -> SHA-256 of its reads
    wall_s: float
    state: ReplicaState    # the cluster after the last flight
    input_digest: str      # SHA-256 of the submitted entries, in log order
    flights: int


def entry_block(rng: np.random.Generator, n: int, entry: int) -> np.ndarray:
    return rng.integers(0, 256, (n, entry), dtype=np.uint8)


def run_device(cfg: RaftConfig, n_entries: int, seed: int, device=None, *,
               transport=None, state: ReplicaState | None = None,
               rows=(1,), measure_latency: bool = False) -> DeviceRun:
    """Pipeline ``n_entries`` of the seeded stream through chunked flights
    led by row 0 in term 1, reading every committed chunk back from each
    follower row in ``rows``.

    By default a fresh cluster is made on ``device``. ``transport`` and
    ``state`` continue an existing one instead: row 0 must lead it in term
    1 with everything it holds committed, and the stream's entries follow
    its commit index. ``state`` is consumed; the run returns the new one.
    On a ``MeshTransport`` every rank makes this call and reads back its
    own row where it is in ``rows``.

    ``measure_latency`` adds the p50 and p99 of per-step time
    (``step_latency``: separate probe flights on a fresh cluster, after
    the certified stream), as the JAX package's ``northstar.run_device``
    reports them; without it they are NaN and the method "skipped"."""
    tr = transport or SingleDeviceTransport(cfg, device=device)
    dev = tr.device
    B, E, R = cfg.batch_size, cfg.entry_bytes, cfg.n_replicas
    rng = np.random.default_rng(seed)
    state = tr.init() if state is None else state
    alive = torch.ones(cfg.rows, dtype=torch.bool, device=dev)
    slow = torch.zeros(cfg.rows, dtype=torch.bool, device=dev)
    h_in = hashlib.sha256()
    local = {r: i for r in rows if (i := tr.local_row(r)) is not None}
    committed = tr.commit_index(state, 0)
    h_rows = {r: hashlib.sha256() for r in local}
    goal = committed + n_entries
    t0 = time.perf_counter()
    while committed < goal:
        take = min(goal - committed, CHUNK_STEPS * B)
        T = -(-take // B)
        counts = np.full(T, B, np.int32)
        counts[-1] = take - (T - 1) * B
        data = np.zeros((T * B, E), np.uint8)
        data[:take] = entry_block(rng, take, E)
        h_in.update(data[:take].tobytes())
        payload = fold_batch(data, R, device=dev).reshape(T, B, -1)
        state, info = tr.replicate_pipeline(
            state, payload, torch.from_numpy(counts).to(dev), 0, 1, alive,
            slow, term_floor=1)
        new_commit = int(info.commit_index)
        if new_commit != committed + take:
            raise RuntimeError(
                f"commit stalled: {new_commit} != {committed + take}")
        # replication fidelity: read the window back from the followers
        for r, h in h_rows.items():
            h.update(log_entries(state, local[r], committed + 1, new_commit)
                     .tobytes())
        committed = new_commit
    wall = time.perf_counter() - t0
    digests = {r: h.hexdigest() for r, h in h_rows.items()}
    lat = step_latency(tr, cfg, rng) if measure_latency else ()
    return DeviceRun(digests.get(rows[0]) if rows else None, wall, state,
                     h_in.hexdigest(), digests, *lat)


def step_latency(tr, cfg: RaftConfig, rng: np.random.Generator,
                 samples: int = 6) -> tuple:
    """(p50_us, p99_us, method) of per-step time: probe flights of
    ``CHUNK_STEPS`` full windows of seeded entries, led by row 0 in term
    1 on a fresh cluster of ``tr`` (one warm-up flight first), each timed
    alone and divided by its steps. On the card, CUDA events around each
    flight (``samples`` of them; method "device"); on the CPU, the host
    clock around each of 4 (method "wall"). Every rank of a
    ``MeshTransport`` makes this call."""
    dev = tr.device
    B, E, R, T = cfg.batch_size, cfg.entry_bytes, cfg.n_replicas, \
        CHUNK_STEPS
    probe = fold_batch(entry_block(rng, T * B, E), R, device=dev).reshape(
        T, B, -1)
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    alive = torch.ones(cfg.rows, dtype=torch.bool, device=dev)
    slow = torch.zeros(cfg.rows, dtype=torch.bool, device=dev)
    box = {"state": tr.init()}

    def flight():
        box["state"], _ = tr.replicate_pipeline(
            box["state"], probe, counts, 0, 1, alive, slow, term_floor=1)

    flight()
    times = []
    if dev.type == "cuda":
        method = "device"
        for _ in range(samples):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            flight()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e3 / T)
    else:
        method = "wall"
        for _ in range(4):
            t0 = time.perf_counter()
            flight()
            times.append((time.perf_counter() - t0) * 1e6 / T)
    return (float(np.percentile(times, 50)), float(np.percentile(times, 99)),
            method)


def run_device_ec(cfg: RaftConfig, n_entries: int, seed: int, device=None,
                  *, transport: SingleDeviceTransport | None = None,
                  state: ReplicaState | None = None,
                  read_sets=((0, 1, 2), (1, 2, 4))) -> ECDeviceRun:
    """Pipeline ``n_entries`` of the seeded stream through an
    erasure-coded cluster (``cfg.rs_k`` set) in flights of ``CHUNK_STEPS``
    full batches (fewer when the ring is shorter: a flight never outruns
    the read-back), led by row 0 in term 1 at the commit quorum of
    ``cfg.commit_quorum``. After each flight the committed window is
    reconstructed from every row set in ``read_sets`` and folded into
    that set's SHA-256. Raises on a commit stall.

    ``transport`` and ``state`` continue an existing cluster as in
    ``run_device``; ``state`` is consumed."""
    if not cfg.ec_enabled:
        raise ValueError("run_device_ec needs an erasure-coded config "
                         "(rs_k set)")
    tr = transport or SingleDeviceTransport(cfg, device=device)
    dev = tr.device
    B, E, R = cfg.batch_size, cfg.entry_bytes, cfg.rows
    code = RSCode(cfg.n_replicas, cfg.rs_k)
    consts = parity_consts(code.n, code.k)
    steps = max(1, min(CHUNK_STEPS, cfg.log_capacity // B))
    rng = np.random.default_rng(seed)
    state = tr.init() if state is None else state
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    slow = torch.zeros(R, dtype=torch.bool, device=dev)
    h_in = hashlib.sha256()
    h_sets = {tuple(rs): hashlib.sha256() for rs in read_sets}
    committed = int(state.commit_index[0])
    goal = committed + n_entries
    flights = 0
    t0 = time.perf_counter()
    while committed < goal:
        take = min(goal - committed, steps * B)
        T = -(-take // B)
        counts = np.full(T, B, np.int32)
        counts[-1] = take - (T - 1) * B
        data = np.zeros((T * B, E), np.uint8)
        data[:take] = entry_block(rng, take, E)
        h_in.update(data[:take].tobytes())
        wins = fold_data_lanes(torch.from_numpy(data).to(dev)).reshape(
            T, B, E // 4)
        state, info = steady_pipeline(
            state, wins, torch.from_numpy(counts).to(dev), 0, 1, alive, slow,
            0, 0, None, 1, commit_quorum=cfg.commit_quorum,
            ec_consts=consts)
        flights += 1
        new_commit = int(info.commit_index)
        if new_commit != committed + take:
            raise RuntimeError(
                f"commit stalled: {new_commit} != {committed + take}")
        for rs, h in h_sets.items():
            h.update(reconstruct(state, code, rs, committed + 1, new_commit)
                     .tobytes())
        committed = new_commit
    wall = time.perf_counter() - t0
    return ECDeviceRun({rs: h.hexdigest() for rs, h in h_sets.items()}, wall,
                       state, h_in.hexdigest(), flights)


def run_golden(n_entries: int, entry: int, seed: int, batch: int = 1024,
               n_replicas: int = 3) -> str:
    """The SHA-256 of the golden oracle's committed log for the seeded
    stream of ``n_entries`` ``entry``-byte entries, fed ``batch`` at a
    time and hashed in commit order (the JAX ``northstar.run_golden``)."""
    from raft_tpu_torch.golden import GoldenCluster

    c = GoldenCluster(n_replicas, seed=0)
    lead = c.run_until_leader()
    rng = np.random.default_rng(seed)
    h = hashlib.sha256()
    done = 0
    while done < n_entries:
        take = min(n_entries - done, batch)
        for row in entry_block(rng, take, entry):
            lead.client_append(row.tobytes())
        guard = 0
        while lead.commit_index < lead.last_applied:
            c._leader_tick(lead)
            guard += 1
            if guard >= 100:
                raise RuntimeError("golden commit stalled")
        # the oracle's stored committed bytes (its log, not the input
        # echo), in commit order: what the device side hashes from a
        # follower row
        for e in lead.log[done:done + take]:
            h.update(e.payload)
        done += take
    if lead.commit_index != n_entries:
        raise RuntimeError(f"golden committed {lead.commit_index} of "
                           f"{n_entries}")
    return h.hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--entries", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = RaftConfig(log_capacity=CHUNK_STEPS * 1024)
    run = run_device(cfg, args.entries, args.seed, measure_latency=True)
    golden = run_golden(args.entries, cfg.entry_bytes, args.seed,
                        n_replicas=cfg.n_replicas)
    print(json.dumps({"north_star": {
        "entries": args.entries, "sha256": run.digest,
        "sha256_input": run.input_digest,
        "read_back_ok": run.digest == run.input_digest,
        "byte_identical": run.digest == golden, "wall_s": run.wall_s,
        "p50_us": run.p50_us, "p99_us": run.p99_us,
        "method": run.latency_method,
        "device": torch.cuda.get_device_name(0),
    }}))
    if run.digest != golden:
        raise SystemExit("FAIL: committed logs diverge from the golden "
                         "oracle's")


if __name__ == "__main__":
    main()
