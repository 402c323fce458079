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
               rows=(1,)) -> DeviceRun:
    """Pipeline ``n_entries`` of the seeded stream through chunked flights
    led by row 0 in term 1, reading every committed chunk back from each
    follower row in ``rows``.

    By default a fresh cluster is made on ``device``. ``transport`` and
    ``state`` continue an existing one instead: row 0 must lead it in term
    1 with everything it holds committed, and the stream's entries follow
    its commit index. ``state`` is consumed; the run returns the new one.
    On a ``MeshTransport`` every rank makes this call and reads back its
    own row where it is in ``rows``."""
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
    return DeviceRun(digests.get(rows[0]) if rows else None, wall, state,
                     h_in.hexdigest(), digests)


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--entries", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = RaftConfig(log_capacity=CHUNK_STEPS * 1024)
    run = run_device(cfg, args.entries, args.seed)
    print(json.dumps({"north_star": {
        "entries": args.entries, "sha256": run.digest,
        "sha256_input": run.input_digest,
        "read_back_ok": run.digest == run.input_digest, "wall_s": run.wall_s,
        "device": torch.cuda.get_device_name(0),
    }}))


if __name__ == "__main__":
    main()
