#!/usr/bin/env python3
"""Smoke run of raft_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``raft_tpu_torch/csrc`` and, at the
north-star deployment (3 replicas, 256-byte entries, batch 1024, a
32 768-slot ring):

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the kernels (all ``nvcc`` runs in parallel) and prints the time;
3. holds every kernel against its plain PyTorch version on the card, bit
   for bit, on seam, partial, slow-row, dead-row, conflict, infeasible and
   turnover cases, then through a 200-step randomized multi-term schedule
   (kernel path on the card, plain path on the host);
4. drives the main path through ``SingleDeviceTransport``: election,
   repair-capable ticks healing a slow row, steady ticks, then the port's
   ``northstar.run_device`` on the same cluster with pipeline flights
   until 1 048 576 entries have committed (32 ring laps), a leader kill
   with re-election and catch-up; follower read-back hashes must equal the
   input stream's, and every kernel must have launched;
5. times each kernel (CUDA events, median of >= 20) beside its plain
   version and its byte bound, and the main path per step;
6. prints the kernel table, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure ends the run with a nonzero exit code before the last line.
It needs the repository checkout around it and a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SEED = 20261016
ENTRIES = 1 << 20
STEPS_PER_FLIGHT = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# --------------------------------------------------------------- phase 1
def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0].strip()
    card = {"phase": "card", "nvidia_smi": line,
            "torch_name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(card)
    return line


def mem_rate(name: str) -> float:
    """Peak device-memory bytes/s of the named card (data-sheet values)."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    return 3.35e12          # H100 SXM


# --------------------------------------------------------------- phase 2
def phase_build():
    from raft_tpu_torch import cuda_build

    report = cuda_build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln][:12]
             for name, log in report["logs"].items()}
    for name in cuda_build.SOURCES:
        cuda_build.lib(name)
    emit({"phase": "build", "seconds": report["seconds"], "ptxas": ptxas})


# --------------------------------------------------------------- phase 3
def ns_config():
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=256, batch_size=1024,
                      log_capacity=STEPS_PER_FLIGHT * 1024,
                      transport="single")


def max_err(pairs) -> int:
    """Largest absolute difference over (a, b) tensor pairs (int64)."""
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.cpu().long() - b.cpu().long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def steady_state(cfg, dev, last, lterm=1, rng=None):
    """A caught-up, fully committed cluster whose rows all end at ``last``
    (every ring slot holds entries of term ``lterm`` and random bytes)."""
    import torch

    from raft_tpu_torch.core.state import init_state

    st = init_state(cfg, device=dev)
    for f in ("last_index", "commit_index", "match_index"):
        getattr(st, f).fill_(last)
    st.term.fill_(lterm)
    st.match_term.fill_(lterm)
    st.voted_for.fill_(0)
    st.log_term.fill_(lterm)
    g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
    st.log_payload.copy_(torch.randint(-2**31, 2**31 - 1,
                                       st.log_payload.shape, generator=g,
                                       dtype=torch.int32))
    return st


def rand_window(rng, B, M, dev):
    import torch

    return torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (B, M), dtype=np.int64)
        .astype(np.int32)).to(dev)


def phase_kernels(cfg, dev, n_random=200):
    """Every kernel against its plain version on the same inputs."""
    import torch

    from raft_tpu_torch.core import ring_cuda, step_cuda as sc

    rng = np.random.default_rng(SEED)
    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    errs = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    cases = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    # K1 — seam, partial count, mixed accept, truncating conflict
    for s, count, acc, conflict in [
            (0, B, [1, 1, 1], False), (C - B + 300, B, [1, 0, 1], False),
            (C - 1, 777, [1, 1, 0], False), (4096, 777, [0, 0, 0], False),
            (C - 200, B, [1, 1, 1], True), (12345, 0, [1, 1, 1], True)]:
        buf_p = rand_window(rng, C, M, dev)
        buf_t = torch.from_numpy(rng.integers(1, 4, (L, C)).astype(
            np.int32)).to(dev)
        win = rand_window(rng, B, M, dev)
        win_t = torch.from_numpy(rng.integers(1, 4, B).astype(
            np.int32)).to(dev)
        ws = s + 1 + 3 * C
        last = torch.from_numpy(rng.integers(ws - 5, ws + B + 5, L).astype(
            np.int32)).to(dev)
        if conflict:
            win_t.fill_(3)
            slots = (s + torch.arange(B, device=dev)) % C
            buf_t[:, slots] = 3
            buf_t[1, slots[min(count, B) // 2]] = 2   # stale term, row 1
            last.fill_(ws + B + 9)
        accept = torch.tensor(acc, dtype=torch.bool, device=dev)
        a = (buf_p.clone(), buf_t.clone())
        b = (buf_p.clone(), buf_t.clone())
        mm_k = ring_cuda.write_window_both(a[0], a[1], win, win_t, s, count,
                                           ws, accept, last)
        mm_p = ring_cuda.write_window_both_plain(
            b[0], b[1], win, win_t, s, count, ws, accept, last)
        if conflict and count:
            check(int(mm_k[1]) == 1, "K1 conflict flag not raised")
        errs["K1"] = max(errs["K1"], max_err(
            [(a[0], b[0]), (a[1], b[1]), (mm_k, mm_p)]))
        cases["K1"] += 1

    def k2_case(st, count, alive, slow, lterm=1, tfloor=1, leader=0):
        prm = sc.step_params(leader, lterm, tfloor, 0, 0, None, L)
        al = torch.tensor(alive, dtype=torch.bool, device=dev)
        sl = torch.tensor(slow, dtype=torch.bool, device=dev)
        win = rand_window(rng, B, M, dev)
        outs = []
        for fn in (sc.steady_step, sc.steady_step_plain):
            s2 = st.clone()
            v = sc.pack(s2)
            out = torch.zeros(2 * L + 5, dtype=torch.int32, device=dev)
            fn(v, s2.log_payload, s2.log_term, win, count, al, sl, None,
               prm, out)
            outs.append((v, s2, out))
        (vk, sk, ok_), (vp, sp, op) = outs
        errs["K2"] = max(errs["K2"], max_err(
            [(vk, vp), (ok_, op), (sk.log_payload, sp.log_payload),
             (sk.log_term, sp.log_term)]))
        cases["K2"] += 1

    base = steady_state(cfg, dev, 5 * B, rng=rng)
    seam = steady_state(cfg, dev, 3 * C - B + 300, rng=rng)
    k2_case(base, B, [1, 1, 1], [0, 0, 0])
    k2_case(seam, B, [1, 1, 1], [0, 0, 0])                # wrap seam
    k2_case(seam, 777, [1, 1, 1], [0, 0, 1])              # partial, slow row
    k2_case(base, B, [1, 1, 0], [0, 0, 0])                # dead row
    k2_case(base, B, [1, 1, 1], [0, 1, 1])                # no quorum
    k2_case(base, B, [1, 1, 1], [0, 0, 0], lterm=2, tfloor=5 * B + 1)
    conflict = base.clone()                               # stale suffix
    conflict.last_index[2] = 5 * B + 700
    conflict.log_term[2, 5 * B:5 * B + 300] = 0
    k2_case(conflict, B, [1, 1, 1], [0, 0, 0], lterm=2, tfloor=5 * B + 1)

    def scan_case(st, counts, alive, slow):
        """K2 as the main path reaches it: a steady scan whose counts stay
        on the device (each launch reads its count through a view)."""
        from raft_tpu_torch.core.state import (FIELDS, state_from_numpy,
                                               state_to_numpy)

        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        pays = torch.stack([rand_window(rng, B, M, dev) for _ in counts])
        al = torch.tensor(alive, dtype=torch.bool, device=dev)
        sl = torch.tensor(slow, dtype=torch.bool, device=dev)
        n0 = sc.LAUNCHES["steady_step"]
        res = [sc.steady_scan_replicate(s2, pays, cnt, 0, 1, al, sl, 0, 0,
                                        None, 1)
               for s2 in (st.clone(),
                          state_from_numpy(state_to_numpy(st), "cpu"))]
        check(sc.LAUNCHES["steady_step"] - n0 == len(counts),
              "the scan did not launch K2 once per step")
        (sk, ik), (sp, ip) = res
        check(sk.log_payload.is_cuda and not sp.log_payload.is_cuda,
              "scan case: kernel side on the card, plain side on the host")
        errs["K2"] = max(errs["K2"], max_err(
            [(getattr(sk, f), getattr(sp, f)) for f in FIELDS]
            + [(getattr(ik, f), getattr(ip, f)) for f in ik._fields]))
        cases["K2"] += 1

    scan_case(seam, [B, 777, 0, B, 1, B], [1, 1, 1], [0, 0, 1])
    scan_case(base, [0, B, 300, B], [1, 1, 0], [0, 0, 0])

    def flight_case(st, T, P, counts, alive, slow, turnover_ok, tag):
        prm = sc.step_params(0, 1, 1, 0, 0, None, L)
        al = torch.tensor(alive, dtype=torch.bool, device=dev)
        sl = torch.tensor(slow, dtype=torch.bool, device=dev)
        wins = torch.stack([rand_window(rng, B, M, dev) for _ in range(P)])
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        work = sc.workspace(dev)
        res = []
        for kernel in (True, False):
            s2 = st.clone()
            v = sc.pack(s2)
            out = torch.zeros(L + 5, dtype=torch.int32, device=dev)
            r4 = int(work[sc.WK_RAN4])
            if kernel:
                sc.pipeline_flight(v, s2.log_payload, s2.log_term, wins, cnt,
                                   al, sl, None, prm, sc.pick_br(B, C),
                                   turnover_ok, out)
                if turnover_ok:
                    sc.turnover_flight(v, s2.log_payload, s2.log_term, wins,
                                       T, prm, out)
            else:
                sc.pipeline_flight_plain(v, s2.log_payload, s2.log_term, wins,
                                         cnt, al, sl, None, prm,
                                         sc.pick_br(B, C), turnover_ok, out,
                                         work)
                if turnover_ok:
                    sc.turnover_flight_plain(v, s2.log_payload, s2.log_term,
                                             wins, T, prm, out, work)
            res.append((v, s2, out, int(work[sc.WK_RAN4]) - r4))
        (vk, sk, ok_, k4k), (vp, sp, op, k4p) = res
        check(k4k == k4p, f"{tag}: kernel and plain took different branches")
        which = "K4" if k4k else "K3"
        errs[which] = max(errs[which], max_err(
            [(vk, vp), (ok_, op), (sk.log_payload, sp.log_payload),
             (sk.log_term, sp.log_term)]))
        cases[which] += 1
        return which

    T = STEPS_PER_FLIGHT
    full = [B] * T
    check(flight_case(base, T, 4, full, [1, 1, 1], [0, 0, 0], False,
                      "all-accept flight") == "K3", "K3 flight")
    part = list(full)
    part[5], part[17] = 300, 0
    check(flight_case(base, T, 3, part, [1, 1, 1], [0, 0, 1], True,
                      "infeasible flight") == "K3", "infeasible K3")
    check(flight_case(seam, 8, 8, [B] * 8, [1, 1, 0], [0, 0, 0], True,
                      "dead-row seam flight") == "K3", "seam K3")
    check(flight_case(base, T, T, full, [1, 1, 1], [0, 0, 0], True,
                      "turnover flight") == "K4", "K4 flight")
    check(flight_case(base, 2 * T + 5, 7, [B] * (2 * T + 5), [1, 1, 1],
                      [0, 0, 0], True, "lapped turnover") == "K4",
          "lapped K4")

    # randomized multi-term schedules: kernel path on the card, plain path
    # on the host, through the public step functions — at the north-star
    # shape (16-byte lane vectors), and at shapes whose lane blocks are
    # not whole int4s or whose window is not a multiple of 128 rows
    from raft_tpu_torch.config import RaftConfig

    rsteps = {"north_star": random_schedule(cfg, dev, n_random, rng)}
    for name, kw in (("r3_w2_b4", dict(n_replicas=3, entry_bytes=8,
                                       batch_size=4, log_capacity=32)),
                     ("r5_w3_b96", dict(n_replicas=5, entry_bytes=12,
                                        batch_size=96, log_capacity=288))):
        small = RaftConfig(transport="single", **kw)
        rsteps[name] = random_schedule(small, dev, n_random // 2, rng)
    for k in errs:
        check(errs[k] == 0, f"{k} differs from its plain version by "
                            f"{errs[k]}")
    emit({"phase": "kernels_vs_plain", "cases": cases,
          "max_abs_err": errs, "random_schedule_steps": rsteps})
    return errs


def random_schedule(cfg, dev, n, rng):
    import torch

    from raft_tpu_torch.core.comm import SingleDeviceComm
    from raft_tpu_torch.core.state import FIELDS, fold_batch, init_state
    from raft_tpu_torch.core.step import replicate_step, vote_step
    from raft_tpu_torch.core.step_cuda import steady_pipeline

    R, B, E, C = cfg.rows, cfg.batch_size, cfg.entry_bytes, cfg.log_capacity
    comm = SingleDeviceComm(R)
    sts = {"k": init_state(cfg, device=dev), "p": init_state(cfg, device="cpu")}
    term, leader, floor = 1, 0, 1
    ones = [True] * R

    def both(fn, *args, **kw):
        infos = {}
        for side, d in (("k", dev), ("p", "cpu")):
            conv = [a.to(d) if isinstance(a, torch.Tensor) else a
                    for a in args]
            sts[side], infos[side] = fn(sts[side], *conv, **kw)
        for f in infos["k"]._fields:
            a, b = getattr(infos["k"], f), getattr(infos["p"], f)
            check(torch.equal(a.cpu(), b.cpu()), f"schedule info.{f}")
        return infos["k"]

    def vote(cand, t, alive):
        return both(lambda st, *a: vote_step(comm, st, *a), cand, t,
                    torch.tensor(alive))

    vote(leader, term, ones)
    steps = 0
    while steps < n:
        if rng.random() < 0.08:
            term += int(rng.integers(1, 3))
            leader = int(rng.integers(0, R))
            vote(leader, term, list(rng.random(R) > 0.2))
            floor = int(sts["p"].last_index[leader]) + 1
        alive = list(rng.random(R) > 0.1)
        alive[leader] = True
        slow = list(rng.random(R) < 0.15)
        member = None
        if rng.random() < 0.2:              # a configuration mask
            member = list(rng.random(R) < 0.8)
            member[leader] = True
            member = torch.tensor(member)
        kind = rng.choice(["repair", "steady", "flight"], p=[0.4, 0.45, 0.15])
        if kind == "flight":
            T = int(rng.integers(2, 6))
            if rng.random() < 0.3:           # a flight that laps the ring
                T = C // B + int(rng.integers(0, 3))
            counts = [B] * T
            if rng.random() < 0.5:
                counts[-1] = int(rng.integers(0, B))
            data = rng.integers(0, 256, (T * B, E), dtype=np.uint8)
            wins = fold_batch(data, R).reshape(T, B, -1)
            both(lambda st, *a: steady_pipeline(st, *a), wins,
                 torch.tensor(counts, dtype=torch.int32), leader, term,
                 torch.tensor(alive), torch.tensor(slow), 0, 0, member,
                 floor)
            steps += T
        else:
            count = int(rng.choice([0, 3, 17, 777, B]))
            data = rng.integers(0, 256, (B, E), dtype=np.uint8)
            data[count:] = 0
            steady = kind == "steady"
            both(lambda st, *a, **k: replicate_step(comm, st, *a, **k),
                 fold_batch(data, R), count, leader, term,
                 torch.tensor(alive), torch.tensor(slow), 0, 0, member,
                 repair=not steady, term_floor=floor if steady else None)
            steps += 1
        if steps % 25 < 5 or steps >= n:
            for f in FIELDS:
                check(torch.equal(getattr(sts["k"], f).cpu(),
                                  getattr(sts["p"], f)),
                      f"schedule state.{f} after {steps} steps")
    return steps


# --------------------------------------------------------------- phase 4
def zero_counters(dev):
    from raft_tpu_torch.core import ring_cuda, step_cuda

    for d in (ring_cuda.LAUNCHES, step_cuda.LAUNCHES):
        for k in d:
            d[k] = 0
    w = step_cuda.workspace(dev)
    w[step_cuda.WK_RAN3] = 0
    w[step_cuda.WK_RAN4] = 0


def read_counters(dev):
    from raft_tpu_torch.core import ring_cuda, step_cuda

    w = step_cuda.workspace(dev)
    return {
        "K1": ring_cuda.LAUNCHES["write_window_both"],
        "K2": step_cuda.LAUNCHES["steady_step"],
        "K3": step_cuda.LAUNCHES["pipeline_flight"],
        "K4": step_cuda.LAUNCHES["turnover_flight"],
        "K3_flights_run": int(w[step_cuda.WK_RAN3]),
        "K4_flights_run": int(w[step_cuda.WK_RAN4]),
    }


class Stream:
    """The client stream: seeded entries, the input hash in index order,
    and per-follower read-back hashes of what each row has committed."""

    def __init__(self, cfg, rows=(1, 2)):
        self.rng = np.random.default_rng(SEED + 1)
        self.cfg = cfg
        self.submitted = 0
        self.h_in = hashlib.sha256()
        self.rows = rows
        self.h_row = {r: hashlib.sha256() for r in rows}
        self.done = {r: 0 for r in rows}

    def batches(self, T, counts):
        """u8 entries for T windows of B (zero past each count)."""
        from raft_tpu_torch.core.state import fold_batch

        B, E = self.cfg.batch_size, self.cfg.entry_bytes
        data = np.zeros((T * B, E), np.uint8)
        for t, c in enumerate(counts):
            chunk = self.rng.integers(0, 256, (c, E), dtype=np.uint8)
            data[t * B:t * B + c] = chunk
            self.h_in.update(chunk.tobytes())
            self.submitted += c
        return fold_batch(data, self.cfg.rows).reshape(T, B, -1)

    def read_back(self, state):
        from raft_tpu_torch.core.state import log_entries

        commits = state.commit_index.tolist()
        for r in self.rows:
            hi = commits[r]
            check(hi - self.done[r] <= self.cfg.log_capacity,
                  f"row {r} fell a ring behind the read-back")
            if hi > self.done[r]:
                self.h_row[r].update(
                    log_entries(state, r, self.done[r] + 1, hi).tobytes())
                self.done[r] = hi

    def skip(self, n):
        """``n`` entries that another stream submitted and read back."""
        check(all(d == self.submitted for d in self.done.values()),
              "a follower's read-back lags before the skip")
        self.submitted += n
        self.done = {r: self.submitted for r in self.rows}


def phase_main_path(cfg, dev, entries=ENTRIES):
    import torch

    from raft_tpu_torch.northstar import run_device
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    tr = SingleDeviceTransport(cfg, device=dev)
    R, B, C = cfg.rows, cfg.batch_size, cfg.log_capacity
    T = STEPS_PER_FLIGHT
    S = Stream(cfg)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    quiet = torch.zeros(R, dtype=torch.bool, device=dev)
    slow2 = torch.tensor([False, False, True], device=dev)
    zero_counters(dev)
    t_all = time.perf_counter()
    state = tr.init()

    # election: row 0 wins term 1
    state, vi = tr.request_votes(state, 0, 1, alive)
    check(int(vi.votes) == R and bool(vi.grants.all()), "election of row 0")

    # repair-capable ticks (K1): row 2 slow, then healed by the repair window
    for _ in range(4):
        state, info = tr.replicate(state, S.batches(1, [B])[0], B, 0, 1,
                                   alive, slow2)
        check(int(info.frontier_len) == B, "tick ingest")
    check(int(info.match[2]) == 0, "slow row stays behind")
    heal = 0
    while int(info.match[2]) < S.submitted:
        state, info = tr.replicate(state, S.batches(1, [0])[0], 0, 0, 1,
                                   alive, quiet)
        heal += 1
        check(heal <= 8, "repair window did not heal row 2")
    S.read_back(state)

    # steady ticks through the whole-step kernel (K2), as one scan
    pays = S.batches(8, [B] * 8)
    state, infos = tr.replicate_many(state, pays, torch.full(
        (8,), B, dtype=torch.int32, device=dev), 0, 1, alive, quiet,
        repair=False, term_floor=1)
    check(int(infos.commit_index[-1]) == S.submitted, "steady scan commit")
    S.read_back(state)

    # saturated flights (K3/K4) through the port's north-star entry point:
    # 32 ring laps of 32 x 1024 entries, read back from both followers
    flights = -(-entries // (T * B))
    run = run_device(cfg, entries, SEED + 3, transport=tr, state=state,
                     rows=S.rows)
    state = run.state
    S.skip(entries)
    check(state.commit_index.tolist()[0] == S.submitted, "flight commit")
    for r in S.rows:
        check(run.row_digests[r] == run.input_digest,
              f"row {r} read-back of the flights differs from their input")

    # leader kill: row 0 dies, row 1 wins term 2 and keeps committing
    alive01 = torch.tensor([False, True, True], device=dev)
    state, vi = tr.request_votes(state, 1, 2, alive01)
    check(int(vi.votes) == 2, "re-election of row 1")
    floor2 = int(state.last_index[1]) + 1
    state, info = tr.replicate(state, S.batches(1, [B])[0], B, 1, 2,
                               alive01, quiet)
    check(int(info.commit_index) == S.submitted, "term-2 commit")
    S.read_back(state)
    Tk = 8
    state, info = tr.replicate_pipeline(
        state, S.batches(Tk, [B] * Tk).to(dev), torch.full(
            (Tk,), B, dtype=torch.int32, device=dev), 1, 2, alive01, quiet,
        term_floor=floor2)
    check(int(info.commit_index) == S.submitted, "flight without row 0")
    S.read_back(state)
    # row 0 returns and catches up through the repair window. Its match is
    # not verified for term 2, so repair restarts at the leader's ring
    # horizon; the slot before it was overwritten by a later lap, so (as
    # the engine does) the step gets the ring-validity floor and the
    # attested term of the entry below it: term 1, written before the kill
    floor = S.submitted - C + 1
    check(floor - 1 <= floor2 - 1, "attested entry predates the kill")
    catch = 0
    while int(info.match[0]) < S.submitted:
        state, info = tr.replicate(state, S.batches(1, [0])[0], 0, 1, 2,
                                   alive, quiet, repair_floor=floor,
                                   floor_prev_term=1)
        catch += 1
        check(catch <= C // B + 4, "row 0 did not catch up")
    S.read_back(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    counters = read_counters(dev)

    commits = state.commit_index.tolist()
    check(commits == [S.submitted] * R, f"commit {commits} != "
                                        f"{S.submitted} submitted")
    digest = S.h_in.hexdigest()
    for r in S.rows:
        check(S.h_row[r].hexdigest() == digest,
              f"row {r} read-back differs from the input stream")
    for k in ("K1", "K2", "K3", "K4", "K3_flights_run", "K4_flights_run"):
        check(counters[k] > 0, f"{k} never ran on the main path")
    result = {
        "phase": "main_path", "entries_committed": S.submitted,
        "pipeline_entries": entries, "pipeline_flights": flights,
        "ring_laps": entries // C,
        "heal_ticks": heal, "catch_up_ticks": catch,
        # the ticks around the flights, and the flights themselves
        "sha256_input": digest,
        "sha256_rows": {str(r): S.h_row[r].hexdigest() for r in S.rows},
        "flights_sha256_input": run.input_digest,
        "flights_sha256_rows": {str(r): d for r, d in run.row_digests.items()},
        "launches": counters,
        # run_device on the host clock: stream generation, fold, upload,
        # flights, follower read-back and the three SHA-256 folds
        "pipeline_wall_s": run.wall_s,
        "pipeline_us_per_step_wall": run.wall_s * 1e6 / (flights * T),
        "pipeline_entries_per_s_wall": entries / run.wall_s,
        "main_path_wall_s": wall,
    }
    emit(result)
    return result


# --------------------------------------------------------------- phase 5
def _events_ms(fn, reps, inner=1, before=None):
    """Median device ms of one ``fn`` call: CUDA events around ``inner``
    back-to-back calls, ``reps`` times (``before`` runs outside them)."""
    import torch

    for _ in range(2):
        if before:
            before()
        fn()
    times = []
    for _ in range(reps):
        if before:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _host_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_events(fn, reps, before=None):
    """Device activity of ``reps`` calls under torch.profiler: a list of
    (name, microseconds) for every kernel, copy and fill on the card, and
    the host wall seconds of the profiled loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            if before:
                before()
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return dev, wall


#: the CUDA function behind each kernel, as the profiler names it
KERNEL_FN = {"K1": "write_window_both_kernel", "K2": "steady_step_kernel",
             "K3": "steady_pipeline_kernel", "K4": "turnover_kernel"}


def kernel_ms(key, fn, reps, before=None, inner=1):
    """The kernel's device time per launch (median, profiler), and the
    wrapper's time per call (CUDA events around back-to-back calls)."""
    call_ms = _events_ms(fn, reps, inner=inner, before=before)
    for attempt in range(3):
        dev, _ = _device_events(fn, reps, before=before)
        mine = [us for name, us in dev if KERNEL_FN[key] in name]
        if len(mine) == reps:
            return statistics.median(mine) / 1e3, call_ms
        # a profiler session now and then records no device activity
        print(f"profiler session {attempt + 1} recorded {len(mine)} of "
              f"{reps} launches of {KERNEL_FN[key]} ({len(dev)} device "
              f"events: {sorted({n for n, _ in dev})[:4]})", file=sys.stderr)
    raise RuntimeError(f"the profiler did not record the launches of "
                       f"{KERNEL_FN[key]}")


def phase_timing(cfg, dev, card_line, reps=21):
    import torch

    from raft_tpu_torch.core import ring_cuda, step_cuda as sc

    rng = np.random.default_rng(SEED + 2)
    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    T = STEPS_PER_FLIGHT
    rate = mem_rate(card_line)
    al = torch.ones(L, dtype=torch.bool, device=dev)
    sl = torch.zeros(L, dtype=torch.bool, device=dev)
    prm = sc.step_params(0, 1, 1, 0, 0, None, L)
    out = {}

    # K1: a main-path frontier window (count = B, every row accepting)
    st = steady_state(cfg, dev, 5 * B, rng=rng)
    win = rand_window(rng, B, M, dev)
    win_t = torch.ones(B, dtype=torch.int32, device=dev)
    s = torch.tensor(5 * B % C, dtype=torch.int32, device=dev)
    cnt = torch.tensor(B, dtype=torch.int32, device=dev)
    ws = torch.tensor(5 * B + 1, dtype=torch.int32, device=dev)
    last = st.last_index.clone()

    def k1():
        ring_cuda.write_window_both(st.log_payload, st.log_term, win, win_t,
                                    s, cnt, ws, al, last)

    def k1p():
        ring_cuda.write_window_both_plain(st.log_payload, st.log_term, win,
                                          win_t, s, cnt, ws, al, last)

    # bytes: window read + payload write, term read + write, win_t, masks
    k1_bytes = 2 * B * M * 4 + 2 * L * B * 4 + B * 4 + 2 * L * 4 + 12
    out["K1"] = (kernel_ms("K1", k1, reps, inner=20), _host_ms(k1p, reps),
                 k1_bytes)

    # K2: steady steps at the main-path shape (each appends and commits B)
    st = steady_state(cfg, dev, 5 * B, rng=rng)
    vecs = sc.pack(st)
    o2 = torch.zeros(2 * L + 5, dtype=torch.int32, device=dev)

    def k2():
        sc.steady_step(vecs, st.log_payload, st.log_term, win, B, al, sl,
                       None, prm, o2)

    def k2p():
        sc.steady_step_plain(vecs, st.log_payload, st.log_term, win, B, al,
                             sl, None, prm, o2)

    step_bytes = 2 * B * M * 4 + 2 * L * B * 4 + 2 * 6 * L * 4 + \
        (2 * L + 5) * 4 + 2 * L
    out["K2"] = (kernel_ms("K2", k2, reps, inner=20), _host_ms(k2p, reps),
                 step_bytes)

    # K3: one main-path flight, 32 steps over 32 distinct windows (every
    # row accepting, turnover not allowed), so each step reads its own
    # window: T times a K2 step's bytes
    wins32 = torch.stack([rand_window(rng, B, M, dev) for _ in range(T)])
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    o3 = torch.zeros(L + 5, dtype=torch.int32, device=dev)
    br = sc.pick_br(B, C)

    def k3():
        sc.pipeline_flight(vecs, st.log_payload, st.log_term, wins32, counts,
                           al, sl, None, prm, br, False, o3)

    def k3p():
        sc.pipeline_flight_plain(vecs, st.log_payload, st.log_term, wins32,
                                 counts, al, sl, None, prm, br, False, o3,
                                 sc.workspace(dev))

    out["K3"] = (kernel_ms("K3", k3, reps), _host_ms(k3p, reps),
                 T * step_bytes)
    grid = sc.pipeline_flight(vecs, st.log_payload, st.log_term, wins32,
                              counts, al, sl, None, prm, br, False, o3)

    # K4: the turnover flight (K3 decides on the device, K4 writes)
    def plan():
        sc.pipeline_flight(vecs, st.log_payload, st.log_term, wins32,
                           counts, al, sl, None, prm, br, True, o3)

    def k4():
        sc.turnover_flight(vecs, st.log_payload, st.log_term, wins32, T,
                           prm, o3)

    def k4p():
        w = sc.workspace(dev)
        sc.pipeline_flight_plain(vecs, st.log_payload, st.log_term, wins32,
                                 counts, al, sl, None, prm, br, True, o3, w)
        sc.turnover_flight_plain(vecs, st.log_payload, st.log_term, wins32,
                                 T, prm, o3, w)

    work = sc.workspace(dev)
    ran4 = int(work[sc.WK_RAN4])
    k4_time = kernel_ms("K4", k4, reps, before=plan)
    # every timed K4 launch must have written its flight
    check(int(work[sc.WK_RAN4]) - ran4 == 2 * reps + 2,
          "timed turnover launches did not all run the flight")
    # bytes: every payload slot written once from the window rows that
    # survive the flight (T*B = C here), every term slot written once
    k4_bytes = 2 * C * M * 4 + L * C * 4 + 2 * 6 * L * 4
    out["K4"] = (k4_time, _host_ms(k4p, reps), k4_bytes)
    plan_ms = kernel_ms("K3", plan, reps)

    # K3 as it runs a flight on the main path (after the leader kill): 8
    # steps with a dead row, on a cluster of its own. Only the live rows'
    # window lanes and term slots need to move.
    st8 = steady_state(cfg, dev, 5 * B, rng=rng)
    v8 = sc.pack(st8)
    dead = torch.tensor([True, True, False], device=dev)
    T8 = 8

    def k3_dead():
        sc.pipeline_flight(v8, st8.log_payload, st8.log_term, wins32[:T8],
                           counts[:T8], dead, sl, None, prm, br, False, o3)

    dead_ms = kernel_ms("K3", k3_dead, reps)
    live = L - 1
    dead_bytes = T8 * (2 * B * live * cfg.shard_words * 4
                       + 2 * live * B * 4) + 2 * 6 * L * 4 + (L + 5) * 4
    torch.cuda.synchronize()
    res = {"phase": "timing", "card": card_line, "mem_bytes_per_s": rate,
           "k3_grid_blocks": grid, "k3_decision_only": {
               "ms": plan_ms[0], "call_ms": plan_ms[1]},
           "k3_dead_row_8_steps": {
               "ms": dead_ms[0], "call_ms": dead_ms[1], "bytes": dead_bytes,
               "bound_ms": dead_bytes / rate * 1e3}}
    for k, ((ms, call_ms), pms, nbytes) in out.items():
        res[k] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms,
                  "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}
    res["main_path_profile"] = profile_flights(cfg, dev)
    emit(res)
    return res


def profile_flights(cfg, dev, flights=4):
    """Where a main-path flight's time goes: ``run_device`` over
    ``flights`` saturated flights, host work included (stream generation,
    fold, upload, follower read-back, hashing), under the profiler —
    device time by kernel, and the device's idle share of its wall time."""
    from raft_tpu_torch.northstar import run_device

    B, T = cfg.batch_size, STEPS_PER_FLIGHT
    warm = run_device(cfg, T * B, SEED + 4, device=dev, rows=(1, 2))
    box = {}

    def run():
        box["run"] = run_device(cfg, flights * T * B, SEED + 5, device=dev,
                                state=warm.state, rows=(1, 2))

    events, wall = _device_events(run, 1)
    for r, d in box["run"].row_digests.items():
        check(d == box["run"].input_digest, f"profiled read-back of row {r}")
    by_name = {}
    for name, us in events:
        key = next((k for k, f in KERNEL_FN.items() if f in name),
                   "copy" if "emcpy" in name else "other")
        by_name[key] = by_name.get(key, 0.0) + us
    busy = sum(by_name.values())
    kern = by_name.get("K3", 0.0) + by_name.get("K4", 0.0)
    return {"flights": flights, "wall_ms": wall * 1e3,
            "kernel_us_per_step": kern / (flights * T),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (wall * 1e6) if wall else None,
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_name.items()}}


KERNELS = [
    ("K1", "write_window_both", "raft_tpu_torch/csrc/ring.cu",
     "raft_tpu/core/ring_pallas.py:145"),
    ("K2", "steady_step", "raft_tpu_torch/csrc/steady.cu",
     "raft_tpu/core/step_pallas.py:404"),
    ("K3", "pipeline_flight", "raft_tpu_torch/csrc/steady.cu",
     "raft_tpu/core/step_pallas.py:1045"),
    ("K4", "turnover_flight", "raft_tpu_torch/csrc/steady.cu",
     "raft_tpu/core/step_pallas.py:1189"),
]


def main() -> int:
    if not (HERE / "raft_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py needs the repository around it: "
              "raft_tpu_torch/ was not found beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card_line = phase_card()
    phase_build()
    cfg = ns_config()
    errs = phase_kernels(cfg, dev)
    main_res = phase_main_path(cfg, dev)
    timing = phase_timing(cfg, dev, card_line)
    kernels = []
    for key, name, src, replaces in KERNELS:
        t = timing[key]
        kernels.append({
            "name": f"{key} {name}", "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_res["launches"][key],
            "max_abs_err": errs[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "matches_plain": True,
        })
    emit({"kernels": kernels})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
