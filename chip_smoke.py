#!/usr/bin/env python3
"""Smoke run of raft_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``raft_tpu_torch/csrc`` and runs two
deployments. First the north star (3 replicas, 256-byte entries, batch
1024, a 32 768-slot ring):

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
   version and its byte bound, and the main path per step.

Then BASELINE config 3 (5 replicas, RS(5,3) shards of 264-byte entries,
batch 1024, a 32 768-slot ring, commit quorum 4):

6. holds K6 (encode; decode for all ten 3-row sets), K7 and K2/K3/K4 in
   their in-kernel parity mode against their plain versions on the card,
   bit for bit (seam, partial, dead-row, slow-row, conflict, turnover and
   two-dead-row cases, then randomized multi-term schedules at config 3
   and at RS(4,2) with 8-byte entries and B = 128);
7. drives the EC main path on a fresh cluster: election, K7-fed ticks
   (K2), a data-lane steady scan (K2·ec), ``northstar.run_device_ec`` to
   1 048 576 committed entries read back through rows (0,1,2) and (1,2,4)
   (K3/K4·ec, K6 decode), a flight with row 4 dead (committed at 4 of 5),
   the heal of row 4 (K6 encode), and a flight with rows 3 and 4 dead (no
   commit, the committed bytes still read); every EC kernel must have
   launched on it;
8. times each EC kernel as in 5, and the EC path's device idle share;
9. prints the kernel table, the card line, and last
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
                    if "registers" in ln or "spill" in ln][:24]
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


def window_lanes(cfg, consts):
    """Lanes of a window: every row's (M), or only the k data-lane blocks
    (k*W) in the steady kernels' in-kernel parity mode."""
    if consts is None:
        return cfg.rows * cfg.shard_words
    return cfg.entry_bytes // 4


def k2_case(cfg, dev, rng, st, count, alive, slow, consts=None, lterm=1,
            tfloor=1):
    """One step of K2 (K2·ec with ``consts``) and of its plain version on
    clones of ``st``. Returns (max error, the kernel's commit index)."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    L = cfg.rows
    prm = sc.step_params(0, lterm, tfloor, 0, 0, cfg.commit_quorum, L,
                         ec=cfg.ec_enabled)
    al = torch.tensor(alive, dtype=torch.bool, device=dev)
    sl = torch.tensor(slow, dtype=torch.bool, device=dev)
    win = rand_window(rng, cfg.batch_size, window_lanes(cfg, consts), dev)
    outs = []
    for fn in (sc.steady_step, sc.steady_step_plain):
        s2 = st.clone()
        v = sc.pack(s2)
        out = torch.zeros(2 * L + 5, dtype=torch.int32, device=dev)
        fn(v, s2.log_payload, s2.log_term, win, count, al, sl, None, prm, out,
           consts)
        outs.append((v, s2, out))
    (vk, sk, ok_), (vp, sp, op) = outs
    return max_err([(vk, vp), (ok_, op), (sk.log_payload, sp.log_payload),
                    (sk.log_term, sp.log_term)]), int(ok_[L])


def scan_case(cfg, dev, rng, st, counts, alive, slow, consts=None):
    """K2 (or K2·ec) as a main path reaches it: a steady scan whose counts
    stay on the device (each launch reads its count through a view),
    against the plain scan on the host. Returns the max error."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc
    from raft_tpu_torch.core.state import (FIELDS, state_from_numpy,
                                           state_to_numpy)

    B = cfg.batch_size
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    pays = torch.stack([rand_window(rng, B, window_lanes(cfg, consts), dev)
                        for _ in counts])
    al = torch.tensor(alive, dtype=torch.bool, device=dev)
    sl = torch.tensor(slow, dtype=torch.bool, device=dev)
    key = "steady_step" if consts is None else "steady_step_ec"
    n0 = sc.LAUNCHES[key]
    res = [sc.steady_scan_replicate(s2, pays, cnt, 0, 1, al, sl, 0, 0, None,
                                    1, commit_quorum=cfg.commit_quorum,
                                    ec_consts=consts)
           for s2 in (st.clone(), state_from_numpy(state_to_numpy(st), "cpu"))]
    check(sc.LAUNCHES[key] - n0 == len(counts),
          f"the scan did not launch {key} once per step")
    (sk, ik), (sp, ip) = res
    check(sk.log_payload.is_cuda and not sp.log_payload.is_cuda,
          "scan case: kernel side on the card, plain side on the host")
    return max_err([(getattr(sk, f), getattr(sp, f)) for f in FIELDS]
                   + [(getattr(ik, f), getattr(ip, f)) for f in ik._fields])


def flight_case(cfg, dev, rng, st, T, P, counts, alive, slow, turnover_ok,
                consts=None):
    """One T-step flight over P windows through K3 (and K4 behind it when
    ``turnover_ok``) and through their plain versions, on clones of
    ``st``. Returns (whether K4 wrote it, max error, the commit index)."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    prm = sc.step_params(0, 1, 1, 0, 0, cfg.commit_quorum, L,
                         ec=cfg.ec_enabled)
    al = torch.tensor(alive, dtype=torch.bool, device=dev)
    sl = torch.tensor(slow, dtype=torch.bool, device=dev)
    wins = torch.stack([rand_window(rng, B, window_lanes(cfg, consts), dev)
                        for _ in range(P)])
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    work = sc.workspace(dev)
    br = sc.pick_br(B, C)
    res = []
    for kernel in (True, False):
        s2 = st.clone()
        v = sc.pack(s2)
        out = torch.zeros(L + 5, dtype=torch.int32, device=dev)
        r4 = int(work[sc.WK_RAN4])
        if kernel:
            sc.pipeline_flight(v, s2.log_payload, s2.log_term, wins, cnt, al,
                               sl, None, prm, br, turnover_ok, out, consts)
            if turnover_ok:
                sc.turnover_flight(v, s2.log_payload, s2.log_term, wins, T,
                                   prm, out, consts)
        else:
            sc.pipeline_flight_plain(v, s2.log_payload, s2.log_term, wins,
                                     cnt, al, sl, None, prm, br, turnover_ok,
                                     out, work, consts)
            if turnover_ok:
                sc.turnover_flight_plain(v, s2.log_payload, s2.log_term, wins,
                                         T, prm, out, work, consts)
        res.append((v, s2, out, int(work[sc.WK_RAN4]) - r4))
    (vk, sk, ok_, k4k), (vp, sp, op, k4p) = res
    check(k4k == k4p, "flight: kernel and plain took different branches")
    return bool(k4k), max_err(
        [(vk, vp), (ok_, op), (sk.log_payload, sp.log_payload),
         (sk.log_term, sp.log_term)]), int(ok_[L])


def phase_kernels(cfg, dev, n_random=200):
    """Every kernel against its plain version on the same inputs."""
    import torch

    from raft_tpu_torch.core import ring_cuda

    rng = np.random.default_rng(SEED)
    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    errs = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    cases = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def note(key, err):
        errs[key] = max(errs[key], err)
        cases[key] += 1

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
        note("K1", max_err([(a[0], b[0]), (a[1], b[1]), (mm_k, mm_p)]))

    def k2(*args, **kw):
        note("K2", k2_case(cfg, dev, rng, *args, **kw)[0])

    base = steady_state(cfg, dev, 5 * B, rng=rng)
    seam = steady_state(cfg, dev, 3 * C - B + 300, rng=rng)
    k2(base, B, [1, 1, 1], [0, 0, 0])
    k2(seam, B, [1, 1, 1], [0, 0, 0])                     # wrap seam
    k2(seam, 777, [1, 1, 1], [0, 0, 1])                   # partial, slow row
    k2(base, B, [1, 1, 0], [0, 0, 0])                     # dead row
    k2(base, B, [1, 1, 1], [0, 1, 1])                     # no quorum
    k2(base, B, [1, 1, 1], [0, 0, 0], lterm=2, tfloor=5 * B + 1)
    conflict = base.clone()                               # stale suffix
    conflict.last_index[2] = 5 * B + 700
    conflict.log_term[2, 5 * B:5 * B + 300] = 0
    k2(conflict, B, [1, 1, 1], [0, 0, 0], lterm=2, tfloor=5 * B + 1)
    note("K2", scan_case(cfg, dev, rng, seam, [B, 777, 0, B, 1, B],
                         [1, 1, 1], [0, 0, 1]))
    note("K2", scan_case(cfg, dev, rng, base, [0, B, 300, B], [1, 1, 0],
                         [0, 0, 0]))

    def flight(*args):
        k4, err, _ = flight_case(cfg, dev, rng, *args)
        which = "K4" if k4 else "K3"
        note(which, err)
        return which

    T = STEPS_PER_FLIGHT
    full = [B] * T
    check(flight(base, T, 4, full, [1, 1, 1], [0, 0, 0], False) == "K3",
          "K3 flight")
    part = list(full)
    part[5], part[17] = 300, 0
    check(flight(base, T, 3, part, [1, 1, 1], [0, 0, 1], True) == "K3",
          "infeasible K3")
    check(flight(seam, 8, 8, [B] * 8, [1, 1, 0], [0, 0, 0], True) == "K3",
          "seam K3")
    check(flight(base, T, T, full, [1, 1, 1], [0, 0, 0], True) == "K4",
          "K4 flight")
    check(flight(base, 2 * T + 5, 7, [B] * (2 * T + 5), [1, 1, 1],
                 [0, 0, 0], True) == "K4", "lapped K4")

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


class Lockstep:
    """One cluster held twice — kernels on the card, plain versions on the
    host — and stepped in lock step: every step's info must agree. Row 0
    leads term 1 at the start; ``masks`` moves the term and the leader
    now and then."""

    def __init__(self, cfg, dev, rng):
        from raft_tpu_torch.core.comm import SingleDeviceComm
        from raft_tpu_torch.core.state import init_state

        self.dev, self.rng, self.R = dev, rng, cfg.rows
        self.comm = SingleDeviceComm(cfg.rows)
        self.sts = {"k": init_state(cfg, device=dev),
                    "p": init_state(cfg, device="cpu")}
        self.term, self.leader, self.floor = 1, 0, 1
        self.vote(0, 1, [True] * cfg.rows)

    def __call__(self, fn, *args, **kw):
        import torch

        infos = {}
        for side, d in (("k", self.dev), ("p", "cpu")):
            conv = [a.to(d) if isinstance(a, torch.Tensor) else a
                    for a in args]
            self.sts[side], infos[side] = fn(self.sts[side], *conv, **kw)
        for f in infos["k"]._fields:
            a, b = getattr(infos["k"], f), getattr(infos["p"], f)
            check(torch.equal(a.cpu(), b.cpu()), f"schedule info.{f}")
        return infos["k"]

    def vote(self, cand, term, alive):
        import torch

        from raft_tpu_torch.core.step import vote_step

        return self(lambda st, *a: vote_step(self.comm, st, *a), cand, term,
                    torch.tensor(alive))

    def masks(self):
        """Maybe a new term and leader; then random (alive, slow, member)
        masks with the leader alive and a member."""
        import torch

        rng, R = self.rng, self.R
        if rng.random() < 0.08:
            self.term += int(rng.integers(1, 3))
            self.leader = int(rng.integers(0, R))
            self.vote(self.leader, self.term, list(rng.random(R) > 0.2))
            self.floor = int(self.sts["p"].last_index[self.leader]) + 1
        alive = list(rng.random(R) > 0.1)
        alive[self.leader] = True
        slow = list(rng.random(R) < 0.15)
        member = None
        if rng.random() < 0.2:              # a configuration mask
            member = list(rng.random(R) < 0.8)
            member[self.leader] = True
            member = torch.tensor(member)
        return torch.tensor(alive), torch.tensor(slow), member

    def check_states(self, what):
        import torch

        from raft_tpu_torch.core.state import FIELDS

        for f in FIELDS:
            check(torch.equal(getattr(self.sts["k"], f).cpu(),
                              getattr(self.sts["p"], f)),
                  f"{what}: state.{f}")


def flight_counts(rng, B, C):
    """A random flight: 2-5 full steps, or one that laps the ring, its
    last count partial half the time."""
    T = int(rng.integers(2, 6))
    if rng.random() < 0.3:
        T = C // B + int(rng.integers(0, 3))
    counts = [B] * T
    if rng.random() < 0.5:
        counts[-1] = int(rng.integers(0, B))
    return counts


def random_schedule(cfg, dev, n, rng):
    """Elections, repair-capable ticks (K1), steady ticks (K2) and flights
    (K3/K4) under random fault and membership masks."""
    import torch

    from raft_tpu_torch.core.state import fold_batch
    from raft_tpu_torch.core.step import replicate_step
    from raft_tpu_torch.core.step_cuda import steady_pipeline

    R, B, E, C = cfg.rows, cfg.batch_size, cfg.entry_bytes, cfg.log_capacity
    ls = Lockstep(cfg, dev, rng)
    steps = 0
    while steps < n:
        masks = ls.masks()
        kind = rng.choice(["repair", "steady", "flight"], p=[0.4, 0.45, 0.15])
        if kind == "flight":
            counts = flight_counts(rng, B, C)
            T = len(counts)
            data = rng.integers(0, 256, (T * B, E), dtype=np.uint8)
            ls(lambda st, *a: steady_pipeline(st, *a),
               fold_batch(data, R).reshape(T, B, -1),
               torch.tensor(counts, dtype=torch.int32), ls.leader, ls.term,
               masks[0], masks[1], 0, 0, masks[2], ls.floor)
            steps += T
        else:
            count = int(rng.choice([0, 3, 17, 777, B]))
            data = rng.integers(0, 256, (B, E), dtype=np.uint8)
            data[count:] = 0
            steady = kind == "steady"
            ls(lambda st, *a, **k: replicate_step(ls.comm, st, *a, **k),
               fold_batch(data, R), count, ls.leader, ls.term, masks[0],
               masks[1], 0, 0, masks[2], repair=not steady,
               term_floor=ls.floor if steady else None)
            steps += 1
        if steps % 25 < 5 or steps >= n:
            ls.check_states(f"schedule after {steps} steps")
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
             "K3": "steady_pipeline_kernel", "K4": "turnover_kernel",
             "K6 encode": "parity_kernel", "K6 decode": "parity_kernel",
             "K7": "encode_fold_kernel", "K2·ec": "steady_step_kernel",
             "K3·ec": "steady_pipeline_kernel", "K4·ec": "turnover_kernel"}


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


def time_steady_kernels(cfg, dev, rng, reps, consts=None):
    """K2, K3 and K4 (their in-kernel parity mode with ``consts``) at a
    main-path shape: {key: ((device ms, wrapper ms), plain ms, bytes)},
    and the flight's operands for further K3 timings."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    Mk = window_lanes(cfg, consts)
    T = STEPS_PER_FLIGHT
    tag = "" if consts is None else "·ec"
    al = torch.ones(L, dtype=torch.bool, device=dev)
    sl = torch.zeros(L, dtype=torch.bool, device=dev)
    prm = sc.step_params(0, 1, 1, 0, 0, cfg.commit_quorum, L,
                         ec=cfg.ec_enabled)
    out = {}

    # K2: steady steps (each appends and commits B): window read, payload
    # write, term read + write, the state vectors and the out block
    st = steady_state(cfg, dev, 5 * B, rng=rng)
    vecs = sc.pack(st)
    win = rand_window(rng, B, Mk, dev)
    o2 = torch.zeros(2 * L + 5, dtype=torch.int32, device=dev)

    def k2():
        sc.steady_step(vecs, st.log_payload, st.log_term, win, B, al, sl,
                       None, prm, o2, consts)

    def k2p():
        sc.steady_step_plain(vecs, st.log_payload, st.log_term, win, B, al,
                             sl, None, prm, o2, consts)

    step_bytes = B * Mk * 4 + B * M * 4 + 2 * L * B * 4 + 2 * 6 * L * 4 + \
        (2 * L + 5) * 4 + 2 * L
    out["K2" + tag] = (kernel_ms("K2" + tag, k2, reps, inner=20),
                       _host_ms(k2p, reps), step_bytes)

    # K3: one main-path flight, 32 steps over 32 distinct windows (every
    # row accepting, turnover not allowed), so each step reads its own
    # window: T times a K2 step's bytes
    wins32 = torch.stack([rand_window(rng, B, Mk, dev) for _ in range(T)])
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    o3 = torch.zeros(L + 5, dtype=torch.int32, device=dev)
    br = sc.pick_br(B, C)

    def k3(turnover_ok=False):
        return sc.pipeline_flight(vecs, st.log_payload, st.log_term, wins32,
                                  counts, al, sl, None, prm, br, turnover_ok,
                                  o3, consts)

    def k3p():
        sc.pipeline_flight_plain(vecs, st.log_payload, st.log_term, wins32,
                                 counts, al, sl, None, prm, br, False, o3,
                                 sc.workspace(dev), consts)

    out["K3" + tag] = (kernel_ms("K3" + tag, k3, reps), _host_ms(k3p, reps),
                       T * step_bytes)

    # K4: the turnover flight (K3 decides on the device, K4 writes)
    def plan():
        k3(turnover_ok=True)

    def k4():
        sc.turnover_flight(vecs, st.log_payload, st.log_term, wins32, T,
                           prm, o3, consts)

    def k4p():
        w = sc.workspace(dev)
        sc.pipeline_flight_plain(vecs, st.log_payload, st.log_term, wins32,
                                 counts, al, sl, None, prm, br, True, o3, w,
                                 consts)
        sc.turnover_flight_plain(vecs, st.log_payload, st.log_term, wins32,
                                 T, prm, o3, w, consts)

    work = sc.workspace(dev)
    ran4 = int(work[sc.WK_RAN4])
    k4_time = kernel_ms("K4" + tag, k4, reps, before=plan)
    # every timed K4 launch must have written its flight
    check(int(work[sc.WK_RAN4]) - ran4 == 2 * reps + 2,
          "timed turnover launches did not all run the flight")
    # bytes: the T*B = C window rows that survive the flight read once,
    # every payload and term slot written once
    k4_bytes = T * B * Mk * 4 + C * M * 4 + L * C * 4 + 2 * 6 * L * 4
    out["K4" + tag] = (k4_time, _host_ms(k4p, reps), k4_bytes)
    flight = dict(k3=k3, plan=plan, wins=wins32, counts=counts, prm=prm,
                  br=br, out=o3, slow=sl)
    return out, flight


def phase_timing(cfg, dev, card_line, reps=21):
    import torch

    from raft_tpu_torch.core import ring_cuda, step_cuda as sc

    rng = np.random.default_rng(SEED + 2)
    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    rate = mem_rate(card_line)
    al = torch.ones(L, dtype=torch.bool, device=dev)
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

    steady, fl = time_steady_kernels(cfg, dev, rng, reps)
    out.update(steady)
    grid = fl["k3"]()
    plan_ms = kernel_ms("K3", fl["plan"], reps)

    # K3 as it runs a flight on the main path (after the leader kill): 8
    # steps with a dead row, on a cluster of its own. Only the live rows'
    # window lanes and term slots need to move.
    st8 = steady_state(cfg, dev, 5 * B, rng=rng)
    v8 = sc.pack(st8)
    dead = torch.tensor([True, True, False], device=dev)
    T8 = 8

    def k3_dead():
        sc.pipeline_flight(v8, st8.log_payload, st8.log_term,
                           fl["wins"][:T8], fl["counts"][:T8], dead,
                           fl["slow"], None, fl["prm"], fl["br"], False,
                           fl["out"])

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


# ------------------------------------------------- the EC data plane
def ec_config():
    """BASELINE config 3 (``bench.py`` ``bench_rs53``): 5 replicas holding
    RS(5,3) shards of 264-byte entries (88-byte shards, W = 22 words, M =
    110 lanes), batch 1024, a 32 768-slot ring, commit quorum 4."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=5, entry_bytes=264, batch_size=1024,
                      log_capacity=1 << 15, rs_k=3, rs_m=2,
                      transport="single")


def rand_bytes(rng, shape, dev):
    import torch

    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(
        dev)


def codec_cases(code, dev, rng, B, S, N, note):
    """K6 (encode, and decode for every row set) and K7 against their plain
    versions on the card, and against the NumPy oracle on the host:
    ``S``-byte entries, batches of ``B``, decode windows of ``N``."""
    from itertools import combinations

    from raft_tpu_torch.ec import kernels as ek

    for count in (B, B // 3):            # a full and a partial batch
        data = rand_bytes(rng, (B, S), dev)
        data[count:] = 0
        enc = ek.encode_device(code, data)
        note("K6 encode", max_err([(enc, ek.encode_bitwise(code, data))]))
        check(np.array_equal(enc.cpu().numpy(), code.encode(
            data.cpu().numpy())), "K6 encode != the NumPy oracle")
        fold = ek.encode_fold_device(code, data)
        note("K7", max_err([(fold, ek.encode_fold_plain(code, data)),
                            (fold, ek.fold_shards_device(enc))]))
    data = rand_bytes(rng, (N, S), dev)
    shards = ek.encode_device(code, data)
    for rows in combinations(range(code.n), code.k):
        sh = shards[list(rows)].contiguous()
        dec = ek.decode_device(code, sh, rows)
        note("K6 decode", max_err([(dec, ek.decode_bitwise(code, sh, rows)),
                                   (dec, data)]))


def phase_ec_kernels(ecfg, dev, n_random=120):
    """K6, K7 and K2-K4 in their in-kernel parity mode against their plain
    versions on the same inputs, at config 3 and at RS(4,2) with 8-byte
    entries and B = 128."""
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.ec.kernels import parity_consts
    from raft_tpu_torch.ec.rs import RSCode

    rng = np.random.default_rng(SEED + 10)
    C, B, L = ecfg.log_capacity, ecfg.batch_size, ecfg.rows
    code = RSCode(ecfg.n_replicas, ecfg.rs_k)
    consts = parity_consts(code.n, code.k)
    keys = ("K6 encode", "K6 decode", "K7", "K2·ec", "K3·ec", "K4·ec")
    errs = {k: 0 for k in keys}
    cases = {k: 0 for k in keys}

    def note(key, err):
        errs[key] = max(errs[key], err)
        cases[key] += 1

    # the codec at the main path's shapes: a B-entry tick batch, and a
    # flight's read-back window (C entries) for every C(5,3) row set
    codec_cases(code, dev, rng, B, ecfg.entry_bytes, C, note)

    def k2(*args, **kw):
        err, commit = k2_case(ecfg, dev, rng, *args, consts=consts, **kw)
        note("K2·ec", err)
        return commit

    ones, none = [1] * L, [0] * L
    base = steady_state(ecfg, dev, 5 * B, rng=rng)
    seam = steady_state(ecfg, dev, 3 * C - B + 300, rng=rng)
    check(k2(base, B, ones, none) == 6 * B, "K2·ec commit")
    k2(seam, B, ones, none)                                    # wrap seam
    k2(seam, 777, ones, [0, 0, 0, 1, 0])                       # partial, slow
    check(k2(base, B, [1, 1, 1, 1, 0], none) == 6 * B,         # dead row:
          "K2·ec commits at 4 of 5")                           # 4 of 5
    check(k2(base, B, [1, 1, 1, 0, 0], none) == 5 * B,         # two dead
          "K2·ec must not commit with two rows dead")
    conflict = base.clone()                                    # stale suffix
    conflict.last_index[2] = 5 * B + 700
    conflict.log_term[2, 5 * B:5 * B + 300] = 0
    k2(conflict, B, ones, none, lterm=2, tfloor=5 * B + 1)
    note("K2·ec", scan_case(ecfg, dev, rng, seam, [B, 777, 0, B, 1, B], ones,
                            [0, 0, 0, 0, 1], consts))
    note("K2·ec", scan_case(ecfg, dev, rng, base, [0, B, 300, B],
                            [1, 1, 1, 1, 0], none, consts))

    def flight(*args):
        k4, err, commit = flight_case(ecfg, dev, rng, *args, consts=consts)
        which = "K4·ec" if k4 else "K3·ec"
        note(which, err)
        return which, commit

    T = STEPS_PER_FLIGHT
    full = [B] * T
    check(flight(base, T, 4, full, ones, none, False)[0] == "K3·ec",
          "K3·ec flight")
    part = list(full)
    part[5], part[17] = 300, 0
    check(flight(base, T, 3, part, ones, [0, 0, 1, 0, 0], True)[0]
          == "K3·ec", "infeasible K3·ec")
    check(flight(seam, 8, 8, [B] * 8, [1, 1, 1, 1, 0], none, True)
          == ("K3·ec", 3 * C - B + 300 + 8 * B),
          "dead-row seam flight commits at 4 of 5")
    check(flight(base, 8, 8, [B] * 8, [1, 1, 1, 0, 0], none, True)
          == ("K3·ec", 5 * B), "two dead rows: no commit")
    check(flight(base, T, T, full, ones, none, True)[0] == "K4·ec",
          "K4·ec flight")
    check(flight(base, 2 * T + 5, 7, [B] * (2 * T + 5), ones, none,
                 True)[0] == "K4·ec", "lapped K4·ec")

    # randomized multi-term schedules: kernel path on the card, plain path
    # on the host — at config 3 and at RS(4,2) with 8-byte entries
    rsteps = {"config3": random_ec_schedule(ecfg, dev, n_random, rng)}
    small = RaftConfig(n_replicas=4, entry_bytes=8, batch_size=128,
                       log_capacity=512, rs_k=2, rs_m=2, transport="single")
    codec_cases(RSCode(4, 2), dev, rng, 128, 8, 512, note)
    rsteps["rs42_e8_b128"] = random_ec_schedule(small, dev, n_random // 2,
                                                rng)
    for k in errs:
        check(errs[k] == 0, f"{k} differs from its plain version by "
                            f"{errs[k]}")
    emit({"phase": "ec_kernels_vs_plain", "cases": cases,
          "max_abs_err": errs, "random_schedule_steps": rsteps})
    return errs


def random_ec_schedule(cfg, dev, n, rng):
    """Elections, K7-fed ticks (general path and K2), data-lane steady
    scans (K2·ec) and flights (K3·ec / K4·ec) under random fault and
    membership masks."""
    import torch

    from raft_tpu_torch.core.step import replicate_step
    from raft_tpu_torch.core.step_cuda import (steady_pipeline,
                                               steady_scan_replicate)
    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.rs import RSCode

    B, E, C = cfg.batch_size, cfg.entry_bytes, cfg.log_capacity
    code = RSCode(cfg.n_replicas, cfg.rs_k)
    ec = dict(commit_quorum=cfg.commit_quorum,
              ec_consts=ek.parity_consts(code.n, code.k))
    ls = Lockstep(cfg, dev, rng)

    def lanes(counts):
        data = np.zeros((len(counts) * B, E), np.uint8)
        for t, c in enumerate(counts):
            data[t * B:t * B + c] = rng.integers(0, 256, (c, E),
                                                 dtype=np.uint8)
        return torch.from_numpy(data.view(np.int32).reshape(len(counts), B,
                                                            E // 4))

    steps = 0
    while steps < n:
        alive, slow, member = ls.masks()
        kind = rng.choice(["tick", "scan", "flight"], p=[0.35, 0.4, 0.25])
        if kind == "tick":                   # K7-fed: general path or K2
            count = int(rng.choice([0, 3, 17, B // 2 + 1, B]))
            data = rng.integers(0, 256, (B, E), dtype=np.uint8)
            data[count:] = 0
            pay = ek.encode_fold_device(code, torch.from_numpy(data).to(dev))
            check(torch.equal(pay.cpu(), ek.encode_fold_plain(
                code, torch.from_numpy(data))), "ec schedule: K7 vs plain")
            steady = rng.random() < 0.6
            ls(lambda st, *a, **k: replicate_step(ls.comm, st, *a, **k),
               pay, count, ls.leader, ls.term, alive, slow, 0, 0, member,
               ec=True, commit_quorum=cfg.commit_quorum,
               term_floor=ls.floor if steady else None)
            steps += 1
        else:                                # data lanes, in-kernel parity
            if kind == "flight":
                counts, fn = flight_counts(rng, B, C), steady_pipeline
            else:
                counts = [int(rng.choice([0, 3, 17, B // 2 + 1, B]))
                          for _ in range(int(rng.integers(1, 4)))]
                fn = steady_scan_replicate
            ls(lambda st, *a: fn(st, *a, **ec), lanes(counts),
               torch.tensor(counts, dtype=torch.int32), ls.leader, ls.term,
               alive, slow, 0, 0, member, ls.floor)
            steps += len(counts)
        if steps % 25 < 5 or steps >= n:
            ls.check_states(f"ec schedule after {steps} steps")
    return steps


def zero_ec_counters(dev):
    from raft_tpu_torch.ec import kernels as ek

    zero_counters(dev)
    for k in ek.LAUNCHES:
        ek.LAUNCHES[k] = 0


def read_ec_counters(dev):
    from raft_tpu_torch.core import step_cuda
    from raft_tpu_torch.ec import kernels as ek

    w = step_cuda.workspace(dev)
    return {
        "K2": step_cuda.LAUNCHES["steady_step"],
        "K6 encode": ek.LAUNCHES["encode"],
        "K6 decode": ek.LAUNCHES["decode"],
        "K7": ek.LAUNCHES["encode_fold"],
        "K2·ec": step_cuda.LAUNCHES["steady_step_ec"],
        "K3·ec": step_cuda.LAUNCHES["pipeline_flight_ec"],
        "K4·ec": step_cuda.LAUNCHES["turnover_flight_ec"],
        "K3_flights_run": int(w[step_cuda.WK_RAN3]),
        "K4_flights_run": int(w[step_cuda.WK_RAN4]),
    }


def phase_ec_main_path(ecfg, dev, entries=ENTRIES):
    """Config 3 on a fresh cluster through SingleDeviceTransport: election,
    K7-fed ticks, a data-lane steady scan, ``run_device_ec`` to
    ``entries`` committed entries read back through a systematic and a
    decoding row set, a flight with one dead row (committed at 4 of 5), the
    heal of that row, and a flight with two dead rows (no commit)."""
    import torch

    from raft_tpu_torch.core.step_cuda import (steady_pipeline,
                                               steady_scan_replicate)
    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.reconstruct import (gather_shard_window,
                                               heal_replica, reconstruct)
    from raft_tpu_torch.ec.rs import RSCode
    from raft_tpu_torch.northstar import run_device_ec
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    tr = SingleDeviceTransport(ecfg, device=dev)
    R, B, C, E = ecfg.rows, ecfg.batch_size, ecfg.log_capacity, \
        ecfg.entry_bytes
    code = RSCode(ecfg.n_replicas, ecfg.rs_k)
    consts = ek.parity_consts(code.n, code.k)
    Q = ecfg.commit_quorum
    rng = np.random.default_rng(SEED + 11)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    quiet = torch.zeros(R, dtype=torch.bool, device=dev)
    sets = ((0, 1, 2), (1, 2, 4))
    h_in = hashlib.sha256()
    h_sets = {rs: hashlib.sha256() for rs in sets}
    zero_ec_counters(dev)
    t_all = time.perf_counter()
    state = tr.init()

    def entries_(counts):
        data = np.zeros((len(counts) * B, E), np.uint8)
        for t, c in enumerate(counts):
            chunk = rng.integers(0, 256, (c, E), dtype=np.uint8)
            data[t * B:t * B + c] = chunk
            h_in.update(chunk.tobytes())
        return data

    def read_back(lo, hi):
        for rs, h in h_sets.items():
            h.update(reconstruct(state, code, rs, lo, hi).tobytes())

    # election: row 0 wins term 1 with every vote
    state, vi = tr.request_votes(state, 0, 1, alive)
    check(int(vi.votes) == R and bool(vi.grants.all()), "ec election")

    # EC ticks as the engine does them: K7 encodes the batch into the log
    # layout, the steady step (K2, ec quorum) replicates it; one partial
    submitted = 0
    for count in (B, 300, B):
        data = entries_([count])
        pay = ek.encode_fold_device(code, torch.from_numpy(data).to(dev))
        state, info = tr.replicate(state, pay, count, 0, 1, alive, quiet,
                                   term_floor=1)
        check(int(info.commit_index) == submitted + count, "ec tick commit")
        read_back(submitted + 1, submitted + count)
        submitted += count

    # steady ticks with in-kernel parity (K2·ec), as one scan; the counts
    # bring the log back to a multiple of the 256-row block, so the
    # flights below qualify for the turnover kernel
    counts = [B, 212, B, B]
    wins = ek.fold_data_lanes(torch.from_numpy(entries_(counts)).to(
        dev)).reshape(len(counts), B, E // 4)
    state, infos = steady_scan_replicate(
        state, wins, torch.tensor(counts, dtype=torch.int32, device=dev), 0,
        1, alive, quiet, 0, 0, None, 1, commit_quorum=Q, ec_consts=consts)
    check(int(infos.commit_index[-1]) == submitted + sum(counts),
          "ec scan commit")
    read_back(submitted + 1, submitted + sum(counts))
    submitted += sum(counts)
    check(submitted % 256 == 0, "ticks end on a block boundary")
    ticks_digest = h_in.hexdigest()
    for rs, h in h_sets.items():
        check(h.hexdigest() == ticks_digest,
              f"read set {rs} of the ticks differs from their input")

    # saturated flights through the port's config-3 entry point (K3
    # decides, K4 turns the ring over), read back through both sets
    run = run_device_ec(ecfg, entries, SEED + 12, transport=tr, state=state,
                        read_sets=sets)
    state = run.state
    submitted += entries
    check(state.commit_index.tolist() == [submitted] * R, "ec flight commit")
    for rs, d in run.set_digests.items():
        check(d == run.input_digest,
              f"read set {rs} of the flights differs from their input")

    def flight(T, alive_rows):
        data = entries_([B] * T)
        w = ek.fold_data_lanes(torch.from_numpy(data).to(dev)).reshape(
            T, B, E // 4)
        al = torch.tensor(alive_rows, dtype=torch.bool, device=dev)
        st, info = steady_pipeline(
            state, w, torch.full((T,), B, dtype=torch.int32, device=dev), 0,
            1, al, quiet, 0, 0, None, 1, commit_quorum=Q, ec_consts=consts)
        return st, info, data

    # one dead row: K3 commits every step at 4 of 5
    T8 = 8
    row4_last = int(state.last_index[4])
    state, info, dead_data = flight(T8, [1, 1, 1, 1, 0])
    check(int(info.commit_index) == submitted + T8 * B,
          "dead-row flight commits at 4 of 5")
    check(int(state.last_index[4]) == row4_last, "the dead row appended")
    lo, hi = submitted + 1, submitted + T8 * B
    for rs in ((0, 1, 2), (1, 2, 3)):
        check(np.array_equal(reconstruct(state, code, rs, lo, hi),
                             dead_data), f"dead-row flight read via {rs}")
    submitted = hi

    # heal row 4 from the data rows: reconstruct, re-encode (K6), install
    state = heal_replica(state, code, 4, (0, 1, 2), row4_last + 1, submitted,
                         1, submitted, B)
    got = gather_shard_window(state, [4], lo, hi).cpu().numpy()[0]
    check(np.array_equal(got, code.encode(dead_data)[4]),
          "healed row 4 holds the encoder's shards")
    check(int(state.last_index[4]) == submitted, "healed row 4's log")
    check(np.array_equal(reconstruct(state, code, (1, 2, 4), lo, hi),
                         dead_data), "read through the healed row")

    # two dead rows: 3 shard-holders < quorum 4, nothing commits, and the
    # committed entries still read back from the data rows
    state, info, _ = flight(4, [1, 1, 1, 0, 0])
    check(int(info.commit_index) == submitted,
          "a flight with two dead rows committed")
    check(state.commit_index.tolist()[:3] == [submitted] * 3,
          "commit moved with two rows dead")
    check(np.array_equal(reconstruct(state, code, (0, 1, 2), lo, hi),
                         dead_data), "committed read with two rows dead")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    counters = read_ec_counters(dev)
    for k, v in counters.items():
        check(v > 0, f"{k} never ran on the EC main path")
    result = {
        "phase": "ec_main_path", "entries_committed": submitted,
        "pipeline_entries": entries, "pipeline_flights": run.flights,
        "ring_laps": entries // C, "healed_entries": T8 * B,
        "ticks_sha256": ticks_digest,
        "flights_sha256_input": run.input_digest,
        "flights_sha256_sets": {",".join(map(str, rs)): d
                                for rs, d in run.set_digests.items()},
        "launches": counters,
        # run_device_ec on the host clock: stream generation, upload,
        # flights, reconstruction from both read sets and the hashing
        "pipeline_wall_s": run.wall_s,
        "pipeline_entries_per_s_wall": entries / run.wall_s,
        "main_path_wall_s": wall,
    }
    emit(result)
    return result


def phase_ec_timing(ecfg, dev, card_line, reps=21):
    import torch

    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.rs import RSCode

    rng = np.random.default_rng(SEED + 13)
    C, B, E = ecfg.log_capacity, ecfg.batch_size, ecfg.entry_bytes
    code = RSCode(ecfg.n_replicas, ecfg.rs_k)
    consts = ek.parity_consts(code.n, code.k)
    M = ecfg.rows * ecfg.shard_words
    rate = mem_rate(card_line)
    out = {}

    # K6 encode and K7 on a main-path tick batch; K6 decode on a flight's
    # read-back window (C entries from three rows)
    data = rand_bytes(rng, (B, E), dev)
    sk = E // code.k
    out["K6 encode"] = (
        kernel_ms("K6 encode", lambda: ek.encode_device(code, data), reps,
                  inner=20),
        _host_ms(lambda: ek.encode_bitwise(code, data), reps),
        B * E + code.m * B * sk)
    out["K7"] = (
        kernel_ms("K7", lambda: ek.encode_fold_device(code, data), reps,
                  inner=20),
        _host_ms(lambda: ek.encode_fold_plain(code, data), reps),
        B * E + B * M * 4)
    rows = (1, 2, 4)
    shards = ek.encode_device(code, rand_bytes(rng, (C, E), dev))[
        list(rows)].contiguous()
    out["K6 decode"] = (
        kernel_ms("K6 decode", lambda: ek.decode_device(code, shards, rows),
                  reps, inner=5),
        _host_ms(lambda: ek.decode_bitwise(code, shards, rows), reps),
        2 * code.k * C * sk)

    out.update(time_steady_kernels(ecfg, dev, rng, reps, consts)[0])
    torch.cuda.synchronize()
    res = {"phase": "ec_timing", "card": card_line, "mem_bytes_per_s": rate}
    for k, ((ms, call_ms), pms, nbytes) in out.items():
        res[k] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms,
                  "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}
    res["ec_path_profile"] = profile_ec_flights(ecfg, dev)
    emit(res)
    return res


def profile_ec_flights(ecfg, dev, flights=4):
    """Where an EC flight's time goes: ``run_device_ec`` over ``flights``
    flights with their host work (stream generation, upload, both read
    sets' reconstruction, hashing) under the profiler."""
    from raft_tpu_torch.northstar import run_device_ec

    B, T = ecfg.batch_size, STEPS_PER_FLIGHT
    warm = run_device_ec(ecfg, T * B, SEED + 14, device=dev)
    box = {}

    def run():
        box["run"] = run_device_ec(ecfg, flights * T * B, SEED + 15,
                                   device=dev, state=warm.state)

    events, wall = _device_events(run, 1)
    for rs, d in box["run"].set_digests.items():
        check(d == box["run"].input_digest, f"profiled read set {rs}")
    names = {"K3·ec": "steady_pipeline_kernel", "K4·ec": "turnover_kernel",
             "K6 decode": "parity_kernel"}
    by_name = {}
    for name, us in events:
        key = next((k for k, f in names.items() if f in name),
                   "copy" if "emcpy" in name else "other")
        by_name[key] = by_name.get(key, 0.0) + us
    busy = sum(by_name.values())
    kern = by_name.get("K3·ec", 0.0) + by_name.get("K4·ec", 0.0)
    return {"flights": flights, "wall_ms": wall * 1e3,
            "entries_per_s_wall": flights * T * B / wall,
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
#: the EC path's kernels: K6 (both uses), K7, and K2-K4's parity mode
EC_KERNELS = [
    ("K6 encode", "encode_device", "raft_tpu_torch/csrc/ec.cu",
     "raft_tpu/ec/kernels.py:77"),
    ("K6 decode", "decode_device", "raft_tpu_torch/csrc/ec.cu",
     "raft_tpu/ec/kernels.py:240"),
    ("K7", "encode_fold_device", "raft_tpu_torch/csrc/ec.cu",
     "raft_tpu/ec/kernels.py:161"),
    ("K2·ec", "steady_step (in-kernel parity)",
     "raft_tpu_torch/csrc/steady.cu", "raft_tpu/core/step_pallas.py:93"),
    ("K3·ec", "pipeline_flight (in-kernel parity)",
     "raft_tpu_torch/csrc/steady.cu", "raft_tpu/core/step_pallas.py:766"),
    ("K4·ec", "turnover_flight (in-kernel parity)",
     "raft_tpu_torch/csrc/steady.cu", "raft_tpu/core/step_pallas.py:1152"),
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
    ecfg = ec_config()
    ec_errs = phase_ec_kernels(ecfg, dev)
    ec_main = phase_ec_main_path(ecfg, dev)
    ec_timing = phase_ec_timing(ecfg, dev, card_line)
    kernels = []
    for table, err, main, tim in ((KERNELS, errs, main_res, timing),
                                  (EC_KERNELS, ec_errs, ec_main, ec_timing)):
        for key, name, src, replaces in table:
            t = tim[key]
            kernels.append({
                "name": f"{key} {name}", "route": "cuda", "source": src,
                "replaces": replaces, "launches": main["launches"][key],
                "max_abs_err": err[key], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "matches_plain": True,
            })
    emit({"kernels": kernels})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
