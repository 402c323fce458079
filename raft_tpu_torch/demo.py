"""Live wall-clock cluster demo — the reference's ``main()`` (main.go:78-96);
port of ``raft_tpu/demo.py``.

The reference's entry point builds three nodes, runs them forever, and acts
as the client: every 10 s it pushes one random int into the current leader's
``LogReq`` channel, while the nodes print nodelog lines for every election
and replication event (main.go:87-95, 399-401).

This module is the same experience for raft_tpu_torch: a real wall-clock
cluster with the reference's timing defaults (follower timeout 10-30 s
main.go:114, candidate timeout 10-13 s main.go:194, leader tick 2 s
main.go:394, client period 10 s main.go:89), printing the identical
``[Id:Term:CommitIndex:LastApplied][state]`` trace schema to stdout.

The engine itself runs on a virtual clock (deterministic tests); here the
demo *paces* that clock against wall time: it sleeps until wall time catches
up with the next pending event, then fires it. ``--time-scale N`` runs the
whole cluster N× faster than real time (``--time-scale 0`` = as fast as
possible), so you can watch a full election + replication cycle without the
reference's 10-30 s waits.

The cluster runs on CUDA unless ``--device cpu`` (``device="cpu"``) is
asked for, which runs every kernel's plain version; there is no fallback.

Run:  python -m raft_tpu_torch.demo [--duration 120] [--time-scale 1]
      [--replicas 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from typing import Optional

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.raft.engine import RaftEngine
from raft_tpu_torch.transport.device import SingleDeviceTransport


def _payload(rng: random.Random, nbytes: int) -> bytes:
    """One client entry: a random int (the reference's ``rand.Int()``,
    main.go:92) packed little-endian into the fixed entry payload."""
    k = min(nbytes, 8)
    value = rng.getrandbits(8 * k - 1)
    return value.to_bytes(k, "little") + bytes(nbytes - k)


def run_demo(
    duration: float = 120.0,
    time_scale: float = 1.0,
    n_replicas: int = 3,
    seed: int = 0,
    rs_k: Optional[int] = None,
    rs_m: Optional[int] = None,
    entry_bytes: int = 256,
    checkpoint: Optional[str] = None,
    hardened: bool = False,
    emit=print,
    device=None,
) -> RaftEngine:
    """Run a live cluster for ``duration`` virtual seconds; returns the
    engine so callers (tests) can inspect final state.

    ``checkpoint``: path for durable cluster state — resumed from if the
    file exists (the committed log, terms, and votes survive the process
    restart the reference never could, main.go:18-21) and written on
    session end, including an interrupted (Ctrl-C) one.

    ``device``: where the cluster runs; CUDA when None (which must then
    exist), ``"cpu"`` for the plain versions."""
    cfg = RaftConfig(
        n_replicas=n_replicas,
        seed=seed,
        rs_k=rs_k,
        rs_m=rs_m,
        entry_bytes=entry_bytes,
        transport="single",  # a live demo is a one-process, one-chip affair
        prevote=hardened,
        check_quorum=hardened,  # §9.6 liveness hardening (--hardened)
    )
    transport = SingleDeviceTransport(cfg, device=device)
    if checkpoint is not None and os.path.exists(checkpoint):
        engine = RaftEngine.restore(cfg, checkpoint, transport, trace=emit)
        emit(f"# resumed from {checkpoint}: "
             f"{engine.commit_watermark} committed entries")
    else:
        engine = RaftEngine(cfg, transport, trace=emit)
    client_rng = random.Random(seed ^ 0xC11E47)  # distinct client stream
    emit(
        f"# raft_tpu_torch live demo on {transport.device}: "
        f"{n_replicas} replicas, "
        f"client entry every {cfg.client_period:.0f}s (virtual), "
        f"time-scale {f'{time_scale:g}x' if time_scale else 'max'}"
    )

    start = time.monotonic()
    next_client = cfg.client_period
    try:
        while True:
            t_ev = engine.next_event_time()
            if t_ev is None:
                t_ev = float("inf")
            t_next = min(next_client, t_ev)
            if t_next > duration:
                break
            if time_scale > 0:
                wait = t_next / time_scale - (time.monotonic() - start)
                if wait > 0:
                    time.sleep(wait)
            if next_client <= t_ev:
                engine.clock.now = max(engine.clock.now, next_client)
                # The reference's client only injects when a leader exists
                # (main.go:90-94) — possibly to several during a dual-leader
                # window; the engine has one authoritative leader at a time.
                if engine.leader_id is not None:
                    seq = engine.submit(_payload(client_rng, cfg.entry_bytes))
                    emit(
                        f"[client] submit seq={seq} -> "
                        f"Server{engine.leader_id}"
                    )
                else:
                    emit("[client] no leader; skipping injection")
                next_client += cfg.client_period
            else:
                engine.step_event()
    finally:
        # entries already reported durable must survive even a Ctrl-C'd
        # session — an interrupted run that skipped the save would roll
        # the cluster back to the PREVIOUS checkpoint on the next resume
        lat = engine.commit_latencies()
        committed = len(lat)
        emit(
            f"# done: {committed} entries durable, commit watermark "
            f"{engine.commit_watermark}"
            + (
                f", p50 commit latency "
                f"{1e3 * float(sorted(lat)[committed // 2]):.0f} ms"
                if committed
                else ""
            )
        )
        if checkpoint is not None:
            propagating = sys.exc_info()[0] is not None
            try:
                engine.save_checkpoint(checkpoint)
                emit(f"# checkpoint written to {checkpoint}")
            except Exception as ex:
                # with an exception already propagating (e.g. Ctrl-C),
                # never mask the original exit reason; on a clean exit a
                # persistence failure must be loud — an exit-0 session
                # whose durable state silently regressed would roll back
                # on the next resume
                if propagating:
                    emit(f"# checkpoint NOT written: {ex}")
                else:
                    raise
    return engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Live raft_tpu_torch cluster (the reference's main(), "
        "main.go:78-96): elections, replication, and commits on stdout."
    )
    ap.add_argument("--duration", type=float, default=120.0,
                    help="virtual seconds to run (default 120)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="speedup over real time; 0 = as fast as possible")
    ap.add_argument("--replicas", type=int, default=3,
                    help="cluster size (reference: 3, main.go:81)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rs", type=str, default=None, metavar="K,M",
                    help="enable RS(k+m, k) erasure-coded log shards, "
                    "e.g. --rs 3,2 with --replicas 5")
    ap.add_argument("--entry-bytes", type=int, default=256,
                    help="client entry payload size (default 256; must be "
                    "divisible by K under --rs, e.g. 264 for --rs 3,2)")
    ap.add_argument("--checkpoint", type=str, default=None, metavar="PATH",
                    help="resume from PATH if it exists; write durable "
                    "cluster state there on session end")
    ap.add_argument("--hardened", action="store_true",
                    help="enable the §9.6 liveness flags (PreVote + "
                    "CheckQuorum); default off = reference dynamics")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the cluster (default: cuda; "
                    "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    rs_k = rs_m = None
    if args.rs:
        rs_k, rs_m = (int(x) for x in args.rs.split(","))
    run_demo(
        duration=args.duration,
        time_scale=args.time_scale,
        n_replicas=args.replicas,
        seed=args.seed,
        rs_k=rs_k,
        rs_m=rs_m,
        entry_bytes=args.entry_bytes,
        checkpoint=args.checkpoint,
        hardened=args.hardened,
        device=args.device,
    )


if __name__ == "__main__":
    main()
