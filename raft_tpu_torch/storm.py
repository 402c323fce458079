"""BASELINE config 5, the leader-election storm (port of ``bench.py:2395``
``bench_storm`` and ``:2446`` ``bench_storm_once``).

3 replicas, 256-byte entries, B = 64, C = 4096, seed 2: disruptive
candidacies at a 5-s mean (``FaultPlan.election_storm(3, t0, t0 + window,
5.0, seed=3)``), a kill of whoever leads every 100 virtual s (recovered
30 s later) and one client entry a virtual second. ``storm_once``
reports what ``bench_storm_once`` reports — time to first leader over 16
seeds, candidacies, commits, re-election gaps, terms spent — plus the
trace lines, the final engine, the SHA-256 of the apply stream (every
committed entry) and of the committed entries the ring still holds, read
back, so two runs can be held equal byte for byte. ``storm`` runs both of
``bench_storm``'s variants: the reference's election dynamics over 1000 s,
then ``prevote`` and ``check_quorum`` over 400 s.

``storm_once`` takes an engine factory ``make_engine(seed, prevote, trace)``
and touches the engine only through the JAX engine's public surface, so
the same schedule can drive this package's engine on either device and,
in the tests, the JAX engine.
"""

from __future__ import annotations

import hashlib

import numpy as np

from raft_tpu_torch.faults import FaultEvent, FaultPlan

#: config 5's deployment (``bench.py`` ``bench_storm_once``)
STORM_SHAPE = dict(n_replicas=3, entry_bytes=256, batch_size=64,
                   log_capacity=1 << 12)
#: the fields ``bench_storm`` keeps of its hardened (pre-vote) variant
HARDENED_FIELDS = ("injections_attempted", "campaigns_real",
                   "virtual_window_s", "submitted", "committed",
                   "commit_ratio", "virtual_commit_p50_s",
                   "reelection_convergence_s", "leaderless_total_s",
                   "terms_spent")


def storm_config(seed: int, prevote: bool):
    """Config 5's ``RaftConfig``: ``bench_storm_once``'s, with the §9.6
    machinery (``prevote`` and ``check_quorum``) on or off."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(**STORM_SHAPE, transport="single", seed=seed,
                      prevote=prevote, check_quorum=prevote)


def storm_once(make_engine, prevote: bool, window: float = 1000.0,
               measure_first_leader: bool = True) -> dict:
    """One variant of the storm (``bench_storm_once``), driven through
    ``make_engine(seed, prevote, trace)``. The ``engine`` and ``trace``
    keys carry the run itself."""
    first_leader = [float("nan")]
    if measure_first_leader:
        first_leader = []
        for seed in range(16):
            e = make_engine(seed, prevote, None)
            e.run_until_leader()
            first_leader.append(e.clock.now)

    trace_lines: list = []
    e = make_engine(2, prevote, trace_lines.append)
    applied = hashlib.sha256()
    e.register_apply(lambda idx, payload: applied.update(payload))
    e.run_until_leader()
    t_start = e.clock.now
    plan = FaultPlan.election_storm(3, t_start, t_start + window, 5.0, seed=3)
    e.schedule_faults(plan)
    # a leader kill every ~100 s, recovered 30 s later; the victim is
    # whoever leads at kill time, so the kills are driven inline
    kills = [(t_start + 50.0 + 100.0 * k, t_start + 80.0 + 100.0 * k)
             for k in range(max(int(window) // 100 - 1, 1))]
    seqs = []
    next_submit = t_start
    lost_at = None
    gaps = []           # leaderless gap durations (re-election convergence)
    ki = 0
    entry = e.cfg.entry_bytes
    while e.clock.now < t_start + window and e._q:
        if ki < len(kills) and e.clock.now >= kills[ki][0]:
            victim = e.leader_id
            if victim is not None:
                e.fail(victim)
                lost_at = e.clock.now   # e.fail cleared leader_id itself
                e.schedule_faults(FaultPlan([FaultEvent(kills[ki][1],
                                                        "recover", victim)]))
            ki += 1
        if e.clock.now >= next_submit:
            seqs.append(e.submit(np.random.default_rng(len(seqs))
                                 .integers(0, 256, entry, np.uint8)
                                 .tobytes()))
            next_submit += 1.0
        had = e.leader_id
        e.step_event()
        if had is not None and e.leader_id is None:
            lost_at = e.clock.now
        elif had is None and e.leader_id is not None and lost_at is not None:
            gaps.append(e.clock.now - lost_at)
            lost_at = None
    lat = e.commit_latencies()
    wm = e.commit_watermark
    lo = max(1, wm - e.state.capacity + 1)   # what the ring still holds
    read = (e.committed_entries(lo, wm) if wm
            else np.zeros((0, entry), np.uint8))
    return {
        "injections_attempted": len(plan.events),
        "campaigns_real": sum(
            1 for ln in trace_lines if "state changed to candidate" in ln
        ),
        "leader_kills": ki,
        "virtual_window_s": window,
        "submitted": len(seqs),
        "committed": int(len(lat)),
        "commit_ratio": round(len(lat) / max(len(seqs), 1), 3),
        "virtual_commit_p50_s": (
            round(float(np.percentile(lat, 50)), 3) if len(lat) else None
        ),
        "time_to_first_leader_s": {
            "p50": round(float(np.percentile(first_leader, 50)), 2),
            "p95": round(float(np.percentile(first_leader, 95)), 2),
            "min": round(float(np.min(first_leader)), 2),
            "max": round(float(np.max(first_leader)), 2),
            "samples": len(first_leader),
        },
        "reelection_convergence_s": {
            "p50": round(float(np.percentile(gaps, 50)), 2) if gaps else None,
            "p99": round(float(np.percentile(gaps, 99)), 2) if gaps else None,
            "max": round(float(np.max(gaps)), 2) if gaps else None,
            "samples": len(gaps),
        },
        "leaderless_total_s": round(float(np.sum(gaps)), 2) if gaps else 0.0,
        "terms_spent": int(e.terms.max()),
        "commit_watermark": wm,
        "apply_sha256": applied.hexdigest(),
        "ring_read_from": lo,
        "ring_read_sha256": hashlib.sha256(
            np.ascontiguousarray(read).tobytes()).hexdigest(),
        "trace": trace_lines,
        "engine": e,
    }


def storm(make_engine, window: float = 1000.0,
          hardened_window: float = 400.0) -> dict:
    """Both variants (``bench_storm``): the reference's election dynamics,
    then ``prevote`` + ``check_quorum`` over a shorter window (first
    leader not measured); the second under ``with_prevote_checkquorum``,
    with its run under ``hardened_run``."""
    base = storm_once(make_engine, prevote=False, window=window)
    hardened = storm_once(make_engine, prevote=True, window=hardened_window,
                          measure_first_leader=False)
    base["with_prevote_checkquorum"] = {k: hardened[k]
                                        for k in HARDENED_FIELDS}
    base["hardened_run"] = hardened
    return base
