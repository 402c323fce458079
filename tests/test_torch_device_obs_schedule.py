"""``chip_smoke.py``'s ``engine_device_obs_path`` schedule on the CPU: the
same ``dev_obs_schedule`` the card runs (an election, two bursts drained
by ``run_for``, one ``submit_pipelined`` ring as one flight, a leader
failover, more entries) through the port's engine detached, attached to
the device plane, and detached once more, and through the JAX engine.
Every pair is held equal on the nodelog lines, ``commit_time`` seq by
seq, the leader tick of every stamp, terms, roles, read-backs and every
state leaf.

Small shapes: 3 replicas, 32-byte entries, B = 128, C = 1 024, bursts of
one ring (so the stamp dicts evict, as at the north star), with the
flight gate opened on both engines (the JAX flight in Pallas interpret
mode), as ``tests/test_torch_device_obs.py``
``test_pipelined_flight_lock_step`` does.
"""

import hashlib

import numpy as np
import pytest

import chip_smoke
import raft_tpu.raft.engine as jengine
import raft_tpu_torch.raft.engine as tengine
from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.raft import RaftEngine as JEngine
from raft_tpu.transport import SingleDeviceTransport as JTransport
from raft_tpu_torch.config import RaftConfig as TConfig
from tests._torch_port import jax_leaves, pallas_interpret

KW = dict(n_replicas=3, entry_bytes=32, batch_size=128, log_capacity=1024,
          transport="single")
PLAN = dict(bursts=2, burst=1024, after=256)


def jax_run(fuse_k):
    """The schedule through the JAX engine: what the port's runs keep,
    with read-backs as (lo, hi, SHA-256 of ``committed_entries``)."""
    cfg = JConfig(**KW, fuse_k=fuse_k)
    lines = []
    e = JEngine(cfg, JTransport(cfg), trace=lines.append)
    ticks = chip_smoke.stamp_ticks(e)
    inp = chip_smoke.EngineInput(cfg)

    def read_back(lo, hi, part):
        got = np.asarray(e.committed_entries(lo, hi)).tobytes()
        assert got == inp.window(lo, hi), part
        return (lo, hi, hashlib.sha256(got).hexdigest())

    with pallas_interpret():
        reads = chip_smoke.dev_obs_schedule(e, inp, PLAN, read_back,
                                            what="jax")
    return {"lines": lines, "commit_time": dict(e.commit_time),
            "stamp_ticks": ticks, "terms": [int(t) for t in e.terms],
            "roles": list(e.roles), "reads": reads,
            "state": jax_leaves(e.state)}


def port_run(fuse_k, capacity):
    cfg = TConfig(**KW, fuse_k=fuse_k)
    res, keep, _ = chip_smoke.dev_obs_engine_run(cfg, "cpu", capacity, PLAN)
    keep["reads"] = [(r["lo"], r["hi"], r["sha256"]) for r in keep["reads"]]
    assert res["flights"] == 1
    return keep


class LosingProfile:
    """Stands in for ``torch.profiler.profile``: records nothing, as a
    session that lost every leading pad of ``_device_events`` on the
    card."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return []


COMPARED = ("lines", "commit_time", "stamp_ticks", "terms", "roles", "reads",
            "state")


@pytest.mark.parametrize("fuse_k", [1, 8])
def test_schedule_detached_attached_and_jax_agree(monkeypatch, fuse_k):
    monkeypatch.setattr(jengine, "_pipeline_backend_ok", lambda: True)
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)
    detached = port_run(fuse_k, None)
    attached = port_run(fuse_k, chip_smoke.DEV_OBS_CAPACITY)
    again = port_run(fuse_k, None)
    ref = jax_run(fuse_k)
    total = PLAN["bursts"] * PLAN["burst"] + KW["log_capacity"] + \
        PLAN["after"]
    # the stamps outgrew their cap (2C) and were evicted, as at the
    # north star
    assert len(ref["commit_time"]) == 2 * KW["log_capacity"] < total
    for what, run in (("attached", attached), ("detached again", again),
                      ("JAX", ref)):
        chip_smoke.same_kept(detached, run,
                             f"fuse_k={fuse_k}: detached vs {what}",
                             COMPARED)


def test_a_profiled_burst_runs_once_when_its_profile_keeps_nothing(
        monkeypatch):
    """``_device_events`` runs its function once per rep, whatever the
    profile kept: a profiled burst drains once, so the profiled run keeps
    the unprofiled run's commit stamps (a profile session run again
    drained the burst again, which moved every later stamp while the
    nodelog lines stayed equal)."""
    import torch
    import torch.profiler

    zeros = torch.zeros
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)
    monkeypatch.setattr(torch.profiler, "profile", LosingProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # the profile's pads, on the CPU here
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, device=None, **k: zeros(*a, **k))
    monkeypatch.setattr(chip_smoke, "PROFILE_LOSS", {
        "sessions": 0, "max_pads_lost": 0, "last_pads_lost": 0,
        "lost_all": 0})
    plan = dict(PLAN, bursts=chip_smoke.DEV_OBS_PROFILED_BURST + 1, burst=512)
    cfg = TConfig(**KW, fuse_k=1)
    res, profiled, _ = chip_smoke.dev_obs_engine_run(cfg, "cpu", None, plan,
                                                     profile=True)
    _, plain, _ = chip_smoke.dev_obs_engine_run(cfg, "cpu", None, plan)
    assert res["profiled_burst"]["device_ops"] == 0
    assert res["profiled_burst"]["profile_whole"] is False
    assert chip_smoke.PROFILE_LOSS["sessions"] == 1
    assert chip_smoke.PROFILE_LOSS["lost_all"] == 1
    chip_smoke.same_kept(plain, profiled, "unprofiled vs profiled", COMPARED)


def test_stamp_tick_reads_the_marks_after_eviction():
    """``stamp_tick`` maps a seq to the tick of the first stamping whose
    newest seq is at or after it; a stamping whose newest seq was evicted
    (seq 3 here) names no retained seq."""
    kept = {"commit_time": dict.fromkeys([5, 6, 7, 8], 0.0),
            "stamp_ticks": [(3, 1), (6, 2), (8, 4)]}
    got = {s: chip_smoke.stamp_tick(kept, s) for s in (5, 6, 7, 8, 9)}
    assert got == {5: 2, 6: 2, 7: 4, 8: 4, 9: None}
