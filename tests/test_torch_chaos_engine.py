"""The engine-level chaos schedules of ``tests/test_chaos.py`` (``:144``,
``:261``, ``:293``, ``:311``, ``:586``; one seed each) on the port's
engine beside the JAX package's: the same seeded interleaving of crashes,
slow windows, disruptive candidacies, partitions and membership changes
drives both engines, whose nodelog lines, majority-side snapshots and
committed payloads must be equal, and the port's run must uphold the JAX
test's invariants. The schedules live in ``tests/_torch_faults.py``;
``:268`` (the same schedule over the replica mesh, one row a rank) is
tests/test_torch_engine_mesh.py's ``test_chaos_over_mesh_transport``."""

import random
import tempfile
from itertools import combinations

import numpy as np
import pytest

from tests._torch_faults import (ALL, chaos_action, chaos_outcome,
                                 check_chaos_invariants, package,
                                 run_schedule)

ENTRY = 16


def mk(pkg, **kw):
    cfg = pkg.RaftConfig(transport="single", **kw)
    tr = pkg.FlightRecorder()
    return cfg, pkg.RaftEngine(cfg, pkg.transport(cfg), recorder=tr), tr


def check_ec(pkg, e, tr, snaps, holders):
    """``check_ec_invariants`` / ``check_ec_member_invariants``: election
    safety, no device commit regression, every k-subset of the holders
    decoding the same committed window."""
    assert tr.dropped == 0
    for term, leaders in tr.leaders_by_term().items():
        assert len(leaders) <= 1, term
    hi = e.commit_watermark
    assert hi >= 1
    if snaps:
        assert int(np.asarray(e.state.commit_index).max()) >= max(snaps)
    lo = max(1, hi - e.state.capacity + 1)
    code = pkg.RSCode(e.cfg.rows, e.cfg.rs_k)
    rows = holders(hi, lo)
    assert len(rows) >= e.cfg.rs_k
    decoded = None
    for sub in combinations(rows, e.cfg.rs_k):
        got = [bytes(x)
               for x in pkg.reconstruct(e.state, code, list(sub), lo, hi)]
        assert decoded is None or got == decoded, sub
        decoded = got


def both(kind, seed, rng_seed, phases, phase_s, **cfg):
    outs = {}
    for name in ("jax", "port"):
        pkg = package(name)
        _, e, tr = mk(pkg, seed=seed, **cfg)
        snaps = run_schedule(pkg.committed, e, random.Random(rng_seed),
                             phases, phase_s, kind)
        outs[name] = (pkg, e, tr, chaos_outcome(e, pkg.committed, snaps))
    want, got = outs["jax"][3], outs["port"][3]
    for key in want:
        assert got[key] == want[key], key
    return outs["port"]


def test_chaos_schedule_matches_jax_and_upholds_invariants():
    pkg, e, tr, out = both("plain", 0, 31000, 10, 40.0, n_replicas=3,
                           max_replicas=5, entry_bytes=ENTRY, batch_size=4,
                           log_capacity=256)
    check_chaos_invariants(out, e.cfg.rows)


def _ec_holders(e):
    commits = np.asarray(e.state.commit_index)
    return lambda hi, lo: [r for r in range(e.cfg.n_replicas)
                           if int(commits[r]) >= hi]


@pytest.mark.parametrize("seed,phases,phase_s", [(0, 8, 40.0),
                                                 (67, 7, 35.0)])
def test_ec_chaos_matches_jax_and_reads_stay_consistent(seed, phases,
                                                        phase_s):
    """``:261`` at seed 0 and ``:293`` (the unrecoverable suffix
    abandoned) at seed 67."""
    pkg, e, tr, out = both("ec", seed, 52000 + seed, phases, phase_s,
                           n_replicas=5, rs_k=3, rs_m=2, entry_bytes=12,
                           batch_size=4, log_capacity=256)
    check_ec(pkg, e, tr, out["snaps"], _ec_holders(e))


def test_ec_membership_chaos_matches_jax():
    pkg, e, tr, out = both("ec_member", 0, 73000, 10, 40.0, n_replicas=5,
                           max_replicas=7, rs_k=3, rs_m=2, entry_bytes=12,
                           batch_size=4, log_capacity=256)
    assert e._pending_config is None
    assert e.cfg.commit_quorum <= int(e.member.sum()) <= e.cfg.rows
    commits = np.asarray(e.state.commit_index)
    lasts = np.asarray(e.state.last_index)
    cap = e.state.capacity

    def holders(hi, lo):
        return [r for r in range(e.cfg.rows)
                if int(commits[r]) >= hi and int(lasts[r]) - cap + 1 <= lo
                and int(e._ring_floor[r]) <= lo]

    check_ec(pkg, e, tr, out["snaps"], holders)


def session_run(pkg, seed):
    """``:311``'s exactly-once counter under the full chaos mix; returns
    (outcome, counter value, expected sum, replayed value)."""
    rng = random.Random(seed)
    cfg, e, tr = mk(pkg, n_replicas=3, max_replicas=5, entry_bytes=24,
                    batch_size=4, log_capacity=64, seed=seed)
    ctr = pkg.ReplicatedCounter(e)
    e.run_until_leader()
    pair_amount, pair_seqs, outstanding = {}, {}, {}
    state = {"part": False}
    n = cfg.rows

    def submit_some():
        for _ in range(rng.randrange(1, 5)):
            if e.leader_id is None:
                return
            client = rng.randrange(1, 5)
            try:
                if client in outstanding:
                    req, amount = outstanding[client]
                    if any(e.is_durable(s) for s in pair_seqs[(client, req)]):
                        del outstanding[client]
                    else:
                        s2, _ = ctr.add(client, amount, request_id=req)
                        pair_seqs[(client, req)].append(s2)
                        continue
                amount = rng.randrange(1, 10)
                seq, req = ctr.add(client, amount)
                outstanding[client] = (req, amount)
                pair_amount[(client, req)] = amount
                pair_seqs.setdefault((client, req), []).append(seq)
            except RuntimeError:
                return

    for _ in range(10):
        submit_some()
        chaos_action(e, rng, n, state, member_floor=3,
                     kill_ok=lambda m, d: d + 1 <= (len(m) - 1) // 2,
                     slow_ok=lambda m, d: True, actions=ALL)
        e.run_for(40.0)
    e.heal_partition()
    for r in range(n):
        if not e.alive[r]:
            e.recover(r)
        e.set_slow(r, False)
    e.run_until_leader(limit=1200.0)
    for (client, req), amount in pair_amount.items():
        tries = 0
        while not any(e.is_durable(s) for s in pair_seqs[(client, req)]):
            tries += 1
            assert tries < 50
            s2, _ = ctr.add(client, amount, request_id=req)
            pair_seqs[(client, req)].append(s2)
            e.run_until_committed(s2, limit=1200.0)
    e.run_for(6 * cfg.heartbeat_period)
    with tempfile.TemporaryDirectory() as td:
        e.save_checkpoint(f"{td}/chaos.ckpt")
        e2 = pkg.RaftEngine.restore(cfg, f"{td}/chaos.ckpt",
                                    pkg.transport(cfg))
        replayed = pkg.ReplicatedCounter(e2, replay=True).value
    return (e, tr, chaos_outcome(e, pkg.committed, []), ctr.value,
            sum(pair_amount.values()), replayed)


def test_exactly_once_counter_under_full_chaos_matches_jax():
    e, tr, got, value, total, replayed = session_run(package("port"), 101)
    want = session_run(package("jax"), 101)
    for key in want[2]:
        assert got[key] == want[2][key], key
    assert (value, total, replayed) == want[3:]
    assert value == total == replayed
    check_chaos_invariants(got, e.cfg.rows)
