"""The engine-level chaos schedules of ``tests/test_chaos.py`` (``:144``,
``:261``, ``:293``, ``:311``, ``:586``; one seed each) on the port's
engine beside the JAX package's: the same seeded interleaving of crashes,
slow windows, disruptive candidacies, partitions and membership changes
drives both engines, whose nodelog lines, majority-side snapshots and
committed payloads must be equal, and the port's run must uphold the JAX
test's invariants. ``:268`` (the same schedule over the replica mesh)
waits for a spawned-rank case of its own."""

import random
import tempfile
from itertools import combinations
from types import SimpleNamespace

import numpy as np
import pytest

ENTRY = 16


def package(name):
    """The names the schedules use, from ``raft_tpu`` ("jax") or
    ``raft_tpu_torch`` (its transport on the CPU)."""
    import importlib

    root = "raft_tpu" if name == "jax" else "raft_tpu_torch"

    def get(mod, attr):
        return getattr(importlib.import_module(f"{root}.{mod}"), attr)

    transport = get("transport", "SingleDeviceTransport")
    return SimpleNamespace(
        RaftConfig=get("config", "RaftConfig"),
        committed_payloads=get("core.state", "committed_payloads"),
        reconstruct=get("ec.reconstruct", "reconstruct"),
        RSCode=get("ec.rs", "RSCode"),
        ReplicatedCounter=get("examples", "ReplicatedCounter"),
        FlightRecorder=get("obs", "FlightRecorder"),
        RaftEngine=get("raft", "RaftEngine"),
        transport=(transport if name == "jax"
                   else lambda cfg: transport(cfg, device="cpu")))


def mk(pkg, **kw):
    cfg = pkg.RaftConfig(transport="single", **kw)
    tr = pkg.FlightRecorder()
    return cfg, pkg.RaftEngine(cfg, pkg.transport(cfg), recorder=tr), tr


def chaos_action(e, rng, n, state, member_floor, kill_ok, slow_ok,
                 actions, cut_any=False):
    """One phase's fault or membership change, JAX's rules (``cut_any``:
    the EC generator's partition cuts any row, not a member sample)."""
    action = rng.choice(actions)
    victim = rng.randrange(n)
    members = [r for r in range(n) if e.member[r]]
    dead = sum(1 for r in members if not e.alive[r])
    if action == "kill":
        if e.alive[victim] and e.member[victim] and kill_ok(members, dead):
            e.fail(victim)
    elif action == "recover":
        if not e.alive[victim]:
            e.recover(victim)
    elif action == "slow":
        if e.alive[victim] and e.member[victim] and slow_ok(members, dead):
            e.set_slow(victim, True)
    elif action == "unslow":
        e.set_slow(victim, False)
    elif action == "campaign":
        e.force_campaign(victim)
    elif action == "partition" and not state["part"]:
        cut = [rng.randrange(n)] if cut_any else rng.sample(members, 1)
        e.partition([cut, [r for r in range(n) if r not in cut]])
        state["part"] = True
    elif action == "heal" and state["part"]:
        e.heal_partition()
        state["part"] = False
    elif action == "add":
        spares = [r for r in range(n) if not e.member[r]]
        if (spares and e._pending_config is None and not state["part"]
                and e.leader_id is not None and dead == 0):
            try:
                e.add_voter(spares[0])
            except RuntimeError:
                pass
    elif action == "remove":
        cands = [r for r in members if r != e.leader_id and e.alive[r]]
        if (len(members) > member_floor and cands and not state["part"]
                and e._pending_config is None
                and e.leader_id is not None and dead == 0):
            try:
                e.remove_server(rng.choice(cands))
            except (RuntimeError, ValueError):
                pass


ALL = ["kill", "recover", "slow", "unslow", "campaign", "partition", "heal",
       "add", "remove", "none"]
NO_MEMBERSHIP = ["kill", "recover", "slow", "unslow", "campaign",
                 "partition", "heal", "none"]


def run_schedule(pkg, e, rng, phases, phase_s, kind):
    """``tests/test_chaos.py``'s ``run_chaos`` (kind "plain"),
    ``run_ec_chaos`` ("ec") and ``run_ec_member_chaos`` ("ec_member")."""
    n, eb = e.cfg.rows, e.cfg.entry_bytes
    quorum = e.cfg.commit_quorum
    state = {"part": False}
    if kind == "plain":
        rules = dict(member_floor=3,
                     kill_ok=lambda m, d: d + 1 <= (len(m) - 1) // 2,
                     slow_ok=lambda m, d: True, actions=ALL)
    elif kind == "ec":
        rules = dict(member_floor=n + 1,
                     kill_ok=lambda m, d: int((~e.alive).sum()) < 1,
                     slow_ok=lambda m, d: not e.slow.any(),
                     actions=NO_MEMBERSHIP, cut_any=True)
    else:
        rules = dict(member_floor=0,
                     kill_ok=lambda m, d: len(m) - d - 1 >= quorum,
                     slow_ok=lambda m, d: (not e.slow.any()
                                           and len(m) - d - 1 >= quorum),
                     actions=ALL)
    e.run_until_leader()
    snaps = []
    for _ in range(phases):
        for _ in range(rng.randrange(0, 5)):
            e.submit(bytes(rng.getrandbits(8) for _ in range(eb)))
        chaos_action(e, rng, n, state, **rules)
        e.run_for(phase_s)
        lead = e.leader_id
        if lead is None:
            continue
        if kind == "plain":
            if ((e.connectivity[lead] & e.member).sum()
                    > int(e.member.sum()) // 2):
                snaps.append([bytes(p) for p in
                              pkg.committed_payloads(e.state, lead)])
        elif kind == "ec":
            if e.connectivity[lead].sum() >= 4:
                snaps.append(int(np.asarray(e.state.commit_index)[lead]))
        elif (e.connectivity[lead] & e.member).sum() >= quorum:
            snaps.append(int(np.asarray(e.state.commit_index)[lead]))
    e.heal_partition()
    for r in range(n):
        if not e.alive[r]:
            e.recover(r)
        e.set_slow(r, False)
    probe = e.submit(bytes(eb))
    e.run_until_committed(probe, limit=1500.0 if kind == "ec_member"
                          else 1200.0)
    e.run_for(6 * e.cfg.heartbeat_period)
    return snaps


def outcome(pkg, e, tr, snaps):
    members = [r for r in range(e.cfg.rows) if e.member[r]]
    return {"lines": tr.nodelog_lines(), "snaps": snaps,
            "watermark": int(e.commit_watermark),
            "member": [bool(x) for x in e.member],
            "committed": {r: [bytes(p) for p in
                              pkg.committed_payloads(e.state, r)]
                          for r in members}}


def check_plain(e, tr, out):
    """``check_invariants``: election safety, state-machine safety over
    the members, leader completeness over the snapshots."""
    assert tr.dropped == 0
    for term, leaders in tr.leaders_by_term().items():
        assert len(leaders) <= 1, term
    comm = out["committed"]
    final = comm[e.leader_id]
    for a in comm:
        for b in comm:
            m = min(len(comm[a]), len(comm[b]))
            assert comm[a][:m] == comm[b][:m]
    for snap in out["snaps"]:
        assert final[:len(snap)] == snap
    assert e._pending_config is None and len(final) >= 1
    assert 3 <= len(comm) <= e.cfg.rows


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
        snaps = run_schedule(pkg, e, random.Random(rng_seed), phases,
                             phase_s, kind)
        outs[name] = (pkg, e, tr, outcome(pkg, e, tr, snaps))
    want, got = outs["jax"][3], outs["port"][3]
    for key in want:
        assert got[key] == want[key], key
    return outs["port"]


def test_chaos_schedule_matches_jax_and_upholds_invariants():
    pkg, e, tr, out = both("plain", 0, 31000, 10, 40.0, n_replicas=3,
                           max_replicas=5, entry_bytes=ENTRY, batch_size=4,
                           log_capacity=256)
    check_plain(e, tr, out)


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
    return (e, tr, outcome(pkg, e, tr, []), ctr.value,
            sum(pair_amount.values()), replayed)


def test_exactly_once_counter_under_full_chaos_matches_jax():
    e, tr, got, value, total, replayed = session_run(package("port"), 101)
    want = session_run(package("jax"), 101)
    for key in want[2]:
        assert got[key] == want[2][key], key
    assert (value, total, replayed) == want[3:]
    assert value == total == replayed
    check_plain(e, tr, got)
