"""Fault schedules of the JAX package's engine-safety suites, written once
against the engine API and run by either package's ``RaftEngine``:
tests/test_partitions.py, tests/test_prevote.py, tests/test_lap_chaos.py
and tests/test_chaos.py's ``run_chaos`` family. Each schedule takes
``pkg`` (``package("jax")``, or ``package("port", device)`` for the port
on the CPU or the card), builds its engine, applies the JAX test's own
assertions as it goes, and returns the engine (and what it observed on
the way); ``observe`` reduces an engine to what two runs must agree on.

Not a test module (leading underscore). It imports neither JAX nor the
JAX package: the spawned mesh ranks (tests/_mesh_ranks.py) and
chip_smoke.py import it; ``package("jax")`` imports the JAX package when
it is called."""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import numpy as np


def package(name: str, device="cpu") -> SimpleNamespace:
    """The names the schedules use, from ``raft_tpu`` ("jax") or
    ``raft_tpu_torch`` (its transport on ``device``)."""
    root = "raft_tpu" if name == "jax" else "raft_tpu_torch"

    def get(mod, attr):
        return getattr(importlib.import_module(f"{root}.{mod}"), attr)

    state = importlib.import_module(f"{root}.core.state")
    transport = get("transport", "SingleDeviceTransport")
    if name == "jax":
        import jax.numpy as jnp

        arr, make_transport = jnp.asarray, transport

        def rows(e, x):
            return np.asarray(x)

        def fold(data, rows, batch):
            return state.fold_batch(data, rows, batch)

        def committed(e, r):
            return state.committed_payloads(e.state, r)

        def entries(e, r, lo, hi):
            return state.log_entries(e.state, r, lo, hi)
    else:
        import torch

        def arr(x):
            return torch.as_tensor(np.asarray(x), device=device)

        def rows(e, x):
            return e._rows(x)

        def make_transport(cfg):
            return transport(cfg, device=device)

        def fold(data, rows, batch):
            return state.fold_batch(data, rows, batch, device=device)

        def committed(e, r):
            return state.committed_payloads(e.state, r, e.t)

        def entries(e, r, lo, hi):
            return state.log_entries(e.state, r, lo, hi, e.t)
    return SimpleNamespace(
        RaftConfig=get("config", "RaftConfig"),
        RaftEngine=get("raft", "RaftEngine"),
        FaultPlan=get("faults", "FaultPlan"),
        FlightRecorder=get("obs", "FlightRecorder"),
        ReplicatedCounter=get("examples", "ReplicatedCounter"),
        reconstruct=get("ec.reconstruct", "reconstruct"),
        RSCode=get("ec.rs", "RSCode"),
        engine_module=importlib.import_module(f"{root}.raft.engine"),
        transport=make_transport, arr=arr, rows=rows, fold=fold,
        committed=committed, entries=entries)


def make(pkg, **kw):
    """A single-device engine of ``pkg`` with its nodelog lines in
    ``e.lines`` and a ``FlightRecorder`` as ``e.recorder``."""
    cfg = pkg.RaftConfig(transport="single", **kw)
    lines = []
    e = pkg.RaftEngine(cfg, pkg.transport(cfg), trace=lines.append,
                       recorder=pkg.FlightRecorder())
    e.lines = lines
    return cfg, e


def rand_bytes(rng, n):
    """``n`` bytes from a ``random.Random``, as the JAX suites draw them."""
    return bytes(rng.getrandbits(8) for _ in range(n))


def np_payloads(n, entry, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, entry, dtype=np.uint8).tobytes()
            for _ in range(n)]


def committed(pkg, e, r):
    return [bytes(p) for p in pkg.committed(e, r)]


def retained(pkg, e, r):
    """Row ``r``'s committed entries its ring still holds validly:
    [lo, hi] with lo past the ring's reach and the row's validity floor,
    hi its commit capped at the watermark (``_ring_matches_archive``'s
    window)."""
    lasts = pkg.rows(e, e.state.last_index)
    commits = pkg.rows(e, e.state.commit_index)
    hi = min(int(commits[r]), int(e.commit_watermark))
    lo = max(1, int(lasts[r]) - e.state.capacity + 1, int(e._ring_floor[r]))
    if hi < lo:
        return lo, hi, []
    return lo, hi, [bytes(p) for p in pkg.entries(e, r, lo, hi)]


def ring_matches_archive(pkg, e):
    """tests/test_lap_chaos.py ``_ring_matches_archive``: every retained
    committed index on every row byte-matches the archive; returns the
    count checked."""
    checked = 0
    for r in range(e.cfg.rows):
        lo, hi, got = retained(pkg, e, r)
        for i in range(lo, hi + 1):
            ent = e.store.get(i)
            if ent is not None:
                assert ent[0] == got[i - lo], (
                    f"replica {r} serves wrong bytes for committed {i}")
                checked += 1
    return checked


def observe(pkg, e) -> dict:
    """What the JAX engine and the port's must agree on after a schedule:
    nodelog lines, leaders by term (and the recorder's drops), terms,
    roles, the leader, the watermark, ``_ring_floor``, every row's
    retained committed bytes (its shards under EC), and the archive
    check's count (full-copy rows only)."""
    rec = e.recorder
    return dict(
        lines=list(e.lines),
        leaders_by_term={t: sorted(v)
                         for t, v in rec.leaders_by_term().items()},
        dropped=rec.dropped,
        terms=[int(x) for x in e.terms], roles=list(e.roles),
        leader=e.leader_id, leader_term=e.leader_term,
        watermark=int(e.commit_watermark),
        ring_floor=[int(x) for x in e._ring_floor],
        member=[bool(x) for x in e.member],
        retained=[retained(pkg, e, r) for r in range(e.cfg.rows)],
        archive_checked=(None if e.cfg.ec_enabled
                         else ring_matches_archive(pkg, e)))


def hold(fn, *args, contexts=None):
    """Run the schedule ``fn(pkg, *args)`` (returning the engine and what
    it observed) on the JAX engine and on the port's on the CPU, each
    under its own context manager from ``contexts`` (a name -> callable
    map); the two runs must agree on ``observe``, on the schedule's own
    observations and on every state leaf. Returns the port's (engine,
    observation, extra). Tests only: it imports the JAX package."""
    from contextlib import nullcontext

    from tests._torch_port import assert_states_equal

    runs = {}
    for name in ("jax", "port"):
        pkg = package(name)
        with (contexts or {}).get(name, nullcontext)():
            e, extra = fn(pkg, *args)
        runs[name] = (e, observe(pkg, e), extra)
    (je, jo, jx), (te, to, tx) = runs["jax"], runs["port"]
    for key in jo:
        assert to[key] == jo[key], f"{fn.__name__}: {key}"
    assert tx == jx, f"{fn.__name__}: the schedule's observations"
    assert_states_equal(je.state, te.state, fn.__name__)
    return te, to, tx


def election_safe(e):
    """At most one leader per term, with no election evidence lost."""
    assert e.recorder.dropped == 0, \
        "flight-recorder ring overflowed: election evidence incomplete"
    for term, leaders in e.recorder.leaders_by_term().items():
        assert len(leaders) <= 1, f"two leaders in term {term}: {leaders}"


# --------------------------------------------- tests/test_partitions.py
PART_ENTRY = 16


def part_make(pkg, seed=0, n=3, **kw):
    return make(pkg, **{**dict(n_replicas=n, entry_bytes=PART_ENTRY,
                               batch_size=4, log_capacity=256, seed=seed),
                        **kw})


def split_brain(pkg, seed):
    """``TestSplitBrain.test_minority_leader_cannot_commit_majority_can``:
    5 replicas, the leader cut off with one friend."""
    cfg, e = part_make(pkg, seed=seed, n=5)
    old = e.run_until_leader()
    pre = np_payloads(5, PART_ENTRY, seed + 10)
    seqs = [e.submit(p) for p in pre]
    e.run_until_committed(seqs[-1])
    e.run_for(4 * cfg.heartbeat_period)
    friend = (old + 1) % 5
    minority = [old, friend]
    majority = [r for r in range(5) if r not in minority]
    e.partition([minority, majority])
    stranded = [e.submit(p) for p in np_payloads(3, PART_ENTRY, seed + 20)]
    e.run_for(120.0)
    assert e.roles[old] == "leader", "stale leader stopped ticking"
    assert not any(e.is_durable(s) for s in stranded)
    new = e.leader_id
    assert new in majority
    assert e.terms[new] > e.terms[old]
    watermark_before = e.commit_watermark
    post = [e.submit(p) for p in np_payloads(4, PART_ENTRY, seed + 30)]
    e.run_until_committed(post[-1])
    assert e.commit_watermark > watermark_before
    e.heal_partition()
    e.run_for(10 * cfg.heartbeat_period)
    assert e.roles[old] == "follower", "stale leader survived heal"
    final = committed(pkg, e, e.leader_id)
    assert final[:len(pre)] == pre
    commits = pkg.rows(e, e.state.commit_index)
    for r in range(5):
        got = committed(pkg, e, r)
        assert got == final[:len(got)], f"replica {r} diverged"
        assert int(commits[r]) >= len(pre)
    return e, dict(old=old, new=new, final=final,
                   durable=[e.is_durable(s) for s in stranded + post])


def isolated_minority(pkg, seed):
    """``TestSplitBrain.test_isolated_minority_cannot_elect``."""
    cfg, e = part_make(pkg, seed=seed, n=3)
    lead = e.run_until_leader()
    loner = (lead + 1) % 3
    rest = [r for r in range(3) if r != loner]
    e.partition([[loner], rest])
    term_before = int(e.terms[loner])
    e.run_for(300.0)
    assert e.terms[loner] > term_before
    assert e.roles[loner] != "leader"
    assert e.leader_id in rest
    s = [e.submit(p) for p in np_payloads(3, PART_ENTRY, seed + 40)]
    e.run_until_committed(s[-1])
    e.heal_partition()
    e.run_for(10 * cfg.heartbeat_period)
    probe = e.submit(np_payloads(1, PART_ENTRY, seed + 50)[0])
    e.run_until_committed(probe, limit=600.0)
    final = committed(pkg, e, e.leader_id)
    for r in range(3):
        got = committed(pkg, e, r)
        assert got == final[:len(got)]
    return e, dict(loner=loner, term_before=term_before, final=final)


def divergent_suffix(pkg):
    """``TestSplitBrain.test_divergent_uncommitted_suffix_truncated_on_heal``:
    the stale leader ingests a batch on its side (driven at the
    transport), which the healed cluster must discard."""
    cfg, e = part_make(pkg, seed=3, n=5)
    old = e.run_until_leader()
    pre = np_payloads(4, PART_ENTRY, 60)
    seqs = [e.submit(p) for p in pre]
    e.run_until_committed(seqs[-1])
    e.run_for(4 * cfg.heartbeat_period)
    friend = (old + 1) % 5
    minority = [old, friend]
    majority = [r for r in range(5) if r not in minority]
    e.partition([minority, majority])
    junk = np_payloads(2, PART_ENTRY, 61)
    pl = pkg.fold(np.frombuffer(b"".join(junk), np.uint8).reshape(
        2, PART_ENTRY), 5, cfg.batch_size)
    eff = e._reach(old)
    e.state, info = e.t.replicate(e.state, pl, 2, old, int(e.terms[old]),
                                  pkg.arr(eff), pkg.arr(e.slow))
    assert int(info.frontier_len) == 2
    assert int(info.commit_index) == len(pre)
    stale_last = int(pkg.rows(e, e.state.last_index)[old])
    assert stale_last == len(pre) + 2
    e.run_for(120.0)
    assert e.leader_id in majority
    post = np_payloads(3, PART_ENTRY, 62)
    s2 = [e.submit(p) for p in post]
    e.run_until_committed(s2[-1])
    e.heal_partition()
    e.run_for(12 * cfg.heartbeat_period)
    final = committed(pkg, e, e.leader_id)
    assert final == pre + post
    for r in range(5):
        got = committed(pkg, e, r)
        assert got == final[:len(got)], f"replica {r}"
    last_old = int(pkg.rows(e, e.state.last_index)[old])
    healed = [bytes(p) for p in pkg.entries(
        e, old, len(pre) + 1, min(last_old, len(pre) + len(post)))]
    assert healed == post[:len(healed)]
    assert junk[0] not in committed(pkg, e, old)
    return e, dict(old=old, final=final, healed=healed,
                   stale_last=stale_last)


def fault_plan_split(pkg):
    """``TestSplitBrain.test_fault_plan_split_schedules``."""
    cfg, e = part_make(pkg, seed=5, n=3)
    lead = e.run_until_leader()
    pre = [e.submit(p) for p in np_payloads(3, PART_ENTRY, 70)]
    e.run_until_committed(pre[-1])
    loner = (lead + 2) % 3
    rest = [r for r in range(3) if r != loner]
    now = e.clock.now
    e.schedule_faults(pkg.FaultPlan.split([[loner], rest], now + 5.0,
                                          now + 80.0))
    e.run_for(4.0)
    seen = [bool(e.connectivity.all())]
    assert seen[-1]
    e.run_for(3.0)
    seen.append(bool(e.connectivity[loner, rest[0]]))
    assert not seen[-1]
    e.run_for(100.0)
    seen.append(bool(e.connectivity.all()))
    assert seen[-1]
    probe = e.submit(np_payloads(1, PART_ENTRY, 71)[0])
    e.run_until_committed(probe, limit=600.0)
    return e, dict(seen=seen)


def replica_log(pkg, e, r):
    """tests/test_properties.py ``replica_log``: row ``r``'s whole log as
    [(term, payload bytes)]."""
    last = int(pkg.rows(e, e.state.last_index)[r])
    if last == 0:
        return []
    slots = (np.arange(1, last + 1) - 1) % e.state.capacity
    terms = pkg.rows(e, e.state.log_term)[r, slots]
    payloads = pkg.entries(e, r, 1, last)
    return [(int(t), bytes(p)) for t, p in zip(terms, payloads)]


def partition_safety(pkg, seed, n):
    """``test_safety_properties_under_partition_schedule``: randomized
    splits, heals and campaigns, then the four safety properties."""
    rng = random.Random(7000 * n + seed)
    cfg, e = part_make(pkg, seed=seed, n=n)
    snapshots = []
    e.run_until_leader()
    partitioned = False
    for _ in range(8):
        for _ in range(rng.randrange(0, 6)):
            e.submit(rand_bytes(rng, PART_ENTRY))
        roll = rng.random()
        if roll < 0.35 and not partitioned:
            cut = rng.sample(range(n), rng.choice([1, max(1, (n - 1) // 2)]))
            rest = [r for r in range(n) if r not in cut]
            if rest:
                e.partition([cut, rest])
                partitioned = True
        elif roll < 0.55 and partitioned:
            e.heal_partition()
            partitioned = False
        elif roll < 0.7:
            e.force_campaign(rng.randrange(n))
        e.run_for(50.0)
        if (e.leader_id is not None
                and e.connectivity[e.leader_id].sum() > n // 2):
            snapshots.append(committed(pkg, e, e.leader_id))
    e.heal_partition()
    probe = e.submit(bytes(PART_ENTRY))
    e.run_until_committed(probe, limit=900.0)
    e.run_for(6 * cfg.heartbeat_period)
    election_safe(e)
    logs = {r: replica_log(pkg, e, r) for r in range(n)}
    for a in range(n):
        for b in range(a + 1, n):
            la, lb = logs[a], logs[b]
            agree = [i for i in range(min(len(la), len(lb)))
                     if la[i][0] == lb[i][0]]
            if agree:
                hi = max(agree)
                assert la[:hi + 1] == lb[:hi + 1], f"replicas {a},{b}"
    comm = {r: committed(pkg, e, r) for r in range(n)}
    for a in range(n):
        for b in range(a + 1, n):
            m = min(len(comm[a]), len(comm[b]))
            assert comm[a][:m] == comm[b][:m], f"replicas {a},{b}"
    final = comm[e.leader_id]
    for i, snap in enumerate(snapshots):
        assert final[:len(snap)] == snap, f"phase-{i} prefix lost"
    assert len(final) >= 1
    return e, dict(snapshots=snapshots, logs=logs)


# ------------------------------------------------ tests/test_prevote.py
def pv_make(pkg, prevote=False, check_quorum=False, n=3, seed=5):
    return make(pkg, n_replicas=n, entry_bytes=8, batch_size=16,
                log_capacity=64, seed=seed, prevote=prevote,
                check_quorum=check_quorum)


def pv_drive(e, k, tag=0):
    rng = np.random.default_rng(tag)
    seqs = [e.submit(rng.integers(0, 256, 8, np.uint8).tobytes())
            for _ in range(k)]
    e.run_until_committed(seqs[-1])
    return seqs


def pv_isolate(pkg, prevote):
    """``test_partitioned_node_term_frozen_and_heal_no_depose`` (PreVote
    on) and ``test_without_prevote_partition_inflates_terms`` (off): one
    follower cut off for 12 election timeouts."""
    cfg, e = pv_make(pkg, prevote=prevote)
    lead = e.run_until_leader()
    pv_drive(e, 8, tag=1)
    term0 = e.leader_term
    f = next(q for q in range(3) if q != lead)
    e.partition([[q for q in range(3) if q != f], [f]])
    e.run_for(12 * cfg.follower_timeout[1])
    isolated = int(e.terms[f])
    if not prevote:
        assert isolated > term0
        return e, dict(term0=term0, isolated=isolated)
    assert isolated == term0, "isolated node inflated its term"
    assert e.roles[f] == "follower"
    assert e.leader_id == lead and e.leader_term == term0
    e.heal_partition()
    e.run_for(4 * cfg.heartbeat_period)
    assert e.leader_id == lead and e.leader_term == term0
    pv_drive(e, 8, tag=2)
    assert e.leader_term == term0
    return e, dict(term0=term0, isolated=isolated)


def pv_stickiness(pkg):
    """``test_force_campaign_suppressed_by_stickiness``."""
    cfg, e = pv_make(pkg, prevote=True)
    lead = e.run_until_leader()
    pv_drive(e, 4, tag=3)
    term0 = e.leader_term
    terms0 = e.terms.copy()
    f = next(q for q in range(3) if q != lead)
    e.force_campaign(f)
    assert e.leader_id == lead and e.leader_term == term0
    assert (e.terms == terms0).all(), "suppressed candidacy moved a term"
    pv_drive(e, 4, tag=4)
    assert e.leader_term == term0
    return e, dict(term0=term0)


def pv_leader_loss(pkg):
    """``test_prevote_still_elects_on_real_leader_loss``."""
    cfg, e = pv_make(pkg, prevote=True)
    lead = e.run_until_leader()
    pv_drive(e, 4, tag=5)
    e.fail(lead)
    new = e.run_until_leader()
    assert new != lead
    pv_drive(e, 4, tag=6)
    return e, dict(lead=lead, new=new)


def pv_check_quorum(pkg):
    """``test_check_quorum_minority_leader_steps_down``: the minority
    leader demotes itself and refuses a linearizable read."""
    cfg, e = pv_make(pkg, prevote=True, check_quorum=True, n=5)
    lead = e.run_until_leader()
    pv_drive(e, 8, tag=7)
    others = [q for q in range(5) if q != lead]
    e.partition([[lead, others[0]], others[1:]])
    e.run_for(cfg.follower_timeout[0] + 8 * cfg.heartbeat_period)
    assert e.roles[lead] == "follower", "minority leader kept leading"
    refused = pkg.engine_module.LinearizableReadRefused
    try:
        e.read_linearizable(lead)
    except refused as ex:
        refusal = (type(ex).__name__, str(ex))
    else:
        raise AssertionError("the minority's read was served")
    e.run_until_leader(limit=3 * cfg.follower_timeout[1])
    assert e.leader_id in others[1:]
    e.heal_partition()
    e.run_for(4 * cfg.heartbeat_period)
    pv_drive(e, 8, tag=8)
    return e, dict(lead=lead, refusal=refusal)


def pv_chaos_mix(pkg):
    """``test_chaos_mix_with_flags_on``: kills, recoveries, partitions and
    campaigns with PreVote and CheckQuorum on."""
    cfg, e = pv_make(pkg, prevote=True, check_quorum=True, n=5, seed=9)
    e.run_until_leader()
    rng = np.random.default_rng(9)
    done = 0
    rounds = []
    for round_no in range(12):
        kind = round_no % 4
        if kind == 0:
            v = rng.integers(0, 5)
            if e.alive[v] and e.leader_id != v:
                e.fail(int(v))
        elif kind == 1:
            for q in range(5):
                if not e.alive[q]:
                    e.recover(q)
        elif kind == 2:
            side = sorted(rng.choice(5, size=2, replace=False).tolist())
            rest = [q for q in range(5) if q not in side]
            e.partition([side, rest])
        else:
            e.heal_partition()
            e.force_campaign(int(rng.integers(0, 5)))
        e.run_for(cfg.follower_timeout[1])
        if e.leader_id is None:
            try:
                e.run_until_leader(limit=6 * cfg.follower_timeout[1])
            except AssertionError:
                rounds.append("leaderless")
                continue
        try:
            pv_drive(e, 4, tag=100 + round_no)
            done += 4
            rounds.append("committed")
        except AssertionError:
            rounds.append("stalled")
            continue
    assert done >= 24, done
    assert e.commit_watermark >= done
    assert int(e.terms.max()) <= 2 + 12, int(e.terms.max())
    return e, dict(done=done, rounds=rounds)


# ---------------------------------------------- tests/test_lap_chaos.py
LAP_ENTRY = 16
LAP_CAP = 32


def run_lap_chaos(pkg, seed):
    """``run_lap_chaos``: capacity 32 under crashes, partitions,
    campaigns and membership changes with heavy traffic."""
    rng = random.Random(71000 + seed)
    cfg, e = make(pkg, n_replicas=3, max_replicas=5, entry_bytes=LAP_ENTRY,
                  batch_size=8, log_capacity=LAP_CAP, seed=seed)
    e.run_until_leader()
    for _ in range(8):
        for _ in range(rng.randrange(10, 30)):
            e.submit(rand_bytes(rng, LAP_ENTRY))
        action = rng.choice(["kill", "recover", "partition", "heal",
                             "campaign", "add", "remove", "none"])
        victim = rng.randrange(cfg.rows)
        members = [r for r in range(cfg.rows) if e.member[r]]
        dead = sum(1 for r in members if not e.alive[r])
        partitioned = not e.connectivity.all()
        if (action == "kill" and e.alive[victim] and e.member[victim]
                and dead + 1 <= (len(members) - 1) // 2):
            e.fail(victim)
        elif action == "recover" and not e.alive[victim]:
            e.recover(victim)
        elif action == "partition" and not partitioned:
            cut = rng.sample(members, 1)
            e.partition([cut, [r for r in range(cfg.rows) if r not in cut]])
        elif action == "heal" and partitioned:
            e.heal_partition()
        elif action == "campaign":
            e.force_campaign(victim)
        elif action == "add":
            spares = [r for r in range(cfg.rows) if not e.member[r]]
            if (spares and e._pending_config is None and not partitioned
                    and dead == 0 and e.leader_id is not None):
                try:
                    e.add_voter(spares[0])
                except RuntimeError:
                    pass
        elif action == "remove":
            cands = [r for r in members if r != e.leader_id and e.alive[r]]
            if (len(members) > 3 and cands and not partitioned and dead == 0
                    and e._pending_config is None
                    and e.leader_id is not None):
                try:
                    e.remove_server(rng.choice(cands))
                except RuntimeError:
                    pass
        e.run_for(40.0)
    e.heal_partition()
    for r in range(cfg.rows):
        if not e.alive[r]:
            e.recover(r)
        e.set_slow(r, False)
    probe = e.submit(bytes(LAP_ENTRY))
    e.run_until_committed(probe, limit=1200.0)
    e.run_for(6 * cfg.heartbeat_period)
    return e, {}


def run_ec_lap_chaos(pkg, seed):
    """``run_ec_lap_chaos``: RS(5,3) at capacity 32 with heavy traffic."""
    rng = random.Random(81000 + seed)
    cfg, e = make(pkg, n_replicas=5, rs_k=3, rs_m=2, entry_bytes=12,
                  batch_size=8, log_capacity=LAP_CAP, seed=seed)
    e.run_until_leader()
    partitioned = False
    for _ in range(8):
        for _ in range(rng.randrange(10, 30)):
            e.submit(rand_bytes(rng, 12))
        action = rng.choice(["kill", "recover", "slow", "unslow",
                             "campaign", "partition", "heal", "none"])
        victim = rng.randrange(5)
        if action == "kill":
            if e.alive[victim] and int((~e.alive).sum()) < 1:
                e.fail(victim)
        elif action == "recover":
            if not e.alive[victim]:
                e.recover(victim)
        elif action == "slow":
            if e.alive[victim] and not e.slow.any():
                e.set_slow(victim, True)
        elif action == "unslow":
            e.set_slow(victim, False)
        elif action == "campaign":
            e.force_campaign(victim)
        elif action == "partition" and not partitioned:
            cut = [rng.randrange(5)]
            e.partition([cut, [r for r in range(5) if r not in cut]])
            partitioned = True
        elif action == "heal" and partitioned:
            e.heal_partition()
            partitioned = False
        e.run_for(40.0)
    e.heal_partition()
    for r in range(5):
        if not e.alive[r]:
            e.recover(r)
        e.set_slow(r, False)
    probe = e.submit(bytes(12))
    e.run_until_committed(probe, limit=1800.0)
    e.run_for(6 * cfg.heartbeat_period)
    return e, dict(read=ec_window_read(e))


def ec_window_read(e):
    """``test_ec_full_ring_old_term_deadlock_escapes``'s read: the last
    ring of committed entries through ``committed_entries``, each held to
    the archive; returns the bytes, or the refusal's text (no eligible
    read quorum at quiescence is legal)."""
    wm = e.commit_watermark
    lo = max(1, wm - LAP_CAP + 1, int(max(e._ring_floor[:5])))
    try:
        got = e.committed_entries(lo, wm)
    except ValueError as ex:
        return str(ex)
    out = []
    for i in range(lo, wm + 1):
        b = bytes(np.asarray(got[i - lo]).tobytes())
        ent = e.store.get(i)
        if ent is not None:
            assert ent[0] == b, f"idx {i}"
        out.append(b)
    return out


def run_pipelined_lap_chaos(pkg, seed):
    """``test_pipelined_multi_lap_under_chaos``'s schedule: whole-ring and
    two-lap ``submit_pipelined`` flights (``pipeline_max_laps=2``)
    between faults. The caller opens the flight hook where the backend
    does not (and, for JAX, the Pallas interpret mode). A gate/kernel
    desync raises the shortfall ``RuntimeError`` out of here. Returns the
    engine and the flights' lengths in launch order."""
    rng = random.Random(91000 + seed)
    cfg, e = make(pkg, n_replicas=3, entry_bytes=16, batch_size=128,
                  log_capacity=256, seed=seed, pipeline_max_laps=2)
    e.run_until_leader()
    flights = []
    orig = e.t.replicate_pipeline

    def counting(state, payloads, counts, *a, **k):
        flights.append(int(counts.shape[0]))
        return orig(state, payloads, counts, *a, **k)

    e.t.replicate_pipeline = counting
    partitioned = False
    for _ in range(6):
        if e.leader_id is None:
            e.run_for(60.0)
            continue
        n = rng.randrange(2, 5) * 256
        e.submit_pipelined([rand_bytes(rng, 16) for _ in range(n)])
        action = rng.choice(["kill", "recover", "partition", "heal",
                             "campaign", "none"])
        victim = rng.randrange(3)
        if action == "kill" and e.alive[victim] \
                and int((~e.alive).sum()) < 1:
            e.fail(victim)
        elif action == "recover" and not e.alive[victim]:
            e.recover(victim)
        elif action == "partition" and not partitioned:
            e.partition([[victim], [r for r in range(3) if r != victim]])
            partitioned = True
        elif action == "heal" and partitioned:
            e.heal_partition()
            partitioned = False
        elif action == "campaign":
            e.force_campaign(victim)
        e.run_for(60.0)
    e.heal_partition()
    for r in range(3):
        if not e.alive[r]:
            e.recover(r)
    probe = e.submit(bytes(16))
    e.run_until_committed(probe, limit=1800.0)
    e.run_for(6 * cfg.heartbeat_period)
    assert e.commit_watermark > cfg.log_capacity
    assert ring_matches_archive(pkg, e) > 0
    T_lap = 2 * (cfg.log_capacity // cfg.batch_size)
    assert T_lap in flights, f"the lapped shape never launched: {flights}"
    return e, flights


# ------------------------------------------------- tests/test_chaos.py
CHAOS_ENTRY = 16
ALL = ["kill", "recover", "slow", "unslow", "campaign", "partition", "heal",
       "add", "remove", "none"]
NO_MEMBERSHIP = ["kill", "recover", "slow", "unslow", "campaign",
                 "partition", "heal", "none"]


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


def run_schedule(committed_of, e, rng, phases, phase_s, kind):
    """``tests/test_chaos.py``'s ``run_chaos`` (kind "plain"),
    ``run_ec_chaos`` ("ec") and ``run_ec_member_chaos`` ("ec_member");
    ``committed_of(e, r)`` reads a row's committed payloads (on the mesh
    every rank reads every row through its transport)."""
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
            e.submit(rand_bytes(rng, eb))
        chaos_action(e, rng, n, state, **rules)
        e.run_for(phase_s)
        lead = e.leader_id
        if lead is None:
            continue
        if kind == "plain":
            if ((e.connectivity[lead] & e.member).sum()
                    > int(e.member.sum()) // 2):
                snaps.append([bytes(p) for p in committed_of(e, lead)])
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


#: ``test_chaos_over_mesh_transport``'s cluster (``tests/test_chaos.py:268``)
MESH_CHAOS = dict(n_replicas=3, max_replicas=5, entry_bytes=CHAOS_ENTRY,
                  batch_size=4, log_capacity=256, seed=0)
MESH_CHAOS_RUN = dict(rng_seed=61000, phases=7, phase_s=35.0)


def chaos_outcome(e, committed_of, snaps):
    """What a chaos run must agree on with the JAX engine's, and what
    ``check_chaos_invariants`` reads: the recorder's nodelog lines and
    election evidence, the snapshots, the leader, the watermark, the
    membership and every member's committed payloads."""
    members = [r for r in range(e.cfg.rows) if e.member[r]]
    return dict(lines=e.recorder.nodelog_lines(), snaps=snaps,
                leader=e.leader_id, watermark=int(e.commit_watermark),
                member=[bool(x) for x in e.member],
                pending_config=e._pending_config,
                committed={r: [bytes(p) for p in committed_of(e, r)]
                           for r in members},
                leaders_by_term={t: sorted(v) for t, v in
                                 e.recorder.leaders_by_term().items()},
                dropped=e.recorder.dropped)


def mesh_chaos(e, committed_of):
    """``test_chaos_over_mesh_transport``'s schedule on an engine built at
    ``MESH_CHAOS`` with a recorder; its ``chaos_outcome``."""
    snaps = run_schedule(committed_of, e,
                         random.Random(MESH_CHAOS_RUN["rng_seed"]),
                         MESH_CHAOS_RUN["phases"], MESH_CHAOS_RUN["phase_s"],
                         "plain")
    return chaos_outcome(e, committed_of, snaps)


def check_chaos_invariants(out, rows):
    """``tests/test_chaos.py`` ``check_invariants`` on a
    ``chaos_outcome``: election safety, state-machine safety over the
    members, leader completeness over the snapshots, membership
    coherence."""
    assert out["dropped"] == 0
    for term, leaders in out["leaders_by_term"].items():
        assert len(leaders) <= 1, f"two leaders in term {term}: {leaders}"
    comm = out["committed"]
    final = comm[out["leader"]]
    for a in comm:
        for b in comm:
            m = min(len(comm[a]), len(comm[b]))
            assert comm[a][:m] == comm[b][:m], f"members {a},{b}"
    for i, snap in enumerate(out["snaps"]):
        assert final[:len(snap)] == snap, f"phase-{i} prefix lost"
    assert out["pending_config"] is None
    assert 3 <= len(comm) <= rows
    assert len(final) >= 1
