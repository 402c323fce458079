"""core.step of raft_tpu_torch against raft_tpu's: replicate_step (repair
and steady), vote_step and scan_replicate, fed the same inputs, with every
state leaf and RepInfo/VoteInfo field compared bit for bit after every
call. Scenarios are those of tests/test_core_step.py, plus a randomized
multi-term schedule in the style of test_steady_fused.py at a
kernel-eligible shape, where the JAX side runs its Pallas kernels in
interpret mode."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import step as jstep
from raft_tpu.core.comm import SingleDeviceComm as JComm
from raft_tpu_torch.core import step as tstep
from raft_tpu_torch.core.comm import SingleDeviceComm as TComm
from tests._torch_port import (
    Duo,
    assert_infos_equal,
    assert_states_equal,
    batch,
    pallas_interpret,
    rand_batch,
)

SMALL = dict(n_replicas=3, entry_bytes=8, batch_size=4, log_capacity=32)


def sc_votes(d):
    d.vote(0, 1)
    d.vote(1, 1)
    d.vote(1, 2)
    d.rep(batch([1, 2, 3, 4]), 4, leader=1, term=2)
    d.fabricate(last_index=[4, 0, 4])
    d.vote(1, 3)
    d.vote(0, 4, alive=[True, True, False])


def sc_steady_and_partial(d):
    d.vote(0, 1)
    d.rep(batch([10, 11, 12, 13]), 4)
    d.rep(batch([7, 8, 0, 0]), 2)
    d.rep(batch([0] * 4), 0)


def sc_straggler_heals(d):
    d.vote(0, 1)
    slow = [False, False, True]
    for i in range(5):
        d.rep(batch([i] * 4), 4, slow=slow)
    for _ in range(5):
        info = d.rep(batch([0] * 4), 0)
    assert list(info.match.numpy()) == [20, 20, 20]


def sc_dead_and_stale(d):
    alive = [True, True, False]
    d.vote(0, 1, alive=alive)
    d.rep(batch([1, 2, 3, 4]), 4, alive=alive)
    d.vote(1, 5)
    info = d.rep(batch([9] * 4), 4, leader=0, term=1)
    assert int(info.max_term) == 5


def sc_prior_term(d):
    d.vote(0, 1)
    d.rep(batch([1, 2, 3, 4]), 4)
    d.vote(1, 2)
    d.rep(batch([0] * 4), 0, leader=1, term=2)
    d.rep(batch([5, 0, 0, 0]), 1, leader=1, term=2)


def sc_conflict_truncation(d):
    d.vote(0, 1)
    d.rep(batch([1, 2, 0, 0]), 2)
    w = 2
    lt = d.leaf("log_term").copy()
    lt[1, 2:4] = 1
    lp = d.leaf("log_payload").copy()
    lp[2:4, w:2 * w] = 99
    li = d.leaf("last_index").copy()
    li[1] = 4
    d.fabricate(log_term=lt, log_payload=lp, last_index=li)
    d.vote(0, 2)
    d.rep(batch([42, 0, 0, 0]), 1, leader=0, term=2)
    assert int(d.t.last_index[1]) == 3


def sc_suffix_and_redelivery(d):
    d.vote(0, 1)
    d.rep(batch([1, 2, 3, 4]), 4)
    mi = d.leaf("match_index").copy()
    mi[2] = 2
    d.fabricate(match_index=mi)
    d.rep(batch([0] * 4), 0)
    mi = d.leaf("match_index").copy()
    mi[2] = 0
    d.fabricate(match_index=mi)
    d.rep(batch([0] * 4), 0)


def sc_divergent_rejoin(d):
    d.vote(0, 1)
    d.rep(batch([11, 12, 13, 14]), 4, slow=[False, True, True])
    alive2 = [False, True, True]
    d.vote(1, 2, alive=alive2)
    d.rep(batch([21, 22, 23, 24]), 4, leader=1, term=2, alive=alive2)
    d.rep(batch([0] * 4), 0, leader=1, term=2)
    assert int(d.t.commit_index[0]) == 4


def sc_backpressure(d):
    d.vote(0, 1)
    only0 = [True, False, False]
    for _ in range(11):
        d.rep(batch([7] * 4), 4, alive=only0)
    assert int(d.t.last_index[0]) == 32


def sc_lapped_replica(d):
    d.vote(0, 1)
    for i in range(10):
        d.rep(batch([i % 251 + 1] * 4), 4, slow=[False, False, True])
    info = d.rep(batch([0] * 4), 0)
    assert int(info.match[2]) == 0 and int(d.t.last_index[2]) == 0


def sc_learner(d):
    """A packed membership mask: row 2 is a learner — it hears and
    appends but is outside the quorum, so row 1 being slow stalls commit."""
    packed = np.array([1, 1, 2], np.int32)       # voter, voter, learner
    d.vote(0, 1)
    d.rep(batch([1, 2, 3, 4]), 4, slow=[False, True, False], member=packed)
    d.rep(batch([5, 6, 7, 8]), 4, member=packed)
    d.rep(batch([0] * 4), 0, member=packed)


def sc_ec_quorum(d):
    """The EC quorum rule: no repair window, and a member majority clamped
    to the static durability floor (commit_quorum)."""
    member = np.array([True, True, True, True, False])
    d.vote(0, 1)
    for slow in ([False, False, True, True, False], [False] * 5):
        d.rep(batch([3, 1, 4, 1], rows=5), 4, slow=slow, member=member,
              commit_quorum=4, ec=True)


SCENARIOS = {
    "learner": (sc_learner, SMALL),
    "ec_quorum": (sc_ec_quorum, dict(SMALL, n_replicas=5)),
    "votes": (sc_votes, SMALL),
    "steady_and_partial": (sc_steady_and_partial, SMALL),
    "straggler_heals": (sc_straggler_heals, SMALL),
    "dead_and_stale": (sc_dead_and_stale, SMALL),
    "prior_term": (sc_prior_term, SMALL),
    "conflict_truncation": (sc_conflict_truncation, SMALL),
    "suffix_and_redelivery": (sc_suffix_and_redelivery, SMALL),
    "divergent_rejoin": (sc_divergent_rejoin, SMALL),
    "backpressure": (sc_backpressure, SMALL),
    "lapped_replica": (sc_lapped_replica, SMALL),
    "wraparound": (lambda d: [d.vote(0, 1)] + [
        d.rep(batch([i] * 4), 4) for i in range(5)],
        dict(SMALL, log_capacity=8)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_core_step_scenarios(name):
    fn, kw = SCENARIOS[name]
    fn(Duo(**kw))


def test_single_replica():
    d = Duo(n_replicas=1, entry_bytes=8, batch_size=4, log_capacity=32)
    d.vote(0, 1)
    info = d.rep(batch([1, 2, 3, 4], rows=1), 4)
    assert int(info.commit_index) == 4


_JSCAN = jax.jit(partial(jstep.scan_replicate, JComm(3), False, None, True))


def test_scan_replicate_matches():
    kw = dict(n_replicas=3, entry_bytes=8, batch_size=4, log_capacity=32)
    d = Duo(**kw)
    d.vote(0, 1)
    pays = np.stack([batch([i, i + 1, i + 2, i + 3]) for i in range(3)])
    counts = np.array([4, 2, 4], np.int32)
    slow = np.array([False, False, True])
    js, ji = _JSCAN(d.j, jnp.asarray(pays), jnp.asarray(counts),
                    jnp.int32(0), jnp.int32(1), jnp.ones(3, bool),
                    jnp.asarray(slow))
    ts, ti = tstep.scan_replicate(
        TComm(3), False, None, True, d.t, torch.from_numpy(pays),
        torch.from_numpy(counts), 0, 1, torch.ones(3, dtype=torch.bool),
        torch.from_numpy(slow))
    assert_infos_equal(ji, ti, "scan")
    assert_states_equal(js, ts, "scan")


B, C, N = 128, 256, 3


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_multi_term_schedule(seed):
    """Leader churn with elections, fault masks, partial counts; repair
    ticks (the JAX ring kernel, interpret mode) interleaved with steady
    ticks carrying the engine's term_floor (the JAX whole-step kernel)."""
    rng = np.random.default_rng(2000 + seed)
    d = Duo(n_replicas=N, entry_bytes=8, batch_size=B, log_capacity=C)
    term, leader = 1, 0
    with pallas_interpret():
        d.vote(leader, term)
        floor = 1
        for step in range(14):
            if rng.random() < 0.25:
                term += int(rng.integers(1, 3))
                leader = int(rng.integers(0, N))
                d.vote(leader, term, alive=list(rng.random(N) > 0.2))
                floor = int(d.t.last_index[leader]) + 1
            count = int(rng.choice([0, 17, 64, B]))
            alive = list(rng.random(N) > 0.15)
            alive[leader] = True
            slow = list(rng.random(N) < 0.25)
            steady = rng.random() < 0.5
            d.rep(rand_batch(100 * seed + step, count, B), count, leader,
                  term, alive, slow, repair=not steady,
                  term_floor=floor if steady else None)
