"""Kernels K2-K4's plain versions (raft_tpu_torch.core.step_cuda) against
the JAX package's Pallas kernels in interpret mode:

- K2 (whole steady step, and its T-step scan) against
  steady_replicate_step_tpu / steady_scan_replicate_tpu on the scripted
  schedules of tests/test_steady_fused.py::TestScripted;
- K3 (steady flight) against steady_pipeline_tpu where interpret mode is
  faithful (no slot revisited in one flight), feasible and infeasible, and
  against the per-step scan across ring laps;
- K4 (turnover flight) against the JAX turnover kernel across laps, which
  interpret mode models faithfully.

Every state leaf and RepInfo field is compared bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.core import step_pallas as jsp
from raft_tpu_torch.core import step_cuda as tsc
from tests._torch_port import (
    Duo,
    assert_infos_equal,
    assert_states_equal,
    pallas_interpret,
    rand_batch,
    to_port,
)

B, C, N = 128, 256, 3
ALL = [True] * N
OK = [False] * N


@pytest.fixture(autouse=True)
def _interpret():
    with pallas_interpret():
        yield


SCRIPTED = {
    "steady_and_heartbeat": [(1, 100, 0, 1, ALL, OK, 1), (2, B, 0, 1, ALL, OK, 1),
                             (3, 0, 0, 1, ALL, OK, 1)],
    "wrap_seam": [(s, B, 0, 1, ALL, OK, 1) for s in range(4)],
    "slow_follower": [(1, B, 0, 1, ALL, [False, False, True], 1),
                      (2, B, 0, 1, ALL, [False, False, True], 1)],
    "no_quorum": [(1, B, 0, 1, ALL, [False, True, True], 1)],
    "deposed_leader": [(1, B, 0, 1, ALL, OK, 1), (2, B, 1, 2, ALL, OK, B + 1),
                       (3, B, 0, 1, ALL, OK, 1)],
    "term_adoption": [(1, B, 0, 3, ALL, OK, 1)],
    "old_term_quorum": [(1, B, 0, 1, ALL, [False, True, True], 1),
                        (2, 0, 0, 2, ALL, OK, B + 1),
                        (3, 64, 0, 2, ALL, OK, B + 1)],
    "backpressure": [(s, B, 0, 1, ALL, [False, True, True], 1)
                     for s in range(3)],
    "dead_row": [(1, B, 0, 1, [True, True, False], OK, 1),
                 (2, B, 0, 1, [True, True, False], OK, 1)],
    "member_shrunk": [(1, B, 0, 1, ALL, OK, 1), (2, B, 0, 1, ALL, OK, 1)],
}
MEMBER = {"member_shrunk": ([True, False, False], 2)}


@pytest.mark.parametrize("name", sorted(SCRIPTED))
def test_k2_scripted_matches_pallas(name):
    d = Duo(n_replicas=N, entry_bytes=8, batch_size=B, log_capacity=C)
    member, quorum = MEMBER.get(name, (None, None))
    for seed, count, leader, term, alive, slow, tf in SCRIPTED[name]:
        d.rep(rand_batch(seed, count, B), count, leader, term, alive, slow,
              repair=False, term_floor=tf, member=member,
              commit_quorum=quorum)


_J_SCAN = jax.jit(jsp.steady_scan_replicate_tpu,
                  static_argnames=("commit_quorum", "interpret",
                                   "stack_infos"))


def test_k2_scan_matches_pallas_scan():
    counts = np.array([B, 100, 0, B, 17, B], np.int32)
    pays = np.stack([rand_batch(40 + t, int(c), B)
                     for t, c in enumerate(counts)])   # same shape as the
    #   lapped-flight reference below: one compiled JAX scan
    slow = np.array([False, False, True])
    cfg = JConfig(n_replicas=N, entry_bytes=8, batch_size=B, log_capacity=C)
    args = (jnp.int32(0), jnp.int32(1), jnp.ones(N, bool), jnp.asarray(slow),
            jnp.int32(0), jnp.int32(0), None, jnp.int32(1))
    js, ji = _J_SCAN(jst.init_state(cfg), jnp.asarray(pays),
                     jnp.asarray(counts), *args, interpret=True)
    ts, ti = tsc.steady_scan_replicate(
        to_port(jst.init_state(cfg)), torch.from_numpy(pays),
        torch.from_numpy(counts), 0, 1, torch.ones(N, dtype=torch.bool),
        torch.from_numpy(slow), 0, 0, None, 1)
    assert_infos_equal(ji, ti, "scan")
    assert_states_equal(js, ts, "scan")


_J_PIPE = jax.jit(jsp.steady_pipeline_tpu,
                  static_argnames=("commit_quorum", "interpret",
                                   "allow_turnover"))


def _flight(cap, T, P, slow, counts=None, seed=900, compare="pipeline"):
    """Run one flight through the port and the named JAX reference: the
    JAX pipeline entry point, or the per-step scan fed the same windows."""
    cfg = JConfig(n_replicas=N, entry_bytes=8, batch_size=B,
                  log_capacity=cap)
    wins = np.stack([rand_batch(seed + p, B, B) for p in range(P)])
    counts = np.full(T, B, np.int32) if counts is None else counts
    args = (jnp.int32(0), jnp.int32(1), jnp.ones(N, bool), jnp.asarray(slow),
            jnp.int32(0), jnp.int32(0), None, jnp.int32(1))
    if compare == "pipeline":
        js, ji = _J_PIPE(jst.init_state(cfg), jnp.asarray(wins),
                         jnp.asarray(counts), *args, commit_quorum=None,
                         interpret=True)
    else:
        xs = np.stack([wins[t % P] for t in range(T)])
        js, ji = _J_SCAN(jst.init_state(cfg), jnp.asarray(xs),
                         jnp.asarray(counts), *args, interpret=True)
        ji = jax.tree.map(lambda a: a[-1], ji)
    work = tsc.workspace("cpu")
    n3, n4 = int(work[tsc.WK_RAN3]), int(work[tsc.WK_RAN4])
    ts, ti = tsc.steady_pipeline(
        to_port(jst.init_state(cfg)), torch.from_numpy(wins),
        torch.from_numpy(counts), 0, 1, torch.ones(N, dtype=torch.bool),
        torch.from_numpy(np.asarray(slow)), 0, 0, None, 1)
    assert_states_equal(js, ts, "flight")
    assert_infos_equal(ji, ti, "flight")
    ran3 = int(work[tsc.WK_RAN3]) - n3
    ran4 = int(work[tsc.WK_RAN4]) - n4
    return ts, ti, ("K4" if ran4 else "K3" if ran3 else "none")


# one flight shape in the interpret-faithful range (T*B <= C): every case
# below shares one compiled JAX program
FLIGHT = dict(cap=1024, T=5, P=5)


def test_k3_feasible_matches_pallas_pipeline():
    ts, ti, which = _flight(**FLIGHT, slow=OK)
    assert which == "K3" and int(ti.commit_index) == 5 * B


def test_k3_slow_row_matches_pallas_pipeline():
    ts, ti, which = _flight(**FLIGHT, slow=[False, False, True])
    assert which == "K3" and int(ti.commit_index) == 5 * B
    assert int(ts.last_index[2]) == 0


def test_k3_infeasible_no_quorum_matches():
    """Two slow rows: below quorum, the flight is infeasible and the JAX
    side takes its per-step scan; the leader appends, nothing commits."""
    ts, ti, which = _flight(**FLIGHT, slow=[False, True, True])
    assert which == "K3" and int(ts.last_index[0]) == 5 * B
    assert int(ti.commit_index) == 0


def test_k3_partial_counts_infeasible_matches():
    counts = np.array([B, B, 77, B, 0], np.int32)
    ts, ti, which = _flight(**FLIGHT, slow=OK, counts=counts)
    assert which == "K3" and int(ti.commit_index) == 3 * B + 77


def test_k3_across_laps_matches_scan():
    """A slow row keeps a lapped flight off the turnover kernel; across
    ring laps the reference is the per-step scan."""
    ts, ti, which = _flight(C, T=6, P=6, slow=[False, False, True],
                            compare="scan")
    assert which == "K3" and int(ti.commit_index) == 6 * B
    assert int(ts.last_index[2]) == 0


def test_k4_turnover_matches_pallas_across_laps():
    ts, ti, which = _flight(C, T=7, P=7, slow=OK)     # 3.5 ring laps
    assert which == "K4" and int(ti.commit_index) == 7 * B


def test_launch_feasibility_matches():
    d = Duo(n_replicas=N, entry_bytes=8, batch_size=B, log_capacity=C)
    d.vote(0, 1)
    d.rep(rand_batch(5, B, B), B, repair=False, term_floor=1)
    cases = [(OK, np.full(4, B)), ([False, True, True], np.full(4, B)),
             (OK, np.array([B, 3, B, B])), ([False, False, True],
                                            np.full(2, B))]
    for slow, counts in cases:
        counts = counts.astype(np.int32)
        jparams, jmasks = jsp._params_and_masks(
            jnp.int32(0), jnp.int32(1), jnp.int32(1), jnp.int32(0),
            jnp.int32(0), jnp.ones(N, bool), jnp.asarray(slow), None, None,
            N)
        jvecs = jsp._pack(d.j)
        s0, prev0 = jsp._start_slot_and_prev(jvecs, d.j.log_term,
                                             jnp.int32(0), C, N)
        jf, ja = jsp._launch_feasibility(
            jvecs, jmasks, jparams, prev0, jnp.asarray(counts), s0, 128, B,
            N, jnp.int32(0), jnp.int32(1), jnp.int32(0), jnp.int32(0))
        prm = tsc.step_params(0, 1, 1, 0, 0, None, N)
        params, masks = tsc.params_and_masks(
            prm, torch.ones(N, dtype=torch.bool), torch.tensor(slow), None)
        np.testing.assert_array_equal(params.numpy(), np.asarray(jparams))
        np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
        ts = to_port(d.j)
        vecs = tsc.pack(ts)
        ts0, tprev = tsc.start_slot_and_prev(vecs, ts.log_term, 0, C, N)
        assert ts0 == int(s0[0])
        np.testing.assert_array_equal(tprev.numpy(), np.asarray(prev0))
        tf, ta = tsc.launch_feasibility(
            vecs, masks, params, tprev, torch.from_numpy(counts), ts0, 128,
            B, N, 0, 1, 0, 0)
        assert bool(tf) == bool(jf)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_k2_out_block_and_next_prev():
    """The step's extra outputs: next start slot and the next prev-term
    column equal what the following step derives from the state."""
    d = Duo(n_replicas=N, entry_bytes=8, batch_size=B, log_capacity=C)
    d.vote(0, 1)
    ts = d.t
    vecs = tsc.pack(ts)
    out = torch.empty(2 * N + 5, dtype=torch.int32)
    prm = tsc.step_params(0, 1, 1, 0, 0, None, N)
    alive = torch.ones(N, dtype=torch.bool)
    slow = torch.tensor([False, True, False])
    for count in (B, 77, 0, B):
        tsc.steady_step(vecs, ts.log_payload, ts.log_term,
                        torch.from_numpy(np.array(rand_batch(count, count, B))),
                        count, alive, slow, None, prm, out)
        s, prev = tsc.start_slot_and_prev(vecs, ts.log_term, 0, C, N)
        assert int(out[N + 3]) == s
        np.testing.assert_array_equal(out[N + 5:].numpy(),
                                      prev[:, 0].numpy())


def test_wrappers_take_plain_version_on_cpu():
    counts = dict(tsc.LAUNCHES)
    _flight(**FLIGHT, slow=OK)
    test_k2_scripted_matches_pallas("wrap_seam")
    assert tsc.LAUNCHES == counts
