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

- K4 launched alone (the plan's decision and start slot set in the
  workspace) against the JAX turnover kernel on bookkeeping planes the
  main path does not give (a leader term of 0, a term floor beyond the
  flight's last tail, rows at mixed terms, votes and commits), and its
  closed-form bookkeeping (the mirror of ``test_torch_steady_mesh.py``)
  against the plain step loop on random resident planes;
- a Python mirror of the CUDA K4's copy (``csrc/steady.cu``
  ``for_runs``: chunks, runs, aligned bodies) against the plain version's
  ring.

Every state leaf and RepInfo field is compared bit for bit."""

import functools

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
from tests.test_torch_steady_mesh import _closed_form

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


# ------------------------------------------------- K4 off the main path
# The resident K4 launched directly, as the plan leaves it (the turnover
# decision and the start slot in the workspace), against the JAX turnover
# kernel (``_run_turnover``, local=False) on bookkeeping planes the main
# path does not give. One shape, so one compiled JAX program: 24-byte rows
# (not 16-byte multiples), two ring laps over three windows.
K4_C, K4_T, K4_P, K4_W = 256, 4, 3, 2


@functools.lru_cache(maxsize=None)
def _j_turnover(C, T, P, L, M):
    BR = jsp._pick_br(B, C)

    @jax.jit
    def run(lp, lt, wins, s0, params, vecs):
        st = jst.ReplicaState(*([jnp.zeros(L, jnp.int32)] * 6), lt, lp)
        return jsp._run_turnover(st, wins, s0, params, vecs, BR, C // BR,
                                 B // BR, P, T, C, M, M, L, None, True)
    return run


def _steady_plane(L, last, lterm=1):
    """Every row caught up and committed at ``last``."""
    return np.stack([np.full(L, lterm), np.full(L, -1), np.full(L, last),
                     np.full(L, last), np.full(L, last),
                     np.full(L, lterm)]).astype(np.int32)


def _mixed_plane(L, last, seed=4):
    """Rows caught up at ``last`` at mixed terms, votes, commits and match
    terms."""
    rng = np.random.default_rng(seed)
    plane = _steady_plane(L, last)
    plane[0] = rng.integers(0, 5, L)
    plane[1] = rng.integers(-1, L, L)
    plane[3] = rng.integers(0, last + 1, L)
    plane[5] = rng.integers(0, 4, L)
    return plane


def _k4_resident(plane, wins, lp, lt, T, s0, lterm, tfloor):
    """The resident K4 from start slot ``s0`` (set in the workspace with
    the turnover decision) through the port's wrapper, on copies: (plane,
    payload ring, term ring, out)."""
    L = plane.shape[1]
    vecs = torch.from_numpy(plane.copy())
    lp, lt = torch.from_numpy(lp.copy()), torch.from_numpy(lt.copy())
    out = torch.zeros(L + 5, dtype=torch.int32)
    work = tsc.workspace("cpu")
    work[tsc.WK_PLAN], work[tsc.WK_S0] = 1, s0
    ran4 = int(work[tsc.WK_RAN4])
    tsc.turnover_flight(vecs, lp, lt, torch.from_numpy(wins), T,
                        tsc.step_params(0, lterm, tfloor, 0, 0, None, L), out)
    assert int(work[tsc.WK_RAN4]) == ran4 + 1
    work[tsc.WK_PLAN] = 0
    return vecs.numpy(), lp.numpy(), lt.numpy(), out.numpy()


#: (plane, leader term, term floor) off the main path; the flight's last
#: tail is B + K4_T*B
K4_PLANES = {
    "steady": (_steady_plane(N, B), 1, 1),
    "lterm_0": (_steady_plane(N, B), 0, 1),              # no commit
    "tfloor_beyond": (_steady_plane(N, B), 1, B + K4_T * B + 1),
    "mixed_plane": (_mixed_plane(N, B), 3, 1),
}


@pytest.mark.parametrize("s0", [0, 128])
@pytest.mark.parametrize("name", sorted(K4_PLANES))
def test_k4_resident_bookkeeping_matches_pallas(name, s0):
    plane, lterm, tfloor = K4_PLANES[name]
    rng = np.random.default_rng(17)
    M = N * K4_W
    wins = rng.integers(-2**31, 2**31, (K4_P, B, M), dtype=np.int64) \
        .astype(np.int32)
    lp = rng.integers(-2**31, 2**31, (K4_C, M), dtype=np.int64) \
        .astype(np.int32)
    lt = rng.integers(0, 4, (N, K4_C)).astype(np.int32)
    params, _ = jsp._params_and_masks(
        jnp.int32(0), jnp.int32(lterm), jnp.int32(tfloor), jnp.int32(0),
        jnp.int32(0), jnp.ones(N, bool), jnp.zeros(N, bool), None, None, N)
    js, ji = _j_turnover(K4_C, K4_T, K4_P, N, M)(
        jnp.asarray(lp), jnp.asarray(lt), jnp.asarray(wins),
        jnp.asarray([s0], jnp.int32), params, jnp.asarray(plane))
    v, tlp, tlt, out = _k4_resident(plane, wins, lp, lt, K4_T, s0, lterm,
                                    tfloor)
    assert_states_equal(js, tsc.unpack(torch.from_numpy(v),
                                       torch.from_numpy(tlt),
                                       torch.from_numpy(tlp)), name)
    np.testing.assert_array_equal(out[:N], np.asarray(ji.match).reshape(-1))
    for k, f in enumerate(("commit_index", "max_term", "frontier_len")):
        assert int(out[N + k]) == int(np.asarray(getattr(ji, f)).flat[0]), f
    want_commit = plane[3] if name in ("lterm_0", "tfloor_beyond") else \
        B + K4_T * B
    np.testing.assert_array_equal(v[3], want_commit)


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5])
def test_k4_resident_closed_form_mirror_matches_step_loop(L):
    """The resident K4's bookkeeping as ``csrc/steady.cu``
    ``turnover_closed_form`` writes it (the Python mirror of
    ``tests/test_torch_steady_mesh.py``) against the plain step loop, on
    random planes, T = 0 to 4 ring laps."""
    rng = np.random.default_rng(100 + L)
    C, Bk, W = 512, 128, 2
    for _ in range(40):
        T = int(rng.integers(0, 4 * C // Bk + 1))
        last = rng.integers(0, 3 * C, L)
        last[:] = last[0]                   # the rows share one tail
        plane = np.stack([
            rng.integers(0, 5, L), rng.integers(-1, L, L), last,
            np.minimum(last, rng.integers(0, 3 * C, L)),
            rng.integers(0, 3 * C, L), rng.integers(0, 5, L),
        ]).astype(np.int32)
        lterm = int(rng.integers(0, 5))
        tfloor = int(rng.integers(0, int(last[0]) + T * Bk + 2 * Bk))
        v, _, lt, out = _k4_resident(
            plane, np.zeros((3, Bk, L * W), np.int32),
            np.zeros((C, L * W), np.int32), np.zeros((L, C), np.int32), T,
            int(rng.integers(0, C)), lterm, tfloor)
        want_v, want_out = _closed_form(plane, T, Bk, C, lterm, tfloor)
        np.testing.assert_array_equal(v, want_v)
        np.testing.assert_array_equal(out, want_out)
        np.testing.assert_array_equal(lt, lterm)


# ------------------------------------------- K4's copy, as the kernel walks it
def _k4_runs(M, C, PB, r0, d0, w0, w1):
    """Python mirror of ``csrc/steady.cu`` ``for_runs``: the runs (source
    word, destination word, length) of the flat words [w0, w1)."""
    k = w0 // M
    off = w0 - k * M
    d = d0 + k - (C if d0 + k >= C else 0)
    r = k % PB + r0
    r -= PB if r >= PB else 0
    w = w0
    while w < w1:
        ln = min(w1 - w, min(C - d, PB - r) * M - off)
        yield r * M + off, d * M + off, ln
        w += ln
        rows = (off + ln) // M
        off += ln - rows * M
        d += rows
        d -= C if d >= C else 0
        r += rows
        r -= PB if r >= PB else 0


def _k4_copy_mirror(ring, wins, T, s0, CW):
    """The resident K4's payload write as its copy blocks walk it (chunks
    of CW flat words, each cut into runs, each run into the words before
    its first 16-byte-aligned destination word, whole 16-byte vectors, and
    the rest; the bases 16-byte aligned), in place on ``ring``. Returns how
    often each ring word was written."""
    C, M = ring.shape
    P, Bw, _ = wins.shape
    TB = T * Bw
    n, PB = min(TB, C), P * Bw
    r0 = (TB - n) % PB
    d0 = (TB - n) % C + s0
    d0 -= C if d0 >= C else 0
    src, dst = wins.reshape(-1), ring.reshape(-1)
    written = np.zeros(C * M, np.int64)
    words = n * M
    for c in range(-(-words // CW)):
        for so, do, ln in _k4_runs(M, C, PB, r0, d0, c * CW,
                                   c * CW + min(CW, words - c * CW)):
            assert ln > 0
            if so % 4 == do % 4:
                head = min(ln, (4 - do % 4) % 4)
                body = (ln - head) & ~3
                assert (do + head) % 4 == 0 and (so + head) % 4 == 0
                parts = [(0, head), (head, head + body), (head + body, ln)]
            else:
                parts = [(0, ln)]
            for a, b in parts:
                dst[do + a:do + b] = src[so + a:so + b]
                written[do + a:do + b] += 1
    return written


@pytest.mark.parametrize("CW", [8192, 4096, 40, 12, 6])
def test_k4_copy_runs_match_plain(CW):
    """The kernel's run walk (its chunk of 8 192 words, and others, small
    ones among them that cut rows) writes every slot the flight reaches
    once, with the plain version's words, and no other: the start slot
    anywhere, fewer windows than steps, rows of 24, 60 and 16·k bytes,
    flights short of a lap and several laps long."""
    rng = np.random.default_rng(CW)
    shapes = [(3, 2, 256, 128), (5, 3, 288, 96), (3, 64, 1024, 128),
              (5, 22, 512, 64), (1, 1, 64, 8)]
    for L, W, C, Bk in shapes:
        M = L * W
        for _ in range(6):
            T = int(rng.integers(1, 3 * C // Bk + 2))
            P = int(rng.integers(1, T + 1))
            s0 = int(rng.choice([0, C - 1, C - Bk - 2,
                                 int(rng.integers(0, C))]))
            wins = rng.integers(-2**31, 2**31, (P, Bk, M), dtype=np.int64) \
                .astype(np.int32)
            lp = rng.integers(-2**31, 2**31, (C, M), dtype=np.int64) \
                .astype(np.int32)
            ring = lp.copy()
            written = _k4_copy_mirror(ring, wins, T, s0, CW)
            _, want, _, _ = _k4_resident(
                _steady_plane(L, Bk), wins, lp, np.zeros((L, C), np.int32),
                T, s0, 1, 1)
            np.testing.assert_array_equal(ring, want)
            reached = np.zeros(C, bool)
            reached[(s0 + np.arange(min(T * Bk, C)) + T * Bk
                     - min(T * Bk, C)) % C] = True
            np.testing.assert_array_equal(written.reshape(C, M),
                                          np.repeat(reached[:, None], M, 1))

