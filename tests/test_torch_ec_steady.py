"""K2-K4 in their in-kernel RS parity mode (raft_tpu_torch.core.step_cuda
with ``ec_consts``) against the JAX package, RS(5,3) with 24-byte entries
(k = 3 data-lane blocks of W = 2 words, M = 10 lanes), B = 128, C = 512:

- K2 (the steady scan) against ``steady_scan_replicate_tpu(...,
  ec_consts=...)`` in interpret mode on scripted schedules — seam, partial
  and zero counts, slow row, dead row (commit at 4 of 5), two dead rows
  (no commit), a §5.3 conflict — and against the JAX general
  ``replicate_step`` fed ``encode_fold_device`` windows;
- K3 and K4 on flights across ring laps against the JAX per-step scan
  (interpret mode cannot model the pipeline kernel's in-call revisits):
  the all-accept turnover flight (K4), and a dead row, a slow row and two
  dead rows (K3).

Every state leaf and RepInfo field is compared bit for bit."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.core import step as jstep
from raft_tpu.core import step_pallas as jsp
from raft_tpu.core.comm import SingleDeviceComm as JComm
from raft_tpu.ec import kernels as jk
from raft_tpu.ec.rs import RSCode as JCode
from raft_tpu_torch.core import step_cuda as tsc
from raft_tpu_torch.ec import kernels as tk
from tests._torch_port import assert_infos_equal, assert_states_equal, to_port

N, K, B, C, E = 5, 3, 128, 512, 24
KW = dict(n_replicas=N, entry_bytes=E, batch_size=B, log_capacity=C,
          rs_k=K, rs_m=N - K)
CFG = JConfig(**KW)
Q = CFG.commit_quorum
CONSTS = tk.parity_consts(N, K)
ALL = [True] * N

_J_SCAN = jax.jit(partial(jsp.steady_scan_replicate_tpu, commit_quorum=Q,
                          interpret=True, ec_consts=jk.parity_consts(N, K)))


def _raw(seed, T):
    return np.random.default_rng(seed).integers(0, 256, (T, B, E),
                                                dtype=np.uint8)


def _lanes(raw):
    return np.ascontiguousarray(raw).view(np.int32)          # [T, B, Mk]


def _args(alive, slow, leader=0, term=1, tfloor=1):
    return ((jnp.int32(leader), jnp.int32(term), jnp.asarray(alive),
             jnp.asarray(slow), jnp.int32(0), jnp.int32(0), None,
             jnp.int32(tfloor)),
            (leader, term, torch.tensor(alive), torch.tensor(slow), 0, 0,
             None, tfloor))


def _scan_both(jstate, wins, counts, alive, slow, **kw):
    ja, ta = _args(alive, slow, **kw)
    js, ji = _J_SCAN(jstate, jnp.asarray(wins), jnp.asarray(counts), *ja)
    ts, ti = tsc.steady_scan_replicate(
        to_port(jstate), torch.from_numpy(wins), torch.from_numpy(counts),
        *ta, commit_quorum=Q, ec_consts=CONSTS)
    assert_infos_equal(ji, ti, "ec scan")
    assert_states_equal(js, ts, "ec scan")
    return js, ts, ti


FULL, PART = [B] * 6, [B, 100, 0, B, B, B]
SCRIPTED = {
    # name: (counts, alive, slow, commit after the scan); 612 entries
    # wrap the 512-slot ring
    "partial_and_seam": (PART, ALL, [False] * N, 612),
    "slow_row": (FULL, ALL, [False, False, False, False, True], 6 * B),
    "dead_row": (PART, [True] * 4 + [False], [False] * N, 612),
    "two_dead_rows": (FULL, [True] * 3 + [False] * 2, [False] * N, 0),
}


@pytest.mark.parametrize("name", sorted(SCRIPTED))
def test_k2_ec_scan_matches_pallas_scan(name):
    counts, alive, slow, commit = SCRIPTED[name]
    counts = np.asarray(counts, np.int32)
    _, ts, ti = _scan_both(jst.init_state(CFG), _lanes(_raw(1, 6)), counts,
                           alive, slow)
    assert int(ti.commit_index[-1]) == commit
    # with nothing committed the leader's ring backpressure stops at C
    assert int(ts.last_index[0]) == min(int(counts.sum()), commit + C)


def test_k2_ec_conflict_truncates_like_pallas():
    """A row holding a stale suffix of an older term: the term-2 leader's
    window overwrites it (§5.3) and the row's tail is cut to the window."""
    js, _, _ = _scan_both(jst.init_state(CFG), _lanes(_raw(2, 6)),
                          np.array(FULL, np.int32), ALL, [False] * N)
    last = 6 * B
    lt = np.array(js.log_term)
    lt[2, (last - 300) % C:(last - 300) % C + 150] = 0
    js = js.replace(last_index=js.last_index.at[2].set(last + 90),
                    log_term=jnp.asarray(lt))
    js2, ts, ti = _scan_both(js, _lanes(_raw(3, 6)), np.array(
        [B, 0, 7, B, 0, 0], np.int32), ALL, [False] * N, term=2,
        tfloor=last + 1)
    assert int(ts.last_index[2]) == last + 2 * B + 7
    assert int(ti.commit_index[-1]) == last + 2 * B + 7


def test_k2_ec_matches_general_fed_k7_windows():
    """In-kernel parity (data-lane windows) equals the JAX general step fed
    pre-encoded full-lane windows, as
    ``test_ec_inline_parity_encode_matches_general`` pins inside JAX."""
    raw = _raw(4, 5)
    counts = np.array([B, 100, 0, B, B], np.int32)
    code = JCode(N, K)
    rep = jax.jit(partial(jstep.replicate_step, JComm(N), ec=True,
                          commit_quorum=Q, repair=True))
    js = jst.init_state(CFG)
    infos = []
    for t in range(5):
        js, info = rep(js, jk.encode_fold_device(code, jnp.asarray(raw[t])),
                       jnp.int32(counts[t]), jnp.int32(0), jnp.int32(1),
                       jnp.ones(N, bool), jnp.zeros(N, bool))
        infos.append(info)
    ts, ti = tsc.steady_scan_replicate(
        to_port(jst.init_state(CFG)), torch.from_numpy(_lanes(raw)),
        torch.from_numpy(counts), 0, 1, torch.ones(N, dtype=torch.bool),
        torch.zeros(N, dtype=torch.bool), 0, 0, None, 1, commit_quorum=Q,
        ec_consts=CONSTS)
    assert_states_equal(js, ts, "general vs ec scan")
    for t, info in enumerate(infos):
        assert_infos_equal(info, jax.tree.map(lambda a: a[t], ti),
                           f"step {t}")
    assert int(ti.commit_index[-1]) == 3 * B + 100


def _flight(T, P, alive, slow, seed):
    """One ec flight through the port and the JAX per-step scan fed the
    same windows; returns the final info and the kernel that wrote it."""
    wins = _lanes(_raw(seed, P))
    counts = np.full(T, B, np.int32)
    ja, ta = _args(alive, slow)
    xs = np.stack([wins[t % P] for t in range(T)])
    js, ji = _J_SCAN(jst.init_state(CFG), jnp.asarray(xs),
                     jnp.asarray(counts), *ja)
    ji = jax.tree.map(lambda a: a[-1], ji)
    work = tsc.workspace("cpu")
    n3, n4 = int(work[tsc.WK_RAN3]), int(work[tsc.WK_RAN4])
    ts, ti = tsc.steady_pipeline(
        to_port(jst.init_state(CFG)), torch.from_numpy(wins),
        torch.from_numpy(counts), *ta, commit_quorum=Q, ec_consts=CONSTS)
    assert_states_equal(js, ts, "ec flight")
    assert_infos_equal(ji, ti, "ec flight")
    ran3 = int(work[tsc.WK_RAN3]) - n3
    ran4 = int(work[tsc.WK_RAN4]) - n4
    return ti, ("K4" if ran4 else "K3" if ran3 else "none")


LAPS = {
    # 6 x 128 entries over a 512-slot ring: 1.5 laps in one flight (the
    # scan's shape is the scripted cases', so one JAX program serves all)
    "turnover": (ALL, [False] * N, "K4", 6 * B),
    "dead_row": ([True] * 4 + [False], [False] * N, "K3", 6 * B),
    "slow_row": (ALL, [False] * 3 + [True, False], "K3", 6 * B),
    "two_dead_rows": ([True] * 3 + [False] * 2, [False] * N, "K3", 0),
}


@pytest.mark.parametrize("name", sorted(LAPS))
def test_k3_k4_ec_across_laps_match_scan(name):
    alive, slow, kernel, commit = LAPS[name]
    ti, which = _flight(6, 4, alive, slow, 30)
    assert which == kernel and int(ti.commit_index) == commit


def test_window_lanes_need_matching_consts():
    st = to_port(jst.init_state(CFG))
    _, ta = _args(ALL, [False] * N)
    lanes = torch.zeros(1, B, K * 2, dtype=torch.int32)
    full = torch.zeros(1, B, N * 2, dtype=torch.int32)
    cnt = torch.full((1,), B, dtype=torch.int32)
    with pytest.raises(ValueError, match="require ec_consts"):
        tsc.steady_scan_replicate(st.clone(), lanes, cnt, *ta,
                                  commit_quorum=Q)
    with pytest.raises(ValueError, match="require ec_consts"):
        tsc.steady_pipeline(st.clone(), full, cnt, *ta, commit_quorum=Q,
                            ec_consts=CONSTS)
    with pytest.raises(ValueError, match="do not fit"):
        tsc.steady_scan_replicate(st.clone(), lanes, cnt, *ta,
                                  commit_quorum=Q,
                                  ec_consts=tk.parity_consts(6, 3))


def test_ec_wrappers_take_plain_version_on_cpu():
    counts = dict(tsc.LAUNCHES)
    _flight(6, 4, ALL, [False] * N, 20)
    assert tsc.LAUNCHES == counts
