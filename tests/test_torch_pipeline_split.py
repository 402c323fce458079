"""K3 as its two phases: the plan (``pipeline_plan_plain``: the turnover
decision, then the scalar core and the term-ring merge step by step, and
the per-step record) and the writer (``pipeline_write_plain``: every
payload destination from the LAST step whose window covers its slot and
whose accept mask holds its row). Plan-then-write is held bit for bit
(every state leaf, ``out``, both rings) against ``pipeline_flight_plain``,
which runs the steps in order, and against the JAX package with its Pallas
kernels in interpret mode:

- ``steady_pipeline_tpu`` where interpret mode is faithful (T·B <= C, no
  slot revisited): feasible, slow row, dead row, partial counts, no
  quorum, member-shrunk, and a §5.3 conflict that truncates a stale
  suffix;
- the per-step scan across ring laps (3.5 laps of a 256-slot ring): a slow
  row, and a row that rejects the first window and accepts the rest —
  there the last-covering-step rule decides;
- the EC windows of k data lanes (RS(5,3), in-kernel parity) against the
  JAX parity-mode scan across 1.5 laps;
- the mesh-local mode (K3·mesh) of every row against
  ``_run_pipeline(local=True)``.

B = 128, C = 256-1024, R = 3 and 5."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.core import step_pallas as jsp
from raft_tpu.ec import kernels as jk
from raft_tpu_torch.core import step_cuda as tsc
from raft_tpu_torch.ec import kernels as tk
from tests._torch_port import (
    assert_infos_equal,
    assert_states_equal,
    pallas_interpret,
    to_port,
)
from tests.test_torch_steady_mesh import _j_flight, _j_params, _steady_plane

B = 128
OK3 = [False] * 3


@pytest.fixture(autouse=True)
def _interpret():
    with pallas_interpret():
        yield


def _wins(seed, P, lanes):
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, (P, B, lanes), dtype=np.int64).astype(np.int32)


def _check_record(rec, C):
    """Windows are consecutive: each step starts where the last ended."""
    pos = rec[:, tsc.REC_POS]
    assert int(pos[0]) == 0
    assert torch.equal(pos[1:], (pos + rec[:, tsc.REC_N])[:-1])
    assert torch.equal(rec[:, tsc.REC_S], (rec[0, tsc.REC_S] + pos) % C)


def _split_vs_flight(vecs, lp, lt, wins, counts, alive, slow, member, prm,
                     ec_consts=None, my_row=-1, prev=None):
    """``pipeline_flight_plain``, and plan then write, on copies of the
    operands; asserts every output equal and returns the split's
    (vecs, payload ring, term ring, out, record)."""
    L, C = vecs.shape[1], lt.shape[1]
    br = tsc.pick_br(B, C)
    work = tsc.workspace("cpu")
    runs = []
    for split in (False, True):
        v, p, t = vecs.clone(), lp.clone(), lt.clone()
        out = torch.zeros(L + 5, dtype=torch.int32)
        rec = None
        if split:
            rec = tsc.pipeline_plan_plain(v, t, counts, B, alive, slow,
                                          member, prm, br, False, out, work,
                                          my_row, prev)
            tsc.pipeline_write_plain(p, t, wins, rec, ec_consts, my_row)
        else:
            tsc.pipeline_flight_plain(v, p, t, wins, counts, alive, slow,
                                      member, prm, br, False, out, work,
                                      ec_consts, my_row, prev)
        runs.append((v, p, t, out))
    for a, b, name in zip(*runs, ("vecs", "payload", "terms", "out")):
        assert torch.equal(a, b), name
    _check_record(rec, C)
    assert rec.shape == (counts.shape[0], 4)
    return (*runs[1], rec)


# ------------------------------------------------------ resident layout
_J_PIPE = jax.jit(jsp.steady_pipeline_tpu,
                  static_argnames=("commit_quorum", "interpret",
                                   "allow_turnover"))
_J_SCAN = jax.jit(jsp.steady_scan_replicate_tpu,
                  static_argnames=("commit_quorum", "interpret",
                                   "stack_infos"))


def _resident(jstate, wins, counts, alive, slow, member=None, lterm=1,
              tfloor=1, ref="pipeline"):
    """One K3 flight from ``jstate`` through the port's split and the JAX
    reference (its pipeline entry point, or the per-step scan); the JAX
    side always gets a member mask (all rows when ``member`` is None: the
    same quorum and ack set), so every case shares one program."""
    R = np.asarray(jstate.term).shape[0]
    counts = np.asarray(counts, np.int32)
    P = wins.shape[0]
    args = (jnp.int32(0), jnp.int32(lterm), jnp.asarray(alive),
            jnp.asarray(slow), jnp.int32(0), jnp.int32(0),
            jnp.asarray(np.ones(R, bool) if member is None else member),
            jnp.int32(tfloor))
    if ref == "pipeline":
        js, ji = _J_PIPE(jstate, jnp.asarray(wins), jnp.asarray(counts),
                         *args, commit_quorum=None, interpret=True)
    else:
        xs = np.stack([wins[t % P] for t in range(len(counts))])
        js, ji = _J_SCAN(jstate, jnp.asarray(xs), jnp.asarray(counts),
                         *args, interpret=True)
        ji = jax.tree.map(lambda a: a[-1], ji)
    ts = to_port(jstate)
    prm = tsc.step_params(0, lterm, tfloor, 0, 0, None, R)
    v, lp, lt, out, rec = _split_vs_flight(
        tsc.pack(ts), ts.log_payload, ts.log_term, torch.from_numpy(wins),
        torch.from_numpy(counts), torch.tensor(alive), torch.tensor(slow),
        None if member is None else torch.tensor(member), prm)
    assert_states_equal(js, tsc.unpack(v, lt, lp), "split flight")
    assert_infos_equal(ji, tsc.mk_info(out, R), "split flight")
    return v, rec


def _stale_suffix(C):
    """Every row at 2B (term 1, committed) except row 2, which holds 5B +
    50 more entries of term 1 that the term-2 leader never wrote (past the
    end of a 5-window flight)."""
    js = jst.init_state(JConfig(n_replicas=3, entry_bytes=8, batch_size=B,
                                log_capacity=C))
    lt = np.ones((3, C), np.int32)
    last = np.array([2 * B, 2 * B, 7 * B + 50], np.int32)
    return js.replace(
        term=jnp.ones(3, jnp.int32), last_index=jnp.asarray(last),
        commit_index=jnp.full(3, 2 * B, jnp.int32),
        match_index=jnp.full(3, 2 * B, jnp.int32),
        match_term=jnp.ones(3, jnp.int32), log_term=jnp.asarray(lt))


FULL5 = [B] * 5
RESIDENT = {
    # name: (alive, slow, member, counts, leader's commit after the flight)
    "feasible": ([True] * 3, OK3, None, FULL5, 5 * B),
    "slow_row": ([True] * 3, [False, False, True], None, FULL5, 5 * B),
    "dead_row": ([True, True, False], OK3, None, FULL5, 5 * B),
    "partial_counts": ([True] * 3, OK3, None, [B, B, 77, B, 0], 3 * B + 77),
    "no_quorum": ([True] * 3, [False, True, True], None, FULL5, 0),
    "member_shrunk": ([True] * 3, OK3, [True, False, False], FULL5, 5 * B),
}


@pytest.mark.parametrize("name", sorted(RESIDENT))
def test_split_matches_pallas_pipeline(name):
    alive, slow, member, counts, commit = RESIDENT[name]
    js = jst.init_state(JConfig(n_replicas=3, entry_bytes=8, batch_size=B,
                                log_capacity=1024))
    v, rec = _resident(js, _wins(10, 5, 6), counts, alive, slow, member)
    assert int(v[3, 0]) == commit
    assert rec[:, tsc.REC_N].tolist() == [min(c, B) for c in counts]


def test_split_conflict_truncates_like_pallas():
    """The term-2 leader's first window overlaps row 2's stale suffix: the
    plan's §5.3 compare reads those old terms and cuts row 2's tail to the
    window (without the cut it would end 50 entries past the flight)."""
    v, rec = _resident(_stale_suffix(1024), _wins(11, 5, 6), FULL5,
                       [True] * 3, OK3, lterm=2, tfloor=2 * B + 1)
    assert v[2].tolist() == [2 * B + 5 * B] * 3
    assert (rec[:, tsc.REC_ACC] == 0b111).all()


def _late_accept(C):
    """Row 2 holds the leader's whole log and 600 entries more of the same
    term, but a stale term at the first window's prev slot: it rejects
    the first window and accepts every later one."""
    js = _stale_suffix(C)
    lt = np.ones((3, C), np.int32)
    lt[2, (2 * B - 1) % C] = 0
    return js.replace(last_index=js.last_index.at[2].set(2 * B + 600),
                      log_term=jnp.asarray(lt))


@pytest.mark.parametrize("name", ["slow_row", "late_accept"])
def test_split_across_laps_matches_scan(name):
    """3.5 laps of a 256-slot ring in one flight: a slot's last covering
    step decides what each row's lanes hold."""
    C = 256
    if name == "slow_row":
        js = jst.init_state(JConfig(n_replicas=3, entry_bytes=8,
                                    batch_size=B, log_capacity=C))
        v, rec = _resident(js, _wins(12, 7, 6), [B] * 7, [True] * 3,
                           [False, False, True], ref="scan")
        assert int(v[2, 2]) == 0 and (rec[:, tsc.REC_ACC] == 0b011).all()
    else:
        v, rec = _resident(_late_accept(C), _wins(13, 7, 6), [B] * 7,
                           [True] * 3, OK3, ref="scan")
        assert rec[:, tsc.REC_ACC].tolist() == [0b011] + [0b111] * 6


# ----------------------------------------------------------- parity mode
N5, K3, E24 = 5, 3, 24
EC_CFG = JConfig(n_replicas=N5, entry_bytes=E24, batch_size=B,
                 log_capacity=512, rs_k=K3, rs_m=N5 - K3)
Q = EC_CFG.commit_quorum
_J_EC_SCAN = jax.jit(partial(jsp.steady_scan_replicate_tpu, commit_quorum=Q,
                             interpret=True,
                             ec_consts=jk.parity_consts(N5, K3)))


@pytest.mark.parametrize("alive,slow", [
    ([True] * 5, [False] * 5),
    ([True] * 4 + [False], [False] * 5),
    ([True] * 5, [False, False, False, True, False]),
], ids=["all_accept", "dead_row", "slow_row"])
def test_split_ec_data_lanes_match_scan(alive, slow):
    """Windows of the k data-lane blocks: the writer encodes the parity
    shards of each destination from its source window row."""
    T, P = 6, 4
    wins = np.random.default_rng(14).integers(
        0, 256, (P, B, E24), dtype=np.uint8).view(np.int32)
    counts = np.full(T, B, np.int32)
    js0 = jst.init_state(EC_CFG)
    xs = np.stack([wins[t % P] for t in range(T)])
    js, ji = _J_EC_SCAN(js0, jnp.asarray(xs), jnp.asarray(counts),
                        jnp.int32(0), jnp.int32(1), jnp.asarray(alive),
                        jnp.asarray(slow), jnp.int32(0), jnp.int32(0), None,
                        jnp.int32(1))
    ts = to_port(js0)
    prm = tsc.step_params(0, 1, 1, 0, 0, Q, N5, ec=True)
    v, lp, lt, out, rec = _split_vs_flight(
        tsc.pack(ts), ts.log_payload, ts.log_term, torch.from_numpy(wins),
        torch.from_numpy(counts), torch.tensor(alive), torch.tensor(slow),
        None, prm, ec_consts=tk.parity_consts(N5, K3))
    assert_states_equal(js, tsc.unpack(v, lt, lp), "ec split")
    assert_infos_equal(jax.tree.map(lambda a: a[-1], ji),
                       tsc.mk_info(out, N5), "ec split")
    assert int(out[N5]) == T * B


# ------------------------------------------------------------ mesh-local
@pytest.mark.parametrize("alive,slow", [
    ([True] * 3, OK3), ([True] * 3, [False, False, True]),
    ([True, True, False], OK3),
], ids=["all_accept", "slow_row", "dead_row"])
def test_split_mesh_local_matches_pallas_local(alive, slow):
    """Every row's K3·mesh split (its own ring, the gathered plane and prev
    column) against the JAX local=True pipeline."""
    R, C, T, P, W = 3, 1024, 5, 3, 2
    rng = np.random.default_rng(15)
    vecs0 = _steady_plane(R, 0)
    prev = np.zeros(R, np.int32)
    wins = rng.integers(-2**31, 2**31, (P, B, W), dtype=np.int64) \
        .astype(np.int32)
    counts = np.full(T, B, np.int32)
    lp0 = rng.integers(-2**31, 2**31, (C, W), dtype=np.int64) \
        .astype(np.int32)
    lt0 = np.zeros((1, C), np.int32)
    run = _j_flight(C, T, P, R, False)
    for r in range(R):
        params, masks = _j_params(r, 0, 1, 1, 0, 0, alive, slow, None, None,
                                  R, False)
        (jlp, jlt, jv), ji = run(
            jnp.asarray(lp0), jnp.asarray(lt0), jnp.asarray(wins),
            jnp.asarray(counts)[None], jnp.asarray([0], jnp.int32),
            jnp.asarray(prev)[:, None], params, jnp.asarray(vecs0), masks)
        v, lp, lt, out, rec = _split_vs_flight(
            torch.from_numpy(vecs0.copy()), torch.from_numpy(lp0.copy()),
            torch.from_numpy(lt0.copy()), torch.from_numpy(wins),
            torch.from_numpy(counts), torch.tensor(alive),
            torch.tensor(slow), None, tsc.step_params(0, 1, 1, 0, 0, None,
                                                      R),
            my_row=r, prev=torch.from_numpy(prev.copy()))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), "vecs")
        np.testing.assert_array_equal(lp.numpy(), np.asarray(jlp), "payload")
        np.testing.assert_array_equal(lt.numpy(), np.asarray(jlt), "terms")
        np.testing.assert_array_equal(out[:R].numpy(), np.asarray(ji.match))
        assert int(out[R]) == int(ji.commit_index) == T * B


# ------------------------------------------------------------- the plan
def test_plan_publishes_the_turnover_decision():
    """A saturated all-accept flight that turns the ring over: the plan
    publishes the branch and start slot as ``pipeline_flight_plain`` does,
    returns no record and changes nothing; the writer then does nothing."""
    cfg = JConfig(n_replicas=3, entry_bytes=8, batch_size=B, log_capacity=256)
    ts = to_port(jst.init_state(cfg))
    vecs = tsc.pack(ts)
    before = (vecs.clone(), ts.log_term.clone(), ts.log_payload.clone())
    work = tsc.workspace("cpu")
    work[tsc.WK_PLAN] = 0
    prm = tsc.step_params(0, 1, 1, 0, 0, None, 3)
    ones = torch.ones(3, dtype=torch.bool)
    rec = tsc.pipeline_plan_plain(
        vecs, ts.log_term, torch.full((2,), B, dtype=torch.int32), B, ones,
        ~ones, None, prm, tsc.pick_br(B, 256), True,
        torch.zeros(8, dtype=torch.int32), work)
    assert rec is None
    assert int(work[tsc.WK_PLAN]) == 1 and int(work[tsc.WK_S0]) == 0
    tsc.pipeline_write_plain(ts.log_payload, ts.log_term,
                             torch.ones(2, B, 6, dtype=torch.int32), rec)
    for a, b in zip((vecs, ts.log_term, ts.log_payload), before):
        assert torch.equal(a, b)


def test_mesh_flight_refuses_a_device_turnover_decision():
    vecs = torch.from_numpy(_steady_plane(3, 0))
    ones = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="on the host"):
        tsc.pipeline_flight(
            vecs, torch.zeros(256, 2, dtype=torch.int32),
            torch.zeros(1, 256, dtype=torch.int32),
            torch.zeros(2, B, 2, dtype=torch.int32),
            torch.full((2,), B, dtype=torch.int32), ones, ~ones, None,
            tsc.step_params(0, 1, 1, 0, 0, None, 3), 128, True,
            torch.zeros(8, dtype=torch.int32), my_row=0,
            prev=torch.zeros(3, dtype=torch.int32))
