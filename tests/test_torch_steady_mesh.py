"""The mesh-local mode of kernels K2-K4 (K2·mesh, K3·mesh, K4·mesh): their
plain versions in raft_tpu_torch.core.step_cuda against the JAX package's
kernels with ``local=True`` (``step_pallas._invoke``, ``_run_pipeline``,
``_run_turnover``) in interpret mode, for every row of the plane.

- K2·mesh on random gathered planes, prev columns, rings and windows (any
  input: the two compute the same closed forms), R = 3 and R = 5 with the
  EC quorum, C = 512 and 1024, and a chained scan whose prev column is the
  previous step's closed form;
- K3·mesh in the no-revisit regime (T·B <= C, where interpret mode models
  the aliased pipeline faithfully) from a fully committed plane: all
  accept, a slow row, a dead row, a shrunk membership, no quorum, and a
  row whose prev term disagrees;
- K4·mesh across ring laps (write-only, interpret-faithful), launched
  with the start slot of the host's turnover decision (``core.step_mesh``
  decides the branch; K3·mesh never does), and its bookkeeping on planes
  the main path does not give: a leader term of 0, a term floor beyond
  the flight's last tail, rows at mixed terms, votes and commits;
- a Python mirror of K4·mesh's closed-form bookkeeping (all T steps at
  once, ``csrc/steady.cu`` ``turnover_closed_form``) against the plain
  step loop on random planes.

B = 128, 8-byte entries (W = 2 words). Every vec word, ring word,
match/scal word and next-prev word must be equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import state as jst
from raft_tpu.core import step_pallas as jsp
from raft_tpu_torch.core import step_cuda as tsc

B, W = 128, 2


def _jk2():
    @jax.jit
    def run(s, cnt, prev, params, vecs, masks, win, lp, lt):
        return jsp._invoke(s, cnt, prev, params, vecs, masks, win, lp, lt,
                           True, local=True)
    return run


_J_K2 = _jk2()


@functools.lru_cache(maxsize=None)
def _j_flight(C, T, P, R, turnover):
    BR = jsp._pick_br(B, C)
    G, CB, WB = B // BR + 1, C // BR, B // BR

    @jax.jit
    def run(lp, lt, wins, cnts, s0, prev0, params, vecs, masks):
        st = jst.ReplicaState(*([jnp.zeros(1, jnp.int32)] * 6), lt, lp)
        if turnover:
            return jsp._run_turnover(st, wins, s0, params, vecs, BR, CB, WB,
                                     P, T, C, W, W, R, None, True,
                                     local=True)
        return jsp._run_pipeline(st, wins, cnts, s0, prev0, params, vecs,
                                 masks, BR, G, CB, WB, P, T, C, W, W, R,
                                 None, True, local=True)
    return run


def _j_params(r, leader, lterm, tfloor, rfloor, fpt, alive, slow, member,
              quorum, R, ec):
    return jsp._params_and_masks(
        jnp.int32(leader), jnp.int32(lterm), jnp.int32(tfloor),
        jnp.int32(rfloor), jnp.int32(fpt), jnp.asarray(alive),
        jnp.asarray(slow), None if member is None else jnp.asarray(member),
        quorum, R, ec=ec, my=r)


def _port_args(leader, lterm, tfloor, rfloor, fpt, alive, slow, member,
               quorum, R, ec):
    prm = tsc.step_params(leader, lterm, tfloor, rfloor, fpt, quorum, R,
                          ec=ec)
    return (prm, torch.from_numpy(np.asarray(alive)),
            torch.from_numpy(np.asarray(slow)),
            None if member is None else torch.from_numpy(np.asarray(member)))


def _rand_case(rng, R, C):
    lterm = int(rng.integers(0, 4))
    last = rng.integers(0, 3 * C, R).astype(np.int32)
    commit = np.maximum(last - rng.integers(0, C + 8, R), 0).astype(np.int32)
    vecs = np.stack([
        rng.integers(0, 5, R), rng.integers(-1, R, R), last, commit,
        np.minimum(last, rng.integers(0, 3 * C, R)), rng.integers(0, 5, R),
    ]).astype(np.int32)
    member = rng.random(R) < 0.8 if rng.random() < 0.3 else None
    return dict(
        vecs=vecs, leader=int(rng.integers(0, R)), lterm=lterm,
        tfloor=int(rng.integers(0, 2 * C)), rfloor=int(rng.integers(0, 3)),
        fpt=int(rng.integers(0, 3)), alive=rng.random(R) < 0.85,
        slow=rng.random(R) < 0.2, member=member,
        prev=rng.integers(-1, 5, R).astype(np.int32),
        lp=rng.integers(-2**31, 2**31, (C, W), dtype=np.int64)
        .astype(np.int32),
        lt=rng.integers(0, 5, (1, C)).astype(np.int32),
        win=rng.integers(-2**31, 2**31, (B, W), dtype=np.int64)
        .astype(np.int32),
        count=int(rng.integers(-2, B + 4)))


def _k2_both(case, r, R, C, quorum=None, ec=False):
    """One K2·mesh step of row ``r`` through JAX and the port's plain
    version; asserts every output equal and returns the port's outputs."""
    c = case
    scal = (c["leader"], c["lterm"], c["tfloor"], c["rfloor"], c["fpt"],
            c["alive"], c["slow"], c["member"], quorum, R, ec)
    params, masks = _j_params(r, *scal)
    s = np.int32((int(c["vecs"][2, c["leader"]])) % C)
    jlp, jlt, jv, jm, js, jn = _J_K2(
        jnp.asarray([s]), jnp.int32(c["count"]).reshape(1, 1),
        jnp.asarray(c["prev"])[:, None], params, jnp.asarray(c["vecs"]),
        masks, jnp.asarray(c["win"]), jnp.asarray(c["lp"]),
        jnp.asarray(c["lt"]))
    prm, alive, slow, member = _port_args(*scal)
    vecs = torch.from_numpy(c["vecs"].copy())
    lp = torch.from_numpy(c["lp"].copy())
    lt = torch.from_numpy(c["lt"].copy())
    out = torch.zeros(2 * R + 5, dtype=torch.int32)
    tsc.steady_step(vecs, lp, lt, torch.from_numpy(c["win"]), c["count"],
                    alive, slow, member, prm, out, my_row=r,
                    prev=torch.from_numpy(c["prev"].copy()))
    np.testing.assert_array_equal(vecs.numpy(), np.asarray(jv), "vecs")
    np.testing.assert_array_equal(lp.numpy(), np.asarray(jlp), "payload")
    np.testing.assert_array_equal(lt.numpy(), np.asarray(jlt), "terms")
    np.testing.assert_array_equal(out[:R].numpy(), np.asarray(jm)[0], "match")
    np.testing.assert_array_equal(out[R:R + 4].numpy(), np.asarray(js)[0],
                                  "scal")
    np.testing.assert_array_equal(out[R + 5:].numpy(), np.asarray(jn)[:, 0],
                                  "next prev")
    return vecs.numpy(), lp.numpy(), lt.numpy(), out.numpy()


@pytest.mark.parametrize("C", [512, 1024])
@pytest.mark.parametrize("R,quorum,ec", [(3, None, False), (5, 4, True)])
def test_k2_mesh_random_matches_pallas_local(R, quorum, ec, C):
    rng = np.random.default_rng(1000 * R + C)
    for _ in range(6):
        case = _rand_case(rng, R, C)
        for r in range(R):
            _k2_both(case, r, R, C, quorum, ec)


def test_k2_mesh_scan_chains_the_closed_form_prev():
    """Four chained steps per row: each takes the previous step's
    closed-form prev column and the JAX kernel's outputs as its state."""
    R, C = 3, 512
    rng = np.random.default_rng(7)
    for r in range(R):
        case = _rand_case(rng, R, C)
        case.update(lterm=2, leader=0, alive=np.ones(R, bool),
                    slow=np.array([False, False, r == 2]), member=None)
        for count in (B, 100, 0, B):
            case["count"] = count
            vecs, lp, lt, out = _k2_both(case, r, R, C)
            case.update(vecs=vecs, lp=lp, lt=lt, prev=out[R + 5:].copy(),
                        win=rng.integers(-2**31, 2**31, (B, W),
                                         dtype=np.int64).astype(np.int32))


def _steady_plane(R, last, lterm=1):
    """A fully committed plane: every row caught up at ``last``."""
    return np.stack([np.full(R, lterm), np.full(R, -1), np.full(R, last),
                     np.full(R, last), np.full(R, last),
                     np.full(R, lterm)]).astype(np.int32)


def _flight_both(C, T, P, R, slow, alive=None, member=None, prev=None,
                 turnover=False, last=0, seed=3, lterm=1, tfloor=1,
                 plane=None):
    """One flight of every row through the JAX local kernel (pipeline or
    turnover) and the port's K3·mesh (+ K4·mesh) plain version, from
    ``plane`` (default: every row caught up at ``last``)."""
    rng = np.random.default_rng(seed)
    alive = np.ones(R, bool) if alive is None else np.asarray(alive)
    slow = np.asarray(slow)
    vecs0 = _steady_plane(R, last) if plane is None else plane
    prev = np.full(R, 1 if last else 0, np.int32) if prev is None else prev
    wins = rng.integers(-2**31, 2**31, (P, B, W), dtype=np.int64) \
        .astype(np.int32)
    counts = np.full(T, B, np.int32)
    lp0 = rng.integers(-2**31, 2**31, (C, W), dtype=np.int64).astype(np.int32)
    lt0 = np.full((1, C), 1 if last else 0, np.int32)
    s0 = last % C
    run = _j_flight(C, T, P, R, turnover)
    chosen = []
    for r in range(R):
        scal = (0, lterm, tfloor, 0, 0, alive, slow, member, None, R, False)
        params, masks = _j_params(r, *scal)
        (jlp, jlt, jv), ji = run(
            jnp.asarray(lp0), jnp.asarray(lt0), jnp.asarray(wins),
            jnp.asarray(counts)[None], jnp.asarray([s0], jnp.int32),
            jnp.asarray(prev)[:, None], params, jnp.asarray(vecs0), masks)
        prm, talive, tslow, tmember = _port_args(*scal)
        vecs = torch.from_numpy(vecs0.copy())
        lp = torch.from_numpy(lp0.copy())
        lt = torch.from_numpy(lt0.copy())
        out = torch.zeros(R + 5, dtype=torch.int32)
        work = tsc.workspace("cpu")
        ran3, ran4 = int(work[tsc.WK_RAN3]), int(work[tsc.WK_RAN4])
        twins = torch.from_numpy(wins)
        if turnover:        # decided on the host, as core.step_mesh does
            tsc.turnover_flight(vecs, lp, lt, twins, T, prm, out, my_row=r,
                                s0=s0)
        else:
            tsc.pipeline_flight(vecs, lp, lt, twins, torch.from_numpy(counts),
                                talive, tslow, tmember, prm,
                                tsc.pick_br(B, C), False, out, my_row=r,
                                prev=torch.from_numpy(prev.copy()))
        chosen.append("K4" if int(work[tsc.WK_RAN4]) > ran4 else
                      "K3" if int(work[tsc.WK_RAN3]) > ran3 else "none")
        np.testing.assert_array_equal(vecs.numpy(), np.asarray(jv), "vecs")
        np.testing.assert_array_equal(lp.numpy(), np.asarray(jlp), "payload")
        np.testing.assert_array_equal(lt.numpy(), np.asarray(jlt), "terms")
        np.testing.assert_array_equal(out[:R].numpy(), np.asarray(ji.match),
                                      "match")
        for k, f in enumerate(("commit_index", "max_term", "frontier_len")):
            assert int(out[R + k]) == int(getattr(ji, f)), f
    assert set(chosen) == {"K4" if turnover else "K3"}, chosen
    return vecs.numpy()


FLIGHTS = {
    "all_accept": dict(slow=[False] * 3),
    "slow_row": dict(slow=[False, False, True]),
    "dead_row": dict(slow=[False] * 3, alive=[True, True, False]),
    "member_shrunk": dict(slow=[False] * 3, member=[True, False, False]),
    "no_quorum": dict(slow=[False, True, True]),
    "stale_prev": dict(slow=[False] * 3, prev=np.array([1, -1, 1], np.int32),
                       last=B),
}


@pytest.mark.parametrize("name", sorted(FLIGHTS))
def test_k3_mesh_matches_pallas_local(name):
    kw = FLIGHTS[name]
    vecs = _flight_both(1024, 5, 3, 3, **kw)
    lead_last = int(vecs[2, 0])
    assert lead_last == kw.get("last", 0) + 5 * B


@pytest.mark.parametrize("T,P", [(7, 3), (8, 8)])
def test_k4_mesh_turnover_across_laps_matches_pallas_local(T, P):
    vecs = _flight_both(512, T, P, 3, [False] * 3, turnover=True, last=B)
    assert (vecs[3] == B + T * B).all()


def _mixed_plane(R, last, seed=4):
    """Rows caught up at ``last`` but at mixed terms, votes, commits and
    match terms."""
    rng = np.random.default_rng(seed)
    plane = _steady_plane(R, last)
    plane[0] = rng.integers(0, 5, R)
    plane[1] = rng.integers(-1, R, R)
    plane[3] = rng.integers(0, last + 1, R)
    plane[5] = rng.integers(0, 4, R)
    return plane


#: K4·mesh's bookkeeping off the main path (C = 512, T = 4 flights of B
#: from a tail of B: the last tail is 5·B)
BOOKKEEPING = {
    "lterm_0": dict(lterm=0),                     # no commit
    "tfloor_beyond": dict(tfloor=5 * B + 1),      # no commit
    "mixed_plane": dict(lterm=3, plane=_mixed_plane(3, B)),
}


@pytest.mark.parametrize("name", sorted(BOOKKEEPING))
def test_k4_mesh_bookkeeping_matches_pallas_local(name):
    kw = BOOKKEEPING[name]
    vecs = _flight_both(512, 4, 4, 3, [False] * 3, turnover=True, last=B,
                        **kw)
    start = kw.get("plane", _steady_plane(3, B))
    # only the mixed plane's flight may commit (a leader term, no floor)
    want_commit = 5 * B if name == "mixed_plane" else start[3]
    np.testing.assert_array_equal(vecs[3], want_commit)
    np.testing.assert_array_equal(vecs[5], kw.get("lterm", 1))


def _closed_form(v, T, B, C, lterm, tfloor):
    """Python mirror of K4·mesh's bookkeeping (``turnover_closed_form``):
    the new (6, R) plane and out = match[R] | scal[5]."""
    v = v.copy()
    we = int(v[2, 0]) + T * B if T > 0 else 0
    if T > 0:
        v[1] = np.where(lterm > v[0], -1, v[1])
        v[0] = np.maximum(v[0], lterm)
        v[2] = v[4] = we
        v[5] = lterm
        if lterm >= 1 and we >= 1 and we >= tfloor:
            v[3] = we
    return v, [*v[4], v[3, 0], max(v[0, 0], lterm), B, we % C, 0]


def test_k4_mesh_closed_form_mirror_matches_step_loop():
    rng = np.random.default_rng(11)
    C = 512
    for _ in range(150):
        R, T = int(rng.integers(1, 6)), int(rng.integers(0, 10))
        last = rng.integers(0, 3 * C, R)
        plane = np.stack([
            rng.integers(0, 5, R), rng.integers(-1, R, R), last,
            np.minimum(last, rng.integers(0, 3 * C, R)),
            rng.integers(0, 3 * C, R), rng.integers(0, 5, R),
        ]).astype(np.int32)
        lterm = int(rng.integers(0, 5))
        tfloor = int(rng.integers(0, int(last[0]) + T * B + 2 * B))
        prm = tsc.step_params(0, lterm, tfloor, 0, 0, None, R)
        vecs = torch.from_numpy(plane.copy())
        out = torch.zeros(R + 5, dtype=torch.int32)
        tsc.turnover_flight_plain(
            vecs, torch.zeros(C, W, dtype=torch.int32),
            torch.zeros(1, C, dtype=torch.int32),
            torch.zeros(2, B, W, dtype=torch.int32), T, prm, out,
            tsc.workspace("cpu"), None, int(rng.integers(0, C)))
        want_v, want_out = _closed_form(plane, T, B, C, lterm, tfloor)
        np.testing.assert_array_equal(vecs.numpy(), want_v)
        np.testing.assert_array_equal(out.numpy(), want_out)


def test_mesh_mode_checks_its_operands():
    vecs = torch.zeros(6, 3, dtype=torch.int32)
    lp = torch.zeros(512, W, dtype=torch.int32)
    lt = torch.zeros(1, 512, dtype=torch.int32)
    prm = tsc.step_params(0, 1, 1, 0, 0, None, 3)
    ones = torch.ones(3, dtype=torch.bool)
    out = torch.zeros(11, dtype=torch.int32)
    win = torch.zeros(B, W, dtype=torch.int32)
    with pytest.raises(ValueError, match="prev-term column"):
        tsc.steady_step(vecs, lp, lt, win, B, ones, ~ones, None, prm, out,
                        my_row=1)
    with pytest.raises(ValueError, match="mesh-local mode"):
        tsc.steady_step(vecs, lp, torch.zeros(3, 512, dtype=torch.int32),
                        win, B, ones, ~ones, None, prm, out, my_row=1,
                        prev=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="parts selects"):
        tsc.turnover_flight(vecs, lp, lt, win[None], 4, prm, out[:8],
                            my_row=1, s0=0, parts=tsc.TURNOVER_PAYLOAD)
    counts = dict(tsc.LAUNCHES)
    tsc.steady_step(vecs, lp, lt, win, B, ones, ~ones, None, prm, out,
                    my_row=1, prev=torch.zeros(3, dtype=torch.int32))
    assert tsc.LAUNCHES == counts     # the plain version launches nothing


@pytest.mark.parametrize("name,mask", [
    ("alive", torch.tensor([1, 0, 0])),                  # int64 bytes
    ("slow", torch.zeros(6, dtype=torch.bool)[::2]),     # not contiguous
    ("member", torch.ones(4, dtype=torch.bool)),         # wrong length
])
def test_kernel_masks_are_bool_bytes(name, mask):
    """The kernels read alive, slow and member as L bytes: the wrappers
    refuse any other mask before they launch."""
    vecs = torch.zeros(6, 3, dtype=torch.int32)
    masks = dict(alive=torch.ones(3, dtype=torch.bool),
                 slow=torch.zeros(3, dtype=torch.bool), member=None)
    tsc._check_masks(vecs, **masks)
    masks[name] = mask
    with pytest.raises(ValueError, match=f"{name} must be a contiguous "
                                         r"bool\[3\]"):
        tsc._check_masks(vecs, **masks)


class _GatherFromWhole:
    """``MeshComm`` for one rank of a mesh whose rows are the rows of a
    resident plane: the two launch gathers return every row's scalars and
    every row's prev term, as the collectives would."""

    def __init__(self, rank, vecs, log_term, leader):
        self.rank, self.n_replicas = rank, vecs.shape[1]
        self.vecs, self.log_term, self.leader = vecs, log_term, leader

    def all_gather_host(self, x):
        if x.dim() == 2:                               # own scalars [1, 6]
            return self.vecs.t().clone()
        C = self.log_term.shape[1]
        slot = (max(int(self.vecs[2, self.leader]), 1) - 1) % C
        return self.log_term[:, slot].clone()

    all_gather_plane = all_gather_host

    def host_once(self, x):
        return x.cpu()


def test_mesh_turnover_is_decided_on_the_host(monkeypatch):
    """A turnover-eligible mesh flight (T·B >= C, feasible, every row
    accepting) goes to K4·mesh from the host's decision alone: no K3·mesh
    call (``LAUNCHES["pipeline_flight_mesh"]`` unchanged), one K4·mesh
    call per rank, and every rank's row equals the JAX local=True
    turnover."""
    import raft_tpu_torch.core.step_mesh as sm
    from raft_tpu_torch.core.state import ReplicaState

    R, C, T, P, last = 3, 512, 7, 3, B
    rng = np.random.default_rng(8)
    vecs0 = _steady_plane(R, last)
    wins = rng.integers(-2**31, 2**31, (P, B, W), dtype=np.int64) \
        .astype(np.int32)
    lp0 = rng.integers(-2**31, 2**31, (C, W), dtype=np.int64).astype(np.int32)
    lt0 = np.ones((1, C), np.int32)
    calls = {"k3": 0, "k4": 0}
    k4 = sm.turnover_flight
    monkeypatch.setattr(sm, "pipeline_flight", lambda *a, **k: calls.update(
        k3=calls["k3"] + 1))
    monkeypatch.setattr(sm, "turnover_flight", lambda *a, **k: (
        calls.update(k4=calls["k4"] + 1), k4(*a, **k)))
    launches = dict(tsc.LAUNCHES)
    run = _j_flight(C, T, P, R, True)
    ones = np.ones(R, bool)
    for r in range(R):
        params, masks = _j_params(r, 0, 1, 1, 0, 0, ones, ~ones, None, None,
                                  R, False)
        (jlp, jlt, jv), ji = run(
            jnp.asarray(lp0), jnp.asarray(lt0), jnp.asarray(wins),
            jnp.asarray(np.full((1, T), B, np.int32)),
            jnp.asarray([last % C], jnp.int32),
            jnp.ones((R, 1), jnp.int32), params, jnp.asarray(vecs0), masks)
        own = torch.from_numpy(vecs0[:, r:r + 1].copy())      # [6, 1]
        st = ReplicaState(*own, torch.from_numpy(lt0.copy()),
                          torch.from_numpy(lp0.copy()))
        comm = _GatherFromWhole(r, torch.from_numpy(vecs0),
                                torch.from_numpy(np.ones((R, C), np.int32)),
                                0)
        st, info = sm.mesh_pipeline(
            comm, st, torch.from_numpy(wins), torch.full((T,), B),
            0, 1, torch.from_numpy(ones), torch.from_numpy(~ones), 0, 0,
            None, 1)
        np.testing.assert_array_equal(st.log_payload.numpy(),
                                      np.asarray(jlp))
        np.testing.assert_array_equal(st.log_term.numpy(), np.asarray(jlt))
        for i, f in enumerate(("term", "voted_for", "last_index",
                               "commit_index", "match_index", "match_term")):
            assert int(getattr(st, f)[0]) == int(np.asarray(jv)[i, r]), f
        np.testing.assert_array_equal(info.match.numpy(),
                                      np.asarray(ji.match))
        assert int(info.commit_index) == int(ji.commit_index) == last + T * B
    assert calls == {"k3": 0, "k4": R}
    assert tsc.LAUNCHES == launches
