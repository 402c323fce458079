"""The multi-Raft group data plane of raft_tpu_torch (core.step
group_replicate_step, group_vote_step, fused_group_scan, fused_steady_scan;
core.state init_group_state, group_view) against the JAX package's group
programs, fed the same inputs, every state leaf and every RepInfo/VoteInfo
field compared bit for bit, per group, after every call. The JAX side runs
under pallas_interpret(), so its vmapped ring kernel (write_window_cols_tpu)
runs in interpret mode. Mirrors tests/test_multi_raft.py's core level."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.core import step as jstep
from raft_tpu.core.comm import SingleDeviceComm as JComm
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core import state as tst
from raft_tpu_torch.core import step as tstep
from raft_tpu_torch.core.comm import SingleDeviceComm as TComm
from raft_tpu_torch.core.ring_cuda import LAUNCHES
from raft_tpu_torch.core.state import FIELDS, state_from_numpy, state_to_numpy
from tests._torch_port import (
    Duo,
    assert_infos_equal,
    assert_states_equal,
    pallas_interpret,
    rand_batch,
)

G, R, B, C = 3, 3, 128, 512
KW = dict(n_replicas=R, entry_bytes=8, batch_size=B, log_capacity=C)
W = 2                                     # 8-byte entries: 2 words
ALL = np.ones((G, R), bool)
NONE = np.zeros((G, R), bool)

# one compiled JAX program each, traced under pallas_interpret()
J_REP = {rep: jax.jit(jstep.group_replicate_step(R, repair=rep))
         for rep in (True, False)}
J_VOTE = jax.jit(jstep.group_vote_step(R))
J_FUSED = jax.jit(jstep.fused_group_scan(R))
J_STEADY = jax.jit(partial(jstep.fused_steady_scan, JComm(R), None))
T_REP = {rep: tstep.group_replicate_step(R, repair=rep)
         for rep in (True, False)}
T_VOTE = tstep.group_vote_step(R)
T_FUSED = tstep.fused_group_scan(R)


def _t(a):
    return torch.from_numpy(np.array(a))


def group_batches(seed, counts):
    """Folded i32[G, B, R*W] batches, each group's zero past its count."""
    return np.stack([rand_batch(seed * 10 + g, int(c), B)
                     for g, c in enumerate(counts)])


class GroupDuo:
    """G groups held in both packages, stepped in lock step."""

    def __init__(self):
        self.j = jst.init_group_state(JConfig(**KW), G)
        self.t = tst.init_group_state(TConfig(**KW), G, device="cpu")
        assert_states_equal(self.j, self.t, "init")

    def vote(self, cands, terms, alive=ALL):
        alive = np.asarray(alive, bool)
        with pallas_interpret():
            self.j, ji = J_VOTE(self.j, jnp.asarray(cands, jnp.int32),
                                jnp.asarray(terms, jnp.int32),
                                jnp.asarray(alive))
        self.t, ti = T_VOTE(self.t, _t(np.int32(cands)), _t(np.int32(terms)),
                            _t(alive))
        assert_infos_equal(ji, ti, "group vote")
        assert_states_equal(self.j, self.t, "group vote")
        return ti

    def rep(self, pays, counts, leaders, terms, alive=ALL, slow=NONE,
            member=ALL, repair=True):
        args = (pays, np.int32(counts), np.int32(leaders), np.int32(terms),
                alive, slow, member)
        with pallas_interpret():
            self.j, ji = J_REP[repair](self.j, *map(jnp.asarray, args))
        self.t, ti = T_REP[repair](self.t, *map(_t, args))
        assert_infos_equal(ji, ti, "group replicate")
        assert_states_equal(self.j, self.t, "group replicate")
        return ti

    def fused(self, pays, counts, n_run, halted0, leaders, terms,
              alive=ALL, slow=NONE, member=ALL):
        args = (pays, np.int32(counts), np.int32(n_run), halted0,
                np.int32(leaders), np.int32(terms), alive, slow, member)
        with pallas_interpret():
            self.j, *jout = J_FUSED(self.j, *map(jnp.asarray, args))
        self.t, *tout = T_FUSED(self.t, *map(_t, args))
        assert_infos_equal(jout[0], tout[0], "fused infos")
        for name, a, b in zip(("escaped", "ran", "halted"), jout[1:],
                              tout[1:]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"fused {name}")
        assert tout[3].dtype == torch.bool and tout[1].dtype == torch.int32
        assert_states_equal(self.j, self.t, "fused")
        return tout

    def fabricate(self, g, **leaves):
        """Overwrite group ``g``'s leaves on both sides (numpy values)."""
        new = {}
        for k, v in leaves.items():
            full = np.array(getattr(self.j, k))
            full[g] = v
            new[k] = jnp.asarray(full, jnp.int32)
        self.j = self.j.replace(**new)
        self.t = state_from_numpy(
            {f: np.asarray(getattr(self.j, f)) for f in FIELDS}, "cpu")

    def leaf(self, name, g):
        return np.array(np.asarray(getattr(self.j, name))[g])


def test_group_state_carries_across():
    st = tst.init_group_state(TConfig(**KW), G, device="cpu")
    assert tuple(st.log_payload.shape) == (G, C, R * W)
    assert tuple(st.log_term.shape) == (G, R, C)
    rng = np.random.default_rng(3)
    leaves = {f: rng.integers(-9, 9, getattr(st, f).shape).astype(np.int32)
              for f in FIELDS}
    back = state_to_numpy(state_from_numpy(leaves, "cpu"))
    for f in FIELDS:
        assert back[f].shape == leaves[f].shape and back[f].dtype == np.int32
        np.testing.assert_array_equal(back[f], leaves[f], err_msg=f)
    view = tst.group_view(state_from_numpy(leaves, "cpu"), 1)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(view, f).numpy(),
                                      leaves[f][1], err_msg=f)


def test_group_vote_step():
    d = GroupDuo()
    alive = ALL.copy()
    alive[2] = False                                  # group 2: no campaign
    info = d.vote([0, 1, 0], [1, 1, 0], alive)
    assert list(info.votes.numpy()) == [R, R, 0]
    d.vote([2, 0, 1], [2, 1, 3], [[1, 1, 0], [1, 1, 1], [0, 1, 1]])
    d.vote([1, 1, 1], [2, 1, 3])                      # already voted / stale


def test_group_replicate_step():
    """Distinct per-group counts, a masked group, a slow row healed by the
    repair window, the wrap seam, a stale-term conflict that truncates;
    and group 1 equal to the single-group port path on the same inputs."""
    d = GroupDuo()
    leaders, terms = [0, 1, 2], [1, 1, 1]
    d.vote(leaders, terms)
    single = tst.init_state(TConfig(**KW), device="cpu")
    comm = TComm(R)
    ones = torch.ones(R, dtype=torch.bool)
    single, _ = tstep.vote_step(comm, single, 1, 1, ones)

    def rep(step, counts, alive=ALL, slow=NONE, terms_=terms):
        pays = group_batches(step, counts)
        info = d.rep(pays, counts, leaders, terms_, alive, slow)
        nonlocal single
        single, _ = tstep.replicate_step(
            comm, single, _t(pays[1]), int(counts[1]), 1, terms_[1],
            _t(alive[1]), _t(slow[1]), member=ones)
        return info

    slow = NONE.copy()
    slow[0, 2] = True                                 # group 0: row 2 slow
    masked = ALL.copy()
    masked[1] = False                                 # group 1: masked
    n0 = LAUNCHES["write_window_cols"]
    rep(0, [B, B - 5, 17], slow=slow)
    before = {f: d.leaf(f, 1) for f in FIELDS}
    rep(1, [B, 0, 40], alive=masked, slow=slow, terms_=[1, 0, 1])
    for f in FIELDS:                                  # bit-unchanged
        np.testing.assert_array_equal(d.leaf(f, 1), before[f], err_msg=f)
    for step in range(2, 9):                          # past the wrap seam
        info = rep(step, [B // 2, B, 3 * step])
    healed = int(info.commit_index[0])                # row 2 caught up
    assert list(info.match.numpy()[0]) == [healed] * R and healed > 4 * B
    assert int(d.leaf("last_index", 1)[1]) > C
    assert LAUNCHES["write_window_cols"] == n0        # CPU: no launches

    view = tst.group_view(d.t, 1)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(view, f).numpy(),
                                      getattr(single, f).numpy(), err_msg=f)

    # a stale-term conflict: group 2's row 0 holds two extra entries of
    # term 1 the leader never had; the new leader's term-2 entry truncates
    last = int(d.leaf("last_index", 2)[2])
    lt, li = d.leaf("log_term", 2), d.leaf("last_index", 2)
    lt[0, [last % C, (last + 1) % C]] = 1
    li[0] = last + 2
    d.fabricate(2, log_term=lt, last_index=li)
    d.vote([0, 1, 2], [1, 1, 2], [[0] * R, [0] * R, [1] * R])
    d.rep(group_batches(20, [0, 0, 1]), [0, 0, 1], leaders, [1, 1, 2])
    assert int(d.leaf("last_index", 2)[0]) == last + 1


def test_fused_group_scan():
    """A commit-stall escape (group 0), a higher-term escape (group 1),
    a clean group (2), n_run < K, and halted threaded across launches."""
    d = GroupDuo()
    leaders = [0, 1, 2]
    d.vote(leaders, [1, 1, 1])
    d.rep(group_batches(0, [B, B, B]), [B, B, B], leaders, [1, 1, 1])
    K = 4
    pays = np.stack([group_batches(1 + k, [B] * G)[:, :, :W]
                     for k in range(K)])
    counts = np.full((K, G), B, np.int32)
    counts[0, 0] = 0                  # group 0 stalls at its second tick
    slow = NONE.copy()
    slow[0, 1:] = True
    term = d.leaf("term", 1)
    term[2] = 5                       # group 1: a higher term surfaces
    d.fabricate(1, term=term)
    _, esc, ran, halted = d.fused(pays, counts, K, np.zeros(G, bool),
                                     leaders, [1, 1, 1], slow=slow)
    assert list(esc.numpy().argmax(0)) == [1, 0, 0]
    assert list(esc.numpy().sum(0)) == [1, 1, 0]
    assert list(halted.numpy()) == [True, True, False]
    before = {f: (d.leaf(f, 0), d.leaf(f, 1)) for f in FIELDS}
    _, esc, ran, halted = d.fused(pays, counts, 2, halted.numpy(),
                                     leaders, [1, 1, 1])
    assert list(ran.numpy().sum(0)) == [0, 0, 2]
    for f in FIELDS:                  # halted groups stay bit-unchanged
        np.testing.assert_array_equal(d.leaf(f, 0), before[f][0], err_msg=f)
        np.testing.assert_array_equal(d.leaf(f, 1), before[f][1], err_msg=f)


def test_fused_steady_scan():
    """The single-group K-tick scan: a count-0 prefix, then a commit-stall
    escape mid-scan; the next launch with halted0 set runs nothing."""
    d = Duo(**KW)
    with pallas_interpret():
        d.vote(0, 1)
        d.rep(rand_batch(0, B, B), B)
        S, K = 3, 4
        staging = np.stack([rand_batch(1 + s, B, B)[:, :W] for s in range(S)])
        alive, slow = np.ones(R, bool), np.array([False, True, True])
        for counts, halted0 in (([0, 0, B, B], False), ([B] * K, True)):
            args = (staging, 2, np.int32(counts), K, halted0, 0, 1, alive,
                    slow)
            d.j, *jout = J_STEADY(d.j, *map(jnp.asarray, args))
            d.t, *tout = tstep.fused_steady_scan(
                TComm(R), None, d.t, *map(_t, args))
            assert_infos_equal(jout[0], tout[0], "steady scan infos")
            for a, b in zip(jout[1:], tout[1:]):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert_states_equal(d.j, d.t, "steady scan")
            assert bool(tout[3])
        assert list(tout[2].numpy()) == [0] * K
