"""Shared helpers of the port's tests (tests/test_torch_*.py): carry states
between the JAX package and raft_tpu_torch through numpy, and compare every
leaf bit for bit. All comparisons are integer and exact."""

from __future__ import annotations

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import ring as jring
from raft_tpu.core import state as jst
from raft_tpu.core import step as jstep
from raft_tpu.core.comm import SingleDeviceComm as JComm
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core import state as tst
from raft_tpu_torch.core import step as tstep
from raft_tpu_torch.core.comm import SingleDeviceComm as TComm
from raft_tpu_torch.core.state import FIELDS, state_from_numpy, state_to_numpy


@contextlib.contextmanager
def pallas_interpret():
    """Route the JAX package's kernel-eligible shapes through its Pallas
    kernels in interpret mode (restored afterwards)."""
    prior = jring._force_interpret
    jring.force_pallas_interpret(True)
    try:
        yield
    finally:
        jring.force_pallas_interpret(prior)


def jax_leaves(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def to_port(state, device="cpu"):
    """A JAX ReplicaState as the port's state (a fresh copy)."""
    return state_from_numpy(jax_leaves(jax.tree.map(np.asarray, state)),
                            device)


def assert_states_equal(jstate, tstate, msg=""):
    want = jax_leaves(jstate)
    got = state_to_numpy(tstate)
    for f in FIELDS:
        assert got[f].dtype == np.int32, f"state.{f} dtype {got[f].dtype}"
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{msg} state.{f}")


def assert_infos_equal(jinfo, tinfo, msg=""):
    for f in jinfo._fields:
        want = np.asarray(getattr(jinfo, f))
        got = getattr(tinfo, f).cpu().numpy()
        if want.dtype == np.bool_:
            assert got.dtype == np.bool_, f"info.{f} dtype {got.dtype}"
        else:
            assert got.dtype == np.int32, f"info.{f} dtype {got.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} info.{f}")


_JREP: dict = {}


def _jrep(rows, repair, commit_quorum=None, ec=False):
    # the interpret flag is read when jit traces, so it is part of the key
    key = (rows, repair, commit_quorum, ec, jring._force_interpret)
    if key not in _JREP:
        _JREP[key] = jax.jit(partial(jstep.replicate_step, JComm(rows),
                                     repair=repair, ec=ec,
                                     commit_quorum=commit_quorum))
    return _JREP[key]


_JVOTE = {r: jax.jit(partial(jstep.vote_step, JComm(r))) for r in (1, 3, 5)}


class Duo:
    """One cluster held in both packages, stepped in lock step."""

    def __init__(self, **kw):
        self.cfg = TConfig(**kw)
        self.R = self.cfg.rows
        self.j = jst.init_state(JConfig(**kw))
        self.t = tst.init_state(self.cfg, device="cpu")
        self.tcomm = TComm(self.R)

    def _masks(self, alive, slow):
        alive = np.ones(self.R, bool) if alive is None else np.asarray(alive)
        slow = np.zeros(self.R, bool) if slow is None else np.asarray(slow)
        return alive, slow

    def rep(self, payload, count, leader=0, term=1, alive=None, slow=None,
            repair=True, term_floor=None, member=None, commit_quorum=None,
            ec=False):
        alive, slow = self._masks(alive, slow)
        jm = None if member is None else jnp.asarray(member)
        self.j, ji = _jrep(self.R, repair, commit_quorum, ec)(
            self.j, jnp.asarray(payload), jnp.int32(count), jnp.int32(leader),
            jnp.int32(term), jnp.asarray(alive), jnp.asarray(slow),
            jnp.int32(0), jnp.int32(0), jm,
            term_floor=None if term_floor is None else jnp.int32(term_floor))
        self.t, ti = tstep.replicate_step(
            self.tcomm, self.t, torch.from_numpy(np.array(payload)), count,
            leader, term, torch.from_numpy(alive), torch.from_numpy(slow),
            member=None if member is None else torch.tensor(member),
            repair=repair, term_floor=term_floor,
            commit_quorum=commit_quorum, ec=ec)
        assert_infos_equal(ji, ti, "replicate")
        assert_states_equal(self.j, self.t, "replicate")
        return ti

    def vote(self, cand, term, alive=None):
        alive, _ = self._masks(alive, None)
        self.j, ji = _JVOTE[self.R](self.j, jnp.int32(cand), jnp.int32(term),
                                    jnp.asarray(alive))
        self.t, ti = tstep.vote_step(self.tcomm, self.t, cand, term,
                                     torch.from_numpy(alive))
        assert_infos_equal(ji, ti, "vote")
        assert_states_equal(self.j, self.t, "vote")
        return ti

    def fabricate(self, **leaves):
        """Overwrite leaves on both sides (numpy values)."""
        self.j = self.j.replace(**{k: jnp.asarray(v, jnp.int32)
                                   for k, v in leaves.items()})
        self.t = to_port(self.j)

    def leaf(self, name):
        return np.asarray(getattr(self.j, name))


def batch(vals, rows=3, entry=8):
    """Folded batch whose entry j is ``entry`` copies of byte vals[j]."""
    data = np.repeat(np.asarray(vals, np.uint8)[:, None], entry, axis=1)
    return np.asarray(jst.fold_batch(data, rows))


def rand_batch(seed, count, B, rows=3, entry=8):
    """Folded batch of random entries, zero past ``count``."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (B, entry), dtype=np.uint8)
    data[count:] = 0
    return np.asarray(jst.fold_batch(data, rows))
