"""BASELINE config 4 (``bench.py`` ``c4_slow``: 5 replicas, one
induced-slow follower) through the port on the CPU against the JAX
package, at B = 128, 8-byte entries and C = 4096, led by row 0 in term 1
with row 4 slow. ``bench.py:3223-3231`` runs the config two ways and
keeps the faster, and so do these tests:

- the steady flight program: ``SingleDeviceTransport.replicate_pipeline(
  ..., allow_turnover=False)`` (K3 alone, never K4) against the JAX
  package's ``steady_pipeline_tpu(..., allow_turnover=False)`` in
  interpret mode, flights of 8 steps that lap the ring across calls (in
  interpret mode a flight is faithful while it revisits no slot, so none
  is a whole lap);
- the repair-capable program: ``replicate_many(..., repair=True)`` (the
  general path with K1) against the JAX transport's.

After every call every state leaf and the final info must be equal, and
the committed bytes of follower row 1 must be the input's. Commit follows
every submitted entry, rows 0-3 hold each one (4 of 5) and row 4's log
never moves. ``allow_turnover=False`` also keeps a flight that K4 would
take (every row accepting, T·B >= C) on K3."""

import hashlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.core import step_pallas as jsp
from raft_tpu.transport.device import SingleDeviceTransport as JTransport
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core import step_cuda
from raft_tpu_torch.core.state import fold_batch, log_entries
from raft_tpu_torch.transport.device import SingleDeviceTransport
from tests._torch_port import (
    assert_infos_equal,
    assert_states_equal,
    pallas_interpret,
)

R, E, B, C = 5, 8, 128, 4096
KW = dict(n_replicas=R, entry_bytes=E, batch_size=B, log_capacity=C,
          transport="single")
T = 8                           # steps a flight
SLOW = [False] * 4 + [True]
_J_FLIGHT = jax.jit(partial(jsp.steady_pipeline_tpu, interpret=True,
                            allow_turnover=False), donate_argnums=(0,))


@pytest.fixture(autouse=True)
def _interpret():
    with pallas_interpret():
        yield


class Pair:
    """One config-4 cluster held by the port on the CPU and by the JAX
    package, row 0 elected in term 1, with a client stream and the
    read-back hash of follower row 1."""

    def __init__(self, seed):
        self.tr, self.jtr = (SingleDeviceTransport(TConfig(**KW),
                                                   device="cpu"),
                             JTransport(JConfig(**KW)))
        self.st, vi = self.tr.request_votes(self.tr.init(), 0, 1,
                                            torch.ones(R, dtype=torch.bool))
        self.jst, jvi = self.jtr.request_votes(self.jtr.init(), 0, 1,
                                               jnp.ones(R, bool))
        assert int(vi.votes) == int(jvi.votes) == R
        self.rng = np.random.default_rng(seed)
        self.h_in, self.h_row1 = hashlib.sha256(), hashlib.sha256()
        self.done = 0

    def batches(self, counts):
        """Seeded entries for len(counts) windows (zero past each count),
        folded for the port and for the JAX package."""
        data = np.zeros((len(counts) * B, E), np.uint8)
        for t, c in enumerate(counts):
            chunk = self.rng.integers(0, 256, (c, E), dtype=np.uint8)
            data[t * B:t * B + c] = chunk
            self.h_in.update(chunk.tobytes())
        folded = fold_batch(data, R, device="cpu").reshape(len(counts), B,
                                                           -1)
        return folded, jnp.asarray(jst.fold_batch(data, R).reshape(
            len(counts), B, -1))

    def masks(self, slow):
        return ((torch.ones(R, dtype=torch.bool), torch.tensor(slow)),
                (jnp.ones(R, bool), jnp.asarray(slow)))

    def read_back(self):
        hi = int(self.st.commit_index[0])
        self.h_row1.update(log_entries(self.st, 1, self.done + 1, hi)
                           .tobytes())
        self.done = hi

    def check(self, info, jinfo, what):
        assert_states_equal(self.jst, self.st, what)
        assert_infos_equal(jinfo, info, what)
        self.read_back()


def _held_at_four_of_five(p, submitted):
    st = p.st
    assert st.commit_index.tolist()[:4] == [submitted] * 4
    assert st.last_index.tolist() == [submitted] * 4 + [0]
    assert int(st.match_index[0]) == submitted
    assert p.h_row1.hexdigest() == p.h_in.hexdigest()


def test_config4_flights_match_jax():
    p = Pair(seed=41)
    (al, sl), (jal, jsl) = p.masks(SLOW)
    work = step_cuda.workspace("cpu")
    ran3, ran4 = int(work[step_cuda.WK_RAN3]), int(work[step_cuda.WK_RAN4])
    counts = np.full(T, B, np.int32)
    flights = 3
    for f in range(flights):
        pay, jpay = p.batches(counts)
        p.st, info = p.tr.replicate_pipeline(
            p.st, pay, torch.from_numpy(counts), 0, 1, al, sl, term_floor=1,
            allow_turnover=False)
        p.jst, jinfo = _J_FLIGHT(
            p.jst, jpay, jnp.asarray(counts), jnp.int32(0), jnp.int32(1),
            jal, jsl, jnp.int32(0), jnp.int32(0), None, jnp.int32(1))
        p.check(info, jinfo, f"flight {f}")
    assert int(work[step_cuda.WK_RAN3]) == ran3 + flights
    assert int(work[step_cuda.WK_RAN4]) == ran4
    _held_at_four_of_five(p, flights * T * B)


def test_config4_repair_capable_ticks_match_jax():
    p = Pair(seed=42)
    (al, sl), (jal, jsl) = p.masks(SLOW)
    steps, calls = 4, 3
    counts = np.full(steps, B, np.int32)
    counts[-1] = B - 37                 # a partial batch
    submitted = 0
    for c in range(calls):
        pay, jpay = p.batches(counts)
        p.st, infos = p.tr.replicate_many(
            p.st, pay, torch.from_numpy(counts), 0, 1, al, sl, repair=True)
        p.jst, jinfos = p.jtr.replicate_many(
            p.jst, jpay, jnp.asarray(counts), 0, 1, jal, jsl, repair=True)
        submitted += int(counts.sum())
        p.check(infos, jinfos, f"call {c}")
    _held_at_four_of_five(p, submitted)


def test_allow_turnover_false_keeps_a_turnover_flight_on_k3():
    """Every row accepting and T·B >= C: the flight K4 takes by default
    runs on K3 with ``allow_turnover=False``, with the same result."""
    work = step_cuda.workspace("cpu")
    tr = SingleDeviceTransport(TConfig(**KW), device="cpu")
    al = torch.ones(R, dtype=torch.bool)
    sl = torch.zeros(R, dtype=torch.bool)
    lap = C // B
    data = np.random.default_rng(43).integers(0, 256, (lap * B, E),
                                              dtype=np.uint8)
    pay = fold_batch(data, R, device="cpu").reshape(lap, B, -1)
    counts = torch.full((lap,), B, dtype=torch.int32)
    outs = {}
    for allow in (True, False):
        st, _ = tr.request_votes(tr.init(), 0, 1, al)
        ran3 = int(work[step_cuda.WK_RAN3])
        ran4 = int(work[step_cuda.WK_RAN4])
        st, info = tr.replicate_pipeline(st, pay, counts, 0, 1, al, sl,
                                         term_floor=1, allow_turnover=allow)
        assert int(work[step_cuda.WK_RAN4]) - ran4 == int(allow)
        assert int(work[step_cuda.WK_RAN3]) - ran3 == int(not allow)
        assert int(info.commit_index) == lap * B
        outs[allow] = (st, info)
    for f in ("log_payload", "log_term", "commit_index", "last_index"):
        assert torch.equal(getattr(outs[True][0], f),
                           getattr(outs[False][0], f)), f


def test_mesh_flight_branch_honours_allow_turnover():
    """The mesh decides a flight's regime on the host: a flight that
    qualifies for K4·mesh (every row accepting, T·B >= C) stays a K3·mesh
    flight with ``allow_turnover=False``."""
    from raft_tpu_torch.core.step_mesh import flight_branch

    lap = C // B
    vecs = torch.zeros(6, R, dtype=torch.int32)
    vecs[0] = 1                                   # every row in term 1
    prev = torch.zeros(R, dtype=torch.int32)
    counts = torch.full((lap,), B, dtype=torch.int32)
    al, sl = torch.ones(R, dtype=torch.bool), torch.zeros(R, dtype=torch.bool)
    prm = step_cuda.step_params(0, 1, 1, 0, 0, None, R)
    for allow, want in ((True, "turnover"), (False, "flight")):
        assert flight_branch(vecs, prev, counts, al, sl, None, prm, B, C, 1,
                             allow) == (want, 0)
    assert flight_branch(vecs, prev, counts[:-1], al, sl, None, prm, B, C,
                         1) == ("flight", 0)
