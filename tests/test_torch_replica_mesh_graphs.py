"""The one-process mesh's fused-window graph set
(``raft_tpu_torch.core.graphs.MeshFusedGraphs``) held on the CPU.

On the card ``ReplicaMeshTransport.replicate_fused`` replays one CUDA
graph of every block's K-tick loop; here no graph can be captured, so the
graph set's captured region (``MeshFusedGraphs._body``: the packed
per-launch input read by every block, the static small leaves, the
blocks' rings written in place, one halted flag a block, the event ring's
static copies) runs uncaptured on CPU blocks, on the same ``LockStep``
threads, and must equal ``replicate_fused``'s eager loop on every block's
leaves, rings and outputs: at K 1, 2 and 8, with the member modes none,
bool and packed, recorded and not, the halted input from the host and on
the device. Then the pool: a released mesh transport's rings, staging
buffer and graph set go to the next transport of its shape, as JAX's
process-wide program cache serves a second ``TpuMeshTransport``."""

import numpy as np
import pytest
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core import graphs
from raft_tpu_torch.core.state import BlockState, pack_membership
from raft_tpu_torch.obs.device import init_ring
from raft_tpu_torch.raft import RaftEngine
from raft_tpu_torch.transport import ReplicaMesh, ReplicaMeshTransport

KW = dict(n_replicas=3, entry_bytes=32, batch_size=4, log_capacity=64,
          transport="tpu_mesh", seed=5)
VOTERS = np.array([True, True, True, False, False])
MEMBERS = {"none": None, "bool": VOTERS,
           "packed": pack_membership(VOTERS, np.array(
               [False, False, False, True, False]))}

_BASES: dict = {}


def base(kind: str):
    """An engine over CPU blocks after an election and 12 committed
    entries (5 blocks with membership headroom for the member modes),
    built once a kind."""
    if kind not in _BASES:
        cfg = RaftConfig(**KW, **({} if kind == "none"
                                  else {"max_replicas": 5}))
        t = ReplicaMeshTransport(cfg, ReplicaMesh(["cpu"] * cfg.rows))
        e = RaftEngine(cfg, t)
        e.run_until_leader()
        rng = np.random.default_rng(7)
        seqs = [e.submit(rng.integers(0, 256, cfg.entry_bytes,
                                      np.uint8).tobytes())
                for _ in range(12)]
        e.run_until_committed(seqs[-1])
        _BASES[kind] = (cfg, t, e.state.clone(), e.leader_id,
                        int(e.leader_term), int(e.commit_watermark))
    return _BASES[kind]


def check_same(gs, outs, eager, K, R, what):
    """Every block's static leaves, rings, halted flag and packed outputs
    equal to the eager loop's result (its outputs are block 0's; every
    block computes the same replicated values)."""
    st, infos, esc, ran, halted = eager[:5]
    for g in range(len(gs.small)):
        for f, leaf in gs.small[g].items():
            assert torch.equal(leaf, getattr(st, f)[g]), f"{what} {g} {f}"
        assert torch.equal(gs.log_term[g], st.log_term[g]), what
        assert torch.equal(gs.log_payload[g], st.log_payload[g]), what
        assert bool(gs.halted[g]) == bool(halted), f"{what} {g} halted"
        i2, e2, r2, h2 = graphs.unpack_outputs(outs[g], K, R)
        for f in infos._fields:
            assert torch.equal(getattr(i2, f), getattr(infos, f)), \
                f"{what} block {g} info.{f}"
        assert torch.equal(e2, esc) and torch.equal(r2, ran), what
        assert bool(h2) == bool(halted), what


def same_rings(a, b, what):
    for name, x, y in zip(("buf", "count", "tick", "counters"),
                          a.tensors(), b.tensors()):
        assert torch.equal(x, y), f"{what}: ring {name}"


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("kind", ["none", "bool", "packed"])
@pytest.mark.parametrize("K", [1, 2, 8])
def test_the_graph_body_equals_the_eager_loop(K, kind, recorded):
    cfg, t, st0, leader, term, wm = base(kind)
    R, B, W = cfg.rows, cfg.batch_size, cfg.shard_words
    member = MEMBERS[kind]
    rng = np.random.default_rng(K)
    S = max(2, 2 * K)
    staging = torch.from_numpy(rng.integers(
        -2**31, 2**31, (S, B, W), dtype=np.int64).astype(np.int32))
    full = VOTERS[:R] | (kind == "none")
    lone = np.arange(R) == leader
    slow = np.zeros(R, bool)
    fg = graphs.MeshFusedGraphs(t)
    cases = [("full", np.full(K, B, np.int32), K, False, full),
             ("n_run", np.full(K, B, np.int32), K // 2, False, full),
             ("halted0", np.full(K, B, np.int32), K, True, full),
             ("escape", np.full(K, B, np.int32), K, False, lone)]
    for name, counts, n_run, h0, alive in cases:
        se, sb = st0.clone(), st0.clone()
        re = rb = None
        if recorded:
            re, rb = init_ring(64, "cpu"), init_ring(64, "cpu")
        kw = dict(member=member, repair_floor=1, floor_prev_term=0)
        eager = t.replicate_fused(se, staging, S - 1, counts, n_run, h0,
                                  leader, term, alive, slow, ring=re, **kw)
        gs = fg.prepare(sb, staging, K, member, rb)
        mode = fg.halted_mode(gs, h0)
        inp = torch.from_numpy(graphs.pack_launch(
            K, R, S - 1, n_run, mode, leader, term, 1, 0, counts, alive,
            slow, member))
        outs = fg._body(gs, inp, K, graphs.member_kind(member))
        what = f"K={K} {kind} rec={recorded} {name}"
        check_same(gs, outs, eager, K, R, what)
        if recorded:
            same_rings(rb, re, what)
            for copy in gs.ring_copies:
                same_rings(copy, rb, f"{what}: a block's copy")
        if name == "full" and K > 1:
            assert int(eager[1].commit_index[-1]) == wm + K * B, what
        if name != "escape":
            continue
        assert bool(eager[4]), f"{what}: no escape"
        # the next launch reads the escape's halted flag on the device:
        # every tick the masked no-op
        eager2 = t.replicate_fused(eager[0], staging, 0, counts, K,
                                   eager[4], leader, term, full, slow,
                                   ring=re, **kw)
        gs2 = fg.prepare(gs.state(t), staging, K, member, rb)
        assert gs2 is gs
        inp = torch.from_numpy(graphs.pack_launch(
            K, R, 0, K, graphs.HALTED_ON_DEVICE, leader, term, 1, 0,
            counts, full, slow, member))
        outs = fg._body(gs, inp, K, graphs.member_kind(member))
        check_same(gs, outs, eager2, K, R, f"{what}, then on device")
        assert int(eager2[3].sum()) == 0, what
        if recorded:
            same_rings(rb, re, f"{what}, then on device")
    assert fg.captures == 0 and fg.recaptures == len(cases) - 1


def test_the_halted_input_and_the_packed_launch():
    cfg, t, st0, leader, term, _ = base("none")
    fg = graphs.MeshFusedGraphs(t)
    staging = torch.zeros((4, cfg.batch_size, cfg.shard_words),
                          dtype=torch.int32)
    gs = fg.prepare(st0.clone(), staging, 2, None)
    assert fg.halted_mode(gs, False) == 0 and fg.halted_mode(gs, True) == 1
    assert fg.halted_mode(gs, np.bool_(True)) == 1
    assert len(gs.halted) == len(t.devices) == 3
    host = graphs.pack_launch(2, 3, 3, 2, 0, leader, term, 1, 0,
                              np.array([4, 2]), np.ones(3, bool),
                              np.zeros(3, bool), None)
    assert host.shape == (graphs.launch_size(2, 3, "none"),)
    assert host.tolist() == [3, 2, 0, leader, term, 1, 0, 4, 2, 1, 1, 1,
                             0, 0, 0]
    assert isinstance(gs.state(t), BlockState) and gs.state(t).view is t


# ------------------------------------------------------------ the pool
CFG = RaftConfig(n_replicas=3, entry_bytes=32, batch_size=4,
                 log_capacity=128, transport="tpu_mesh", seed=3, fuse_k=4)


@pytest.fixture
def pool():
    graphs.POOL.clear()
    yield graphs.POOL
    graphs.POOL.clear()


def mesh_engine(trace=None, path=None):
    t = ReplicaMeshTransport(CFG, ReplicaMesh(["cpu"] * 3))
    if path is not None:
        return RaftEngine.restore(CFG, path, t, trace=trace)
    return RaftEngine(CFG, t, trace=trace)


def drive(e, n=24):
    e.run_until_leader()
    seqs = [e.submit(bytes([i + 1]) * CFG.entry_bytes) for i in range(n)]
    e.run_for(40.0)
    assert all(e.is_durable(s) for s in seqs)
    assert e.fused_launches > 0
    return e


def test_a_released_mesh_lends_its_graph_set(pool, tmp_path):
    """A set over the engine's block rings and staging buffer, as the
    card's first fused launch leaves it: released with the transport, the
    next transport of the shape takes the rings (zeroed), the set (bound
    to its own lock step and comms) and the staging buffer back, and a
    restore onto it commits and reads as one with lending off."""
    a = drive(mesh_engine())
    staging = a._fused_driver.staging.buf
    fg = graphs.MeshFusedGraphs(a.t)
    gs = fg.prepare(a.state, staging, 4, None)
    a.t.graphs = a.t._held.graphs = fg
    rings = gs.ring_tensors()
    path = str(tmp_path / "a.npz")
    a.save_checkpoint(path)
    a.t.release()
    assert a.t.graphs is None and len(pool.free) == 1
    lines = []
    b = mesh_engine(lines.append, path)
    assert pool.lent == 1 and pool.free == []
    assert b.t.graphs is fg and fg.recaptures == 0
    assert fg.lockstep is b.t.lockstep and fg.comms is b.t.comms
    assert tuple(b.state.log_term) + tuple(b.state.log_payload) == rings
    drive(b)
    assert b._fused_driver.staging.buf is staging
    assert fg.sets[next(iter(fg.sets))].holds(b.state, staging, None)
    # the same restore with lending off: every line and byte equal
    pool.enabled = False
    try:
        plain_lines = []
        c = drive(mesh_engine(plain_lines.append, path))
    finally:
        pool.enabled = True
    assert c.t.graphs is None and c.state.log_payload[0] is not rings[3]
    assert lines == plain_lines
    for f in ("term", "commit_index", "last_index", "log_term",
              "log_payload"):
        for g in range(3):
            assert torch.equal(getattr(b.state, f)[g],
                               getattr(c.state, f)[g]), f


def test_a_mesh_entry_serves_only_its_own_shape(pool):
    a = drive(mesh_engine())
    payload = a.state.log_payload[0]
    a.t.release()
    # a single-device transport of the same config never takes it
    from raft_tpu_torch.transport import SingleDeviceTransport

    s = RaftEngine(CFG, SingleDeviceTransport(CFG, device="cpu"))
    assert s.state.log_payload is not payload and pool.lent == 0
    d = mesh_engine()
    assert d.state.log_payload[0] is payload and pool.lent == 1
    assert all(int(x.abs().sum()) == 0 for x in d.state.log_payload)
    e = mesh_engine()                      # d is alive: nothing to lend
    assert e.state.log_payload[0] is not payload and pool.lent == 1
