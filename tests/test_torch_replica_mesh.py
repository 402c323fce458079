"""The port's one-process replica mesh, step by step
(``raft_tpu_torch.transport.ReplicaMeshTransport`` over
``ReplicaMesh(["cpu"] * R·P)``: one block a row, or a lane slice of one,
each block's protocol body on a ``core.comm.LockStep`` thread, the
collectives device copies) against the JAX package's one-process
``TpuMeshTransport(cfg, jax.devices()[:R·P])`` on the virtual CPU devices
of tests/conftest.py, the Pallas kernels in interpret mode.

The schedules are the gloo mesh's (tests/test_torch_mesh.py at P = 1,
tests/test_torch_mesh2d.py at P = 2): after every stage every block's
state leaves equal its part of the JAX mesh state (``cut_row``) and the
call's RepInfo/VoteInfo equal JAX's, bit for bit, and the
``LAST_DISPATCH`` witness names the mesh entry point that ran. The
stages cover ``replicate`` (general, steady K2·mesh, repair),
``replicate_many``, ``replicate_pipeline`` (K3·mesh and K4·mesh through
their plain versions), ``replicate_fused`` and ``request_votes``.

The pins: no ``torch.distributed`` group exists, the collectives copy no
operand to the host (a flight reads its decision plane once for the whole
mesh), two blocks on one device do not alias, an error in one block
raises in the caller, and blocks that leave lock step raise instead of
hanging."""

import jax
import numpy as np
import pytest
import torch

import raft_tpu.transport.tpu_mesh as jax_tpu_mesh
import raft_tpu_torch.core.step_mesh as step_mesh
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.comm import BlockComm, LockStep
from raft_tpu_torch.core.state import (
    FIELDS,
    BlockState,
    Blocks,
    state_to_numpy,
)
from raft_tpu_torch.transport import ReplicaMesh, ReplicaMeshTransport
from tests import test_torch_mesh as tm
from tests import test_torch_mesh2d as t2
from tests._mesh_ranks import apply_stage, info_numpy


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_mesh_programs():
    """JAX's mesh programs are cached process-wide and witness their
    dispatch at trace time: this module traces its own and leaves none
    behind."""
    jax.clear_caches()
    jax_tpu_mesh._PROGRAMS.clear()
    yield
    jax.clear_caches()
    jax_tpu_mesh._PROGRAMS.clear()


def cpu_mesh(cfg: RaftConfig, P: int = 1) -> ReplicaMeshTransport:
    return ReplicaMeshTransport(cfg, ReplicaMesh(["cpu"] * cfg.rows * P),
                                payload_shards=P)


def run_blocks(programs: dict, P: int = 1) -> list:
    """Every program {name: (config keywords, stages)} from a fresh
    cluster on one ``ReplicaMeshTransport`` of CPU blocks; returns, for
    every block g, {name: [(its leaves, the info, dispatch) a stage]}
    (the form of the gloo ranks' results)."""
    out: list = []
    for name, (cfg_kw, stages) in programs.items():
        tr = cpu_mesh(RaftConfig(**cfg_kw, transport="tpu_mesh"), P)
        out += [{} for _ in range(len(tr.devices) - len(out))]
        state = tr.init()
        for stage in stages:
            step_mesh.LAST_DISPATCH = None
            state, info = apply_stage(tr, state, stage)
            assert isinstance(state, BlockState)
            for g in range(len(tr.devices)):
                leaves = {f: getattr(state, f)[g].numpy().copy()
                          for f in FIELDS}
                out[g].setdefault(name, []).append(
                    (leaves, info_numpy(info), step_mesh.LAST_DISPATCH))
        if all(s["op"] != "north_star" for s in stages):
            # one host read a flight, for the whole mesh
            assert tr.comm_host_copies() == sum(
                s["op"] == "pipeline" for s in stages), name
    return out


@pytest.fixture(scope="module")
def blocks3():
    return run_blocks(tm.PROGRAMS3)


@pytest.fixture(scope="module")
def blocks5():
    return run_blocks({"ec": (tm.EC_CFG, tm._ec_shards())})


@pytest.fixture(scope="module")
def blocks6():
    return [{"programs": b} for b in run_blocks(t2.PROGRAMS6, t2.P)]


@pytest.mark.parametrize("name", ["ladder", "fused_scan",
                                  "saturated_pipeline"])
def test_schedule_matches_jax_mesh(blocks3, name):
    """The dry run's ladder (vote, general K1, steady K2·mesh, K3·mesh
    flight, a scan with a slow row, its repair heal, a failover), the
    fused K-tick scan and the saturated flight: every block's leaves and
    every info field equal JAX's one-process mesh after every stage."""
    tm._check(blocks3, name, *tm.PROGRAMS3[name])


def test_ec_shards_match_jax_mesh(blocks5):
    """RS(5,3) shards through K2·mesh on 5 blocks."""
    st = tm._check(blocks5, "ec", tm.EC_CFG, tm._ec_shards())
    assert (np.asarray(st.commit_index) == tm.B).all()


@pytest.mark.parametrize("name", sorted(t2.PROGRAMS6))
def test_payload_shards_match_jax_2d_mesh(blocks6, name):
    """P = 2: 3 x 2 blocks against JAX's (replica, pshard) mesh, every
    block's leaves its part of the JAX state (``cut_row(..., g, 2)``)."""
    t2._check_program(blocks6, name, *t2.PROGRAMS6[name])


def test_north_star_turns_the_ring_over(blocks3):
    """``northstar.run_device`` on one engine's transport: the followers'
    read-backs hash to the input and every block equals its row of the
    resident run of the same stream (K4·mesh's plain version)."""
    from raft_tpu_torch.core.state import cut_row
    from raft_tpu_torch.northstar import run_device
    from raft_tpu_torch.transport import SingleDeviceTransport

    cfg_kw, stages = tm.PROGRAMS3["north_star"]
    tr = SingleDeviceTransport(RaftConfig(**cfg_kw, transport="single"),
                               device="cpu")
    st, _ = tr.request_votes(tr.init(), 0, 1, np.ones(3, bool))
    run = run_device(tr.cfg, stages[1]["n"], stages[1]["seed"],
                     transport=tr, state=st, rows=(1, 2))
    want = state_to_numpy(run.state)
    for r in range(3):
        leaves, info, dispatch = blocks3[r]["north_star"][1]
        assert dispatch == "pipeline"
        assert info["input"] == run.input_digest
        assert info["rows"] == {1: run.row_digests[1],
                                2: run.row_digests[2]}
        cut = cut_row(want, r)
        for f in FIELDS:
            np.testing.assert_array_equal(leaves[f], cut[f], f"block {r} {f}")


def test_no_process_group_and_no_host_copies():
    """A steady tick, a scan and a vote: no ``torch.distributed`` group
    is made, and no collective copies an operand to the host."""
    import torch.distributed as dist

    cfg = RaftConfig(**tm.KERNEL_CFG, transport="tpu_mesh")
    tr = cpu_mesh(cfg)
    stages = tm._ladder()
    st = tr.init()
    for stage in stages[:3] + stages[4:]:
        st, _ = apply_stage(tr, st, stage)
        assert not dist.is_initialized()
    assert tr.comm_host_copies() == 0
    assert tr.collectives() > 0


def test_blocks_on_one_device_do_not_alias():
    """Three blocks of one device hold separate storage: a write to row
    1 leaves row 0's and row 2's bytes as they were."""
    cfg = RaftConfig(n_replicas=3, entry_bytes=8, batch_size=4,
                     log_capacity=16, transport="tpu_mesh")
    tr = cpu_mesh(cfg)
    st = tr.init()
    before = state_to_numpy(st)

    def write(blk, i, cut):
        blk.log_payload.fill_(7)
        blk.log_term.fill_(3)
        return blk

    tr.on_row(st, 1, write)
    after = state_to_numpy(st)
    w = cfg.shard_words
    assert (after["log_payload"][:, w:2 * w] == 7).all()
    assert (after["log_term"][1] == 3).all()
    for r in (0, 2):
        np.testing.assert_array_equal(
            after["log_payload"][:, r * w:(r + 1) * w],
            before["log_payload"][:, r * w:(r + 1) * w])
        np.testing.assert_array_equal(after["log_term"][r],
                                      before["log_term"][r])
    ptrs = {t.data_ptr() for t in st.log_payload}
    assert len(ptrs) == 3


def test_a_failing_block_raises_in_the_caller():
    """An error in block 1 raises at once in the caller; the other blocks
    stop at their next collective, and the mesh runs again afterwards."""
    ls = LockStep(["cpu"] * 3)
    comms = [BlockComm(ls, g, 3) for g in range(3)]

    def body(g):
        x = comms[g].all_gather(torch.full((1,), g))
        if g == 1:
            raise KeyError("block 1 fails on purpose")
        return comms[g].all_gather(x[None])

    with pytest.raises(KeyError, match="on purpose"):
        ls.run(body)
    got = ls.run(lambda g: comms[g].all_gather(torch.full((1,), 10 + g)))
    assert [t.tolist() for t in got] == [[10, 11, 12]] * 3


def test_blocks_out_of_lock_step_raise():
    """A block that ends, or makes another collective, while the others
    wait at one raises rather than hanging."""
    ls = LockStep(["cpu"] * 2)
    comms = [BlockComm(ls, g, 2) for g in range(2)]

    def ends_early(g):
        if g == 0:
            return None
        return comms[g].all_gather(torch.zeros(1))

    with pytest.raises(RuntimeError, match="left lock step"):
        ls.run(ends_early)

    def other_op(g):
        x = torch.zeros(1, 2)
        return (comms[g].all_gather(x) if g == 0
                else comms[g].all_gather_lanes(x))

    with pytest.raises(RuntimeError, match="left lock step"):
        ls.run(other_op)


def test_an_operand_changed_in_place_raises():
    """Block 0 runs on past a collective before block 1 reads its
    operand: a body that changes its operand in place there raises
    (``LockStep``), and the mesh runs again afterwards."""
    ls = LockStep(["cpu"] * 2)
    comms = [BlockComm(ls, g, 2) for g in range(2)]

    def writes_back(g):
        x = torch.full((1,), g)
        comms[g].all_gather(x)
        x.add_(5)
        return comms[g].all_gather(torch.zeros(1))

    with pytest.raises(RuntimeError, match="changed their operand"):
        ls.run(writes_back)

    def replaces(g):
        x = torch.full((1,), g)
        got = comms[g].all_gather(x)
        x = x + 5
        return got.tolist(), comms[g].all_gather(x).tolist()

    assert ls.run(replaces) == [([0, 1], [5, 6])] * 2


def test_collectives_gather_on_each_blocks_device():
    """``all_gather`` over the column, ``all_gather_lanes`` over the row
    and ``select_row``/``leader_cols`` on a 2 x 2 mesh: the JAX
    semantics, each result a fresh tensor on the block's device."""
    ls = LockStep(["cpu"] * 4)
    comms = [BlockComm(ls, g, 2, payload_shards=2) for g in range(4)]
    leader = torch.tensor(1, dtype=torch.int32)

    def body(g):
        c = comms[g]
        mine = torch.full((1, 3), g, dtype=torch.int32)
        col = c.all_gather(mine)
        lanes = c.all_gather_lanes(mine[0])
        row = c.select_row(torch.full((1,), 10 * g), leader)
        cols = c.leader_cols(torch.full((2, 3), g), leader, 3)
        return col[:, 0].tolist(), lanes.tolist(), int(row), \
            cols[0].tolist(), col.data_ptr() != mine.data_ptr()

    got = ls.run(body)
    assert [g[0] for g in got] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [g[1] for g in got] == [[0] * 3 + [1] * 3] * 2 + \
        [[2] * 3 + [3] * 3] * 2
    assert [g[2] for g in got] == [20, 30, 20, 30]
    assert [g[3] for g in got] == [[2] * 3, [3] * 3, [2] * 3, [3] * 3]
    assert all(g[4] for g in got)
    assert sum(c.host_copies for c in comms) == 0


def test_size_checks_are_jaxs():
    """Too few devices, membership headroom and lanes that do not split
    raise the JAX transport's texts; more devices than needed use the
    first ``rows * P``."""
    kw = dict(n_replicas=3, entry_bytes=8, batch_size=4, log_capacity=16,
              transport="tpu_mesh")
    with pytest.raises(ValueError, match=r"need 3 devices \(3 replica rows "
                       r"x 1 payload shards\), got 2"):
        ReplicaMeshTransport(RaftConfig(**kw), ReplicaMesh(["cpu"] * 2))
    with pytest.raises(ValueError, match=r"need 5 devices \(5 replica "
                       r"rows x 1 payload shards\), got 3"):
        ReplicaMeshTransport(RaftConfig(**kw, max_replicas=5),
                             ReplicaMesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="must divide evenly over 3"):
        ReplicaMeshTransport(RaftConfig(**kw), ReplicaMesh(["cpu"] * 9),
                             payload_shards=3)
    tr = ReplicaMeshTransport(RaftConfig(**kw), ReplicaMesh(["cpu"] * 8))
    assert len(tr.devices) == 3 and isinstance(tr.init().term, Blocks)


def test_seam_reads_and_writes_at_payload_shards_2():
    """The engine's seam on a 3 x 2 BlockState of random words: every
    read equals the same read of the whole state, and ``place_rows``
    puts each row's value on its row's blocks."""
    cfg = RaftConfig(n_replicas=3, entry_bytes=16, batch_size=4,
                     log_capacity=16, payload_shards=2, transport="tpu_mesh")
    tr = cpu_mesh(cfg, 2)
    st = tr.init()
    rng = np.random.default_rng(7)
    for g in range(6):
        blk = st.block(g)
        for f in FIELDS[:6]:
            getattr(blk, f).fill_(int(rng.integers(1, 99)) + 100 * (g // 2))
        blk.log_term.copy_(torch.from_numpy(
            rng.integers(0, 9, (1, 16)).astype(np.int32)))
        blk.log_payload.copy_(torch.from_numpy(
            rng.integers(-9, 9, (16, 2)).astype(np.int32)))
    whole = state_to_numpy(st)
    np.testing.assert_array_equal(tr.fetch_rows(st.last_index),
                                  whole["last_index"])
    assert int(tr.fetch_row(st.term, 2)) == whole["term"][2]
    lanes = tr.fetch_row_lanes(Blocks(p[None] for p in st.log_payload),
                               1, 0)
    np.testing.assert_array_equal(lanes, whole["log_payload"][:, 4:8])
    slots = [3, 0, 15]
    np.testing.assert_array_equal(tr.log_terms(st, slots),
                                  whole["log_term"][:, slots])
    np.testing.assert_array_equal(tr.log_terms(st, slots, 1),
                                  whole["log_term"][1, slots])
    win = tr.gather_window(st, [2, 0], 3, 5)            # slots 2..4
    np.testing.assert_array_equal(
        win.numpy(), np.concatenate([whole["log_payload"][2:5, 8:12],
                                     whole["log_payload"][2:5, 0:4]], 1))
    placed = tr.place_rows(np.array([5, 6, 7]), st.term)
    assert [int(t) for t in placed] == [5, 5, 6, 6, 7, 7]
    assert tr.commit_index(st, 1) == whole["commit_index"][1]
    assert tr.comm_host_copies() == 0


def test_lock_step_under_thread_switches():
    """16 blocks, more than this host's cores, a switch interval of 1 µs
    and 200 collectives each: every gather holds every block's value of
    that round (a lost or crossed deposit breaks the sums), within a
    time bound."""
    import sys
    import threading

    n, rounds = 16, 200
    ls = LockStep(["cpu"] * n)
    comms = [BlockComm(ls, g, n) for g in range(n)]

    def body(g):
        total = 0
        for i in range(rounds):
            got = comms[g].all_gather(torch.full((1,), 1000 * i + g))
            total += int(got.sum()) - 1000 * i * n
        return total

    out, old = {}, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: out.update(r=ls.run(body)))
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive(), "the lock step did not finish in 120 s"
    assert out["r"] == [rounds * sum(range(n))] * n
