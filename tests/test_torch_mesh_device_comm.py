"""``MeshComm``'s flat collectives, the code the NCCL mesh runs on the
cards (one card a rank), held on the CPU.

Every collective of ``raft_tpu_torch.core.comm.MeshComm`` is one flat
all_gather or one broadcast that takes its operand where it lies; over
gloo a CPU operand takes that same code, so the spawned gloo ranks here
run the device path's code. One spawn of 6 ranks
(``tests/_mesh_ranks.py`` ``device_comm_rank``) runs the transport
programs at R = 3, P = 1 (ranks 0-2) and P = 2 (all six); after every
stage each rank's leaves and infos must equal the JAX package's
``TpuMeshTransport`` on its virtual CPU devices bit for bit, and every
host read of the transport (``fetch_rows``, ``fetch_row``,
``fetch_row_lanes``, ``gather_window``, ``gather_state``,
``commit_index``, ``log_terms``) the JAX mesh's final state.

A stand-in for ``torch.distributed`` that reports the ``"nccl"`` backend
records each collective's operand and output: no host copy comes before
a collective, each ``_host`` form makes exactly one copy after it, the
row and column subgroups take the world's backend while the digest group
stays gloo, and ``make_transport`` decides in an NCCL world as in a gloo
one. ``run_ranks(backend="nccl")`` refuses too few cards before any
spawn, ``initialize_multihost`` picks gloo on the CPU, and ``MeshComm``
refuses a third backend.
"""

import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.comm import MeshComm
from raft_tpu_torch.core.state import FIELDS
from raft_tpu_torch.transport.launch import run_ranks
from tests import _mesh_ranks as mr
from tests.test_torch_mesh import _check, _fused_scan, _pipeline
from tests.test_torch_mesh2d import _check_program, _mesh_programs
from tests.test_torch_mesh2d import _step_programs

B = 128
#: log indices [lo, hi] of the ring reads
WINDOW = (1, 12)


def _one_shard(programs):
    return {k: (dict(cfg, payload_shards=1), stages)
            for k, (cfg, stages) in programs.items()}


PROGRAMS1 = {**_one_shard(_mesh_programs(3)),
             "saturated_pipeline": (dict(n_replicas=3, entry_bytes=8,
                                         batch_size=B, log_capacity=1024),
                                    _pipeline(7, [False] * 3)),
             "fused_scan": (dict(n_replicas=3, entry_bytes=8, batch_size=B,
                                 log_capacity=1024), _fused_scan())}
PROGRAMS2 = {"matches_single_3": _mesh_programs(3)["matches_single_3"],
             **_step_programs()}


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_traces_after():
    """The JAX references trace ``TpuMeshTransport`` programs whose
    dispatch the JAX package's own tests witness at trace time; a later
    test in the same process must trace them afresh."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def ranks6():
    return run_ranks(mr.device_comm_rank, 6,
                     (PROGRAMS1, PROGRAMS2, WINDOW), timeout=300)


def _leaves(st):
    """A JAX mesh state's leaves, whole, as numpy arrays."""
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def _check_reads(reads, want, rows, W):
    """Every rank's host reads against the JAX mesh's whole state."""
    lo, hi = WINDOW
    slots = (np.arange(lo, hi + 1) - 1) % want["log_term"].shape[1]

    def words(r):
        return want["log_payload"][slots, r * W:(r + 1) * W]

    for g, got in enumerate(reads):
        msg = f"rank {g}"
        np.testing.assert_array_equal(got["fetch_rows"], want["last_index"],
                                      msg)
        assert got["commit_index"] == want["commit_index"].tolist(), msg
        np.testing.assert_array_equal(got["log_terms"],
                                      want["log_term"][:, slots], msg)
        for r in range(rows):
            np.testing.assert_array_equal(got["log_terms_row"][r],
                                          want["log_term"][r, slots], msg)
            np.testing.assert_array_equal(got["entry_words"][r], words(r),
                                          f"{msg} replica {r}")
        np.testing.assert_array_equal(
            got["gather_window"],
            np.concatenate([words(rows - 1), words(0)], axis=1), msg)
        for f in FIELDS:
            np.testing.assert_array_equal(got["gather_state"][f], want[f],
                                          f"{msg} gather_state.{f}")


@pytest.mark.parametrize("name", sorted(PROGRAMS1))
def test_flat_path_matches_jax_mesh_one_shard(ranks6, name):
    """R = 3, P = 1: every stage's leaves and infos, then every read."""
    cfg_kw, stages = PROGRAMS1[name]
    st = _check([o["p1"] for o in ranks6[:3]], name, cfg_kw, stages)
    W = RaftConfig(**cfg_kw).shard_words
    _check_reads([o["reads1"][name] for o in ranks6[:3]], _leaves(st), 3,
                 W)


@pytest.mark.parametrize("name", sorted(PROGRAMS2))
def test_flat_path_matches_jax_mesh_two_shards(ranks6, name):
    """R = 3, P = 2: every stage's leaves and infos, then every read
    (the lanes stitched over the row groups)."""
    cfg_kw, stages = PROGRAMS2[name]
    st = _check_program([{"programs": o["p2"]} for o in ranks6], name,
                        cfg_kw, stages)
    W = RaftConfig(**cfg_kw).shard_words
    _check_reads([o["reads2"][name] for o in ranks6], _leaves(st), 3, W)


class FakeNccl:
    """A stand-in for ``torch.distributed`` in a world of ``size`` ranks
    reporting ``backend``: rank ``rank``; ``new_group`` records its
    ranks, backend and timeout; every all_gather and broadcast records
    its operand, its output and ``comm.host_copies`` when it ran (the
    comm is set once built). Rank k's gathered value is the operand plus
    k."""

    def __init__(self, monkeypatch, size=6, rank=4, backend="nccl"):
        self.size, self.rank, self.backend = size, rank, backend
        self.groups, self.calls, self.comm = [], [], None
        for name in ("get_world_size", "get_backend", "get_rank",
                     "get_process_group_ranks", "new_group",
                     "get_global_rank", "all_gather_into_tensor",
                     "broadcast", "is_initialized"):
            monkeypatch.setattr(dist, name, getattr(self, name))
        monkeypatch.setattr(dist, "all_gather_single",
                            self.all_gather_into_tensor, raising=False)

    def get_world_size(self, group=None):
        return self.size if group is None else len(group["ranks"])

    def get_backend(self, group=None):
        return self.backend if group is None else group["backend"]

    def get_rank(self, group=None):
        return self.rank if group is None else group["ranks"].index(
            self.rank)

    def get_process_group_ranks(self, group):
        return group["ranks"]

    def is_initialized(self):
        return True

    def new_group(self, ranks=None, backend=None, timeout=None):
        g = {"ranks": list(range(self.size)) if ranks is None
             else list(ranks), "backend": backend or self.backend,
             "timeout": timeout}
        self.groups.append(g)
        return g

    def get_global_rank(self, group, rank):
        return group["ranks"][rank]

    def _copies(self):
        return None if self.comm is None else self.comm.host_copies

    def all_gather_into_tensor(self, out, src, group=None):
        self.calls.append(("all_gather", src, out, self._copies(), group))
        for k in range(out.shape[0]):
            out[k:k + 1] = src + k

    def broadcast(self, buf, src=0, group=None):
        self.calls.append(("broadcast", buf, buf, self._copies(), group))


def _comm(monkeypatch, backend="nccl"):
    fake = FakeNccl(monkeypatch, backend=backend)
    fake.comm = MeshComm(3, payload_shards=2,
                         exchange_timeout_s=7.0)
    return fake, fake.comm


def test_nccl_groups_take_the_world_backend(monkeypatch):
    """At P = 2 the column and row subgroups take NCCL, the digest group
    gloo with the exchange timeout, created in one order."""
    fake, comm = _comm(monkeypatch)
    assert comm.backend == "nccl"
    assert [(g["ranks"], g["backend"]) for g in fake.groups] == [
        ([0, 2, 4], "nccl"), ([1, 3, 5], "nccl"),
        ([0, 1], "nccl"), ([2, 3], "nccl"), ([4, 5], "nccl"),
        ([0, 1, 2, 3, 4, 5], "gloo")]
    assert fake.groups[-1]["timeout"] == datetime.timedelta(seconds=7.0)
    assert (comm.rank, comm.pshard) == (2, 0)
    assert comm.group is fake.groups[0] and \
        comm._row_group is fake.groups[4]


def _shares(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


@pytest.mark.parametrize("form", ["all_gather", "all_gather_host",
                                  "all_gather_plane", "select_row",
                                  "leader_cols"])
def test_nccl_gather_takes_the_operand_where_it_lies(monkeypatch, form):
    """The operand itself reaches the collective (no copy, no host copy
    before it); the device forms make no host copy after it, the host
    form exactly one, into a buffer of its own."""
    fake, comm = _comm(monkeypatch)
    x = torch.arange(6, dtype=torch.int32).reshape(1, 6) + 10
    before = comm.host_copies
    if form == "leader_cols":
        got = comm.leader_cols(x, 1, 6)      # a window of one row
        want = x + 1
    elif form == "select_row":
        got = comm.select_row(x, torch.tensor(2))
        want = x[0] + 2
    else:
        got = getattr(comm, form)(x)
        want = torch.cat([x + k for k in range(3)])
    (op, src, out, copies, group), = fake.calls
    assert op == "all_gather" and group is comm.group
    assert _shares(src, x) and copies == before
    assert torch.equal(got, want)
    host = form == "all_gather_host"
    assert comm.host_copies - before == int(host)
    if form.startswith("all_gather"):   # the others pick a row of it
        assert _shares(got, out) != host
    assert comm.collectives == 1 and comm.device_copies == 0


def test_nccl_bool_travels_as_uint8(monkeypatch):
    fake, comm = _comm(monkeypatch)
    got = comm.all_gather(torch.tensor([True]))
    assert fake.calls[0][1].dtype == torch.uint8
    assert got.dtype == torch.bool and got.tolist() == [True] * 3


@pytest.mark.parametrize("lanes", [False, True])
def test_nccl_broadcast_host_copies_once(monkeypatch, lanes):
    """``broadcast_host``: a device copy broadcast into (from row 1's
    global rank), no host copy before it; with ``lanes`` the row
    group's gather after it; then one host copy."""
    fake, comm = _comm(monkeypatch)
    x = torch.arange(4, dtype=torch.int32)
    got = comm.broadcast_host(x, 1, lanes=lanes)
    op, buf, _, copies, group = fake.calls[0]
    assert op == "broadcast" and group is comm.group and copies == 0
    assert torch.equal(buf, x) and not _shares(buf, x)
    assert len(fake.calls) == 1 + lanes
    if lanes:
        assert fake.calls[1][4] is comm._row_group and \
            fake.calls[1][3] == 0
        assert torch.equal(got, torch.cat([x, x + 1]))
    else:
        assert torch.equal(got, x)
    assert comm.host_copies == 1 and not _shares(got, fake.calls[-1][2])


@pytest.mark.parametrize("host", [False, True])
def test_nccl_gather_lanes(monkeypatch, host):
    """``gather_lanes``: one gather over the column, the rows picked, one
    over the row group, the lanes stitched in slice order; one host copy
    with ``host`` and none without; ``all_gather_lanes`` the row gather
    and one copy."""
    fake, comm = _comm(monkeypatch)
    x = torch.arange(4, dtype=torch.int32).reshape(1, 2, 2)
    got = comm.gather_lanes(x, [2, 0], host=host)
    assert [c[4] for c in fake.calls] == [comm.group, comm._row_group]
    assert [c[3] for c in fake.calls] == [0, 0]
    rows = torch.stack([x[0] + 2, x[0]])
    assert torch.equal(got, torch.cat([rows, rows + 1], -1))
    assert comm.host_copies == int(host)
    lanes = comm.all_gather_lanes(x[0])
    assert torch.equal(lanes, torch.cat([x[0], x[0] + 1], -1))
    assert comm.host_copies == int(host) + 1
    assert (comm.collectives, comm.row_collectives) == (1, 2)


def test_nccl_host_once_copies_once(monkeypatch):
    fake, comm = _comm(monkeypatch)
    x = torch.arange(3)
    got = comm.host_once(x)
    assert torch.equal(got, x) and not _shares(got, x)
    assert comm.host_copies == 1 and not fake.calls


def test_gloo_cpu_operand_takes_the_flat_path(monkeypatch):
    """Over gloo a CPU operand is not staged: it reaches the collective
    itself, as under NCCL."""
    fake, comm = _comm(monkeypatch, backend="gloo")
    x = torch.ones(1, 3, dtype=torch.int32)
    comm.all_gather(x)
    assert _shares(fake.calls[0][1], x) and comm.host_copies == 0
    assert comm.all_gather_plane(x).shape == (3, 3)
    assert comm.host_copies == 0 and comm.device_copies == 0


@pytest.mark.parametrize("backend", ["mpi", "ucc", "cuda:nccl,cpu:gloo"])
def test_mesh_comm_refuses_a_third_backend(monkeypatch, backend):
    FakeNccl(monkeypatch, backend=backend)
    with pytest.raises(ValueError, match=f"gloo or an nccl group, got "
                                         f"'{backend}'"):
        MeshComm(3, payload_shards=2)


KW = dict(entry_bytes=16, batch_size=4, log_capacity=64)


@pytest.mark.parametrize("case", [
    dict(KW, n_replicas=3, payload_shards=2, transport="tpu_mesh"),
    dict(KW, n_replicas=3, max_replicas=4, payload_shards=2,
         transport="tpu_mesh"),
    dict(KW, n_replicas=3, payload_shards=2, transport="multihost"),
    dict(KW, n_replicas=4, payload_shards=2, transport="tpu_mesh")])
def test_make_transport_decides_alike_under_nccl(monkeypatch, case):
    """In a world of 6 ranks ``make_transport`` gives the same transport,
    or raises the same text, whichever backend the world has; under NCCL
    the transport's device is the rank's card."""
    from raft_tpu_torch.transport import make_transport

    got = {}
    for backend in ("gloo", "nccl"):
        FakeNccl(monkeypatch, backend=backend)
        try:
            t = make_transport(RaftConfig(**case), device="cuda:4")
            got[backend] = (type(t).__name__, str(t.device))
        except ValueError as ex:
            got[backend] = f"ValueError: {ex}"
    assert got["gloo"] == got["nccl"]


def test_nccl_transport_refuses_the_cpu(monkeypatch):
    from raft_tpu_torch.transport import MeshTransport

    FakeNccl(monkeypatch, size=3, rank=1)
    with pytest.raises(ValueError, match="on the ranks' cards, got device "
                                         "'cpu'"):
        MeshTransport(RaftConfig(n_replicas=3, **KW), device="cpu")


def test_run_ranks_nccl_refuses_too_few_cards(monkeypatch):
    """No spawn: the text names the ranks and the visible cards; a third
    backend is refused too."""
    import torch.multiprocessing as mp

    def no_spawn(*a, **k):
        raise AssertionError("run_ranks spawned")

    monkeypatch.setattr(mp, "get_context", no_spawn)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match=r"NCCL group of 3 ranks needs "
                                           r"one card a rank: 2 visible"):
        run_ranks(mr.fail_on, 3, (1,), backend="nccl")
    with pytest.raises(ValueError, match="gloo or an nccl group, got 'mpi'"):
        run_ranks(mr.fail_on, 3, (1,), backend="mpi")


def test_initialize_multihost_picks_gloo_on_the_cpu(monkeypatch):
    """``backend=None`` takes JAX's rule: gloo where no card is visible
    (the group is joined with it), and an NCCL rank needs a card."""
    from raft_tpu_torch.transport import multihost

    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    multihost.initialize_multihost("tcp://localhost:1", num_processes=3,
                                   process_id=2)
    (backend, kw), = seen
    assert backend == "gloo" and kw["rank"] == 2 and "device_id" not in kw
    with pytest.raises(RuntimeError, match="local rank 2 of 0 visible"):
        multihost.initialize_multihost("tcp://localhost:1",
                                       num_processes=3, process_id=2,
                                       backend="nccl")
    assert len(seen) == 1
