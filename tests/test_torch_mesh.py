"""The port's replica mesh (raft_tpu_torch.transport.MeshTransport over
MeshComm, the general path on one local row with K1, and K2-K4·mesh
through core.step_mesh) against the JAX package's ``TpuMeshTransport``.

The port runs on spawned gloo ranks on the CPU (3, and 5 for the EC
shards), once per module; the JAX package runs the same schedules under
``shard_map`` on its virtual CPU devices with the Pallas kernels in
interpret mode, as tests/test_step_mesh.py does. After every stage each
rank's state leaves must equal its row of the JAX mesh state (``cut_row``)
and its RepInfo/VoteInfo the JAX one, bit for bit, and the port's
``LAST_DISPATCH`` witness must name the mesh entry point that ran.

Schedules: the multichip dry run's ladder (``__graft_entry__.py:349-425``,
its ``_kernel_cfg`` shapes) extended by a scan and a slow-row heal,
``test_mesh_fused_scan_matches_single``,
``TestMeshPipeline.test_saturated_pipeline_matches_single`` and
``test_mesh_fused_ec_shards``. The JAX package runs its lap-turnover,
slow-follower, infeasible and member-shrunk mesh variants in its slow
tier; so do the port's, against the JAX ``SingleDeviceTransport`` rows
(tests/test_step_mesh.py pins the JAX mesh to those)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core.state import fold_batch as jfold_batch
from raft_tpu.core.state import fold_rows as jfold_rows
from raft_tpu.transport import SingleDeviceTransport as JSingle
from raft_tpu.transport import TpuMeshTransport
from raft_tpu_torch.core.state import FIELDS, cut_row, stack_rows
from raft_tpu_torch.transport.launch import run_ranks
from tests._mesh_ranks import fail_on, hang, row_placement, run_programs
from tests._torch_port import pallas_interpret

B = 128
ALL3, OK3 = [True] * 3, [False] * 3


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_traces_after():
    """The JAX references below trace ``TpuMeshTransport`` programs whose
    dispatch the JAX package's own tests witness at trace time
    (``tests/test_step_mesh.py``, ``step_mesh.LAST_DISPATCH``); a later
    test in the same process must trace them afresh, so JAX's caches are
    cleared when this module ends."""
    yield
    jax.clear_caches()


def _batch(seed, count, rows, entry=8):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (B, entry), dtype=np.uint8)
    data[count:] = 0
    return np.asarray(jfold_batch(data, rows))


def _rows_batch(seed, rows, entry):
    """Distinct bytes per replica block, as the dry run's ``fold_rows``."""
    rng = np.random.default_rng(seed)
    return np.asarray(jfold_rows(rng.integers(0, 256, (rows, B, entry),
                                              dtype=np.uint8)))


def _rep(payload, count, slow=OK3, dispatch=None, leader=0, term=1,
         alive=ALL3, **kw):
    return dict(op="replicate", payload=payload, count=count, leader=leader,
                term=term, alive=alive, slow=slow, dispatch=dispatch, **kw)


def _ladder():
    """The dry run's phases at ``_kernel_cfg`` (B=128, C=1024, 256-byte
    entries), then a scan, a slow row, and its heal by repair ticks."""
    pay = _rows_batch(0, 3, 256)
    slow2 = [False, False, True]
    return [
        dict(op="vote", cand=0, term=1, alive=ALL3, dispatch=None),
        _rep(pay, B, shard=True),                           # general, K1
        _rep(pay, B, repair=False, term_floor=1, dispatch="step"),
        dict(op="pipeline", wins=np.stack([pay] * 4), counts=[B] * 4,
             leader=0, term=1, alive=ALL3, slow=OK3, term_floor=1,
             dispatch="pipeline"),
        dict(op="replicate_many",
             payloads=np.stack([_rows_batch(10 + t, 3, 256)
                                for t in range(2)]),
             counts=[B, 77], leader=0, term=1, alive=ALL3, slow=slow2,
             repair=False, term_floor=1, dispatch="scan"),
        _rep(_rows_batch(20, 3, 256), 0),                   # heal row 2
        _rep(_rows_batch(21, 3, 256), 0),
        dict(op="vote", cand=1, term=2, alive=[False, True, True],
             dispatch=None),
        _rep(_rows_batch(22, 3, 256), 50, alive=[False, True, True],
             leader=1, term=2),
    ]


def _fused_scan():
    """tests/test_step_mesh.py::test_mesh_fused_scan_matches_single, then
    K steady ticks with exact early exit (``replicate_fused``: a partial
    count escapes at its tick, ``n_run`` masks the tail)."""
    rng = np.random.default_rng(300)
    staging = rng.integers(-2**31, 2**31, (3, B, 2), dtype=np.int64) \
        .astype(np.int32)
    return [
        dict(op="vote", cand=0, term=1, alive=ALL3, dispatch=None),
        dict(op="replicate_many",
             payloads=np.stack([_batch(100 + t, B, 3) for t in range(5)]),
             counts=[B] * 5, leader=0, term=1, alive=ALL3, slow=OK3,
             repair=False, term_floor=1, dispatch="scan"),
        dict(op="fused", staging=staging, start=2, counts=[B, B, 50, B],
             n_run=4, halted0=False, leader=0, term=1, alive=ALL3, slow=OK3,
             dispatch=None),
        dict(op="fused", staging=staging, start=1, counts=[B] * 4, n_run=3,
             halted0=False, leader=0, term=1, alive=ALL3,
             slow=[False, False, True], dispatch=None),
    ]


def _pipeline(T, slow, seed0=200, rows=3, member=None):
    """TestMeshPipeline._run_both's schedule: one flight after the vote."""
    return [
        dict(op="vote", cand=0, term=1, alive=[True] * rows, dispatch=None),
        dict(op="pipeline",
             wins=np.stack([_batch(seed0 + t, B, rows) for t in range(T)]),
             counts=[B] * T, leader=0, term=1, alive=[True] * rows,
             slow=slow, member=member, term_floor=1, dispatch="pipeline"),
    ]


def _ec_shards():
    """tests/test_step_mesh.py::test_mesh_fused_ec_shards: a K7-encoded
    window (every row its own RS(5,3) shard) through the fused step."""
    from raft_tpu.ec.kernels import encode_fold_device
    from raft_tpu.ec.rs import RSCode

    raw = np.random.default_rng(42).integers(0, 256, (B, 24), np.uint8)
    win = np.asarray(encode_fold_device(RSCode(5, 3), jnp.asarray(raw)))
    return [
        dict(op="vote", cand=0, term=1, alive=[True] * 5, dispatch=None),
        dict(op="replicate", payload=win, count=B, leader=0, term=1,
             alive=[True] * 5, slow=[False] * 5, repair=False, term_floor=1,
             dispatch="step"),
    ]


KERNEL_CFG = dict(n_replicas=3, entry_bytes=256, batch_size=B,
                  log_capacity=1024)
SMALL = dict(n_replicas=3, entry_bytes=8, batch_size=B, log_capacity=1024)
EC_CFG = dict(n_replicas=5, entry_bytes=24, batch_size=B, log_capacity=512,
              rs_k=3, rs_m=2)

NORTH_STAR = dict(n_replicas=3, entry_bytes=8, batch_size=B,
                  log_capacity=32 * B)

PROGRAMS3 = {
    "ladder": (KERNEL_CFG, _ladder()),
    "fused_scan": (SMALL, _fused_scan()),
    "saturated_pipeline": (SMALL, _pipeline(7, OK3)),
    "north_star": (NORTH_STAR, [
        dict(op="vote", cand=0, term=1, alive=ALL3, dispatch=None),
        dict(op="north_star", n=2 * 32 * B + 300, seed=11, rows=(1, 2),
             dispatch="pipeline")]),
}
SLOW_PROGRAMS3 = {
    "turnover_laps": (dict(SMALL, log_capacity=256), _pipeline(7, OK3)),
    "slow_follower": (SMALL, _pipeline(5, [False, False, True])),
    "infeasible": (SMALL, _pipeline(5, [False, True, True])),
    "member_shrunk": (dict(SMALL, max_replicas=3),
                      _pipeline(5, OK3, member=[True, False, False])),
}


@pytest.fixture(scope="module")
def ranks3():
    return run_ranks(run_programs, 3, (PROGRAMS3,), timeout=240)


@pytest.fixture(scope="module")
def ranks5():
    return run_ranks(run_programs, 5, ({"ec": (EC_CFG, _ec_shards())},),
                     timeout=240)


@pytest.fixture(scope="module")
def slow_ranks3():
    return run_ranks(run_programs, 3, (SLOW_PROGRAMS3,), timeout=240)


def _j_apply(tr, st, stage):
    alive = jnp.asarray(stage["alive"])
    if stage["op"] == "vote":
        return tr.request_votes(st, stage["cand"], stage["term"], alive)
    kw = dict(member=None if stage.get("member") is None
              else jnp.asarray(stage["member"]),
              term_floor=stage.get("term_floor"))
    args = (stage["leader"], stage["term"], alive, jnp.asarray(stage["slow"]))
    if stage["op"] == "replicate":
        return tr.replicate(st, jnp.asarray(stage["payload"]), stage["count"],
                            *args, repair=stage.get("repair", True), **kw)
    if stage["op"] == "replicate_many":
        return tr.replicate_many(st, jnp.asarray(stage["payloads"]),
                                 jnp.asarray(stage["counts"], jnp.int32),
                                 *args, repair=stage.get("repair", True),
                                 **kw)
    if stage["op"] == "fused":
        st, infos, escaped, ran, halted = tr.replicate_fused(
            st, jnp.asarray(stage["staging"]), stage["start"],
            jnp.asarray(stage["counts"], jnp.int32), stage["n_run"],
            jnp.asarray(stage["halted0"]), *args, member=kw["member"])
        return st, dict(infos._asdict(), escaped=escaped, ran=ran,
                        halted=halted)
    return tr.replicate_pipeline(st, jnp.asarray(stage["wins"]),
                                 jnp.asarray(stage["counts"], jnp.int32),
                                 *args, **kw)


def _check(results, name, cfg_kw, stages, reference="mesh"):
    """Run ``stages`` through the JAX transport and hold every rank's
    results against it, stage by stage."""
    cfg = JConfig(**cfg_kw)
    R = cfg.rows
    with pallas_interpret():
        tr = (TpuMeshTransport(cfg, jax.devices()[:R]) if reference == "mesh"
              else JSingle(cfg))
        st = tr.init()
        for i, stage in enumerate(stages):
            st, info = _j_apply(tr, st, stage)
            want = {f: np.asarray(getattr(st, f)) for f in FIELDS}
            for r in range(R):
                leaves, tinfo, dispatch = results[r][name][i]
                msg = f"{name} stage {i} ({stage['op']}) rank {r}"
                assert dispatch == stage["dispatch"], msg
                cut = cut_row(want, r)
                for f in FIELDS:
                    assert leaves[f].dtype == np.int32, f"{msg} {f}"
                    np.testing.assert_array_equal(leaves[f], cut[f],
                                                  f"{msg} state.{f}")
                fields = info if isinstance(info, dict) else info._asdict()
                assert sorted(tinfo) == sorted(fields), msg
                for f, v in fields.items():
                    jv = np.asarray(v)
                    assert tinfo[f].dtype == jv.dtype, f"{msg} info.{f}"
                    np.testing.assert_array_equal(tinfo[f], jv,
                                                  f"{msg} info.{f}")
    return st


def test_dry_run_ladder_matches_jax_mesh(ranks3):
    st = _check(ranks3, "ladder", *PROGRAMS3["ladder"])
    assert int(np.asarray(st.commit_index)[1]) == 7 * B + 127
    assert np.asarray(st.last_index).tolist() == [7 * B + 77, 7 * B + 127,
                                                  7 * B + 127]


def test_fused_scan_matches_jax_mesh(ranks3):
    st = _check(ranks3, "fused_scan", *PROGRAMS3["fused_scan"])
    assert int(np.asarray(st.commit_index)[0]) == 11 * B + 50


def test_saturated_pipeline_matches_jax_mesh(ranks3):
    st = _check(ranks3, "saturated_pipeline",
                *PROGRAMS3["saturated_pipeline"])
    assert (np.asarray(st.commit_index) == 7 * B).all()


def test_north_star_run_on_the_mesh(ranks3):
    """``northstar.run_device`` driven on every rank: each follower rank
    reads its own committed bytes back to the input's SHA-256, and every
    rank's row equals the resident run of the same stream."""
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.core.state import state_to_numpy
    from raft_tpu_torch.northstar import run_device
    from raft_tpu_torch.transport import SingleDeviceTransport

    cfg_kw, stages = PROGRAMS3["north_star"]
    tr = SingleDeviceTransport(RaftConfig(**cfg_kw, transport="single"),
                               device="cpu")
    st, _ = tr.request_votes(tr.init(), 0, 1, np.ones(3, bool))
    stage = stages[1]
    run = run_device(tr.cfg, stage["n"], stage["seed"], transport=tr,
                     state=st, rows=(1, 2))
    want = state_to_numpy(run.state)
    for r in range(3):
        leaves, info, dispatch = ranks3[r]["north_star"][1]
        assert dispatch == "pipeline"
        assert info["input"] == run.input_digest
        assert info["rows"] == ({r: run.row_digests[r]} if r else {})
        cut = cut_row(want, r)
        for f in FIELDS:
            np.testing.assert_array_equal(leaves[f], cut[f], f"rank {r} {f}")
    assert run.row_digests[1] == run.row_digests[2] == run.input_digest


def test_ec_shards_match_jax_mesh(ranks5):
    st = _check(ranks5, "ec", EC_CFG, _ec_shards())
    assert (np.asarray(st.commit_index) == B).all()


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SLOW_PROGRAMS3))
def test_pipeline_variant_matches_jax_rows(slow_ranks3, name):
    _check(slow_ranks3, name, *SLOW_PROGRAMS3[name], reference="single")


def test_cut_row_and_stack_rows_round_trip():
    rng = np.random.default_rng(5)
    R, C, W = 3, 16, 4
    whole = {f: rng.integers(-9, 9, (R,)).astype(np.int32)
             for f in FIELDS[:6]}
    whole["log_term"] = rng.integers(0, 9, (R, C)).astype(np.int32)
    whole["log_payload"] = rng.integers(0, 9, (C, R * W)).astype(np.int32)
    rows = [cut_row(whole, r) for r in range(R)]
    assert rows[1]["log_term"].shape == (1, C)
    assert rows[1]["log_payload"].shape == (C, W)
    np.testing.assert_array_equal(rows[2]["log_payload"],
                                  whole["log_payload"][:, 2 * W:])
    back = stack_rows(rows)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], whole[f], f)
        assert back[f].dtype == np.int32


def test_a_failed_or_hung_rank_fails_the_run():
    """A rank's exception, or ranks still running at the deadline, end
    ``run_ranks`` with an error naming them; every rank is stopped."""
    with pytest.raises(RuntimeError, match="rank 1 exited") as err:
        run_ranks(fail_on, 2, (1,), timeout=120)
    assert "fails on purpose" in str(err.value)
    with pytest.raises(RuntimeError, match="still running after 3 s"):
        run_ranks(hang, 2, (120,), timeout=3)


def test_mesh_comm_takes_a_gloo_group_only(monkeypatch):
    """The mesh has run only over gloo; a group of another backend is
    refused before any collective."""
    import torch.distributed as dist

    from raft_tpu_torch.core.comm import MeshComm

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="gloo group, got 'nccl'"):
        MeshComm(3)


def test_transport_places_rows():
    """``local_row``/``commit_index``: the resident layout holds every row
    at its own index; a mesh rank holds its own row only, and every rank
    reads row 0's commit from rank 0."""
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.transport import SingleDeviceTransport

    kw = dict(n_replicas=3, entry_bytes=8, batch_size=B, log_capacity=256)
    tr = SingleDeviceTransport(RaftConfig(**kw), device="cpu")
    st = tr.init()
    st.commit_index[:] = torch.tensor([7, 5, 6], dtype=torch.int32)
    assert [tr.local_row(r) for r in range(3)] == [0, 1, 2]
    assert [tr.commit_index(st, r) for r in range(3)] == [7, 5, 6]
    assert run_ranks(row_placement, 3, (kw,), timeout=120) == [
        ([0, None, None], 10), ([None, 0, None], 10), ([None, None, 0], 10)]
