"""Rank side of the port's mesh tests (tests/test_torch_mesh.py): a schedule
of transport calls, given as plain data, run on every rank of a spawned
gloo group through ``raft_tpu_torch.transport.MeshTransport`` on the CPU.
Each rank returns its own row's state leaves, the call's info and the
``core.step_mesh.LAST_DISPATCH`` witness after every stage, as numpy.

This module imports neither JAX nor the JAX package: the spawned ranks
import it."""

from __future__ import annotations

import numpy as np
import torch

import raft_tpu_torch.core.step_mesh as step_mesh
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.state import state_to_numpy
from raft_tpu_torch.northstar import run_device
from raft_tpu_torch.transport import MeshTransport, make_transport


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def apply_stage(tr, state, stage: dict):
    """One stage on a port transport (mesh or single device): returns
    (state, info), info a RepInfo/VoteInfo or a dict of tensors and host
    values. Payloads are whole folded batches [..., R*W]."""
    op = stage["op"]
    if op == "north_star":
        run = run_device(tr.cfg, stage["n"], stage["seed"], transport=tr,
                         state=state, rows=stage["rows"])
        return run.state, {"input": run.input_digest,
                           "rows": run.row_digests}
    alive = _t(stage["alive"], bool)
    if op == "vote":
        return tr.request_votes(state, stage["cand"], stage["term"], alive)
    slow = _t(stage["slow"], bool)
    member = None if stage.get("member") is None else _t(stage["member"],
                                                         bool)
    common = dict(member=member, term_floor=stage.get("term_floor"))
    if op == "replicate":
        payload = _t(stage["payload"])
        if stage.get("shard"):          # the rank's own lane block only
            payload = tr.shard_rows(payload)
        return tr.replicate(state, payload, stage["count"],
                            stage["leader"], stage["term"], alive, slow,
                            repair=stage.get("repair", True), **common)
    if op == "replicate_many":
        return tr.replicate_many(state, _t(stage["payloads"]),
                                 _t(stage["counts"], np.int32),
                                 stage["leader"], stage["term"], alive, slow,
                                 repair=stage.get("repair", True), **common)
    if op == "pipeline":
        return tr.replicate_pipeline(state, _t(stage["wins"]),
                                     _t(stage["counts"], np.int32),
                                     stage["leader"], stage["term"], alive,
                                     slow, **common)
    if op == "fused":
        state, infos, escaped, ran, halted = tr.replicate_fused(
            state, _t(stage["staging"]), stage["start"],
            _t(stage["counts"], np.int32), stage["n_run"],
            _t(stage["halted0"], bool), stage["leader"], stage["term"],
            alive, slow, member=member)
        return state, dict(infos._asdict(), escaped=escaped, ran=ran,
                           halted=halted)
    raise ValueError(f"unknown stage {op!r}")


def info_numpy(info) -> dict:
    """Host copies of an info's fields (tensors as numpy arrays)."""
    fields = info if isinstance(info, dict) else info._asdict()
    return {f: v.cpu().numpy().copy() if isinstance(v, torch.Tensor) else v
            for f, v in fields.items()}


def run_programs(rank: int, world: int, programs: dict) -> dict:
    """Every program {name: (config keywords, stages)} from a fresh cluster
    on this rank's ``MeshTransport`` (built through ``make_transport``,
    which must pick the mesh inside the group). Returns {name: [(leaves,
    info, dispatch) per stage]}."""
    torch.set_num_threads(1)
    results = {}
    for name, (cfg_kw, stages) in programs.items():
        tr = make_transport(RaftConfig(**cfg_kw, transport="tpu_mesh"),
                            device="cpu")
        assert isinstance(tr, MeshTransport) and tr.rank == rank, type(tr)
        state = tr.init()
        out = results[name] = []
        for stage in stages:
            step_mesh.LAST_DISPATCH = None
            state, info = apply_stage(tr, state, stage)
            leaves = {f: v.copy() for f, v in state_to_numpy(state).items()}
            out.append((leaves, info_numpy(info), step_mesh.LAST_DISPATCH))
    return results


def transport_kind(rank: int, world: int, cfg_kw: dict) -> str:
    """The class ``make_transport`` picks inside the group."""
    cfg = RaftConfig(**cfg_kw, transport="tpu_mesh")
    return type(make_transport(cfg, device="cpu")).__name__


def row_placement(rank: int, world: int, cfg_kw: dict):
    """A MeshTransport's ``local_row`` for every row, and row 0's commit
    index as every rank reads it (rank r's commit is 10 + r)."""
    tr = MeshTransport(RaftConfig(**cfg_kw, transport="tpu_mesh"),
                       device="cpu")
    st = tr.init()
    st.commit_index.fill_(10 + rank)
    return [tr.local_row(r) for r in range(world)], tr.commit_index(st, 0)


def fail_on(rank: int, world: int, bad: int) -> int:
    """Rank ``bad`` raises; the others return their rank."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def hang(rank: int, world: int, seconds: float) -> int:
    """Every rank outlives any short deadline."""
    import time

    time.sleep(seconds)
    return rank
