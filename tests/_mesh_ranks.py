"""Rank side of the port's mesh tests: for tests/test_torch_mesh.py a
schedule of transport calls, given as plain data, run on every rank of a
spawned gloo group through ``raft_tpu_torch.transport.MeshTransport`` on
the CPU (each rank returns its own row's state leaves, the call's info and
the ``core.step_mesh.LAST_DISPATCH`` witness after every stage, as numpy);
for tests/test_torch_engine_mesh.py the engine scenarios (``SCENARIOS``)
that the mirrored ranks, the JAX engine and the port's single-device
engine all run; for tests/test_torch_multihost.py the multihost ranks;
for tests/test_torch_mesh2d.py the 2-D mesh's ranks (``mesh2d_rank``).

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
    which must pick the mesh inside the group; on the 2-D mesh the config
    names ``payload_shards``). Returns {name: [(leaves, info, dispatch)
    per stage]}."""
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


# ----------------------------------------------------------------- engine
# The engine over the mesh (tests/test_torch_engine_mesh.py and
# tests/test_torch_multihost.py): scenarios written once against the
# engine API, run by the port's mirrored engines on the ranks here and by
# the JAX engine on ``TpuMeshTransport`` and the port's single-device
# engine in the test process. ``make(over, restore=, recorder=,
# vote_log=)`` builds an engine of the environment (its nodelog lines in
# ``e.lines``); ``ops`` does the package-specific reads.

def payloads(n, entry=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, entry, dtype=np.uint8).tobytes()
            for _ in range(n)]


class PortOps:
    """The port's reads for the shared scenarios: through the engine's
    transport, so on the mesh every read of another row is the gathering
    fetch every rank makes."""

    def rows(self, e, leaf):
        return e._rows(getattr(e.state, leaf))

    def committed(self, e, r):
        from raft_tpu_torch.core.state import committed_payloads

        return [bytes(p) for p in committed_payloads(e.state, r, e.t)]

    def log_entries(self, e, r, lo, hi):
        from raft_tpu_torch.core.state import log_entries

        return [bytes(p) for p in log_entries(e.state, r, lo, hi, e.t)]

    def reconstruct(self, e, rows, lo, hi):
        from raft_tpu_torch.ec.reconstruct import reconstruct
        from raft_tpu_torch.ec.rs import RSCode

        code = RSCode(e.cfg.rows, e.cfg.rs_k)
        return [bytes(p) for p in reconstruct(e.state, code, rows, lo, hi,
                                               e.t)]

    def packed(self, e):
        from raft_tpu_torch.obs.device import packed_flush

        return e._fetch(packed_flush(e._dev_ring))

    def whole(self, e):
        return e.t.gather_state(e.state)

    def recorder(self):
        from raft_tpu_torch.obs import FlightRecorder

        return FlightRecorder()


def _committed_tail(e, ops):
    """The committed entries every live holder still serves (None when no
    replica retains the window)."""
    wm = e.commit_watermark
    if wm == 0:
        return []
    lo = max(1, wm - e.cfg.log_capacity + 1)
    try:
        return [bytes(p) for p in e.committed_entries(lo, wm)]
    except ValueError as ex:
        return str(ex)


def final_obs(e, ops) -> dict:
    """What every environment must agree on at a scenario's end."""
    return dict(lines=list(e.lines), terms=[int(x) for x in e.terms],
                roles=list(e.roles), wm=int(e.commit_watermark),
                leader=e.leader_id, whole=ops.whole(e),
                tail=_committed_tail(e, ops))


def _ckpt_members(path) -> dict:
    """The checkpoint's members, uncompressed (the zip's own timestamps
    differ between writers; its arrays must not)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def sc_submit(make, ops, tmp):
    e = make(dict(seed=1))
    e.run_until_leader()
    ps = payloads(10)
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    return dict(ps=ps, got=[ops.committed(e, r)[:10] for r in range(3)]), e


def sc_failover(make, ops, tmp):
    e = make(dict(seed=4))
    lead = e.run_until_leader()
    ps = payloads(5, seed=9)
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    e.fail(lead)
    e.run_until_leader()
    e.run_for(10 * e.cfg.heartbeat_period)
    return dict(ps=ps, got=ops.committed(e, e.leader_id)[:5]), e


def sc_slow_heal(make, ops, tmp):
    e = make(dict(seed=2))
    lead = e.run_until_leader()
    slow = (lead + 1) % 3
    e.set_slow(slow, True)
    seqs = [e.submit(p) for p in payloads(6, seed=5)]
    e.run_until_committed(seqs[-1])
    before = int(ops.rows(e, "match_index")[slow])
    wm = e.commit_watermark
    e.set_slow(slow, False)
    e.run_for(3 * e.cfg.heartbeat_period)
    return dict(before=before, wm=wm,
                after=int(ops.rows(e, "match_index")[slow])), e


def sc_lapped(make, ops, tmp):
    e = make(dict(seed=3, log_capacity=16))
    lead = e.run_until_leader()
    dead = (lead + 1) % 3
    e.fail(dead)
    ps = payloads(48, seed=6)
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    e.recover(dead)
    e.run_for(8 * e.cfg.heartbeat_period)
    lo = e.commit_watermark - 16 + 1
    return dict(match=int(ops.rows(e, "match_index")[dead]),
                want=ps[lo - 1:e.commit_watermark],
                got=ops.log_entries(e, dead, lo, e.commit_watermark)), e


EC = dict(n_replicas=5, entry_bytes=24, rs_k=3, rs_m=2)


def sc_ec_roundtrip(make, ops, tmp):
    e = make(dict(EC, seed=1))
    e.run_until_leader()
    ps = payloads(12, entry=24, seed=2)
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    return dict(ps=ps, got=[ops.reconstruct(e, rows, 1, 12) for rows in
                            ([0, 1, 2], [2, 3, 4], [0, 2, 4])]), e


def sc_ec_heal(make, ops, tmp):
    e = make(dict(EC, seed=4))
    lead = e.run_until_leader()
    slow = (lead + 2) % 5
    e.set_slow(slow, True)
    ps = payloads(8, entry=24, seed=6)
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    before = int(ops.rows(e, "match_index")[slow])
    e.set_slow(slow, False)
    e.run_for(2 * e.cfg.heartbeat_period)
    rows = [slow] + [q for q in range(5) if q != slow][:2]
    return dict(ps=ps, before=before,
                after=int(ops.rows(e, "match_index")[slow]),
                got=ops.reconstruct(e, rows, 1, 8)), e


def sc_membership(make, ops, tmp, rows=5):
    e = make(dict(max_replicas=rows, log_capacity=256, seed=11))
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(6, seed=12)]
    e.run_until_committed(seqs[-1])
    s_add = e.add_voter(3)
    e.run_until_committed(s_add)
    added = (bool(e.member[3]), int(e.member.sum()))
    mid = [e.submit(p) for p in payloads(4, seed=13)]
    e.run_until_committed(mid[-1])
    e.run_for(6 * e.cfg.heartbeat_period)
    joiner = (int(ops.rows(e, "commit_index")[3]), e.commit_watermark)
    e.fail((e.leader_id + 1) % 3)
    probe = e.submit(payloads(1, seed=14)[0])
    e.run_until_committed(probe)
    e.recover((e.leader_id + 1) % 3)
    s_rm = e.remove_server(3)
    e.run_until_committed(s_rm)
    removed = (bool(e.member[3]), int(e.member.sum()))
    tail = [e.submit(p) for p in payloads(2, seed=15)]
    e.run_until_committed(tail[-1])
    return dict(added=added, joiner=joiner, removed=removed,
                committed=[ops.committed(e, r) for r in range(rows)],
                leader=e.leader_id), e


def sc_restart(make, ops, tmp):
    import os

    over = dict(log_capacity=64)
    vlog = os.path.join(tmp, "votes.log")     # this rank's own vote log
    e = make(over, vote_log=vlog)
    e.run_until_leader()
    pre = payloads(10, seed=11)
    seqs = [e.submit(p) for p in pre]
    e.run_until_committed(seqs[-1])
    with open(vlog, "rb") as f:
        votes = f.read()
    path = os.path.join(tmp, "mesh.npz")
    e.save_checkpoint(path)
    e2 = make(over, restore=path, vote_log=vlog)
    restored = [ops.committed(e2, r) for r in range(3)]
    wm0 = e2.commit_watermark
    e2.run_until_leader()
    post = payloads(4, seed=12)
    s2 = [e2.submit(p) for p in post]
    e2.run_until_committed(s2[-1])
    e2.run_for(3 * e2.cfg.heartbeat_period)
    commits = ops.rows(e2, "commit_index")
    tails = [ops.log_entries(e2, r, max(1, int(commits[r]) - 64 + 1),
                             int(commits[r])) for r in range(3)]
    return dict(pre=pre, post=post, wm0=wm0, restored=restored,
                tails=tails, ckpt=_ckpt_members(path), votes=votes), e2


def sc_ec_restart(make, ops, tmp):
    import os

    over = dict(EC, entry_bytes=12, log_capacity=64)
    e = make(over)
    e.run_until_leader()
    pre = payloads(15, entry=12, seed=13)
    seqs = [e.submit(p) for p in pre]
    e.run_until_committed(seqs[-1])
    path = os.path.join(tmp, "ecmesh.npz")
    e.save_checkpoint(path)
    e2 = make(over, restore=path)
    wm0 = e2.commit_watermark
    data = ops.reconstruct(e2, [1, 3, 4], 1, 15)
    e2.run_until_leader()
    post = payloads(5, entry=12, seed=14)
    s2 = [e2.submit(p) for p in post]
    e2.run_until_committed(s2[-1])
    return dict(pre=pre, post=post, wm0=wm0, data=data,
                after=[bytes(x) for x in e2.committed_entries(1, 20)],
                ckpt=_ckpt_members(path)), e2


def sc_pipeline(make, ops, tmp):
    e = make(dict(log_capacity=64))
    e.run_until_leader()
    ps = payloads(640)
    seqs = e.submit_pipelined(ps)
    durable = all(e.is_durable(s) for s in seqs)
    e.run_for(3 * e.cfg.heartbeat_period)
    commits = ops.rows(e, "commit_index")
    tails = [ops.log_entries(e, r, max(1, int(commits[r]) - 64 + 1),
                             int(commits[r])) for r in range(3)]
    return dict(ps=ps, durable=durable,
                lead_commit=int(commits[e.leader_id]), tails=tails), e


def sc_pipeline_ec(make, ops, tmp):
    e = make(dict(EC, entry_bytes=12, log_capacity=64))
    e.run_until_leader()
    ps = payloads(120, entry=12, seed=7)
    seqs = e.submit_pipelined(ps)
    hi = int(ops.rows(e, "commit_index")[e.leader_id])
    lo = max(1, hi - 64 + 1)
    return dict(ps=ps, durable=all(e.is_durable(s) for s in seqs),
                lo=lo, hi=hi,
                got=[bytes(x) for x in e.committed_entries(lo, hi)]), e


def sc_slow_window(make, ops, tmp, seed):
    """tests/test_differential_faults.py's slow-follower shape, the
    engine half (32-byte entries, C = 128)."""
    rng = np.random.default_rng(seed + 100)
    ps = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
          for _ in range(10)]
    e = make(dict(entry_bytes=32, seed=seed))
    lead = e.run_until_leader()
    slow = (lead + 1) % 3
    e.set_slow(slow, True)
    seqs = [e.submit(p) for p in ps[:5]]
    e.run_until_committed(seqs[-1])
    e.set_slow(slow, False)
    seqs += [e.submit(p) for p in ps[5:]]
    e.run_until_committed(seqs[-1])
    e.run_for(3 * e.cfg.heartbeat_period)
    return dict(ps=ps, committed=[ops.committed(e, r) for r in range(3)],
                leader=e.leader_id), e


def sc_fused(make, ops, tmp):
    """tests/test_fused_ticks.py's TestMeshFused at fuse_k 1 and 8."""
    out = {}
    for k in (1, 8):
        e = make(dict(log_capacity=64, fuse_k=k))
        e.run_until_leader()
        seqs = [e.submit(p) for p in payloads(8, seed=1)]
        e.run_until_committed(seqs[-1])
        e.run_for(2 * e.cfg.heartbeat_period)
        more = [e.submit(p) for p in payloads(24, seed=2)]
        e.run_for(30 * e.cfg.heartbeat_period)
        out[k] = dict(durable=all(e.is_durable(s) for s in more),
                      launches=e.fused_launches, ticks=e.fused_ticks,
                      commit_time=dict(e.commit_time), now=e.clock.now,
                      whole=ops.whole(e), lines=list(e.lines))
    return out, e


def sc_device_obs(make, ops, tmp):
    """tests/test_device_obs.py's test_mesh_recorded_byte_compat."""
    e = make(dict(batch_size=8, log_capacity=256), recorder=True)
    dev = e.attach_device_obs(capacity=256)
    e.run_until_leader()
    rng = np.random.default_rng(0)
    for _ in range(3):
        seqs = [e.submit(rng.integers(0, 256, 16, np.uint8).tobytes())
                for _ in range(8)]
        e.run_until_committed(seqs[-1])
    host = [ev.nodelog() for ev in e.recorder.events()
            if ev.kind in ("elect", "commit")]
    return dict(dev=dev.nodelog_lines(), host=host,
                packed=ops.packed(e)), e


EC2D = dict(n_replicas=4, entry_bytes=32, rs_k=2, rs_m=2)


def sc_ec2d_roundtrip(make, ops, tmp):
    """tests/test_engine_mesh.py:140 TestECWithPayloadShardsOnMesh, its
    round trip (RS(4,2), 32-byte entries; the 2-D config adds
    ``payload_shards``)."""
    e = make(dict(EC2D, seed=1))
    e.run_until_leader()
    ps = payloads(8, entry=32, seed=3)
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    return dict(ps=ps, got=[ops.reconstruct(e, rows, 1, 8) for rows in
                            ([0, 1], [2, 3], [1, 2])]), e


def sc_ec2d_heal(make, ops, tmp):
    """TestECWithPayloadShardsOnMesh's slow follower: commit at k+1 = 3
    of the other three, then the heal."""
    e = make(dict(EC2D, seed=2))
    lead = e.run_until_leader()
    slow = (lead + 1) % 4
    e.set_slow(slow, True)
    ps = payloads(6, entry=32, seed=4)
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    before = int(ops.rows(e, "match_index")[slow])
    e.set_slow(slow, False)
    e.run_for(2 * e.cfg.heartbeat_period)
    rows = [slow, (slow + 1) % 4]
    return dict(ps=ps, before=before,
                after=int(ops.rows(e, "match_index")[slow]),
                got=ops.reconstruct(e, rows, 1, 6)), e


SCENARIOS = {
    "submit": (3, sc_submit), "failover": (3, sc_failover),
    "slow_heal": (3, sc_slow_heal), "lapped": (3, sc_lapped),
    "ec_roundtrip": (5, sc_ec_roundtrip), "ec_heal": (5, sc_ec_heal),
    "membership": (5, sc_membership), "restart": (3, sc_restart),
    "ec_restart": (5, sc_ec_restart), "pipeline": (3, sc_pipeline),
    "pipeline_ec": (5, sc_pipeline_ec), "fused": (3, sc_fused),
    "device_obs": (3, sc_device_obs),
    "membership4": (4, lambda m, o, t: sc_membership(m, o, t, rows=4)),
    "ec2d_roundtrip": (4, sc_ec2d_roundtrip), "ec2d_heal": (4, sc_ec2d_heal),
    **{f"slow_window_{s}": (3, (lambda s: lambda m, o, t:
                                sc_slow_window(m, o, t, s))(s))
       for s in (0, 1, 2)},
}

BASE = dict(n_replicas=3, entry_bytes=16, batch_size=4, log_capacity=128,
            seed=0)


def run_scenario(name, make, ops, tmp):
    """One scenario in one environment: its result and the final
    observation of the engine it ends with, and that engine."""
    res, e = SCENARIOS[name][1](make, ops, tmp)
    return dict(result=res, final=final_obs(e, ops)), e


def port_make(transport: str, transport_of, extra=None):
    """``make`` for the port: configs carry ``transport`` (and ``extra``,
    the 2-D mesh's ``payload_shards``) and ``transport_of(cfg)`` places
    the engine."""
    from raft_tpu_torch.raft import RaftEngine

    def make(over, restore=None, recorder=False, vote_log=None):
        cfg = RaftConfig(**{**BASE, **(extra or {}), **over,
                            "transport": transport})
        lines = []
        kw = dict(trace=lines.append, vote_log=vote_log,
                  recorder=PortOps().recorder() if recorder else None)
        if restore is not None:
            e = RaftEngine.restore(cfg, restore, transport_of(cfg), **kw)
        else:
            e = RaftEngine(cfg, transport_of(cfg), **kw)
        e.lines = lines
        return e
    return make


def engine_scenarios(rank: int, world: int, names, extra=None) -> dict:
    """The named scenarios on this rank's mirrored engine (a
    ``MeshTransport`` on the CPU; ``extra`` config keywords, the 2-D
    mesh's ``payload_shards``), each from a fresh cluster; returns {name:
    result, final observation, and this rank's own leaves}."""
    import tempfile

    from raft_tpu_torch.core.state import state_to_numpy

    torch.set_num_threads(1)
    out = {}
    make = port_make("tpu_mesh",
                     lambda cfg: MeshTransport(cfg, device="cpu"), extra)
    for name in names:
        with tempfile.TemporaryDirectory(prefix=f"rank{rank}_") as tmp:
            obs, e = run_scenario(name, make, PortOps(), tmp)
        obs["local"] = state_to_numpy(e.state)
        out[name] = obs
    return out


# -------------------------------------------------------------- multihost
# tests/test_torch_multihost.py: the port's counterparts of
# tests/test_multihost.py and tests/test_multiprocess.py, one process a
# replica row, joined by ``run_ranks``' gloo group.

def multihost_kind(rank: int, world: int, kw: dict):
    """The transport ``make_transport`` gives ``transport="multihost"``
    inside the group, and the row it holds."""
    t = make_transport(RaftConfig(**kw, transport="multihost"),
                       device="cpu")
    return type(t).__name__, t.local_row(rank)


def multihost_cluster(rank: int, world: int) -> bool:
    """tests/test_multihost.py TestEndToEnd: the transport
    ``multihost_transport`` builds drives elect, replicate and commit."""
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport import multihost_transport

    torch.set_num_threads(1)
    cfg = RaftConfig(n_replicas=3, entry_bytes=16, batch_size=4,
                     log_capacity=64, transport="multihost")
    e = RaftEngine(cfg, multihost_transport(cfg, device="cpu"))
    e.run_until_leader()
    seqs = [e.submit(bytes([i]) * 16) for i in range(6)]
    e.run_until_committed(seqs[-1])
    return all(e.is_durable(s) for s in seqs)


def _sha(b: bytes) -> str:
    import hashlib

    return hashlib.sha256(b).hexdigest()[:16]


def full_engine(rank: int, world: int) -> dict:
    """tests/test_multiprocess.py:233: the full engine as mirrored loops,
    a leadership change, a rejoin, byte-identical committed logs."""
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport import multihost_transport

    torch.set_num_threads(1)
    cfg = RaftConfig(n_replicas=3, entry_bytes=16, batch_size=4,
                     log_capacity=64, transport="multihost", seed=7,
                     mirror_check_every=16)
    t = multihost_transport(cfg, device="cpu")
    e = RaftEngine(cfg, t)
    lead1 = e.run_until_leader()
    rng = np.random.default_rng(42)
    ps = [rng.integers(0, 256, 16, np.uint8).tobytes() for _ in range(8)]
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    term1 = e.leader_term
    e.fail(lead1)
    lead2 = e.run_until_leader()
    ps2 = [rng.integers(0, 256, 16, np.uint8).tobytes() for _ in range(4)]
    seqs2 = [e.submit(p) for p in ps2]
    e.run_until_committed(seqs2[-1])
    e.recover(lead1)
    e.run_for(8 * cfg.heartbeat_period)
    got = e.committed_entries(1, e.commit_watermark)
    return dict(ok=[bytes(x) for x in got] == ps + ps2,
                changed=(lead2 != lead1 and e.leader_term > term1),
                covers=e.store.covers(1, e.commit_watermark),
                mark=(e.commit_watermark, e.leader_id, e.leader_term,
                      _sha(got.tobytes())),
                exchanges=e.mirror_exchanges, fetches=t.fetches)


def kernel_engine(rank: int, world: int) -> dict:
    """tests/test_multiprocess.py:321 at its kernel-eligible shape (B =
    128, C = 256): every steady tick through K2·mesh's twin, a full-ring
    ``submit_pipelined`` through the mesh flight (the engine's card-only
    flight gate opened on the CPU), a leadership change and a rejoin."""
    import raft_tpu_torch.core.step_mesh as sm
    import raft_tpu_torch.raft.engine as engine_mod
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport import multihost_transport

    torch.set_num_threads(1)
    engine_mod._pipeline_backend_ok = lambda device: True
    cfg = RaftConfig(n_replicas=3, entry_bytes=16, batch_size=128,
                     log_capacity=256, transport="multihost", seed=7)
    e = RaftEngine(cfg, multihost_transport(cfg, device="cpu"))
    e.run_until_leader()
    sm.LAST_DISPATCH = None
    rng = np.random.default_rng(42)
    ps = [rng.integers(0, 256, 16, np.uint8).tobytes() for _ in range(256)]
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1], limit=900.0)
    tick = sm.LAST_DISPATCH
    e.run_for(4 * cfg.heartbeat_period)
    ps_pipe = [rng.integers(0, 256, 16, np.uint8).tobytes()
               for _ in range(cfg.log_capacity)]
    seqs_pipe = e.submit_pipelined(ps_pipe)
    flight = sm.LAST_DISPATCH
    e.run_until_committed(seqs_pipe[-1], limit=900.0)
    lead1 = e.leader_id
    e.fail(lead1)
    e.run_until_leader()
    ps2 = [rng.integers(0, 256, 16, np.uint8).tobytes() for _ in range(56)]
    seqs2 = [e.submit(p) for p in ps2]
    e.run_until_committed(seqs2[-1], limit=900.0)
    e.recover(lead1)
    e.run_for(8 * cfg.heartbeat_period)
    lo = max(1, e.commit_watermark - cfg.log_capacity + 1)
    got = e.committed_entries(lo, e.commit_watermark)
    want = (ps + ps_pipe + ps2)[lo - 1:]
    return dict(ok=[bytes(x) for x in got] == want, tick=tick,
                flight=flight,
                mark=(e.commit_watermark, _sha(np.asarray(got).tobytes())))


def desync(rank: int, world: int, payload_shards: int = 1,
           bad: int = 1) -> dict:
    """tests/test_multiprocess.py:510: rank ``bad`` perturbs a host
    mirror; the digest splits at the next check and every rank
    fail-stops (on the 2-D mesh every rank of every column)."""
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.raft.engine import MirrorDesyncError
    from raft_tpu_torch.transport import multihost_transport

    torch.set_num_threads(1)
    cfg = RaftConfig(n_replicas=3, entry_bytes=16, batch_size=4,
                     log_capacity=64, transport="multihost", seed=7,
                     mirror_check_every=8, mirror_exchange_timeout_s=30.0,
                     payload_shards=payload_shards)
    e = RaftEngine(cfg, multihost_transport(cfg, device="cpu"))
    lead = e.run_until_leader()
    rng = np.random.default_rng(1)
    ps = [rng.integers(0, 256, 16, np.uint8).tobytes() for _ in range(8)]
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1])
    out = dict(synced=e.commit_watermark, caught=None)
    if rank == bad:
        victim = next(q for q in range(3) if q != lead)
        e.terms[victim] += 1
    try:
        for p in ps:
            e.submit(p)
        for _ in range(400):
            if not e.step_event():
                break
    except MirrorDesyncError as ex:
        out["caught"] = str(ex)
    return out


# ----------------------------------------------------------- the 2-D mesh
# tests/test_torch_mesh2d.py: one spawn of R x P ranks runs everything the
# file compares (the transport programs, the engine scenarios, the
# transport decisions, and last the forced desync).

def collectives_1d(rank: int, world: int) -> dict:
    """The 1-D engine's communication on 3 ranks at two shapes (the tick
    path, and the kernel-eligible one): (column collectives, gathering
    fetches, leader ticks) from the election's end to a settled commit of
    40 entries."""
    from raft_tpu_torch.raft import RaftEngine

    torch.set_num_threads(1)
    out = {}
    for name, kw in (("tick", dict(batch_size=4, log_capacity=128)),
                     ("kernel", dict(batch_size=128, log_capacity=256))):
        cfg = RaftConfig(n_replicas=3, entry_bytes=16, seed=5,
                         transport="tpu_mesh", **kw)
        t = MeshTransport(cfg, device="cpu")
        e = RaftEngine(cfg, t)
        e.run_until_leader()
        c0, f0, k0 = t.comm.collectives, t.fetches, e._tick_count
        rng = np.random.default_rng(3)
        seqs = [e.submit(rng.integers(0, 256, 16, np.uint8).tobytes())
                for _ in range(40)]
        e.run_until_committed(seqs[-1])
        e.run_for(4 * cfg.heartbeat_period)
        out[name] = (t.comm.collectives - c0, t.fetches - f0,
                     e._tick_count - k0, t.comm.row_collectives)
    return out


def transport_decisions(rank: int, world: int, cases) -> list:
    """``make_transport`` for each config (a dict), or ``MeshTransport``
    built directly for a ``(config, payload_shards)`` pair: the class it
    gives, or the ``ValueError`` text it raises."""
    out = []
    for case in cases:
        try:
            if isinstance(case, dict):
                t = make_transport(RaftConfig(**case), device="cpu")
            else:
                t = MeshTransport(RaftConfig(**case[0]), device="cpu",
                                  payload_shards=case[1])
            out.append(type(t).__name__)
        except ValueError as ex:
            out.append(f"ValueError: {ex}")
    return out


def mesh2d_rank(rank: int, world: int, programs: dict, names,
                decisions=(), desync_bad=None) -> dict:
    """Everything one 2-D rank runs for tests/test_torch_mesh2d.py, in
    one order on every rank: the transport's decisions, the transport
    programs, the engine scenarios (``payload_shards=2``) and, last, the
    forced desync on rank ``desync_bad``."""
    out = dict(decisions=transport_decisions(rank, world, decisions),
               programs=run_programs(rank, world, programs),
               engine=engine_scenarios(rank, world, names,
                                       dict(payload_shards=2)))
    if desync_bad is not None:
        out["desync"] = desync(rank, world, 2, desync_bad)
    return out
