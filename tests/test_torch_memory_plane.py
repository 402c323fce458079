"""The port's memory plane (``raft_tpu_torch.obs.memory``) against the JAX
package's (``raft_tpu.obs.memory``): ``tests/test_memory_plane.py``'s cases
that need no chaos runner, and ``tests/test_tiered.py``'s
``TestHostAttribution`` ``MemoryWatch`` cases, each through both packages
on the same seeded inputs (3 replicas, 16-byte entries, B = 4, C = 64).

- Attribution: the ``engine.state.*`` labels, their counts and their
  bytes equal JAX's; the gauges ride the census; snapshots are JSON-safe
  with JAX's keys (on the CPU the port adds none: its allocator keys are
  the card's).
- Leak detector: a held ``float32[123,7]`` orphan drifts with JAX's text,
  and goes flat once dropped; lazily allocated engine singletons are
  attributed; one ``migrate_group`` move on two shards is flat.
- Donation: the port has no donation; its audit counts the donated
  leaves whose storage an output shares. On the CPU the fused launch
  writes the two rings in place and returns new small leaves: 2 of 8
  leaves, engaged but not honored, where JAX's donation consumes at
  least 7 of 8. An undonated call audits 0 in both.

The exactness is equality of strings, counts and bytes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.obs import memory as jmemory
from raft_tpu.obs.registry import MetricsRegistry as JRegistry
from raft_tpu.raft.engine import RaftEngine as JEngine
from raft_tpu.transport.device import SingleDeviceTransport as JTransport
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.obs import memory as tmemory
from raft_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from raft_tpu_torch.raft.engine import RaftEngine as TEngine
from raft_tpu_torch.transport import SingleDeviceTransport as TTransport

ENTRY = 16
KW = dict(n_replicas=3, entry_bytes=ENTRY, batch_size=4, log_capacity=64,
          transport="single")
PKGS = {"jax": jmemory, "torch": tmemory}


def payloads(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, ENTRY, dtype=np.uint8).tobytes()
            for _ in range(n)]


def mk_engine(pkg, fuse_k=1, seed=0, **kw):
    if pkg == "jax":
        cfg = JConfig(**KW, fuse_k=fuse_k, seed=seed, **kw)
        return JEngine(cfg, JTransport(cfg))
    cfg = TConfig(**KW, fuse_k=fuse_k, seed=seed, **kw)
    return TEngine(cfg, TTransport(cfg, device="cpu"))


def registry(pkg):
    return JRegistry() if pkg == "jax" else TRegistry()


# ----------------------------------------------------------- 1. attribution
def test_state_leaves_attributed_by_label_equal_jax():
    got = {}
    for pkg, mod in PKGS.items():
        reg = registry(pkg)
        watch = mod.MemoryWatch(registry=reg)
        e = mk_engine(pkg)
        watch.watch_engine(e)
        c = watch.census()
        assert c.attributed_bytes > 0
        assert c.total_bytes >= c.attributed_bytes
        assert reg.gauge("raft_device_mem_bytes").value() == c.total_bytes
        assert reg.gauge("raft_device_arrays").value() == c.n_arrays
        assert watch.high_water_bytes >= c.total_bytes
        got[pkg] = {k: v for k, v in c.by_label.items()
                    if k.startswith("engine.state.")}
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == 8


def test_views_and_shared_storage_count_once():
    """A view, or a second tensor over one storage, is one storage in the
    census; it is labeled by the root that holds any tensor over it."""
    watch = tmemory.MemoryWatch()
    base = torch.zeros((50, 13), dtype=torch.int32)
    view = base[10:20]
    holder = {"v": view}
    watch.register_root("root", lambda: holder)
    c = watch.census()
    assert c.by_label == {"root['v']": (1, 50 * 13 * 4)}
    assert "int32[50,13]" in c.by_shape and "int32[10,13]" not in c.by_shape
    del base, view


def test_snapshot_jsonable_with_jax_keys():
    snaps = {}
    for pkg, mod in PKGS.items():
        watch = mod.MemoryWatch()
        e = mk_engine(pkg)
        watch.watch_engine(e)
        snap = watch.snapshot(census=True)
        json.dumps(snap)
        assert snap["census"]["n_arrays"] > 0
        snaps[pkg] = (snap, watch.summary())
    (js, jsum), (ts, tsum) = snaps["jax"], snaps["torch"]
    assert set(ts) == set(js)
    assert set(ts["census"]) == set(js["census"])
    assert set(tsum) == set(jsum)
    assert ts["roots"] == js["roots"]
    assert ts["host_roots"] == js["host_roots"]


# ---------------------------------------------------------- 2. leak detector
def orphan_drift(pkg):
    mod = PKGS[pkg]
    watch = mod.MemoryWatch()
    e = mk_engine(pkg)
    watch.watch_engine(e)
    watch.set_baseline()
    assert watch.drift() == []
    orphan = (jnp.zeros((123, 7), jnp.float32) if pkg == "jax"
              else torch.zeros((123, 7), dtype=torch.float32))
    drift = watch.drift()
    with pytest.raises(AssertionError):
        watch.assert_flat()
    del orphan
    watch.assert_flat()
    return drift


def test_orphan_buffer_flagged_with_jax_text_then_flat():
    jd, td = orphan_drift("jax"), orphan_drift("torch")
    bucket = "bucket float32[123,7]: +1 unattributed arrays (+3444 bytes)"
    assert bucket in td and bucket in jd
    total = [ln.split(" (")[0] for ln in td
             if ln.startswith("unattributed total")]
    assert total == [ln.split(" (")[0] for ln in jd
                     if ln.startswith("unattributed total")] == \
        ["unattributed total +3444 bytes"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_lazy_engine_singletons_are_attributed(pkg):
    watch = PKGS[pkg].MemoryWatch()
    e = mk_engine(pkg, fuse_k=4)
    watch.watch_engine(e)
    watch.set_baseline()
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(16, seed=1)]
    e.run_for(30 * e.cfg.heartbeat_period)
    assert all(e.is_durable(s) for s in seqs)
    assert e.fused_launches > 0
    watch.assert_flat()


def test_migrate_group_census_flat_in_both():
    """One ``migrate_group`` move across two shards: flat in both (JAX
    on its two virtual CPU devices, the port on ``GroupMesh([cpu, cpu])``)."""
    from jax.sharding import Mesh

    from raft_tpu.core.state import GROUP_AXIS, REPLICA_AXIS
    from raft_tpu.multi.engine import MultiEngine as JMulti
    from raft_tpu_torch.multi.engine import MultiEngine as TMulti
    from raft_tpu_torch.transport.group_mesh import GroupMesh

    kw = {**KW, "transport": "mesh_groups", "seed": 5}
    engines = {
        "jax": lambda: JMulti(JConfig(**kw), 4, mesh=Mesh(
            np.array(jax.devices()[:2]).reshape(2, 1),
            (GROUP_AXIS, REPLICA_AXIS))),
        "torch": lambda: TMulti(TConfig(**kw), 4,
                                mesh=GroupMesh(["cpu", "cpu"]),
                                device="cpu"),
    }
    states = {}
    for pkg, mk in engines.items():
        me = mk()
        me.seed_leaders()
        watch = PKGS[pkg].MemoryWatch()
        watch.watch_engine(me, name="multi")
        for g in range(4):
            for p in payloads(4, seed=g):
                me.submit(g, p)
        me.run_for(20 * me.cfg.heartbeat_period)
        watch.set_baseline()
        dst = 1 - me.shard_of(0)
        assert me.migrate_group(0, dst) is not None
        me.run_for(10 * me.cfg.heartbeat_period)
        watch.assert_flat()
        states[pkg] = {k: v for k, v in watch.last.by_label.items()
                       if k.startswith("multi.state")}
    # the port's sharded state is a list of per-shard blocks, so its
    # labels carry a shard index (``multi.state[k].term``) where JAX
    # holds one global array a leaf: the shards' bytes sum to JAX's
    fields = sorted(k.split(".")[-1] for k in states["jax"])
    assert len(fields) == 8
    for f in fields:
        parts = [states["torch"][f"multi.state[{k}].{f}"] for k in (0, 1)]
        assert parts[0] == parts[1]
        assert (1, 2 * parts[0][1]) == states["jax"][f"multi.state.{f}"]
    assert len(states["torch"]) == 16


# ---------------------------------------------------------- 3. donation audit
def fused_donation(pkg):
    mod = PKGS[pkg]
    e = mk_engine(pkg, fuse_k=8, seed=9)
    e.run_until_leader()
    for p in payloads(8, seed=1):
        e.submit(p)
    e.run_for(20 * e.cfg.heartbeat_period)
    d = e._fused_driver
    d.staging._alloc()
    r = e.leader_id
    watch = mod.MemoryWatch()
    watch.watch_engine(e)
    if pkg == "jax":
        extra = (jnp.zeros(4, jnp.int32), jnp.asarray(e.alive),
                 jnp.asarray(e.slow))
    else:
        extra = (torch.zeros(4, dtype=torch.int32),
                 torch.as_tensor(e.alive), torch.as_tensor(e.slow))

    def call(state, staging):
        out = e.t.replicate_fused(state, staging, 0, extra[0], 2, False, r,
                                  int(e.lead_terms[r]), *extra[1:])
        e.state = out[0]             # keep the engine coherent
        return out

    report = mod.audit_donation(call, (e.state, d.staging.buf),
                                donated=(0,), watch=watch)
    assert watch.snapshot()["donation"]["engaged"] is report.engaged
    # no copy accumulates across launches: flat over a sustained drive
    watch.set_baseline()
    launches0 = e.fused_launches
    for p in payloads(24, seed=2):
        e.submit(p)
    e.run_for(40 * e.cfg.heartbeat_period)
    assert e.fused_launches > launches0
    watch.assert_flat()
    return report


def test_fused_state_donation_audits():
    jr, tr = fused_donation("jax"), fused_donation("torch")
    assert jr.engaged and jr.n_deleted >= jr.n_donated_leaves - 1
    assert (tr.honored, tr.engaged, tr.backend, tr.n_donated_leaves,
            tr.n_deleted) == (False, True, "cpu", 8, 2)
    assert tr.n_donated_leaves == jr.n_donated_leaves
    assert set(tr.__dict__) == set(jr.__dict__)


def test_undonated_program_audits_not_honored_in_both():
    jrep = jmemory.audit_donation(jax.jit(lambda x: x + 1), (jnp.ones(16),),
                                  donated=(0,))
    trep = tmemory.audit_donation(lambda x: x + 1, (torch.ones(16),),
                                  donated=(0,))
    for rep in (jrep, trep):
        assert not rep.honored and not rep.engaged
        assert (rep.n_donated_leaves, rep.n_deleted) == (1, 0)
    assert trep.detail == jrep.detail


def test_in_place_call_audits_honored():
    """A call that writes its donated tensors in place and returns them is
    honored: every donated storage comes back."""
    st = {"a": torch.zeros(4), "b": torch.ones(3, dtype=torch.int32)}

    def call(s):
        s["a"].add_(1)
        return {"a": s["a"], "b": s["b"][:2]}

    rep = tmemory.audit_donation(call, (st,))
    assert (rep.honored, rep.engaged, rep.n_deleted) == (True, True, 2)
    assert rep.detail == "all donated leaves consumed in place"


# ---------------------------- tests/test_tiered.py TestHostAttribution
def tiered_engine(pkg, tmp_path, seed):
    kw = dict(n_replicas=3, entry_bytes=ENTRY, batch_size=4,
              log_capacity=16, transport="single", seed=seed,
              tiered_log_dir=str(tmp_path / pkg))
    if pkg == "jax":
        cfg = JConfig(**kw)
        return JEngine(cfg, JTransport(cfg))
    cfg = TConfig(**kw)
    return TEngine(cfg, TTransport(cfg, device="cpu"))


def drain(e, ps):
    seqs = [e.submit(p) for p in ps]
    e.run_until_committed(seqs[-1], limit=40000.0)


def test_sealed_buffers_are_a_labeled_root(tmp_path):
    got = {}
    for pkg, mod in PKGS.items():
        e = tiered_engine(pkg, tmp_path, 23)
        e.run_until_leader()
        drain(e, payloads(80, seed=24))
        watch = mod.MemoryWatch()
        watch.watch_engine(e, name="engine")
        census = watch.census()
        label = "engine.store.sealed"
        assert census.host_by_label[label] == e.store.host_bytes() > 0
        assert label in watch.snapshot()["census"]["host_by_label"]
        assert watch.summary()["host_bytes"] is not None
        got[pkg] = census.host_by_label
    assert got["torch"] == got["jax"]


def test_host_mem_gauge_published(tmp_path):
    lines = {}
    for pkg, mod in PKGS.items():
        e = tiered_engine(pkg, tmp_path, 25)
        e.run_until_leader()
        drain(e, payloads(60, seed=26))
        reg = registry(pkg)
        watch = mod.MemoryWatch(registry=reg)
        watch.watch_engine(e)
        watch.census()
        lines[pkg] = [ln for ln in reg.to_prometheus().splitlines()
                      if "raft_host_mem_bytes" in ln]
        assert lines[pkg]
    assert lines["torch"] == lines["jax"]
