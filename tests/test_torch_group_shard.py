"""The port's group-sharded layout against the JAX package's
(``tests/test_group_shard.py`` through both packages): the partition
rules (``core.state``), ``transport.group_mesh`` (``GroupMesh``,
``n_shards_for``, ``GroupMeshTransport``) and ``MultiEngine`` with
``transport="mesh_groups"``, the slot table and ``migrate_group``.

The JAX side shards over two of the eight virtual CPU devices
(``tests/conftest.py``); the port's over ``GroupMesh(["cpu", "cpu"])``,
the same two-shard block layout. Engines run in lock step
(``tests/test_torch_multi.py`` ``MPair``): nodelog lines, the event heap
and every rng after every event, every gathered state leaf, the slot
tables, committed bytes, stamps, the apply stream and the status
snapshot. ``tests/test_torch_group_shard_paths.py`` drives every path
after migrations. Small shapes: 3 replicas, G = 2-8, B = 8, C = 256, two
shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.core import step as jstep
from raft_tpu.multi import Router as JRouter
from raft_tpu.obs import device as jdev
from raft_tpu.transport import group_mesh as jgm
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core import state as tst
from raft_tpu_torch.core import step as tstep
from raft_tpu_torch.multi import (
    GROUP_AXIS_TRANSPORTS,
    MultiEngine,
    Router,
    UnsupportedGroupTransport,
)
from raft_tpu_torch.obs import device as tdev
from raft_tpu_torch.transport import group_mesh as tgm
from tests.test_group_shard import two_shard_mesh
from tests.test_torch_multi import MPair, payloads

CPU2 = ["cpu", "cpu"]
KW = dict(n_replicas=3, entry_bytes=64, batch_size=8, log_capacity=256,
          transport="single", seed=5)


def meshes():
    return (two_shard_mesh(), tgm.GroupMesh(CPU2))


def sharded_pair(G, **over):
    p = MPair(G, meshes=meshes(), **{"transport": "mesh_groups", **over})
    for e in p.engines:
        assert (e.transport_mode, e.n_shards) == ("mesh_groups", 2)
    return p


def jspec(spec):
    """A JAX ``PartitionSpec`` as the port's tuple of axis names."""
    return tuple(spec)


# ------------------------------------------------------- partition rules
class TestPartitionRules:
    def test_rule_table_and_leaf_specs_equal_jax(self):
        trules = tst.group_partition_rules()
        jrules = jst.group_partition_rules()
        assert [r for r, _ in trules] == [r for r, _ in jrules]
        assert [s for _, s in trules] == [jspec(s) for _, s in jrules]
        assert (tst.GROUP_AXIS, tst.REPLICA_AXIS) == \
            (jst.GROUP_AXIS, jst.REPLICA_AXIS)
        tspecs = tst.group_state_specs(TConfig(**KW), 4)
        jspecs = jst.group_state_specs(JConfig(**KW), 4)
        for f in tst.FIELDS:
            assert getattr(tspecs, f) == jspec(getattr(jspecs, f)) == \
                ("gshard",), f
        # scalar and single-element leaves get the empty spec first
        tree = {"x": np.zeros(()), "y": np.zeros((1, 1))}
        assert tst.match_partition_rules(trules, tree) == {"x": (), "y": ()}
        jgot = jst.match_partition_rules(jrules, tree)
        assert {k: jspec(v) for k, v in jgot.items()} == {"x": (), "y": ()}

    def test_unmatched_leaf_refuses_with_jax_text(self):
        leaf = {"other": np.zeros((4, 2))}
        with pytest.raises(ValueError) as te:
            tst.match_partition_rules(((r"^only_this$", ()),), leaf)
        with pytest.raises(ValueError) as je:
            jst.match_partition_rules(((r"^only_this$", P()),), leaf)
        assert str(te.value) == str(je.value) == \
            "no partition rule matched leaf 'other'"

    def test_shard_and_gather_round_trip(self):
        cfg = TConfig(**KW)
        mesh = tgm.GroupMesh(CPU2)
        specs = tst.group_state_specs(cfg, 4)
        shard_fns, gather_fns = tst.make_shard_and_gather_fns(mesh, specs)
        state = tst.init_group_state(cfg, 4, device="cpu")
        state.last_index.copy_(torch.arange(12).reshape(4, 3))
        for f in tst.FIELDS:
            parts = getattr(shard_fns, f)(getattr(state, f))
            assert [tuple(p.shape)[0] for p in parts] == [2, 2]
            back = getattr(gather_fns, f)(parts)
            np.testing.assert_array_equal(back, getattr(state, f).numpy())
        # the whole-value spec copies onto every shard
        fn, gather = (x["v"] for x in tst.make_shard_and_gather_fns(
            mesh, {"v": ()}))
        parts = fn(np.arange(3))
        assert len(parts) == 2 and all(p.tolist() == [0, 1, 2]
                                       for p in parts)
        assert gather(parts).tolist() == [0, 1, 2]


@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 8, 12, 1024])
def test_n_shards_for_equals_jax(G):
    for n_devices in (0, 1, 2, 3, 4, 5, 8, 16):
        assert tgm.n_shards_for(G, n_devices) == \
            jgm.n_shards_for(G, n_devices), (G, n_devices)


# ------------------------------------------------------ sharded kernels
class Trio:
    """One 8-group state three ways: the port's two-shard transport, the
    JAX two-shard transport and JAX's vmapped programs; every call's
    state leaves and infos compared across all three."""

    def __init__(self, G=8, capacity=None):
        self.cfg = TConfig(**KW)
        self.G, self.R = G, self.cfg.n_replicas
        self.t = tgm.GroupMeshTransport(self.cfg, G, mesh=tgm.GroupMesh(CPU2))
        self.j = jgm.GroupMeshTransport(JConfig(**KW), G,
                                        mesh=two_shard_mesh())
        assert self.t.n_shards == self.j.n_shards == 2
        self.ts = self.t.shard_state(tst.init_group_state(self.cfg, G,
                                                          device="cpu"))
        self.js = self.j.shard_state(jst.init_group_state(JConfig(**KW), G))
        self.vs = jst.init_group_state(JConfig(**KW), G)
        self.rings = None
        if capacity is not None:
            self.trings = self.t.shard_rings(
                tdev.init_group_rings(capacity, G, device="cpu"))
            self.jrings = self.j.shard_rings(jdev.init_group_rings(
                capacity, G))
            self.vrings = jdev.init_group_rings(capacity, G)
            self.gids = np.arange(G, dtype=np.int32)[::-1].copy()

    def call(self, kind, *ops):
        """``kind`` on all three with the same numpy operands."""
        rec = getattr(self, "trings", None) is not None
        j_ops = [jnp.asarray(o) for o in ops]
        t_ops = [torch.from_numpy(np.asarray(o)) for o in ops]
        tfn = {"vote": self.t.request_votes, "rep": self.t.replicate,
               "fused": self.t.replicate_fused}[kind]
        jfn = {"vote": self.j.request_votes, "rep": self.j.replicate,
               "fused": self.j.replicate_fused}[kind]
        vfn = jax.jit({"vote": jstep.group_vote_step,
                       "rep": jstep.group_replicate_step,
                       "fused": jstep.fused_group_scan}[kind](
                           self.R, record=rec))
        if rec:
            tout = tfn(self.ts, *t_ops, self.trings,
                       torch.from_numpy(self.gids))
            jout = jfn(self.js, *j_ops, self.jrings, jnp.asarray(self.gids))
            vout = vfn(self.vs, *j_ops, self.vrings, jnp.asarray(self.gids))
            self.trings, self.jrings, self.vrings = \
                tout[-1], jout[-1], vout[-1]
            tout, jout, vout = tout[:-1], jout[:-1], vout[:-1]
        else:
            tout, jout, vout = tfn(self.ts, *t_ops), jfn(self.js, *j_ops), \
                vfn(self.vs, *j_ops)
        self.ts, self.js, self.vs = tout[0], jout[0], vout[0]
        for i, (a, b, c) in enumerate(zip(tout[1:], jout[1:], vout[1:])):
            pairs = (zip(a, b, c) if isinstance(a, tuple)
                     else [(a, b, c)])
            for x, y, z in pairs:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=f"{kind} out {i}")
                np.testing.assert_array_equal(np.asarray(y), np.asarray(z))
        got = self.t.gather_state(self.ts)
        for f in tst.FIELDS:
            np.testing.assert_array_equal(got[f], np.asarray(
                getattr(self.js, f)), err_msg=f"{kind} state.{f}")
            np.testing.assert_array_equal(got[f], np.asarray(
                getattr(self.vs, f)), err_msg=f"{kind} state.{f} vmapped")
        if rec:
            tp = np.concatenate([tdev.packed_flush(r).numpy()
                                 for r in self.trings])
            np.testing.assert_array_equal(tp, np.asarray(
                jdev.packed_flush(self.jrings)))
            np.testing.assert_array_equal(tp, np.asarray(
                jdev.packed_flush(self.vrings)))
        return tout


class TestShardedKernels:
    @pytest.mark.parametrize("capacity", [None, 64], ids=["plain",
                                                          "recorded"])
    def test_vote_replicate_fused_equal_jax_and_vmapped(self, capacity):
        """Vote, replicate and the fused window through the port's
        two-shard transport against JAX's ``GroupMeshTransport`` and the
        vmapped programs: every leaf, every info, and with event rings
        the packed rings."""
        tri = Trio(capacity=capacity)
        G, R, B, W = tri.G, tri.R, 8, tri.cfg.shard_words
        rng = np.random.default_rng(0)
        alive = np.ones((G, R), bool)
        cands = np.array([g % R for g in range(G)], np.int32)
        ones = np.ones(G, np.int32)
        tri.call("vote", cands, ones, alive)
        pay = np.stack([np.asarray(jst.fold_batch(
            rng.integers(0, 256, (B, 64), np.uint8), R)) for _ in range(G)])
        counts = np.array([B - (g % 3) for g in range(G)], np.int32)
        slow = np.zeros((G, R), bool)
        slow[5, (cands[5] + 1) % R] = True
        tri.call("rep", pay, counts, cands, ones, alive, slow, alive)
        K = 4
        pays = rng.integers(-2**31, 2**31 - 1, (K, G, B, W)).astype(np.int32)
        cut = alive.copy()
        cut[6] = False
        cut[6, cands[6]] = True                 # group 6 escapes at once
        out = tri.call("fused", pays, np.full((K, G), B, np.int32),
                       np.int32(K), np.zeros(G, bool), cands, ones, cut,
                       np.zeros((G, R), bool), alive)
        assert out[4].tolist() == [g == 6 for g in range(G)]

    def test_slot_swap_in_place_across_shards(self):
        """``swap_slots`` as JAX's (a shard-0 slot with a shard-1 slot),
        written in place: the blocks keep their tensors; the rings ride
        the same permutation."""
        cfg = TConfig(**KW)
        G = 8
        t = tgm.GroupMeshTransport(cfg, G, mesh=tgm.GroupMesh(CPU2))
        state = t.shard_state(tst.init_group_state(cfg, G, device="cpu"))
        for k, b in enumerate(state):
            b.last_index.copy_(torch.arange(12).reshape(4, 3) + 12 * k)
            b.log_payload[:, 0, 0] = torch.arange(4) + 4 * k
        ptrs = [[getattr(b, f).data_ptr() for f in tst.FIELDS]
                for b in state]
        perm = np.arange(G)
        perm[[0, 6]] = [6, 0]
        out = t.swap_slots(state, perm)
        assert out is state
        got = t.gather_state(out)
        assert (got["last_index"][0] == np.arange(18, 21)).all()
        assert (got["last_index"][6] == np.arange(0, 3)).all()
        assert got["log_payload"][:, 0, 0].tolist() == [6, 1, 2, 3, 4, 5,
                                                        0, 7]
        assert ptrs == [[getattr(b, f).data_ptr() for f in tst.FIELDS]
                        for b in out]
        # JAX's swap on the same values
        jt = jgm.GroupMeshTransport(JConfig(**KW), G, mesh=two_shard_mesh())
        js = jst.init_group_state(JConfig(**KW), G)
        js = jt.shard_state(js.replace(last_index=jnp.arange(
            G * 3, dtype=jnp.int32).reshape(G, 3)))
        np.testing.assert_array_equal(
            np.asarray(jt.swap_slots(js, perm).last_index),
            got["last_index"])
        rings = t.shard_rings(tdev.init_group_rings(8, G, device="cpu"))
        for k, r in enumerate(rings):
            r.count.copy_(torch.arange(4) + 4 * k)
        t.swap_ring_slots(rings, perm)
        assert torch.cat([r.count for r in rings]).tolist() == \
            [6, 1, 2, 3, 4, 5, 0, 7]
        with pytest.raises(ValueError, match="permutation"):
            t.swap_slots(state, np.zeros(G, np.int64))
        # payload batches split with their group axis, [G, ...] or
        # [K, G, ...] (the fused window's)
        for shape, dim in (((G, 8, 48), 0), ((4, G, 8, 16), 1)):
            parts = t.shard_payloads(np.arange(np.prod(shape)).reshape(
                shape))
            assert [p.shape[dim] for p in parts] == [4, 4]
            np.testing.assert_array_equal(
                torch.cat(parts, dim).numpy(),
                np.arange(np.prod(shape)).reshape(shape))

    def test_mesh_refusals_and_default_devices(self):
        cfg = TConfig(**KW)
        with pytest.raises(ValueError) as te:
            tgm.GroupMeshTransport(cfg, 5, mesh=tgm.GroupMesh(CPU2))
        with pytest.raises(ValueError) as je:
            jgm.GroupMeshTransport(JConfig(**KW), 5, mesh=two_shard_mesh())
        assert str(te.value) == str(je.value)
        t = tgm.GroupMeshTransport(cfg, 6, devices=["cpu"] * 4)
        assert (t.n_shards, t.groups_per_shard) == (3, 2)
        assert t.mesh.axis_names == ("gshard", "replica")
        assert t.mesh.shape == {"gshard": 3, "replica": 1}
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tgm.GroupMeshTransport(cfg, 4)


# ------------------------------------------------------- sharded engine
def drive_schedule(p):
    """``tests/test_group_shard.py`` ``drive_schedule`` in lock step:
    traffic on every group, a leader kill and re-election, more
    traffic."""
    p.both("seed_leaders")
    last = {}
    for g in range(p.G):
        last.update(p.submit_all({g: payloads(12 + g, seed=100 + g)}))
    for g in range(p.G):
        p.until_committed(g, last[g])
    p.both("fail", 0, p.t.leader_id[0])
    p.until_leader(0)
    s = p.both("submit", 0, payloads(1, seed=9)[0])
    p.until_committed(0, s)
    p.check_all()
    return p


class TestShardedEngine:
    def test_drive_schedule_equals_jax_and_resident(self):
        """G = 8 over two shards in lock step with JAX's two-shard engine;
        then equal to the port's resident engine fed the same calls."""
        p = drive_schedule(sharded_pair(8, apply=True))
        r = drive_schedule(MPair(8, apply=True))
        for g in range(8):
            assert p.t.committed_payloads(g) == r.t.committed_payloads(g)
            assert p.t.commit_time[g] == r.t.commit_time[g]
            assert p.t._durable_ranges[g] == r.t._durable_ranges[g]
            assert p.t.rngs[g].getstate() == r.t.rngs[g].getstate()
        assert p.t._q == r.t._q and p.tl == r.tl
        got = p.t._gshard.gather_state(p.t.state)
        for f, v in tst.state_to_numpy(r.t.state).items():
            np.testing.assert_array_equal(got[f], v, err_msg=f)

    def test_one_fetch_and_one_upload_a_shard_per_round(self):
        """A replicate round makes one packed upload a shard and ONE host
        fetch (the shards' outputs joined on their device first)."""
        e = MultiEngine(TConfig(**{**KW, "transport": "mesh_groups"}), 4,
                        mesh=tgm.GroupMesh(CPU2), device="cpu")
        e.seed_leaders()
        e.run_until_leader(3)
        calls = {"fetch": 0, "upload": 0}
        for name in calls:
            orig = getattr(e, f"_{name}")

            def wrapped(*a, _orig=orig, _name=name):
                calls[_name] += 1
                return _orig(*a)
            setattr(e, f"_{name}", wrapped)
        e.read_index(3)
        assert calls == {"fetch": 1, "upload": 2}

    def test_typed_refusals_and_migrate_refusals(self):
        for t in ("tpu_mesh", "multihost", "no_such_transport"):
            with pytest.raises(UnsupportedGroupTransport) as ei:
                MultiEngine(TConfig(**{**KW, "transport": t}), 2,
                            mesh=tgm.GroupMesh(CPU2), device="cpu")
            assert ei.value.supported == GROUP_AXIS_TRANSPORTS
            assert "mesh_groups" in str(ei.value)
        p = sharded_pair(8)
        p.both("seed_leaders")
        p.both_raise("migrate_group", 0, 2)
        p.both_raise("migrate_group", 0, 1, partner=1)
        assert p.both("migrate_group", 0, 0) is None
        with pytest.raises(ValueError, match="is not the mesh's"):
            MultiEngine(TConfig(**{**KW, "transport": "mesh_groups"}), 4,
                        mesh=tgm.GroupMesh(["meta", "meta"]), device="cpu")

    def test_status_snapshot_carries_placement(self):
        p = sharded_pair(8)
        p.both("seed_leaders")
        snap = p.t._status_snapshot()
        assert snap["shards"] == 2 and snap["transport"] == "mesh_groups"
        assert set(snap["placement"]) == {str(g) for g in range(8)}
        assert snap["migrations"] == 0
        g = p.t.groups_on_shard(0)[0]
        assert p.t.groups_on_shard(0) == p.j.groups_on_shard(0)
        p.both("migrate_group", g, 1)
        snap = p.t._status_snapshot()
        assert snap["placement"][str(g)] == 1 and snap["migrations"] == 1
        assert p.t.groups_on_shard(1) == p.j.groups_on_shard(1)
        p.check_all()


# ----------------------------------------------------- bounded history
def sharded_engine(G=2, **over):
    return MultiEngine(
        TConfig(**{**KW, "transport": "mesh_groups", **over}), G,
        mesh=tgm.GroupMesh(CPU2), device="cpu")


def fill(me, n, seed):
    last = None
    for p in payloads(n, seed=seed):
        last = me.submit(0, p)
        if last % 8 == 0:
            me.run_until_committed(0, last)
    me.run_until_committed(0, last)


class TestBoundedHistory:
    """``tests/test_group_shard.py`` ``TestBoundedHistory`` on the
    sharded layout (G = 2, one group a shard)."""

    def test_stamp_eviction_and_durable_ranges(self):
        me = sharded_engine(batch_size=4, log_capacity=8)
        me.seed_leaders()
        cap = 2 * me.cfg.log_capacity
        n = 3 * cap
        fill(me, n, 3)
        assert len(me.commit_time[0]) == cap
        assert int(me.commit_stamps_evicted[0]) == n - cap
        assert int(me.committed_total[0]) == n
        assert all(me.is_durable(0, s) for s in range(1, n + 1))
        assert not me.is_durable(0, n + 1)
        assert me._durable_ranges[0] == [[1, n - cap]]
        assert len(me.submit_time[0]) == cap
        assert me.commit_time[1] == {} and me._durable_ranges[1] == []

    def test_archive_retention_floor_and_replay_refusal(self):
        me = sharded_engine(batch_size=4, log_capacity=8)
        me.seed_leaders()
        fill(me, 3 * 2 * me.cfg.log_capacity, 4)
        floor = int(me._archive_floor[0])
        assert floor > 1 and min(me._archive[0]) == floor
        seen = []
        with pytest.raises(ValueError, match="retention horizon"):
            me.register_apply(0, lambda i, p: seen.append(i), replay=True)
        start = me.register_apply(0, lambda i, p: seen.append(i))
        assert start == int(me.commit_watermark[0]) + 1
        s = me.submit(0, payloads(1, seed=5)[0])
        me.run_until_committed(0, s)
        assert seen and seen[-1] == int(me.commit_watermark[0])

    def test_apply_stream_blocks_archive_sweep(self):
        me = sharded_engine(batch_size=4, log_capacity=8)
        me.seed_leaders()
        applied = []
        me.register_apply(0, lambda i, p: applied.append(i))
        n = 3 * 2 * me.cfg.log_capacity
        fill(me, n, 6)
        assert applied == list(range(1, n + 1))


# ----------------------------------------------------------- placement
class TestRebalancer:
    def test_router_rebalance_drives_migration(self):
        """``Router.rebalance`` on both sharded engines: the same output
        dict (leadership respread plus a planned migration off the hot
        shard), and the moved group still commits."""
        p = sharded_pair(8)
        p.both("seed_leaders")
        for g in p.t.groups_on_shard(0):
            p.submit_all({g: payloads(12, seed=g)})
        out = Router(p.t).rebalance()
        assert out == JRouter(p.j).rebalance()
        p.check_all()
        assert out["migrations"], "hot shard not rebalanced"
        mv = out["migrations"][0]
        assert (mv["src"], mv["dst"]) == (0, 1)
        assert p.t.shard_of(mv["group"]) == 1
        s = p.both("submit", mv["group"], payloads(1, seed=99)[0])
        p.until_committed(mv["group"], s)
        p.check_all()
