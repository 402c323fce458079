"""The port's tiered archive (``raft_tpu_torch.ckpt.tiered``) against the
JAX package's (``raft_tpu.ckpt.tiered``): ``tests/test_tiered.py``'s
single-group cases run through both packages on the same seeded inputs.

- ``SegmentIO``: round trip, a flipped data shard, torn and missing
  shards, below k; the shard files and CRC sidecars are equal byte for
  byte, and each package loads the other's segments.
- ``TieredStore``: sealing, read-through, the RAM bound, the apply-cursor
  ceiling, the checkpoint floor, ``set_floor``, a lost segment; manifests
  and shard files equal.
- the engine with the tier on (``RAFT_TPU_TIERED_DIR``): both engines in
  lock step (``tests/test_torch_engine.py`` ``Pair``) through full-history
  replay, a lapped rejoin streamed from the sealed tier, a kill
  mid-stream, the flat-rejoin ladder and a checkpoint restore, with their
  tier directories equal file for file; the ``/status`` tier section.
- the catch-up lane of the admission gate.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from raft_tpu.ckpt import tiered as jtiered
from raft_tpu_torch.ckpt import tiered as ttiered
from raft_tpu_torch.core.state import log_entries
from tests.test_torch_engine import Pair

ENTRY = 16
PKGS = {"jax": jtiered, "port": ttiered}


def blobs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, ENTRY, dtype=np.uint8).tobytes()
            for _ in range(n)]


def tree(root) -> dict:
    """Every file under ``root`` by relative path -> bytes."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_tree(a, b):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert ta[name] == tb[name], name


# ---------------------------------------------------------- segment I/O
def sealed(tmp_path, pkg, n=20, seed=1):
    io = PKGS[pkg].SegmentIO(str(tmp_path / pkg), k=4, m=2)
    ents = np.frombuffer(b"".join(blobs(n, seed)), np.uint8).reshape(n, ENTRY)
    terms = np.arange(3, 3 + n, dtype=np.int32)
    io.seal(5, 4 + n, ents, terms)
    return io, ents, terms


@pytest.fixture
def both_sealed(tmp_path):
    got = {pkg: sealed(tmp_path, pkg) for pkg in PKGS}
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    return got


def test_round_trip_bytes_and_terms_exact(both_sealed):
    io, ents, terms = both_sealed["port"]
    got, gterms, reconstructed = io.load(5, 24, ENTRY)
    np.testing.assert_array_equal(got, ents)
    np.testing.assert_array_equal(gterms, terms)
    assert not reconstructed
    name = io.name(5, 24)
    for r in range(io.code.n):
        assert os.path.exists(io._crc_path(io.shard_path(name, r)))


@pytest.mark.parametrize("loader,writer", [("port", "jax"), ("jax", "port")])
def test_each_package_loads_the_others_segment(tmp_path, both_sealed,
                                               loader, writer):
    """A segment sealed by one package loads in the other, through the
    decode too (a data shard deleted)."""
    wio, ents, terms = both_sealed[writer]
    lio = PKGS[loader].SegmentIO(wio.root, k=4, m=2)
    got, gterms, rec = lio.load(5, 24, ENTRY)
    np.testing.assert_array_equal(got, ents)
    np.testing.assert_array_equal(gterms, terms)
    assert not rec
    os.unlink(wio.shard_path(wio.name(5, 24), 2))
    got, _, rec = lio.load(5, 24, ENTRY)
    np.testing.assert_array_equal(got, ents)
    assert rec


def test_flipped_data_shard_reconstructs(both_sealed):
    for pkg, (io, ents, terms) in both_sealed.items():
        p = io.shard_path(io.name(5, 24), 1)
        blob = bytearray(open(p, "rb").read())
        blob[len(blob) // 2] ^= 0x40
        open(p, "wb").write(bytes(blob))
        got, gterms, reconstructed = io.load(5, 24, ENTRY)
        np.testing.assert_array_equal(got, ents)
        np.testing.assert_array_equal(gterms, terms)
        assert reconstructed, pkg


def test_torn_and_missing_shards_reconstruct(both_sealed):
    for pkg, (io, ents, _) in both_sealed.items():
        name = io.name(5, 24)
        torn = io.shard_path(name, 0)
        blob = open(torn, "rb").read()
        open(torn, "wb").write(blob[: len(blob) // 2])
        os.unlink(io.shard_path(name, 3))
        got, _, reconstructed = io.load(5, 24, ENTRY)
        np.testing.assert_array_equal(got, ents)
        assert reconstructed, pkg


def test_below_k_shards_raises(both_sealed):
    for pkg, (io, _, _) in both_sealed.items():
        name = io.name(5, 24)
        for r in range(3):
            os.unlink(io.shard_path(name, r))
        with pytest.raises(PKGS[pkg].SegmentCorrupt):
            io.load(5, 24, ENTRY)


# ------------------------------------------------------- tiered store
def stores(tmp_path, **kw):
    return {pkg: mod.TieredStore(ENTRY, root=str(tmp_path / pkg), **kw)
            for pkg, mod in PKGS.items()}


def test_seal_read_through_and_ram_bound(tmp_path):
    ss = stores(tmp_path, hot_entries=32, segment_entries=8)
    ps = blobs(200, seed=2)
    for s in ss.values():
        for i, b in enumerate(ps, 1):
            s.put(i, b, 1 + i // 50)
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    for s in ss.values():
        assert s.stats["segments_sealed"] == (200 - 32) // 8
        assert len(s._slots) <= 32 + 8
        for i in (1, 8, 9, 100, 168, 169, 200):
            assert s.get(i) == (ps[i - 1], 1 + i // 50)
        assert s.covers(1, 200)
        snap = s.snapshot(1, 64)
        np.testing.assert_array_equal(
            snap.entries,
            np.frombuffer(b"".join(ps[:64]), np.uint8).reshape(64, ENTRY))
    s, j = ss["port"], ss["jax"]
    for i in range(1, 201):
        assert s.get(i) == j.get(i)
    a, b = j.tier_summary(), s.tier_summary()
    a.pop("seal_wall_s"), b.pop("seal_wall_s")
    assert a == b


def test_apply_cursor_caps_sealing(tmp_path):
    ss = stores(tmp_path, hot_entries=16, segment_entries=8)
    for s in ss.values():
        s.apply_cursor = 0
        for i, b in enumerate(blobs(100, seed=3), 1):
            s.put(i, b, 1)
        assert s.stats["segments_sealed"] == 0
        s.apply_cursor = 40
        s.put(101, bytes(ENTRY), 1)
        assert 0 < s._sealed_hi <= 40
    assert ss["port"]._sealed == ss["jax"]._sealed
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_checkpoint_floor_matches_plain_store(tmp_path):
    from raft_tpu_torch.ckpt import CheckpointStore

    plain = CheckpointStore(ENTRY, max_entries=32)
    tiered = ttiered.TieredStore(ENTRY, root=str(tmp_path), hot_entries=16,
                                 segment_entries=8, checkpoint_span=32)
    for i, b in enumerate(blobs(90, seed=4), 1):
        plain.put(i, b, 1)
        tiered.put(i, b, 1)
    assert tiered.checkpoint_floor == plain.checkpoint_floor == plain.first
    assert tiered.covers(1, 90) and not plain.covers(1, 90)


def test_set_floor_does_not_wedge_sealing(tmp_path):
    ss = stores(tmp_path, hot_entries=16, segment_entries=8)
    ps = blobs(300, seed=6)
    for s in ss.values():
        s.set_floor(101)
        for i, b in enumerate(ps, 101):
            s.put(i, b, 1)
        assert s.stats["segments_sealed"] > 0
        assert len(s._slots) <= 16 + 8
        assert s.get(150)[0] == ps[49]
        assert s.get(400)[0] == ps[-1]
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_lost_segment_is_a_gap_not_garbage(tmp_path):
    ss = stores(tmp_path, hot_entries=16, segment_entries=8, rs_k=2, rs_m=1)
    for s in ss.values():
        for i, b in enumerate(blobs(48, seed=5), 1):
            s.put(i, b, 1)
        lo, hi = s._sealed[0]
        for r in range(2):
            os.unlink(s.io.shard_path(s.io.name(lo, hi), r))
        s._cache.clear()
        s._cache_order.clear()
        assert s.get(lo) is None
        assert s.stats["segments_lost"] == 1
        assert s.get(hi + 1) is not None


def test_adopt_reads_the_other_packages_manifest(tmp_path):
    """A restarted store (``adopt=True``) over the other package's root
    inherits its sealed segments and reads them back."""
    ps = blobs(100, seed=8)
    j = jtiered.TieredStore(ENTRY, root=str(tmp_path), hot_entries=16,
                            segment_entries=8)
    for i, b in enumerate(ps, 1):
        j.put(i, b, 2)
    t = ttiered.TieredStore(ENTRY, root=str(tmp_path), hot_entries=16,
                            segment_entries=8, adopt=True)
    assert t.stats["segments_adopted"] == len(j._sealed)
    assert t.generation == j.generation + 1
    assert t.get(3) == (ps[2], 2)


# --------------------------------------------------- engine integration
TKW = dict(entry_bytes=ENTRY, batch_size=4, log_capacity=16)


@pytest.fixture
def tier_env(monkeypatch, tmp_path):
    """Both engines' archives tiered under ``tmp_path`` (the environment
    override: the transports, and so the JAX programs, stay shared)."""
    monkeypatch.setenv("RAFT_TPU_TIERED_DIR", str(tmp_path))
    return tmp_path


def assert_tiers_equal(p):
    assert p.t._tiered_store is not None
    assert_same_tree(p.j.store.root, p.t.store.root)
    a, b = p.j.store.tier_summary(), p.t.store.tier_summary()
    a.pop("seal_wall_s"), b.pop("seal_wall_s")
    assert a == b


def drain(p, ps):
    seqs = p.submit(ps)
    p.both("run_until_committed", seqs[-1], limit=40000.0)
    return seqs


def test_full_history_replay_past_retention(tier_env):
    p = Pair(11, **TKW)
    p.until_leader()
    ps = blobs(120, seed=12)
    drain(p, ps)
    got = ([], [])
    starts = [e.register_apply(lambda i, b, g=g: g.append(b), replay=True)
              for e, g in zip((p.j, p.t), got)]
    assert starts == [1, 1]
    assert got[1] == got[0] == ps
    assert p.t.store.stats["segments_sealed"] > 0
    p.check_all()
    assert_tiers_equal(p)


def test_lapped_rejoin_streams_from_sealed_tier(tier_env):
    p = Pair(13, **{**TKW, "log_capacity": 32}, tiered_hot_entries=16,
             segment_entries=8)
    lead = p.until_leader()
    dead = (lead + 1) % 3
    p.both("fail", dead)
    ps = blobs(96, seed=14)
    drain(p, ps)
    loads0 = p.t.store.stats["segment_loads"]
    p.both("recover", dead)
    p.both("run_for", 10 * p.t.cfg.heartbeat_period)
    e = p.t
    assert int(e._fetch(e.state.match_index)[dead]) >= 96
    assert e.store.stats["segment_loads"] > loads0
    assert e._shipper.chunks_total == p.j._shipper.chunks_total > 0
    lo = e.commit_watermark - e.cfg.log_capacity + 1
    want = np.frombuffer(b"".join(ps[lo - 1: e.commit_watermark]),
                         np.uint8).reshape(-1, ENTRY)
    np.testing.assert_array_equal(
        log_entries(e.state, dead, lo, e.commit_watermark), want)
    p.check_all()
    assert_tiers_equal(p)


def test_kill_mid_stream_resumes_from_last_acked_chunk(tier_env):
    p = Pair(15, **{**TKW, "log_capacity": 32}, tiered_hot_entries=16,
             segment_entries=8, catchup_max_chunks_per_tick=1)
    lead = p.until_leader()
    dead, other = (lead + 1) % 3, (lead + 2) % 3
    hb = p.t.cfg.heartbeat_period
    p.both("fail", dead)
    drain(p, blobs(96, seed=16))
    p.both("fail", other)
    p.submit(blobs(32, seed=17))
    p.both("run_for", 10 * hb)
    e = p.t
    assert e.commit_watermark == 96
    wm = e.commit_watermark
    p.both("recover", dead)
    for _ in range(40):
        p.both("run_for", hb)
        if e._shipper.chunks_total >= 2:
            break
    assert e._shipper.chunks_total >= 2
    base = e._shipper.streams[dead].base
    mid = int(e._fetch(e.state.match_index)[dead])
    assert base <= mid < wm
    before = e._shipper.chunks_total
    p.both("fail", dead)
    p.both("run_for", 4 * hb)
    assert e._shipper.chunks_total == before
    assert e._shipper.streams[dead].next == mid + 1
    p.both("recover", dead)
    for _ in range(60):
        p.both("run_for", hb)
        if int(e._fetch(e.state.match_index)[dead]) >= wm:
            break
    assert e._shipper.streams_started == 1
    assert int(e._fetch(e.state.match_index)[dead]) >= wm
    assert e._shipper.chunks_total == -(-(wm - base + 1) // 4)
    p.both("recover", other)
    p.both("run_for", 10 * hb)
    assert e.commit_watermark > wm
    p.check_all()
    assert_tiers_equal(p)


def test_flat_ladder_pin(tier_env):
    """Rejoin time is flat in history length: within 1.5x between a log
    ~2x the ring and one ~16x the ring, equal in both engines."""
    rejoin = {}
    for n in (128, 1024):
        p = Pair(17, **{**TKW, "log_capacity": 64, "batch_size": 8},
                 tiered_hot_entries=32, segment_entries=16)
        lead = p.until_leader()
        dead = (lead + 1) % 3
        p.both("fail", dead)
        seqs = p.both("submit_pipelined", [bytes(ENTRY)] * n)
        p.both("run_until_committed", seqs[-1], limit=80000.0)
        t0 = p.t.clock.now
        p.both("recover", dead)
        while p.t.clock.now < t0 + 4000.0:
            p.both("run_for", 2 * p.t.cfg.heartbeat_period)
            if int(p.t._fetch(p.t.state.match_index)[dead]) >= n:
                break
        assert int(p.t._fetch(p.t.state.match_index)[dead]) >= n
        rejoin[n] = p.t.clock.now - t0
        p.check_all(read_back=False)
        assert_tiers_equal(p)
    assert rejoin[1024] <= 1.5 * rejoin[128], rejoin


def test_checkpoint_restore_round_trip_with_tier(tier_env):
    """``save_checkpoint`` stays O(ring) with the tier on, both packages
    write the same file, and ``restore`` (into a fresh tier subdirectory)
    gives a working cluster in lock step."""
    from raft_tpu_torch.ckpt import EngineCheckpoint

    p = Pair(18, **TKW)
    p.until_leader()
    ps = blobs(80, seed=19)
    drain(p, ps)
    paths = (str(tier_env / "j.npz"), str(tier_env / "t.npz"))
    for e, path in zip((p.j, p.t), paths):
        e.save_checkpoint(path)
    ck = EngineCheckpoint.load(paths[1])
    assert ck.snap.last_index - ck.snap.base_index + 1 <= 2 * 16
    jck = EngineCheckpoint.load(paths[0])
    np.testing.assert_array_equal(ck.snap.entries, jck.snap.entries)
    q = Pair(18, restore_from=paths, **TKW)
    assert q.t.commit_watermark == 80
    assert q.t.store.get(80)[0] == ps[-1]
    assert q.t.store.root != p.t.store.root
    more = q.submit(blobs(40, seed=20))
    q.until_leader()
    q.both("run_until_committed", more[-1], limit=40000.0)
    q.check_all()
    assert_tiers_equal(q)


def test_status_snapshot_has_tier_section(tier_env):
    p = Pair(27, **TKW)
    p.until_leader()
    drain(p, blobs(80, seed=28))
    snaps = [e._status_snapshot() for e in (p.j, p.t)]
    for s in snaps:
        s["tiered"].pop("seal_wall_s")
    assert snaps[1]["tiered"] == snaps[0]["tiered"]
    assert snaps[1]["tiered"]["segments_sealed"] > 0
    assert "host_bytes" in snaps[1]["tiered"]


def test_no_tier_without_the_setting(monkeypatch):
    from raft_tpu_torch.ckpt import CheckpointStore

    monkeypatch.delenv("RAFT_TPU_TIERED_DIR", raising=False)
    p = Pair(29, **TKW)
    assert type(p.t.store) is CheckpointStore and p.t._tiered_store is None
    assert "tiered" not in p.t._status_snapshot()


def test_seal_counts_into_the_registry(tier_env):
    from raft_tpu.obs.registry import MetricsRegistry as JReg
    from raft_tpu_torch.obs.registry import MetricsRegistry as TReg

    p = Pair(30, **TKW)
    p.j.metrics, p.t.metrics = JReg(), TReg()
    p.until_leader()
    drain(p, blobs(80, seed=30))
    assert p.t.metrics.to_prometheus() == p.j.metrics.to_prometheus()
    assert "raft_segments_sealed_total" in p.t.metrics.to_prometheus()


# ------------------------------------------------------- admission lane
def gates(max_writes=16):
    from raft_tpu.admission import AdmissionGate as JGate
    from raft_tpu_torch.admission import AdmissionGate as TGate

    return [G(lambda: 0.0, max_writes=max_writes) for G in (JGate, TGate)]


@pytest.mark.parametrize("case", ["uncongested", "depth", "shedding",
                                  "ungated"])
def test_catchup_lane(case):
    got = []
    for g in gates(None if case == "ungated" else 16):
        if case == "shedding":
            g.shedding = True
        depth = {"depth": 8, "ungated": 10_000}.get(case, 0)
        got.append((g.catchup_chunks(depth=depth, max_chunks=4),
                    g.admitted["catchup"], g.catchup_throttled))
    assert got[1] == got[0]
    want = {"uncongested": 4, "depth": 1, "shedding": 1, "ungated": 4}
    assert got[1][0] == want[case]
