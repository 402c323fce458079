"""Snapshots and the snapshot stream (``raft_tpu_torch.ckpt`` and the
engine's ``_stream_snapshot``) against the JAX package.

The cases of ``tests/test_ckpt.py``: a plain and an erasure-coded replica
the ring has lapped rejoin through the chunked snapshot stream with both
engines in lock step (``Pair``: nodelog, rng, heap, stamps, every state
leaf, the archive and the apply stream equal after every event); the
archive compacts, keeps span blocks and raises its floor as the JAX
store does; snapshots and checkpoints saved by either package load in
the other, and ``install_snapshot`` / ``install_snapshot_all`` write the
same state leaves (the port encodes the shard rows on the device, the
JAX package with its host codec). Shapes: 3 replicas with 16-byte
entries, or RS(5,3) with 24-byte entries; B = 4, C = 16 or 32.
"""

import numpy as np
import pytest

from raft_tpu.ckpt import CheckpointStore as JStore
from raft_tpu.ckpt import EngineCheckpoint as JCheckpoint
from raft_tpu.ckpt import Snapshot as JSnapshot
from raft_tpu.ckpt import install_snapshot as j_install
from raft_tpu.ckpt import install_snapshot_all as j_install_all
from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core.state import init_state as j_init
from raft_tpu.ec.rs import RSCode as JCode
from raft_tpu_torch.ckpt import CheckpointStore as TStore
from raft_tpu_torch.ckpt import EngineCheckpoint as TCheckpoint
from raft_tpu_torch.ckpt import Snapshot as TSnapshot
from raft_tpu_torch.ckpt import install_snapshot as t_install
from raft_tpu_torch.ckpt import install_snapshot_all as t_install_all
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core.state import init_state as t_init
from raft_tpu_torch.core.state import log_entries
from raft_tpu_torch.ec.reconstruct import reconstruct
from raft_tpu_torch.ec.rs import RSCode as TCode
from tests._torch_port import assert_states_equal
from tests.test_torch_engine import Pair, payloads

PLAIN = dict(n_replicas=3, entry_bytes=16, batch_size=4, log_capacity=16)
EC = dict(n_replicas=5, entry_bytes=24, batch_size=4, log_capacity=16,
          rs_k=3, rs_m=2)


def drain(p, ps):
    seqs = p.submit(ps)
    p.until_committed(seqs[-1])
    return seqs


def _want(ps, lo, hi, entry):
    return np.frombuffer(b"".join(ps[lo - 1:hi]), np.uint8).reshape(-1, entry)


def test_plain_lapped_replica_rejoins_via_snapshot():
    p = Pair(1, **PLAIN)
    lead = p.until_leader()
    dead = (lead + 1) % 3
    p.both("fail", dead)
    ps = payloads(48, 2, entry=16)       # three ring laps past the dead row
    drain(p, ps)
    p.both("recover", dead)
    p.run_for(8 * p.t.cfg.heartbeat_period)
    p.check_all()
    assert any("snapshot stream complete" in ln for ln in p.tl)
    e = p.t
    assert int(e.state.match_index[dead]) >= 48
    assert int(e.state.commit_index[dead]) >= 48
    lo = e.commit_watermark - e.cfg.log_capacity + 1
    np.testing.assert_array_equal(
        log_entries(e.state, dead, lo, e.commit_watermark),
        _want(ps, lo, e.commit_watermark, 16))


def test_healthy_replicas_never_snapshot():
    p = Pair(2, **PLAIN)
    p.until_leader()
    drain(p, payloads(40, 3, entry=16))
    p.run_for(6 * p.t.cfg.heartbeat_period)
    p.check_all()
    assert not any("snapshot" in ln for ln in p.tl)


def test_ec_lapped_replica_rejoins_via_snapshot():
    """Under EC the heal refuses (every donor ring lapped the replica) and
    the stream installs re-encoded shard rows, chunk by chunk."""
    p = Pair(3, **EC)
    lead = p.until_leader()
    dead = (lead + 1) % 5
    p.both("fail", dead)
    ps = payloads(48, 4, entry=24)
    drain(p, ps)
    p.both("recover", dead)
    p.run_for(8 * p.t.cfg.heartbeat_period)
    p.check_all()
    assert any("snapshot chunk installed" in ln for ln in p.tl)
    e = p.t
    assert int(e.state.match_index[dead]) >= 48
    lo = e.commit_watermark - e.cfg.log_capacity + 1
    others = [q for q in range(5) if q != dead][:2]
    got = reconstruct(e.state, TCode(5, 3), [dead] + others, lo,
                      e.commit_watermark)
    np.testing.assert_array_equal(got, _want(ps, lo, e.commit_watermark, 24))


def test_kill_mid_stream_resumes_from_last_acked_chunk():
    """One chunk a tick: the follower is killed mid-stream and resumes
    from its last acked chunk (one stream for the whole transfer)."""
    p = Pair(15, **{**PLAIN, "log_capacity": 32,
                    "catchup_max_chunks_per_tick": 1})
    lead = p.until_leader()
    dead, other = (lead + 1) % 3, (lead + 2) % 3
    p.both("fail", dead)
    drain(p, payloads(96, 16, entry=16))
    p.both("fail", other)
    p.submit(payloads(32, 17, entry=16))     # the ring fills ahead of wm
    p.run_for(10 * p.t.cfg.heartbeat_period)
    wm = p.t.commit_watermark
    assert wm == 96
    p.both("recover", dead)
    while p.t._shipper.chunks_total < 2:
        p.run_for(p.t.cfg.heartbeat_period)
    mid = int(p.t.state.match_index[dead])
    assert p.t._shipper.streams[dead].base <= mid < wm
    before = p.t._shipper.chunks_total
    p.both("fail", dead)
    p.run_for(4 * p.t.cfg.heartbeat_period)
    assert p.t._shipper.chunks_total == before
    p.both("recover", dead)
    while int(p.t.state.match_index[dead]) < wm:
        p.run_for(p.t.cfg.heartbeat_period)
    assert p.t._shipper.streams_started == p.j._shipper.streams_started == 1
    assert p.t._shipper.chunks_total == p.j._shipper.chunks_total
    p.both("recover", other)
    p.run_for(10 * p.t.cfg.heartbeat_period)
    p.check_all()
    assert p.t.commit_watermark > wm


def test_store_archives_every_committed_entry():
    p = Pair(5, **PLAIN)
    p.until_leader()
    ps = payloads(20, 6, entry=16)
    drain(p, ps)
    assert p.t.store.covers(1, 20)
    np.testing.assert_array_equal(p.t.store.snapshot(1, 20).entries,
                                  _want(ps, 1, 20, 16))


def test_store_compaction_spans_and_floor():
    """Per-index puts, span blocks (whole and straddling the floor), the
    retention sweep and ``set_floor``: the port's store answers every
    ``get``, ``covers``, ``covered_lo`` and floor as the JAX store."""
    stores = (JStore(4, max_entries=24), TStore(4, max_entries=24))
    recs = [(i, i.to_bytes(4, "little")) for i in range(1, 200)]
    for st in stores:
        for i in range(1, 9):
            st.put(i, recs[i - 1][1], 1)
        st.put_span(9, recs[8:20], 2, pick=1)       # (seq, payload) records
        st.put_span(21, [r[1] for r in recs[20:30]], 2)
        st.put_span(21, [r[1] for r in recs[20:31]], 3)   # replaced in place
        st.put(25, b"over", 4)                      # a single put wins
        st.put_span(32, [r[1] for r in recs[31:40]], 3)
    for phase in ("swept", "floored"):
        j, t = stores
        assert (t.first, t.last, t.checkpoint_floor) == \
            (j.first, j.last, j.checkpoint_floor), phase
        for idx in range(0, 45):
            assert t.get(idx) == j.get(idx), (phase, idx)
            assert t.covered_lo(idx) == j.covered_lo(idx), (phase, idx)
            assert t.covers(max(1, idx - 5), idx) == \
                j.covers(max(1, idx - 5), idx), (phase, idx)
        assert sorted(t._spans) == sorted(j._spans) and \
            t._span_los == j._span_los, phase
        for st in stores:
            st.set_floor(30)
            st.set_floor(12)                        # never lowers


def _snap(cls, ps, base, term0=3):
    n = len(ps)
    return cls(base, base + n - 1,
               np.frombuffer(b"".join(ps), np.uint8).reshape(n, -1),
               np.arange(term0, term0 + n, dtype=np.int32))


@pytest.mark.parametrize("writer,reader", [(TSnapshot, JSnapshot),
                                           (JSnapshot, TSnapshot)],
                         ids=["torch-jax", "jax-torch"])
def test_snapshot_file_loads_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "snap.npz")
    src = _snap(writer, payloads(12, 8, entry=16), 5)
    src.save(path)
    got = reader.load(path)
    assert (got.base_index, got.last_index, got.last_term) == \
        (5, 16, src.last_term)
    np.testing.assert_array_equal(got.entries, src.entries)
    assert got.terms.dtype == np.int32
    np.testing.assert_array_equal(got.terms, src.terms)


@pytest.mark.parametrize("writer,reader", [(TCheckpoint, JCheckpoint),
                                           (JCheckpoint, TCheckpoint)],
                         ids=["torch-jax", "jax-torch"])
def test_checkpoint_file_loads_in_the_other_package(tmp_path, writer,
                                                    reader):
    snap_cls = TSnapshot if writer is TCheckpoint else JSnapshot
    path = str(tmp_path / "ck.npz")
    writer(snap=_snap(snap_cls, payloads(6, 9, entry=16), 1),
           terms=np.array([4, 4, 5], np.int32),
           voted_for=np.array([2, -1, 2], np.int32)).save(path)
    ck = reader.load(path)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["base_index", "last_index", "entries", "terms", "replica_terms",
             "voted_for", "member", "learner"])
    assert list(ck.terms) == [4, 4, 5] and list(ck.voted_for) == [2, -1, 2]
    assert ck.member.all() and not ck.learner.any()
    assert (ck.snap.base_index, ck.snap.last_index) == (1, 6)
    np.testing.assert_array_equal(ck.snap.entries,
                                  _want(payloads(6, 9, entry=16), 1, 6, 16))


@pytest.mark.parametrize("kw,n,code", [
    (PLAIN, 12, False), (PLAIN, 40, False), (EC, 12, True), (EC, 40, True),
], ids=["plain", "plain-lapped", "ec", "ec-lapped"])
def test_install_snapshot_matches_jax(tmp_path, kw, n, code):
    """Save, load and install into one row and into every row: the port's
    state leaves equal the JAX package's (40 entries: only the tail that
    fits the 16-slot ring is installed)."""
    kw = {**kw, "transport": "single"}
    entry = kw["entry_bytes"]
    path = str(tmp_path / "snap.npz")
    _snap(TSnapshot, payloads(n, 10, entry=entry), 3).save(path)
    jsnap, tsnap = JSnapshot.load(path), TSnapshot.load(path)
    rows = kw["n_replicas"]
    jcode = JCode(rows, 3) if code else None
    tcode = TCode(rows, 3) if code else None
    js = j_install(j_init(JConfig(**kw)), 1, jsnap, jsnap.last_term, 4, jcode)
    ts = t_install(t_init(TConfig(**kw), device="cpu"), 1, tsnap,
                   tsnap.last_term, 4, tcode)
    assert_states_equal(js, ts, "install_snapshot")
    js = j_install_all(j_init(JConfig(**kw)), jsnap, 0, 4, jcode)
    ts = t_install_all(t_init(TConfig(**kw), device="cpu"), tsnap, 0, 4,
                       tcode)
    assert_states_equal(js, ts, "install_snapshot_all")
    lo = max(3, n + 2 - 16 + 1)
    want = _want(payloads(n, 10, entry=entry), lo - 2, n, entry)
    got = (reconstruct(ts, tcode, [1, 3, 4], lo, n + 2) if code
           else log_entries(ts, 2, lo, n + 2))
    np.testing.assert_array_equal(got, want)
