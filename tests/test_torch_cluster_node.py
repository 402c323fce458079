"""The port's cluster replica (``raft_tpu_torch.cluster.node.RaftNode``) in
lock step with the JAX package's (``tests/_torch_cluster.py``): every unit
class of ``tests/test_cluster.py`` rerun through a ``Pair``, which after
each step holds the reply frames, the outbox, every field of the role
machine and every byte on disk (``wal.bin``, ``vote.json``, the segment
shards and manifest, ``death.json``, ``disk-stats.json``) of the port
equal to JAX's; the tiered store's restart handoff and manifest recovery
through both packages' ``TieredStore`` (shard trees byte for byte); the
death certificates through both ``Rendezvous``; and one three-node cluster
with no sockets (a synchronous frame router, one fake clock): an
election, 200 committed records, a follower killed and restarted on its
directory that adopts its segments and rejoins by the snapshot stream.
"""

import os
import random

import numpy as np
import pytest

from tests._torch_cluster import (
    PACKAGES,
    PEERS3,
    Pair,
    Trio,
    assert_same,
    fake_time,
    mod,
    one_frame,
    tree,
)

ENTRY = 16


def blobs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, ENTRY, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _pair(tmp_path, node_id=1, **kw):
    """``tests/test_cluster.py``'s ``_node`` sizes, as a pair."""
    kw.setdefault("heartbeat_s", 0.01)
    kw.setdefault("election_timeout_s", 0.05)
    kw.setdefault("segment_entries", 8)
    kw.setdefault("hot_entries", 16)
    return Pair(tmp_path, node_id=node_id, **kw)


def _rec(key: bytes, value: bytes) -> bytes:
    got = {pkg: mod(pkg, "cluster.node").pack_record(key, value)
           for pkg in PACKAGES}
    assert got["raft_tpu"] == got["raft_tpu_torch"]
    return got["raft_tpu"]


def _decode(name, blob):
    return getattr(mod("raft_tpu", "net.protocol"), name)(one_frame(blob)[1])


# -------------------------------------------------- records and formats
def test_record_format_and_constants_are_jax_s():
    jn, tn = mod("raft_tpu", "cluster.node"), mod("raft_tpu_torch",
                                                   "cluster.node")
    assert tn.REC_BYTES == jn.REC_BYTES == 64
    assert tn._WAL_REC.format == jn._WAL_REC.format == "!BQII"
    assert tn._WAL_HDR.format == jn._WAL_HDR.format
    for key, value in ((b"k", b"v"), (b"", b""), (b"x" * 40, b"y" * 21)):
        rec = tn.pack_record(key, value)
        assert rec == jn.pack_record(key, value)
        assert tn.unpack_record(rec) == jn.unpack_record(rec)
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="record overflow"):
            mod(pkg, "cluster.node").pack_record(b"x" * 40, b"y" * 22)


# -------------------------------------------------- manifest handoff
class TierPair:
    """A JAX and a port ``TieredStore`` on their own roots."""

    def __init__(self, root, **kw):
        self.root = str(root)
        self.kw = kw
        self.s = {pkg: mod(pkg, "ckpt.tiered").TieredStore(
            ENTRY, root=os.path.join(self.root, pkg), **kw)
            for pkg in PACKAGES}
        self.check()

    def reopen(self, **kw):
        self.__init__(self.root, **dict(self.kw, **kw))

    def put(self, i, blob, term):
        for s in self.s.values():
            s.put(i, blob, term)
        self.check()

    def get(self, i):
        got = [s.get(i) for s in self.s.values()]
        assert got[0] == got[1]
        return got[0]

    def check(self):
        j, t = self.s["raft_tpu"], self.s["raft_tpu_torch"]
        assert j.stats == t.stats
        assert j._sealed == t._sealed and j._sealed_hi == t._sealed_hi
        assert j.generation == t.generation
        assert_same(tree(os.path.join(self.root, "raft_tpu")),
                    tree(os.path.join(self.root, "raft_tpu_torch")), "tier")

    @property
    def j(self):
        return self.s["raft_tpu"]


class TestManifestHandoff:
    def test_adopt_inherits_sealed_segments_without_resealing(self, tmp_path):
        ps = blobs(100, seed=9)
        tp = TierPair(tmp_path, hot_entries=16, segment_entries=8)
        for i, b in enumerate(ps, 1):
            tp.put(i, b, 1)
        sealed = tp.j.stats["segments_sealed"]
        assert sealed >= 1 and tp.j.generation == 1
        tp.reopen(adopt=True)
        assert tp.j.generation == 2
        assert tp.j.stats["segments_adopted"] == sealed
        assert tp.j.stats["segments_resealed"] == 0
        assert tp.j.stats["segments_sealed"] == 0
        lo, hi = tp.j._sealed[0]
        for i in (lo, hi):
            assert tp.get(i) == (ps[i - 1], 1)
        hole_lo = tp.j._sealed_hi + 1
        for j, b in enumerate(blobs(60, seed=10), 101):
            tp.put(j, b, 2)
        assert tp.j.stats["segments_sealed"] == 0
        for i in range(hole_lo, 101):
            tp.put(i, ps[i - 1], 1)
        tp.put(161, bytes(ENTRY), 2)
        assert tp.j.stats["segments_sealed"] >= 1
        assert tp.j.stats["segments_resealed"] == 0

    def test_adopt_on_empty_root_is_generation_one(self, tmp_path):
        tp = TierPair(tmp_path, hot_entries=16, segment_entries=8,
                      adopt=True)
        assert tp.j.generation == 1
        assert tp.j.stats["segments_adopted"] == 0


# ------------------------------------------------- death certificates
class TestDeathCertificates:
    @staticmethod
    def _cert(c):
        return {k: v for k, v in c.items() if k != "time"}

    def _both(self, tmp_path, fn):
        out = []
        for pkg in PACKAGES:
            root = str(tmp_path / pkg)
            os.makedirs(root, exist_ok=True)
            out.append(fn(mod(pkg, "transport.reform").Rendezvous, root))
        assert out[0] == out[1]
        return out[0]

    def test_certificate_overrides_recency_and_self_heals(self, tmp_path):
        def run(Rendezvous, root):
            victim = Rendezvous(root, pid=0)
            observer = Rendezvous(root, pid=-1)
            victim.heartbeat(epoch=1, round_no=3, wm=10, ckpt=None)
            seen = [0 in observer.fresh_peers(stale_s=30.0)]
            observer.declare_dead(0, evidence="waitpid")
            seen.append(0 in observer.fresh_peers(stale_s=30.0))
            seen.append({k: self._cert(c)
                         for k, c in observer.declared_dead().items()})
            victim.heartbeat(epoch=1, round_no=4, wm=11, ckpt=None)
            seen.append(0 in observer.fresh_peers(stale_s=30.0))
            seen.append(observer.declared_dead())
            return seen

        seen = self._both(tmp_path, run)
        assert seen[0] is True and seen[1] is False
        assert seen[2][0]["evidence"] == "waitpid" and seen[2][0]["beat"] == 1
        assert seen[3] is True and seen[4] == {}

    def test_clear_dead_is_idempotent(self, tmp_path):
        def run(Rendezvous, root):
            rv = Rendezvous(root, pid=-1)
            rv.clear_dead(7)
            rv.declare_dead(7, evidence="test")
            rv.clear_dead(7)
            rv.clear_dead(7)
            return rv.declared_dead()

        assert self._both(tmp_path, run) == {}


# -------------------------------------------- consensus-safety pins
class TestSnapStreamConflicts:
    def test_chunk_truncates_conflicting_uncommitted_tail(self, tmp_path):
        p = _pair(tmp_path)
        p.set(log=[(1, _rec(b"a", b"1")), (2, _rec(b"b", b"stale")),
                   (2, _rec(b"c", b"stale"))],
              commit=1, applied=1, kv={b"a": b"1"})
        ents = [(3, _rec(b"b", b"new2")), (3, _rec(b"c", b"new3"))]
        (ack,) = p.frame(lambda P: P.encode_peer_snap_chunk(
            0, term=3, base=2, last_total=3, commit=3, entries=ents))
        assert p.t.log[1][0] == 3 and p.t.log[2][0] == 3
        assert p.t.commit == 3 and p.t.kv[b"b"] == b"new2"
        assert _decode("decode_peer_snap_ack", ack) == (1, 3, 3)

    def test_matching_overlap_is_idempotent(self, tmp_path):
        p = _pair(tmp_path)
        p.set(log=[(1, _rec(b"a", b"1")), (1, _rec(b"b", b"2"))],
              commit=2, applied=2)
        ents = [(1, _rec(b"a", b"1")), (1, _rec(b"b", b"2"))]
        (ack,) = p.frame(lambda P: P.encode_peer_snap_chunk(
            0, term=1, base=1, last_total=2, commit=2, entries=ents))
        assert p.t.last_idx == 2
        assert _decode("decode_peer_snap_ack", ack)[2] == 2

    def test_gap_reacks_committed_floor_not_raw_last_idx(self, tmp_path):
        p = _pair(tmp_path)
        p.set(log=[(1, _rec(b"a", b"1")), (1, _rec(b"b", b"2")),
                   (2, _rec(b"c", b"??")), (2, _rec(b"d", b"??"))],
              commit=2, applied=2)
        (ack,) = p.frame(lambda P: P.encode_peer_snap_chunk(
            0, term=3, base=10, last_total=12, commit=12, entries=[]))
        assert _decode("decode_peer_snap_ack", ack)[2] == 2


class TestDurabilityTermCheck:
    def test_is_durable_raises_when_entry_superseded(self, tmp_path):
        p = _pair(tmp_path)
        p.set(role="leader", term=1)
        _, seq = p.call("submit", b"k", b"mine")
        assert seq == 1 and p.call("is_durable", 0, seq) is False
        p.frame(lambda P: P.encode_peer_append(
            2, term=2, prev_idx=0, prev_term=0, commit=1, round_no=1,
            entries=[(2, _rec(b"k", b"theirs"))]))
        assert p.t.commit >= seq
        with pytest.raises(Exception) as ex:
            p.call("is_durable", 0, seq)
        assert type(ex.value).__name__ == "NotLeader"

    def test_is_durable_true_when_own_entry_commits(self, tmp_path):
        p = _pair(tmp_path)
        p.set(role="leader", term=1)
        _, seq = p.call("submit", b"k", b"v")
        p.call("_wal_extend", p.t.last_idx)
        p.set(match_idx={0: 1, 2: 1})
        p.call("_advance_commit", p.clock.t)
        assert p.call("is_durable", 0, seq) is True


class TestFreshLeaderReadGate:
    def test_reads_refused_until_current_term_commit(self, tmp_path):
        p = _pair(tmp_path)
        p.set(log=[(1, _rec(b"a", b"1"))], commit=1, applied=1,
              kv={b"a": b"1"}, role="leader", term=2)
        with pytest.raises(Exception) as ex:
            p.call("begin_read", "linearizable", b"a", {})
        assert type(ex.value).__name__ == "ReadLagging"
        assert p.call("begin_read", "session", b"a", {}).value == b"1"
        p.set(log=[(1, _rec(b"a", b"1")), (2, _rec(b"", b""))],
              commit=2, applied=2)
        out = p.call("begin_read", "linearizable", b"a", {})
        assert type(out).__name__ == "_Pending"


class TestLeaseClock:
    def test_failed_replies_carry_no_evidence(self, tmp_path):
        p = _pair(tmp_path)
        p.set(role="leader", term=1, _round_sent={7: 100.0})
        p.frame(lambda P: P.encode_peer_append_reply(
            0, term=1, success=False, match_idx=0, round_no=7))
        assert p.t.ack_at == {} and p.t.peer_round.get(0, 0) == 0

    def test_lease_clock_runs_from_send_time(self, tmp_path):
        p = _pair(tmp_path)
        p.set(log=[(1, _rec(b"a", b"1"))] * 3, role="leader", term=1,
              _wal_hi=3, _round_sent={7: 100.0})
        p.frame(lambda P: P.encode_peer_append_reply(
            0, term=1, success=True, match_idx=3, round_no=7))
        assert p.t.ack_at[0] == 100.0
        assert p.t.peer_round[0] == 7 and p.t.match_idx[0] == 3
        p2 = _pair(tmp_path, node_id=2)
        p2.set(role="leader", term=1)
        p2.frame(lambda P: P.encode_peer_append_reply(
            0, term=1, success=True, match_idx=0, round_no=99))
        assert p2.t.ack_at == {}

    def test_lease_clamped_under_minimum_election_timeout(self, tmp_path):
        p = _pair(tmp_path, lease_s=5.0, election_timeout_s=0.3)
        assert p.t.lease_s == p.j.lease_s <= 0.8 * 0.3 + 1e-9

    def test_vote_stickiness_guards_the_lease(self, tmp_path):
        p = _pair(tmp_path)
        p.set(leader_id=0, last_heard=p.clock.t)

        def vote(P):
            return P.encode_peer_vote(2, term=9, last_idx=100, last_term=9)

        (rep,) = p.frame(vote)
        _, term, granted, _pv = _decode("decode_peer_vote_reply", rep)
        assert granted is False and p.t.term == 0 and p.t.voted_for is None
        p.set(last_heard=p.clock.t - 10.0)
        (rep,) = p.frame(vote)
        _, term, granted, _pv = _decode("decode_peer_vote_reply", rep)
        assert granted is True and p.t.term == 9 and p.t.voted_for == 2


class TestAppendAckWal:
    def test_acked_log_survives_kill_minus_nine(self, tmp_path):
        p = _pair(tmp_path)
        recs = [(1, _rec(b"k%d" % i, b"v%d" % i)) for i in range(1, 31)]
        (rep,) = p.frame(lambda P: P.encode_peer_append(
            0, term=1, prev_idx=0, prev_term=0, commit=20, round_no=1,
            entries=recs))
        assert _decode("decode_peer_append_reply", rep)[2] is True
        assert p.t.last_idx == 30 and p.t.commit == 20
        sealed = p.t.store._sealed_hi
        p.build()                                # kill -9: new processes
        assert p.t.last_idx == 30
        assert [t for t, _ in p.t.log] == [1] * 30
        assert p.t.commit == sealed
        assert p.t.store.stats["segments_resealed"] == 0
        p.frame(lambda P: P.encode_peer_append(
            0, term=1, prev_idx=30, prev_term=1, commit=30, round_no=2,
            entries=[]))
        assert p.t.commit == 30 and p.t.kv[b"k30"] == b"v30"

    def test_torn_wal_tail_is_dropped_not_fatal(self, tmp_path):
        p = _pair(tmp_path)
        p.frame(lambda P: P.encode_peer_append(
            0, term=1, prev_idx=0, prev_term=0, commit=0, round_no=1,
            entries=[(1, _rec(b"a", b"1")), (1, _rec(b"b", b"2"))]))
        for n in p.nodes.values():
            with open(n._wal_path, "ab") as f:
                f.write(b"\x01torn-half-record")
        p.build()
        assert p.t.last_idx == 2

    def test_heartbeat_commit_clamps_to_validated_prefix(self, tmp_path):
        p = _pair(tmp_path)
        p.set(log=[(1, _rec(b"a", b"1")), (2, _rec(b"b", b"??")),
                   (2, _rec(b"c", b"??"))],
              commit=1, applied=1, kv={b"a": b"1"})
        p.frame(lambda P: P.encode_peer_append(
            0, term=3, prev_idx=1, prev_term=1, commit=3, round_no=1,
            entries=[]))
        assert p.t.commit == 1


# ------------------------------------------- storage-fault units
class TestWalCrcRecovery:
    def _filled(self, tmp_path, n_entries=12):
        p = _pair(tmp_path)
        recs = [(1, _rec(b"k%d" % i, b"v%d" % i))
                for i in range(1, n_entries + 1)]
        p.frame(lambda P: P.encode_peer_append(
            0, term=1, prev_idx=0, prev_term=0, commit=0, round_no=1,
            entries=recs))
        assert p.t.last_idx == n_entries
        return p

    @staticmethod
    def _flip(p):
        """The same seeded bit flip on both packages' WALs, each through
        its own package's helper."""
        pos = {pkg: mod(pkg, "cluster.storage").flip_file_bit(
            p.nodes[pkg]._wal_path, random.Random(3)) for pkg in PACKAGES}
        assert pos["raft_tpu"] == pos["raft_tpu_torch"]
        p.check()
        return pos["raft_tpu"]

    def test_midfile_bit_rot_truncates_never_skips(self, tmp_path):
        p = self._filled(tmp_path)
        pos = self._flip(p)
        assert pos > 0
        p.build()
        assert p.t.last_idx == pos // (17 + 64)
        assert p.t.stats["wal_truncated_records"] >= 1
        assert p.t.stats["wal_skipped_corrupt"] == 0

    def test_skip_corrupt_broken_mode_shifts_the_log(self, tmp_path,
                                                     monkeypatch):
        p = self._filled(tmp_path, n_entries=12)
        self._flip(p)
        monkeypatch.setenv("RAFT_TPU_WAL_SKIP_CORRUPT", "1")
        p.build()
        assert p.t.stats["wal_skipped_corrupt"] >= 1
        assert p.t.last_idx == 12 - p.t.stats["wal_skipped_corrupt"]
        assert p.t.stats["wal_truncated_records"] == 0


class TestWalGroupCommit:
    def test_ack_defers_until_the_shared_fsync(self, tmp_path):
        p = _pair(tmp_path, wal_group_commit=True)
        f0 = p.t.stats["wal_fsyncs"]
        replies = []
        for i in (1, 2, 3):
            replies.extend(p.frame(lambda P, i=i: P.encode_peer_append(
                0, term=1, prev_idx=i - 1, prev_term=1 if i > 1 else 0,
                commit=0, round_no=i,
                entries=[(1, _rec(b"k%d" % i, b"v"))])))
        assert replies == []
        assert p.call("wal_flush_pending")
        assert p.t._wal_written == 3 and p.t._wal_hi == 0
        out = p.call("flush_wal")
        assert p.t.stats["wal_fsyncs"] == f0 + 1
        assert p.t._wal_hi == 3 and len(out) == 3
        peer, frame = out[-1]
        assert peer == 0
        _, term, ok, match, rnd = _decode("decode_peer_append_reply", frame)
        assert ok is True and match == 3 and rnd == 3

    def test_stale_term_deferred_acks_are_dropped(self, tmp_path):
        p = _pair(tmp_path, wal_group_commit=True)
        assert p.frame(lambda P: P.encode_peer_append(
            0, term=1, prev_idx=0, prev_term=0, commit=0, round_no=1,
            entries=[(1, _rec(b"a", b"1"))])) == []
        p.frame(lambda P: P.encode_peer_append(
            2, term=5, prev_idx=0, prev_term=0, commit=0, round_no=9,
            entries=[]))
        assert p.t.term == 5
        out = p.call("flush_wal")
        assert [q for q, _ in out] == [2]
        assert all(_decode("decode_peer_append_reply", f)[1] == 5
                   for _, f in out)
        assert p.t._wal_hi == 1


class TestFaultyIOFailStop:
    @staticmethod
    def _plan(p, plan):
        for pkg in PACKAGES:
            mod(pkg, "cluster.storage").write_plan(p.dir(pkg), plan)

    def _faulty(self, tmp_path, plan):
        """Write ``plan`` into both nodes' directories first, then build
        the pair over FaultyIO (a plan present at boot, as a drill child
        sees it)."""
        for pkg in PACKAGES:
            d = str(tmp_path / pkg / "n1")
            os.makedirs(d, exist_ok=True)
            mod(pkg, "cluster.storage").write_plan(d, plan)
        return _pair(tmp_path, io="faulty")

    def test_fsync_eio_fail_stops_with_death_certificate(self, tmp_path):
        import json

        p = self._faulty(tmp_path, {"seed": 0, "eio_arm": True})
        errs = p.build_error
        assert errs is not None
        assert type(errs["raft_tpu_torch"]).__name__ == "DiskFailStop"
        cert = json.loads((tmp_path / "raft_tpu_torch" / "n1" /
                           "death.json").read_text())
        assert cert["errno"] == 5 and cert["where"]
        ios = p.last_io
        assert (ios["raft_tpu"].stats == ios["raft_tpu_torch"].stats)
        assert ios["raft_tpu_torch"].stats["eio_raised"] == 1
        assert ios["raft_tpu_torch"].stats["fsync_after_eio"] == 0
        for pkg, io in ios.items():
            h = io.open_append(os.path.join(p.dir(pkg), "x.bin"))
            with pytest.raises(OSError):
                h.fsync()
        assert ios["raft_tpu"].stats == ios["raft_tpu_torch"].stats
        assert ios["raft_tpu_torch"].stats["fsync_after_eio"] == 1
        p.check()

    def test_disk_full_sheds_typed_never_corrupts(self, tmp_path):
        p = self._faulty(tmp_path, {"seed": 0})
        p.set(role="leader", term=1)
        p.call("submit", b"k", b"v1")
        p.call("_wal_extend", p.t.last_idx)
        before = open(p.t._wal_path, "rb").read()
        self._plan(p, {"seed": 0, "full_until_ts": p.clock.time() + 30})
        p.clock.advance(0.06)                    # one plan-poll period
        with pytest.raises(Exception) as ex:
            p.call("submit", b"k", b"v2")
        assert type(ex.value).__name__ == "Overloaded"
        assert ex.value.reason == "disk_full"
        assert p.t.stats["disk_full_shed"] == 1
        assert open(p.t._wal_path, "rb").read() == before

    def test_fsync_lies_loses_the_acked_suffix(self, tmp_path):
        p = self._faulty(tmp_path, {"seed": 0, "fsync_lies": True})
        (rep,) = p.frame(lambda P: P.encode_peer_append(
            0, term=1, prev_idx=0, prev_term=0, commit=0, round_no=1,
            entries=[(1, _rec(b"a", b"1")), (1, _rec(b"b", b"2"))]))
        assert _decode("decode_peer_append_reply", rep)[2] is True
        assert p.t._wal_hi == 2
        assert os.path.getsize(p.t._wal_path) == 0
        p.io_kind = None                         # restart on the real bytes
        p.build()
        assert p.t.last_idx == 0

    def test_torn_stall_and_flip_plans_match(self, tmp_path):
        """The plan hooks the drill arms one by one, composed on one node
        under group commit: torn write-back of the un-fsynced tail, every
        second fsync stalled (on the fake clock), a bit flipped after the
        third fsync; then a restart on what reached the file."""
        p = self._faulty(tmp_path, {"seed": 4, "torn": True,
                                    "stall_every": 2, "stall_s": 0.05,
                                    "flip_after_fsync": [3]})
        p.set(wal_group_commit=True)
        for i in range(1, 9):
            p.frame(lambda P, i=i: P.encode_peer_append(
                0, term=1, prev_idx=i - 1, prev_term=1 if i > 1 else 0,
                commit=0, round_no=i,
                entries=[(1, _rec(b"k%d" % i, b"v%d" % i))]))
            if i % 3 == 0:
                p.call("flush_wal")
        assert p.j._io.stats["stalls"] >= 1
        assert p.j._io.stats["flips"] == 1
        p.io_kind = None
        p.build()


class TestManifestRecovery:
    def _sealed_store(self, tmp_path):
        ps = blobs(64, seed=21)
        tp = TierPair(tmp_path, hot_entries=16, segment_entries=8)
        for i, b in enumerate(ps, 1):
            tp.put(i, b, 1)
        assert tp.j.stats["segments_sealed"] >= 2
        return tp, ps

    def test_torn_manifest_falls_back_to_prev_generation(self, tmp_path):
        tp, ps = self._sealed_store(tmp_path)
        for pkg in PACKAGES:
            assert mod(pkg, "cluster.storage").torn_truncate(
                os.path.join(str(tmp_path), pkg, "manifest.json"))
        tp.reopen(adopt=True)
        assert tp.j.stats["manifest_fallbacks"] == 1
        assert tp.j.stats["segments_adopted"] >= 1
        assert tp.j.stats["segments_resealed"] == 0
        lo, hi = tp.j._sealed[0]
        assert tp.get(lo) == (ps[lo - 1], 1)

    def test_missing_manifest_double_crash_rides_prev(self, tmp_path):
        tp, _ = self._sealed_store(tmp_path)
        for pkg in PACKAGES:
            os.unlink(os.path.join(str(tmp_path), pkg, "manifest.json"))
        tp.reopen(adopt=True)
        assert tp.j.stats["manifest_fallbacks"] == 1
        assert tp.j.stats["segments_adopted"] >= 1

    def test_both_manifests_corrupt_is_a_fresh_start(self, tmp_path):
        tp, _ = self._sealed_store(tmp_path)
        for pkg in PACKAGES:
            for name in ("manifest.json", "manifest.json.prev"):
                p = os.path.join(str(tmp_path), pkg, name)
                if os.path.exists(p):
                    with open(p, "w") as f:
                        f.write("{ rotten")
        tp.reopen(adopt=True)
        assert tp.j.stats["segments_adopted"] == 0
        assert tp.j._sealed == []

    def test_every_crash_state_has_a_loadable_manifest(self, tmp_path):
        import json

        self._sealed_store(tmp_path)
        for name in ("manifest.json", "manifest.json.prev"):
            with open(os.path.join(str(tmp_path), "raft_tpu_torch",
                                   name)) as f:
                assert json.load(f)["sealed"]

    def test_flipped_sealed_shard_is_reconstructed(self, tmp_path):
        """The drill's shard rot through both packages' helper: the same
        seeded flip in the oldest data shard, and both adopting stores
        read the segment back through the RS decode."""
        tp, ps = self._sealed_store(tmp_path)
        got = [mod(pkg, "cluster.storage").flip_sealed_shard(
            os.path.join(str(tmp_path), pkg), random.Random(5))
            for pkg in PACKAGES]
        assert [os.path.basename(g) for g in got] == [
            os.path.basename(got[0])] * 2
        tp.reopen(adopt=True)
        lo, _ = tp.j._sealed[0]
        assert tp.get(lo) == (ps[lo - 1], 1)
        assert tp.j.stats["segment_reconstructs"] >= 1
        tp.check()


# ------------------------------------------------------- check quorum
class TestCheckQuorum:
    def test_stale_ack_quorum_demotes_the_leader(self, tmp_path):
        p = _pair(tmp_path)
        now = p.clock.t
        p.set(role="leader", term=3, leader_id=1, _lead_since=now - 10.0,
              ack_at={0: now - 10.0, 2: now - 10.0})
        p.call("tick", now)
        assert p.t.role == "follower"
        assert p.t.leader_id is None
        assert p.t.stats["leader_demotions"] == 1

    def test_fresh_leader_gets_a_full_timeout_of_grace(self, tmp_path):
        p = _pair(tmp_path)
        now = p.clock.t
        p.set(role="leader", term=3, _lead_since=now)
        p.call("tick", now)
        assert p.t.role == "leader"
        assert p.t.stats["leader_demotions"] == 0

    def test_one_live_follower_sustains_the_quorum(self, tmp_path):
        p = _pair(tmp_path)
        now = p.clock.t
        p.set(role="leader", term=3, _lead_since=now - 10.0, ack_at={0: now})
        p.call("tick", now)
        assert p.t.role == "leader"
        assert p.t.stats["leader_demotions"] == 0


# ------------------------------------------- stale-round discipline
class TestStaleRoundDiscipline:
    def _leader(self, tmp_path, node_id=1):
        p = _pair(tmp_path, node_id=node_id)
        p.set(log=[(1, _rec(b"a", b"1"))] * 3, role="leader", term=1,
              _wal_hi=3)
        return p

    @staticmethod
    def _reply(round_no):
        return lambda P: P.encode_peer_append_reply(
            0, term=1, success=True, match_idx=3, round_no=round_no)

    def test_duplicated_reply_is_counted_and_credits_nothing(self, tmp_path):
        p = self._leader(tmp_path)
        p.set(_round_sent={7: 100.0})
        p.frame(self._reply(7))
        assert p.t.ack_at[0] == 100.0
        p.frame(self._reply(7))
        assert p.t.ack_at[0] == 100.0
        assert p.t.stats["stale_round_ignored"] == 1

    def test_pruned_round_replay_is_counted(self, tmp_path):
        p = self._leader(tmp_path)
        p.frame(self._reply(99))
        assert p.t.ack_at == {}
        assert p.t.stats["stale_round_ignored"] == 1

    def test_broken_env_clocks_arrival_not_send(self, tmp_path,
                                                monkeypatch):
        monkeypatch.setenv("RAFT_TPU_LEASE_STALE_ROUND", "1")
        p = self._leader(tmp_path)
        p.frame(self._reply(99))
        assert p.t.ack_at == {0: p.clock.t}
        assert p.t.stats["stale_round_ignored"] == 0


# --------------------------------------------- snap stream cursor
class TestSnapStreamCursor:
    def _streaming_leader(self, tmp_path):
        p = _pair(tmp_path, snap_chunk=4, snap_threshold=4)
        p.set(log=[(2, _rec(b"k%d" % i, b"v%d" % i)) for i in range(1, 13)],
              role="leader", term=2, commit=12, _wal_hi=12)
        return p

    @staticmethod
    def _base(frame):
        return _decode("decode_peer_snap_chunk", frame)[2]

    @staticmethod
    def _ack(match):
        return lambda P: P.encode_peer_snap_ack(0, term=2, match_idx=match)

    def test_duplicated_ack_leaves_the_cursor_exact(self, tmp_path):
        p = self._streaming_leader(tmp_path)
        p.call("_start_snap", 0)
        ((_, first),) = p.t.outbox
        assert self._base(first) == 1
        p.set(outbox=[])
        p.frame(self._ack(4))
        ((_, nxt),) = p.t.outbox
        assert self._base(nxt) == 5
        p.set(outbox=[])
        p.frame(self._ack(4))
        ((_, dup),) = p.t.outbox
        assert self._base(dup) == 5
        assert p.t.match_idx[0] == 4

    def test_torn_stream_resumes_from_last_acked_cursor(self, tmp_path):
        p = self._streaming_leader(tmp_path)
        p.call("_start_snap", 0)
        p.set(outbox=[])
        p.frame(self._ack(4))
        p.set(outbox=[])
        now = p.clock.t
        p.set(_snap_sent={0: now - 1.0})
        p.call("_broadcast_appends", now, heartbeat=True)
        P = mod("raft_tpu", "net.protocol")
        chunks = [f for q, f in p.t.outbox
                  if q == 0 and one_frame(f)[0] == P.PEER_SNAP_CHUNK]
        assert len(chunks) == 1
        assert self._base(chunks[0]) == 5

    def test_final_ack_closes_the_stream(self, tmp_path):
        p = self._streaming_leader(tmp_path)
        p.call("_start_snap", 0)
        p.frame(self._ack(12))
        assert 0 not in p.t.snap_mode
        assert p.t.next_idx[0] == 13


# --------------------------------------- backend surface and control
class TestBackendSurface:
    def test_status_hint_and_deny_lists(self, tmp_path):
        """The ingest-server duck type and the ``ctrl-<id>.json`` /
        ``net.json`` deny-lists, read on the next tick by both nodes."""
        import json

        p = _pair(tmp_path)
        assert p.call("meta") == (64, 1)
        assert p.call("leader_hint", 0) == ""
        p.set(leader_id=2)
        assert p.call("leader_hint", 0) == PEERS3[2]
        for pkg in PACKAGES:
            with open(os.path.join(p.dir(pkg), "ctrl-1.json"), "w") as f:
                json.dump({"deny": [2]}, f)
            with open(os.path.join(p.dir(pkg), "net.json"), "w") as f:
                json.dump({"deny_to": [0]}, f)
        p.call("tick", p.clock.t)
        assert p.t.deny == {2} and p.t.deny_to == {0}
        p.frame(lambda P: P.encode_peer_vote(2, term=5, last_idx=0,
                                             last_term=0))
        assert p.t.stats["denied_frames"] == 1
        for pkg in PACKAGES:
            os.unlink(os.path.join(p.dir(pkg), "ctrl-1.json"))
            os.unlink(os.path.join(p.dir(pkg), "net.json"))
        p.call("tick", p.clock.advance(0.001))
        assert p.t.deny == set() and p.t.deny_to == set()
        p.call("status")


# ----------------------------------------- a cluster with no sockets
def test_three_nodes_elect_commit_200_and_a_restart_adopts(tmp_path):
    """Three pairs behind a synchronous router on one fake clock (the
    child's sizes: 50 ms heartbeat, 400 ms election timeout, snapshot
    threshold 24, 16-entry segments, 32 hot entries, group commit): an
    election, 200 committed records, node 2 killed mid-run and restarted
    on its directory after the log moved past the stream threshold. It
    adopts its sealed segments (none resealed) and catches up by the
    snapshot stream; every node's digest, state and bytes equal the JAX
    trio's at every step."""
    trio = Trio(tmp_path, heartbeat_s=0.05, election_timeout_s=0.4,
                snap_threshold=24, segment_entries=16, hot_entries=32,
                wal_group_commit=True)
    with fake_time(trio.clock):
        for _ in range(40):
            trio.tick(0.025)
            if trio.leader() is not None:
                break
        lead = trio.leader()
        assert lead is not None
        written = 0

        def write(n):
            nonlocal written
            lp = trio.pairs[trio.leader()]
            for _ in range(n):
                written += 1
                lp.call("submit", b"k%d" % (written % 7), b"v%d" % written)
            trio.tick(0.025)

        victim = next(i for i in range(3) if i != lead)
        while written < 120:
            write(10)
        trio.kill(victim)
        while written < 200:
            write(10)
        for _ in range(8):
            trio.tick(0.025)
        live = [i for i in range(3) if i != victim]
        target = max(trio.pairs[i].t.commit for i in live)
        assert target >= 201                    # 200 records + the noop
        trio.restart(victim)
        vp = trio.pairs[victim]
        assert vp.t.generation >= 2
        assert vp.t.store.stats["segments_adopted"] >= 1
        for _ in range(80):
            trio.tick(0.025)
            if vp.t.commit >= target:
                break
        assert vp.t.commit >= target
        for _ in range(4):                      # commit reaches everyone
            trio.tick(0.025)
        assert vp.t.stats["snap_chunks_in"] >= 1
        assert vp.t.store.stats["segments_resealed"] == 0
        digests = {i: p.t.status()["digest_ckpts"]
                   for i, p in trio.pairs.items()}
        shared = set(dict(digests[0])) & set(dict(digests[1])) & set(
            dict(digests[2]))
        for idx in shared:
            assert len({dict(d)[idx] for d in digests.values()}) == 1
        kvs = [p.t.kv for p in trio.pairs.values()]
        assert kvs[0] == kvs[1] == kvs[2]
