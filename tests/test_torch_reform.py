"""The port's process-group re-formation (``raft_tpu_torch.transport.
reform``) against the JAX package's: the five failure-detector cases of
``tests/test_reform_detector.py`` through the port, and the shared
rendezvous directory — the same operations write the same files byte for
byte in either package, and a JAX ``Rendezvous`` and a port one on one
directory read each other's heartbeats, certificates, epochs and joins.
"""

import json
import os
import socket
import time

import pytest

from raft_tpu.transport.reform import Epoch as JEpoch
from raft_tpu.transport.reform import Rendezvous as JRendezvous
from raft_tpu_torch.transport import Epoch, Rendezvous


def _write_hb(root, pid, stamp, beat):
    with open(os.path.join(root, f"hb-{pid}.json"), "w") as f:
        json.dump({"time": stamp, "beat": beat, "epoch": 1,
                   "round": 0, "wm": 0, "ckpt": None}, f)


class TestProgressionDetector:
    """``tests/test_reform_detector.py`` through the port."""

    def test_absolute_skew_cannot_kill_a_progressing_peer(self, tmp_path):
        rv = Rendezvous(str(tmp_path), pid=0)
        _write_hb(tmp_path, 7, stamp=12345.0, beat=1)     # epoch-1970 clock
        assert 7 in rv.fresh_peers(0.2)
        time.sleep(0.3)                                   # past stale_s...
        _write_hb(tmp_path, 7, stamp=12345.0, beat=2)     # ...but progressed
        assert 7 in rv.fresh_peers(0.2)

    def test_frozen_writer_goes_stale_after_observation_window(self,
                                                               tmp_path):
        rv = Rendezvous(str(tmp_path), pid=0)
        _write_hb(tmp_path, 7, stamp=time.time(), beat=1)
        assert 7 in rv.fresh_peers(0.2)          # first sighting: fresh
        time.sleep(0.3)
        assert 7 not in rv.fresh_peers(0.2)      # never progressed: dead
        _write_hb(tmp_path, 7, stamp=time.time(), beat=2)
        assert 7 in rv.fresh_peers(0.2)          # came back: fresh again

    def test_backward_wall_step_still_counts_as_progression(self, tmp_path):
        rv = Rendezvous(str(tmp_path), pid=0)
        _write_hb(tmp_path, 7, stamp=5000.0, beat=1)
        rv.fresh_peers(0.2)
        time.sleep(0.25)
        _write_hb(tmp_path, 7, stamp=1000.0, beat=2)      # clock stepped back
        assert 7 in rv.fresh_peers(0.2)

    def test_own_heartbeat_carries_beat_counter(self, tmp_path):
        rv = Rendezvous(str(tmp_path), pid=3)
        rv.heartbeat(1, 0, 10, None)
        rv.heartbeat(1, 1, 12, None)
        hb = rv.my_heartbeat()
        assert hb["beat"] == 2 and hb["wm"] == 12
        assert 3 in rv.fresh_peers(60.0)

    def test_detection_latency_bounded_from_first_sight(self, tmp_path):
        _write_hb(tmp_path, 9, stamp=time.time() - 9999.0, beat=42)
        rv = Rendezvous(str(tmp_path), pid=0)     # fresh observer
        t0 = time.monotonic()
        assert 9 in rv.fresh_peers(0.2)           # first sight: fresh
        while 9 in rv.fresh_peers(0.2):
            assert time.monotonic() - t0 < 2.0, "never went stale"
            time.sleep(0.05)


class _Sock:
    """A socket whose bound port is fixed (the epoch's coordinator)."""

    def __init__(self, *a, **kw):
        pass

    def bind(self, addr):
        pass

    def getsockname(self):
        return ("127.0.0.1", 45678)

    def close(self):
        pass


def _script(rv):
    """One run of every file-writing operation of a rendezvous."""
    rv.heartbeat(1, 5, 40, "ck-a")
    rv.heartbeat(1, 6, 48, "ck-b")
    rv.declare_dead(7)
    rv.declare_dead(8, evidence="operator")
    ep = rv.publish_epoch(1, [2, 0, 4], "ck-b", [3, 1])
    rv.request_join()
    nxt = rv.propose_next_epoch(
        ep, {0: {"ckpt": "ck-c", "wm": 50}, 2: rv.my_heartbeat()}, [9])
    return ep, nxt


def test_same_operations_write_the_same_files(tmp_path, monkeypatch):
    """Every file a JAX ``Rendezvous`` writes, the port's writes with the
    same bytes (the wall clock and the coordinator port held fixed)."""
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    monkeypatch.setattr(socket, "socket", _Sock)
    got = {}
    for name, cls in (("jax", JRendezvous), ("port", Rendezvous)):
        root = tmp_path / name
        ep, nxt = _script(cls(str(root), pid=2))
        got[name] = ({f: (root / f).read_bytes()
                      for f in sorted(os.listdir(root))},
                     (ep.n, ep.members, ep.coord, ep.ckpt, ep.dead_rows),
                     (nxt.n, nxt.members, nxt.coord, nxt.ckpt,
                      nxt.dead_rows))
    assert got["port"] == got["jax"]
    assert sorted(got["port"][0]) == [
        "dead-7.json", "dead-8.json", "epoch-1.json", "epoch-2.json",
        "hb-2.json", "join-2.json"]
    assert Epoch(1, [0], "127.0.0.1:45678", None).init_method == \
        "tcp://127.0.0.1:45678"


def test_jax_and_port_share_one_directory(tmp_path):
    """A JAX process (pid 0) and a port process (pid 1) on one
    rendezvous directory: each sees the other's heartbeat as written,
    honours the other's death certificate and its retirement, reads the
    other's epochs (write-once across packages) and folds in the other's
    join."""
    root = str(tmp_path)
    jrv, trv = JRendezvous(root, pid=0), Rendezvous(root, pid=1)
    jrv.heartbeat(1, 3, 30, "ck-j")
    trv.heartbeat(1, 4, 31, "ck-t")
    for rv in (jrv, trv):
        fresh = rv.fresh_peers(60.0)
        assert sorted(fresh) == [0, 1]
        assert fresh[0] == jrv.my_heartbeat() and \
            fresh[1] == trv.my_heartbeat()
    assert trv.my_heartbeat()["ckpt"] == "ck-t"
    # a certificate from either side is read, and obeyed, by both
    trv.declare_dead(0)
    assert jrv.declared_dead() == trv.declared_dead()
    assert 0 not in jrv.fresh_peers(60.0) and 0 not in trv.fresh_peers(60.0)
    jrv.heartbeat(1, 4, 32, "ck-j2")                 # progressed: retired
    assert 0 in trv.fresh_peers(60.0)
    assert trv.declared_dead() == {} == jrv.declared_dead()
    # epochs: write-once across the packages, read alike
    ep = trv.publish_epoch(1, [0, 1], "ck-t", [])
    assert jrv.publish_epoch(1, [0], None, [1]) is None
    jep = jrv.latest_epoch()
    assert (jep.n, jep.members, jep.coord, jep.ckpt, jep.dead_rows) == \
        (ep.n, ep.members, ep.coord, ep.ckpt, ep.dead_rows)
    assert isinstance(jep, JEpoch) and ep.init_method == f"tcp://{ep.coord}"
    # the JAX coordinator (lowest fresh member) folds in the port's join
    trv.request_join()
    fresh = jrv.fresh_peers(60.0)
    assert jrv.is_coordinator(fresh, ep.members)
    assert not trv.is_coordinator(fresh, ep.members)
    assert jrv.pending_joins([0]) == [1]
    nxt = jrv.propose_next_epoch(jep, fresh, [])
    tep = trv.latest_epoch()
    assert (tep.n, tep.members, tep.ckpt, tep.dead_rows) == \
        (nxt.n, nxt.members, nxt.ckpt, nxt.dead_rows) == \
        (2, [0, 1], "ck-j2", [])     # the highest watermark's checkpoint
    assert trv.await_epoch_including_me(after=1, timeout_s=5.0).n == 2
    assert trv.pending_joins([0, 1]) == [] == jrv.pending_joins([0, 1])


@pytest.mark.parametrize("cls", [JRendezvous, Rendezvous],
                         ids=["jax", "port"])
def test_certified_death_reforms_without_settle(tmp_path, cls):
    """``reform`` with every missing member certified dead proposes at
    once (no settle window), in either package, and both read the
    result alike."""
    root = str(tmp_path)
    rv = cls(root, pid=0)
    cur = rv.publish_epoch(1, [0, 1, 2], None, [])
    rv.heartbeat(1, 0, 10, "ck-0")
    rv.declare_dead(1)
    rv.declare_dead(2)
    t0 = time.monotonic()
    ep = rv.reform(cur, stall_s=30.0, timeout_s=10.0,
                   hb={"round": 0, "wm": 10, "ckpt": "ck-0"})
    assert time.monotonic() - t0 < 3.0
    assert (ep.n, ep.members, ep.ckpt, ep.dead_rows) == (2, [0], "ck-0",
                                                         [1, 2])
    other = (Rendezvous if cls is JRendezvous else JRendezvous)(root, pid=5)
    o = other.latest_epoch()
    assert (o.n, o.members, o.coord, o.ckpt, o.dead_rows) == \
        (ep.n, ep.members, ep.coord, ep.ckpt, ep.dead_rows)
