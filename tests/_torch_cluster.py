"""Shared helpers of the port's cluster-tier tests (tests/test_torch_cluster*.py):
a lock-step harness that drives a JAX ``RaftNode`` and a port ``RaftNode``
(same id, peers, seed and sizes, each in its own directory) with the same
frames under one fake clock, and holds them equal after every step: the
reply frames, the outbox, every field of the role machine, and every byte
the node wrote (``wal.bin``, ``vote.json``, the segment shards, their
sidecars and the manifest, ``death.json`` and ``disk-stats.json``). A trio of
pairs with a synchronous frame router runs whole clusters without sockets.
Not a test module (leading underscore: pytest does not collect it).

The clock replaces the ``time`` module the node and storage modules of
both packages see (``monotonic``, ``time`` and ``sleep``), so timers,
lease ages, plan polls, fsync stalls and death-certificate stamps are the
same numbers on both sides. The one field left out of the comparison is
``tier.seal_wall_s``, the real time the tiered store spent sealing.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import importlib
import os
from types import SimpleNamespace

PACKAGES = ("raft_tpu", "raft_tpu_torch")
PEERS3 = {i: f"127.0.0.1:{7400 + i}" for i in range(3)}

_STATE = (
    "node_id", "peers", "others", "majority", "hb_s", "timeout_base",
    "lease_s", "wal_fsync", "wal_group_commit", "max_append", "snap_chunk",
    "snap_threshold", "failed", "term", "voted_for", "generation", "role",
    "leader_id", "log", "kv", "commit", "applied", "_wal_hi",
    "_wal_written", "_wal_records", "_wal_deferred", "_wal_skip_corrupt",
    "_lease_stale_round", "digest_every", "_digest", "stats", "last_heard",
    "timeout", "outbox", "deny", "deny_to", "deny_from", "_lead_since",
    "next_idx", "match_idx", "hb_round", "peer_round", "ack_at",
    "_round_sent", "last_hb", "snap_mode", "_snap_sent", "votes", "_dirty",
    "_reads", "_next_ticket", "_submit_terms",
)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class Clock:
    """One fake clock for both packages: ``monotonic`` starts at 1000 s,
    ``time`` is a fixed epoch plus the same offset, ``sleep`` advances."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return 1.7e9 + self.t

    def sleep(self, dt: float) -> None:
        self.t += float(dt)

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@contextlib.contextmanager
def fake_time(clock: Clock):
    """Point the node and storage modules of both packages at ``clock``."""
    shim = SimpleNamespace(monotonic=clock.monotonic, time=clock.time,
                           sleep=clock.sleep)
    saved = []
    for pkg in PACKAGES:
        for name in ("cluster.node", "cluster.storage"):
            m = mod(pkg, name)
            saved.append((m, m.time))
            m.time = shim
    try:
        yield clock
    finally:
        for m, t in saved:
            m.time = t


def plain(v, root: str = ""):
    """A value both packages can be compared by: reply objects by class
    name and slots, exceptions by type name and message, directory paths
    cut out of strings."""
    if isinstance(v, BaseException):
        return ("raise", type(v).__name__, plain(str(v), root))
    if isinstance(v, str):
        return v.replace(root, "<dir>") if root else v
    if isinstance(v, dict):
        return {plain(k, root): plain(x, root) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(plain(x, root) for x in v)
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    if hasattr(v, "__slots__") and not isinstance(v, (bytes, int, float)):
        return (type(v).__name__,
                tuple(plain(getattr(v, s), root) for s in v.__slots__))
    return v


def tree(root: str) -> dict:
    """Every file under ``root`` -> its bytes (directory paths cut out of
    the JSON files that carry them)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                blob = fh.read()
            out[os.path.relpath(p, root)] = blob.replace(
                root.encode(), b"<dir>")
    return out


def node_state(n, root: str) -> dict:
    st = {k: plain(copy.copy(getattr(n, k)), root) for k in _STATE}
    st["_digest_ckpts"] = list(n._digest_ckpts)
    status = n.status()
    status["tier"] = {k: v for k, v in status["tier"].items()
                      if k != "seal_wall_s"}
    st["status"] = status
    st["data_dir"] = plain(n.data_dir, root)
    st["store"] = {k: v for k, v in n.store.tier_summary().items()
                   if k != "seal_wall_s"}
    io = n._io
    if hasattr(io, "plan"):
        st["io"] = (dict(io.stats), plain(io.plan, root), io._eio_fired)
    return st


def assert_same(a, b, what: str = "") -> None:
    if isinstance(a, dict) and isinstance(b, dict):
        assert a.keys() == b.keys(), (what, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
        return
    assert a == b, f"{what}: JAX {a!r} != port {b!r}"


def faulty_io(pkg: str, data_dir: str):
    return mod(pkg, "cluster.storage").FaultyIO(data_dir)


class Pair:
    """A JAX node and a port node in lock step. ``root`` holds one
    directory a package (``root/raft_tpu/n<id>``, ``root/raft_tpu_torch/
    n<id>``); ``io`` is None or ``"faulty"`` (each node gets its package's
    ``FaultyIO`` over its own directory); ``kw`` goes to both ``RaftNode``
    constructors. A constructor that raises leaves ``nodes`` None and the
    two exceptions, which must agree, in ``build_error``."""

    def __init__(self, root: str, node_id: int = 1, peers=None,
                 io=None, clock: Clock = None, **kw):
        self.root = str(root)
        self.node_id = node_id
        self.peers = dict(peers or PEERS3)
        self.io_kind = io
        self.kw = dict(kw)
        self.kw.setdefault("seed", 1000 + node_id)
        self.clock = clock or Clock()
        self.nodes = None
        self.build_error = None
        self.build()

    def dir(self, pkg: str) -> str:
        return os.path.join(self.root, pkg, f"n{self.node_id}")

    def build(self, **over) -> None:
        """(Re)build both nodes on their directories: the restart of a
        process whose RAM is gone."""
        kw = dict(self.kw, **over)
        made, errs = {}, {}
        self.last_io = {}
        with fake_time(self.clock):
            for pkg in PACKAGES:
                os.makedirs(self.dir(pkg), exist_ok=True)
                io = (faulty_io(pkg, self.dir(pkg))
                      if self.io_kind == "faulty" else None)
                self.last_io[pkg] = io
                try:
                    made[pkg] = mod(pkg, "cluster.node").RaftNode(
                        self.node_id, self.peers, self.dir(pkg), io=io, **kw)
                except Exception as ex:   # compared below
                    errs[pkg] = ex
        assert set(errs) in (set(), set(PACKAGES)), (
            "one package raised, the other did not", errs)
        if errs:
            assert_same(plain(errs["raft_tpu"], self.dir("raft_tpu")),
                        plain(errs["raft_tpu_torch"],
                              self.dir("raft_tpu_torch")), "build")
            self.nodes, self.build_error = None, errs
        else:
            self.nodes, self.build_error = made, None
        self.check()

    @property
    def j(self):
        return self.nodes["raft_tpu"]

    @property
    def t(self):
        return self.nodes["raft_tpu_torch"]

    # ------------------------------------------------------------ driving
    def set(self, **attrs) -> None:
        """Set the same attribute values on both nodes (deep copies)."""
        for n in self.nodes.values():
            for k, v in attrs.items():
                setattr(n, k, copy.deepcopy(v))
        self.check()

    def call(self, name: str, *args, **kw):
        """Call ``name`` on both nodes; results (or exceptions) must
        agree. Returns the JAX node's result, or raises its exception."""
        res = {}
        with fake_time(self.clock):
            for pkg in PACKAGES:
                try:
                    res[pkg] = getattr(self.nodes[pkg], name)(*args, **kw)
                except Exception as ex:
                    res[pkg] = ex
        a, b = res["raft_tpu"], res["raft_tpu_torch"]
        assert_same(plain(a, self.dir("raft_tpu")),
                    plain(b, self.dir("raft_tpu_torch")), name)
        self.check()
        if isinstance(a, Exception):
            raise a
        return a

    def frame(self, build) -> list:
        """``build(P)`` encodes one frame with a package's protocol module;
        the two encodings must be equal. Both nodes handle the frame;
        returns the (equal) reply frames."""
        blobs = [build(mod(pkg, "net.protocol")) for pkg in PACKAGES]
        assert blobs[0] == blobs[1], "the packages encode different frames"
        return self.feed(blobs[0])

    def feed(self, blob: bytes) -> list:
        P = mod("raft_tpu", "net.protocol")
        (kind, payload), = P.FrameDecoder().feed(blob)
        return self.call("on_peer_frame", kind, payload)

    def check(self) -> None:
        """Every field and every byte on disk, JAX's against the port's."""
        if self.nodes is not None:
            assert_same(node_state(self.j, self.dir("raft_tpu")),
                        node_state(self.t, self.dir("raft_tpu_torch")),
                        "state")
        assert_same(tree(os.path.join(self.root, "raft_tpu")),
                    tree(os.path.join(self.root, "raft_tpu_torch")), "files")


def one_frame(blob: bytes):
    P = mod("raft_tpu", "net.protocol")
    frames = P.FrameDecoder().feed(blob)
    assert len(frames) == 1
    return frames[0]


class Trio:
    """Three pairs (node ids 0, 1, 2) on one clock and a synchronous frame
    router: what a node sends (its outbox) is handed to the target's
    ``on_peer_frame``, replies go back to the sender the same way, and
    every node's deferred group-commit acks are released by a
    ``flush_wal`` after each delivery sweep. Down nodes drop what is sent
    to them."""

    def __init__(self, root: str, **kw):
        self.clock = Clock()
        self.pairs = {i: Pair(root, node_id=i, clock=self.clock, **kw)
                      for i in range(3)}
        self.down: set = set()

    def tick(self, dt: float) -> None:
        self.clock.advance(dt)
        for i, p in self.pairs.items():
            if i not in self.down:
                p.call("tick", self.clock.t)
        self.route()

    def _deliver(self, src: int, dst: int, blob: bytes) -> None:
        if dst in self.down or src in self.down:
            return
        replies = self.pairs[dst].feed(blob)
        for r in replies:
            self._deliver(dst, src, r)

    def route(self) -> None:
        for _ in range(64):
            moved = False
            for i, p in self.pairs.items():
                if i in self.down:
                    continue
                outs = p.j.outbox
                assert_same(plain(outs), plain(p.t.outbox), f"outbox {i}")
                if not outs:
                    continue
                p.set(outbox=[])
                for dst, blob in outs:
                    moved = True
                    self._deliver(i, dst, blob)
            for i, p in self.pairs.items():
                if i in self.down:
                    continue
                for dst, blob in p.call("flush_wal"):
                    moved = True
                    self._deliver(i, dst, blob)
            if not moved:
                return
        raise AssertionError("the router did not quiesce")

    def kill(self, i: int) -> None:
        self.down.add(i)

    def restart(self, i: int) -> None:
        self.down.discard(i)
        self.pairs[i].build()

    def leader(self):
        for i, p in self.pairs.items():
            if i not in self.down and p.j.role == "leader":
                return i
        return None


# ------------------------------------------------------------ drills
#: what a drill's verdict rests on, compared between the packages: the
#: verdict, the report's boolean receipts, and the EIO node's exit code
#: (the ``fail_stop`` pair). The counts are wall-clock multi-process
#: numbers and are held as the JAX tests hold them, not for equality.
RECEIPTS = {
    "cluster_run": ("verdict", "handoff_ok", "rejoined"),
    "cluster_storage_run": (
        "verdict", "handoff_ok", "rejoined", "fail_stop_ok", "eio_exit",
        "storage_ok", "digest_ok", "caught", "caught_by"),
    "cluster_net_run": (
        "verdict", "handoff_ok", "rejoined", "reelected", "net_ok",
        "digest_ok", "caught", "caught_by"),
}


def receipts(fn: str, rep) -> dict:
    return {k: getattr(rep, k) for k in RECEIPTS[fn]}


def run_drill(pkg: str, fn: str, *args, **kw):
    """``pkg.chaos.runner.fn(*args, **kw)``, or a pytest skip when the
    environment cannot spawn children (the ``ClusterBroken`` contract)."""
    import pytest

    try:
        return getattr(mod(pkg, "chaos.runner"), fn)(*args, **kw)
    except mod(pkg, "cluster.supervisor").ClusterBroken as ex:
        pytest.skip(f"multi-process clusters cannot run here: {ex}")


@functools.lru_cache(maxsize=None)
def _jax_drill(fn, args, kw):
    import shutil

    rep = run_drill("raft_tpu", fn, *args, **dict(kw))
    shutil.rmtree(rep.base_dir, ignore_errors=True)
    return receipts(fn, rep), rep.summary()


def jax_drill(fn: str, *args, **kw) -> tuple:
    """The JAX package's receipts (and summary line) for the same drill,
    run once a worker."""
    return _jax_drill(fn, args, tuple(sorted(kw.items())))
