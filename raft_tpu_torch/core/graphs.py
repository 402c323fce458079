"""The fused steady window as CUDA graphs (this module has no counterpart
in the JAX package: it plays the part of the JAX transport's ``jax.jit``
of the K-tick scan, ``transport/device.py:56-76`` ``_fused_program``).

``core.step.fused_steady_scan`` is a Python loop of K general-path ticks,
each of which launches kernel K1 once and a few dozen small torch ops.
Nothing in it reads the device back, so the whole loop is captured once
into a ``torch.cuda.CUDAGraph`` and each fused launch of the engine is one
replay.

- **Cache.** :class:`FusedGraphs` (one per transport) keeps one graph per
  (member mode, launch size K, B, W, S, record mode), all in one shared
  graph pool;
  its rows and commit quorum are the transport's. The engine's window
  planner picks power-of-two launch sizes up to ``fuse_k``, so about
  log2(K) graphs are captured.
- **Static state.** A graph reads and writes fixed addresses: the
  cluster's own ring tensors (K1 writes them in place), the staging
  buffer, and static copies of the six small state leaves. A replay
  first copies the caller's small leaves into the static ones when they
  are other tensors, and the captured region ends by copying the final
  small leaves back into them; the returned state holds the static
  leaves (the next replay overwrites them, as every call consumes the
  state it is given). A ring or staging buffer that has changed identity
  (a restore, or anything else that hands the engine new ring tensors)
  drops the graphs and captures anew, never a silent copy of the ring.
- **Recorded mode.** With an ``obs.device.EventRing`` (``ring=``) the
  captured region is ``fused_steady_scan(..., ring=, record=True)``: the
  ring's four tensors are written in place by the replay, like the state
  rings, and a ring of another identity (a new attachment) drops the
  set and captures anew.
- **Per-launch inputs.** start slot, ``n_run``, the halted mode, leader,
  term, repair floor, its attested term, the K counts and the
  alive/slow/member planes are one int32 host array, uploaded with one
  asynchronous copy from a ring of pinned buffers (a slot is reused only
  after its copy's event has completed). They are host values (the
  engine passes Python numbers and numpy masks); a tensor is read back
  to the host first.
- **Warm-up.** Before capture the loop runs once, eagerly on a side
  stream, with every tick the masked no-op (halted), so the state passes
  through bit for bit; the device halted flag it sets is put back, since
  a launch of another size earlier in the same window may have left it
  for the launch being captured. The warm-up's masked ticks also
  advance a recorded ring's ``tick``: the ring's four tensors are saved
  before it and put back after.
- **Pipelining.** The outputs live at fixed addresses in the pool, so
  each replay is followed by one stream-ordered clone of its packed
  output; the returned infos, ``escaped``, ``ran`` and ``halted`` are
  views of that clone. ``halted`` also stays on the device: passing the
  last returned ``halted`` back as ``halted0`` reads it there, with no
  host round trip.
- **Launch counts.** Capture launches nothing, so K1's count
  (``core.ring_cuda.LAUNCHES``) is restored after capture, and each
  replay adds the K1 launches the graph holds.
- **No fallback.** A capture or replay that fails raises; nothing falls
  back to the eager loop.
- **Compile plane.** Each capture is a ``compile`` event of the compile
  plane (``obs.compile.emit``) with the capture's own seconds, attributed
  to the labeled call it ran under (``single.fused``, ``group.fused``,
  ``group_mesh.fused``).
- **The pool** (:data:`POOL`, :class:`GraphPool`). A crash-restore
  cycle builds a fresh transport and restores the engine onto new
  tensors, which would capture every graph anew (JAX's process-wide
  program cache compiles nothing anew). Instead the dead engine's
  transport releases its rings, its staging buffer and its
  :class:`FusedGraphs` (``SingleDeviceTransport.release``), and the next
  transport of the same shape on the same device claims them in
  ``init()``: it zeroes the rings and hands them to the engine, the
  engine's staging ring takes the staging buffer back
  (:meth:`GraphPool.staging_for`), so every graph set still holds what
  it reads and replays with no capture. The chaos runner also releases
  its last engine when a run ends, so the next run of the same shape
  replays the graphs, as JAX's process-wide cache serves a second run.
  Only a released transport's set is lent: two live engines never share
  one.

:class:`FusedGroupGraphs` does the same for the multi-Raft fused window
(``core.step.fused_group_scan``, G groups × K ticks, one K5 launch a
tick), in the part of the JAX ``MultiEngine``'s ``jax.jit`` of the group
scan (``multi/engine.py:194``): one graph per (G, K, B, W, record mode)
over the engine's rings, every per-launch input (payload words
included) one packed upload (:func:`pack_group_launch`).
"""

from __future__ import annotations

import math
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import ring_cuda
from raft_tpu_torch.core.comm import SingleDeviceComm
from raft_tpu_torch.core.state import ReplicaState
from raft_tpu_torch.core.step import RepInfo, fused_steady_scan
from raft_tpu_torch.obs import compile as obs_compile

#: the six small state leaves (the rings are captured in place)
SMALL = ("term", "voted_for", "last_index", "commit_index", "match_index",
         "match_term")
#: the scalar head of the packed inputs, then counts[K], alive[R],
#: slow[R] and (with a member mode) member[R]
HEAD = ("start_slot", "n_run", "halted", "leader", "leader_term",
        "repair_floor", "floor_prev_term")
_H = {name: i for i, name in enumerate(HEAD)}
#: the ``halted`` input: 0 / 1 from the host, or the device flag the
#: previous launch left
HALTED_ON_DEVICE = 2
#: pinned upload buffers per graph (at most two launches are in flight:
#: the engine books launch i, which fetches it, before dispatching i+2)
PINNED = 4


def member_kind(member) -> str:
    """"none", "bool" (the voter plane) or "packed" (voter|learner)."""
    if member is None:
        return "none"
    dtype = member.dtype
    is_bool = dtype == torch.bool if isinstance(member, torch.Tensor) \
        else np.dtype(dtype) == np.bool_
    return "bool" if is_bool else "packed"


class _Graph:
    """One captured launch size: the graph, its packed input buffer on
    the card, the pinned upload ring, its packed output, and the kernel
    launches (K1 or K5) it holds."""

    def __init__(self, K: int, n_inputs: int, device):
        self.K = K
        self.graph = torch.cuda.CUDAGraph()
        self.inp = torch.zeros(n_inputs, dtype=torch.int32, device=device)
        self.pinned = [torch.zeros(n_inputs, dtype=torch.int32,
                                   pin_memory=True) for _ in range(PINNED)]
        self.events = [None] * PINNED
        self.next = 0
        self.out: Optional[torch.Tensor] = None
        self.launches = 0

    def upload(self, host: np.ndarray) -> None:
        """One asynchronous copy of the packed inputs, from a pinned
        buffer whose previous copy has completed."""
        i = self.next
        self.next = (i + 1) % PINNED
        if self.events[i] is not None:
            self.events[i].synchronize()
        self.pinned[i].numpy()[:] = host
        self.inp.copy_(self.pinned[i], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.events[i] = ev


class _GraphSet:
    """The graphs of one member mode and staging shape over one cluster's
    rings and one staging buffer, with the static small leaves and the
    device halted flag they share."""

    def __init__(self, state: ReplicaState, staging: torch.Tensor,
                 ring=None):
        self.log_term = state.log_term
        self.log_payload = state.log_payload
        self.staging = staging
        self.ring = ring
        self.small = {f: torch.empty_like(getattr(state, f)) for f in SMALL}
        self.halted = torch.zeros((), dtype=torch.bool, device=state.device)
        self.last_halted: Optional[torch.Tensor] = None
        self.graphs: Dict[int, _Graph] = {}

    def holds(self, state: ReplicaState, staging: torch.Tensor,
              ring) -> bool:
        return (state.log_term is self.log_term
                and state.log_payload is self.log_payload
                and staging is self.staging
                and (ring is None) == (self.ring is None)
                and (ring is None or all(
                    a is b for a, b in zip(ring.tensors(),
                                           self.ring.tensors()))))

    def state(self) -> ReplicaState:
        return ReplicaState(**self.small, log_term=self.log_term,
                            log_payload=self.log_payload)


class FusedGraphs:
    """CUDA graphs of ``fused_steady_scan`` for one transport's cluster
    shape (``rows``, ``commit_quorum``) on ``device``; see the module
    doc. ``captures``, ``replays`` and ``k1_launches`` (the K1 launches
    the replays ran) count what it did."""

    def __init__(self, rows: int, commit_quorum, device):
        self.rows = rows
        self.commit_quorum = commit_quorum
        self.device = torch.device(device)
        self.comm = SingleDeviceComm(rows)
        self.pool = None
        self.sets: Dict[Tuple, _GraphSet] = {}
        self.captures = 0
        self.replays = 0
        self.k1_launches = 0
        self.capture_s = 0.0    # host seconds spent warming up and capturing
        self.recaptures = 0
        #   graph sets dropped because a ring or the staging buffer
        #   changed identity

    def buffers(self) -> dict:
        """The tensors the graph sets hold (the memory plane's host
        walk attributes them): per set its static leaves and halted flag,
        per graph its packed input, output and pinned upload buffers."""
        return _set_buffers(self.sets)

    # ------------------------------------------------------------ capture
    def _body(self, gs: _GraphSet, inp: torch.Tensor, K: int,
              kind: str) -> torch.Tensor:
        """The captured region: the K-tick loop over the static state,
        its final small leaves and halted flag written back in place, and
        the outputs packed into one int32 tensor."""
        R = self.rows
        head = inp[:len(HEAD)]
        counts = inp[len(HEAD):len(HEAD) + K]
        planes = inp[len(HEAD) + K:].reshape(-1, R)
        member = None
        if kind == "bool":
            member = planes[2] != 0
        elif kind == "packed":
            member = planes[2]
        mode = head[_H["halted"]]
        halted0 = torch.where(mode == HALTED_ON_DEVICE, gs.halted, mode == 1)
        rec = {} if gs.ring is None else {"ring": gs.ring, "record": True}
        st, infos, esc, ran, halted = fused_steady_scan(
            self.comm, self.commit_quorum, gs.state(), gs.staging,
            head[_H["start_slot"]], counts, head[_H["n_run"]], halted0,
            head[_H["leader"]], head[_H["leader_term"]], planes[0] != 0,
            planes[1] != 0, head[_H["floor_prev_term"]],
            head[_H["repair_floor"]], member, **rec)[:5]
        for f in SMALL:
            gs.small[f].copy_(getattr(st, f))
        gs.halted.copy_(halted)
        return torch.cat([
            infos.commit_index, infos.frontier_len, infos.max_term,
            infos.repair_start, esc, ran,
            halted.to(torch.int32).reshape(1), infos.match.reshape(-1)])

    def _capture(self, gs: _GraphSet, K: int, kind: str) -> _Graph:
        t0 = time.perf_counter()
        planes = 2 + (kind != "none")
        g = _Graph(K, len(HEAD) + K + planes * self.rows, self.device)
        # warm-up: every tick the masked no-op, so the state passes
        # through bit for bit (and the kernels' library loads here). It
        # leaves the shared halted flag set, which a launch of another
        # size, dispatched earlier in this window, may have left for the
        # next one to read: keep it.
        g.inp[_H["halted"]] = 1
        flag = gs.halted.clone()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        _capture(g, self.pool, self.device, gs.ring,
                 lambda: self._body(gs, g.inp, K, kind),
                 lambda: gs.halted.copy_(flag), "write_window_both")
        self.captures += 1
        dt = time.perf_counter() - t0
        self.capture_s += dt
        obs_compile.emit("compile", dt)
        return g

    # -------------------------------------------------------------- run
    def run(self, state: ReplicaState, staging: torch.Tensor, start_slot,
            counts, n_run, halted0, leader, leader_term, alive, slow,
            member, repair_floor, floor_prev_term, ring=None):
        """One fused launch: ``fused_steady_scan``'s arguments and
        results (``state, infos, escaped, ran, halted``, and ``ring`` when
        one is given), by one replay."""
        K = int(counts.shape[0])
        S, B, W = staging.shape
        kind = member_kind(member)
        key = (kind, B, W, S, ring is not None)
        gs = self.sets.get(key)
        if gs is None or not gs.holds(state, staging, ring):
            if gs is not None:
                self.recaptures += 1
            gs = self.sets[key] = _GraphSet(state, staging, ring)
        for f in SMALL:
            src = getattr(state, f)
            if src is not gs.small[f]:
                gs.small[f].copy_(src)
        g = gs.graphs.get(K)
        if g is None:
            g = gs.graphs[K] = self._capture(gs, K, kind)
        R = self.rows
        host = np.zeros(g.inp.shape[0], np.int32)
        scalars = dict(start_slot=start_slot, n_run=n_run, leader=leader,
                       leader_term=leader_term, repair_floor=repair_floor,
                       floor_prev_term=floor_prev_term)
        for name, v in scalars.items():
            host[_H[name]] = _host(v)
        if isinstance(halted0, torch.Tensor) and halted0.is_cuda:
            if halted0 is not gs.last_halted:
                gs.halted.copy_(halted0.reshape(()))
            host[_H["halted"]] = HALTED_ON_DEVICE
        else:
            host[_H["halted"]] = int(bool(_host(halted0)))
        base = len(HEAD)
        for v, n in ((counts, K), (alive, R), (slow, R), (member, R)):
            if v is not None:
                host[base:base + n] = _host(v).reshape(-1)
                base += n
        g.upload(host)
        g.graph.replay()
        ring_cuda.LAUNCHES["write_window_both"] += g.launches
        self.k1_launches += g.launches
        self.replays += 1
        snap = g.out.clone()
        views = [snap[i * K:(i + 1) * K] for i in range(6)]
        ci, fl, mt, rs, esc, ran = views
        halted = snap.view(torch.uint8)[4 * 6 * K].view(torch.bool)
        gs.last_halted = halted
        infos = RepInfo(commit_index=ci, match=snap[6 * K + 1:].reshape(K, R),
                        max_term=mt, repair_start=rs, frontier_len=fl)
        out = (gs.state(), infos, esc, ran, halted)
        return out if ring is None else out + (ring,)


class _Lent:
    """What a transport holds that the pool may lend on: the rings its
    ``init()`` handed out, its staging buffer (None when no graph read
    one) and its :class:`FusedGraphs` (None when it never fused on the
    card), keyed by device, rows, commit quorum and ring shapes."""

    def __init__(self, key: tuple, rings: Tuple[torch.Tensor, torch.Tensor],
                 staging: Optional[torch.Tensor] = None,
                 graphs: Optional[FusedGraphs] = None):
        self.key = key
        self.rings = rings
        self.staging = staging
        self.graphs = graphs

    def n_graphs(self) -> int:
        """The captured graphs this entry's graph sets hold."""
        return 0 if self.graphs is None else sum(
            len(gs.graphs) for gs in self.graphs.sets.values())


class GraphPool:
    """The process-wide pool of released cluster buffers and graph sets
    (see the module doc). ``free`` holds what released transports left,
    at most :attr:`MAX_FREE` entries (the oldest is dropped); ``claimed``
    maps each live transport that claimed an entry with a staging buffer
    to it, until its engine's staging ring has taken the buffer back.
    ``lent`` counts the claims; ``enabled = False`` turns lending off
    (every ``init()`` then allocates, every fused set is captured).
    Lending is explicit: a transport lends only when its owner declares
    its engine dead (``SingleDeviceTransport.release``), never on
    collection, so a state kept past its engine is never reused."""

    MAX_FREE = 4

    def __init__(self):
        self.enabled = True
        self.free: List[_Lent] = []
        self.claimed = weakref.WeakKeyDictionary()
        self.lent = 0

    @staticmethod
    def hold(device, rows: int, commit_quorum,
             rings: Tuple[torch.Tensor, torch.Tensor],
             graphs: Optional[FusedGraphs]) -> _Lent:
        """What a transport holds that it may lend; it sets ``.graphs``
        on it when it builds them."""
        return _Lent((torch.device(device), rows, commit_quorum,
                      tuple(rings[0].shape), tuple(rings[1].shape)),
                     rings, graphs=graphs)

    def release(self, owner, held: _Lent) -> None:
        """``owner``'s engine is dead: put what it holds in the free
        list. Its staging buffer is the one its graph sets read, else the
        one it claimed and its engine never took; a set over other
        tensors can never be held again and is left out."""
        claim = self.claimed.pop(owner, None)
        if not self.enabled:
            return
        graphs = held.graphs
        sets = graphs.sets if graphs is not None else {}
        staging = next((gs.staging for gs in sets.values()), None)
        if staging is None and claim is not None:
            staging = claim.staging
        for k in [k for k, gs in sets.items()
                  if gs.staging is not staging
                  or gs.log_payload is not held.rings[1]]:
            del sets[k]
        self.free.append(_Lent(held.key, held.rings, staging, graphs))
        del self.free[:-self.MAX_FREE]

    def claim(self, owner, device, rows: int, commit_quorum,
              log_term_shape, log_payload_shape) -> Optional[_Lent]:
        """The free entry of this shape for ``owner``'s ``init()``, its
        rings zeroed, or None: of several, the one with the most graphs
        captured, then the newest. The entry leaves the free list:
        nothing else may claim it until ``owner`` lends it in turn."""
        if not self.enabled:
            return None
        key = (torch.device(device), rows, commit_quorum,
               tuple(log_term_shape), tuple(log_payload_shape))
        fits = [(lent.n_graphs(), i) for i, lent in enumerate(self.free)
                if lent.key == key]
        if not fits:
            return None
        lent = self.free.pop(max(fits)[1])
        for t in lent.rings:
            t.zero_()
        if lent.staging is not None:
            self.claimed[owner] = lent
        self.lent += 1
        return lent

    def staging_for(self, log_payload: torch.Tensor,
                    shape) -> Optional[torch.Tensor]:
        """The claimed staging buffer of the entry whose payload ring is
        ``log_payload`` (the engine's), zeroed, if its shape is
        ``shape``; else None (the caller allocates)."""
        for owner, lent in list(self.claimed.items()):
            if (lent.rings[1] is log_payload
                    and tuple(lent.staging.shape) == tuple(shape)):
                buf, lent.staging = lent.staging, None
                del self.claimed[owner]
                return buf.zero_()
        return None

    def buffers(self) -> dict:
        """The tensors the pool holds (the memory plane's root: pooled
        buffers are bounded by :attr:`MAX_FREE`, never a leak)."""
        out = {f"free[{i}]": {
            "rings": lent.rings, "staging": lent.staging,
            "graphs": None if lent.graphs is None else lent.graphs.buffers()}
            for i, lent in enumerate(self.free)}
        for i, lent in enumerate(list(self.claimed.values())):
            out[f"claimed[{i}]"] = {"staging": lent.staging}
        return out

    def clear(self) -> None:
        """Drop every entry (what they held is freed with them) and zero
        ``lent``."""
        self.free.clear()
        self.claimed = weakref.WeakKeyDictionary()
        self.lent = 0


#: the process-wide pool the single-device transports lend through
POOL = GraphPool()


def _set_buffers(sets: dict) -> dict:
    return {repr(key): {
        "small": dict(gs.small),
        "halted": getattr(gs, "halted", None),
        "graphs": {K: {"inp": g.inp, "out": g.out, "pinned": g.pinned}
                   for K, g in gs.graphs.items()},
    } for key, gs in sets.items()}


def _capture(g: _Graph, pool, device, ring, body, after_warm,
             counter: str) -> None:
    """Warm up and capture ``body`` into ``g``. The warm-up runs ``body``
    once eagerly on a side stream (the caller has set its inputs to the
    masked no-op); a recorded ring's four tensors are saved before it and
    put back after, and ``after_warm`` restores whatever else the caller
    keeps. The capture runs ``body`` again between capture_begin and
    capture_end on a side stream: what the torch.cuda.graph context does,
    without its full gc.collect() (tens of ms under an engine's host
    state) and empty_cache(). Capture launches nothing, so the kernel
    count ``ring_cuda.LAUNCHES[counter]`` is restored after it and the
    launches the graph holds are kept in ``g.launches``."""
    saved = ring.save() if ring is not None else None
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        body()
    cur.wait_stream(side)
    after_warm()
    if saved is not None:
        ring.restore(saved)
    before = ring_cuda.LAUNCHES[counter]
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        g.graph.capture_begin(pool=pool)
        try:
            g.out = body()
        finally:
            g.graph.capture_end()
    cur.wait_stream(side)
    g.launches = ring_cuda.LAUNCHES[counter] - before
    ring_cuda.LAUNCHES[counter] = before


# ------------------------------------------------ the fused group window
def _group_layout(K: int, G: int, R: int, B: int, W: int) -> dict:
    """Name -> shape of each per-launch input of one fused group launch,
    in upload order."""
    return {"n_run": (), "halted0": (G,), "leaders": (G,), "terms": (G,),
            "counts": (K, G), "alive": (G, R), "slow": (G, R),
            "member": (G, R), "payloads": (K, G, B, W)}


_BOOL = ("halted0", "alive", "slow", "member")


def group_launch_size(K: int, G: int, R: int, B: int, W: int) -> int:
    """Length of the packed int32 inputs of one fused group launch."""
    return sum(math.prod(v) for v in _group_layout(K, G, R, B, W).values())


def pack_group_launch(K: int, G: int, R: int, B: int, W: int,
                      **parts) -> np.ndarray:
    """The per-launch inputs of ``fused_group_scan`` as ONE int32 host
    array, in ``_group_layout`` order (bools as 0/1; ``payloads`` the
    untiled words [K, G, B, W]): the single upload a launch makes."""
    return np.concatenate([
        np.broadcast_to(np.asarray(parts[name], np.int32), shape).reshape(-1)
        for name, shape in _group_layout(K, G, R, B, W).items()])


def unpack_group_launch(inp: torch.Tensor, K: int, G: int, R: int, B: int,
                        W: int) -> dict:
    """The inverse of :func:`pack_group_launch` on a tensor: views of
    ``inp`` shaped as ``fused_group_scan`` takes them (bools compared
    against 0, which are new tensors)."""
    out, at = {}, 0
    for name, shape in _group_layout(K, G, R, B, W).items():
        size = math.prod(shape)
        v = inp[at:at + size].reshape(shape)
        out[name] = v != 0 if name in _BOOL else v
        at += size
    return out


def run_group_launch(program, state, inp: torch.Tensor, K: int, B: int,
                     W: int, rings=None, gids=None):
    """One fused group launch from its packed inputs ``inp`` (on the
    state's device): ``program`` is ``fused_group_scan(R, record=)``."""
    G, R = state.term.shape
    a = unpack_group_launch(inp, K, G, R, B, W)
    rec = () if rings is None else (rings, gids)
    return program(state, a["payloads"], a["counts"], a["n_run"],
                   a["halted0"], a["leaders"], a["terms"], a["alive"],
                   a["slow"], a["member"], *rec)


class _GroupGraphSet:
    """The graphs of one (G, B, W, record, shard) shape over one block's
    rings (and event rings with their group ids) on its device: the
    static small leaves [G, R] they share."""

    def __init__(self, state: ReplicaState, rings=None, gids=None):
        self.device = state.device
        self.log_term = state.log_term
        self.log_payload = state.log_payload
        self.rings = rings
        self.gids = gids
        self.small = {f: torch.empty_like(getattr(state, f)) for f in SMALL}
        self.graphs: Dict[int, _Graph] = {}

    def holds(self, state: ReplicaState, rings, gids) -> bool:
        return (state.log_term is self.log_term
                and state.log_payload is self.log_payload
                and (rings is None) == (self.rings is None)
                and gids is self.gids
                and (rings is None or all(
                    a is b for a, b in zip(rings.tensors(),
                                           self.rings.tensors()))))

    def state(self) -> ReplicaState:
        return ReplicaState(**self.small, log_term=self.log_term,
                            log_payload=self.log_payload)


class FusedGroupGraphs:
    """CUDA graphs of ``fused_group_scan`` (the multi-Raft fused window:
    G groups × K ticks) for one ``MultiEngine`` on ``device``. The
    counterpart of the JAX engine's ``jax.jit`` of the group scan
    (``raft_tpu/multi/engine.py:194`` ``_fused_group_programs``), with
    :class:`FusedGraphs`' rules:

    - one graph per (G, K, B, W, recorded, shard) and ring identity (the
      group state's two rings and, recorded, the group event rings' four
      tensors and the ``gids`` tensor): one of another identity drops
      the set and captures anew (``recaptures``). ``shard`` keeps the
      blocks of a group-sharded state (``transport.group_mesh``) in sets
      of their own, each captured on its block's device, so two shards
      of one shape on one card never drop each other's set;
    - every per-launch input (``n_run``, ``halted0``, leaders, terms, the
      K × G counts, the alive/slow/member planes and the K × G × B × W
      payload words) is one int32 array (:func:`pack_group_launch`),
      uploaded with one asynchronous copy from a pinned buffer into the
      graph's fixed input buffer;
    - the small leaves live in static buffers the graph reads and writes
      (the returned state holds them; the next replay overwrites them);
    - the warm-up runs the loop with every group halted (the bit-exact
      no-op) and puts a recorded ring's tensors back after it;
    - the outputs are packed in the graph and cloned once per replay.

    ``captures``, ``replays``, ``recaptures``, ``k5_launches`` (the K5
    launches the replays ran) and ``capture_s`` count what it did."""

    def __init__(self, rows: int, device):
        from raft_tpu_torch.core.step import fused_group_scan

        self.rows = rows
        self.device = torch.device(device)
        self.programs = {rec: fused_group_scan(rows, record=rec)
                         for rec in (False, True)}
        self.pool = None
        self.sets: Dict[Tuple, _GroupGraphSet] = {}
        self.captures = 0
        self.replays = 0
        self.recaptures = 0
        self.k5_launches = 0
        self.capture_s = 0.0

    def buffers(self) -> dict:
        """The tensors the graph sets hold, as :meth:`FusedGraphs.buffers`."""
        return _set_buffers(self.sets)

    def _body(self, gs: _GroupGraphSet, inp: torch.Tensor, K: int, B: int,
              W: int) -> torch.Tensor:
        """The captured region: the K-tick group loop over the static
        state, its final small leaves written back in place, and the
        outputs packed into one int32 tensor: commit_index, frontier_len,
        max_term, repair_start, escaped, ran (each [K, G]), halted [G],
        match [K, G, R]."""
        prog = self.programs[gs.rings is not None]
        st, infos, esc, ran, halted = run_group_launch(
            prog, gs.state(), inp, K, B, W, gs.rings, gs.gids)[:5]
        for f in SMALL:
            gs.small[f].copy_(getattr(st, f))
        return torch.cat([
            infos.commit_index.reshape(-1), infos.frontier_len.reshape(-1),
            infos.max_term.reshape(-1), infos.repair_start.reshape(-1),
            esc.reshape(-1), ran.reshape(-1),
            halted.to(torch.int32), infos.match.reshape(-1)])

    def _capture(self, gs: _GroupGraphSet, K: int, B: int, W: int) -> _Graph:
        t0 = time.perf_counter()
        G = gs.small["term"].shape[0]
        g = _Graph(K, group_launch_size(K, G, self.rows, B, W), gs.device)
        # warm-up: n_run 0 and every group halted, the bit-exact no-op
        g.inp[1:1 + G] = 1
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        _capture(g, self.pool, gs.device, gs.rings,
                 lambda: self._body(gs, g.inp, K, B, W),
                 lambda: None, "write_window_cols")
        self.captures += 1
        dt = time.perf_counter() - t0
        self.capture_s += dt
        obs_compile.emit("compile", dt)
        return g

    def run(self, state: ReplicaState, host: np.ndarray, K: int, B: int,
            W: int, rings=None, gids=None, shard: int = 0):
        """One fused group launch from its packed host inputs ``host``
        (:func:`pack_group_launch`) by one replay of ``shard``'s set:
        ``fused_group_scan``'s results ``(state, infos, escaped, ran,
        halted[, rings])``."""
        G, R = state.term.shape
        key = (G, B, W, rings is not None, shard)
        gs = self.sets.get(key)
        if gs is None or not gs.holds(state, rings, gids):
            if gs is not None:
                self.recaptures += 1
            gs = self.sets[key] = _GroupGraphSet(state, rings, gids)
        for f in SMALL:
            src = getattr(state, f)
            if src is not gs.small[f]:
                gs.small[f].copy_(src)
        g = gs.graphs.get(K)
        if g is None:
            g = gs.graphs[K] = self._capture(gs, K, B, W)
        g.upload(host)
        g.graph.replay()
        ring_cuda.LAUNCHES["write_window_cols"] += g.launches
        self.k5_launches += g.launches
        self.replays += 1
        snap = g.out.clone()
        n = K * G
        ci, fl, mt, rs, esc, ran = (snap[i * n:(i + 1) * n].reshape(K, G)
                                    for i in range(6))
        halted = snap[6 * n:6 * n + G] != 0
        infos = RepInfo(commit_index=ci, match=snap[6 * n + G:].reshape(
            K, G, R), max_term=mt, repair_start=rs, frontier_len=fl)
        out = (gs.state(), infos, esc, ran, halted)
        return out if rings is None else out + (rings,)


def _host(x) -> np.ndarray:
    """A per-launch input as int32 numpy (a tensor is read back)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int32)
