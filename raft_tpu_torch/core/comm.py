"""Replica-axis communication (port of ``raft_tpu/core/comm.py``).

The protocol steps of ``core.step`` reach other replica rows only through
this interface — ``replica_ids``, ``local``, ``all_gather``,
``select_row`` and ``leader_cols`` — so one body runs in two placements:

- ``SingleDeviceComm`` (``comm.py:87``): all R rows resident on one
  device (L = R); the "collectives" are plain indexing.
- ``MeshComm`` (``comm.py:112``): one replica row per rank of a
  ``torch.distributed`` process group (L = 1); on the 2-D mesh one lane
  slice of a row per rank, the replica collectives running over the
  ranks that hold the same slice of every row.
- ``BlockComm``: the same placement in ONE process (the JAX package's
  single-controller mesh, ``transport.ReplicaMeshTransport``): one block
  a device, each block's body on a thread of a ``LockStep``, the
  collectives device-to-device copies between the blocks.

Indices may be Python ints or 0-d device tensors; a tensor index goes
through ``index_select``, which never reads the value back to the host.
"""

from __future__ import annotations

import datetime
import threading
import time

import numpy as np
import torch


def take(x: torch.Tensor, idx, dim: int = 0) -> torch.Tensor:
    """``x`` indexed at one position along ``dim`` with no host sync."""
    if isinstance(idx, torch.Tensor):
        return x.index_select(dim, idx.reshape(1).long()).squeeze(dim)
    return x.select(dim, int(idx))


def take_groups(x: torch.Tensor, idx: torch.Tensor,
                dim: int = 1) -> torch.Tensor:
    """The batched ``take``: for every group g, ``x[g]`` indexed at
    ``idx[g]`` along ``dim`` (``x`` [G, ...], ``idx`` [G]) — one
    ``gather``, no host sync."""
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    size = list(x.shape)
    size[dim] = 1
    index = idx.long().reshape(shape).expand(size)
    return x.gather(dim, index).squeeze(dim)


class SingleDeviceComm:
    """All R replica rows resident on one device (L == R)."""

    def __init__(self, n_replicas: int):
        self.n_replicas = n_replicas

    def replica_ids(self, device) -> torch.Tensor:
        return torch.arange(self.n_replicas, dtype=torch.int32, device=device)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def select_row(self, x: torch.Tensor, idx) -> torch.Tensor:
        return take(x, idx, 0)

    def leader_cols(self, win: torch.Tensor, leader, w: int) -> torch.Tensor:
        """Every replica's lane block replaced by the leader's:
        [B, L*w] -> [B, L*w]."""
        blocks = win.reshape(win.shape[0], self.n_replicas, w)
        return take(blocks, leader, 1).repeat(1, self.n_replicas)

    def group_leader_cols(self, win: torch.Tensor, leaders: torch.Tensor,
                          w: int) -> torch.Tensor:
        """``leader_cols`` per group: [G, B, L*w] with ``leaders`` [G]."""
        G, B = win.shape[:2]
        blocks = win.reshape(G, B, self.n_replicas, w)
        return take_groups(blocks, leaders, 2).repeat(1, 1, self.n_replicas)


#: the process-group backends ``MeshComm`` runs over
MESH_BACKENDS = ("gloo", "nccl")


def _all_gather_flat(out: torch.Tensor, src: torch.Tensor, group) -> None:
    """One flat all_gather: ``src`` [1, ...] of every rank into ``out``
    [n, ...] in group rank order (``all_gather_single``, the name torch
    gives ``all_gather_into_tensor`` from 2.13)."""
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src, group=group)


class MeshComm:
    """One replica row per rank of a ``torch.distributed`` group (L = 1).

    The group (the default group when None) is a gloo or an NCCL group of
    ``n_replicas * payload_shards`` ranks: NCCL with one card a rank, gloo
    on the CPU or with ranks sharing one card (NCCL refuses two ranks on
    one device). Rank ``g`` of the group holds replica row ``g // P`` and
    lane slice ``g % P`` of it (``P = payload_shards``, the JAX package's
    ``(replica, pshard)`` mesh). The replica collectives (``all_gather``,
    ``broadcast_host``, ``select_row``, ``leader_cols``) run over the
    rank's pshard *column*, the ranks ``{r*P + p : r}``, whose subgroup
    rank is the replica row (``rank``): the counterpart of JAX's
    ``MeshComm(rows, "replica")`` under a 2-D ``shard_map``.
    ``all_gather_lanes`` runs over the rank's *row*, ``{r*P + q : q}``,
    for reads that reassemble a row's lanes. At P = 1 the column is the
    group itself and there is no row group: the groups and collectives
    are those of the 1-D mesh. The row and column subgroups take the
    group's backend.

    Each collective is one flat all_gather (``all_gather_single``) or one
    broadcast that takes its operand where it lies and leaves the result
    there: on the rank's card over NCCL, with no host copy. The ``_host``
    forms (``all_gather_host``, ``broadcast_host``, ``all_gather_lanes``,
    ``gather_lanes(host=True)``, ``host_once``) then make exactly one copy
    of the result to the host (``host_copies``). Over gloo a CUDA operand
    is staged: one copy to the host before the collective (counted in
    ``host_copies``), the result put back on the operand's device after
    it (``device_copies``) or, in a ``_host`` form, left on the host; a
    CPU operand (the tests') takes the NCCL path's code. Bool operands
    travel as uint8. Every rank must make the same calls in the same
    order, as the mirrored programs of the transport do. The mirror
    digest exchange (``exchange_int64``) runs over every rank of the
    group on a gloo group of its own, whatever the group's backend, with
    ``exchange_timeout_s`` as its timeout: it exchanges a host int64 and
    turns a dead or diverged peer into a fail-stop.

    ``events``, when a list, gets a pair of CUDA events recorded on the
    current stream around every collective on a CUDA operand (the
    device time of the collectives; the caller reads and clears it)."""

    def __init__(self, n_replicas: int, group=None,
                 exchange_timeout_s: float = 60.0, payload_shards: int = 1):
        import torch.distributed as dist

        P = payload_shards
        size = dist.get_world_size(group)
        if size != n_replicas * P:
            raise ValueError(
                f"MeshComm over {n_replicas} replicas x {P} payload shards "
                f"needs a process group of {n_replicas * P} ranks, got "
                f"{size}")
        backend = str(dist.get_backend(group))
        if backend not in MESH_BACKENDS:
            raise ValueError(
                f"MeshComm runs over a gloo or an nccl group, got "
                f"{backend!r}")
        self.backend = backend
        self.n_replicas = n_replicas
        self.payload_shards = P
        self.group_rank = dist.get_rank(group)
        self.rank = self.group_rank // P          # the replica row
        self.pshard = self.group_rank % P         # the lane slice
        self.collectives = 0
        self.collective_s = 0.0
        #   replica (column) collectives made and the host seconds spent
        #   in them (the mesh engine's per-tick communication cost)
        self.row_collectives = 0
        self.row_collective_s = 0.0
        #   the same for the row-group gathers (2-D mesh only)
        self.host_copies = 0
        self.device_copies = 0
        #   copies to the host (a staged operand, a ``_host`` form's
        #   result) and back to a card (a staged result)
        self.events = None
        ranks = None if group is None else dist.get_process_group_ranks(
            group)
        world = list(range(size)) if ranks is None else list(ranks)
        # Every rank creates every group, in one order, before any
        # collective: ``new_group`` is a collective of the whole world.
        # At P = 1 the column is ``group`` itself and no row group exists.
        # The mirror digest rides a gloo group of its own, so an exchange
        # never interleaves with a data-plane collective; its timeout is
        # the exchange bound.
        self.group = group
        self._row_group = None
        if P > 1:
            cols = [dist.new_group(ranks=world[p::P], backend=backend)
                    for p in range(P)]
            rows = [dist.new_group(ranks=world[r * P:(r + 1) * P],
                                   backend=backend)
                    for r in range(n_replicas)]
            self.group = cols[self.pshard]
            self._row_group = rows[self.rank]
        self._digest_group = dist.new_group(
            ranks=ranks, backend="gloo",
            timeout=datetime.timedelta(seconds=exchange_timeout_s))

    def replica_ids(self, device) -> torch.Tensor:
        return torch.full((1,), self.rank, dtype=torch.int32, device=device)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.rank:self.rank + 1]

    # -- the flat path: each step returns (tensor, staged), the tensor
    # where the collective left it (the host when gloo staged it)

    def _run(self, op, cuda: bool, row: bool = False) -> None:
        """One collective ``op()``, counted and timed (host seconds; CUDA
        events into ``events`` for a CUDA operand)."""
        pair = None
        if cuda and self.events is not None:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
        t0 = time.perf_counter()
        op()
        dt = time.perf_counter() - t0
        if pair is not None:
            pair[1].record()
            self.events.append(pair)
        if row:
            self.row_collectives += 1
            self.row_collective_s += dt
        else:
            self.collectives += 1
            self.collective_s += dt

    def _operand(self, x: torch.Tensor):
        """``x`` as a collective takes it: bool as uint8, contiguous, and
        on the host when gloo must stage it (a CUDA operand)."""
        src = x.detach()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        staged = self.backend == "gloo" and src.is_cuda
        if staged:
            src = src.cpu()
            self.host_copies += 1
        return src.contiguous(), staged

    def _gather(self, x: torch.Tensor, row: bool = False):
        """Every rank's ``x`` of the column (``row``: of the row group)
        stacked: [n, *x.shape]."""
        group, n = ((self._row_group, self.payload_shards) if row
                    else (self.group, self.n_replicas))
        src, staged = self._operand(x)
        out = src.new_empty((n,) + tuple(src.shape))
        self._run(lambda: _all_gather_flat(out, src[None], group),
                  src.is_cuda, row)
        return out, staged

    def _stitch(self, x: torch.Tensor, staged: bool):
        """``x`` [..., w] with its row's lane slices stitched over the row
        group: [..., P*w], slice p at lanes [p*w, (p+1)*w)."""
        if self._row_group is None:
            return x, staged
        out, again = self._gather(x, row=True)          # [P, ..., w]
        return (out.movedim(0, -2).reshape(*x.shape[:-1], -1),
                staged or again)

    def _bcast(self, x: torch.Tensor, row: int):
        """Rank ``row``'s ``x`` on every rank of the column (each passes
        its own ``x`` of the same shape; a copy is broadcast into)."""
        import torch.distributed as dist

        buf, staged = self._operand(x)
        if not staged:
            buf = buf.clone()
        root = row if self.group is None else dist.get_global_rank(
            self.group, row)
        self._run(lambda: dist.broadcast(buf, src=root, group=self.group),
                  buf.is_cuda)
        return buf, staged

    def _finish(self, t: torch.Tensor, x: torch.Tensor, staged: bool,
                host: bool) -> torch.Tensor:
        """A result in ``x``'s dtype: with ``host`` on the host (one copy,
        none when gloo staged it there), else on ``x``'s device (one copy
        back when staged)."""
        if host and not staged:
            self.host_copies += 1
            t = t.to("cpu", copy=True)
        elif not host and staged:
            self.device_copies += 1
            t = t.to(x.device)
        return t.to(x.dtype)

    # -- the replica collectives

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...] per-rank values -> [R, ...] on every rank, on ``x``'s
        device."""
        out, staged = self._gather(x)
        return self._finish(out.reshape((-1,) + tuple(x.shape[1:])), x,
                            staged, host=False)

    def all_gather_host(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather`` with the result on the host, for decisions taken
        there: one copy of the result to the host (over gloo, of the
        operand before the collective, and none after)."""
        out, staged = self._gather(x)
        return self._finish(out.reshape((-1,) + tuple(x.shape[1:])), x,
                            staged, host=True)

    def all_gather_plane(self, x: torch.Tensor) -> torch.Tensor:
        """The mesh kernels' launch plane (``core.step_mesh``): gathered
        where it lies, on the card over NCCL, where the kernels read it;
        over gloo a CUDA operand's plane goes to the host, where every
        rank takes the same decisions on it."""
        if self.backend == "gloo" and x.is_cuda:
            return self.all_gather_host(x)
        return self.all_gather(x)

    def host_once(self, x: torch.Tensor) -> torch.Tensor:
        """A value every rank holds alike, on the host: each rank's own
        copy (a flight's decision read, ``core.step_mesh``), one copy."""
        self.host_copies += 1
        return x.detach().to("cpu", copy=True)

    def all_gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """Every lane slice of this rank's row on the host: [..., w] per
        rank -> [..., P*w], slice p at lanes [p*w, (p+1)*w) (one gather
        over the row group, then one copy of the result to the host; at
        P = 1 the copy alone)."""
        out, staged = self._stitch(x.detach(), False)
        return self._finish(out, x, staged, host=True)

    def gather_lanes(self, x: torch.Tensor, rows=None,
                     host: bool = False) -> torch.Tensor:
        """Every row of the column ([1, ..., w] per rank), or the rows
        ``rows`` of it, each at full width: [k, ..., P*w] (one gather over
        the column and, on the 2-D mesh, one over the row group). On
        ``x``'s device, or with ``host`` on the host (one copy of the
        result)."""
        out, staged = self._gather(x)
        out = out.reshape((-1,) + tuple(x.shape[1:]))
        if rows is not None:
            out = out.index_select(0, torch.as_tensor(
                list(rows), dtype=torch.int64, device=out.device))
        out, staged = self._stitch(out, staged)
        return self._finish(out, x, staged, host)

    def broadcast_host(self, x: torch.Tensor, row: int,
                       lanes: bool = False) -> torch.Tensor:
        """Rank ``row``'s ``x`` on the host of every rank: every rank
        passes its own ``x`` of the same shape and dtype (the other
        ranks' values are overwritten). ``lanes``: its lane slices
        stitched over the row group first (the broadcast of each slice
        rides its own column). One copy of the result to the host."""
        buf, staged = self._bcast(x, row)
        if lanes:
            buf, staged = self._stitch(buf, staged)
        return self._finish(buf, x, staged, host=True)

    def exchange_int64(self, value: int) -> np.ndarray:
        """One int64 from every rank of the group (all R*P), in rank
        order, over the digest group (the mirror digest exchange;
        ``RaftEngine``)."""
        import torch.distributed as dist

        mine = torch.tensor([int(value)], dtype=torch.int64)
        parts = [torch.empty_like(mine)
                 for _ in range(self.n_replicas * self.payload_shards)]
        dist.all_gather(parts, mine, group=self._digest_group)
        return torch.cat(parts).numpy()

    def select_row(self, x: torch.Tensor, idx) -> torch.Tensor:
        return take(self.all_gather(x), idx, 0)

    def leader_cols(self, win: torch.Tensor, leader, w: int) -> torch.Tensor:
        """The leader rank's lane block [B, w] (``w`` = the local lanes)."""
        blocks = self.all_gather(win[None])           # [R, B, w]
        return take(blocks, leader, 0)


class LockStep:
    """One body a block of the one-process mesh, run in lock step on
    threads of its own (one a block, started once).

    Exactly one block runs at a time. A block hands the turn to the next
    one (in block order) when it reaches a collective or ends, so every
    block's host code between two collectives runs alone: its launches
    stay adjacent on its device's stream (the flight kernels' plan and
    writer share per-device scratch), and the schedule is the same on
    every run. At a collective each block deposits its operand and gets
    every block's back once all have deposited. An error in one block
    aborts the others at their next collective and raises in the caller;
    a block that ends while another still waits at a collective raises
    there (the bodies left lock step). Each thread runs with its block's
    CUDA device current. ``for_devices`` shares one a device list, so
    the threads are made once a process.

    A block reads the others' operands when its turn comes, after the
    blocks before it have run on past the collective. So an operand must
    not be changed in place until the next collective: the bodies pass
    fresh tensors or leaves they replace functionally. A read checks
    each operand's version counter and raises if it moved.

    ``run(fn, stream=)`` runs every block's body with ``stream`` current
    on its thread (PyTorch's current stream is per thread): the one
    stream a CUDA graph captures, or its warm-up's side stream. All
    blocks then enqueue on one stream, in the lock step's order, so
    stream order is the collectives' order. ``run(fn, tally=)`` books
    ``tally()``'s growth to the block that held the turn while it grew
    (``tallies``): a launch counter read so counts each block's
    launches."""

    _shared: dict = {}

    @classmethod
    def for_devices(cls, devices) -> "LockStep":
        key = tuple(str(torch.device(d)) for d in devices)
        if key not in cls._shared:
            cls._shared[key] = cls(devices)
        return cls._shared[key]

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        self._cv = threading.Condition()
        self._tasks = [None] * self.n
        self._threads = None
        self._turn = None
        self._active = [False] * self.n
        self._seq = [0] * self.n
        self._slots: dict = {}
        self._results = [None] * self.n
        self._error = None
        self._aborted = False
        self._calls = threading.Lock()
        self._stream = None
        self._tally = None
        self._mark = 0
        self.tallies = [0] * self.n

    def _start(self) -> None:
        self._threads = [threading.Thread(target=self._worker, args=(k,),
                                          daemon=True,
                                          name=f"replica-mesh-block-{k}")
                         for k in range(self.n)]
        for t in self._threads:
            t.start()

    def run(self, fn, stream=None, tally=None) -> list:
        """``fn(k)`` on every block k in lock step; returns the results in
        block order, or raises the first block's error. ``stream`` is made
        current on every block's thread for the call; ``tally`` is booked
        by block into ``tallies`` (class doc)."""
        with self._calls, self._cv:
            if self._threads is None:
                self._start()
            self._stream = stream
            self._tally = tally
            self.tallies = [0] * self.n
            self._seq = [0] * self.n
            self._slots = {}
            self._error = None
            self._aborted = False
            self._results = [None] * self.n
            self._active = [True] * self.n
            self._tasks = [fn] * self.n
            self._turn = 0
            self._cv.notify_all()
            while any(self._active):
                self._cv.wait()
            self._tasks = [None] * self.n
            self._stream = self._tally = None
            error, self._error = self._error, None
            results, self._results = self._results, [None] * self.n
            if error is not None:
                raise error
        return results

    def _worker(self, k: int) -> None:
        dev = self.devices[k]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            with self._cv:
                while self._tasks[k] is None or self._turn != k \
                        or not self._active[k]:
                    self._cv.wait()
                fn = self._tasks[k]
                stream = self._stream
                self._took()
            try:
                if self._aborted:
                    raise _Aborted()
                if stream is None:
                    out = fn(k)
                else:
                    with torch.cuda.stream(stream):
                        out = fn(k)
            except BaseException as e:      # handed to the caller
                with self._cv:
                    if self._error is None and not isinstance(e, _Aborted):
                        self._error = e
                    self._aborted = True
                    self._end(k)
                continue
            finally:
                fn = None           # hold no task between runs
            with self._cv:
                self._results[k] = out
                self._end(k)
            out = None

    def _end(self, k: int) -> None:
        """Block k is done (lock held): hand the turn on."""
        self._active[k] = False
        self._tasks[k] = None
        self._pass(k)

    def _took(self) -> None:
        """A block takes the turn (lock held): mark the tally."""
        if self._tally is not None:
            self._mark = self._tally()

    def _pass(self, k: int) -> None:
        """The turn to the next active block after k, which held it (lock
        held); k's tally grows by what grew while it held the turn."""
        if self._tally is not None:
            self.tallies[k] += self._tally() - self._mark
        for j in range(1, self.n + 1):
            nxt = (k + j) % self.n
            if self._active[nxt]:
                self._turn = nxt
                break
        else:
            self._turn = None
        self._cv.notify_all()

    def exchange(self, k: int, op: str, value, once=None) -> list:
        """Block k's side of a collective: deposit ``value``, hand the turn
        on, and once every block has deposited return all values in block
        order. With ``once``, ``once(values)`` is computed by the first
        block to read and its result returned to every block instead."""
        with self._cv:
            seq = self._seq[k]
            self._seq[k] += 1
            slot = self._slots.setdefault(seq, {"ops": [None] * self.n,
                                                "vals": [None] * self.n,
                                                "vers": [None] * self.n,
                                                "read": 0})
            slot["ops"][k] = op
            slot["vals"][k] = value
            slot["vers"][k] = getattr(value, "_version", None)
            self._pass(k)
            while self._turn != k and not self._aborted:
                self._cv.wait()
            if self._aborted:
                raise _Aborted()
            self._took()
            if slot["ops"] != [op] * self.n:
                self._aborted = True
                raise RuntimeError(
                    f"replica mesh blocks left lock step at collective "
                    f"{seq}: {slot['ops']} (None: the block ended)")
            vals = slot["vals"]
            moved = [j for j, v in enumerate(vals)
                     if getattr(v, "_version", None) != slot["vers"][j]]
            if moved:
                self._aborted = True
                raise RuntimeError(
                    f"replica mesh collective {seq} ({op}): blocks {moved} "
                    "changed their operand in place before every block "
                    "had read it")
            if once is not None:
                if "once" not in slot:
                    slot["once"] = once(vals)
                vals = slot["once"]
            slot["read"] += 1
            if slot["read"] == self.n:
                del self._slots[seq]
            return vals


class _Aborted(Exception):
    """Another block failed: this one stops at its next collective."""


class BlockComm:
    """The replica-axis interface of ``MeshComm`` that the protocol
    bodies use, for block ``block`` of the one-process mesh (row
    ``block // P``, lane slice ``block % P``): ``rank``, ``pshard``,
    ``local``, ``replica_ids``, ``all_gather``, ``all_gather_lanes``,
    ``select_row`` and ``leader_cols``, each collective a ``LockStep``
    exchange whose result is copied onto the operand's device (a copy
    within the card when the blocks share one). An operand must not be
    changed in place until the next collective (``LockStep``). No operand
    goes through the host; ``host_once`` is a flight's one read of its
    decision plane, counted in ``host_copies``. ``collectives`` counts the
    replica collectives and ``copies`` the tensors they moved into this
    block."""

    def __init__(self, lockstep: LockStep, block: int, n_replicas: int,
                 payload_shards: int = 1):
        P = payload_shards
        self.lockstep = lockstep
        self.block = block
        self.n_replicas = n_replicas
        self.payload_shards = P
        self.rank = block // P          # the replica row
        self.pshard = block % P         # the lane slice
        self._column = [r * P + self.pshard for r in range(n_replicas)]
        self._row = [self.rank * P + q for q in range(P)]
        self.collectives = 0
        self.copies = 0
        self.host_copies = 0

    def replica_ids(self, device) -> torch.Tensor:
        return torch.full((1,), self.rank, dtype=torch.int32, device=device)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.rank:self.rank + 1]

    def _gather(self, op: str, x: torch.Tensor, members) -> list:
        vals = self.lockstep.exchange(self.block, op, x)
        self.collectives += 1
        self.copies += len(members)
        return [vals[m].to(x.device, copy=True) for m in members]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...] per-block values -> [R, ...] over the block's column,
        on ``x``'s device."""
        return torch.cat(self._gather("all_gather", x, self._column), 0)

    #: the launch plane stays on the devices (a flight reads it to the
    #: host once, ``host_once``)
    all_gather_plane = all_gather

    def all_gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """Every lane slice of this block's row: [..., w] a block ->
        [..., P*w] over the row's P blocks, on ``x``'s device."""
        return torch.cat(self._gather("all_gather_lanes", x, self._row), -1)

    def host_once(self, x: torch.Tensor) -> torch.Tensor:
        """A value every block holds alike, on the host: one host copy
        for all blocks (block order's first reader makes it)."""
        def copy(vals):
            self.host_copies += 1
            return vals[self.block].cpu()

        return self.lockstep.exchange(self.block, "host_once", x, once=copy)

    def select_row(self, x: torch.Tensor, idx) -> torch.Tensor:
        return take(self.all_gather(x), idx, 0)

    def leader_cols(self, win: torch.Tensor, leader, w: int) -> torch.Tensor:
        """The leader row's lane block [B, w] (``w`` = the local lanes)."""
        return take(self.all_gather(win[None]), leader, 0)
