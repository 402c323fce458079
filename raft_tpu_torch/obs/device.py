"""Device-resident observability: the event ring and on-device counters
(port of ``raft_tpu/obs/device.py``).

Host nodelog call sites see a protocol transition only when a tick
returns to the host. The fused K-tick window (one CUDA graph replay) and
the pipelined flights do not, so this module records the transitions ON
the device, beside the protocol steps:

- :class:`EventRing` — a fixed-capacity ring of fixed-width int32 records
  on the engine's device. Each record is ``REC_W`` lanes: (seq, tick,
  node, group, kind code, term, role, commit, last, aux). The ring is
  UPDATED IN PLACE: ``buf``, ``count``, ``tick`` and ``counters`` are
  tensors at fixed addresses, so a CUDA graph captures the recording
  with the ticks and the flush reads the same tensors. (The JAX ring is
  a pytree each step returns anew.)
- :func:`dev_record` — the masked write: the record goes to slot
  ``count % capacity`` and ``count`` advances iff ``cond``, with no host
  read. ``seq`` is the ring's monotone counter, so laps never reorder or
  renumber surviving records.
- :func:`record_replicate_events` / :func:`record_vote_events` — the
  bodies the step functions run in their ``record=True`` mode. They
  derive role change, term adoption, election win, commit advance and
  repair-window motion from the (old, new, info) triple alone, as plain
  torch ops after the step (whichever kernel it ran), so the recorded
  step's state equals the unrecorded step's by construction. Records are
  written one at a time, in the JAX order, so a step whose candidates
  exceed the capacity leaves exactly the JAX ring.
- the on-device metrics vector (``EventRing.counters``): elections, term
  adoptions, commits, heartbeat ticks, repair rounds, folded into the
  metrics registry at flush.
- :func:`packed_flush` — the ring and a trailer (count, tick, counters)
  as one i32[capacity + 1, REC_W] tensor: one device fetch per launch
  boundary. :func:`decode_records` turns it into ``obs.events.Event``
  objects whose ``nodelog()`` rendering, for the kinds the host recorder
  also logs (``elect``, ``commit``), is the host line byte for byte.
- :class:`DeviceObs` — the host-side plane an engine flushes into;
  :func:`merged_timeline` interleaves it with the flight recorder.

The record layout, the kind, role and counter codes and
``COUNTER_METRICS`` are the JAX package's, so a packed flush of either
package decodes in the other. Detached costs nothing: no ring is
allocated and no flush runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.comm import take_groups
from raft_tpu_torch.obs.events import Event

# ------------------------------------------------------------ record layout
#: int32 lanes per record.
REC_W = 10
#: field offsets inside a record (the order the module docstring names)
F_SEQ, F_TICK, F_NODE, F_GROUP, F_KIND, F_TERM, F_ROLE, F_COMMIT, \
    F_LAST, F_AUX = range(REC_W)

#: kind codes (0 is reserved = "empty slot"; decode rejects it)
K_ELECT = 1          # election win          (host twin: "state changed to leader")
K_COMMIT = 2         # commit advance        (host twin: "commit index changed to N")
K_TERM_ADOPT = 3     # a row adopted a higher term (silent on the host)
K_STEP_DOWN = 4      # step saw a term above the leader's (host acts next tick)
K_REPAIR = 5         # repair window moved (aux = window start index)

KIND_NAMES = {
    K_ELECT: "elect",
    K_COMMIT: "commit",
    K_TERM_ADOPT: "term_adopt",
    K_STEP_DOWN: "step_down",
    K_REPAIR: "repair_floor",
}

#: role codes (record field F_ROLE) -> engine role strings
ROLE_FOLLOWER, ROLE_CANDIDATE, ROLE_LEADER = 0, 1, 2
ROLE_NAMES = {ROLE_FOLLOWER: "follower", ROLE_CANDIDATE: "candidate",
              ROLE_LEADER: "leader"}

# ------------------------------------------------------- on-device counters
#: offsets into ``EventRing.counters`` (the on-device metrics vector)
C_ELECTIONS, C_TERM_ADOPTIONS, C_COMMITS, C_TICKS, C_REPAIRS = range(5)
N_COUNTERS = 5
COUNTER_NAMES = (
    "elections", "term_adoptions", "commits", "heartbeat_ticks",
    "repair_rounds",
)
#: registry metric name for counter i at flush
COUNTER_METRICS = tuple(f"raft_device_{n}_total" for n in COUNTER_NAMES)

# the flush trailer packs (count, tick, counters...) into one REC_W row
assert N_COUNTERS + 2 <= REC_W


@dataclasses.dataclass(eq=False)
class EventRing:
    """The device-resident ring, updated in place (module doc).

    ``count`` is the monotone seq counter (total records ever written, the
    next record's seq); the slot of seq ``s`` is ``s % capacity``, so
    ``max(0, count - capacity)`` oldest records have been lapped. ``tick``
    counts recorded steps (the stamp records carry); ``counters`` is the
    on-device metrics vector."""

    buf: torch.Tensor       # i32[capacity, REC_W]
    count: torch.Tensor     # i32[]
    tick: torch.Tensor      # i32[]
    counters: torch.Tensor  # i32[N_COUNTERS]

    @property
    def capacity(self) -> int:
        return self.buf.shape[-2]

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.buf, self.count, self.tick, self.counters)

    def save(self) -> Tuple[torch.Tensor, ...]:
        """Copies of the four tensors (``restore`` puts them back)."""
        return tuple(t.clone() for t in self.tensors())

    def restore(self, saved) -> None:
        for t, s in zip(self.tensors(), saved):
            t.copy_(s)


def init_ring(capacity: int = 4096, device=None) -> EventRing:
    """A fresh empty ring on ``device`` (CUDA unless ``"cpu"`` is named,
    as every entry point of the port)."""
    from raft_tpu_torch.transport.device import resolve_device

    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    dev = resolve_device(device)
    z = dict(dtype=torch.int32, device=dev)
    return EventRing(
        buf=torch.zeros((capacity, REC_W), **z),
        count=torch.zeros((), **z),
        tick=torch.zeros((), **z),
        counters=torch.zeros((N_COUNTERS,), **z),
    )


def init_group_rings(capacity: int, n_groups: int,
                     device=None) -> EventRing:
    """G independent rings as one :class:`EventRing` whose four tensors
    carry a leading group axis (``raft_tpu/obs/device.py:136``): ``buf``
    [G, capacity, REC_W], ``count`` and ``tick`` [G], ``counters``
    [G, N_COUNTERS]. The recorded group programs write every group's
    records in one batched op each; group g's ring is JAX's ring of
    group g byte for byte."""
    one = init_ring(capacity, device)
    return EventRing(*(t.unsqueeze(0).repeat((n_groups,) + (1,) * t.dim())
                       for t in one.tensors()))


def _grouped(ring: EventRing) -> EventRing:
    """A one-group ring as a group ring with G = 1 (views: writes through
    them land in the ring)."""
    return EventRing(*(t[None] for t in ring.tensors()))


class Pre(NamedTuple):
    """The three small leaves recording reads from the state BEFORE a
    step, copied out first: kernel K2, the flights and the captured
    graphs write the small leaves in place."""

    term: torch.Tensor
    commit_index: torch.Tensor
    last_index: torch.Tensor


def pre_of(state) -> Pre:
    return Pre(state.term.clone(), state.commit_index.clone(),
               state.last_index.clone())


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as int32 of ``like``'s shape on its device: a fill for a
    Python int, never a host copy (legal inside a graph capture); a 0-d
    tensor broadcasts over a group axis."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(
            x.to(device=like.device, dtype=torch.int32), like.shape)
    return like.new_full(like.shape, int(x))


def _as_bool(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as bool of ``like``'s shape on its device (a bool tensor is
    used as it is: no op)."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(
            x.to(device=like.device, dtype=torch.bool), like.shape)
    return like.new_full(like.shape, bool(x), dtype=torch.bool)


def make_rec(kind: int, node, term, role: int, commit, last, aux,
             group, like: torch.Tensor) -> torch.Tensor:
    """Fields 2.. of one record (i32[REC_W - 2]; [G, REC_W - 2] when
    ``like`` is a group ring's [G] ``count``); ``seq`` and ``tick`` are
    stamped by :func:`dev_record`. Scalars may be ints, 0-d or [G]
    tensors; ``like`` names the device and the group axis."""
    return torch.stack([_i32(v, like) for v in (
        node, group, kind, term, role, commit, last, aux)], dim=-1)


def dev_record(ring: EventRing, cond, rec: torch.Tensor) -> EventRing:
    """Masked ring append, in place: write ``rec`` (the fields of
    :func:`make_rec`) at slot ``count % capacity`` stamped with (count,
    tick), and bump ``count``, iff ``cond``; otherwise the ring is left
    bit-unchanged. On a group ring ``cond`` is [G] and each group's
    record goes to its own slot, all in one write. No value is read back
    to the host."""
    if ring.count.dim() == 0:
        dev_record(_grouped(ring), _as_bool(cond, ring.count).reshape(1),
                   rec[None])
        return ring
    G, cap = ring.count.shape[0], ring.capacity
    cond = _as_bool(cond, ring.count)
    slot = torch.remainder(ring.count, cap).long()
    if G > 1:
        slot = slot + torch.arange(0, G * cap, cap, device=slot.device)
    full = torch.cat([ring.count[:, None], ring.tick[:, None],
                      rec.to(torch.int32)], dim=1)
    flat = ring.buf.view(G * cap, REC_W)
    cur = flat.index_select(0, slot)
    flat.index_copy_(0, slot, torch.where(cond[:, None], full, cur))
    ring.count.add_(cond.to(torch.int32))
    return ring


def dev_count(ring: EventRing, idx: int, amount) -> EventRing:
    """Bump on-device metrics counter ``idx`` by ``amount`` (an int, a 0-d
    or, on a group ring, a [G] tensor), in place."""
    ring.counters[..., idx].add_(_i32(amount, ring.count))
    return ring


# ------------------------------------------------- step instrumentation
def _gathered(comm, *states):
    """(term, commit_index, last_index) of every row of each state, [R]
    (or [G, R] for group states)."""
    return [comm.all_gather(getattr(st, f)) for st in states
            for f in ("term", "commit_index", "last_index")]


def _as_group_args(ring, *values):
    """A one-group recording's ring and values with a G = 1 axis."""
    if ring.count.dim() > 0:
        return (ring,) + values
    return (_grouped(ring),) + tuple(
        v[None] if isinstance(v, torch.Tensor) else v for v in values)


def _adoptions(ring, old_term, new_term, new_commit, new_last,
               group_id) -> None:
    """Per-row term adoption records (R conditional writes, in row order;
    [G, R] operands) and the adoptions counter."""
    adopt = new_term > old_term
    for p in range(new_term.shape[-1]):
        dev_record(ring, adopt[..., p], make_rec(
            K_TERM_ADOPT, p, new_term[..., p], ROLE_FOLLOWER,
            new_commit[..., p], new_last[..., p], old_term[..., p],
            group_id, ring.count,
        ))
    dev_count(ring, C_TERM_ADOPTIONS, adopt.to(torch.int32).sum(-1))


def record_replicate_events(
    ring: EventRing, comm, old, new, info, leader, leader_term,
    group_id=-1, *, repair: bool = True, ticks=1,
) -> EventRing:
    """Record one replicate step's transitions, derived from the (old,
    new, info) triple alone (``raft_tpu/obs/device.py:182``): the commit
    advance (the host nodelog twin), per-row term adoptions, a step-down
    signal (``max_term`` above the leader's) and repair-window motion;
    counters: ticks (``ticks`` a legitimate step, so a chunk can charge
    its whole flight), commits (entry delta), term adoptions, repair
    rounds. ``old`` is a :class:`Pre` or a state whose small leaves the
    step did not overwrite.

    On a group ring (:func:`init_group_rings`) every operand carries the
    leading group axis (``leader``, ``leader_term``, ``group_id`` [G],
    the states' leaves [G, R], ``info``'s fields [G]), as JAX's vmapped
    body: each group's records go into its own ring in JAX's order, one
    batched write per record kind, however many groups there are."""
    ot, oc, ol, nt, nc, nl = _gathered(comm, old, new)
    ring_g, ot, oc, ol, nt, nc, nl, commit, max_term, rstart = \
        _as_group_args(ring, ot, oc, ol, nt, nc, nl, info.commit_index,
                       info.max_term, info.repair_start)
    like = ring_g.count
    leader = _i32(leader, like)
    leader_term = _i32(leader_term, like)
    old_commit_l = take_groups(oc, leader)
    old_last_l = take_groups(ol, leader)
    new_commit_l = take_groups(nc, leader)
    new_last_l = take_groups(nl, leader)
    legit = leader_term >= 1

    ring_g.tick.add_(1)
    dev_count(ring_g, C_TICKS, legit.to(torch.int32) * _i32(ticks, like))

    commit_adv = legit & (commit > old_commit_l)
    dev_record(ring_g, commit_adv, make_rec(
        K_COMMIT, leader, leader_term, ROLE_LEADER, commit, new_last_l, 0,
        group_id, like,
    ))
    dev_count(ring_g, C_COMMITS, torch.where(
        commit_adv, commit - old_commit_l, 0))

    _adoptions(ring_g, ot, nt, nc, nl, group_id)

    step_down = legit & (max_term > leader_term)
    dev_record(ring_g, step_down, make_rec(
        K_STEP_DOWN, leader, max_term, ROLE_FOLLOWER, new_commit_l,
        new_last_l, leader_term, group_id, like,
    ))

    if repair:
        moved = legit & (rstart >= 1) & (old_last_l >= rstart)
        dev_record(ring_g, moved, make_rec(
            K_REPAIR, leader, leader_term, ROLE_LEADER, commit, new_last_l,
            rstart, group_id, like,
        ))
        dev_count(ring_g, C_REPAIRS, moved.to(torch.int32))
    return ring


def record_vote_events(
    ring: EventRing, comm, old, new, info, candidate, cand_term,
    quorum, group_id=-1,
) -> EventRing:
    """Record one vote round (``raft_tpu/obs/device.py:260``): the
    election win (the host's "state changed to leader" twin: a vote
    majority, ``votes > quorum``, and no higher term heard) and per-row
    term adoptions. A group ring takes [G] operands, as
    :func:`record_replicate_events`."""
    ot, _oc, _ol, nt, nc, nl = _gathered(comm, old, new)
    ring_g, ot, nt, nc, nl, votes, max_term = _as_group_args(
        ring, ot, nt, nc, nl, info.votes, info.max_term)
    like = ring_g.count
    candidate = _i32(candidate, like)
    cand_term = _i32(cand_term, like)

    ring_g.tick.add_(1)
    win = (votes > _i32(quorum, like)) & (max_term <= cand_term)
    dev_record(ring_g, win, make_rec(
        K_ELECT, candidate, cand_term, ROLE_LEADER,
        take_groups(nc, candidate), take_groups(nl, candidate), votes,
        group_id, like,
    ))
    dev_count(ring_g, C_ELECTIONS, win.to(torch.int32))
    _adoptions(ring_g, ot, nt, nc, nl, group_id)
    return ring


# --------------------------------------------------------------- flushing
def packed_flush(ring: EventRing) -> torch.Tensor:
    """The whole ring as ONE i32[capacity + 1, REC_W] tensor for a single
    device fetch per launch boundary: the buffer plus a trailer row
    carrying (count, tick, counters...). A group ring packs as
    i32[G, capacity + 1, REC_W] (``raft_tpu/obs/device.py:311``)."""
    trailer = torch.cat([
        ring.count[..., None], ring.tick[..., None], ring.counters,
        ring.count.new_zeros(ring.count.shape + (REC_W - 2 - N_COUNTERS,)),
    ], dim=-1)
    return torch.cat([ring.buf, trailer[..., None, :]], dim=-2)


flush_pack = packed_flush


def _node_name(node: int, group: int) -> str:
    return f"Server{node}" if group < 0 else f"g{group}/Server{node}"


def _msg_of(kind_code: int, commit: int) -> Optional[str]:
    if kind_code == K_ELECT:
        return "state changed to leader"
    if kind_code == K_COMMIT:
        return f"commit index changed to {commit}"
    return None            # recorder-only: never entered the trace stream


def decode_records(
    packed: np.ndarray,
    start_seq: int = 0,
    t_virtual: float = 0.0,
) -> Tuple[List[Event], int, int, np.ndarray, int]:
    """Decode one :func:`packed_flush` fetch into ``obs.events.Event``
    objects.

    Returns ``(events, count, lost, counters, tick)`` where ``events``
    are the decoded records with seq >= ``start_seq`` still resident in
    the ring (seq order), and ``lost`` counts records that lapped out
    between flushes (seq < the oldest resident record but >=
    ``start_seq``). ``Event.seq`` carries the DEVICE seq; ``t_virtual``
    stamps the flush-time virtual clock (the engine flushes once per
    launch, so decoded events carry the tick they surfaced at)."""
    packed = np.asarray(packed)
    cap = packed.shape[0] - 1
    trailer = packed[-1]
    count, tick = int(trailer[0]), int(trailer[1])
    counters = trailer[2 : 2 + N_COUNTERS].astype(np.int64)
    oldest = max(0, count - cap)
    lost = max(0, oldest - start_seq)
    events: List[Event] = []
    for s in range(max(start_seq, oldest), count):
        row = packed[s % cap]
        if int(row[F_SEQ]) != s or int(row[F_KIND]) == 0:
            continue       # torn slot (cannot happen post-flush; belt)
        kind_code = int(row[F_KIND])
        group = int(row[F_GROUP])
        commit = int(row[F_COMMIT])
        events.append(Event(
            seq=s,
            t_virtual=t_virtual,
            node=_node_name(int(row[F_NODE]), group),
            group=None if group < 0 else group,
            term=int(row[F_TERM]),
            kind=KIND_NAMES.get(kind_code, f"dev_kind_{kind_code}"),
            state=ROLE_NAMES.get(int(row[F_ROLE]), ""),
            commit_index=commit,
            last_index=int(row[F_LAST]),
            msg=_msg_of(kind_code, commit),
            fields={
                "device": True, "tick": int(row[F_TICK]),
                "aux": int(row[F_AUX]),
            },
        ))
    return events, count, lost, counters, tick


class DeviceObs:
    """Host-side accumulation plane for device-recorded observability.

    One instance can span several engines / crash-restore cycles (an
    ``ObsStack`` holds one per run, like the flight recorder): each
    engine keeps its own ring + flush cursor and ``ingest``s decoded
    events here. ``counters`` accumulates the on-device metrics vector
    per group label; ``dropped`` counts records lapped out before any
    flush saw them (the overflow contract: seq stays monotone, losses
    are reported, never silent)."""

    def __init__(self, capacity: int = 4096,
                 host_capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        from collections import deque

        self.capacity = capacity
        self.events = deque(maxlen=host_capacity)
        #   decoded events, host-side bounded like the FlightRecorder's
        #   ring; host evictions are counted separately from device
        #   laps (``dropped`` = records lost BEFORE any flush saw them)
        self.host_evicted = 0
        self.dropped = 0
        # epoch accounting: each engine attachment is one EPOCH whose
        # device-side readings (seq counter, metrics vector) restart at
        # zero; completed epochs fold into the ``_base_*`` accumulators
        # (new_epoch) so a crash-restored engine ADDS to the plane
        # instead of regressing it, and its seqs re-offset past
        # everything already ingested.
        self._cur_totals: Dict[Optional[int], int] = {}
        self._cur_laps: Dict[Optional[int], int] = {}
        self._cur_counters: Dict[Tuple[str, str], int] = {}
        self._base_totals: Dict[Optional[int], int] = {}
        self._base_laps: Dict[Optional[int], int] = {}
        self._base_counters: Dict[Tuple[str, str], int] = {}

    # ------------------------------------------------------------ epochs
    def new_epoch(self) -> None:
        """Fold the current engine's cumulative device readings into the
        base accumulators — called by ``attach_device_obs`` whenever an
        engine (fresh boot, crash-restore) adopts this plane. Idempotent
        on an empty current epoch."""
        for g, tot in self._cur_totals.items():
            self._base_totals[g] = self._base_totals.get(g, 0) + tot
        for g, laps in self._cur_laps.items():
            self._base_laps[g] = self._base_laps.get(g, 0) + laps
        for key, v in self._cur_counters.items():
            self._base_counters[key] = self._base_counters.get(key, 0) + v
        self._cur_totals = {}
        self._cur_laps = {}
        self._cur_counters = {}

    # ------------------------------------------------------------ ingest
    def ingest(self, events: List[Event], *, total: int, lost: int,
               counters: np.ndarray, group: Optional[int] = None) -> None:
        base = self._base_totals.get(group, 0)
        if base:
            # keep the accumulated stream's seqs monotone across engine
            # generations (each fresh ring restarts at 0)
            import dataclasses

            events = [dataclasses.replace(e, seq=e.seq + base)
                      for e in events]
        room = self.events.maxlen - len(self.events)
        if len(events) > room:
            self.host_evicted += len(events) - room
        self.events.extend(events)
        self.dropped += lost
        self._cur_totals[group] = total
        self._cur_laps[group] = total // self.capacity
        label = "0" if group is None else str(group)
        for i, name in enumerate(COUNTER_METRICS):
            self._cur_counters[(name, label)] = int(counters[i])

    # ----------------------------------------------------------- queries
    @property
    def counters(self) -> Dict[str, Dict[str, int]]:
        """name -> {group label -> value}, summed across epochs."""
        out: Dict[str, Dict[str, int]] = {}
        for src in (self._base_counters, self._cur_counters):
            for (name, label), v in src.items():
                out.setdefault(name, {})
                out[name][label] = out[name].get(label, 0) + v
        return out

    @property
    def total_recorded(self) -> int:
        return (sum(self._base_totals.values())
                + sum(self._cur_totals.values()))

    @property
    def laps(self) -> int:
        groups = set(self._base_laps) | set(self._cur_laps)
        return max(
            (self._base_laps.get(g, 0) + self._cur_laps.get(g, 0)
             for g in groups),
            default=0,
        )

    def of_kind(self, *kinds: str, group: Optional[int] = None):
        want = set(kinds)
        return [
            e for e in self.events
            if e.kind in want and (group is None or e.group == group)
        ]

    def nodelog_lines(self) -> List[str]:
        """The decoded device stream's nodelog renderings (events whose
        kind overlaps the host trace stream — elect / commit)."""
        return [e.nodelog() for e in self.events if e.msg is not None]

    # --------------------------------------------------------- (de)serial
    def to_jsonable(self) -> dict:
        return {
            "capacity": self.capacity,
            "dropped": self.dropped,
            "laps": self.laps,
            "total_recorded": self.total_recorded,
            "counters": self.counters,
            "events": [e.to_jsonable() for e in self.events],
        }

    @classmethod
    def from_jsonable(cls, d: dict) -> "DeviceObs":
        obs = cls(capacity=d.get("capacity", 4096))
        obs.dropped = d.get("dropped", 0)
        for name, series in d.get("counters", {}).items():
            for label, v in series.items():
                obs._base_counters[(name, label)] = int(v)
        obs._base_totals = {None: d.get("total_recorded", len(d["events"]))}
        obs._base_laps = {None: d.get("laps", 0)}
        obs.events.extend(Event.from_jsonable(ed) for ed in d["events"])
        return obs


def merged_timeline(recorder, device_obs) -> List[Event]:
    """Host flight-recorder events and decoded device events as ONE
    stream, ordered by virtual time with device events first inside a
    tie (the device step ran before the host bookkeeping that observed
    it) — the forensics view ``--explain`` interleaves."""
    host = list(recorder._ring) if recorder is not None else []
    dev = list(device_obs.events) if device_obs is not None else []
    tagged = [(e.t_virtual, 0, i, e) for i, e in enumerate(dev)]
    tagged += [(e.t_virtual, 1, i, e) for i, e in enumerate(host)]
    tagged.sort(key=lambda t: t[:3])
    return [e for _, _, _, e in tagged]
