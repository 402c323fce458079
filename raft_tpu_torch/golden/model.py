"""The reference's Raft, re-expressed as a deterministic host-side oracle
(a copy of ``raft_tpu/golden/model.py``, which uses the standard library
only; the port keeps its own so that it never imports the JAX package).

This is a behavioral port of the reference's ``main.go`` at the *message*
level: the same state fields, the same request/response schemas, and the
same handler logic, including the reference's deliberate deviations from
the Raft paper, which the differential tests must reproduce, not fix
(SURVEY.md §2 "protocol semantics in detail"):

- blind append with no conflict truncation (main.go:148);
- commit advance ``min(LeaderCommit, len(log) + 1)`` with its ``+1``
  (main.go:151-154);
- a sticky ``voted`` bool instead of per-term ``votedFor`` (main.go:160,
  never reset on term advance — the only reset is a leader stepping down,
  main.go:318);
- no §5.4.1 up-to-date check (LastLogIndex/LastLogTerm are carried but
  never filled or read, main.go:185-186, 264);
- followers self-report their match point in every response and the leader
  jumps straight to it (main.go:301, 375-378);
- the exact-bucket commit rule over follower match indices only
  (main.go:381-391).

The one reference behavior deliberately *not* ported is the main.go:242
bug (a candidate denying a competing vote writes the rejection into its
own response channel, corrupting its next count) — SURVEY.md §2 marks it a
defect to exclude from the oracle.

Scheduling: the reference runs one goroutine per node with blocking
channel round-trips (send to peer, immediately block on own response
channel — main.go:259-269, 334-379). Because every request is followed by
a synchronous wait for exactly one reply, the observable semantics are
those of an atomic RPC; the oracle models it as a direct handler call.
Timers (election timeouts, the 2 s leader tick, the 10 s client period)
run on a seeded virtual clock, so every run is replayable (SURVEY.md §7
hard part 4: deterministic schedules for byte-identical comparison).
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Callable, Dict, List, Optional, Tuple

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


@dataclasses.dataclass
class LogEntry:
    """main.go:46-49 — the reference payload is one int; here raw bytes so
    the differential test can compare against 256 B device entries."""

    term: int
    payload: bytes


@dataclasses.dataclass
class VoteRequest:          # main.go:182-187
    term: int
    candidate_id: str
    last_log_index: int = 0  # schema'd but never filled by the reference
    last_log_term: int = 0


@dataclasses.dataclass
class VoteResponse:         # main.go:188-191
    term: int
    vote: bool


@dataclasses.dataclass
class AppendEntriesRequest:  # main.go:289-296
    term: int
    leader_id: str
    logs: List[LogEntry]
    leader_commit: int
    prev_log_index: int
    prev_log_term: int


@dataclasses.dataclass
class AppendEntriesResponse:  # main.go:298-302
    term: int
    success: bool
    match_index: int


class GoldenNode:
    """One replica's state + handlers (the reference's ``Node``,
    main.go:14-39, with the role handlers' message logic)."""

    def __init__(self, node_id: str, trace: Optional[Callable[[str], None]] = None):
        self.id = node_id
        self.state = FOLLOWER          # main.go:61
        self.term = 0
        self.voted = False             # the reference's sticky bool
        self.log: List[LogEntry] = []
        self.commit_index = 0
        self.last_applied = 0          # used as "last log index" (SURVEY §2)
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        self.logreq: List[bytes] = []  # the buffered LogReq channel
        #   (main.go:36, 72): the client writes here; only LeaderRun reads
        #   it (main.go:327), so values buffered while the node is not a
        #   leader sit until it (re)wins — a faithful reference quirk.
        self.last_heard = 0.0          # virtual time of the last timer-
        #   resetting receipt (AppendEntries receipt main.go:124-127;
        #   granted VoteRequest main.go:162) — maintained by the cluster
        self._trace = trace

    # -- observability: the reference's nodelog format (main.go:399-401) ----
    def nodelog(self, message: str) -> str:
        line = (
            f"[{self.id}:{self.term}:{self.commit_index}:{self.last_applied}]"
            f"[{self.state}]{message}"
        )
        if self._trace is not None:  # not truthiness: empty sinks are falsy
            self._trace(line)
        return line

    # -- log accessors (1-indexed, main.go:403-409) -------------------------
    def get_log(self, index: int) -> LogEntry:
        return self.log[index - 1]

    def get_logs_from(self, index: int) -> List[LogEntry]:
        return self.log[index - 1 :]

    # -- follower/candidate message handlers --------------------------------
    def handle_append_entries(self, r: AppendEntriesRequest) -> AppendEntriesResponse:
        """Follower AppendEntries logic, main.go:121-156 (quirks preserved)."""
        self.nodelog(f"AppendEntriesRequest received from {r.leader_id}")
        if r.term < self.term:                       # main.go:129-133
            return AppendEntriesResponse(self.term, False, self.last_applied)
        if self.state == LEADER:
            # A leader hearing an equal-term AppendEntries refuses and stays
            # (main.go:322-326); a higher term makes it step down and ack
            # (main.go:309-321).
            if r.term == self.term:
                return AppendEntriesResponse(self.term, False, self.last_applied)
            self.step_down(r.term)
            return AppendEntriesResponse(self.term, True, self.last_applied)
        if self.state == CANDIDATE:
            # A candidate steps down on >=-term AppendEntries (main.go:204-217).
            self.state = FOLLOWER
            self.term = r.term
            self.nodelog("step down to follower (AppendEntries received)")
        if self.last_applied > 0:                    # main.go:135-146
            if self.last_applied + len(r.logs) < r.prev_log_index:
                return AppendEntriesResponse(self.term, False, self.last_applied)
            if self.get_log(r.prev_log_index).term != r.prev_log_term:
                return AppendEntriesResponse(self.term, False, self.last_applied)
        self.log.extend(r.logs)                      # blind append, main.go:148
        self.last_applied += len(r.logs)             # main.go:149
        if r.leader_commit > self.commit_index:      # main.go:151-154 (the +1
            self.commit_index = min(r.leader_commit, len(self.log) + 1)
        self.term = r.term                           # main.go:155
        return AppendEntriesResponse(self.term, True, self.last_applied)

    def handle_request_vote(self, r: VoteRequest) -> VoteResponse:
        """Vote logic, main.go:157-170 (follower) / 224-246 (candidate)."""
        if self.state == CANDIDATE:
            # Candidate grants only to a strictly-higher-term candidate
            # (main.go:227-239); the equal/lower-term denial's main.go:242
            # self-delivery bug is NOT ported (SURVEY.md §2).
            if r.term > self.term:
                self.term = r.term
                self.voted = True
                self.state = FOLLOWER
                self.nodelog(f"vote to {r.candidate_id} (higher term); step down")
                return VoteResponse(self.term, True)
            return VoteResponse(self.term, False)
        if r.term < self.term or self.voted:         # main.go:160
            self.nodelog(f"vote request denied to {r.candidate_id}")
            return VoteResponse(self.term, False)
        self.term = r.term                           # main.go:168
        self.voted = True
        self.nodelog(f"voted to {r.candidate_id}")
        return VoteResponse(self.term, True)

    def step_down(self, term: int) -> None:
        """Leader -> follower on higher-term AppendEntries (main.go:312-321)
        — the only place the reference resets ``voted``."""
        self.state = FOLLOWER
        self.voted = False
        self.term = term
        self.nodelog("step down to follower")

    # -- client ingest (leader only), main.go:327-331 -----------------------
    def client_append(self, payload: bytes) -> None:
        self.log.append(LogEntry(self.term, payload))
        self.last_applied += 1
        self.nodelog("new log received")

    def committed_payloads(self) -> List[bytes]:
        """The committed prefix — the differential-test join key. The
        reference's commit_index can point one past the log (its +1 quirk);
        the prefix is what exists."""
        return [e.payload for e in self.log[: min(self.commit_index, len(self.log))]]


class GoldenCluster:
    """All nodes + the seeded virtual-clock scheduler.

    Events reproduce the reference's timers: follower election timeout
    uniform 10-29 s inclusive (main.go:114), candidate re-election timeout
    10-13 s (main.go:194), leader tick 2 s (main.go:394), client inject
    10 s (main.go:89). ``rng`` draws make every schedule replayable.
    """

    def __init__(
        self,
        n_nodes: int = 3,
        seed: int = 0,
        trace: Optional[Callable[[str], None]] = None,
        channel_depth: int = 10,
    ):
        # ``channel_depth`` models the reference's buffered channels (all
        # capacity 10, main.go:68-72): a full LogReq channel BLOCKS the
        # client goroutine mid-send (main.go:92) until the leader drains.
        # Wire ``RaftConfig.channel_depth`` here when driving differential
        # runs from a config.
        self.channel_depth = channel_depth
        self._client_blocked: Optional[Tuple[bytes, List[str]]] = None
        #   (value, remaining targets) of a send the client is blocked on
        self.rng = random.Random(seed)
        self.nodes: Dict[str, GoldenNode] = {
            f"Server{i}": GoldenNode(f"Server{i}", trace) for i in range(n_nodes)
        }
        self.now = 0.0
        self._q: List[Tuple[float, int, str, str]] = []  # (t, seq, kind, node)
        self._seq = 0
        self._timer_gen: Dict[str, int] = {n: 0 for n in self.nodes}
        self._armed_at: Dict[str, float] = {n: 0.0 for n in self.nodes}
        self.client_values: List[bytes] = []   # injection queue (see inject())
        # Fault masks (OUR extension — no node ever fails in the reference,
        # SURVEY §5; these mirror the engine's alive/slow masks so the same
        # fault schedule can drive both sides of a differential test).
        # dead: timers don't fire, nothing is delivered, no votes; slow:
        # AppendEntries are not delivered (stale matchIndex).
        self.alive: Dict[str, bool] = {n: True for n in self.nodes}
        self.slow: Dict[str, bool] = {n: False for n in self.nodes}
        self._group_of: Optional[Dict[str, int]] = None   # see partition()
        for name in self.nodes:
            self._arm_follower_timeout(name)

    @classmethod
    def from_config(
        cls,
        cfg,
        trace: Optional[Callable[[str], None]] = None,
    ) -> "GoldenCluster":
        """Build the oracle for one side of a differential run from the
        same ``RaftConfig`` that builds the engine: cluster size, seed and
        the LogReq channel depth (main.go:68-72) come from the config."""
        return cls(
            cfg.n_replicas, seed=cfg.seed, trace=trace,
            channel_depth=cfg.channel_depth,
        )

    # -- fault injection (engine-mask mirror, not reference behavior) -------
    def fail(self, name: str) -> None:
        self.alive[name] = False
        self.nodes[name].state = FOLLOWER
        self.nodes[name].nodelog("killed")

    def recover(self, name: str) -> None:
        self.alive[name] = True
        self.nodes[name].state = FOLLOWER
        self.nodes[name].nodelog("recovered")
        self._arm_follower_timeout(name)

    def set_slow(self, name: str, is_slow: bool) -> None:
        self.slow[name] = is_slow

    def partition(self, groups) -> None:
        """Link-level partition (OUR extension, mirroring
        ``RaftEngine.partition`` so one schedule drives both sides of a
        differential run): nodes in different groups exchange nothing —
        no AppendEntries, no votes, no replies. Groups are lists of node
        names or replica indices; unlisted nodes are isolated. The client
        is unaffected (the reference's client is in-process with every
        node, main.go:87-95 — there is no client link to cut)."""
        g: Dict[str, int] = {}
        for gi, group in enumerate(groups):
            for m in group:
                name = m if isinstance(m, str) else f"Server{m}"
                g[name] = gi
        iso = len(groups)
        for name in self.nodes:
            if name not in g:
                g[name] = iso
                iso += 1
        self._group_of = g
        for name in self.nodes:
            self.nodes[name].nodelog("partitioned")

    def heal_partition(self) -> None:
        self._group_of = None
        for name in self.nodes:
            self.nodes[name].nodelog("partition healed")

    def _reachable(self, a: str, b: str) -> bool:
        if a == b or self._group_of is None:
            return True
        return self._group_of[a] == self._group_of[b]

    # -- scheduling ---------------------------------------------------------
    def _push(self, t: float, kind: str, node: str) -> None:
        heapq.heappush(self._q, (t, self._seq, kind, node))
        self._seq += 1

    def _arm_follower_timeout(self, name: str, base: Optional[float] = None) -> None:
        # rand.Intn(20) + 10 seconds, inclusive ints (main.go:114). ``base``
        # is the virtual instant the reference's timer.Reset would have
        # happened (a message receipt); the timeout runs from there.
        self._timer_gen[name] += 1
        base = self.now if base is None else base
        self._armed_at[name] = base
        dt = float(self.rng.randint(10, 29))
        self._push(max(self.now, base + dt), f"etimer:{self._timer_gen[name]}", name)

    def _arm_candidate_timeout(self, name: str) -> None:
        # rand.Intn(4) + 10 (main.go:194)
        self._timer_gen[name] += 1
        dt = float(self.rng.randint(10, 13))
        self._push(self.now + dt, f"ctimer:{self._timer_gen[name]}", name)

    def inject(self, payload: bytes) -> None:
        """Queue one client entry; delivered to every self-identified leader
        at the next client tick (main.go:87-95 pushes to all Leader-state
        nodes)."""
        self.client_values.append(payload)

    def _deliver_client(self) -> None:
        """Push queued client values into every current leader's bounded
        LogReq channel (capacity ``channel_depth``, main.go:68-72).

        A full channel blocks the client goroutine mid-send (main.go:92):
        delivery stops entirely — later values and later targets wait —
        until a leader tick drains the full channel, then resumes with the
        SAME value and its remaining targets (targets already sent to do
        not receive the value twice). A blocked-on target that has died is
        dropped (our fault extension; reference nodes never die)."""
        while True:
            if self._client_blocked is not None:
                v, targets = self._client_blocked
            else:
                if not self.client_values:
                    return
                targets = [
                    n.id for n in self.nodes.values()
                    if n.state == LEADER and self.alive[n.id]
                ]
                if not targets:
                    return  # no leader: values wait for a later tick
                v = self.client_values.pop(0)
            while targets:
                name = targets[0]
                if not self.alive[name]:
                    targets.pop(0)
                    continue
                node = self.nodes[name]
                if len(node.logreq) >= self.channel_depth:
                    self._client_blocked = (v, targets)
                    return  # blocked: the drain in _leader_tick resumes us
                node.logreq.append(v)
                targets.pop(0)
            self._client_blocked = None

    # -- the role bodies that need the cluster (send/recv) ------------------
    def _campaign(self, cand: GoldenNode) -> None:
        """One election round: vote for self then poll every peer
        synchronously (main.go:253-284)."""
        count = 1
        cand.voted = True                            # main.go:255-256
        for name, peer in self.nodes.items():
            if name == cand.id or cand.state != CANDIDATE:
                continue
            if not self.alive[name]:
                continue                             # dead peer: no response
            if not self._reachable(cand.id, name):
                continue                             # partitioned away
            prev_state = peer.state
            res = peer.handle_request_vote(
                VoteRequest(cand.term, cand.id)      # fields as sent, main.go:264
            )
            if res.vote:
                # a granted vote resets the voter's election timer
                # (main.go:162)
                peer.last_heard = self.now
                count += 1
            if prev_state != FOLLOWER and peer.state == FOLLOWER:
                # stepping down re-enters FollowerRun, which arms a fresh
                # election timer (main.go:113-114)
                self._arm_follower_timeout(name)
        if cand.state != CANDIDATE:
            return
        if count > len(self.nodes) / 2:              # main.go:273
            cand.state = LEADER
            cand.nodelog("state changed to leader")
            for name in self.nodes:                  # main.go:275-284
                if name != cand.id:
                    cand.match_index[name] = 0
                    cand.next_index[name] = 1
            self._push(self.now, "ltick", cand.id)

    def _leader_tick(self, leader: GoldenNode) -> None:
        """One pass of the leader default branch (main.go:332-395)."""
        # Drain the LogReq channel first: the select loop consumes pending
        # client entries between ticks (main.go:327-331), so everything
        # buffered since the last tick is appended before this replication
        # pass. Freed capacity unblocks a client stuck mid-send.
        if leader.logreq:
            for v in leader.logreq:
                leader.client_append(v)
            leader.logreq.clear()
            self._deliver_client()
        for name, peer in self.nodes.items():
            if name == leader.id:
                continue
            if not self.alive[name]:
                continue                  # dead peer: not delivered
            if not self._reachable(leader.id, name):
                continue                  # partitioned away: not delivered
            if self.slow[name]:
                # Engine slow-mask semantics (engine.set_slow): the replica
                # *receives* traffic — election timer resets, terms flow
                # both ways — but appends nothing, so the leader's view of
                # its match stays stale (BASELINE config 4). Without the
                # timer reset the golden slow node would campaign during
                # long slow windows while the engine's stays a quiet
                # follower, and the two sides of a differential run would
                # diverge.
                if peer.term > leader.term:
                    # the reply still carries the higher term (the engine's
                    # collective max_term does the same, core/step.py) and
                    # deposes the leader, main.go:309-321 semantics
                    leader.step_down(peer.term)
                    self._arm_follower_timeout(leader.id)
                    return
                peer.last_heard = self.now
                if peer.state != FOLLOWER:
                    # candidate/stale-leader steps down on hearing a
                    # current leader (main.go:204-217): full step_down so
                    # term adoption + vote reset match the engine's device
                    # step for heard-but-slow replicas
                    peer.step_down(leader.term)
                    self._arm_follower_timeout(name)
                elif peer.term < leader.term:
                    # a delivered AppendEntries would adopt the leader's
                    # term (main.go:155); keep the host mirror in step
                    peer.term = leader.term
                continue
            ni = leader.next_index[name]
            if ni == 1 and leader.last_applied > 0:  # never synced: full log
                req = AppendEntriesRequest(          # main.go:343-351
                    leader.term, leader.id, list(leader.log),
                    leader.commit_index, 0, 0,
                )
            elif 1 < ni <= leader.last_applied:      # behind: suffix
                mi = leader.match_index[name]
                req = AppendEntriesRequest(          # main.go:352-361
                    leader.term, leader.id, leader.get_logs_from(ni),
                    leader.commit_index, mi,
                    leader.get_log(mi).term if mi > 0 else 0,
                )
            else:                                    # up to date: heartbeat
                req = AppendEntriesRequest(          # main.go:362-372
                    leader.term, leader.id, [], leader.commit_index,
                    leader.last_applied,
                    leader.get_log(leader.last_applied).term
                    if leader.last_applied > 0
                    else 0,
                )
            prev_state = peer.state
            res = peer.handle_append_entries(req)    # send + blocking reply
            # every AppendEntries receipt resets the receiver's election
            # timer, success or not (timer.Reset at the top of the handler,
            # main.go:124-127)
            peer.last_heard = self.now
            if prev_state != FOLLOWER and peer.state == FOLLOWER:
                # candidate stepped down on >=-term AppendEntries
                # (main.go:204-217) and re-enters FollowerRun, which arms a
                # fresh election timer (main.go:113-114)
                self._arm_follower_timeout(name)
            if res.success:                          # main.go:375-378
                leader.match_index[name] = res.match_index
                leader.next_index[name] = res.match_index + 1
            elif res.term > leader.term:
                leader.step_down(res.term)
                self._arm_follower_timeout(leader.id)
                return
        # exact-bucket commit over follower match values (main.go:381-391)
        counter: Dict[int, int] = {}
        for mi in leader.match_index.values():
            counter[mi] = counter.get(mi, 0) + 1
        for i, v in counter.items():
            if v > len(self.nodes) // 2 and i > leader.commit_index:
                leader.commit_index = i
                leader.nodelog(f"commit index changed to {i}")
        self._push(self.now + 2.0, "ltick", leader.id)   # main.go:394

    # -- event loop ---------------------------------------------------------
    def force_campaign(self, name: str) -> None:
        """Disruptive candidacy regardless of a live leader — the
        election-storm injection (BASELINE config 5), mirroring
        ``RaftEngine.force_campaign`` so the same storm schedule can drive
        both sides of a differential run. The reference has no such hook;
        the campaign itself then follows reference semantics exactly
        (candidate term bump + serial poll, main.go:253-284, including the
        sticky-``Voted`` quirk that can wedge golden elections)."""
        node = self.nodes[name]
        if not self.alive[name]:
            return
        if node.state == LEADER:
            return  # a leader bumping itself is a no-op disruption
        node.state = CANDIDATE
        node.term += 1
        node.nodelog("state changed to candidate (injected)")
        self._campaign(node)
        if node.state == CANDIDATE:
            self._arm_candidate_timeout(name)

    def step_event(self) -> bool:
        """Dispatch one scheduled event; False when the queue is empty."""
        if not self._q:
            return False
        t, _, kind, name = heapq.heappop(self._q)
        self.now = max(self.now, t)
        node = self.nodes[name]
        if not self.alive[name] and kind != "client":
            return True                   # a dead node's timers never fire
        if kind.startswith("etimer:"):
            # Election timeout is armed at follower entry and *reset on
            # every AppendEntries receipt / granted vote* (main.go:124-127,
            # 162). The virtual-clock equivalence: if a resetting receipt
            # happened after this timer was armed, the reference's timer
            # would now be running from that receipt with a fresh draw —
            # re-arm from ``last_heard`` and skip.
            gen = int(kind.split(":")[1])
            if node.state != FOLLOWER or gen != self._timer_gen[name]:
                return True
            if node.last_heard > self._armed_at[name]:
                self._arm_follower_timeout(name, base=node.last_heard)
                return True
            node.state = CANDIDATE                   # main.go:171-177
            node.term += 1
            node.nodelog("state changed to candidate")
            self._campaign(node)
            if node.state == CANDIDATE:
                self._arm_candidate_timeout(name)
        elif kind.startswith("ctimer:"):
            gen = int(kind.split(":")[1])
            if node.state != CANDIDATE or gen != self._timer_gen[name]:
                return True
            node.term += 1                           # main.go:248-251
            self._campaign(node)
            if node.state == CANDIDATE:
                self._arm_candidate_timeout(name)
        elif kind == "ltick":
            if node.state == LEADER:
                self._leader_tick(node)
            else:
                self._arm_follower_timeout(name)
        elif kind == "client":
            # main.go:87-95: push queued values into every Leader-state
            # node's bounded LogReq channel (blocking semantics in
            # _deliver_client); the leader appends them at its next tick.
            self._deliver_client()
            self._push(self.now + 10.0, "client", name)
        return True

    def start_client(self) -> None:
        """Arm the reference's 10 s client loop (main.go:87-95)."""
        self._push(self.now + 10.0, "client", next(iter(self.nodes)))

    def run_until(self, t: float, max_events: int = 100_000) -> None:
        for _ in range(max_events):
            if not self._q or self._q[0][0] > t:
                break
            self.step_event()
        self.now = max(self.now, t)

    def leader(self) -> Optional[GoldenNode]:
        for n in self.nodes.values():
            if n.state == LEADER:
                return n
        return None

    def run_until_leader(self, limit: float = 600.0) -> GoldenNode:
        while self.leader() is None and self.now < limit:
            if not self.step_event():
                break
        lead = self.leader()
        assert lead is not None, "no leader elected within the time limit"
        return lead
