"""The K-tick fused steady state (port of ``raft_tpu/raft/steady.py``).

The engine's leader tick is host-bound: a few µs of kernel time inside
milliseconds of Python per tick. In the steady state (a stable leader, no
configuration change, every follower caught up) the next K ticks are
known in advance, so this module runs K consecutive leader ticks as one
launch (``transport.replicate_fused``: ``core.step.fused_steady_scan``,
one replay of a captured CUDA graph on the card) and books them in one
host pass, escaping to the tick path when a tick's escape predicate
fires or the staging buffer drains.

Three pieces:

- :class:`StagingRing`: the device staging buffer of untiled payload
  words, i32[S, B, W]. Each client submit that completes a batch copies
  it into the next slot (the copy is paid on the submit path), so a
  fused launch reads its windows by slot index. The ring mirrors a queue
  suffix; any queue mutation other than append / aligned pop-front
  invalidates it (``reset``), and the driver re-stages lazily.
- :class:`FusedDriver`: eligibility, window planning, pipelined dispatch
  and exact booking. Eligibility is a host proof that nothing
  interesting can happen inside the window (a routed leader holding the
  highest term, verified steady, fully committed, a quorum of reachable
  non-slow voters, no configuration change in flight, no fault or
  election event due inside the window); the device escape mask is the
  safety net for what the proof missed. Launch i+1 is dispatched before
  launch i is booked; the previous launch's ``halted`` flag threads into
  the next on the device, so an unbooked escape turns every later launch
  into a provable no-op chain.
- exact booking (:class:`_WindowBook`): the host replays each fused
  tick's control-plane bookkeeping in order (virtual clock, timer
  re-arms with the same rng draws, the heap's tiebreak counter, the
  CheckQuorum contact, admission delay observations, nodelog lines),
  while the per-entry work (seq -> index mapping, commit stamps, the
  archive) collapses into one pass per launch. The result equals the
  tick-at-a-time engine's byte for byte: committed log, stamps, rng,
  heap and nodelog lines.

The booking feeds the host observability plane as the JAX booking does
(spans, metrics, the safety auditor, the SLO tracker, the flight
recorder), all of it host code after the launch: nothing of it runs
inside the captured graph. With the device plane attached
(``RaftEngine.attach_device_obs``) each launch records its ticks into
the engine's event ring inside the graph (``replicate_fused(ring=)``),
and the booking flushes the ring once per launch boundary.

Over the mesh (``transport.MeshTransport``) every rank's mirrored engine
plans and books the same windows from its identical host state, and
``replicate_fused`` runs the K-tick loop eagerly over the comm, never as
a captured graph (its collectives are gloo host calls). The JAX
``FusedDriver`` refuses fusion when ``jax.process_count() > 1``; the
port's mesh is R (or R x P) processes by construction, the counterpart
of the JAX package's one-process mesh, which fuses, so the port fuses
there too. The staging ring keeps full-width words; on the 2-D mesh the
transport hands the scan each rank's slice of them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from raft_tpu_torch.core.graphs import POOL
from raft_tpu_torch.obs import profiling
from raft_tpu_torch.obs.compile import labeled


def _batch_words(chunk, count: int, batch: int,
                 entry_bytes: int) -> torch.Tensor:
    """The first ``count`` (seq, payload) pairs of ``chunk`` as untiled
    words i32[batch, entry_bytes // 4], zero-padded past ``count`` (a
    writable host tensor: the staging copy's source)."""
    words = np.zeros((batch, entry_bytes), np.uint8)
    if count:
        words[:count] = np.frombuffer(
            b"".join(p for _, p in chunk[:count]), np.uint8
        ).reshape(count, entry_bytes)
    return torch.from_numpy(words.view(np.int32))


def _stage_write(buf: torch.Tensor, words: torch.Tensor,
                 slot: int) -> torch.Tensor:
    buf[slot].copy_(words)
    return buf


#: the shared staging-slot writer: one copy per staged batch, labeled as
#: the JAX package's process-wide slot writer (the compile plane's
#: "single.stage" hot path)
_STAGE = labeled("single.stage", _stage_write)


class StagingRing:
    """Device staging ring of untiled payload words, i32[S, B, W].

    Mirrors the engine queue's aligned prefix: with ``consumed`` entries
    popped since the last reset, absolute batch ``k`` (entries
    ``[kB, (k+1)B)`` counted from the reset point) lives in slot
    ``k % S`` once staged; the queue's head sits at absolute entry
    ``consumed``. Full batches only: the window's trailing partial batch
    drains through the ordinary tick path, which is also where the fused
    window's "staging drained" escape hands control back.

    The buffer is allocated once, so its address stays what the captured
    graphs read. Each stage is a copy into one slot on the current CUDA
    stream; stream order keeps it behind every launch already queued
    that reads the slot.
    """

    def __init__(self, batch: int, words: int, slots: int, device=None,
                 claim=None):
        self.claim = claim
        #   shape -> a pooled buffer or None (``core.graphs.POOL``'s
        #   staging_for: a restored engine takes its dead predecessor's
        #   buffer back, so the graphs that read it stay valid)
        self.B = batch
        self.W = words
        self.S = slots
        self.device = device
        self.buf: Optional[torch.Tensor] = None   # i32[S, B, W], lazily
        self.consumed = 0        # entries popped since reset
        self.staged = 0          # absolute batches staged since reset
        self.stage_events = 0    # lifetime full-batch copies (never reset)
        self.stage_tail_events = 0
        #   window-tail stages (stage_tail): the fused window's trailing
        #   partial batch, at most one per window, counted apart

    def _alloc(self) -> None:
        if self.buf is None:
            shape = (self.S, self.B, self.W)
            if self.claim is not None:
                self.buf = self.claim(shape)
            if self.buf is None:
                self.buf = torch.zeros(shape, dtype=torch.int32,
                                       device=self.device)

    def reset(self) -> None:
        """The queue mutated in a way the mirror cannot track (prepend,
        reorder, wholesale swap): drop the staged region. The buffer is
        kept; re-staging overwrites slots."""
        self.consumed = 0
        self.staged = 0

    def consume(self, n_entries: int, queue_len_after: int) -> None:
        """``n_entries`` popped from the queue front. An empty queue
        resets the frame for free (nothing staged is live), which also
        heals any partial-batch misalignment a final short tick left."""
        self.consumed += n_entries
        if queue_len_after == 0:
            self.reset()

    def available_batches(self) -> int:
        """Staged, unconsumed, alignment-verified batches from the queue
        head (0 when the consume cursor sits mid-batch: the driver then
        realigns via reset + top_up)."""
        if self.consumed % self.B:
            return 0
        return max(self.staged - self.consumed // self.B, 0)

    def free_slots(self) -> int:
        return self.S - (self.staged - self.consumed // self.B)

    def stage_tail(self, queue: List, entry_bytes: int,
                   offset: int, count: int) -> None:
        """Stage the queue's trailing partial batch (zero-padded) into the
        next free slot for the window about to launch, without advancing
        the full-batch bookkeeping: the window consumes through it
        (emptying the queue resets the frame) or escapes (the next window
        rebuilds). ``offset`` is the queue position of the tail's first
        entry."""
        self._alloc()
        _STAGE(self.buf, _batch_words(queue[offset:offset + count], count,
                                      self.B, entry_bytes),
               self.staged % self.S)
        self.stage_tail_events += 1

    def top_up(self, queue: List, entry_bytes: int,
               max_new: Optional[int] = None) -> int:
        """Stage as many unstaged full batches as fit (at most
        ``max_new``: the submit hook stages only the batch the arriving
        entry completed). Returns the number staged."""
        if self.consumed % self.B:
            return 0
        if self.staged * self.B < self.consumed:
            # the tick path drained past the staged region (the ring
            # filled while fusion stayed ineligible and ordinary ticks
            # kept consuming): realign to the queue head and re-stage
            self.reset()
        self._alloc()
        B = self.B
        total = self.consumed + len(queue)
        staged_new = 0
        while (self.staged + 1) * B <= total and self.free_slots() > 0:
            if max_new is not None and staged_new >= max_new:
                break
            lo = self.staged * B - self.consumed     # queue offset
            _STAGE(self.buf, _batch_words(queue[lo:lo + B], B, B,
                                          entry_bytes),
                   self.staged % self.S)
            self.staged += 1
            staged_new += 1
            self.stage_events += 1
        return staged_new


class FusedDriver:
    """Plans, dispatches and books fused K-tick windows for one
    :class:`~raft_tpu_torch.raft.engine.RaftEngine` (see module doc)."""

    #: minimum fused window: below 2 ticks the ordinary tick path is
    #: strictly cheaper (no window planning, no staging checks)
    MIN_TICKS = 2

    def __init__(self, engine):
        self.e = engine
        cfg = engine.cfg
        slots = max(4, min(2 * engine.fuse_k, 256))
        self.staging = StagingRing(
            cfg.batch_size, cfg.shard_words, slots, device=engine._dev,
            claim=lambda shape: POOL.staging_for(engine.state.log_payload,
                                                 shape))

    # ------------------------------------------------------ engine hooks
    def on_submit(self) -> None:
        """A submit appended to the queue: stage the batch it completed
        (if any); a client-side cost, off the drain."""
        self.staging.top_up(self.e._queue, self.e.cfg.entry_bytes,
                            max_new=1)

    def on_consumed(self, n_entries: int) -> None:
        self.staging.consume(n_entries, len(self.e._queue))

    def on_queue_replaced(self) -> None:
        self.staging.reset()

    # ------------------------------------------------------- eligibility
    def _heap_bound(self, r: int, eff: np.ndarray) -> float:
        """Earliest heap event the fused window must not run past.
        Ignorable (no-op pops or timers the window re-arms anyway):

        - stale-generation election/candidate timers;
        - election timers of rows the window's first tick re-arms (heard
          live member followers) and of rows whose pop is a no-op (dead,
          non-member);
        - candidate timers while no candidate exists;
        - leader-tick events of rows not in the leader role.

        Everything else (fault-plan events, a live unreachable member's
        election timer, unknown kinds) bounds the window.
        """
        e = self.e
        bound = float("inf")
        roles = e.roles
        for (te, _seq, kind, row) in e._q:
            tag, _, gen = kind.partition(":")
            if tag in ("e", "c"):
                if int(gen) != e._timer_gen[row]:
                    continue                     # stale: no-op pop
                if tag == "e" and (
                    not e.alive[row] or not e.member[row]
                    or (eff[row] and roles[row] == "follower"
                        and row != r)
                ):
                    continue
                if tag == "c" and roles[row] != "candidate":
                    continue
            elif tag == "l" and roles[row] != "leader":
                continue
            bound = min(bound, te)
        return bound

    # ------------------------------------------------------------- fire
    def fire(self, r: int, horizon: float) -> bool:
        """Handle the just-popped leader tick for ``r`` as a fused window
        when the eligibility proof holds; False hands the tick back to
        the ordinary ``_fire_leader_tick`` untouched."""
        e = self.e
        cfg = e.cfg
        if cfg.ec_enabled or cfg.mirror_check_every:
            return False
        if getattr(e.t, "replicate_fused", None) is None:
            return False
        ready = getattr(e.t, "fusion_ready", None)
        if ready is not None and not ready():
            return False
        if (e.leader_id != r or e.roles[r] != "leader"
                or not e.alive[r] or e.slow[r]):
            return False
        term = int(e.lead_terms[r])
        if int(e.terms[r]) > term or int(e.terms.max()) > term:
            return False
        if any(p != r and e.roles[p] != "follower"
               for p in range(cfg.rows)):
            return False
        if (e._staged_config or e._config_seqs
                or e._pending_config is not None or e.learner.any()):
            return False
        if cfg.steady_dispatch == "off" or not e._steady:
            return False
        if e.admission is not None and e.admission.shedding:
            # a shedding window's delay observations gate client-facing
            # refusals tick by tick: keep those on the tick path
            return False
        lasts = e._pre_lasts()
        if int(lasts[r]) != e.commit_watermark:
            return False
        eff = e._reach(r)
        live_members = e.alive & e.member
        if not eff[live_members].all():
            return False
        quorum = int(e.member.sum()) // 2 + 1
        if int((eff & e.member & ~e.slow).sum()) < quorum:
            return False
        # the window: the staged ingest plus trailing heartbeat ticks (the
        # tick path fires those at the same instants whatever the
        # backlog), bounded by the horizon and the heap
        B = cfg.batch_size
        q = len(e._queue)
        t0 = e.clock.now
        hb = cfg.heartbeat_period
        bound = self._heap_bound(r, eff)
        if bound <= t0:
            return False
        # tick times follow the same incremental ``t + hb`` chain as the
        # tick path's heap pushes: a closed-form ``t0 + j*hb`` differs in
        # the last ulp, which would leak into stamps and heap times
        times = [t0]
        tj = t0
        while len(times) < 100_000:
            tj = tj + hb
            if tj > horizon or tj >= bound:
                break
            times.append(tj)
        n = len(times)
        if n < self.MIN_TICKS:
            return False
        # staging coverage for the ingest prefix (top up; rebuild when
        # the mirror went stale: a misaligned consume, a failover)
        st = self.staging
        full_need = min(q // B, n)
        if full_need:
            st.top_up(e._queue, cfg.entry_bytes)
            if st.available_batches() < full_need:
                st.reset()
                st.top_up(e._queue, cfg.entry_bytes)
        full_b = min(full_need, st.available_batches()) if full_need else 0
        counts = np.zeros(n, np.int32)
        counts[:full_b] = B
        tail = q - full_b * B
        staged_tail = 0
        if (0 < tail < B and full_b == q // B and full_b < n
                and st.free_slots() > 0):
            # the trailing partial batch rides the window's next tick (the
            # free-slot check keeps it off a staged, unconsumed batch)
            st.stage_tail(e._queue, cfg.entry_bytes, full_b * B, tail)
            counts[full_b] = tail
            staged_tail = tail
        if full_b * B + staged_tail < q:
            # the staging ring does not cover the whole backlog: the
            # window ends at its last covered ingest tick (a fused
            # heartbeat where the tick path would ingest is a divergence)
            n = full_b + (1 if staged_tail else 0)
            if n < self.MIN_TICKS:
                return False
            counts = counts[:n]
            times = times[:n]
        st._alloc()   # a pure-heartbeat window still passes the buffer
        self._run_window(r, term, eff, times, counts)
        return True

    # ----------------------------------------------------------- window
    def _run_window(self, r: int, term: int, eff: np.ndarray,
                    times: List[float], counts: np.ndarray) -> None:
        """Dispatch the planned window as a chain of power-of-two-sized
        launches (at most K ticks each; ``n_run`` masks a residual tail
        inside the last launch, so a window needs at most about log2(K)
        launch sizes), pipelined: launch i+1 is dispatched, carrying
        launch i's ``halted`` flag on the device, before launch i is
        booked."""
        e = self.e
        cfg = e.cfg
        hp = e.hostprof
        st = self.staging
        # heard rows' terms reach the leader's before anything books (the
        # tick path's pre-commit durability fence)
        e.terms[eff] = np.maximum(e.terms[eff], term)
        e._persist_votes()
        floor, fpt = e._floor_attest(r)
        member = None if cfg.max_replicas is None else e.member.copy()
        alive = eff.copy()
        slow = e.slow.copy()
        lasts0 = np.asarray(e._pre_lasts()).copy()
        if hp is not None:
            hp.mark("host_pre")
        n = len(counts)
        win = _WindowBook(self, r, term, eff, times, int(lasts0[r]))
        win.set_window(n)
        halted = False
        start_batch = st.consumed // st.B
        prev = None
        pos = 0
        k = e.fuse_k
        while pos < n:
            left = n - pos
            size = 1 << (min(left, k).bit_length() - 1)
            if size < left and size * 2 <= k:
                size *= 2                 # round up: mask the tail with
                #                           n_run instead of a 2nd launch
            n_run = min(left, size)
            cnt = np.zeros(size, np.int32)
            cnt[:n_run] = counts[pos:pos + n_run]
            with profiling.launch_annotation(
                "fused_window", e.fused_launches
            ):
                out = e.t.replicate_fused(
                    e.state, st.buf, start_batch % st.S, cnt, n_run,
                    halted, r, term, alive, slow, member=member,
                    repair_floor=floor, floor_prev_term=fpt,
                    ring=e._dev_ring,
                )
            e.state, infos, escaped, ran, halted = out[:5]
            e.fused_launches += 1
            if hp is not None:
                hp.mark("dispatch")
            if prev is not None:
                win.book_launch(*prev)
            prev = (infos, escaped, ran)
            start_batch += n_run
            pos += n_run
        win.book_launch(*prev)
        win.finish(lasts0)

    # --------------------------------------------------------- plumbing
    @property
    def slots(self) -> int:
        return self.staging.S


def _launch_outputs(infos, escaped, ran):
    """One launch's outputs on the host with one fetch: (commit, frontier,
    max_term, escaped, ran) int64[K] each and match int64[K, R]."""
    K = escaped.shape[0]
    flat = torch.cat([
        infos.commit_index.reshape(-1), infos.frontier_len.reshape(-1),
        infos.max_term.reshape(-1), escaped.reshape(-1).to(torch.int32),
        ran.reshape(-1).to(torch.int32), infos.match.reshape(-1),
    ]).cpu().numpy().astype(np.int64)
    head = flat[:5 * K].reshape(5, K)
    return (*head, flat[5 * K:].reshape(K, -1))


class _WindowBook:
    """Exact host booking of one fused window: per-tick control-plane
    replay (clock, rng draws, heap counter, leases, admission
    observations, nodelog lines) with the per-entry work done once per
    launch (see the module doc). One instance spans the window's
    pipelined launches."""

    def __init__(self, driver: FusedDriver, r: int, term: int,
                 eff: np.ndarray, times: List[float], last0: int):
        self.d = driver
        self.r = r
        self.term = term
        self.eff = eff
        self.times = times
        self.last = last0           # leader last_index booked so far
        self.g = 0                  # global tick index in the window
        self.qpos = 0               # queue entries booked (consumed)
        self.halted = False         # no later launch may book (it ran
        #                             as a device no-op chain)
        self.stepped_down = False
        self.final_match = None
        self.confirmed = False
        self._n_ticks = 0

    # ---------------------------------------------------------- booking
    def book_launch(self, infos, escaped, ran) -> None:
        e = self.d.e
        hp = e.hostprof
        if self.halted:
            # the halted flag was threaded into this launch on the device:
            # it ran as a no-op chain; there is nothing to book
            return
        if hp is not None:
            hp.sync(infos.commit_index, escaped, ran)
        ci, fl, mt, esc, rn, match = _launch_outputs(infos, escaped, ran)
        e._flush_device_obs()
        n_run = int(rn.sum())
        for j in range(n_run):
            last_exec = (j == n_run - 1) and bool(esc[j])
            self._book_tick(
                int(ci[j]), int(fl[j]), int(mt[j]), match[j],
                escape=last_exec,
            )
            if self.halted:
                return
        if n_run:
            self.final_match = match[n_run - 1]

    def _book_tick(self, commit: int, frontier: int, max_term: int,
                   match: np.ndarray, escape: bool) -> None:
        """Replay one fused tick's host bookkeeping, in the order
        ``_fire_leader_tick`` performs it."""
        d = self.d
        e = d.e
        cfg = e.cfg
        r = self.r
        term = self.term
        hb = cfg.heartbeat_period
        t_j = self.times[self.g]
        e.clock.now = max(e.clock.now, t_j)
        e._tick_count += 1
        e.fused_ticks += 1
        e._metric_inc("raft_heartbeat_ticks_total")
        if cfg.check_quorum:
            # the voter quorum is reachable by the eligibility proof: the
            # contact renews exactly as the tick path's branch would
            e._quorum_contact_at[r] = t_j
        if e.admission is not None:
            head_delay = 0.0
            if self.qpos < len(e._queue):
                head_seq = e._queue[self.qpos][0]
                head_delay = t_j - e.submit_time.get(head_seq, t_j)
            transition = e.admission.observe_delay(head_delay)
            if transition == "shed_start":
                e._nodelog_at(
                    r, f"admission shedding ON (head delay "
                    f"{head_delay:.1f}s >= target "
                    f"{e.admission.target_delay_s:g}s for a full "
                    f"interval)", e.commit_watermark, self.last,
                )
            elif transition == "shed_stop":
                e._nodelog_at(
                    r, "admission shedding OFF (delay back under "
                    "target)", e.commit_watermark, self.last,
                )
        if self.g > 0 and e.recorder is not None:
            # the tick path fires repair_floor_raise inside tick j's
            # pre-dispatch _floor_attest, from the previous tick's last:
            # replay it there with that value (tick 0's event fired in
            # _run_window's own _floor_attest)
            self._replay_floor_event(self.last)
        if escape and max_term > term:
            # the step that surfaced a higher term: the tick path books
            # nothing from it (no ingest mapping, no commit, no re-arm, no
            # next-tick push, no steady update) and steps the leader down
            self.g += 1
            e._step_down_leader(r, max_term)
            self.stepped_down = True
            self.halted = True
            return
        chunk = e._queue[self.qpos:self.qpos + frontier]
        new_last = self.last + frontier
        if frontier and commit >= new_last:
            # the whole batch committed inside its own tick (the steady
            # common case): stamps, archive and watermark in one pass
            self._book_committed_batch(chunk, t_j, new_last, commit)
        elif frontier:
            # escape tick with a partial or uncommitted ingest: book what
            # the tick path would
            for i, (seq, p) in enumerate(chunk):
                idx = self.last + 1 + i
                e._seq_at_index[idx] = seq
                e._uncommitted[idx] = (p, term)
                if e.spans is not None:
                    e.spans.note_ingest(seq, idx, t_j, e._tick_count)
            e._advance_commit(r, commit)
        self.qpos += frontier
        self.last = new_last
        if escape:
            # the tick path's _update_steady, from this tick's verified
            # match against the post-ingest leader tail
            others = self.eff & ~e.slow
            others[self.r] = False
            e._steady = bool((match[others] >= new_last).all())
        if not self.confirmed and max_term <= term:
            e._confirm_reads(r, term, self.eff, max_term)
            #   _confirm_reads also renews the leader lease; later fused
            #   ticks renew below, so the lease clock advances tick by
            #   tick as the unfused path's per-tick confirmation drives it
            self.confirmed = True
        elif max_term <= term:
            e._lease_renew(r, term, self.eff, max_term)
        e._reset_heard_timers(r)
        self.g += 1
        if escape or self.g == self._n_ticks:
            # the last executed tick pushes the real next leader tick
            e._push(t_j + hb, "l:x", r)
        else:
            # an intermediate tick's push is popped by the next fused
            # tick: replay only the tiebreak counter the push and pop
            # would have advanced
            e._seq_events += 1
        if escape:
            self.halted = True   # window over: later launches ran as
            #                      device no-op chains

    def set_window(self, n_ticks: int) -> None:
        self._n_ticks = n_ticks

    def _book_committed_batch(self, chunk, t_j: float, new_last: int,
                              commit: int) -> None:
        e = self.d.e
        r = self.r
        term = self.term
        n = len(chunk)
        s0, sl = chunk[0][0], chunk[-1][0]
        if (e.spans is None and e.metrics is None and e.slo is None
                and sl - s0 + 1 == n):
            e.commit_time.update(dict.fromkeys(range(s0, sl + 1), t_j))
        else:
            slo_lat = [] if e.slo is not None else None
            for i, (seq, p) in enumerate(chunk):
                e.commit_time[seq] = t_j
                if e.spans is not None:
                    e.spans.note_ingest(
                        seq, new_last - n + 1 + i, t_j, e._tick_count
                    )
                    e.spans.note_commit(seq, t_j, e._tick_count)
                if e.metrics is not None:
                    e._metric_inc("raft_commits_total")
                    e.metrics.histogram(
                        "raft_commit_latency_seconds",
                        "submit -> durable, virtual seconds", ("group",),
                    ).observe(
                        t_j - e.submit_time.get(seq, t_j), group="0",
                    )
                if slo_lat is not None:
                    slo_lat.append(t_j - e.submit_time.get(seq, t_j))
            if slo_lat:
                e.slo.observe_batch("commit", slo_lat, t_j)
        e.committed_total += n
        e.store.put_span(new_last - n + 1, chunk, term, pick=1)
        if e.auditor is not None:
            # the span-granularity audit feed, O(1) per launch like
            # put_span: entries resolve lazily inside the auditor
            e.auditor.note_entry_span(
                new_last - n + 1, chunk, term, t_j, pick=1
            )
            e.auditor.note_commit(commit, t_j)
        if commit > e._row_commit[r]:
            e._row_commit[r] = commit
        e._lease_ok_term[r] = term
        #   the fused batch commit is a current-term watermark advance
        #   riding r's own round: _advance_commit's lease gate
        e.commit_watermark = commit
        e._nodelog_at(r, f"commit index changed to {commit}",
                      commit, new_last, kind="commit")
        e._evict_commit_stamps()
        e._drain_apply()

    def _replay_floor_event(self, last: int) -> None:
        """The tick path's ``_floor_attest`` records a recorder-only event
        when the lap horizon raises the repair floor past its high-water
        mark; replay it at the tick where it would fire."""
        e = self.d.e
        r = self.r
        cap = e.state.capacity
        lap = last - cap + 1
        floor = max(int(e._ring_floor[r]), lap)
        if floor > 1 and floor > e._floor_event_hwm.get(r, 0):
            e._floor_event_hwm[r] = floor
            e._record_event(
                r, "repair_floor_raise", floor=floor, lap_horizon=lap,
                ring_floor=int(e._ring_floor[r]),
            )

    # ------------------------------------------------------------ close
    def finish(self, lasts0: np.ndarray) -> None:
        """Window epilogue: consume the booked queue prefix, retire the
        staging mirror, refresh the host snapshots, and re-derive the
        steady flag from the final tick's verified match."""
        d = self.d
        e = d.e
        if self.qpos:
            e._queue = e._queue[self.qpos:]
            d.staging.consume(self.qpos, len(e._queue))
        e._note_truncations(lasts0)
        if self.stepped_down:
            return
        if not self.halted and self.final_match is not None:
            others = self.eff & ~e.slow
            others[self.r] = False
            e._steady = bool(
                (self.final_match[others] >= self.last).all()
            )
