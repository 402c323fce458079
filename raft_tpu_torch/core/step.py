"""The protocol steps on torch tensors (port of ``raft_tpu/core/step.py``).

- ``replicate_step`` — one leader tick: ingest + repair window + frontier
  window + quorum commit for every replica row at once. The general path
  (``core/step.py:264-530``) runs as torch ops and writes both windows
  through kernel K1 (``core.ring_cuda.write_window_both``). With
  ``term_floor`` given and ``repair=False`` (or ``ec``) the call goes to
  the whole-step kernel K2 instead, as the JAX package dispatches to its
  fused Pallas step (``:246-263``).
- ``vote_step`` — one election round (``:928``).
- ``scan_replicate`` — T ticks (``:532``); the steady form goes to T
  back-to-back K2 launches (``:599-613``).
- ``fused_steady_scan`` — K steady ticks with exact early exit
  (``:633``), each through the general path (K1).

These four reach other replica rows only through ``comm``, where the JAX
package does (``core.comm``): under ``SingleDeviceComm`` every row is
resident, under ``MeshComm`` each rank holds its own row (L = 1), as does
each block under ``BlockComm`` (the one-process mesh), and the steady
forms go to the mesh kernels of ``core.step_mesh`` exactly where the JAX
package dispatches to them (``:225-245``, ``:584-598``): with
``term_floor``, ``repair`` off or ``ec`` on, 128 | B and 128 | C, and a
window of the full local lanes. Everywhere else the general path runs on
the one local row. An operand handed to ``comm`` must not be changed in
place until the next collective: on the one-process mesh the other
blocks read it later (``core.comm.LockStep`` checks this).

The multi-Raft group data plane — G independent groups, every operand
with a leading group axis (state from ``core.state.init_group_state``):

- ``group_replicate_step`` (``:843``) and ``group_vote_step`` (``:901``)
  return callables with the JAX signatures. Where the JAX package vmaps
  ``replicate_step`` with ``use_pallas=False``, the port writes its
  general path out once with the group axis: one batched tick is one
  sequence of batched torch ops whose payload windows go through kernel
  K5 (``core.ring_cuda.write_window_cols``), one launch per window for
  all G groups — never K1 or K2, and no loop over groups.
- ``fused_group_scan`` (``:749``) — G groups × K ticks with per-group
  ``halted`` flags on the device.

Scalar arguments may be Python ints or 0-d tensors; the general path
never reads a device value back to the host. The rings are updated in
place: the state passed in is consumed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raft_tpu_torch.core.comm import (
    BlockComm,
    MeshComm,
    SingleDeviceComm,
    take,
    take_groups,
)
from raft_tpu_torch.core.ring import (
    group_read_window,
    group_read_window_cols,
    group_write_window_rows,
    per_group,
    read_window,
    read_window_cols,
)
from raft_tpu_torch.core.ring_cuda import write_window_both, write_window_cols
from raft_tpu_torch.core.state import (
    NO_VOTE,
    ReplicaState,
    as_group,
    last_log_term,
    membership_voters,
    slot_of,
)
from raft_tpu_torch.quorum.commit import commit_from_match


class RepInfo(NamedTuple):
    """Outputs of a replication step (int32 tensors)."""

    commit_index: torch.Tensor  # i32[]  global commit index after the step
    match: torch.Tensor         # i32[R] verified per-replica match (0 if dead)
    max_term: torch.Tensor      # i32[]  highest term heard in the cluster
    repair_start: torch.Tensor  # i32[]  first index the repair window covered
    frontier_len: torch.Tensor  # i32[]  client entries ingested this step


class VoteInfo(NamedTuple):
    votes: torch.Tensor         # i32[]  granted votes (with the candidate's)
    max_term: torch.Tensor      # i32[]  highest term heard after voting
    grants: torch.Tensor        # bool[R] per-replica grant vector


def _i32(x, device) -> torch.Tensor:
    """A 0-d int32 tensor on ``device`` (a fill, never a host copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(x), dtype=torch.int32, device=device)


def _mask(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool)
    return torch.as_tensor(x, dtype=torch.bool).to(device)


def _mesh_kernel_ok(comm, cap: int, B: int, lanes: int, state) -> bool:
    """Whether a steady call under ``comm`` goes to the mesh kernels: the
    JAX package's dispatch rule (``core/step.py:225-231``,
    ``ring._pallas_ok``), kept as narrow as it is there because the
    kernels' closed forms hold only under the engine's steady-program
    invariants (``core.step_mesh``)."""
    return (isinstance(comm, (MeshComm, BlockComm)) and B % 128 == 0
            and cap % 128 == 0 and lanes == state.log_payload.shape[1])


def replicate_step(
    comm,
    state: ReplicaState,
    client_payload: torch.Tensor,  # i32[B, L*W] folded batch
    client_count,                  # valid entries in client_payload (<= B)
    leader,                        # replica id of the leader
    leader_term,                   # leader's current term
    alive,                         # bool[R] fault mask: dead rows hear nothing
    slow,                          # bool[R] slow rows hear but do not append
    floor_prev_term=0,             # attested term of entry repair_floor - 1
    repair_floor=0,                # lowest index the leader's ring holds
    member=None,                   # bool[R] / packed int[R] configuration
    *,
    ec: bool = False,
    commit_quorum: int | None = None,
    repair: bool = True,
    term_floor=None,               # first log index of the leader's term
    ring=None,                     # obs.device.EventRing when record=True
    record: bool = False,
    group_id: int = -1,            # group tag recorded events carry
) -> tuple[ReplicaState, RepInfo]:
    """One leader tick, on device: the same (state, RepInfo) as
    ``raft_tpu.core.step.replicate_step`` (see its docstring for the
    protocol). Consumes ``state``.

    ``record=True`` (``:152-213``) runs the step unrecorded, through
    whichever formulation the dispatch picks (K2 or the general path),
    then records its events into ``ring`` in place from the (old, new,
    info) triple (``obs.device.record_replicate_events``); the old small
    leaves are copied out first, since K2 writes them in place. Returns
    ``(state, info, ring)``."""
    if record:
        from raft_tpu_torch.obs.device import pre_of, record_replicate_events

        if ring is None:
            raise ValueError("record=True requires an EventRing")
        old = pre_of(state)
        new_state, info = replicate_step(
            comm, state, client_payload, client_count, leader, leader_term,
            alive, slow, floor_prev_term, repair_floor, member, ec=ec,
            commit_quorum=commit_quorum, repair=repair,
            term_floor=term_floor)
        record_replicate_events(
            ring, comm, old, new_state, info, leader, leader_term,
            group_id, repair=bool(repair and not ec))
        return new_state, info, ring
    dev = state.device
    if member is not None:
        member = membership_voters(_as_member(member, dev))
    cap = state.capacity
    B, M = client_payload.shape
    steady = term_floor is not None and (not repair or ec)
    if steady and _mesh_kernel_ok(comm, cap, B, M, state):
        from raft_tpu_torch.core.step_mesh import mesh_replicate_step

        return mesh_replicate_step(
            comm, state, client_payload, client_count, leader, leader_term,
            alive, slow, floor_prev_term, repair_floor, member, term_floor,
            commit_quorum=commit_quorum, ec=ec,
        )
    if steady and isinstance(comm, SingleDeviceComm):
        from raft_tpu_torch.core.step_cuda import steady_replicate_step

        return steady_replicate_step(
            state, client_payload, client_count, leader, leader_term, alive,
            slow, floor_prev_term, repair_floor, member, term_floor,
            commit_quorum=commit_quorum, ec=ec,
        )
    L = state.term.shape[0]
    W = M // L
    client_payload = client_payload.to(dev)
    leader = _i32(leader, dev)
    leader_term = _i32(leader_term, dev)
    repair_floor = _i32(repair_floor, dev)
    floor_prev_term = _i32(floor_prev_term, dev)
    alive = _mask(alive, dev)
    slow = _mask(slow, dev)
    ids = comm.replica_ids(dev)
    is_leader_row = ids == leader
    alive_l = comm.local(alive)
    slow_l = comm.local(slow)
    term0 = state.term
    barange = torch.arange(B, dtype=torch.int32, device=dev)
    client_count = _i32(client_count, dev).clamp(0, B)
    legit = leader_term >= 1

    # ---- 1. frontier accounting (the leader's client batch)
    leader_current = legit & (take(comm.all_gather(term0), leader)
                              <= leader_term)
    leader_last0 = take(comm.all_gather(state.last_index), leader)
    leader_commit0 = take(comm.all_gather(state.commit_index), leader)
    room = cap - (leader_last0 - leader_commit0)
    frontier_count = torch.where(
        leader_current, torch.minimum(client_count, room.clamp(min=0)), 0)
    ingest_row = is_leader_row & leader_current
    frontier_start = leader_last0 + 1
    leader_last = leader_last0 + frontier_count

    # ---- 2. verified match bookkeeping
    heard = alive_l & legit & (leader_term >= term0)
    m_eff = torch.where(state.match_term == leader_term, state.match_index, 0)
    m_eff = torch.where(ingest_row, leader_last, m_eff)

    def leader_prev_term(lt, ws, prev_slot):
        ring_term = comm.select_row(take(lt, prev_slot, 1), leader)
        attested = torch.where(ws - 1 < repair_floor, floor_prev_term,
                               ring_term)
        return torch.where(ws == 1, 0, attested)

    def apply_window(carry, ws, count, win_p, win_t, prev_term, prev_slot,
                     force_leader_row=False):
        log_term, log_payload, last_index, m_eff = carry
        my_prev_t = take(log_term, prev_slot, 1)
        has_prev = (ws == 1) | ((last_index >= ws - 1)
                                & (my_prev_t == prev_term))
        accept = heard & ~slow_l & has_prev
        if force_leader_row:
            accept = accept | ingest_row
        start_slot = slot_of(ws, cap)
        any_mm = write_window_both(
            log_payload, log_term, win_p, win_t, start_slot, count, ws,
            accept, last_index) != 0
        we = ws + count - 1
        last_index = torch.where(
            accept,
            torch.where(any_mm, torch.maximum(we, ws - 1),
                        torch.maximum(last_index, we)),
            last_index)
        m_eff = torch.where(accept, torch.maximum(m_eff, we), m_eff)
        return (log_term, log_payload, last_index, m_eff)

    # ---- 3. repair window: heal the slowest live verified match
    carry = (state.log_term, state.log_payload, state.last_index, m_eff)
    repair_ws = torch.zeros((), dtype=torch.int32, device=dev)
    if not ec and repair:
        matches0 = comm.all_gather(m_eff)
        repair_mask = alive & ~slow
        horizon = (leader_last - cap + 1).clamp(min=1)
        horizon = torch.maximum(horizon, repair_floor)
        repair_ws = torch.maximum(
            torch.where(repair_mask, matches0, leader_last0).min() + 1,
            horizon)
        repair_count = torch.where(
            legit, (leader_last0 - repair_ws + 1).clamp(0, B), 0)
        # The JAX step skips the window under lax.cond when repair_count
        # is 0. Here it always runs — a zero-count window writes nothing —
        # and its vector outputs are kept only when it would have run, so
        # the tick needs no host read of repair_count.
        lt, lp = carry[0], carry[1]
        rslot = slot_of(repair_ws, cap)
        win_p = comm.leader_cols(read_window_cols(lp, rslot, B), leader, W)
        win_t = comm.select_row(read_window(lt, rslot, B), leader)
        prev_slot = slot_of(torch.clamp(repair_ws - 1, min=1), cap)
        prev_term = leader_prev_term(lt, repair_ws, prev_slot)
        fixed = apply_window(carry, repair_ws, repair_count, win_p, win_t,
                             prev_term, prev_slot)
        run = repair_count > 0
        carry = (fixed[0], fixed[1], torch.where(run, fixed[2], carry[2]),
                 torch.where(run, fixed[3], carry[3]))

    # ---- 4. frontier window: the fresh client batch
    win_t = torch.where(barange < frontier_count, leader_term, 0)
    prev_slot = slot_of(torch.clamp(frontier_start - 1, min=1), cap)
    prev_term = leader_prev_term(carry[0], frontier_start, prev_slot)
    carry = apply_window(carry, frontier_start, frontier_count,
                         client_payload, win_t, prev_term, prev_slot,
                         force_leader_row=True)
    log_term, log_payload, last_index, m_eff = carry

    # term adoption on hearing a legitimate leader (vote reset on advance)
    adopt = heard & (leader_term > term0)
    voted_for = torch.where(adopt, NO_VOTE, state.voted_for)
    term = torch.where(heard, torch.maximum(term0, leader_term), term0)

    # ---- 5. quorum commit (k-th largest verified match, §5.4.2 gate)
    if member is None:
        quorum = commit_quorum
        ack_mask = alive
    else:
        quorum = member.to(torch.int32).sum() // 2 + 1
        if ec and commit_quorum is not None:
            quorum = quorum.clamp(min=commit_quorum)
        ack_mask = alive & member
    match = torch.where(ack_mask, comm.all_gather(m_eff), 0)
    commit_cand = commit_from_match(match, quorum)
    cand_slot = slot_of(commit_cand.clamp(min=1), cap)
    cand_term = comm.select_row(take(log_term, cand_slot, 1), leader)
    commit_ok = legit & (commit_cand >= 1) & (cand_term == leader_term)
    global_commit = torch.where(
        commit_ok, torch.maximum(leader_commit0, commit_cand), leader_commit0)
    my_commit = torch.where(is_leader_row, global_commit,
                            torch.minimum(global_commit, m_eff))
    commit_index = torch.where(
        (heard & ~slow_l) | (is_leader_row & leader_current),
        torch.maximum(state.commit_index, my_commit), state.commit_index)

    new_state = ReplicaState(
        term=term.to(torch.int32),
        voted_for=voted_for.to(torch.int32),
        last_index=last_index.to(torch.int32),
        commit_index=commit_index.to(torch.int32),
        match_index=torch.where(heard | ingest_row, m_eff,
                                state.match_index).to(torch.int32),
        match_term=torch.where(heard | ingest_row, leader_term,
                               state.match_term).to(torch.int32),
        log_term=log_term,
        log_payload=log_payload,
    )
    info = RepInfo(
        commit_index=global_commit.to(torch.int32),
        match=match.to(torch.int32),
        max_term=torch.where(alive, comm.all_gather(term), 0).max()
        .to(torch.int32),
        repair_start=repair_ws.to(torch.int32),
        frontier_len=frontier_count.to(torch.int32),
    )
    return new_state, info


def _as_member(member, device) -> torch.Tensor:
    if isinstance(member, torch.Tensor):
        return member.to(device)
    return torch.as_tensor(member).to(device)


def scan_replicate(comm, ec, commit_quorum, repair, state, payloads, counts,
                   leader, leader_term, alive, slow, floor_prev_term=0,
                   repair_floor=0, member=None, term_floor=None, ring=None,
                   record=False, group_id=-1):
    """T replication steps (``payloads`` i32[T, B, L*W], ``counts`` i32[T]);
    returns (state, RepInfo with a leading [T] axis on every field).

    ``record=True`` (``:535-570``) runs T recorded general-path steps into
    ``ring`` and returns ``(state, infos, ring, interesting)``, with
    ``interesting`` i32[T] 1 for every step that recorded an event."""
    dev = state.device
    if record:
        if ring is None:
            raise ValueError("record=True requires an EventRing")
        counts = torch.as_tensor(counts).to(device=dev, dtype=torch.int32)
        infos, interesting = [], []
        for t in range(counts.shape[0]):
            c0 = ring.count.clone()
            state, info, ring = replicate_step(
                comm, state, payloads[t], counts[t], leader, leader_term,
                alive, slow, floor_prev_term, repair_floor, member, ec=ec,
                commit_quorum=commit_quorum, repair=repair, ring=ring,
                record=True, group_id=group_id)
            infos.append(info)
            interesting.append(ring.count > c0)
        return (state, _stack_infos(infos), ring,
                torch.stack(interesting).to(torch.int32))
    if member is not None:
        member = membership_voters(_as_member(member, dev))
    steady = term_floor is not None and (not repair or ec)
    if steady and _mesh_kernel_ok(comm, state.capacity, payloads.shape[1],
                                  payloads.shape[2], state):
        from raft_tpu_torch.core.step_mesh import mesh_scan_replicate

        return mesh_scan_replicate(
            comm, state, payloads, counts, leader, leader_term, alive, slow,
            floor_prev_term, repair_floor, member, term_floor,
            commit_quorum=commit_quorum, ec=ec,
        )
    if steady and isinstance(comm, SingleDeviceComm):
        from raft_tpu_torch.core.step_cuda import steady_scan_replicate

        return steady_scan_replicate(
            state, payloads, counts, leader, leader_term, alive, slow,
            floor_prev_term, repair_floor, member, term_floor,
            commit_quorum=commit_quorum, ec=ec,
        )
    counts = torch.as_tensor(counts).to(device=dev, dtype=torch.int32)
    infos = []
    for t in range(counts.shape[0]):
        state, info = replicate_step(
            comm, state, payloads[t], counts[t], leader, leader_term, alive,
            slow, floor_prev_term, repair_floor, member, ec=ec,
            commit_quorum=commit_quorum, repair=repair,
        )
        infos.append(info)
    return state, _stack_infos(infos)


def _stack_infos(infos) -> RepInfo:
    return RepInfo(*(torch.stack(f) for f in zip(*infos)))


def _escape(run, info, cnt, term, prev_last):
    """The K-tick escape predicate (``core/step.py:724-731``, ``:818-825``):
    a tick that ran escapes when it saw a higher term, ingested less than
    its count, or committed short of the leader's log. Returns (escaped,
    the leader's last index after the tick)."""
    new_last = prev_last + info.frontier_len
    esc = run & ((info.max_term > term) | (info.frontier_len < cnt)
                 | (info.commit_index < new_last))
    return esc, torch.where(run, new_last, prev_last)


def fused_steady_scan(comm, commit_quorum, state, staging, start_slot,
                      counts, n_run, halted0, leader, leader_term, alive,
                      slow, floor_prev_term=0, repair_floor=0, member=None,
                      ring=None, record=False, group_id=-1):
    """K steady leader ticks with exact early exit (``core/step.py:633``).

    Tick j reads staging slot ``(start_slot + j) % S`` of ``staging``
    i32[S, B, W] (untiled words), tiles it to the lane layout on the device
    and runs the general path with ``repair=False`` (kernel K1). A tick
    whose escape predicate fires (``_escape``) is the last that runs: later
    ticks, ticks ``j >= n_run``, and every tick when ``halted0`` is set are
    the masked no-op (term 0, dead cluster, count 0: the state passes
    through bit for bit). Nothing is read back to the host.

    ``record=True`` (``:636-746``) records every tick into ``ring`` in
    place: ``ring.tick`` advances on every tick, the masked ones included,
    and a masked tick records nothing.

    Returns ``(state, infos[K], escaped i32[K], ran i32[K], halted[,
    ring])``."""
    if record and ring is None:
        raise ValueError("record=True requires an EventRing")
    dev = state.device
    S, K = staging.shape[0], counts.shape[0]
    reps = state.log_payload.shape[1] // staging.shape[2]
    counts = torch.as_tensor(counts).to(device=dev, dtype=torch.int32)
    staging = staging.to(dev)
    leader = _i32(leader, dev)
    leader_term = _i32(leader_term, dev)
    alive = _mask(alive, dev)
    start = _i32(start_slot, dev)
    n_run = _i32(n_run, dev)
    halted = _mask(halted0, dev).reshape(())
    prev_last = take(comm.all_gather(state.last_index), leader)
    infos, escaped, ran = [], [], []
    for j in range(K):
        run = ~halted & (j < n_run)
        cnt = counts[j]
        win = take(staging, (start + j) % S).repeat(1, reps)
        out = replicate_step(
            comm, state, win, torch.where(run, cnt, 0), leader,
            torch.where(run, leader_term, 0), alive & run, slow,
            floor_prev_term, repair_floor, member,
            commit_quorum=commit_quorum, repair=False, ring=ring,
            record=record, group_id=group_id)
        state, info = out[:2]
        esc, prev_last = _escape(run, info, cnt, leader_term, prev_last)
        halted = halted | esc
        infos.append(info)
        escaped.append(esc)
        ran.append(run)
    out = (state, _stack_infos(infos), torch.stack(escaped).to(torch.int32),
           torch.stack(ran).to(torch.int32), halted)
    return out + (ring,) if record else out


def vote_step(comm, state: ReplicaState, candidate, cand_term,
              alive, *, ring=None, record: bool = False, quorum=0,
              group_id: int = -1) -> tuple[ReplicaState, VoteInfo]:
    """One election round: every replica votes at once, with per-term votes
    and the §5.4.1 up-to-date check (``raft_tpu/core/step.py:928``). The
    candidate's last index and last-log term and the grants cross the
    rows through ``comm`` (``:969-993``); the vote itself is the one-group
    case of ``_vote``.

    ``record=True`` (``:935-965``) also records the round into ``ring`` in
    place (``obs.device.record_vote_events``; a win is ``votes > quorum``
    with no higher term heard) and returns ``(state, info, ring)``."""
    if record:
        from raft_tpu_torch.obs.device import pre_of, record_vote_events

        if ring is None:
            raise ValueError("record=True requires an EventRing")
        old = pre_of(state)
        new_state, info = vote_step(comm, state, candidate, cand_term, alive)
        record_vote_events(ring, comm, old, new_state, info, candidate,
                           cand_term, quorum, group_id)
        return new_state, info, ring
    alive = _mask(alive, state.device)
    my_lterm = last_log_term(state)
    new, grant = _vote(as_group(state), candidate, cand_term,
                       comm.local(alive)[None],
                       comm.all_gather(state.last_index)[None],
                       comm.all_gather(my_lterm)[None], my_lterm[None])
    term = new.term[0]
    info = _vote_info(comm.all_gather(grant[0]) & alive,
                      comm.all_gather(term), alive)
    return state.replace(term=term, voted_for=new.voted_for[0]), info


def _vote_info(grants, terms, alive) -> VoteInfo:
    """A round's VoteInfo from every row's grant and new term ([..., R]):
    only rows the candidate could reach count or report their term."""
    return VoteInfo(
        votes=grants.to(torch.int32).sum(-1).to(torch.int32),
        max_term=torch.where(alive, terms, 0).amax(-1).to(torch.int32),
        grants=grants,
    )


def _vote(state, candidates, cand_terms, alive, lasts, lterms, my_lterm):
    """The vote of G groups' local rows (``state`` group-batched, ``alive``
    the local rows' [G, L] mask, ``lasts``/``lterms`` every row's last
    index and last-log term [G, R], ``my_lterm`` the local rows' [G, L]).
    Returns (state with the new terms and votes, local grants [G, L])."""
    G, dev = state.term.shape[0], state.device
    col = (slice(None), None)                       # [G] -> [G, 1]
    cand = per_group(candidates, G, dev, torch.int32)
    cand_term = per_group(cand_terms, G, dev, torch.int32)[col]
    cand_last = take_groups(lasts, cand)[col]
    cand_lterm = take_groups(lterms, cand)[col]
    newer = cand_term > state.term
    term = torch.maximum(state.term, cand_term)
    vf = torch.where(newer, NO_VOTE, state.voted_for)
    up_to_date = (cand_lterm > my_lterm) | (
        (cand_lterm == my_lterm) & (cand_last >= state.last_index))
    grant = (alive & (cand_term >= state.term)
             & ((vf == NO_VOTE) | (vf == cand[col])) & up_to_date)
    voted_for = torch.where(grant, cand[col], vf)
    term = torch.where(alive, term, state.term)
    voted_for = torch.where(alive, voted_for, state.voted_for)
    new_state = state.replace(term=term.to(torch.int32),
                              voted_for=voted_for.to(torch.int32))
    return new_state, grant


# ------------------------------------------------- multi-Raft group plane
def _group_replicate(comm, state, payload, client_count, leader, leader_term,
                     alive, slow, member, repair):
    """One tick of G groups: ``replicate_step``'s general path (``:264-529``,
    the ``use_pallas=False`` form the JAX group programs vmap) with a
    leading group axis on every operand. The group programs pass no ring
    floor (``repair_floor`` = ``floor_prev_term`` = 0), always a member
    mask, and no commit quorum or EC."""
    dev = state.device
    G, L = state.term.shape
    cap = state.capacity
    B, M = payload.shape[1:]
    W = M // L
    payload = payload.to(dev).contiguous()
    leader = per_group(leader, G, dev, torch.int32)
    leader_term = per_group(leader_term, G, dev, torch.int32)
    alive = _mask(alive, dev)
    slow = _mask(slow, dev)
    member = membership_voters(_as_member(member, dev))
    col = (slice(None), None)                       # [G] -> [G, 1]
    is_leader_row = comm.replica_ids(dev)[None, :] == leader[col]
    term0 = state.term
    barange = torch.arange(B, dtype=torch.int32, device=dev)
    client_count = per_group(client_count, G, dev, torch.int32).clamp(0, B)
    legit = leader_term >= 1

    # ---- 1. frontier accounting (each group's client batch)
    leader_current = legit & (take_groups(term0, leader) <= leader_term)
    leader_last0 = take_groups(state.last_index, leader)
    leader_commit0 = take_groups(state.commit_index, leader)
    room = cap - (leader_last0 - leader_commit0)
    frontier_count = torch.where(
        leader_current, torch.minimum(client_count, room.clamp(min=0)), 0)
    ingest_row = is_leader_row & leader_current[col]
    frontier_start = leader_last0 + 1
    leader_last = leader_last0 + frontier_count

    # ---- 2. verified match bookkeeping
    heard = alive & legit[col] & (leader_term[col] >= term0)
    m_eff = torch.where(state.match_term == leader_term[col],
                        state.match_index, 0)
    m_eff = torch.where(ingest_row, leader_last[col], m_eff)

    def leader_prev_term(lt, ws, prev_slot):
        ring_term = take_groups(take_groups(lt, prev_slot, 2), leader)
        return torch.where(ws == 1, 0, ring_term)

    def apply_window(carry, ws, count, win_p, win_t, prev_term, prev_slot,
                     force_leader_row=False):
        log_term, log_payload, last_index, m_eff = carry
        my_prev_t = take_groups(log_term, prev_slot, 2)
        has_prev = (ws == 1)[col] | ((last_index >= (ws - 1)[col])
                                     & (my_prev_t == prev_term[col]))
        accept = heard & ~slow & has_prev
        if force_leader_row:
            accept = accept | ingest_row
        start_slot = slot_of(ws, cap)
        # the §5.3 check on the old terms (``:370-375``), then the writes:
        # payload lanes through K5, the term ring through the row twin
        valid = barange[None, :] < count[col]
        widx = ws[col] + barange[None, :]
        my_win_t = group_read_window(log_term, start_slot, B)
        mismatch = ((widx[:, None, :] <= last_index[:, :, None])
                    & (my_win_t != win_t[:, None, :]) & valid[:, None, :])
        any_mm = mismatch.any(dim=2)
        write_window_cols(log_payload, win_p, start_slot, count,
                          accept.repeat_interleave(W, dim=1))
        group_write_window_rows(log_term, win_t, start_slot, count, accept)
        we = (ws + count - 1)[col]
        last_index = torch.where(
            accept,
            torch.where(any_mm, torch.maximum(we, (ws - 1)[col]),
                        torch.maximum(last_index, we)),
            last_index)
        m_eff = torch.where(accept, torch.maximum(m_eff, we), m_eff)
        return (log_term, log_payload, last_index, m_eff)

    # ---- 3. repair window: heal each group's slowest live verified match.
    # Always run (a zero-count window writes nothing); its vector outputs
    # are kept only where repair_count > 0, which is what JAX's lax.cond
    # (``:433``) becomes under vmap.
    carry = (state.log_term, state.log_payload, state.last_index, m_eff)
    repair_ws = torch.zeros(G, dtype=torch.int32, device=dev)
    if repair:
        repair_mask = alive & ~slow
        horizon = (leader_last - cap + 1).clamp(min=1)
        repair_ws = torch.maximum(
            torch.where(repair_mask, m_eff, leader_last0[col]).amin(dim=1)
            + 1, horizon)
        repair_count = torch.where(
            legit, (leader_last0 - repair_ws + 1).clamp(0, B), 0)
        lt, lp = carry[0], carry[1]
        rslot = slot_of(repair_ws, cap)
        win_p = comm.group_leader_cols(group_read_window_cols(lp, rslot, B),
                                       leader, W)
        win_t = take_groups(group_read_window(lt, rslot, B), leader)
        prev_slot = slot_of(torch.clamp(repair_ws - 1, min=1), cap)
        prev_term = leader_prev_term(lt, repair_ws, prev_slot)
        fixed = apply_window(carry, repair_ws, repair_count, win_p, win_t,
                             prev_term, prev_slot)
        run = (repair_count > 0)[col]
        carry = (fixed[0], fixed[1], torch.where(run, fixed[2], carry[2]),
                 torch.where(run, fixed[3], carry[3]))

    # ---- 4. frontier window: each group's fresh client batch
    win_t = torch.where(barange[None, :] < frontier_count[col],
                        leader_term[col], 0)
    prev_slot = slot_of(torch.clamp(frontier_start - 1, min=1), cap)
    prev_term = leader_prev_term(carry[0], frontier_start, prev_slot)
    carry = apply_window(carry, frontier_start, frontier_count, payload,
                         win_t, prev_term, prev_slot, force_leader_row=True)
    log_term, log_payload, last_index, m_eff = carry

    adopt = heard & (leader_term[col] > term0)
    voted_for = torch.where(adopt, NO_VOTE, state.voted_for)
    term = torch.where(heard, torch.maximum(term0, leader_term[col]), term0)

    # ---- 5. quorum commit per group (member majority, §5.4.2 gate)
    quorum = member.to(torch.int32).sum(dim=1) // 2 + 1
    match = torch.where(alive & member, m_eff, 0)
    commit_cand = commit_from_match(match, quorum)
    cand_slot = slot_of(commit_cand.clamp(min=1), cap)
    cand_term = take_groups(take_groups(log_term, cand_slot, 2), leader)
    commit_ok = legit & (commit_cand >= 1) & (cand_term == leader_term)
    global_commit = torch.where(
        commit_ok, torch.maximum(leader_commit0, commit_cand), leader_commit0)
    my_commit = torch.where(is_leader_row, global_commit[col],
                            torch.minimum(global_commit[col], m_eff))
    commit_index = torch.where(
        (heard & ~slow) | (is_leader_row & leader_current[col]),
        torch.maximum(state.commit_index, my_commit), state.commit_index)

    new_state = ReplicaState(
        term=term.to(torch.int32),
        voted_for=voted_for.to(torch.int32),
        last_index=last_index.to(torch.int32),
        commit_index=commit_index.to(torch.int32),
        match_index=torch.where(heard | ingest_row, m_eff,
                                state.match_index).to(torch.int32),
        match_term=torch.where(heard | ingest_row, leader_term[col],
                               state.match_term).to(torch.int32),
        log_term=log_term,
        log_payload=log_payload,
    )
    info = RepInfo(
        commit_index=global_commit.to(torch.int32),
        match=match.to(torch.int32),
        max_term=torch.where(alive, term, 0).amax(dim=1).to(torch.int32),
        repair_start=repair_ws.to(torch.int32),
        frontier_len=frontier_count.to(torch.int32),
    )
    return new_state, info


def group_replicate_step(n_replicas: int, *, repair: bool = True,
                         record: bool = False):
    """G independent groups' replication ticks as one batched program
    (``raft_tpu/core/step.py:843``). Returned callable, every leading axis
    G: ``(state, payloads[G,B,R*W], counts[G], leaders[G], terms[G],
    alive[G,R], slow[G,R], member[G,R]) -> (state, RepInfo[G])``.

    Masking: a group with nothing to do passes ``leader_term=0`` and an
    all-False ``alive`` row; its state passes through bit for bit. The
    state is consumed (its rings are written in place).

    ``record=True`` (``:866-881``) takes two more operands, a group ring
    (``obs.device.init_group_rings``) and the group ids ``gids`` [G] the
    records carry, records every group's transitions into it in place
    (``obs.device.record_replicate_events`` with the group axis) and
    returns ``(state, info, rings)``; the state equals the unrecorded
    program's bit for bit."""
    comm = SingleDeviceComm(n_replicas)

    def step(state, payloads, counts, leaders, terms, alive, slow, member,
             rings=None, gids=None):
        if not record:
            return _group_replicate(comm, state, payloads, counts, leaders,
                                    terms, alive, slow, member, repair)
        return _recorded_replicate(comm, state, payloads, counts, leaders,
                                   terms, alive, slow, member, repair,
                                   rings, gids)

    return step


def _recorded_replicate(comm, state, payloads, counts, leaders, terms,
                        alive, slow, member, repair, rings, gids):
    """One recorded group tick: the old small leaves copied out first
    (``obs.device.pre_of``; the step consumes the state), the tick, then
    the records of every group from the (old, new, info) triple."""
    from raft_tpu_torch.obs.device import pre_of, record_replicate_events

    if rings is None:
        raise ValueError("record=True requires group rings")
    G, dev = state.term.shape[0], state.device
    leaders = per_group(leaders, G, dev, torch.int32)
    terms = per_group(terms, G, dev, torch.int32)
    old = pre_of(state)
    new, info = _group_replicate(comm, state, payloads, counts, leaders,
                                 terms, alive, slow, member, repair)
    record_replicate_events(rings, comm, old, new, info, leaders, terms,
                            gids, repair=repair)
    return new, info, rings


def group_vote_step(n_replicas: int, *, record: bool = False):
    """G groups' election rounds as one batched program
    (``raft_tpu/core/step.py:901``): ``(state, candidates[G],
    cand_terms[G], alive[G,R]) -> (state, VoteInfo[G])``. A group with no
    campaign passes an all-False ``alive`` row and is left unchanged.

    ``record=True`` takes ``rings`` and ``gids`` as
    :func:`group_replicate_step` and returns ``(state, info, rings)``; the
    recorded win threshold is the static strict majority of the R-row
    cluster, ``n_replicas // 2`` (``:914-918``: fixed membership)."""
    comm = SingleDeviceComm(n_replicas)

    def vote(state, candidates, cand_terms, alive, rings=None, gids=None):
        if record:
            from raft_tpu_torch.obs.device import pre_of, record_vote_events

            if rings is None:
                raise ValueError("record=True requires group rings")
            G, dev = state.term.shape[0], state.device
            candidates = per_group(candidates, G, dev, torch.int32)
            cand_terms = per_group(cand_terms, G, dev, torch.int32)
            old = pre_of(state)
        alive = _mask(alive, state.device)
        lterms = last_log_term(state)
        new, grant = _vote(state, candidates, cand_terms, alive,
                           state.last_index, lterms, lterms)
        info = _vote_info(grant & alive, new.term, alive)
        if not record:
            return new, info
        record_vote_events(rings, comm, old, new, info, candidates,
                           cand_terms, n_replicas // 2, gids)
        return new, info, rings

    return vote


def fused_group_scan(n_replicas: int, *, record: bool = False):
    """G groups × K ticks with exact per-group early exit
    (``raft_tpu/core/step.py:749``): tick j runs the steady group step
    (``repair=False``) for every group not yet halted while ``j < n_run``;
    a group whose tick escapes (``_escape``) runs no later tick, and the
    masked ticks are the bit-exact no-op. ``halted0`` threads the flags
    across launches. Payloads arrive untiled, i32[K, G, B, W], and are
    tiled to the lane layout on the device (as ``fold_batch`` tiles them).
    No value is read back to the host.

    Returned callable: ``(state, payloads[K,G,B,W], counts[K,G], n_run,
    halted0[G], leaders[G], terms[G], alive[G,R], slow[G,R], member[G,R]
    [, rings, gids]) -> (state, infos[K,G], escaped i32[K,G], ran i32[K,G],
    halted[G][, rings])``. ``record=True`` records every tick of every
    group into ``rings`` (a masked tick advances the group's ``tick`` and
    records nothing), as the recorded group step."""
    comm = SingleDeviceComm(n_replicas)

    def run(state, payloads, counts, n_run, halted0, leaders, terms, alive,
            slow, member, rings=None, gids=None):
        G, dev = state.term.shape[0], state.device
        K = payloads.shape[0]
        reps = state.log_payload.shape[-1] // payloads.shape[-1]
        counts = torch.as_tensor(counts).to(device=dev, dtype=torch.int32)
        payloads = payloads.to(dev)
        leaders = per_group(leaders, G, dev, torch.int32)
        terms = per_group(terms, G, dev, torch.int32)
        alive = _mask(alive, dev)
        n_run = _i32(n_run, dev)
        halted = _mask(halted0, dev)
        prev_last = take_groups(state.last_index, leaders)
        infos, escaped, ran = [], [], []
        for j in range(K):
            run_g = ~halted & (j < n_run)
            cnt = counts[j]
            win = payloads[j].repeat(1, 1, reps)
            args = (comm, state, win, torch.where(run_g, cnt, 0), leaders,
                    torch.where(run_g, terms, 0), alive & run_g[:, None],
                    slow, member, False)
            if record:
                state, info, rings = _recorded_replicate(*args, rings, gids)
            else:
                state, info = _group_replicate(*args)
            esc, prev_last = _escape(run_g, info, cnt, terms, prev_last)
            halted = halted | esc
            infos.append(info)
            escaped.append(esc)
            ran.append(run_g)
        out = (state, _stack_infos(infos),
               torch.stack(escaped).to(torch.int32),
               torch.stack(ran).to(torch.int32), halted)
        return out + (rings,) if record else out

    return run
