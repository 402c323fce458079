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

Scalar arguments may be Python ints or 0-d tensors; the general path
never reads a device value back to the host. The rings are updated in
place: the state passed in is consumed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raft_tpu_torch.core.comm import SingleDeviceComm, take
from raft_tpu_torch.core.ring import read_window, read_window_cols
from raft_tpu_torch.core.ring_cuda import write_window_both
from raft_tpu_torch.core.state import (
    NO_VOTE,
    ReplicaState,
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


def replicate_step(
    comm: SingleDeviceComm,
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
) -> tuple[ReplicaState, RepInfo]:
    """One leader tick, on device: the same (state, RepInfo) as
    ``raft_tpu.core.step.replicate_step`` (see its docstring for the
    protocol). Consumes ``state``."""
    dev = state.device
    if member is not None:
        member = membership_voters(_as_member(member, dev))
    if term_floor is not None and (not repair or ec):
        from raft_tpu_torch.core.step_cuda import steady_replicate_step

        return steady_replicate_step(
            state, client_payload, client_count, leader, leader_term, alive,
            slow, floor_prev_term, repair_floor, member, term_floor,
            commit_quorum=commit_quorum, ec=ec,
        )
    cap = state.capacity
    B, M = client_payload.shape
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
    term0 = state.term
    barange = torch.arange(B, dtype=torch.int32, device=dev)
    client_count = _i32(client_count, dev).clamp(0, B)
    legit = leader_term >= 1

    # ---- 1. frontier accounting (the leader's client batch)
    leader_current = legit & (take(term0, leader) <= leader_term)
    leader_last0 = take(state.last_index, leader)
    leader_commit0 = take(state.commit_index, leader)
    room = cap - (leader_last0 - leader_commit0)
    frontier_count = torch.where(
        leader_current, torch.minimum(client_count, room.clamp(min=0)), 0)
    ingest_row = is_leader_row & leader_current
    frontier_start = leader_last0 + 1
    leader_last = leader_last0 + frontier_count

    # ---- 2. verified match bookkeeping
    heard = alive & legit & (leader_term >= term0)
    m_eff = torch.where(state.match_term == leader_term, state.match_index, 0)
    m_eff = torch.where(ingest_row, leader_last, m_eff)

    def leader_prev_term(lt, ws, prev_slot):
        ring_term = take(take(lt, prev_slot, 1), leader)
        attested = torch.where(ws - 1 < repair_floor, floor_prev_term,
                               ring_term)
        return torch.where(ws == 1, 0, attested)

    def apply_window(carry, ws, count, win_p, win_t, prev_term, prev_slot,
                     force_leader_row=False):
        log_term, log_payload, last_index, m_eff = carry
        my_prev_t = take(log_term, prev_slot, 1)
        has_prev = (ws == 1) | ((last_index >= ws - 1)
                                & (my_prev_t == prev_term))
        accept = heard & ~slow & has_prev
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
        repair_mask = alive & ~slow
        horizon = (leader_last - cap + 1).clamp(min=1)
        horizon = torch.maximum(horizon, repair_floor)
        repair_ws = torch.maximum(
            torch.where(repair_mask, m_eff, leader_last0).min() + 1, horizon)
        repair_count = torch.where(
            legit, (leader_last0 - repair_ws + 1).clamp(0, B), 0)
        # The JAX step skips the window under lax.cond when repair_count
        # is 0. Here it always runs — a zero-count window writes nothing —
        # and its vector outputs are kept only when it would have run, so
        # the tick needs no host read of repair_count.
        lt, lp = carry[0], carry[1]
        rslot = slot_of(repair_ws, cap)
        win_p = comm.leader_cols(read_window_cols(lp, rslot, B), leader, W)
        win_t = take(read_window(lt, rslot, B), leader)
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
    match = torch.where(ack_mask, m_eff, 0)
    commit_cand = commit_from_match(match, quorum)
    cand_slot = slot_of(commit_cand.clamp(min=1), cap)
    cand_term = take(take(log_term, cand_slot, 1), leader)
    commit_ok = legit & (commit_cand >= 1) & (cand_term == leader_term)
    global_commit = torch.where(
        commit_ok, torch.maximum(leader_commit0, commit_cand), leader_commit0)
    my_commit = torch.where(is_leader_row, global_commit,
                            torch.minimum(global_commit, m_eff))
    commit_index = torch.where(
        (heard & ~slow) | (is_leader_row & leader_current),
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
        max_term=torch.where(alive, term, 0).max().to(torch.int32),
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
                   repair_floor=0, member=None, term_floor=None):
    """T replication steps (``payloads`` i32[T, B, L*W], ``counts`` i32[T]);
    returns (state, RepInfo with a leading [T] axis on every field)."""
    dev = state.device
    if member is not None:
        member = membership_voters(_as_member(member, dev))
    if term_floor is not None and (not repair or ec):
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
    return state, RepInfo(*(torch.stack(f) for f in zip(*infos)))


def vote_step(comm: SingleDeviceComm, state: ReplicaState, candidate,
              cand_term, alive) -> tuple[ReplicaState, VoteInfo]:
    """One election round: every replica votes at once, with per-term votes
    and the §5.4.1 up-to-date check (``raft_tpu/core/step.py:928``)."""
    dev = state.device
    candidate = _i32(candidate, dev)
    cand_term = _i32(cand_term, dev)
    alive = _mask(alive, dev)
    lasts = state.last_index
    my_lterm = last_log_term(state)
    cand_last, cand_lterm = take(lasts, candidate), take(my_lterm, candidate)
    newer = cand_term > state.term
    term = torch.maximum(state.term, cand_term)
    vf = torch.where(newer, NO_VOTE, state.voted_for)
    up_to_date = (cand_lterm > my_lterm) | (
        (cand_lterm == my_lterm) & (cand_last >= state.last_index))
    grant = (alive & (cand_term >= state.term)
             & ((vf == NO_VOTE) | (vf == candidate)) & up_to_date)
    voted_for = torch.where(grant, candidate, vf)
    term = torch.where(alive, term, state.term)
    voted_for = torch.where(alive, voted_for, state.voted_for)
    grants = grant & alive
    new_state = state.replace(term=term.to(torch.int32),
                              voted_for=voted_for.to(torch.int32))
    info = VoteInfo(
        votes=grants.to(torch.int32).sum().to(torch.int32),
        max_term=torch.where(alive, term, 0).max().to(torch.int32),
        grants=grants,
    )
    return new_state, info
