"""The steady kernels on the replica mesh (port of
``raft_tpu/core/step_mesh.py``).

**Replicated scalar plane, local data plane.** Each rank of the process
group holds ONE replica row's ring (payload [C, W], terms [1, C]) and that
row's six protocol scalars. One launch-time gather moves every row's
scalars (a (6, R) plane) and a second one every row's prev term (the term
at the slot before the leader's frontier) to every rank; from there each
rank runs the same scalar core as the resident kernels over all R rows —
accept sets, the match vector, the quorum commit, term adoption —
redundantly, while its memory traffic touches only its own row. A call,
however many steps, costs exactly those two collectives.

**Why no per-step communication is sound.** The steady program's
cross-row observables are closed-form in the launch state and the fault
masks, given two invariants the engine maintains:

1. *No follower holds a current-term entry beyond the leader's tail* — the
   leader appends before replicating, truncation clamps every row, and two
   leaders never share a term. Hence an accepting row's overlap always
   conflicts and its new tail is exactly the window end.
2. *Non-accepting rows stay non-accepting for the flight* — a row that
   rejects window t has, at window t+1's prev slot, a too-short log or a
   term other than the current one, so it keeps rejecting; an accepting
   row's next prev term is the ``lterm`` it just wrote.

So the §5.3 conflict bit and the next prev-term column, the only places
the resident kernels read other rows' rings, become closed forms
(``core.step_cuda``'s mesh-local mode of K2, K3 and K4). The closed forms
are exact only under these invariants, which is why ``core.step`` sends a
call here only where the JAX package does.

EC: windows arrive pre-encoded (``ec.kernels.encode_fold_device``), so a
rank's lane block is its shard and the mesh kernels never encode parity.

``LAST_DISPATCH`` names the entry point that ran last ("step", "scan" or
"pipeline"), so tests and ``chip_smoke.py`` can assert that a mesh call
went through the mesh kernels.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.state import ReplicaState, slot_of
from raft_tpu_torch.core.step_cuda import (
    _VL,
    _prepare,
    launch_feasibility,
    mk_info,
    params_and_masks,
    pick_br,
    pipeline_flight,
    steady_step,
    turnover_flight,
)

LAST_DISPATCH: str | None = None


def _gather_plane(comm, state: ReplicaState, leader: int):
    """The two launch collectives: every row's packed scalars -> (6, R)
    and every row's prev term (the slot before the leader's frontier)
    -> [R]. The plane is gathered to the host, where every rank takes the
    same decisions on it, and put on the state's device in one copy for
    the kernels. Returns (vecs, prev) on the host and on the device."""
    R = comm.n_replicas
    own = torch.stack([state.term, state.voted_for, state.last_index,
                       state.commit_index, state.match_index,
                       state.match_term], dim=1).to(torch.int32)   # [1, 6]
    vecs = comm.all_gather_host(own).t().contiguous()              # (6, R)
    prev_slot = slot_of(max(int(vecs[_VL, leader]), 1), state.capacity)
    prev = comm.all_gather_host(state.log_term[0, prev_slot:prev_slot + 1])
    plane = torch.cat([vecs.reshape(-1), prev]).to(state.device)
    return (vecs, prev), (plane[:6 * R].view(6, R), plane[6 * R:])


def _unpack_local(comm, vecs, state: ReplicaState) -> ReplicaState:
    """The rank's own scalars out of the replicated (6, R) result; the
    rings are already local."""
    own = vecs[:, comm.rank:comm.rank + 1]
    return ReplicaState(
        term=own[0], voted_for=own[1], last_index=own[2],
        commit_index=own[3], match_index=own[4], match_term=own[5],
        log_term=state.log_term, log_payload=state.log_payload,
    )


def _setup(comm, state, leader, leader_term, term_floor, repair_floor,
           floor_prev_term, alive, slow, member, commit_quorum, ec):
    prm, alive, slow, member = _prepare(
        state, leader, leader_term, term_floor, repair_floor,
        floor_prev_term, alive, slow, member, commit_quorum, ec,
        rows=comm.n_replicas)
    host, (vecs, prev) = _gather_plane(comm, state, prm.leader)
    return prm, alive, slow, member, vecs, prev, host


def mesh_replicate_step(comm, state: ReplicaState, client_payload,
                        client_count, leader, leader_term, alive, slow,
                        floor_prev_term, repair_floor, member, term_floor,
                        commit_quorum=None, ec=False):
    """One steady step on the mesh (K2·mesh): the same (state, RepInfo)
    as the general ``core.step.replicate_step(repair=False)`` under
    ``MeshComm`` on inputs that respect the engine's invariants.
    ``client_payload`` is the rank's own lane block [B, W]. Consumes
    ``state``."""
    global LAST_DISPATCH
    LAST_DISPATCH = "step"
    R = comm.n_replicas
    prm, alive, slow, member, vecs, prev, _ = _setup(
        comm, state, leader, leader_term, term_floor, repair_floor,
        floor_prev_term, alive, slow, member, commit_quorum, ec)
    out = torch.empty(2 * R + 5, dtype=torch.int32, device=state.device)
    steady_step(vecs, state.log_payload, state.log_term,
                client_payload.to(state.device).contiguous(), client_count,
                alive, slow, member, prm, out, my_row=comm.rank, prev=prev)
    return _unpack_local(comm, vecs, state), mk_info(out, R)


def _scan(comm, vecs, prev, state, wins, counts, alive, slow, member, prm):
    """T back-to-back K2·mesh launches on the replicated plane; each
    launch hands the next its closed-form prev column. Returns the
    stacked outputs [T, 2R+5]."""
    R = comm.n_replicas
    T = counts.shape[0]
    outs = torch.zeros(T, 2 * R + 5, dtype=torch.int32, device=state.device)
    for t in range(T):
        steady_step(vecs, state.log_payload, state.log_term, wins(t),
                    counts[t:t + 1], alive, slow, member, prm, outs[t],
                    my_row=comm.rank, prev=prev)
        prev = outs[t, R + 5:]
    return outs


def mesh_scan_replicate(comm, state: ReplicaState, payloads, counts, leader,
                        leader_term, alive, slow, floor_prev_term,
                        repair_floor, member, term_floor, commit_quorum=None,
                        ec=False):
    """T steady steps on the mesh (``payloads`` [T, B, W], ``counts``
    [T]): one gather, then T K2·mesh launches. Returns the stacked
    RepInfo. Consumes ``state``."""
    global LAST_DISPATCH
    LAST_DISPATCH = "scan"
    dev = state.device
    prm, alive, slow, member, vecs, prev, _ = _setup(
        comm, state, leader, leader_term, term_floor, repair_floor,
        floor_prev_term, alive, slow, member, commit_quorum, ec)
    payloads = payloads.to(dev).contiguous()
    counts = torch.as_tensor(counts).to(device=dev, dtype=torch.int32)
    outs = _scan(comm, vecs, prev, state, lambda t: payloads[t], counts,
                 alive, slow, member, prm)
    return _unpack_local(comm, vecs, state), mk_info(outs, comm.n_replicas)


def mesh_pipeline(comm, state: ReplicaState, wins, counts, leader,
                  leader_term, alive, slow, floor_prev_term, repair_floor,
                  member, term_floor, commit_quorum=None, ec=False):
    """T saturated steps on the mesh (``wins`` [P, B, W], step t takes
    wins[t % P]) in the JAX package's three regimes: the write-only
    turnover (K4·mesh) when T·B >= C, the flight is feasible and every
    row accepts; otherwise the flight (K3·mesh) when it is feasible; else
    the per-step scan (K2·mesh). Feasibility is ``launch_feasibility`` on
    the gathered plane, so every rank takes the same branch; K3·mesh
    makes the turnover decision on the device from the same column.
    Returns (state, the final step's RepInfo). Consumes ``state``."""
    global LAST_DISPATCH
    LAST_DISPATCH = "pipeline"
    R = comm.n_replicas
    dev = state.device
    C = state.capacity
    prm, alive, slow, member, vecs, prev, (vecs_h, prev_h) = _setup(
        comm, state, leader, leader_term, term_floor, repair_floor,
        floor_prev_term, alive, slow, member, commit_quorum, ec)
    wins = wins.to(dev).contiguous()
    counts_h = torch.as_tensor(counts).to(dtype=torch.int32).cpu()
    counts = counts_h.to(dev)
    P, B, _ = wins.shape
    T = counts.shape[0]
    if T < 1:
        raise ValueError("a flight needs at least one step")
    br = pick_br(B, C)
    # the launch-feasibility predicate on the host copy of the plane
    masks_h = torch.stack([alive, slow] + ([] if member is None
                                           else [member])).cpu()
    params, masks = params_and_masks(
        prm, masks_h[0], masks_h[1], None if member is None else masks_h[2],
        comm.rank)
    feasible, _ = launch_feasibility(
        vecs_h, masks, params, prev_h[:, None], counts_h,
        int(vecs_h[_VL, prm.leader]) % C, br, B, R, prm.leader, prm.lterm,
        prm.rfloor, prm.fpt)
    if not bool(feasible):
        outs = _scan(comm, vecs, prev, state, lambda t: wins[t % P], counts,
                     alive, slow, member, prm)
        return _unpack_local(comm, vecs, state), mk_info(outs[-1], R)
    turnover_ok = T * B >= C
    out = torch.empty(R + 5, dtype=torch.int32, device=dev)
    pipeline_flight(vecs, state.log_payload, state.log_term, wins, counts,
                    alive, slow, member, prm, br, turnover_ok, out,
                    my_row=comm.rank, prev=prev)
    if turnover_ok:
        turnover_flight(vecs, state.log_payload, state.log_term, wins, T,
                        prm, out, my_row=comm.rank)
    return _unpack_local(comm, vecs, state), mk_info(out, R)
