"""Kernels K2-K4: the steady replication data plane (port of
``raft_tpu/core/step_pallas.py``, resident layout).

- K2 ``steady_step`` — one whole steady step (``_invoke`` :404 /
  ``_steady_kernel`` :145): prologue (frontier room, backpressure,
  heard/accept/verified-match masks), window merge with the §5.3 check,
  epilogue (last/match/commit advance, term adoption with vote reset, the
  k-th-order quorum commit behind the ``term_floor`` gate). It also emits
  the next window's start slot and prev-term column.
- K3 ``pipeline_flight`` — T steady steps in one launch (``_run_pipeline``
  :1045 / ``_steady_pipeline_kernel`` :664). Each step runs at its true
  start slot, so the flight equals the per-step scan for every input.
- K4 ``turnover_flight`` — the write-only all-accept flight that turns the
  ring over (``_run_turnover`` :1189 / ``_turnover_kernel`` :1130).

With ``ec_consts`` (the [m, k, 8] table of ``ec.kernels.parity_consts``)
each kernel runs in its in-kernel RS parity mode (K2-4·ec,
``_encode_parity_lanes`` :93): the windows carry only the k data-lane
blocks (``Mk = k*W`` lanes) and the merge computes the m parity lane
blocks. Full-lane windows must come without it; any other combination
raises, as ``step_pallas.py:974-978`` does.

Each wrapper launches its CUDA kernel (``csrc/steady.cu``, whose header
states the design and the bound) for CUDA tensors and runs its plain
version, in this module, for CPU tensors. The six [L] state vectors travel
packed as one (6, L) int32 block that the kernels update in place, as do
the two rings: a state handed to these functions is consumed.

Host scalars (leader, terms, floors, quorum) go to the kernels by value;
masks and counts stay on the device. The branch between K3 and K4 is taken
on the device (K3 publishes it in the workspace, K4 reads it), so a flight
costs two launches and no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch import cuda_build
from raft_tpu_torch.core.ring_cuda import vec4_ok, write_window_both_plain
from raft_tpu_torch.core.state import NO_VOTE, ReplicaState
from raft_tpu_torch.ec.kernels import apply_bits_plain

# packed state-vector rows (the (6, L) block)
_VT, _VV, _VL, _VC, _VMI, _VMT = range(6)
# params layout of the JAX kernels (``_params_and_masks``)
_LEADER, _LTERM, _TFLOOR, _RFLOOR, _FPT, _QUORUM, _MYROW = range(7)
# mask rows (alive, slow, ack)
_MAL, _MSL, _MAK = range(3)
# workspace words (csrc/steady.cu ``WK_*``; the buffer holds at least
# its WK_N words)
WK_PLAN, WK_S0, WK_RAN3, WK_RAN4 = 5, 6, 7, 8
_WORK_WORDS = 16

#: kernel launches, counted where each wrapper launches its kernel; the
#: in-kernel parity mode counts under its own ``*_ec`` keys
LAUNCHES = {"steady_step": 0, "pipeline_flight": 0, "turnover_flight": 0,
            "steady_step_ec": 0, "pipeline_flight_ec": 0,
            "turnover_flight_ec": 0}

_workspaces: dict = {}
_ec_tables: dict = {}


def workspace(device) -> torch.Tensor:
    """The per-device int32 scratch words the steady kernels share (zero
    between calls except the plan and the executed-flight counters)."""
    key = str(torch.device(device))
    if key not in _workspaces:
        _workspaces[key] = torch.zeros(_WORK_WORDS, dtype=torch.int32,
                                       device=device)
    return _workspaces[key]


class StepParams(NamedTuple):
    """Per-call constants of a steady step, all host ints."""

    leader: int
    lterm: int
    tfloor: int
    rfloor: int
    fpt: int
    quorum: int      # commit quorum when no member mask is given
    ec_floor: int    # EC floor clamping a member majority (0 = none)


def step_params(leader, leader_term, term_floor, repair_floor,
                floor_prev_term, commit_quorum, L, ec=False) -> StepParams:
    quorum = commit_quorum if commit_quorum is not None else L // 2 + 1
    ec_floor = commit_quorum if (ec and commit_quorum is not None) else 0
    return StepParams(int(leader), int(leader_term), int(term_floor),
                      int(repair_floor), int(floor_prev_term), int(quorum),
                      int(ec_floor))


def pick_br(B: int, C: int) -> int:
    """The JAX kernels' row-block size (``step_pallas._pick_br``). It only
    enters the launch-feasibility predicate here: a flight whose start slot
    is not BR-aligned is not feasible, exactly as on the TPU."""
    return 256 if B % 256 == 0 and C % 256 == 0 else 128


def pack(state: ReplicaState) -> torch.Tensor:
    return torch.stack([
        state.term, state.voted_for, state.last_index, state.commit_index,
        state.match_index, state.match_term,
    ]).to(torch.int32)


def unpack(vecs, log_term, log_payload) -> ReplicaState:
    return ReplicaState(
        term=vecs[_VT], voted_for=vecs[_VV], last_index=vecs[_VL],
        commit_index=vecs[_VC], match_index=vecs[_VMI],
        match_term=vecs[_VMT], log_term=log_term, log_payload=log_payload,
    )


def mk_info(out: torch.Tensor, L: int):
    """RepInfo views of a kernel output block ``match[L] | scal[5] ...``
    (leading axes, if any, are steps)."""
    from raft_tpu_torch.core.step import RepInfo

    return RepInfo(
        commit_index=out[..., L], match=out[..., :L],
        max_term=out[..., L + 1], repair_start=out[..., L + 4],
        frontier_len=out[..., L + 2],
    )


# ------------------------------------------------------- in-kernel parity
def check_lanes(M: int, Mk: int, L: int, ec_consts) -> None:
    """Windows of ``Mk = k*W`` data lanes need ``ec_consts`` [L-k, k, 8];
    full-lane windows (``Mk = M``) must not have them."""
    if (Mk != M) != (ec_consts is not None):
        raise ValueError(
            f"window lanes {Mk} vs payload lanes {M}: data-lane-only "
            "windows require ec_consts (in-kernel parity), full-lane "
            "windows must not")
    if ec_consts is not None:
        m, k, eight = ec_consts.shape
        W = M // L
        if eight != 8 or Mk != k * W or (k + m) * W != M:
            raise ValueError(
                f"ec_consts {tuple(ec_consts.shape)} do not fit {Mk} data "
                f"lanes of a {L}-row ring with {W} words per row")


def encode_parity_lanes_plain(win: torch.Tensor, ec_consts,
                              W: int) -> torch.Tensor:
    """The plain in-kernel parity: i32[..., k*W] data lanes -> i32[...,
    (k+m)*W] full lanes, parity block p the GF(2^8) combination of the k
    data blocks (``step_pallas._encode_parity_lanes``, byte for byte)."""
    lead, Mk = win.shape[:-1], win.shape[-1]
    k = Mk // W
    m = ec_consts.shape[0]
    src = win.contiguous().view(torch.uint8).reshape(-1, k, 4 * W)
    parity = apply_bits_plain(ec_consts, src.permute(1, 0, 2))
    words = parity.permute(1, 0, 2).contiguous().view(torch.int32)
    return torch.cat([win, words.reshape(*lead, m * W)], dim=-1)


def _ec_table(ec_consts, device):
    """The parity table as a device u8 tensor (cached per device)."""
    key = (str(torch.device(device)), ec_consts.tobytes(), ec_consts.shape)
    if key not in _ec_tables:
        _ec_tables[key] = torch.from_numpy(
            np.array(ec_consts, dtype=np.uint8)).to(device)
    return _ec_tables[key]


def _full_lanes(win, ec_consts, log_term, log_payload):
    """The windows the plain versions merge: as given, or parity-expanded."""
    if ec_consts is None:
        return win
    W = log_payload.shape[1] // log_term.shape[0]
    return encode_parity_lanes_plain(win, ec_consts, W)


# ------------------------------------------------------------ plain core
class _Plan(NamedTuple):
    count: int
    ws: int
    s: int
    lcur: bool
    acc: list
    heard: list
    meff: list
    prev_ts: list


def _prologue(v, cnt, prev_ts, alive, slow, prm: StepParams, C, B) -> _Plan:
    L = len(v[0])
    last0, commit0, term0 = (v[r][prm.leader] for r in (_VL, _VC, _VT))
    legit = prm.lterm >= 1
    lcur = legit and term0 <= prm.lterm
    room = C - (last0 - commit0)
    count = min(min(max(cnt, 0), B), max(room, 0)) if lcur else 0
    ws = last0 + 1
    leader_last = last0 + count
    prev_term = prm.fpt if ws - 1 < prm.rfloor else prev_ts[prm.leader]
    if ws == 1:
        prev_term = 0
    acc, heard, meff = [], [], []
    for l in range(L):
        has_prev = ws == 1 or (v[_VL][l] >= ws - 1 and prev_ts[l] == prev_term)
        h = bool(alive[l]) and legit and prm.lterm >= v[_VT][l]
        ingest = prm.leader == l and lcur
        m0 = v[_VMI][l] if v[_VMT][l] == prm.lterm else 0
        if ingest:
            m0 = leader_last
        acc.append((h and not slow[l] and has_prev) or ingest)
        heard.append(h)
        meff.append(m0)
    return _Plan(count, ws, (ws - 1) % C, lcur, acc, heard, meff,
                 list(prev_ts))


def _quorum(member, prm: StepParams) -> int:
    if member is None:
        return prm.quorum
    return max(sum(bool(m) for m in member) // 2 + 1, prm.ec_floor)


def _epilogue(v, pl: _Plan, mm, alive, slow, member, prm: StepParams, C):
    """In place on the list-of-lists ``v``; returns (match, scal)."""
    L = len(v[0])
    legit = prm.lterm >= 1
    we = pl.ws + pl.count - 1
    meffs, match = [], []
    for l in range(L):
        last0 = v[_VL][l]
        if pl.acc[l]:
            v[_VL][l] = max(we, pl.ws - 1) if mm[l] else max(last0, we)
        m1 = max(pl.meff[l], we) if pl.acc[l] else pl.meff[l]
        meffs.append(m1)
        ack = alive[l] and (member is None or member[l])
        match.append(m1 if ack else 0)
    q = _quorum(member, prm)
    cand = 0
    for l in range(L):
        cnt = sum(match[j] >= match[l] for j in range(L))
        cand = max(cand, match[l] if cnt >= q else 0)
    commit_ok = legit and cand >= 1 and cand >= prm.tfloor
    lcommit = v[_VC][prm.leader]
    g = max(lcommit, cand) if commit_ok else lcommit
    max_term = 0
    for l in range(L):
        h = pl.heard[l]
        ingest = prm.leader == l and pl.lcur
        t0 = v[_VT][l]
        t1 = max(t0, prm.lterm) if h else t0
        v[_VT][l] = t1
        if h and prm.lterm > t0:
            v[_VV][l] = NO_VOTE
        my_commit = g if prm.leader == l else min(g, meffs[l])
        if (h and not slow[l]) or ingest:
            v[_VC][l] = max(v[_VC][l], my_commit)
        if h or ingest:
            v[_VMI][l] = meffs[l]
            v[_VMT][l] = prm.lterm
        max_term = max(max_term, t1 if alive[l] else 0)
    return match, [g, max_term, pl.count, (pl.ws - 1 + pl.count) % C, 0]


def _masks(alive, slow, member):
    return (alive.tolist(), slow.tolist(),
            None if member is None else member.tolist())


def _plain_step(v, log_payload, log_term, win, cnt, masks, prm, C):
    """One plain steady step on the host list ``v``; returns
    (match, scal, next_prev)."""
    alive, slow, member = masks
    B = win.shape[0]
    prev_slot = (max(v[_VL][prm.leader], 1) - 1) % C
    prev_ts = log_term[:, prev_slot].tolist()
    pl = _prologue(v, cnt, prev_ts, alive, slow, prm, C, B)
    dev = log_term.device
    last = torch.tensor(v[_VL], dtype=torch.int32, device=dev)
    mm = write_window_both_plain(
        log_payload, log_term, win,
        torch.full((B,), prm.lterm, dtype=torch.int32, device=dev),
        pl.s, pl.count, pl.ws,
        torch.tensor(pl.acc, dtype=torch.bool, device=dev), last,
    ).tolist()
    match, scal = _epilogue(v, pl, mm, alive, slow, member, prm, C)
    if pl.count > 0:
        nxt = log_term[:, (pl.s + pl.count - 1) % C].tolist()
    else:
        nxt = pl.prev_ts
    return match, scal, nxt


def steady_step_plain(vecs, log_payload, log_term, win, count, alive, slow,
                      member, prm: StepParams, out, ec_consts=None) -> None:
    """The plain version of K2 (same arguments and outputs)."""
    L, C = log_term.shape
    check_lanes(log_payload.shape[1], win.shape[1], L, ec_consts)
    win = _full_lanes(win, ec_consts, log_term, log_payload)
    v = vecs.tolist()
    match, scal, nxt = _plain_step(v, log_payload, log_term, win, int(count),
                                   _masks(alive, slow, member), prm, C)
    vecs.copy_(torch.tensor(v, dtype=torch.int32))
    out.copy_(torch.tensor(match + scal + nxt, dtype=torch.int32))


def pipeline_flight_plain(vecs, log_payload, log_term, wins, counts, alive,
                          slow, member, prm: StepParams, br, turnover_ok,
                          out, work, ec_consts=None) -> None:
    """The plain version of K3: decide the turnover branch (publishing it
    in ``work`` as the kernel does) or run the T steps."""
    L, C = log_term.shape
    P, B, Mk = wins.shape
    check_lanes(log_payload.shape[1], Mk, L, ec_consts)
    T = counts.shape[0]
    s0, prev0 = start_slot_and_prev(vecs, log_term, prm.leader, C, L)
    turnover = False
    if turnover_ok:
        params, masks = params_and_masks(prm, alive, slow, member)
        feasible, accept0 = launch_feasibility(
            vecs, masks, params, prev0, counts, s0, br, B, L, prm.leader,
            prm.lterm, prm.rfloor, prm.fpt)
        turnover = bool(feasible) and bool(accept0.all())
    work[WK_PLAN] = int(turnover)
    work[WK_S0] = int(s0)
    if turnover:
        return
    wins = _full_lanes(wins, ec_consts, log_term, log_payload)
    v = vecs.tolist()
    masks = _masks(alive, slow, member)
    cnts = counts.tolist()
    for t in range(T):
        match, scal, _ = _plain_step(v, log_payload, log_term, wins[t % P],
                                     cnts[t], masks, prm, C)
    work[WK_RAN3] += 1
    vecs.copy_(torch.tensor(v, dtype=torch.int32))
    out.copy_(torch.tensor(match + scal, dtype=torch.int32))


def turnover_flight_plain(vecs, log_payload, log_term, wins, T, prm,
                          out, work, ec_consts=None) -> None:
    """The plain version of K4: step t writes every lane of slots
    [s0 + t*B, s0 + (t+1)*B) mod C (later steps overwrite earlier laps),
    every term slot becomes the leader's term, and the bookkeeping is the
    closed form of ``step_pallas.py:1161-1186``."""
    L, C = log_term.shape
    check_lanes(log_payload.shape[1], wins.shape[2], L, ec_consts)
    if int(work[WK_PLAN]) == 0:
        return
    wins = _full_lanes(wins, ec_consts, log_term, log_payload)
    P, B, _ = wins.shape
    s0 = int(work[WK_S0])
    j = torch.arange(B, device=log_payload.device, dtype=torch.int64)
    for t in range(T):
        log_payload.index_copy_(0, (s0 + t * B + j) % C, wins[t % P])
    log_term.fill_(prm.lterm)
    v = vecs.tolist()
    we = 0
    for _ in range(T):
        we = v[_VL][0] + B
        commit_ok = prm.lterm >= 1 and we >= 1 and we >= prm.tfloor
        for l in range(L):
            t0 = v[_VT][l]
            if prm.lterm > t0:
                v[_VV][l] = NO_VOTE
            v[_VT][l] = max(t0, prm.lterm)
            v[_VL][l] = v[_VMI][l] = we
            v[_VMT][l] = prm.lterm
            if commit_ok:
                v[_VC][l] = we
    work[WK_RAN4] += 1
    vecs.copy_(torch.tensor(v, dtype=torch.int32))
    scal = [v[_VC][0], max(v[_VT][0], prm.lterm), B, we % C, 0]
    out.copy_(torch.tensor(v[_VMI] + scal, dtype=torch.int32))


# ----------------------------------------------------------- JAX helpers
def start_slot_and_prev(vecs, log_term, leader, cap, L):
    """Window start slot and the prev-term column i32[L, 1] of a leader
    (``step_pallas._start_slot_and_prev``), as host int and tensor."""
    ws = int(vecs[_VL, leader]) + 1
    s = (ws - 1) % cap
    prev_slot = (max(ws - 1, 1) - 1) % cap
    return s, log_term[:, prev_slot:prev_slot + 1].to(torch.int32)


def params_and_masks(prm: StepParams, alive, slow, member):
    """The JAX kernels' params (1, 7) and masks (3, L) operands (the
    resident layout: no mesh row, so _MYROW is -1)."""
    if member is None:
        quorum, ackm = prm.quorum, alive
    else:
        quorum = _quorum(member.tolist(), prm)
        ackm = alive & member
    params = torch.tensor([[prm.leader, prm.lterm, prm.tfloor, prm.rfloor,
                            prm.fpt, quorum, -1]],
                          dtype=torch.int32, device=alive.device)
    masks = torch.stack([alive, slow, ackm]).to(torch.int32)
    return params, masks


def launch_feasibility(vecs, masks, params, prev0, counts, s0, BR, B, L,
                       leader, leader_term, repair_floor, floor_prev_term):
    """``step_pallas._launch_feasibility`` on torch tensors: whether a
    flight may run as one saturated launch, and the launch-time accept
    set. ``s0`` is the start slot (int or a one-element tensor)."""
    s0 = int(s0[0]) if isinstance(s0, torch.Tensor) else int(s0)
    last0_l = vecs[_VL, leader]
    commit0_l = vecs[_VC, leader]
    term0_l = vecs[_VT, leader]
    lterm = int(leader_term)
    leader_current = (lterm >= 1) & (term0_l <= lterm)
    ws0 = last0_l + 1
    prev_term = torch.where(ws0 - 1 < int(repair_floor),
                            int(floor_prev_term), prev0[leader, 0])
    prev_term = torch.where(ws0 == 1, 0, prev_term)
    rows = torch.arange(L, device=vecs.device)
    accept0 = (
        (masks[_MAL] != 0) & (masks[_MSL] == 0) & (masks[_MAK] != 0)
        & (lterm >= vecs[_VT]) & (vecs[_VL] == last0_l)
        & ((ws0 == 1) | (prev0[:, 0] == prev_term))
    ) | ((rows == int(leader)) & (masks[_MAK] != 0))
    quorum = params[0, _QUORUM]
    feasible = (
        leader_current
        & (commit0_l == last0_l)
        & (s0 % BR == 0)
        & bool((counts == B).all())
        & (accept0.to(torch.int32).sum() >= quorum)
    )
    return feasible, accept0


# ------------------------------------------------------------- wrappers
def _bool_mask(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and x.device == torch.device(device) \
            and x.dtype == torch.bool:
        return x.contiguous()
    return torch.as_tensor(x).to(device=device, dtype=torch.bool).contiguous()


def _check_rings(vecs, log_payload, log_term, L):
    if L > 32:
        raise ValueError(f"the CUDA kernels take at most 32 rows, got {L}")
    for name, t in (("vecs", vecs), ("log_payload", log_payload),
                    ("log_term", log_term)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def steady_step(vecs, log_payload, log_term, win, count, alive, slow,
                member, prm: StepParams, out, ec_consts=None) -> None:
    """K2: one steady step in place on ``vecs`` (6, L) and both rings.
    ``count``: host int, or a one-element device tensor (a scan passes a
    view of its counts). Writes ``out`` = match[L] | {commit, max_term,
    frontier_len, next start slot, repair_start} | next_prev[L]. With
    ``ec_consts`` the window carries data lanes only (parity mode)."""
    if not log_payload.is_cuda:
        steady_step_plain(vecs, log_payload, log_term, win, count, alive,
                          slow, member, prm, out, ec_consts)
        return
    L, C = log_term.shape
    M = log_payload.shape[1]
    B, Mk = win.shape
    check_lanes(M, Mk, L, ec_consts)
    _check_rings(vecs, log_payload, log_term, L)
    ec = None if ec_consts is None else _ec_table(ec_consts, vecs.device)
    if isinstance(count, torch.Tensor):
        count = count.to(device=vecs.device, dtype=torch.int32).contiguous()
        cnt_ptr, cnt_val = count.data_ptr(), 0
    else:
        cnt_ptr, cnt_val = 0, int(count)
    rc = cuda_build.lib("steady").rt_steady_step(
        vecs.data_ptr(), log_payload.data_ptr(), log_term.data_ptr(),
        win.data_ptr(), cnt_ptr, cnt_val, alive.data_ptr(), slow.data_ptr(),
        _ptr(member), *prm, L, C, B, M, Mk, out.data_ptr(),
        workspace(vecs.device).data_ptr(), _ptr(ec),
        int(ec is None and vec4_ok(M, L, log_payload, win)),
        cuda_build.stream_of(vecs))
    cuda_build.check("steady", rc, "steady_step")
    LAUNCHES["steady_step" if ec is None else "steady_step_ec"] += 1


def pipeline_flight(vecs, log_payload, log_term, wins, counts, alive, slow,
                    member, prm: StepParams, br: int, turnover_ok: bool,
                    out, ec_consts=None) -> int:
    """K3: a T-step flight over ``wins`` [P, B, M] (step t reads
    wins[t % P]) and device ``counts`` [T], in place. With ``turnover_ok``
    it first decides on the device whether the flight belongs to K4 and,
    if so, publishes that and does nothing else. Writes ``out`` =
    match[L] | scal[5] when it runs the flight. Returns the kernel's grid
    size in blocks (0 for the plain version)."""
    work = workspace(vecs.device)
    if not log_payload.is_cuda:
        pipeline_flight_plain(vecs, log_payload, log_term, wins, counts,
                              alive, slow, member, prm, br, turnover_ok,
                              out, work, ec_consts)
        return 0
    import ctypes

    L, C = log_term.shape
    M = log_payload.shape[1]
    P, B, Mk = wins.shape
    T = counts.shape[0]
    check_lanes(M, Mk, L, ec_consts)
    _check_rings(vecs, log_payload, log_term, L)
    ec = None if ec_consts is None else _ec_table(ec_consts, vecs.device)
    grid = ctypes.c_int(0)
    rc = cuda_build.lib("steady").rt_steady_pipeline(
        vecs.data_ptr(), log_payload.data_ptr(), log_term.data_ptr(),
        wins.data_ptr(), counts.data_ptr(), T, P, alive.data_ptr(),
        slow.data_ptr(), _ptr(member), *prm, L, C, B, M, Mk, int(br),
        int(turnover_ok), out.data_ptr(), work.data_ptr(), _ptr(ec),
        int(ec is None and vec4_ok(M, L, log_payload, wins)),
        cuda_build.stream_of(vecs), ctypes.byref(grid))
    cuda_build.check("steady", rc, "pipeline_flight")
    LAUNCHES["pipeline_flight" if ec is None else "pipeline_flight_ec"] += 1
    return grid.value


def turnover_flight(vecs, log_payload, log_term, wins, T: int,
                    prm: StepParams, out, ec_consts=None) -> None:
    """K4: the write-only turnover flight. Runs only behind a
    ``pipeline_flight`` launched with ``turnover_ok`` on the same stream,
    and does its work only when that launch chose it."""
    work = workspace(vecs.device)
    if not log_payload.is_cuda:
        turnover_flight_plain(vecs, log_payload, log_term, wins, T, prm,
                              out, work, ec_consts)
        return
    L, C = log_term.shape
    M = log_payload.shape[1]
    P, B, Mk = wins.shape
    check_lanes(M, Mk, L, ec_consts)
    _check_rings(vecs, log_payload, log_term, L)
    ec = None if ec_consts is None else _ec_table(ec_consts, vecs.device)
    rc = cuda_build.lib("steady").rt_turnover(
        vecs.data_ptr(), log_payload.data_ptr(), log_term.data_ptr(),
        wins.data_ptr(), T, P, prm.lterm, prm.tfloor, L, C, B, M, Mk,
        out.data_ptr(), work.data_ptr(), _ptr(ec),
        int(ec is None and vec4_ok(M, L, log_payload, wins)),
        cuda_build.stream_of(vecs))
    cuda_build.check("steady", rc, "turnover_flight")
    LAUNCHES["turnover_flight" if ec is None else "turnover_flight_ec"] += 1


# ------------------------------------------------------ public functions
def _prepare(state, leader, leader_term, term_floor, repair_floor,
             floor_prev_term, alive, slow, member, commit_quorum, ec):
    dev = state.device
    L = state.term.shape[0]
    prm = step_params(leader, leader_term, term_floor, repair_floor,
                      floor_prev_term, commit_quorum, L, ec=ec)
    alive = _bool_mask(alive, dev)
    slow = _bool_mask(slow, dev)
    member = None if member is None else _bool_mask(member, dev)
    return prm, alive, slow, member


def steady_replicate_step(state: ReplicaState, client_payload, client_count,
                          leader, leader_term, alive, slow, floor_prev_term,
                          repair_floor, member, term_floor,
                          commit_quorum=None, ec=False, ec_consts=None):
    """One steady-state replication step (``steady_replicate_step_tpu``):
    the same (state, RepInfo) as ``core.step.replicate_step(repair=False)``
    given a correct ``term_floor``. ``ec_consts`` selects the in-kernel
    parity mode (data-lane windows; implies ``ec``). Consumes ``state``."""
    L = state.term.shape[0]
    prm, alive, slow, member = _prepare(
        state, leader, leader_term, term_floor, repair_floor,
        floor_prev_term, alive, slow, member, commit_quorum,
        ec or ec_consts is not None)
    vecs = pack(state)
    out = torch.empty(2 * L + 5, dtype=torch.int32, device=state.device)
    steady_step(vecs, state.log_payload, state.log_term,
                client_payload.to(state.device).contiguous(), client_count,
                alive, slow, member, prm, out, ec_consts)
    return unpack(vecs, state.log_term, state.log_payload), mk_info(out, L)


def steady_scan_replicate(state: ReplicaState, payloads, counts, leader,
                          leader_term, alive, slow, floor_prev_term,
                          repair_floor, member, term_floor,
                          commit_quorum=None, ec=False, ec_consts=None):
    """T steady steps (``steady_scan_replicate_tpu``): T back-to-back K2
    launches on the packed state, no host work in between. Returns the
    stacked RepInfo (fields with a leading [T] axis). ``ec_consts`` as in
    ``steady_replicate_step``. Consumes ``state``."""
    L = state.term.shape[0]
    dev = state.device
    prm, alive, slow, member = _prepare(
        state, leader, leader_term, term_floor, repair_floor,
        floor_prev_term, alive, slow, member, commit_quorum,
        ec or ec_consts is not None)
    payloads = payloads.to(dev).contiguous()
    counts = torch.as_tensor(counts).to(device=dev, dtype=torch.int32)
    T = counts.shape[0]
    vecs = pack(state)
    outs = torch.zeros(T, 2 * L + 5, dtype=torch.int32, device=dev)
    for t in range(T):
        steady_step(vecs, state.log_payload, state.log_term, payloads[t],
                    counts[t:t + 1], alive, slow, member, prm, outs[t],
                    ec_consts)
    return unpack(vecs, state.log_term, state.log_payload), mk_info(outs, L)


def steady_pipeline(state: ReplicaState, wins, counts, leader, leader_term,
                    alive, slow, floor_prev_term, repair_floor, member,
                    term_floor, commit_quorum=None, ec=False,
                    ec_consts=None):
    """T saturated steady steps as one flight (``steady_pipeline_tpu``):
    K3, then K4 when ``T*B >= C``; the device decides which one writes
    (K4 only when every row accepts). ``ec_consts`` as in
    ``steady_replicate_step``. Returns (state, final RepInfo). Consumes
    ``state``."""
    L, C = state.log_term.shape
    dev = state.device
    prm, alive, slow, member = _prepare(
        state, leader, leader_term, term_floor, repair_floor,
        floor_prev_term, alive, slow, member, commit_quorum,
        ec or ec_consts is not None)
    wins = wins.to(dev).contiguous()
    counts = torch.as_tensor(counts).to(device=dev, dtype=torch.int32)
    P, B, _ = wins.shape
    T = counts.shape[0]
    if T < 1:
        raise ValueError("a flight needs at least one step")
    turnover_ok = T * B >= C
    vecs = pack(state)
    out = torch.empty(L + 5, dtype=torch.int32, device=dev)
    pipeline_flight(vecs, state.log_payload, state.log_term, wins, counts,
                    alive, slow, member, prm, pick_br(B, C), turnover_ok,
                    out, ec_consts)
    if turnover_ok:
        turnover_flight(vecs, state.log_payload, state.log_term, wins, T,
                        prm, out, ec_consts)
    return unpack(vecs, state.log_term, state.log_payload), mk_info(out, L)
