"""Kernels K2-K4: the steady replication data plane (port of
``raft_tpu/core/step_pallas.py``, resident layout).

- K2 ``steady_step`` — one whole steady step (``_invoke`` :404 /
  ``_steady_kernel`` :145): prologue (frontier room, backpressure,
  heard/accept/verified-match masks), window merge with the §5.3 check,
  epilogue (last/match/commit advance, term adoption with vote reset, the
  k-th-order quorum commit behind the ``term_floor`` gate). It also emits
  the next window's start slot and prev-term column.
- K3 ``pipeline_flight`` — T steady steps as one flight (``_run_pipeline``
  :1045 / ``_steady_pipeline_kernel`` :664), in two launches: a one-block
  plan (the scalar core and the term-ring merge, step by step, and a
  per-step record) and a writer that stores each payload destination from
  the last step that covers it and accepts its row. Each step runs at its
  true start slot, so the flight equals the per-step scan for every input.
- K4 ``turnover_flight`` — the write-only all-accept flight that turns the
  ring over (``_run_turnover`` :1189 / ``_turnover_kernel`` :1130).

With ``my_row >= 0`` each kernel runs in its mesh-local mode (K2·mesh,
K3·mesh, K4·mesh: the ``local=True`` branches, ``step_pallas.py:217``,
:245, :268, :292, :361, :751, :775, :816, :1155), driven by
``core.step_mesh``. The (6, R) state block is the plane gathered from
every rank, and the scalar core runs over all R rows of it as before; the
rings hold the local row only (payload [C, W], terms [1, C]). The merge
writes the local row where it accepts and reads no old term; the §5.3
conflict bit and the next prev-term column are replaced by their closed
forms (an accepting row's tail is exactly the window end; the next prev
term is the leader's term for accepting rows and -1 for the rest), which
hold under the engine's steady-program invariants (``core.step_mesh``).
The prev-term column comes in as an operand (``prev`` [R]) instead of from
the ring. The mesh takes the turnover decision on the host, so K3·mesh
never decides and K4·mesh takes its start slot from the caller. No parity
mode: mesh windows arrive pre-encoded.

With ``ec_consts`` (the [m, k, 8] table of ``ec.kernels.parity_consts``)
each kernel runs in its in-kernel RS parity mode (K2-4·ec,
``_encode_parity_lanes`` :93): the windows carry only the k data-lane
blocks (``Mk = k*W`` lanes) and the merge computes the m parity lane
blocks. Full-lane windows must come without it; any other combination
raises, as ``step_pallas.py:974-978`` does.

Each wrapper launches its CUDA kernels (``csrc/steady.cu``, whose header
states the design and the bound) for CUDA tensors and runs its plain
version, in this module, for CPU tensors. The six [L] state vectors travel
packed as one (6, L) int32 block that the kernels update in place, as do
the two rings: a state handed to these functions is consumed.

Host scalars (leader, terms, floors, quorum) go to the kernels by value;
masks and counts stay on the device. On the resident layout the branch
between K3 and K4 is taken on the device (K3's plan publishes it in the
workspace, K3's writer and K4 read it), so a flight costs three launches
and no host read.

The flight's two phases also have plain versions of their own,
``pipeline_plan_plain`` (returning the per-step record) and
``pipeline_write_plain``: the tests and ``chip_smoke.py`` hold the split
against ``pipeline_flight_plain``; nothing on the main path calls them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch import cuda_build
from raft_tpu_torch.core.ring_cuda import (
    vec2_ok,
    vec4_ok,
    write_window_both_plain,
    write_window_terms_plain,
)
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
# fields of the flight plan's per-step record: the window's start slot,
# its count, the accept mask (bit l = row l) and the flight position of
# its first row (step t covers positions [pos, pos + count), slot
# (s_0 + position) mod C)
REC_S, REC_N, REC_ACC, REC_POS = range(4)

#: kernel launches, counted where each wrapper launches its kernel; the
#: in-kernel parity mode counts under its own ``*_ec`` keys
LAUNCHES = {"steady_step": 0, "pipeline_flight": 0, "turnover_flight": 0,
            "steady_step_ec": 0, "pipeline_flight_ec": 0,
            "turnover_flight_ec": 0, "steady_step_mesh": 0,
            "pipeline_flight_mesh": 0, "turnover_flight_mesh": 0}

_workspaces: dict = {}
_ec_tables: dict = {}
_records: dict = {}


def workspace(device) -> torch.Tensor:
    """The per-device int32 scratch words the steady kernels share (zero
    between calls except the plan and the executed-flight counters)."""
    key = str(torch.device(device))
    if key not in _workspaces:
        _workspaces[key] = torch.zeros(_WORK_WORDS, dtype=torch.int32,
                                       device=device)
    return _workspaces[key]


def plan_record(device, T: int) -> torch.Tensor:
    """The plan kernel's per-step record, int32[T, 4]: a view of a
    per-device buffer that grows with T, rewritten by every flight."""
    key = str(torch.device(device))
    buf = _records.get(key)
    if buf is None or buf.shape[0] < T:
        buf = _records[key] = torch.empty(max(T, 64), 4, dtype=torch.int32,
                                          device=device)
    return buf[:T]


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


def shape_ok(C: int, B: int) -> bool:
    """The JAX kernels' shape gate (``ring._pallas_ok`` without its
    backend test): 128-row blocks dividing both the window and the ring.
    The engine's single-launch flight gate keeps it, so both engines take
    the flight on the same shapes."""
    return B % 128 == 0 and C % 128 == 0


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
    """In place on the list-of-lists ``v``; returns (match, scal). ``mm``
    None is the mesh-local mode: an accepting row's tail is the window end
    (``step_pallas.py:292-298``)."""
    L = len(v[0])
    legit = prm.lterm >= 1
    we = pl.ws + pl.count - 1
    meffs, match = [], []
    for l in range(L):
        last0 = v[_VL][l]
        if mm is None:
            if pl.acc[l] and pl.count > 0:
                v[_VL][l] = we
        elif pl.acc[l]:
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


def _plain_step(v, log_payload, log_term, win, cnt, masks, prm, C, B,
                my=-1, prev_ts=None):
    """One plain steady step on the host list ``v``; returns
    (pl, match, scal, next_prev). ``my >= 0`` is the mesh-local mode: the
    rings hold row ``my`` only and ``prev_ts`` is every row's prev term.
    With ``log_payload`` None only the term ring is merged (the plan)."""
    alive, slow, member = masks
    if my < 0:
        prev_slot = (max(v[_VL][prm.leader], 1) - 1) % C
        prev_ts = log_term[:, prev_slot].tolist()
    pl = _prologue(v, cnt, prev_ts, alive, slow, prm, C, B)
    dev = log_term.device
    rows = [my] if my >= 0 else range(len(v[0]))
    merge = (pl.s, pl.count, pl.ws,
             torch.tensor([pl.acc[l] for l in rows], dtype=torch.bool,
                          device=dev),
             torch.tensor([v[_VL][l] for l in rows], dtype=torch.int32,
                          device=dev))
    terms = torch.full((B,), prm.lterm, dtype=torch.int32, device=dev)
    if log_payload is None:
        mm = write_window_terms_plain(log_term, terms, *merge).tolist()
    else:
        mm = write_window_both_plain(log_payload, log_term, win, terms,
                                     *merge).tolist()
    if my >= 0:
        # closed forms (step_pallas.py:292-298, :361-373): no conflict
        # bit, and the next prev column without reading other rows' terms
        match, scal = _epilogue(v, pl, None, alive, slow, member, prm, C)
        if pl.count > 0:
            nxt = [prm.lterm if a else -1 for a in pl.acc]
        else:
            nxt = pl.prev_ts
        return pl, match, scal, nxt
    match, scal = _epilogue(v, pl, mm, alive, slow, member, prm, C)
    if pl.count > 0:
        nxt = log_term[:, (pl.s + pl.count - 1) % C].tolist()
    else:
        nxt = pl.prev_ts
    return pl, match, scal, nxt


def steady_step_plain(vecs, log_payload, log_term, win, count, alive, slow,
                      member, prm: StepParams, out, ec_consts=None,
                      my_row=-1, prev=None) -> None:
    """The plain version of K2 (same arguments and outputs), and of
    K2·mesh with ``my_row >= 0``."""
    C = log_term.shape[1]
    check_lanes(log_payload.shape[1], win.shape[1], log_term.shape[0],
                ec_consts)
    win = _full_lanes(win, ec_consts, log_term, log_payload)
    v = vecs.tolist()
    _, match, scal, nxt = _plain_step(
        v, log_payload, log_term, win, int(count),
        _masks(alive, slow, member), prm, C, win.shape[0], my_row,
        None if prev is None else prev.tolist())
    vecs.copy_(torch.tensor(v, dtype=torch.int32))
    out.copy_(torch.tensor(match + scal + nxt, dtype=torch.int32))


def _decide(vecs, log_term, counts, alive, slow, member, prm, br,
            turnover_ok, B, work, my_row, prev):
    """A flight's start: whether it belongs to K4 (the launch-feasibility
    predicate and every row accepting; the resident layout only, as the
    mesh decides on the host), published in ``work`` with the start slot
    as the plan kernel does. Returns (turnover, the prev-term column
    [L, 1])."""
    L, C = vecs.shape[1], log_term.shape[1]
    if my_row >= 0:
        if turnover_ok:
            raise ValueError("the mesh takes the turnover decision on the "
                             "host: K3·mesh runs with turnover_ok=False")
        s0, prev0 = int(vecs[_VL, prm.leader]) % C, prev.reshape(L, 1)
    else:
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
    return turnover, prev0


def pipeline_flight_plain(vecs, log_payload, log_term, wins, counts, alive,
                          slow, member, prm: StepParams, br, turnover_ok,
                          out, work, ec_consts=None, my_row=-1,
                          prev=None) -> None:
    """The plain version of K3: decide the turnover branch (publishing it
    in ``work`` as the kernel does) or run the T steps in order; K3·mesh
    with ``my_row >= 0``, the prev column carried step to step in closed
    form."""
    C = log_term.shape[1]
    P, B, Mk = wins.shape
    check_lanes(log_payload.shape[1], Mk, log_term.shape[0], ec_consts)
    turnover, prev0 = _decide(vecs, log_term, counts, alive, slow, member,
                              prm, br, turnover_ok, B, work, my_row, prev)
    if turnover:
        return
    wins = _full_lanes(wins, ec_consts, log_term, log_payload)
    v = vecs.tolist()
    masks = _masks(alive, slow, member)
    prev_ts = prev0[:, 0].tolist()
    for t, cnt in enumerate(counts.tolist()):
        _, match, scal, prev_ts = _plain_step(
            v, log_payload, log_term, wins[t % P], cnt, masks, prm, C, B,
            my_row, prev_ts)
    work[WK_RAN3] += 1
    vecs.copy_(torch.tensor(v, dtype=torch.int32))
    out.copy_(torch.tensor(match + scal, dtype=torch.int32))


def pipeline_plan_plain(vecs, log_term, counts, B, alive, slow, member,
                        prm: StepParams, br, turnover_ok, out, work,
                        my_row=-1, prev=None):
    """The plain version of K3's plan: the turnover decision (as
    ``pipeline_flight_plain``) or the T steps' scalar core and term-ring
    merge, in place on ``vecs`` and ``log_term``, ``out`` = match[L] |
    scal[5]. Returns the per-step record int32[T, 4] (``REC_*``), or None
    when the flight belongs to K4."""
    C = log_term.shape[1]
    turnover, prev0 = _decide(vecs, log_term, counts, alive, slow, member,
                              prm, br, turnover_ok, B, work, my_row, prev)
    if turnover:
        return None
    v = vecs.tolist()
    masks = _masks(alive, slow, member)
    prev_ts = prev0[:, 0].tolist()
    record, pos = [], 0
    for cnt in counts.tolist():
        pl, match, scal, prev_ts = _plain_step(
            v, None, log_term, None, cnt, masks, prm, C, B, my_row, prev_ts)
        acc = sum(1 << l for l, a in enumerate(pl.acc) if a)
        record.append([pl.s, pl.count, acc - (1 << 32) * (acc >> 31), pos])
        pos += pl.count
    work[WK_RAN3] += 1
    vecs.copy_(torch.tensor(v, dtype=torch.int32))
    out.copy_(torch.tensor(match + scal, dtype=torch.int32))
    return torch.tensor(record, dtype=torch.int32, device=vecs.device)


def pipeline_write_plain(log_payload, log_term, wins, record, ec_consts=None,
                         my_row=-1) -> None:
    """The plain version of K3's writer: every payload destination (slot,
    row) takes the window row of the LAST step of ``record`` whose window
    covers the slot and whose accept mask holds the row; a destination no
    such step covers keeps its words. Nothing to do for a flight that went
    to K4 (``record`` None)."""
    if record is None:
        return
    C, M = log_payload.shape
    check_lanes(M, wins.shape[2], log_term.shape[0], ec_consts)
    wins = _full_lanes(wins, ec_consts, log_term, log_payload)
    P = wins.shape[0]
    rows = [my_row] if my_row >= 0 else range(log_term.shape[0])
    W = M // len(rows)
    rec = record.to(device=log_payload.device, dtype=torch.int64)
    first, acc = rec[:, REC_POS].contiguous(), rec[:, REC_ACC]
    s0 = int(rec[0, REC_S])
    N = int(rec[-1, REC_POS] + rec[-1, REC_N])
    k = torch.arange(min(N, C), device=log_payload.device)
    for i, l in enumerate(rows):
        src = torch.full_like(k, -1)          # the source flight position
        for lap in range((N - 1) // C, -1, -1):
            kk = k + lap * C
            t = torch.searchsorted(first, kk, right=True) - 1
            take = (kk < N) & (src < 0) & (((acc[t] >> l) & 1) == 1)
            src = torch.where(take, kk, src)
        hit = src >= 0
        t = torch.searchsorted(first, src[hit], right=True) - 1
        lanes = wins[t % P, src[hit] - first[t]]
        if my_row < 0:
            lanes = lanes[:, l * W:(l + 1) * W]
        log_payload[(s0 + k[hit]) % C, i * W:(i + 1) * W] = lanes


def turnover_flight_plain(vecs, log_payload, log_term, wins, T, prm,
                          out, work, ec_consts=None, s0=None) -> None:
    """The plain version of K4: step t writes every lane of slots
    [s0 + t*B, s0 + (t+1)*B) mod C (later steps overwrite earlier laps),
    every term slot becomes the leader's term, and the bookkeeping is the
    closed form of ``step_pallas.py:1161-1186``. The same for K4·mesh,
    whose term ring is the one local row and whose start slot ``s0`` the
    caller gives; otherwise the plan's decision and start slot in
    ``work``."""
    L, C = vecs.shape[1], log_term.shape[1]
    check_lanes(log_payload.shape[1], wins.shape[2], log_term.shape[0],
                ec_consts)
    if s0 is None:
        if int(work[WK_PLAN]) == 0:
            return
        s0 = int(work[WK_S0])
    wins = _full_lanes(wins, ec_consts, log_term, log_payload)
    P, B, _ = wins.shape
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


def params_and_masks(prm: StepParams, alive, slow, member, my=-1):
    """The JAX kernels' params (1, 7) and masks (3, L) operands; ``my`` is
    the mesh row (_MYROW), -1 on the resident layout."""
    if member is None:
        quorum, ackm = prm.quorum, alive
    else:
        quorum = _quorum(member.tolist(), prm)
        ackm = alive & member
    params = torch.tensor([[prm.leader, prm.lterm, prm.tfloor, prm.rfloor,
                            prm.fpt, quorum, int(my)]],
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


def _check_masks(vecs, alive, slow, member):
    """The kernels read each mask as L bytes on the card."""
    L = vecs.shape[1]
    for name, t in (("alive", alive), ("slow", slow), ("member", member)):
        if t is not None and (
                t.dtype != torch.bool or not t.is_contiguous()
                or t.shape != (L,) or t.device != vecs.device):
            raise ValueError(f"{name} must be a contiguous bool[{L}] on "
                             f"{vecs.device}")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _mode(vecs, log_term, ec_consts, my_row, prev, kind):
    """The launch counter key of a wrapper call, checking the mesh-local
    operands: the local row's one term row and an R-long prev column
    (K2·mesh and K3·mesh), and no parity table."""
    if my_row < 0:
        return kind if ec_consts is None else kind + "_ec"
    R = vecs.shape[1]
    if not 0 <= my_row < R or log_term.shape[0] != 1 or \
            ec_consts is not None:
        raise ValueError(
            f"mesh-local mode: row {my_row} of {R}, term ring "
            f"{tuple(log_term.shape)} (one row), no ec_consts")
    if kind != "turnover_flight" and (
            prev is None or prev.shape != (R,) or prev.dtype != torch.int32
            or not prev.is_contiguous() or prev.device != vecs.device):
        raise ValueError("mesh-local mode needs the prev-term column as a "
                         f"contiguous int32[{R}] on {vecs.device}")
    return kind + "_mesh"


def steady_step(vecs, log_payload, log_term, win, count, alive, slow,
                member, prm: StepParams, out, ec_consts=None, my_row=-1,
                prev=None) -> None:
    """K2: one steady step in place on ``vecs`` (6, L) and both rings.
    ``count``: host int, or a one-element device tensor (a scan passes a
    view of its counts). Writes ``out`` = match[L] | {commit, max_term,
    frontier_len, next start slot, repair_start} | next_prev[L]. With
    ``ec_consts`` the window carries data lanes only (parity mode). With
    ``my_row >= 0``, K2·mesh: the rings hold that row only and ``prev``
    is every row's prev term [L]."""
    key = _mode(vecs, log_term, ec_consts, my_row, prev, "steady_step")
    if not log_payload.is_cuda:
        steady_step_plain(vecs, log_payload, log_term, win, count, alive,
                          slow, member, prm, out, ec_consts, my_row, prev)
        return
    L, C = vecs.shape[1], log_term.shape[1]
    M = log_payload.shape[1]
    B, Mk = win.shape
    check_lanes(M, Mk, log_term.shape[0], ec_consts)
    _check_rings(vecs, log_payload, log_term, L)
    _check_masks(vecs, alive, slow, member)
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
        _lane_width(ec, M, log_term.shape[0], M // log_term.shape[0],
                    log_payload, win),
        int(my_row), _ptr(prev), cuda_build.stream_of(vecs))
    cuda_build.check("steady", rc, key)
    LAUNCHES[key] += 1


def _lane_width(ec, M, L, W, *tensors) -> int:
    """The kernels' vector width: 16-byte lane vectors (4) or single
    words; in the parity mode, word pairs (2) or single words."""
    if ec is not None:
        return 2 if vec2_ok(W, *tensors) else 1
    return 4 if vec4_ok(M, L, *tensors) else 1


def _check_index_range(C, M, wins):
    if C * M >= 2 ** 31 or wins.numel() >= 2 ** 31:
        raise ValueError("the flight kernels index the rings and windows "
                         "in 32 bits")


def pipeline_flight(vecs, log_payload, log_term, wins, counts, alive, slow,
                    member, prm: StepParams, br: int, turnover_ok: bool,
                    out, ec_consts=None, my_row=-1, prev=None):
    """K3: a T-step flight over ``wins`` [P, B, M] (step t reads
    wins[t % P]) and device ``counts`` [T], in place: the plan kernel (one
    block) and the writer behind it. With ``turnover_ok`` the plan first
    decides on the device whether the flight belongs to K4 and, if so,
    publishes that and does nothing else. Writes ``out`` = match[L] |
    scal[5] when it runs the flight. With ``my_row >= 0``, K3·mesh,
    ``prev`` the gathered prev column [L] (``steady_step``); the mesh
    decides turnover on the host, so ``turnover_ok`` must be False there.
    Returns the plan's per-step record (``plan_record``, valid until the
    next flight) on the card, None for the plain version."""
    key = _mode(vecs, log_term, ec_consts, my_row, prev, "pipeline_flight")
    work = workspace(vecs.device)
    if not log_payload.is_cuda:
        pipeline_flight_plain(vecs, log_payload, log_term, wins, counts,
                              alive, slow, member, prm, br, turnover_ok,
                              out, work, ec_consts, my_row, prev)
        return None
    L, C = vecs.shape[1], log_term.shape[1]
    M = log_payload.shape[1]
    P, B, Mk = wins.shape
    T = counts.shape[0]
    check_lanes(M, Mk, log_term.shape[0], ec_consts)
    _check_rings(vecs, log_payload, log_term, L)
    _check_masks(vecs, alive, slow, member)
    _check_index_range(C, M, wins)
    if T < 1 or (my_row >= 0 and turnover_ok):
        raise ValueError("a flight needs at least one step, and K3·mesh "
                         "runs with turnover_ok=False (the mesh takes the "
                         "turnover decision on the host)")
    ec = None if ec_consts is None else _ec_table(ec_consts, vecs.device)
    rec = plan_record(vecs.device, T)
    W = M if my_row >= 0 else M // L
    rc = cuda_build.lib("steady").rt_steady_pipeline(
        vecs.data_ptr(), log_payload.data_ptr(), log_term.data_ptr(),
        wins.data_ptr(), counts.data_ptr(), T, P, alive.data_ptr(),
        slow.data_ptr(), _ptr(member), *prm, L, C, B, M, Mk, int(br),
        int(turnover_ok), out.data_ptr(), work.data_ptr(), _ptr(ec),
        _lane_width(ec, M, log_term.shape[0], W, log_payload, wins),
        int(my_row), _ptr(prev), rec.data_ptr(), cuda_build.stream_of(vecs))
    cuda_build.check("steady", rc, key)
    LAUNCHES[key] += 1
    return rec


#: K4·mesh's parts (``csrc/steady.cu`` ``TURNOVER_*``): the payload row,
#: the term row and the bookkeeping; the main path runs all three, and
#: ``chip_smoke.py`` times each alone
TURNOVER_PAYLOAD, TURNOVER_TERMS, TURNOVER_BOOK = 1, 2, 4
TURNOVER_ALL = 7


def turnover_flight(vecs, log_payload, log_term, wins, T: int,
                    prm: StepParams, out, ec_consts=None, my_row=-1,
                    s0=None, parts=TURNOVER_ALL) -> None:
    """K4: the write-only turnover flight. On the resident layout it runs
    only behind a ``pipeline_flight`` launched with ``turnover_ok`` on the
    same stream, and does its work only when that launch chose it. With
    ``my_row >= 0``, K4·mesh (a kernel of its own): one payload row and
    one term row, from the start slot ``s0`` that the mesh's host decision
    gives, with the bookkeeping of all T steps in closed form; ``parts``
    (K4·mesh on the card only) runs a subset of its parts, for timing."""
    key = _mode(vecs, log_term, ec_consts, my_row, None, "turnover_flight")
    if (my_row >= 0) != (s0 is not None):
        raise ValueError("K4·mesh takes its start slot from the caller; "
                         "the resident K4 reads the plan's")
    if parts != TURNOVER_ALL and not (my_row >= 0 and log_payload.is_cuda):
        raise ValueError("parts selects a subset of K4·mesh on the card")
    work = workspace(vecs.device)
    if not log_payload.is_cuda:
        turnover_flight_plain(vecs, log_payload, log_term, wins, T, prm,
                              out, work, ec_consts, s0)
        return
    L, C = vecs.shape[1], log_term.shape[1]
    M = log_payload.shape[1]
    P, B, Mk = wins.shape
    check_lanes(M, Mk, log_term.shape[0], ec_consts)
    _check_rings(vecs, log_payload, log_term, L)
    _check_index_range(C, M, wins)
    lib, stream = cuda_build.lib("steady"), cuda_build.stream_of(vecs)
    if my_row >= 0:       # 16-byte vectors, word pairs or single words
        vec = 4 if vec4_ok(M, 1, log_payload, wins) else \
            2 if vec2_ok(M, log_payload, wins) else 1
        rc = lib.rt_turnover_mesh(
            vecs.data_ptr(), log_payload.data_ptr(), log_term.data_ptr(),
            wins.data_ptr(), T, P, prm.lterm, prm.tfloor, L, C, B, M,
            int(s0) % C, out.data_ptr(), work.data_ptr(), vec, int(parts),
            stream)
    else:
        ec = None if ec_consts is None else _ec_table(ec_consts,
                                                      vecs.device)
        rc = lib.rt_turnover(
            vecs.data_ptr(), log_payload.data_ptr(), log_term.data_ptr(),
            wins.data_ptr(), T, P, prm.lterm, prm.tfloor, L, C, B, M, Mk,
            out.data_ptr(), work.data_ptr(), _ptr(ec),
            _lane_width(ec, M, L, M // L, log_payload, wins), stream)
    cuda_build.check("steady", rc, key)
    LAUNCHES[key] += 1


# ------------------------------------------------------ public functions
def _prepare(state, leader, leader_term, term_floor, repair_floor,
             floor_prev_term, alive, slow, member, commit_quorum, ec,
             rows=None):
    """Host params and device masks of a call; ``rows`` is the plane width
    when it is not the state's row count (the mesh)."""
    dev = state.device
    L = state.term.shape[0] if rows is None else rows
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
                    ec_consts=None, allow_turnover=True):
    """T saturated steady steps as one flight (``steady_pipeline_tpu``):
    K3, then K4 when ``allow_turnover`` and ``T*B >= C``; the device
    decides which one writes (K4 only when every row accepts). A caller
    that expects the general regime (a slow row, spare rows) passes
    ``allow_turnover=False`` and gets K3 alone (``step_pallas.py:1016``).
    ``ec_consts`` as in ``steady_replicate_step``. Returns (state, final
    RepInfo). Consumes ``state``."""
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
    turnover_ok = bool(allow_turnover) and T * B >= C
    vecs = pack(state)
    out = torch.empty(L + 5, dtype=torch.int32, device=dev)
    pipeline_flight(vecs, state.log_payload, state.log_term, wins, counts,
                    alive, slow, member, prm, pick_br(B, C), turnover_ok,
                    out, ec_consts)
    if turnover_ok:
        turnover_flight(vecs, state.log_payload, state.log_term, wins, T,
                        prm, out, ec_consts)
    return unpack(vecs, state.log_term, state.log_payload), mk_info(out, L)
