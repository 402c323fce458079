"""Linearizability checking over recorded client histories
(port of ``raft_tpu/chaos/checker.py``, line for line).

The algorithm is Wing & Gong's exhaustive search with Lowe's
memoization (the same family Knossos/Porcupine implement): depth-first
over the choices of "which outstanding operation linearizes next",
pruning configurations — a (set of linearized ops, model state) pair —
that have already failed. An operation may be chosen next only if no
OTHER un-linearized operation *completed strictly before* it was
invoked (the real-time order linearizability must respect); reads must
match the model state, writes/deletes advance it.

Status handling (see chaos.history):

- ``fail`` ops provably took no effect and are removed up front;
- ``info`` READS constrain nothing (no result was observed) and are
  removed;
- ``info`` WRITES/DELETES keep an unbounded interval ``[invoke, inf)``:
  the search may linearize them at any admissible point or never —
  success requires only that every *completed* op is linearized.

Tractability comes from P-compositionality (Herlihy–Wing locality): a
history over independent keys is linearizable iff each key's
subhistory is against a single-register model, so ``check_history``
checks each key independently — exponential worst cases shrink from
"all ops" to "ops per key". The whole-history mode (``per_key=False``,
one dict-shaped model) exists to *validate* that optimization
(tests pin per-key == whole-history verdicts on small cases), not for
production use.

The search is budgeted: every explored configuration costs one step,
and an exhausted budget returns ``UNDETERMINED`` instead of hanging —
a torture harness must never turn a hard history into a wedged CI run.
``UNDETERMINED`` means exactly "neither a witness nor a refutation was
found within the budget".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from raft_tpu_torch.chaos.history import (
    DELETE,
    FAIL,
    INFO,
    OK,
    READ,
    History,
    OpRecord,
)

LINEARIZABLE = "LINEARIZABLE"
VIOLATION = "VIOLATION"
UNDETERMINED = "UNDETERMINED"
SERIALIZABLE = "SERIALIZABLE"        # check_serializable's passing verdict

_INF = float("inf")


@dataclasses.dataclass
class CheckResult:
    verdict: str                     # LINEARIZABLE | VIOLATION | UNDETERMINED
    steps: int                       # search configurations explored
    key: Optional[bytes] = None      # offending / exhausted key, if any
    detail: str = ""

    def __bool__(self) -> bool:
        return self.verdict == LINEARIZABLE


def _prepare(ops: Iterable[OpRecord]) -> Optional[List[OpRecord]]:
    """Drop constraint-free ops; None = history uses a PENDING op (the
    caller forgot ``History.close()``) — refuse rather than guess."""
    out = []
    for rec in ops:
        if rec.status == FAIL:
            continue                 # provably never took effect
        if rec.status == INFO and rec.op == READ:
            continue                 # result never observed: no constraint
        if rec.status not in (OK, INFO):
            return None
        out.append(rec)
    return out


def _search_key(
    ops: List[OpRecord],
    budget: int,
    state0,
    apply_op,
) -> Tuple[str, int]:
    """Budgeted WG/Lowe search over one object's subhistory.

    ``state0``/``apply_op`` parameterize the sequential model:
    ``apply_op(state, rec) -> (ok, new_state)`` — hashable states only
    (memoization keys on them). Returns (verdict, steps used)."""
    n = len(ops)
    if n == 0:
        return LINEARIZABLE, 0
    inv = [op.invoke_t for op in ops]
    ret = [op.complete_t if op.complete_t is not None else _INF
           for op in ops]
    must = 0                          # ops that MUST linearize (completed)
    for i, op in enumerate(ops):
        if op.status == OK:
            must |= 1 << i
    full = (1 << n) - 1

    seen = set()                      # failed (remaining_mask, state) configs
    steps = 0

    def candidates(remaining: int) -> List[int]:
        """Ops admissible as the next linearization point: no OTHER
        remaining op completed strictly before this one was invoked."""
        rem = [i for i in range(n) if remaining >> i & 1]
        out = []
        for i in rem:
            if all(ret[j] >= inv[i] for j in rem if j != i):
                out.append(i)
        return out

    # Explicit stack of (remaining_mask, state, candidate list, cursor):
    # recursion depth equals history length, and an explicit stack makes
    # the budget check one place instead of every call site.
    stack = [[full, state0, None, 0]]
    while stack:
        frame = stack[-1]
        remaining, state, cands, cur = frame
        if remaining & must == 0:
            return LINEARIZABLE, steps
        if cands is None:
            cands = candidates(remaining)
            frame[2] = cands
        advanced = False
        while frame[3] < len(cands):
            i = cands[frame[3]]
            frame[3] += 1
            okd, nstate = apply_op(state, ops[i])
            if not okd:
                continue
            nxt = remaining & ~(1 << i)
            if (nxt, nstate) in seen:
                continue
            steps += 1
            if steps > budget:
                return UNDETERMINED, steps
            stack.append([nxt, nstate, None, 0])
            advanced = True
            break
        if not advanced:
            seen.add((remaining, state))
            stack.pop()
    return VIOLATION, steps


def _prune_unobserved(kops: List[OpRecord]) -> List[OpRecord]:
    """Drop ``info`` writes/deletes of ONE key whose effect value no
    completed read of that key ever returned. Sound and complete for a
    register: an optional (info) op need never be linearized, and any
    valid schedule that DOES include such a write maps to a valid
    schedule without it — removing a last-writer-wins write can only
    invalidate reads that returned its value, and there are none. This
    is the pruning that keeps violation proofs tractable: without it
    every crash-lost write (unbounded interval, never observed)
    multiplies the configuration space for nothing."""
    seen = {rec.value for rec in kops if rec.op == READ and rec.status == OK}
    out = []
    for rec in kops:
        if rec.status == INFO:
            effect = None if rec.op == DELETE else rec.value
            if effect not in seen:
                continue
        out.append(rec)
    return out


def _register_apply(state, rec: OpRecord):
    """Single-key register model: state = current value (None = absent)."""
    if rec.op == READ:
        return state == rec.value, state
    if rec.op == DELETE:
        return True, None
    return True, rec.value            # WRITE


def _kv_apply(state, rec: OpRecord):
    """Whole-map model (validation mode): state = frozenset of items."""
    d = dict(state)
    if rec.op == READ:
        return d.get(rec.key) == rec.value, state
    if rec.op == DELETE:
        d.pop(rec.key, None)
    else:
        d[rec.key] = rec.value
    return True, frozenset(d.items())


def check_history(
    history,
    step_budget: int = 500_000,
    per_key: bool = True,
) -> CheckResult:
    """Check a recorded history against the KV register model.

    ``history`` is a ``chaos.History`` or a plain list of ``OpRecord``.
    ``per_key=True`` (default) exploits P-compositionality: each key's
    subhistory checks independently against a register, and the budget
    is shared across keys. Any key's violation fails the whole history;
    otherwise any budget exhaustion is ``UNDETERMINED``.
    """
    ops = history.ops if isinstance(history, History) else list(history)
    prepared = _prepare(ops)
    if prepared is None:
        raise ValueError(
            "history contains PENDING ops; call History.close() first"
        )
    total = 0
    sub: Dict[bytes, List[OpRecord]] = {}
    for rec in prepared:
        sub.setdefault(rec.key, []).append(rec)
    sub = {k: _prune_unobserved(kops) for k, kops in sub.items()}
    if not per_key:
        flat = [rec for kops in sub.values() for rec in kops]
        verdict, steps = _search_key(
            flat, step_budget, frozenset(), _kv_apply
        )
        return CheckResult(verdict, steps, detail="whole-history mode")
    exhausted: Optional[bytes] = None
    for key, kops in sorted(sub.items()):
        verdict, steps = _search_key(
            kops, step_budget - total, None, _register_apply
        )
        total += steps
        if verdict == VIOLATION:
            return CheckResult(
                VIOLATION, total, key=key,
                detail=f"key {key!r}: no linearization of "
                       f"{len(kops)} ops exists",
            )
        if verdict == UNDETERMINED and exhausted is None:
            exhausted = key
            if total >= step_budget:
                break
    if exhausted is not None:
        return CheckResult(
            UNDETERMINED, total, key=exhausted,
            detail=f"step budget ({step_budget}) exhausted",
        )
    return CheckResult(LINEARIZABLE, total)


# ------------------------------------------------- per-read-class grading
#: read classes whose contract IS linearizability: their reads enter the
#: Wing–Gong search together with every write/delete. ``session`` reads
#: deliberately do not — their contract is the weaker session model
#: below, and grading them as linearizable would either fail correct
#: runs (session reads may be stale) or, worse, grade them against
#: nothing at all.
LINEARIZABLE_READ_CLASSES = ("read_index", "lease", "follower")
SESSION_CLASS = "session"


def read_class_of(rec: OpRecord) -> Optional[str]:
    """The class a read was SERVED under (recorded by the harness on
    the OpRecord); non-reads return None, unlabeled reads default to
    ``read_index`` — the legacy single-class world."""
    if rec.op != READ:
        return None
    return getattr(rec, "read_class", None) or "read_index"


def check_read_classes(
    history,
    step_budget: int = 500_000,
) -> Dict[str, CheckResult]:
    """Grade each read class present in ``history`` against ITS OWN
    consistency model (docs/READS.md matrix) — weaker classes get their
    own verdicts, not a free pass, and stronger classes are not blamed
    for a weaker class's staleness:

    - ``read_index`` / ``lease`` / ``follower``: linearizability of the
      write history plus that class's reads (one Wing–Gong search per
      class, budget shared);
    - ``session``: per-(client, key) MONOTONE READS over the recorded
      serve indices, READ-YOUR-WRITES against the recorded session
      floor (``ryw_floor`` — the client's token at invoke time), and
      read-committed value justification (a returned value must have
      been written to that key by an op invoked before the read
      completed, or be the initial absence).

    Returns class -> :class:`CheckResult`; classes absent from the
    history are absent from the result."""
    ops = history.ops if isinstance(history, History) else list(history)
    present = {c for rec in ops
               for c in (read_class_of(rec),) if c is not None}
    results: Dict[str, CheckResult] = {}
    base = [rec for rec in ops if rec.op != READ]
    spent = 0
    for cls in [c for c in LINEARIZABLE_READ_CLASSES if c in present]:
        sub = base + [rec for rec in ops if read_class_of(rec) == cls]
        res = check_history(sub, step_budget=max(step_budget - spent, 1))
        spent += res.steps
        results[cls] = res
    if SESSION_CLASS in present:
        results[SESSION_CLASS] = _check_session(
            [rec for rec in ops
             if rec.op != READ or read_class_of(rec) == SESSION_CLASS]
        )
    return results


def _check_session(ops: List[OpRecord]) -> CheckResult:
    """The session model: completed session reads carry the harness's
    recorded ``serve_index`` (the applied index the value was read at)
    and ``ryw_floor`` (the client's session token when the read was
    invoked). Violations: a value never written to the key before the
    read completed (read-uncommitted), a serve below the client's own
    floor (read-your-writes broken), or a serve below an index the same
    client already observed for that key (monotone-reads inversion)."""
    written: Dict[bytes, List[Tuple[float, Optional[bytes]]]] = {}
    for rec in ops:
        if rec.op != READ and rec.status != FAIL:
            written.setdefault(rec.key, []).append(
                (rec.invoke_t, None if rec.op == DELETE else rec.value)
            )
    hwm: Dict[Tuple[int, bytes], int] = {}
    steps = 0
    for rec in ops:
        if rec.op != READ or rec.status != OK:
            continue
        steps += 1
        if rec.value is not None:
            # time-bounded justification: only a write INVOKED before
            # this read completed can explain the value — a value some
            # client writes later must not retroactively launder an
            # earlier dirty serve
            t_end = (rec.complete_t if rec.complete_t is not None
                     else _INF)
            if not any(v == rec.value and t_inv <= t_end
                       for t_inv, v in written.get(rec.key, ())):
                return CheckResult(
                    VIOLATION, steps, key=rec.key,
                    detail=f"session read of {rec.value!r} on key "
                           f"{rec.key!r}: value was never written "
                           "before the read completed",
                )
        idx = getattr(rec, "serve_index", None)
        if idx is None:
            continue            # value-only record: nothing more to grade
        floor = getattr(rec, "ryw_floor", 0)
        if idx < floor:
            return CheckResult(
                VIOLATION, steps, key=rec.key,
                detail=f"client {rec.client} session read served at "
                       f"index {idx} below its own token floor {floor} "
                       "(read-your-writes broken)",
            )
        mkey = (rec.client, rec.key)
        if idx < hwm.get(mkey, 0):
            return CheckResult(
                VIOLATION, steps, key=rec.key,
                detail=f"client {rec.client} session read served at "
                       f"index {idx} after already observing "
                       f"{hwm[mkey]} (monotone-reads inversion)",
            )
        hwm[mkey] = max(hwm.get(mkey, 0), idx)
    return CheckResult(LINEARIZABLE, steps,
                       detail="session model (monotone + RYW + "
                              "read-committed)")


# ------------------------------------------------- transactional checking
@dataclasses.dataclass
class TxnRecord:
    """One transaction as the serializability checker sees it.

    ``expects`` are the validation reads the coordinator certified
    UNDER THE LOCKS (key -> committed value observed, None = absent);
    ``writes`` are the staged intents (key -> new value, None =
    delete). ``status`` follows chaos.history: ``ok`` = committed with
    a known decision position, ``fail`` = aborted (provably no
    effect), ``info`` = outcome unknown (the drill resolves these from
    the replicated decision map at quiesce, so a clean run has none).
    ``pos`` is the decision record's apply position in the decision
    group — the commit-order witness."""

    txn_id: int
    writes: Dict[bytes, Optional[bytes]]
    expects: Dict[bytes, Optional[bytes]]
    status: str = OK
    pos: Optional[int] = None
    invoke_t: float = 0.0
    complete_t: Optional[float] = None


def check_serializable(
    txns: List[TxnRecord],
    final_state: Optional[Dict[bytes, bytes]] = None,
    initial: Optional[Dict[bytes, bytes]] = None,
) -> CheckResult:
    """Grade a cross-group transactional history against STRICT
    serializability by VERIFYING the system's own commit-order witness
    (the decision group's apply order) rather than searching for one.

    The witness obligates three things, and failing any is a
    ``VIOLATION`` — this checker can call the system wrong, which is
    the falsifiability contract (``--broken txn_*`` pins it):

    1. **Reads explained at the serial point** — replaying committed
       transactions in decision order, every transaction's certified
       ``expects`` must equal the model state at its position (a
       coordinator that commits after a failed prewrite, or validates
       against staged/dirty values, breaks here);
    2. **Real time respected** — a transaction that completed before
       another was invoked must hold the earlier decision position
       (strictness: the witness cannot reorder non-overlapping txns);
    3. **Atomicity at the end state** — when ``final_state`` (a
       quiesced read of every key) is supplied, the replay's end state
       must match it exactly: a half-applied commit or an aborted
       transaction's leaked write both surface as a mismatch.

    ``info`` transactions (outcome unknown) make a failed end-state
    comparison ``UNDETERMINED`` instead of ``VIOLATION`` — the missing
    effects might be theirs. A committed txn with no recorded position
    is an incomplete witness: ``UNDETERMINED``."""
    committed = [t for t in txns if t.status == OK]
    unknown = [t for t in txns if t.status == INFO]
    steps = 0
    for t in committed:
        if t.pos is None:
            return CheckResult(
                UNDETERMINED, steps,
                detail=f"txn {t.txn_id} committed without a decision "
                       "position: witness incomplete",
            )
    order = sorted(committed, key=lambda t: t.pos)
    for a, b in zip(order, order[1:]):
        if a.pos == b.pos:
            return CheckResult(
                VIOLATION, steps,
                detail=f"txns {a.txn_id} and {b.txn_id} share decision "
                       f"position {a.pos}: the witness is not an order",
            )
    # 2) strictness: completed-before implies decided-before
    for i, a in enumerate(order):
        for b in order[i + 1:]:
            steps += 1
            if (b.complete_t is not None
                    and b.complete_t < a.invoke_t):
                return CheckResult(
                    VIOLATION, steps,
                    detail=f"txn {b.txn_id} completed at "
                           f"{b.complete_t:.3f} before txn {a.txn_id} "
                           f"was invoked at {a.invoke_t:.3f}, but "
                           f"decided later (pos {b.pos} > {a.pos})",
                )
    # 1) replay the witness
    state: Dict[bytes, Optional[bytes]] = dict(initial or {})
    for t in order:
        for k in sorted(t.expects):
            steps += 1
            if state.get(k) != t.expects[k]:
                return CheckResult(
                    VIOLATION, steps, key=k,
                    detail=f"txn {t.txn_id} (pos {t.pos}) certified "
                           f"{t.expects[k]!r} for key {k!r} but the "
                           f"serial state holds {state.get(k)!r}",
                )
        for k, v in t.writes.items():
            if v is None:
                state.pop(k, None)
            else:
                state[k] = v
    # 3) atomicity at the end state
    if final_state is not None:
        model = {k: v for k, v in state.items() if v is not None}
        for k in sorted(set(model) | set(final_state)):
            steps += 1
            if model.get(k) != final_state.get(k):
                if unknown:
                    return CheckResult(
                        UNDETERMINED, steps, key=k,
                        detail=f"end state of key {k!r} is "
                               f"{final_state.get(k)!r}, replay says "
                               f"{model.get(k)!r}; {len(unknown)} "
                               "unresolved txn(s) could explain it",
                    )
                return CheckResult(
                    VIOLATION, steps, key=k,
                    detail=f"end state of key {k!r} is "
                           f"{final_state.get(k)!r} but replaying the "
                           f"commit order yields {model.get(k)!r} "
                           "(atomicity broken)",
                )
    return CheckResult(
        SERIALIZABLE, steps,
        detail=f"{len(order)} committed txn(s) replayed in decision "
               f"order; {len(txns) - len(committed)} aborted/unknown",
    )
