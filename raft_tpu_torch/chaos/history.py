"""Client-visible operation histories — the Jepsen event model
(port of ``raft_tpu/chaos/history.py``, line for line).

Every client operation is recorded as an interval on the engine's
VIRTUAL clock: an ``invoke`` event when the client issues it and exactly
one terminal event later —

- ``ok``   — the operation completed and its result is known (a write
  acknowledged durable; a read served with a confirmed read index).
- ``fail`` — the operation PROVABLY took no effect (a refused
  linearizable read, a submit rejected before queueing). The checker
  removes these outright; marking an op ``fail`` when it might have
  applied is unsound, so the recorders only use it where the engine
  guarantees no effect.
- ``info`` — the outcome is unknown (a write in flight across a crash,
  or still unresolved at the end of the run). The checker must consider
  BOTH worlds: the op may have taken effect at any point after its
  invocation, or never.

This is the half of the Jepsen methodology the Raft-internal invariant
suites (tests/test_properties.py, tests/test_chaos.py) cannot supply:
those check what the *replicas* agree on; a history checks what the
*clients* were told — the contract of Raft §8 that end users actually
observe. Histories are recorded per key (``per_key``), which is what
makes checking tractable: a sharded KV is linearizable iff every key's
subhistory is (Herlihy–Wing locality / P-compositionality), and the
multi-Raft ``Router`` guarantees a key never changes groups.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

WRITE = "write"
DELETE = "delete"
READ = "read"

OK = "ok"
FAIL = "fail"
INFO = "info"
PENDING = "pending"


@dataclasses.dataclass
class OpRecord:
    """One client operation's lifetime. ``value`` is the value written
    (write), ``None`` (delete), or the value RETURNED (read; ``None`` =
    key absent). The linearization point must lie in
    ``[invoke_t, complete_t]`` (``complete_t`` None = unbounded)."""

    client: int
    op: str                      # WRITE | DELETE | READ
    key: bytes
    value: Optional[bytes]
    invoke_t: float
    complete_t: Optional[float] = None
    status: str = PENDING        # PENDING -> OK | FAIL | INFO

    def ok(self, t: float, value: Optional[bytes] = None) -> "OpRecord":
        assert self.status == PENDING, f"terminal event on {self.status} op"
        self.status = OK
        self.complete_t = t
        if self.op == READ:
            self.value = value
        return self

    def fail(self, t: float) -> "OpRecord":
        """The op provably took no effect (see module docstring — never
        use for a write that may still commit)."""
        assert self.status == PENDING, f"terminal event on {self.status} op"
        self.status = FAIL
        self.complete_t = t
        return self

    def info(self) -> "OpRecord":
        """Outcome unknown: the op keeps an unbounded interval — it may
        have taken effect at any time after ``invoke_t``, or never."""
        assert self.status == PENDING, f"terminal event on {self.status} op"
        self.status = INFO
        return self


class History:
    """Append-only operation history with per-key projection.

    Timestamps are refined to a strictly monotone sequence
    (``stamp``): the virtual clock is coarse — a whole client round can
    share one instant — but the single-threaded harness really does
    execute those events in order, so sub-tick ordering IS real-time
    order and recording it is sound. Without it, same-instant events
    all read as concurrent and the checker loses exactly the ordering
    constraints that catch same-round stale reads."""

    EPS = 1e-6

    #: record class instantiated by ``invoke`` — subclasses substitute a
    #: richer record (e.g. the chaos runner's span-closing _SpannedOp)
    #: without re-implementing the stamp/append logic, so the timestamp
    #: discipline cannot drift between observed and plain runs
    REC_CLS = OpRecord

    def __init__(self) -> None:
        self.ops: List[OpRecord] = []
        self._last = 0.0

    def stamp(self, t: float) -> float:
        """Refine a virtual-clock reading to the next strictly-monotone
        instant (host execution order breaks clock ties)."""
        self._last = max(t, self._last + self.EPS)
        return self._last

    def invoke(
        self,
        client: int,
        op: str,
        key: bytes,
        value: Optional[bytes],
        t: float,
    ) -> OpRecord:
        rec = self.REC_CLS(client, op, key, value, invoke_t=self.stamp(t))
        self._on_invoke(rec)
        self.ops.append(rec)
        return rec

    def _on_invoke(self, rec: OpRecord) -> None:
        """Subclass hook, called after the record is stamped and before
        it is appended (e.g. to open an obs span for it)."""

    def close(self) -> None:
        """End of run: any op still pending resolves to ``info`` —
        its outcome was never observed, so the checker must allow both
        worlds."""
        for rec in self.ops:
            if rec.status == PENDING:
                rec.info()

    def per_key(self) -> Dict[bytes, List[OpRecord]]:
        out: Dict[bytes, List[OpRecord]] = {}
        for rec in self.ops:
            out.setdefault(rec.key, []).append(rec)
        return out

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.ops:
            out[rec.status] = out.get(rec.status, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.ops)
