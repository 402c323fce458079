"""Message-level fault injection at the Transport seam
(port of ``raft_tpu/chaos/transport.py``).

``ChaosTransport`` wraps any device transport and perturbs the
collective rounds the engine dispatches through it — the transport-level
half of the nemesis vocabulary that ``faults.FaultPlan``'s process-level
actions (kill/slow/partition) cannot express:

- **drop** — an AppendEntries window lost in transit: the victim row is
  folded into the round's ``slow`` mask, so it hears the round (term
  adoption, heartbeat) but appends nothing and its ack is lost; the
  repair window re-serves it on a later round, exactly as a real leader
  re-sends after a lost ack. For vote rounds the victim is removed from
  the round's ``alive`` mask: a dropped RequestVote yields no grant and
  no term adoption on that row.
- **dup** — the same message delivered twice: the round is followed by a
  zero-entry echo round with identical (leader, term, masks). Raft's
  idempotence obligations make the echo a protocol no-op (AppendEntries
  re-delivery; a repeat RequestVote re-grants to the same candidate);
  the engine sees only the REAL round's info, so its bookkeeping is
  untouched — any state the echo does advance (e.g. commit off an extra
  quorum round) is reported by the next real round.
- **delay** — a message delivered late: the victim rows are dropped from
  the current round and a zero-entry echo (the stale window, in the
  ORIGINAL leader's original term) is queued to run just before a later
  round. By delivery time the cluster may have moved on — higher terms
  refuse the stale round, which is precisely the §5.1/§5.3 machinery a
  delayed message must exercise. Delivery masks are intersected with the
  delivering round's ``alive`` so a row that died in between hears
  nothing.

Why masks and echoes rather than a message queue: this engine has no
per-message plane — a "message" IS a row's participation in one
collective launch — so the faithful injection point is the per-round
mask, and a duplicated/delayed message is a re-issued round. Safety is
never at stake by construction (Raft tolerates arbitrary message loss,
duplication, and reordering); what drops/dups/delays perturb is
*progress and timing*, which is exactly what the linearizability
checker needs varied. Host-side quorum checks (read confirmation,
CheckQuorum) read the engine's fault masks as ground truth — the
documented simulation framing (see ``read_linearizable``) — so message
faults model data-plane loss, not control-plane partitions; use
``partition()`` for those.

The wrapper deliberately does NOT expose ``replicate_pipeline``: the
engine's eligibility gate then routes every chunk through the general
scan path, keeping one code path under fault injection.

The port's engine also asks its transport for the mesh seam (``resident``,
``device``, ``comm``, ``processes``, the row reads and writes, the
mirror digest exchange). ``ChaosTransport`` forwards exactly those names
to the base transport (``_SEAM``), never a blanket ``__getattr__``, which
would expose ``replicate_pipeline`` and change the engine's route. The
zero heartbeat batch and the round masks are tensors on the base
transport's device; the victim draws read host numpy masks in
``np.flatnonzero`` order, as the JAX wrapper does.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np
import torch

#: the mesh seam of the port's engine, forwarded by name to the base
#: transport (absent there, absent here)
_SEAM = ("resident", "device", "comm", "processes", "fetch_rows",
         "fetch_row", "fetch_row_lanes", "gather_window", "place_rows",
         "local_row", "lane_slice", "exchange_digest", "gather_state",
         "on_row", "log_terms", "record_chunk", "entry_words")


def _host(m) -> np.ndarray:
    """A round mask as a host bool array (a device tensor is copied
    back: the victim draws walk its rows on the host, as JAX's do)."""
    if isinstance(m, torch.Tensor):
        m = m.cpu().numpy()
    return np.asarray(m).astype(bool)


def _forward(name: str) -> property:
    return property(lambda self: getattr(self.t, name),
                    doc=f"The base transport's ``{name}``.")


class ChaosTransport:
    """Seeded drop/dup/delay fault injection around a base transport."""

    def __init__(self, base, seed: int = 0):
        self.t = base
        self.cfg = base.cfg
        self.rng = random.Random(seed)
        self.p_drop = 0.0
        self.p_dup = 0.0
        self.p_delay = 0.0
        self.delay_rounds: Tuple[int, int] = (1, 4)
        self._deferred: List[tuple] = []   # (due_round, leader, term, eff, slow, kw)
        self._round = 0
        self.stats = {"drop": 0, "dup": 0, "delay": 0, "delivered": 0}
        self._hb = None

    # ------------------------------------------------------------- control
    def set_message_faults(
        self,
        p_drop: float = 0.0,
        p_dup: float = 0.0,
        p_delay: float = 0.0,
        delay_rounds: Tuple[int, int] = (1, 4),
    ) -> None:
        self.p_drop, self.p_dup, self.p_delay = p_drop, p_dup, p_delay
        self.delay_rounds = delay_rounds

    def clear_message_faults(self) -> None:
        """Stop injecting AND drop undelivered delayed echoes (heal)."""
        self.p_drop = self.p_dup = self.p_delay = 0.0
        self._deferred.clear()

    # ------------------------------------------------------------ plumbing
    def init(self):
        return self.t.init()

    def fetch(self, x):
        f = getattr(self.t, "fetch", None)
        return f(x) if f is not None else np.asarray(x)

    def _victims(self, p: float, mask: np.ndarray, keep: int) -> np.ndarray:
        """Bernoulli(p) victim mask over rows active in ``mask``, never
        the source row ``keep`` (a leader always hears itself)."""
        out = np.zeros_like(mask)
        if p <= 0.0:
            return out
        for r in np.flatnonzero(mask):
            r = int(r)
            if r != keep and self.rng.random() < p:
                out[r] = True
        return out

    def _mask(self, m) -> torch.Tensor:
        """A host bool mask as a bool tensor on the base's device."""
        return torch.as_tensor(np.asarray(m, bool), device=self.t.device)

    def _hb_payload(self):
        if self._hb is None:
            cfg = self.cfg
            self._hb = torch.zeros(
                (cfg.batch_size, cfg.rows * cfg.shard_words),
                dtype=torch.int32, device=self.t.device,
            )
        return self._hb

    def _echo(self, state, leader, term, eff, slow, kw):
        """One zero-entry round — a re-delivered (dup) or late (delay)
        window. Info is discarded: the engine never saw this message."""
        state, _ = self.t.replicate(
            state, self._hb_payload(), 0, leader, term,
            self._mask(eff), self._mask(slow), **kw,
        )
        return state

    def _run_due(self, state, current_alive):
        """Deliver delayed echoes that have come due, gated on the rows
        still alive at delivery time."""
        now_alive = _host(current_alive)
        still: List[tuple] = []
        for item in self._deferred:
            due, leader, term, eff, slow, kw = item
            if self._round < due:
                still.append(item)
                continue
            eff_now = eff & now_alive
            if eff_now[leader]:
                self.stats["delivered"] += 1
                state = self._echo(state, leader, term, eff_now, slow, kw)
        self._deferred = still
        return state

    # ---------------------------------------------------------- transport
    def replicate(
        self, state, client_payload, client_count, leader, leader_term,
        alive, slow, **kw,
    ):
        # the device-observability ring (obs.device) rides only the
        # PRIMARY delivery: echoes (dup / delayed re-delivery) replay a
        # message the engine already observed, so recording them would
        # double-count transitions — and the deferred-echo kw snapshot
        # must never capture a stale ring
        ring = kw.pop("ring", None)
        self._round += 1
        state = self._run_due(state, alive)
        alive_np = _host(alive)
        slow_np = _host(slow)
        leader_i = int(leader)
        dropped = self._victims(self.p_drop, alive_np, leader_i)
        delayed = self._victims(self.p_delay, alive_np & ~dropped, leader_i)
        self.stats["drop"] += int(dropped.sum())
        self.stats["delay"] += int(delayed.sum())
        slow_round = slow_np | dropped | delayed
        if ring is not None:
            state, info, ring = self.t.replicate(
                state, client_payload, client_count, leader, leader_term,
                alive, self._mask(slow_round), ring=ring, **kw,
            )
        else:
            state, info = self.t.replicate(
                state, client_payload, client_count, leader, leader_term,
                alive, self._mask(slow_round), **kw,
            )
        if delayed.any():
            due = self._round + self.rng.randint(*self.delay_rounds)
            self._deferred.append(
                (due, leader_i, int(leader_term), alive_np.copy(),
                 slow_np.copy(), dict(kw))
            )
        if self.p_dup > 0.0 and self.rng.random() < self.p_dup:
            self.stats["dup"] += 1
            state = self._echo(
                state, leader_i, int(leader_term), alive_np, slow_np, kw
            )
        if ring is not None:
            return state, info, ring
        return state, info

    def fusion_ready(self) -> bool:
        """Whether the K-tick fused path may run RIGHT NOW: only while
        no message-fault plane is armed and no delayed echo is pending.
        The chaos rng draws (and the deferred-echo due arithmetic) are
        keyed to per-round calls, so fusing rounds under an armed fault
        plane would fork the seeded stream — the engine falls back to
        tick-at-a-time whenever this is False, which is exactly what
        keeps seeded replays byte-identical with fusion on vs off."""
        return (
            self.p_drop == 0.0 and self.p_dup == 0.0
            and self.p_delay == 0.0 and not self._deferred
            and hasattr(self.t, "replicate_fused")
            and getattr(self.t, "fusion_ready", lambda: True)()
        )

    def replicate_fused(self, state, staging, start_slot, counts, n_run,
                        *a, **kw):
        """Fault-free fused window (``fusion_ready`` gated by the
        engine): forward to the base transport, advancing the round
        counter by the window's tick count so deferred-echo due rounds
        stay aligned with what K tick-at-a-time rounds would have
        produced."""
        self._round += int(n_run)
        return self.t.replicate_fused(
            state, staging, start_slot, counts, n_run, *a, **kw
        )

    def replicate_many(
        self, state, payloads, counts, leader, leader_term, alive, slow,
        **kw,
    ):
        """Chunked scans see one drop draw for the whole chunk (the
        chunk is one dispatch; per-step faults inside a compiled scan
        would need a device-side fault plane)."""
        self._round += 1
        state = self._run_due(state, alive)
        alive_np = _host(alive)
        dropped = self._victims(self.p_drop, alive_np, int(leader))
        self.stats["drop"] += int(dropped.sum())
        slow_round = _host(slow) | dropped
        return self.t.replicate_many(
            state, payloads, counts, leader, leader_term, alive,
            self._mask(slow_round), **kw,
        )

    def request_votes(self, state, candidate, cand_term, alive,
                      ring=None, quorum=0):
        self._round += 1
        alive_np = _host(alive)
        dropped = self._victims(self.p_drop, alive_np, int(candidate))
        self.stats["drop"] += int(dropped.sum())
        if ring is not None:
            state, info, ring = self.t.request_votes(
                state, candidate, cand_term,
                self._mask(alive_np & ~dropped), ring=ring, quorum=quorum,
            )
        else:
            state, info = self.t.request_votes(
                state, candidate, cand_term, self._mask(alive_np & ~dropped)
            )
        if self.p_dup > 0.0 and self.rng.random() < self.p_dup:
            # repeat RequestVote delivery: re-grants to the same
            # candidate in the same term (idempotent by §5.2's
            # one-vote-per-term rule); the first round's info stands
            self.stats["dup"] += 1
            state, _ = self.t.request_votes(
                state, candidate, cand_term, self._mask(alive_np & ~dropped)
            )
        if ring is not None:
            return state, info, ring
        return state, info


for _name in _SEAM:
    setattr(ChaosTransport, _name, _forward(_name))
