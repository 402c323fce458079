"""Client-side overload discipline: backoff, retry budgets, breakers.

Admission control on the server bounds queues; it does NOT stop the
retry amplification loop — a refused client that retries immediately
turns every refusal into a fresh arrival, and under open-loop traffic
the retry storm alone can hold the service in the overloaded regime
after the original cause is gone (the metastable pattern). The three
pieces here break that loop on the client side:

- ``Backoff``       — capped exponential with FULL jitter (decorrelated
  retries; a server ``retry_after_s`` hint floors the draw).
- ``RetryBudget``   — a token bucket where retries spend and successes
  refill by a fraction < 1, so sustained retry traffic is capped at
  that fraction of goodput. An exhausted budget fails fast with the
  original refusal instead of retrying.
- ``CircuitBreaker``— repeated consecutive failures open the circuit:
  further calls fast-fail (``CircuitOpen``) without touching the
  service until a cooldown elapses, then ONE probe is allowed through;
  a successful probe closes the circuit, a failed one re-arms the
  cooldown.

``multi.router.Router`` composes all three per consensus group; the
classes are engine-agnostic (plain floats and a caller-supplied clock)
so torture clients and external deployments can reuse them.

A copy of ``raft_tpu/admission/retry.py`` (host only), kept in this
package so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import random
from typing import Optional

from raft_tpu_torch.admission.gate import Overloaded


class CircuitOpen(Overloaded):
    """Fast-fail: the target's circuit breaker is open — recent calls
    failed repeatedly and the cooldown has not elapsed. Nothing was
    attempted against the service (provably no effect). A subclass of
    ``Overloaded`` because the recovery action is identical: back off
    ``retry_after_s``, then retry (the retry becomes the probe)."""

    def __init__(self, retry_after_s: float, group: Optional[int] = None):
        super().__init__(
            "circuit_open", retry_after_s,
            detail=(f"group {group} breaker open" if group is not None
                    else "breaker open"),
            group=group,
        )


class Backoff:
    """Capped exponential backoff with full jitter: attempt ``k`` draws
    uniform(0, min(max_s, base_s * factor**k)). Full jitter
    decorrelates a thundering herd better than equal-jitter at the same
    mean; a server-provided ``retry_after_s`` hint floors the draw (the
    server knows its own drain cadence better than the client)."""

    def __init__(self, base_s: float, max_s: float,
                 rng: Optional[random.Random] = None, factor: float = 2.0):
        if base_s <= 0 or max_s < base_s or factor < 1.0:
            raise ValueError("need 0 < base_s <= max_s and factor >= 1")
        self.base_s = base_s
        self.max_s = max_s
        self.factor = factor
        self.rng = rng if rng is not None else random.Random()

    def delay(self, attempt: int, hint_s: Optional[float] = None) -> float:
        cap = min(self.max_s, self.base_s * self.factor ** attempt)
        d = self.rng.uniform(0.0, cap)
        if hint_s is not None:
            d = max(d, min(hint_s, self.max_s))
        return d


class RetryBudget:
    """Token bucket capping retry traffic at a fraction of goodput.

    Retries spend one token; each SUCCESS refills ``refill_per_success``
    tokens (capped at ``capacity``), so in steady state retries cannot
    exceed ``refill_per_success`` per success — the budget that keeps a
    refusal wave from amplifying itself. The bucket starts full (a cold
    client may retry through a transient), and an empty bucket means
    fail-fast: surface the original refusal to the caller."""

    def __init__(self, capacity: float = 32.0,
                 refill_per_success: float = 0.5):
        if capacity < 1 or not (0.0 <= refill_per_success):
            raise ValueError("capacity >= 1 and refill_per_success >= 0")
        self.capacity = float(capacity)
        self.refill_per_success = float(refill_per_success)
        self.tokens = float(capacity)
        self.spent = 0
        self.denied = 0

    def try_spend(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            self.spent += 1
            return True
        self.denied += 1
        return False

    def on_success(self) -> None:
        self.tokens = min(self.capacity, self.tokens + self.refill_per_success)

    @property
    def balance(self) -> float:
        return self.tokens


class CircuitBreaker:
    """Per-target failure breaker (closed -> open -> half-open).

    ``failure_threshold`` CONSECUTIVE failures open the circuit; while
    open, ``allow`` returns False until ``cooldown_s`` has elapsed on
    the caller's clock, after which probes are allowed (half-open). Any
    success fully closes and resets; a failure while half-open re-opens
    with a fresh cooldown. Single-threaded by design (the engines are
    event loops)."""

    def __init__(self, failure_threshold: int = 8, cooldown_s: float = 30.0,
                 on_transition=None):
        if failure_threshold < 1 or cooldown_s <= 0:
            raise ValueError("failure_threshold >= 1 and cooldown_s > 0")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self.opened_count = 0
        self.on_transition = on_transition
        #   optional ``fn(state, now)`` observability hook, fired on
        #   open / half_open / close transitions (the flight recorder's
        #   previously-silent breaker plane — multi.router wires it).
        #   ``state()`` derives half-open from elapsed time, so the
        #   half_open notification fires from the first post-cooldown
        #   ``allow`` probe, deduped by _half_open_seen. ``now`` is
        #   None on a close whose ``on_success`` caller supplied no
        #   clock reading (the breaker holds no clock of its own).
        self._half_open_seen = False

    def _notify(self, state: str, now: Optional[float]) -> None:
        if self.on_transition is not None:
            self.on_transition(state, now)

    def state(self, now: float) -> str:
        if self._opened_at is None:
            return "closed"
        if now - self._opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def allow(self, now: float) -> bool:
        st = self.state(now)
        if st == "half_open" and not self._half_open_seen:
            self._half_open_seen = True
            self._notify("half_open", now)
        return st != "open"

    def retry_after(self, now: float) -> float:
        if self._opened_at is None:
            return 0.0
        return max(0.0, self.cooldown_s - (now - self._opened_at))

    def on_success(self, now: Optional[float] = None) -> None:
        was_open = self._opened_at is not None
        self._consecutive_failures = 0
        self._opened_at = None
        self._half_open_seen = False
        if was_open:
            self._notify("close", now)

    def on_failure(self, now: float) -> None:
        self._consecutive_failures += 1
        if self._opened_at is not None:
            if now - self._opened_at >= self.cooldown_s:
                # the half-open probe failed: re-arm a fresh cooldown
                self._opened_at = now
                self.opened_count += 1
                self._half_open_seen = False
                self._notify("open", now)
            return
        if self._consecutive_failures >= self.failure_threshold:
            self._opened_at = now
            self.opened_count += 1
            self._notify("open", now)
