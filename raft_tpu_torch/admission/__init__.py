"""Overload admission control: bounded queues, delay-gated shedding,
and client-side retry discipline.

The north star is open-loop traffic — millions of clients that do NOT
slow down when the service does. Every unbounded queue between them and
the device is then a metastable-failure amplifier (Bronson et al.,
HotOS '21): a transient slowdown grows the queue, queue delay grows
timeouts and retries, retries grow the queue. This package makes
overload a first-class, *gracefully degraded* regime instead:

- ``gate``  — the server side. ``AdmissionGate`` bounds the engine's
  host queues by depth AND by queue delay (a CoDel-style controller on
  the virtual clock), keeps reads and writes in separate priority
  lanes, accounts per-client fair shares, and refuses excess work with
  a typed ``Overloaded`` carrying a retry-after hint. A refusal happens
  BEFORE any state changes, so the chaos harness records shed ops as
  sound no-effect failures and the linearizability verdict is
  unaffected.
- ``retry`` — the client side. ``Backoff`` (jittered exponential),
  ``RetryBudget`` (a token bucket refilled by successes, so retry
  traffic is capped at a fraction of goodput), and ``CircuitBreaker``
  (repeated refusals convert to fast-fail ``CircuitOpen`` until a probe
  succeeds). ``multi.router.Router`` composes all three.

Enable server-side admission with ``RaftConfig.admission_max_writes`` /
``admission_max_reads`` (both default ``None`` — the legacy unbounded
behavior). docs/OVERLOAD.md has the model, the refusal contract, and
the tuning knobs.

A copy of ``raft_tpu/admission/__init__.py`` (host only), kept in this
package so the port imports nothing of the JAX package.
"""

from raft_tpu_torch.admission.gate import AdmissionGate, AdmissionReport, Overloaded
from raft_tpu_torch.admission.retry import (
    Backoff,
    CircuitBreaker,
    CircuitOpen,
    RetryBudget,
)

__all__ = [
    "AdmissionGate",
    "AdmissionReport",
    "Overloaded",
    "Backoff",
    "CircuitBreaker",
    "CircuitOpen",
    "RetryBudget",
]
