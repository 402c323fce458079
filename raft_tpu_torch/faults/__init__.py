"""Fault injection as first-class configuration.

The reference has no failure hooks at all — no node ever crashes, slows,
or drops a message (SURVEY.md §5: failure *detection* is the election
timeout only, main.go:114). The BASELINE configs require induced faults
(slow follower, crash/recover, election storm), so this package makes them
a scripted, seeded schedule the engine executes on its virtual clock —
every fault run is replayable.

A copy of ``raft_tpu/faults/__init__.py`` (host only), kept in this
package so the port imports nothing of the JAX package.
"""

from raft_tpu_torch.faults.plan import FaultEvent, FaultPlan

__all__ = ["FaultEvent", "FaultPlan"]
