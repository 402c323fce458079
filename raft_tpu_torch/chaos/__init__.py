"""Jepsen-style torture harness: client-history linearizability under a
randomized nemesis (port of ``raft_tpu/chaos``).

The package closes the verification gap the Raft-internal suites leave
open: they prove what the *replicas* agree on; this harness records what
the *clients* were told — every submit and linearizable read as an
invoke/ok/fail/info interval on the virtual clock — and checks the
history against the sequential KV model (Raft §8's client contract, the
property users actually observe).

- ``chaos.history``   — the event model (History / OpRecord).
- ``chaos.checker``   — Wing–Gong/Lowe linearizability search with
  P-compositional per-key decomposition and a step budget
  (``UNDETERMINED`` instead of a hang).
- ``chaos.nemesis``   — the seeded adversary: FaultPlan process faults,
  transport drop/dup/delay windows, crash cycles with storage faults.
- ``chaos.transport`` — ``ChaosTransport``, message faults at the
  Transport seam (masks and echo rounds as tensors on the base
  transport's device; the engine's mesh seam forwarded by name).
- ``chaos.storage``   — ``MirroredStore``, the simulated durable disk
  set (mirrored checkpoints + vote WAL) the storage faults target, and
  ``SegmentNemesis`` against the tiered store's sealed shards.
- ``chaos.runner``    — ``torture_run`` / ``torture_run_multi``: the
  end-to-end loop, reported with a one-line seed repro; plus the
  deterministic ``overload_run``, ``reconfig_run``,
  ``segment_storage_run``, ``reads_run`` and ``migration_run`` drills,
  and ``txn_run``, the cross-group transaction drill.

Every run is the JAX runner's seed for seed (the same draws, nemesis
log, history and report), on the card unless ``device="cpu"``; the wire
drill (``wire_run``) runs over the port's net tier and is held by its
checker verdict and invariants. The cluster drills (``cluster_run``,
``cluster_storage_run``, ``cluster_net_run`` in ``chaos.runner``) drive
real replica processes of ``raft_tpu_torch.cluster`` and are held the
same way: by their verdicts and receipts.

One-command repro of any run: ``python -m raft_tpu_torch.chaos --seed N``.
"""

from raft_tpu_torch.chaos.checker import (
    LINEARIZABLE,
    UNDETERMINED,
    VIOLATION,
    CheckResult,
    check_history,
)
from raft_tpu_torch.chaos.history import History, OpRecord
from raft_tpu_torch.chaos.nemesis import MembershipView, Nemesis, NemesisAction
from raft_tpu_torch.chaos.runner import (
    MigrationReport,
    OverloadReport,
    ReadsReport,
    ReconfigReport,
    SegmentReport,
    TortureReport,
    TxnReport,
    WireReport,
    migration_run,
    overload_run,
    poisson,
    reads_run,
    reconfig_run,
    segment_storage_run,
    torture_run,
    torture_run_multi,
    txn_run,
    wire_run,
)
from raft_tpu_torch.chaos.storage import MirroredStore
from raft_tpu_torch.chaos.transport import ChaosTransport

__all__ = [
    "LINEARIZABLE",
    "UNDETERMINED",
    "VIOLATION",
    "CheckResult",
    "check_history",
    "History",
    "OpRecord",
    "MembershipView",
    "Nemesis",
    "NemesisAction",
    "MigrationReport",
    "OverloadReport",
    "ReadsReport",
    "ReconfigReport",
    "SegmentReport",
    "TortureReport",
    "TxnReport",
    "WireReport",
    "migration_run",
    "overload_run",
    "poisson",
    "reads_run",
    "reconfig_run",
    "segment_storage_run",
    "torture_run",
    "torture_run_multi",
    "txn_run",
    "wire_run",
    "MirroredStore",
    "ChaosTransport",
]
