"""Golden model: the reference's semantics as a host-side oracle (port of
``raft_tpu/golden``).

A pure-Python re-expression of the reference's message-level behavior
(``main.go``; SURVEY.md §4 "golden model"), driven by a seeded
virtual-clock scheduler. The differential tests and
``raft_tpu_torch.northstar.run_golden`` use it to check that the port's
committed log is byte-identical to the oracle's.
"""

from raft_tpu_torch.golden.model import (
    AppendEntriesRequest,
    AppendEntriesResponse,
    GoldenCluster,
    GoldenNode,
    VoteRequest,
    VoteResponse,
)

__all__ = [
    "AppendEntriesRequest",
    "AppendEntriesResponse",
    "GoldenCluster",
    "GoldenNode",
    "VoteRequest",
    "VoteResponse",
]
