"""Quorum rules (port of ``raft_tpu.quorum``)."""

from raft_tpu_torch.quorum.commit import (
    commit_from_match,
    majority,
    reference_bucket_commit,
    vote_majority,
)

__all__ = [
    "commit_from_match",
    "majority",
    "reference_bucket_commit",
    "vote_majority",
]
