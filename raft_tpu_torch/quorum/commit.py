"""Quorum rules on torch tensors (port of ``raft_tpu/quorum/commit.py``).

- ``commit_from_match`` — the paper-correct rule: the largest N such that a
  quorum of replicas have matchIndex >= N, as a counting k-th order
  statistic (O(R^2) compares, no sort).
- ``reference_bucket_commit`` — the reference's exact-bucket rule
  (main.go:381-391), kept for differential testing only.
- ``vote_majority`` — the reference's ``count > len(Nodes)/2`` test.

``torch.sum`` over int32 or bool gives int64; every result here is cast
back to int32 so it matches the JAX package's dtypes.
"""

from __future__ import annotations

import torch


def majority(n: int) -> int:
    """Strict majority of an n-replica cluster."""
    return n // 2 + 1


def commit_from_match(match: torch.Tensor, quorum=None) -> torch.Tensor:
    """Largest N with |{r : match[r] >= N}| >= quorum — i32[] from i32[R],
    or i32[G] from i32[G, R] (one cluster per group).

    ``quorum`` (int, 0-d tensor, or i32[G] per group) defaults to strict
    majority. The answer is the largest value covered by >= quorum
    elements, 0 when none is.
    """
    n = match.shape[-1]
    q = majority(n) if quorum is None else quorum
    if isinstance(q, torch.Tensor) and q.dim():
        q = q.unsqueeze(-1)
    cnt = (match[..., None, :] >= match[..., :, None]).to(torch.int32).sum(-1)
    return torch.where(cnt >= q, match, 0).amax(dim=-1).to(torch.int32)


def reference_bucket_commit(follower_match: torch.Tensor, n_nodes: int,
                            commit_prev: torch.Tensor) -> torch.Tensor:
    """The reference's exact-bucket commit (main.go:381-391): the largest
    value held by a strict majority of the whole cluster that is above the
    previous commit; otherwise the previous commit."""
    eq = follower_match[:, None] == follower_match[None, :]
    counts = eq.to(torch.int32).sum(dim=1)
    ok = (counts > n_nodes // 2) & (follower_match > commit_prev)
    return torch.where(ok, follower_match, commit_prev).max().to(torch.int32)


def vote_majority(votes: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """True iff ``votes`` is a strict majority (main.go:273)."""
    return votes > n_nodes // 2
