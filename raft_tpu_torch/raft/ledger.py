"""Bounded commit-stamp ledger — the ONE copy of the eviction/interval
logic both engines share.

``RaftEngine`` keeps one ``(commit_time, submit_time, durable_ranges)``
triple; ``MultiEngine`` keeps one per group. The invariants are subtle
enough (trim-to-exactly-cap batching invariance — the fused and tick
paths must retain IDENTICAL dicts; contiguous-run collapse; neighbour
coalescing; ``is_durable`` answering for every seq ever issued) that two
hand-synchronized copies would drift, so the algorithms live here and
the engines delegate.

Contract (see ``RaftEngine.commit_time``'s comment for the full story):
stamps evict oldest-first past ``cap`` retained entries (dict order IS
stamp order), trimmed to EXACTLY cap so the retained set is a pure
function of the stamp sequence, never of check cadence; evicted seqs —
committed by construction — collapse into merged ``[lo, hi]`` intervals
(one per loss gap) that keep durability queries exact after the stamp
is gone.

A copy of ``raft_tpu/raft/ledger.py`` (host only), kept in this
package so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import bisect
from itertools import islice
from typing import Dict, List, Tuple

import numpy as np


def durable_range_covers(ranges: List[List[int]], seq: int) -> bool:
    """True iff ``seq`` lies in one of the merged durable intervals
    (bisect lookup; the intervals are sorted and disjoint)."""
    if not ranges:
        return False
    i = bisect.bisect_right(ranges, [seq, float("inf")]) - 1
    return i >= 0 and ranges[i][0] <= seq <= ranges[i][1]


def merge_durable_range(ranges: List[List[int]], a: int, b: int) -> None:
    """Insert [a, b] into the sorted, disjoint interval list in place,
    coalescing with adjacent/overlapping neighbours."""
    if ranges and ranges[-1][0] <= a <= ranges[-1][1] + 1:
        # common case: the run starts inside or immediately after the
        # tail range (evictions proceed in stamp order)
        if ranges[-1][1] < b:
            ranges[-1][1] = b
        return
    i = bisect.bisect_right(ranges, [a, float("inf")])
    if i > 0 and ranges[i - 1][1] >= a - 1:
        ranges[i - 1][1] = max(ranges[i - 1][1], b)
        i -= 1
    else:
        ranges.insert(i, [a, b])
    # absorb any following ranges the new one now touches
    while i + 1 < len(ranges) and ranges[i + 1][0] <= ranges[i][1] + 1:
        ranges[i][1] = max(ranges[i][1], ranges[i + 1][1])
        del ranges[i + 1]


def evict_commit_stamps(
    commit_time: Dict[int, float],
    submit_time: Dict[int, float],
    cap: int,
    ranges: List[List[int]],
) -> Tuple[Dict[int, float], Dict[int, float], int]:
    """Trim the stamp dicts to exactly ``cap`` retained entries
    (oldest-first; bulk C-level rebuilds), folding the evicted seqs
    into ``ranges`` (mutated in place). Returns the new
    ``(commit_time, submit_time, n_evicted)`` — no-op triple when under
    the cap."""
    n_evict = len(commit_time) - cap
    if n_evict <= 0:
        return commit_time, submit_time, 0
    it = iter(commit_time.items())
    evicted = list(islice(it, n_evict))
    commit_time = dict(it)                 # retained tail, C-level
    if n_evict * 4 < len(submit_time):
        for seq, _ in evicted:
            submit_time.pop(seq, None)
    else:
        drop = {s for s, _ in evicted}
        submit_time = {
            k: v for k, v in submit_time.items() if k not in drop
        }
    # fold the evicted seqs into the merged durable intervals:
    # contiguous runs collapse via one numpy pass (seqs stamp in
    # near-ascending order, so the interval list stays tiny — one
    # interval per loss gap)
    arr = np.fromiter((s for s, _ in evicted), np.int64, n_evict)
    arr.sort()
    breaks = np.flatnonzero(np.diff(arr) != 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [n_evict - 1]))
    for a, b in zip(arr[starts], arr[ends]):
        merge_durable_range(ranges, int(a), int(b))
    return commit_time, submit_time, n_evict
