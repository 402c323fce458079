"""Streaming latency digests (port of the digest half of
``raft_tpu/obs/slo.py``).

:class:`LatencyDigest` is a fixed-layout log-scale bucket digest. All
digests share one bucket layout (geometric, factor ``2**0.25`` from 1 µs
to 1e5 s), so digests merge by adding count vectors, and a reported
quantile is the geometric midpoint of its bucket: within one bucket
factor (~19 %) of the true value. The pump profiler
(``obs.hostprof.PumpProfiler``) keeps its batch sizes and queue ages in
it. The burn-rate tracker (``SloTracker``) comes with the rest of the
observability plane (ROADMAP A16a).
"""

from __future__ import annotations

import math

import numpy as np

# One shared bucket layout so any two digests merge: geometric buckets
# factor 2**0.25 (~+19% per bucket) spanning 1 µs .. 1e5 s. Values
# outside clamp into the terminal buckets.
_FACTOR = 2.0 ** 0.25
_LO = 1e-6
_N_BUCKETS = int(math.ceil(math.log(1e5 / _LO, _FACTOR))) + 2


def _bucket_of(v: float) -> int:
    if not (v > _LO):                     # NaN and <= LO land in bucket 0
        return 0
    i = int(math.log(v / _LO, _FACTOR)) + 1
    return min(i, _N_BUCKETS - 1)


def _bucket_mid(i: int) -> float:
    """Geometric midpoint of bucket ``i`` — the quantile estimate whose
    relative error is bounded by the bucket factor."""
    if i <= 0:
        return _LO
    lo = _LO * _FACTOR ** (i - 1)
    return lo * math.sqrt(_FACTOR)


class LatencyDigest:
    """Streaming log-bucket latency digest (module docstring). Fixed
    layout: every instance merges with every other. ``observe_many``
    is the numpy-vectorized bulk path the engine's batched commit
    booking uses (one call per tick/launch, not per entry)."""

    __slots__ = ("counts", "n", "total", "max")

    def __init__(self) -> None:
        self.counts = np.zeros(_N_BUCKETS, np.int64)
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        self.counts[_bucket_of(v)] += 1
        self.n += 1
        self.total += v
        if v > self.max:
            self.max = v

    def observe_many(self, values: np.ndarray) -> None:
        """Bulk observe: same bucketing formula as ``observe``,
        vectorized (log + bincount)."""
        v = np.asarray(values, np.float64)
        if v.size == 0:
            return
        idx = np.zeros(v.shape, np.int64)
        pos = v > _LO
        idx[pos] = (
            np.log(v[pos] / _LO) / math.log(_FACTOR)
        ).astype(np.int64) + 1
        np.clip(idx, 0, _N_BUCKETS - 1, out=idx)
        self.counts += np.bincount(idx, minlength=_N_BUCKETS)
        self.n += int(v.size)
        self.total += float(v.sum())
        self.max = max(self.max, float(v.max()))

    def merge(self, other: "LatencyDigest") -> "LatencyDigest":
        """Fold ``other`` into self (shared layout: vector add)."""
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        self.max = max(self.max, other.max)
        return self

    def quantile(self, q: float) -> float:
        """The q-quantile estimate (NaN on an empty digest); within one
        bucket factor of the true sample quantile by construction."""
        if self.n == 0:
            return float("nan")
        rank = max(1, math.ceil(q * self.n))
        i = int(np.searchsorted(np.cumsum(self.counts), rank))
        return _bucket_mid(min(i, _N_BUCKETS - 1))

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    def to_jsonable(self) -> dict:
        return {
            "n": self.n,
            "mean": self.mean if self.n else None,
            "max": self.max if self.n else None,
            "p50": self.quantile(0.5) if self.n else None,
            "p90": self.quantile(0.9) if self.n else None,
            "p99": self.quantile(0.99) if self.n else None,
            "p999": self.quantile(0.999) if self.n else None,
        }
