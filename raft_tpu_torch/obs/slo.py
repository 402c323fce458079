"""SLO plane (port of ``raft_tpu/obs/slo.py``): streaming latency
digests and multi-window burn-rate alerts.

- :class:`LatencyDigest` is a fixed-layout log-scale bucket digest. All
  digests share one bucket layout (geometric, factor ``2**0.25`` from
  1 µs to 1e5 s), so digests merge by adding count vectors, and a
  reported quantile is the geometric midpoint of its bucket: within one
  bucket factor (~19 %) of the true value. The pump profiler
  (``obs.hostprof.PumpProfiler``) keeps its batch sizes and queue ages
  in it.
- :class:`SloTracker` keeps per-(objective, group) good/total counts in
  coarse buckets of the virtual clock and evaluates multi-window burn
  rates: an alert fires only when both a long and a short window burn
  the error budget faster than a threshold. Alerts are typed
  :class:`SloAlert` events, recorded into the flight recorder (kind
  ``slo_alert``) and counted as ``raft_slo_alerts_total{slo,severity}``
  when a registry is attached.

Pure host arithmetic on values the engine already computed (commit and
read latencies, queue delays): no rng and no device fetch, so a seeded
run replays byte for byte with the tracker attached or absent. The
snapshot equals the JAX tracker's for the same observations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One service-level objective: ``target`` fraction of ``metric``
    events must complete under ``threshold_s`` (virtual seconds). The
    error budget is ``1 - target``; burn rate 1.0 = spending the budget
    exactly at the sustainable rate."""

    name: str                 # e.g. "commit_p99"
    metric: str               # "commit" | "read" | "queue_delay"
    threshold_s: float        # good iff value <= threshold
    target: float = 0.999     # objective: fraction of good events

    @property
    def budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


@dataclasses.dataclass(frozen=True)
class SloAlert:
    """Typed burn-rate alert (fired when BOTH windows exceed the
    threshold; cleared when the short window recovers)."""

    slo: str
    group: Optional[int]
    severity: str             # "page" | "ticket"
    burn_rate: float          # the short window's burn rate at firing
    long_s: float
    short_s: float
    t_virtual: float
    kind: str = "fire"        # "fire" | "clear"


#: (long window s, short window s, burn-rate threshold, severity) — the
#: SRE-workbook defaults scaled to the virtual clock. Overridable per
#: tracker; tests use short synthetic windows.
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float, str], ...] = (
    (3600.0, 300.0, 14.4, "page"),
    (21600.0, 1800.0, 6.0, "ticket"),
)


class SloTracker:
    """Per-(objective, group) SLO accounting + digests (module
    docstring). ``observe`` is the hot-path entry (guarded by the engine
    behind ``self.slo is not None``); ``maybe_evaluate`` runs the burn
    computation at most once per ``bucket_s`` of virtual time."""

    def __init__(
        self,
        objectives: Tuple[SLObjective, ...] = (),
        recorder=None,
        registry=None,
        bucket_s: float = 60.0,
        windows: Tuple[Tuple[float, float, float, str], ...] = DEFAULT_WINDOWS,
    ) -> None:
        self.objectives = tuple(objectives)
        self.recorder = recorder
        self.registry = registry
        self.bucket_s = float(bucket_s)
        self.windows = tuple(windows)
        self._span = max((w[0] for w in self.windows), default=0.0)
        self._by_metric: Dict[str, List[SLObjective]] = {}
        for o in self.objectives:
            self._by_metric.setdefault(o.metric, []).append(o)
        self.digests: Dict[Tuple[str, Optional[int]], LatencyDigest] = {}
        #   (metric, group) -> digest; group None = single engine
        self._buckets: Dict[Tuple[str, Optional[int]], Dict[int, list]] = {}
        #   (slo name, group) -> {bucket index -> [good, total]}
        self._active: Dict[Tuple[str, Optional[int], str], SloAlert] = {}
        self.alerts: List[SloAlert] = []
        self.alerts_dropped = 0
        self._last_eval = float("-inf")
        self.ALERT_CAP = 1024

    # ------------------------------------------------------------- feed
    def observe(self, metric: str, v: float,
                t: float, group: Optional[int] = None) -> None:
        dig = self.digests.get((metric, group))
        if dig is None:
            dig = self.digests[(metric, group)] = LatencyDigest()
        dig.observe(v)
        for o in self._by_metric.get(metric, ()):
            key = (o.name, group)
            buckets = self._buckets.get(key)
            if buckets is None:
                buckets = self._buckets[key] = {}
            bi = int(t // self.bucket_s)
            cell = buckets.get(bi)
            if cell is None:
                cell = buckets[bi] = [0, 0]
                # retention: drop buckets older than the longest window
                floor = bi - int(self._span // self.bucket_s) - 2
                for old in [b for b in buckets if b < floor]:
                    del buckets[old]
            cell[1] += 1
            if v <= o.threshold_s:
                cell[0] += 1

    def observe_batch(self, metric: str, values, t: float,
                      group: Optional[int] = None) -> None:
        """Bulk observe for batched commit booking: one digest update
        (vectorized) + one window-bucket update per call, instead of a
        Python call per entry — the hot-path shape that keeps the
        online plane inside its <= 5% overhead contract at the
        headline batch size (bench.py ``attribution.online_plane``)."""
        v = np.asarray(values, np.float64)
        if v.size == 0:
            return
        dig = self.digests.get((metric, group))
        if dig is None:
            dig = self.digests[(metric, group)] = LatencyDigest()
        dig.observe_many(v)
        for o in self._by_metric.get(metric, ()):
            key = (o.name, group)
            buckets = self._buckets.get(key)
            if buckets is None:
                buckets = self._buckets[key] = {}
            bi = int(t // self.bucket_s)
            cell = buckets.get(bi)
            if cell is None:
                cell = buckets[bi] = [0, 0]
                floor = bi - int(self._span // self.bucket_s) - 2
                for old in [b for b in buckets if b < floor]:
                    del buckets[old]
            cell[1] += int(v.size)
            cell[0] += int((v <= o.threshold_s).sum())

    # ------------------------------------------------------- evaluation
    def maybe_evaluate(self, t: float) -> None:
        if t - self._last_eval >= self.bucket_s:
            self.evaluate(t)

    def _burn(self, o: SLObjective, buckets: Dict[int, list],
              t: float, window_s: float) -> Optional[float]:
        """Burn rate over [t - window_s, t]: bad fraction / budget.
        None when the window holds no events (no evidence either way)."""
        lo = int((t - window_s) // self.bucket_s)
        good = total = 0
        for bi, (g, n) in buckets.items():
            if bi >= lo:
                good += g
                total += n
        if total == 0:
            return None
        return ((total - good) / total) / o.budget

    def evaluate(self, t: float) -> None:
        """Multi-window burn-rate pass: fire a typed alert when BOTH the
        long and the short window of a severity tier exceed its burn
        threshold; clear it when the short window recovers."""
        self._last_eval = t
        for o in self.objectives:
            for (name, group), buckets in self._buckets.items():
                if name != o.name:
                    continue
                for long_s, short_s, thresh, severity in self.windows:
                    key = (o.name, group, severity)
                    b_long = self._burn(o, buckets, t, long_s)
                    b_short = self._burn(o, buckets, t, short_s)
                    firing = (
                        b_long is not None and b_short is not None
                        and b_long > thresh and b_short > thresh
                    )
                    if firing and key not in self._active:
                        alert = SloAlert(
                            slo=o.name, group=group, severity=severity,
                            burn_rate=round(b_short, 3), long_s=long_s,
                            short_s=short_s, t_virtual=t,
                        )
                        self._active[key] = alert
                        self._emit(alert)
                    elif key in self._active and (
                        b_short is None or b_short <= thresh
                    ):
                        fired = self._active.pop(key)
                        self._emit(dataclasses.replace(
                            fired, kind="clear", t_virtual=t,
                            burn_rate=round(b_short or 0.0, 3),
                        ))

    def _emit(self, alert: SloAlert) -> None:
        if len(self.alerts) >= self.ALERT_CAP:
            self.alerts_dropped += 1
        else:
            self.alerts.append(alert)
        if self.recorder is not None:
            self.recorder.record(
                node=f"slo/{alert.slo}", term=0, kind="slo_alert",
                t_virtual=alert.t_virtual, group=alert.group,
                severity=alert.severity, burn_rate=alert.burn_rate,
                long_s=alert.long_s, short_s=alert.short_s,
                alert_kind=alert.kind,
            )
        if self.registry is not None and alert.kind == "fire":
            self.registry.counter(
                "raft_slo_alerts_total", "burn-rate alerts fired",
                ("slo", "severity"),
            ).inc(slo=alert.slo, severity=alert.severity)

    # --------------------------------------------------------- snapshot
    def active_alerts(self) -> List[SloAlert]:
        return list(self._active.values())

    def snapshot(self) -> dict:
        """JSON-safe state for ``/slo`` and forensics bundles."""
        def gkey(g):
            return "default" if g is None else str(g)

        digests = {}
        for (metric, group), dig in sorted(
            self.digests.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))
        ):
            digests.setdefault(metric, {})[gkey(group)] = dig.to_jsonable()
        slos = []
        # a scrape before the first evaluation must not feed -inf into
        # the bucket-index arithmetic (OverflowError); burn rates read
        # as of the last evaluation, 0.0 when none has happened yet
        t_eval = (self._last_eval
                  if math.isfinite(self._last_eval) else 0.0)
        for o in self.objectives:
            groups = {}
            for (name, group), buckets in self._buckets.items():
                if name != o.name:
                    continue
                good = sum(g for g, _ in buckets.values())
                total = sum(n for _, n in buckets.values())
                burns = {}
                for long_s, short_s, thresh, severity in self.windows:
                    burns[severity] = {
                        "long_s": long_s, "short_s": short_s,
                        "threshold": thresh,
                        "burn_long": self._burn(o, buckets,
                                                t_eval, long_s),
                        "burn_short": self._burn(o, buckets,
                                                 t_eval, short_s),
                    }
                groups[gkey(group)] = {
                    "good": good, "total": total,
                    "good_fraction": (good / total) if total else None,
                    "burn": burns,
                }
            slos.append({
                "name": o.name, "metric": o.metric,
                "threshold_s": o.threshold_s, "target": o.target,
                "groups": groups,
            })
        return {
            "objectives": slos,
            "digests": digests,
            "alerts_active": [dataclasses.asdict(a)
                              for a in self._active.values()],
            "alerts_total": len(self.alerts) + self.alerts_dropped,
            "alerts": [dataclasses.asdict(a) for a in self.alerts[-32:]],
        }
