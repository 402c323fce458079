"""Metrics registry (port of ``raft_tpu/obs/registry.py``): counters /
gauges / histograms with labels. The exposition text equals the JAX
registry's for the same updates.

The third observability pillar: numeric signals the engines update on
their hot paths (guarded so a detached registry costs nothing), with
per-group labels for multi-Raft, a snapshot API consumed by
``obs.metrics.EngineReport``, Prometheus text exposition and a JSON
dump for forensics bundles. ``parse_prometheus`` closes the loop for
the exposition round-trip test.

Metric names follow Prometheus conventions (``raft_*_total`` counters,
``_seconds`` unit suffixes). The well-known engine metrics:

========================================  =======  =======================
name                                      type     labels
========================================  =======  =======================
raft_elections_total                      counter  group
raft_term_adoptions_total                 counter  group
raft_heartbeat_ticks_total                counter  group
raft_repair_rounds_total                  counter  group
raft_sheds_total                          counter  group, reason
raft_commits_total                        counter  group
raft_snapshot_installs_total              counter  group
raft_snapshot_chunks_total                counter  group
raft_segments_sealed_total                counter  group
raft_net_requests_total                   counter  kind
raft_net_bytes_total                      counter  dir
raft_net_refusals_total                   counter  reason
raft_net_pump_phase_seconds               histogram phase
raft_net_coalesce_batch                   histogram (none)
raft_net_frame_queue_age_seconds          histogram (none)
raft_commit_latency_seconds               histogram group
raft_queue_depth_high_water               gauge    group
raft_term                                 gauge    group
raft_host_mem_bytes                       gauge    root
========================================  =======  =======================

Determinism contract: pure host arithmetic, no rng, no device traffic.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Tuple

DEFAULT_BUCKETS = (
    0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 60.0, 120.0, 300.0,
)


def _labelkey(labelnames: Tuple[str, ...], labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {labelnames}, got {tuple(labels)}"
        )
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)


class Counter(_Metric):
    typ = "counter"

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames)
        self._values: Dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _labelkey(self.labelnames, labels)
        self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_labelkey(self.labelnames, labels), 0.0)

    def series(self) -> Iterable[Tuple[tuple, float]]:
        return self._values.items()


class Gauge(Counter):
    typ = "gauge"

    def set(self, value: float, **labels) -> None:
        self._values[_labelkey(self.labelnames, labels)] = float(value)

    def set_max(self, value: float, **labels) -> None:
        """High-water helper: keep the max of all observations."""
        k = _labelkey(self.labelnames, labels)
        self._values[k] = max(self._values.get(k, float("-inf")), value)


class Histogram(_Metric):
    typ = "histogram"

    def __init__(self, name, help, labelnames, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[tuple, List[int]] = {}   # per-bucket, non-cum.
        self._sum: Dict[tuple, float] = {}
        self._n: Dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        k = _labelkey(self.labelnames, labels)
        if k not in self._counts:
            self._counts[k] = [0] * (len(self.buckets) + 1)
        for i, b in enumerate(self.buckets):
            if value <= b:
                self._counts[k][i] += 1
                break
        else:
            self._counts[k][-1] += 1               # +Inf bucket
        self._sum[k] = self._sum.get(k, 0.0) + value
        self._n[k] = self._n.get(k, 0) + 1

    def summary(self, **labels) -> dict:
        k = _labelkey(self.labelnames, labels)
        return {
            "count": self._n.get(k, 0),
            "sum": self._sum.get(k, 0.0),
            "buckets": dict(zip(
                [str(b) for b in self.buckets] + ["+Inf"],
                self._counts.get(k, [0] * (len(self.buckets) + 1)),
            )),
        }

    def series(self) -> Iterable[tuple]:
        return self._n.keys()


class MetricsRegistry:
    """Named metric registry. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent re-registration with the same shape), so
    engine layers can share one registry without coordination."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name, help, labelnames, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered with a different shape"
                )
            return m
        m = cls(name, help, tuple(labelnames), **kw)
        self._metrics[name] = m
        return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """JSON-safe dump: name -> {type, help, labels, series:[{labels,
        value|histogram}]} — the structure ``EngineReport.metrics``
        carries and forensics bundles embed."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            series = []
            if isinstance(m, Histogram):
                for k in sorted(m.series()):
                    series.append({
                        "labels": dict(zip(m.labelnames, k)),
                        **m.summary(**dict(zip(m.labelnames, k))),
                    })
            else:
                for k, v in sorted(m.series()):
                    series.append({
                        "labels": dict(zip(m.labelnames, k)), "value": v,
                    })
            out[name] = {
                "type": m.typ, "help": m.help,
                "labels": list(m.labelnames), "series": series,
            }
        return out

    to_json = snapshot

    # ------------------------------------------------------- exposition
    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.typ}")
            if isinstance(m, Histogram):
                for k in sorted(m.series()):
                    base = dict(zip(m.labelnames, k))
                    s = m.summary(**base)
                    cum = 0
                    for b, c in s["buckets"].items():
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels({**base, 'le': b})} {cum}"
                        )
                    lines.append(
                        f"{name}_sum{_fmt_labels(base)} {_fmt_num(s['sum'])}"
                    )
                    lines.append(
                        f"{name}_count{_fmt_labels(base)} {s['count']}"
                    )
            else:
                for k, v in sorted(m.series()):
                    lines.append(
                        f"{name}{_fmt_labels(dict(zip(m.labelnames, k)))} "
                        f"{_fmt_num(v)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$"
)
_LABEL = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"')
_ESCAPED = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    # single pass, so a literal backslash followed by 'n' survives
    # (sequential str.replace would corrupt it — the round-trip contract)
    return _ESCAPED.sub(lambda m: {"n": "\n"}.get(m[1], m[1]), v)


def parse_prometheus(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Parse exposition text back into ``name -> {sorted label items ->
    value}`` — the inverse half of the round-trip test. Comment and
    blank lines are skipped; histogram component samples parse as their
    ``_bucket``/``_sum``/``_count`` sample names."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        labels = {}
        if m["labels"]:
            for lm in _LABEL.finditer(m["labels"]):
                labels[lm["k"]] = _unescape(lm["v"])
        v = m["value"]
        value = math.inf if v == "+Inf" else (
            -math.inf if v == "-Inf" else float(v)
        )
        out.setdefault(m["name"], {})[tuple(sorted(labels.items()))] = value
    return out
