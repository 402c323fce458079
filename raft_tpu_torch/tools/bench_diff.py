"""Bench regression gate of the port (its own copy of
``tools/bench_diff.py``): diff two bench JSON artifacts leg by leg.

``python -m raft_tpu_torch.bench`` emits one JSON row per leg and a final
combined object, in ``bench.py``'s format, so this gate reads either
package's artifacts (a port row diffs against a JAX row of the same leg):

    python -m raft_tpu_torch.tools.bench_diff OLD.json NEW.json \
        [--threshold 0.10]
    python -m raft_tpu_torch.bench --compare OLD.json \
        [--regress-threshold 0.10]

Both print a leg-by-leg delta table and exit non-zero when any GATED
metric regressed past the threshold (fractional: 0.10 = 10%).

Accepted artifact shapes (auto-detected):
- raw ``bench.py`` stdout: one JSON object per line, final line the
  combined object (``configs`` maps leg name -> row);
- the repo's BENCH_rNN wrapper: ``{"cmd", "rc", "tail", "parsed"}`` —
  ``parsed`` when present, else the combined/leg lines inside ``tail``
  (a deadline- or rc=124-killed run still yields its finished legs);
- a bare combined object.

Gating policy: only well-known metric keys gate (direction matters —
``p50_us`` regresses UP, ``entries_per_sec`` regresses DOWN); legs or
keys present on one side only are reported as ``added``/``removed`` but
never gate, and rows skipped by the deadline (``{"skipped":
"deadline"}``) are reported as ``skipped`` — "not measured" must stay
distinguishable from "measured and regressed". The round-11
compile-&-memory columns gate down (``compile_count``,
``mem_high_water_bytes``), and a leg whose compile count went 0 -> >0
is ALWAYS a gated regression with its own ``recompiling`` status plus
a summary line naming the legs — the "newly started recompiling"
report the XLA plane exists for (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

#: metric key -> direction ("down" = smaller is better). Only these
#: gate; every other shared numeric key is reported ungated.
GATED_METRICS: Dict[str, str] = {
    "p50_us": "down",
    "p99_us": "down",
    "wall_slope_us": "down",
    "wall_us_per_tick": "down",
    "wall_us_per_tick_observe_off": "down",
    "wall_us_per_leader_tick": "down",
    "us_per_tick": "down",
    "entries_per_sec": "up",
    "goodput_eps": "up",
    "entries_per_sec_wall": "up",
    # group_shard leg (the sharded group-axis sweep): per-group device
    # cost and per-group commit p50 gate DOWN, the aggregate mesh
    # throughput gates UP (entries_per_sec_wall above already covers
    # the end-to-end column)
    "mesh_us_per_group_tick": "down",
    "mesh_entries_per_sec": "up",
    "virtual_commit_p50_s": "down",
    # compile-&-memory plane columns (round 11): XLA compiles and the
    # live-buffer high water must never grow past threshold — a leg
    # that newly starts recompiling (old 0 -> new > 0) is always a
    # regression, reported with its own "recompiling" status
    "compile_count": "down",
    "mem_high_water_bytes": "down",
    # tiered-log wipe ladder (round 12): rejoin time gates DOWN and the
    # foreground-goodput coexistence ratio gates UP per wipe_logN row;
    # the ladder's flatness ratio (rejoin at log 4096 / log 256) gates
    # DOWN so rejoin cost can never quietly grow back into scaling
    # with history length. rejoin_wall_ms and seal_entries_per_sec are
    # reported but NOT gated: wall numbers on shared CI boxes are too
    # noisy for a 10% tripwire (the virtual-clock columns carry the
    # gate).
    "rejoin_virtual_s": "down",
    "flat_ratio": "down",
    "catchup_goodput_ratio": "up",
    # read scale-out (round 13): per-class read throughput gates UP and
    # the per-read wall latency percentiles gate DOWN on every
    # read_scale_* row; the lease row's speedup over the ReadIndex-only
    # baseline gates UP so the zero-round win can't silently regress
    # back into per-read confirmation rounds.
    "reads_per_sec": "up",
    "read_p50_us": "down",
    "read_p99_us": "down",
    "speedup_vs_read_index": "up",
    # macro (wire) leg (round 14): end-to-end service latency gates
    # DOWN and the batched-ingest amortization ratio (wire goodput /
    # in-process Router.submit goodput, same shape same box) gates UP;
    # goodput_eps above already gates the absolute throughput on every
    # macro row. shed_rate is deliberately REPORTED UNGATED: the
    # leader-kill row runs at 2x capacity where shedding is the
    # designed behavior, and its level is workload-shaped, not a
    # regression axis.
    "e2e_p50_ms": "down",
    "e2e_p99_ms": "down",
    "wire_goodput_ratio": "up",
    # wire trace plane (round 15): the tracing-overhead ratio (traced /
    # untraced wire goodput, bracketed windows) gates UP so the trace
    # plane can never quietly grow past its <= 5% budget, and the
    # pump-phase attribution coverage gates UP so the phase table can
    # never silently stop tiling the pump iteration. The per-phase
    # µs/iter and coalesce/queue-age percentiles are REPORTED UNGATED
    # (shape-dependent wall numbers; the ratio and coverage carry the
    # contract).
    "tracing_overhead_ratio": "up",
    "pump_coverage": "up",
    # txn leg (round 16): the wire 2PC commit latency percentiles gate
    # DOWN and committed-transaction goodput gates UP on the 90/10
    # mixed row. abort_rate is deliberately REPORTED UNGATED: it
    # measures OCC contention in the generated workload (expect_failed
    # is a CORRECT outcome under racing transfers), not a regression
    # axis — gating it would punish honest conflict detection.
    "txn_p50_ms": "down",
    "txn_p99_ms": "down",
    "txn_goodput_eps": "up",
    # cluster leg (round 17): the 3-process deployed goodput gates UP
    # and the restart economics gate DOWN — handoff_ratio is
    # restart-with-manifest-adoption time over wiped-dir re-seal time,
    # so a regression means the durable handoff started redoing work.
    # cluster_vs_singleproc and the kill row's shed split are REPORTED
    # UNGATED (deployment-shaped, not regression axes); e2e_p99_ms on
    # the kill row rides the existing macro gate.
    "cluster_goodput_eps": "up",
    "handoff_ratio": "down",
    # storage round (round 18): WAL group commit — cluster-wide
    # replicated entries per shared fsync on the goodput row. Gates UP
    # so the one-fsync-per-ingest-sweep coalescing can never quietly
    # fall back to fsync-per-append (1.0 is the degenerate floor).
    "wal_fsync_batched": "up",
    # network round (round 19): the cluster_latency row — goodput with
    # 5ms±2ms injected on every peer link gates UP (a pipelining
    # regression shows up here first, where a quorum round actually
    # costs something); its faulted e2e_p99_ms and wal_fsync_batched
    # ride the existing gates. Old artifacts without the row compare
    # clean: legs and metric keys gate on the INTERSECTION only, so a
    # new row reports as ``added`` and never fails a diff against a
    # pre-round-19 baseline.
    "cluster_rtt_goodput_eps": "up",
}


@dataclasses.dataclass(frozen=True)
class Delta:
    leg: str
    metric: str
    old: Optional[float]
    new: Optional[float]
    change: Optional[float]       # signed fraction, regression-positive
    status: str                   # ok|regressed|improved|added|removed|skipped
    gated: bool


def _flatten_legs(doc: dict) -> Dict[str, dict]:
    """Leg name -> row from a combined object (top-level headline
    metrics become a synthetic ``headline`` leg)."""
    legs: Dict[str, dict] = {}
    configs = doc.get("configs")
    if isinstance(configs, dict):
        for name, row in configs.items():
            if isinstance(row, dict):
                legs[name] = row
    headline = {
        k: doc[k]
        for k in ("value", "p99_us", "entries_per_sec", "wall_slope_us")
        if isinstance(doc.get(k), (int, float))
    }
    if headline:
        if "value" in headline and doc.get("metric") == "commit_p50_latency":
            headline["p50_us"] = headline.pop("value")
        legs["headline"] = headline
    return legs


def load_bench(path: str) -> Dict[str, dict]:
    """Parse any accepted artifact shape into leg name -> row."""
    with open(path) as fh:
        text = fh.read()
    legs: Dict[str, dict] = {}
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and "tail" in doc and "cmd" in doc:
        # BENCH_rNN wrapper: prefer the parsed combined object, fall
        # back to the JSON lines inside the captured stdout tail
        if isinstance(doc.get("parsed"), dict):
            return _flatten_legs(doc["parsed"])
        text = doc.get("tail") or ""
        doc = None
    if isinstance(doc, dict) and "leg" in doc:
        # a single leg row (the sole survivor of a killed run)
        return {doc["leg"]: {k: v for k, v in doc.items() if k != "leg"}}
    if isinstance(doc, dict):
        flattened = _flatten_legs(doc)
        if flattened:
            return flattened
        raise ValueError(
            f"{path}: no bench legs found (not a bench.py artifact?)"
        )
    # JSON-lines stdout: leg rows first, combined object last
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(row, dict):
            continue
        if "configs" in row:
            combined = _flatten_legs(row)
            combined.update(
                {k: v for k, v in legs.items() if k not in combined}
            )
            legs = combined
        elif "leg" in row:
            name = row["leg"]
            legs[name] = {k: v for k, v in row.items() if k != "leg"}
    if not legs:
        raise ValueError(
            f"{path}: no bench legs found (not a bench.py artifact?)"
        )
    return legs


def _num(v) -> Optional[float]:
    if isinstance(v, (int, float)) and math.isfinite(v):
        return float(v)
    return None


def compare_runs(
    old: Dict[str, dict], new: Dict[str, dict], threshold: float = 0.10
) -> Tuple[List[Delta], List[Delta]]:
    """(all deltas, gated regressions past threshold)."""
    deltas: List[Delta] = []
    for leg in sorted(set(old) | set(new)):
        orow, nrow = old.get(leg), new.get(leg)
        if orow is None or nrow is None:
            deltas.append(Delta(
                leg, "-", None, None, None,
                "added" if orow is None else "removed", False,
            ))
            continue
        if nrow.get("skipped") or orow.get("skipped"):
            deltas.append(Delta(leg, "-", None, None, None,
                                "skipped", False))
            continue
        for metric in sorted(set(orow) & set(nrow)):
            ov, nv = _num(orow.get(metric)), _num(nrow.get(metric))
            if ov is None or nv is None:
                continue
            direction = GATED_METRICS.get(metric)
            if direction is None:
                continue
            # signed change, positive = regression in the gated sense
            if ov == 0:
                change = 0.0 if nv == 0 else math.inf
            else:
                change = (nv - ov) / abs(ov)
            if direction == "up":
                change = -change
            status = ("regressed" if change > threshold
                      else "improved" if change < -threshold else "ok")
            if metric == "compile_count" and ov == 0 and nv > 0:
                # a steady leg that NEWLY started recompiling: always a
                # gated regression, named so the table says what broke
                status = "recompiling"
            deltas.append(Delta(leg, metric, ov, nv, change, status, True))
    regressions = [d for d in deltas
                   if d.gated and d.status in ("regressed", "recompiling")]
    return deltas, regressions


def format_table(deltas: List[Delta], threshold: float) -> str:
    """The human-readable delta table (regression-positive percent)."""
    rows = [("leg", "metric", "old", "new", "delta", "status")]
    for d in deltas:
        rows.append((
            d.leg, d.metric,
            "-" if d.old is None else f"{d.old:.4g}",
            "-" if d.new is None else f"{d.new:.4g}",
            "-" if d.change is None else f"{d.change * 100:+.1f}%",
            d.status,
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(6)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    lines.insert(1, "-" * len(lines[0]))
    n_reg = sum(1 for d in deltas
                if d.status in ("regressed", "recompiling"))
    recompiling = sorted({d.leg for d in deltas
                          if d.status == "recompiling"})
    lines.append(
        f"{n_reg} regression(s) past the {threshold * 100:g}% threshold"
        if n_reg else
        f"no regressions past the {threshold * 100:g}% threshold"
    )
    if recompiling:
        lines.append(
            "legs newly recompiling (compile_count 0 -> >0): "
            + ", ".join(recompiling)
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.tools.bench_diff",
        description="diff two bench JSON artifacts leg by leg; "
                    "non-zero exit on regression past the threshold",
    )
    ap.add_argument("old", help="baseline artifact")
    ap.add_argument("new", help="candidate artifact")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="fractional regression gate (default 0.10)")
    args = ap.parse_args(argv)
    deltas, regressions = compare_runs(
        load_bench(args.old), load_bench(args.new), args.threshold
    )
    print(format_table(deltas, args.threshold))
    return 1 if regressions else 0


if __name__ == "__main__":
    sys.exit(main())
