"""Observability CLI: ``python -m raft_tpu_torch.obs`` (port of
``python -m raft_tpu.obs``; either reads the other's artifacts).

Post-mortem tooling over repro bundles (``obs.forensics``) and black-box
artifacts (``obs.blackbox``) — nothing here re-runs a seed:

- ``--explain PATH [PATH ...]``  — reconstruct the failure story from
  whatever PATH is: a repro bundle (minimal failure timeline: last
  leader per term, faults in flight, the violating op — and, when the
  run carried the device plane, the decoded device ring: kind summary,
  overflow laps flagged, device events interleaved into the timeline;
  when it carried the compile-&-memory plane, ``RETRACE:`` /
  ``CENSUS GREW:`` flags from the compile log and memory census),
  a **stall bundle** (who stalled, the blocked phase, journal tail,
  all-thread stacks), a **blackbox journal** ``.jsonl`` (per-process
  phase timeline with durations; the final in-flight phase flagged),
  or a directory of journals (one timeline per process — the multihost
  post-mortem view). MULTIPLE paths must all be repro bundles: their
  span tables are JOINED on the cross-process wire trace id into one
  causal timeline per op (client attempt → wire frame → ingest batch →
  tick → completion sweep → response — ``obs.forensics.explain_joined``;
  a single bundle carrying both a ``spans`` and a ``client_spans``
  table, as the chaos wire drill writes, gets the joined view
  appended automatically).
- ``--render-perfetto BUNDLE``  — convert the bundle's span table to
  Chrome/Perfetto trace JSON (load at ui.perfetto.dev); ``-o`` writes
  to a file, default stdout.
- ``--metrics-dump BUNDLE``     — print the bundle's metrics snapshot
  as Prometheus text exposition (``--json`` for the raw snapshot).
- ``--serve`` refuses: its demo boots a multi-Raft engine with the
  compile and memory planes (ROADMAP A14, A16b).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from raft_tpu_torch.obs.blackbox import (
    STALL_FORMAT,
    explain_journal,
    explain_merged,
    explain_stall,
)
from raft_tpu_torch.obs.forensics import (
    BUNDLE_FORMAT,
    explain,
    explain_joined,
    load_bundle,
)


def _render_perfetto(bundle: dict) -> dict:
    from raft_tpu_torch.obs.spans import SpanTracker, spans_from_jsonable

    if not bundle.get("spans"):
        raise SystemExit(
            "bundle carries no span table (run with observe=True)"
        )
    tracker = SpanTracker()
    tracker.spans = spans_from_jsonable(bundle["spans"])
    return tracker.to_perfetto()


def _explain_many(paths: list) -> str:
    """--explain with 2+ paths: every artifact must be a repro bundle;
    their span tables join on the wire trace id into one causal
    timeline per op (the cross-process wire forensics view)."""
    bundles = []
    for path in paths:
        if not os.path.exists(path):
            raise SystemExit(f"{path}: no such file")
        try:
            bundles.append(load_bundle(path))
        except (ValueError, json.JSONDecodeError, OSError) as ex:
            # OSError covers e.g. a journal DIRECTORY among the paths
            # — joined mode is bundles-only, and the user deserves the
            # typed message, not a traceback
            raise SystemExit(
                f"{path}: joined --explain needs repro bundles ({ex})"
            )
    return explain_joined(bundles)


def _explain_any(path: str) -> str:
    """Dispatch --explain on what the artifact actually is: a directory
    of journals, a journal file, a stall bundle, or a repro bundle."""
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        journals = [
            os.path.join(path, f) for f in names if f.endswith(".jsonl")
        ]
        # the watchdog writes stall bundles into the SAME blackbox dir —
        # the directory post-mortem must surface them (they carry the
        # all-thread stacks), not just the journal timelines
        stalls = []
        for f in names:
            if f.startswith("stall_") and f.endswith(".json"):
                try:
                    with open(os.path.join(path, f)) as fh:
                        doc = json.load(fh)
                except (OSError, json.JSONDecodeError):
                    continue
                if doc.get("format") == STALL_FORMAT:
                    stalls.append(explain_stall(doc))
        if not journals and not stalls:
            raise SystemExit(
                f"{path}: no .jsonl journals or stall bundles in directory"
            )
        parts = [explain_journal(journals)] if journals else []
        if len(journals) > 1:
            # 2+ journals in one directory = a multi-process run: the
            # per-journal views above tell each process's story, the
            # merged wall-clock view tells THE story (a kill -9 in the
            # supervisor's journal next to the victim's last gasp)
            parts.append(explain_merged(journals))
        return "\n\n".join(parts + stalls)
    if not os.path.exists(path):
        # read_journal forgives unreadable files (it must not choke on
        # the artifact of a crash), but a CLI typo must fail loudly, not
        # exit 0 with an "empty journal" shrug
        raise SystemExit(f"{path}: no such file")
    if path.endswith(".jsonl"):
        return explain_journal([path])
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as ex:
        raise SystemExit(f"{path}: not a readable JSON artifact ({ex})")
    if doc.get("format") == STALL_FORMAT:
        return explain_stall(doc)
    if doc.get("format") != BUNDLE_FORMAT:
        raise SystemExit(
            f"{path}: not a raft_tpu artifact "
            f"(format={doc.get('format')!r})"
        )
    text = explain(doc)
    if doc.get("client_spans"):
        # one bundle carrying both sides (the wire drill): the joined
        # per-op view rides along without a second artifact
        text += "\n\n" + explain_joined([doc])
    return text


def _metrics_prometheus(snapshot: dict) -> str:
    """Re-expose a bundle's JSON metrics snapshot as Prometheus text (a
    snapshot is values, not live metric objects, so rebuild a registry)."""
    from raft_tpu_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    for name, m in snapshot.items():
        labels = tuple(m["labels"])
        if m["type"] == "counter":
            c = reg.counter(name, m["help"], labels)
            for s in m["series"]:
                c.inc(s["value"], **s["labels"])
        elif m["type"] == "gauge":
            g = reg.gauge(name, m["help"], labels)
            for s in m["series"]:
                g.set(s["value"], **s["labels"])
        elif m["type"] == "histogram":
            buckets = None
            for s in m["series"]:
                bs = [float(b) for b in s["buckets"] if b != "+Inf"]
                buckets = tuple(bs)
                break
            h = reg.histogram(
                name, m["help"], labels,
                buckets=buckets if buckets else (1.0,),
            )
            for s in m["series"]:
                h._counts[tuple(str(s["labels"][n]) for n in labels)] = \
                    list(s["buckets"].values())
                k = tuple(str(s["labels"][n]) for n in labels)
                h._sum[k] = s["sum"]
                h._n[k] = s["count"]
    return reg.to_prometheus()


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.obs",
        description="raft_tpu observability tooling (repro bundles)",
    )
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--explain", metavar="PATH", nargs="+",
                   help="reconstruct the failure timeline from a repro "
                        "bundle, a stall bundle, a blackbox journal "
                        "(.jsonl), or a directory of journals; with "
                        "2+ bundle paths, join their span tables on "
                        "the wire trace id into one causal timeline "
                        "per op (client+server forensics)")
    g.add_argument("--render-perfetto", metavar="BUNDLE",
                   help="bundle span table -> Chrome/Perfetto trace JSON")
    g.add_argument("--metrics-dump", metavar="BUNDLE",
                   help="bundle metrics snapshot -> Prometheus text")
    g.add_argument("--serve", action="store_true",
                   help="not ported yet (ROADMAP A14, A16b): the demo "
                        "ops server over a multi-Raft engine")
    ap.add_argument("-o", "--output", default=None,
                    help="output file (default stdout)")
    ap.add_argument("--json", action="store_true",
                    help="with --metrics-dump: raw JSON snapshot instead "
                         "of Prometheus text")
    args = ap.parse_args(argv)

    if args.serve:
        from raft_tpu_torch.obs.serve import serve_demo

        try:
            serve_demo()
        except NotImplementedError as ex:
            raise SystemExit(str(ex))
    if args.explain:
        text = (_explain_any(args.explain[0]) if len(args.explain) == 1
                else _explain_many(args.explain))
    elif args.render_perfetto:
        text = json.dumps(_render_perfetto(load_bundle(args.render_perfetto)))
    else:
        bundle = load_bundle(args.metrics_dump)
        snap = bundle.get("metrics")
        if not snap:
            raise SystemExit(
                "bundle carries no metrics snapshot (run with observe=True)"
            )
        text = (json.dumps(snap) if args.json
                else _metrics_prometheus(snap))

    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
    else:
        sys.stdout.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
