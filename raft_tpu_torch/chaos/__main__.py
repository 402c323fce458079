"""One-command torture repro: ``python -m raft_tpu_torch.chaos --seed N``
(port of ``raft_tpu/chaos/__main__.py``).

Runs one torture run (or a ``--sweep K`` batch) with the given seed and
knobs, prints each run's summary plus a JSON result line, and exits
non-zero unless every history checked LINEARIZABLE — the exact
invocation a failing run's report names as its repro.

The flags, their checks and the result lines are JAX's. ``--device``
picks the engines' device: the card unless ``cpu`` is named (no fallback
when no card is found). ``--wire`` runs the wire drill over the port's
net tier; ``--txn`` the transaction drill on two shards of ``--device``,
as ``--migration`` does. The cluster drills are not ported yet:
``--cluster``, ``--cluster-storage`` and ``--cluster-net`` (ROADMAP A17d)
exit with a message naming the item, after JAX's own argument checks.
"""

from __future__ import annotations

import argparse
import json
import sys

from raft_tpu_torch.chaos.runner import (
    migration_run,
    overload_run,
    reads_run,
    reconfig_run,
    segment_storage_run,
    torture_run,
    torture_run_multi,
    txn_run,
    wire_run,
)

#: the drills of the JAX CLI that wait for their tier: flag -> what the
#: exit names
NOT_PORTED = (
    ("cluster", "--cluster", "A17d (the cluster tier and cluster_run)"),
    ("cluster_storage", "--cluster-storage",
     "A17d (the cluster tier and cluster_storage_run)"),
    ("cluster_net", "--cluster-net",
     "A17d (the cluster tier and cluster_net_run)"),
)


def _two_shards(device):
    """The migration and txn drills' mesh: two shards of one device (the
    card's first unless ``device`` names another)."""
    import torch

    from raft_tpu_torch.transport.device import resolve_device
    from raft_tpu_torch.transport.group_mesh import GroupMesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return GroupMesh([dev, dev])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.chaos",
        description="Jepsen-style torture run with linearizability check",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", type=int, default=1,
                    help="run seeds [seed, seed+sweep)")
    ap.add_argument("--phases", type=int, default=12)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--keys", type=int, default=4)
    ap.add_argument("--phase-s", type=float, default=30.0)
    ap.add_argument("--step-budget", type=int, default=500_000)
    ap.add_argument("--multi", action="store_true",
                    help="multi-Raft Router/ShardedKV torture instead")
    ap.add_argument("--groups", type=int, default=4, help="--multi groups")
    ap.add_argument("--no-crash", action="store_true")
    ap.add_argument("--no-msg", action="store_true")
    ap.add_argument("--no-storage", action="store_true")
    ap.add_argument("--overload", action="store_true",
                    help="arm admission and let the nemesis open "
                         "open-loop arrival storms at 2-10x capacity, "
                         "composed with the other fault planes "
                         "(docs/OVERLOAD.md)")
    ap.add_argument("--membership", action="store_true",
                    help="arm the membership plane: nemesis grow/shrink/"
                         "remove-the-leader/wipe-replace cycles over a "
                         "headroom cluster, composed with the other "
                         "fault planes (docs/CHAOS.md round 9)")
    ap.add_argument("--reconfig", action="store_true",
                    help="run the deterministic reconfiguration drill "
                         "(grow via learner, shrink, leader removal, "
                         "wipe-replace) instead of a torture run; "
                         "succeeds only if the history checks "
                         "linearizable AND commit progress resumes "
                         "within the documented window after every "
                         "configuration commit")
    ap.add_argument("--migration", action="store_true",
                    help="run the deterministic group-migration drill "
                         "(a mesh-sharded MultiEngine moves groups "
                         "between shards mid-traffic, Rebalancer-"
                         "planned) instead of a torture run; succeeds "
                         "only if the history checks linearizable AND "
                         "commit progress resumes on every moved group "
                         "within the documented window; the port runs "
                         "it on two shards of --device")
    ap.add_argument("--segments", action="store_true",
                    help="run the deterministic sealed-segment storage "
                         "nemesis drill (tiered log: torn spill, bit "
                         "flip, dropped shard against RS-coded cold-"
                         "tier segments) instead of a torture run; "
                         "succeeds only if the history checks "
                         "linearizable, the lapped follower rejoins, "
                         "AND recovery rode the RS reconstruct path "
                         "(no segment lost)")
    ap.add_argument("--reads", action="store_true",
                    help="run the deterministic read scale-out drill "
                         "(leader leases under traffic, clock-skew "
                         "churn across the drift band, leader kill "
                         "with lease resumption, session reads, and "
                         "the scripted stale-probe scenario) instead "
                         "of a torture run; succeeds only if EVERY "
                         "read class passes its own consistency model "
                         "(per-class verdicts, docs/READS.md) and the "
                         "stale probe was refused; with --broken "
                         "lease_skew, succeeds only if the stale "
                         "serve was CAUGHT")
    ap.add_argument("--wire", action="store_true",
                    help="run the wire-plane drill (docs/NETWORK.md): "
                         "torture traffic driven through a REAL "
                         "loopback asyncio TCP server instead of "
                         "in-process calls, with the leader-kill and "
                         "overload nemeses composed; succeeds only if "
                         "every read class holds its contract, the "
                         "admission gate's typed refusals surfaced as "
                         "wire backpressure (shed >= 1), and clients "
                         "rode NOT_LEADER frames through the election")
    ap.add_argument("--cluster", action="store_true",
                    help="run the multi-process cluster drill "
                         "(docs/CLUSTER.md): 3 REAL OS processes, one "
                         "replica each, speaking peer frames over "
                         "loopback TCP, with kill -9 composed with a "
                         "userspace partition, an open-loop burst, "
                         "SIGSTOP/SIGCONT, and restart-with-handoff; "
                         "succeeds only if every read class holds its "
                         "contract AND the killed-and-restarted "
                         "process adopted its prior generation's "
                         "sealed segments (segments_resealed == 0) "
                         "and rejoined via the resumable snapshot "
                         "stream")
    ap.add_argument("--cluster-nodes", type=int, default=3,
                    help="--cluster process count (>= 3)")
    ap.add_argument("--cluster-storage", action="store_true",
                    help="run the storage-fault nemesis over the "
                         "multi-process cluster (docs/CLUSTER.md "
                         "storage-fault model): every durable write "
                         "rides the FaultyIO VFS seam, and torn "
                         "writes, fsync stalls, a disk-full window, "
                         "post-kill media rot (mid-file WAL bit flip, "
                         "torn manifest, flipped sealed shard), and a "
                         "mid-run fsync-EIO fail-stop compose with "
                         "partition / kill -9 / restart-with-handoff; "
                         "succeeds only if every read class holds its "
                         "contract AND every recovery receipt is "
                         "present (WAL truncated at the first bad "
                         "CRC, manifest.json.prev fallback, RS shard "
                         "reconstruct, typed disk-full sheds, death "
                         "certificate + exit 97 with ZERO post-EIO "
                         "fsyncs, commit digests agreeing at shared "
                         "checkpoints); with --broken fsync_lies or "
                         "wal_skip_corrupt, succeeds only if the lie "
                         "was CAUGHT")
    ap.add_argument("--cluster-net", action="store_true",
                    help="run the network-fault nemesis over the "
                         "multi-process cluster (docs/CLUSTER.md "
                         "network-fault model): every peer byte rides "
                         "the netfault seam, and latency + jitter, a "
                         "bandwidth trickle, torn frames, duplicate / "
                         "reordered / cross-redial-replayed delivery, "
                         "and post-header bit corruption compose with "
                         "an ASYMMETRIC partition of the leader and "
                         "kill -9 / restart-with-handoff; succeeds "
                         "only if every read class holds its contract "
                         "AND every wire receipt is present (injected "
                         "corruption all dropped at the CRC check "
                         "with commit digests agreeing, dup/reordered "
                         "replies credited as zero lease evidence, "
                         "CheckQuorum demotion then re-election "
                         "within the liveness window, torn "
                         "connections redialed, the killed ex-leader "
                         "rejoined); with --broken peer_no_crc or "
                         "lease_stale_round, succeeds only if the lie "
                         "was CAUGHT")
    ap.add_argument("--txn", action="store_true",
                    help="run the cross-group transaction drill "
                         "(docs/TXN.md): a replicated 2PC coordinator "
                         "drives validated transfers across a mesh-"
                         "sharded MultiEngine while the nemesis kills "
                         "leaders, partitions groups, and migrates a "
                         "participant mid-transaction; succeeds only "
                         "if the commit-order witness checks "
                         "SERIALIZABLE, money is conserved, AND the "
                         "single-key side-traffic checks linearizable; "
                         "with --broken txn_partial_commit or "
                         "txn_dirty_read, succeeds only if the "
                         "serializability checker CAUGHT the bug")
    ap.add_argument("--txn-extra", action="store_true",
                    help="compose the round-16 remainder nemeses into "
                         "the --txn drill (phase 4b): a mem_replace "
                         "window (participant follower out, "
                         "replacement catches up on the same row), an "
                         "induced-slow-follower wire fault, and an "
                         "open-loop overload burst through the "
                         "admission gate")
    ap.add_argument("--txn-lease-reads", action="store_true",
                    help="arm the read-plane lease path for the --txn "
                         "drill's basis reads: every transfer's "
                         "expects anchor to a leader-certified read "
                         "index (zero quorum rounds while the "
                         "participant leader holds a valid lease)")
    ap.add_argument("--read-plane", action="store_true",
                    help="arm the read scale-out plane on a torture "
                         "run: leader leases (prevote implied) plus "
                         "the clock-skew nemesis drawing rates inside "
                         "the configured drift band, composed with "
                         "the other fault planes")
    ap.add_argument("--overload-recovery", type=float, default=None,
                    metavar="MULT",
                    help="run the deterministic overload-and-recover "
                         "scenario at MULT x capacity instead of a "
                         "torture run; succeeds only if the history "
                         "checks linearizable, the queue bound held, "
                         "AND goodput recovered inside the documented "
                         "window")
    ap.add_argument("--broken",
                    choices=["dirty_reads", "commit_rewind",
                             "lease_skew", "txn_partial_commit",
                             "txn_dirty_read", "fsync_lies",
                             "wal_skip_corrupt", "peer_no_crc",
                             "lease_stale_round"],
                    default=None,
                    help="deliberately broken variant; the run SUCCEEDS "
                         "(exit 0) only if the harness catches it — "
                         "dirty_reads must be REJECTED by the offline "
                         "checker, commit_rewind (acked commits lost by "
                         "a lying storage layer; usually invisible to "
                         "the checker) must trip the ONLINE safety "
                         "auditor during the run (--audit is implied), "
                         "lease_skew (leader leases that ignore the "
                         "clock-drift bound; needs --reads) must serve "
                         "a stale read the per-class checker and/or "
                         "auditor catch, txn_partial_commit (a 2PC "
                         "coordinator that commits a transaction whose "
                         "prewrite lost its locks; needs --txn) and "
                         "txn_dirty_read (a store that serves staged "
                         "intents before the decision; needs --txn) "
                         "must both be CAUGHT by the serializability "
                         "checker, fsync_lies (a disk whose fsync "
                         "returns before durability; needs "
                         "--cluster-storage) must lose acked writes "
                         "the checker sees after a cluster-wide "
                         "kill -9, and wal_skip_corrupt (a WAL replay "
                         "that SKIPS a corrupt record instead of "
                         "truncating; needs --cluster-storage) must "
                         "trip the cross-node commit-digest plane, "
                         "peer_no_crc (frame-CRC negotiation disabled; "
                         "needs --cluster-net) must let injected wire "
                         "corruption into the log where the digest "
                         "plane catches it, and lease_stale_round (a "
                         "lease clock that credits append replies at "
                         "arrival time regardless of round; needs "
                         "--cluster-net) must serve a stale lease "
                         "read the per-class checker flags. "
                         "A passing broken run means the harness "
                         "lost its teeth")
    ap.add_argument("--audit", action="store_true",
                    help="attach the ONLINE safety plane: the "
                         "obs.audit.SafetyAuditor invariant checks "
                         "(one leader per term, monotone commit/terms, "
                         "committed-prefix CRC, per-client monotone "
                         "reads) plus the obs.slo.SloTracker burn-rate "
                         "plane — determinism-neutral; violations are "
                         "reported in the JSON result line")
    ap.add_argument("--observe", action="store_true",
                    help="attach the observability plane (flight "
                         "recorder, per-op spans, metrics registry) — "
                         "determinism-neutral; makes forensics bundles "
                         "carry the full event ring + span table")
    ap.add_argument("--observe-device", action="store_true",
                    help="additionally attach the DEVICE observability "
                         "plane (obs.device in-kernel event rings + "
                         "on-device counters; implies --observe on the "
                         "torture runners) — determinism-neutral, and "
                         "bundles gain a device_ring section")
    ap.add_argument("--observe-compile", action="store_true",
                    help="additionally attach the XLA compile-and-"
                         "memory plane (obs.compile CompileWatch + "
                         "RetraceSentinel, obs.memory census): every "
                         "trace/compile is recorded per program label, "
                         "the sentinel freezes after the warmup phase "
                         "(later hot-path compiles are typed "
                         "violations), and the device-memory census "
                         "baselines there — determinism-neutral; also "
                         "armed by env RAFT_TPU_COMPILE_SENTINEL=1")
    ap.add_argument("--bundle-dir", default=None, metavar="DIR",
                    help="write a repro bundle to DIR whenever a run "
                         "ends in anything but its expected verdict "
                         "(also honored via RAFT_TPU_BUNDLE_DIR); "
                         "inspect with python -m raft_tpu_torch.obs --explain")
    ap.add_argument("--blackbox-dir", default=None, metavar="DIR",
                    help="write a black-box progress journal (one "
                         "append-only line-flushed .jsonl per run: "
                         "nemesis phases, crash-restore cycles, checker "
                         "milestones) to DIR — it survives an external "
                         "kill of the harness itself (also honored via "
                         "RAFT_TPU_BLACKBOX_DIR); inspect with "
                         "python -m raft_tpu_torch.obs --explain")
    ap.add_argument("--device", default=None,
                    help="the engines' device (the card unless 'cpu'; "
                         "there is no fallback when no card is found)")
    args = ap.parse_args(argv)
    if args.multi and args.broken:
        ap.error("--broken applies to the single-engine runner only")
    if args.overload_recovery is not None and (args.multi or args.broken):
        ap.error("--overload-recovery is a standalone single-engine run")
    if args.membership and args.multi:
        ap.error("--membership applies to the single-engine runner only "
                 "(MultiEngine is fixed-membership by design)")
    if args.read_plane and args.multi:
        ap.error("--read-plane applies to the single-engine runner "
                 "only (the multi engine has no PreVote yet — its "
                 "lease plane is exercised by the Router tests and "
                 "bench, not the torture nemesis)")
    if args.reconfig and (args.multi or args.broken or args.overload
                          or args.overload_recovery is not None):
        ap.error("--reconfig is a standalone single-engine drill")
    if args.migration and (args.multi or args.broken or args.overload
                           or args.reconfig
                           or args.overload_recovery is not None):
        ap.error("--migration is a standalone sharded-multi drill")
    if args.segments and (args.multi or args.broken or args.overload
                          or args.reconfig or args.migration
                          or args.overload_recovery is not None):
        ap.error("--segments is a standalone single-engine drill")
    if args.broken == "lease_skew" and not args.reads:
        ap.error("--broken lease_skew applies to the --reads drill")
    if (args.broken in ("txn_partial_commit", "txn_dirty_read")
            and not args.txn):
        ap.error("--broken %s applies to the --txn drill" % args.broken)
    if args.txn and (args.multi or args.overload or args.reconfig
                     or args.migration or args.segments
                     or args.membership or args.reads or args.wire
                     or args.broken not in (None, "txn_partial_commit",
                                            "txn_dirty_read")
                     or args.overload_recovery is not None):
        ap.error("--txn is a standalone sharded-multi drill (--broken "
                 "txn_partial_commit / txn_dirty_read are its only "
                 "compositions)")
    if (args.txn_extra or args.txn_lease_reads) and not args.txn:
        ap.error("--txn-extra / --txn-lease-reads apply to the --txn "
                 "drill")
    if args.reads and (args.multi or args.overload or args.reconfig
                       or args.migration or args.segments
                       or args.membership
                       or args.broken not in (None, "lease_skew")
                       or args.overload_recovery is not None):
        ap.error("--reads is a standalone single-engine drill "
                 "(--broken lease_skew is its one composition)")
    if args.wire and (args.multi or args.broken or args.overload
                      or args.reconfig or args.migration
                      or args.segments or args.membership or args.reads
                      or args.overload_recovery is not None):
        ap.error("--wire is a standalone drill (its leader-kill and "
                 "overload nemeses are built in)")
    if args.cluster and (args.multi or args.broken or args.overload
                         or args.reconfig or args.migration
                         or args.segments or args.membership
                         or args.reads or args.wire or args.txn
                         or args.cluster_storage or args.cluster_net
                         or args.overload_recovery is not None):
        ap.error("--cluster is a standalone multi-process drill (its "
                 "kill -9 / partition / pause / overload / restart "
                 "nemeses are built in)")
    if (args.broken in ("fsync_lies", "wal_skip_corrupt")
            and not args.cluster_storage):
        ap.error("--broken %s applies to the --cluster-storage drill"
                 % args.broken)
    if args.cluster_storage and (
            args.multi or args.overload or args.reconfig
            or args.migration or args.segments or args.membership
            or args.reads or args.wire or args.txn or args.cluster_net
            or args.broken not in (None, "fsync_lies",
                                   "wal_skip_corrupt")
            or args.overload_recovery is not None):
        ap.error("--cluster-storage is a standalone multi-process "
                 "drill (--broken fsync_lies / wal_skip_corrupt are "
                 "its only compositions)")
    if (args.broken in ("peer_no_crc", "lease_stale_round")
            and not args.cluster_net):
        ap.error("--broken %s applies to the --cluster-net drill"
                 % args.broken)
    if args.cluster_net and (
            args.multi or args.overload or args.reconfig
            or args.migration or args.segments or args.membership
            or args.reads or args.wire or args.txn
            or args.broken not in (None, "peer_no_crc",
                                   "lease_stale_round")
            or args.overload_recovery is not None):
        ap.error("--cluster-net is a standalone multi-process drill "
                 "(--broken peer_no_crc / lease_stale_round are its "
                 "only compositions)")

    for attr, flag, item in NOT_PORTED:
        if getattr(args, attr):
            print(f"{flag} is not ported to raft_tpu_torch yet: ROADMAP "
                  f"{item}", file=sys.stderr)
            return 2

    ok = True
    if args.txn:
        for seed in range(args.seed, args.seed + args.sweep):
            rep = txn_run(
                seed, n_groups=args.groups, broken=args.broken,
                step_budget=args.step_budget,
                bundle_dir=args.bundle_dir,
                blackbox_dir=args.blackbox_dir,
                extra_nemeses=args.txn_extra,
                lease_reads=args.txn_lease_reads,
                device=args.device, mesh=_two_shards(args.device),
            )
            print(rep.summary())
            print(json.dumps({
                "seed": seed,
                "verdict": rep.verdict,
                "singles": rep.singles.verdict,
                "txns": rep.txns,
                "committed": rep.committed,
                "aborted": rep.aborted,
                "unresolved": rep.unresolved,
                "conflicts": rep.conflicts,
                "single_ops": rep.single_ops,
                "conserved_ok": rep.conserved_ok,
                "moves": rep.moves,
                "nemeses": rep.nemeses,
                "broken": rep.broken,
                "commit_digest": rep.commit_digest,
                "bundle": rep.bundle_path,
                "read_certs": rep.read_certs,
            }), flush=True)
            if args.broken:
                # the flag's contract: a CAUGHT violation IS success
                ok = ok and rep.caught
            else:
                ok = ok and (
                    rep.verdict == "SERIALIZABLE"
                    and rep.conserved_ok
                    and rep.singles.verdict == "LINEARIZABLE"
                    and rep.committed >= 1
                )
        return 0 if ok else 1
    if args.wire:
        for seed in range(args.seed, args.seed + args.sweep):
            rep = wire_run(
                seed, clients=args.clients, keys=args.keys,
                step_budget=args.step_budget,
                blackbox_dir=args.blackbox_dir,
                bundle_dir=args.bundle_dir, device=args.device,
            )
            print(rep.summary())
            print(json.dumps({
                "seed": seed,
                "verdict": rep.verdict,
                "per_class": {c: r.verdict
                              for c, r in rep.per_class.items()},
                "ops": rep.ops,
                "op_counts": rep.op_counts,
                "shed_writes": rep.shed_writes,
                "not_leader_frames": rep.not_leader_frames,
                "wire_refusals": rep.wire_refusals,
                "leader_kills": rep.leader_kills,
                "net": rep.net,
                "commit_digest": rep.commit_digest,
                "traced": rep.traced,
                "client_spans": rep.client_spans,
                "server_spans": rep.server_spans,
                "bundle": rep.bundle_path,
            }), flush=True)
            ok = ok and (
                rep.verdict == "LINEARIZABLE"
                and rep.shed_writes >= 1
                and rep.not_leader_frames >= 1
            )
        return 0 if ok else 1
    if args.reads:
        for seed in range(args.seed, args.seed + args.sweep):
            rep = reads_run(
                seed, broken=args.broken,
                step_budget=args.step_budget,
                observe=True, bundle_dir=args.bundle_dir,
                blackbox_dir=args.blackbox_dir, device=args.device,
            )
            print(rep.summary())
            print(json.dumps({
                "seed": seed,
                "verdict": rep.verdict,
                "per_class": {c: r.verdict
                              for c, r in rep.per_class.items()},
                "lease_serves": rep.lease_serves,
                "read_index_serves": rep.read_index_serves,
                "session_serves": rep.session_serves,
                "refused_stale": rep.refused_stale,
                "stale_served": rep.stale_served,
                "audit_violations": rep.audit_violations,
                "ops": rep.ops,
            }), flush=True)
            if args.broken == "lease_skew":
                # the flag's contract: a caught stale serve IS success
                ok = ok and rep.caught
            else:
                ok = ok and (
                    rep.verdict == "LINEARIZABLE"
                    and rep.refused_stale >= 1
                    and rep.lease_serves > 0
                    and rep.session_serves > 0
                )
        return 0 if ok else 1
    if args.segments:
        for seed in range(args.seed, args.seed + args.sweep):
            rep = segment_storage_run(
                seed, step_budget=args.step_budget,
                observe=args.observe, bundle_dir=args.bundle_dir,
                blackbox_dir=args.blackbox_dir, device=args.device,
            )
            print(rep.summary())
            print(json.dumps({
                "seed": seed,
                "verdict": rep.verdict,
                "rejoined": rep.rejoined,
                "recovered_via_rs": rep.recovered_via_rs,
                "faults": rep.faults,
                "tier": rep.tier,
                "chunks_shipped": rep.chunks_shipped,
                "ops": rep.ops,
            }), flush=True)
            ok = ok and (
                rep.verdict == "LINEARIZABLE" and rep.rejoined
                and rep.recovered_via_rs
            )
        return 0 if ok else 1
    if args.migration:
        for seed in range(args.seed, args.seed + args.sweep):
            rep = migration_run(
                seed, n_groups=args.groups, mesh=_two_shards(args.device),
                clients=args.clients, keys=args.keys,
                step_budget=args.step_budget,
                observe=args.observe, bundle_dir=args.bundle_dir,
                blackbox_dir=args.blackbox_dir, device=args.device,
            )
            print(rep.summary())
            print(json.dumps({
                "seed": seed,
                "verdict": rep.verdict,
                "progress_ok": rep.progress_ok,
                "moves": rep.moves,
                "n_shards": rep.n_shards,
                "ops": rep.ops,
                "op_counts": rep.op_counts,
            }), flush=True)
            ok = ok and (
                rep.verdict == "LINEARIZABLE" and rep.progress_ok
            )
        return 0 if ok else 1
    if args.reconfig:
        for seed in range(args.seed, args.seed + args.sweep):
            rep = reconfig_run(
                seed, step_budget=args.step_budget,
                observe=args.observe, bundle_dir=args.bundle_dir,
                blackbox_dir=args.blackbox_dir, device=args.device,
            )
            print(rep.summary())
            print(json.dumps({
                "seed": seed,
                "verdict": rep.verdict,
                "availability_ok": rep.availability_ok,
                "events": rep.events,
                "promote_s": rep.promote_s,
                "replace_promote_s": rep.replace_promote_s,
                "ops": rep.ops,
                "op_counts": rep.op_counts,
            }), flush=True)
            ok = ok and (
                rep.verdict == "LINEARIZABLE" and rep.availability_ok
            )
        return 0 if ok else 1
    if args.overload_recovery is not None:
        for seed in range(args.seed, args.seed + args.sweep):
            rep = overload_run(
                seed, rate_mult=args.overload_recovery,
                step_budget=args.step_budget,
                observe=args.observe, bundle_dir=args.bundle_dir,
                blackbox_dir=args.blackbox_dir, device=args.device,
            )
            print(rep.summary())
            print(json.dumps({
                "seed": seed,
                "verdict": rep.verdict,
                "rate_mult": rep.rate_mult,
                "baseline_goodput": rep.baseline_goodput,
                "overload_goodput": rep.overload_goodput,
                "recovery_goodput": rep.recovery_goodput,
                "shed": rep.shed,
                "queue_depth_max": rep.queue_depth_max,
                "depth_bound": rep.depth_bound,
                "recovered_in_s": rep.recovered_in_s,
                "recovery_ok": rep.recovery_ok,
            }), flush=True)
            ok = ok and (
                rep.verdict == "LINEARIZABLE" and rep.recovery_ok
                and rep.queue_depth_max <= rep.depth_bound
            )
        return 0 if ok else 1

    audit = args.audit or args.broken == "commit_rewind"
    #   commit_rewind's whole point is a fault the offline checker
    #   usually CANNOT see (no client-visible effect): the success
    #   criterion is the online auditor tripping, so the audit plane is
    #   implied on
    expect = ("VIOLATION" if args.broken == "dirty_reads"
              else "LINEARIZABLE")
    for seed in range(args.seed, args.seed + args.sweep):
        if args.multi:
            rep = torture_run_multi(
                seed, n_groups=args.groups, phases=args.phases,
                clients=args.clients, keys=args.keys,
                phase_s=args.phase_s, overload=args.overload,
                step_budget=args.step_budget,
                observe=args.observe,
                observe_device=args.observe_device,
                audit=audit,
                observe_compile=args.observe_compile,
                bundle_dir=args.bundle_dir,
                blackbox_dir=args.blackbox_dir,
                device=args.device,
            )
        else:
            rep = torture_run(
                seed, phases=args.phases, clients=args.clients,
                keys=args.keys, phase_s=args.phase_s,
                crash=not args.no_crash, msg_faults=not args.no_msg,
                storage_faults=not args.no_storage, broken=args.broken,
                overload=args.overload, membership=args.membership,
                reads=args.read_plane,
                step_budget=args.step_budget,
                observe=args.observe,
                observe_device=args.observe_device,
                audit=audit,
                observe_compile=args.observe_compile,
                bundle_dir=args.bundle_dir,
                blackbox_dir=args.blackbox_dir,
                device=args.device,
            )
        violations = (
            rep.obs.audit.total_violations
            if rep.obs is not None and rep.obs.audit is not None else None
        )
        print(rep.summary())
        print(json.dumps({
            "seed": seed,
            "verdict": rep.verdict,
            "expected": expect,
            "ops": rep.ops,
            "op_counts": rep.op_counts,
            "crashes": rep.crashes,
            "msg_stats": rep.msg_stats,
            "shed_ops": rep.shed_ops,
            "open_loop_ops": rep.open_loop_ops,
            "membership_ops": rep.membership_ops,
            "checker_steps": rep.check.steps,
            "audit_violations": violations,
            **(
                {
                    "compiles": rep.obs.compile.total_compiles,
                    "compile_violations":
                        len(rep.obs.compile.sentinel.violations),
                }
                if rep.obs is not None and rep.obs.compile is not None
                else {}
            ),
        }), flush=True)
        if args.broken == "commit_rewind":
            ok = ok and bool(violations)
        elif args.broken:
            ok = ok and rep.verdict == expect
        else:
            ok = ok and rep.verdict == expect and not violations
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
