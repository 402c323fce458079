"""Per-replica entrypoint: ``python -m raft_tpu_torch.cluster.child`` (port
of ``raft_tpu/cluster/child.py``).

One process = one :class:`RaftNode` fronted by one ``IngestServer`` on
one port (clients and peers share it — ``CAP_PEER`` gates the peer
kinds). The process is built to die: every phase marks the blackbox
journal BEFORE it runs (so a ``kill -9`` leaves a last line naming the
in-flight phase), a :class:`StallWatchdog` hard-exits a wedged child
with stacks dumped, and the ready file is written only after the
server is actually accepting — the supervisor's crash-loop counter
keys off it.

The ticker task is load-bearing, not cosmetic: the ingest pump sleeps
on its wakeup event while no client traffic is in flight, so election
timeouts and heartbeats would NEVER fire from the pump alone. The
ticker advances the node's timers every ``heartbeat_s / 2``, drains
the outbox through the dialer, and pets the watchdog.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from raft_tpu_torch.cluster.auth import ClusterAuth
from raft_tpu_torch.cluster.dialer import PeerDialer
from raft_tpu_torch.cluster.netfault import NetFaults
from raft_tpu_torch.cluster.node import RaftNode
from raft_tpu_torch.cluster.storage import DiskFailStop, FaultyIO
from raft_tpu_torch.net.server import IngestServer, PeerBackend
from raft_tpu_torch.obs import blackbox


async def serve(spec: dict, node_id: int) -> None:
    blackbox.mark("child_build", node=node_id)
    peers = {int(i): addr for i, addr in spec["nodes"].items()}
    data_dir = os.path.join(spec["dir"], f"n{node_id}")
    os.makedirs(data_dir, exist_ok=True)
    # the storage-nemesis hook: a fault plan at <data_dir>/disk.json
    # swaps the lying disk in under EVERY durable write this process
    # makes — absent the file, the seam is the real OS, full stop
    io = (FaultyIO(data_dir)
          if os.path.exists(os.path.join(data_dir, "disk.json"))
          else None)
    if io is not None:
        blackbox.mark("faulty_io_armed", node=node_id, plan=io.plan)
    # the network-nemesis hook, same contract one layer out: a fault
    # plan at <data_dir>/net.json puts the lying network under every
    # socket this process opens (peer dials AND accepted conns) —
    # absent the file at boot, the seam is the raw asyncio transport
    nf = (NetFaults(data_dir)
          if os.path.exists(os.path.join(data_dir, "net.json"))
          else None)
    if nf is not None:
        blackbox.mark("net_faults_armed", node=node_id)
    node = RaftNode(
        node_id, peers, data_dir,
        heartbeat_s=spec.get("heartbeat_s", 0.05),
        election_timeout_s=spec.get("election_timeout_s", 0.3),
        snap_threshold=spec.get("snap_threshold"),
        segment_entries=spec.get("segment_entries", 64),
        hot_entries=spec.get("hot_entries", 256),
        io=io,
        wal_group_commit=spec.get("wal_group_commit", True),
    )
    blackbox.mark("child_adopted", node=node_id,
                  generation=node.generation,
                  adopted=node.store.stats["segments_adopted"],
                  commit=node.commit)
    auth = ClusterAuth(
        spec.get("token", "").encode(),
        certfile=spec.get("tls_cert"), keyfile=spec.get("tls_key"),
        cafile=spec.get("tls_ca"),
    )
    dialer = PeerDialer(node, auth, netfaults=nf)
    host, _, port = peers[node_id].rpartition(":")
    server = IngestServer(
        node, host=host or "127.0.0.1", port=int(port),
        peer=PeerBackend(node, auth),
        ssl=auth.server_ssl(),     # None when no certs configured
        netfaults=nf,
    )
    blackbox.mark("child_bind", node=node_id, port=int(port))
    await server.start()

    ready = os.path.join(spec["dir"], f"ready-{node_id}.json")
    tmp = ready + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "port": server.port,
                   "generation": node.generation}, f)
    os.replace(tmp, ready)
    blackbox.mark("child_ready", node=node_id, port=server.port,
                  generation=node.generation)

    watchdog = blackbox.StallWatchdog(
        deadline_s=spec.get("stall_deadline_s", 30.0),
        tag=f"cluster-n{node_id}",
        journal=blackbox.get_journal(),
        hard_exit_code=86,
    ).arm()
    interval = node.hb_s / 2
    # the cross-process status surface: an atomically-replaced snapshot
    # the supervisor (and the chaos drill's evidence collector) can read
    # without a wire round-trip — a dead or paused child simply stops
    # refreshing it, which is itself signal
    status_path = os.path.join(spec["dir"], f"status-{node_id}.json")
    status_tmp = status_path + f".tmp{os.getpid()}"
    status_every = max(1, int(0.5 / interval))
    last_role = node.role
    ticks = 0
    try:
        while True:
            node.tick(node.now())
            # laggard fallback for group commit: acks whose shared
            # fsync somehow wasn't scheduled by the peer backend ride
            # the dialer's outbound links at the next half-heartbeat
            for p, frame in node.flush_wal():
                node.outbox.append((p, frame))
            dialer.pump_outbox()
            watchdog.pet()
            if node.role != last_role:
                blackbox.mark("role_change", node=node_id,
                              role=node.role, term=node.term)
                last_role = node.role
            ticks += 1
            if ticks % status_every == 0:
                try:
                    st = node.status()
                    # wire-health diagnostics ride the same snapshot:
                    # buffered-frame drops and redial counts are the
                    # first thing to look at under a trickle fault
                    st["dialer"] = dict(dialer.stats)
                    st["net_faults"] = dict(nf.stats) if nf else {}
                    with open(status_tmp, "w") as f:
                        json.dump(st, f)
                    os.replace(status_tmp, status_path)
                except OSError:
                    pass
            await asyncio.sleep(interval)
    finally:
        watchdog.disarm()
        await dialer.close()
        await server.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True)
    ap.add_argument("--node", type=int, required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    with blackbox.journal_for(
        f"cluster-n{args.node}",
        proc=f"cluster-n{args.node}",
    ):
        blackbox.mark("child_start", node=args.node, pid=os.getpid())
        try:
            asyncio.run(serve(spec, args.node))
        except KeyboardInterrupt:
            pass
        except DiskFailStop as ex:
            # the disk's state is unknowable (fsync EIO): the death
            # certificate is already on disk — exit distinctly so the
            # supervisor can tell fail-stop from a crash loop
            blackbox.mark("child_fail_stop", node=args.node,
                          error=str(ex))
            return 97
    return 0


if __name__ == "__main__":
    sys.exit(main())
