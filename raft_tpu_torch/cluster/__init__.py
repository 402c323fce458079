"""Multi-process cluster mode: replicas as wire peers (port of
``raft_tpu/cluster``; docs/CLUSTER.md).

One OS process per replica, inter-replica traffic as ``PEER_*`` frames
on the same length-prefixed protocol the client tier speaks — no
collectives, no process-group rendezvous, no device state. The pieces:

- :mod:`raft_tpu_torch.cluster.node` — the host-level replica: Raft roles
  and timers, a fixed-record log with a write-ahead log, mirrored into a
  :class:`TieredStore` for the durable-across-restart segment handoff,
  and the ingest-server backend surface so the SAME wire tier serves
  clients.
- :mod:`raft_tpu_torch.cluster.dialer` — outbound peer connections with
  reconnect + backoff + ``PEER_HELLO`` auth.
- :mod:`raft_tpu_torch.cluster.auth` — shared-token verification and the
  TLS context seam.
- :mod:`raft_tpu_torch.cluster.supervisor` — spawn / ``kill -9`` /
  SIGSTOP / restart real OS processes, with the crash-loop fast-fail
  guard.
- :mod:`raft_tpu_torch.cluster.child` — the per-process entrypoint
  (``python -m raft_tpu_torch.cluster.child``).
- :mod:`raft_tpu_torch.cluster.storage` and
  :mod:`raft_tpu_torch.cluster.netfault` — the storage and wire seams
  (``RealIO``/``FaultyIO``, ``RealConn``/``FaultyConn``).

The names of ``__all__`` resolve on first use: ``net/server.py`` imports
``cluster.netfault`` and ``ckpt/tiered.py`` ``cluster.storage`` without
loading ``node.py``, which imports both of them back.
"""

from raft_tpu_torch._lazy import exports

__all__ = [
    "ClusterAuth", "PeerAuthError", "RaftNode", "pack_record",
    "unpack_record", "ClusterBroken", "ClusterSupervisor",
]

__getattr__ = exports(__name__, {
    "ClusterAuth": "auth", "PeerAuthError": "auth",
    "RaftNode": "node", "pack_record": "node", "unpack_record": "node",
    "ClusterBroken": "supervisor", "ClusterSupervisor": "supervisor",
})
