"""The cluster tier (port of ``raft_tpu/cluster``). Two seams are ported:
the storage seam's production backend (``cluster.storage.RealIO``, which
the tiered archive writes through) and the wire seam
(``cluster.netfault``: ``RealConn``, ``FaultyConn``, ``NetFaults`` and the
plan files, which ``net/server.py`` wraps every accepted connection in);
the multi-process cluster comes with ROADMAP A17d. This package's
``__init__`` imports nothing, so ``net/server.py`` can resolve the wire
seam lazily without completing a cluster package first."""
