"""The cluster tier (port of ``raft_tpu/cluster``). Only the storage
seam's production backend is ported (``cluster.storage.RealIO``, which the
tiered archive writes through); the multi-process cluster comes with
ROADMAP A17. This package's ``__init__`` imports nothing."""
