"""Worked examples on the port's engines: the replicated key-value store,
the exactly-once counter and the key-sharded store over ``MultiEngine``
(copies of ``raft_tpu/examples/kv.py``, ``sessions.py`` and
``kv_sharded.py``)."""

from raft_tpu_torch.examples.kv import ReplicatedKV, apply_op, decode_op, encode_op
from raft_tpu_torch.examples.kv_sharded import ShardedKV
from raft_tpu_torch.examples.sessions import (
    ReplicatedCounter,
    SessionedStateMachine,
)

__all__ = [
    "ReplicatedKV", "ShardedKV", "ReplicatedCounter",
    "SessionedStateMachine", "apply_op", "decode_op", "encode_op",
]
