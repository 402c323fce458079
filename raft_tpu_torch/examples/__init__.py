"""Worked examples on the port's engine: the replicated key-value store
and the exactly-once counter (copies of ``raft_tpu/examples/kv.py`` and
``sessions.py``). The sharded store waits for the multi-group engine
(ROADMAP A14)."""

from raft_tpu_torch.examples.kv import ReplicatedKV, apply_op, decode_op, encode_op
from raft_tpu_torch.examples.sessions import (
    ReplicatedCounter,
    SessionedStateMachine,
)

__all__ = [
    "ReplicatedKV", "ReplicatedCounter", "SessionedStateMachine",
    "apply_op", "decode_op", "encode_op",
]
