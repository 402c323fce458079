"""A key-sharded replicated KV store over G Raft groups — the
production-store shape (TiKV/CockroachDB style) on the multi-Raft
subsystem (a copy of ``raft_tpu/examples/kv_sharded.py`` over the port's
``multi`` and ``examples.kv``).

One ``ReplicatedKV`` tops out at its single group's commit stream;
``ShardedKV`` hashes every key onto one of G independent groups
(``multi.Router``), so G commit streams run concurrently — and on this
engine, *in the same batched device launches* (``multi.MultiEngine``).
The wire format and dict state machine are ``examples.kv``'s exactly
(``encode_op`` / ``apply_op``): a per-group shard of this store is
bitwise the single-group store over that group's log.

Usage:

    eng = MultiEngine(cfg, n_groups=4)   # device="cpu" off the card
    # or sharded: cfg with transport="mesh_groups" and
    # mesh=GroupMesh(["cuda:0", "cuda:0"]) (two shards on one card)
    eng.seed_leaders()                    # round-robin leader placement
    kv = ShardedKV(eng)
    g, seq = kv.set(b"color", b"green")
    eng.run_until_committed(g, seq)
    kv.get(b"color")                      # b"green"

Consistency contract per key (same as ``ReplicatedKV``, scoped to the
key's group): ``get`` serves LOCAL applied state — never an un-durable
write, but possibly stale; ``linearizable_get`` confirms the group's
leadership first (per-group ReadIndex) and reflects every write
acknowledged before it was issued. Cross-key (cross-group) reads carry
NO ordering relation — exactly the per-shard consistency a sharded
store offers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.examples.kv import _DELETE, _SET, apply_op, encode_op
from raft_tpu_torch.multi.engine import MultiEngine
from raft_tpu_torch.multi.router import Router


class ShardedKV:
    """Dict-shaped state machine sharded over G replicated logs."""

    def __init__(self, engine: MultiEngine, router: Optional[Router] = None,
                 replay: bool = False):
        self.engine = engine
        self.router = router if router is not None else Router(engine)
        self._data: List[Dict[bytes, bytes]] = [
            {} for _ in range(engine.G)
        ]
        self.last_applied = [0] * engine.G
        for g in range(engine.G):
            engine.register_apply(g, self._make_apply(g), replay=replay)

    def _make_apply(self, g: int):
        def _apply(index: int, payload: bytes) -> None:
            apply_op(self._data[g], payload)
            self.last_applied[g] = index
        return _apply

    # ------------------------------------------------------------ client
    def set(self, key: bytes, value: bytes) -> Tuple[int, int]:
        """Queue a SET on the key's group; returns ``(group, seq)``.
        Durable (and visible to ``get``) once
        ``engine.is_durable(group, seq)``."""
        return self.router.submit(
            key, encode_op(self.engine.cfg.entry_bytes, _SET, key, value)
        )

    def delete(self, key: bytes) -> Tuple[int, int]:
        return self.router.submit(
            key, encode_op(self.engine.cfg.entry_bytes, _DELETE, key, b"")
        )

    def set_many(
        self, items: Sequence[Tuple[bytes, bytes]]
    ) -> List[Tuple[int, int]]:
        """Batched SETs: group-bucketed through ``Router.submit_many``
        (one leadership check per group; same-tick replication batches
        across groups on device). Returns ``(group, seq)`` per item in
        input order."""
        eb = self.engine.cfg.entry_bytes
        return self.router.submit_many(
            [(k, encode_op(eb, _SET, k, v)) for k, v in items]
        )

    def get(self, key: bytes) -> Optional[bytes]:
        """Read the key's group-LOCAL applied state: never an un-durable
        write, but possibly stale (see module docstring)."""
        return self._data[self.router.group_of(key)].get(key)

    def linearizable_get(self, key: bytes) -> Optional[bytes]:
        """Linearizable read of one key: the key's group confirms
        leadership (per-group ReadIndex) and the value serves only from
        state applied to at least the read index. Raises
        ``multi.NotLeader`` (after the router's retries) when the group
        cannot confirm, ``RuntimeError`` if the apply stream lags the
        read index."""
        g, idx = self.router.read_index(key)
        if self.last_applied[g] < idx:
            raise RuntimeError(
                f"group {g} apply stream at {self.last_applied[g]} has "
                f"not reached read index {idx}"
            )
        return self._data[g].get(key)

    def get_many(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        """Batched local reads, aligned with ``keys``."""
        return [self.get(k) for k in keys]

    def __len__(self) -> int:
        return sum(len(d) for d in self._data)
