"""Transaction log-entry encodings: the participant plane's wire format
(the port's copy of ``raft_tpu/txn/ops.py``: the same bytes).

Cross-group transactions (docs/TXN.md) ride the groups' OWN replicated
logs as typed entries, extending ``examples.kv``'s op space (op 1 = SET,
op 2 = DELETE) with four transactional ops:

- ``OP_LOCK`` (3): prewrite — lock one key and stage its intent (the
  new value, or a delete, or nothing for a read-only lock) under a
  transaction id and a TTL deadline. First LOCK to APPLY wins the key:
  apply order is log order, so every replica resolves a prewrite race
  identically, and a coordinator learns it lost by finding someone
  else's lock where its own should be.
- ``OP_COMMIT`` (4) / ``OP_ABORT`` (5): release — roll the txn's locks
  in THIS group forward (apply staged intents) or back (discard them).
  Idempotent: releasing a txn that holds no locks is a no-op, so a
  resolver and a slow coordinator can both release safely.
- ``OP_DECIDE`` (6): the commit/abort decision record, replicated in
  the designated decision group only. First decision to apply wins
  (``TxnShardedKV`` ignores later ones), which is what makes
  coordinator crash-restore replay to the SAME verdict: the decision
  group's log is the single serialization point.

All four ops are invisible to the plain stores: ``kv.decode_op``
returns padding for op codes it does not speak and ``kv.apply_op``
no-ops them, so a log carrying txn entries replays byte-identically
through a plain ``ShardedKV`` / the read-audit feed (the txn-off
byte-identity pin in tests/test_txn.py).

Encodings (fixed-size entries, zero-padded like ``kv.encode_op``):

- LOCK:    ``[op u8][txn_id u32][deadline f64][flags u8][klen u8]
  [vlen u8][key][value]`` (16-byte header)
- COMMIT/ABORT: ``[op u8][txn_id u32]`` (5 bytes)
- DECIDE:  ``[op u8][txn_id u32][verdict u8][group_mask u32]``
  (10 bytes; the mask names the participant groups a resolver must
  release — G <= 32)
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

from raft_tpu_torch.admission.gate import Overloaded

OP_LOCK = 3
OP_COMMIT = 4
OP_ABORT = 5
OP_DECIDE = 6

TXN_OPS = (OP_LOCK, OP_COMMIT, OP_ABORT, OP_DECIDE)

#: LOCK flag bits: the staged intent writes (else the lock is
#: read-only), and the write is a delete.
FLAG_WRITE = 0x01
FLAG_DELETE = 0x02

VERDICT_COMMIT = 1
VERDICT_ABORT = 2

_LOCK_HDR = struct.Struct("<BIdBBB")     # 16 bytes
_REL_HDR = struct.Struct("<BI")          # 5 bytes
_DEC_HDR = struct.Struct("<BIBI")        # 10 bytes


class LockConflict(Overloaded):
    """A transactional submit refused because a LIVE lock held by
    another transaction covers one of its keys. Raised BEFORE anything
    is queued — the admission gate's provably-no-effect contract, which
    is exactly what lets the serializability checker grade a refused
    transaction as a no-op. ``retry_after_s`` hints the remaining lock
    TTL (the earliest the conflict can possibly clear without a
    decision)."""

    def __init__(self, key: bytes, holder: int, retry_after_s: float,
                 group: Optional[int] = None):
        super().__init__(
            "txn_lock", retry_after_s,
            detail=f"key {key!r} locked by txn {holder}", group=group,
        )
        self.key = key
        self.holder = holder


class LockRecord(NamedTuple):
    """One decoded LOCK entry."""

    txn_id: int
    deadline: float
    flags: int
    key: bytes
    value: bytes


class DecisionRecord(NamedTuple):
    """One decoded DECIDE entry."""

    txn_id: int
    commit: bool
    group_mask: int


def _pad(entry_bytes: int, body: bytes) -> bytes:
    if len(body) > entry_bytes:
        raise ValueError(
            f"txn op needs {len(body)} bytes, entries are {entry_bytes}"
        )
    return body + bytes(entry_bytes - len(body))


def encode_lock(entry_bytes: int, txn_id: int, key: bytes,
                value: Optional[bytes], deadline: float,
                delete: bool = False) -> bytes:
    """One prewrite entry. ``value=None`` stages no write (a read-only
    lock) unless ``delete`` is set."""
    flags = 0
    staged = b""
    if delete:
        flags = FLAG_WRITE | FLAG_DELETE
    elif value is not None:
        flags = FLAG_WRITE
        staged = value
    if len(key) > 0xFF or len(staged) > 0xFF:
        raise ValueError("txn keys/values are limited to 255 bytes")
    body = _LOCK_HDR.pack(OP_LOCK, txn_id, deadline, flags,
                          len(key), len(staged)) + key + staged
    return _pad(entry_bytes, body)


def encode_release(entry_bytes: int, commit: bool, txn_id: int) -> bytes:
    """One release entry: roll the txn's locks in the receiving group
    forward (``commit=True``) or back."""
    return _pad(entry_bytes, _REL_HDR.pack(
        OP_COMMIT if commit else OP_ABORT, txn_id
    ))


def encode_decision(entry_bytes: int, txn_id: int, commit: bool,
                    group_mask: int) -> bytes:
    """The replicated decision record (decision group only)."""
    return _pad(entry_bytes, _DEC_HDR.pack(
        OP_DECIDE, txn_id,
        VERDICT_COMMIT if commit else VERDICT_ABORT, group_mask,
    ))


def decode_lock(payload: bytes) -> LockRecord:
    op, txn_id, deadline, flags, klen, vlen = _LOCK_HDR.unpack_from(
        payload
    )
    off = _LOCK_HDR.size
    return LockRecord(txn_id, deadline, flags,
                      payload[off:off + klen],
                      payload[off + klen:off + klen + vlen])


def decode_release(payload: bytes):
    """``(commit, txn_id)``."""
    op, txn_id = _REL_HDR.unpack_from(payload)
    return op == OP_COMMIT, txn_id


def decode_decision(payload: bytes) -> DecisionRecord:
    op, txn_id, verdict, mask = _DEC_HDR.unpack_from(payload)
    return DecisionRecord(txn_id, verdict == VERDICT_COMMIT, mask)
