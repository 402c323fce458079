"""A replicated key-value store — the canonical Raft application, built
entirely on the public engine API (the port's copy of
``raft_tpu/examples/kv.py``: the same wire format, byte for byte, over
``raft_tpu_torch.raft.RaftEngine``).

The reference replicates bare random ints and never applies them to
anything (SURVEY §2: "there is no state machine"; main.go:92,149). This
example is what the missing layer looks like: operations are encoded into
fixed-size log entries, submitted through the engine, and applied to a
dict **only once committed** — so every replica of the state machine
(here, every process that replays the same log) converges to the same
map, and a read served from the applied state never shows an
un-durable write.

Usage:

    eng = RaftEngine(cfg)                 # on CUDA; or pass a CPU transport
    kv = ReplicatedKV(eng)
    eng.run_until_leader()
    seq = kv.set(b"color", b"green")
    eng.run_until_committed(seq)
    kv.get(b"color")                      # b"green"

Restart: build the engine with ``RaftEngine.restore`` and pass
``replay=True`` — the store rebuilds from the archived committed tail.

Entry encoding (fits one fixed-size log entry, entry_bytes >= 6):
``[op u8][klen u16][vlen u16][key][value]`` zero-padded; op 1 = SET,
op 2 = DELETE. Zero padding is self-delimiting because op 0 is invalid
(an all-zero heartbeat entry is ignored).

Ops 3-6 are CLAIMED by the transaction plane of the JAX package
(LOCK=3, COMMIT=4, ABORT=5, DECIDE=6 — docs/TXN.md); a new plain-KV op
must start at 7. This store ignores them (unknown op = no-op on apply),
so typed transaction entries can share the log without forking the wire
format.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

from raft_tpu_torch.raft.engine import RaftEngine

_SET, _DELETE = 1, 2
_HDR = struct.Struct("<BHH")


def encode_op(entry_bytes: int, op: int, key: bytes, value: bytes) -> bytes:
    """One KV operation as a fixed-size log entry (module docstring
    format)."""
    body = _HDR.pack(op, len(key), len(value)) + key + value
    if len(body) > entry_bytes:
        raise ValueError(f"op needs {len(body)} bytes, entries are {entry_bytes}")
    return body + bytes(entry_bytes - len(body))


def decode_op(payload: bytes):
    """Decode one log entry back into ``(op, key, value)`` — ``(0, b"",
    None)`` for padding/heartbeat entries, ``value=None`` for deletes."""
    op, klen, vlen = _HDR.unpack_from(payload)
    if op not in (_SET, _DELETE):
        return 0, b"", None
    key = payload[_HDR.size:_HDR.size + klen]
    if op == _DELETE:
        return op, key, None
    return op, key, payload[_HDR.size + klen:_HDR.size + klen + vlen]


def apply_op(data: Dict[bytes, bytes], payload: bytes) -> None:
    """Apply one committed entry to a dict state machine (op 0 =
    padding/heartbeat: ignore)."""
    op, klen, vlen = _HDR.unpack_from(payload)
    if op == _SET:
        k = payload[_HDR.size:_HDR.size + klen]
        data[k] = payload[_HDR.size + klen:_HDR.size + klen + vlen]
    elif op == _DELETE:
        data.pop(payload[_HDR.size:_HDR.size + klen], None)


class ReplicatedKV:
    """Dict-shaped state machine over the replicated log."""

    def __init__(self, engine: RaftEngine, replay: bool = False):
        self.engine = engine
        self._data: Dict[bytes, bytes] = {}
        self.last_applied = 0
        engine.register_apply(self._apply, replay=replay)

    # ------------------------------------------------------------ client
    def _encode(self, op: int, key: bytes, value: bytes) -> bytes:
        return encode_op(self.engine.cfg.entry_bytes, op, key, value)

    def set(self, key: bytes, value: bytes, client=None) -> int:
        """Queue a SET; returns the engine seq. Durable (and visible to
        ``get``) once the engine commits it — check
        ``engine.is_durable(seq)`` or run until committed. ``client``
        is the opaque id the admission gate's fair-share accounting
        keys on (``raft_tpu_torch.admission``); with admission configured
        the submit may raise ``Overloaded`` before anything is queued."""
        return self.engine.submit(self._encode(_SET, key, value),
                                  client=client)

    def delete(self, key: bytes, client=None) -> int:
        return self.engine.submit(self._encode(_DELETE, key, b""),
                                  client=client)

    def get(self, key: bytes) -> Optional[bytes]:
        """Read from LOCAL applied (committed) state.

        Weaker contract than ``linearizable_get``: it never shows a
        write that could still be lost to a leadership change, but it
        can be arbitrarily STALE — on a partitioned/minority-side engine
        mirror nothing proves a fresher write hasn't committed on the
        majority side. Use ``linearizable_get`` when the read must
        reflect every write acknowledged before it was issued."""
        return self._data.get(key)

    def linearizable_get(self, key: bytes) -> Optional[bytes]:
        """Linearizable read (ReadIndex, dissertation §6.4): the engine
        confirms leadership with a quorum round and returns a read index;
        the value is served only from state applied to at least that
        index. Raises ``raft_tpu_torch.raft.engine.LinearizableReadRefused``
        when leadership cannot be confirmed (no leader, deposed, or a
        quorum is unreachable — e.g. from the minority side of a
        partition), and ``RuntimeError`` if the apply stream is paused
        behind an archive gap below the read index."""
        idx = self.engine.read_linearizable()
        if self.last_applied < idx:
            raise RuntimeError(
                f"apply stream at {self.last_applied} has not reached "
                f"read index {idx} (archive gap)"
            )
        return self._data.get(key)

    def __len__(self) -> int:
        return len(self._data)

    # ------------------------------------------------------ state machine
    def _apply(self, index: int, payload: bytes) -> None:
        apply_op(self._data, payload)
        self.last_applied = index
