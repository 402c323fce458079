"""Length-prefixed binary wire protocol for the data plane (port of
``raft_tpu/net/protocol.py``: a pure byte codec, so every frame kind,
capability bit, message and byte is the JAX module's).

One frame = an 8-byte header (``!HBBI``: magic, protocol version, kind,
payload length) followed by ``length`` payload bytes. The framing is
deliberately dumb: no compression, no TLVs, no varints — a reader can
always tell "incomplete" (wait for more bytes) from "corrupt" (bad
magic/version: the stream can never resynchronize, close it) from
"hostile" (a length past the configured bound: refuse before buffering,
the oversized-payload backstop). docs/NETWORK.md carries the full
frame table and the backpressure contract.

Request frames carry a client-chosen ``req_id`` (u64) echoed verbatim
on exactly one response frame, so responses pipeline back out of order
over one connection while the client completes them by id.

Read classes ride the wire twice: the REQUEST class is what the client
asked for (``linearizable`` / ``any`` / ``session``), the SERVED class
on the response is what certification actually cost (``read_index`` /
``lease`` / ``follower`` / ``session`` — the docs/READS.md matrix), so
a wire client sees the same per-class accounting the in-process Router
reports.

Session tokens (``multi.router.ReadSession`` floors) are plain
``(group, index)`` pairs: a client sends its floors in ``HELLO`` (the
reconnect-and-resume carry), and every ``OK``/``VALUE`` response
returns the one floor it raised, so the client-side token stays current
without a dedicated token round-trip.

Trace context (Dapper-style propagation, docs/OBSERVABILITY.md "Wire
plane"): any frame may carry a compact 17-byte context — trace id
(u64), parent span id (u64), flags (u8, bit 0 = sampled) — flagged by
the ``TRACE_FLAG`` high bit on the kind byte and prepended to the
payload. The context is NEGOTIATED, never assumed: a client advertises
``CAP_TRACE`` in a capability byte appended to ``HELLO``, the server
echoes the intersection on ``WELCOME``, and only then do either side's
frames carry contexts. The capability byte is strictly additive — a
HELLO/WELCOME without it is byte-identical to the pre-capability
encoding, and both decoders ignore trailing bytes they do not speak —
so pre-trace peers interoperate byte-for-byte.

The TXN_* and PEER_* frames are encoded and decoded here in full. The
server answers the TXN_* frames once a transaction coordinator
(``raft_tpu_torch.txn``) is attached, and the PEER_* frames once the
cluster's ``PeerBackend`` (``net/server.py``) is; without them it treats them
as unknown kinds, as the JAX server does without them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

MAGIC = 0x5254          # "RT"
VERSION = 1

#: default frame-size bound: anything longer is refused BEFORE it is
#: buffered (FrameTooLarge) — the wire's oversized-payload backstop
MAX_FRAME_BYTES = 1 << 20

# ------------------------------------------------------------- kinds
HELLO = 1        # client -> server: session floors (reconnect carry)
WELCOME = 2      # server -> client: entry_bytes, group count
SUBMIT = 3       # client -> server: one write
READ = 4         # client -> server: one read (request class below)
OK = 5           # server -> client: submit acked DURABLE
VALUE = 6        # server -> client: read served
REFUSED = 7      # server -> client: typed backpressure (no effect)
NOT_LEADER = 8   # server -> client: no routed leader; hint attached
ERROR = 9        # server -> client: protocol violation (conn closes)
SUBMIT_BATCH = 10  # client -> server: many writes, ONE frame
OK_BATCH = 11      # server -> client: batch acked (admitted part durable)
TXN_BEGIN = 12     # client -> server: open a transaction (id allocated)
TXN_COMMIT = 13    # client -> server: commit a txn's write/expect set
TXN_ABORT = 14     # client -> server: abandon an open transaction
TXN_STATUS = 15    # client -> server: decision lookup by txn id
TXN_STATE = 16     # server -> client: txn outcome / status
# peer plane (docs/CLUSTER.md): replica-to-replica RPCs on
# the SAME framed protocol, gated on CAP_PEER — a cluster of N server
# processes replicates through these instead of in-process collectives
PEER_HELLO = 17       # peer -> peer: identify + authenticate
PEER_VOTE = 18        # candidate -> peer: RequestVote
PEER_VOTE_REPLY = 19  # peer -> candidate: vote verdict
PEER_APPEND = 20      # leader -> peer: AppendEntries batch
PEER_APPEND_REPLY = 21  # peer -> leader: success + match index
PEER_SNAP_CHUNK = 22  # leader -> lagging peer: bulk catch-up chunk
PEER_SNAP_ACK = 23    # peer -> leader: resumable-stream floor

KIND_NAMES = {
    HELLO: "hello", WELCOME: "welcome", SUBMIT: "submit", READ: "read",
    OK: "ok", VALUE: "value", REFUSED: "refused",
    NOT_LEADER: "not_leader", ERROR: "error",
    SUBMIT_BATCH: "submit_batch", OK_BATCH: "ok_batch",
    TXN_BEGIN: "txn_begin", TXN_COMMIT: "txn_commit",
    TXN_ABORT: "txn_abort", TXN_STATUS: "txn_status",
    TXN_STATE: "txn_state",
    PEER_HELLO: "peer_hello", PEER_VOTE: "peer_vote",
    PEER_VOTE_REPLY: "peer_vote_reply", PEER_APPEND: "peer_append",
    PEER_APPEND_REPLY: "peer_append_reply",
    PEER_SNAP_CHUNK: "peer_snap_chunk", PEER_SNAP_ACK: "peer_snap_ack",
}

#: high bit on the kind byte: the payload starts with a 17-byte trace
#: context. Only legal after BOTH sides advertised ``CAP_TRACE`` — a
#: pre-trace peer sees an unknown kind and closes, which is why the
#: capability handshake gates every flagged frame.
TRACE_FLAG = 0x80

#: capability bits (client: appended to HELLO; server: the echoed
#: intersection appended to WELCOME). Absent byte = no capabilities —
#: byte-identical to the pre-capability frames.
CAP_TRACE = 0x01
#: the server fronts a transaction coordinator and speaks the TXN_*
#: frames. Same additive contract as CAP_TRACE: a pre-txn
#: peer never sees the bit, never the frames.
CAP_TXN = 0x02
#: the server owns one replica of a multi-process cluster and speaks
#: the PEER_* frames. Same additive contract: a server
#: without a peer backend never advertises the bit, and every PEER
#: frame it receives falls to the unknown-kind close.
CAP_PEER = 0x04
#: peer frames carry a CRC32 trailer (``crc_seal``/``crc_open``,
#: flagged by ``CRC_FLAG`` on the kind byte). Advertised by a dialing
#: peer in a capability byte appended to PEER_HELLO; the server seals
#: its replies on that connection, and the dialer starts sealing once
#: the first flagged frame comes back. Same additive contract again: a
#: pre-CRC peer never advertises, never gets a flagged frame, and the
#: whole exchange stays byte-identical.
CAP_CRC = 0x08

#: second-highest bit on the kind byte: the frame ends with a CRC32
#: trailer over (kind byte + payload). Negotiated via ``CAP_CRC`` —
#: never sent to a peer that did not prove it speaks flagged frames,
#: because a pre-CRC decoder sees an unknown kind and closes.
CRC_FLAG = 0x40


def crc_seal(frame: bytes) -> bytes:
    """Append a CRC32 trailer to one complete encoded frame and set
    ``CRC_FLAG``: header length grows by 4, the trailer covers the
    flagged kind byte + the payload. Idempotent-unsafe by design —
    callers seal exactly once, at the send boundary."""
    magic, version, kind, length = _HEADER.unpack_from(frame)
    kind |= CRC_FLAG
    payload = frame[_HEADER.size:]
    crc = zlib.crc32(bytes((kind,)) + payload)
    return (_HEADER.pack(magic, version, kind, length + 4)
            + payload + struct.pack("!I", crc))


def crc_open(kind: int, payload: bytes) -> Tuple[int, bytes, bool]:
    """Verify + strip a frame's CRC trailer: returns ``(base_kind,
    payload, ok)``. Unflagged frames pass through ``ok=True`` (the
    pre-CRC peer — additive compat). A failed CRC returns ``ok=False``
    and the caller MUST drop the frame unparsed (count it, never
    decode garbage into the log) — Raft's retransmit replaces it."""
    if not kind & CRC_FLAG:
        return kind, payload, True
    if len(payload) < 4:
        return kind & ~CRC_FLAG, b"", False
    body = payload[:-4]
    (want,) = struct.unpack_from("!I", payload, len(payload) - 4)
    ok = zlib.crc32(bytes((kind,)) + body) == want
    return kind & ~CRC_FLAG, body, ok

_TRACE_CTX = struct.Struct("!QQB")
TRACE_CTX_BYTES = _TRACE_CTX.size        # 17


def encode_trace(trace_id: int, span_id: int, sampled: bool) -> bytes:
    return _TRACE_CTX.pack(trace_id, span_id, 1 if sampled else 0)


def split_trace(
    kind: int, payload: bytes
) -> Tuple[int, Optional[Tuple[int, int, bool]], bytes]:
    """Strip a frame's trace context, if flagged: returns
    ``(base_kind, (trace_id, span_id, sampled) | None, payload)``.
    A flagged frame too short to hold the context is corrupt."""
    if not kind & TRACE_FLAG:
        return kind, None, payload
    if len(payload) < TRACE_CTX_BYTES:
        raise ProtocolError(
            f"traced frame payload {len(payload)} B cannot hold the "
            f"{TRACE_CTX_BYTES} B trace context"
        )
    tid, sid, flags = _TRACE_CTX.unpack_from(payload)
    return (kind & ~TRACE_FLAG, (tid, sid, bool(flags & 1)),
            payload[TRACE_CTX_BYTES:])

#: request-side read classes (what the client ASKS for)
READ_CLASSES = {"linearizable": 0, "any": 1, "session": 2}
READ_CLASS_NAMES = {v: k for k, v in READ_CLASSES.items()}

#: response-side served classes (what certification actually COST —
#: all four docs/READS.md classes are representable on the wire)
SERVED_CLASSES = {"read_index": 0, "lease": 1, "follower": 2,
                  "session": 3}
SERVED_CLASS_NAMES = {v: k for k, v in SERVED_CLASSES.items()}

_HEADER = struct.Struct("!HBBI")


class ProtocolError(Exception):
    """The byte stream violates the protocol (bad magic/version,
    malformed payload). Unrecoverable for the connection: framing
    carries no resync marker, so the only safe action is to close."""


class FrameTooLarge(ProtocolError):
    """A header announced a payload past the configured bound. Raised
    BEFORE the payload is buffered — a hostile length can never make
    the server allocate it."""


# ----------------------------------------------------------- framing
def encode_frame(kind: int, payload: bytes,
                 max_frame_bytes: int = MAX_FRAME_BYTES,
                 trace: Optional[Tuple[int, int, bool]] = None) -> bytes:
    """One frame. ``trace=(trace_id, span_id, sampled)`` prepends the
    17-byte trace context and sets ``TRACE_FLAG`` on the kind byte —
    legal only on a connection that negotiated ``CAP_TRACE`` (callers
    gate; an unflagged encode is byte-identical to the pre-trace
    protocol)."""
    if trace is not None:
        payload = encode_trace(*trace) + payload
        kind |= TRACE_FLAG
    if len(payload) > max_frame_bytes:
        raise FrameTooLarge(
            f"{KIND_NAMES.get(kind & ~TRACE_FLAG, kind)} payload "
            f"{len(payload)} B exceeds the {max_frame_bytes} B frame "
            f"bound"
        )
    return _HEADER.pack(MAGIC, VERSION, kind, len(payload)) + payload


class FrameDecoder:
    """Incremental frame parser. ``feed`` returns every COMPLETE frame
    the new bytes finished; a torn tail (header or payload cut mid-way)
    stays buffered until more bytes arrive — ``pending`` exposes how
    many are waiting, so a connection teardown can tell "clean close"
    from "died mid-frame"."""

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES):
        self.max_frame_bytes = max_frame_bytes
        self._buf = bytearray()
        self.frames_in = 0

    @property
    def pending(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf.extend(data)
        out: List[Tuple[int, bytes]] = []
        while True:
            if len(self._buf) < _HEADER.size:
                return out
            magic, version, kind, length = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise ProtocolError(
                    f"bad magic 0x{magic:04x} (expected 0x{MAGIC:04x})"
                )
            if version != VERSION:
                raise ProtocolError(
                    f"unsupported protocol version {version}"
                )
            if length > self.max_frame_bytes:
                raise FrameTooLarge(
                    f"frame announces {length} B payload "
                    f"(bound {self.max_frame_bytes} B)"
                )
            if len(self._buf) < _HEADER.size + length:
                return out                      # torn: wait for bytes
            payload = bytes(self._buf[_HEADER.size:_HEADER.size + length])
            del self._buf[:_HEADER.size + length]
            self.frames_in += 1
            out.append((kind, payload))


# ----------------------------------------------- payload pack helpers
def _pb16(b: bytes) -> bytes:
    if len(b) > 0xFFFF:
        raise ProtocolError(f"field of {len(b)} B exceeds u16 length")
    return struct.pack("!H", len(b)) + b


def _ub16(buf: bytes, off: int) -> Tuple[bytes, int]:
    _need(buf, off, 2)       # a payload cut AT the prefix must raise
    (n,) = struct.unpack_from("!H", buf, off)   # ProtocolError, never
    off += 2                                    # a bare struct.error
    if off + n > len(buf):
        raise ProtocolError("truncated u16-length field")
    return buf[off:off + n], off + n


def _pb32(b: bytes) -> bytes:
    return struct.pack("!I", len(b)) + b


def _ub32(buf: bytes, off: int) -> Tuple[bytes, int]:
    _need(buf, off, 4)
    (n,) = struct.unpack_from("!I", buf, off)
    off += 4
    if off + n > len(buf):
        raise ProtocolError("truncated u32-length field")
    return buf[off:off + n], off + n


def _need(buf: bytes, off: int, n: int) -> None:
    if off + n > len(buf):
        raise ProtocolError("truncated frame payload")


# ------------------------------------------------------------- HELLO
def encode_hello(floors: Optional[Dict[int, int]] = None,
                 caps: int = 0, **kw) -> bytes:
    """``caps=0`` (the default) emits the pre-capability encoding
    byte-for-byte; a nonzero ``caps`` appends one capability byte that
    pre-trace decoders provably ignore (``decode_hello`` reads exactly
    the floor table it was told about)."""
    floors = floors or {}
    parts = [struct.pack("!H", len(floors))]
    parts += [struct.pack("!IQ", g, idx) for g, idx in sorted(floors.items())]
    if caps:
        parts.append(struct.pack("!B", caps))
    return encode_frame(HELLO, b"".join(parts), **kw)


def decode_hello(payload: bytes) -> Dict[int, int]:
    _need(payload, 0, 2)
    (n,) = struct.unpack_from("!H", payload)
    floors: Dict[int, int] = {}
    off = 2
    for _ in range(n):
        _need(payload, off, 12)
        g, idx = struct.unpack_from("!IQ", payload, off)
        floors[g] = idx
        off += 12
    return floors


def decode_hello_caps(payload: bytes) -> Tuple[Dict[int, int], int]:
    """(floors, capability bits) — an absent trailing byte (a pre-
    capability peer) decodes as caps 0, never as an error."""
    floors = decode_hello(payload)
    off = 2 + 12 * len(floors)
    caps = payload[off] if off < len(payload) else 0
    return floors, caps


# ----------------------------------------------------------- WELCOME
def encode_welcome(entry_bytes: int, groups: int, caps: int = 0,
                   **kw) -> bytes:
    """``caps`` is the server's echo of the INTERSECTION of advertised
    capabilities — appended only when nonzero, so the reply to a
    capability-less HELLO is byte-identical to the pre-capability
    WELCOME (the compat pin's contract)."""
    body = struct.pack("!II", entry_bytes, groups)
    if caps:
        body += struct.pack("!B", caps)
    return encode_frame(WELCOME, body, **kw)


def decode_welcome(payload: bytes) -> Tuple[int, int]:
    _need(payload, 0, 8)
    return struct.unpack_from("!II", payload)


def decode_welcome_caps(payload: bytes) -> Tuple[int, int, int]:
    """(entry_bytes, groups, capability bits); absent byte = 0."""
    entry_bytes, groups = decode_welcome(payload)
    caps = payload[8] if len(payload) > 8 else 0
    return entry_bytes, groups, caps


# ------------------------------------------------------------ SUBMIT
def encode_submit(req_id: int, key: bytes, value: bytes, **kw) -> bytes:
    return encode_frame(
        SUBMIT, struct.pack("!Q", req_id) + _pb16(key) + _pb32(value),
        **kw,
    )


def decode_submit(payload: bytes) -> Tuple[int, bytes, bytes]:
    _need(payload, 0, 8)
    (req_id,) = struct.unpack_from("!Q", payload)
    key, off = _ub16(payload, 8)
    value, _ = _ub32(payload, off)
    return req_id, key, value


# ------------------------------------------------------ SUBMIT_BATCH
def encode_submit_batch(req_id: int, items, **kw) -> bytes:
    """Many writes in ONE frame — the client-side half of the batched
    ingest amortization (the macro bench's goodput mechanism: framing
    and event-loop costs amortize over the batch exactly as the fused
    K-tick scan amortizes device launches). Per-entry outcomes are
    summarized, not itemized: use single ``SUBMIT`` frames when every
    op needs its own verdict (the chaos drill does). The body is joined
    once, not grown entry by entry (same bytes, linear in the batch)."""
    parts = [struct.pack("!QH", req_id, len(items))]
    for key, value in items:
        parts.append(_pb16(key))
        parts.append(_pb32(value))
    return encode_frame(SUBMIT_BATCH, b"".join(parts), **kw)


def decode_submit_batch(payload: bytes):
    _need(payload, 0, 10)
    req_id, n = struct.unpack_from("!QH", payload)
    off = 10
    items = []
    for _ in range(n):
        key, off = _ub16(payload, off)
        value, off = _ub32(payload, off)
        items.append((key, value))
    return req_id, items


def encode_ok_batch(req_id: int, accepted: int, shed: int,
                    floors: Dict[int, int], **kw) -> bytes:
    """Batch resolution: every ADMITTED entry is durable; ``shed``
    entries were typed-refused at ingest (no effect, per-reason tallies
    ride the server's net section). ``floors`` carries the commit
    watermark of every group the batch touched — the session raise."""
    parts = [struct.pack("!QIIH", req_id, accepted, shed, len(floors))]
    parts += [struct.pack("!IQ", g, idx) for g, idx in sorted(floors.items())]
    return encode_frame(OK_BATCH, b"".join(parts), **kw)


def decode_ok_batch(payload: bytes):
    _need(payload, 0, 18)
    req_id, accepted, shed, n = struct.unpack_from("!QIIH", payload)
    off = 18
    floors: Dict[int, int] = {}
    for _ in range(n):
        _need(payload, off, 12)
        g, idx = struct.unpack_from("!IQ", payload, off)
        floors[g] = idx
        off += 12
    return req_id, accepted, shed, floors


# -------------------------------------------------------------- READ
def encode_read(req_id: int, cls: str, key: bytes, **kw) -> bytes:
    code = READ_CLASSES.get(cls)
    if code is None:
        raise ProtocolError(f"unknown read class {cls!r}")
    return encode_frame(
        READ, struct.pack("!QB", req_id, code) + _pb16(key), **kw
    )


def decode_read(payload: bytes) -> Tuple[int, str, bytes]:
    _need(payload, 0, 9)
    req_id, code = struct.unpack_from("!QB", payload)
    cls = READ_CLASS_NAMES.get(code)
    if cls is None:
        raise ProtocolError(f"unknown read-class code {code}")
    key, _ = _ub16(payload, 9)
    return req_id, cls, key


# ---------------------------------------------------------------- OK
def encode_ok(req_id: int, group: int, seq: int, floor: int,
              **kw) -> bytes:
    """Submit acknowledged DURABLE. ``floor`` is the group's commit
    watermark at ack time — the session-token raise that buys
    read-your-writes for this write (``Router.note_write_observed``'s
    wire twin)."""
    return encode_frame(
        OK, struct.pack("!QIQQ", req_id, group, seq, floor), **kw
    )


def decode_ok(payload: bytes) -> Tuple[int, int, int, int]:
    _need(payload, 0, 28)
    return struct.unpack_from("!QIQQ", payload)


# ------------------------------------------------------------- VALUE
def encode_value(req_id: int, group: int, index: int, served_cls: str,
                 value: Optional[bytes], **kw) -> bytes:
    code = SERVED_CLASSES.get(served_cls)
    if code is None:
        raise ProtocolError(f"unknown served class {served_cls!r}")
    body = struct.pack(
        "!QIQBB", req_id, group, index, code,
        0 if value is None else 1,
    )
    if value is not None:
        body += _pb32(value)
    return encode_frame(VALUE, body, **kw)


def decode_value(
    payload: bytes,
) -> Tuple[int, int, int, str, Optional[bytes]]:
    _need(payload, 0, 22)
    req_id, group, index, code, has = struct.unpack_from("!QIQBB",
                                                         payload)
    cls = SERVED_CLASS_NAMES.get(code)
    if cls is None:
        raise ProtocolError(f"unknown served-class code {code}")
    value = _ub32(payload, 22)[0] if has else None
    return req_id, group, index, cls, value


# ----------------------------------------------------------- REFUSED
def encode_refused(req_id: int, reason: str, retry_after_s: float,
                   **kw) -> bytes:
    """Typed backpressure: the op provably took NO effect (the
    admission gate's contract, surfaced at the wire). ``retry_after_s``
    is the server-clock hint a well-behaved client floors its backoff
    at (``admission.retry.Backoff.delay``)."""
    return encode_frame(
        REFUSED,
        struct.pack("!Qd", req_id, retry_after_s)
        + _pb16(reason.encode()),
        **kw,
    )


def decode_refused(payload: bytes) -> Tuple[int, str, float]:
    _need(payload, 0, 16)
    req_id, retry_after = struct.unpack_from("!Qd", payload)
    reason, _ = _ub16(payload, 16)
    return req_id, reason.decode(), retry_after


# -------------------------------------------------------- NOT_LEADER
def encode_not_leader(req_id: int, group: int, hint: str = "",
                      **kw) -> bytes:
    """No routed leader for the op's group (or leadership moved
    mid-op). ``hint`` names where to redial — an address when the
    server knows one, else the replica row (``"replica:N"``) — and may
    be empty mid-election."""
    return encode_frame(
        NOT_LEADER,
        struct.pack("!QI", req_id, group) + _pb16(hint.encode()),
        **kw,
    )


def decode_not_leader(payload: bytes) -> Tuple[int, int, str]:
    _need(payload, 0, 12)
    req_id, group = struct.unpack_from("!QI", payload)
    hint, _ = _ub16(payload, 12)
    return req_id, group, hint.decode()


# ------------------------------------------------------------- ERROR
def encode_error(req_id: int, message: str, **kw) -> bytes:
    """Protocol violation or unexpected server failure; ``req_id`` 0
    when the error is connection-level (the server closes after)."""
    return encode_frame(
        ERROR, struct.pack("!Q", req_id) + _pb16(message.encode()), **kw
    )


def decode_error(payload: bytes) -> Tuple[int, str]:
    _need(payload, 0, 8)
    (req_id,) = struct.unpack_from("!Q", payload)
    message, _ = _ub16(payload, 8)
    return req_id, message.decode()


# ------------------------------------------------------------- TXN_*
#: TXN_STATE status codes (the coordinator's verdict as the wire
#: speaks it). ``unknown`` answers a TXN_STATUS for a txn the decision
#: group never decided.
TXN_STATUSES = {"open": 0, "committed": 1, "aborted": 2, "unknown": 3}
TXN_STATUS_NAMES = {v: k for k, v in TXN_STATUSES.items()}


def encode_txn_begin(req_id: int, **kw) -> bytes:
    """Open a transaction: the server allocates the txn id (TXN_STATE
    ``open`` carries it back). Gated on ``CAP_TXN`` — a server that
    never advertised it treats every TXN frame as an unknown kind."""
    return encode_frame(TXN_BEGIN, struct.pack("!Q", req_id), **kw)


def decode_txn_begin(payload: bytes) -> int:
    _need(payload, 0, 8)
    return struct.unpack_from("!Q", payload)[0]


def _pack_kv_list(items) -> bytes:
    """``[(key, value|None)]`` — the shared shape of a txn's write set
    (None = delete) and expect set (None = expect-absent)."""
    parts = [struct.pack("!H", len(items))]
    for key, value in items:
        parts.append(_pb16(key))
        parts.append(struct.pack("!B", 0 if value is None else 1))
        if value is not None:
            parts.append(_pb32(value))
    return b"".join(parts)


def _unpack_kv_list(payload: bytes, off: int):
    _need(payload, off, 2)
    (n,) = struct.unpack_from("!H", payload, off)
    off += 2
    items = []
    for _ in range(n):
        key, off = _ub16(payload, off)
        _need(payload, off, 1)
        has = payload[off]
        off += 1
        value = None
        if has:
            value, off = _ub32(payload, off)
        items.append((key, value))
    return items, off


def encode_txn_commit(req_id: int, txn_id: int, writes,
                      expects=(), **kw) -> bytes:
    """Commit one transaction: ``writes`` = [(key, new_value | None
    for delete)], ``expects`` = [(key, committed value the coordinator
    must still certify under the locks | None for expect-absent)]. One
    TXN_STATE resolves it: ``committed``, or ``aborted`` with the
    reason (lock lost / expect failed / prewrite refused)."""
    body = (struct.pack("!QI", req_id, txn_id)
            + _pack_kv_list(list(writes))
            + _pack_kv_list(list(expects)))
    return encode_frame(TXN_COMMIT, body, **kw)


def decode_txn_commit(payload: bytes):
    _need(payload, 0, 12)
    req_id, txn_id = struct.unpack_from("!QI", payload)
    writes, off = _unpack_kv_list(payload, 12)
    expects, _ = _unpack_kv_list(payload, off)
    return req_id, txn_id, writes, expects


def encode_txn_abort(req_id: int, txn_id: int, **kw) -> bytes:
    """Abandon an open (never-committed) transaction — nothing was
    prewritten at BEGIN, so the abort is trivially effect-free."""
    return encode_frame(
        TXN_ABORT, struct.pack("!QI", req_id, txn_id), **kw
    )


def decode_txn_abort(payload: bytes) -> Tuple[int, int]:
    _need(payload, 0, 12)
    return struct.unpack_from("!QI", payload)


def encode_txn_status(req_id: int, txn_id: int, **kw) -> bytes:
    """Decision lookup: how a client whose TXN_COMMIT died mid-flight
    (WireDisconnected — outcome unknown) resolves the outcome."""
    return encode_frame(
        TXN_STATUS, struct.pack("!QI", req_id, txn_id), **kw
    )


def decode_txn_status(payload: bytes) -> Tuple[int, int]:
    _need(payload, 0, 12)
    return struct.unpack_from("!QI", payload)


def encode_txn_state(req_id: int, txn_id: int, status: str,
                     reason: str = "", **kw) -> bytes:
    code = TXN_STATUSES.get(status)
    if code is None:
        raise ProtocolError(f"unknown txn status {status!r}")
    return encode_frame(
        TXN_STATE,
        struct.pack("!QIB", req_id, txn_id, code)
        + _pb16(reason.encode()),
        **kw,
    )


def decode_txn_state(payload: bytes) -> Tuple[int, int, str, str]:
    _need(payload, 0, 13)
    req_id, txn_id, code = struct.unpack_from("!QIB", payload)
    status = TXN_STATUS_NAMES.get(code)
    if status is None:
        raise ProtocolError(f"unknown txn-status code {code}")
    reason, _ = _ub16(payload, 13)
    return req_id, txn_id, status, reason.decode()


# ------------------------------------------------------------- PEER_*
# The replica plane (docs/CLUSTER.md). Gated on CAP_PEER; every frame
# leads with the sender's node id so a multi-homed process can tell
# which peer a shared-acceptor connection belongs to. Entries travel
# as (term u64, record pb16) pairs — records are the node's fixed-size
# log entries, so an append batch is self-describing.

def is_peer_kind(kind: int) -> bool:
    return PEER_HELLO <= kind <= PEER_SNAP_ACK


def encode_peer_hello(node_id: int, token: bytes = b"",
                      last_idx: int = 0, caps: int = 0, **kw) -> bytes:
    """Peer identification + auth: ``token`` is verified by the
    receiving server's auth hook (cluster.auth) before any other PEER
    frame is honored on the connection; a mismatch answers ERROR and
    closes. ``last_idx`` is the sender's durable log floor — the
    resumable-handoff hint a restarted process opens with, so the
    leader resumes the catch-up stream past the adopted segments
    instead of replaying history the disk already holds. ``caps`` is
    the dialer's capability byte (``CAP_CRC``), appended only when
    nonzero — the additive contract: a caps-less hello is
    byte-identical to the pre-capability encoding, and the old decoder
    ignores the trailing byte."""
    body = struct.pack("!IQ", node_id, last_idx) + _pb16(token)
    if caps:
        body += struct.pack("!B", caps)
    return encode_frame(PEER_HELLO, body, **kw)


def decode_peer_hello(payload: bytes) -> Tuple[int, int, bytes]:
    _need(payload, 0, 12)
    node_id, last_idx = struct.unpack_from("!IQ", payload)
    token, _ = _ub16(payload, 12)
    return node_id, last_idx, token


def decode_peer_hello_caps(payload: bytes) -> Tuple[int, int, bytes, int]:
    """``decode_peer_hello`` plus the trailing capability byte (0 when
    absent — a pre-CRC dialer)."""
    _need(payload, 0, 12)
    node_id, last_idx = struct.unpack_from("!IQ", payload)
    token, off = _ub16(payload, 12)
    caps = payload[off] if len(payload) > off else 0
    return node_id, last_idx, token, caps


def encode_peer_vote(node_id: int, term: int, last_idx: int,
                     last_term: int, prevote: bool = False,
                     **kw) -> bytes:
    """RequestVote: grant iff the candidate's log is at least as
    up-to-date (§5.4.1) and no vote was cast this term. ``prevote``
    probes without bumping terms (the disruption guard)."""
    return encode_frame(
        PEER_VOTE,
        struct.pack("!IQQQB", node_id, term, last_idx, last_term,
                    1 if prevote else 0),
        **kw,
    )


def decode_peer_vote(payload: bytes) -> Tuple[int, int, int, int, bool]:
    _need(payload, 0, 29)
    node_id, term, last_idx, last_term, pv = struct.unpack_from(
        "!IQQQB", payload
    )
    return node_id, term, last_idx, last_term, bool(pv)


def encode_peer_vote_reply(node_id: int, term: int, granted: bool,
                           prevote: bool = False, **kw) -> bytes:
    return encode_frame(
        PEER_VOTE_REPLY,
        struct.pack("!IQBB", node_id, term, 1 if granted else 0,
                    1 if prevote else 0),
        **kw,
    )


def decode_peer_vote_reply(payload: bytes) -> Tuple[int, int, bool, bool]:
    _need(payload, 0, 14)
    node_id, term, granted, pv = struct.unpack_from("!IQBB", payload)
    return node_id, term, bool(granted), bool(pv)


def _pack_entries(entries) -> bytes:
    parts = [struct.pack("!H", len(entries))]
    for term, data in entries:
        parts.append(struct.pack("!Q", term))
        parts.append(_pb16(data))
    return b"".join(parts)


def _unpack_entries(payload: bytes, off: int):
    _need(payload, off, 2)
    (n,) = struct.unpack_from("!H", payload, off)
    off += 2
    entries = []
    for _ in range(n):
        _need(payload, off, 8)
        (term,) = struct.unpack_from("!Q", payload, off)
        data, off = _ub16(payload, off + 8)
        entries.append((term, data))
    return entries, off


def encode_peer_append(node_id: int, term: int, prev_idx: int,
                       prev_term: int, commit: int, round_no: int = 0,
                       entries=(), **kw) -> bytes:
    """AppendEntries: consistency-checked at (prev_idx, prev_term),
    ``commit`` is the leader's watermark. An empty batch is the
    heartbeat. ``round_no`` is the leader's heartbeat-round counter,
    echoed in the reply — a majority of echoes >= R certifies the
    leader was still leader when round R was minted (the ReadIndex
    confirmation, docs/READS.md, carried peer-to-peer)."""
    body = struct.pack("!IQQQQQ", node_id, term, prev_idx, prev_term,
                       commit, round_no) + _pack_entries(list(entries))
    return encode_frame(PEER_APPEND, body, **kw)


def decode_peer_append(payload: bytes):
    _need(payload, 0, 44)
    node_id, term, prev_idx, prev_term, commit, round_no = \
        struct.unpack_from("!IQQQQQ", payload)
    entries, _ = _unpack_entries(payload, 44)
    return node_id, term, prev_idx, prev_term, commit, round_no, entries


def encode_peer_append_reply(node_id: int, term: int, success: bool,
                             match_idx: int, round_no: int = 0,
                             **kw) -> bytes:
    """``match_idx``: on success, the highest index now replicated on
    the sender; on failure, the follower's last log index — the
    conflict hint the leader rewinds ``next`` to (one round-trip per
    divergent tail, not per entry). ``round_no`` echoes the append's
    heartbeat round for ReadIndex certification."""
    return encode_frame(
        PEER_APPEND_REPLY,
        struct.pack("!IQBQQ", node_id, term, 1 if success else 0,
                    match_idx, round_no),
        **kw,
    )


def decode_peer_append_reply(payload: bytes):
    _need(payload, 0, 29)
    node_id, term, ok, match_idx, round_no = struct.unpack_from(
        "!IQBQQ", payload
    )
    return node_id, term, bool(ok), match_idx, round_no


def encode_peer_snap_chunk(node_id: int, term: int, base: int,
                           last_total: int, commit: int, entries=(),
                           **kw) -> bytes:
    """One bulk catch-up chunk: entries ``[base, base+len)`` of a
    stream whose end is ``last_total`` (the resumable-stream contract
    carried peer-to-peer: each PEER_SNAP_ACK names the floor, so a
    stream cut by a kill resumes at the ack, not at zero)."""
    body = struct.pack("!IQQQQ", node_id, term, base, last_total,
                       commit) + _pack_entries(list(entries))
    return encode_frame(PEER_SNAP_CHUNK, body, **kw)


def decode_peer_snap_chunk(payload: bytes):
    _need(payload, 0, 36)
    node_id, term, base, last_total, commit = struct.unpack_from(
        "!IQQQQ", payload
    )
    entries, _ = _unpack_entries(payload, 36)
    return node_id, term, base, last_total, commit, entries


def encode_peer_snap_ack(node_id: int, term: int, match_idx: int,
                         **kw) -> bytes:
    return encode_frame(
        PEER_SNAP_ACK,
        struct.pack("!IQQ", node_id, term, match_idx), **kw
    )


def decode_peer_snap_ack(payload: bytes) -> Tuple[int, int, int]:
    _need(payload, 0, 20)
    return struct.unpack_from("!IQQ", payload)
