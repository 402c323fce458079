"""The port's wire codec (``raft_tpu_torch.net.protocol``) against the JAX
package's, byte for byte: every encoder over every frame kind, untraced
and with sampled and unsampled trace contexts, with and without
capability bytes, from seeded numpy draws; every decoder on the encoded
payloads and on every truncation of them; and ``FrameDecoder`` on torn,
byte-by-byte, garbage, bad-magic, bad-version and oversized input, with
the same exception type and message. The cases are
``tests/test_net_protocol.py``'s, run through both packages."""

import struct

import numpy as np
import pytest

from raft_tpu.net import protocol as J
from raft_tpu_torch.net import protocol as T

SEED = 20261018


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng([SEED, sum(map(ord, name))])


def _b(rng, lo=0, hi=48) -> bytes:
    return rng.integers(0, 256, int(rng.integers(lo, hi)),
                        dtype=np.uint8).tobytes()


def _u(rng, bits) -> int:
    return int(rng.integers(0, 1 << min(bits, 62)))


def _floors(rng) -> dict:
    return {_u(rng, 32): _u(rng, 64) for _ in range(int(rng.integers(0, 5)))}


def _kv(rng, n_max=5, none_ok=False) -> list:
    return [(_b(rng, 0, 12),
             None if none_ok and rng.random() < 0.3 else _b(rng))
            for _ in range(int(rng.integers(0, n_max)))]


def _entries(rng) -> list:
    return [(_u(rng, 64), _b(rng, 0, 40))
            for _ in range(int(rng.integers(0, 5)))]


#: (case, encoder, decoders, argument draw): every encoder of the module
CASES = [
    ("hello", "encode_hello", ("decode_hello", "decode_hello_caps"),
     lambda r: ((_floors(r),), {})),
    ("hello_caps", "encode_hello", ("decode_hello", "decode_hello_caps"),
     lambda r: ((_floors(r),), {"caps": int(r.integers(1, 16))})),
    ("welcome", "encode_welcome", ("decode_welcome", "decode_welcome_caps"),
     lambda r: ((_u(r, 32), _u(r, 32)), {})),
    ("welcome_caps", "encode_welcome",
     ("decode_welcome", "decode_welcome_caps"),
     lambda r: ((_u(r, 32), _u(r, 32)), {"caps": int(r.integers(1, 16))})),
    ("submit", "encode_submit", ("decode_submit",),
     lambda r: ((_u(r, 64), _b(r, 0, 16), _b(r, 0, 300)), {})),
    ("submit_batch", "encode_submit_batch", ("decode_submit_batch",),
     lambda r: ((_u(r, 64), _kv(r, 9)), {})),
    ("ok_batch", "encode_ok_batch", ("decode_ok_batch",),
     lambda r: ((_u(r, 64), _u(r, 32), _u(r, 32), _floors(r)), {})),
    ("read", "encode_read", ("decode_read",),
     lambda r: ((_u(r, 64), ["linearizable", "any", "session"][
         int(r.integers(3))], _b(r, 0, 16)), {})),
    ("ok", "encode_ok", ("decode_ok",),
     lambda r: ((_u(r, 64), _u(r, 32), _u(r, 64), _u(r, 64)), {})),
    ("value", "encode_value", ("decode_value",),
     lambda r: ((_u(r, 64), _u(r, 32), _u(r, 64),
                 ["read_index", "lease", "follower", "session"][
                     int(r.integers(4))], _b(r)), {})),
    ("value_absent", "encode_value", ("decode_value",),
     lambda r: ((_u(r, 64), _u(r, 32), _u(r, 64), "lease", None), {})),
    ("refused", "encode_refused", ("decode_refused",),
     lambda r: ((_u(r, 64), ["depth", "delay", "wire_backlog"][
         int(r.integers(3))], float(r.random() * 10)), {})),
    ("not_leader", "encode_not_leader", ("decode_not_leader",),
     lambda r: ((_u(r, 64), _u(r, 32), f"replica:{int(r.integers(5))}"),
                {})),
    ("not_leader_no_hint", "encode_not_leader", ("decode_not_leader",),
     lambda r: ((_u(r, 64), _u(r, 32)), {})),
    ("error", "encode_error", ("decode_error",),
     lambda r: ((_u(r, 64), "bad frame %d" % int(r.integers(99))), {})),
    ("txn_begin", "encode_txn_begin", ("decode_txn_begin",),
     lambda r: ((_u(r, 64),), {})),
    ("txn_commit", "encode_txn_commit", ("decode_txn_commit",),
     lambda r: ((_u(r, 64), _u(r, 32), _kv(r, 5, True),
                 _kv(r, 4, True)), {})),
    ("txn_abort", "encode_txn_abort", ("decode_txn_abort",),
     lambda r: ((_u(r, 64), _u(r, 32)), {})),
    ("txn_status", "encode_txn_status", ("decode_txn_status",),
     lambda r: ((_u(r, 64), _u(r, 32)), {})),
    ("txn_state", "encode_txn_state", ("decode_txn_state",),
     lambda r: ((_u(r, 64), _u(r, 32), ["open", "committed", "aborted",
                                         "unknown"][int(r.integers(4))],
                 "lock_lost"), {})),
    ("peer_hello", "encode_peer_hello",
     ("decode_peer_hello", "decode_peer_hello_caps"),
     lambda r: ((_u(r, 32), _b(r, 0, 24), _u(r, 64)), {})),
    ("peer_hello_caps", "encode_peer_hello",
     ("decode_peer_hello", "decode_peer_hello_caps"),
     lambda r: ((_u(r, 32), _b(r, 0, 24), _u(r, 64)),
                {"caps": T.CAP_CRC})),
    ("peer_vote", "encode_peer_vote", ("decode_peer_vote",),
     lambda r: ((_u(r, 32), _u(r, 64), _u(r, 64), _u(r, 64),
                 bool(r.integers(2))), {})),
    ("peer_vote_reply", "encode_peer_vote_reply",
     ("decode_peer_vote_reply",),
     lambda r: ((_u(r, 32), _u(r, 64), bool(r.integers(2)),
                 bool(r.integers(2))), {})),
    ("peer_append", "encode_peer_append", ("decode_peer_append",),
     lambda r: ((_u(r, 32), _u(r, 64), _u(r, 64), _u(r, 64), _u(r, 64),
                 _u(r, 64), _entries(r)), {})),
    ("peer_append_reply", "encode_peer_append_reply",
     ("decode_peer_append_reply",),
     lambda r: ((_u(r, 32), _u(r, 64), bool(r.integers(2)), _u(r, 64),
                 _u(r, 64)), {})),
    ("peer_snap_chunk", "encode_peer_snap_chunk",
     ("decode_peer_snap_chunk",),
     lambda r: ((_u(r, 32), _u(r, 64), _u(r, 64), _u(r, 64), _u(r, 64),
                 _entries(r)), {})),
    ("peer_snap_ack", "encode_peer_snap_ack", ("decode_peer_snap_ack",),
     lambda r: ((_u(r, 32), _u(r, 64), _u(r, 64)), {})),
]

TRACES = {"untraced": None, "sampled": (0xABCDEF0123, 0x42, True),
          "unsampled": ((7 << 32) | 9, 0, False)}


def _outcome(fn, *args, **kw):
    """(``"ok"``, value) or (exception type name, message)."""
    try:
        return "ok", fn(*args, **kw)
    except Exception as ex:      # the comparison is the point
        return type(ex).__name__, str(ex)


def test_constants_and_tables_equal():
    names = [n for n in dir(J) if n.isupper() and not n.startswith("_")]
    for n in names:
        assert getattr(T, n) == getattr(J, n), n
    assert T._HEADER.format == J._HEADER.format
    assert T.TRACE_CTX_BYTES == J.TRACE_CTX_BYTES == 17
    public = {n for n in dir(J) if not n.startswith("_")
              and callable(getattr(J, n)) and getattr(
                  getattr(J, n), "__module__", "") == J.__name__}
    assert public <= set(dir(T))
    assert {c[1] for c in CASES} == {n for n in public
                                     if n.startswith("encode_")
                                     and n not in ("encode_frame",
                                                   "encode_trace")}


@pytest.mark.parametrize("trace", list(TRACES), ids=str)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_encoders_byte_identical_and_decoders_equal(case, trace):
    name, enc, decs, draw = case
    rng = _rng(name + trace)
    for _ in range(6):
        args, kw = draw(rng)
        ctx = TRACES[trace]
        want = getattr(J, enc)(*args, trace=ctx, **kw)
        got = getattr(T, enc)(*args, trace=ctx, **kw)
        assert got == want
        (jk, jp), = J.FrameDecoder().feed(want)
        (tk, tp), = T.FrameDecoder().feed(got)
        assert (tk, tp) == (jk, jp)
        jk, jctx, jp = J.split_trace(jk, jp)
        tk, tctx, tp = T.split_trace(tk, tp)
        assert (tk, tctx, tp) == (jk, jctx, jp) and tctx == ctx
        for dec in decs:
            assert getattr(T, dec)(tp) == getattr(J, dec)(jp)
            # every truncation: the same value or the same typed error
            for cut in range(len(tp)):
                assert (_outcome(getattr(T, dec), tp[:cut])
                        == _outcome(getattr(J, dec), jp[:cut])), (dec, cut)


@pytest.mark.parametrize("call", [
    ("encode_read", (7, "eventual", b"k"), {}),
    ("encode_value", (5, 1, 7, "stale", b"v"), {}),
    ("encode_txn_state", (1, 2, "maybe"), {}),
    ("encode_submit", (1, b"k", bytes(2048)), {"max_frame_bytes": 1024}),
    ("encode_submit", (1, b"k", bytes(995)),
     {"max_frame_bytes": 1024, "trace": (1, 1, True)}),
    ("encode_submit", (1, bytes(70000), b""), {}),
    ("decode_read", (struct.pack("!QB", 1, 9) + b"\x00\x00",), {}),
    ("decode_value", (struct.pack("!QIQBB", 1, 0, 0, 9, 0),), {}),
    ("decode_txn_state", (struct.pack("!QIB", 1, 0, 9) + b"\x00\x00",), {}),
    ("decode_submit", (struct.pack("!Q", 42),), {}),
    ("decode_submit", (struct.pack("!Q", 42) + b"\x00\x03key",), {}),
    ("decode_submit_batch", (struct.pack("!QH", 1, 2) + b"\x00\x01k",), {}),
    ("split_trace", (J.OK | J.TRACE_FLAG, bytes(8)), {}),
    ("crc_open", (J.PEER_VOTE | J.CRC_FLAG, b"\x01\x02"), {}),
], ids=lambda c: c[0])
def test_refusals_same_type_and_message(call):
    fn, args, kw = call
    want = _outcome(getattr(J, fn), *args, **kw)
    assert want[0] != "ok" or fn == "crc_open"
    assert _outcome(getattr(T, fn), *args, **kw) == want


@pytest.mark.parametrize("frame", [
    J.encode_peer_vote(1, 2, 3, 4), J.encode_peer_append(1, 2, 3, 4, 5, 6,
                                                        [(1, bytes(9))]),
    J.encode_ok(1, 0, 1, 1)], ids=["vote", "append", "ok"])
def test_crc_seal_and_open_equal(frame):
    sealed = T.crc_seal(frame)
    assert sealed == J.crc_seal(frame)
    (k, p), = T.FrameDecoder().feed(sealed)
    assert T.crc_open(k, p) == J.crc_open(k, p)
    bad = bytearray(p)
    bad[-5 if len(bad) > 4 else 0] ^= 1
    assert T.crc_open(k, bytes(bad)) == J.crc_open(k, bytes(bad))


def _stream(rng) -> bytes:
    out = b""
    for i in range(8):
        name, enc, _, draw = CASES[int(rng.integers(len(CASES)))]
        args, kw = draw(rng)
        out += getattr(J, enc)(*args, trace=list(TRACES.values())[i % 3],
                               **kw)
    return out


def _feed_all(mod, chunks, **kw):
    dec = mod.FrameDecoder(**kw)
    frames = []
    try:
        for c in chunks:
            frames.extend(dec.feed(c))
    except Exception as ex:
        return frames, dec.pending, dec.frames_in, (type(ex).__name__,
                                                    str(ex))
    return frames, dec.pending, dec.frames_in, None


def _chunkings(blob: bytes, rng):
    yield "whole", [blob]
    yield "byte_by_byte", [blob[i:i + 1] for i in range(len(blob))]
    cuts = sorted(set(int(c) for c in rng.integers(0, len(blob), 9)))
    yield "torn", [blob[a:b] for a, b in zip([0] + cuts, cuts + [len(blob)])]
    yield "tail_missing", [blob[:-3]]


@pytest.mark.parametrize("seed", range(4))
def test_frame_decoder_chunkings_equal(seed):
    rng = np.random.default_rng([SEED, seed])
    blob = _stream(rng)
    for name, chunks in _chunkings(blob, rng):
        got = _feed_all(T, chunks)
        assert got == _feed_all(J, chunks), name
        assert got[3] is None
    frames = _feed_all(T, [blob])[0]
    assert len(frames) == 8


def _bad_version(blob):
    b = bytearray(blob)
    b[2] = 99
    return bytes(b)


@pytest.mark.parametrize("bad", [
    ("bad_magic", lambda ok: b"\x00\x00\x01\x01\x00\x00\x00\x00", {}),
    ("bad_version", _bad_version, {}),
    ("garbage_after_frame", lambda ok: ok + b"\xde\xad\xbe\xef" + bytes(4),
     {}),
    ("oversized", lambda ok: J._HEADER.pack(J.MAGIC, J.VERSION, J.SUBMIT,
                                            1 << 30),
     {"max_frame_bytes": 1024}),
    ("oversized_default_bound",
     lambda ok: J._HEADER.pack(J.MAGIC, J.VERSION, J.SUBMIT,
                               J.MAX_FRAME_BYTES + 1), {}),
    ("half_magic", lambda ok: b"\x52", {}),
], ids=lambda b: b[0])
@pytest.mark.parametrize("split", ["whole", "byte_by_byte"])
def test_frame_decoder_refusals_equal(bad, split):
    name, make, kw = bad
    blob = make(J.encode_ok(1, 0, 1, 1))
    chunks = ([blob] if split == "whole"
              else [blob[i:i + 1] for i in range(len(blob))])
    got = _feed_all(T, chunks, **kw)
    assert got == _feed_all(J, chunks, **kw)
    if name == "half_magic":
        assert got[1:] == (1, 0, None)
    else:
        assert got[3] is not None
        want_type = ("FrameTooLarge" if name.startswith("oversized")
                     else "ProtocolError")
        assert got[3][0] == want_type
