"""Tiered log store: hot RAM tail + sealed, RS-coded on-disk segments
(port of ``raft_tpu/ckpt/tiered.py``).

The plain ``CheckpointStore`` keeps the archived committed log in RAM and
EVICTS everything past ``max_entries``: history older than 2x the device
ring is gone, so a ``register_apply(replay=True)`` consumer cannot rebuild
from it. This store keeps the whole history at bounded RAM:

- **Hot tier** — the inherited slot/span structures, holding the most
  recent ``hot_entries`` committed entries in RAM (the same O(1) span
  bookkeeping the fused booking relies on).
- **Cold tier** — once a contiguous ``segment_entries`` run falls
  ``hot_entries`` behind the archive head AND below the apply cursor, it
  is *sealed*: RS(n, k)-coded over the segment bytes on the C++ host codec
  (``RSCode.encode_host``, ``raft_tpu_torch.native``) and spilled to disk
  as n shard files, each with a CRC32 sidecar. Any k healthy shards
  reconstruct the segment; the hot copies are dropped. Sealing reads host
  bytes only (the archive's records), never the device.
- **Read-through** — ``get``/``covers``/``snapshot`` fall through to the
  segment tier (a small LRU of decoded segments), so snapshot install,
  apply replay and checkpoint backfill work at any history depth.

Integrity model. A shard file is trusted only if its sidecar CRC matches;
a segment with >= k healthy shards reconstructs via ``RSCode.decode_host``;
below k the segment is reported lost (``get`` returns None, an archive
gap) rather than fabricated. Spills go through a temp file +
``os.replace`` (``cluster.storage.RealIO``); the CRC sidecar is written
AFTER its shard, so a torn pair fails closed.

The on-disk format is the JAX package's byte for byte (the shard header
``_HDR``/``_MAGIC``, the sidecars, ``manifest.json`` and its ``.prev``):
a segment sealed by either package loads in the other.

Determinism contract: tier placement never changes WHAT bytes a read
returns, only where they come from.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.ckpt.snapshot import CheckpointStore

_HDR = struct.Struct("<8sIIqqII")       # magic, k, m, lo, hi, pad, shard_row
_MAGIC = b"RTSEG\x01\x00\x00"


class SegmentCorrupt(Exception):
    """A sealed segment has fewer than k healthy shards left — its bytes
    are unrecoverable from this tier (the keep-k rule the nemesis must
    respect, the storage analogue of keep-a-majority-alive)."""


def _default_vio():
    """The storage backend this tier writes through when the caller
    hands none in. Resolved lazily, as in the JAX package, where the
    cluster package's ``__init__`` imports this module back."""
    from raft_tpu_torch.cluster.storage import RealIO
    return RealIO()


class SegmentIO:
    """Seal / load one RS-coded segment as n shard files + CRC sidecars.

    Layout per segment (``name = seg-<lo>-<hi>`` under ``root``):

    - ``<name>.s<r>`` — shard row r: a fixed header (k, m, lo, hi, pad,
      row id) + the terms array (replicated in EVERY shard, so any one
      healthy shard serves the terms — they are 4 bytes/entry) + that
      row's byte-slice of the RS-coded payload.
    - ``<name>.s<r>.crc`` — ``crc32(shard bytes)`` in hex.

    The payload is flattened, zero-padded to a multiple of k, and coded
    as RS(k+m, k) over GF(2^8) — ``encode_host`` rides the C++ codec
    when present. Rows 0..k-1 are systematic: a segment whose data
    shards are all healthy stitches without a decode.
    """

    def __init__(self, root: str, k: int = 4, m: int = 2, vio=None):
        from raft_tpu_torch.ec.rs import RSCode

        self.root = root
        self.code = RSCode(k + m, k)
        self.vio = vio if vio is not None else _default_vio()
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- paths
    def name(self, lo: int, hi: int, prefix: str = "") -> str:
        return f"{prefix}seg-{lo:012d}-{hi:012d}"

    def shard_path(self, name: str, r: int) -> str:
        return os.path.join(self.root, f"{name}.s{r}")

    def _crc_path(self, path: str) -> str:
        return path + ".crc"

    # -------------------------------------------------------------- seal
    def seal(self, lo: int, hi: int, entries: np.ndarray,
             terms: np.ndarray, prefix: str = "") -> str:
        """Code + spill entries [lo, hi]; returns the segment name."""
        code = self.code
        flat = np.ascontiguousarray(entries, np.uint8).reshape(-1)
        pad = (-len(flat)) % code.k
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
        shards = code.encode_host(flat)             # [n, len/k]
        name = self.name(lo, hi, prefix)
        tbytes = np.asarray(terms, np.int32).tobytes()
        for r in range(code.n):
            hdr = _HDR.pack(_MAGIC, code.k, code.m, lo, hi, pad, r)
            blob = hdr + tbytes + shards[r].tobytes()
            p = self.shard_path(name, r)
            self.vio.atomic_write(p, blob)
            self.vio.atomic_write(self._crc_path(p),
                                  f"{zlib.crc32(blob):08x}".encode())
        return name

    # -------------------------------------------------------------- load
    def _read_shard(self, name: str, r: int,
                    n_entries: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(terms i32[N], shard bytes u8[...]) when shard r is healthy
        (present, CRC-valid, header-consistent), else None."""
        p = self.shard_path(name, r)
        try:
            blob = self.vio.read_bytes(p)
            want = int(self.vio.read_bytes(self._crc_path(p)).strip(),
                       16)
        except (OSError, ValueError):
            return None
        if zlib.crc32(blob) != want or len(blob) < _HDR.size:
            return None
        magic, k, m, lo, hi, pad, row = _HDR.unpack_from(blob)
        if magic != _MAGIC or row != r or k != self.code.k or m != self.code.m:
            return None
        toff = _HDR.size
        soff = toff + 4 * n_entries
        terms = np.frombuffer(blob, np.int32, n_entries, toff)
        return terms, np.frombuffer(blob, np.uint8, len(blob) - soff, soff)

    def load(self, lo: int, hi: int, entry_bytes: int,
             prefix: str = "") -> Tuple[np.ndarray, np.ndarray, bool]:
        """(entries u8[N, entry_bytes], terms i32[N], reconstructed).

        ``reconstructed`` is True when a data shard was missing/corrupt
        and the payload came through the RS decode (parity rebuilt it).
        Raises :class:`SegmentCorrupt` below k healthy shards.
        """
        code = self.code
        n_entries = hi - lo + 1
        name = self.name(lo, hi, prefix)
        shard_len = None
        healthy: Dict[int, np.ndarray] = {}
        terms = None
        for r in range(code.n):
            got = self._read_shard(name, r, n_entries)
            if got is None:
                continue
            t, s = got
            if shard_len is None:
                shard_len, terms = len(s), t
            if len(s) != shard_len:
                continue                      # truncated but CRC-matching
            healthy[r] = s
            if len(healthy) == code.n:
                break
        if len(healthy) < code.k:
            raise SegmentCorrupt(
                f"segment {name}: only {len(healthy)} of {code.n} shards "
                f"healthy, need k={code.k}"
            )
        data_rows = list(range(code.k))
        if all(r in healthy for r in data_rows):
            flat = np.concatenate([healthy[r] for r in data_rows])
            reconstructed = False
        else:
            rows = sorted(healthy)[: code.k]
            flat = code.decode_host(
                np.stack([healthy[r] for r in rows]), rows
            )
            reconstructed = True
        flat = flat[: n_entries * entry_bytes]
        return (
            flat.reshape(n_entries, entry_bytes),
            np.asarray(terms, np.int32),
            reconstructed,
        )

    def drop(self, lo: int, hi: int, prefix: str = "") -> None:
        name = self.name(lo, hi, prefix)
        for r in range(self.code.n):
            for p in (self.shard_path(name, r),
                      self._crc_path(self.shard_path(name, r))):
                self.vio.unlink(p)


class TieredStore(CheckpointStore):
    """``CheckpointStore`` with a sealed cold tier (module docstring).

    Drop-in for the engine's archive: same ``put``/``put_span``/``get``
    /``covers``/``snapshot`` surface, but instead of evicting entries
    past a retention bound it SEALS them to disk and serves them back
    through the segment tier. ``apply_cursor`` (set by the engine) caps
    sealing: only entries the apply stream has consumed are sealed, so
    the hot path never pays a segment read for the next apply index.

    **Restart handoff** (``adopt=True``, docs/CLUSTER.md). A
    generation-stamped ``manifest.json`` in ``root`` records the sealed
    index after every seal; a restarted process constructs with
    ``adopt=True`` and inherits the prior generation's sealed segments
    verbatim — the seal cursor resumes past ``sealed_hi``, so re-filling
    the log from a peer's snapshot stream re-seals NOTHING it already
    paid for (``segments_resealed`` counts any violation; the cluster
    drill asserts it stays 0). Shard health is not re-audited at adopt
    time: a shard rotted across the restart surfaces through the normal
    read-path CRC/RS machinery, same as any other loss.
    """

    def __init__(
        self,
        entry_bytes: int,
        root: str,
        hot_entries: int,
        segment_entries: int,
        rs_k: int = 4,
        rs_m: int = 2,
        cache_segments: int = 2,
        on_seal=None,
        checkpoint_span: Optional[int] = None,
        adopt: bool = False,
        io_backend=None,
    ):
        if hot_entries < segment_entries:
            raise ValueError("hot_entries must be >= segment_entries")
        super().__init__(entry_bytes, max_entries=None)
        self.vio = io_backend if io_backend is not None else _default_vio()
        self.io = SegmentIO(root, k=rs_k, m=rs_m, vio=self.vio)
        self.root = root
        self.hot_entries = hot_entries
        self.segment_entries = segment_entries
        self.apply_cursor: Optional[int] = None
        #   highest index the apply stream consumed; None = no apply
        #   consumers registered (anything committed is sealable).
        self.on_seal = on_seal      # callback(n_entries) per sealed segment
        self._ckpt_span = checkpoint_span or hot_entries
        #   checkpoint_floor parity with a plain store of
        #   max_entries=checkpoint_span (see property below) — decoupled
        #   from hot_entries so a small hot tail (the segment-nemesis
        #   drill) still writes the same checkpoints
        self._sealed: List[Tuple[int, int]] = []   # sorted [(lo, hi)]
        self._sealed_hi = 0
        self._hot_first = 1          # smallest index still in RAM tiers
        self._cache: "Dict[int, Tuple[np.ndarray, np.ndarray]]" = {}
        self._cache_order: List[int] = []
        self.cache_segments = cache_segments
        self._seal_block: Optional[int] = None
        #   lowest known archive hole blocking the next seal — skip the
        #   O(segment) coverage rescan until a put fills it
        self._lost: set = set()
        #   segment los that failed to load below k shards: report once,
        #   don't re-read n files on every subsequent get
        # ------------------------------------------------ tier statistics
        self.stats: Dict[str, int] = {
            "segments_sealed": 0, "entries_sealed": 0, "seal_bytes": 0,
            "segment_loads": 0, "segment_reconstructs": 0,
            "segments_lost": 0, "segments_adopted": 0,
            "segments_resealed": 0, "manifest_fallbacks": 0,
        }
        self.seal_wall_s = 0.0       # cumulative wall time inside seal()
        # --------------------------------------------- restart handoff
        self.generation = 1
        self._adopted_hi = 0     # prior generation's sealed_hi: sealing
        #   at or below it means the handoff failed and we re-paid
        if adopt:
            self._adopt_manifest()

    # --------------------------------------------------------- manifest
    def _manifest_path(self) -> str:
        return os.path.join(self.root, "manifest.json")

    def _write_manifest(self) -> None:
        """Atomic replace, with the outgoing manifest preserved as
        ``manifest.json.prev`` first — the fallback generation adopt
        reaches for when the current manifest is torn or rotted. Both
        writes are individually atomic, so a crash between them leaves
        (old, old) and a crash after leaves (new, old): every
        reachable state has at least one loadable manifest."""
        path = self._manifest_path()
        try:
            prev = self.vio.read_bytes(path)
        except OSError:
            prev = None
        if prev:
            self.vio.atomic_write(path + ".prev", prev)
        self.vio.atomic_write(path, json.dumps({
            "generation": self.generation,
            "entry_bytes": self.entry_bytes,
            "sealed": [[lo, hi] for lo, hi in self._sealed],
            "sealed_hi": self._sealed_hi,
        }).encode())

    def _load_manifest(self, path: str) -> Optional[dict]:
        """Parse + validate one manifest candidate; None when torn,
        missing, or from a different layout."""
        try:
            m = json.loads(self.vio.read_bytes(path))
            if m.get("entry_bytes") != self.entry_bytes:
                return None         # layout changed under us: reseal all
            m["sealed"] = [(int(lo), int(hi)) for lo, hi in m["sealed"]]
            m["sealed_hi"] = int(m["sealed_hi"])
            m["generation"] = int(m.get("generation", 0))
        except (OSError, ValueError, KeyError, TypeError):
            return None
        return m

    def _adopt_manifest(self) -> None:
        m = self._load_manifest(self._manifest_path())
        if m is None:
            # torn / half-written manifest (the writer crashed inside
            # _write_manifest, or the disk rotted it): fall back to the
            # previous generation's manifest. Losing the last seal is
            # SAFE — the range above the older sealed_hi re-replicates
            # from the leader and re-seals above _adopted_hi, so it
            # never counts as a handoff violation — whereas trusting a
            # torn sealed list could adopt ranges whose shards were
            # never written
            m = self._load_manifest(self._manifest_path() + ".prev")
            if m is not None:
                self.stats["manifest_fallbacks"] += 1
        if m is None:
            return                  # first generation: nothing to adopt
        self.generation = m["generation"] + 1
        self._sealed = list(m["sealed"])
        self._sealed_hi = m["sealed_hi"]
        self._adopted_hi = self._sealed_hi
        self._hot_first = self._sealed_hi + 1
        # the archive extends at least to the adopted index; backfill
        # puts past it raise ``last`` normally
        self.last = max(self.last, self._sealed_hi)
        self.stats["segments_adopted"] = len(self._sealed)
        self._write_manifest()      # stamp the new generation

    # ----------------------------------------------------------- sealing
    def _seal_ceiling(self) -> int:
        """Highest index eligible for sealing: ``hot_entries`` behind
        the archive head, and never past the apply cursor."""
        ceil = self.last - self.hot_entries
        if self.apply_cursor is not None:
            ceil = min(ceil, self.apply_cursor)
        return ceil

    def _sweep(self) -> None:
        # parent retention is disabled (max_entries=None); tier instead
        ceil = self._seal_ceiling()
        while self._sealed_hi + self.segment_entries <= ceil:
            lo = self._sealed_hi + 1
            hi = lo + self.segment_entries - 1
            if self._seal_block is not None:
                # a known archive hole (EC give-up) blocks this
                # boundary; skip the O(segment) rescan until a backfill
                # put() fills it
                if super().get(self._seal_block) is None:
                    return
                self._seal_block = None
            hot_get = super().get     # bind: zero-arg super() cannot
            hole = next(              # resolve inside the genexpr frame
                (i for i in range(lo, hi + 1)
                 if hot_get(i) is None), None,
            )
            if hole is not None:
                self._seal_block = hole
                return
            self._seal_range(lo, hi)

    def _seal_range(self, lo: int, hi: int) -> None:
        import time

        hot_get = super().get
        ents = np.frombuffer(
            b"".join(hot_get(i)[0] for i in range(lo, hi + 1)), np.uint8
        ).reshape(hi - lo + 1, self.entry_bytes)
        terms = np.asarray(
            [hot_get(i)[1] for i in range(lo, hi + 1)], np.int32
        )
        t0 = time.monotonic()
        self.io.seal(lo, hi, ents, terms)
        self.seal_wall_s += time.monotonic() - t0
        self._sealed.append((lo, hi))
        self._sealed_hi = hi
        self.stats["segments_sealed"] += 1
        self.stats["entries_sealed"] += hi - lo + 1
        self.stats["seal_bytes"] += ents.nbytes
        if hi <= self._adopted_hi:
            # the prior generation already sealed this range — the
            # restart handoff failed to spare us the work
            self.stats["segments_resealed"] += 1
        self._write_manifest()
        # drop the hot copies: slots individually, spans wholly below
        for i in range(lo, hi + 1):
            self._slots.pop(i, None)
        self._hot_first = hi + 1
        self._drop_spans_below(self._hot_first)
        if self.on_seal is not None:
            self.on_seal(hi - lo + 1)

    # ------------------------------------------------------ segment reads
    def _segment_for(self, idx: int) -> Optional[Tuple[int, int]]:
        import bisect

        i = bisect.bisect_right(self._sealed, (idx, 1 << 62)) - 1
        if i < 0:
            return None
        lo, hi = self._sealed[i]
        return (lo, hi) if lo <= idx <= hi else None

    def _segment_get(self, idx: int) -> Optional[Tuple[bytes, int]]:
        seg = self._segment_for(idx)
        if seg is None:
            return None
        lo, hi = seg
        if lo in self._lost:
            return None
        got = self._cache.get(lo)
        if got is None:
            try:
                ents, terms, reconstructed = self.io.load(
                    lo, hi, self.entry_bytes
                )
            except SegmentCorrupt:
                self.stats["segments_lost"] += 1
                self._lost.add(lo)
                return None
            self.stats["segment_loads"] += 1
            if reconstructed:
                self.stats["segment_reconstructs"] += 1
            got = (ents, terms)
            self._cache[lo] = got
            self._cache_order.append(lo)
            while len(self._cache_order) > self.cache_segments:
                self._cache.pop(self._cache_order.pop(0), None)
        ents, terms = got
        return ents[idx - lo].tobytes(), int(terms[idx - lo])

    # -------------------------------------------------------- read-through
    def get(self, idx: int) -> Optional[Tuple[bytes, int]]:
        if idx < self._first:
            return None
        got = super().get(idx)
        if got is not None:
            return got
        return self._segment_get(idx)

    @property
    def checkpoint_floor(self) -> int:
        """What a plain store of ``max_entries = hot_entries`` would
        report as its compaction floor — ``save_checkpoint`` uses this
        so checkpoint files stay O(ring) (and byte-identical to the
        untiered engine's) while the segment tier keeps the deep
        history."""
        return max(self._first, self.last - self._ckpt_span + 1)

    def set_floor(self, first: int) -> None:
        super().set_floor(first)
        if first > self._hot_first:
            self._hot_first = first
        # indices below the floor are compacted, not unsealed: the seal
        # cursor must skip past them or the next sweep would wedge
        # forever on a "hole" that is really the floor (and the store
        # would never seal nor evict again — unbounded RAM)
        self._sealed_hi = max(self._sealed_hi, first - 1)
        if self._seal_block is not None and self._seal_block < first:
            self._seal_block = None
        kept = [(lo, hi) for (lo, hi) in self._sealed
                if hi >= self._first]
        if kept != self._sealed:
            self._sealed = kept
            self._write_manifest()
        for lo in [lo for lo in self._cache if lo < self._first]:
            self._cache.pop(lo, None)
            if lo in self._cache_order:
                self._cache_order.remove(lo)

    # ------------------------------------------------------------- obs
    def host_bytes(self) -> int:
        """RAM held by this store: hot-tier payload bytes + the decoded
        segment cache — the number MemoryWatch attributes to the
        ``sealed-segment host buffers`` root (a labeled bucket, not
        'unattributed')."""
        hot = sum(len(b) for b, _ in self._slots.values())
        for lo, (hi, items, _t, pick) in self._spans.items():
            try:
                n = hi - lo + 1
                sample = items[0] if pick is None else items[0][pick]
                hot += n * len(sample)
            except Exception:
                pass
        cache = sum(
            e.nbytes + t.nbytes for e, t in self._cache.values()
        )
        return hot + cache

    def tier_summary(self) -> dict:
        """The ``/status`` tiered-store section + bench columns."""
        return {
            "hot_first": self._hot_first,
            "sealed_hi": self._sealed_hi,
            "generation": self.generation,
            "segments": len(self._sealed),
            "host_bytes": self.host_bytes(),
            "seal_wall_s": round(self.seal_wall_s, 6),
            **self.stats,
        }
