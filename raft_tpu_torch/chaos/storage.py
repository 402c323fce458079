"""Simulated durable storage for torture runs, with fault injectors
(port of ``raft_tpu/chaos/storage.py``, line for line).

The engine's durability stack is a checkpoint file
(``ckpt.EngineCheckpoint`` — the archived committed tail + terms +
votedFor) plus a vote WAL (``ckpt.VoteLog``). In a real deployment that
state is replicated across R machines' disks; in this single-process
engine it is one file set, so a storage fault against "the" checkpoint
would be a correlated failure of every replica's disk at once — a
failure mode Raft does not claim to survive. ``MirroredStore``
therefore models the deployment's redundancy at the file level: each
checkpoint generation is written to M mirror slots, each with a CRC32
sidecar, and recovery picks the newest mirror that validates. The
nemesis may corrupt mirrors **as long as at least one stays healthy**
— the storage analogue of the "keep a majority alive" rule that lets
torture runs quiesce.

Fault vocabulary (applied between crash and restart):

- ``tear_votelog``  — append a torn partial record (a crash mid-append
  that never returned): ``VoteLog``'s open path must trim it, or replay
  framing silently garbles every later record.
- ``flip_bit``      — flip one random bit in one mirror's checkpoint
  file: recovery must *detect* the corruption (CRC mismatch) and fall
  back to another mirror, never load garbage as committed state.
- ``rollback``      — replace one mirror (file + sidecar) with the
  previous generation (a filesystem-level rollback / lost write): the
  stale mirror is internally VALID, so recovery must prefer the mirror
  with the higher committed watermark, not merely any valid one.
- ``wipe_node``     — total disk loss of ONE node: its (term, votedFor)
  slice is zeroed in every mirror generation (current and previous, so
  a later ``rollback`` cannot resurrect it) and its records dropped
  from the vote WAL. Unlike the corruptions above this is a *clean*
  loss the recovery path is allowed to load — the protocol-level
  defense is the engine's wiped-voter rule: a node whose durable
  identity is gone must rejoin through removal + learner re-admission
  (``RaftEngine.replace``), never resume as a voter.

``load_best`` is the recovery path under test: validate every mirror
(sidecar CRC over the raw bytes, then a real ``EngineCheckpoint.load``),
rank by committed watermark, refuse only when NO mirror survives.
"""

from __future__ import annotations

import os
import random
import zlib
from typing import Dict, List, Optional, Set, Tuple

from raft_tpu_torch.ckpt import EngineCheckpoint


class MirroredStore:
    """M mirrored checkpoint slots + one vote WAL under ``root``."""

    def __init__(self, root: str, mirrors: int = 2):
        if mirrors < 2:
            raise ValueError(
                "need >= 2 mirrors: with one, any storage fault is a "
                "correlated total loss the harness must not inject"
            )
        self.root = root
        self.mirrors = mirrors
        os.makedirs(root, exist_ok=True)
        self.generation = 0
        # re-opening over existing mirrors must keep the generation
        # counter monotone, or fresh saves would rank BELOW stale files
        for i in range(mirrors):
            crc = self._crc_path(self.mirror_path(i))
            for side in (crc, self._prev_path(crc)):
                try:
                    with open(side) as f:
                        gen = int(f.read().split()[1])
                    self.generation = max(self.generation, gen + 1)
                except (OSError, ValueError, IndexError):
                    pass

    # -------------------------------------------------------------- paths
    @property
    def votelog_path(self) -> str:
        return os.path.join(self.root, "votes.wal")

    def mirror_path(self, i: int) -> str:
        return os.path.join(self.root, f"ckpt.m{i}.npz")

    def _crc_path(self, path: str) -> str:
        return path + ".crc"

    def _prev_path(self, path: str) -> str:
        return path + ".prev"

    # --------------------------------------------------------------- save
    def save(self, engine) -> None:
        """One ``save_checkpoint`` fanned out to every mirror with CRC
        sidecars; the previous generation is kept per mirror (it is what
        a rollback fault restores). The engine writes mirror 0 itself
        (its WAL-rotation side effect must run exactly once); the other
        mirrors are byte copies."""
        p0 = self.mirror_path(0)
        for i in range(self.mirrors):
            p = self.mirror_path(i)
            if os.path.exists(p):
                os.replace(p, self._prev_path(p))
                crc = self._crc_path(p)
                if os.path.exists(crc):
                    os.replace(crc, self._prev_path(crc))
        engine.save_checkpoint(p0)
        with open(p0, "rb") as f:
            blob = f.read()
        for i in range(self.mirrors):
            p = self.mirror_path(i)
            if i > 0:
                with open(p, "wb") as f:
                    f.write(blob)
            # sidecar: CRC + the save generation. The generation breaks
            # watermark ties in load_best: a rolled-back mirror can carry
            # the SAME watermark as the current one (no commits between
            # saves) while holding older terms — restoring those would
            # regress durable vote state (the double-vote hazard).
            with open(self._crc_path(p), "w") as f:
                f.write(f"{zlib.crc32(blob):08x} {self.generation}\n")
        self.generation += 1

    # ------------------------------------------------------------ recovery
    def _validate(self, path: str) -> Optional[Tuple[int, int]]:
        """(generation, watermark) if the mirror is healthy, else None."""
        crc_path = self._crc_path(path)
        try:
            with open(path, "rb") as f:
                blob = f.read()
            with open(crc_path) as f:
                crc_hex, gen_s = f.read().split()
            want, gen = int(crc_hex, 16), int(gen_s)
        except (OSError, ValueError):
            return None
        if zlib.crc32(blob) != want:
            return None
        try:
            ck = EngineCheckpoint.load(path)
        except Exception:
            return None
        return gen, int(ck.snap.last_index)

    def load_best(self) -> Tuple[str, int, List[int]]:
        """(path, watermark, rejected mirror ids) of the newest healthy
        mirror — newest by save generation, so an internally-valid but
        rolled-back mirror never outranks the current one. Raises when
        every mirror is corrupt — the correlated loss the nemesis is
        forbidden from injecting."""
        best: Optional[Tuple[Tuple[int, int], str]] = None
        rejected: List[int] = []
        for i in range(self.mirrors):
            p = self.mirror_path(i)
            rank = self._validate(p)
            if rank is None:
                rejected.append(i)
                continue
            if best is None or rank > best[0]:
                best = (rank, p)
        if best is None:
            raise RuntimeError(
                "no healthy checkpoint mirror survives; the nemesis "
                "violated the keep-one-healthy rule"
            )
        return best[1], best[0][1], rejected

    # --------------------------------------------------------- fault hooks
    def tear_votelog(self, rng: random.Random) -> None:
        """Crash mid-append: a partial trailing record (1-15 garbage
        bytes) that was never acted on — ``VoteLog.__init__`` must trim
        it before appending."""
        if not os.path.exists(self.votelog_path):
            return
        with open(self.votelog_path, "ab") as f:
            f.write(bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 15))))

    def flip_bit(self, mirror: int, rng: random.Random) -> None:
        p = self.mirror_path(mirror)
        with open(p, "rb") as f:
            blob = bytearray(f.read())
        if not blob:
            return
        pos = rng.randrange(len(blob))
        blob[pos] ^= 1 << rng.randrange(8)
        with open(p, "wb") as f:
            f.write(bytes(blob))

    def rollback(self, mirror: int) -> bool:
        """Restore one mirror's previous generation (file + sidecar);
        False when no previous generation exists yet."""
        p = self.mirror_path(mirror)
        prev, prev_crc = self._prev_path(p), self._prev_path(self._crc_path(p))
        if not (os.path.exists(prev) and os.path.exists(prev_crc)):
            return False
        os.replace(prev, p)
        os.replace(prev_crc, self._crc_path(p))
        return True

    def wipe_node(self, r: int) -> None:
        """Destroy node ``r``'s durable identity across the whole store:
        zero its (term, votedFor) slice in EVERY mirror generation —
        current and ``.prev``, so neither recovery nor a later
        ``rollback`` fault can resurrect its votes — and drop its rows
        from the vote WAL. The mirrors stay internally VALID (fresh CRC
        sidecars, same generation rank): this is clean disk loss, not
        corruption, and pairs with ``RaftEngine.wipe``'s in-memory half
        during the chaos wipe-replace cycle."""
        from raft_tpu_torch.ckpt import EngineCheckpoint
        from raft_tpu_torch.ckpt.votelog import _MAGIC, _REC, VoteLog

        for i in range(self.mirrors):
            for path in (self.mirror_path(i),
                         self._prev_path(self.mirror_path(i))):
                crc_path = (
                    self._crc_path(path) if not path.endswith(".prev")
                    else self._prev_path(self._crc_path(self.mirror_path(i)))
                )
                if not (os.path.exists(path) and os.path.exists(crc_path)):
                    continue
                try:
                    ck = EngineCheckpoint.load(path)
                    with open(crc_path) as f:
                        gen = int(f.read().split()[1])
                except Exception:
                    continue   # already-corrupt mirrors stay corrupt
                if not (0 <= r < ck.terms.shape[0]):
                    continue
                ck.terms[r] = 0
                ck.voted_for[r] = -1
                ck.save(path)
                with open(path, "rb") as f:
                    blob = f.read()
                with open(crc_path, "w") as f:
                    f.write(f"{zlib.crc32(blob):08x} {gen}\n")
        # vote WAL: rewrite without r's records (a torn trailing record,
        # if any, is dropped with the rewrite — same as VoteLog's own
        # open-path trim)
        recs = VoteLog.replay(self.votelog_path)
        if r in recs:
            del recs[r]
            with open(self.votelog_path, "wb") as f:
                f.write(_MAGIC)
                for q in sorted(recs):
                    t, v = recs[q]
                    f.write(_REC.pack(int(q), int(t), int(v)))
                f.flush()
                os.fsync(f.fileno())


class SegmentNemesis:
    """Fault injectors against a ``ckpt.tiered.TieredStore``'s sealed
    shard files — the cold tier's analogue of the mirror faults above.

    Fault vocabulary (each names a distinct real-world storage failure):

    - ``torn_spill``  — truncate one shard file mid-bytes, sidecar left
      stale (a crash mid-spill that `os.replace`'d anyway, or a
      filesystem that lost the tail): the CRC must reject the shard.
    - ``flip_bit``    — flip one random payload bit in one shard file
      (bit rot): the CRC must reject; the segment reconstructs from the
      surviving shards through the RS decode.
    - ``drop_shard``  — delete one shard file + sidecar outright (a
      lost object / dead disk sector).

    Keep-k rule (the storage analogue of keep-a-majority-alive): the
    nemesis never reduces a segment below k healthy shards — below
    that the data is genuinely unrecoverable and the store's documented
    behavior is an archive gap, not recovery. Fault bookkeeping is per
    segment row, so composed faults across rounds stay within budget.

    Every injection clears the store's decoded-segment cache: the next
    read must hit the disk files, or a warm cache would vacuously pass
    the recovery assertion.
    """

    KINDS = ("torn_spill", "flip_bit", "drop_shard")

    def __init__(self, store):
        self.store = store
        self._faulted: Dict[Tuple[int, int], Set[int]] = {}

    def _pick(self, rng: random.Random,
              within: Optional[Tuple[int, int]] = None,
              data_only: bool = False,
              ) -> Optional[Tuple[int, int, int]]:
        """(lo, hi, shard row) of a faultable shard, or None when no
        segment has fault budget left. ``within`` restricts candidates
        to segments overlapping that index range — the drill uses it to
        place faults squarely on a rejoining follower's catch-up path
        (a fault on a segment nothing reads proves nothing).
        ``data_only`` restricts the row choice to systematic DATA
        shards (rows 0..k-1): a parity-only fault recovers through the
        systematic stitch with no decode, so a drill asserting the RS
        reconstruct path engaged must corrupt data rows."""
        code = self.store.io.code
        segs = [
            (lo, hi) for (lo, hi) in self.store._sealed
            if len(self._faulted.get((lo, hi), ())) < code.m
            and (within is None
                 or (lo <= within[1] and hi >= within[0]))
            and (not data_only or any(
                r not in self._faulted.get((lo, hi), set())
                for r in range(code.k)
            ))
        ]
        if not segs:
            return None
        lo, hi = segs[rng.randrange(len(segs))]
        rows = [
            r for r in range(code.k if data_only else code.n)
            if r not in self._faulted.get((lo, hi), set())
        ]
        return lo, hi, rows[rng.randrange(len(rows))]

    def inject(self, rng: random.Random,
               kind: Optional[str] = None,
               within: Optional[Tuple[int, int]] = None,
               data_only: bool = False) -> Optional[str]:
        """Apply one fault (seeded choice when ``kind`` is None);
        returns a human-readable description, or None when no sealed
        segment (overlapping ``within``, if given) can absorb a fault
        under the keep-k rule."""
        got = self._pick(rng, within, data_only)
        if got is None:
            return None
        lo, hi, row = got
        kind = kind or rng.choice(self.KINDS)
        io = self.store.io
        name = io.name(lo, hi)
        p = io.shard_path(name, row)
        if kind == "torn_spill":
            with open(p, "rb") as f:
                blob = f.read()
            keep = rng.randrange(max(1, len(blob) // 2), len(blob))
            with open(p, "wb") as f:
                f.write(blob[:keep])
        elif kind == "flip_bit":
            with open(p, "rb") as f:
                blob = bytearray(f.read())
            pos = rng.randrange(len(blob))
            blob[pos] ^= 1 << rng.randrange(8)
            with open(p, "wb") as f:
                f.write(bytes(blob))
        elif kind == "drop_shard":
            for path in (p, io._crc_path(p)):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        else:
            raise ValueError(f"unknown segment fault {kind!r}")
        self._faulted.setdefault((lo, hi), set()).add(row)
        # force the next read through the faulted files
        self.store._cache.clear()
        self.store._cache_order.clear()
        return f"{kind}(seg=[{lo},{hi}], shard={row})"
