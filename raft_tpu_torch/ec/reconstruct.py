"""Read-path reconstruction and repair for erasure-coded logs (port of
``raft_tpu/ec/reconstruct.py``).

With RS(n, k) on, each replica's ring slot holds its own shard. Reading an
entry therefore needs k shard rows and a decode (kernel K6 with the decode
matrix of the serving rows), and a lagging replica cannot be healed from
the leader's log: repair is reconstruct -> re-encode -> install, the EC
analogue of Raft's InstallSnapshot.

The fast path pays none of this: a read served by the k data rows needs no
decode at all, and commit never decodes anything.

Differences of mechanism from the JAX package, none of result: a
decoding read hands K6 the log ring itself (``ring_source``: the serving
rows' lane offsets, the ring's row stride, capacity and start slot), so
the window is decoded in place on the card, seam included, where the JAX
package copies the ring to the host and gathers the window there; the
systematic read gathers only the requested slots on the device; and
``heal_replica`` re-encodes on the device with K6 where the JAX package
uses its C++ host codec (``RSCode.encode_host``, equal to the NumPy
``encode``).

On the mesh (``view`` a ``transport.MeshTransport``) each rank holds one
row: a read gathers the k donor rows' windows onto every rank's device
first (``gather_window``, a collective every rank makes) and K6 decodes
that block; a write lands only on the rank that holds the row
(``view.on_row``). The one-process mesh (a ``core.state.BlockState``,
which carries its view) gathers the donor block onto its first device
with device copies and writes each of the row's blocks. On the 2-D
mesh the donor block is gathered at full width (each donor's P slices
stitched over the row group) and decoded whole, and a write lands on each
of the row's P ranks as its byte slice of the shard (``view.lane_slice``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from raft_tpu_torch.core.state import ReplicaState, slot_of, view_of
from raft_tpu_torch.ec.kernels import GfSource, decode_ring, encode_device
from raft_tpu_torch.ec.rs import RSCode


def gather_shard_window(state: ReplicaState, rows: Sequence[int], lo: int,
                        hi: int) -> torch.Tensor:
    """u8[len(rows), hi-lo+1, Sk] shard slices of log indices [lo, hi] on
    the state's device."""
    cap = state.capacity
    w = state.words_per_entry
    n_rows = state.term.shape[0]
    dev = state.device
    slots = (torch.arange(lo, hi + 1, device=dev, dtype=torch.int64) - 1) % cap
    rows_t = torch.as_tensor(list(rows), dtype=torch.int64, device=dev)
    lp = state.log_payload.view(cap, n_rows, w)
    words = lp.index_select(0, slots).index_select(1, rows_t)  # [N, r, w]
    return words.permute(1, 0, 2).contiguous().view(torch.uint8)


def ring_source(state: ReplicaState, rows: Sequence[int],
                lo: int) -> GfSource:
    """Where the shards of ``rows`` for log indices lo, lo+1, ... lie in
    ``state.log_payload``: K6's source description of the ring (row
    offsets ``rows[j] * W``, row stride ``R * W``, capacity C, start slot
    ``(lo - 1) mod C``), in 4-byte words."""
    w = state.words_per_entry
    return GfSource(tuple(int(r) * w for r in rows),
                    state.term.shape[0] * w, state.capacity,
                    (lo - 1) % state.capacity)


def _reconstruct(state: ReplicaState, code: RSCode, rows: Sequence[int],
                 lo: int, hi: int, view=None) -> torch.Tensor:
    """``reconstruct`` as a u8[hi-lo+1, S] tensor on the state's device."""
    rows = [int(r) for r in rows]
    if len(rows) != code.k:
        raise ValueError(f"need exactly k={code.k} shard rows, got {rows}")
    view = view_of(state, view)
    w = state.words_per_entry
    n = hi - lo + 1
    block = None
    if not view.resident:
        # the k donor windows at full width, gathered onto this rank's
        # device: i32[N, k*W]
        block = view.gather_window(state, rows, lo, hi)
        w = block.shape[1] // code.k
    if sorted(rows) == list(range(code.k)):
        # Systematic fast path: rows 0..k-1 hold the raw byte slices in
        # some order — reorder to shard id and stitch; no decode.
        if block is None:
            shards = gather_shard_window(state, rows, lo, hi)
        else:
            shards = block.view(n, code.k, w).permute(1, 0, 2) \
                .contiguous().view(torch.uint8)
        order = torch.as_tensor(np.argsort(np.asarray(rows)),
                                device=shards.device)
        sh = shards.index_select(0, order)
        return sh.permute(1, 0, 2).reshape(sh.shape[1], -1)
    if block is None:
        return decode_ring(code, state.log_payload,
                           ring_source(state, rows, lo), n, w, rows)
    # K6 over the gathered block: shard j at lane offset j*W, row stride
    # k*W, capacity N from slot 0
    return decode_ring(code, block,
                       GfSource(tuple(j * w for j in range(code.k)),
                                code.k * w, n, 0), n, w, rows)


def reconstruct(state: ReplicaState, code: RSCode, rows: Sequence[int],
                lo: int, hi: int, view=None) -> np.ndarray:
    """Decode entries [lo, hi] (1-based, inclusive) from the shard rows of
    the k replicas in ``rows`` -> u8[hi-lo+1, S] on the host.

    ``rows`` picks which replicas serve the read (any k live ones): the
    data rows 0..k-1 in any order need no decode; any other set is decoded
    by K6, which reads the ring in place on the card (on the mesh, the
    gathered donor windows)."""
    return _reconstruct(state, code, rows, lo, hi, view).cpu().numpy()


def install_window(state: ReplicaState, replica: int, start, count,
                   payload: torch.Tensor, terms: torch.Tensor, leader_term,
                   commit_to) -> ReplicaState:
    """Install a verified window into one replica's row.

    ``start`` (first log index), ``count`` (valid entries), ``leader_term``
    and ``commit_to``: ints or 0-d tensors; ``payload`` i32[B, Wk] is the
    re-encoded shard words for ``replica``, ``terms`` i32[B] the entry
    terms. Match and commit advance to the window end, as accepting a
    leader window does; an unverified suffix beyond the window is cut (a
    suffix verified for ``leader_term``, or committed, is kept). The rings
    are updated in place: the state passed in is consumed."""
    cap = state.capacity
    dev = state.device
    B = payload.shape[0]
    w = state.words_per_entry

    def i32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.int32).reshape(())
        return torch.tensor(int(x), dtype=torch.int32, device=dev)

    start, count = i32(start), i32(count)
    leader_term, commit_to = i32(leader_term), i32(commit_to)
    barange = torch.arange(B, dtype=torch.int32, device=dev)
    valid = barange < count
    pos = slot_of(start + barange, cap).long()
    cols = state.log_payload[:, replica * w:(replica + 1) * w]   # a view
    cols[pos] = torch.where(valid[:, None], payload.to(dev), cols[pos])
    row_t = state.log_term[replica]
    row_t[pos] = torch.where(valid, terms.to(device=dev, dtype=torch.int32),
                             row_t[pos])
    we = start + count - 1
    verified = torch.where(state.match_term[replica] == leader_term,
                           state.match_index[replica], 0)
    protected = torch.maximum(torch.maximum(we, verified),
                              state.commit_index[replica])
    new_last = torch.minimum(torch.maximum(state.last_index[replica], we),
                             protected)

    def put(vec, value):
        out = vec.clone()
        out[replica] = value
        return out

    return state.replace(
        last_index=put(state.last_index, new_last),
        match_index=put(state.match_index, torch.maximum(verified, we)),
        match_term=put(state.match_term, leader_term),
        commit_index=put(state.commit_index, torch.maximum(
            state.commit_index[replica], torch.minimum(commit_to, we))),
    )


def install_entries(state: ReplicaState, replica: int, start: int, shards,
                    terms, leader_term: int, commit_to: int,
                    batch: int, view=None) -> ReplicaState:
    """Chunked ``install_window`` over a contiguous index range: ``shards``
    u8[N, Sk] (this replica's shard per entry) and ``terms`` i32[N], numpy
    or tensors. On the mesh only the rank holding ``replica`` writes (on
    the 2-D mesh each of its P ranks writes its byte slice of every
    shard); the others return their state unchanged."""
    return view_of(state, view).on_row(
        state, replica, lambda st, i, cut: _install_rows(
            st, i, start, cut(shards), terms, leader_term, commit_to,
            batch))


def _install_rows(state: ReplicaState, replica: int, start: int, shards,
                  terms, leader_term: int, commit_to: int,
                  batch: int) -> ReplicaState:
    """``install_entries`` on a state that holds row ``replica`` (its
    index there) and the bytes ``shards`` of it."""
    dev = state.device
    if isinstance(shards, np.ndarray):   # may be a read-only byte view
        shards = np.require(shards, requirements=["C", "W"])
    shards = torch.as_tensor(shards, device=dev)
    terms = torch.as_tensor(terms, device=dev).to(torch.int32)
    n_entries, sk = shards.shape
    for ofs in range(0, n_entries, batch):
        m = min(batch, n_entries - ofs)
        buf = torch.zeros(batch, sk, dtype=torch.uint8, device=dev)
        buf[:m] = shards[ofs:ofs + m]
        tbuf = torch.zeros(batch, dtype=torch.int32, device=dev)
        tbuf[:m] = terms[ofs:ofs + m]
        state = install_window(state, replica, start + ofs, m,
                               buf.view(torch.int32), tbuf, leader_term,
                               commit_to)
    return state


def heal_replica(state: ReplicaState, code: RSCode, replica: int,
                 donor_rows: Sequence[int], lo: int, hi: int,
                 leader_term: int, commit_to: int,
                 batch: int, view=None) -> ReplicaState:
    """Reconstruct entries [lo, hi] from ``donor_rows`` and install replica
    ``replica``'s re-encoded shards, ``batch`` entries at a time: each
    chunk is reconstructed (K6 decode unless the donors are the data rows),
    re-encoded on the device (K6 encode) and installed.

    Raises ``ValueError`` if any donor's ring has already lapped ``lo``
    (the slot would hold a newer entry's shard — decoding it would install
    silent garbage); such a replica needs a snapshot install instead."""
    view = view_of(state, view)
    donor_rows = [int(r) for r in donor_rows]
    donor_last = view.fetch_rows(state.last_index)[donor_rows]
    horizon = int(donor_last.max()) - state.capacity + 1
    if lo < horizon:
        raise ValueError(
            f"heal range start {lo} below donor ring horizon {horizon}; "
            "replica needs snapshot install, not log repair")
    slots = (np.arange(lo, hi + 1, dtype=np.int64) - 1) % state.capacity
    terms_all = torch.from_numpy(view.log_terms(state, slots,
                                                donor_rows[0]))
    mine = view.local_row(replica) is not None
    for ofs in range(0, hi - lo + 1, batch):
        a = lo + ofs
        b = min(hi, a + batch - 1)
        # every rank reconstructs (on the mesh the donor gather is a
        # collective); only the ranks holding the replica encode its
        # shards and install them
        data = _reconstruct(state, code, donor_rows, a, b, view)  # [N, S]
        if mine:
            shards = encode_device(code, data)[replica]           # [N, Sk]
            state = install_entries(state, replica, a, shards,
                                    terms_all[ofs:ofs + b - a + 1],
                                    leader_term, commit_to, batch, view)
    return state
