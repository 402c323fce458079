"""The host side of K6 (``raft_tpu_torch.ec.kernels``), which the CPU can
check although the kernel runs only on the card:

- the packed lookup tables K6 receives (``_tables_on``, ``gf_tables``):
  for the parity matrix and for the decode matrix of every ordered row set
  the tests use, byte q of entry x of table (j, g) must be
  ``raft_tpu.ec.gf.mul(M[4g + q, j], x)`` (0 past the last output row),
  with M the JAX package's matrix;
- the source description that ``reconstruct`` hands K6 for a decoding
  read (``ec.reconstruct.ring_source``): the words it addresses, expanded
  here from its row offsets, row stride, capacity and start slot, must be
  the slots and rows that JAX ``gather_shard_window`` reads, for a
  whole-ring window and one across the seam (RS(5,3), C = 512);
  ``gather_source``, the plain version's form of the same addressing, too.

Everything is compared exactly."""

from itertools import combinations, permutations

import numpy as np
import pytest
import torch

from raft_tpu.ec import gf as jgf
from raft_tpu.ec import reconstruct as jrec
from raft_tpu.ec.rs import RSCode as JCode
from raft_tpu_torch.ec import kernels as ek
from raft_tpu_torch.ec.reconstruct import ring_source
from tests._torch_port import to_port
from tests.test_torch_ec_reconstruct import C, LAST, _cluster

CPU = torch.device("cpu")


def _assert_tables(tables: torch.Tensor, matrix: np.ndarray) -> None:
    rows, k = matrix.shape
    t = tables.numpy().view(np.uint32)
    assert t.shape == (k, -(-rows // 4), 256)
    x = np.arange(256, dtype=np.uint8)
    for j in range(k):
        for g in range(t.shape[1]):
            for q in range(4):
                got = (t[j, g] >> np.uint32(8 * q)) & np.uint32(0xFF)
                r = 4 * g + q
                want = jgf.mul(matrix[r, j], x) if r < rows else 0
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"j={j} r={r}")


#: codes whose tables span one and several output-row groups
CODES = [(5, 3), (4, 2), (6, 4), (14, 4), (12, 10)]


@pytest.mark.parametrize("n,k", CODES)
def test_parity_tables_match_gf_mul(n, k):
    _assert_tables(ek._tables_on(CPU, n, k, None), JCode(n, k).parity_matrix)


def _ordered_sets(n, k):
    """Every row set of the RS(5,3) tests, and permutations of a few: the
    decode matrix depends on the serving rows' order."""
    sets = list(combinations(range(n), k)) + [(2, 0, 1)]
    sets += list(permutations((1, 2, 4))) + list(permutations((0, 3, 4)))
    return sets


def test_decode_tables_match_gf_mul_for_every_ordered_row_set():
    jcode = JCode(5, 3)
    for rows in _ordered_sets(5, 3):
        _assert_tables(ek._tables_on(CPU, 5, 3, rows),
                       jcode.decode_matrix(list(rows)))
    # k > 4: the decode matrix spans two output-row groups
    _assert_tables(ek._tables_on(CPU, 8, 6, (7, 0, 5, 1, 6, 2)),
                   JCode(8, 6).decode_matrix([7, 0, 5, 1, 6, 2]))


WINDOWS = {"whole_ring": (LAST - C + 1, LAST), "seam": (500, 530)}


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_ring_source_addresses_what_jax_gathers(window):
    lo, hi = WINDOWS[window]
    js, _ = _cluster()
    ts = to_port(js)
    n, w = hi - lo + 1, ts.words_per_entry
    flat = ts.log_payload.reshape(-1)
    for rows in [(1, 2, 4), (0, 3, 4), (2, 0, 1), (4, 3, 2)]:
        src = ring_source(ts, rows, lo)
        assert (src.entry, src.cap) == (ts.log_payload.shape[1], C)
        # K6's addressing, written out: row j of entry i at word
        # ((start + i) mod cap) * entry + rows[j] + word
        words = np.empty((len(rows), n, w), np.int32)
        for j, off in enumerate(src.rows):
            for i in range(n):
                slot = src.start + i
                if slot >= src.cap:
                    slot -= src.cap
                base = slot * src.entry + off
                words[j, i] = flat[base:base + w].numpy()
        want = np.asarray(jrec.gather_shard_window(js, list(rows), lo, hi))
        np.testing.assert_array_equal(words.view(np.uint8), want,
                                      err_msg=f"{rows}")
        np.testing.assert_array_equal(
            ek.gather_source(ts.log_payload, src, n, w).numpy(), want,
            err_msg=f"gather_source {rows}")
