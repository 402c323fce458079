"""The port's RS codec (raft_tpu_torch.ec) against the JAX package's:

- the GF(2^8) tables and matrix algebra, the RS matrices and NumPy oracle,
  and the bit-decomposition constants of the parity matrix and of the
  decode matrix of every serving row set;
- K6's plain version (``encode_bitwise`` / ``decode_bitwise``, reached
  through ``encode_device`` / ``decode_device`` on CPU tensors) against
  ``encode_pallas`` / ``decode_pallas`` (Pallas in interpret mode);
- K7's plain version (``encode_fold_device`` on CPU tensors) against
  ``_encode_fold_pallas`` and against ``fold_shards_device(encode_device)``.

RS(5,3), RS(4,2) and RS(6,4) with 24-byte entries, B = 128. Every
comparison is exact."""

from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ec import gf as jgf
from raft_tpu.ec import kernels as jk
from raft_tpu.ec.rs import RSCode as JCode
from raft_tpu_torch.ec import gf as tgf
from raft_tpu_torch.ec import kernels as tk
from raft_tpu_torch.ec.rs import RSCode

CODES = [(5, 3), (4, 2), (6, 4)]
B, S = 128, 24


def _data(seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 256, (b, s),
                                                dtype=np.uint8)


def test_gf_tables_and_algebra_match():
    np.testing.assert_array_equal(tgf.EXP, jgf.EXP)
    np.testing.assert_array_equal(tgf.LOG, jgf.LOG)
    a = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tgf.mul(a[:, None], a[None, :]),
                                  jgf.mul(a[:, None], a[None, :]))
    np.testing.assert_array_equal(tgf.inv(a[1:]), jgf.inv(a[1:]))
    for c in (0, 1, 2, 0x53, 255):
        np.testing.assert_array_equal(tgf.mul_table(c), jgf.mul_table(c))
    m = JCode(6, 4).generator[[0, 2, 4, 5]]
    np.testing.assert_array_equal(tgf.mat_inv(m), jgf.mat_inv(m))
    np.testing.assert_array_equal(tgf.mat_mul(m, tgf.mat_inv(m)),
                                  np.eye(4, dtype=np.uint8))
    with pytest.raises(ZeroDivisionError):
        tgf.inv(0)


@pytest.mark.parametrize("n,k", CODES)
def test_rs_matrices_oracle_and_consts_match(n, k):
    t, j = RSCode(n, k), JCode(n, k)
    assert t.m == j.m
    np.testing.assert_array_equal(t.parity_matrix, j.parity_matrix)
    np.testing.assert_array_equal(t.generator, j.generator)
    np.testing.assert_array_equal(tk.parity_consts(n, k),
                                  jk.parity_consts(n, k))
    data = _data(n * 10 + k)
    np.testing.assert_array_equal(t.split(data), j.split(data))
    np.testing.assert_array_equal(t.encode(data), j.encode(data))
    shards = t.encode(data)
    for rows in combinations(range(n), k):
        np.testing.assert_array_equal(t.decode_matrix(rows),
                                      j.decode_matrix(rows))
        want = np.frombuffer(jk._decode_consts_key(n, k, rows),
                             np.uint8).reshape(k, k, 8)
        np.testing.assert_array_equal(tk.decode_consts(n, k, rows), want)
        got = t.decode(shards[list(rows)], rows)
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(t.unsplit(t.split(data)), data)
    with pytest.raises(ValueError):
        RSCode(3, 4)


@pytest.mark.parametrize("n,k", CODES)
def test_k6_plain_matches_pallas(n, k):
    """Encode against ``encode_pallas``; decode for every C(n, k) row set
    against the input bytes, and against ``decode_pallas`` for the set
    with the most parity rows (each row set is a Pallas program of its
    own; the constants of every set are pinned above)."""
    data = _data(100 + n)
    j, t = JCode(n, k), RSCode(n, k)
    got = tk.encode_device(t, torch.from_numpy(data))
    assert got.dtype == torch.uint8 and not got.is_cuda
    want = np.array(jk.encode_pallas(j, jnp.asarray(data)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), t.encode(data))
    sets = list(combinations(range(n), k))
    for rows in sets:
        sh = want[list(rows)]
        dec = tk.decode_device(t, torch.from_numpy(sh), rows).numpy()
        np.testing.assert_array_equal(dec, data, err_msg=f"rows {rows}")
        if rows == sets[-1]:
            np.testing.assert_array_equal(
                dec, np.asarray(jk.decode_pallas(j, jnp.asarray(sh), rows)),
                err_msg=f"rows {rows}")
    with pytest.raises(ValueError, match="exactly k"):
        tk.decode_device(t, torch.from_numpy(want[:k]), range(k + 1))


@pytest.mark.parametrize("n,k", CODES)
def test_k7_plain_matches_pallas_and_unfused(n, k):
    data = _data(200 + n)
    j, t = JCode(n, k), RSCode(n, k)
    got = tk.encode_fold_device(t, torch.from_numpy(data))
    assert got.dtype == torch.int32 and got.shape == (B, n * S // k // 4)
    want = np.asarray(jk._encode_fold_pallas(
        k, n - k, jk._parity_consts_key(n, k), jnp.asarray(data)))
    np.testing.assert_array_equal(got.numpy(), want)
    unfused = tk.fold_shards_device(tk.encode_device(t, torch.from_numpy(
        data)))
    np.testing.assert_array_equal(got.numpy(), unfused.numpy())
    np.testing.assert_array_equal(
        unfused.numpy(),
        np.asarray(jk.fold_shards_device(jnp.asarray(t.encode(data)))))


def test_folds_match_host_fold():
    """Both folds view bytes as little-endian words, as numpy's host fold
    and the JAX package's bitcast do."""
    data = _data(7, b=16, s=24)
    lanes = tk.fold_data_lanes(torch.from_numpy(data))
    np.testing.assert_array_equal(lanes.numpy(), data.view(np.int32))
    np.testing.assert_array_equal(
        lanes.numpy(), np.asarray(jk.fold_data_lanes(jnp.asarray(data))))
    shards = RSCode(5, 3).encode(data)
    folded = tk.fold_shards_device(torch.from_numpy(shards)).numpy()
    np.testing.assert_array_equal(
        folded,
        np.ascontiguousarray(np.swapaxes(shards, 0, 1)).reshape(16, -1)
        .view(np.int32))


def test_wrappers_take_plain_version_on_cpu():
    counts = dict(tk.LAUNCHES)
    t = RSCode(5, 3)
    x = torch.from_numpy(_data(9, b=8))
    tk.decode_device(t, tk.encode_device(t, x)[[0, 3, 4]], (0, 3, 4))
    tk.encode_fold_device(t, x)
    assert tk.LAUNCHES == counts
