"""The port's host RS codec (``raft_tpu_torch.native``, its own copy of
``rs_codec.cpp`` built with ``g++`` on first use) against the JAX
package's (``raft_tpu.native``) and the NumPy oracle: the GF multiply,
``apply_matrix`` (aligned, and every unaligned tail 1-25), and
``RSCode.encode_host`` / ``decode_host`` for every k-of-n row set, byte
for byte. Where the JAX package falls back to NumPy when the library
cannot be built, the port raises: a build that cannot run is an error,
never the NumPy path."""

import itertools

import numpy as np
import pytest

from raft_tpu import native as jnative
from raft_tpu.ec.rs import RSCode as JCode
from raft_tpu_torch import native
from raft_tpu_torch.ec import gf
from raft_tpu_torch.ec.rs import RSCode


def test_gf_mul_sample():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        a, b = int(rng.integers(0, 256)), int(rng.integers(0, 256))
        assert native.gf_mul(a, b) == int(gf.mul(a, b))
    assert all(native.gf_mul(a, b) == jnative.gf_mul(a, b)
               for a, b in rng.integers(0, 256, (200, 2)).tolist())


@pytest.mark.parametrize("in_rows,out_rows,nbytes",
                         [(3, 2, 1024), (4, 4, 333), (2, 5, 7)])
def test_apply_matrix_matches_numpy(in_rows, out_rows, nbytes):
    rng = np.random.default_rng(in_rows * 100 + nbytes)
    M = rng.integers(0, 256, (out_rows, in_rows), dtype=np.uint8)
    rows = rng.integers(0, 256, (in_rows, nbytes), dtype=np.uint8)
    got = native.apply_matrix(M, rows)
    np.testing.assert_array_equal(got, gf.mat_mul(M, rows))
    np.testing.assert_array_equal(got, jnative.apply_matrix(M, rows))


@pytest.mark.parametrize("nbytes", range(1, 26))
def test_unaligned_tail_bytes(nbytes):
    rng = np.random.default_rng(nbytes)
    M = rng.integers(0, 256, (2, 3), dtype=np.uint8)
    rows = rng.integers(0, 256, (3, nbytes), dtype=np.uint8)
    np.testing.assert_array_equal(native.apply_matrix(M, rows),
                                  gf.mat_mul(M, rows))


CODES = [(3, 2), (5, 3), (6, 4)]


@pytest.mark.parametrize("n,k", CODES)
def test_encode_host_matches_oracle_and_jax(n, k):
    rng = np.random.default_rng(n * k)
    data = rng.integers(0, 256, (64, 16 * k), dtype=np.uint8)
    got = RSCode(n, k).encode_host(data)
    np.testing.assert_array_equal(got, RSCode(n, k).encode(data))
    np.testing.assert_array_equal(got, JCode(n, k).encode_host(data))


@pytest.mark.parametrize("n,k", CODES)
def test_decode_host_any_k_of_n(n, k):
    rng = np.random.default_rng(n + k)
    code = RSCode(n, k)
    data = rng.integers(0, 256, (16, 8 * k), dtype=np.uint8)
    shards = code.encode(data)
    for rows in itertools.combinations(range(n), k):
        got = code.decode_host(shards[list(rows)], rows)
        np.testing.assert_array_equal(got, data, err_msg=f"rows={rows}")
        np.testing.assert_array_equal(
            got, JCode(n, k).decode_host(shards[list(rows)], rows))


def test_segment_sized_flat_buffer():
    """A flat buffer as the tiered store codes it (entries flattened and
    padded to a multiple of k), RS(6,4): encode, then decode from a row
    set missing two data rows."""
    rng = np.random.default_rng(7)
    flat = rng.integers(0, 256, 4 * 4099, dtype=np.uint8)
    code = RSCode(6, 4)
    shards = code.encode_host(flat)
    np.testing.assert_array_equal(shards, JCode(6, 4).encode_host(flat))
    rows = [1, 3, 4, 5]
    np.testing.assert_array_equal(code.decode_host(shards[rows], rows), flat)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setenv("RAFT_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_build_into_the_build_dir_with_a_source_hash(fresh_build):
    path = native.lib_path()
    assert path.parent == fresh_build / "build"
    assert path.name.startswith("librs_codec-") and path.suffix == ".so"
    assert native.gf_mul(3, 7) == int(gf.mul(3, 7))
    assert path.exists()
    assert not [p for p in path.parent.iterdir() if ".tmp" in p.name]


def test_missing_compiler_raises_never_falls_back(fresh_build, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    data = np.zeros((4, 8), np.uint8)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
        RSCode(3, 2).encode_host(data)
    with pytest.raises(native.NativeBuildError):
        RSCode(3, 2).decode_host(np.zeros((2, 4, 4), np.uint8), [0, 1])


def test_failing_build_raises_with_its_output(fresh_build, monkeypatch):
    bad = fresh_build / "rs_codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.apply_matrix(np.eye(2, dtype=np.uint8),
                            np.zeros((2, 3), np.uint8))
    assert not list((fresh_build / "build").glob("*.so"))
