"""Kernel K5's plain version (core.ring.write_window_cols_xla, reached
through core.ring_cuda.write_window_cols on CPU tensors) against the JAX
package's Pallas kernel write_window_cols_tpu in interpret mode: the seam
starts x counts of tests/test_ring_pallas.py, the all-reject no-op, and a
group-batched call with per-group starts, counts and lane masks against the
kernel under jax.vmap, as the JAX group programs reach it. Bit-exact."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.ring_pallas import write_window_cols_tpu
from raft_tpu_torch.core.ring_cuda import LAUNCHES, write_window_cols

C, B, M = 512, 128, 24
STARTS = [0, 1, 7, 63, 64, 100, C - B, C - B + 1, C - B + 37, C - 1]
J_VMAP = jax.vmap(partial(write_window_cols_tpu, interpret=True))


def _rand(rng, *shape):
    return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int32)


def _port(buf, win, s, count, lanes):
    """The port's wrapper on CPU tensors: the plain version, no launch."""
    n0 = LAUNCHES["write_window_cols"]
    out = write_window_cols(torch.from_numpy(buf.copy()),
                            torch.from_numpy(win), s, count,
                            torch.from_numpy(lanes))
    assert LAUNCHES["write_window_cols"] == n0
    return out.numpy()


@pytest.mark.parametrize("s", STARTS)
@pytest.mark.parametrize("count", [0, 1, 17, B - 1, B])
def test_plain_matches_pallas(s, count):
    rng = np.random.default_rng(s * 1000 + count)
    buf, win = _rand(rng, C, M), _rand(rng, B, M)
    lanes = rng.random(M) < 0.7
    want = write_window_cols_tpu(jnp.asarray(buf), jnp.asarray(win),
                                 jnp.int32(s), jnp.int32(count),
                                 jnp.asarray(lanes), interpret=True)
    got = _port(buf, win, torch.tensor(s, dtype=torch.int32),
                torch.tensor(count, dtype=torch.int32), lanes)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_all_lanes_reject_is_noop():
    rng = np.random.default_rng(0)
    buf, win = _rand(rng, C, M), _rand(rng, B, M)
    got = _port(buf, win, 5, B, np.zeros(M, bool))
    np.testing.assert_array_equal(got, buf)


def test_grouped_matches_vmapped_pallas():
    """G groups in one call, each with its own start (seams included),
    count (0 and B included) and per-lane mask, against the Pallas kernel
    vmapped over the group axis — and against G unbatched calls."""
    rng = np.random.default_rng(7)
    G = 6
    buf, win = _rand(rng, G, C, M), _rand(rng, G, B, M)
    s = np.array([0, 63, C - B, C - B + 11, C - 1, 200], np.int32)
    count = np.array([B, 17, 0, B - 1, 1, B], np.int32)
    lanes = rng.random((G, M)) < 0.6
    want = np.asarray(J_VMAP(jnp.asarray(buf), jnp.asarray(win),
                             jnp.asarray(s), jnp.asarray(count),
                             jnp.asarray(lanes)))
    got = _port(buf, win, torch.from_numpy(s), torch.from_numpy(count),
                lanes)
    np.testing.assert_array_equal(got, want)
    for g in range(G):
        np.testing.assert_array_equal(
            _port(buf[g], win[g], int(s[g]), int(count[g]), lanes[g]),
            want[g], err_msg=f"group {g} alone")
