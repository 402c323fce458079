"""Ring twins (core.ring) and kernel K1's plain version (core.ring_cuda)
against the JAX package: the XLA formulations of raft_tpu/core/ring.py and
the Pallas kernel write_window_both_tpu in interpret mode — wrap seam,
partial counts, mixed accept and truncating conflicts. Bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import ring as jring
from raft_tpu.core.ring_pallas import write_window_both_tpu
from raft_tpu_torch.core import ring as tring
from raft_tpu_torch.core.ring_cuda import LAUNCHES, write_window_both

C, B, L = 512, 128, 3
M = 8 * L
SEAM = [0, 3, 63, C - B, C - B + 11, C - 1]   # C-B+11 and C-1 wrap
# one compiled program per reference function (s and count traced)
J_WRITE_COLS = jax.jit(jring.write_window_cols_xla)
J_WRITE_ROWS = jax.jit(jring.write_window_rows)
J_READ_COLS = jax.jit(jring.read_window_cols, static_argnums=2)
J_READ = jax.jit(jring.read_window, static_argnums=2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("s", SEAM)
@pytest.mark.parametrize("count", [0, 29, B])
def test_twins_match_xla(s, count):
    rng = np.random.default_rng(s * 7 + count)
    buf = rng.integers(-2**31, 2**31 - 1, (C, M), dtype=np.int32)
    buf_t = rng.integers(0, 6, (L, C), dtype=np.int32)
    win = rng.integers(-2**31, 2**31 - 1, (B, M), dtype=np.int32)
    win_t = rng.integers(0, 6, B, dtype=np.int32)
    lanes = np.repeat(rng.random(L) < 0.6, M // L)
    accept = rng.random(L) < 0.6
    want = J_WRITE_COLS(jnp.asarray(buf), jnp.asarray(win), jnp.int32(s),
                        jnp.int32(count), jnp.asarray(lanes))
    got = tring.write_window_cols_xla(_t(buf), _t(win), s,
                                      torch.tensor(count), _t(lanes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = J_WRITE_ROWS(jnp.asarray(buf_t), jnp.asarray(win_t),
                        jnp.int32(s), jnp.int32(count), jnp.asarray(accept))
    got = tring.write_window_rows(_t(buf_t), _t(win_t), torch.tensor(s),
                                  count, _t(accept))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tring.read_window_cols(_t(buf), s, B).numpy(),
        np.asarray(J_READ_COLS(jnp.asarray(buf), jnp.int32(s), B)))
    np.testing.assert_array_equal(
        tring.read_window(_t(buf_t), torch.tensor(s), B).numpy(),
        np.asarray(J_READ(jnp.asarray(buf_t), jnp.int32(s), B)))


def _k1_case(s, count, seed, conflict=False):
    rng = np.random.default_rng(seed)
    buf_p = rng.integers(-2**31, 2**31 - 1, (C, M), dtype=np.int32)
    buf_t = rng.integers(1, 6, (L, C), dtype=np.int32)
    win = rng.integers(-2**31, 2**31 - 1, (B, M), dtype=np.int32)
    win_t = rng.integers(1, 6, B, dtype=np.int32)
    accept = rng.random(L) < 0.7
    ws = s + 1 + int(rng.integers(0, 3)) * C
    last_index = rng.integers(0, ws + B + 4, L).astype(np.int32)
    if conflict:
        # row 1: a longer log whose window slots carry a stale term — the
        # truncating §5.3 case; row 2: a consistent (same-term) suffix
        accept[:] = True
        win_t[:] = 5
        last_index[1] = ws + B + 3
        last_index[2] = ws + B + 3
        slots = (s + np.arange(B)) % C
        buf_t[1, slots] = 5
        buf_t[1, slots[count // 2]] = 2
        buf_t[2, slots] = 5
    return buf_p, buf_t, win, win_t, accept, ws, last_index


@pytest.mark.parametrize("s,count,conflict", [
    (0, B, False), (63, 29, False), (C - B, B, False),
    (C - B + 11, B, False), (C - B + 11, 29, False), (C - 1, 1, False),
    (C - 1, 0, False), (64, B, True), (C - 40, 77, True),
])
def test_k1_plain_matches_pallas(s, count, conflict):
    buf_p, buf_t, win, win_t, accept, ws, last = _k1_case(
        s, count, seed=s * 7 + count, conflict=conflict)
    jp, jt, jmm = write_window_both_tpu(
        jnp.asarray(buf_p), jnp.asarray(buf_t), jnp.asarray(win),
        jnp.asarray(win_t), jnp.int32(s), jnp.int32(count), jnp.int32(ws),
        jnp.asarray(accept), jnp.asarray(last), interpret=True)
    tp, tt = _t(buf_p), _t(buf_t)
    n0 = LAUNCHES["write_window_both"]
    mm = write_window_both(tp, tt, _t(win), _t(win_t), torch.tensor(s),
                           torch.tensor(count), torch.tensor(ws), _t(accept),
                           _t(last))
    assert LAUNCHES["write_window_both"] == n0   # CPU: the plain version
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(mm.numpy() != 0, np.asarray(jmm)[0] != 0)
    assert mm.dtype == torch.int32
    if conflict:
        assert list(mm.numpy()[1:] != 0) == [True, False]
