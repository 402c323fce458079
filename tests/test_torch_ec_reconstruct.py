"""Reconstruction reads, install and heal (raft_tpu_torch.ec.reconstruct)
against ``raft_tpu.ec.reconstruct`` on an RS(5,3) cluster whose rings hold
encoded entries across the ring seam (24-byte entries, B = 128, C = 512):

- ``gather_shard_window`` and ``reconstruct`` for the systematic row sets
  (no decode) and for sets that decode through a parity row;
- ``install_window``: both ``TestInstallWindow`` cases of
  tests/test_ec_integration.py (an unverified suffix is cut, a verified
  one kept);
- ``heal_replica`` from the data rows and from a set with a parity row,
  and its ring-horizon ``ValueError``.

Every leaf and byte is compared exactly."""

from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.ec import reconstruct as jrec
from raft_tpu.ec.rs import RSCode as JCode
from raft_tpu_torch.ec import reconstruct as trec
from raft_tpu_torch.ec.rs import RSCode
from tests._torch_port import assert_states_equal, to_port

N, K, B, C, E = 5, 3, 128, 512, 24
CFG = JConfig(n_replicas=N, entry_bytes=E, batch_size=B, log_capacity=C,
              rs_k=K, rs_m=N - K, transport="single")
LAST = 1000                                   # the ring has wrapped once


def _cluster(lag=0, seed=0):
    """Every row holds entries (LAST-C, LAST] of term 1, committed; row 4
    lags by ``lag`` entries (its newest slots hold nothing)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (LAST, E), dtype=np.uint8)
    idx = np.arange(LAST - C + 1, LAST + 1)
    shards = RSCode(N, K).encode(data[idx - 1])             # [N, C, Sk]
    payload = np.zeros((C, N * E // K // 4), np.int32)
    payload[(idx - 1) % C] = np.ascontiguousarray(
        np.swapaxes(shards, 0, 1)).reshape(C, -1).view(np.int32)
    log_term = np.ones((N, C), np.int32)
    last = np.full(N, LAST, np.int32)
    if lag:
        gone = (idx[-lag:] - 1) % C
        payload[gone, 4 * 2:] = 0
        log_term[4, gone] = 0
        last[4] = LAST - lag
    st = jst.init_state(CFG).replace(
        term=jnp.ones(N, jnp.int32), voted_for=jnp.zeros(N, jnp.int32),
        last_index=jnp.asarray(last), commit_index=jnp.asarray(last),
        match_index=jnp.asarray(last), match_term=jnp.ones(N, jnp.int32),
        log_term=jnp.asarray(log_term), log_payload=jnp.asarray(payload))
    return st, data


JAX_SETS = [(0, 1, 2), (2, 0, 1), (1, 2, 4), (0, 3, 4)]


def test_reconstruct_matches_jax_for_every_row_set():
    js, data = _cluster()
    ts = to_port(js)
    code, jcode = RSCode(N, K), JCode(N, K)
    for lo, hi in ((LAST - C + 1, LAST), (500, 530)):       # 500..512 seam
        want = data[lo - 1:hi]
        for rows in list(combinations(range(N), K)) + [(2, 0, 1)]:
            got = trec.reconstruct(ts, code, rows, lo, hi)
            assert isinstance(got, np.ndarray) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{rows}")
            if rows in JAX_SETS and hi - lo + 1 == C:
                np.testing.assert_array_equal(
                    trec.gather_shard_window(ts, rows, lo, hi).cpu().numpy(),
                    jrec.gather_shard_window(js, rows, lo, hi))
                np.testing.assert_array_equal(
                    got, jrec.reconstruct(js, jcode, rows, lo, hi),
                    err_msg=f"{rows}")


INSTALL = {
    # name: (match_term of row 1's 10-entry suffix, expected last/match)
    "unverified_suffix_truncated": (2, 4),
    "verified_suffix_kept": (3, 10),
}


@pytest.mark.parametrize("name", sorted(INSTALL))
def test_install_window_matches_jax(name):
    mterm, want = INSTALL[name]
    cfg = JConfig(n_replicas=N, entry_bytes=E, batch_size=4,
                  log_capacity=64, rs_k=K, rs_m=N - K, transport="single")
    js = jst.init_state(cfg)
    js = js.replace(last_index=js.last_index.at[1].set(10),
                    match_index=js.match_index.at[1].set(10),
                    match_term=js.match_term.at[1].set(mterm))
    ts = to_port(js)
    words = np.arange(8, dtype=np.int32).reshape(4, 2) - 3
    terms = np.full(4, 3, np.int32)
    js = jrec.install_window(js, 1, jnp.int32(1), jnp.int32(4),
                             jnp.asarray(words), jnp.asarray(terms),
                             jnp.int32(3), jnp.int32(4))
    ts = trec.install_window(ts, 1, 1, 4, torch.from_numpy(words),
                             torch.from_numpy(terms), 3, 4)
    assert_states_equal(js, ts, name)
    assert int(ts.last_index[1]) == want and int(ts.match_index[1]) == want
    assert int(ts.match_term[1]) == 3


@pytest.mark.parametrize("donors", [(0, 1, 2), (3, 1, 0)],
                         ids=["data_rows", "with_parity_row"])
def test_heal_replica_matches_jax(donors):
    lag = 300
    js, data = _cluster(lag=lag, seed=1)
    ts = to_port(js)
    lo, hi = LAST - lag + 1, LAST
    js = jrec.heal_replica(js, JCode(N, K), 4, list(donors), lo, hi, 1, hi,
                           B)
    ts = trec.heal_replica(ts, RSCode(N, K), 4, donors, lo, hi, 1, hi, B)
    assert_states_equal(js, ts, "heal")
    got = trec.gather_shard_window(ts, [4], lo, hi).cpu().numpy()[0]
    np.testing.assert_array_equal(got, RSCode(N, K).encode(data[lo - 1:hi])[4])
    assert int(ts.last_index[4]) == LAST


def test_heal_below_donor_horizon_raises():
    js, _ = _cluster(lag=20, seed=2)
    lo = LAST - C                                 # one slot past the horizon
    with pytest.raises(ValueError, match="horizon"):
        jrec.heal_replica(js, JCode(N, K), 4, [0, 1, 2], lo, LAST, 1, LAST,
                          B)
    with pytest.raises(ValueError, match="horizon"):
        trec.heal_replica(to_port(js), RSCode(N, K), 4, (0, 1, 2), lo, LAST,
                          1, LAST, B)
