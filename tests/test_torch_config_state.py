"""raft_tpu_torch config, state helpers and quorum rules against the JAX
package: every RaftConfig field, default and rejection; the host folds and
read-backs byte for byte; the numpy carry-across pair; the commit rules."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import config as jcfg
from raft_tpu.core import state as jst
from raft_tpu.quorum import commit as jq
from raft_tpu_torch import config as tcfg
from raft_tpu_torch.core import state as tst
from raft_tpu_torch.quorum import commit as tq
from tests._torch_port import assert_states_equal, jax_leaves, to_port

PROPS = ("rows", "majority", "commit_quorum", "ec_enabled", "session_lag",
         "lease_duration_s", "shard_bytes", "shard_words")


def test_fields_and_defaults_match():
    jf = dataclasses.fields(jcfg.RaftConfig)
    tf = dataclasses.fields(tcfg.RaftConfig)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.default == b.default, a.name
        assert a.type == b.type, a.name
    assert tcfg.RaftConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [
    {},
    dict(n_replicas=5, entry_bytes=24, batch_size=128, log_capacity=1024,
         rs_k=3, rs_m=2),
    dict(n_replicas=3, max_replicas=5, entry_bytes=8, batch_size=128,
         log_capacity=256),
    dict(n_replicas=5, entry_bytes=24, batch_size=64, log_capacity=256,
         rs_k=3, rs_m=2, ec_commit_margin=2, session_max_lag=7),
])
def test_properties_match(kw):
    a, b = jcfg.RaftConfig(**kw), tcfg.RaftConfig(**kw)
    for p in PROPS:
        assert getattr(a, p) == getattr(b, p), p
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("kw", [
    dict(n_replicas=0),
    dict(batch_size=1024, log_capacity=1536),       # C < 2B
    dict(batch_size=1000, log_capacity=32768),      # C % B
    dict(rs_k=3),
    dict(n_replicas=5, rs_k=3, rs_m=1),
    dict(n_replicas=5, entry_bytes=256, rs_k=3, rs_m=2),
    dict(n_replicas=5, entry_bytes=24, rs_k=3, rs_m=2, ec_commit_margin=3),
    dict(payload_shards=0),
    dict(channel_depth=0),
    dict(n_replicas=3, max_replicas=2),
    dict(steady_dispatch="sometimes"),
    dict(pipeline_max_laps=0),
    dict(fuse_k=0),
    dict(read_lease=True),
    dict(entry_bytes=6),
    dict(entry_bytes=8, payload_shards=3),
    dict(clock_drift_bound=0.5),
])
def test_rejections_match(kw):
    with pytest.raises(ValueError) as ja:
        jcfg.RaftConfig(**kw)
    with pytest.raises(ValueError) as ta:
        tcfg.RaftConfig(**kw)
    assert str(ja.value) == str(ta.value)


def _random_jax_state(seed, R=3, C=64, W=2):
    rng = np.random.default_rng(seed)
    fields = {
        "term": rng.integers(0, 5, R), "voted_for": rng.integers(-1, R, R),
        "last_index": rng.integers(0, 3 * C, R),
        "commit_index": rng.integers(0, C, R),
        "match_index": rng.integers(0, C, R),
        "match_term": rng.integers(0, 5, R),
        "log_term": rng.integers(0, 5, (R, C)),
        "log_payload": rng.integers(-2**31, 2**31 - 1, (C, R * W)),
    }
    return jst.ReplicaState(**{k: jnp.asarray(v.astype(np.int32))
                               for k, v in fields.items()})


def test_init_state_matches():
    cfg = dict(n_replicas=3, max_replicas=5, entry_bytes=8, batch_size=128,
               log_capacity=256)
    assert_states_equal(jst.init_state(jcfg.RaftConfig(**cfg)),
                        tst.init_state(tcfg.RaftConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_state_round_trip_and_read_helpers(seed):
    js = _random_jax_state(seed)
    ts = to_port(js)
    back = tst.state_from_numpy(tst.state_to_numpy(ts), device="cpu")
    assert_states_equal(js, back)
    np.testing.assert_array_equal(
        tst.last_log_term(ts).numpy(), np.asarray(jst.last_log_term(js)))
    for r in range(3):
        np.testing.assert_array_equal(tst.payload_slot_bytes(ts, r),
                                      jst.payload_slot_bytes(js, r))
        for lo, hi in ((1, 10), (50, 140), (5, 4)):
            np.testing.assert_array_equal(tst.log_entries(ts, r, lo, hi),
                                          jst.log_entries(js, r, lo, hi))
    st = ts.replace(commit_index=torch.tensor([70, 0, 3], dtype=torch.int32))
    jsc = js.replace(commit_index=jnp.asarray([70, 0, 3], jnp.int32))
    for r in range(3):
        np.testing.assert_array_equal(tst.committed_payloads(st, r),
                                      jst.committed_payloads(jsc, r))


def test_folds_are_byte_identical():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (37, 24), dtype=np.uint8)
    for batch in (None, 64):
        np.testing.assert_array_equal(
            tst.fold_batch(data, 3, batch).numpy(),
            np.asarray(jst.fold_batch(data, 3, batch)))
    rows = rng.integers(0, 256, (5, 37, 8), dtype=np.uint8)
    for batch in (None, 40):
        np.testing.assert_array_equal(tst.fold_rows(rows, batch).numpy(),
                                      np.asarray(jst.fold_rows(rows, batch)))
    words = tst.fold_batch(data, 1).numpy()
    np.testing.assert_array_equal(tst.unfold_bytes(words), data)
    np.testing.assert_array_equal(tst.unfold_bytes(torch.from_numpy(words)),
                                  jst.unfold_bytes(words))


def test_slot_of_and_membership():
    idx = np.arange(-70, 300, dtype=np.int32)
    np.testing.assert_array_equal(
        tst.slot_of(torch.from_numpy(idx), 64).numpy(),
        np.asarray(jst.slot_of(jnp.asarray(idx), 64)))
    m = np.array([True, False, True, False])
    lr = np.array([False, True, False, False])
    packed = tst.pack_membership(m, lr)
    np.testing.assert_array_equal(packed, jst.pack_membership(m, lr))
    np.testing.assert_array_equal(
        tst.membership_voters(torch.from_numpy(packed)).numpy(),
        np.asarray(jst.membership_voters(jnp.asarray(packed))))
    b = torch.tensor([True, False])
    assert tst.membership_voters(b) is b
    with pytest.raises(ValueError):
        tst.pack_membership(m, m)


@pytest.mark.parametrize("seed", range(4))
def test_quorum_rules_match(seed):
    rng = np.random.default_rng(seed)
    for R in (1, 4, 5):
        match = rng.integers(0, 6, R).astype(np.int32)
        tm = torch.from_numpy(match)
        for q in (None, 1, R // 2 + 1, R):
            got = tq.commit_from_match(tm, q)
            assert got.dtype == torch.int32
            assert int(got) == int(jq.commit_from_match(jnp.asarray(match), q))
        prev = jnp.int32(int(rng.integers(0, 4)))
        got = tq.reference_bucket_commit(tm, R + 1, torch.tensor(int(prev)))
        assert int(got) == int(jq.reference_bucket_commit(
            jnp.asarray(match), R + 1, prev))
        assert tq.majority(R) == jq.majority(R)
        for v in range(R + 1):
            assert bool(tq.vote_majority(torch.tensor(v), R)) == bool(
                jq.vote_majority(jnp.int32(v), R))


def test_leaves_cross_through_numpy():
    js = _random_jax_state(9)
    leaves = jax_leaves(jax.tree.map(np.asarray, js))
    ts = tst.state_from_numpy(leaves, device="cpu")
    assert ts.capacity == js.capacity
    assert ts.words_per_entry == js.words_per_entry
    assert all(getattr(ts, f).dtype == torch.int32 for f in tst.FIELDS)
    c = ts.clone()
    c.log_term.add_(1)
    assert_states_equal(js, ts)
