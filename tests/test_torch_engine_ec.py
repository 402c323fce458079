"""The erasure-coded engine (``RaftEngine`` with ``rs_k`` set, ROADMAP
A9e) against the JAX engine: RS(5,3) shards through the whole stack
(engine -> transport -> step), with both engines in lock step (``Pair``:
nodelog, rng, heap, stamps, every state leaf — every shard row — the
archive and the apply stream equal after every event).

The cases of ``tests/test_ec_integration.py``: the k + margin commit
quorum, reads from every 3-row set, a slow follower, two slow rows
blocking commit, the heal by reconstruction, reads with two rows dead,
recovered followers unblocking commit through the suffix re-serve, the
buffer draining, and a deposed leader's stranded suffix; then the
suffix rebuilt from shards and an unrecoverable suffix abandoned, and
``install_entries`` cutting an unverified suffix. 5 replicas, 24-byte
entries (8-byte shards), B = 4, C = 128. On the CPU the port's K6/K7
wrappers run their plain versions (the launch counters stay at 0).
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core import state as jst
from raft_tpu.ec import reconstruct as jrec
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.ec import kernels as ek
from raft_tpu_torch.ec import reconstruct as trec
from raft_tpu_torch.ec.rs import RSCode
from tests._torch_port import assert_states_equal, to_port
from tests.test_torch_engine import Pair, payloads

ENTRY = 24
EC = dict(n_replicas=5, entry_bytes=ENTRY, batch_size=4, log_capacity=128,
          rs_k=3, rs_m=2)


def ec_pair(seed):
    return Pair(seed, **EC)


def want(ps):
    return np.frombuffer(b"".join(ps), np.uint8).reshape(len(ps), ENTRY)


def test_commit_quorum_is_k_plus_margin():
    for cfg in (TConfig(**EC), JConfig(**EC)):
        assert cfg.commit_quorum == 4 and cfg.shard_words == 2


def test_submit_commit_reconstruct_roundtrip():
    p = ec_pair(1)
    p.until_leader()
    ps = payloads(12, 2, entry=ENTRY)
    seqs = p.submit(ps)
    p.until_committed(seqs[-1])
    p.check_all()
    code = RSCode(5, 3)
    for rows in combinations(range(5), 3):
        np.testing.assert_array_equal(
            trec.reconstruct(p.t.state, code, rows, 1, 12), want(ps),
            err_msg=f"rows={rows}")
    assert all(v == 0 for v in ek.LAUNCHES.values())   # plain on the CPU


def test_each_replica_stores_one_shard_not_full_copy():
    p = ec_pair(1)
    p.until_leader()
    seqs = p.submit(payloads(4, 3, entry=ENTRY))
    p.until_committed(seqs[-1])
    assert p.t.state.log_payload.shape[-1] == 5 * (ENTRY // 3 // 4)
    assert p.t.state.words_per_entry == ENTRY // 3 // 4
    # every row's column is its own RS shard row of the entries
    shards = RSCode(5, 3).encode(want(payloads(4, 3, entry=ENTRY)))
    for r in range(5):
        np.testing.assert_array_equal(
            trec.gather_shard_window(p.t.state, [r], 1, 4).numpy()[0],
            shards[r])


def test_slow_follower_commit_still_advances():
    p = ec_pair(2)
    lead = p.until_leader()
    p.both("set_slow", (lead + 1) % 5, True)
    seqs = p.submit(payloads(8, 4, entry=ENTRY))
    p.until_committed(seqs[-1])
    p.check_all()
    assert p.t.commit_watermark >= 8


def test_two_slow_block_commit_at_quorum_4():
    p = ec_pair(3)
    lead = p.until_leader()
    for i in (1, 2):
        p.both("set_slow", (lead + i) % 5, True)
    p.submit(payloads(4, 5, entry=ENTRY))
    p.run_for(6 * p.t.cfg.heartbeat_period)
    p.check_all()
    assert p.t.commit_watermark == 0


def test_healing_by_reconstruction():
    p = ec_pair(4)
    lead = p.until_leader()
    slow = (lead + 2) % 5
    p.both("set_slow", slow, True)
    ps = payloads(8, 6, entry=ENTRY)
    seqs = p.submit(ps)
    p.until_committed(seqs[-1])
    assert int(p.t.state.match_index[slow]) < 8
    p.both("set_slow", slow, False)
    p.run_for(2 * p.t.cfg.heartbeat_period)
    p.check_all()
    assert any(f"[Server{slow}:" in ln and "healed by reconstruction" in ln
               for ln in p.tl)
    assert int(p.t.state.match_index[slow]) >= 8
    rows = [slow] + [q for q in range(5) if q != slow][:2]
    np.testing.assert_array_equal(
        trec.reconstruct(p.t.state, RSCode(5, 3), rows, 1, 8), want(ps))


def test_read_survives_two_dead_replicas():
    """Any 3 of 5 shard rows decode: ``committed_entries`` with two rows
    dead reads through the survivors (a parity row among them)."""
    p = ec_pair(5)
    lead = p.until_leader()
    ps = payloads(6, 7, entry=ENTRY)
    seqs = p.submit(ps)
    p.until_committed(seqs[-1])
    for d in ((lead + 1) % 5, (lead + 2) % 5):
        p.both("fail", d)
    p.check_all()
    np.testing.assert_array_equal(p.t.committed_entries(1, 6), want(ps))


def test_recovered_followers_unblock_commit():
    """With quorum k + 1 = 4, entries ingested while two followers are
    down commit only after the recovered followers are re-served the
    uncommitted suffix from the host buffer."""
    p = ec_pair(6)
    lead = p.until_leader()
    dead = [(lead + 1) % 5, (lead + 2) % 5]
    for d in dead:
        p.both("fail", d)
    ps = payloads(6, 8, entry=ENTRY)
    seqs = p.submit(ps)
    p.run_for(4 * p.t.cfg.heartbeat_period)
    assert p.t.commit_watermark == 0
    for d in dead:
        p.both("recover", d)
    p.until_committed(seqs[-1])
    p.run_for(2 * p.t.cfg.heartbeat_period)
    p.check_all()
    assert any("suffix re-served" in ln for ln in p.tl)
    np.testing.assert_array_equal(
        trec.reconstruct(p.t.state, RSCode(5, 3), dead + [lead], 1, 6),
        want(ps))


def test_uncommitted_buffer_drains_on_commit():
    p = ec_pair(7)
    p.until_leader()
    seqs = p.submit(payloads(5, 9, entry=ENTRY))
    p.until_committed(seqs[-1])
    p.check_all()
    assert p.t._uncommitted == {}


def test_deposed_leader_with_stranded_suffix_cannot_wedge():
    p = ec_pair(8)
    lead = p.until_leader()
    seqs = p.submit(payloads(4, 10, entry=ENTRY))
    p.until_committed(seqs[-1])
    w = p.t.commit_watermark
    others = [q for q in range(5) if q != lead]
    for q in others:
        p.both("fail", q)
    p.submit(payloads(3, 11, entry=ENTRY))
    p.run_for(3 * p.t.cfg.heartbeat_period)      # ingested by lead alone
    assert int(p.t.state.last_index[lead]) > w
    p.both("fail", lead)
    for q in others:
        p.both("recover", q)
    p.until_leader()
    p.both("recover", lead)
    p.run_for(4 * p.t.cfg.heartbeat_period)
    p.both("force_campaign", lead)
    p.run_for(4 * p.t.cfg.heartbeat_period)
    fresh = p.submit(payloads(3, 12, entry=ENTRY))
    p.until_committed(fresh[-1], limit=900.0)
    p.run_for(2 * p.t.cfg.heartbeat_period)
    p.check_all()


@pytest.mark.parametrize("holders,line", [
    (3, "rebuilt from shards"), (2, "abandoned"),
], ids=["refilled", "abandoned"])
def test_lost_suffix_bytes(holders, line):
    """The ingest buffer loses an uncommitted suffix: with k rows holding
    it in the current term it is rebuilt from their shards and
    re-served; with fewer than k holders anywhere it is abandoned (the
    tail truncated everywhere) so the quorum is not wedged."""
    p = ec_pair(9)
    lead = p.until_leader()
    seqs = p.submit(payloads(4, 13, entry=ENTRY))
    p.until_committed(seqs[-1])
    down = [(lead + i) % 5 for i in range(1, 6 - holders)]
    for q in down:
        p.both("fail", q)
    lost = p.submit(payloads(4, 14, entry=ENTRY))
    p.run_for(3 * p.t.cfg.heartbeat_period)
    assert p.t.commit_watermark == 4 and len(p.t._uncommitted) == 4
    for e in (p.j, p.t):
        e._uncommitted.clear()
    for q in down:
        p.both("recover", q)
    p.run_for(3 * p.t.cfg.heartbeat_period)
    assert any(line in ln for ln in p.tl)
    fresh = p.submit(payloads(3, 15, entry=ENTRY))
    p.until_committed(fresh[-1])
    p.run_for(2 * p.t.cfg.heartbeat_period)
    p.check_all()
    assert all(p.t.is_durable(s) for s in lost) == (holders == 3)


def test_install_entries_cuts_unverified_suffix():
    """Chunked ``install_entries`` (B = 4, ten entries) onto a row holding
    a junk suffix of an older term: the suffix beyond the install is cut,
    as in the JAX package."""
    cfg = JConfig(**EC, transport="single")
    js = jst.init_state(cfg)
    js = js.replace(last_index=js.last_index.at[2].set(20),
                    match_index=js.match_index.at[2].set(20),
                    match_term=js.match_term.at[2].set(2))
    ts = to_port(js)
    rng = np.random.default_rng(16)
    shards = rng.integers(0, 256, (10, 8), dtype=np.uint8)
    terms = np.full(10, 3, np.int32)
    js = jrec.install_entries(js, 2, 3, shards, terms, 3, 8, 4)
    ts = trec.install_entries(ts, 2, 3, torch.from_numpy(shards),
                              torch.from_numpy(terms), 3, 8, 4)
    assert_states_equal(js, ts, "install_entries")
    assert int(ts.last_index[2]) == 12 and int(ts.commit_index[2]) == 8
    np.testing.assert_array_equal(
        trec.gather_shard_window(ts, [2], 3, 12).numpy()[0], shards)
    assert int(js.match_term[2]) == int(ts.match_term[2]) == 3
