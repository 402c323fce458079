"""The port's golden oracle (``raft_tpu_torch.golden``) against the JAX
package's, on ``tests/test_golden.py``'s cases: the same seeds give the
same nodelog lines and committed logs, and the port's device path (its
transport on the CPU) commits the oracle's bytes on every replica."""

import numpy as np
import pytest

from raft_tpu.golden import GoldenCluster as JGolden
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.state import committed_payloads, fold_batch
from raft_tpu_torch.golden import GoldenCluster as TGolden
from raft_tpu_torch.golden.model import (
    AppendEntriesRequest,
    GoldenNode,
    LogEntry,
    VoteRequest,
)
from raft_tpu_torch.transport import SingleDeviceTransport

ENTRY = 32


def inject_and_settle(cluster, payloads):
    """Queue payloads, then run the client tick and enough leader ticks
    for the reference's deferred replication to commit and for the
    followers to hear the advanced commit index."""
    cluster.start_client()
    for p in payloads:
        cluster.inject(p)
    cluster.run_until(cluster.now + 40.0)


def both(seed, payloads=(), **kw):
    """One seeded session on each oracle, traced: (JAX, port, lines of
    each, leaders)."""
    out = []
    for cls in (JGolden, TGolden):
        lines = []
        c = cls(3, seed=seed, trace=lines.append, **kw)
        lead = c.run_until_leader()
        if payloads:
            inject_and_settle(c, list(payloads))
        out.append((c, lead, lines))
    (jc, jlead, jl), (tc, tlead, tl) = out
    assert tl == jl, "nodelog lines"
    assert tlead.id == jlead.id and tlead.term == jlead.term
    for name, jn in jc.nodes.items():
        tn = tc.nodes[name]
        assert tn.committed_payloads() == jn.committed_payloads(), name
        assert (tn.term, tn.commit_index, tn.last_applied, tn.state) == \
            (jn.term, jn.commit_index, jn.last_applied, jn.state), name
    assert tc.now == jc.now
    return tc, tlead


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_elects_exactly_one_leader(seed):
    c, lead = both(seed)
    assert sum(n.state == "leader" for n in c.nodes.values()) == 1
    assert lead.term >= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commits_are_consistent_prefixes(seed):
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, ENTRY, dtype=np.uint8).tobytes()
                for _ in range(5)]
    c, lead = both(seed, payloads)
    assert lead.commit_index >= 5
    lead_c = lead.committed_payloads()
    assert lead_c[:5] == payloads
    for n, node in c.nodes.items():
        cp = node.committed_payloads()
        assert cp == lead_c[:len(cp)], n


def test_nodelog_format():
    c, lead = both(0)
    got = lead.nodelog("hello")
    assert got == (f"[{lead.id}:{lead.term}:{lead.commit_index}:"
                   f"{lead.last_applied}][leader]hello")


def test_reference_quirks_preserved():
    """The sticky ``voted`` bool (main.go:160,168) and the ``+1`` commit
    (main.go:151-154), as the JAX oracle keeps them."""
    n = GoldenNode("Server0")
    assert n.handle_request_vote(VoteRequest(1, "Server1")).vote
    assert not n.handle_request_vote(VoteRequest(2, "Server2")).vote
    n = GoldenNode("Server0")
    r = n.handle_append_entries(
        AppendEntriesRequest(1, "Server1", [LogEntry(1, b"x")], 99, 0, 0))
    assert r.success and n.commit_index == 2


def test_channel_backpressure_equals_jax():
    """A full LogReq channel blocks the client mid-send; every value
    arrives in order, in both oracles."""
    logs = []
    for cls in (JGolden, TGolden):
        c = cls(3, seed=0, channel_depth=2)
        lead = c.run_until_leader()
        vals = [bytes([i]) * ENTRY for i in range(1, 6)]
        for v in vals:
            c.inject(v)
        c._deliver_client()
        assert len(lead.logreq) == 2 and c._client_blocked is not None
        for _ in range(3):
            c._leader_tick(lead)
        assert c._client_blocked is None and not c.client_values
        logs.append([e.payload for e in lead.log])
    assert logs[1] == logs[0] and logs[1][-5:] == vals
    cfg = RaftConfig(n_replicas=3, entry_bytes=ENTRY, batch_size=4,
                     log_capacity=64, channel_depth=3, seed=7)
    c = TGolden.from_config(cfg)
    assert c.channel_depth == 3 and len(c.nodes) == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_path_commits_the_oracles_log(seed):
    """``TestDifferential``: the port's transport (on the CPU) replicates
    the same payloads under the oracle's leader; every replica's committed
    bytes equal both oracles' committed log."""
    rng = np.random.default_rng(seed)
    n_entries, B = 40, 8
    payloads = [rng.integers(0, 256, ENTRY, dtype=np.uint8).tobytes()
                for _ in range(n_entries)]
    c, lead = both(seed, payloads)
    golden = lead.committed_payloads()
    assert len(golden) >= n_entries
    cfg = RaftConfig(n_replicas=3, entry_bytes=ENTRY, batch_size=B,
                     log_capacity=128, transport="single")
    t = SingleDeviceTransport(cfg, device="cpu")
    state = t.init()
    alive, slow = np.ones(3, bool), np.zeros(3, bool)
    leader = int(lead.id.removeprefix("Server"))
    state, vi = t.request_votes(state, leader, 1, alive)
    assert int(vi.votes) == 3
    flat = np.frombuffer(b"".join(payloads), np.uint8).reshape(
        n_entries, ENTRY)
    for ofs in range(0, n_entries, B):
        chunk = flat[ofs:ofs + B]
        state, info = t.replicate(state, fold_batch(chunk, 3, B), len(chunk),
                                  leader, 1, alive, slow)
    assert int(info.commit_index) == n_entries
    want = np.frombuffer(b"".join(golden[:n_entries]), np.uint8).reshape(
        n_entries, ENTRY)
    for r in range(3):
        np.testing.assert_array_equal(committed_payloads(state, r), want,
                                      err_msg=f"replica {r}")
