"""``raft_tpu_torch.raft.lease.LeaseTable`` (the port's copy, host-only)
against the JAX package's ``raft_tpu.raft.lease.LeaseTable``, and the
configuration rules of the read plane in both packages' ``RaftConfig``:
the same calls give the same answers, floats compared exactly."""

import pytest

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.raft.lease import LeaseTable as JLease
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.raft.lease import LeaseTable as TLease


def both(f0=10.0, drift=2.0):
    return JLease(f0, drift), TLease(f0, drift)


def same(tables, name, *args):
    got = [getattr(t, name)(*args) for t in tables]
    assert got[0] == got[1], (name, args, got)
    return got[1]


def test_grant_valid_expire():
    ts = both()
    for t in ts:
        t.grant(0, term=3, now=100.0)
    assert same(ts, "valid", 0, 3, 100.0)
    assert same(ts, "valid", 0, 3, 104.9)
    assert not same(ts, "valid", 0, 3, 105.0)          # strict boundary
    assert same(ts, "remaining_s", 0, 3, 102.0) == pytest.approx(3.0)
    assert same(ts, "summary", 0, 3, 101.0)["valid"]


def test_term_mismatch_and_break():
    ts = both()
    for t in ts:
        t.grant(0, 3, 0.0)
        t.grant(1, 1, 0.0)
    assert not same(ts, "valid", 0, 4, 0.1)
    for t in ts:
        t.break_(0)
    assert not same(ts, "valid", 0, 3, 0.1)
    assert same(ts, "valid", 1, 1, 0.1)
    for t in ts:
        t.break_()
    assert not same(ts, "valid", 1, 1, 0.1)
    assert ts[0].grants == ts[1].grants == 2


@pytest.mark.parametrize("rate", [0.5, 0.75, 1.0, 1.5, 2.0])
@pytest.mark.parametrize("ignore_drift", [False, True])
def test_skew_band_and_the_broken_plane(rate, ignore_drift):
    ts = both()
    for t in ts:
        t.ignore_drift = ignore_drift
        t.set_rate(0, rate)
        t.grant(0, 1, 0.0)
    assert same(ts, "rate", 0) == rate
    assert ts[0].effective_duration_s == ts[1].effective_duration_s
    for now in [0.0, 1.0, 2.5, 4.99, 5.0, 9.99, 10.0, 15.0, 19.99, 20.0]:
        same(ts, "valid", 0, 1, now)
        same(ts, "remaining_s", 0, 1, now)
        same(ts, "summary", 0, 1, now)
    if not ignore_drift:
        # the safety inequality: no serve at TRUE elapsed >= f0 for any
        # rate inside [1/drift, drift]
        assert not ts[1].valid(0, 1, 10.0)


def test_validation():
    for cls in (JLease, TLease):
        with pytest.raises(ValueError):
            cls(10.0, 0.5)
        with pytest.raises(ValueError):
            cls(0.0, 2.0)
        with pytest.raises(ValueError):
            cls(10.0, 2.0).set_rate(0, 0.0)


@pytest.mark.parametrize("cls", [JConfig, TConfig])
def test_config_rules(cls):
    with pytest.raises(ValueError, match="prevote"):
        cls(read_lease=True)
    with pytest.raises(ValueError, match="clock_drift_bound"):
        cls(clock_drift_bound=0.9)
    with pytest.raises(ValueError, match="session_max_lag"):
        cls(session_max_lag=0)
    with pytest.raises(ValueError, match="promote_max_lag"):
        cls(max_replicas=5, promote_max_lag=0)
    with pytest.raises(ValueError, match="max_replicas"):
        cls(n_replicas=5, max_replicas=3)
    cfg = cls(prevote=True, read_lease=True)
    assert cfg.session_lag == 2 * cfg.batch_size
    assert cls(session_max_lag=7).session_lag == 7
    assert cfg.lease_duration_s == \
        cfg.follower_timeout[0] / cfg.clock_drift_bound
    assert cls(n_replicas=3, max_replicas=5).rows == 5


def test_the_configs_agree():
    kw = dict(n_replicas=5, max_replicas=6, rs_k=3, rs_m=2, entry_bytes=264,
              prevote=True,
              read_lease=True, check_quorum=True, clock_drift_bound=1.5)
    j, t = JConfig(**kw), TConfig(**kw)
    for f in ("rows", "commit_quorum", "lease_duration_s", "session_lag",
              "shard_words"):
        assert getattr(j, f) == getattr(t, f), f
