"""Replica rows across processes (``raft_tpu_torch.transport.multihost``)
and the mirrored engine's guard, against the JAX package.

- the placement rules (tests/test_multihost.py ``TestPlacement``) through
  both packages' ``replica_devices_across_hosts`` on the same fake
  fabrics;
- ``make_transport`` routing ``"multihost"``: a ``MeshTransport`` inside a
  group of ``rows`` ranks, the loud fallback outside one;
- the port's counterparts of tests/test_multihost.py ``TestEndToEnd`` and
  of tests/test_multiprocess.py's full engine (:233), its kernel-eligible
  shape with the pipelined flight (:321) and its forced desync (:510),
  each on spawned gloo ranks on the CPU (one process a replica row: the
  JAX tests put three rows on two processes, the port's mesh holds one row
  a rank);
- the bounded digest exchange of tests/test_torture.py (:249, :280): a
  stalled exchange fail-stops with "did not complete" within the bound, an
  exchange error with its cause, in both engines with the same message.
"""

import dataclasses
import logging
import time

import numpy as np
import pytest

from raft_tpu.transport import replica_devices_across_hosts as j_place
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.transport import SingleDeviceTransport
from raft_tpu_torch.transport import replica_devices_across_hosts as t_place
from raft_tpu_torch.transport.launch import run_ranks
from tests import _mesh_ranks as mr

ENTRY = 16


@dataclasses.dataclass(frozen=True)
class FakeDev:
    id: int
    process_index: int


def fabric(n_procs, per_proc):
    return [FakeDev(p * 100 + i, p) for p in range(n_procs)
            for i in range(per_proc)]


def both(*args):
    """Both packages' placement of the same fabric: equal, returned once."""
    got, want = t_place(*args), j_place(*args)
    assert got == want
    return got


def both_raise(*args):
    with pytest.raises(ValueError) as te:
        t_place(*args)
    with pytest.raises(ValueError):
        j_place(*args)
    return str(te.value)


class TestPlacement:
    def test_one_replica_per_process(self):
        got = both(3, 1, fabric(3, 4))
        assert [d.process_index for d in got] == [0, 1, 2]

    def test_payload_shards_stay_on_one_host(self):
        got = both(3, 2, fabric(3, 4))
        assert [d.process_index for d in got] == [0, 0, 1, 1, 2, 2]

    def test_round_robin_when_fewer_processes(self):
        got = both(3, 1, fabric(2, 4))
        assert [d.process_index for d in got] == [0, 1, 0]
        assert len({d.id for d in got}) == 3

    def test_five_replicas_five_hosts(self):
        got = both(5, 4, fabric(5, 8))
        assert [d.process_index for d in got[::4]] == [0, 1, 2, 3, 4]
        assert len({d.id for d in got}) == 20

    def test_single_process_flat(self):
        assert len(both(3, 2, fabric(1, 8))) == 6

    def test_rejects_insufficient_single_process(self):
        both_raise(3, 4, fabric(1, 8))

    def test_rejects_shards_spanning_processes(self):
        both_raise(4, 2, fabric(2, 3))

    def test_uneven_fabric_places_where_round_robin_would_fail(self):
        devs = [FakeDev(i, 0) for i in range(2)] + [
            FakeDev(100 + i, 1) for i in range(6)]
        got = both(3, 2, devs)
        blocks = [got[i:i + 2] for i in range(0, 6, 2)]
        for b in blocks:
            assert len({d.process_index for d in b}) == 1
        assert len({d.id for d in got}) == 6
        assert {b[0].process_index for b in blocks} == {0, 1}


KW = dict(n_replicas=3, entry_bytes=ENTRY, batch_size=4, log_capacity=64)


def test_make_transport_routes_multihost(caplog):
    """Inside a group of ``rows`` ranks ``"multihost"`` is the mesh, each
    rank its own row; outside one the fallback to the resident layout
    warns, naming the cause."""
    from raft_tpu_torch.transport import make_transport

    got = run_ranks(mr.multihost_kind, 3, (KW,), timeout=120)
    assert got == [("MeshTransport", 0)] * 3
    # the records are read from the module's own logger, so a change to
    # the logging tree left by another file in the process cannot hide
    # them
    with caplog.at_level(logging.WARNING,
                         logger="raft_tpu_torch.transport.base"):
        log = logging.getLogger("raft_tpu_torch.transport.base")
        log.addHandler(caplog.handler)
        try:
            t = make_transport(TConfig(**KW, transport="multihost"),
                               device="cpu")
        finally:
            log.removeHandler(caplog.handler)
    assert isinstance(t, SingleDeviceTransport)
    assert any("multihost placement unavailable" in r.getMessage()
               and "single process has 1" in r.getMessage()
               for r in caplog.records)


class TestEndToEnd:
    def test_multihost_transport_runs_cluster(self):
        assert run_ranks(mr.multihost_cluster, 3, timeout=120) == [True] * 3


def test_three_process_full_engine():
    """tests/test_multiprocess.py:233 on three ranks: the same leadership
    change and rejoin on every rank, byte-identical committed logs, the
    digest exchanged with no desync."""
    outs = run_ranks(mr.full_engine, 3, timeout=300)
    for rank, out in enumerate(outs):
        assert out["ok"] and out["changed"] and out["covers"], rank
        assert out["exchanges"] > 0 and out["fetches"] > 0
    assert len({o["mark"] for o in outs}) == 1
    assert outs[0]["mark"][0] == 12


def test_three_process_full_engine_fused_kernels():
    """tests/test_multiprocess.py:321: the kernel-eligible shape, every
    tick through the mesh step, a whole-ring ``submit_pipelined`` through
    the mesh flight, then a leadership change and catch-up; every rank
    ends with the same bytes."""
    outs = run_ranks(mr.kernel_engine, 3, timeout=480)
    for rank, out in enumerate(outs):
        assert out["ok"], rank
        assert out["tick"] is not None, "tick path did not reach the mesh"
        assert out["flight"] == "pipeline", out["flight"]
    assert len({o["mark"] for o in outs}) == 1
    assert outs[0]["mark"][0] == 568


def test_three_process_desync_fail_stop():
    """tests/test_multiprocess.py:510: a forced divergence on rank 1 is a
    MirrorDesyncError on every rank, naming every rank's digest, within
    the ranks' deadline (no hang)."""
    outs = run_ranks(mr.desync, 3, timeout=120)
    for rank, out in enumerate(outs):
        assert out["synced"] == 8, rank
        assert out["caught"] is not None, f"rank {rank} never detected it"
        assert "per-process digests" in out["caught"]
    digests = {o["caught"].split("per-process digests ")[1].split(" (")[0]
               for o in outs}
    assert len(digests) == 1   # every rank names the same digests


def _engines(timeout_s):
    from raft_tpu.config import RaftConfig as JConfig
    from raft_tpu.raft.engine import RaftEngine as JEngine
    from raft_tpu.transport.device import SingleDeviceTransport as JS
    from raft_tpu_torch.raft.engine import RaftEngine as TEngine

    kw = dict(KW, transport="single", mirror_check_every=1,
              mirror_exchange_timeout_s=timeout_s)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    tt = SingleDeviceTransport(tcfg, device="cpu")
    return JEngine(jcfg, JS(jcfg)), TEngine(tcfg, tt), tt


def _raised(engine):
    from raft_tpu.raft.engine import MirrorDesyncError as JErr
    from raft_tpu_torch.raft.engine import MirrorDesyncError as TErr

    t0 = time.monotonic()
    with pytest.raises((JErr, TErr)) as ex:
        engine.step_event()
    return type(ex.value).__name__, str(ex.value), time.monotonic() - t0


def test_mirror_digest_exchange_timeout_fail_stops(monkeypatch):
    """tests/test_torture.py:249: a stalled peer turns the exchange into
    MirrorDesyncError within the bound, not an indefinite wait."""
    import jax
    from jax.experimental import multihost_utils

    je, te, tt = _engines(0.2)

    def _stall(x):
        time.sleep(60.0)

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", _stall)
    monkeypatch.setattr(tt, "processes", 2)
    monkeypatch.setattr(tt, "exchange_digest", _stall)
    jgot, tgot = _raised(je), _raised(te)
    assert tgot[:2] == jgot[:2]
    assert "did not complete" in tgot[1]
    assert tgot[2] < 5.0, "bound was not enforced"


def test_mirror_digest_exchange_error_fail_stops(monkeypatch):
    """tests/test_torture.py:280: an error inside the exchange is the
    same fail-stop, with its cause."""
    import jax
    from jax.experimental import multihost_utils

    je, te, tt = _engines(5.0)

    def _boom(x):
        raise OSError("fabric gone")

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", _boom)
    monkeypatch.setattr(tt, "processes", 2)
    monkeypatch.setattr(tt, "exchange_digest", _boom)
    jgot, tgot = _raised(je), _raised(te)
    assert tgot[:2] == jgot[:2]
    assert "fabric gone" in tgot[1]
    assert np.isfinite(tgot[2])
