"""``submit_pipelined``'s single-launch flight on an erasure-coded cluster
(RS(5,3), 24-byte entries, B = 128, C = 512) through the port's engine
against the JAX engine, with both engines' backend hooks
(``_pipeline_backend_ok``) patched true, as
``tests/test_torch_engine_pipeline.py`` does for the plain cluster: the
JAX side's flight in Pallas interpret mode, the port's plain versions of
K7 and the flight. Its own file: tracing the JAX flight takes most of its
~15 s."""

import numpy as np

import raft_tpu.raft.engine as jengine
import raft_tpu_torch.raft.engine as tengine
from raft_tpu_torch.ec.reconstruct import reconstruct
from raft_tpu_torch.ec.rs import RSCode
from tests._torch_port import pallas_interpret
from tests.test_torch_engine import Pair, committed_bytes, payloads


def test_submit_pipelined_flight_ec(monkeypatch):
    """The same flight on an erasure-coded cluster (RS(5,3), 24-byte
    entries): the chunk is encoded by K7's plain version into the folded
    shard layout and flown at the EC quorum of 4; every shard row equals
    the JAX engine's, and any 3 rows decode the input."""
    monkeypatch.setattr(jengine, "_pipeline_backend_ok", lambda: True)
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)
    p = Pair(10, n_replicas=5, entry_bytes=24, batch_size=128,
             log_capacity=512, rs_k=3, rs_m=2)
    flights = []
    orig = p.t.t.replicate_pipeline

    def counting(*a, **k):
        flights.append(int(a[2].shape[0]))
        return orig(*a, **k)

    monkeypatch.setattr(p.t.t, "replicate_pipeline", counting)
    p.until_leader()
    warm = p.submit(payloads(128, 12, entry=24))
    p.until_committed(warm[-1])
    p.run_for(4.0)
    ps = payloads(512, 13, entry=24)
    with pallas_interpret():
        p.both("submit_pipelined", ps)
    p.check_all()
    assert flights == [4], flights
    everything = payloads(128, 12, entry=24) + ps
    assert committed_bytes(p) == everything
    lo = len(everything) - 512 + 1
    np.testing.assert_array_equal(
        reconstruct(p.t.state, RSCode(5, 3), (1, 3, 4), lo, len(everything)),
        np.frombuffer(b"".join(everything[lo - 1:]), np.uint8).reshape(
            512, 24))
