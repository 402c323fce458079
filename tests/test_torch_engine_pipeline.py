"""``submit_pipelined``'s single-launch flight through both engines: the
port's ``RaftEngine`` against the JAX engine with both engines' backend
hooks (``_pipeline_backend_ok``) patched true, at B = 128 and C = 1024.
A whole-ring chunk of a verified-steady cluster goes through
``replicate_pipeline`` — the JAX side's K3/K4 in Pallas interpret mode,
the port's plain versions — and the two engines must stay byte-identical
(the checks of ``tests/test_torch_engine.py``'s ``Pair``).

Its own file: tracing the JAX flight in interpret mode takes most of its
~8 s, and the other engine cases need not wait for it."""

from tests._torch_port import pallas_interpret
from tests.test_torch_engine import Pair, committed_bytes, payloads


def test_submit_pipelined_flight(monkeypatch):
    import raft_tpu.raft.engine as jengine
    import raft_tpu_torch.raft.engine as tengine

    monkeypatch.setattr(jengine, "_pipeline_backend_ok", lambda: True)
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)
    p = Pair(9, entry_bytes=8, batch_size=128, log_capacity=1024)
    flights = []
    orig = p.t.t.replicate_pipeline

    def counting(*a, **k):
        flights.append(int(a[2].shape[0]))
        return orig(*a, **k)

    monkeypatch.setattr(p.t.t, "replicate_pipeline", counting)
    p.until_leader()
    warm = p.submit(payloads(128, 10, entry=8))
    p.until_committed(warm[-1])
    p.run_for(4.0)            # verified steady at a block-aligned tail
    ps = payloads(1024, 11, entry=8)
    # the interpret flag is read when the JAX flight is traced
    with pallas_interpret():
        p.both("submit_pipelined", ps)
    p.check_all()
    p.run_for(4.0)
    p.check_all()
    assert flights == [8], flights
    assert committed_bytes(p) == payloads(128, 10, entry=8) + ps
