"""tests/test_lap_chaos.py ``test_pipelined_multi_lap_under_chaos``
through both engines: whole-ring and two-lap ``submit_pipelined`` flights
(``pipeline_max_laps=2``) between crashes, partitions and campaigns, with
both engines' flight hooks opened on the CPU: the JAX flights run its
K3/K4 in Pallas interpret mode, the port's its plain K3/K4. A gate/kernel
desync raises the shortfall ``RuntimeError`` and fails the case. The two
runs must launch the same flights and agree on every nodelog line, the
leaders by term, the watermark, ``_ring_floor``, every row's retained
committed bytes (each equal to the archive) and every state leaf.

Its own file: the JAX half traces the interpret-mode flights (~20 s)."""

import pytest

from tests import _torch_faults as F
from tests._torch_port import pallas_interpret


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_traces():
    """The JAX flights here are traced in interpret mode: trace them
    afresh, and leave none for a later file of this worker."""
    import jax

    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("seed", [
    3,
    # as the JAX case: one tier-1 seed, the sibling in the slow tier
    pytest.param(11, marks=pytest.mark.slow),
])
def test_pipelined_multi_lap_under_chaos(seed, monkeypatch):
    import raft_tpu.raft.engine as jengine
    import raft_tpu_torch.raft.engine as tengine

    monkeypatch.setattr(jengine, "_pipeline_backend_ok", lambda: True)
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)
    e, obs, flights = F.hold(F.run_pipelined_lap_chaos, seed,
                             contexts={"jax": pallas_interpret})
    assert e.commit_watermark > e.cfg.log_capacity
    assert obs["archive_checked"] > 0
    assert 2 * (e.cfg.log_capacity // e.cfg.batch_size) in flights
