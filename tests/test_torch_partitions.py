"""tests/test_partitions.py through both engines: split brain (a minority
leader that ticks but cannot commit, the majority electing and
committing), an isolated minority that cannot elect, a divergent
uncommitted suffix truncated on heal, ``FaultPlan.split`` in the event
heap, and the four safety properties under seeded partition schedules.
Each schedule (``tests/_torch_faults.py``) runs on the JAX engine and on
the port's on the CPU, applying the JAX test's assertions to each; the
two runs must then agree on every nodelog line, the leaders by term,
terms and roles, the watermark, ``_ring_floor``, every row's committed
bytes (and the archive behind them) and every state leaf."""

import pytest

from tests import _torch_faults as F


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_traces_after():
    """A later file of this worker traces its own JAX programs."""
    yield
    import jax

    jax.clear_caches()


class TestSplitBrain:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_minority_leader_cannot_commit_majority_can(self, seed):
        e, obs, extra = F.hold(F.split_brain, seed)
        assert extra["new"] != extra["old"]
        assert obs["archive_checked"] > 0

    @pytest.mark.parametrize("seed", [0, 1])
    def test_isolated_minority_cannot_elect(self, seed):
        e, obs, extra = F.hold(F.isolated_minority, seed)
        assert e.terms[extra["loner"]] > extra["term_before"]

    def test_divergent_uncommitted_suffix_truncated_on_heal(self):
        e, obs, extra = F.hold(F.divergent_suffix)
        assert extra["healed"] and extra["stale_last"] == 6

    def test_fault_plan_split_schedules(self):
        e, obs, extra = F.hold(F.fault_plan_split)
        assert extra["seen"] == [True, False, True]
        assert any("partition healed" in ln for ln in obs["lines"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [3, 5])
def test_safety_properties_under_partition_schedule(seed, n):
    e, obs, extra = F.hold(F.partition_safety, seed, n)
    F.election_safe(e)
    assert obs["archive_checked"] > 0
