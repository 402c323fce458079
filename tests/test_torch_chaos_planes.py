"""The port's observability planes under chaos (the chaos cases of
``tests/test_compile_plane.py:224``, ``:242``, ``tests/test_memory_plane.py
:111``, ``tests/test_device_obs.py:347``, ``tests/test_tiered.py:480`` and
``tests/test_fused_ticks.py:480``): a plane attached, the tiered archive
armed or K-tick fusion on, the pinned membership seeds replay the JAX
package's plain fingerprint (``tests/_torture_fingerprints.py``), and the
crash-cycle runs of the compile and memory planes equal JAX's runs and
keep their verdicts: no sentinel violation, a flat census."""

import pytest

from raft_tpu_torch.chaos import LINEARIZABLE
from tests._torch_chaos import assert_same, env, jax_run, port_run
from tests._torture_fingerprints import fingerprint, plain_membership_run


def membership(seed, **kw):
    return port_run("torture_run", seed, phases=4, membership=True, **kw)[1]


@pytest.mark.parametrize("seed", [11, 22])
def test_compile_plane_on_replays_jax_plain_run(seed):
    rep = membership(seed, observe_compile=True)
    assert fingerprint(rep) == plain_membership_run(seed)
    assert rep.obs.compile.sentinel.frozen


def test_crash_restore_run_zero_violations_and_stats():
    got, rep = port_run("torture_run", 17, phases=6, observe_compile=True)
    assert_same(got, jax_run("torture_run", 17, phases=6,
                             observe_compile=True))
    assert rep.check.verdict == LINEARIZABLE and rep.crashes >= 1
    w = rep.obs.compile
    assert w.sentinel.frozen and w.sentinel.violations == []
    assert w.by_program()["single.replicate"]["launches"] > 0
    assert w.snapshot()["sentinel"]["violations"] == []


def test_chaos_crash_restore_census_flat():
    got, rep = port_run("torture_run", 18, phases=6, observe_compile=True)
    assert_same(got, jax_run("torture_run", 18, phases=6,
                             observe_compile=True))
    assert rep.check.verdict == LINEARIZABLE and rep.crashes >= 1
    assert rep.obs.memory.final_drift == []
    assert rep.obs.memory.baseline is not None


@pytest.mark.parametrize("seed", [11, 14, 22, 27])
def test_device_recording_replays_jax_plain_run(seed):
    rep = membership(seed, observe_device=True)
    assert fingerprint(rep) == plain_membership_run(seed)
    assert rep.obs.device is not None


@pytest.mark.parametrize("seed", [11, 22])
def test_tiered_archive_replays_jax_plain_run(seed, tmp_path):
    with env(RAFT_TPU_TIERED_DIR=str(tmp_path)):
        rep = membership(seed)
    assert fingerprint(rep) == plain_membership_run(seed)
    assert any(p.name.startswith("tier_") for p in tmp_path.iterdir())


def test_fused_chaos_seeds_replay_jax_plain_runs(monkeypatch):
    """K = 4 on seeds 11 and 27, and the windows really fuse."""
    import raft_tpu_torch.raft.steady as steady

    fired = {"n": 0}
    orig = steady.FusedDriver.fire

    def spy(self, r, horizon):
        out = orig(self, r, horizon)
        fired["n"] += bool(out)
        return out

    monkeypatch.setattr(steady.FusedDriver, "fire", spy)
    for seed in (11, 27):
        with env(RAFT_TPU_FUSE_K="4"):
            rep = membership(seed)
        assert fingerprint(rep) == plain_membership_run(seed)
    assert fired["n"] > 0, "no torture window ever fused"
