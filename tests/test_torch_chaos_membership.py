"""The port's membership plane under chaos against the JAX package's
(``tests/test_torture.py:314``, ``:337``, ``:355`` and
``tests/test_read_scale.py:544``): the pinned membership seeds at
``phases=4``, the reconfiguration drill, the nemesis decision stream with
the plane on and off, and the read plane's pinned torture seed. Each run
equals JAX's field by field and op by op, and each pinned seed's
fingerprint equals the JAX package's plain run, which
``tests/_torture_fingerprints.py`` caches once a session."""

import pytest

from raft_tpu_torch.chaos import LINEARIZABLE, Nemesis
from tests._torch_chaos import assert_same, jax_run, port_run
from tests._torture_fingerprints import fingerprint, plain_membership_run

MEMBERSHIP_SEEDS = [11, 14, 22, 27]


@pytest.mark.parametrize("seed", MEMBERSHIP_SEEDS)
def test_membership_seed_matches_jax(seed):
    got, rep = port_run("torture_run", seed, phases=4, membership=True)
    assert fingerprint(rep) == plain_membership_run(seed)
    assert_same(got, jax_run("torture_run", seed, phases=4, membership=True))
    assert rep.verdict == LINEARIZABLE, rep.summary()


def test_membership_pins_cover_reconfig_vocabulary():
    ops, crashes = {}, 0
    for seed in MEMBERSHIP_SEEDS:
        rep = port_run("torture_run", seed, phases=4, membership=True)[1]
        crashes += rep.crashes
        for k, v in rep.membership_ops.items():
            ops[k] = ops.get(k, 0) + v
    for kind in ("grow", "shrink", "remove_leader", "replace"):
        assert ops.get(kind, 0) > 0, ops
    assert crashes > 0


def test_reconfig_drill_matches_jax():
    got, rep = port_run("reconfig_run", 0)
    assert_same(got, jax_run("reconfig_run", 0))
    assert rep.verdict == LINEARIZABLE and rep.availability_ok
    assert [ev["op"] for ev in rep.events] == [
        "grow", "grow", "shrink", "remove_leader", "wipe_replace"]
    assert rep.promote_s is not None and rep.replace_promote_s is not None
    assert rep.repro == "python -m raft_tpu_torch.chaos --reconfig --seed 0"


def test_nemesis_stream_equals_jax_with_the_plane_on_and_off():
    from raft_tpu.chaos import Nemesis as JNemesis

    def stream(cls, **kw):
        n = cls(7, 3, **kw)
        alive = {r: True for r in range(3)}
        return [n.next_action([0, 1, 2], alive, False, float(i)).describe()
                for i in range(50)]

    for kw in ({}, {"allow_membership": False}, {"allow_membership": True},
               {"allow_overload": True, "allow_clock": True}):
        assert stream(Nemesis, **kw) == stream(JNemesis, **kw)
    assert stream(Nemesis) == stream(Nemesis, allow_membership=True)


def test_reads_torture_pinned_seed_matches_jax():
    got, rep = port_run("torture_run", 5, phases=4, reads=True)
    assert_same(got, jax_run("torture_run", 5, phases=4, reads=True))
    assert rep.verdict == LINEARIZABLE, rep.summary()


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(12))
def test_membership_torture_sweep_matches_jax(seed):
    got, rep = port_run("torture_run", seed, phases=12, membership=True)
    assert_same(got, jax_run("torture_run", seed, phases=12,
                             membership=True))
    assert rep.verdict == LINEARIZABLE, rep.summary()


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(1, 4))
def test_reconfig_drill_sweep_matches_jax(seed):
    got, rep = port_run("reconfig_run", seed)
    assert_same(got, jax_run("reconfig_run", seed))
    assert rep.verdict == LINEARIZABLE and rep.availability_ok
