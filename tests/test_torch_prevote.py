"""tests/test_prevote.py through both engines: PreVote keeps an isolated
follower's term frozen and makes the heal a non-event (and without it
the term inflates), stickiness suppresses a forced campaign, a real
leader loss still elects, CheckQuorum demotes a minority leader (whose
linearizable read is refused with the same text), and a storm of kills,
partitions and campaigns with both flags on. Each schedule
(``tests/_torch_faults.py``) runs on the JAX engine and on the port's on
the CPU under the JAX test's assertions; the two runs must agree on
every nodelog line, the leaders by term, terms, roles, the watermark,
``_ring_floor``, the committed bytes and every state leaf."""

import pytest

from tests import _torch_faults as F


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_traces_after():
    """A later file of this worker traces its own JAX programs."""
    yield
    import jax

    jax.clear_caches()


def test_partitioned_node_term_frozen_and_heal_no_depose():
    e, obs, extra = F.hold(F.pv_isolate, True)
    assert extra["isolated"] == extra["term0"] == e.leader_term


def test_without_prevote_partition_inflates_terms():
    e, obs, extra = F.hold(F.pv_isolate, False)
    assert extra["isolated"] > extra["term0"]


def test_force_campaign_suppressed_by_stickiness():
    e, obs, extra = F.hold(F.pv_stickiness)
    assert e.leader_term == extra["term0"]


def test_prevote_still_elects_on_real_leader_loss():
    e, obs, extra = F.hold(F.pv_leader_loss)
    assert extra["new"] != extra["lead"] and e.leader_id == extra["new"]


def test_check_quorum_minority_leader_steps_down():
    e, obs, extra = F.hold(F.pv_check_quorum)
    assert extra["refusal"][0] == "LinearizableReadRefused"
    assert e.roles[extra["lead"]] == "follower"


def test_chaos_mix_with_flags_on():
    e, obs, extra = F.hold(F.pv_chaos_mix)
    assert extra["done"] >= 24 and e.commit_watermark >= extra["done"]
    assert int(e.terms.max()) <= 2 + 12
