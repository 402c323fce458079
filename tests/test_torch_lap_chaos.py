"""tests/test_lap_chaos.py's ring-lap chaos through both engines: a
32-slot ring lapped again and again under crashes, partitions, storms
and membership changes (seeds 22 and 25 reproduced a minority leader's
wrapped ring serving junk as committed data, the fault ``_ring_floor``
fixes), and RS(5,3) at the same capacity through the full-ring §5.4.2
escape (``_make_room_for_current_term``) and the abandoned unrecoverable
suffix. Each schedule (``tests/_torch_faults.py``) runs on the JAX engine
and on the port's on the CPU; the two runs must agree on every nodelog
line, the leaders by term, terms, roles, the watermark, ``_ring_floor``,
every row's retained committed bytes and every state leaf, and every
retained committed byte must equal the archive
(``_ring_matches_archive``). The pipelined multi-lap case is
tests/test_torch_lap_chaos_pipelined.py."""

import pytest

from tests import _torch_faults as F


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_traces_after():
    """A later file of this worker traces its own JAX programs."""
    yield
    import jax

    jax.clear_caches()


# 22/25 are the pre-fix divergence reproducers
@pytest.mark.parametrize("seed", [0, 5, 22, 25])
def test_ring_bytes_match_archive_after_lap_chaos(seed):
    e, obs, _ = F.hold(F.run_lap_chaos, seed)
    assert e.commit_watermark > F.LAP_CAP, \
        "ring never lapped — schedule too light"
    assert obs["archive_checked"] > 0


# 12/14/23/29 reproduced the bounded-log §5.4.2 deadlock
@pytest.mark.parametrize("seed", [12, 14, 23, 29])
def test_ec_full_ring_old_term_deadlock_escapes(seed):
    e, obs, extra = F.hold(F.run_ec_lap_chaos, seed)
    assert e.commit_watermark > F.LAP_CAP
    assert extra["read"]
