"""``submit_pipelined``'s host gate and the lapped flight
(``pipeline_max_laps > 1``) through both engines: the six engine cases of
tests/test_steady_fused.py (``:549``, ``:614``, ``:657``, ``:704``,
``:763``, ``:798``) driven in lock step through
``tests/test_torch_engine.py``'s ``Pair`` at their shape (3 replicas,
8-byte entries, B = 128, C = 256), with both engines'
``_pipeline_backend_ok`` hooks patched where the JAX case patches its own,
and the JAX programs traced in Pallas interpret mode as that file's
autouse fixture runs them. Every flight the two engines launch is listed
with its length and ``allow_turnover``, and the lists must be equal; the
Pair's checks hold the leaves, lines, queues and committed bytes equal
after every call; then the JAX case's own assertions are applied to the
port's run. Where the JAX case swaps the transport's flight for a shim,
both engines get the same shim over their own ``replicate_many``."""

import numpy as np
import pytest
import torch

from tests._torch_port import pallas_interpret
from tests.test_torch_engine import Pair, committed_bytes

SHAPE = dict(entry_bytes=8, batch_size=128, log_capacity=256)
N, B, C = 3, SHAPE["batch_size"], SHAPE["log_capacity"]
T_RING = C // B


@pytest.fixture(autouse=True)
def _interpret():
    """tests/test_steady_fused.py's ``_force_interpret``: the JAX kernels
    at these shapes run in Pallas interpret mode."""
    with pallas_interpret():
        yield


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_traces():
    """The JAX programs here are traced in interpret mode; a test of
    another file in this worker must trace its own (and this file must
    not reuse another file's)."""
    import jax

    jax.clear_caches()
    yield
    jax.clear_caches()


def draws(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
            for _ in range(n)]


def open_gates(monkeypatch):
    import raft_tpu.raft.engine as jengine
    import raft_tpu_torch.raft.engine as tengine

    monkeypatch.setattr(jengine, "_pipeline_backend_ok", lambda: True)
    monkeypatch.setattr(tengine, "_pipeline_backend_ok", lambda *a: True)


def count_flights(monkeypatch, p):
    """Wrap both engines' flights: {"jax": [...], "port": [...]}, one
    (steps, allow_turnover) a launch."""
    calls = {"jax": [], "port": []}
    for name, e in (("jax", p.j), ("port", p.t)):
        orig = e.t.replicate_pipeline

        def counting(state, payloads, counts, *a, _o=orig, _c=calls[name],
                     **k):
            _c.append((int(counts.shape[0]), k.get("allow_turnover")))
            return _o(state, payloads, counts, *a, **k)

        monkeypatch.setattr(e.t, "replicate_pipeline", counting)
    return calls


def scan_shims(monkeypatch, p, all_slow=False):
    """Both transports' flights replaced by a scan of ticks without
    repair (``all_slow``: every follower silently drops the chunk, the
    worst gate/kernel desync), returning the last step's info."""
    import jax
    import jax.numpy as jnp

    calls = {"jax": [], "port": []}

    def jshim(state, payloads, counts, r, term, alive, slow, member=None,
              repair_floor=0, floor_prev_term=0, term_floor=1,
              allow_turnover=True):
        calls["jax"].append((int(counts.shape[0]), allow_turnover))
        if all_slow:
            slow = jnp.ones_like(jnp.asarray(slow), bool)
        st, infos = p.j.t.replicate_many(
            state, payloads, counts, r, term, alive, slow, repair=False,
            member=member, repair_floor=repair_floor,
            floor_prev_term=floor_prev_term, term_floor=term_floor)
        return st, jax.tree.map(lambda a: a[-1], infos)

    def tshim(state, payloads, counts, r, term, alive, slow, member=None,
              repair_floor=0, floor_prev_term=0, term_floor=1,
              allow_turnover=True):
        calls["port"].append((int(counts.shape[0]), allow_turnover))
        if all_slow:
            slow = torch.ones_like(slow, dtype=torch.bool)
        st, infos = p.t.t.replicate_many(
            state, payloads, counts, r, term, alive, slow, repair=False,
            member=member, repair_floor=repair_floor,
            floor_prev_term=floor_prev_term, term_floor=term_floor)
        return st, type(infos)(*(f[-1] for f in infos))

    monkeypatch.setattr(p.j.t, "replicate_pipeline", jshim)
    monkeypatch.setattr(p.t.t, "replicate_pipeline", tshim)
    return calls


def set_rows(p, **leaves):
    """Overwrite one row of state leaves in both engines:
    ``leaf=(row, value)``."""
    jst, tst = p.j.state, p.t.state
    jnew, tnew = {}, {}
    for f, (row, value) in leaves.items():
        jnew[f] = getattr(jst, f).at[row].set(value)
        t = getattr(tst, f).clone()
        t[row] = value
        tnew[f] = t
    p.j.state, p.t.state = jst.replace(**jnew), tst.replace(**tnew)


def set_steady(p, value=True):
    p.j._steady = p.t._steady = value


def read_ring(p):
    """The last ring of committed entries, through both engines."""
    wm = p.t.commit_watermark
    lo = max(1, wm - C + 1)
    got = [bytes(x) for x in p.t.committed_entries(lo, wm)]
    assert got == [bytes(x) for x in np.asarray(
        p.j.committed_entries(lo, wm))]
    return got


def eligible(p, *args):
    got = [bool(e._pipeline_eligible(*args)) for e in (p.j, p.t)]
    assert got[0] == got[1], f"gates disagree: {got}"
    return got[1]


def test_engine_pipeline_chunk_gate_and_bookkeeping(monkeypatch):
    """``:549``: full-ring chunks on a verified-steady cluster go through
    the transport's flight (a shim of scanned ticks here, in both
    engines) as one launch each, with contiguous seq bookkeeping, and
    commit the same bytes as engines that never take the fast path."""
    ps = draws(640 + 120, 21)

    def build(shimmed):
        p = Pair(6, **SHAPE)
        if shimmed:
            open_gates(monkeypatch)
            calls = scan_shims(monkeypatch, p)
        else:
            calls = {"jax": [], "port": []}
            for e in (p.j, p.t):
                monkeypatch.setattr(e.t, "replicate_pipeline", None)
        p.until_leader()
        warm = p.submit(ps[:128])
        p.until_committed(warm[-1])
        p.run_for(4 * p.t.cfg.heartbeat_period)
        seqs = p.both("submit_pipelined", ps[128:])
        p.until_committed(seqs[-1], limit=900.0)
        p.check_all()
        monkeypatch.undo()
        assert calls["port"] == calls["jax"]
        return p, calls["port"], read_ring(p)

    p1, calls, got1 = build(shimmed=True)
    assert calls == [(T_RING, True), (T_RING, True)], calls
    p2, _, got2 = build(shimmed=False)
    assert got1 == got2, "fast-path committed bytes diverged"
    assert p1.t.commit_watermark == p2.t.commit_watermark
    assert committed_bytes(p1) == committed_bytes(p2) == ps


def test_engine_pipeline_gate_negative_cases(monkeypatch):
    """``:614``: each leg of the gate refuses on its own, in both engines
    alike: the backend, a partial chunk, a misaligned tail, an unsteady
    cluster, an uncommitted backlog, a quorum shortfall, a higher term."""
    p = Pair(7, **SHAPE)
    r = p.until_leader()
    T = T_RING
    eff = p.t._reach(r)
    np.testing.assert_array_equal(eff, p.j._reach(r))
    set_steady(p)
    assert not eligible(p, r, T * B, T, 0, eff)
    open_gates(monkeypatch)
    assert eligible(p, r, T * B, T, 0, eff)
    assert not eligible(p, r, T * B - 4, T, 0, eff)
    assert not eligible(p, r, T * B, T, 8, eff)
    set_steady(p, False)
    assert not eligible(p, r, T * B, T, 0, eff)
    set_steady(p)
    p.j.commit_watermark = p.t.commit_watermark = 0
    assert not eligible(p, r, T * B, T, B, eff)
    only_leader = np.zeros(p.t.cfg.rows, bool)
    only_leader[r] = True
    assert not eligible(p, r, T * B, T, 0, only_leader)
    for e in (p.j, p.t):
        e.terms[(r + 1) % N] = e.leader_term + 1
    assert not eligible(p, r, T * B, T, 0, eff)
    p.check()


@pytest.mark.slow   # as its JAX case: a multi-lap composition variant
def test_engine_multi_lap_chunk(monkeypatch):
    """``:657``: with ``pipeline_max_laps=2`` a backlog of three ring
    turnovers rides a lapped launch of 2·T_ring steps (the real flights:
    JAX's in interpret mode, the port's plain K3/K4) and commits what
    the one-lap engine commits."""
    open_gates(monkeypatch)
    ps = draws(3 * C, 51)

    def run(max_laps):
        p = Pair(13, pipeline_max_laps=max_laps, **SHAPE)
        calls = count_flights(monkeypatch, p)
        p.until_leader()
        set_steady(p)                   # fresh cluster, all rows at 0
        seqs = p.both("submit_pipelined", ps)
        p.until_committed(seqs[-1], limit=900.0)
        p.check_all()
        assert calls["port"] == calls["jax"]
        return p, [n for n, _ in calls["port"]], read_ring(p)

    p1, calls1, got1 = run(max_laps=2)
    p2, calls2, got2 = run(max_laps=1)
    assert 2 * T_RING in calls1, f"no lapped launch happened: {calls1}"
    assert all(c == T_RING for c in calls2)
    assert len(calls1) < len(calls2), "laps did not reduce launch count"
    assert p1.t.commit_watermark == p2.t.commit_watermark == 3 * C
    assert got1 == got2 == ps[-C:]


def test_multi_lap_requires_all_rows_verified(monkeypatch):
    """``:704``: a quorum but not every row in the accept set: the
    lapped shape is refused, the one-ring launch runs, and both engines
    pass it ``allow_turnover=False``."""
    open_gates(monkeypatch)
    p = Pair(14, pipeline_max_laps=2, **SHAPE)
    calls = count_flights(monkeypatch, p)
    p.until_leader()
    set_steady(p)
    victim = (p.t.leader_id + 1) % N
    set_rows(p, match_index=(victim, 0), match_term=(victim, -1),
             last_index=(victim, 0))
    rng = np.random.default_rng(60)
    warm_ps = [rng.integers(0, 256, 8, np.uint8).tobytes() for _ in range(B)]
    warm = p.submit(warm_ps)
    p.until_committed(warm[-1])
    p.run_for(4 * p.t.cfg.heartbeat_period)
    p.both("set_slow", victim, True)
    p.both("set_slow", victim, False)
    set_rows(p, match_index=(victim, 0), match_term=(victim, -1))
    set_steady(p)
    calls["jax"].clear()
    calls["port"].clear()
    ps = [rng.integers(0, 256, 8, np.uint8).tobytes() for _ in range(2 * C)]
    tail = int(p.t.state.last_index[p.t.leader_id])
    seqs = p.both("submit_pipelined", ps)
    p.until_committed(seqs[-1], limit=900.0)
    # The one-ring K3 flight starts mid-ring (slot 128) and, in Pallas
    # interpret mode, JAX's leaves its first step's slots unwritten: the
    # JAX engine archives and applies zeros of term 0 at those indices
    # (ROADMAP §C). Its leaves are whole again after the next flight.
    gap = set(range(tail + 1, tail + B + 1))
    j, t = p.j, p.t
    assert {i for i in range(j.store.first, j.store.last + 1)
            if j.store.get(i) != t.store.get(i)} <= gap
    p.check_all(archive_except=gap)
    sent = warm_ps + ps
    for i in range(t.store.first, t.store.last + 1):
        assert t.store.get(i)[0] == sent[i - 1], f"archive {i}"
    assert committed_bytes(p) == sent
    assert calls["port"] == calls["jax"]
    assert calls["port"], "pipeline fast path never ran"
    assert calls["port"][0] == (T_RING, False), calls["port"]


def test_pipeline_gate_verifies_current_accept_set(monkeypatch):
    """``:763``: the gate verifies the rows it counts against the
    current device vectors, whatever ``_steady`` says."""
    p = Pair(8, **SHAPE)
    r = p.until_leader()
    T = T_RING
    open_gates(monkeypatch)
    seqs = p.submit([bytes([i % 256]) * 8 for i in range(B)])
    p.until_committed(seqs[-1])
    p.run_for(4 * p.t.cfg.heartbeat_period)
    eff = p.t._reach(r)
    set_steady(p)
    leader_last = int(p.t.state.last_index[r])
    assert p.t.commit_watermark == leader_last
    assert eligible(p, r, T * B, T, leader_last, eff)
    p.j.state = p.j.state.replace(
        match_index=p.j.state.match_index * 0)
    p.t.state = p.t.state.replace(
        match_index=torch.zeros_like(p.t.state.match_index))
    set_steady(p)
    assert not eligible(p, r, T * B, T, leader_last, eff)


def test_pipeline_shortfall_reconciles_device_log(monkeypatch):
    """``:798``: a flight that falls short of the gate (every follower
    drops the chunk) raises the shortfall error with the same text in
    both engines, truncates the orphaned suffix off every row, re-queues
    the bytes, and the regular tick path then commits each payload once."""
    open_gates(monkeypatch)
    p = Pair(9, **SHAPE)
    scan_shims(monkeypatch, p, all_slow=True)
    p.until_leader()
    rng = np.random.default_rng(33)
    ps = [rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
          for _ in range(C)]
    set_steady(p)
    name, msg = p.both_raise("submit_pipelined", ps)
    assert name == "RuntimeError" and "pipeline chunk shortfall" in msg
    assert int(p.t.state.last_index.max()) == 0
    assert len(p.t._queue) == len(ps)
    p.check_all()
    for e in (p.j, p.t):
        monkeypatch.setattr(e.t, "replicate_pipeline", None)
    hb = p.t.cfg.heartbeat_period
    for _ in range(200):
        if p.t.commit_watermark >= len(ps):
            break
        p.both("run_for", hb)
    assert p.t.commit_watermark == len(ps)
    p.check_all()
    assert [bytes(x) for x in p.t.committed_entries(1, len(ps))] == ps
    assert committed_bytes(p) == ps
