"""The port's history and linearizability checker (``raft_tpu_torch.chaos``
``history`` / ``checker``) against the JAX package's: every case of
``tests/test_linearizability.py`` built through both packages' ``History``
and checked by both, plus seeded random histories over one to three keys
with every status and read class. Verdict, step count, key and detail must
be equal, so ``UNDETERMINED`` falls at the same budget."""

import random

import pytest

from raft_tpu.chaos import checker as jchk
from raft_tpu.chaos import history as jhist
from raft_tpu_torch.chaos import checker as tchk
from raft_tpu_torch.chaos import history as thist
from tests._torch_chaos import check_tuple, history_rows

W, R, D = thist.WRITE, thist.READ, thist.DELETE

#: tests/test_linearizability.py's histories, by name
CASES = {
    "read_your_writes": [
        (1, W, b"k", b"A", 0.0, 1.0, "ok"), (2, R, b"k", b"A", 2.0, 3.0, "ok"),
        (1, W, b"k", b"B", 4.0, 5.0, "ok"), (2, R, b"k", b"B", 6.0, 7.0, "ok")],
    "concurrent_read_either_side": [
        (1, W, b"k", b"A", 0.0, 10.0, "ok"), (2, R, b"k", None, 1.0, 2.0, "ok"),
        (3, R, b"k", b"A", 3.0, 4.0, "ok")],
    "info_write_applied": [
        (1, W, b"k", b"A", 0.0, 1.0, "ok"), (1, W, b"k", b"B", 2.0, None, "info"),
        (2, R, b"k", b"B", 3.0, 4.0, "ok")],
    "info_write_lost": [
        (1, W, b"k", b"A", 0.0, 1.0, "ok"), (1, W, b"k", b"B", 2.0, None, "info"),
        (2, R, b"k", b"A", 3.0, 4.0, "ok")],
    "failed_ops_constrain_nothing": [
        (1, W, b"k", b"A", 0.0, 1.0, "ok"), (2, W, b"k", b"Z", 2.0, 3.0, "fail"),
        (3, R, b"k", b"A", 4.0, 5.0, "ok")],
    "delete_reads_absent": [
        (1, W, b"k", b"A", 0.0, 1.0, "ok"), (1, D, b"k", None, 2.0, 3.0, "ok"),
        (2, R, b"k", None, 4.0, 5.0, "ok")],
    "stale_read": [
        (1, W, b"k", b"A", 0.0, 1.0, "ok"), (1, W, b"k", b"B", 2.0, 3.0, "ok"),
        (2, R, b"k", b"A", 4.0, 5.0, "ok")],
    "never_written_value": [
        (1, W, b"k", b"A", 0.0, 1.0, "ok"),
        (2, R, b"k", b"GHOST", 2.0, 3.0, "ok")],
    "flip_flop_over_lost_write": [
        (1, W, b"k", b"A", 0.0, 1.0, "ok"), (1, W, b"k", b"B", 2.0, None, "info"),
        (2, R, b"k", b"B", 3.0, 3.5, "ok"), (2, R, b"k", b"A", 4.0, 5.0, "ok")],
    "one_bad_key": [
        (1, W, b"good", b"A", 0.0, 1.0, "ok"),
        (2, R, b"good", b"A", 2.0, 3.0, "ok"),
        (1, W, b"bad", b"X", 4.0, 5.0, "ok"),
        (2, R, b"bad", b"Y", 6.0, 7.0, "ok")],
    "two_keys_interleaved": [
        (1, W, b"a", b"A1", 0.0, 1.0, "ok"), (2, W, b"b", b"B1", 0.5, 1.5, "ok"),
        (1, R, b"b", b"B1", 2.0, 3.0, "ok"), (2, R, b"a", b"A1", 2.5, 3.5, "ok"),
        (1, W, b"a", b"A2", 4.0, 5.0, "ok"), (2, R, b"a", b"A2", 6.0, 7.0, "ok")],
    "cross_key_deletes_info": [
        (1, W, b"a", b"A1", 0.0, 4.0, "ok"), (2, W, b"b", b"B1", 0.0, 4.0, "ok"),
        (3, R, b"a", None, 1.0, 2.0, "ok"), (3, D, b"b", None, 5.0, 6.0, "ok"),
        (1, W, b"b", b"B2", 7.0, None, "info"),
        (3, R, b"b", b"B2", 8.0, 9.0, "ok")],
    "stale_on_one_key": [
        (1, W, b"a", b"A1", 0.0, 1.0, "ok"), (1, W, b"a", b"A2", 2.0, 3.0, "ok"),
        (2, R, b"a", b"A1", 4.0, 5.0, "ok"), (2, R, b"b", None, 4.5, 5.5, "ok")],
    "cross_read_pair": [
        (1, W, b"a", b"A1", 0.0, 1.0, "ok"), (2, R, b"a", b"A1", 2.0, 3.0, "ok"),
        (1, W, b"a", b"A2", 2.0, None, "info"),
        (2, R, b"a", b"A2", 4.0, 5.0, "ok"), (2, R, b"a", b"A1", 6.0, 7.0, "ok")],
    "wide": ([(i, W, b"k", f"v{i}".encode(), 0.0, 100.0, "ok")
              for i in range(8)] + [(9, R, b"k", b"v3", 101.0, 102.0, "ok")]),
}


def build(mod, events, extra=None):
    """``events`` through ``mod``'s History (the JAX test's ``H``);
    ``extra[i]`` sets attributes on op i (read classes)."""
    h = mod.History()
    for i, (client, op, key, value, inv, comp, status) in enumerate(events):
        rec = h.invoke(client, op, key, value, inv)
        for k, v in (extra or {}).get(i, {}).items():
            setattr(rec, k, v)
        if status == "ok":
            rec.ok(comp, value)
        elif status == "fail":
            rec.fail(comp)
        elif status == "info":
            rec.info()
    h.close()
    return h


def both(events, extra=None):
    return build(jhist, events, extra), build(thist, events, extra)


@pytest.mark.parametrize("name", sorted(CASES))
def test_handwritten_histories_match_jax(name):
    jh, th = both(CASES[name])
    assert history_rows(th) == history_rows(jh)
    assert th.counts() == jh.counts()
    assert list(th.per_key()) == list(jh.per_key())
    for kw in ({}, {"per_key": False}, {"step_budget": 2},
               {"step_budget": 7, "per_key": False}):
        want = check_tuple(jchk.check_history(jh, **kw))
        got = check_tuple(tchk.check_history(th, **kw))
        assert got == want, kw
    assert check_tuple(tchk.check_history(th)) \
        == check_tuple(jchk.check_history(jh))


def test_budget_and_pending_refusal_match_jax():
    jh, th = both(CASES["wide"])
    j = jchk.check_history(jh, step_budget=2)
    t = tchk.check_history(th, step_budget=2)
    assert t.verdict == tchk.UNDETERMINED and not t
    assert check_tuple(t) == check_tuple(j)
    errors = []
    for mod, chk in ((jhist, jchk), (thist, tchk)):
        h = mod.History()
        h.invoke(1, W, b"k", b"A", 0.0)
        with pytest.raises(ValueError) as ex:
            chk.check_history(h)
        errors.append(str(ex.value))
    assert errors[0] == errors[1] and "PENDING" in errors[1]


def random_events(rng, n_ops, keys):
    """A seeded history: overlapping intervals, unique written values,
    reads that return a written value, the empty value or a ghost."""
    events, written = [], [None]
    t = 0.0
    for i in range(n_ops):
        t += rng.choice([0.0, 0.25, 0.5, 1.0])
        key = rng.choice(keys)
        roll = rng.random()
        if roll < 0.45:
            op, value = W, f"v{i}".encode()
            written.append(value)
        elif roll < 0.52:
            op, value = D, None
        else:
            op = R
            value = rng.choice(written + [b"ghost"] * (rng.random() < 0.05))
        status = rng.choices(["ok", "fail", "info"], [0.8, 0.1, 0.1])[0]
        comp = None if status == "info" else t + rng.choice([0.1, 0.5, 2.0])
        events.append((rng.randrange(4), op, key, value, t, comp, status))
    return events


def random_classes(rng, events):
    extra = {}
    for i, ev in enumerate(events):
        if ev[1] == R:
            cls = rng.choice(["lease", "read_index", "session", None])
            extra[i] = {"read_class": cls}
            if cls == "session":
                extra[i].update(ryw_floor=rng.randrange(4),
                                serve_index=rng.randrange(8))
    return extra


@pytest.mark.parametrize("seed", range(24))
def test_seeded_random_histories_match_jax(seed):
    rng = random.Random(f"torch-chaos-checker:{seed}")
    keys = [f"k{i}".encode() for i in range(rng.randint(1, 3))]
    events = random_events(rng, rng.randint(4, 14), keys)
    extra = random_classes(rng, events)
    jh, th = both(events, extra)
    assert history_rows(th) == history_rows(jh)
    for kw in ({}, {"per_key": False}, {"step_budget": 6}):
        assert check_tuple(tchk.check_history(th, **kw)) \
            == check_tuple(jchk.check_history(jh, **kw)), kw
    want = {c: check_tuple(r)
            for c, r in jchk.check_read_classes(jh).items()}
    got = {c: check_tuple(r)
           for c, r in tchk.check_read_classes(th).items()}
    assert got == want
