"""The port's online audit, forensics and black-box journal under chaos
against the JAX package's (the chaos cases of ``tests/test_audit.py:128``,
``:150``, ``:166``, ``:196``, ``tests/test_obs_forensics.py:31``, ``:54``,
``:74``, ``:85`` and ``tests/test_perf_obs.py:256``): the auditor flags
the broken variants online with JAX's violations, a healthy run audits
clean with the auditor's digest equal to the report's, every op closes
one span, a rejected seed's bundle reads the same through either
package's ``--explain``, and a crash-cycle run's journal holds JAX's
marks in JAX's order."""

import json

import pytest

from raft_tpu_torch.chaos import LINEARIZABLE, VIOLATION
from raft_tpu_torch.obs.forensics import explain, load_bundle
from tests._torch_chaos import assert_same, jax_run, port_run, run_traced
from tests._torture_fingerprints import fingerprint, plain_membership_run


def audited(package, seed, **kw):
    """(trace, auditor facts) of one audited run."""
    got, rep = run_traced(package, "torture_run", seed, audit=True,
                          **({"device": "cpu"} if package != "raft_tpu"
                             else {}), **kw)
    aud = rep.obs.audit
    facts = (aud.total_violations, dict(aud.by_invariant),
             [(v.invariant, v.t_virtual, v.group, v.node, v.detail)
              for v in aud.violations], aud.commit_digest())
    return got, facts, rep


@pytest.mark.parametrize("broken", ["dirty_reads", "commit_rewind"])
def test_broken_variants_trip_the_auditor_as_in_jax(broken):
    got, facts, rep = audited("raft_tpu_torch", 0, phases=6, keys=2,
                              broken=broken)
    want, jfacts, _ = audited("raft_tpu", 0, phases=6, keys=2,
                              broken=broken)
    assert_same(got, want)
    assert facts == jfacts
    aud = rep.obs.audit
    assert aud.total_violations > 0 and aud.violations[0].t_virtual > 0.0
    if broken == "dirty_reads":
        assert set(aud.by_invariant) & {"read_uncommitted", "read_monotone"}
        assert rep.obs.recorder.events(kind="audit_violation")
        assert rep.verdict != LINEARIZABLE
    else:
        assert aud.by_invariant.get("commit_monotone", 0) > 0
        c = rep.obs.registry.get("raft_audit_violations_total")
        assert c is not None and c.value(invariant="commit_monotone") > 0


def test_legit_run_audits_clean_and_digest_crosscheck():
    got, facts, rep = audited("raft_tpu_torch", 3, phases=6, keys=2)
    want, jfacts, _ = audited("raft_tpu", 3, phases=6, keys=2)
    assert_same(got, want)
    assert facts == jfacts
    aud = rep.obs.audit
    assert rep.verdict == LINEARIZABLE and aud.total_violations == 0
    assert aud.commit_digest() == rep.commit_digest
    assert aud.max_entries == 2 * 128
    dig = rep.obs.slo.digests.get(("commit", None))
    assert dig is not None and dig.n > 0


@pytest.mark.parametrize("seed", [11, 22])
def test_audit_plane_replays_jax_plain_run(seed):
    rep = port_run("torture_run", seed, phases=4, membership=True,
                   audit=True)[1]
    assert fingerprint(rep) == plain_membership_run(seed)
    assert rep.obs.audit.total_violations == 0


@pytest.mark.parametrize("seed", [11, 14, 22, 27])
def test_flight_recorder_replays_jax_plain_run(seed):
    rep = port_run("torture_run", seed, phases=4, membership=True,
                   observe=True)[1]
    assert fingerprint(rep) == plain_membership_run(seed)
    assert len(rep.obs.recorder) > 0


@pytest.mark.parametrize("seed,kw", [(9, {"overload": True}),
                                     (11, {"membership": True})])
def test_span_completeness_under_crash_and_shed(seed, kw):
    got, rep = port_run("torture_run", seed, phases=5, observe=True, **kw)
    assert_same(got, jax_run("torture_run", seed, phases=5, observe=True,
                             **kw))
    spans = rep.obs.spans
    assert len(spans.spans) == rep.ops and spans.open_spans() == []
    states = spans.by_state()
    assert set(states) <= {"ok", "failed", "shed", "info"}
    assert states.get("ok", 0) > 0
    if rep.shed_ops:
        assert states.get("shed", 0) > 0


def test_span_completeness_multi_router_redials():
    got, rep = port_run("torture_run_multi", 0, n_groups=4, phases=5,
                        observe=True)
    assert_same(got, jax_run("torture_run_multi", 0, n_groups=4, phases=5,
                             observe=True))
    spans = rep.obs.spans
    assert len(spans.spans) == rep.ops and spans.open_spans() == []
    assert rep.verdict == LINEARIZABLE


def test_rejected_seed_bundle_reads_the_same_through_both_clis(tmp_path):
    from raft_tpu.obs.forensics import explain as jexplain
    from raft_tpu.obs.forensics import load_bundle as jload

    kw = dict(phases=8, keys=2, broken="dirty_reads", observe=True)
    got, rep = run_traced("raft_tpu_torch", "torture_run", 0, device="cpu",
                          bundle_dir=str(tmp_path / "port"), **kw)
    want, jrep = run_traced("raft_tpu", "torture_run", 0,
                            bundle_dir=str(tmp_path / "jax"), **kw)
    assert_same(got, want)
    assert rep.verdict == VIOLATION and rep.bundle_path is not None
    bundle, jbundle = load_bundle(rep.bundle_path), jload(jrep.bundle_path)
    for key in ("kind", "seed", "verdict", "detail", "violation_key",
                "config", "faults", "history", "events", "spans", "extra"):
        assert bundle[key] == jbundle[key], key
    text = explain(bundle)
    assert "violating op:" in text and rep.repro in text
    assert "last leader per term:" in text
    assert jexplain(bundle) == text
    assert explain(jbundle) == jexplain(jbundle)
    json.dumps(bundle)


def test_journal_survives_crash_restore_with_jax_marks(tmp_path):
    from raft_tpu_torch.obs.blackbox import read_journal

    phases = []
    for package, kw in (("raft_tpu_torch", {"device": "cpu"}),
                        ("raft_tpu", {})):
        d = tmp_path / package
        _, rep = run_traced(package, "torture_run", 3, phases=6,
                            blackbox_dir=str(d), **kw)
        assert rep.verdict == LINEARIZABLE and rep.crashes >= 1
        recs = read_journal(str(d / "journal_torture_seed3.jsonl"))
        marks = [r["phase"] for r in recs]
        assert marks[0] == "journal_open" and marks[-1] == "journal_close"
        assert marks.count("crash_restore") == rep.crashes
        assert [r["seq"] for r in recs] == sorted(r["seq"] for r in recs)
        phases.append([
            (r["phase"], {k: v for k, v in r.items()
                          if k not in ("t", "seq", "pid", "proc", "wall",
                                       "mono", "host", "t_wall")})
            for r in recs[1:-1]])
    assert phases[0] == phases[1]
