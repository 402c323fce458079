"""Forensics through the port (``raft_tpu_torch.obs.forensics``,
``blackbox`` and the CLI ``python -m raft_tpu_torch.obs``) against the
JAX package's.

- From one lock-step run of both engines with the full plane attached,
  each package writes a repro bundle: the two files hold the same JSON;
  ``explain``, ``--explain``, ``--render-perfetto`` and
  ``--metrics-dump`` (text and ``--json``) print the same output in
  both packages, and each CLI reads the other's bundle alike.
- ``BlackboxJournal`` journals and a ``StallWatchdog`` stall bundle
  (fired by a 0.2-s budget) explain the same through both packages.
- ``ObsStack.build(device=True)`` refuses naming ROADMAP A13,
  ``compile_plane=True`` naming A16b.
"""

import json
import time
import types

import pytest

from raft_tpu.obs import blackbox as jblackbox
from raft_tpu.obs import forensics as jforensics
from raft_tpu.obs.__main__ import main as jmain
from raft_tpu_torch.obs import blackbox as tblackbox
from raft_tpu_torch.obs import forensics as tforensics
from raft_tpu_torch.obs.__main__ import main as tmain
from tests.test_torch_engine import payloads
from tests.test_torch_obs_engine import ObsPair

MAINS = {"jax": jmain, "torch": tmain}


def history():
    """A small client history with a stale read (what the chaos runner's
    ``History`` records; ``write_bundle`` reads its ``ops``)."""
    op = types.SimpleNamespace
    return op(ops=[
        op(client=0, op="write", key=b"k", value=b"v1", invoke_t=1.0,
           complete_t=2.0, status="ok"),
        op(client=1, op="write", key=b"k", value=b"v2", invoke_t=3.0,
           complete_t=4.0, status="ok"),
        op(client=2, op="read", key=b"k", value=b"v2", invoke_t=5.0,
           complete_t=6.0, status="ok"),
        op(client=2, op="read", key=b"k", value=b"v1", invoke_t=7.0,
           complete_t=8.0, status="ok"),
    ])


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """One lock-step run with a failover; each package writes a bundle."""
    p = ObsPair(41)
    lead = p.until_leader()
    seqs = p.submit_spanned(payloads(20, 41))
    p.until_committed(seqs[-1])
    p.both("fail", lead)
    p.until_leader()
    p.both("recover", lead)
    more = p.submit_spanned(payloads(8, 42))
    p.until_committed(more[-1])
    p.run_for(4.0)
    p.check_all()
    out = {}
    for name, mod, e, (stack, _) in (
        ("jax", jforensics, p.j, p.planes[0]),
        ("torch", tforensics, p.t, p.planes[1]),
    ):
        d = tmp_path_factory.mktemp(f"bundle_{name}")
        out[name] = mod.write_bundle(
            str(d), kind="engine", seed=41, expected="LINEARIZABLE",
            verdict="VIOLATION", detail="stale read on key 'k'",
            violation_key=b"k", repro="seed 41", config=e.cfg,
            nemesis_log=[f"t={e.clock.now:.3f} kill Server{lead}"],
            history=history(), obs=stack,
        )
    return out


def test_bundles_hold_the_same_json(bundles):
    j, t = (json.load(open(bundles[k])) for k in ("jax", "torch"))
    assert t == j
    assert t["format"] == "raft_tpu.obs/bundle.v1"
    assert t["events"]["events"] and t["spans"]["spans"]
    assert t["audit"]["violations_total"] == 0


def test_explain_names_the_last_leaders(bundles):
    texts = {k: mod.explain(mod.load_bundle(bundles[k]))
             for k, mod in (("jax", jforensics), ("torch", tforensics))}
    assert texts["torch"] == texts["jax"]
    text = texts["torch"]
    assert "last leader per term:" in text
    assert "violating op: client 2 read" in text
    b = tforensics.load_bundle(bundles["torch"])
    elects = [ev for ev in b["events"]["events"] if ev["kind"] == "elect"]
    for ev in elects:
        assert f"term {ev['term']}: " in text


@pytest.mark.parametrize("args", [
    ["--explain"], ["--render-perfetto"], ["--metrics-dump"],
    ["--metrics-dump", "--json"],
], ids=["explain", "perfetto", "metrics", "metrics-json"])
def test_cli_outputs_equal_and_cross_read(bundles, args, tmp_path):
    """Each CLI on each bundle: four outputs, all equal."""
    outs = {}
    for cli, main in MAINS.items():
        for src, path in bundles.items():
            o = tmp_path / f"{cli}_{src}.out"
            flag, rest = args[0], args[1:]
            assert main([flag, path, *rest, "-o", str(o)]) == 0
            outs[(cli, src)] = o.read_text()
    want = outs[("jax", "jax")]
    assert all(v == want for v in outs.values()), list(outs)
    if args == ["--metrics-dump"]:
        assert "raft_commits_total" in want
    if args == ["--render-perfetto"]:
        assert any(ev["ph"] == "X"
                   for ev in json.loads(want)["traceEvents"])


def test_bundle_dir_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("RAFT_TPU_BUNDLE_DIR", str(tmp_path))
    monkeypatch.setenv("RAFT_TPU_BLACKBOX_DIR", str(tmp_path / "bb"))
    for fmod, bmod in ((jforensics, jblackbox), (tforensics, tblackbox)):
        assert fmod.resolve_bundle_dir(None) == str(tmp_path)
        assert fmod.resolve_bundle_dir("x") == "x"
        assert bmod.resolve_blackbox_dir() == str(tmp_path / "bb")


def test_journal_marks_and_explain(tmp_path, capsys):
    """A journal written by the port reads back through both packages
    with the same explanation, the module-level marks included."""
    p = tmp_path / "journal_p0.jsonl"
    tblackbox.mark("ignored_without_journal")
    with tblackbox.journal_for("p0", blackbox_dir=str(tmp_path),
                               proc="p0") as j:
        assert tblackbox.get_journal() is j
        tblackbox.mark("barrier_enter", barrier="b", id=3)
        j.mark("tick", n=1)
    assert tblackbox.get_journal() is None
    recs = tblackbox.read_journal(str(p))
    assert [r["phase"] for r in recs] == [
        "journal_open", "barrier_enter", "tick", "journal_close"]
    assert recs == jblackbox.read_journal(str(p))
    assert tblackbox.explain_journal([str(p)]) == \
        jblackbox.explain_journal([str(p)])
    q = tmp_path / "journal_p1.jsonl"
    jj = jblackbox.BlackboxJournal(str(q), proc="p1")
    jj.mark("phase_a")
    jj._f.close()        # died mid-phase: no journal_close
    paths = [str(p), str(q)]
    assert tblackbox.explain_merged(paths) == \
        jblackbox.explain_merged(paths)
    outs = []
    for main in (jmain, tmain):
        assert main(["--explain", str(tmp_path)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert "p0" in outs[1] and "p1" in outs[1]


def test_stall_watchdog_fires_and_explains(tmp_path, capsys):
    j = tblackbox.BlackboxJournal(str(tmp_path / "j.jsonl"), proc="s0")
    fired = []
    wd = tblackbox.StallWatchdog(
        0.2, tag="unit", journal=j, bundle_dir=str(tmp_path),
        on_fire=fired.append, poll_s=0.05,
    ).arm()
    j.mark("allgather", id=5)
    deadline = time.monotonic() + 30.0
    while not wd.fired and time.monotonic() < deadline:
        time.sleep(0.05)       # the "blocked" main thread
    wd.disarm()
    j.close()
    assert wd.fired and fired
    bundle = json.load(open(wd.bundle_path))
    assert bundle["format"] == "raft_tpu.obs/stall.v1"
    assert bundle["phase"] == "allgather"
    assert "test_stall_watchdog_fires_and_explains" in bundle["stacks"]
    assert tblackbox.explain_stall(bundle) == jblackbox.explain_stall(bundle)
    outs = []
    for main in (jmain, tmain):
        assert main(["--explain", wd.bundle_path]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0] and "STALL" in outs[1]
    # a clean run stays silent
    with tblackbox.StallWatchdog(5.0, tag="clean", poll_s=0.05) as quiet:
        quiet.pet()
    assert not quiet.fired


@pytest.mark.parametrize("kw,item", [
    (dict(device=True), "A13"),
    (dict(compile_plane=True), "A16b"),
], ids=["device", "compile"])
def test_obs_stack_refuses_unported_planes(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tforensics.ObsStack.build(**kw)
