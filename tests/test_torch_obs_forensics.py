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
- ``ObsStack.build(compile_plane=True)`` builds the compile and memory
  planes (the case that checked its refusal before they were ported keeps
  its name), and a bundle carries JAX's ``compile_log`` and ``memory``
  sections: each package's ``--explain`` prints the same ``RETRACE:`` and
  ``CENSUS GREW`` lines for the other's bundle
  (``tests/test_obs_forensics.py``'s
  ``test_explain_flags_retrace_and_census_growth``; ``device=True`` is
  covered in ``tests/test_torch_device_obs.py``).
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
    (dict(compile_plane=True), "A16b"),
], ids=["compile"])
def test_obs_stack_refuses_unported_planes(kw, item):
    """Once the refusal of ROADMAP ``item``; the planes now build: a
    compile watch installed with its sentinel and a memory watch on the
    stack's registry, attached to an engine by ``attach`` and detached by
    ``close``."""
    from raft_tpu_torch.obs import compile as tcompile
    from raft_tpu_torch.obs.compile import CompileWatch, RetraceSentinel
    from raft_tpu_torch.obs.memory import MemoryWatch
    from tests.test_torch_memory_plane import mk_engine

    stack = tforensics.ObsStack.build(**kw)
    try:
        assert isinstance(stack.compile, CompileWatch)
        assert isinstance(stack.compile.sentinel, RetraceSentinel)
        assert stack.compile.installed and tcompile.active()
        assert isinstance(stack.memory, MemoryWatch)
        assert stack.memory.registry is stack.registry
        e = mk_engine("torch")
        stack.attach(e)
        assert stack.memory.snapshot()["roots"] == [
            "engine.host", "engine.ring", "engine.state"]
    finally:
        stack.close()
    assert not stack.compile.installed


def settled(memory, take):
    """``take()`` (a baseline or a drift: a census of the process) again
    until two censuses in a row count the same bytes, and its last
    result. The growth a bundle reports is the difference of two
    censuses of the whole process, so each waits for the census it reads
    to be still (in a worker that ran other files first, a collection's
    finalizers or an array's deferred deletion may be under way)."""
    out = take()
    for _ in range(100):
        before = memory.last.total_bytes
        out = take()
        if memory.last.total_bytes == before:
            break
        time.sleep(0.02)
    return out


def bundle_with_retrace_and_growth(pkg, tmp_path):
    """JAX's case through ``pkg``: a post-freeze retrace on
    ``single.fused`` and a held ``float32[99,3]`` buffer, then a bundle."""
    import jax
    import jax.numpy as jnp
    import torch

    fmod = {"jax": jforensics, "torch": tforensics}[pkg]
    if pkg == "jax":
        from raft_tpu.obs.compile import labeled

        prog, mk = jax.jit(lambda x: x - 2), jnp.ones
        zeros = lambda: jnp.zeros((99, 3), jnp.float32)  # noqa: E731
    else:
        from raft_tpu_torch.obs.compile import labeled

        prog, mk = (lambda x: x - 2), torch.ones
        zeros = lambda: torch.zeros((99, 3))  # noqa: E731
    obs = fmod.ObsStack.build(compile_plane=True)
    try:
        probe = labeled("single.fused", prog)
        a, b = mk(5), mk(6)
        probe(a)
        obs.compile.sentinel.freeze()
        probe(b)                                   # post-freeze retrace
        assert obs.compile.sentinel.violations
        settled(obs.memory, obs.memory.set_baseline)
        leak = zeros()                             # census growth
        obs.memory.final_drift = settled(obs.memory, obs.memory.drift)
        assert obs.memory.final_drift
        path = fmod.write_bundle(
            str(tmp_path / pkg), kind="torture", seed=1,
            expected="LINEARIZABLE", verdict="VIOLATION", obs=obs)
        del leak
    finally:
        obs.close()
    return path


def flagged(text):
    return [ln for ln in text.splitlines()
            if "RETRACE:" in ln or "CENSUS GREW" in ln]


def test_explain_flags_retrace_and_census_growth(tmp_path, capsys):
    paths = {pkg: bundle_with_retrace_and_growth(pkg, tmp_path)
             for pkg in ("jax", "torch")}
    b = tforensics.load_bundle(paths["torch"])
    jb = jforensics.load_bundle(paths["jax"])
    assert set(b["compile_log"]) == set(jb["compile_log"])
    assert set(b["memory"]) == set(jb["memory"])
    assert b["compile_log"]["sentinel"]["violations"]
    assert b["memory"]["census"]["n_arrays"] > 0
    texts = {}
    for reader, main in MAINS.items():
        for writer, path in paths.items():
            assert main(["--explain", path]) == 0
            texts[reader, writer] = flagged(capsys.readouterr().out)
    for writer in paths:
        got = texts["torch", writer]
        assert got == texts["jax", writer], writer
        assert any("RETRACE: post-freeze" in ln and "single.fused" in ln
                   for ln in got)
        assert any("CENSUS GREW" in ln for ln in got)
    # the port's bundle: its one trace on the hot path; the same census
    # growth as JAX's (the same buffers, the same bytes; the totals
    # around it are whatever else the process holds)
    retrace = [ln for ln in texts["torch", "torch"] if "RETRACE" in ln]
    assert len(retrace) == 1
    assert retrace[0].startswith(
        "  RETRACE: post-freeze trace on 'single.fused' at t_wall=")
    assert retrace[0].endswith("s args=(float32[6])")
    grew = {w: [ln.split(" (")[0] + " " + ln.split(") ")[-1]
                for ln in texts["torch", w] if "CENSUS GREW" in ln]
            for w in paths}
    assert grew["torch"] == grew["jax"] == [
        "  CENSUS GREW: +1188 bytes over baseline — possible leak across "
        "crash-restore/migration"]
