"""The port's compile plane (``raft_tpu_torch.obs.compile``) against the JAX
package's (``raft_tpu.obs.compile``): ``tests/test_compile_plane.py``'s
cases 1-3 and its fetch pin, each through both packages on the same
seeded inputs (3 replicas, 16-byte entries, B = 4, C = 64).

- Accounting: a labeled program's first call records a ``trace`` with
  the same ``float32[7]`` string and the same ``raft_retraces_total``
  text; a second call records nothing; detached, the wrapper is a
  passthrough; snapshots and summaries carry the same keys.
- Zero steady-state compiles: a fused K = 64 window and the per-seed
  engine rebuild run frozen with no violation in either package.
- Falsifiability: an S + 1 staging buffer trips the sentinel in both,
  with the same program and the same ``int32[S+1,B,W]`` string. The port
  has no ``lower`` event, and on the CPU no ``compile`` event (nothing is
  captured or built there): its violation is the ``trace``.
- Overhead: the port with the plane attached makes the same ``_fetch``
  calls, nodelog lines and committed bytes as detached, and the nodelog
  lines and committed bytes of the JAX engine; over one lock-step drive
  (``tests/test_torch_fused.py`` ``drive``) every label's ``launches`` is
  the JAX engine's.

The exactness is equality of strings, counts and bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JConfig
from raft_tpu.core.state import committed_payloads as jcommitted
from raft_tpu.obs import compile as jcompile
from raft_tpu.obs.memory import MemoryWatch as JMemoryWatch
from raft_tpu.obs.registry import MetricsRegistry as JRegistry
from raft_tpu.raft.engine import RaftEngine as JEngine
from raft_tpu.transport.device import SingleDeviceTransport as JTransport
from raft_tpu_torch.config import RaftConfig as TConfig
from raft_tpu_torch.core.state import log_entries
from raft_tpu_torch.obs import compile as tcompile
from raft_tpu_torch.obs.memory import MemoryWatch as TMemoryWatch
from raft_tpu_torch.obs.registry import MetricsRegistry as TRegistry
from raft_tpu_torch.raft.engine import RaftEngine as TEngine
from raft_tpu_torch.transport import SingleDeviceTransport as TTransport
from tests.test_torch_fused import assert_engines_equal, drive, make_pair

ENTRY = 16
KW = dict(n_replicas=3, entry_bytes=ENTRY, batch_size=4, log_capacity=64,
          transport="single")
PKGS = {"jax": jcompile, "torch": tcompile}


def payloads(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, ENTRY, dtype=np.uint8).tobytes()
            for _ in range(n)]


def mk_engine(pkg, fuse_k=1, seed=0):
    if pkg == "jax":
        cfg = JConfig(**KW, fuse_k=fuse_k, seed=seed)
        return JEngine(cfg, JTransport(cfg))
    cfg = TConfig(**KW, fuse_k=fuse_k, seed=seed)
    return TEngine(cfg, TTransport(cfg, device="cpu"))


def drive_pattern(e, seed):
    """``tests/test_compile_plane.py``'s warmup-shaped drive."""
    e.run_until_leader()
    seqs = [e.submit(p) for p in payloads(24, seed=seed)]
    e.run_for(40 * e.cfg.heartbeat_period)
    e.run_for(10 * e.cfg.heartbeat_period)
    assert all(e.is_durable(s) for s in seqs)


def program(pkg, fn):
    """``fn`` as each package's program: a jit for JAX, the function
    itself for the port."""
    return jax.jit(fn) if pkg == "jax" else fn


def ones(pkg, n):
    return jnp.ones(n) if pkg == "jax" else torch.ones(n)


def retraces_text(registry) -> list:
    return [ln for ln in registry.to_prometheus().splitlines()
            if "raft_retraces_total" in ln]


# ------------------------------------------------------------ 1. accounting
def test_labeled_program_attribution_and_shapes():
    got = {}
    for pkg, mod in PKGS.items():
        reg = JRegistry() if pkg == "jax" else TRegistry()
        watch = mod.CompileWatch(registry=reg)
        # a fresh program in each package: its first call is novel
        fn = mod.labeled("single.fused", program(pkg, lambda x: x * 2))
        x = ones(pkg, 7)
        with watch:
            fn(x)
        traces = watch.events(program="single.fused", event="trace")
        assert traces, pkg
        before = watch.total_traces
        with watch:
            fn(x)                            # the same shapes: nothing
        assert watch.total_traces == before, pkg
        assert watch.by_program()["single.fused"]["launches"] == 2, pkg
        got[pkg] = ([r.arg_shapes for r in traces], retraces_text(reg))
    # JAX traces twice (the jitted lambda and the multiply inside it);
    # the port once: the same shape string, the same counter text but
    # for the count
    assert got["torch"][0] == [["float32[7]"]]
    assert all(a == ["float32[7]"] for a in got["jax"][0])
    assert [ln.rsplit(" ", 1)[0] for ln in got["torch"][1]] == \
        [ln.rsplit(" ", 1)[0] for ln in got["jax"][1]]
    assert got["torch"][1][-1] == \
        'raft_retraces_total{program="single.fused"} 1'


def test_novel_shape_traces_again_and_scalars_key_by_type():
    """A new shape is a new signature; a Python scalar keys by its type,
    not its value (``jax.jit``'s weak-typed scalars)."""
    watch = tcompile.CompileWatch()
    fn = tcompile.labeled("probe.shapes", lambda x, n: x + n)
    with watch:
        fn(torch.ones(3), 1)
        fn(torch.ones(3), 2)
        fn(torch.ones(4), 2)
        fn(torch.ones(4), 2.5)
    assert [r.arg_shapes for r in watch.events("probe.shapes", "trace")] \
        == [["float32[3]", "int"], ["float32[4]", "int"],
            ["float32[4]", "float"]]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_detached_wrapper_is_passthrough(pkg):
    mod = PKGS[pkg]
    base = program(pkg, lambda x: x + 1)
    fn = mod.labeled("single.vote", base)
    assert fn.__wrapped__ is base and fn.program_label == "single.vote"
    assert not mod.active()
    out = fn(ones(pkg, 3))              # no watch installed anywhere
    np.testing.assert_array_equal(np.asarray(out), np.full(3, 2.0))


def test_snapshot_and_summary_keys_equal():
    snaps = {}
    for pkg, mod in PKGS.items():
        watch = mod.CompileWatch()
        mod.RetraceSentinel(watch)
        x = ones(pkg, 2)
        with watch:
            mod.labeled("p", program(pkg, lambda x: x - 1))(x)
        snap = watch.snapshot()
        assert "p" in snap["programs"], pkg
        assert snap["sentinel"]["frozen"] is False
        assert snap["log"][0]["event"] == "trace"
        assert snap["log"][0]["program"] == "p"
        snaps[pkg] = (snap, watch.summary())
    (js, jsum), (ts, tsum) = snaps["jax"], snaps["torch"]
    assert set(ts) == set(js)
    assert set(tsum) == set(jsum)
    assert set(ts["programs"]["p"]) == set(js["programs"]["p"])
    assert set(ts["log"][0]) == set(js["log"][0])
    assert set(ts["sentinel"]) == set(js["sentinel"])
    assert ts["sentinel"]["hot_paths"] == js["sentinel"]["hot_paths"]
    assert tcompile.DEFAULT_HOT_PATHS == jcompile.DEFAULT_HOT_PATHS
    assert tcompile.UNLABELED == jcompile.UNLABELED


# -------------------------------------------- 2. zero steady-state compiles
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fused_k64_window_zero_steady_compiles(pkg):
    mod = PKGS[pkg]
    watch = mod.CompileWatch()
    sentinel = mod.RetraceSentinel(watch)
    with watch:
        e = mk_engine(pkg, fuse_k=64)
        drive_pattern(e, seed=1)
        launches0 = e.fused_launches
        with sentinel.assert_no_recompiles():
            seqs = [e.submit(p) for p in payloads(24, seed=2)]
            e.run_for(40 * e.cfg.heartbeat_period)
            e.run_for(10 * e.cfg.heartbeat_period)
        assert all(e.is_durable(s) for s in seqs)
        assert e.fused_launches > launches0
    assert sentinel.violations == []
    assert watch.by_program()["single.fused"]["launches"] > 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_per_seed_engine_rebuild_zero_compiles(pkg):
    mod = PKGS[pkg]
    watch = mod.CompileWatch()
    sentinel = mod.RetraceSentinel(watch)
    with watch:
        e1 = mk_engine(pkg, fuse_k=1, seed=3)
        drive_pattern(e1, seed=3)
        with sentinel.assert_no_recompiles():
            e2 = mk_engine(pkg, fuse_k=1, seed=3)   # a fresh "restart"
            drive_pattern(e2, seed=3)
    assert sentinel.violations == []


# ------------------------------------------------------ 3. falsifiability
def drift_violations(pkg):
    mod = PKGS[pkg]
    watch = mod.CompileWatch()
    sentinel = mod.RetraceSentinel(watch)
    with watch:
        e = mk_engine(pkg, fuse_k=8)
        drive_pattern(e, seed=4)
        d = e._fused_driver
        S, B, W = d.staging.S, d.staging.B, d.staging.W
        r = e.leader_id
        if pkg == "jax":
            drifted = jnp.zeros((S + 1, B, W), jnp.int32)
            args = (jnp.zeros(4, jnp.int32), jnp.asarray(e.alive),
                    jnp.asarray(e.slow))
        else:
            drifted = torch.zeros((S + 1, B, W), dtype=torch.int32)
            args = (torch.zeros(4, dtype=torch.int32),
                    torch.as_tensor(e.alive), torch.as_tensor(e.slow))
        with pytest.raises(mod.RecompileError) as ei:
            with sentinel.assert_no_recompiles():
                e.t.replicate_fused(e.state, drifted, 0, args[0], 2, False,
                                    r, int(e.lead_terms[r]), *args[1:])
    assert "single.fused" in str(ei.value)
    return sentinel.violations, (S, B, W)


def test_injected_shape_drift_trips_sentinel_in_both():
    jv, shape = drift_violations("jax")
    tv, tshape = drift_violations("torch")
    assert tshape == shape
    want = "int32[{},{},{}]".format(shape[0] + 1, *shape[1:])
    # JAX records a trace for every jit it traces inside the call (the
    # step's inner programs too) and a compile; the port records one
    # trace (a novel signature) and, on the CPU, captures and builds
    # nothing. Every violation names the same program and carries the
    # call's arguments, the staging buffer second.
    assert [v.event for v in tv] == ["trace"]
    assert {v.event for v in jv} == {"trace", "compile"}
    assert {v.program for v in tv} == {v.program for v in jv} == \
        {"single.fused"}
    for v in list(jv) + list(tv):
        assert v.arg_shapes[:2] == ["pytree(8 leaves)", want]


# ------------------------------------------------------ 4. overhead contract
def fetch_run(pkg, with_plane):
    """``TestOverheadContract.test_plane_adds_no_device_fetches``'s run:
    (``_fetch`` calls, nodelog lines, committed bytes of row 0)."""
    mod = PKGS[pkg]
    cfg = (JConfig if pkg == "jax" else TConfig)(**KW, fuse_k=4, seed=7)
    lines = []
    e = (JEngine(cfg, JTransport(cfg), trace=lines.append) if pkg == "jax"
         else TEngine(cfg, TTransport(cfg, device="cpu"),
                      trace=lines.append))
    counts = [0]
    orig = e._fetch

    def counting(x):
        counts[0] += 1
        return orig(x)

    e._fetch = counting
    watch = mem = None
    if with_plane:
        watch = mod.CompileWatch().install()
        mod.RetraceSentinel(watch)
        mem = (JMemoryWatch if pkg == "jax" else TMemoryWatch)()
        mem.watch_engine(e)
        mem.census()
    try:
        drive_pattern(e, seed=7)
        if mem is not None:
            mem.census()
    finally:
        if watch is not None:
            watch.uninstall()
    if pkg == "jax":
        log = [bytes(p) for p in jcommitted(e.state, 0)]
    else:
        hi = int(e.state.commit_index[0])
        ents = log_entries(e.state, 0, 1, hi)
        log = [ents[i].tobytes() for i in range(hi)]
    return counts[0], lines, log


def test_plane_adds_no_device_fetches():
    bare = fetch_run("torch", False)
    plane = fetch_run("torch", True)
    assert plane == bare
    jbare = fetch_run("jax", False)
    # the port's engine reads back twice more than JAX's over this drive
    # (its own fetch pattern, plane or no plane): lines and bytes agree
    assert bare[1:] == jbare[1:]


def test_launches_per_label_equal_the_jax_engine():
    """Both engines in lock step at ``fuse_k`` 4 (``tests/test_torch_fused.py``
    ``drive``: an election, a drained backlog through fused windows, idle
    heartbeats, a leader kill, a re-election and a re-drain) with a watch
    installed in each package: every label's launch count is the JAX
    engine's (the seams are the same)."""
    watches = [jcompile.CompileWatch().install(),
               tcompile.CompileWatch().install()]
    try:
        j, t, jl, tl = make_pair(4)
        for sj, st in zip(drive(j), drive(t)):
            assert sj == st
            assert_engines_equal(j, t, jl, tl, st)
    finally:
        for w in watches:
            w.uninstall()
    assert t.fused_launches > 0
    # (JAX also tallies unlabeled traces, launched by no seam)
    jl, tl = ({k: v["launches"] for k, v in w.by_program().items()
               if v["launches"]} for w in watches)
    assert tl == jl
    assert {"single.fused", "single.stage", "single.vote",
            "single.replicate"} <= set(tl)
