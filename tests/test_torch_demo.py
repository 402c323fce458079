"""The port's live demo (``raft_tpu_torch.demo``) on the CPU, on
``tests/test_demo.py``'s three cases: an election and commits, a
checkpoint resume, and the RS(5,3) session. At ``time_scale=0`` (no
sleeping) every line it prints equals the JAX demo's, apart from the
header line that names the package and device."""

import re

import pytest

from raft_tpu.demo import run_demo as jax_demo
from raft_tpu_torch.demo import run_demo


def sessions(**kw):
    """The same session through both demos: (port engine, port lines)."""
    jl, tl = [], []
    jax_demo(time_scale=0.0, emit=jl.append, **kw)
    eng = run_demo(time_scale=0.0, emit=tl.append, device="cpu", **kw)
    header = [i for i, ln in enumerate(tl) if "live demo" in ln]
    assert len(header) == 1 and "raft_tpu_torch live demo on cpu" in \
        tl[header[0]]
    assert [ln for i, ln in enumerate(tl) if i != header[0]] == \
        [ln for i, ln in enumerate(jl) if i != header[0]]
    return eng, tl


def test_demo_session_elects_and_commits():
    eng, lines = sessions(duration=90.0)
    out = "\n".join(lines)
    assert re.search(r"\[Server\d:\d+:\d+:\d+\]\[candidate\]state changed "
                     r"to candidate", out)
    assert re.search(r"\[leader\]state changed to leader", out)
    assert "[client] submit seq=1" in out
    assert re.search(r"\[leader\]commit index changed to \d+", out)
    assert eng.commit_watermark >= 5
    lat = eng.commit_latencies()
    assert len(lat) >= 5 and max(lat) < 4.5


def test_demo_checkpoint_resume(tmp_path):
    """Two sessions on one checkpoint path in each package: the second
    resumes the first's committed log and keeps committing."""
    kw = dict(duration=60.0)
    jpath, tpath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    first = []
    for path in (jpath, tpath):
        lines = []
        run = jax_demo if path == jpath else run_demo
        extra = {} if path == jpath else {"device": "cpu"}
        e1 = run(time_scale=0.0, checkpoint=path, emit=lines.append,
                 **kw, **extra)
        first.append((e1.commit_watermark, lines))
    assert first[1][0] == first[0][0] >= 3
    assert any("checkpoint written" in ln for ln in first[1][1])
    jl, tl = [], []
    jax_demo(time_scale=0.0, checkpoint=jpath, emit=jl.append, **kw)
    e2 = run_demo(time_scale=0.0, checkpoint=tpath, emit=tl.append,
                  device="cpu", **kw)
    assert any("resumed from" in ln for ln in tl)
    assert e2.commit_watermark > first[1][0]
    strip = [ln.replace(tpath, "CKPT") for ln in tl
             if "live demo" not in ln]
    assert strip == [ln.replace(jpath, "CKPT") for ln in jl
                     if "live demo" not in ln]


def test_demo_ec_session():
    eng, _ = sessions(duration=90.0, n_replicas=5, rs_k=3, rs_m=2,
                      entry_bytes=264)
    assert eng.commit_watermark >= 5


def test_demo_defaults_to_cuda():
    """Without ``device`` the demo runs on CUDA: on a machine without a
    card it raises rather than falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        eng = run_demo(duration=1.0, time_scale=0.0, emit=lambda ln: None)
        assert eng.state.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_demo(duration=1.0, time_scale=0.0, emit=lambda ln: None)
