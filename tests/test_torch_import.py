"""The port stands alone: importing raft_tpu_torch pulls in neither JAX nor
the JAX package, no module of the port (nor chip_smoke.py) imports them,
and the transport refuses to run on a machine without CUDA unless the
caller asks for the CPU."""

import ast
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "raft_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import raft_tpu_torch, raft_tpu_torch.northstar\n"
        "import raft_tpu_torch.core.step_cuda, raft_tpu_torch.core.ring_cuda\n"
        "import raft_tpu_torch.core.step, raft_tpu_torch.core.ring\n"
        "import raft_tpu_torch.core.state, raft_tpu_torch.core.comm\n"
        "import raft_tpu_torch.ec, raft_tpu_torch.ec.gf, raft_tpu_torch.ec.rs\n"
        "import raft_tpu_torch.ec.kernels, raft_tpu_torch.ec.reconstruct\n"
        "import raft_tpu_torch.core.step_mesh, raft_tpu_torch.transport.mesh\n"
        "import raft_tpu_torch.transport.multihost\n"
        "import raft_tpu_torch.transport.group_mesh\n"
        "import raft_tpu_torch.transport.reform\n"
        "import raft_tpu_torch.transport.launch\n"
        "import raft_tpu_torch.raft, raft_tpu_torch.raft.engine\n"
        "import raft_tpu_torch.raft.ledger, raft_tpu_torch.storm\n"
        "import raft_tpu_torch.raft.lease, raft_tpu_torch.examples\n"
        "import raft_tpu_torch.examples.kv, raft_tpu_torch.examples.sessions\n"
        "import raft_tpu_torch.admission, raft_tpu_torch.admission.retry\n"
        "import raft_tpu_torch.faults, raft_tpu_torch.faults.plan\n"
        "import raft_tpu_torch.ckpt, raft_tpu_torch.ckpt.ship\n"
        "import raft_tpu_torch.ckpt.snapshot, raft_tpu_torch.ckpt.votelog\n"
        "import raft_tpu_torch.obs, raft_tpu_torch.obs.profiling\n"
        "import raft_tpu_torch.obs.hostprof, raft_tpu_torch.obs.slo\n"
        "import raft_tpu_torch.obs.events, raft_tpu_torch.obs.trace\n"
        "import raft_tpu_torch.obs.registry, raft_tpu_torch.obs.spans\n"
        "import raft_tpu_torch.obs.audit, raft_tpu_torch.obs.metrics\n"
        "import raft_tpu_torch.obs.serve, raft_tpu_torch.obs.blackbox\n"
        "import raft_tpu_torch.obs.forensics, raft_tpu_torch.obs.__main__\n"
        "import raft_tpu_torch.raft.steady, raft_tpu_torch.core.graphs\n"
        "import raft_tpu_torch.golden, raft_tpu_torch.golden.model\n"
        "import raft_tpu_torch.demo\n"
        "import raft_tpu_torch.native, raft_tpu_torch.ckpt.tiered\n"
        "import raft_tpu_torch.cluster, raft_tpu_torch.cluster.storage\n"
        "import raft_tpu_torch.obs.device\n"
        "import raft_tpu_torch.obs.compile, raft_tpu_torch.obs.memory\n"
        "import raft_tpu_torch.multi, raft_tpu_torch.multi.engine\n"
        "import raft_tpu_torch.multi.router, raft_tpu_torch.multi.rebalancer\n"
        "import raft_tpu_torch.examples.kv_sharded\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax') or "
        "m == 'raft_tpu' or m.startswith(('jax.', 'raft_tpu.')))\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % str(ROOT)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_obs_exports_the_jax_planes_names():
    """``raft_tpu_torch.obs`` exports every name of JAX's
    ``raft_tpu/obs/__init__.py`` (the device plane's lazily), the compile
    and memory planes' among them."""
    import raft_tpu.obs as jobs
    import raft_tpu_torch.obs as tobs

    assert set(jobs.__all__) <= set(tobs.__all__)
    for name in ("CompileRecord", "CompileViolation", "CompileWatch",
                 "RecompileError", "RetraceSentinel", "assert_no_recompiles",
                 "DonationReport", "MemoryCensus", "MemoryWatch",
                 "audit_donation", "serve_demo"):
        assert getattr(tobs, name).__module__.startswith("raft_tpu_torch.")


def test_compile_plane_import_stays_off_the_device():
    """The transports import ``obs.compile`` on the hot path: it imports
    no torch of its own and touches no device, and importing it leaves
    CUDA uninitialised and ``obs.device`` unloaded."""
    src = (ROOT / "raft_tpu_torch" / "obs" / "compile.py").read_text()
    tree = ast.parse(src)
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names} | {n.module for n in ast.walk(tree)
                                 if isinstance(n, ast.ImportFrom)}
    assert not any(m and m.split(".")[0] == "torch" for m in mods)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import raft_tpu_torch.obs.compile, torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'raft_tpu_torch.obs.device' not in sys.modules\n"
        % str(ROOT)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    assert path.exists(), path
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert not _forbidden(n), f"{path.name}:{node.lineno} imports {n}"


def test_transport_without_device_needs_cuda():
    from raft_tpu_torch import RaftConfig, SingleDeviceTransport

    cfg = RaftConfig(n_replicas=3, entry_bytes=8, batch_size=128,
                     log_capacity=256, transport="single")
    if torch.cuda.is_available():
        assert SingleDeviceTransport(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SingleDeviceTransport(cfg)
    # asked for explicitly, the CPU runs the plain versions
    assert SingleDeviceTransport(cfg, device="cpu").init().device.type == "cpu"


def test_make_transport_single_only(caplog):
    """``transport="single"`` is the resident layout; ``"tpu_mesh"`` (and
    ``"multihost"``) is a ``MeshTransport`` inside a process group of
    ``n_replicas * payload_shards`` ranks and, outside one, the resident
    layout after a logged warning; ``"loopback"`` and any other name are
    refused with the JAX package's messages (the golden model named as
    the port's own)."""
    from raft_tpu_torch import MeshTransport, RaftConfig, make_transport
    from raft_tpu_torch.transport.launch import run_ranks
    from tests._mesh_ranks import transport_kind

    kw = dict(n_replicas=3, entry_bytes=8, batch_size=128, log_capacity=256)
    assert make_transport(RaftConfig(**kw, transport="single"),
                          device="cpu").device.type == "cpu"
    assert run_ranks(transport_kind, 3, (kw,), timeout=120) == [
        "MeshTransport"] * 3
    with caplog.at_level(logging.WARNING):
        tr = make_transport(RaftConfig(**kw), device="cpu")
    assert not isinstance(tr, MeshTransport)
    assert tr.init().log_term.shape == (3, 256)
    assert "falling back to SingleDeviceTransport" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tr = make_transport(RaftConfig(**kw, transport="multihost"),
                            device="cpu")
    assert not isinstance(tr, MeshTransport)
    assert "multihost placement unavailable" in caplog.text
    from raft_tpu.config import RaftConfig as JConfig
    from raft_tpu.transport import make_transport as jmake

    for name in ("loopback", "carrier-pigeon"):
        with pytest.raises(ValueError) as want:
            jmake(JConfig(**kw, transport=name))
        with pytest.raises(ValueError) as got:
            make_transport(RaftConfig(**kw, transport=name), device="cpu")
        assert str(got.value) == str(want.value).replace(
            "raft_tpu.golden", "raft_tpu_torch.golden")
