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
        "import raft_tpu_torch.net, raft_tpu_torch.net.protocol\n"
        "import raft_tpu_torch.net.client, raft_tpu_torch.net.server\n"
        "import raft_tpu_torch.cluster.netfault\n"
        "import raft_tpu_torch.cluster.auth, raft_tpu_torch.cluster.node\n"
        "import raft_tpu_torch.cluster.dialer\n"
        "import raft_tpu_torch.cluster.supervisor\n"
        "import raft_tpu_torch.cluster.child\n"
        "from raft_tpu_torch.cluster import RaftNode, ClusterSupervisor\n"
        "import raft_tpu_torch.chaos, raft_tpu_torch.chaos.runner\n"
        "import raft_tpu_torch.chaos.__main__\n"
        "import raft_tpu_torch.txn, raft_tpu_torch.txn.ops\n"
        "import raft_tpu_torch.txn.store, raft_tpu_torch.txn.coordinator\n"
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


def test_net_server_leaves_the_cluster_package_unloaded():
    """``net/server.py`` resolves the wire seam lazily: importing the net
    tier loads nothing of ``raft_tpu_torch.cluster`` (the cluster tier's
    node will import ``net``), and the seam module imports only the
    standard library."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import raft_tpu_torch.net\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.startswith('raft_tpu_torch.cluster'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % str(ROOT)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    tree = ast.parse((ROOT / "raft_tpu_torch" / "cluster" /
                      "netfault.py").read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    mods = {a.name for n in top if isinstance(n, ast.Import)
            for a in n.names} | {n.module for n in top
                                 if isinstance(n, ast.ImportFrom)}
    assert mods <= set(sys.stdlib_module_names) | {"__future__"}, mods


_RAW_STREAM_METHODS = ("read", "readexactly", "readuntil", "readline",
                       "write", "writelines", "drain")


def _dotted(node) -> str:
    """'os.replace'-style name for a call target, best effort (the JAX
    gate's)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def test_peer_bytes_ride_the_netfault_seam():
    """The port of ``tests/test_lint.py``'s seam gate over the dialer and
    the server: no ``open_connection``, no raw socket, and no read, write
    or drain on a bare reader or writer — every byte goes through
    ``cluster/netfault.py``'s ``RealConn`` / ``FaultyConn`` (``.close()``
    and ``asyncio.start_server`` are fine)."""
    offenders = []
    for rel, node in ((rel, node) for rel in (
            "raft_tpu_torch/cluster/dialer.py",
            "raft_tpu_torch/net/server.py")
            for node in ast.walk(ast.parse((ROOT / rel).read_text()))):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if (name == "asyncio.open_connection" or name == "socket.socket"
                or name.endswith(".create_connection")):
            offenders.append(f"{rel}:{node.lineno}: {name}")
        elif (isinstance(node.func, ast.Attribute)
                and node.func.attr in _RAW_STREAM_METHODS):
            recv = _dotted(node.func.value)
            tail = recv.rsplit(".", 1)[-1]
            if tail in ("reader", "writer") or tail.endswith(
                    ("_reader", "_writer")):
                offenders.append(f"{rel}:{node.lineno}: "
                                 f"{recv}.{node.func.attr}")
    assert not offenders, "\n".join(offenders)


def _write_mode_open(call) -> bool:
    """open(...) with a write, append or create mode (a dynamic mode
    counts), as the JAX gate reads it."""
    if _dotted(call.func) != "open":
        return False
    mode = call.args[1] if len(call.args) >= 2 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False
    if not isinstance(mode, ast.Constant) or not isinstance(mode.value,
                                                             str):
        return True
    return any(ch in mode.value for ch in "wax+")


@pytest.mark.parametrize("rel", ["raft_tpu_torch/cluster/node.py",
                                 "raft_tpu_torch/ckpt/tiered.py"])
def test_durable_writes_ride_the_vfs_seam(rel):
    """The port of ``tests/test_lint.py``'s fsync gate: in the replica and
    the tiered store no write-mode ``open``, no ``os.fsync`` or
    ``os.replace`` and no ``tempfile`` — every durable write goes through
    ``cluster/storage.py``, where the lying disk can cover it."""
    offenders = []
    for node in ast.walk(ast.parse((ROOT / rel).read_text())):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if (name in ("os.fsync", "os.replace")
                    or name.startswith("tempfile.")
                    or _write_mode_open(node)):
                offenders.append(f"{rel}:{node.lineno}: {name}")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names]
            if "tempfile" in mods or getattr(node, "module", None) == \
                    "tempfile":
                offenders.append(f"{rel}:{node.lineno}: import tempfile")
    assert not offenders, "\n".join(offenders)


def test_cluster_package_resolves_its_names_lazily():
    """``raft_tpu_torch.cluster`` exports JAX's ``__all__``; importing the
    package, or its wire and storage seams, loads no ``node.py`` (which
    imports both seams back), and a name of ``__all__`` loads its module
    on first use."""
    import raft_tpu.cluster as jcluster

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import raft_tpu_torch.cluster as c\n"
        "import raft_tpu_torch.cluster.netfault\n"
        "import raft_tpu_torch.cluster.storage\n"
        "import raft_tpu_torch.ckpt.tiered\n"
        "assert 'raft_tpu_torch.cluster.node' not in sys.modules\n"
        "print(sorted(c.__all__))\n"
        "assert c.RaftNode.__module__ == 'raft_tpu_torch.cluster.node'\n"
        "assert c.ClusterBroken.__module__.endswith('.supervisor')\n"
        % str(ROOT)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == str(sorted(jcluster.__all__))


def test_a_cluster_replica_loads_no_torch(tmp_path):
    """A cluster replica is pure host code: the child entry point's
    imports, a ``RaftNode`` that seals segments through the host codec,
    and its restart adopting them load no PyTorch, so no child process
    can open a CUDA context (the supervisor also hides the card)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import raft_tpu_torch.cluster.child\n"
        "from raft_tpu_torch.cluster.node import RaftNode, pack_record\n"
        "from raft_tpu_torch.net import protocol as P\n"
        "peers = {0: 'h:1', 1: 'h:2', 2: 'h:3'}\n"
        "kw = dict(segment_entries=8, hot_entries=16, seed=1)\n"
        "n = RaftNode(1, peers, %r, **kw)\n"
        "recs = [(1, pack_record(b'k%%d' %% i, b'v')) for i in range(60)]\n"
        "(k, pl), = P.FrameDecoder().feed(P.encode_peer_append(\n"
        "    0, term=1, prev_idx=0, prev_term=0, commit=60, round_no=1,\n"
        "    entries=recs))\n"
        "n.on_peer_frame(k, pl)\n"
        "assert n.store.stats['segments_sealed'] >= 1\n"
        "r = RaftNode(1, peers, %r, **kw)\n"
        "assert r.store.stats['segments_adopted'] >= 1 and r.last_idx == 60\n"
        "bad = sorted(m for m in sys.modules if m == 'torch'\n"
        "             or m.startswith('torch.'))\n"
        "print(bad[:5]); sys.exit(1 if bad else 0)\n"
        % (str(ROOT), str(tmp_path), str(tmp_path))
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-I", "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
