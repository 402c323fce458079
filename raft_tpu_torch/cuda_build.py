"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. All sources build in parallel on first
use into ``build/raft_tpu_torch/`` beside the package (override with
``RAFT_TPU_TORCH_BUILD_DIR``); a library's file name carries a hash of its
sources, so an edited kernel is rebuilt and a current one is reused.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: library name -> its translation unit (headers are hashed into every one)
SOURCES = {"ring": "ring.cu", "steady": "steady.cu", "ec": "ec.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures of the exported launchers
SIGNATURES = {
    "ring": {
        "rt_error_string": ([_I], ctypes.c_char_p),
        "rt_write_window_both": ([_P] * 10 + [_I] * 5 + [_P], _I),
        "rt_write_window_cols": ([_P] * 5 + [_I] * 5 + [_P], _I),
    },
    "steady": {
        "rt_error_string": ([_I], ctypes.c_char_p),
        "rt_steady_step": (
            [_P] * 5 + [_I] + [_P] * 3 + [_I] * 12 + [_P] * 3
            + [_I, _I, _P, _P],
            _I),
        "rt_steady_pipeline": (
            [_P] * 5 + [_I, _I] + [_P] * 3 + [_I] * 14 + [_P] * 3
            + [_I, _I] + [_P] * 3,
            _I),
        "rt_turnover": ([_P] * 4 + [_I] * 9 + [_P] * 3 + [_I, _P], _I),
        "rt_turnover_mesh": ([_P] * 4 + [_I] * 9 + [_P] * 2 + [_I] * 2
                             + [_P], _I),
    },
    "ec": {
        "rt_error_string": ([_I], ctypes.c_char_p),
        "rt_gf_apply": ([_P, _P] + [_I] * 4 + [_P, _I, _I, _P] + [_I] * 5
                        + [_P], _I),
    },
}

_libs: dict = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("RAFT_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent / "build" / "raft_tpu_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in [SOURCES[name]] + sorted(p.name for p in CSRC.glob("*.cuh")):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest(name)}.so"


def build_all() -> dict:
    """Compile every library that is missing, all ``nvcc`` runs started
    together. Returns {"seconds": wall seconds, "logs": {library: nvcc
    output}} (empty logs when nothing was missing); raises on a failed
    build."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {"seconds": 0.0, "logs": {}}
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = out / f"lib{n}-{_digest(n)}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors, logs = [], {}
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[n] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]}:\n{log}")
            continue
        os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use)."""
    with _lock:
        if name not in _libs:
            build_all()
            cdll = ctypes.CDLL(str(_lib_path(name)))
            for fn, (args, res) in SIGNATURES[name].items():
                f = getattr(cdll, fn)
                f.argtypes = args
                f.restype = res
            _libs[name] = cdll
        return _libs[name]


def check(name: str, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib(name).rt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
