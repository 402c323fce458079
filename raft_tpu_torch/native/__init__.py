"""ctypes bindings of the host RS codec ``rs_codec.cpp`` (port of
``raft_tpu/native``).

The library is built with ``g++ -O3 -shared -fPIC`` on first use into the
port's build directory (``cuda_build.build_dir()``, ``build/raft_tpu_torch``
beside the package), under a name that carries a hash of the source, so an
edited source is rebuilt and a current one is reused. The build compiles to
a temporary name and renames it into place, so processes that build at the
same moment never load a half-written library. A build is a ``compile``
event of the compile plane (``obs.compile``) when a watch is installed.

There is no fallback: where the JAX package returns ``None`` and its
callers take the NumPy oracle when ``g++`` or the library is missing, the
port raises, naming the build failure. ``ec.rs.RSCode.encode`` /
``decode`` stay the plain versions the tests compare with.
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

import numpy as np

SRC = Path(__file__).resolve().parent / "rs_codec.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """The host codec could not be built or loaded."""


def lib_path() -> Path:
    from raft_tpu_torch.cuda_build import build_dir

    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"librs_codec-{h.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            "g++ not found: the host RS codec (raft_tpu_torch/native/"
            "rs_codec.cpp) is built with g++ on first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp.so")
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as ex:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ could not build {SRC.name}: {ex}") \
            from ex
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed for {SRC.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The codec library, built on first use; raises
    :class:`NativeBuildError` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from raft_tpu_torch.obs import compile as obs_compile

        path = lib_path()
        if not path.exists():
            t0 = time.perf_counter()
            _build(path)
            obs_compile.emit("compile", time.perf_counter() - t0)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as ex:
            raise NativeBuildError(f"cannot load {path}: {ex}") from ex
        lib.rs_apply_matrix.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_long,
        ]
        lib.rs_apply_matrix.restype = None
        lib.rs_gf_mul.argtypes = [ctypes.c_uint8, ctypes.c_uint8]
        lib.rs_gf_mul.restype = ctypes.c_uint8
        _lib = lib
        return _lib


def apply_matrix(matrix: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """out[r] = XOR_c mul(matrix[r, c], rows[c]) on the C++ codec.

    ``rows``: u8[in_rows, ...] (trailing dims flattened); returns
    u8[out_rows, ...]."""
    lib = load()
    matrix = np.ascontiguousarray(matrix, np.uint8)
    rows_c = np.ascontiguousarray(rows, np.uint8)
    out_rows, in_rows = matrix.shape
    if rows_c.shape[0] != in_rows:
        raise ValueError(f"{rows_c.shape[0]} input rows for a matrix of "
                         f"{in_rows} columns")
    row_bytes = int(rows_c[0].size)
    out = np.empty((out_rows,) + rows_c.shape[1:], np.uint8)
    lib.rs_apply_matrix(
        rows_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        in_rows,
        out_rows,
        row_bytes,
    )
    return out


def gf_mul(a: int, b: int) -> int:
    return int(load().rs_gf_mul(a, b))
