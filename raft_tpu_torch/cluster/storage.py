"""The storage seam of the cluster tier (port of
``raft_tpu/cluster/storage.py``, its production backend only).

Every durable write of the tiered archive (``ckpt/tiered.py``: segment
shards, CRC sidecars, the manifest) goes through a :class:`RealIO`:
``atomic_write`` (temp file + ``os.replace``), ``read_bytes`` and
``unlink``. The JAX module's append handles and its fault-injecting
``FaultyIO`` come with the rest of the cluster tier (ROADMAP A17).

This module imports nothing of the package, as in the JAX package, so the
tiered store can resolve it lazily.
"""

from __future__ import annotations

import os
import tempfile


def atomic_write(path: str, blob: bytes) -> None:
    """temp file + ``os.replace``: a crash mid-write leaves either the
    old file or the new one under the final name, never a torn half."""
    parent = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class RealIO:
    """The production storage backend: direct OS calls, no faults."""

    def atomic_write(self, path: str, blob: bytes) -> None:
        atomic_write(path, blob)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def unlink(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def is_full(self) -> bool:
        return False
