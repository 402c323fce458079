"""Launch annotations for profiler captures (port of
``raft_tpu/obs/profiling.py:85`` ``launch_annotation``).

The engine wraps each launch boundary (the per-tick replicate) in
``launch_annotation``: a ``torch.profiler.record_function`` named for the
launch while a capture is active, so a trace segments by launch, and the
shared null context otherwise — the detached cost is one module-bool test
per launch, no device traffic. ``annotating()`` marks a capture active
around a block (a caller that runs ``torch.profiler`` over engine ticks).
The on-demand capture (``/profile``) and the timeline merge of the JAX
module wait for ROADMAP A16b.
"""

from __future__ import annotations

import contextlib

_capture_active = False
#: shared detached context: nullcontext is stateless and reentrant
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def annotating():
    """Annotate every launch inside the block (not reentrant across
    threads: one capture at a time, as in the JAX package)."""
    global _capture_active
    prior, _capture_active = _capture_active, True
    try:
        yield
    finally:
        _capture_active = prior


def launch_annotation(name: str, step: int):
    """A ``record_function`` span ``"{name}#{step}"`` while a capture is
    active, else the shared detached nullcontext."""
    if not _capture_active:
        return _NULL
    import torch

    return torch.profiler.record_function(f"{name}#{step}")
