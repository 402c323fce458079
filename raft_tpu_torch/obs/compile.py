"""The compile plane (port of ``raft_tpu/obs/compile.py``): program
accounting and the retrace sentinel.

Every performance claim of the fused steady state leans on programs that
are built once and then only launched: the K-tick window is one replay of
a captured CUDA graph, the per-tick programs are bound once per cluster
shape, the kernel libraries are built once per source hash. A silent
rebuild on the hot path would invalidate those numbers without any signal
firing. This module makes the rebuilds visible:

- :class:`CompileWatch` records every program event as a typed
  :class:`CompileRecord` (program label, argument shapes and dtypes,
  elapsed seconds, cache hit or miss), with the counters
  ``raft_compiles_total{program}`` / ``raft_retraces_total{program}`` and
  flight-recorder events, as the JAX plane does.
- There is no ``jax.monitoring`` to subscribe to, so the port emits the
  events itself, on the calling thread, and only while a watch is
  installed:

  - ``trace``: the first call at a labeled seam with a novel signature,
    the counterpart of a jit retrace. The signature is what ``jax.jit``
    keys on: each tensor's (or array's) dtype and shape, the container
    structure (a ``ReplicaState`` renders as ``pytree(8 leaves)``) and the
    type of each Python scalar. The signatures seen are kept process-wide
    per label, as process-wide as the transports' program caches; a
    second call with the same shapes records nothing. ``elapsed_s`` is
    that call's host time.
  - ``compile``: build work done inside a call: a CUDA-graph capture
    (``core.graphs``, ``elapsed_s`` the capture's own seconds) or a
    library build (``cuda_build.build_all`` with ``nvcc``, the
    ``native`` codec with ``g++``).
  - ``cache_hit`` / ``cache_miss``: the kernel library's source-hash
    cache found or missed a built library.
  - There is no ``lower`` event: nothing in the port lowers a program
    between tracing and building it.

- **Program attribution** rides :func:`labeled`, a wrapper at the seams
  that launch the hot-path programs: while a watch is installed, each
  call publishes its label (and its arguments, for lazy shape rendering)
  in a thread-local for the duration of the call, which is when captures
  and builds fire. Detached, the cost is ONE module-list truthiness test
  per launch: no signature is computed, nothing touches the device, and
  the launched callable is the same object either way. A signature first
  seen while no watch was installed therefore reads as a ``trace`` when
  it is first seen under one (JAX's jit cache fills either way).
- :class:`RetraceSentinel` turns any post-``freeze()`` trace/compile on a
  registered hot path into a typed :class:`CompileViolation` (event kind
  ``compile_violation``), exposed to tests as the
  :meth:`RetraceSentinel.assert_no_recompiles` context manager.

Env knob (the JAX plane's): ``RAFT_TPU_COMPILE_SENTINEL=1`` arms the
compile plane in chaos runners as if ``--observe-compile`` was passed.

Importing this module imports no torch and touches no device: the
transports import it on the hot path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

#: The registered hot paths: program labels whose post-freeze
#: trace/compile is a CompileViolation (the JAX plane's list).
DEFAULT_HOT_PATHS = (
    "single.fused",
    "single.replicate",
    "single.replicate_many",
    "single.vote",
    "single.stage",
    "group.replicate",
    "group.vote",
    "group.fused",
    "group_mesh.replicate",
    "group_mesh.vote",
    "group_mesh.fused",
    "tpu_mesh.replicate",
    "tpu_mesh.replicate_many",
    "tpu_mesh.vote",
    "tpu_mesh.fused",
)

UNLABELED = "(unlabeled)"

# ---------------------------------------------------------------- plumbing
#: active watches. The hot-path contract hangs on this list: labeled()
#: wrappers test its truthiness and fall straight through to the wrapped
#: callable when no watch is installed.
_WATCHES: List["CompileWatch"] = []
_TLS = threading.local()
#: label -> the call signatures seen at that seam (process-wide)
_SEEN: Dict[str, set] = {}
_SEEN_LOCK = threading.Lock()


def emit(tag: str, elapsed: float) -> None:
    """Record a ``compile`` / ``cache_hit`` / ``cache_miss`` event against
    the label of the labeled call running on this thread (the build
    sites call this; a no-op with no watch installed)."""
    if not _WATCHES:
        return
    label = getattr(_TLS, "label", None) or UNLABELED
    shapes = None
    args = getattr(_TLS, "args", None)
    if args is not None and tag == "compile":
        shapes = _arg_shapes(args)
    for w in list(_WATCHES):
        w._record(tag, label, elapsed, shapes)


def _dtype_name(dt) -> str:
    """JAX's dtype text: ``int32``, ``float32``, ``bool`` (a torch dtype
    renders as ``torch.int32``)."""
    name = str(dt)
    return name[6:] if name.startswith("torch.") else name


def _is_array(a) -> bool:
    return hasattr(a, "shape") and hasattr(a, "dtype")


def flatten_with_path(tree: Any, path: str = "", out=None, seen=None):
    """(path, leaf) pairs of the array leaves (tensors, numpy arrays) of a
    nested container, with JAX's path text: ``['key']`` for a dict key,
    ``[i]`` for a sequence index, ``.field`` for a named tuple's or
    dataclass's field. Other objects are opaque, as foreign objects are
    leaves of a JAX pytree."""
    if out is None:
        out, seen = [], set()
    if _is_array(tree):
        out.append((path, tree))
        return out
    if not isinstance(tree, (dict, list, tuple)) and not (
            dataclasses.is_dataclass(tree) and not isinstance(tree, type)):
        return out
    if id(tree) in seen:
        return out
    seen.add(id(tree))
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        for k in keys:
            flatten_with_path(tree[k], f"{path}[{k!r}]", out, seen)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            flatten_with_path(v, f"{path}.{f}", out, seen)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flatten_with_path(v, f"{path}[{i}]", out, seen)
    else:
        for f in dataclasses.fields(tree):
            flatten_with_path(getattr(tree, f.name), f"{path}.{f.name}",
                              out, seen)
    return out


def _signature(a):
    """What ``jax.jit`` keys a call on (module doc), hashable."""
    if _is_array(a):
        return (_dtype_name(a.dtype), tuple(a.shape))
    if a is None or isinstance(a, (bool, int, float)):
        return type(a).__name__
    if isinstance(a, str):
        return ("str", a)
    if isinstance(a, dict):
        return ("dict",) + tuple(
            (repr(k), _signature(a[k])) for k in sorted(a, key=repr))
    if isinstance(a, (tuple, list)):
        return (type(a).__name__,) + tuple(_signature(v) for v in a)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return (type(a).__name__,) + tuple(
            _signature(getattr(a, f.name)) for f in dataclasses.fields(a))
    return type(a).__name__


def _arg_shapes(args: tuple) -> List[str]:
    """Compact ``dtype[shape]`` rendering of a call's arguments, in the
    JAX plane's text (computed only when an event fires)."""
    out: List[str] = []
    for a in args:
        if _is_array(a):
            out.append(f"{_dtype_name(a.dtype)}"
                       f"[{','.join(map(str, a.shape))}]")
        elif isinstance(a, (int, float, bool)):
            out.append(type(a).__name__)
        elif isinstance(a, (tuple, list, dict)) or a is None or (
                dataclasses.is_dataclass(a) and not isinstance(a, type)):
            out.append(f"pytree({len(flatten_with_path(a))} leaves)")
        else:
            out.append(type(a).__name__)
    return out[:16]


def active() -> bool:
    """True when at least one CompileWatch is installed."""
    return bool(_WATCHES)


def labeled(label: str, fn, method: bool = False):
    """Wrap a program at the seam that launches it (module doc): while a
    watch is installed, each call publishes ``label`` (and the args, for
    lazy shape rendering) in a thread-local around the underlying call,
    counts the launch, and records a ``trace`` when the call's signature
    is novel for ``label``; with no watch installed the call falls
    straight through. ``method=True`` wraps a function defined in a class
    body: its first argument (the instance) is no part of the signature.
    Wrap where the program is stored, so the wrapper is as process-wide
    as the program it wraps."""
    skip = 1 if method else 0

    def call(*args, **kw):
        if not _WATCHES:
            return fn(*args, **kw)
        prev_label = getattr(_TLS, "label", None)
        prev_args = getattr(_TLS, "args", None)
        shown = args[skip:]
        _TLS.label = label
        _TLS.args = shown
        sig = (tuple(_signature(a) for a in shown),
               tuple((k, _signature(v)) for k, v in sorted(kw.items())))
        seen = _SEEN.setdefault(label, set())
        try:
            for w in _WATCHES:
                w._note_launch(label)
            if sig in seen:
                return fn(*args, **kw)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            elapsed = time.perf_counter() - t0
            with _SEEN_LOCK:
                novel = sig not in seen
                seen.add(sig)
            if novel:
                shapes = _arg_shapes(shown)
                for w in list(_WATCHES):
                    w._record("trace", label, elapsed, shapes)
            return out
        finally:
            _TLS.label = prev_label
            _TLS.args = prev_args

    call.program_label = label
    call.__wrapped__ = fn
    call.__name__ = getattr(fn, "__name__", "call")
    call.__doc__ = getattr(fn, "__doc__", None)
    return call


def labeled_method(label: str):
    """``labeled(label, fn, method=True)`` as a decorator for a method."""
    return lambda fn: labeled(label, fn, method=True)


@contextlib.contextmanager
def program_scope(label: str):
    """Attribute any compile fired inside the block to ``label``: the
    context-manager face of :func:`labeled` for one-off call sites."""
    prev = getattr(_TLS, "label", None)
    _TLS.label = label
    try:
        yield
    finally:
        _TLS.label = prev


# ----------------------------------------------------------------- records
@dataclasses.dataclass(frozen=True)
class CompileRecord:
    """One program event: a trace (novel signature), a compile (graph
    capture or library build), or a library-cache hit/miss."""

    seq: int
    t_wall: float                  # seconds since the watch installed
    program: str                   # label from the wrapper seam
    event: str                     # trace | compile | cache_*
    elapsed_s: float
    arg_shapes: Optional[List[str]] = None
    frozen: bool = False           # fired after the sentinel froze

    def to_jsonable(self) -> dict:
        d = dataclasses.asdict(self)
        if d["arg_shapes"] is None:
            del d["arg_shapes"]
        return d


@dataclasses.dataclass(frozen=True)
class CompileViolation:
    """A post-freeze trace/compile on a registered hot path."""

    seq: int
    t_wall: float
    program: str
    event: str
    elapsed_s: float
    arg_shapes: Optional[List[str]] = None

    def __str__(self) -> str:
        shapes = (
            f" args=({', '.join(self.arg_shapes)})" if self.arg_shapes
            else ""
        )
        return (
            f"post-freeze {self.event} on hot path {self.program!r} "
            f"({self.elapsed_s * 1e3:.1f} ms{shapes})"
        )


class RecompileError(AssertionError):
    """Raised by ``assert_no_recompiles`` when the sentinel tripped."""


# ------------------------------------------------------------------- watch
class CompileWatch:
    """Typed flight recorder for program events (module docstring).

    ``install()``/``uninstall()`` bound the watch's active window; the
    class is also a context manager. All bookkeeping is host-side
    arithmetic on the calling thread (no rng, no device traffic), so
    seeded runs replay byte for byte with the watch on or off."""

    def __init__(self, recorder=None, registry=None,
                 capacity: int = 4096) -> None:
        self.recorder = recorder
        self.registry = registry
        self.capacity = capacity
        self.log: deque = deque(maxlen=capacity)
        self.dropped = 0
        self._next_seq = 0
        self._t0 = time.monotonic()
        self.sentinel: Optional["RetraceSentinel"] = None
        # per-program tallies
        self.traces: Dict[str, int] = {}
        self.compiles: Dict[str, int] = {}
        self.compile_s: Dict[str, float] = {}
        self.launches: Dict[str, int] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self._lock = threading.Lock()

    # --------------------------------------------------------- lifecycle
    def install(self) -> "CompileWatch":
        if self not in _WATCHES:
            self._t0 = time.monotonic()
            _WATCHES.append(self)
        return self

    def uninstall(self) -> None:
        if self in _WATCHES:
            _WATCHES.remove(self)

    @property
    def installed(self) -> bool:
        return self in _WATCHES

    def __enter__(self) -> "CompileWatch":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ----------------------------------------------------------- recording
    def _note_launch(self, label: str) -> None:
        self.launches[label] = self.launches.get(label, 0) + 1

    def _record(self, tag: str, label: str, elapsed: float,
                shapes: Optional[List[str]]) -> None:
        with self._lock:
            self._record_locked(tag, label, elapsed, shapes)

    def _record_locked(self, tag: str, label: str, elapsed: float,
                       shapes: Optional[List[str]]) -> None:
        frozen = self.sentinel is not None and self.sentinel.frozen
        rec = CompileRecord(
            seq=self._next_seq, t_wall=time.monotonic() - self._t0,
            program=label, event=tag, elapsed_s=elapsed,
            arg_shapes=shapes, frozen=frozen,
        )
        self._next_seq += 1
        if len(self.log) == self.capacity:
            self.dropped += 1
        self.log.append(rec)
        if tag == "trace":
            self.traces[label] = self.traces.get(label, 0) + 1
        elif tag == "compile":
            self.compiles[label] = self.compiles.get(label, 0) + 1
            self.compile_s[label] = (
                self.compile_s.get(label, 0.0) + elapsed
            )
        elif tag == "cache_hit":
            self.cache_hits += 1
        elif tag == "cache_miss":
            self.cache_misses += 1
        if self.registry is not None and tag in ("trace", "compile"):
            name = ("raft_retraces_total" if tag == "trace"
                    else "raft_compiles_total")
            self.registry.counter(
                name, "XLA-layer events by program label", ("program",),
            ).inc(program=label)
        if self.recorder is not None and tag in ("trace", "compile"):
            self.recorder.record(
                node="xla", term=0, kind="compile", t_virtual=rec.t_wall,
                program=label, event=tag,
                elapsed_s=round(elapsed, 6), frozen=frozen,
                **({"arg_shapes": shapes} if shapes else {}),
            )
        if self.sentinel is not None:
            self.sentinel._observe(rec)

    # ------------------------------------------------------------ queries
    @property
    def total_traces(self) -> int:
        return sum(self.traces.values())

    @property
    def total_compiles(self) -> int:
        return sum(self.compiles.values())

    @property
    def total_compile_s(self) -> float:
        return sum(self.compile_s.values())

    def events(self, program: Optional[str] = None,
               event: Optional[str] = None) -> List[CompileRecord]:
        out = list(self.log)
        if program is not None:
            out = [r for r in out if r.program == program]
        if event is not None:
            out = [r for r in out if r.event == event]
        return out

    def by_program(self) -> Dict[str, dict]:
        progs = (set(self.traces) | set(self.compiles)
                 | set(self.launches))
        return {
            p: {
                "launches": self.launches.get(p, 0),
                "traces": self.traces.get(p, 0),
                "compiles": self.compiles.get(p, 0),
                "compile_s": round(self.compile_s.get(p, 0.0), 6),
            }
            for p in sorted(progs)
        }

    def snapshot(self) -> dict:
        """The /compile body and the forensics-bundle entry."""
        return {
            "programs": self.by_program(),
            "total_traces": self.total_traces,
            "total_compiles": self.total_compiles,
            "total_compile_s": round(self.total_compile_s, 6),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "dropped": self.dropped,
            "log": [r.to_jsonable() for r in list(self.log)],
            "sentinel": (
                self.sentinel.summary() if self.sentinel is not None
                else None
            ),
        }

    def summary(self) -> dict:
        """The light /status section (no event log)."""
        return {
            "total_traces": self.total_traces,
            "total_compiles": self.total_compiles,
            "total_compile_s": round(self.total_compile_s, 6),
            "violations": (
                len(self.sentinel.violations)
                if self.sentinel is not None else None
            ),
            "frozen": (
                self.sentinel.frozen if self.sentinel is not None
                else None
            ),
        }


# ---------------------------------------------------------------- sentinel
class RetraceSentinel:
    """Freeze-semantics guard over a :class:`CompileWatch`.

    Before ``freeze()`` every compile is warmup and merely recorded.
    After it, any trace/compile whose program label is a registered hot
    path becomes a :class:`CompileViolation`: recorded as an event (kind
    ``compile_violation``), counted in ``raft_compile_violations_total``,
    and surfaced by :meth:`assert_no_recompiles`."""

    def __init__(self, watch: CompileWatch,
                 hot_paths: Tuple[str, ...] = DEFAULT_HOT_PATHS) -> None:
        self.watch = watch
        self.hot_paths = set(hot_paths)
        self.frozen = False
        self.violations: List[CompileViolation] = []
        watch.sentinel = self

    def register_hot_path(self, label: str) -> None:
        self.hot_paths.add(label)

    def freeze(self) -> None:
        """End of warmup: from here every hot-path compile violates."""
        self.frozen = True

    def thaw(self) -> None:
        """Re-open a warmup window (an intentional reshape: a new cluster
        shape, a first recorded-variant launch)."""
        self.frozen = False

    def _observe(self, rec: CompileRecord) -> None:
        if not self.frozen or rec.event not in ("trace", "compile"):
            return
        if rec.program not in self.hot_paths:
            return
        v = CompileViolation(
            seq=rec.seq, t_wall=rec.t_wall, program=rec.program,
            event=rec.event, elapsed_s=rec.elapsed_s,
            arg_shapes=rec.arg_shapes,
        )
        self.violations.append(v)
        w = self.watch
        if w.registry is not None:
            w.registry.counter(
                "raft_compile_violations_total",
                "post-freeze compiles on registered hot paths",
                ("program",),
            ).inc(program=rec.program)
        if w.recorder is not None:
            w.recorder.record(
                node="xla", term=0, kind="compile_violation",
                t_virtual=rec.t_wall, program=rec.program,
                event=rec.event, elapsed_s=round(rec.elapsed_s, 6),
                **({"arg_shapes": rec.arg_shapes}
                   if rec.arg_shapes else {}),
            )

    def summary(self) -> dict:
        return {
            "frozen": self.frozen,
            "hot_paths": sorted(self.hot_paths),
            "violations": [dataclasses.asdict(v) for v in self.violations],
        }

    @contextlib.contextmanager
    def assert_no_recompiles(self, thaw_after: bool = False):
        """Freeze (if not already frozen), run the block, and raise
        :class:`RecompileError` naming every hot-path compile the block
        incurred. Violations from before the block don't count against
        it; they stay recorded."""
        was_frozen = self.frozen
        self.freeze()
        mark = len(self.violations)
        try:
            yield self
        finally:
            if thaw_after and not was_frozen:
                self.frozen = False
        new = self.violations[mark:]
        if new:
            raise RecompileError(
                f"{len(new)} hot-path recompile(s) inside "
                f"assert_no_recompiles():\n  "
                + "\n  ".join(str(v) for v in new)
            )


@contextlib.contextmanager
def assert_no_recompiles(hot_paths: Tuple[str, ...] = DEFAULT_HOT_PATHS):
    """Module-level convenience: install a fresh frozen watch+sentinel for
    the block; ``with obs_compile.assert_no_recompiles(): drive()`` is
    the whole steady-state pin."""
    watch = CompileWatch()
    sentinel = RetraceSentinel(watch, hot_paths=hot_paths)
    with watch:
        with sentinel.assert_no_recompiles():
            yield sentinel
