"""Shared helpers of the port's chaos tests (tests/test_torch_chaos*.py):
run a chaos entry point of either package with the histories its checker
was handed captured, reduce the result to plain values, and cache the JAX
package's runs once a worker (the port's runs are cheap; the JAX runs pay
their compiles). Not a test module (leading underscore: pytest does not
collect it).

A run's ``trace`` is every report field but the live objects (``obs``,
``bundle_path``, the ``repro`` string, which names its package), each
``CheckResult`` as (verdict, steps, key, detail), and every history the
checker saw as one tuple an op: (client, op, key, value, invoke_t,
complete_t, status, read_class, serve_index, ryw_floor). Two runs agree
when their traces are equal: every field, op and virtual time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
from functools import lru_cache

#: environment variables that change what a run does (part of the key of
#: a cached JAX run)
_ENV = ("RAFT_TPU_FUSE_K", "RAFT_TPU_GSHARD", "RAFT_TPU_TIERED_DIR",
        "RAFT_TPU_COMPILE_SENTINEL")


def history_rows(history) -> list:
    return [(r.client, r.op, r.key, r.value, r.invoke_t, r.complete_t,
             r.status, getattr(r, "read_class", None),
             getattr(r, "serve_index", None), getattr(r, "ryw_floor", None))
            for r in history.ops]


def check_tuple(c) -> tuple:
    return (c.verdict, c.steps, c.key, c.detail)


def _plain(v):
    if hasattr(v, "verdict") and hasattr(v, "steps"):
        return check_tuple(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


@contextlib.contextmanager
def capture(runner):
    """Record every history ``runner``'s checker entry points are given
    (``check_history`` and ``check_read_classes``, as the module named
    them at import)."""
    seen = []
    saved = {}
    for name in ("check_history", "check_read_classes"):
        orig = getattr(runner, name)
        saved[name] = orig

        def wrap(history, *a, _orig=orig, **kw):
            seen.append(history_rows(history))
            return _orig(history, *a, **kw)

        setattr(runner, name, wrap)
    try:
        yield seen
    finally:
        for name, orig in saved.items():
            setattr(runner, name, orig)


def trace_of(rep, histories) -> dict:
    out = {f.name: _plain(getattr(rep, f.name))
           for f in dataclasses.fields(rep)
           if f.name not in ("obs", "bundle_path", "repro")}
    out["verdict"] = rep.verdict
    out["repro_args"] = rep.repro.split(".chaos", 1)[1]
    out["histories"] = histories
    return out


def run_traced(package: str, fn: str, *args, **kw) -> tuple:
    """``package.chaos.runner.fn(*args, **kw)`` -> (trace, report)."""
    runner = importlib.import_module(f"{package}.chaos.runner")
    with capture(runner) as seen:
        rep = getattr(runner, fn)(*args, **kw)
    return trace_of(rep, seen), rep


def port_run(fn: str, *args, **kw) -> tuple:
    """The port's run on the CPU -> (trace, report)."""
    return run_traced("raft_tpu_torch", fn, *args, device="cpu", **kw)


@lru_cache(maxsize=None)
def _jax_cached(fn, args, kw, env):
    return run_traced("raft_tpu", fn, *args, **dict(kw))[0]


def jax_run(fn: str, *args, **kw) -> dict:
    """The JAX package's trace of the same call, once a worker."""
    env = tuple(os.environ.get(k) for k in _ENV)
    return _jax_cached(fn, args, tuple(sorted(kw.items())), env)


def assert_same(got: dict, want: dict) -> None:
    """Field by field, so a failure names the first field that differs."""
    assert got.keys() == want.keys()
    for k in want:
        if k == "histories":
            assert len(got[k]) == len(want[k])
            for h_got, h_want in zip(got[k], want[k]):
                assert len(h_got) == len(h_want), "history length"
                for i, (a, b) in enumerate(zip(h_got, h_want)):
                    assert a == b, f"op {i}: {a} != {b}"
        else:
            assert got[k] == want[k], f"{k}: {got[k]!r} != {want[k]!r}"


@contextlib.contextmanager
def env(**values):
    """Set environment variables for a block (None removes one)."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
