"""Multihost black-box recorder (port of ``raft_tpu/obs/blackbox.py``):
progress journals + stall watchdog. Journals and stall bundles keep the
JAX package's formats and environment variable.

Every MULTICHIP bench round since r01 that failed did so the same way:
``rc=124`` with nothing in the tail but an xla_bridge warning — the
external kill arrived while the process was blocked inside some
collective, compile, or barrier, and everything it knew died with it.
The flight recorder (obs/events.py) cannot help there: it lives in
memory and is only dumped by code that runs *after* the hang would have
to end.

This module is the crash-and-hang-proof half of the observability
plane, in two parts:

- :class:`BlackboxJournal` — a per-process append-only, **line-flushed**
  progress journal. The rule is *write the mark BEFORE the blocking
  operation*: device enumeration, mesh build, barrier enter/exit,
  allgather launches (with an id), bench phases, tick counts. Each mark
  is one JSON line, flushed to the kernel, so a SIGKILL'd or wedged
  process still leaves a durable record whose LAST line names the phase
  it never finished. The JAX package wires it through its mesh,
  multihost and reform transports and its chaos runners. The port marks
  the same points of its mesh and multihost transports (``mesh_build``,
  ``mesh_ready``, ``allgather`` with a running id on every gathering
  fetch, ``distributed_init``, ``device_enum``) and of the engine's
  mirror digest exchange (``barrier_enter`` / ``barrier_exit``), the
  group mesh's build (``group_mesh_build`` / ``group_mesh_ready``) and
  re-formation's (``reform_enter``, ``reform_propose``, ``reform_done``,
  ``reform_rejoin``, ``await_epoch``, ``await_epoch_done``,
  ``declare_dead``); the chaos runners' wait for ROADMAP A17.

- :class:`StallWatchdog` — a daemon thread that fires when no
  :meth:`StallWatchdog.pet` arrives for ``deadline_s`` seconds: it dumps
  ``faulthandler`` stacks of ALL threads plus the journal tail into a
  repro-bundle-style file (``stall_<tag>_pid<pid>.json``, format
  ``raft_tpu.obs/stall.v1``), mirrors the same forensics to stderr, and
  can hard-exit the process with a chosen code — so a hung 8-device run
  finally reports *which process, which phase, which barrier* instead
  of an empty rc=124.

Components mark through the module-level active journal
(:func:`set_journal` / :func:`mark`): with no journal installed every
mark is a single ``None`` check — the observe-off path costs nothing
and touches no device state.

``python -m raft_tpu_torch.obs --explain`` understands journals (``.jsonl``
files or a directory of them) and stall bundles: it reconstructs the
per-process phase timeline and names the in-flight phase
(:func:`explain_journal`, :func:`explain_stall`).
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

STALL_FORMAT = "raft_tpu.obs/stall.v1"


def resolve_blackbox_dir(blackbox_dir: Optional[str] = None) -> Optional[str]:
    """Destination policy, mirroring ``forensics.resolve_bundle_dir``:
    explicit argument, else ``RAFT_TPU_BLACKBOX_DIR``, else disabled."""
    if blackbox_dir is not None:
        return blackbox_dir
    return os.environ.get("RAFT_TPU_BLACKBOX_DIR") or None


class BlackboxJournal:
    """Append-only, line-flushed progress journal for ONE process.

    Each :meth:`mark` writes one JSON line
    ``{seq, t, mono, pid, proc, phase, ...fields}`` and flushes it to
    the kernel before returning — the write-before-block contract: when
    the next operation hangs forever (or the process is killed), the
    journal already says what it was. No fsync: the threat is process
    death, which kernel buffers survive; OS-crash durability is not
    worth a syscall per allgather on the path being measured.
    Appending (never truncating) means one journal file spans crash-
    restore cycles; ``journal_open`` marks separate the incarnations.
    ``fresh=True`` truncates instead — for fixed-path journals meant to
    hold ONE round (the multichip dryrun), where accreting rounds would
    let ``explain_journal`` merge two runs' timelines into one story.
    """

    def __init__(
        self, path: str, proc: Optional[str] = None, fresh: bool = False,
    ):
        self.path = str(path)
        self.proc = proc or f"pid{os.getpid()}"
        self._lock = threading.Lock()
        self._seq = 0
        self.last_phase: Optional[str] = None
        try:
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "w" if fresh else "a", buffering=1)
        except OSError as ex:
            # Best-effort like every other write in this module: an
            # unwritable destination (read-only dir, another user's
            # leftover /tmp file) must degrade to no journal, never
            # crash the run the journal exists to observe.
            print(
                f"raft_tpu.obs: blackbox journal {self.path!r} not "
                f"writable ({ex}); journaling disabled", file=sys.stderr,
            )
            self._f = None
        self.mark("journal_open", argv=" ".join(sys.argv[:4]))

    def mark(self, phase: str, /, **fields: Any) -> dict:
        """Durably record that ``phase`` is about to run (or just
        happened — the caller picks the tense; blocking operations mark
        BEFORE). Thread-safe; safe after close (silently dropped, so a
        late watchdog or daemon thread cannot crash shutdown)."""
        with self._lock:
            rec = {
                "seq": self._seq,
                "t": round(time.time(), 6),
                "mono": round(time.monotonic(), 6),
                "pid": os.getpid(),
                "proc": self.proc,
                "phase": phase,
            }
            for k, v in fields.items():
                # the envelope is the reader's grouping key (explain
                # groups timelines by (proc, pid)) — a caller field must
                # never clobber it, or one OS process splits into
                # phantom per-"pid" timelines in the post-mortem. The
                # positional-only ``phase, /`` lets even a field named
                # "phase" land here instead of a TypeError crashing the
                # run the journal observes.
                rec[k if k not in rec else f"field_{k}"] = v
            self._seq += 1
            self.last_phase = phase
            if self._f is not None:
                try:
                    self._f.write(json.dumps(rec) + "\n")
                    # flush (no fsync): the threat model is a hung or
                    # SIGKILL'd PROCESS — kernel-buffered data survives
                    # both. fsync would only add OS-crash durability, at
                    # a syscall per mark on the multihost hot path
                    # (every allgather marks) — perturbing the very
                    # measurement this plane exists to take.
                    self._f.flush()
                except (ValueError, OSError):
                    pass      # closed file / full disk: journal is best-effort
        return rec

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self.mark("journal_close")
            self._f.close()


# ------------------------------------------------- module-active journal
_active: Optional[BlackboxJournal] = None


def set_journal(j: Optional[BlackboxJournal]) -> Optional[BlackboxJournal]:
    """Install ``j`` as the process's active journal; returns the
    previous one (callers restore it — see :func:`journal_for`)."""
    global _active
    prev, _active = _active, j
    return prev


def get_journal() -> Optional[BlackboxJournal]:
    return _active


def mark(phase: str, /, **fields: Any) -> None:
    """Mark into the active journal; a no-op (one None check) when no
    journal is installed — the disabled path costs nothing, which is
    why transports and the engine barrier can call this unconditionally."""
    j = _active
    if j is not None:
        j.mark(phase, **fields)


@contextmanager
def journal_for(
    tag: str,
    blackbox_dir: Optional[str] = None,
    proc: Optional[str] = None,
) -> Iterator[Optional[BlackboxJournal]]:
    """Open ``journal_<tag>.jsonl`` under the resolved blackbox dir and
    install it as the active journal for the block; yields None (and
    does nothing) when no destination is configured."""
    bdir = resolve_blackbox_dir(blackbox_dir)
    if bdir is None:
        yield None
        return
    j = BlackboxJournal(os.path.join(bdir, f"journal_{tag}.jsonl"), proc=proc)
    prev = set_journal(j)
    try:
        yield j
    finally:
        set_journal(prev)
        j.close()


# ------------------------------------------------------------- reading
def read_journal(path: str) -> List[dict]:
    """Parse one journal back into its marks, in file order. Torn final
    lines (the process died mid-write) are skipped rather
    than raised — a forensics reader must never choke on the artifact
    of the very crash it is investigating."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out


def journal_tail(path: str, n: int = 40) -> List[dict]:
    return read_journal(path)[-n:]


# ------------------------------------------------------------ watchdog
def _all_thread_stacks() -> str:
    """Python stacks of every live thread via faulthandler (needs a real
    fd, hence the temp file)."""
    try:
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()
    except Exception as ex:            # stack dump must never mask the stall
        return f"<faulthandler dump failed: {ex!r}>"


class StallWatchdog:
    """Fires when no progress (:meth:`pet`) arrives for ``deadline_s``.

    On fire it writes a stall bundle — per-process faulthandler stacks
    of ALL threads, the journal tail, the last journal phase — to
    ``bundle_dir`` (``stall_<tag>_pid<pid>.json``), mirrors the same
    forensics to stderr (so an external log tail carries them even if
    the disk write fails), invokes ``on_fire`` if given, and, when
    ``hard_exit_code`` is set, ``os._exit``s — converting the silent
    external-kill mode (rc=124, parsed: null) into a self-reported
    stall with a full forensic record. Arming, petting and disarming
    are cheap; a clean run that disarms in time writes nothing.
    """

    def __init__(
        self,
        deadline_s: float,
        *,
        tag: str = "run",
        journal: Optional[BlackboxJournal] = None,
        bundle_dir: Optional[str] = None,
        on_fire=None,
        hard_exit_code: Optional[int] = None,
        tail_lines: int = 40,
        poll_s: Optional[float] = None,
    ):
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.deadline_s = float(deadline_s)
        self.tag = tag
        self.journal = journal
        self.bundle_dir = resolve_blackbox_dir(bundle_dir)
        self.on_fire = on_fire
        self.hard_exit_code = hard_exit_code
        self.tail_lines = tail_lines
        self._poll_s = poll_s if poll_s is not None else min(
            0.25, self.deadline_s / 4
        )
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_pet = time.monotonic()
        self.fired = False
        self.bundle_path: Optional[str] = None

    # ------------------------------------------------------------ control
    def arm(self) -> "StallWatchdog":
        self._last_pet = time.monotonic()
        self._thread = threading.Thread(
            target=self._watch, daemon=True,
            name=f"stall-watchdog-{self.tag}",
        )
        self._thread.start()
        return self

    def pet(self) -> None:
        """Progress notification: the deadline restarts from now."""
        self._last_pet = time.monotonic()

    def disarm(self) -> None:
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self) -> "StallWatchdog":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()

    # ------------------------------------------------------------- firing
    def _watch(self) -> None:
        while not self._done.wait(self._poll_s):
            if time.monotonic() - self._last_pet >= self.deadline_s:
                self._fire()
                return

    def _fire(self) -> None:
        if self._done.is_set():
            # a disarm racing a just-expired deadline: the run completed
            # — do not hard-exit it between its last phase and its
            # summary row
            return
        self.fired = True
        stalled_for = time.monotonic() - self._last_pet
        phase = self.journal.last_phase if self.journal is not None else None
        tail = (
            journal_tail(self.journal.path, self.tail_lines)
            if self.journal is not None else []
        )
        stacks = _all_thread_stacks()
        bundle = {
            "format": STALL_FORMAT,
            "kind": "stall",
            "tag": self.tag,
            "pid": os.getpid(),
            "proc": (self.journal.proc if self.journal is not None
                     else f"pid{os.getpid()}"),
            "deadline_s": self.deadline_s,
            "stalled_for_s": round(stalled_for, 3),
            "phase": phase,
            "journal_path": (self.journal.path if self.journal is not None
                             else None),
            "journal_tail": tail,
            "stacks": stacks,
        }
        if self.bundle_dir is not None:
            try:
                Path(self.bundle_dir).mkdir(parents=True, exist_ok=True)
                p = Path(self.bundle_dir) / (
                    f"stall_{self.tag}_pid{os.getpid()}.json"
                )
                p.write_text(json.dumps(bundle))
                self.bundle_path = str(p)
            except OSError as ex:
                print(
                    f"raft_tpu.obs: stall bundle not written to "
                    f"{self.bundle_dir!r}: {ex}", file=sys.stderr,
                )
        # stderr mirror: the external supervisor's log tail must carry the
        # forensics even when the bundle write itself fails
        print(
            f"raft_tpu.obs STALL: {self.tag} pid {os.getpid()} made no "
            f"progress for {stalled_for:.1f}s (deadline {self.deadline_s:g}s)"
            + (f"; blocked phase: {phase}" if phase else "")
            + (f"; bundle: {self.bundle_path}" if self.bundle_path else ""),
            file=sys.stderr,
        )
        print(stacks, file=sys.stderr)
        if self.on_fire is not None:
            try:
                self.on_fire(bundle)
            except Exception:
                pass
        if self.hard_exit_code is not None and not self._done.is_set():
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(self.hard_exit_code)


# ------------------------------------------------------------- explain
def _fmt_fields(rec: dict) -> str:
    skip = {"seq", "t", "mono", "pid", "proc", "phase"}
    kv = {k: v for k, v in rec.items() if k not in skip}
    return (" " + " ".join(f"{k}={v}" for k, v in kv.items())) if kv else ""


def explain_journal(paths: Sequence[str]) -> str:
    """Reconstruct the per-process phase timeline from one or more
    journals: each mark with its offset from incarnation start and the
    time spent until the NEXT mark; the final mark of each incarnation
    is flagged as in flight — for a hung run that line IS the diagnosis
    (which process, which phase, which barrier). An append-mode journal
    holds one incarnation per ``journal_open`` (a killed run followed by
    a re-run of the same seed appends a second); each is rendered as its
    own timeline, so an earlier wedged incarnation keeps its in-flight
    flag and no duration spans the gap between runs."""
    out: List[str] = []
    for path in paths:
        recs = read_journal(path)
        if not recs:
            out.append(f"{path}: empty or unreadable journal")
            continue
        by_proc: Dict[tuple, List[dict]] = {}
        for r in recs:
            by_proc.setdefault((r.get("proc"), r.get("pid")), []).append(r)
        out.append(f"{path}:")
        for (proc, pid), marks in by_proc.items():
            runs: List[List[dict]] = []
            for r in marks:
                if r.get("phase") == "journal_open" or not runs:
                    runs.append([])
                runs[-1].append(r)
            for run_no, run in enumerate(runs):
                t0 = run[0].get("mono", 0.0)
                tag = f", incarnation {run_no}" if len(runs) > 1 else ""
                out.append(
                    f"  process {proc} (pid {pid}{tag}): {len(run)} marks"
                )
                for i, r in enumerate(run):
                    dt = r.get("mono", 0.0) - t0
                    if i + 1 < len(run):
                        held = run[i + 1].get("mono", 0.0) - r.get("mono", 0.0)
                        dur = f"{held:8.3f}s"
                        flag = ""
                    else:
                        dur = "        "
                        flag = (
                            ""
                            if r.get("phase") == "journal_close"
                            else "   <== in flight at journal end"
                        )
                    out.append(
                        f"    +{dt:9.3f}s  {dur}  "
                        f"{r.get('phase')}{_fmt_fields(r)}{flag}"
                    )
    return "\n".join(out)


def explain_merged(paths: Sequence[str], limit: int = 400) -> str:
    """The MERGED cross-process timeline: every mark from every journal
    interleaved on the shared wall clock (``t`` — the one field
    comparable across processes; ``mono`` restarts with each
    incarnation and never crosses a pid). This is the forensics view a
    multi-process drill needs — ``kill -9`` lands in the supervisor's
    journal, the last gasp in the victim's, the re-election in a
    peer's, and only side by side do they read as one story. Each line
    carries its offset from the EARLIEST mark across all journals plus
    the owning process (``proc[pid]``), so an incarnation change shows
    up as the same proc under a new pid. ``limit`` caps the render from
    the tail (the interesting end of a crashed run), with an elision
    line saying how many earlier marks were folded."""
    recs: List[dict] = []
    for path in paths:
        recs.extend(read_journal(path))
    recs = [r for r in recs if "t" in r]
    if not recs:
        return "no marks in any journal"
    recs.sort(key=lambda r: (r.get("t", 0.0), r.get("pid", 0),
                             r.get("seq", 0)))
    t0 = recs[0]["t"]
    out = [f"merged timeline ({len(recs)} marks, "
           f"{len(set((r.get('proc'), r.get('pid')) for r in recs))} "
           f"process incarnations):"]
    if len(recs) > limit:
        out.append(f"  ... {len(recs) - limit} earlier marks elided")
        recs = recs[-limit:]
    width = max(len(str(r.get("proc"))) for r in recs)
    for r in recs:
        out.append(
            f"  +{r['t'] - t0:9.3f}s  "
            f"{str(r.get('proc')):<{width}} [{r.get('pid')}]  "
            f"{r.get('phase')}{_fmt_fields(r)}"
        )
    return "\n".join(out)


def explain_stall(bundle: dict) -> str:
    """The stall bundle's failure story: who stalled, in which phase,
    the journal tail leading up to it, and every thread's stack."""
    out = [
        f"STALL: {bundle.get('tag')} — process {bundle.get('proc')} "
        f"(pid {bundle.get('pid')}) made no progress for "
        f"{bundle.get('stalled_for_s')}s "
        f"(deadline {bundle.get('deadline_s')}s)",
        f"blocked phase: {bundle.get('phase') or '<no journal attached>'}",
    ]
    tail = bundle.get("journal_tail") or []
    if tail:
        t0 = tail[0].get("mono", 0.0)
        out.append(f"journal tail ({len(tail)} marks, "
                   f"{bundle.get('journal_path')}):")
        for r in tail:
            out.append(
                f"  +{r.get('mono', 0.0) - t0:9.3f}s  "
                f"{r.get('phase')}{_fmt_fields(r)}"
            )
        out.append("  (last mark is the operation that never completed)")
    if bundle.get("stacks"):
        out.append("thread stacks at fire time:")
        out.append(bundle["stacks"].rstrip())
    return "\n".join(out)
