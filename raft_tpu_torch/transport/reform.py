"""Process-group re-formation: the elastic-recovery loop for multihost
(port of ``raft_tpu/transport/reform.py``; host code).

``transport/multihost.py`` states the recovery contract of a mirrored
multi-process cluster: detection is a progress watchdog (the bounded
digest exchange), re-formation is a restart into a fresh process group
over the processes that remain, and state comes from stable storage.
This module is the agreement an N >= 3 cluster needs for that restart:
**who survived, who coordinates the next process group, and which
checkpoint the new epoch restores from**, plus the rejoin path of a
process that comes back.

The agreement medium is a shared **rendezvous directory** on common
storage, the stand-in for a deployment's supervisor or config service.
The files are the JAX package's, byte for byte, so processes of either
package can share one directory:

- Every process writes a *heartbeat* ``hb-{pid}.json`` = {time, beat,
  epoch, round, wm, ckpt} each committed round: the failure detector's
  evidence and the checkpoint directory.
- Epochs are numbered process-group generations. ``epoch-{n}.json``
  (atomic, write-once) fixes the new generation: its members, the
  coordinator address, the checkpoint to restore and the dead replica
  rows. The address is ``host:port``; ``Epoch.init_method`` gives it as
  the ``tcp://`` rendezvous of ``torch.distributed.init_process_group``
  (``multihost.initialize_multihost``; re-formation is held over gloo
  only), where the JAX package hands it to ``jax.distributed``.
- **Coordinator derivation**: the lowest fresh pid proposes the next
  epoch, a rule every survivor evaluates alike; write-once epoch files
  make a racing duplicate harmless (first link wins).
- **Checkpoint election**: the fresh checkpoint with the HIGHEST
  watermark. Every process acks only entries its own checkpoint covers,
  and mirrors commit identical prefixes, so that checkpoint covers every
  acked entry: the durability fence holds across re-formation.
- **Rejoin**: a restarted process writes ``join-{pid}`` and waits; the
  coordinator folds it into the next epoch. A survivor excluded from a
  newly published epoch (its heartbeat went stale while it was wedged)
  takes the same path.

**Death certificates**: ``declare_dead`` publishes a supervisor's
positive evidence (it reaped the process) as ``dead-{pid}.json`` stamped
with the victim's last ``beat``; ``fresh_peers`` drops certified pids at
once, ``reform`` skips its settle window when every missing member is
certified, and a heartbeat whose ``beat`` progresses past the
certificate retires it (a false positive).

**Failure detector (one clock domain)**: freshness comes from each
writer's stamp PROGRESSION as the observer sees it on its own
``time.monotonic()``: a peer is fresh iff its (beat, stamp) pair changed
within the last ``stale_s`` of observation. No cross-host clock is ever
compared, so wall-clock skew or an NTP step cannot mis-detect. A peer
seen for the first time counts as fresh until ``stale_s`` passes without
progression. Deadline loops run on ``time.monotonic()`` too.
"""

from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from raft_tpu_torch.obs import blackbox


def _atomic_write(path: str, payload: dict) -> bool:
    """Write-once atomic JSON publish: False if ``path`` already exists
    (or appears concurrently — os.link semantics make the publish
    exclusive even when two proposers race)."""
    if os.path.exists(path):
        return False
    # unique tmp per attempt: pid alone collides for two writers in one
    # process (threads) or across pid reuse after a kill
    import uuid

    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, path)          # fails if a racer published first
        return True
    except FileExistsError:
        return False
    finally:
        os.unlink(tmp)


@dataclass
class Epoch:
    n: int
    members: List[int]              # original process ids, sorted
    coord: str                      # coordinator address, host:port
    ckpt: Optional[str]             # checkpoint to restore (None: fresh)
    dead_rows: List[int] = field(default_factory=list)

    @property
    def num_processes(self) -> int:
        return len(self.members)

    @property
    def init_method(self) -> str:
        """The coordinator as ``torch.distributed``'s rendezvous URL
        (``transport.multihost.initialize_multihost``'s first argument)."""
        return f"tcp://{self.coord}"

    def process_id(self, pid: int) -> int:
        return self.members.index(pid)


class Rendezvous:
    """One process's handle on the shared re-formation directory."""

    def __init__(self, root: str, pid: int):
        self.root = root
        self.pid = pid
        os.makedirs(root, exist_ok=True)
        self._beats = 0
        self._seen: Dict[int, tuple] = {}
        #   pid -> ((beat, stamp), monotonic time this observer first saw
        #   that exact pair) — the progression detector's whole state
        #   (see fresh_peers / the module-doc failure-detector note)

    # ---- heartbeats ----------------------------------------------------
    def heartbeat(self, epoch: int, round_no: int, wm: int,
                  ckpt: Optional[str]) -> None:
        path = os.path.join(self.root, f"hb-{self.pid}.json")
        tmp = path + ".tmp"
        self._beats += 1
        with open(tmp, "w") as f:
            # ``beat`` is the progression counter freshness derives from
            # (it advances even if the wall clock is frozen or stepped
            # backward); ``time`` is kept for humans reading the files
            json.dump({"time": time.time(), "beat": self._beats,
                       "epoch": epoch, "round": round_no, "wm": wm,
                       "ckpt": ckpt}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def my_heartbeat(self) -> Optional[dict]:
        """This process's last published heartbeat (stale or not) — the
        restart path reads it to learn which epoch it last participated
        in and which checkpoint it last fenced acks behind."""
        path = os.path.join(self.root, f"hb-{self.pid}.json")
        try:
            return json.load(open(path))
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def fresh_peers(self, stale_s: float) -> Dict[int, dict]:
        """pids (self included) whose heartbeat PROGRESSED within the
        last ``stale_s`` seconds of this observer's ``time.monotonic()``
        — the failure detector's survivor estimate.

        Progression, not wall-clock age: the observer remembers each
        writer's last distinct (beat, stamp) pair and when it saw it on
        its OWN monotonic clock; a peer is fresh iff the pair changed
        within the window. No cross-host clock comparison — skew of any
        magnitude cannot mis-detect (module-doc failure-detector note).
        A writer seen for the first time counts as fresh from that
        sighting: detection of an already-dead peer costs at most one
        staleness window of observation, which is the bounded price of
        skew immunity."""
        now = time.monotonic()
        out: Dict[int, dict] = {}
        for f in os.listdir(self.root):
            # exact-shape match: a concurrent writer's hb-N.json.tmp must
            # not be parsed (os.replace makes the .json itself atomic)
            if not (f.startswith("hb-") and f.endswith(".json")):
                continue
            try:
                hb = json.load(open(os.path.join(self.root, f)))
            except (json.JSONDecodeError, OSError):
                continue                      # torn concurrent write
            pid = int(f[3:-5])
            mark = (hb.get("beat"), hb["time"])
            seen = self._seen.get(pid)
            if seen is None or seen[0] != mark:
                self._seen[pid] = (mark, now)     # progressed: stamp NOW
                out[pid] = hb
            elif now - seen[1] <= stale_s:
                out[pid] = hb                     # unchanged but recent
        # positive evidence overrides recency: a certified-dead peer is
        # out NOW (no staleness wait) — unless its beat progressed past
        # the certificate, which proves the declaration stale
        for pid, cert in self.declared_dead().items():
            hb = out.get(pid)
            if (hb is not None and cert.get("beat") is not None
                    and (hb.get("beat") or 0) > cert["beat"]):
                self.clear_dead(pid)              # false positive: retire
            else:
                out.pop(pid, None)
        return out

    # ---- death certificates (positive evidence) ------------------------
    def declare_dead(self, pid: int, evidence: str = "waitpid") -> None:
        """Publish positive death evidence for member ``pid`` (module
        doc, death certificates): the caller REAPED the process or
        otherwise knows it is gone — not a staleness guess. Stamped
        with the victim's last published ``beat`` so a later heartbeat
        that progresses past it can prove the certificate stale."""
        hb = None
        try:
            hb = json.load(open(os.path.join(self.root,
                                             f"hb-{pid}.json")))
        except (OSError, json.JSONDecodeError):
            pass
        path = os.path.join(self.root, f"dead-{pid}.json")
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"time": time.time(), "evidence": evidence,
                       "beat": None if hb is None else hb.get("beat"),
                       "by": self.pid}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        blackbox.mark("declare_dead", rv_pid=self.pid, dead=pid,
                      evidence=evidence)

    def declared_dead(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for f in os.listdir(self.root):
            if f.startswith("dead-") and f.endswith(".json"):
                try:
                    out[int(f[5:-5])] = json.load(
                        open(os.path.join(self.root, f)))
                except (OSError, ValueError):
                    continue
        return out

    def clear_dead(self, pid: int) -> None:
        try:
            os.unlink(os.path.join(self.root, f"dead-{pid}.json"))
        except FileNotFoundError:
            pass

    # ---- epochs --------------------------------------------------------
    def latest_epoch(self) -> Optional[Epoch]:
        best = None
        for f in os.listdir(self.root):
            if f.startswith("epoch-") and f.endswith(".json"):
                n = int(f[6:-5])
                if best is None or n > best:
                    best = n
        if best is None:
            return None
        d = json.load(open(os.path.join(self.root, f"epoch-{best}.json")))
        return Epoch(n=best, members=sorted(d["members"]),
                     coord=d["coord"], ckpt=d.get("ckpt"),
                     dead_rows=d.get("dead_rows", []))

    def publish_epoch(self, n: int, members: List[int],
                      ckpt: Optional[str],
                      dead_rows: List[int]) -> Optional[Epoch]:
        """Publish epoch ``n`` (write-once). The coordinator address is a
        freshly bound localhost port; the ``torch.distributed`` TCP store
        is hosted by rank 0 — i.e. ``sorted(members)[0]`` — so on a real
        fabric the address host must be that member's hostname (a
        localhost cluster makes every choice valid). The
        probe-then-close port pick is TOCTOU:
        another process can take the port before the coordinator binds
        it. That failure is SELF-HEALING, not permanent — the epoch's
        members fail ``initialize`` (bounded timeout), their supervisors
        restart them into the reform path (each entry attempt first
        heartbeats its target epoch, so a re-entry loop cannot form),
        and the next proposal mints a fresh port in epoch ``n+1``.
        Returns None if a racer published first (caller re-reads)."""
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        coord = f"127.0.0.1:{port}"
        ep = {"members": sorted(members), "coord": coord, "ckpt": ckpt,
              "dead_rows": sorted(dead_rows)}
        if _atomic_write(os.path.join(self.root, f"epoch-{n}.json"), ep):
            return Epoch(n=n, members=sorted(members), coord=coord,
                         ckpt=ckpt, dead_rows=sorted(dead_rows))
        return None

    def propose_next_epoch(self, prev: Epoch, survivors: Dict[int, dict],
                           joiners: List[int]) -> Optional[Epoch]:
        """Coordinator-side epoch bump: members = fresh survivors of the
        previous epoch plus any joiners; dead rows = rows of members that
        did NOT survive (row == original pid, the initial placement
        convention) minus rows coming back; checkpoint = the survivor
        checkpoint with the highest watermark (see module doc)."""
        alive = sorted(set(survivors) & set(prev.members))
        members = sorted(set(alive) | set(joiners))
        dead = sorted(
            (set(prev.members) | set(prev.dead_rows)) - set(members)
        )
        best_ckpt, best_wm = None, -1
        for p in alive:
            hb = survivors[p]
            if hb.get("ckpt") and hb.get("wm", -1) > best_wm:
                best_ckpt, best_wm = hb["ckpt"], hb["wm"]
        return self.publish_epoch(prev.n + 1, members, best_ckpt, dead)

    def is_coordinator(self, survivors: Dict[int, dict],
                       members: Optional[List[int]] = None) -> bool:
        """Deterministic coordinator derivation: lowest fresh pid —
        restricted to the current epoch's ``members`` when given, so a
        waiting joiner (fresh but not a member) can never self-elect."""
        pool = set(survivors)
        if members is not None:
            pool &= set(members)
        return bool(pool) and min(pool) == self.pid

    # ---- joins ---------------------------------------------------------
    def request_join(self) -> None:
        _atomic_write(
            os.path.join(self.root, f"join-{self.pid}.json"),
            {"time": time.time()},
        )

    def pending_joins(self, members: List[int],
                      stale_s: Optional[float] = None) -> List[int]:
        """Join requests from non-members. With ``stale_s``, only joiners
        with a FRESH heartbeat count (a waiting joiner heartbeats in
        ``await_epoch_including_me``) — a leftover join file from a
        process that died again must not be folded into an epoch it can
        never connect to."""
        fresh = None if stale_s is None else self.fresh_peers(stale_s)
        out = []
        for f in os.listdir(self.root):
            if f.startswith("join-") and f.endswith(".json"):
                p = int(f[5:-5])
                if p in members:
                    self.clear_join(p)      # folded in: retire the file
                elif fresh is None or p in fresh:
                    out.append(p)
        return sorted(out)

    def clear_join(self, pid: int) -> None:
        try:
            os.unlink(os.path.join(self.root, f"join-{pid}.json"))
        except FileNotFoundError:
            pass

    def await_epoch_including_me(self, after: int = 0,
                                 timeout_s: float = 600.0,
                                 poll_s: float = 0.3,
                                 hb: Optional[dict] = None) -> Epoch:
        """Block until an epoch newer than ``after`` lists this pid as a
        member, heartbeating meanwhile so the failure detector keeps
        counting this process as alive. ``hb`` carries the last known
        {round, wm, ckpt} so the re-published heartbeat stays a valid
        candidate in the checkpoint election (clobbering it with
        placeholders could silently drop the max-watermark checkpoint
        from the next epoch's restore choice)."""
        hb = hb or {}
        # write-before-block (obs.blackbox): this wait can legitimately
        # run to its full timeout — the journal says which epoch the
        # process was waiting past when an external kill arrives
        blackbox.mark("await_epoch", rv_pid=self.pid, after=after,
                      timeout_s=timeout_s)
        # monotonic deadline (ADVICE r5 #1): a wall-clock step must not
        # expire the wait early or extend it indefinitely
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ep = self.latest_epoch()
            if ep is not None and ep.n > after and self.pid in ep.members:
                self.clear_join(self.pid)
                blackbox.mark("await_epoch_done", rv_pid=self.pid, epoch=ep.n)
                return ep
            self.heartbeat(after, hb.get("round", -1), hb.get("wm", -1),
                           hb.get("ckpt"))
            time.sleep(poll_s)
        raise TimeoutError(
            f"pid {self.pid}: no epoch after {after} included me"
        )

    def reform(self, cur: Epoch, stall_s: float, joiners: List[int] = (),
               timeout_s: float = 600.0, hb: Optional[dict] = None) -> Epoch:
        """Drive one re-formation to completion: wait out heartbeat
        staleness, derive the coordinator from the fresh set, propose the
        next epoch if that is this process, and return the first epoch
        newer than ``cur`` that includes this pid. Safe for every
        survivor to call concurrently — non-coordinators just wait, a
        lost proposal race falls through to the published epoch, and the
        coordinator re-derivation loop covers the case where the
        would-be coordinator is itself dead (its heartbeat goes stale
        and the next-lowest survivor takes over)."""
        hb = hb or {}
        blackbox.mark("reform_enter", rv_pid=self.pid, epoch=cur.n,
                      stall_s=stall_s, timeout_s=timeout_s)
        deadline = time.monotonic() + timeout_s
        seen, seen_at = None, time.monotonic()
        settle_s = 6.0
        while time.monotonic() < deadline:
            ep = self.latest_epoch()
            if ep is not None and ep.n > cur.n:
                if self.pid in ep.members:
                    blackbox.mark("reform_done", rv_pid=self.pid, epoch=ep.n)
                    return ep
                # A newer epoch EXCLUDED this survivor: its heartbeat went
                # stale past the detector window while it was wedged (GC
                # pause, storage stall, clock skew — module doc). Spinning
                # here on proposals derived from ``cur`` can never
                # succeed — ``cur.n + 1`` is already taken, and the new
                # epoch's members owe a silent non-member nothing. Take
                # the rejoin path instead: announce the join and wait to
                # be folded into a following epoch (the coordinator sees
                # the fresh join on its next round).
                blackbox.mark("reform_rejoin", rv_pid=self.pid,
                              excluded_by=ep.n)
                self.request_join()
                return self.await_epoch_including_me(
                    after=ep.n,
                    timeout_s=max(deadline - time.monotonic(), 1.0),
                    hb=hb,
                )
            self.heartbeat(cur.n, hb.get("round", -1), hb.get("wm", -1),
                           hb.get("ckpt"))
            fresh = self.fresh_peers(stall_s)
            # settle window: the fresh set must hold still before the
            # derived coordinator proposes, so two survivors re-exec'ing
            # a second apart converge on the SAME survivor set instead of
            # the faster one forming a smaller epoch without the other
            key = tuple(sorted(fresh))
            if key != seen:
                seen, seen_at = key, time.monotonic()
            # death-driven short-circuit: when every missing member is
            # covered by a death certificate, the survivor set is not a
            # guess that needs to hold still — it is reaped fact, and
            # the settle window would only delay recovery
            missing = set(cur.members) - set(fresh)
            certified = missing and missing <= set(self.declared_dead())
            settle = 0.0 if certified else settle_s
            if (
                self.is_coordinator(fresh, cur.members)
                and time.monotonic() - seen_at >= settle
            ):
                blackbox.mark("reform_propose", rv_pid=self.pid,
                              next_epoch=cur.n + 1,
                              survivors=sorted(fresh),
                              death_driven=bool(certified))
                self.propose_next_epoch(cur, fresh, list(joiners))
            time.sleep(0.5)
        raise TimeoutError(f"pid {self.pid}: re-formation stalled")
