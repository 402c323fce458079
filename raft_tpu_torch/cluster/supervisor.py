"""Spawn, kill, pause, and resurrect real replica processes (port of
``raft_tpu/cluster/supervisor.py``).

The supervisor is the harness half of cluster mode: it owns the
cluster spec (ids, ports, dirs, token), launches one
``python -m raft_tpu_torch.cluster.child`` per replica, and exposes the
process-level fault surface the chaos nemeses compose:

- :meth:`kill9` — ``SIGKILL``, the fault the in-process harness could
  never drive: no atexit, no flush, the RAM tail is GONE.
- :meth:`pause` / :meth:`resume` — ``SIGSTOP``/``SIGCONT``: a replica
  that is alive to the TCP stack (connections stay open!) but makes no
  progress — the classic partial-failure the failure detector must
  distinguish from death.
- :meth:`restart` — respawn on the SAME dirs and port: the child
  adopts its previous generation's sealed segments by manifest and
  rejoins via the resumable catch-up stream.
- :meth:`partition` / :meth:`heal` — fold deny-lists into each node's
  polled ``net.json`` fault plan (symmetric deny is just the degenerate
  network fault); the legacy ``ctrl-<id>.json`` alias is still written
  so pre-existing drills and tooling see the same files.
- :meth:`partition_asym` — the one-directional blackhole: the target's
  sends deliver but its receives vanish, the exact shape that wedges a
  send-only leader unless CheckQuorum demotes it.
- :meth:`net_fault` — merge wire-fault keys (latency, trickle, torn,
  dup, corrupt...) into chosen nodes' ``net.json`` mid-run.

**Crash-loop fast-fail** (the test_multiprocess pattern): if
``fast_fail`` consecutive spawns die or fail to report ready within
``min_life_s``, the environment can never work — :class:`ClusterBroken`
is raised immediately so a broken container costs ~3 short failures,
not minutes of the tier-1 budget. Deliberate kills do NOT count; only
spawns that never became ready — and a spawn that published a death
certificate (``death.json``, the disk fail-stop contract) is an
EXPLAINED death, exempt too: the storage drill raises ``fast_fail``
while injecting faults precisely so "recovering under injection" is
never mistaken for "this environment cannot run clusters".
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from raft_tpu_torch.cluster.netfault import merge_net_plan
from raft_tpu_torch.obs import blackbox


class ClusterBroken(Exception):
    """``fast_fail`` consecutive child spawns died young — this
    environment cannot run multi-process clusters; stop burning budget."""


def _free_ports(n: int) -> List[int]:
    """Allocate n distinct loopback ports. The sockets are held open
    until all are chosen (then closed), which closes the worst of the
    bind race; the child binding the EXACT port catches the rest."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


class ClusterSupervisor:
    def __init__(
        self,
        n: int,
        base_dir: str,
        *,
        token: str = "cluster-secret",
        heartbeat_s: float = 0.05,
        election_timeout_s: float = 0.3,
        snap_threshold: Optional[int] = None,
        segment_entries: int = 64,
        hot_entries: int = 256,
        ready_timeout_s: float = 20.0,
        fast_fail: int = 3,
        min_life_s: float = 15.0,
        wal_group_commit: bool = True,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
        tls_ca: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        rendezvous_root: Optional[str] = None,
    ):
        self.n = n
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self.ports = _free_ports(n)
        self.token = token
        self.ready_timeout_s = ready_timeout_s
        self.fast_fail = fast_fail
        self.min_life_s = min_life_s
        self.env = env or {}
        self.procs: Dict[int, Optional[subprocess.Popen]] = {}
        self.spawn_count: Dict[int, int] = {i: 0 for i in range(n)}
        self._young_deaths = 0       # consecutive spawn-never-ready
        self._rendezvous = None
        if rendezvous_root is not None:
            # the supervisor is the one party with POSITIVE death
            # evidence (it reaps what it kills) — publish it as reform
            # death certificates so re-formation skips the staleness
            # guess (transport/reform.py module doc)
            from raft_tpu_torch.transport.reform import Rendezvous

            self._rendezvous = Rendezvous(rendezvous_root, pid=-1)
        self.spec = {
            "nodes": {str(i): f"127.0.0.1:{self.ports[i]}"
                      for i in range(n)},
            "dir": base_dir,
            "token": token,
            "heartbeat_s": heartbeat_s,
            "election_timeout_s": election_timeout_s,
            "snap_threshold": snap_threshold,
            "segment_entries": segment_entries,
            "hot_entries": hot_entries,
            "wal_group_commit": wal_group_commit,
            "tls_cert": tls_cert,
            "tls_key": tls_key,
            "tls_ca": tls_ca,
        }
        self.spec_path = os.path.join(base_dir, "cluster.json")
        with open(self.spec_path, "w") as f:
            json.dump(self.spec, f)

    # -------------------------------------------------------------- info
    def addr(self, i: int) -> str:
        return self.spec["nodes"][str(i)]

    def addr_map(self) -> Dict[str, tuple]:
        """WireClient ``addr_map``: every node's address under its own
        ``host:port`` name, so literal redial hints resolve too."""
        out = {}
        for i in range(self.n):
            host, _, port = self.addr(i).rpartition(":")
            out[self.addr(i)] = (host, int(port))
        return out

    def node_dir(self, i: int) -> str:
        return os.path.join(self.base_dir, f"n{i}")

    def _ready_path(self, i: int) -> str:
        return os.path.join(self.base_dir, f"ready-{i}.json")

    def status(self, i: int) -> Optional[dict]:
        """The node's last self-published status snapshot (the child
        atomically replaces ``status-<i>.json`` every ~0.5 s), or None
        before the first publish. A dead/paused child's snapshot goes
        stale rather than vanishing — read ``alive()`` alongside."""
        try:
            with open(os.path.join(self.base_dir,
                                   f"status-{i}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def leader(self) -> Optional[int]:
        """Best-effort current leader id from the status snapshots."""
        for i in range(self.n):
            s = self.status(i)
            if s and s.get("role") == "leader" and self.alive(i):
                return i
        for i in range(self.n):
            s = self.status(i)
            if s and s.get("leader") is not None:
                return s["leader"]
        return None

    def ready_info(self, i: int) -> Optional[dict]:
        """The child's ready file ({pid, port, generation}) or None."""
        try:
            with open(self._ready_path(i)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def death_certificate(self, i: int) -> Optional[dict]:
        """The node's published fail-stop evidence (``death.json``,
        written by the node itself when fsync reported EIO), or None.
        This is how the harness tells 'the disk is genuinely broken'
        (explained, certificate present) from 'crashed while
        recovering under injection' (unexplained — the crash-loop
        counter's business). Cleared on the next spawn."""
        try:
            with open(os.path.join(self.node_dir(i),
                                   "death.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def alive(self, i: int) -> bool:
        p = self.procs.get(i)
        return p is not None and p.poll() is None

    # ------------------------------------------------------------- spawn
    def spawn(self, i: int, wait_ready: bool = True) -> None:
        if self._young_deaths >= self.fast_fail:
            raise ClusterBroken(
                f"{self._young_deaths} consecutive young child deaths — "
                "multi-process clusters cannot run here"
            )
        for stale in (self._ready_path(i),
                      os.path.join(self.base_dir, f"status-{i}.json"),
                      os.path.join(self.node_dir(i), "death.json")):
            # a prior incarnation's ready/status files must not speak
            # for the new child: readiness keys off the fresh pid, and
            # a status poller must see "no snapshot yet", not the dead
            # process's last commit (which may already satisfy the very
            # watermark the poller is waiting on)
            try:
                os.unlink(stale)
            except OSError:
                pass
        env = dict(os.environ)
        # a replica is a pure host state machine: keep the card out of
        # its sight, so no child opens a CUDA context it does not use
        env.setdefault("CUDA_VISIBLE_DEVICES", "")
        # the child must import raft_tpu_torch no matter the harness cwd
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        pp = env.get("PYTHONPATH", "")
        if repo_root not in pp.split(os.pathsep):
            env["PYTHONPATH"] = (repo_root + os.pathsep + pp
                                 if pp else repo_root)
        env.setdefault("RAFT_TPU_BLACKBOX_DIR",
                       os.path.join(self.base_dir, "blackbox"))
        env.update(self.env)
        self.spawn_count[i] += 1
        if self._rendezvous is not None:
            self._rendezvous.clear_dead(i)   # it's coming back
        blackbox.mark("cluster_spawn", node=i,
                      incarnation=self.spawn_count[i])
        self.procs[i] = subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.cluster.child",
             "--spec", self.spec_path, "--node", str(i)],
            env=env,
            stdout=open(os.path.join(self.base_dir, f"n{i}.out"), "ab"),
            stderr=subprocess.STDOUT,
        )
        if wait_ready:
            self.wait_ready(i)

    def wait_ready(self, i: int) -> None:
        t0 = time.monotonic()
        deadline = t0 + self.ready_timeout_s
        while time.monotonic() < deadline:
            if not self.alive(i):
                break
            try:
                with open(self._ready_path(i)) as f:
                    r = json.load(f)
                if r.get("pid") == self.procs[i].pid:
                    self._young_deaths = 0
                    return
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        # never became ready. A published death certificate from THIS
        # pid is an EXPLAINED fail-stop (the disk lied and the node
        # did the sound thing) — it must not count toward the
        # crash-loop verdict, which exists to catch the UNexplained
        cert = self.death_certificate(i)
        p = self.procs.get(i)
        if cert is not None and p is not None and (
                cert.get("pid") == p.pid):
            blackbox.mark("cluster_fail_stop", node=i,
                          where=cert.get("where"))
            self.kill9(i, count_young=False)
            raise RuntimeError(
                f"node {i} fail-stopped on a disk fault: {cert}")
        # died young or hung past the deadline, with no certificate:
        # a young death for the crash-loop counter
        life = time.monotonic() - t0
        if life < self.min_life_s or not self.alive(i):
            self._young_deaths += 1
        self.kill9(i, count_young=False)
        tail = self.child_log_tail(i)
        if self._young_deaths >= self.fast_fail:
            raise ClusterBroken(
                f"node {i} never became ready ({self._young_deaths} "
                f"consecutive young deaths):\n{tail}"
            )
        raise RuntimeError(f"node {i} never became ready:\n{tail}")

    def start_all(self) -> None:
        for i in range(self.n):
            self.spawn(i, wait_ready=False)
        for i in range(self.n):
            self.wait_ready(i)

    def child_log_tail(self, i: int, n: int = 2000) -> str:
        try:
            with open(os.path.join(self.base_dir, f"n{i}.out"), "rb") as f:
                f.seek(0, 2)
                f.seek(max(0, f.tell() - n))
                return f.read().decode(errors="replace")
        except OSError:
            return "<no child log>"

    # ------------------------------------------------------------- faults
    def kill9(self, i: int, count_young: bool = True) -> None:
        p = self.procs.get(i)
        if p is None:
            return
        blackbox.mark("cluster_kill9", node=i, pid=p.pid)
        try:
            p.send_signal(signal.SIGKILL)
        except ProcessLookupError:
            pass
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        else:
            if self._rendezvous is not None:
                self._rendezvous.declare_dead(i, evidence="waitpid")
        self.procs[i] = None

    def pause(self, i: int) -> None:
        p = self.procs.get(i)
        if p is not None and p.poll() is None:
            blackbox.mark("cluster_pause", node=i, pid=p.pid)
            os.kill(p.pid, signal.SIGSTOP)

    def resume(self, i: int) -> None:
        p = self.procs.get(i)
        if p is not None and p.poll() is None:
            blackbox.mark("cluster_resume", node=i, pid=p.pid)
            os.kill(p.pid, signal.SIGCONT)

    def restart(self, i: int, wait_ready: bool = True) -> None:
        """Kill (if needed) and respawn on the same dirs + port: the
        child adopts the prior generation's sealed segments."""
        if self.alive(i):
            self.kill9(i)
        self.spawn(i, wait_ready=wait_ready)

    def partition(self, groups: List[List[int]]) -> None:
        """Deny-list every pair that crosses a group boundary (the
        userspace partition: no root, heals by file removal). The deny
        set rides each node's ``net.json`` fault plan — a symmetric
        partition is just the degenerate network fault — with the
        legacy ``ctrl-<id>.json`` still written as an alias."""
        side = {i: gi for gi, grp in enumerate(groups) for i in grp}
        for i in range(self.n):
            deny = [j for j in range(self.n)
                    if j != i and side.get(j) != side.get(i)]
            os.makedirs(self.node_dir(i), exist_ok=True)
            merge_net_plan(self.node_dir(i), {"deny": deny})
            path = os.path.join(self.node_dir(i),
                                f"ctrl-{i}.json")
            with open(path, "w") as f:
                json.dump({"deny": deny}, f)
        blackbox.mark("cluster_partition", groups=groups)

    def partition_asym(self, target: int) -> None:
        """One-directional blackhole around ``target``: everything it
        SENDS still delivers, everything sent TO it vanishes. Followers
        keep hearing a live leader (so vote stickiness suppresses
        elections) while the leader hears nothing back — the exact
        asymmetry only CheckQuorum demotion can un-wedge."""
        others = [j for j in range(self.n) if j != target]
        merge_net_plan(self.node_dir(target), {"deny_from": others})
        for j in others:
            merge_net_plan(self.node_dir(j), {"deny_to": [target]})
        blackbox.mark("cluster_partition_asym", target=target)

    def heal(self) -> None:
        for i in range(self.n):
            try:
                os.unlink(os.path.join(self.node_dir(i),
                                       f"ctrl-{i}.json"))
            except OSError:
                pass
            # clear the deny keys but PRESERVE wire-fault keys: healing
            # a partition must not silently lift a latency/corruption
            # nemesis that is part of the same drill
            if os.path.exists(os.path.join(self.node_dir(i),
                                           "net.json")):
                merge_net_plan(self.node_dir(i), {
                    "deny": None, "deny_to": None, "deny_from": None})
        blackbox.mark("cluster_heal")

    def net_fault(self, patch: dict, nodes: Optional[List[int]] = None
                  ) -> None:
        """Merge wire-fault keys into the ``net.json`` plan of the
        given nodes (all by default). ``None`` values delete keys. The
        children poll the plan at ~50 ms, so faults land mid-run
        without restarts — but the seam itself only exists in children
        whose plan file was present at BOOT (write an empty plan before
        :meth:`start_all` to arm it)."""
        for i in (range(self.n) if nodes is None else nodes):
            os.makedirs(self.node_dir(i), exist_ok=True)
            merge_net_plan(self.node_dir(i), patch)
        blackbox.mark("cluster_net_fault", patch=patch,
                      nodes=list(nodes) if nodes is not None else "all")

    # ------------------------------------------------------------ teardown
    def stop_all(self) -> None:
        for i in range(self.n):
            p = self.procs.get(i)
            if p is not None and p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGCONT)   # un-pause first
                except OSError:
                    pass
                p.send_signal(signal.SIGKILL)
        for i in range(self.n):
            p = self.procs.get(i)
            if p is not None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        self.procs = {}
