"""The memory plane (port of ``raft_tpu/obs/memory.py``): a live-tensor
census, leak detection, and the in-place (donation) audit.

The fused steady state writes the cluster's rings in place at every
launch, a crash-restore cycle rebuilds engines, ``migrate_group`` permutes
whole device slots, and on the card every transport keeps CUDA graphs with
their own memory pool: any of these could leak device memory silently.

- :meth:`MemoryWatch.census` walks the garbage collector's objects for
  live torch tensors, metadata only (no device sync, no copy), and
  buckets them by STORAGE: a view, or a state leaf that is also a graph's
  static buffer, shares its base's storage and is counted once, under the
  dtype and shape of the tensor that covers the storage. Storages matched
  to a registered root's leaves (:meth:`register_root` /
  :meth:`watch_engine`) bucket under the leaf's label
  (``engine.state.log_payload``, the JAX plane's path text); the rest
  bucket by ``dtype[shape]``. Roots are matched by storage, not by
  Python identity: a ring written in place keeps its storage through
  every path, not always its tensor object.
- On a CUDA device the census also carries the caching allocator's view
  of that device (``torch.cuda.memory_allocated``, ``memory_reserved``,
  ``max_memory_allocated``) and the gap between the allocator's bytes and
  the bytes reachable from Python: memory no live tensor holds, such as a
  CUDA graph's private pool, shows there and nowhere else. These are keys
  beside the JAX plane's, which keep their meaning.
- **Leak detector**: :meth:`set_baseline` pins the steady-state census;
  :meth:`drift` / :meth:`assert_flat` compare a later census bucket by
  bucket.
- **High-water gauges**: every census updates ``raft_device_mem_bytes``
  / ``raft_device_mem_bytes_high_water`` / ``raft_device_arrays``
  (per-root bytes ride ``raft_device_state_bytes{root}``, host roots
  ``raft_host_mem_bytes{root}``).
- :func:`audit_donation`: torch has no buffer donation. The port's
  contract is that a passed state is consumed: its rings are written in
  place and, on the card, a graph replay's small leaves are the graph's
  static buffers. The audit runs the call once and counts the donated
  leaves whose storage an output leaf shares (JAX's ``n_deleted``).

The census reads the tensors of the watched engine's device only
(:meth:`MemoryWatch.watch_engine` sets it); before an engine is watched
it reads every live tensor. Taking a
census is host metadata walking: a seeded run replays byte for byte with
the plane attached or absent.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from raft_tpu_torch.obs.compile import flatten_with_path


def _storage(t: torch.Tensor) -> Optional[Tuple[tuple, int]]:
    """((device type, device index, address), bytes) of a tensor's
    storage; None for a tensor with no data (meta, empty, sparse)."""
    if t.device.type == "meta" or t.is_sparse:
        return None
    try:
        s = t.untyped_storage()
        ptr, nbytes = s.data_ptr(), s.nbytes()
    except (RuntimeError, NotImplementedError):
        return None
    if not nbytes or not ptr:
        return None
    return (t.device.type, t.device.index, ptr), nbytes


def _shape_key(t: torch.Tensor) -> str:
    return (f"{str(t.dtype).replace('torch.', '')}"
            f"[{','.join(map(str, t.shape))}]")


def _tensors(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of a root's container (JAX's path text)."""
    return [(p, t) for p, t in flatten_with_path(tree)
            if isinstance(t, torch.Tensor)]


def _leaf_labels(name: str, tree: Any) -> Dict[tuple, str]:
    """storage key -> "name.path" for a registered root's tensors."""
    out: Dict[tuple, str] = {}
    for path, leaf in _tensors(tree):
        st = _storage(leaf)
        if st is not None:
            out[st[0]] = f"{name}{path}"
    return out


def _on(dev: torch.device, want: Optional[torch.device]) -> bool:
    return want is None or (dev.type == want.type and (
        want.index is None or dev.index == want.index))


def _live_storages(device: Optional[torch.device] = None
                  ) -> Dict[tuple, Tuple[int, str]]:
    """storage key -> (bytes, ``dtype[shape]``) of every live tensor's
    storage on ``device`` (all devices when None), from one walk of the
    garbage collector's objects. A storage shared by several tensors is
    keyed once, under the shape of a tensor that is not a view when one
    is live."""
    out: Dict[tuple, Tuple[int, str]] = {}
    base: set = set()
    is_tensor: Dict[type, bool] = {}
    for obj in gc.get_objects():
        # by type, cached: isinstance() reads __class__, which some
        # module objects turn into a deprecation warning
        tp = type(obj)
        hit = is_tensor.get(tp)
        if hit is None:
            hit = is_tensor[tp] = issubclass(tp, torch.Tensor)
        if not hit:
            continue
        try:
            if not _on(obj.device, device):
                continue
            st = _storage(obj)
            is_base = obj._base is None
        except Exception:
            continue
        if st is None:
            continue
        key, nbytes = st
        if key not in out or (is_base and key not in base):
            out[key] = (nbytes, _shape_key(obj))
            if is_base:
                base.add(key)
    return out


@dataclasses.dataclass
class MemoryCensus:
    """One point-in-time live-storage census. ``by_shape`` covers every
    live storage; ``unattr_by_shape`` only those NOT reachable from a
    registered root: the population the leak detector watches (a leaked
    old engine generation, an orphaned staging buffer, a silently copied
    state all land there, while a live root's fixed structure cannot grow
    without bound). ``allocator`` is the CUDA caching allocator's view of
    the watched card (None off the card)."""

    total_bytes: int
    n_arrays: int
    by_label: Dict[str, Tuple[int, int]]    # label -> (count, bytes)
    by_shape: Dict[str, Tuple[int, int]]    # dtype[shape] -> (count, bytes)
    unattr_by_shape: Dict[str, Tuple[int, int]]
    attributed_bytes: int
    host_by_label: Dict[str, int] = dataclasses.field(default_factory=dict)
    #   HOST-side buffers a registered host root accounts for (label ->
    #   bytes): the tiered store's sealed hot tails and decoded-segment
    #   caches live in numpy/bytes, outside the tensor census
    allocator: Optional[Dict[str, int]] = None

    @property
    def unattributed_bytes(self) -> int:
        return self.total_bytes - self.attributed_bytes

    def to_jsonable(self) -> dict:
        out = {
            "total_bytes": self.total_bytes,
            "n_arrays": self.n_arrays,
            "attributed_bytes": self.attributed_bytes,
            "unattributed_bytes": self.unattributed_bytes,
            "host_by_label": dict(sorted(self.host_by_label.items())),
            "by_label": {
                k: {"count": c, "bytes": b}
                for k, (c, b) in sorted(self.by_label.items())
            },
            "by_shape": {
                k: {"count": c, "bytes": b}
                for k, (c, b) in sorted(self.by_shape.items())
            },
            "unattr_by_shape": {
                k: {"count": c, "bytes": b}
                for k, (c, b) in sorted(self.unattr_by_shape.items())
            },
        }
        if self.allocator is not None:
            out.update(self.allocator)
        return out


def _allocator_view(device: torch.device, reachable: int) -> Dict[str, int]:
    """The caching allocator's counters for ``device`` (no sync) and the
    bytes it holds that no live tensor reaches."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    allocated = int(torch.cuda.memory_allocated(idx))
    return {
        "cuda_allocated_bytes": allocated,
        "cuda_reserved_bytes": int(torch.cuda.memory_reserved(idx)),
        "cuda_max_allocated_bytes": int(
            torch.cuda.max_memory_allocated(idx)),
        "cuda_unreachable_bytes": allocated - reachable,
    }


class MemoryWatch:
    """Device-memory accounting for one run (module docstring)."""

    def __init__(self, registry=None, recorder=None) -> None:
        self.registry = registry
        self.recorder = recorder
        self.device: Optional[torch.device] = None
        #   the watched engine's device (watch_engine); None counts the
        #   tensors of every device
        self._roots: Dict[str, Callable[[], Any]] = {}
        self._host_roots: Dict[str, Callable[[], Optional[int]]] = {}
        self.baseline: Optional[MemoryCensus] = None
        self.last: Optional[MemoryCensus] = None
        self.high_water_bytes = 0
        self.high_water_arrays = 0
        self.donation: Optional["DonationReport"] = None
        #: the chaos runner's end-of-run flatness verdict (drift() taken
        #: at quiesce, while the final engine is still alive)
        self.final_drift: Optional[List[str]] = None

    # ------------------------------------------------------------- roots
    def register_root(self, name: str,
                      getter: Callable[[], Any]) -> None:
        """Label the tensors of ``getter()``'s container in every census.
        ``getter`` returning ``None`` skips the root (a crashed
        engine)."""
        self._roots[name] = getter

    def register_host_root(self, name: str,
                           nbytes: Callable[[], Optional[int]]) -> None:
        """Account a HOST-side buffer population under ``name``:
        ``nbytes()`` returns the bytes it currently holds (None skips: a
        collected engine). Host roots appear in the census's
        ``host_by_label`` section and the ``raft_host_mem_bytes`` gauge."""
        self._host_roots[name] = nbytes

    def watch_engine(self, engine, name: str = "engine") -> None:
        """Register an engine's device-resident roots under ``name``: the
        state and the event ring (precise per-leaf labels), plus a
        shallow walk of the engine's, its fused driver's and its transport
        chain's instance attributes, which attributes the LAZY singletons
        (the heartbeat zero batch, the staging ring) and the transports'
        and engine's CUDA-graph buffers (``core.graphs``: packed inputs,
        outputs, static leaves), all allocated on first use, which must be
        attributed or their first appearance after ``set_baseline`` would
        read as a leak, and what the graph pool keeps for the next
        cluster of the engine's shape (``core.graphs.POOL``). Held via weakref so a watched engine can be
        collected across crash-restore cycles. The watch's device becomes
        the engine's when it has none."""
        ref = weakref.ref(engine)
        if self.device is None:
            dev = getattr(engine, "_dev", None) or getattr(
                engine, "device", None)
            if dev is not None:
                self.device = torch.device(dev)

        def state_getter():
            e = ref()
            return None if e is None else getattr(e, "state", None)

        def ring_getter():
            e = ref()
            return None if e is None else getattr(e, "_dev_ring", None)

        def host_getter():
            e = ref()
            if e is None:
                return None
            out: Dict[str, Any] = {"self": dict(vars(e))}
            driver = getattr(e, "_fused_driver", None)
            if driver is not None:
                out["staging"] = getattr(driver.staging, "buf", None)
            chain = [e]
            t = getattr(e, "t", None) or getattr(e, "transport", None)
            depth = 0
            while t is not None and depth < 3:
                out[f"t{depth}"] = dict(vars(t))
                chain.append(t)
                t = getattr(t, "t", None)
                depth += 1
            graphs = [g.buffers() for g in (
                getattr(o, a, None) for o in chain
                for a in ("graphs", "_graphs"))
                if hasattr(g, "buffers")]
            if graphs:
                out["graphs"] = graphs
            from raft_tpu_torch.core.graphs import POOL

            pooled = POOL.buffers()
            if pooled:
                # what the graph pool keeps for the next cluster of this
                # shape (bounded; claimed at the next restore)
                out["graph_pool"] = pooled
            return out

        # host first: roots apply in registration order with later wins,
        # so the precise state/ring leaf labels override the host walk's
        self.register_root(f"{name}.host", host_getter)
        self.register_root(f"{name}.state", state_getter)
        self.register_root(f"{name}.ring", ring_getter)

        def sealed_bytes():
            e = ref()
            if e is None:
                return None
            store = getattr(e, "store", None)
            if store is not None and hasattr(store, "host_bytes"):
                return store.host_bytes()
            tier = getattr(e, "_tier_host_bytes", None)
            return tier() if tier is not None else None

        self.register_host_root(f"{name}.store.sealed", sealed_bytes)

    # ------------------------------------------------------------ census
    def census(self, collect: bool = False) -> MemoryCensus:
        """Take a census (see module docstring). ``collect=True`` runs
        ``gc.collect()`` first: the leak-detector comparisons want
        dropped-but-uncollected engine generations out of the picture;
        the passive /memory endpoint leaves the collector alone."""
        if collect:
            gc.collect()
        labels: Dict[tuple, str] = {}
        for name, getter in self._roots.items():
            try:
                tree = getter()
            except Exception:
                tree = None
            if tree is not None:
                labels.update(_leaf_labels(name, tree))
        by_label: Dict[str, List[int]] = {}
        by_shape: Dict[str, List[int]] = {}
        unattr: Dict[str, List[int]] = {}
        total = 0
        n = 0
        attributed = 0
        for key, (nbytes, shape_key) in _live_storages(self.device).items():
            total += nbytes
            n += 1
            sc = by_shape.setdefault(shape_key, [0, 0])
            sc[0] += 1
            sc[1] += nbytes
            label = labels.get(key)
            if label is not None:
                attributed += nbytes
                lc = by_label.setdefault(label, [0, 0])
                lc[0] += 1
                lc[1] += nbytes
            else:
                uc = unattr.setdefault(shape_key, [0, 0])
                uc[0] += 1
                uc[1] += nbytes
        host_by_label: Dict[str, int] = {}
        for hname, nbytes in self._host_roots.items():
            try:
                b = nbytes()
            except Exception:
                b = None
            if b is not None:
                host_by_label[hname] = int(b)
        census = MemoryCensus(
            total_bytes=total, n_arrays=n,
            by_label={k: (c, b) for k, (c, b) in by_label.items()},
            by_shape={k: (c, b) for k, (c, b) in by_shape.items()},
            unattr_by_shape={k: (c, b) for k, (c, b) in unattr.items()},
            attributed_bytes=attributed,
            host_by_label=host_by_label,
            allocator=(_allocator_view(self.device, total)
                       if self.device is not None
                       and self.device.type == "cuda" else None),
        )
        self.last = census
        self.high_water_bytes = max(self.high_water_bytes, total)
        self.high_water_arrays = max(self.high_water_arrays, n)
        if self.registry is not None:
            self.registry.gauge(
                "raft_device_mem_bytes", "live device buffer bytes",
            ).set(total)
            self.registry.gauge(
                "raft_device_mem_bytes_high_water",
                "max live device buffer bytes observed",
            ).set(self.high_water_bytes)
            self.registry.gauge(
                "raft_device_arrays", "live device buffer count",
            ).set(n)
            roots: Dict[str, int] = {}
            for label, (_c, b) in census.by_label.items():
                root = label.split(".", 1)[0]
                roots[root] = roots.get(root, 0) + b
            for root, b in roots.items():
                self.registry.gauge(
                    "raft_device_state_bytes",
                    "live bytes attributed to a registered root",
                    ("root",),
                ).set_max(b, root=root)
            for hname, b in host_by_label.items():
                self.registry.gauge(
                    "raft_host_mem_bytes",
                    "host bytes attributed to a registered host root "
                    "(tiered-store hot tail + segment cache)",
                    ("root",),
                ).set(b, root=hname)
        return census

    # ----------------------------------------------------- leak detector
    def set_baseline(self, collect: bool = True) -> MemoryCensus:
        """Pin the steady-state census the flatness pins compare to."""
        self.baseline = self.census(collect=collect)
        return self.baseline

    def drift(self, tolerance_bytes: int = 0,
              collect: bool = True) -> List[str]:
        """Census-vs-baseline deltas worth flagging, as human-readable
        strings (empty = FLAT). The watched population is the
        UNATTRIBUTED storages (see :class:`MemoryCensus`)."""
        if self.baseline is None:
            raise RuntimeError("set_baseline() before drift()")
        now = self.census(collect=collect)
        out: List[str] = []
        delta = now.unattributed_bytes - self.baseline.unattributed_bytes
        if delta > tolerance_bytes:
            out.append(
                f"unattributed total {delta:+d} bytes "
                f"({self.baseline.unattributed_bytes} -> "
                f"{now.unattributed_bytes})"
            )
        buckets = set(now.unattr_by_shape) | set(
            self.baseline.unattr_by_shape
        )
        for k in sorted(buckets):
            c0, b0 = self.baseline.unattr_by_shape.get(k, (0, 0))
            c1, b1 = now.unattr_by_shape.get(k, (0, 0))
            if c1 > c0 and b1 - b0 > tolerance_bytes:
                out.append(
                    f"bucket {k}: {c1 - c0:+d} unattributed arrays "
                    f"({b1 - b0:+d} bytes)"
                )
        if out and self.recorder is not None:
            self.recorder.record(
                node="mem", term=0, kind="census_drift",
                drift=list(out),
            )
        return out

    def assert_flat(self, tolerance_bytes: int = 0,
                    collect: bool = True) -> None:
        """The leak detector's teeth: raise when the census drifted."""
        drift = self.drift(
            tolerance_bytes=tolerance_bytes, collect=collect
        )
        if drift:
            raise AssertionError(
                "device-memory census is not flat vs baseline:\n  "
                + "\n  ".join(drift)
            )

    # ---------------------------------------------------------- snapshot
    def snapshot(self, census: bool = False) -> dict:
        """The /memory body and the forensics-bundle entry.
        ``census=True`` takes a fresh census first (metadata only)."""
        if census or self.last is None:
            self.census()
        return {
            "census": self.last.to_jsonable() if self.last else None,
            "baseline": (
                self.baseline.to_jsonable() if self.baseline else None
            ),
            "high_water_bytes": self.high_water_bytes,
            "high_water_arrays": self.high_water_arrays,
            "final_drift": self.final_drift,
            "roots": sorted(self._roots),
            "host_roots": sorted(self._host_roots),
            "donation": (
                dataclasses.asdict(self.donation)
                if self.donation is not None else None
            ),
        }

    def summary(self) -> dict:
        """The light /status section (with the allocator's bytes on the
        card)."""
        out = {
            "live_bytes": self.last.total_bytes if self.last else None,
            "live_arrays": self.last.n_arrays if self.last else None,
            "host_bytes": (
                sum(self.last.host_by_label.values())
                if self.last and self.last.host_by_label else None
            ),
            "high_water_bytes": self.high_water_bytes,
            "flat": (
                None if self.baseline is None or self.last is None
                else self.last.total_bytes <= self.baseline.total_bytes
            ),
        }
        if self.last is not None and self.last.allocator is not None:
            out.update(self.last.allocator)
        return out


# --------------------------------------------------------------- donation
@dataclasses.dataclass
class DonationReport:
    """Outcome of one in-place (donated-call) audit.

    ``engaged``: at least one donated leaf's storage came back in the
    outputs (written in place). ``honored``: every donated leaf's did.
    ``n_deleted`` keeps the JAX field name and counts those leaves. The
    gap between the two is the port's design, not a leak: on the CPU the
    rings are written in place while the small leaves are new tensors;
    on the card a graph replay returns its static buffers, which are the
    passed small leaves only when they came from the previous replay."""

    honored: bool           # every donated leaf came back in place
    engaged: bool           # at least one leaf came back in place
    backend: str
    n_donated_leaves: int
    n_deleted: int
    detail: str = ""


def audit_donation(call: Callable, args: tuple,
                   donated: Tuple[int, ...] = (0,),
                   watch: Optional[MemoryWatch] = None) -> DonationReport:
    """Run ``call(*args)`` once and count the donated positional args'
    tensors whose storage an output tensor shares: consumed in place,
    not copied. The caller treats the donated args as consumed either
    way (the transports' contract)."""
    donated_leaves: List[torch.Tensor] = []
    for i in donated:
        donated_leaves.extend(t for _, t in _tensors(args[i]))
    backend = donated_leaves[0].device.type if donated_leaves else "cpu"
    keys = [_storage(t) for t in donated_leaves]
    out = call(*args)
    out_keys = {st[0] for st in (_storage(t) for _, t in _tensors(out))
                if st is not None}
    deleted = sum(1 for k in keys if k is not None and k[0] in out_keys)
    honored = deleted == len(donated_leaves) and donated_leaves != []
    engaged = deleted > 0
    if honored:
        detail = "all donated leaves consumed in place"
    elif engaged:
        detail = (
            f"{len(donated_leaves) - deleted} donated leaves survived "
            "the call (new output tensors: the small leaves outside a "
            "graph's static buffers, see DonationReport)"
        )
    else:
        detail = (
            "no donated leaf was consumed (the backend copied instead "
            "of donating)"
        )
    report = DonationReport(
        honored=honored, engaged=engaged, backend=backend,
        n_donated_leaves=len(donated_leaves), n_deleted=deleted,
        detail=detail,
    )
    if watch is not None:
        watch.donation = report
        if watch.recorder is not None:
            watch.recorder.record(
                node="mem", term=0, kind="donation_audit",
                honored=honored, engaged=engaged, backend=backend,
                n_donated_leaves=report.n_donated_leaves,
                n_deleted=deleted,
            )
    return report
