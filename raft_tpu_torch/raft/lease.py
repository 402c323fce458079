"""Leader leases: zero-round linearizable reads (dissertation §6.4.1);
the port's own copy of ``raft_tpu/raft/lease.py``, host-only, with the
same class and arithmetic.

Classic ReadIndex pays one empty quorum round per read (or per batch —
``submit_read``).  A leader LEASE removes even that: every successful
quorum round (a write tick, a pipelined chunk, an explicit
confirmation) doubles as a lease grant, and while the lease is valid
the leader may serve linearizable reads from its own committed state
with ZERO replication rounds — the read costs one host-side clock
compare.

Safety argument (why a lease-holder cannot serve stale data): a new
leader requires votes from a voter majority, and under PreVote's
leader-stickiness clause (§9.6 — ``RaftConfig.read_lease`` REQUIRES
``prevote``) no voter grants while it heard the current leader within
the minimum election timeout ``f0 = follower_timeout[0]``.  The lease
is granted at the instant a quorum round reached a member majority —
the same instant those followers' stickiness clocks reset — so no rival
can be elected (let alone commit a write the lease-read would miss)
until ``f0`` true seconds after the grant.  A lease that expires before
then is safe.

Clocks drift, so "``f0`` seconds after the grant" is measured on the
leader's OWN clock, which may run slow relative to the cluster: the
lease duration is therefore ``f0 / clock_drift_bound``
(``RaftConfig.clock_drift_bound`` — the deployment's assumed worst-case
clock-rate error).  With the leader's true rate ``rho`` (local seconds
per true second), a serve at local elapsed ``< f0 / drift`` happened at
true elapsed ``< f0 / (drift * rho)``, which is ``< f0`` whenever
``rho >= 1 / drift`` — i.e. the plane is provably safe for any skew
inside the assumed bound.  ``set_rate`` is the clock-skew injection
surface; ``ignore_drift`` is the deliberately broken plane (lease = the
full ``f0`` on the local clock), under which a slow clock holds the
lease past a rival's election and serves a stale read.

One :class:`LeaseTable` serves every engine — keys are replica rows
(``RaftEngine``) or ``(group, row)`` pairs (a multi-group engine).  Lease
state is VOLATILE by design: a restarted engine builds a fresh table
and must win a quorum round before serving locally again (a persisted
lease could outlive the stickiness evidence it rests on).
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional, Tuple


class LeaseTable:
    """Drift-bounded leader-lease clocks, one entry per lease holder.

    ``duration_s`` is the raw stickiness window ``f0``; a valid lease
    requires the holder's LOCAL elapsed time since grant to stay under
    ``duration_s / drift_bound`` (see module docstring).  ``set_rate``
    models the holder's clock-rate error (the chaos nemesis's injection
    surface): local elapsed = true elapsed * rate, so ``rate < 1`` is a
    slow clock that overestimates its remaining lease.

    ``ignore_drift=True`` is the deliberately BROKEN plane (the
    ``lease_skew`` falsifiability variant): the drift divisor is
    dropped, so any slow clock inside the assumed band already violates
    the safety argument.  Production code never sets it.
    """

    def __init__(self, duration_s: float, drift_bound: float) -> None:
        if duration_s <= 0:
            raise ValueError("lease duration must be > 0")
        if drift_bound < 1.0:
            raise ValueError("clock_drift_bound must be >= 1.0")
        self.duration_s = float(duration_s)
        self.drift_bound = float(drift_bound)
        self.ignore_drift = False
        self.grants = 0                 # all-time grant count (obs)
        self._grant: Dict[Hashable, Tuple[int, float]] = {}
        #   key -> (term, true grant time): only the LATEST grant per
        #   holder matters — leases renew, never stack
        self._rate: Dict[Hashable, float] = {}

    # ------------------------------------------------------------ skew
    def set_rate(self, key: Hashable, rate: float) -> None:
        """Set ``key``'s local clock rate (1.0 = perfect; the nemesis
        draws inside ``[1/drift_bound, drift_bound]`` — the band the
        correct plane must absorb)."""
        if rate <= 0:
            raise ValueError("clock rate must be > 0")
        if rate == 1.0:
            self._rate.pop(key, None)
        else:
            self._rate[key] = float(rate)

    def rate(self, key: Hashable) -> float:
        return self._rate.get(key, 1.0)

    # ----------------------------------------------------------- lease
    @property
    def effective_duration_s(self) -> float:
        """Local-clock seconds a grant stays valid."""
        if self.ignore_drift:
            return self.duration_s
        return self.duration_s / self.drift_bound

    def grant(self, key: Hashable, term: int, now: float) -> None:
        """A quorum round sourced at ``key`` in ``term`` completed at
        true time ``now`` (the same instant the heard followers'
        stickiness clocks reset — the caller's burden)."""
        self._grant[key] = (int(term), float(now))
        self.grants += 1

    def break_(self, key: Optional[Hashable] = None) -> None:
        """Drop a grant (or all of them): leadership change, membership
        change, crash-restore — anything that invalidates the
        stickiness evidence."""
        if key is None:
            self._grant.clear()
        else:
            self._grant.pop(key, None)

    def remaining_s(self, key: Hashable, term: int, now: float) -> float:
        """LOCAL-clock seconds of lease left (<= 0 = expired / absent /
        a different term's grant)."""
        got = self._grant.get(key)
        if got is None or got[0] != int(term):
            return 0.0
        local_elapsed = (float(now) - got[1]) * self.rate(key)
        return self.effective_duration_s - local_elapsed

    def valid(self, key: Hashable, term: int, now: float) -> bool:
        """Serve-locally predicate, STRICT: at exactly the boundary the
        lease is expired (the safety math needs true elapsed < f0)."""
        return self.remaining_s(key, term, now) > 0.0

    # ------------------------------------------------------------- obs
    def summary(self, key: Hashable, term: int, now: float) -> dict:
        return {
            "granted": key in self._grant,
            "valid": self.valid(key, term, now),
            "remaining_s": round(max(self.remaining_s(key, term, now), 0.0), 6),
            "duration_s": self.effective_duration_s,
            "drift_bound": self.drift_bound,
            "rate": self.rate(key),
            "grants": self.grants,
        }
