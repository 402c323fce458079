"""The typed refusals the engines raise and the wire tier answers with a
frame (``NOT_LEADER``, ``REFUSED``), defined apart from the engines so
that a host process can name them without loading PyTorch: a cluster
replica (``cluster/node.py``) raises them, and ``net/server.py`` maps
them. ``multi.engine`` and ``raft.engine`` export them under their JAX
homes (``raft_tpu/multi/engine.py``, ``raft_tpu/raft/engine.py``)."""

from __future__ import annotations

from typing import Optional


class NotLeader(Exception):
    """A leader-required group operation (``submit_to_leader``,
    ``read_index``) found no live, confirmable leader for the target
    group. Carries ``group`` so a router can retry: drive the engine
    until the group re-elects (``run_until_leader``), then resubmit
    (``multi.router.Router``). Raised out of a batched router call,
    ``partial`` carries the per-item results placed before the failure
    (None = unplaced)."""

    def __init__(self, group: int, msg: str = ""):
        super().__init__(msg or f"group {group} has no current leader")
        self.group = group
        self.partial: Optional[list] = None


class ReadLagging(Exception):
    """A follower or session read could not be served within the
    staleness bound: the chosen replica's replication cursor (or, for a
    session read, the group's apply cursor) has not passed the required
    index. ``replica`` is None for session reads; ``lag`` is entries
    short; ``retry_after_s`` hints one replication round."""

    def __init__(self, group: int, replica: Optional[int], lag: int,
                 retry_after_s: float = 0.0):
        which = ("apply stream" if replica is None
                 else f"replica {replica}")
        super().__init__(
            f"group {group}: {which} lags the required read index by "
            f"{lag} entries"
        )
        self.group = group
        self.replica = replica
        self.lag = lag
        self.retry_after_s = retry_after_s


class LinearizableReadRefused(Exception):
    # not a RuntimeError: ReplicatedKV.linearizable_get's other failure
    # mode (the apply stream paused behind an archive gap) raises
    # RuntimeError, and the two call for different recovery actions
    """``read_linearizable`` could not confirm leadership: the caller is
    not leader, was deposed during the confirmation round, or cannot
    reach a quorum of the configuration (a minority-side leader during a
    partition). The read must be retried against the real leader."""


class TicketEvicted(LinearizableReadRefused):
    """A ``submit_read`` ticket was FIFO-evicted at the outstanding-ticket
    cap (``READ_TICKET_CAP``), or idle past the admission TTL, before it
    was polled; a consumed ticket polled after the eviction floor passed
    it reads the same. The recovery is to re-issue the read."""
