"""Dynamic group placement: a StatusBoard-fed shard-load controller (a
copy of ``raft_tpu/multi/rebalancer.py``; host code). ``plan`` works on
any snapshot; ``step`` carries a plan out through
``MultiEngine.migrate_group``, which moves groups on the sharded layout
and refuses on the resident one (every group on shard 0), as in JAX.

The sharded layout (``transport.group_mesh``) makes WHERE a group lives
a one-launch decision (``MultiEngine.migrate_group``); this module
decides WHEN and WHICH. Its entire input is the PR-9 online plane,
consumed straight off the :class:`obs.serve.StatusBoard`
snapshot — the rebalancer never scrapes the engine and never touches
device state:

- ``queue_depth`` per group (the engine's ``/status`` section): queued
  work is the direct load signal;
- ``slo_alerts`` (the SLO tracker's active burn-rate alerts, published
  into the engine snapshot): a group burning its commit or queue-delay
  error budget is weighted far above its queue depth — burn is the
  "users are hurting" signal the SRE windows exist for;
- ``breakers`` (the Router's section): a group whose circuit breaker is
  open is refusing clients — co-locating it with healthy hot groups
  compounds the refusal wave;
- ``placement`` / ``leader_spread``: where everything lives now.

Policy (deliberately greedy and hysteretic — a placement controller
that chases noise migrates forever): compute each shard's load as the
sum of its resident groups' scores, and while the hottest shard exceeds
the coolest by more than ``imbalance_threshold``, move the hottest
group that FITS the gap (moving a group hotter than the gap would just
swap which shard is hot). Leadership respread within a group's replica
rows stays :meth:`MultiEngine.rebalance`'s job; the Router composes
both under one call (``Router.rebalance``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

#: Load-score weights: a queued entry counts 1; an active burn-rate
#: alert on the group counts as a full batch of queued work (page twice
#: a ticket); an open breaker likewise. The absolute values only set
#: the exchange rate between "backlog" and "burning" — the controller
#: compares sums of them, it never reads them as latencies.
BURN_WEIGHT = {"page": 64.0, "ticket": 32.0}
BREAKER_WEIGHT = {"open": 32.0, "half_open": 8.0}


class Rebalancer:
    """StatusBoard-driven group→shard placement controller.

    ``board`` defaults to the engine's attached status board; when
    neither exists the engine's snapshot is built directly (same dict,
    same code path — the board is a publication seam, not a schema).
    """

    def __init__(
        self,
        engine,
        board=None,
        imbalance_threshold: float = 8.0,
    ):
        self.engine = engine
        self.board = board if board is not None else engine.status_board
        self.imbalance_threshold = imbalance_threshold
        self.moves: List[dict] = []

    # ---------------------------------------------------------- inputs
    def snapshot(self) -> dict:
        """The current composed StatusBoard snapshot (or a fresh engine
        snapshot when no board is attached — cold-start/testing)."""
        if self.board is not None:
            snap = self.board.compose()
            if snap.get("placement"):
                return snap
        return self.engine._status_snapshot()

    def group_scores(self, snap: dict) -> Dict[int, float]:
        """Per-group load score from the snapshot alone (module
        docstring): queue depth + burn-alert weight + breaker weight."""
        scores: Dict[int, float] = {
            int(g): float(d)
            for g, d in snap.get("queue_depth", {}).items()
        }
        for a in snap.get("slo_alerts", ()):
            g = a.get("group")
            if g is not None:
                scores[int(g)] = (
                    scores.get(int(g), 0.0)
                    + BURN_WEIGHT.get(a.get("severity"), 32.0)
                )
        for g, state in snap.get("breakers", {}).items():
            w = BREAKER_WEIGHT.get(state)
            if w:
                scores[int(g)] = scores.get(int(g), 0.0) + w
        return scores

    def shard_loads(self, snap: dict) -> Dict[int, float]:
        placement = snap.get("placement", {})
        scores = self.group_scores(snap)
        loads = {s: 0.0 for s in range(int(snap.get("shards", 1)))}
        for g, shard in placement.items():
            loads[int(shard)] = loads.get(int(shard), 0.0) + scores.get(
                int(g), 0.0
            )
        return loads

    # ------------------------------------------------------------ plan
    def plan(self, snap: Optional[dict] = None,
             max_moves: int = 1) -> List[dict]:
        """Greedy move plan off one snapshot: ``[{"group", "src",
        "dst", "partner", "gap"}, ...]``, at most ``max_moves`` long,
        empty when the load spread is within the hysteresis threshold
        or no move can improve it (single shard, or every candidate
        swap would worsen the spread)."""
        snap = snap if snap is not None else self.snapshot()
        if int(snap.get("shards", 1)) < 2:
            return []
        scores = self.group_scores(snap)
        placement = {
            int(g): int(s) for g, s in snap.get("placement", {}).items()
        }
        loads = self.shard_loads(snap)
        plan: List[dict] = []
        for _ in range(max_moves):
            hot = max(loads, key=loads.get)
            cool = min(loads, key=loads.get)
            gap = loads[hot] - loads[cool]
            if gap <= self.imbalance_threshold:
                break
            # a migration is a slot SWAP (migrate_group): the partner
            # group comes BACK to the hot shard, so the net transfer is
            # s_group - s_partner. Plan the partner explicitly (the
            # destination's lightest group) and require the strict
            # improvement 0 < net < gap — the swap changes the pair's
            # spread to |gap - 2*net|, so net == gap would just swap
            # which shard is hot and ping-pong on every rebalance call,
            # and net <= 0 would move load the wrong way.
            cool_groups = [
                g for g, s in placement.items() if s == cool
            ]
            if not cool_groups:
                break
            partner = min(
                cool_groups, key=lambda gg: (scores.get(gg, 0.0), gg)
            )
            s_p = scores.get(partner, 0.0)
            movable = [
                g for g, s in placement.items()
                if s == hot and 0.0 < scores.get(g, 0.0) - s_p < gap
            ]
            if not movable:
                break
            g = max(movable, key=lambda gg: (scores.get(gg, 0.0), -gg))
            net = scores.get(g, 0.0) - s_p
            plan.append({
                "group": g, "src": hot, "dst": cool, "partner": partner,
                "gap": round(gap, 3),
            })
            placement[g] = cool
            placement[partner] = hot
            loads[hot] -= net
            loads[cool] += net
        return plan

    # --------------------------------------------------------- execute
    def step(self, max_moves: int = 1,
             snap: Optional[dict] = None) -> List[dict]:
        """Plan against the current snapshot and DRIVE the planned moves
        through ``MultiEngine.migrate_group`` (the staged catch-up →
        install → release ladder), passing the planned partner so the
        executed swap matches the load model. Returns the executed move
        summaries (each the engine's migration dict + the plan's gap)."""
        done: List[dict] = []
        for mv in self.plan(snap=snap, max_moves=max_moves):
            out = self.engine.migrate_group(
                mv["group"], mv["dst"], partner=mv["partner"]
            )
            if out is not None:
                out["gap"] = mv["gap"]
                done.append(out)
        self.moves.extend(done)
        return done
