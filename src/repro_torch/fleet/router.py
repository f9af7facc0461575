"""Routing policies for the serving fleet (port of
``repro.fleet.router``, pure Python) — one interface, concrete
dispatch backends (the abstract-dispatcher shape of vllm-ascend's
``MoETokenDispatcher``: an ABC that fixes the contract, subclasses that
fix the placement strategy).

A router answers exactly one question: *given what every worker looks
like right now, which worker should this request go to?*  It sees the
fleet through ``WorkerView``s — a deliberately small, backend-agnostic
projection of worker state that both the live asyncio ``Fleet`` (views
built from ``GatewayStats`` snapshots) and the virtual-clock
``FleetSim`` (views updated in place at simulation speed) can produce.
Because routers only read views, every concrete router is shared
verbatim between live serving and the million-request simulation, and
the no-bad-placement invariant (never a worker that lacks the plan, is
draining, or is unhealthy) is property-tested once for all of them.

Concrete routers:

  ``RoundRobinRouter``   rotate over admissible workers — the baseline
                         the benchmark beats (it sends one third of a
                         heavy trace to an edge part with a tenth of
                         the capacity).
  ``LeastLoadedRouter``  minimize estimated wait (outstanding work /
                         service rate) — load-aware, cost-blind.
  ``PlanAwareRouter``    the paper's fleet-level payoff: deadline-tight
                         traffic goes to the *fastest* admissible
                         worker, best-effort traffic to the *cheapest*
                         profile that still fits (spilling upward only
                         when the cheap tier's backlog would blow the
                         wait budget).

All tie-breaks end on ``worker_id`` so every router is deterministic:
the same views in the same order always route the same way — the
property the bit-reproducible benchmark rests on.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Sequence, Tuple, Union

#: request tiers the fleet routes on, most to least urgent
TIERS = ("interactive", "batch", "best_effort")


class WorkerView:
    """Router-visible state of one worker.

    Mutable by design: the live ``Fleet`` builds fresh views from each
    worker's ``GatewayStats`` snapshot per routing decision, while the
    simulator keeps one view per worker and updates ``queue_depth`` /
    ``inflight`` / ``healthy`` / ``draining`` in place — constructing a
    frozen dataclass per request would dominate a million-request run.

    ``rate`` is the worker's estimated service rate in images/sec (its
    device profile's relative speed × the measured or modeled per-image
    time); ``est_wait`` — outstanding work over that rate — is the one
    load metric every router shares.  When the worker reports a
    *measured* wait (``GatewayStats.est_wait``, the gateway's own EWMA
    throughput applied to its own backlog), ``est_wait_s`` carries it
    and takes precedence over the depth-over-nominal-rate inference.
    """

    __slots__ = ("worker_id", "cost", "plan_ids", "queue_depth",
                 "inflight", "max_batch", "rate", "healthy", "draining",
                 "est_wait_s")

    def __init__(self, worker_id: str, *, cost: float, plan_ids,
                 rate: float, max_batch: int = 8, queue_depth: int = 0,
                 inflight: int = 0, healthy: bool = True,
                 draining: bool = False,
                 est_wait_s: Optional[float] = None):
        self.worker_id = worker_id
        self.cost = float(cost)
        self.plan_ids = frozenset(plan_ids)
        self.rate = float(rate)
        self.max_batch = int(max_batch)
        self.queue_depth = int(queue_depth)
        self.inflight = int(inflight)
        self.healthy = bool(healthy)
        self.draining = bool(draining)
        self.est_wait_s = None if est_wait_s is None else float(est_wait_s)

    @property
    def accepting(self) -> bool:
        """Admissible for *new* traffic: healthy and not draining."""
        return self.healthy and not self.draining

    def est_wait(self) -> float:
        """Seconds of outstanding work ahead of a new arrival: the
        worker's measured estimate when it reports one, otherwise
        inferred from queue depth over the nominal rate."""
        if self.est_wait_s is not None:
            return self.est_wait_s
        return (self.queue_depth + self.inflight) / max(self.rate, 1e-9)

    def __repr__(self) -> str:                    # pragma: no cover
        return (f"WorkerView({self.worker_id!r}, cost={self.cost}, "
                f"depth={self.queue_depth}+{self.inflight}, "
                f"healthy={self.healthy}, draining={self.draining})")


class Router(ABC):
    """The routing contract.  ``select`` returns the chosen worker view
    or ``None`` when no admissible worker exists (the fleet then sheds
    or backpressures).  It must never return a worker that is draining,
    unhealthy, or missing ``plan_id`` — the invariant the fleet's
    drain/health guarantees rest on, property-tested over every
    registered router in ``tests/test_torch_fleet.py``."""

    name = "router"

    @abstractmethod
    def select(self, plan_id: str, tier: str,
               workers: Sequence[WorkerView], now: float,
               deadline: Optional[float] = None) -> Optional[WorkerView]:
        """Pick a worker for one request (``deadline`` absolute on the
        fleet clock, or None)."""

    @staticmethod
    def admissible(plan_id: str,
                   workers: Sequence[WorkerView]) -> List[WorkerView]:
        """Workers that may legally receive a ``plan_id`` request.

        ``plan_ids`` is the mixed-workload placement seam: a plan id
        stands for a full ``DeploymentPlan`` of *any* workload kind
        (CNN, quantized MoE, ...), and a worker only advertises plans
        its device profile could host — an MoE plan that exceeds an
        edge part's budgets fails ``plan_moe_deployment`` before it
        could ever be registered there.  Routing by plan id therefore
        *is* plan-aware workload placement; no router needs to know
        what kind of network hides behind the id."""
        return [w for w in workers
                if w.accepting and plan_id in w.plan_ids]


class RoundRobinRouter(Router):
    """Rotate over admissible workers, blind to load, cost, and tier —
    the trivial baseline.  Deterministic: the rotation counter advances
    once per *successful* selection."""

    name = "round_robin"

    def __init__(self) -> None:
        self._turn = 0

    def select(self, plan_id, tier, workers, now, deadline=None):
        ok = self.admissible(plan_id, workers)
        if not ok:
            return None
        ok.sort(key=lambda w: w.worker_id)
        chosen = ok[self._turn % len(ok)]
        self._turn += 1
        return chosen


class LeastLoadedRouter(Router):
    """Minimize estimated wait; ties fall to cheaper cost, then worker
    id.  Load-aware but cost-blind: a cheap idle part and an expensive
    idle part are interchangeable to it."""

    name = "least_loaded"

    def select(self, plan_id, tier, workers, now, deadline=None):
        ok = self.admissible(plan_id, workers)
        if not ok:
            return None
        return min(ok, key=lambda w: (w.est_wait(), w.cost, w.worker_id))


class PlanAwareRouter(Router):
    """Tier- and cost-aware placement — the fleet-level version of the
    paper's match-the-network-to-the-hardware claim.

    * **Deadline-tight** traffic (tier ``interactive``, or any request
      whose deadline headroom is within ``tight_s``) goes to the
      admissible worker with the lowest estimated wait — the fastest
      door, cost be damned.
    * **Everything else** (``batch`` / ``best_effort``) goes to the
      *cheapest* profile whose backlog stays inside a wait budget —
      ``spill_wait_s``, tightened to half the remaining deadline
      headroom when the request carries one — and spills to the next
      cost tier only when the cheap one is saturated.  If every worker
      is past its budget, least-loaded wins (graceful degradation, not
      a refusal).
    """

    name = "plan_aware"

    def __init__(self, *, tight_s: float = 0.3,
                 spill_wait_s: float = 1.0) -> None:
        if tight_s < 0 or spill_wait_s <= 0:
            raise ValueError(
                f"tight_s={tight_s} must be ≥ 0 and "
                f"spill_wait_s={spill_wait_s} must be > 0")
        self.tight_s = float(tight_s)
        self.spill_wait_s = float(spill_wait_s)

    def select(self, plan_id, tier, workers, now, deadline=None):
        ok = self.admissible(plan_id, workers)
        if not ok:
            return None
        headroom = None if deadline is None else deadline - now
        tight = tier == "interactive" or (
            headroom is not None and headroom <= self.tight_s)
        if tight:
            return min(ok, key=lambda w: (w.est_wait(), w.cost,
                                          w.worker_id))
        budget = self.spill_wait_s
        if headroom is not None:
            budget = min(budget, max(headroom / 2.0, 1e-3))
        ok.sort(key=lambda w: (w.cost, w.est_wait(), w.worker_id))
        for w in ok:
            if w.est_wait() <= budget:
                return w
        return min(ok, key=lambda w: (w.est_wait(), w.cost, w.worker_id))


RouterLike = Union[str, Router, None]

_ROUTERS = {
    RoundRobinRouter.name: RoundRobinRouter,
    LeastLoadedRouter.name: LeastLoadedRouter,
    PlanAwareRouter.name: PlanAwareRouter,
}


def get_router(router: RouterLike) -> Router:
    """Resolve a router name to a *fresh* instance (routers such as
    round-robin carry mutable rotation state — two fleets must never
    share one), or pass a constructed ``Router`` through.  ``None``
    means ``plan_aware`` — the production default."""
    if router is None:
        return PlanAwareRouter()
    if isinstance(router, Router):
        return router
    try:
        return _ROUTERS[router]()
    except KeyError:
        raise ValueError(f"unknown router {router!r}; known: "
                         f"{sorted(_ROUTERS)}") from None


def list_routers() -> Tuple[str, ...]:
    return tuple(sorted(_ROUTERS))
