"""``repro_torch.fleet`` — plan-aware multi-worker serving fleet (port
of ``repro.fleet``).

The layer above ``repro_torch.serve``: where a gateway runs *one*
worker's continuous-batching loop, the fleet runs *many* gateways —
bound to heterogeneous device profiles from the port's catalog
(``edge``, ``v5e``, ``v5p``) — behind one ``submit`` front door.  A
pluggable ``Router`` places each request (the default
``PlanAwareRouter`` sends deadline-tight traffic to the fastest
admissible worker and best-effort traffic to the cheapest profile that
still fits), a per-worker health machine ejects workers on consecutive
failures and probes them back in, and ``Fleet.drain`` removes a worker
gracefully — in-flight batches finish, queued requests re-route,
nothing admitted is lost.  ``Fleet.kill``/``Fleet.respawn`` are the
*ungraceful* pair behind ``repro_torch.chaos``: a killed worker's
queued and mid-dispatch requests re-route on their original deadlines,
and a respawn from the shared ``repro_torch.ops.StoreRoot`` re-admits
the worker through the health-probe path with zero preparations.

The same routers drive ``repro_torch.fleet.sim`` — a virtual-clock
simulator that replays seeded traces bit-reproducibly, field for field
the reference's.
"""

from repro_torch.fleet.fleet import (
    TIER_PRIORITY,
    Fleet,
    FleetError,
    FleetRequest,
    FleetSaturated,
    NoWorkerAvailable,
)
from repro_torch.fleet.health import HealthPolicy, WorkerHealth
from repro_torch.fleet.router import (
    TIERS,
    LeastLoadedRouter,
    PlanAwareRouter,
    RoundRobinRouter,
    Router,
    WorkerView,
    get_router,
    list_routers,
)
from repro_torch.fleet.sim import (
    DEFAULT_TIERS,
    SimResult,
    SimWorkerSpec,
    TierSpec,
    Trace,
    make_trace,
    profile_speed,
    simulate,
)
from repro_torch.fleet.worker import NOMINAL_V5E_RATE, FleetWorker, nominal_rate

__all__ = [
    "DEFAULT_TIERS",
    "Fleet",
    "FleetError",
    "FleetRequest",
    "FleetSaturated",
    "FleetWorker",
    "HealthPolicy",
    "LeastLoadedRouter",
    "NOMINAL_V5E_RATE",
    "NoWorkerAvailable",
    "PlanAwareRouter",
    "RoundRobinRouter",
    "Router",
    "SimResult",
    "SimWorkerSpec",
    "TIERS",
    "TIER_PRIORITY",
    "TierSpec",
    "Trace",
    "WorkerHealth",
    "WorkerView",
    "get_router",
    "list_routers",
    "make_trace",
    "nominal_rate",
    "profile_speed",
    "simulate",
]
