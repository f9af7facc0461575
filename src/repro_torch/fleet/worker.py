"""``FleetWorker`` — one serving worker in the fleet.  Port of
``repro.fleet.worker``; the profiles come from the port's catalog
(``core.allocate``: ``edge``, ``v5e``, ``v5p``).

A worker binds together the three identities the router needs to agree
on: a **device profile** from ``deploy.DEVICE_CATALOG`` (what hardware
this worker's plans were made for, and what it costs), a **gateway**
(an ``AsyncCNNGateway``, or any object with the same ``submit`` /
``submit_nowait`` / ``snapshot`` / ``close`` surface — the simulator's
workers speak it too), and the **plans** registered on that gateway
(which requests it may legally receive).  On top it layers the two
pieces of fleet-only state: a ``WorkerHealth`` machine fed by serving
outcomes, and the ``draining`` flag that stops new admissions while
in-flight batches finish.

Health heartbeats ride the ``GatewayStats`` snapshot seam: ``view()``
captures one consistent snapshot per routing decision, and a worker
whose snapshot *raises* is treated as a failed heartbeat — it takes a
health strike and is presented to the router as unroutable.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

from repro_torch.core.allocate import V5E, DeviceProfile
from repro_torch.core.deploy import device_profile
from repro_torch.fleet.health import HealthPolicy, WorkerHealth
from repro_torch.fleet.router import WorkerView

#: nominal v5e service rate the profile-relative default is anchored to
#: (images/sec; only ratios between workers matter to the routers)
NOMINAL_V5E_RATE = 100.0


def nominal_rate(profile: DeviceProfile) -> float:
    """Profile-relative service-rate estimate: MXU budget relative to
    v5e × the nominal v5e rate.  Routers only compare waits *across*
    workers, so a consistent relative scale is all that's needed; pass
    a measured rate to ``FleetWorker`` when one is available."""
    return (NOMINAL_V5E_RATE * profile.budgets["mxu_cost"]
            / V5E.budgets["mxu_cost"])


class FleetWorker:
    """One gateway bound to a device profile, with health and drain
    state.  ``profile`` accepts a catalog name (``"edge"``) — resolved
    via ``deploy.device_profile``, so a typo raises ``DeploymentError``
    with the catalog spelled out — or a ``DeviceProfile`` directly."""

    def __init__(self, worker_id: str, gateway,
                 profile: Union[str, DeviceProfile] = "v5e", *,
                 rate: Optional[float] = None,
                 health: Optional[HealthPolicy] = None,
                 spawn: Optional[Callable[[], object]] = None):
        self.worker_id = worker_id
        self.gateway = gateway
        # zero-arg factory building a *replacement* gateway for this
        # worker identity (e.g. repro_torch.chaos.respawn_gateway over a
        # shared StoreRoot); Fleet.respawn calls it off the event loop
        self.spawn = spawn
        # set by Fleet.kill: the process behind the gateway is gone —
        # view() short-circuits to an unroutable view without taking
        # heartbeat strikes (death was already recorded by the kill;
        # re-striking would keep re-arming the exile clock and delay
        # the post-respawn probe)
        self.dead = False
        self.profile = (device_profile(profile)
                        if isinstance(profile, str) else profile)
        self.rate = (float(rate) if rate is not None
                     else nominal_rate(self.profile))
        if self.rate <= 0:
            raise ValueError(f"worker {worker_id!r}: rate={self.rate} "
                             f"must be > 0")
        self.health = WorkerHealth(health if health is not None
                                   else HealthPolicy())
        self.draining = False
        # fleet requests currently handed to this worker (queued or
        # in-flight on its gateway); drain() waits for this to empty
        self.outstanding: set = set()
        self._idle_waiters: list = []       # asyncio Events, fleet-owned

    @property
    def plan_ids(self):
        """Plans this worker can serve (live view of its registry).
        Prefers the gateway's ``routable_plans`` so a plan being
        retired disappears from routing the moment its admission
        closes, not when its last in-flight request finishes."""
        routable = getattr(self.gateway, "routable_plans", None)
        if routable is not None:
            return frozenset(routable)
        return frozenset(self.gateway.plans)

    @property
    def workload_kinds(self):
        """The workload kinds behind this worker's plans (``{"cnn"}``,
        ``{"moe"}``, or both on a mixed worker).  Placement by plan id
        subsumes placement by kind — a worker only lists a plan it
        could register, and registering an MoE plan on an edge-profile
        worker fails at planning time — but the kinds make mixed-fleet
        telemetry and capacity audits legible."""
        kinds = set()
        for entry in self.gateway.plans.values():
            compiled = getattr(entry, "compiled", entry)
            kinds.add(getattr(compiled, "kind", "cnn"))
        return frozenset(kinds)

    def view(self, now: Optional[float] = None, *,
             clock: Callable[[], float] = time.monotonic) -> WorkerView:
        """The router's one-snapshot projection of this worker.  A
        failing ``snapshot()`` is a missed heartbeat: it strikes the
        health machine and yields an unroutable view instead of
        raising into the routing path."""
        now = clock() if now is None else now
        rate, est_wait_s = self.rate, None
        if self.dead:
            return WorkerView(
                self.worker_id, cost=self.profile.cost,
                plan_ids=self.plan_ids, rate=rate, max_batch=1,
                queue_depth=0, inflight=0, healthy=False,
                draining=self.draining)
        try:
            snap = self.gateway.snapshot()
            queue_depth, inflight = snap.queue_depth, snap.inflight
            max_batch = snap.max_batch
            # prefer the gateway's *measured* throughput telemetry over
            # the profile-relative nominal rate once the EWMA has warmed
            # up — routers then compare real waits, not modeled ones
            measured = getattr(snap, "service_rate", 0.0)
            if measured and measured > 0.0:
                rate = measured
                est_wait_s = snap.est_wait
            reachable = True
        except Exception:           # noqa: BLE001 — unreachable worker
            self.health.note_failure(now)
            queue_depth = inflight = 0
            max_batch = 1
            reachable = False
        return WorkerView(
            self.worker_id, cost=self.profile.cost,
            plan_ids=self.plan_ids, rate=rate, max_batch=max_batch,
            queue_depth=queue_depth, inflight=inflight,
            healthy=reachable and self.health.routable(now),
            draining=self.draining, est_wait_s=est_wait_s)

    def __repr__(self) -> str:                    # pragma: no cover
        return (f"FleetWorker({self.worker_id!r}, "
                f"profile={self.profile.name!r}, "
                f"plans={sorted(self.plan_ids)}, "
                f"draining={self.draining})")
