"""Restart-from-store: rebuild a dead worker's gateway from a shared
``StoreRoot``.  Port of ``repro.chaos.recovery``.

``respawn_gateway`` is the factory ``Fleet.respawn`` (or a
``FleetWorker(..., spawn=...)`` closure) uses to replace a killed
worker's process:

    root = StoreRoot("state")                    # shared by the fleet
    gw = respawn_gateway(root, "w1-v5e", ["cnn-v5e"])
    await fleet.respawn("w1-v5e", gateway=gw)

What "from the store" buys:

* the worker's **lease** is (re-)acquired — a takeover when the old
  holder is dead or is this very process, ``LeaseHeld`` when another
  live process still claims the identity;
* its **plans** are loaded from the shared ``PlanStore`` — no
  re-planning;
* its **launches** are made from the shared
  ``PersistentExecutableCache`` directory's records, and their kernel
  libraries loaded from ``exec-cache/kernels/`` — the predecessor
  already paid the preparation and the ``nvcc`` runs, so a warm
  respawn serves its first request with **zero preparations** and, in
  a fresh process, zero compiler runs.

The gateway runs on ``device`` (the card unless the caller asks for the
CPU), with each plan's weights from ``params[plan_id]`` where given,
else the seeded draw ``register_plan`` makes — the same weights every
time, as the reference's respawn draws its own.  The returned gateway
carries the held lease as ``gw.lease``; release it when the gateway
retires for good (a later takeover by the same worker identity is safe
either way — lease release is token-checked).

This module imports only ``repro_torch.serve`` and ``repro_torch.ops``
— never ``repro_torch.fleet`` — so ``chaos`` sits below the fleet.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.device import DeviceLike
from repro_torch.ops.root import StoreRoot
from repro_torch.serve.async_engine import AsyncCNNGateway, AsyncServeConfig

__all__ = ["respawn_gateway"]


def respawn_gateway(root: StoreRoot, worker_id: str,
                    plan_ids: Sequence[str],
                    cfg: Optional[AsyncServeConfig] = None, *,
                    clock: Callable[[], float] = time.monotonic,
                    tracker=None, faults=None,
                    device: DeviceLike = "cuda",
                    params: Optional[Mapping[str, object]] = None
                    ) -> AsyncCNNGateway:
    """Build a replacement gateway for ``worker_id`` from the shared
    store (see module docstring).  Raises ``LeaseHeld`` when a live
    foreign process still owns the identity, and whatever the plan
    store raises when a plan is missing/corrupt — a respawn must fail
    loudly, not serve a partial plan set."""
    params = params or {}
    lease = root.acquire_lease(worker_id)
    try:
        gw = AsyncCNNGateway(cfg, clock=clock,
                             exec_cache=root.exec_cache(),
                             tracker=tracker, faults=faults)
        for plan_id in plan_ids:
            gw.register_plan(root.plans.load(plan_id), plan_id=plan_id,
                             params=params.get(plan_id), device=device)
    except BaseException:
        lease.release()
        raise
    gw.lease = lease
    return gw
