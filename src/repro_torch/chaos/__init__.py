"""``repro_torch.chaos`` — deterministic fault injection and fleet
recovery (port of ``repro.chaos``).

Production-viability is survival under faults, not just peak
throughput.  This package proves the serving stack's invariants hold
through failures, with the same determinism the planner applies to
resources:

* ``FaultPlan`` / ``FaultSpec`` / ``make_fault_plan`` — a seeded,
  JSON-serializable schedule of faults (worker crash mid-dispatch,
  stalled heartbeat, corrupt cache entry, torn plan write, tracker
  disk-full);
* ``FaultInjector`` — executes a plan's runtime faults through the
  production seams (``SlotPool``/``AsyncCNNGateway`` ``faults=``,
  ``JsonlTracker`` ``io_fault=``), never monkeypatches;
  ``corrupt_cache_entries`` / ``tear_plan_write`` apply the disk
  faults;
* ``respawn_gateway`` — restart-from-store recovery: rebuild a dead
  worker's gateway from a shared ``repro_torch.ops.StoreRoot`` (lease
  takeover, plans from the shared ``PlanStore``, launches made from
  the shared cache's records → zero preparations), ready for
  ``Fleet.respawn`` to re-admit through the health-probe path.

The fleet-wide contract under kill→restart, held by the port's tests
and by ``chip_smoke.py`` on the card (live and in ``fleet.sim``):
``completed + refused == trace`` and ``lost == 0`` — every request
either completes on its original deadline budget or is refused
loudly; none vanish.
"""

from repro_torch.chaos.inject import (FaultInjector, FaultSeam,
                                      HeartbeatStalled, TrackerDiskFull,
                                      WorkerCrashed, corrupt_cache_entries,
                                      tear_plan_write)
from repro_torch.chaos.plan import (FAULT_KINDS, FAULT_PLAN_SCHEMA_VERSION,
                                    FaultPlan, FaultSpec, make_fault_plan)
from repro_torch.chaos.recovery import respawn_gateway

__all__ = [
    "FAULT_KINDS", "FAULT_PLAN_SCHEMA_VERSION", "FaultSpec", "FaultPlan",
    "make_fault_plan",
    "FaultInjector", "FaultSeam",
    "WorkerCrashed", "HeartbeatStalled", "TrackerDiskFull",
    "corrupt_cache_entries", "tear_plan_write",
    "respawn_gateway",
]
