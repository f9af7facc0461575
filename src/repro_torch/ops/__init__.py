"""``repro_torch.ops`` — durable plans and ops telemetry (port of the
plan-store and tracker half of ``repro.ops``).

* ``PlanStore`` — crash-safe on-disk plan repository
  (save/load/retire/quarantine, atomic writes), behind the launcher's
  ``--plan-store``;
* ``Tracker`` / ``JsonlTracker`` / ``StatsSampler`` — background-
  threaded telemetry that records lifecycle events and periodic
  ``stats()`` snapshots without ever blocking the serving path
  (``read_log`` parses a file back with its seal totals), behind the
  launcher's ``--metrics-out`` and the gateway's ``tracker=``.

The persistent executable cache and the shared store root of the
reference (``cache.py``, ``root.py``) are not ported yet.
"""

from repro_torch.ops.store import (PlanCorrupt, PlanNotFound, PlanRetired,
                                   PlanStore, PlanStoreError,
                                   PlanUnsupported)
from repro_torch.ops.tracker import (JsonlTracker, NullTracker,
                                     StatsSampler, Tracker, TrackerLog,
                                     read_events, read_log)

__all__ = [
    "PlanStore", "PlanStoreError", "PlanNotFound", "PlanRetired",
    "PlanCorrupt", "PlanUnsupported",
    "Tracker", "NullTracker", "JsonlTracker", "StatsSampler",
    "TrackerLog", "read_log", "read_events",
]
