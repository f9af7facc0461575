"""``repro_torch.ops`` — durable serving state and ops telemetry (port
of ``repro.ops``).

* ``PlanStore`` — crash-safe on-disk plan repository
  (save/load/retire/quarantine, atomic writes), behind the launcher's
  ``--plan-store``;
* ``PersistentExecutableCache`` — disk tier under
  ``runtime.ExecutableCache``: each prepared (layer, bucket) launch is
  stored as a record, its kernel libraries beside it, so a warm restart
  prepares nothing and runs no ``nvcc`` (``--cache-dir``);
* ``Tracker`` / ``JsonlTracker`` / ``StatsSampler`` — background-
  threaded telemetry that records lifecycle events and periodic
  ``stats()`` snapshots without ever blocking the serving path
  (``read_log`` parses a file back with its seal totals), behind the
  launcher's ``--metrics-out`` and the gateway's ``tracker=``;
* ``StoreRoot`` — one shared plan-store + executable-cache location
  for a whole fleet, with per-worker leases (``Lease``, ``LeaseHeld``),
  so a respawned worker warm-starts from its dead predecessor's
  preparations (``--store-root``).
"""

from repro_torch.ops.cache import (CACHE_FORMAT_VERSION,
                                   PersistentExecutableCache,
                                   cache_fingerprint)
from repro_torch.ops.root import Lease, LeaseHeld, StoreRoot
from repro_torch.ops.store import (PlanCorrupt, PlanNotFound, PlanRetired,
                                   PlanStore, PlanStoreError,
                                   PlanUnsupported)
from repro_torch.ops.tracker import (JsonlTracker, NullTracker,
                                     StatsSampler, Tracker, TrackerLog,
                                     read_events, read_log)

__all__ = [
    "PlanStore", "PlanStoreError", "PlanNotFound", "PlanRetired",
    "PlanCorrupt", "PlanUnsupported",
    "PersistentExecutableCache", "cache_fingerprint",
    "CACHE_FORMAT_VERSION",
    "StoreRoot", "Lease", "LeaseHeld",
    "Tracker", "NullTracker", "JsonlTracker", "StatsSampler",
    "TrackerLog", "read_log", "read_events",
]
