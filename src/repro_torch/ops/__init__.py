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
  preparations (``--store-root``);
* ``spans`` — the serving path's spans (``spans.RECORDER``): the
  gateway's stages, each request's submit and queue wait, the
  runtime's copies and layer loop, the MoE expert products and garbage
  collection, on one monotonic clock.  They are recorded only while a
  ``torch.profiler`` session records, each stretch of code also as a
  ``record_function`` range: profile the server with CPU and CUDA
  activity to see them on the trace's host lanes, over the kernels
  they launch.

``spans`` loads with the package, since the runtime and the models
import it; the other modules load at the first use of one of their
names, since ``cache`` builds on the runtime.
"""

from importlib import import_module

from repro_torch.ops import spans

#: each exported name and the module that defines it
_EXPORTS = {
    "PlanStore": "store", "PlanStoreError": "store",
    "PlanNotFound": "store", "PlanRetired": "store",
    "PlanCorrupt": "store", "PlanUnsupported": "store",
    "PersistentExecutableCache": "cache", "cache_fingerprint": "cache",
    "CACHE_FORMAT_VERSION": "cache",
    "StoreRoot": "root", "Lease": "root", "LeaseHeld": "root",
    "Tracker": "tracker", "NullTracker": "tracker",
    "JsonlTracker": "tracker", "StatsSampler": "tracker",
    "TrackerLog": "tracker", "read_log": "tracker",
    "read_events": "tracker",
}

__all__ = list(_EXPORTS) + ["spans"]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
