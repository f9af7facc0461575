"""Fault enforcement: the ``FaultInjector`` behind the runtime seams,
plus deterministic disk-fault helpers.  Port of ``repro.chaos.inject``.

Runtime faults ride the production seams rather than monkeypatches:

* ``SlotPool``/``AsyncCNNGateway`` accept ``faults=`` — an object with
  ``check(point, now=..., **ctx)`` consulted at the **"dispatch"** seam
  (inside ``_run_batch``'s try, so a raise takes the real
  failed-dispatch path) and the **"heartbeat"** seam (``snapshot()``,
  so a raise reads as a missed heartbeat to ``FleetWorker.view``);
* ``JsonlTracker`` accepts ``io_fault=`` — a callable invoked before
  each disk write; ``FaultInjector.tracker_io_fault`` builds one from
  the plan's ``tracker_disk_full`` specs.

One injector executes one ``FaultPlan`` for any number of workers:
``for_target(worker_id)`` binds a per-worker seam to pass as the
gateway's ``faults=``.  A fired ``crash_dispatch`` is **sticky** — the
target keeps raising ``WorkerCrashed`` at every seam until
``revive(target)`` — because a dead process stays dead until something
restarts it; ``Fleet.respawn`` swaps in a fresh gateway (typically
*without* a bound seam), which is that restart.

Disk faults (``corrupt_cache_entry``, ``torn_plan_write``) are not
runtime checks: the harness applies them at the scheduled moment with
the deterministic helpers here (``corrupt_cache_entries``,
``tear_plan_write``) and the recovery layer proves serving survives.

This module imports nothing from ``repro_torch.fleet`` or
``repro_torch.serve`` — ``fleet.fleet`` imports ``WorkerCrashed`` from
here, so the dependency only points downward.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

from repro_torch.chaos.plan import FaultPlan, FaultSpec

__all__ = ["WorkerCrashed", "HeartbeatStalled", "TrackerDiskFull",
           "FaultInjector", "FaultSeam", "corrupt_cache_entries",
           "tear_plan_write"]


class WorkerCrashed(RuntimeError):
    """The worker process died (injected at the dispatch seam; the
    fleet treats it as a death, not a per-request failure)."""


class HeartbeatStalled(RuntimeError):
    """The worker's stats snapshot hung (injected at the heartbeat
    seam; reads as a missed heartbeat upstream)."""


class TrackerDiskFull(OSError):
    """The telemetry disk refused a write (injected via the tracker's
    ``io_fault`` seam)."""


#: which seam points each runtime fault kind fires at
_KIND_POINTS = {"crash_dispatch": ("dispatch",),
                "stall_heartbeat": ("heartbeat",)}


class FaultSeam:
    """A ``FaultInjector`` bound to one target — the object a gateway
    takes as ``faults=``.  ``check(point, now=...)`` raises when the
    plan says this target fails at this point now."""

    def __init__(self, injector: "FaultInjector", target: str):
        self.injector = injector
        self.target = target

    def check(self, point: str, now: Optional[float] = None,
              **ctx) -> None:
        self.injector.check(self.target, point, now=now, **ctx)

    def __repr__(self) -> str:                    # pragma: no cover
        return f"FaultSeam(target={self.target!r})"


class FaultInjector:
    """Executes a ``FaultPlan``'s runtime faults (see module docstring).

    Thread-safe: gateways consult seams from the event loop while the
    dispatch executor and samplers read clocks elsewhere.  ``injected``
    logs every fault firing as ``(kind, target, now)`` so harnesses can
    assert the schedule actually happened.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._counts: Dict[FaultSpec, int] = {}
        self._fired: set = set()       # one-shot specs already fired
        self._crashed: set = set()     # targets sticky-crashed
        self.injected: List[tuple] = []

    def for_target(self, target: str) -> FaultSeam:
        return FaultSeam(self, target)

    def revive(self, target: str) -> None:
        """Clear a sticky crash — the restart side of the fault.  The
        crash spec that fired stays consumed, so a revived target does
        not immediately re-crash."""
        with self._lock:
            self._crashed.discard(target)

    @property
    def crashed(self) -> frozenset:
        with self._lock:
            return frozenset(self._crashed)

    # -- trigger/window evaluation (under self._lock) -----------------

    def _visit(self, spec: FaultSpec) -> int:
        n = self._counts.get(spec, 0) + 1
        self._counts[spec] = n
        return n

    def _active(self, spec: FaultSpec, now: Optional[float],
                visits: int) -> bool:
        if spec.at is not None:
            if now is None or now < spec.at:
                return False
            if spec.duration_s is not None \
                    and now >= spec.at + spec.duration_s:
                return False
            return True
        if visits < spec.after_n:
            return False
        if spec.count is not None \
                and visits >= spec.after_n + spec.count:
            return False
        return True

    # -- the runtime seam ---------------------------------------------

    def check(self, target: str, point: str,
              now: Optional[float] = None, **ctx) -> None:
        with self._lock:
            if target in self._crashed:
                raise WorkerCrashed(
                    f"worker {target!r} is dead (injected crash)")
            for spec in self.plan.for_target(target):
                points = _KIND_POINTS.get(spec.kind, ())
                if point not in points:
                    continue
                visits = self._visit(spec)
                if spec.kind == "crash_dispatch":
                    if spec in self._fired \
                            or not self._active(spec, now, visits):
                        continue
                    self._fired.add(spec)
                    self._crashed.add(target)
                    self.injected.append((spec.kind, target, now))
                    raise WorkerCrashed(
                        f"worker {target!r} crashed mid-dispatch "
                        f"(injected at t={now})")
                if spec.kind == "stall_heartbeat" \
                        and self._active(spec, now, visits):
                    self.injected.append((spec.kind, target, now))
                    raise HeartbeatStalled(
                        f"worker {target!r} heartbeat stalled "
                        f"(injected at t={now})")

    # -- the tracker seam ---------------------------------------------

    def tracker_io_fault(self, target: str
                         ) -> Optional[Callable[[dict], None]]:
        """An ``io_fault`` callable for ``JsonlTracker`` enforcing this
        target's ``tracker_disk_full`` specs, or None when the plan has
        none for it (so callers can pass it through unconditionally)."""
        specs = [s for s in self.plan.for_target(target)
                 if s.kind == "tracker_disk_full"]
        if not specs:
            return None

        def io_fault(entry: dict) -> None:
            with self._lock:
                for spec in specs:
                    visits = self._visit(spec)
                    if self._active(spec, None, visits):
                        self.injected.append((spec.kind, target, visits))
                        raise TrackerDiskFull(
                            f"telemetry disk full for {target!r} "
                            f"(injected, write #{visits})")

        return io_fault


# ---------------------------------------------------------------------------
# disk-fault helpers (applied by the harness at the scheduled moment)
# ---------------------------------------------------------------------------

_GARBAGE = b"\x00repro_torch.chaos: corrupted cache entry\x00"


def corrupt_cache_entries(cache_dir: Union[str, Path], *,
                          limit: Optional[int] = None) -> List[Path]:
    """Overwrite stored cache entries (``*.exe``) with garbage bytes —
    the on-disk effect of bit-rot or a torn write that slipped past
    fsync.  Deterministic: entries are hit in sorted order, ``limit``
    bounds how many.  Returns the paths corrupted.  Recovery contract:
    the cache quarantines each as ``*.corrupt`` and re-prepares it."""
    paths = sorted(Path(cache_dir).glob("*.exe"))
    if limit is not None:
        paths = paths[:limit]
    for p in paths:
        p.write_bytes(_GARBAGE)
    return paths


def tear_plan_write(store, plan_id: str, text: str, *,
                    cut: int) -> Path:
    """Stage what a crash mid-``atomic_write_text`` leaves behind: the
    temp file (same naming protocol — dot-prefixed, ``.tmp`` suffix,
    in the destination directory) holding the first ``cut`` bytes of
    ``text``, **without** the rename.  The store contract under test:
    the torn temp never shadows the live plan and never appears in
    listings — a reader after the crash sees the old plan bytes."""
    dest = store.path_for(plan_id)
    data = text.encode("utf-8")[:cut]
    tmp = dest.parent / (f".{dest.name}.{os.getpid()}"
                         f".{threading.get_ident()}.tmp")
    tmp.write_bytes(data)
    return tmp
