"""``StoreRoot``: one shared durable-state location for a whole fleet.

Port of ``repro.ops.root``, built on the port's ``ops.store.PlanStore``
and ``ops.cache.PersistentExecutableCache``.  One directory holds the
fleet's ``PlanStore`` *and* one shared executable-cache location,
coordinated across worker processes with per-worker **lease files**, so
a respawned worker rebuilds its predecessor's serving state without
preparing a launch or running ``nvcc``::

    <root>/plans/        live plans        (PlanStore — same layout)
    <root>/retired/      retired plans
    <root>/quarantine/   corrupt plans
    <root>/exec-cache/   stored launch records (shared by workers), and
                         their kernel libraries under exec-cache/kernels/
    <root>/leases/<worker_id>   one JSON lease per live worker identity

Usage::

    root = StoreRoot("state")
    root.plans.save(plan, "cnn-v5e")
    lease = root.acquire_lease("w0")       # crash-safe worker identity
    cache = root.exec_cache()              # warm across restarts
    ...
    lease.release()

Lease semantics — deliberately minimal:

* ``acquire_lease`` creates ``leases/<worker_id>`` with
  ``O_CREAT | O_EXCL`` (atomic on every POSIX filesystem), recording
  the holder's pid.  A second *live* process claiming the same
  ``worker_id`` gets ``LeaseHeld`` — two gateways must never serve one
  worker identity off one store.
* A lease whose recorded pid is **dead** (or is this very process) is
  taken over atomically: crash recovery must not require manual lock
  removal.  Same-process takeover is what lets ``Fleet.respawn`` build
  the replacement gateway in the process that held the old one.
* Leases guard **cross-process** duplication only.  Two threads of one
  process racing the same worker_id is a caller bug, not a lease
  feature — in-process coordination belongs to ``Fleet``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import List, Union

from repro_torch.ops.cache import PersistentExecutableCache
from repro_torch.ops.store import PlanStore
from repro_torch.runtime.plan_io import _fsync_dir

__all__ = ["StoreRoot", "Lease", "LeaseHeld"]


class LeaseHeld(RuntimeError):
    """Another live process holds this worker's lease."""


def _pid_alive(pid: int) -> bool:
    """Is ``pid`` a live process?  ``PermissionError`` means it exists
    but belongs to someone else — still alive."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


class Lease:
    """A held per-worker lease file (see ``StoreRoot``)."""

    def __init__(self, path: Path, worker_id: str, pid: int,
                 token: float):
        self.path = path
        self.worker_id = worker_id
        self.pid = pid
        self.token = token            # acquired_at written into the file
        self._released = False

    @property
    def held(self) -> bool:
        return not self._released

    def release(self) -> None:
        """Remove the lease file (idempotent).  The unlink is
        token-checked: if a successor has already taken the lease over
        (same worker_id, newer ``acquired_at``), this stale handle
        leaves the successor's file alone — releasing an old handle
        after a respawn must never evict the live holder."""
        if self._released:
            return
        self._released = True
        try:
            current = json.loads(self.path.read_text(encoding="utf-8"))
            if current.get("pid") != self.pid \
                    or current.get("acquired_at") != self.token:
                return                 # taken over: not ours to remove
            self.path.unlink()
        except (OSError, ValueError, AttributeError):
            pass

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        state = "held" if self.held else "released"
        return (f"Lease(worker_id={self.worker_id!r}, pid={self.pid}, "
                f"{state})")


class StoreRoot:
    """One shared durable-state directory for a fleet (see module
    docstring)."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        self.plans = PlanStore(self.root)
        self.exec_cache_dir = self.root / "exec-cache"
        self._leases = self.root / "leases"
        for d in (self.exec_cache_dir, self._leases):
            d.mkdir(parents=True, exist_ok=True)

    # -- the shared executable tier -----------------------------------

    def exec_cache(self, **kwargs) -> PersistentExecutableCache:
        """A fresh ``PersistentExecutableCache`` over the shared disk
        tier.  Each caller gets its own in-memory tier (counters and
        single-flight state are per-process), but every instance reads
        and writes the same ``exec-cache/`` directory — a respawned
        worker makes its launches from what its predecessor prepared."""
        return PersistentExecutableCache(self.exec_cache_dir, **kwargs)

    # -- worker leases ------------------------------------------------

    def _lease_path(self, worker_id: str) -> Path:
        PlanStore._check_id(worker_id)   # same portable-filename rules
        return self._leases / worker_id

    def acquire_lease(self, worker_id: str) -> Lease:
        """Claim ``worker_id`` for this process; ``LeaseHeld`` if a
        *live* foreign process already holds it.  Dead-holder and
        own-pid leases are taken over atomically."""
        path = self._lease_path(worker_id)
        token = time.time()
        payload = json.dumps({"worker_id": worker_id, "pid": os.getpid(),
                              "acquired_at": token})
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            holder = self._holder_pid(path)
            if holder is not None and holder != os.getpid() \
                    and _pid_alive(holder):
                raise LeaseHeld(
                    f"worker {worker_id!r} is leased by live pid "
                    f"{holder} ({path})") from None
            # stale (dead holder / unreadable) or our own: take over
            tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            _fsync_dir(self._leases)
            return Lease(path, worker_id, os.getpid(), token)
        try:
            os.write(fd, payload.encode("utf-8"))
            os.fsync(fd)
        finally:
            os.close(fd)
        _fsync_dir(self._leases)
        return Lease(path, worker_id, os.getpid(), token)

    @staticmethod
    def _holder_pid(path: Path):
        try:
            return int(json.loads(path.read_text(encoding="utf-8"))
                       .get("pid", -1))
        except (OSError, ValueError, AttributeError):
            return None   # unreadable/torn lease: treat as stale

    def list_leases(self) -> List[str]:
        """Sorted worker ids with a lease file on disk (live or stale)."""
        return sorted(p.name for p in self._leases.iterdir()
                      if not p.name.startswith("."))

    def __repr__(self) -> str:
        return (f"StoreRoot(root={str(self.root)!r}, "
                f"plans={len(self.plans)}, "
                f"leases={len(self.list_leases())})")
