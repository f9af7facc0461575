"""``PlanStore``: an on-disk, crash-safe repository of deployment plans.

Port of ``repro.ops.store``; the two packages read and write the same
layout and the same plan artifacts, so a store written by one loads in
the other.

A gateway restart used to forget every registered plan — re-deriving
them meant re-running the planner (the software analog of the paper's
synthesis loop).  ``PlanStore`` keeps the versioned plan artifacts on
disk, keyed by ``plan_id``, so plans outlive the process:

    store = PlanStore("state/plans")
    store.save(plan, "cnn-v5e")           # atomic tmp+fsync+rename
    ...restart...
    plan = store.load("cnn-v5e")          # exactly the saved bytes
    store.retire("cnn-v5e")               # atomic move to retired/

Layout under the root directory::

    plans/<plan_id>.json       live plans (schema-versioned via plan_io)
    retired/<plan_id>.json     retired plans, kept for audit
    quarantine/<file>          corrupt payloads moved aside, never deleted

Guarantees:

* **No torn reads.** Every write goes through
  ``plan_io.atomic_write_text`` (tmp file in the same directory, fsync,
  ``os.replace``) and retire is a single ``os.replace`` — a concurrent
  reader sees either the complete old artifact or the complete new one.
* **Corruption is quarantined, not propagated.** A payload that fails
  to parse is moved to ``quarantine/`` and ``load`` raises
  ``PlanCorrupt`` naming the quarantined path; the store itself stays
  healthy.
* **A plan of a workload kind the port does not serve yet is left in
  place.** A store may be shared with the reference package, and both
  now serve the same kinds (``cnn`` and ``moe``); should the reference
  gain a kind the port lacks (``runtime.workloads._NOT_YET_PORTED``),
  ``load`` raises ``PlanUnsupported`` and the artifact stays live, for
  the package that can serve it.
* **Retire is terminal but auditable.** ``load`` of a retired id raises
  ``PlanRetired`` (a ``KeyError`` subclass) rather than silently
  resurrecting it; the artifact remains under ``retired/``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Union

from repro_torch.core.deploy import DeploymentPlan
from repro_torch.runtime.plan_io import _fsync_dir, atomic_write_text

__all__ = [
    "PlanStore", "PlanStoreError", "PlanNotFound", "PlanRetired",
    "PlanCorrupt", "PlanUnsupported",
]

# plan_ids become filenames: accept a conservative portable subset and
# refuse anything that could traverse directories or hide as a dotfile.
_PLAN_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,99}$")


class PlanStoreError(RuntimeError):
    """Base class for plan-store failures."""


class PlanNotFound(PlanStoreError, KeyError):
    """No live or retired plan under this id."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep it readable
        return RuntimeError.__str__(self)


class PlanRetired(PlanStoreError, KeyError):
    """The plan exists but was retired; ``load`` refuses to serve it."""

    def __str__(self) -> str:
        return RuntimeError.__str__(self)


class PlanCorrupt(PlanStoreError):
    """The artifact failed to parse; it was moved to quarantine."""


class PlanUnsupported(PlanStoreError):
    """The artifact is a well-formed plan of a workload kind the
    reference serves and this package does not yet; it was left where
    it is."""


class PlanStore:
    """Directory-backed plan repository (see module docstring)."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        self._live = self.root / "plans"
        self._retired = self.root / "retired"
        self._quarantine = self.root / "quarantine"
        for d in (self._live, self._retired, self._quarantine):
            d.mkdir(parents=True, exist_ok=True)

    # -- paths -------------------------------------------------------

    @staticmethod
    def _check_id(plan_id: str) -> str:
        if not _PLAN_ID_RE.match(plan_id):
            raise ValueError(
                f"invalid plan_id {plan_id!r}: must match "
                f"{_PLAN_ID_RE.pattern}")
        return plan_id

    def path_for(self, plan_id: str) -> Path:
        return self._live / f"{self._check_id(plan_id)}.json"

    def retired_path_for(self, plan_id: str) -> Path:
        return self._retired / f"{self._check_id(plan_id)}.json"

    # -- write side --------------------------------------------------

    def save(self, plan: DeploymentPlan, plan_id: str) -> Path:
        """Persist ``plan`` under ``plan_id`` (atomic; overwrite OK).

        Saving an id that was retired revives it as a *new* live plan —
        the retired artifact stays in ``retired/`` for audit.
        """
        if not isinstance(plan, DeploymentPlan):
            raise PlanStoreError(
                f"save expects a DeploymentPlan, got {type(plan).__name__}")
        return atomic_write_text(self.path_for(plan_id), plan.to_json())

    def retire(self, plan_id: str) -> Path:
        """Atomically move a live plan to ``retired/``.

        Raises ``PlanNotFound`` if no live plan exists (retiring an
        already-retired id is not an error a second time only if the
        live file still exists — it won't, so callers get
        ``PlanNotFound``, which is the honest answer).
        """
        src = self.path_for(plan_id)
        dst = self.retired_path_for(plan_id)
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            raise PlanNotFound(f"no live plan {plan_id!r} to retire "
                               f"(root={self.root})") from None
        _fsync_dir(self._live)
        _fsync_dir(self._retired)
        return dst

    # -- read side ---------------------------------------------------

    def _read(self, path: Path, plan_id: str) -> DeploymentPlan:
        try:
            text = path.read_text(encoding="utf-8")
        except FileNotFoundError:
            raise PlanNotFound(
                f"no plan {plan_id!r} in store (root={self.root})"
            ) from None
        try:
            return DeploymentPlan.from_json(text)
        except NotImplementedError as err:
            raise PlanUnsupported(
                f"plan {plan_id!r} is of a workload kind this package "
                f"does not serve ({err}); left at {path}") from err
        except Exception as err:
            qpath = self._quarantine / path.name
            try:
                os.replace(path, qpath)
            except OSError:
                qpath = path          # couldn't move; name it in place
            raise PlanCorrupt(
                f"plan {plan_id!r} failed to parse ({err}); "
                f"quarantined at {qpath}") from err

    def load(self, plan_id: str) -> DeploymentPlan:
        """Load a live plan; ``PlanRetired``/``PlanNotFound``/
        ``PlanCorrupt``/``PlanUnsupported`` otherwise."""
        path = self.path_for(plan_id)
        if not path.exists():
            if self.retired_path_for(plan_id).exists():
                raise PlanRetired(
                    f"plan {plan_id!r} was retired (root={self.root})")
            raise PlanNotFound(
                f"no plan {plan_id!r} in store (root={self.root})")
        return self._read(path, plan_id)

    def load_retired(self, plan_id: str) -> DeploymentPlan:
        """Load a retired plan's artifact (audit/rollback tooling)."""
        return self._read(self.retired_path_for(plan_id), plan_id)

    # -- listing -----------------------------------------------------

    @staticmethod
    def _ids_in(d: Path) -> List[str]:
        out = []
        for p in d.iterdir():
            # skip in-flight temp files and anything non-plan-shaped
            if p.suffix == ".json" and not p.name.startswith("."):
                out.append(p.stem)
        return sorted(out)

    def list_plans(self) -> List[str]:
        """Sorted ids of live plans."""
        return self._ids_in(self._live)

    def list_retired(self) -> List[str]:
        """Sorted ids of retired plans."""
        return self._ids_in(self._retired)

    def __contains__(self, plan_id: str) -> bool:
        try:
            return self.path_for(plan_id).exists()
        except ValueError:
            return False

    def __len__(self) -> int:
        return len(self.list_plans())

    def __repr__(self) -> str:
        return (f"PlanStore(root={str(self.root)!r}, "
                f"live={len(self)}, retired={len(self.list_retired())})")
