"""``FaultPlan`` — a seeded, serializable schedule of injected faults.

Port of ``repro.chaos.plan``: pure Python, the same schema (version 1),
so a plan either package writes loads in the other, and the same seed
gives the same plan.

The paper's planning loop works because resource behavior is
*predictable*; the chaos layer applies the same discipline to failure
testing: faults are not random monkeypatches sprinkled at runtime but a
**plan** — JSON-serializable like ``DeploymentPlan``, derivable from a
seed, diffable in a repo — that both the live asyncio fleet and the
virtual-clock simulator can execute, so a failing chaos run replays
bit-for-bit from its plan.

A plan is a tuple of ``FaultSpec``s.  Each spec names

* ``kind`` — one of ``FAULT_KINDS``;
* ``target`` — the unit it hits (a ``worker_id`` for runtime faults,
  a store/cache label for disk faults);
* a **trigger**: ``at`` (seconds on the harness clock) *or*
  ``after_n`` (the n-th visit to the fault's seam point) — exactly one;
* optionally a window: ``duration_s`` (time-triggered transients) or
  ``count`` (occurrence-triggered transients).  Absent, a transient
  fault is permanent until revived and a crash is always sticky.

Kinds and where they bite:

====================  ====================================================
``crash_dispatch``    the worker dies mid-dispatch — raises
                      ``WorkerCrashed`` at the gateway's "dispatch" seam;
                      sticky until ``FaultInjector.revive``
``stall_heartbeat``   ``snapshot()`` raises ``HeartbeatStalled`` at the
                      "heartbeat" seam — the fleet reads a missed
                      heartbeat, exactly like a hung process
``corrupt_cache_entry``  disk fault: a stored cache entry is
                      overwritten with garbage
                      (``inject.corrupt_cache_entries``)
``torn_plan_write``   disk fault: a ``PlanStore`` atomic-write temp file
                      is left truncated, as a crash mid-write would
                      (``inject.tear_plan_write``)
``tracker_disk_full`` the tracker's disk writes fail — injected through
                      ``JsonlTracker(io_fault=...)``
====================  ====================================================

Runtime kinds are enforced by ``inject.FaultInjector`` through the
``SlotPool.faults`` seam; disk kinds are applied by the harness with
the ``inject`` helpers at the scheduled moment — the plan is the single
schedule for both.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

__all__ = ["FAULT_KINDS", "FAULT_PLAN_SCHEMA_VERSION", "FaultSpec",
           "FaultPlan", "make_fault_plan"]

FAULT_KINDS = ("crash_dispatch", "stall_heartbeat", "corrupt_cache_entry",
               "torn_plan_write", "tracker_disk_full")

FAULT_PLAN_SCHEMA_VERSION = 1

#: kinds whose window field is time (``duration_s``) vs occurrences
#: (``count``); crash kinds take no window (sticky until revive)
_TIME_WINDOW_KINDS = ("stall_heartbeat",)
_COUNT_WINDOW_KINDS = ("stall_heartbeat", "tracker_disk_full")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault (see module docstring)."""
    kind: str
    target: str
    at: Optional[float] = None         # trigger: harness-clock seconds
    after_n: Optional[int] = None      # trigger: n-th seam visit
    duration_s: Optional[float] = None   # window for time triggers
    count: Optional[int] = None          # window for occurrence triggers

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: "
                             f"{FAULT_KINDS}")
        if not self.target:
            raise ValueError("FaultSpec.target must be non-empty")
        if (self.at is None) == (self.after_n is None):
            raise ValueError(
                f"exactly one of at/after_n must be set "
                f"(got at={self.at}, after_n={self.after_n})")
        if self.at is not None and self.at < 0:
            raise ValueError(f"at={self.at} must be ≥ 0")
        if self.after_n is not None and self.after_n < 1:
            raise ValueError(f"after_n={self.after_n} must be ≥ 1")
        if self.duration_s is not None:
            if self.kind not in _TIME_WINDOW_KINDS:
                raise ValueError(
                    f"duration_s does not apply to kind {self.kind!r}")
            if self.duration_s <= 0:
                raise ValueError(
                    f"duration_s={self.duration_s} must be > 0")
        if self.count is not None:
            if self.kind not in _COUNT_WINDOW_KINDS:
                raise ValueError(
                    f"count does not apply to kind {self.kind!r}")
            if self.count < 1:
                raise ValueError(f"count={self.count} must be ≥ 1")

    def to_payload(self) -> dict:
        out = {"kind": self.kind, "target": self.target}
        for name in ("at", "after_n", "duration_s", "count"):
            val = getattr(self, name)
            if val is not None:
                out[name] = val
        return out

    @classmethod
    def from_payload(cls, payload: dict) -> "FaultSpec":
        known = {"kind", "target", "at", "after_n", "duration_s", "count"}
        extra = set(payload) - known
        if extra:
            raise ValueError(f"unknown FaultSpec fields: {sorted(extra)}")
        return cls(**payload)


@dataclass(frozen=True)
class FaultPlan:
    """An ordered, serializable set of scheduled faults."""
    specs: Tuple[FaultSpec, ...]
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    def __iter__(self):
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)

    def for_target(self, target: str) -> Tuple[FaultSpec, ...]:
        return tuple(s for s in self.specs if s.target == target)

    def of_kind(self, *kinds: str) -> Tuple[FaultSpec, ...]:
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        return tuple(s for s in self.specs if s.kind in kinds)

    # -- serialization (the DeploymentPlan idiom) ---------------------

    def to_payload(self) -> dict:
        out = {"schema_version": FAULT_PLAN_SCHEMA_VERSION,
               "specs": [s.to_payload() for s in self.specs]}
        if self.seed is not None:
            out["seed"] = self.seed
        return out

    def to_json(self, *, indent: int = 2) -> str:
        return json.dumps(self.to_payload(), indent=indent,
                          sort_keys=True)

    @classmethod
    def from_payload(cls, payload: dict) -> "FaultPlan":
        version = payload.get("schema_version")
        if version != FAULT_PLAN_SCHEMA_VERSION:
            raise ValueError(
                f"unknown FaultPlan schema_version {version!r} "
                f"(this build reads {FAULT_PLAN_SCHEMA_VERSION})")
        return cls(specs=tuple(FaultSpec.from_payload(p)
                               for p in payload["specs"]),
                   seed=payload.get("seed"))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_payload(json.loads(text))


def make_fault_plan(seed: int, *, workers: Sequence[str],
                    horizon_s: float,
                    kinds: Iterable[str] = ("crash_dispatch",)
                    ) -> FaultPlan:
    """Derive a reproducible ``FaultPlan`` from a seed: one spec per
    requested kind, each hitting a seeded-random worker at a
    seeded-random moment inside ``(0.2, 0.7) × horizon_s`` (away from
    the edges, so there is traffic both before and after the fault).
    The same ``(seed, workers, horizon_s, kinds)`` always yields the
    same plan — a failing chaos run names its seed and replays."""
    if not workers:
        raise ValueError("make_fault_plan needs at least one worker")
    if horizon_s <= 0:
        raise ValueError(f"horizon_s={horizon_s} must be > 0")
    rng = random.Random(seed)
    specs = []
    for kind in kinds:
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; known: "
                             f"{FAULT_KINDS}")
        target = rng.choice(list(workers))
        at = round(rng.uniform(0.2, 0.7) * horizon_s, 6)
        if kind == "stall_heartbeat":
            specs.append(FaultSpec(
                kind, target, at=at,
                duration_s=round(rng.uniform(0.05, 0.2) * horizon_s, 6)))
        elif kind == "tracker_disk_full":
            specs.append(FaultSpec(kind, target,
                                   after_n=rng.randint(1, 16),
                                   count=rng.randint(1, 8)))
        else:
            specs.append(FaultSpec(kind, target, at=at))
    return FaultPlan(specs=tuple(specs), seed=seed)
