"""Device budget profiles.  Port of the part of ``repro.core.allocate``
that plan artifacts carry: ``BUDGET_RESOURCES`` and ``DeviceProfile``.
The allocator and the catalog come with the planner."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

# the resource classes every device budgets (and every BlockModels fits)
BUDGET_RESOURCES = ("hbm_bytes", "mxu_cost", "vmem_bytes", "vpu_ops")


@dataclass(frozen=True)
class DeviceProfile:
    """One deployable part: a named budget vector plus a relative unit
    cost.  ``budgets`` maps every resource in ``BUDGET_RESOURCES`` to the
    device's capacity in the allocator's normalized units (rates per µs,
    except ``vmem_bytes`` which is a capacity)."""

    name: str
    budgets: Mapping[str, float]
    cost: float = 1.0              # relative unit price (v5e ≡ 1.0)
    description: str = ""

    def __post_init__(self):
        missing = [r for r in BUDGET_RESOURCES if r not in self.budgets]
        if missing:
            raise ValueError(f"device {self.name!r} missing budgets for "
                             f"{missing}")
