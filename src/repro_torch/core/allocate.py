"""Block allocation under resource budgets (paper §4.2, Table 5).

Port of ``repro.core.allocate``.  The device catalog (``edge``, ``v5e``,
``v5p``) carries the reference's budgets over unchanged, in the
reference's normalized units: they are the parts the reference plans
for, not measurements of the port's card.  There is no H100 profile
yet; one waits for a sweep measured on Hopper.

The paper packs a ZCU104 to a target utilization (80 %) with a mix of
convolution blocks chosen purely from the fitted models.  TPU adaptation
(DESIGN.md §7): FPGA area budgets become per-chip *rate* budgets — a block
instance is a streaming pipeline consuming predicted resources per tile
step (normalized to 1 tile/µs, the paper's one-conv-per-cycle unit):

  DSP  → MXU issue (int32-equivalent FLOPs/µs)
  LLUT → VPU lane-ops/µs
  BRAM → HBM bytes/µs
  VMEM → VMEM bytes (capacity, not rate)

The allocation itself is the same optimization problem: maximize total
convolutions subject to every resource ≤ target·budget, solved by LP
relaxation (scipy linprog) + greedy integer rounding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
from scipy.optimize import linprog

from repro_torch.blocks import get_block
from repro_torch.core import polyfit, synth

# the resource classes every device budgets (and every BlockModels fits)
BUDGET_RESOURCES = ("hbm_bytes", "mxu_cost", "vmem_bytes", "vpu_ops")


@dataclass(frozen=True)
class DeviceProfile:
    """One deployable part: a named budget vector plus a relative unit
    cost — the TPU analogue of choosing among FPGA parts (ZCU104 vs a
    bigger/smaller Zynq) in the paper's companion resource-driven flow.

    ``budgets`` maps every resource in ``BUDGET_RESOURCES`` to the
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


# v5e per-chip budgets in the allocator's normalized units
V5E_BUDGETS = {
    "mxu_cost": 98.5e6,       # int32-equiv FLOPs/µs (197 TFLOP/s bf16 peak)
    "vpu_ops": 3.0e6,         # int32 lane-ops/µs
    "hbm_bytes": 819e3,       # bytes/µs (819 GB/s)
    "vmem_bytes": 128 * 2**20,  # bytes (capacity)
}

V5E = DeviceProfile(
    name="v5e", budgets=V5E_BUDGETS, cost=1.0,
    description="TPU v5e chip — the mid-range baseline part")

V5P = DeviceProfile(
    name="v5p", cost=3.4,
    budgets={
        "mxu_cost": 229.5e6,      # 459 TFLOP/s bf16 peak
        "vpu_ops": 6.0e6,
        "hbm_bytes": 2765e3,      # 2765 GB/s
        "vmem_bytes": 128 * 2**20,
    },
    description="TPU v5p chip — the large training part")

EDGE = DeviceProfile(
    name="edge", cost=0.2,
    budgets={
        "mxu_cost": 9.85e6,       # one-tenth of a v5e
        "vpu_ops": 0.5e6,
        "hbm_bytes": 102e3,
        "vmem_bytes": 32 * 2**20,
    },
    description="constrained edge part — the ZCU104-class analogue")

# cheapest first, so "first profile that fits" is also the cheapest fit
DEVICE_CATALOG: Tuple[DeviceProfile, ...] = (EDGE, V5E, V5P)

BudgetLike = Union[DeviceProfile, Mapping[str, float]]


def get_device(name: str) -> DeviceProfile:
    for dev in DEVICE_CATALOG:
        if dev.name == name:
            return dev
    raise KeyError(f"unknown device {name!r}; catalog: "
                   f"{[d.name for d in DEVICE_CATALOG]}")


def as_budgets(budgets: Optional[BudgetLike]) -> Dict[str, float]:
    """Coerce a DeviceProfile / budget mapping / None (→ v5e) to a dict."""
    if budgets is None:
        return dict(V5E_BUDGETS)
    if isinstance(budgets, DeviceProfile):
        return dict(budgets.budgets)
    return dict(budgets)


@dataclass
class BlockModels:
    """Fitted per-resource models for every block (from the sweep)."""
    models: Dict[str, Dict[str, object]]   # block -> resource -> model
    convs: Dict[str, float]                # block -> convolutions per step

    @classmethod
    def fit(cls, rows: List[dict]) -> "BlockModels":
        """Fit one model per (registered block, budgeted resource).

        Every budgeted resource gets a model — including columns that are
        constant over the sweep (e.g. Conv1 never touches the MXU):
        ``fit_auto`` degrades to the constant polynomial there, which
        predicts the flat value exactly, and ``demand()`` then always
        covers every budgeted resource.  Block identity (convs/step)
        comes from the ``ConvBlock`` registry when the block is
        registered; rows naming an unregistered block (e.g. a cached
        sweep from a session that registered a custom block) fall back
        to the ``convs_per_step`` recorded in the rows themselves.
        """
        blocks = sorted({r["block"] for r in rows})
        models, convs = {}, {}
        for b in blocks:
            d, c, ys = synth.sweep_arrays(rows, b)
            models[b] = {res: polyfit.fit_auto(d, c, ys[res], block=b)
                         for res in BUDGET_RESOURCES}
            try:
                convs[b] = float(get_block(b).convs_per_step)
            except KeyError:
                convs[b] = float(next(r["convs_per_step"] for r in rows
                                      if r["block"] == b))
        return cls(models, convs)

    def demand(self, block: str, data_bits: int, coeff_bits: int) -> Dict:
        return {res: float(max(m.predict(data_bits, coeff_bits)[0], 0.0))
                for res, m in self.models[block].items()}


@dataclass
class Allocation:
    counts: Dict[str, int]
    usage_pct: Dict[str, float]
    total_convs: float


def allocate(bm: BlockModels, *, data_bits: int = 8, coeff_bits: int = 8,
             target: float = 0.8,
             budgets: Optional[BudgetLike] = None,
             only_block: Optional[str] = None,
             max_topup_rounds: int = 10_000) -> Allocation:
    budgets = as_budgets(budgets)
    blocks = [only_block] if only_block else sorted(bm.models)
    res_names = sorted(budgets)
    A = np.array([[bm.demand(b, data_bits, coeff_bits)[r] for b in blocks]
                  for r in res_names])
    ub = np.array([target * budgets[r] for r in res_names])
    objective = -np.array([bm.convs[b] for b in blocks])

    # Blocks whose predicted demand is ~0 on EVERY budgeted resource are
    # excluded from both the LP and the greedy top-up: a free column with
    # positive objective makes the LP unbounded (discarding its solution
    # for every block), and the top-up would add the block forever.
    nonzero = [i for i in range(len(blocks)) if np.any(A[:, i] > 1e-9)]
    n = np.zeros(len(blocks), int)
    if nonzero:
        lp = linprog(objective[nonzero], A_ub=A[:, nonzero], b_ub=ub,
                     bounds=[(0, None)] * len(nonzero), method="highs")
        if lp.success:
            n[nonzero] = np.floor(lp.x + 1e-9).astype(int)

    # greedy top-up: add whichever block still fits and adds most convs.
    # The round cap is a backstop against demands so tiny that the top-up
    # degenerates into counting to the budget one by one.
    order = sorted(nonzero, key=lambda i: -bm.convs[blocks[i]])
    improved, rounds = True, 0
    while improved and rounds < max_topup_rounds:
        improved = False
        rounds += 1
        for i in order:
            trial = n.copy()
            trial[i] += 1
            if np.all(A @ trial <= ub + 1e-9):
                n = trial
                improved = True
    used = A @ n
    usage = {r: float(100 * used[k] / budgets[r])
             for k, r in enumerate(res_names)}
    total = float(sum(bm.convs[b] * n[i] for i, b in enumerate(blocks)))
    return Allocation({b: int(n[i]) for i, b in enumerate(blocks)},
                      usage, total)
