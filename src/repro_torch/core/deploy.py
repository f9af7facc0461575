"""The deployment-plan artifact.

Port of the plan half of ``repro.core.deploy``: ``DeploymentError``,
``LayerAssignment``, ``DeploymentPlan`` (versioned JSON, v2 native and
the v1 upgrade, byte-identical to the reference's) and ``plan_config``.
The planner itself (``plan_deployment`` and the fitted resource models)
is not ported yet, so the port serves plans the reference's planner
wrote.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.allocate import DeviceProfile
from repro_torch.core.cnn import CNNConfig


class DeploymentError(RuntimeError):
    """A CNN (or one of its layers) does not fit a device's budgets."""


# Version of the serialized DeploymentPlan payload (the reference's).
# v1 → v2: the CNN-only ``"cnn"`` key became a typed ``"workload"``
# envelope ``{"kind": ..., "spec": ...}``; v1 payloads still load.
PLAN_SCHEMA_VERSION = 2

# schema versions ``from_json`` accepts (older ones upgrade in place)
_READABLE_SCHEMA_VERSIONS = (1, PLAN_SCHEMA_VERSION)


@dataclass(frozen=True)
class LayerAssignment:
    """One layer's planned execution: block + precision + its predicted
    per-layer demand in the device budget units."""
    index: int
    block: str
    data_bits: int
    coeff_bits: int
    calls: int                     # kernel calls per forward pass
    demand: Dict[str, float]       # per-layer predicted demand


@dataclass
class DeploymentPlan:
    device: DeviceProfile
    target: float
    layers: Tuple[LayerAssignment, ...]
    demand: Dict[str, float]       # plan totals (Σ rates, max vmem)
    usage_pct: Dict[str, float]    # demand / device budget, percent
    convs_per_step: float          # plane convolutions per kernel call
    feasible: bool = True
    quant_error: Optional[float] = None
    cnn: Optional[CNNConfig] = None       # the planned network (CNN plans)
    #: typed non-CNN workload spec (``runtime.workloads.WorkloadSpec``);
    #: CNN plans keep using ``cnn`` and leave this None
    workload: Optional[object] = None

    @property
    def max_usage_pct(self) -> float:
        return max(self.usage_pct.values())

    def block_names(self) -> List[str]:
        return [a.block for a in self.layers]

    def bits(self) -> List[Tuple[int, int]]:
        return [(a.data_bits, a.coeff_bits) for a in self.layers]

    # -- serialization (the durable deployment artifact) -----------------

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        """Versioned JSON payload, byte-identical to the reference's
        ``to_json`` of the same plan; ``from_json`` round-trips it."""
        # lazy: runtime.workloads imports this module
        from repro_torch.runtime import workloads as _wl
        workload = None
        if self.workload is not None:
            workload = {"kind": self.workload.kind,
                        "spec": self.workload.to_payload()}
        elif self.cnn is not None:
            workload = {"kind": "cnn",
                        "spec": _wl.CNNWorkloadSpec(self.cnn).to_payload()}
        payload = {
            "version": PLAN_SCHEMA_VERSION,
            "device": {
                "name": self.device.name,
                "budgets": {r: float(v)
                            for r, v in sorted(self.device.budgets.items())},
                "cost": float(self.device.cost),
                "description": self.device.description,
            },
            "target": float(self.target),
            "layers": [{
                "index": int(a.index),
                "block": a.block,
                "data_bits": int(a.data_bits),
                "coeff_bits": int(a.coeff_bits),
                "calls": int(a.calls),
                "demand": {r: float(v) for r, v in sorted(a.demand.items())},
            } for a in self.layers],
            "demand": {r: float(v) for r, v in sorted(self.demand.items())},
            "usage_pct": {r: float(v)
                          for r, v in sorted(self.usage_pct.items())},
            "convs_per_step": float(self.convs_per_step),
            "feasible": bool(self.feasible),
            "quant_error": (None if self.quant_error is None
                            else float(self.quant_error)),
            "workload": workload,
        }
        return json.dumps(payload, indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "DeploymentPlan":
        """Parse a versioned plan payload.  v2 is the native schema; v1
        payloads (the CNN-only era) upgrade in place.  A workload kind
        the port does not serve yet raises ``NotImplementedError``."""
        from repro_torch.runtime import workloads as _wl
        payload = json.loads(text)
        version = payload.get("version")
        if version not in _READABLE_SCHEMA_VERSIONS:
            raise ValueError(
                f"deployment plan schema version {version!r} != supported "
                f"{PLAN_SCHEMA_VERSION} (readable: "
                f"{_READABLE_SCHEMA_VERSIONS}) — re-plan with this repro "
                f"version (plans are not migrated across unknown schema "
                f"bumps)")
        dev = payload["device"]
        device = DeviceProfile(
            name=dev["name"], budgets=dict(dev["budgets"]),
            cost=dev["cost"], description=dev.get("description", ""))
        layers = tuple(LayerAssignment(
            index=int(a["index"]), block=a["block"],
            data_bits=int(a["data_bits"]), coeff_bits=int(a["coeff_bits"]),
            calls=int(a["calls"]), demand=dict(a["demand"]))
            for a in payload["layers"])
        cnn = None
        workload = None
        if version == 1:
            if payload.get("cnn") is not None:
                cnn = _wl.CNNWorkloadSpec.from_payload(payload["cnn"]).cnn
        elif payload.get("workload") is not None:
            w = payload["workload"]
            spec = _wl.get_workload(w["kind"]).from_payload(w["spec"])
            if w["kind"] == "cnn":
                cnn = spec.cnn     # CNN plans keep the legacy field
            else:
                workload = spec
        return cls(device=device, target=payload["target"], layers=layers,
                   demand=dict(payload["demand"]),
                   usage_pct=dict(payload["usage_pct"]),
                   convs_per_step=payload["convs_per_step"],
                   feasible=payload["feasible"],
                   quant_error=payload["quant_error"], cnn=cnn,
                   workload=workload)

    def save(self, path: Union[str, Path]) -> Path:
        path = Path(path)
        path.write_text(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: Union[str, Path]) -> "DeploymentPlan":
        return cls.from_json(Path(path).read_text())


def plan_config(plan: DeploymentPlan,
                cfg: Optional[CNNConfig] = None) -> CNNConfig:
    """The plan baked back into a runnable config: each layer spec gets
    the planned block and bits (shift and channels are unchanged).
    ``cfg`` defaults to the network the plan was made for."""
    if cfg is None:
        cfg = plan.cnn
    if cfg is None:
        if plan.workload is not None:
            raise ValueError(
                f"plan carries a {plan.workload.kind!r} workload, not a "
                f"CNN — use runtime.workloads.compile_plan instead of "
                f"plan_config")
        raise ValueError("plan carries no CNNConfig; pass cfg explicitly")
    specs = tuple(dataclasses.replace(spec, block=a.block,
                                      data_bits=a.data_bits,
                                      coeff_bits=a.coeff_bits)
                  for spec, a in zip(cfg.layers, plan.layers))
    return dataclasses.replace(cfg, layers=specs)
