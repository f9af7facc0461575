"""Workload registry: typed ``WorkloadSpec``s behind ``DeploymentPlan``.

Port of the CNN half of ``repro.runtime.workloads``: the ``WorkloadSpec``
protocol and registry, ``CNNWorkloadSpec`` and ``compile_plan``, the one
construction path the serving engine uses.  The quantized MoE workload
is not ported yet: a plan of kind ``"moe"`` raises ``NotImplementedError``
when it is read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Type

import torch

from repro_torch.core.cnn import CNNConfig, ConvLayerSpec
from repro_torch.core.deploy import DeploymentPlan
from repro_torch.runtime.compiled import CompiledModel, ExecutableCache

# workload kinds the reference serves that the port does not yet
_NOT_YET_PORTED = {"moe": "the quantized MoE workload"}


class WorkloadSpec:
    """What a ``DeploymentPlan`` deploys, as a typed value.

    Implementations are frozen dataclasses with a ``kind`` class
    attribute, an exact JSON round-trip (``to_payload`` /
    ``from_payload``) and a ``compile`` hook that builds the
    ``CompiledModel`` backend executing a plan."""

    kind: str = "workload"

    def to_payload(self) -> dict:
        raise NotImplementedError

    @classmethod
    def from_payload(cls, payload: dict) -> "WorkloadSpec":
        raise NotImplementedError

    def compile(self, plan, *, params=None,
                generator: Optional[torch.Generator] = None,
                max_batch: int = 16, device="cuda", warmup: bool = True,
                exec_cache: Optional[ExecutableCache] = None
                ) -> CompiledModel:
        raise NotImplementedError


_WORKLOADS: Dict[str, Type[WorkloadSpec]] = {}


def register_workload(cls: Type[WorkloadSpec]) -> Type[WorkloadSpec]:
    """Class decorator: make ``cls`` the spec for its ``kind``."""
    kind = cls.kind
    if not kind or kind == WorkloadSpec.kind:
        raise ValueError(f"{cls.__name__} must define a concrete kind")
    if kind in _WORKLOADS and _WORKLOADS[kind] is not cls:
        raise ValueError(f"workload kind {kind!r} already registered "
                         f"by {_WORKLOADS[kind].__name__}")
    _WORKLOADS[kind] = cls
    return cls


def get_workload(kind: str) -> Type[WorkloadSpec]:
    if kind in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"workload kind {kind!r} ({_NOT_YET_PORTED[kind]}) is not yet "
            f"ported to repro_torch; serve it with the reference package")
    try:
        return _WORKLOADS[kind]
    except KeyError:
        raise ValueError(
            f"unknown workload kind {kind!r}; registered: "
            f"{sorted(_WORKLOADS)}") from None


def list_workloads() -> List[str]:
    return sorted(_WORKLOADS)


def workload_spec(plan: DeploymentPlan) -> WorkloadSpec:
    """The typed spec of any plan: the ``workload`` field when present,
    else the embedded ``CNNConfig`` wrapped as a ``CNNWorkloadSpec``."""
    if plan.workload is not None:
        return plan.workload
    if plan.cnn is not None:
        return CNNWorkloadSpec(cnn=plan.cnn)
    raise ValueError(
        "plan carries neither a workload spec nor a CNNConfig — it "
        "cannot be compiled (re-plan, or attach a spec)")


def compile_plan(plan: DeploymentPlan, *, params=None,
                 generator: Optional[torch.Generator] = None,
                 max_batch: int = 16, device="cuda", warmup: bool = True,
                 exec_cache: Optional[ExecutableCache] = None
                 ) -> CompiledModel:
    """Any plan → its batch-bucketed executor, dispatched through the
    workload registry (the construction path ``CNNEngine.from_plan``
    uses)."""
    return workload_spec(plan).compile(
        plan, params=params, generator=generator, max_batch=max_batch,
        device=device, warmup=warmup, exec_cache=exec_cache)


@register_workload
@dataclass(frozen=True)
class CNNWorkloadSpec(WorkloadSpec):
    """The convolution workload: the network a plan embeds."""

    cnn: CNNConfig
    kind = "cnn"

    def to_payload(self) -> dict:
        return {
            "img_h": int(self.cnn.img_h),
            "img_w": int(self.cnn.img_w),
            "layers": [{
                "in_channels": int(s.in_channels),
                "out_channels": int(s.out_channels),
                "data_bits": int(s.data_bits),
                "coeff_bits": int(s.coeff_bits),
                "shift": int(s.shift),
                "block": s.block,
            } for s in self.cnn.layers],
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "CNNWorkloadSpec":
        return cls(cnn=CNNConfig(
            layers=tuple(ConvLayerSpec(
                in_channels=int(s["in_channels"]),
                out_channels=int(s["out_channels"]),
                data_bits=int(s["data_bits"]),
                coeff_bits=int(s["coeff_bits"]),
                shift=int(s["shift"]), block=s["block"])
                for s in payload["layers"]),
            img_h=int(payload["img_h"]), img_w=int(payload["img_w"])))

    def compile(self, plan, *, params=None,
                generator: Optional[torch.Generator] = None,
                max_batch: int = 16, device="cuda", warmup: bool = True,
                exec_cache: Optional[ExecutableCache] = None
                ) -> CompiledModel:
        from repro_torch.runtime.compiled import CompiledCNN
        return CompiledCNN.from_plan(
            plan, self.cnn, params=params, generator=generator,
            max_batch=max_batch, device=device, warmup=warmup,
            exec_cache=exec_cache)
