"""Workload registry: typed ``WorkloadSpec``s behind ``DeploymentPlan``.

Port of ``repro.runtime.workloads``: the ``WorkloadSpec`` protocol and
registry, ``compile_plan`` (the one construction path the serving
engines use, so ``CNNEngine``, ``AsyncCNNGateway`` and ``Fleet`` stay
plan-type-blind), and both workloads the reference serves:

``CNNWorkloadSpec``  wraps the embedded ``CNNConfig``.
``MoEWorkloadSpec``  quantized mixture-of-experts inference: expert
                     weights fake-quantized to the plan's coeff_bits
                     grid (``models.moe.quantize_moe_params``),
                     activations per token to data_bits, served by
                     ``CompiledMoE`` and validated against
                     ``moe_layer_dense_ref`` (``validate_moe_plan``);
                     ``plan_moe_deployment`` is its per-layer bit
                     search under a ``DeviceProfile``'s budgets.

A request payload for an MoE plan is one ``(seq_len, d_model)`` float32
block of token activations; the compiled forward runs ``num_layers``
residual MoE layers over the bucketed batch.  The MoE path is torch ops
end to end (the reference's is jnp, never a Pallas kernel): the expert
products are ``torch.bmm`` in full float32.

Where the port's numbers differ from the reference's by design: weights
are drawn from a ``torch.Generator``, which cannot reproduce
``jax.random``, so a plan the port's planner makes has the reference's
layers, bits, demand and usage but another ``quant_error`` (a plan
loaded from JSON keeps its stored value); parity tests carry the
reference's weights across with ``convert.moe_params_from_numpy``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.allocate import BUDGET_RESOURCES
from repro_torch.core.cnn import CNNConfig, ConvLayerSpec
from repro_torch.core.deploy import (DEFAULT_BIT_CANDIDATES, RATE_RESOURCES,
                                     DeploymentError, DeploymentPlan,
                                     LayerAssignment, _as_device,
                                     device_profile)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.models import moe as moe_mod
from repro_torch.runtime.compiled import CompiledModel, ExecutableCache

#: registry block name for an MoE layer's assignment (conv blocks come
#: from repro_torch.blocks; MoE layers are all the one expert FFN)
MOE_BLOCK_NAME = "moe_ffn"

# workload kinds the reference serves that the port does not yet, by
# what they are (none today: ``cnn`` and ``moe`` are both ported);
# ``get_workload`` raises ``NotImplementedError`` for them
_NOT_YET_PORTED: Dict[str, str] = {}


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
                max_batch: int = 16, device="cuda", mesh=None,
                warmup: bool = True,
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
                 max_batch: int = 16, device="cuda", mesh=None,
                 warmup: bool = True,
                 exec_cache: Optional[ExecutableCache] = None
                 ) -> CompiledModel:
    """Any plan → its batch-bucketed executor, dispatched through the
    workload registry (the construction path ``CNNEngine.from_plan``
    uses); ``mesh`` shards a CNN plan's batches."""
    return workload_spec(plan).compile(
        plan, params=params, generator=generator, max_batch=max_batch,
        device=device, mesh=mesh, warmup=warmup, exec_cache=exec_cache)


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
                max_batch: int = 16, device="cuda", mesh=None,
                warmup: bool = True,
                exec_cache: Optional[ExecutableCache] = None
                ) -> CompiledModel:
        from repro_torch.runtime.compiled import CompiledCNN
        return CompiledCNN.from_plan(
            plan, self.cnn, params=params, generator=generator,
            max_batch=max_batch, device=device, mesh=mesh, warmup=warmup,
            exec_cache=exec_cache)


# ---------------------------------------------------------------------------
# MoE: quantized mixture-of-experts inference
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoELayerSpec:
    """One MoE layer's geometry and planned quantization (the analogue
    of ``ConvLayerSpec``)."""
    d_ff_expert: int
    num_experts: int
    top_k: int
    data_bits: int = 8             # activation fake-quant grid
    coeff_bits: int = 8            # expert-weight fake-quant grid
    n_shared_experts: int = 0
    capacity_factor: float = 2.0

    def __post_init__(self):
        if self.top_k < 1 or self.top_k > self.num_experts:
            raise ValueError(
                f"top_k={self.top_k} must be in [1, num_experts="
                f"{self.num_experts}]")
        for name in ("data_bits", "coeff_bits"):
            v = getattr(self, name)
            if not 2 <= v <= 16:
                raise ValueError(f"{name}={v} outside [2, 16]")


@register_workload
@dataclass(frozen=True)
class MoEWorkloadSpec(WorkloadSpec):
    """A stack of residual MoE layers serving ``(seq_len, d_model)``
    float32 token blocks, one block per request."""

    layers: Tuple[MoELayerSpec, ...]
    d_model: int
    seq_len: int = 32
    act: str = "silu"
    mlp_gated: bool = True
    kind = "moe"

    def __post_init__(self):
        if not self.layers:
            raise ValueError("MoE workload needs at least one layer")
        if self.d_model < 1 or self.seq_len < 1:
            raise ValueError(
                f"d_model={self.d_model} and seq_len={self.seq_len} "
                f"must be ≥ 1")

    def to_payload(self) -> dict:
        return {
            "d_model": int(self.d_model),
            "seq_len": int(self.seq_len),
            "act": self.act,
            "mlp_gated": bool(self.mlp_gated),
            "layers": [{
                "d_ff_expert": int(s.d_ff_expert),
                "num_experts": int(s.num_experts),
                "top_k": int(s.top_k),
                "data_bits": int(s.data_bits),
                "coeff_bits": int(s.coeff_bits),
                "n_shared_experts": int(s.n_shared_experts),
                "capacity_factor": float(s.capacity_factor),
            } for s in self.layers],
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "MoEWorkloadSpec":
        return cls(
            layers=tuple(MoELayerSpec(
                d_ff_expert=int(s["d_ff_expert"]),
                num_experts=int(s["num_experts"]),
                top_k=int(s["top_k"]),
                data_bits=int(s["data_bits"]),
                coeff_bits=int(s["coeff_bits"]),
                n_shared_experts=int(s["n_shared_experts"]),
                capacity_factor=float(s["capacity_factor"]))
                for s in payload["layers"]),
            d_model=int(payload["d_model"]),
            seq_len=int(payload["seq_len"]),
            act=payload["act"], mlp_gated=bool(payload["mlp_gated"]))

    def compile(self, plan, *, params=None,
                generator: Optional[torch.Generator] = None,
                max_batch: int = 16, device="cuda", mesh=None,
                warmup: bool = True,
                exec_cache: Optional[ExecutableCache] = None
                ) -> CompiledModel:
        if mesh is not None:
            raise ValueError("a data-parallel mesh serves CNN plans; the "
                             "MoE workload runs on one device")
        return CompiledMoE.from_plan(
            plan, params=params, generator=generator, max_batch=max_batch,
            device=device, warmup=warmup, exec_cache=exec_cache)

    # -- model-config shim + params --------------------------------------
    def layer_cfg(self, i: int) -> "_MoELayerModelCfg":
        """The config view ``models.moe`` expects, for layer ``i``."""
        s = self.layers[i]
        return _MoELayerModelCfg(
            moe=MoEConfig(num_experts=s.num_experts, top_k=s.top_k,
                          d_ff_expert=s.d_ff_expert,
                          n_shared_experts=s.n_shared_experts,
                          capacity_factor=s.capacity_factor),
            d_model=self.d_model, act=self.act, mlp_gated=self.mlp_gated)

    def init_params(self, generator: Optional[torch.Generator], *,
                    quantized: bool = True) -> list:
        """Per-layer ``init_moe`` draws (float32) from ``generator``, one
        layer after another, on its device; expert weights
        fake-quantized to each layer's ``coeff_bits`` grid unless
        ``quantized=False`` (the float oracle draw).  Without a
        generator the tensors are empty, on ``meta``."""
        out = []
        for i, s in enumerate(self.layers):
            p = moe_mod.init_moe(generator, self.layer_cfg(i))
            out.append(moe_mod.quantize_moe_params(p, s.coeff_bits)
                       if quantized else p)
        return out


@dataclass(frozen=True)
class _MoELayerModelCfg:
    """The slice of ``configs.base.ModelConfig`` that ``models.moe``
    reads.  Serving runs float32 on the flat (single-group) path."""
    moe: MoEConfig
    d_model: int
    act: str = "silu"
    mlp_gated: bool = True
    moe_groups: int = 1
    moe_shard_hints: bool = False
    moe_combine_shardmap: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float32


def _fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric ``bits``-bit fake quantization with a dynamic per-token
    scale: each token's max magnitude (floored at 1e-6) maps to
    ``2^(bits-1) - 1`` levels, rounded half to even.  Per-token scaling
    keeps a token's grid independent of the batch and padding it is
    dispatched with."""
    s = moe_mod._symmetric_scale(x.abs().amax(dim=-1, keepdim=True),
                                 bits, 1e-6)
    return torch.round(x * s) / s


class CompiledMoE(CompiledModel):
    """The quantized-MoE backend: each layer is one prepared residual
    MoE block — activations fake-quantized to the layer's
    ``data_bits``, expert weights pre-quantized to ``coeff_bits`` —
    bucketed, batched and cached like ``CompiledCNN``, on ``device``
    (``"cuda"`` unless the caller asks for the CPU).

    A (layer, bucket) preparation is a closure over the layer's
    configuration that checks its input's shape: the capacity depends
    on the bucket, as each (layer, bucket) is its own executable in the
    reference.  On the card its expert products launch the port's
    ``moe_expert_gemm`` kernels (the rest is torch ops); the warm-up
    builds (if missing) and binds their library in the cache's kernel
    directory, so no dispatch compiles.  ``ops.PersistentExecutableCache``
    keeps the closures in memory only, and a restart prepares them
    again, which builds nothing the kernel directory holds."""

    kind = "moe"
    input_noun = "token block"

    def __init__(self, spec: MoEWorkloadSpec, params, *,
                 max_batch: int = 16, device: DeviceLike = "cuda",
                 warmup: bool = True,
                 exec_cache: Optional[ExecutableCache] = None):
        if len(params) != len(spec.layers):
            raise ValueError(
                f"need one param dict per layer: {len(params)} for "
                f"{len(spec.layers)} layers")
        self.device = resolve_device(device)
        self.spec = spec
        self.params = [{k: torch.as_tensor(v).to(self.device).contiguous()
                        for k, v in p.items()} for p in params]
        self.num_layers = len(spec.layers)
        self.in_shape = (spec.seq_len, spec.d_model)
        self.in_dtype = torch.float32
        super().__init__(max_batch=max_batch, warmup=warmup,
                         exec_cache=exec_cache)

    @classmethod
    def from_plan(cls, plan, *, params=None,
                  generator: Optional[torch.Generator] = None,
                  max_batch: int = 16, device: DeviceLike = "cuda",
                  warmup: bool = True,
                  exec_cache: Optional[ExecutableCache] = None
                  ) -> "CompiledMoE":
        """Executor for a planned MoE deployment: the spec with each
        layer's planned (data_bits, coeff_bits) baked in; ``params``
        default to a quantized ``init_moe`` draw per layer from
        ``generator`` (a CPU generator seeded with 0 when none is
        given)."""
        spec = moe_plan_spec(plan)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = spec.init_params(generator)
        return cls(spec, params, max_batch=max_batch, device=device,
                   warmup=warmup, exec_cache=exec_cache)

    def warmup(self) -> "CompiledMoE":
        """Prepare every (layer, bucket) closure; on the card first build
        (if missing) and bind the expert kernels' library, which every
        layer's products launch (a gated SiLU FFN in float32)."""
        if self.device.type == "cuda" and self.spec.mlp_gated \
                and self.spec.act == "silu":
            build.prepare(("moe_expert_gemm",), self.cache.kernel_dir)
        return super().warmup()

    # -- backend hooks ----------------------------------------------------
    def _layer_key(self, i: int, bucket: int) -> tuple:
        s = self.spec.layers[i]
        return (MOE_BLOCK_NAME, self.spec.d_model, s.d_ff_expert,
                s.num_experts, s.top_k, s.n_shared_experts,
                float(s.capacity_factor), s.data_bits, s.coeff_bits,
                self.spec.seq_len, self.spec.act, self.spec.mlp_gated,
                self.device, bucket)

    def _prepare_layer(self, i: int, bucket: int):
        cfg = self.spec.layer_cfg(i)
        data_bits = self.spec.layers[i].data_bits
        shape = (bucket, self.spec.seq_len, self.spec.d_model)
        device = self.device

        def layer(p, x):
            if tuple(x.shape) != shape or x.dtype != torch.float32 \
                    or x.device != device:
                raise ValueError(
                    f"MoE layer prepared for {shape} float32 on {device}, "
                    f"got {tuple(x.shape)} {x.dtype} on {x.device}")
            # residual MoE block over the quantized activation grid; the
            # aux (load-balancing) loss is a training quantity
            y, _aux = moe_mod.moe_layer(p, _fake_quant(x, data_bits), cfg)
            return x + y

        return layer

    def _layer_params(self, i: int):
        return self.params[i]

    def _empty_output(self) -> torch.Tensor:
        return torch.zeros((0,) + self.in_shape, dtype=torch.float32,
                           device=self.device)

    # -- workload helpers --------------------------------------------------
    def sample_inputs(self, k: int, seed: int = 0) -> List[np.ndarray]:
        """``k`` random float32 token blocks (unit-normal activations)
        matching this executor's ``(seq_len, d_model)`` contract — the
        reference's generator, so one seed gives the same blocks."""
        rng = np.random.default_rng(seed)
        return [rng.standard_normal(self.in_shape).astype(np.float32)
                for _ in range(k)]

    def validate_input(self, x, request_id: int = 0) -> np.ndarray:
        """Shape + finiteness admission check: token activations must be
        real finite numbers (NaN/Inf would propagate through every
        expert); any real dtype is accepted and served as float32."""
        x = np.asarray(x)
        if tuple(x.shape) != tuple(self.in_shape):
            raise ValueError(
                f"request {request_id}: {self.input_noun} shape "
                f"{tuple(x.shape)} != engine input {tuple(self.in_shape)}")
        if not np.issubdtype(x.dtype, np.floating) \
                and not np.issubdtype(x.dtype, np.integer):
            raise ValueError(
                f"request {request_id}: {self.input_noun} dtype {x.dtype} "
                f"is not a real numeric type")
        if not np.all(np.isfinite(x)):
            raise ValueError(
                f"request {request_id}: {self.input_noun} carries "
                f"non-finite values (NaN/Inf) — they would propagate "
                f"through every routed expert")
        return x


# ---------------------------------------------------------------------------
# the MoE planner: per-layer bit search under device budgets
# ---------------------------------------------------------------------------

def moe_layer_demand(spec: MoEWorkloadSpec, layer: MoELayerSpec,
                     data_bits: int, coeff_bits: int) -> Dict[str, float]:
    """Analytic per-request demand of one MoE layer in the device
    budget units: matmul MACs (``mxu_cost``), weight traffic at the
    quantized container width plus activation traffic (``hbm_bytes``),
    elementwise work (``vpu_ops``), and the expert-buffer + one-weight
    working set (``vmem_bytes``, a capacity) — the reference's model,
    number for number."""
    S, d = spec.seq_len, spec.d_model
    fe, e, k = layer.d_ff_expert, layer.num_experts, layer.top_k
    fs = fe * layer.n_shared_experts
    nmats = 3 if spec.mlp_gated else 2
    routed = S * k                      # expert-token assignments
    mxu = (S * d * e                    # router projection
           + nmats * routed * d * fe    # expert FFN on dispatched tokens
           + nmats * S * d * fs)        # always-on shared experts
    weight_bytes = (nmats * e * d * fe + nmats * d * fs) * coeff_bits / 8
    act_bytes = S * d * data_bits / 8
    vpu = S * (e + k * fe + d)          # softmax + act + combine
    cap = int(max(k, round(layer.capacity_factor * S * k / e)))
    vmem = float(e * cap * d * 4 + e * d * fe * 4)
    return {"mxu_cost": float(mxu),
            "hbm_bytes": float(weight_bytes + act_bytes),
            "vpu_ops": float(vpu), "vmem_bytes": vmem}


def plan_moe_deployment(spec: MoEWorkloadSpec, device=None, *,
                        bit_candidates=DEFAULT_BIT_CANDIDATES,
                        target: float = 0.8,
                        on_infeasible: str = "raise",
                        generator: Optional[torch.Generator] = None
                        ) -> DeploymentPlan:
    """Greedy per-layer (data_bits, coeff_bits) assignment for an MoE
    workload under one device profile's budgets (``device``: a catalog
    name, a ``DeviceProfile`` or a budget mapping) —
    ``deploy.plan_deployment``'s loop with the analytic MoE demand
    model.  Each layer takes the highest-precision candidate that fits
    the remaining budget (lexicographically: data+coeff bits, then
    lowest normalized demand); ``bit_candidates=None`` pins every layer
    to its spec's bits.  ``on_infeasible="fallback"`` assigns the
    least-over-budget candidate and marks the plan ``feasible=False``
    instead of raising.  The plan embeds the spec with the assigned
    bits (``plan.workload``).  Layers, bits, demand and usage equal the
    reference's; ``quant_error`` is ``moe_quantization_error``'s, whose
    weights come from ``generator`` (on its device; a CPU generator
    seeded with 0 when none is given)."""
    if on_infeasible not in ("raise", "fallback"):
        raise ValueError(f"on_infeasible={on_infeasible!r}")
    dev = (device_profile(device) if isinstance(device, str)
           else _as_device(device))
    budgets = {r: float(dev.budgets[r]) for r in BUDGET_RESOURCES}
    remaining = {r: target * budgets[r] for r in RATE_RESOURCES}
    vmem_cap = target * budgets["vmem_bytes"]
    eps = 1e-9

    assignments: List[LayerAssignment] = []
    planned_layers: List[MoELayerSpec] = []
    feasible = True
    for i, layer in enumerate(spec.layers):
        cands = ([(layer.data_bits, layer.coeff_bits)]
                 if bit_candidates is None
                 else list(dict.fromkeys(tuple(b) for b in bit_candidates)))
        best = best_key = None
        cheapest, cheapest_over = None, float("inf")
        for d_bits, c_bits in cands:
            demand = moe_layer_demand(spec, layer, d_bits, c_bits)
            over = max(
                max((demand[r] - remaining[r]) / budgets[r]
                    for r in RATE_RESOURCES),
                (demand["vmem_bytes"] - vmem_cap) / budgets["vmem_bytes"])
            norm = sum(demand[r] / budgets[r] for r in RATE_RESOURCES)
            if over < cheapest_over:
                cheapest, cheapest_over = (d_bits, c_bits, demand), over
            if over > eps:
                continue
            key = (d_bits + c_bits, -norm)
            if best_key is None or key > best_key:
                best, best_key = (d_bits, c_bits, demand), key
        if best is None:
            if on_infeasible == "raise":
                d_bits, c_bits, _ = cheapest
                raise DeploymentError(
                    f"MoE layer {i} (E={layer.num_experts}, "
                    f"ff={layer.d_ff_expert}, k={layer.top_k}) does not "
                    f"fit device {dev.name!r} at target {target:.0%}: "
                    f"least-demanding candidate d{d_bits}/c{c_bits} "
                    f"exceeds the budget by {cheapest_over:.1%}")
            best = cheapest
            feasible = False
        d_bits, c_bits, demand = best
        for r in RATE_RESOURCES:
            remaining[r] = max(0.0, remaining[r] - demand[r])
        assignments.append(LayerAssignment(
            index=i, block=MOE_BLOCK_NAME, data_bits=d_bits,
            coeff_bits=c_bits, calls=spec.seq_len * layer.top_k,
            demand=demand))
        planned_layers.append(dataclasses.replace(
            layer, data_bits=d_bits, coeff_bits=c_bits))

    totals = {r: sum(a.demand[r] for a in assignments)
              for r in RATE_RESOURCES}
    totals["vmem_bytes"] = max(
        (a.demand["vmem_bytes"] for a in assignments), default=0.0)
    usage = {r: 100.0 * totals[r] / budgets[r] for r in BUDGET_RESOURCES}
    planned = dataclasses.replace(spec, layers=tuple(planned_layers))
    plan = DeploymentPlan(
        device=dev, target=target, layers=tuple(assignments),
        demand=totals, usage_pct=usage,
        convs_per_step=float(spec.seq_len),    # tokens per request
        feasible=feasible, cnn=None, workload=planned)
    plan.quant_error = moe_quantization_error(planned, generator=generator)
    return plan


def moe_plan_spec(plan: DeploymentPlan) -> MoEWorkloadSpec:
    """The plan baked back into a runnable spec: each layer gets the
    planned (data_bits, coeff_bits)."""
    spec = workload_spec(plan)
    if not isinstance(spec, MoEWorkloadSpec):
        raise ValueError(
            f"plan carries a {spec.kind!r} workload, not 'moe'")
    if len(spec.layers) != len(plan.layers):
        raise ValueError(
            f"plan has {len(plan.layers)} assignments for "
            f"{len(spec.layers)} spec layers")
    layers = tuple(dataclasses.replace(s, data_bits=a.data_bits,
                                       coeff_bits=a.coeff_bits)
                   for s, a in zip(spec.layers, plan.layers))
    return dataclasses.replace(spec, layers=layers)


# ---------------------------------------------------------------------------
# validation vs the dense oracle (the MoE twin of deploy.validate_plan)
# ---------------------------------------------------------------------------

def _eager_forward(spec: MoEWorkloadSpec, params, x: torch.Tensor, *,
                   quant_act: bool = True) -> torch.Tensor:
    """The residual stack over the spec's layers, unbucketed."""
    act = x
    for i in range(len(spec.layers)):
        xi = (_fake_quant(act, spec.layers[i].data_bits)
              if quant_act else act)
        y, _ = moe_mod.moe_layer(params[i], xi, spec.layer_cfg(i))
        act = act + y
    return act


def _dense_ref_forward(spec: MoEWorkloadSpec, params,
                       x: torch.Tensor) -> torch.Tensor:
    """Residual stack through ``moe_layer_dense_ref`` — every expert on
    every token, no capacity drops, no quantization: the float oracle."""
    act = x
    for i in range(len(spec.layers)):
        act = act + moe_mod.moe_layer_dense_ref(
            params[i], act, spec.layer_cfg(i))
    return act


def _rel_rmse(y: torch.Tensor, ref: torch.Tensor) -> float:
    num = float(torch.sqrt(torch.mean((y - ref) ** 2)))
    den = float(torch.sqrt(torch.mean(ref ** 2)))
    return num / max(den, 1e-9)


def _probe(spec: MoEWorkloadSpec, batch: int, seed: int,
           device: torch.device) -> torch.Tensor:
    """The reference's probe blocks (numpy's ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (batch, spec.seq_len, spec.d_model)).astype(np.float32)).to(device)


def moe_quantization_error(spec: MoEWorkloadSpec, *,
                           generator: Optional[torch.Generator] = None,
                           seed: int = 0) -> float:
    """Relative RMSE of the quantized MoE stack against the float
    dense-reference oracle on a deterministic probe block (the per-plan
    Pareto axis), on the generator's device.  The weights are drawn
    from ``generator`` (a CPU generator seeded with 0 when none is
    given), so the value differs from the reference's ``jax.random``
    draw; the probe block is the reference's (numpy, ``seed``)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    float_params = spec.init_params(generator, quantized=False)
    quant_params = [moe_mod.quantize_moe_params(p, s.coeff_bits)
                    for p, s in zip(float_params, spec.layers)]
    x = _probe(spec, 1, seed, generator.device)
    yq = _eager_forward(spec, quant_params, x)
    yf = _dense_ref_forward(spec, float_params, x)
    return _rel_rmse(yq, yf)


@dataclass
class MoEPlanValidation:
    """Validation verdict for one MoE plan: the compiled (bucketed)
    path must match the eager quantized stack, and the quantized stack
    must track the dense float oracle within quantization tolerance."""
    compiled_matches_eager: bool
    dense_ref_rel_err: float
    quant_error: float             # the probe-seed Pareto number


def validate_moe_plan(plan: DeploymentPlan, *,
                      generator: Optional[torch.Generator] = None,
                      seed: int = 0, max_batch: int = 4, batch: int = 3,
                      atol: float = 1e-5,
                      device: DeviceLike = "cuda") -> MoEPlanValidation:
    """Close the loop for an MoE plan as ``deploy.validate_plan`` does
    for CNNs: execute the plan on ``device`` through ``CompiledMoE``
    (bucketed dispatch, including a padded bucket) and check it against
    the unbucketed quantized stack there (``rtol=1e-5``), then score
    quantization against ``moe_layer_dense_ref``.  Every draw — the
    served weights, the float oracle's and ``quant_error``'s — starts
    from ``generator``'s state (a CPU generator seeded with 0 when none
    is given), as the reference reuses one key, so ``quant_error``
    equals the plan's when both use the default."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state = generator.get_state()

    def twin():
        return torch.Generator(device=generator.device).set_state(state)
    spec = moe_plan_spec(plan)
    float_params = spec.init_params(twin(), quantized=False)
    compiled = CompiledMoE(
        spec, [moe_mod.quantize_moe_params(p, s.coeff_bits)
               for p, s in zip(float_params, spec.layers)],
        max_batch=max_batch, device=dev)
    x = _probe(spec, batch, seed, dev)
    y_compiled = compiled(x)
    y_eager = _eager_forward(spec, compiled.params, x)
    matches = bool(torch.allclose(y_compiled, y_eager, rtol=1e-5,
                                  atol=atol))
    y_ref = _dense_ref_forward(
        spec, [{k: v.to(dev) for k, v in p.items()} for p in float_params],
        x)
    return MoEPlanValidation(
        compiled_matches_eager=matches,
        dense_ref_rel_err=_rel_rmse(y_eager, y_ref),
        quant_error=moe_quantization_error(spec, generator=twin(),
                                           seed=seed))


def fake_quant_flips(acts, ref_acts, data_bits, *, rtol: float = 0.0,
                     atol: float) -> List[List[int]]:
    """Hold one MoE stack's activations against another's on the same
    blocks, both as lists of numpy arrays ``[input of layer 0, ...,
    input of the last layer, output]``, each (blocks, S, D).  A block
    whose output is not within (rtol, atol) must be explained by a
    fake-quant rounding flip: at some layer the two inputs are still
    within (rtol, atol), yet their per-token quantization onto that
    layer's ``data_bits`` grid differs somewhere by at least half a step
    (a value that sat on a rounding boundary, moved by float summation
    order).  Returns the flips as [block, layer, token, channel] of the
    first such value; raises ``AssertionError`` for a block no flip
    explains (an arithmetic difference)."""
    flips = []
    for r in range(ref_acts[-1].shape[0]):
        if np.allclose(acts[-1][r], ref_acts[-1][r], rtol=rtol, atol=atol):
            continue
        found = None
        for i, bits in enumerate(data_bits):
            a, b = acts[i][r], ref_acts[i][r]
            if not np.allclose(a, b, rtol=rtol, atol=atol):
                break                          # diverged before a flip
            qa = _fake_quant(torch.from_numpy(np.array(a)), bits).numpy()
            qb = _fake_quant(torch.from_numpy(np.array(b)), bits).numpy()
            step = np.abs(b).max(axis=-1, keepdims=True) \
                / ((1 << (bits - 1)) - 1)
            jumps = np.argwhere(np.abs(qa - qb) >= 0.5 * step)
            if len(jumps):
                found = [r, i, *map(int, jumps[0])]
                break
        if found is None:
            raise AssertionError(
                f"block {r}: outputs differ by "
                f"{np.abs(acts[-1][r] - ref_acts[-1][r]).max()} and no "
                f"fake-quant rounding flip explains it")
        flips.append(found)
    return flips


# ---------------------------------------------------------------------------
# bridge from the config zoo
# ---------------------------------------------------------------------------

def moe_workload_from_config(cfg, *, n_layers: int = 2,
                             seq_len: int = 32,
                             data_bits: int = 8, coeff_bits: int = 8,
                             capacity_factor: Optional[float] = None
                             ) -> MoEWorkloadSpec:
    """An ``MoEWorkloadSpec`` from a registry ``ModelConfig`` (e.g.
    ``smoke_config("qwen3-moe-30b-a3b")``): ``n_layers`` MoE blocks at
    the config's expert geometry, planned at the given starting bits.
    ``capacity_factor`` defaults to a generous 2.0 — serving validates
    against the no-drop dense oracle, so the capacity bound should not
    be the thing dropping tokens."""
    if cfg.moe is None:
        raise ValueError(
            f"config {cfg.name!r} (family {cfg.family!r}) has no MoE "
            f"block — pick an arch with cfg.moe set")
    m = cfg.moe
    layer = MoELayerSpec(
        d_ff_expert=m.d_ff_expert, num_experts=m.num_experts,
        top_k=m.top_k, data_bits=data_bits, coeff_bits=coeff_bits,
        n_shared_experts=m.n_shared_experts,
        capacity_factor=(2.0 if capacity_factor is None
                         else capacity_factor))
    return MoEWorkloadSpec(
        layers=(layer,) * n_layers, d_model=cfg.d_model,
        seq_len=seq_len, act=cfg.act, mlp_gated=cfg.mlp_gated)
