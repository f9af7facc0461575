"""Deployment planner and the deployment-plan artifact.

Port of ``repro.core.deploy``:

* the artifact — ``DeploymentError``, ``LayerAssignment``,
  ``DeploymentPlan`` (versioned JSON, v2 native and the v1 upgrade,
  byte-identical to the reference's) and ``plan_config``;
* the planner — ``plan_deployment`` (greedy per-layer search over
  (block, data_bits, coeff_bits) under one ``DeviceProfile``'s budgets,
  driven by the fitted resource models), ``pareto_frontier``,
  ``select_device`` and ``quantization_error``;
* the loop-closing check ``validate_plan``: run the plan's forward on
  one image on the card (the per-plane path, kernels K3–K6), hold it
  bit-exactly against ``cnn_forward_ref`` on the CPU, re-count the
  planned layers with the census at the deployed geometry and report
  predicted-vs-measured MSE/MAE/R²/MAPE per budgeted resource.

Demand units: the sweep models predict per *kernel call* at the sweep
image (4·tile_h × tile_w).  A CNN layer issues ``ceil(out_ch/step)·in_ch``
calls per forward (step = 2 for dual-output blocks), each over the
deployed image, so per-layer rate demand scales by calls × the grid-step
ratio (img_h/sweep_h · img_w/sweep_w).  ``vmem_bytes`` is a capacity:
calls reuse one working set, evaluated at the deployed geometry
(``synth.vmem_bytes``) and corrected by the fitted model's ratio at the
design point, and a plan takes the max over its layers (layers run
sequentially).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.blocks import get_block
from repro_torch.configs.paper_conv import SWEEP, ConvSweepConfig
from repro_torch.core import allocate, census, polyfit, synth
from repro_torch.core.allocate import (BUDGET_RESOURCES, BudgetLike,
                                       DEVICE_CATALOG, DeviceProfile)
from repro_torch.core.cnn import (CNNConfig, ConvLayerSpec, cnn_forward,
                                  cnn_forward_ref, init_cnn, init_cnn_float)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

# budgeted resources that are rates (additive across layer instances);
# vmem_bytes is the one capacity
RATE_RESOURCES = tuple(r for r in BUDGET_RESOURCES if r != "vmem_bytes")

# per-layer precisions searched when the caller does not pin bits: spans
# the packed dual-conv regime (d+c ≤ 12), the 8-bit baseline, and the
# wide end of the sweep range
DEFAULT_BIT_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (4, 4), (6, 4), (6, 6), (8, 6), (8, 8), (10, 8), (12, 10))


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
        the reference serves and the port does not yet raises
        ``NotImplementedError``; an unknown kind ``ValueError``."""
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


def device_profile(name: str) -> DeviceProfile:
    """Look up a catalog part by name (``"edge"`` / ``"v5e"`` / ``"v5p"``).

    Fleet configs and launch flags reference profiles as strings; an
    unknown name raises ``DeploymentError`` with the available catalog
    spelled out, instead of the bare ``KeyError`` of
    ``allocate.get_device`` — a typo in a fleet topology should read as
    a deployment problem, not a dict miss."""
    try:
        return allocate.get_device(name)
    except KeyError:
        raise DeploymentError(
            f"unknown device profile {name!r}; the catalog has: "
            f"{sorted(d.name for d in DEVICE_CATALOG)}") from None


def _as_device(device: Optional[BudgetLike]) -> DeviceProfile:
    if device is None:
        return allocate.V5E
    if isinstance(device, DeviceProfile):
        return device
    return DeviceProfile(name="custom", budgets=dict(device))


def layer_calls(block, in_channels: int, out_channels: int) -> int:
    """Kernel calls per forward for one layer: dual-output blocks cover
    output channels two per call (odd tail still costs a call)."""
    blk = get_block(block)
    step = 2 if blk.dual_output else 1
    return math.ceil(out_channels / step) * in_channels


def predict_layer_demand(bm: allocate.BlockModels, block, data_bits: int,
                         coeff_bits: int, spec: ConvLayerSpec, img_h: int,
                         img_w: int, *, tile_h: int = 16,
                         sweep: ConvSweepConfig = SWEEP) -> Dict[str, float]:
    """Predicted whole-layer demand from the per-call fitted models (see
    the module docstring for the scaling rules)."""
    blk = get_block(block)
    per_call = bm.demand(blk.name, data_bits, coeff_bits)
    calls = layer_calls(blk, spec.in_channels, spec.out_channels)
    sweep_h, sweep_w = 4 * sweep.tile_h, sweep.tile_w
    geom = (img_h / sweep_h) * (img_w / sweep_w)
    out = {r: per_call[r] * calls * geom for r in RATE_RESOURCES}
    n_out = 2 if blk.dual_output else 1
    dep = synth.vmem_bytes(img_h, img_w, tile_h, data_bits, coeff_bits, n_out)
    ref = synth.vmem_bytes(sweep_h, sweep_w, sweep.tile_h, data_bits,
                           coeff_bits, n_out)
    out["vmem_bytes"] = per_call["vmem_bytes"] * dep / max(ref, 1.0)
    return out


def _layer_candidates(spec: ConvLayerSpec, bm: allocate.BlockModels,
                      bit_candidates) -> List[Tuple[str, int, int]]:
    """Search space for one layer.  A spec with an explicit ``block`` is
    fully user-pinned — block AND bits are taken verbatim, the planner
    never overrides them (the caller handles a pin the models don't
    cover)."""
    if spec.block is not None:
        return [(get_block(spec.block).name, spec.data_bits,
                 spec.coeff_bits)]
    bits = [(spec.data_bits, spec.coeff_bits)] if bit_candidates is None \
        else list(dict.fromkeys(tuple(b) for b in bit_candidates))
    out = []
    for name in sorted(bm.models):
        blk = get_block(name)
        out.extend((name, d, c) for d, c in bits if blk.supports(d, c))
    return out


def plan_deployment(cfg: CNNConfig, bm: allocate.BlockModels,
                    device: Optional[BudgetLike] = None, *,
                    bit_candidates=None, target: float = 0.8,
                    tile_h: int = 16,
                    on_infeasible: str = "raise") -> DeploymentPlan:
    """Greedy per-layer assignment under one device's budgets.

    Layers are assigned in order; each takes the candidate that fits the
    remaining budget and maximizes, lexicographically: precision
    (data+coeff bits), convolutions/step, then lowest budget-normalized
    demand — i.e. the highest-quality, highest-throughput assignment
    that still fits.  ``bit_candidates=None`` pins every layer to its
    spec's bits (block search only); a sequence of (data, coeff) pairs
    opens the per-layer precision search.  ``on_infeasible="fallback"``
    assigns the least-demanding candidate instead of raising and marks
    the plan ``feasible=False``.
    """
    if on_infeasible not in ("raise", "fallback"):
        raise ValueError(f"on_infeasible={on_infeasible!r}")
    dev = _as_device(device)
    budgets = {r: float(dev.budgets[r]) for r in BUDGET_RESOURCES}
    remaining = {r: target * budgets[r] for r in RATE_RESOURCES}
    vmem_cap = target * budgets["vmem_bytes"]
    eps = 1e-9

    assignments: List[LayerAssignment] = []
    feasible = True
    for i, spec in enumerate(cfg.layers):
        if spec.block is not None \
                and get_block(spec.block).name not in bm.models:
            if on_infeasible == "raise":
                raise DeploymentError(
                    f"layer {i} pins block {spec.block!r} but the fitted "
                    f"models only cover {sorted(bm.models)}")
            # an explicit pin wins unconditionally (the seed contract
            # choose_blocks preserves) even when the sweep never modeled
            # the block; its demand is unknown, so the plan cannot claim
            # feasibility
            name = get_block(spec.block).name
            assignments.append(LayerAssignment(
                index=i, block=name, data_bits=spec.data_bits,
                coeff_bits=spec.coeff_bits,
                calls=layer_calls(name, spec.in_channels,
                                  spec.out_channels),
                demand={r: 0.0 for r in BUDGET_RESOURCES}))
            feasible = False
            continue
        best = None
        best_key = None
        cheapest = None                # least over-budget, for fallback
        cheapest_over = float("inf")
        for name, d, c in _layer_candidates(spec, bm, bit_candidates):
            demand = predict_layer_demand(bm, name, d, c, spec,
                                          cfg.img_h, cfg.img_w,
                                          tile_h=tile_h)
            # overflow as a fraction of the device budget, so bytes and
            # rates are comparable when picking the least-bad candidate
            over = max(
                max((demand[r] - remaining[r]) / budgets[r]
                    for r in RATE_RESOURCES),
                (demand["vmem_bytes"] - vmem_cap) / budgets["vmem_bytes"])
            norm = sum(demand[r] / budgets[r] for r in RATE_RESOURCES)
            if over < cheapest_over:
                cheapest, cheapest_over = (name, d, c, demand), over
            if over > eps:
                continue
            key = (d + c, bm.convs[name], -norm, name)
            if best_key is None or key > best_key:
                best, best_key = (name, d, c, demand), key
        if best is None:
            if cheapest is None:
                raise DeploymentError(
                    f"layer {i}: no (block, bits) candidate at all — "
                    f"fitted models cover {sorted(bm.models)}")
            if on_infeasible == "raise":
                cname, cd, cc, cdem = cheapest
                caps = dict(remaining, vmem_bytes=vmem_cap)
                worst = max(cdem, key=lambda r: (cdem[r] - caps[r])
                            / budgets[r])
                raise DeploymentError(
                    f"layer {i} ({spec.in_channels}→{spec.out_channels}ch)"
                    f" does not fit device {dev.name!r} at target "
                    f"{target:.0%}: least-demanding candidate "
                    f"{cname}@d{cd}/c{cc} exceeds the remaining "
                    f"{worst!r} budget by {cheapest_over:.1%} of the "
                    f"device budget")
            best = cheapest
            feasible = False
        name, d, c, demand = best
        for r in RATE_RESOURCES:
            remaining[r] = max(0.0, remaining[r] - demand[r])
        assignments.append(LayerAssignment(
            index=i, block=name, data_bits=d, coeff_bits=c,
            calls=layer_calls(name, spec.in_channels, spec.out_channels),
            demand=demand))

    totals = {r: sum(a.demand[r] for a in assignments)
              for r in RATE_RESOURCES}
    totals["vmem_bytes"] = max(
        (a.demand["vmem_bytes"] for a in assignments), default=0.0)
    usage = {r: 100.0 * totals[r] / budgets[r] for r in BUDGET_RESOURCES}
    plane_convs = sum(s.in_channels * s.out_channels for s in cfg.layers)
    total_calls = sum(a.calls for a in assignments)
    return DeploymentPlan(
        device=dev, target=target, layers=tuple(assignments),
        demand=totals, usage_pct=usage,
        convs_per_step=plane_convs / max(total_calls, 1),
        feasible=feasible, cnn=cfg)


# ---------------------------------------------------------------------------
# quantization error vs the float oracle
# ---------------------------------------------------------------------------

def _conv3x3_f32(x2d, w3x3):
    """Float 'same'-padded 3×3 convolution (the float twin of
    ref.conv2d_3x3_ref)."""
    xp = torch.nn.functional.pad(x2d, (1, 1, 1, 1))
    h, w = x2d.shape
    return sum(w3x3[di, dj] * xp[di:di + h, dj:dj + w]
               for di in range(3) for dj in range(3))


def _float_forward(float_params, x, cfg: CNNConfig):
    """Float mirror of ``cnn_forward_ref``: same per-layer 2^-shift
    rescale and [0, 2^(d-1)-1] clamp, but no rounding or integer
    containers — the quantization-free oracle."""
    act = x
    for spec, w in zip(cfg.layers, float_params):
        h, wd, cin = act.shape
        acc = torch.zeros((spec.out_channels, h, wd), dtype=torch.float32)
        for oc in range(spec.out_channels):
            for ic in range(cin):
                acc[oc] += _conv3x3_f32(act[:, :, ic], w[oc, ic])
        hi = (1 << (spec.data_bits - 1)) - 1
        act = torch.clamp(acc / (1 << spec.shift), 0.0, hi).permute(1, 2, 0)
    return act


def quantization_error(cfg: CNNConfig, *,
                       generator: Optional[torch.Generator] = None,
                       seed: int = 0) -> float:
    """Relative RMSE of the quantized CNN against its float oracle on a
    deterministic probe image (per-plan Pareto axis), on the CPU.  The
    weights are drawn from ``generator`` (seeded with 0 when none is
    given), so the value differs from the reference's ``jax.random``
    draw; the probe image is the reference's (numpy, ``seed``)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    float_params = init_cnn_float(generator, cfg)
    params = [ops.quantize_fixed(w, spec.coeff_bits)
              for w, spec in zip(float_params, cfg.layers)]
    rng = np.random.default_rng(seed)
    d0 = cfg.layers[0].data_bits
    hi0 = (1 << (d0 - 1)) - 1
    xf = torch.from_numpy(
        rng.uniform(0, hi0, (cfg.img_h, cfg.img_w,
                             cfg.layers[0].in_channels))).to(torch.float32)
    xq = ops.quantize_fixed(xf, d0)
    yq = cnn_forward_ref(params, xq, cfg).to(torch.float32)
    yf = _float_forward(float_params, xf, cfg)
    num = float(torch.sqrt(torch.mean((yq - yf) ** 2)))
    den = float(torch.sqrt(torch.mean(yf ** 2)))
    return num / max(den, 1e-9)


# ---------------------------------------------------------------------------
# Pareto frontier + device selection
# ---------------------------------------------------------------------------

def _dominates(a: DeploymentPlan, b: DeploymentPlan) -> bool:
    """a dominates b over (utilization ↓, convs/step ↑, quant error ↓)."""
    ge = (a.max_usage_pct <= b.max_usage_pct
          and a.convs_per_step >= b.convs_per_step
          and (a.quant_error or 0.0) <= (b.quant_error or 0.0))
    gt = (a.max_usage_pct < b.max_usage_pct
          or a.convs_per_step > b.convs_per_step
          or (a.quant_error or 0.0) < (b.quant_error or 0.0))
    return ge and gt


def pareto_filter(plans: Sequence[DeploymentPlan]) -> List[DeploymentPlan]:
    return [p for p in plans
            if not any(_dominates(q, p) for q in plans if q is not p)]


def pareto_frontier(cfg: CNNConfig, bm: allocate.BlockModels,
                    devices: Optional[Sequence[DeviceProfile]] = None, *,
                    bit_candidates=DEFAULT_BIT_CANDIDATES,
                    target: float = 0.8,
                    measure_error: bool = True) -> List[DeploymentPlan]:
    """Feasible plans across the catalog: one mixed-precision searched
    plan per device plus one uniform-precision plan per (device, bit
    candidate), Pareto-filtered over (max utilization, convs/step,
    quantization error).  Infeasible (device, precision) combinations
    are silently skipped — an empty result means nothing in the catalog
    fits."""
    devices = tuple(devices if devices is not None else DEVICE_CATALOG)
    bit_candidates = tuple(bit_candidates or ())
    plans: List[DeploymentPlan] = []
    seen = set()
    for dev in devices:
        trials = [dict(bit_candidates=bit_candidates or None)]
        trials += [dict(bit_candidates=(bits,)) for bits in bit_candidates]
        for kw in trials:
            try:
                plan = plan_deployment(cfg, bm, dev, target=target, **kw)
            except DeploymentError:
                continue
            key = (dev.name, tuple(plan.block_names()), tuple(plan.bits()))
            if key not in seen:
                seen.add(key)
                plans.append(plan)
    if measure_error:
        cache: Dict[tuple, float] = {}
        for plan in plans:
            k = tuple(plan.bits())
            if k not in cache:
                cache[k] = quantization_error(plan_config(plan, cfg))
            plan.quant_error = cache[k]
    return pareto_filter(plans)


def select_device(cfg: CNNConfig, bm: allocate.BlockModels,
                  catalog: Optional[Sequence[DeviceProfile]] = None, *,
                  bit_candidates=None, target: float = 0.8
                  ) -> Tuple[DeviceProfile, DeploymentPlan]:
    """Cheapest catalog part whose plan fits at the target utilization."""
    catalog = sorted(catalog if catalog is not None else DEVICE_CATALOG,
                     key=lambda d: d.cost)
    failures = []
    for dev in catalog:
        try:
            return dev, plan_deployment(cfg, bm, dev, target=target,
                                        bit_candidates=bit_candidates)
        except DeploymentError as e:
            failures.append(f"{dev.name}: {e}")
    raise DeploymentError(
        "no device in the catalog fits the network:\n  "
        + "\n  ".join(failures))


# ---------------------------------------------------------------------------
# predicted-vs-measured validation (paper §4.1)
# ---------------------------------------------------------------------------

@dataclass
class PlanValidation:
    predicted: Dict[str, np.ndarray]   # resource → per-layer vector
    measured: Dict[str, np.ndarray]
    metrics: Dict[str, Dict[str, float]]   # resource → mse/mae/r2/mape_pct
    bit_exact: bool
    quant_error: float


def measure_layer_resources(plan: DeploymentPlan, cfg: CNNConfig, *,
                            tile_h: int = 16) -> Dict[str, np.ndarray]:
    """Re-count every planned layer's plane form at the *deployed*
    geometry with the op census and aggregate exactly like the
    predictor: per-call count × calls for rates; for vmem, the staged
    working set the census exposes (``pallas_vmem_bytes``) — measured
    from the plane form's own operands, independent of the analytic
    ``synth.vmem_bytes`` formula the models were fitted on."""
    measured = {r: np.zeros(len(plan.layers)) for r in BUDGET_RESOURCES}
    for i, a in enumerate(plan.layers):
        res = census.block_resources(
            a.block, cfg.img_h, cfg.img_w, data_bits=a.data_bits,
            coeff_bits=a.coeff_bits, tile_h=tile_h)
        for r in RATE_RESOURCES:
            measured[r][i] = float(res.get(r, 0.0)) * a.calls
        measured["vmem_bytes"][i] = float(res["pallas_vmem_bytes"])
    return measured


def validate_plan(plan: DeploymentPlan, cfg: CNNConfig, *,
                  generator: Optional[torch.Generator] = None,
                  seed: int = 0, tile_h: int = 16,
                  device: DeviceLike = "cuda") -> PlanValidation:
    """Close the loop: run the plan on one image on ``device`` — the
    single-image ``cnn_forward``, i.e. the per-plane path, K3–K6 on the
    card — bit-exactly against ``cnn_forward_ref`` on the CPU, and score
    the resource models against a fresh census of the deployed layers.
    Weights are an ``init_cnn`` draw from ``generator`` (seeded with 0
    when none is given); the image is the reference's (numpy,
    ``seed``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    pcfg = plan_config(plan, cfg)

    # the quantization error draws the same weights, as the reference's
    # reuse of one key does
    twin = torch.Generator().set_state(generator.get_state())
    params = init_cnn(generator, pcfg)
    rng = np.random.default_rng(seed)
    d0 = pcfg.layers[0].data_bits
    x = ops.quantize_fixed(torch.from_numpy(
        rng.integers(0, (1 << (d0 - 1)),
                     (pcfg.img_h, pcfg.img_w, pcfg.layers[0].in_channels))
        .astype(np.float32)), d0)
    y = cnn_forward([w.to(dev) for w in params], x.to(dev), pcfg,
                    plan.block_names())
    yr = cnn_forward_ref(params, x, pcfg)
    bit_exact = bool(torch.equal(y.cpu(), yr))

    predicted = {r: np.array([a.demand[r] for a in plan.layers])
                 for r in BUDGET_RESOURCES}
    measured = measure_layer_resources(plan, cfg, tile_h=tile_h)
    metrics = {r: polyfit.error_metrics(measured[r], predicted[r])
               for r in BUDGET_RESOURCES}
    return PlanValidation(
        predicted=predicted, measured=measured, metrics=metrics,
        bit_exact=bit_exact,
        quant_error=quantization_error(pcfg, generator=twin, seed=seed))
