"""Fixed-point CNN built on the convolution-block library.

Port of ``repro.core.cnn``: the layer specs and config, the quickstart
network, model-driven block selection (``fitted_block_models``,
``choose_blocks``), the weight draw, the per-layer requantize, the
batched forward (each layer one ``ConvBlock.apply_batched``), the
per-plane baseline ``cnn_forward_loop`` and the integer oracle.

Numerics: power-of-two fixed-point.  Activations and weights are
quantized to (data_bits, coeff_bits); accumulation is exact int32; each
layer rescales by a right-shift and clamps back into the activation
range (ReLU folded into the clamp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.blocks import BIT_RANGE, BlockLike, ConvBlock, get_block
from repro_torch.core import allocate, synth
from repro_torch.kernels import conv2d, ops, ref


@dataclass(frozen=True)
class ConvLayerSpec:
    in_channels: int
    out_channels: int
    data_bits: int = 8
    coeff_bits: int = 8
    shift: int = 7                 # post-accumulation right-shift
    block: Optional[str] = None    # registry name; None → planner decides

    def __post_init__(self):
        lo, hi = BIT_RANGE
        for name in ("data_bits", "coeff_bits"):
            bits = getattr(self, name)
            if not lo <= bits <= hi:
                raise ValueError(
                    f"ConvLayerSpec.{name}={bits} outside the supported "
                    f"block bit range {BIT_RANGE}")
        if self.shift < 0:
            raise ValueError(f"ConvLayerSpec.shift={self.shift} must be ≥ 0")
        if self.in_channels < 1 or self.out_channels < 1:
            raise ValueError(
                f"ConvLayerSpec needs ≥ 1 channel, got "
                f"{self.in_channels}→{self.out_channels}")


@dataclass
class CNNConfig:
    layers: Tuple[ConvLayerSpec, ...]
    img_h: int = 32
    img_w: int = 128


def quickstart_cnn_config() -> CNNConfig:
    """The quickstart CNN (the reference's examples and benchmarks share
    this one definition)."""
    return CNNConfig(layers=(
        ConvLayerSpec(1, 8, data_bits=8, coeff_bits=6),
        ConvLayerSpec(8, 8, data_bits=8, coeff_bits=6),
        ConvLayerSpec(8, 4, data_bits=6, coeff_bits=4),
    ), img_h=32, img_w=128)


# fitted-model memo for the default sweep, keyed on the sweep schema
# version: repeated planning/serving calls share ONE sweep + fit per
# process; a SWEEP_SCHEMA_VERSION bump naturally invalidates the entry
_FITTED_MODELS: Dict[str, allocate.BlockModels] = {}


def fitted_block_models(rows=None) -> allocate.BlockModels:
    """``BlockModels`` for the block library.  Explicit ``rows`` are
    fitted directly (caller owns the sweep); ``rows=None`` serves the
    process-wide memoized fit of the default sweep (``synth.run_sweep``,
    cached under ``build/repro_torch/``)."""
    if rows is not None:
        return allocate.BlockModels.fit(rows)
    key = synth.SWEEP_SCHEMA_VERSION
    if key not in _FITTED_MODELS:
        _FITTED_MODELS[key] = allocate.BlockModels.fit(synth.run_sweep())
    return _FITTED_MODELS[key]


def clear_fitted_model_cache() -> None:
    """Drop the memoized default-sweep fit (tests / custom registries)."""
    _FITTED_MODELS.clear()


def choose_blocks(cfg: CNNConfig, rows=None,
                  budgets=None) -> List[ConvBlock]:
    """Model-driven block selection (paper §4.2), a thin wrapper over
    the deployment planner (``repro_torch.core.deploy``): each layer
    gets the block the fitted models pick under the device budget at
    the layer's spec bits.  An explicit ``ConvLayerSpec.block`` wins
    unconditionally, and selection never fails: a network that
    overflows the device falls back to the least-demanding block per
    overflowing layer instead of raising.  Use
    ``deploy.plan_deployment`` directly for strict budget enforcement,
    precision search and the full plan."""
    from repro_torch.core import deploy
    bm = fitted_block_models(rows)
    plan = deploy.plan_deployment(cfg, bm, budgets, target=0.8,
                                  on_infeasible="fallback")
    return [get_block(a.block) for a in plan.layers]


def init_cnn_float(generator: torch.Generator, cfg: CNNConfig
                   ) -> List[torch.Tensor]:
    """Per-layer float weight draws before coefficient quantization:
    standard normal × 2^(coeff_bits-2)/3, the reference's formula.  The
    layers draw one after another from ``generator`` on the CPU, so the
    numbers differ from the reference's ``jax.random`` draw; carry the
    reference's weights across with ``repro_torch.convert`` where both
    sides must compute the same thing."""
    params = []
    for spec in cfg.layers:
        w = torch.randn((spec.out_channels, spec.in_channels, 3, 3),
                        generator=generator, dtype=torch.float32)
        params.append(w * (2.0 ** (spec.coeff_bits - 2) / 3.0))
    return params


def init_cnn(generator: torch.Generator, cfg: CNNConfig
             ) -> List[torch.Tensor]:
    """Quantized weights, one (out_ch, in_ch, 3, 3) container tensor per
    layer, on the CPU (see ``init_cnn_float`` for how the draw differs
    from the reference's)."""
    return [ops.quantize_fixed(w, spec.coeff_bits)
            for w, spec in zip(init_cnn_float(generator, cfg), cfg.layers)]


def _requantize(acc: torch.Tensor, spec: ConvLayerSpec) -> torch.Tensor:
    """Rescale + ReLU + requantize one layer's int32 accumulator —
    (out_ch, H, W) or (N, out_ch, H, W) — back into the channels-last
    activation range, contiguous for the next layer's kernel
    (``conv2d.requantize`` at the layer's shift and data bits; the dot
    layers' kernels run the same arithmetic in their epilogue)."""
    return conv2d.requantize(acc, spec.shift, spec.data_bits)


def cnn_forward(params, x, cfg: CNNConfig, blocks: Sequence[BlockLike],
                *, mesh=None):
    """x: (H, W, C_in) quantized ints, or an (N, H, W, C_in) image batch,
    on the device of ``params``.  Returns the last layer's (H, W, C_out)
    — or (N, H, W, C_out).  Each layer is one ``apply_batched`` call
    through the assigned block, then ``_requantize``.

    ``mesh``: a ``parallel.sharding.CNNDataMesh`` for data-parallel
    serving — a batch splits over its devices by
    ``cnn_batch_sharding`` (whole on each where N does not divide
    them), each device runs every layer on its slice with its own copy
    of the weights, and the slices are joined on the first device."""
    if mesh is not None and x.ndim == 4:
        from repro_torch.parallel.sharding import cnn_batch_sharding
        sharding = cnn_batch_sharding(mesh, x.shape[0])
        parts = [on_device(dev, cnn_forward,
                           [w.to(dev) for w in params], part, cfg, blocks)
                 for dev, part in zip(mesh.devices, sharding.split(x))]
        return sharding.join(parts)
    act = x
    for spec, w, block in zip(cfg.layers, params, blocks):
        acc = get_block(block).apply_batched(
            act, w, data_bits=spec.data_bits, coeff_bits=spec.coeff_bits)
        act = _requantize(acc, spec)
    return act


def on_device(device: torch.device, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``device`` the current card where it
    is one (the kernels launch on the current card's stream)."""
    if device.type != "cuda":
        return fn(*args, **kwargs)
    with torch.cuda.device(device):
        return fn(*args, **kwargs)


def cnn_forward_loop(params, x, cfg: CNNConfig,
                     blocks: Sequence[BlockLike]):
    """The per-plane baseline: one ``ConvBlock.apply`` — one plane-kernel
    launch — per (out_ch, in_ch) plane, or per (channel pair, in_ch)
    plane for dual blocks.  x: one (H, W, C_in) image on the device of
    ``params``; returns (H, W, C_out).  Kept as the reference keeps it,
    for the batched-vs-loop comparison and as a cross-check; prefer
    ``cnn_forward``."""
    act = x
    for spec, w, block in zip(cfg.layers, params, blocks):
        blk = get_block(block)
        h, wd, cin = act.shape
        acc = torch.zeros((spec.out_channels, h, wd), dtype=torch.int64,
                          device=act.device)
        kw = dict(data_bits=spec.data_bits, coeff_bits=spec.coeff_bits)
        step = 2 if blk.dual_output else 1
        for oc in range(0, spec.out_channels, step):
            for ic in range(cin):
                x2d = act[:, :, ic]
                if blk.dual_output:
                    oc2 = min(oc + 1, spec.out_channels - 1)
                    y = blk.apply(x2d, torch.stack([w[oc, ic], w[oc2, ic]]),
                                  **kw)
                    acc[oc] += y[0]
                    if oc2 != oc:
                        acc[oc2] += y[1]
                else:
                    acc[oc] += blk.apply(x2d, w[oc, ic], **kw)
        act = _requantize(conv2d.wrap_int(acc).to(torch.int32), spec)
    return act


def cnn_forward_ref(params, x, cfg: CNNConfig):
    """Float-free oracle using the plain per-plane convolution (exact
    same integer math).  Accepts a single (H, W, C) image or an
    (N, H, W, C) batch — batches run image by image, so the batched path
    is checked against independent per-image math."""
    if x.ndim == 4:
        return torch.stack([cnn_forward_ref(params, xi, cfg) for xi in x])
    act = x
    for spec, w in zip(cfg.layers, params):
        h, wd, cin = act.shape
        acc = torch.zeros((spec.out_channels, h, wd), dtype=torch.int64,
                          device=act.device)
        for oc in range(spec.out_channels):
            for ic in range(cin):
                acc[oc] += ref.conv2d_3x3_ref(act[:, :, ic], w[oc, ic])
        act = _requantize(conv2d.wrap_int(acc).to(torch.int32), spec)
    return act
