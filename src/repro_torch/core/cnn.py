"""Fixed-point CNN built on the convolution-block library.

Port of ``repro.core.cnn``: the layer specs and config, the quickstart
network, the weight draw, the per-layer requantize, the batched forward
(each layer one ``ConvBlock.apply_batched``) and the integer oracle.

Numerics: power-of-two fixed-point.  Activations and weights are
quantized to (data_bits, coeff_bits); accumulation is exact int32; each
layer rescales by a right-shift and clamps back into the activation
range (ReLU folded into the clamp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.blocks import BIT_RANGE, BlockLike, get_block
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
    activation range, contiguous for the next layer's kernel.  ``>>`` is
    arithmetic on int32 in both frameworks; a shift past 31 fills with
    the sign, as XLA's does."""
    lo, hi = 0, (1 << (spec.data_bits - 1)) - 1
    return torch.clamp(acc >> min(spec.shift, 31), lo, hi) \
        .to(conv2d.container_dtype(spec.data_bits)).movedim(-3, -1) \
        .contiguous()


def cnn_forward(params, x, cfg: CNNConfig, blocks: Sequence[BlockLike]):
    """x: (H, W, C_in) quantized ints, or an (N, H, W, C_in) image batch,
    on the device of ``params``.  Returns the last layer's (H, W, C_out)
    — or (N, H, W, C_out).  Each layer is one ``apply_batched`` call
    through the assigned block, then ``_requantize``."""
    act = x
    for spec, w, block in zip(cfg.layers, params, blocks):
        acc = get_block(block).apply_batched(
            act, w, data_bits=spec.data_bits, coeff_bits=spec.coeff_bits)
        act = _requantize(acc, spec)
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
