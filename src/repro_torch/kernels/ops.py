"""Quantization helper.  Port of ``repro.kernels.ops.quantize_fixed``."""

from __future__ import annotations

import torch

from repro_torch.kernels import conv2d


def quantize_fixed(x, bits: int, *, signed: bool = True) -> torch.Tensor:
    """Clamp float/int data into a ``bits``-bit signed fixed-point range and
    store it in the smallest integer container.  ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    x = torch.as_tensor(x)
    lo = -(1 << (bits - 1)) if signed else 0
    hi = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1
    dtype = conv2d.container_dtype(bits)
    if not x.is_floating_point():      # integers wrap into the container
        return torch.clamp(x, lo, hi).to(dtype)
    # floats saturate at the container's ends, as XLA's conversion does
    # (an unsigned 8- or 16-bit range exceeds its signed container)
    info = torch.iinfo(dtype)
    return torch.clamp(torch.round(x), max(lo, info.min),
                       min(hi, info.max)).to(dtype)
