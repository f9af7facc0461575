"""Public wrappers of the kernel library and the quantization helper.

Port of ``repro.kernels.ops``: ``quantize_fixed``; ``causal_conv1d`` (the
kernel K7) and its oracle ``causal_conv1d_ref``; and
``conv_block``/``conv_block_ref``, which survive only as deprecated
shims over the ``repro_torch.blocks`` registry — use
``get_block(name).apply(...)`` / ``.reference(...)`` instead.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.kernels import conv1d, conv2d, ref


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


def conv_block(block, x, w, *, data_bits, coeff_bits, tile_h=16):
    """Deprecated string-dispatch shim; use
    ``repro_torch.blocks.get_block(block).apply(...)``."""
    warnings.warn(
        "ops.conv_block is deprecated; use "
        "repro.blocks.get_block(name).apply(...)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.blocks import get_block
    try:
        blk = get_block(block)
    except KeyError as e:       # preserve the seed contract (ValueError)
        raise ValueError(f"unknown block {block!r}") from e
    return blk.apply(x, w, data_bits=data_bits, coeff_bits=coeff_bits,
                     tile_h=tile_h)


def conv_block_ref(block, x, w, **kw):
    """Deprecated shim; use
    ``repro_torch.blocks.get_block(block).reference``."""
    warnings.warn(
        "ops.conv_block_ref is deprecated; use "
        "repro.blocks.get_block(name).reference(...)",
        DeprecationWarning, stacklevel=2)
    del kw  # legacy signature compatibility
    from repro_torch.blocks import get_block
    return get_block(block).reference(x, w)


def causal_conv1d(x, w, conv_state=None) -> torch.Tensor:
    """Depthwise causal conv1d, float32 and before the SiLU: the kernel
    K7 on the card, its plain version on the CPU."""
    return conv1d.causal_conv1d(x, w, conv_state)


def causal_conv1d_ref(x, w, conv_state=None) -> torch.Tensor:
    return ref.causal_conv1d_ref(x, w, conv_state)
