"""The paper's four convolution blocks as ``ConvBlock`` subclasses.

Port of ``repro.blocks.paper``; instances are registered at import so
``get_block("conv1")`` etc. work everywhere.  Each block pairs its
metadata with its plain row-tile body (``kernel_body``, the counterpart
of the reference's Pallas body) and its plane kernel: Conv2, Conv3 and
Conv4 the per-plane kernels ``conv2_planes``, ``conv3_planes`` and
``conv4_planes``; Conv1 its whole-layer shift-add kernel
``conv1_layer``, which computes the same function on a one-channel
layer.  Conv1 also runs ``conv1_layer`` for a whole image and through
the default ``batched_layer``.  The dot blocks override ``batched_layer``
as the reference's do: Conv2/Conv4 with the fused implicit-GEMM dot,
Conv3 with the operand-packed dot while packing is valid and the fused
dot outside it; and ``batched_layer_requant`` with the same kernels'
requantizing entries.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.blocks.base import (ConvBlock, fused_dot_layer,
                                     fused_dot_layer_requant,
                                     packed_dot_layer,
                                     packed_dot_layer_requant)
from repro_torch.blocks.registry import register_block
from repro_torch.kernels import conv2d


@dataclass(frozen=True)
class Conv1Block(ConvBlock):
    """Multiply-free shift-add (LUT+carry-chain analogue)."""

    def serving_kernels(self, data_bits, coeff_bits):
        return ("conv1_layer",)

    def kernel_body(self, *, data_bits, coeff_bits):
        return functools.partial(conv2d.conv1_tile, data_bits=data_bits,
                                 coeff_bits=coeff_bits)

    def plane_kernel(self, x, w, *, data_bits, coeff_bits):
        # each plane is a one-channel layer of its own
        return torch.stack([
            self.layer_kernel(xp[None, :, :, None], wp[None, None],
                              data_bits=data_bits,
                              coeff_bits=coeff_bits)[0, 0]
            for xp, wp in zip(x, w)])

    def plane_layer(self, x, w, *, data_bits, coeff_bits):
        return self.layer_kernel(x[None], w, data_bits=data_bits,
                                 coeff_bits=coeff_bits)[0]

    def layer_kernel(self, x, w, *, data_bits, coeff_bits):
        return conv2d.conv1_layer(x, w, data_bits=data_bits,
                                  coeff_bits=coeff_bits)


@dataclass(frozen=True)
class Conv2Block(ConvBlock):
    """im2col + one integer dot (1-DSP analogue)."""

    def serving_kernels(self, data_bits, coeff_bits):
        return ("fused_dot_layer",)

    def kernel_body(self, *, data_bits, coeff_bits):
        return functools.partial(conv2d.conv2_tile, data_bits=data_bits,
                                 coeff_bits=coeff_bits)

    def plane_kernel(self, x, w, *, data_bits, coeff_bits):
        return conv2d.conv2_planes(x, w, data_bits=data_bits,
                                   coeff_bits=coeff_bits)

    def batched_layer(self, x, w, *, data_bits, coeff_bits, tile_h=16):
        return fused_dot_layer(x, w, data_bits=data_bits,
                               coeff_bits=coeff_bits)

    def batched_layer_requant(self, x, w, *, data_bits, coeff_bits, shift):
        return fused_dot_layer_requant(x, w, data_bits=data_bits,
                                       coeff_bits=coeff_bits, shift=shift,
                                       out_bits=data_bits)


@dataclass(frozen=True)
class Conv3Block(ConvBlock):
    """Two coefficient planes packed into one operand: a single dot
    yields both convolutions while data_bits + coeff_bits ≤ 12; outside
    that regime it degrades to two dots (the discontinuity the paper's
    segmented regression models)."""

    def packed_ok(self, data_bits, coeff_bits):
        return conv2d.conv3_packed_ok(data_bits, coeff_bits)

    def serving_kernels(self, data_bits, coeff_bits):
        return (("packed_dot_layer",) if self.packed_ok(data_bits, coeff_bits)
                else ("fused_dot_layer",))

    def kernel_body(self, *, data_bits, coeff_bits):
        return functools.partial(conv2d.conv3_tile, data_bits=data_bits,
                                 coeff_bits=coeff_bits)

    def plane_kernel(self, x, w, *, data_bits, coeff_bits):
        return conv2d.conv3_planes(x, w, data_bits=data_bits,
                                   coeff_bits=coeff_bits)

    def batched_layer(self, x, w, *, data_bits, coeff_bits, tile_h=16):
        if self.packed_ok(data_bits, coeff_bits):
            return packed_dot_layer(x, w, data_bits=data_bits,
                                    coeff_bits=coeff_bits)
        # outside the packing regime the kernel degrades to two dots —
        # exactly the plain fused dot
        return fused_dot_layer(x, w, data_bits=data_bits,
                               coeff_bits=coeff_bits)

    def batched_layer_requant(self, x, w, *, data_bits, coeff_bits, shift):
        kw = dict(data_bits=data_bits, coeff_bits=coeff_bits, shift=shift,
                  out_bits=data_bits)
        if self.packed_ok(data_bits, coeff_bits):
            return packed_dot_layer_requant(x, w, **kw)
        return fused_dot_layer_requant(x, w, **kw)


@dataclass(frozen=True)
class Conv4Block(ConvBlock):
    """Two parallel dots (2-DSP analogue), two convolutions per step."""

    def serving_kernels(self, data_bits, coeff_bits):
        return ("fused_dot_layer",)

    def kernel_body(self, *, data_bits, coeff_bits):
        return functools.partial(conv2d.conv4_tile, data_bits=data_bits,
                                 coeff_bits=coeff_bits)

    def plane_kernel(self, x, w, *, data_bits, coeff_bits):
        return conv2d.conv4_planes(x, w, data_bits=data_bits,
                                   coeff_bits=coeff_bits)

    def batched_layer(self, x, w, *, data_bits, coeff_bits, tile_h=16):
        return fused_dot_layer(x, w, data_bits=data_bits,
                               coeff_bits=coeff_bits)

    def batched_layer_requant(self, x, w, *, data_bits, coeff_bits, shift):
        return fused_dot_layer_requant(x, w, data_bits=data_bits,
                                       coeff_bits=coeff_bits, shift=shift,
                                       out_bits=data_bits)


CONV1 = register_block(Conv1Block(
    name="conv1", convs_per_step=1, dual_output=False,
    description="multiply-free shift-add (logic-only)"))
CONV2 = register_block(Conv2Block(
    name="conv2", convs_per_step=1, dual_output=False,
    description="im2col + one MXU dot (1 DSP)"))
CONV3 = register_block(Conv3Block(
    name="conv3", convs_per_step=2, dual_output=True,
    description="operand-packed dual conv (1 DSP for 2 convs when packed)"))
CONV4 = register_block(Conv4Block(
    name="conv4", convs_per_step=2, dual_output=True,
    description="two parallel MXU dots (2 DSPs)"))
