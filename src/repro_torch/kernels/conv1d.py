"""Depthwise causal conv1d of the Mamba-2 mixer: the CUDA kernel K7 and
its plain version.

Port of ``repro.kernels.conv1d``.  ``causal_conv1d`` replaces
``causal_conv1d_pallas`` (``_kernel``): K float32 multiply-adds per
output over a left halo of K-1 positions, float32 out, before the SiLU.
The Pallas kernel pads the halo with zeros; this one reads it from a
state (the trailing K-1 inputs of the previous call) where one is
given, so the same kernel serves prefill at any length and decode at one
position.  A wrapper runs the plain version for a tensor on the CPU and
launches the kernel (``csrc/causal_conv1d.cu``) for a tensor on the card
(or raises) through ``build.launch``, which counts it in
``build.LAUNCHES["causal_conv1d"]`` and reports its work.

Gradients: where grad is enabled and an input requires it, the call
goes through ``_CausalConv1d``, a ``torch.autograd.Function`` whose
forward is the same launch (the plain version on the CPU).  The
reference has no backward kernel (``jax.grad`` differentiates its
model's jnp conv); the backward here is torch ops in float32: the
gradient of the padded input (state ‖ x) is the conv of dy with the
taps run backwards in time, and dw[j, c] = Σ (state ‖ x)[b, s+j, c] ·
dy[b, s, c].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import causal_conv1d_ref

FLOATS = (torch.float32, torch.bfloat16)
MAX_K = 8                      # taps the kernel instantiates (1 .. 8)


def causal_conv1d_plain(x: torch.Tensor, w: torch.Tensor,
                        state: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version of ``causal_conv1d``: the oracle's K-tap loop, whose
    products and sums the kernel rounds in the same order."""
    return causal_conv1d_ref(x, w, state)


def _check(x: torch.Tensor, w: torch.Tensor,
           state: Optional[torch.Tensor]) -> None:
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2] \
            or w.shape[0] < 1:
        raise ValueError(f"causal_conv1d: expected x (B, S, C) and w (K, C), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    k = w.shape[0]
    if state is not None and (
            tuple(state.shape) != (x.shape[0], k - 1, x.shape[2])
            or state.dtype != x.dtype or state.device != x.device):
        raise ValueError(
            f"causal_conv1d: state must be (B, K-1, C) = "
            f"{(x.shape[0], k - 1, x.shape[2])} in x's dtype on x's device, "
            f"got {tuple(state.shape)} {state.dtype} on {state.device}")
    if x.dtype not in FLOATS or w.dtype != x.dtype:
        raise ValueError(f"causal_conv1d: x and w must share one dtype, "
                         f"float32 or bfloat16, got {x.dtype} and "
                         f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"causal_conv1d: x on {x.device} but w on "
                         f"{w.device}")


_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, state, y, bf16, b, s, c, k, stream
_ARGTYPES = (_P, _P, _P, _P) + (_I,) * 5 + (_P,)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[b, s, c] = Σ_j (state ‖ x)[b, s + j, c] · w[j, c] in float32:
    x (B, S, C) and w (K, C) both in float32 or both in bfloat16, state
    (B, K-1, C) in x's dtype or None (zeros) → float32 (B, S, C), before the SiLU.
    One CUDA launch on the card; the plain version on the CPU.
    Differentiable (``_CausalConv1d``) where grad is enabled and an input
    requires it."""
    _check(x, w, state)
    tensors = (x, w) if state is None else (x, w, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _CausalConv1d.apply(x, w, state)
    return _forward(x, w, state)


class _CausalConv1d(torch.autograd.Function):
    """K7 with a gradient: the forward launches the kernel, the backward
    is torch ops in float32."""

    @staticmethod
    def forward(ctx, x, w, state):
        ctx.save_for_backward(x, w, state)
        return _forward(x, w, state)

    @staticmethod
    def backward(ctx, dy):
        x, w, state = ctx.saved_tensors
        k, s = w.shape[0], x.shape[1]
        dy = dy.float()
        halo = x.new_zeros((x.shape[0], k - 1, x.shape[2])) \
            if state is None else state
        xpad = torch.cat([halo, x], dim=1).float()         # (B, S+K-1, C)
        wf = w.float()
        # d xpad[p] = Σ_j dy[p - j] · w[j] over the p - j inside [0, S)
        dyp = F.pad(dy, (0, 0, k - 1, k - 1))
        dxpad = sum(dyp[:, k - 1 - j:k - 1 - j + s + k - 1] * wf[j]
                    for j in range(k))
        dw = torch.stack([(xpad[:, j:j + s] * dy).sum(dim=(0, 1))
                          for j in range(k)])
        dstate = None if state is None else dxpad[:, :k - 1].to(state.dtype)
        return dxpad[:, k - 1:].to(x.dtype), dw.to(w.dtype), dstate


def _forward(x: torch.Tensor, w: torch.Tensor,
             state: Optional[torch.Tensor]) -> torch.Tensor:
    """The launch on the card (counted), the plain version on the CPU."""
    if x.device.type == "cpu":
        return causal_conv1d_plain(x, w, state)
    k = w.shape[0]
    if k > MAX_K:
        raise ValueError(f"causal_conv1d: the kernel takes K <= {MAX_K}, "
                         f"got {k}")
    tensors = (x, w) if state is None else (x, w, state)
    b, s, c = x.shape
    y = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    return build.launch(
        "causal_conv1d", _ARGTYPES, tensors, y, x.data_ptr(), w.data_ptr(),
        None if state is None or state.numel() == 0 else state.data_ptr(),
        y.data_ptr(), int(x.dtype == torch.bfloat16), b, s, c, k,
        work=(2 * b * s * c * k, sum(t.numel() * t.element_size()
                                     for t in tensors + (y,))))
