"""Shared layers: norms, rotary embeddings, MLPs, initializers.

Port of ``repro.models.layers``.  Modules are pure functions over
explicit parameter dictionaries, as the reference's are over pytrees.
Initializers draw from a ``torch.Generator`` (which cannot reproduce
``jax.random``: parity tests carry the reference's parameters across
with ``repro_torch.convert.lm_params_from_numpy``); without a generator
they return empty tensors of the same shapes and dtypes on ``meta``,
the port's counterpart of ``jax.eval_shape``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import is_dtensor, resolve_partial


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

# a leaf of more elements than this is drawn in slices of its leading
# axis, each at most this size, so that its float32 draw never exists
# whole (Llama-4-Maverick's (128, 5120, 8192) expert leaf would be a
# 21.5 GB transient); every leaf of Llama-3.2-3B and Mamba-2-1.3B is
# smaller and drawn in one piece
DRAW_SLICE = 1 << 29


def _normal(gen: Optional[torch.Generator], shape: Sequence[int],
            scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Standard normal draws in float32 times ``scale``, cast to
    ``dtype``, on the generator's device; on ``meta`` without one.  A
    leaf above ``DRAW_SLICE`` elements is drawn slice by slice into the
    result."""
    shape = tuple(shape)
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    n = math.prod(shape)
    if n <= DRAW_SLICE or len(shape) < 2:
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (x * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, DRAW_SLICE // (n // shape[0]))
    for r in range(0, shape[0], rows):
        part = torch.randn((min(rows, shape[0] - r),) + shape[1:],
                           generator=gen, dtype=torch.float32,
                           device=gen.device)
        out[r:r + rows].copy_(part.mul_(scale))
    return out


def dense_init(gen, shape, dtype, fan_in: Optional[int] = None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return _normal(gen, shape, 1.0 / math.sqrt(max(1, fan_in)), dtype)


def embed_init(gen, shape, dtype):
    return _normal(gen, shape, 0.02, dtype)


def const_init(gen, shape, value: float, dtype=torch.float32):
    """A constant (zeros for norms and biases, ones for skips)."""
    device = "meta" if gen is None else gen.device
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the scale ``1 + weight`` (zero-initialized
    weights are the identity scale), cast back to x's dtype.  Under a
    mesh a partial-sum input (the residual stream after a row-parallel
    product) is all-reduced first and a normalized dim sharded over an
    axis is gathered (Mamba's gated norm over its inner channels), so
    the norm runs on whole rows."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = Shard(x.ndim - 1)
        x = resolve_partial(x)
        if last in x.placements:
            x = x.redistribute(placements=[
                Replicate() if p == last else p for p in x.placements])
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  The
    rotation pairs the two halves of D (x[:D/2] with x[D/2:]), not
    interleaved neighbours, as the reference does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU / GeGLU, or plain 2-matrix)
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, gated: bool, dtype):
    p = {"w_up": dense_init(gen, (d_model, d_ff), dtype),
         "w_down": dense_init(gen, (d_ff, d_model), dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype)
    return p


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is
    # the exact erf form
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(x @ p["w_gate"], act) * h
    else:
        h = _act(h, act)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# logit softcap (gemma-2)
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
