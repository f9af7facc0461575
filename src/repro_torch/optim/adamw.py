"""AdamW with optional block-wise 8-bit quantized moments.

Port of ``repro.optim.adamw``.  The 8-bit mode stores m and v as int8
with one float32 scale per 256-element block (the block's max magnitude
maps to 127; ``torch.round`` rounds half to even, as ``jnp.round``
does), so the codes and scales equal the reference's.  Optimizer state
drops from 8 bytes a parameter to about 2.

The reference returns new arrays (its train step donates the old ones).
Here ``adamw_update`` writes the new parameters and the float32 moments
into the tensors it is given and returns them, so a full-width model
holds one copy of each: every step does the reference's arithmetic, op
for op in float32, on one leaf at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import leaves, tree_map

BLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # float32 | int8


# ---------------------------------------------------------------------------
# block-wise int8 state codec
# ---------------------------------------------------------------------------

def quantize_state(x: torch.Tensor):
    """A float tensor → {"codes": int8 (blocks, 256), "scale": float32
    (blocks,)}, the flattened tensor zero-padded to whole blocks (one
    float32 copy of it, divided and rounded in place)."""
    n = x.numel()
    blocks = torch.zeros(n + (-n) % BLOCK, dtype=torch.float32,
                         device=x.device)
    blocks[:n] = x.reshape(-1)
    blocks = blocks.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    codes = blocks.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale[:, 0]}


def dequantize_state(q, shape) -> torch.Tensor:
    """The float32 tensor of ``shape`` that ``q`` encodes."""
    blocks = q["codes"].float().mul_(q["scale"][:, None])
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------

def adamw_init(params, cfg: AdamWConfig):
    """Step 0 and zero moments (float32, or int8 codes) for every leaf,
    on the leaves' devices."""
    def zeros_like_state(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return quantize_state(z) if cfg.state_dtype == "int8" else z
    device = leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(zeros_like_state, params),
            "v": tree_map(zeros_like_state, params)}


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw_update(grads, opt_state, params, lr, cfg: AdamWConfig):
    """One AdamW step: gradients clipped to a global norm of
    ``cfg.grad_clip``, bias-corrected moments, decoupled weight decay on
    leaves of two or more dimensions only.  Writes the new parameters
    (and float32 moments) into ``params`` (and ``opt_state``) in place.
    Returns (params, new opt_state, {"grad_norm"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    # a true division (torch computes a Python scalar over a tensor as
    # the scalar times a reciprocal)
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9),
                       max=1.0)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    q8 = cfg.state_dtype == "int8"

    @torch.no_grad()
    def upd(g, m, v, p):
        # the reference's expressions, each op rounded as there (no fused
        # multiply-add), on as few float32 temporaries as will do
        g = g.to(torch.float32, copy=True).mul_(clip)
        m_f = dequantize_state(m, g.shape) if q8 else m
        v_f = dequantize_state(v, g.shape) if q8 else v
        m_f.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v_f.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        den = (v_f / b2c).sqrt_().add_(cfg.eps)
        u = (m_f / b1c).div_(den)
        del den
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            u.add_(p.float() * cfg.weight_decay)
        p.copy_(p.float() - u.mul_(lr))
        del u
        if q8:
            return quantize_state(m_f), quantize_state(v_f)
        return m_f, v_f

    out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    new_state = {"step": step,
                 "m": tree_map(lambda _, o: o[0], grads, out),
                 "v": tree_map(lambda _, o: o[1], grads, out)}
    return params, new_state, {"grad_norm": gnorm}
