"""AdamW with optional block-wise 8-bit quantized moments.

Port of ``repro.optim.adamw``.  The 8-bit mode stores m and v as int8
with one float32 scale per 256-element block (the block's max magnitude
maps to 127; ``torch.round`` rounds half to even, as ``jnp.round``
does), so the codes and scales equal the reference's.  Optimizer state
drops from 8 bytes a parameter to about 2.

Under a mesh (DTensor leaves placed by ``parallel.sharding``) the
moments mirror their parameters' placements, and the int8 codec, which
flattens a leaf into 256-element blocks of its global row-major order,
gathers a sharded leaf whole first and places the codes and scales with
their blocks over the data axes (the reference's ``opt_spec``); decoding
gathers the blocks and takes the parameter's shards.  Both are explicit
``redistribute`` calls (``_codec_gather``, ``_codec_place``).

The reference returns new arrays (its train step donates the old ones).
Here ``adamw_update`` writes the new parameters and the float32 moments
into the tensors it is given and returns them, so a full-width model
holds one copy of each: every step does the reference's arithmetic, op
for op in float32, on one leaf at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.parallel.sharding import is_dtensor
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

def _codec_gather(x):
    """A DTensor leaf gathered whole on every device (the codec's
    blocks follow the global order); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(placements=[Replicate()] * x.device_mesh.ndim)


def _codec_place(t, like):
    """Codes or scales ``t`` (blocks first), computed replicated from a
    leaf placed like ``like``: the blocks over the data axes where they
    divide them, replicated elsewhere, as ``ShardingRules.opt_spec``
    places them."""
    if not is_dtensor(like):
        return t
    from repro_torch.parallel.sharding import P, axis_sizes, to_placements
    mesh = like.device_mesh
    dp = ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
    size = 1
    for a in dp:
        size *= axis_sizes(mesh).get(a, 1)
    lead = (dp if len(dp) > 1 else dp[0]) if t.shape[0] % size == 0 \
        else None
    return t.redistribute(placements=to_placements(
        P(lead, *(None,) * (t.ndim - 1)), mesh))


def quantize_state(x: torch.Tensor):
    """A float tensor → {"codes": int8 (blocks, 256), "scale": float32
    (blocks,)}, the flattened tensor zero-padded to whole blocks (one
    float32 copy of it, divided and rounded in place).  A DTensor is
    gathered whole first (``_codec_gather``) and its codes placed with
    their blocks over the data axes (``_codec_place``)."""
    if is_dtensor(x):
        full = quantize_state(_codec_gather(x).to_local())
        mesh = x.device_mesh
        return {k: _codec_place(_replicated(v, mesh), x)
                for k, v in full.items()}
    n = x.numel()
    blocks = torch.zeros(n + (-n) % BLOCK, dtype=torch.float32,
                         device=x.device)
    blocks[:n] = x.reshape(-1)
    blocks = blocks.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    codes = blocks.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale[:, 0]}


def _replicated(t: torch.Tensor, mesh):
    """A tensor every device holds whole, as a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def dequantize_state(q, shape, like=None) -> torch.Tensor:
    """The float32 tensor of ``shape`` that ``q`` encodes; with a
    DTensor ``like``, a DTensor placed like it (the blocks gathered
    whole first)."""
    if is_dtensor(q["codes"]):
        full = dequantize_state({k: _codec_gather(v).to_local()
                                 for k, v in q.items()}, shape)
        out = _replicated(full, q["codes"].device_mesh)
        return out if like is None else \
            out.redistribute(placements=like.placements)
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
        # a DTensor's moments mirror its placements
        z = torch.zeros_like(p, dtype=torch.float32)
        return quantize_state(z) if cfg.state_dtype == "int8" else z
    first = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if is_dtensor(first):
        step = _replicated(step, first.device_mesh)
    return {"step": step,
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
    b1c = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    q8 = cfg.state_dtype == "int8"

    @torch.no_grad()
    def upd(g, m, v, p):
        # the reference's expressions, each op rounded as there (no fused
        # multiply-add), on as few float32 temporaries as will do
        g = g.to(torch.float32, copy=True).mul_(clip)
        m_f = dequantize_state(m, g.shape, g) if q8 else m
        v_f = dequantize_state(v, g.shape, g) if q8 else v
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
