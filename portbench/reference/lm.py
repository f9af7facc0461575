"""Plain reference of the published Qwen3-MoE forward (Qwen3-30B-A3B).

The forward, teacher-forced over whole sequences::

    embedding
    48 x  h = norm(x); x = x + attention(h)      QK-norm, RoPE, causal GQA
          h = norm(x); x = x + moe(h)            softmax router, top-8
                                                 renormalized, every routed
                                                 expert, no capacity
    final norm, then the LM head

in plain float32 torch with TF32 off, over weights in the port's layout
(``models.transformer.init_params``: leaves stacked over layers), each
layer's weights cast to float32 only while that layer runs, so a bf16
model of 61 GB is run in float32 on one card.  It imports nothing of the
port and no JAX.

Departures from the published code, each the same function:

* Norm weights are stored as the port stores them, as offsets from one:
  every RMS norm (the two per layer, QK-norm's per head, the final one)
  scales by ``1 + weight`` where the published model scales by
  ``weight``; the two are one function under that reparametrization.
* Weights are (in, out) matrices, ``x @ w``, where the published
  ``nn.Linear`` stores (out, in); q, k and v keep their heads as a
  separate axis.
* The norm multiplies by its weight in float32 before any cast (the
  published code casts the normalized value to the input dtype first);
  here every value is float32.
* Ties in the router's top-k go to the lower expert index.

``round_to`` (a dtype, e.g. ``torch.float8_e4m3fn``) rounds every matmul
input to that dtype and back before the float32 product: a reference in
a precision below the model's, the control a check must refuse.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F


def _round(t: torch.Tensor, round_to: Optional[torch.dtype]) -> torch.Tensor:
    return t if round_to is None else t.to(round_to).float()


def _mm(a: torch.Tensor, b: torch.Tensor, round_to) -> torch.Tensor:
    return _round(a, round_to) @ _round(b, round_to)


def rms_norm(x: torch.Tensor, offset: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMS norm over the last axis, scaled by ``1 + offset``."""
    var = x.pow(2).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + offset.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half pairing, of x (S, H, Dh) at
    positions 0..S-1."""
    s, dh = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    emb = torch.cat([ang, ang], dim=-1)[:, None, :]            # (S, 1, Dh)
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * torch.cos(emb) + rotated * torch.sin(emb)


def attention(h: torch.Tensor, p: Dict[str, torch.Tensor], spec: Dict,
              round_to=None) -> torch.Tensor:
    """Causal GQA self-attention of one sequence h (S, D) with QK-norm
    before RoPE; query head j reads kv head j // (H / KH)."""
    s, d = h.shape
    nh, kh, dh = spec["n_heads"], spec["n_kv_heads"], spec["head_dim"]
    q = _mm(h, p["wq"].reshape(d, nh * dh), round_to).reshape(s, nh, dh)
    k = _mm(h, p["wk"].reshape(d, kh * dh), round_to).reshape(s, kh, dh)
    v = _mm(h, p["wv"].reshape(d, kh * dh), round_to).reshape(s, kh, dh)
    q = rope(rms_norm(q, p["q_norm"], spec["norm_eps"]), spec["rope_theta"])
    k = rope(rms_norm(k, p["k_norm"], spec["norm_eps"]), spec["rope_theta"])
    k = k.repeat_interleave(nh // kh, dim=1)
    v = v.repeat_interleave(nh // kh, dim=1)
    scores = _mm(q.transpose(0, 1), k.permute(1, 2, 0), round_to) \
        / math.sqrt(dh)                                        # (H, S, S)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = _mm(probs, v.transpose(0, 1), round_to)              # (H, S, Dh)
    return _mm(out.transpose(0, 1).reshape(s, nh * dh),
               p["wo"].reshape(nh * dh, d), round_to)


def moe(h: torch.Tensor, p: Dict[str, torch.Tensor], spec: Dict,
        round_to=None) -> torch.Tensor:
    """The routed experts of h (T, D): softmax router, the top k
    renormalized to sum 1, every assignment computed (no capacity),
    each expert silu(x Wg) * (x Wu) Wd."""
    k = spec["top_k"]
    probs = torch.softmax(_mm(h, p["router"], round_to), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    vals = vals / vals.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for ex in torch.unique(ids).tolist():
        tok, slot = torch.nonzero(ids == ex, as_tuple=True)
        x = h[tok]
        y = _mm(F.silu(_mm(x, p["w_gate"][ex], round_to))
                * _mm(x, p["w_up"][ex], round_to), p["w_down"][ex], round_to)
        out.index_add_(0, tok, y * vals[tok, slot][:, None])
    return out


def _layer(stack: Dict, i: int, device) -> Dict[str, Dict]:
    """Layer ``i``'s weights, cast to float32 on ``device``."""
    sub = stack["s0"]
    f32 = lambda t: t[i].to(device=device, dtype=torch.float32)  # noqa: E731
    return {"ln1": f32(sub["ln1"]), "ln2": f32(sub["ln2"]),
            "attn": {n: f32(t) for n, t in sub["attn"].items()},
            "moe": {n: f32(t) for n, t in sub["moe"].items()}}


def forward(params: Dict, seqs: Sequence[Sequence[int]],
            rows: Sequence[Sequence[int]], spec: Dict, *,
            round_to: Optional[torch.dtype] = None,
            device=None) -> List[torch.Tensor]:
    """Teacher-forced logits of each sequence of token ids in ``seqs``
    at its positions ``rows`` (a list per sequence): a list of
    (len(rows[j]), V) float32 tensors.  ``params`` in the port's layout;
    ``spec``: ``n_layers``, ``n_heads``, ``n_kv_heads``, ``head_dim``,
    ``top_k``, ``rope_theta``, ``norm_eps``."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        device = params["embed"].device if device is None else device
        eps = spec["norm_eps"]
        xs = [params["embed"][torch.as_tensor(list(s), device=device)]
              .float() for s in seqs]
        for i in range(spec["n_layers"]):
            p = _layer(params["stack"], i, device)
            for j, x in enumerate(xs):
                x = x + attention(rms_norm(x, p["ln1"], eps), p["attn"],
                                  spec, round_to)
                xs[j] = x + moe(rms_norm(x, p["ln2"], eps), p["moe"], spec,
                                round_to)
            del p
        head = params["unembed"].float()
        final = params["final_norm"].float()
        out = []
        for x, r in zip(xs, rows):
            h = rms_norm(x[torch.as_tensor(list(r), device=device)], final,
                         eps)
            out.append(_mm(h, head, round_to))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
