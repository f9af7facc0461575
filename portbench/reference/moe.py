"""Plain reference of the quantized MoE expert stack the benchmark serves.

One dispatch is a batch of token blocks padded with zero blocks to its
bucket.  Each layer, for the batch's T tokens:

1. fake-quantizes every token to ``data_bits`` with its own scale
   (its max magnitude, floored at 1e-6, maps to 2^(bits-1) - 1 levels;
   rounding half to even); expert weights are fake-quantized the same way
   with one scale per tensor (floor 1e-9) and the router stays exact;
2. routes: softmax of the token's router logits, the top-k experts (the
   lower index first among equal probabilities), their probabilities
   renormalized to sum 1;
3. bounds each expert at ``capacity = int(max(k, round(cf·T·k/E)))``
   assignments, kept in (token, rank-of-choice) order and the rest
   dropped;
4. runs each expert's SiLU-gated FFN, silu(x·Wg) * (x·Wu) · Wd, over its
   kept tokens, and adds each token's kept outputs weighted by their
   probabilities to the token's unquantized input (the residual).

Plain torch in float32 with TF32 off; imports nothing of the port.
``tf32=True`` rounds every matmul operand to TF32 (10 explicit mantissa
bits, to nearest even) and keeps float32 accumulation, as the tensor
cores do: the lower-precision control.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), still stored as float32."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def fake_quant(x: torch.Tensor, bits: int, floor: float,
               per_row: bool) -> torch.Tensor:
    """Symmetric fake quantization onto 2^(bits-1) - 1 levels each side,
    one scale per row (``per_row``) or per tensor."""
    hi = torch.tensor(float((1 << (bits - 1)) - 1), dtype=x.dtype,
                      device=x.device)
    m = x.abs().amax(dim=-1, keepdim=True) if per_row else x.abs().amax()
    s = hi / m.clamp_min(floor)
    return torch.round(x * s) / s


def quantize_weights(p: Dict[str, torch.Tensor], coeff_bits: int
                     ) -> Dict[str, torch.Tensor]:
    """The layer's expert weights on the ``coeff_bits`` grid, the router
    exact."""
    return {k: v if k == "router" else fake_quant(v, coeff_bits, 1e-9,
                                                   per_row=False)
            for k, v in p.items()}


def layer(x: torch.Tensor, p: Dict[str, torch.Tensor], spec: Dict, *,
          tf32: bool = False) -> torch.Tensor:
    """One residual MoE layer over tokens x (T, D), with quantized
    weights ``p`` (router (D, E), w_up/w_gate (E, D, F), w_down
    (E, F, D))."""
    t = x.shape[0]
    e, k = spec["num_experts"], spec["num_experts_per_tok"]
    xq = fake_quant(x, spec["data_bits"], 1e-6, per_row=True)
    probs = torch.softmax(_mm(xq, p["router"], tf32), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    vals = vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    cap = int(max(k, round(spec["capacity_factor"] * t * k / e)))
    flat = ids.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(flat, e)
    rank = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat[:, None])[:, 0]
    keep = rank < cap
    contrib = torch.zeros((t * k, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    for ex in range(e):
        pos = torch.nonzero((flat == ex) & keep)[:, 0]
        if pos.numel() == 0:
            continue
        xe = xq[pos // k]
        h = F.silu(_mm(xe, p["w_gate"][ex], tf32)) \
            * _mm(xe, p["w_up"][ex], tf32)
        contrib[pos] = _mm(h, p["w_down"][ex], tf32) \
            * vals.reshape(-1)[pos, None]
    return x + contrib.reshape(t, k, -1).sum(dim=1)


def forward(blocks: torch.Tensor, layers: Sequence[Dict[str, torch.Tensor]],
            specs: Sequence[Dict], bucket: int, *,
            tf32: bool = False) -> torch.Tensor:
    """A dispatch: ``blocks`` (n, S, D) float32 padded with zero blocks to
    ``bucket``, through every layer (quantized weights ``layers``);
    returns the n served blocks."""
    n, s, d = blocks.shape
    x = torch.cat([blocks, blocks.new_zeros((bucket - n, s, d))]) \
        .reshape(bucket * s, d)
    for p, spec in zip(layers, specs):
        x = layer(x, p, spec, tf32=tf32)
    return x.reshape(bucket, s, d)[:n]


def contribution_errors(answer: torch.Tensor, ref: torch.Tensor,
                        inputs: torch.Tensor) -> torch.Tensor:
    """Per token, the distance between a served answer and the
    reference's, over the median token's norm of what the layers add to
    their input (``ref - inputs``): (…, S, D) → (… * S,)."""
    d = answer.shape[-1]
    gap = (answer - ref).reshape(-1, d).norm(dim=-1)
    added = (ref - inputs).reshape(-1, d).norm(dim=-1)
    return gap / added.median().clamp_min(1e-30)

