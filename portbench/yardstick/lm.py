"""FLOPs a decoded token of a language model needs, from its published
configuration alone.

A decoded token at context ``c`` (the positions it attends to), a
multiply and an add counted as two operations, in each layer: the
attention projections, 2·D·(H + 2·KH)·Dh + 2·H·Dh·D; QK-norm, four
operations an element of its H + KH heads (square, sum, scale, weight);
attention over the context, 2·H·Dh·c for the scores and as many for the
values; the router, 2·D·E; and its top-k experts' gated FFNs, k·3·2·D·F.
Over the stack, the LM head, 2·D·V.  Embedding lookups, the other norms,
RoPE, softmaxes, the residual adds and the empty slots of a decode batch
are left out: the count is the work a token needs, not what a step
spends.
"""

from __future__ import annotations

from typing import Dict


def decode_flops_per_layer(config: Dict, context: float) -> float:
    """FLOPs of one decoded token in one layer of ``config`` (keys as in
    the published ``config.json``) at ``context`` positions."""
    d = config["hidden_size"]
    h, kh = config["num_attention_heads"], config["num_key_value_heads"]
    dh = config["head_dim"]
    proj = 2 * d * (h + 2 * kh) * dh + 2 * h * dh * d
    qk_norm = 4 * (h + kh) * dh if config.get("qk_norm") else 0
    attend = 2 * 2 * h * dh * context
    router = 2 * d * config["num_experts"]
    experts = config["num_experts_per_tok"] * 3 * 2 * d \
        * config["moe_intermediate_size"]
    return proj + qk_norm + attend + router + experts


def decode_flops_per_token(config: Dict, context: float) -> float:
    """FLOPs of one decoded token through every layer and the LM head."""
    return config["num_hidden_layers"] \
        * decode_flops_per_layer(config, context) \
        + 2 * config["hidden_size"] * config["vocab_size"]
