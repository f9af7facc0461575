"""Llama-4-Maverick-400B-A17B — 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
vocab=202048, MoE 128 experts top-1 + 1 shared expert, MoE interleaved every
other layer (dense MLP on the rest), early-fusion multimodal (text backbone
here).  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

With d_ff_expert=8192 and MoE on alternate layers the total lands at ~400B
params with ~17B active — matching the a17b designation.
"""

from repro_torch.configs.base import (ModelConfig, MoEConfig, SubLayer, ATTN,
                                      MOE, DENSE, register)

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    # interleaved: dense MLP layer, then MoE layer (cycle of 2)
    layer_cycle=(SubLayer(mixer=ATTN, mlp=DENSE),
                 SubLayer(mixer=ATTN, mlp=MOE)),
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  n_shared_experts=1),
    rope_theta=5e5,
    act="silu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
