"""Qwen3-MoE-30B-A3B — 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=768.  [hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import (ModelConfig, MoEConfig, SubLayer, ATTN,
                                      MOE, register)

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                      # expert FFN width (MoE on every layer)
    vocab_size=151936,
    layer_cycle=(SubLayer(mixer=ATTN, mlp=MOE),),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    rope_theta=1e6,
    act="silu",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
