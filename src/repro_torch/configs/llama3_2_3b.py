"""Llama-3.2-3B — dense, 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256.  [hf:meta-llama/Llama-3.2-1B; unverified]"""

from repro_torch.configs.base import (ModelConfig, SubLayer, ATTN, DENSE,
                                      register)

CONFIG = register(ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    layer_cycle=(SubLayer(mixer=ATTN, mlp=DENSE),),
    rope_theta=5e5,
    act="silu",
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
))
