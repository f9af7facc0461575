"""Granite-20B (code) — dense, 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, llama-style architecture.  [arXiv:2405.04324; hf]"""

from repro_torch.configs.base import (ModelConfig, SubLayer, ATTN, DENSE,
                                      register)

CONFIG = register(ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    layer_cycle=(SubLayer(mixer=ATTN, mlp=DENSE),),
    act="gelu",
    mlp_gated=False,               # gpt-bigcode-style plain MLP
    source="arXiv:2405.04324; hf",
))
