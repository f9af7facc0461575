"""Pixtral-12B — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Pixtral ViT frontend is a STUB: input_specs() provides precomputed patch
embeddings prepended to the token stream; the decoder is the Mistral-Nemo
backbone.  [hf:mistralai/Pixtral-12B-2409; unverified]"""

from repro_torch.configs.base import (ModelConfig, SubLayer, ATTN, DENSE,
                                      register)

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    layer_cycle=(SubLayer(mixer=ATTN, mlp=DENSE),),
    frontend="vision",
    frontend_len=256,              # stub patch count per image
    rope_theta=1e6,
    act="silu",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
))
