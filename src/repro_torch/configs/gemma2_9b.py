"""Gemma-2-9B — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
alternating local(sliding-window 4096)/global attention, attn+final logit
softcaps, GeGLU.  [arXiv:2408.00118; hf]"""

from repro_torch.configs.base import (ModelConfig, SubLayer, ATTN, LOCAL_ATTN,
                                      DENSE, register)

CONFIG = register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    layer_cycle=(SubLayer(mixer=LOCAL_ATTN, mlp=DENSE),
                 SubLayer(mixer=ATTN, mlp=DENSE)),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    source="arXiv:2408.00118; hf",
))
