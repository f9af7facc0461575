"""Gemma-2-2B — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
alternating local/global attention, logit softcaps.  [arXiv:2408.00118; hf]"""

from repro_torch.configs.base import (ModelConfig, SubLayer, ATTN, LOCAL_ATTN,
                                      DENSE, register)

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
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
