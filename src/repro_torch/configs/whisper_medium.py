"""Whisper-medium — enc-dec, 24 encoder + 24 decoder layers, d_model=1024,
16H (MHA: kv=16), d_ff=4096, vocab=51865.  Conv frame frontend is a STUB:
input_specs() provides precomputed frame embeddings (1500 frames) as encoder
input.  [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import (ModelConfig, SubLayer, ATTN, DENSE,
                                      register)

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,                   # decoder layers
    n_enc_layers=24,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    layer_cycle=(SubLayer(mixer=ATTN, mlp=DENSE),),
    frontend="audio",
    frontend_len=1500,             # stub mel-frame embeddings
    act="gelu",
    mlp_gated=False,               # plain 2-matrix GELU MLP
    source="arXiv:2212.04356; unverified",
))
