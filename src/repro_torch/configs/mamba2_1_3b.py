"""Mamba-2-1.3B — attention-free SSM (SSD / state-space duality), 48L
d_model=2048, ssm_state=128, expand=2, vocab=50280.
[arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import (ModelConfig, SSMConfig, SubLayer, MAMBA,
                                      NONE, register)

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,                     # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                        # no separate MLP; gated SSM block only
    vocab_size=50280,
    layer_cycle=(SubLayer(mixer=MAMBA, mlp=NONE),),
    ssm=SSMConfig(state_dim=128, conv_kernel=4, expand=2, head_dim=64,
                  chunk_size=256),
    act="silu",
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
