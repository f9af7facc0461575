"""Jamba-1.5-Large-398B — hybrid, 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, Mamba:attention 7:1 interleave, MoE 16 experts top-2
on every other layer.  [arXiv:2403.19887; hf]

Cycle of 8: [mamba ×3, attn, mamba ×4]; MLPs alternate dense/MoE within the
cycle (4 MoE layers per cycle) — matching the paper's 1:7 attention ratio and
every-other-layer MoE.
"""

from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                      SubLayer, ATTN, MAMBA, MOE, DENSE,
                                      register)

_CYCLE = (
    SubLayer(mixer=MAMBA, mlp=DENSE),
    SubLayer(mixer=MAMBA, mlp=MOE),
    SubLayer(mixer=MAMBA, mlp=DENSE),
    SubLayer(mixer=ATTN, mlp=MOE),
    SubLayer(mixer=MAMBA, mlp=DENSE),
    SubLayer(mixer=MAMBA, mlp=MOE),
    SubLayer(mixer=MAMBA, mlp=DENSE),
    SubLayer(mixer=MAMBA, mlp=MOE),
)

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layer_cycle=_CYCLE,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMConfig(state_dim=128, conv_kernel=4, expand=2, head_dim=128,
                  chunk_size=256),
    act="silu",
    source="arXiv:2403.19887; hf",
))
