"""Qwen3-30B-A3B as published — 48L d_model=2048 32H (GQA kv=4,
head_dim 128) vocab=151936, untied, RMSNorm eps 1e-6; QK-norm over
head_dim on every query and key head before RoPE (theta 1e6); every
layer a MoE of 128 SiLU-gated experts of width 768, top-8 renormalized,
no shared expert, no token dropped.  [hf:Qwen/Qwen3-30B-A3B config.json]

A port-only architecture: the reference's zoo entry of the same model
(``qwen3-moe-30b-a3b``) has no QK-norm and drops tokens at capacity
factor 1.25, and ``list_archs`` keeps mirroring the reference's zoo.
Dropless routing is configuration alone: at capacity factor E / k = 16
``models.moe._capacity`` gives every expert ``max(k, n)`` rows for n
tokens, and a token picks k distinct experts, so no expert is assigned
more than n rows.
"""

from dataclasses import dataclass

from repro_torch.configs.base import (ModelConfig, MoEConfig, SubLayer, ATTN,
                                      MOE, register)


@dataclass(frozen=True)
class QKNormConfig(ModelConfig):
    """A ``ModelConfig`` whose attention RMS-normalizes every query and
    key head over ``head_dim`` (learned (head_dim,) weights ``q_norm``
    and ``k_norm`` per layer) between the projections and RoPE."""
    qk_norm: bool = True

    def param_count(self) -> int:
        attn = sum(sub.mixer == ATTN for sub in self.layer_cycle)
        return super().param_count() \
            + 2 * self.head_dim * attn * self.n_cycles


NUM_EXPERTS, TOP_K = 128, 8

CONFIG = register(QKNormConfig(
    name="qwen3-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                      # expert FFN width (MoE on every layer)
    vocab_size=151936,
    layer_cycle=(SubLayer(mixer=ATTN, mlp=MOE),),
    moe=MoEConfig(num_experts=NUM_EXPERTS, top_k=TOP_K, d_ff_expert=768,
                  capacity_factor=NUM_EXPERTS / TOP_K,   # dropless
                  router_aux_weight=0.001),              # router_aux_loss_coef
    rope_theta=1e6,
    act="silu",
    norm_eps=1e-6,
    tie_embeddings=False,
    dtype="bfloat16",
    source="hf:Qwen/Qwen3-30B-A3B config.json",
), port_only=True)
