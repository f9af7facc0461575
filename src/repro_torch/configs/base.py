"""Config system: model/shape dataclasses and the arch registry.

Port of ``repro.configs.base``: the same dataclasses, registry and
reduced ("smoke") configs, with ``torch_dtype`` in place of
``jnp_dtype``.  Every assigned architecture is a ``ModelConfig`` built
from a *layer cycle*: a short repeating pattern of sublayers (attention /
local-attention / mamba, each optionally followed by a dense or MoE
MLP).  The decoder stack holds ``n_layers // len(cycle)`` stacked cycles
(parameters and caches lead with that dimension), which the port walks
in a Python loop.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Sublayer / cycle specification
# ---------------------------------------------------------------------------

# mixer kinds
ATTN = "attn"            # full (causal for decoder) attention
LOCAL_ATTN = "local"     # sliding-window attention
MAMBA = "mamba"          # Mamba-2 SSD block (includes its own gating/conv)

# mlp kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"            # mamba blocks carry no separate MLP unless configured


@dataclass(frozen=True)
class SubLayer:
    """One (mixer, mlp) residual pair inside a layer cycle."""

    mixer: str = ATTN
    mlp: str = DENSE


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    conv_kernel: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_cycle: Tuple[SubLayer, ...] = (SubLayer(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None   # None | "audio" | "vision"
    frontend_len: int = 0            # stub frames / patches
    # attention details
    sliding_window: int = 4096
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    act: str = "silu"                # silu | gelu
    mlp_gated: bool = True           # gated (3-matrix) vs plain (2-matrix) MLP
    scale_embeddings: bool = False   # multiply embeddings by sqrt(d_model)
    # perf knobs (§Perf): resharding hints applied inside the model
    attn_batch_shard: bool = False   # shard attention over (data, model)
                                     # batch when heads don't divide TP
    attn_logits_bf16: bool = False   # keep attention logits in bf16
    moe_shard_hints: bool = False    # constrain expert buffers to
                                     # (E→model, capacity→data) sharding
    moe_groups: int = 1              # >1: route per token-group (aligned
                                     # to the data axis) — local dispatch,
                                     # no global sort/scatter collectives
    moe_combine_shardmap: bool = False  # explicit shard_map combine: one
                                        # psum(NL·D) instead of the k×
                                        # larger gather all-reduce
    remat_policy: str = "full"       # full | save_mixer_out — the latter
                                     # keeps sublayer outputs so backward
                                     # never re-runs forward collectives
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # notes carried into DESIGN/EXPERIMENTS
    source: str = ""

    # ---- derived -----------------------------------------------------
    @property
    def n_cycles(self) -> int:
        assert self.n_layers % len(self.layer_cycle) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"cycle length {len(self.layer_cycle)}")
        return self.n_layers // len(self.layer_cycle)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.name}: unknown dtype {self.dtype!r}")
        return dt

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (analytic; used by model_dse + roofline MODEL_FLOPS).
    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        def attn_params():
            return d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        n_mats = 3 if self.mlp_gated else 2
        def dense_mlp():
            return n_mats * d * ff
        def moe_mlp():
            m = self.moe
            per = n_mats * d * m.d_ff_expert
            return m.num_experts * per + m.n_shared_experts * per + d * m.num_experts
        def mamba_params():
            s = self.ssm
            inner = s.expand * d
            nh = inner // s.head_dim
            in_proj = d * (2 * inner + 2 * s.n_groups * s.state_dim + nh)
            conv = (inner + 2 * s.n_groups * s.state_dim) * s.conv_kernel
            out = inner * d
            return in_proj + conv + out + 2 * nh + inner
        per_cycle = 0
        for sub in self.layer_cycle:
            if sub.mixer in (ATTN, LOCAL_ATTN):
                per_cycle += attn_params()
            elif sub.mixer == MAMBA:
                per_cycle += mamba_params()
            if sub.mlp == DENSE:
                per_cycle += dense_mlp()
            elif sub.mlp == MOE:
                per_cycle += moe_mlp()
            per_cycle += 2 * d  # norms
        total += per_cycle * self.n_cycles
        if self.enc_dec:
            # encoder layers: attn + dense mlp; decoder adds cross-attn
            total += self.n_enc_layers * (attn_params() + dense_mlp() + 2 * d)
            total += self.n_layers * attn_params()  # cross attention
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per = 3 * self.d_model * m.d_ff_expert
        inactive = (m.num_experts - m.top_k) * per
        n_moe_layers = sum(1 for s in self.layer_cycle if s.mlp == MOE) * self.n_cycles
        return int(self.param_count() - n_moe_layers * inactive)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k requires sub-quadratic context handling: run only for SSM/hybrid.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, (f"{cfg.name} is a full-attention arch; long_500k needs "
                       "sub-quadratic attention (see DESIGN.md §4)")
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}
#: architectures the port serves beyond the reference's zoo: found by
#: ``get_config`` and ``smoke_config``, left out of ``list_archs``, which
#: mirrors the reference's registry
_PORT_ONLY: set = set()


def register(cfg: ModelConfig, *, port_only: bool = False) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    if port_only:
        _PORT_ONLY.add(cfg.name)
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    """The reference's architectures (the port-only ones left out)."""
    _ensure_loaded()
    return sorted(set(_REGISTRY) - _PORT_ONLY)


_LOADED = False

_ARCH_MODULES = [
    "qwen3_moe_30b_a3b", "llama4_maverick_400b_a17b", "pixtral_12b",
    "whisper_medium", "granite_20b", "gemma2_9b", "llama3_2_3b",
    "gemma2_2b", "jamba_1_5_large_398b", "mamba2_1_3b", "paper_conv",
    "qwen3_30b_a3b",
]


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


# ---------------------------------------------------------------------------
# Reduced ("smoke") configs: same family, tiny dims — for CPU tests.
# ---------------------------------------------------------------------------

def smoke_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    cyc = len(cfg.layer_cycle)
    kw = dict(
        n_layers=2 * cyc,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=503,
        sliding_window=16,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk_size=8)
    if cfg.enc_dec:
        kw["n_enc_layers"] = 2
    if cfg.frontend is not None:
        kw["frontend_len"] = 8
    return cfg.with_overrides(**kw)
