"""The language-model kind: a published LM served whole by the port's
``serve.engine.Engine`` (``servers/engine.py``), its logits held to the
plain reference ``reference/lm.py``.

The configuration is the model's published ``config.json`` values plus
``arch``, the port's registered architecture that serves them; the
values are built into that architecture's ``ModelConfig`` (routing
dropless: capacity factor experts over top-k), and the architecture
must carry what the configuration states and the ``ModelConfig`` does
not (QK-norm, untied embeddings, every layer a gated SiLU MoE with
renormalized top-k).  Weights are drawn here from the seed on the
device, layer by layer, into the port's layout (``draw_weights``), and
the same weights go to the program and to the reference.  A request is one prompt of the pool: ``pool`` prompts of token
ids uniform over the vocabulary, lengths log-uniform over
``prompt_tokens`` [lo, hi], drawn from the seed.

The check runs after the program is released: the weights drawn again
from the seed, and every kept request's prompt and served tokens
through the reference, teacher-forced, in float32 one layer at a time.
Every logits row the program emitted for the request is compared with
the reference's row at that position: a token's error is the distance
between the two over the median reference row's norm; the check reads
the median of those errors (the precision the model ran at) and the
share of tokens whose error reaches the configuration's ``bad_token``
(tokens that went wrong: a share and not a maximum, since in bf16 a
router near-tie picks another expert now and then, as the published
model's bf16 inference does).  ``control`` puts the reference with every matmul
input rounded to float8 (e4m3), below the configuration's bf16, in the
program's place.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from portbench.reference import lm as ref
from portbench.yardstick import lm as work

UNIT = "tokens"
#: the server that serves this kind (``servers/engine.py``)
SERVER = "engine"
#: the precision below the configuration's bf16
CONTROL_DTYPE = torch.float8_e4m3fn
#: what the configuration states that the port's architecture must
#: carry, as (key, value the configuration must give, the architecture's
#: reading of it); the port's MoE renormalizes its top-k and has no
#: attention bias by construction
CARRIED = (
    ("qk_norm", True, lambda cfg: getattr(cfg, "qk_norm", False)),
    ("tie_word_embeddings", False, lambda cfg: cfg.tie_embeddings),
    ("hidden_act", "silu", lambda cfg: cfg.act),
    ("norm_topk_prob", True, lambda cfg: True),
    ("attention_bias", False, lambda cfg: False),
    ("decoder_sparse_step", 1, lambda cfg: 1 if all(
        s.mixer == "attn" and s.mlp == "moe" for s in cfg.layer_cycle)
     else 0),
)


def prompt_lengths(config: Dict, rng: np.random.Generator) -> np.ndarray:
    """``pool`` lengths log-uniform over ``prompt_tokens`` [lo, hi]."""
    lo, hi = config["prompt_tokens"]
    u = rng.uniform(np.log(lo), np.log(hi + 1), config["pool"])
    return np.clip(np.floor(np.exp(u)).astype(np.int64), lo, hi)


#: the spread of every norm weight, an offset from the identity scale
#: (the port's norms and the reference's scale by 1 + weight), so that a
#: norm applied to the wrong heads, in the wrong layer or not at all
#: moves the logits
NORM_OFFSET_STD = 0.3


def draw_weights(config: Dict, seed: int, device: torch.device) -> Dict:
    """Every weight drawn from ``seed`` on ``device`` in a fixed order:
    the embedding, then layer by layer (ln1, wq, wk, wv, q_norm, k_norm,
    wo, ln2, router, w_gate, w_up, w_down), then the final norm and the
    LM head.  The port's layout: leaves stacked over layers, matrices
    (in, out), q/k/v heads an axis of their own, norms and the router in
    float32, the rest in the configuration's dtype.  Matrices are normal
    over the square root of their fan-in (the residual projections' too:
    wo over 32 x 128, w_down over 768), the embedding normal x 0.02, the
    norms normal x ``NORM_OFFSET_STD``."""
    c = config
    n, d, v = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    h, kh, dh = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    e, f = c["num_experts"], c["moe_intermediate_size"]
    wt, f32 = getattr(torch, c["torch_dtype"]), torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    def fill(t, std):
        return t.normal_(0.0, std, generator=gen)

    layer = {"ln1": ((d,), f32, NORM_OFFSET_STD),
             "wq": ((d, h, dh), wt, d ** -0.5),
             "wk": ((d, kh, dh), wt, d ** -0.5),
             "wv": ((d, kh, dh), wt, d ** -0.5),
             "q_norm": ((dh,), f32, NORM_OFFSET_STD),
             "k_norm": ((dh,), f32, NORM_OFFSET_STD),
             "wo": ((h, dh, d), wt, (h * dh) ** -0.5),
             "ln2": ((d,), f32, NORM_OFFSET_STD),
             "router": ((d, e), f32, d ** -0.5),
             "w_gate": ((e, d, f), wt, d ** -0.5),
             "w_up": ((e, d, f), wt, d ** -0.5),
             "w_down": ((e, f, d), wt, f ** -0.5)}
    embed = fill(empty((v, d), wt), 0.02)
    stacked = {k: empty((n,) + shape, dt)
               for k, (shape, dt, _) in layer.items()}
    for i in range(n):
        for k, (_, _, std) in layer.items():
            fill(stacked[k][i], std)
    final_norm = fill(empty((d,), f32), NORM_OFFSET_STD)
    unembed = fill(empty((d, v), wt), d ** -0.5)
    attn = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
    mlp = ("router", "w_up", "w_down", "w_gate")
    return {"embed": embed, "final_norm": final_norm,
            "stack": {"s0": {"ln1": stacked["ln1"],
                             "attn": {k: stacked[k] for k in attn},
                             "ln2": stacked["ln2"],
                             "moe": {k: stacked[k] for k in mlp}}},
            "unembed": unembed}


def _layout(tree, prefix=""):
    """{leaf path: (shape, dtype)} of a tree of tensors."""
    out = {}
    for k, t in tree.items():
        if isinstance(t, dict):
            out.update(_layout(t, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(t.shape), t.dtype)
    return out


class System:
    """One configuration drawn from one seed."""

    def __init__(self, config: Dict, seed: int, device: torch.device,
                 config_dir: Path):
        self.config, self.seed, self.device = config, seed, device
        rng = np.random.default_rng([seed, 1])
        lengths = prompt_lengths(config, rng)
        self.pool = [rng.integers(0, config["vocab_size"], n).tolist()
                     for n in lengths]
        self.ops_per_unit = work.decode_flops_per_token(
            config, float(np.mean(lengths)))
        self.model_config()            # the architecture serves the config

    def model_config(self):
        """The port's ``ModelConfig`` of the configuration: its
        architecture with the configuration's sizes."""
        from repro_torch.configs import get_config
        c = self.config
        base = get_config(c["arch"])
        for key, value, read in CARRIED:
            if c[key] != value or read(base) != value:
                raise ValueError(f"{c['arch']}: {key} is {read(base)!r}, "
                                 f"the configuration states {c[key]!r}")
        e, k = c["num_experts"], c["num_experts_per_tok"]
        return base.with_overrides(
            n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
            d_ff=c["moe_intermediate_size"], vocab_size=c["vocab_size"],
            norm_eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
            dtype=c["torch_dtype"],
            moe=dataclasses.replace(
                base.moe, num_experts=e, top_k=k,
                d_ff_expert=c["moe_intermediate_size"],
                capacity_factor=e / k,
                router_aux_weight=c["router_aux_loss_coef"]))

    def model_and_params(self):
        """The port's model and the weights ``draw_weights`` draws on the
        device from the seed (nothing here keeps either); a layout that
        differs from the model's raises."""
        from repro_torch.models.registry import build_model
        model = build_model(self.model_config(), self.device)
        params = draw_weights(self.config, self.seed, self.device)
        layout = _layout(model.init_abstract())
        if _layout(params) != layout:
            raise ValueError(f"the drawn weights {_layout(params)} are not "
                             f"the port's layout {layout}")
        return model, params

    def spec(self) -> Dict:
        cfg = self.model_config()
        return {"n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                "top_k": cfg.moe.top_k, "rope_theta": cfg.rope_theta,
                "norm_eps": cfg.norm_eps}

    def check(self, answers: Dict, rng: np.random.Generator, check: Dict,
              control: bool = False) -> Dict[str, float]:
        """Every kept answer's rows against the reference's (``rng`` is
        not drawn from: every kept request is compared whole)."""
        if not answers:
            return {"compared": 0}
        _, params = self.model_and_params()
        seqs, rows, got = [], [], []
        for i in sorted(answers):
            a = answers[i]
            prompt = list(self.pool[a.prompt])
            seqs.append(prompt + list(a.tokens[:-1]))
            rows.append(range(len(prompt) - 1,
                              len(prompt) - 1 + len(a.tokens)))
            got.append(a.logits)
        spec = self.spec()
        want = ref.forward(params, seqs, rows, spec)
        if control:
            got = ref.forward(params, seqs, rows, spec,
                              round_to=CONTROL_DTYPE)
        del params
        norms = torch.cat([w.norm(dim=-1) for w in want])
        scale = norms.median().clamp_min(1e-30)
        err = torch.cat([(g.to(w.device).float() - w).norm(dim=-1)
                         for g, w in zip(got, want)]) / scale
        q90, q99 = torch.quantile(err, torch.tensor(
            [0.9, 0.99], dtype=err.dtype, device=err.device)).tolist()
        return {"compared": int(err.numel()), "requests": len(want),
                "token_err_median": float(err.median()),
                "bad_token_share": float(
                    (err >= self.config["bad_token"]).float().mean()),
                "token_err_p90": q90, "token_err_p99": q99,
                "token_err_max": float(err.max())}
