"""A language-model kind added as a file alone (test only): a tiny MoE
LM of the port's zoo (attention and a routed MoE MLP in every layer),
served by ``servers/engine.py``.

The configuration gives the model's sizes and ``prompt_lengths``: the
pool's prompts take them in turn, drawn from the seed.  The capacity
factor is the experts over top-k, so no token is ever dropped and a row
decoded in the engine's pool reads as it does alone.  The check is the
port's own prefill over each kept request's prompt and served tokens,
at positions drawn by ``rng`` (the first and the last among them): the
widest gap between the kept logits row and that prefill's, over the
largest logit of the prefill's.
"""

import numpy as np
import torch

UNIT = "tokens"
SERVER = "engine"


class System:
    def __init__(self, config, seed, device, config_dir):
        self.config, self.seed, self.device = config, seed, device
        rng = np.random.default_rng([seed, 1])
        lengths = config["prompt_lengths"]
        self.pool = [rng.integers(1, config["vocab_size"],
                                  lengths[k % len(lengths)]).tolist()
                     for k in range(config["pool"])]
        d, f = config["d_model"], config["d_ff_expert"]
        self.ops_per_unit = config["n_layers"] * (
            2 * d * config["num_experts"] + config["top_k"] * 3 * 2 * d * f)

    def model_and_params(self):
        from repro_torch.configs.base import ModelConfig, MoEConfig, SubLayer
        from repro_torch.models.registry import build_model
        c = self.config
        cfg = ModelConfig(
            name=c["name"], family="moe", n_layers=c["n_layers"],
            d_model=c["d_model"], n_heads=c["n_heads"],
            n_kv_heads=c["n_kv_heads"], head_dim=c["head_dim"],
            d_ff=c["d_ff_expert"], vocab_size=c["vocab_size"],
            layer_cycle=(SubLayer(mixer="attn", mlp="moe"),),
            moe=MoEConfig(num_experts=c["num_experts"], top_k=c["top_k"],
                          d_ff_expert=c["d_ff_expert"],
                          capacity_factor=c["num_experts"] / c["top_k"]),
            dtype=c["dtype"])
        model = build_model(cfg, self.device)
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        return model, model.init(g)

    def check(self, answers, rng, check, control=False):
        model, params = self.model_and_params()
        gaps = []
        for i in sorted(answers):
            a = answers[i]
            n = len(a.tokens)
            pick = {0, n - 1} | set(rng.choice(
                n, min(check["compare"], n), replace=False).tolist())
            for k in sorted(pick):
                seq = list(self.pool[a.prompt]) + a.tokens[:k]
                want = model.prefill(params, {"tokens": torch.tensor(
                    [seq], device=self.device)})[0][0].float()
                got = a.logits[k].to(want.device).float()
                gaps.append(float((got - want).abs().max()
                                  / want.abs().max()))
        return {"compared": len(gaps),
                "logit_gap": max(gaps) if gaps else float("inf")}
