"""The quantized MoE expert kind: float weights and token blocks drawn from
the seed, the frozen plan served, dispatches held to
``reference/moe.py``.

A request is one (S, D) float32 block of token activations; its answer is
the block after every residual MoE layer.  Capacity depends on the whole
dispatch (its bucket and the tokens ahead in it), so the check recomputes
whole dispatches: the blocks the gateway served together, padded with
zero blocks to the bucket.  Per token it takes the distance between the
served answer and the reference's, over the median token's norm of what
the layers add to their input, and compares the median of those errors
(the precision the products ran at) and the share of tokens above
``BAD_TOKEN`` (answers that went wrong).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import moe as ref
from portbench.yardstick import work

UNIT = "tokens"
#: the server that serves this kind (``servers/gateway.py``)
SERVER = "gateway"
#: a token whose error reaches this share of the median token's layer
#: output is counted as wrong
BAD_TOKEN = 1e-2


class System:
    """One configuration drawn from one seed."""

    def __init__(self, config: Dict, seed: int, device: torch.device,
                 config_dir: Path):
        self.config, self.seed, self.device = config, seed, device
        self.specs = [dict(num_experts=config["num_experts"],
                           num_experts_per_tok=config["num_experts_per_tok"],
                           capacity_factor=config["capacity_factor"], **bits)
                      for bits in config["layer_bits"]]
        with open(Path(config_dir) / config["plan"]) as f:
            self._check_plan(json.load(f))
        self.d, self.f = config["hidden_size"], config["moe_intermediate_size"]
        s = config["tokens_per_request"]
        rng = np.random.default_rng([seed, 1])
        self.pool = rng.standard_normal((config["pool"], s, self.d),
                                        dtype=np.float32)
        self.request_bytes = int(self.pool[0].nbytes)
        self.units_per_request = s
        self.ops_per_request = s * work.moe_flops_per_token(config)

    def _check_plan(self, plan: Dict) -> None:
        c = self.config
        spec = plan["workload"]["spec"]
        served = {"hidden_size": spec["d_model"],
                  "tokens_per_request": spec["seq_len"],
                  "hidden_act": spec["act"], "gated": spec["mlp_gated"],
                  "layer_bits": [{"data_bits": a["data_bits"],
                                  "coeff_bits": a["coeff_bits"]}
                                 for a in plan["layers"]]}
        for l in spec["layers"]:
            served.update(num_experts=l["num_experts"],
                          num_experts_per_tok=l["top_k"],
                          moe_intermediate_size=l["d_ff_expert"],
                          capacity_factor=l["capacity_factor"],
                          shared_experts=l["n_shared_experts"])
        served["num_hidden_layers"] = len(spec["layers"])
        stated = {k: c[k] for k in served}
        if served != stated:
            raise ValueError(f"{c['plan']} serves {served}, the "
                             f"configuration states {stated}")

    def float_layers(self):
        """Each layer's float32 weights in turn, drawn on the device from
        the seed: router (D, E) and w_up, w_gate (E, D, F) normal /
        sqrt(D), w_down (E, F, D) normal / sqrt(2 L F) for L layers (the
        scaled init of residual output projections).  The workload has
        no norm between its layers and a gated FFN grows with the square
        of its input, so without that scale the residual stream of a
        deep stack overflows float32."""
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        e, d, f = self.config["num_experts"], self.d, self.f
        shapes = {"router": ((d, e), d), "w_up": ((e, d, f), d),
                  "w_gate": ((e, d, f), d),
                  "w_down": ((e, f, d), 2 * len(self.specs) * f)}
        for _ in self.specs:
            yield {k: torch.randn(shape, generator=g, device=self.device)
                   .div_(math.sqrt(var)) for k, (shape, var) in shapes.items()}

    def quantized_layers(self, quantize) -> List[Dict[str, torch.Tensor]]:
        """Every layer's weights through ``quantize(p, coeff_bits)``, each
        float layer freed before the next is drawn: the stack fills most
        of the card, so no two float layers are alive at once."""
        out = []
        for p, s in zip(self.float_layers(), self.specs):
            out.append(quantize(p, s["coeff_bits"]))
            del p
        return out

    def params(self) -> List[Dict[str, torch.Tensor]]:
        """What the program is handed: each layer's weights through the
        program's own quantizer, onto the plan's coefficient grid."""
        from repro_torch.models.moe import quantize_moe_params
        return self.quantized_layers(quantize_moe_params)

    def bucket(self, n: int) -> int:
        return min(b for b in self.config["buckets"] if b >= n)

    def check(self, answers: Dict[int, np.ndarray], payload: Sequence[int],
              dispatches: List[List[int]], rng: np.random.Generator,
              compare: int, control: bool = False) -> Dict[str, float]:
        """Recompute up to ``compare`` whole dispatches whose answers were
        all kept (drawn by ``rng``, the largest always among them) and
        compare every block of them; ``control`` puts the TF32 reference
        in the program's place."""
        whole = [d for d in dispatches if all(i in answers for i in d)]
        if not whole:
            return {"compared": 0}
        largest = max(range(len(whole)), key=lambda j: len(whole[j]))
        rest = [j for j in range(len(whole)) if j != largest]
        pick = [largest] + [rest[int(j)] for j in rng.choice(
            len(rest), min(compare - 1, len(rest)), replace=False)]
        layers = self.quantized_layers(ref.quantize_weights)
        errs = []
        for j in pick:
            d = whole[j]
            x = torch.from_numpy(self.pool[[payload[i] for i in d]]) \
                .to(self.device)
            want = ref.forward(x, layers, self.specs, self.bucket(len(d)))
            if control:
                got = ref.forward(x, layers, self.specs,
                                  self.bucket(len(d)), tf32=True)
            else:
                got = torch.from_numpy(np.stack([answers[i] for i in d])) \
                    .to(self.device)
            errs.append(ref.contribution_errors(got, want, x))
        err = torch.cat(errs)
        return {"compared": int(err.numel()),
                "token_err_median": float(err.median()),
                "bad_token_share": float((err >= BAD_TOKEN).float().mean())}

