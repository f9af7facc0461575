"""The fixed-point CNN kind: weights and images drawn from the seed, the
frozen plan served, answers held to ``reference/cnn.py``.

A request is one (H, W, C0) image of ``data_bits``-bit activations in an
int8 container; its answer is the last layer's (H, W, C_last)
activations.  The comparison is exact: the number of answer values that
differ from the reference's, limit 0.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import cnn as ref
from portbench.yardstick import work

UNIT = "images"
#: the control computes every operand with its top 4 bits: int4 for the
#: int8 containers the configuration states
CONTROL_BITS = 4


def plan_network(plan: Dict) -> Dict:
    """The network a plan artifact embeds, in the configuration's terms
    (read from the JSON, not through the program)."""
    spec = plan["workload"]["spec"]
    return {"img_h": spec["img_h"], "img_w": spec["img_w"],
            "layers": [{"in_channels": l["in_channels"],
                        "out_channels": l["out_channels"],
                        "data_bits": a["data_bits"],
                        "coeff_bits": a["coeff_bits"], "shift": l["shift"]}
                       for l, a in zip(spec["layers"], plan["layers"])]}


class System:
    """One configuration drawn from one seed."""

    def __init__(self, config: Dict, seed: int, device: torch.device,
                 config_dir: Path):
        self.config, self.seed, self.device = config, seed, device
        self.net = config["network"]
        self.plan_path = Path(config_dir) / config["plan"]
        with open(self.plan_path) as f:
            planned = plan_network(json.load(f))
        if planned != self.net:
            raise ValueError(f"{self.plan_path.name} serves {planned}, the "
                             f"configuration states {self.net}")
        first = self.net["layers"][0]
        rng = np.random.default_rng([seed, 1])
        self.pool = rng.integers(
            0, 1 << (first["data_bits"] - 1),
            (config["pool"], self.net["img_h"], self.net["img_w"],
             first["in_channels"]), dtype=np.int8)
        self.request_bytes = int(self.pool[0].nbytes)
        self.units_per_request = 1
        self.ops_per_request = work.cnn_ops_per_image(self.net)

    def weights(self) -> List[torch.Tensor]:
        """Integer weights drawn on the device from the seed, uniform over
        each layer's c-bit range (one draw per layer, in layer order)."""
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        return [torch.randint(-(1 << (l["coeff_bits"] - 1)),
                              1 << (l["coeff_bits"] - 1),
                              (l["out_channels"], l["in_channels"], 3, 3),
                              generator=g, device=self.device,
                              dtype=torch.int8)
                for l in self.net["layers"]]

    def params(self):
        """What the program is handed: the integer weights."""
        return self.weights()

    def check(self, answers: Dict[int, np.ndarray], payload: Sequence[int],
              dispatches: List[List[int]], rng: np.random.Generator,
              compare: int, control: bool = False) -> Dict[str, float]:
        """Compare up to ``compare`` kept answers, drawn by ``rng``, with
        the reference on the same images; ``control`` puts the int4
        reference in the program's place."""
        kept = sorted(answers)
        if not kept:
            return {"compared": 0}
        pick = np.sort(rng.choice(len(kept), min(compare, len(kept)),
                                  replace=False))
        idx = [kept[int(p)] for p in pick]
        x = torch.from_numpy(self.pool[[payload[i] for i in idx]]) \
            .to(self.device)
        w = self.weights()
        want = ref.forward(x, w, self.net)
        if control:
            got = ref.forward(x, w, self.net, operand_bits=CONTROL_BITS)
        else:
            got = torch.from_numpy(np.stack([answers[i] for i in idx])) \
                .to(self.device).to(torch.int64)
        return {"compared": len(idx),
                "mismatches": int((got != want).sum())}
