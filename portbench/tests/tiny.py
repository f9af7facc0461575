"""A copy of the benchmark's files at test sizes, in a temporary root:
the quickstart network on 16 x 32 images and the MoE stack with 8 experts
at d_model 64, with the frozen plans rewritten to match and, unless asked
to keep them, the cells' clients and samples cut to what the CPU
serves."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import catalog

TINY_MOE = {"hidden_size": 64, "moe_intermediate_size": 32, "num_experts": 8,
            "num_experts_per_tok": 2, "tokens_per_request": 4, "pool": 16}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path, shrink_cells: bool = True) -> Path:
    """``tmp`` holding BENCHMARK.json and a tiny copy of portbench/;
    ``shrink_cells=False`` keeps every cell's traffic and check."""
    src = catalog.ROOT
    shutil.copy(src / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(src / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    cfgs = tmp / "portbench" / "configs"

    cnn = json.loads((cfgs / "quickstart-cnn.json").read_text())
    cnn["network"].update(img_h=16, img_w=32)
    cnn["pool"] = 64
    _write(cfgs / "quickstart-cnn.json", cnn)
    plan = json.loads((cfgs / cnn["plan"]).read_text())
    plan["workload"]["spec"].update(img_h=16, img_w=32)
    _write(cfgs / cnn["plan"], plan)

    moe = json.loads((cfgs / "qwen3-moe-30b-a3b-experts.json").read_text())
    moe.update(TINY_MOE)
    _write(cfgs / "qwen3-moe-30b-a3b-experts.json", moe)
    plan = json.loads((cfgs / moe["plan"]).read_text())
    spec = plan["workload"]["spec"]
    spec.update(d_model=64, seq_len=4)
    for layer in spec["layers"]:
        layer.update(d_ff_expert=32, num_experts=8, top_k=2)
    _write(cfgs / moe["plan"], plan)

    if not shrink_cells:
        return tmp
    for path in (tmp / "portbench" / "cells").glob("*.json"):
        cell = json.loads(path.read_text())
        cell["traffic"]["clients"] = 8
        cell["check"].update(keep_every=2, compare=min(
            cell["check"]["compare"], 16))
        if "moe" in path.name:
            cell["check"].update(keep_run=8)
        _write(path, cell)
    return tmp
