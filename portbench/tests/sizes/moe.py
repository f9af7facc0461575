"""The MoE stack with 8 experts of width 32 at d_model 64, 4 tokens a
request, 16 requests in the pool; a cell's 8 clients, runs of 8 kept
answers, every second run, at most 16 dispatches compared."""

import json

TINY_MOE = {"hidden_size": 64, "moe_intermediate_size": 32, "num_experts": 8,
            "num_experts_per_tok": 2, "tokens_per_request": 4, "pool": 16}


def shrink(config, config_dir) -> None:
    config.update(TINY_MOE)
    path = config_dir / config["plan"]
    plan = json.loads(path.read_text())
    spec = plan["workload"]["spec"]
    spec.update(d_model=64, seq_len=4)
    for layer in spec["layers"]:
        layer.update(d_ff_expert=32, num_experts=8, top_k=2)
    path.write_text(json.dumps(plan, indent=1))


def shrink_cell(cell) -> None:
    cell["traffic"]["clients"] = 8
    cell["check"].update(keep_every=2, keep_run=8,
                         compare=min(cell["check"]["compare"], 16))
