"""The quickstart network on 16 x 32 images, 64 of them in the pool;
a cell's 8 clients, every second run of kept answers, at most 16
compared."""

import json


def shrink(config, config_dir) -> None:
    config["network"].update(img_h=16, img_w=32)
    config["pool"] = 64
    path = config_dir / config["plan"]
    plan = json.loads(path.read_text())
    plan["workload"]["spec"].update(img_h=16, img_w=32)
    path.write_text(json.dumps(plan, indent=1))


def shrink_cell(cell) -> None:
    cell["traffic"]["clients"] = 8
    cell["check"].update(keep_every=2,
                         compare=min(cell["check"]["compare"], 16))
