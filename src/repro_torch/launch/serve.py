"""Serving launcher of the port: the synchronous CNN path of
``repro.launch.serve``, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \\
      --plan src/repro_torch/plans/quickstart_v5e_conv1_conv3.json \\
      [--params src/repro_torch/golden/quickstart_reference.npz] \\
      --requests 64 --max-batch 16 [--torch-device cuda|cpu]

The plan artifact is served verbatim (the port has no planner yet).
``--params`` names an npz of layer weights under the keys
``<plan file stem>.w0``, ``.w1``, …, as the committed golden file stores
them; without it the weights are a seeded draw.
Prints what the reference's ``run_cnn`` prints, with the device's name.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import convert
from repro_torch.core import deploy
from repro_torch.device import device_name, resolve_device
from repro_torch.runtime import load_plan
from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest


def load_params(path, plan_path, cfg, device):
    """Layer weights from an npz, under ``<plan file stem>.w<i>``."""
    stem = Path(plan_path).stem
    with np.load(path) as z:
        arrays = []
        for i in range(len(cfg.layers)):
            key = f"{stem}.w{i}"
            if key not in z:
                raise ValueError(f"{path}: no weights for layer {i} ({key})")
            arrays.append(z[key])
    return convert.params_from_numpy(arrays, cfg, device)


def run_cnn(args) -> Tuple[CNNEngine, List[ImageRequest], float]:
    """Serve ``args.requests`` sample images from the plan artifact;
    returns the engine, the served requests and the serving seconds."""
    device = resolve_device(args.torch_device)
    plan = load_plan(args.plan)
    print(f"[serve] loaded plan artifact {args.plan!r} "
          f"(planned for device {plan.device.name})")
    print(f"[serve] plan for {plan.device.name}: "
          + ", ".join(f"L{a.index}={a.block}@d{a.data_bits}/c{a.coeff_bits}"
                      for a in plan.layers))
    params = None
    if args.params:
        params = load_params(args.params, args.plan,
                             deploy.plan_config(plan), device)
    t0 = time.perf_counter()
    engine = CNNEngine.from_plan(           # prepares every bucket
        plan, params=params,
        serve_cfg=CNNServeConfig(max_batch=args.max_batch), device=device)
    print(f"[serve] AOT warmup: {len(engine.compiled.buckets)} buckets × "
          f"{len(engine.cfg.layers)} layers compiled in "
          f"{time.perf_counter() - t0:.2f}s (off the serving critical path)")

    reqs = [ImageRequest(image=img, request_id=i) for i, img in
            enumerate(engine.compiled.sample_inputs(args.requests))]
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    stats = engine.stats()
    print(f"[serve] {len(reqs)} images in {dt:.2f}s "
          f"({len(reqs)/dt:.1f} images/s, "
          f"{stats['images_per_step']:.1f} images/step) on "
          f"{device_name(device)}")
    print(f"[serve] occupancy histogram: {stats['occupancy_hist']}  "
          f"bucket hits: {stats['bucket_hits']}")
    return engine, reqs, dt


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Serve a CNN deployment plan through repro_torch.")
    ap.add_argument("--workload", choices=("cnn",), default="cnn",
                    help="the port serves the CNN workload")
    ap.add_argument("--plan", required=True,
                    help="DeploymentPlan JSON artifact to serve")
    ap.add_argument("--params", default=None, metavar="NPZ",
                    help="layer weights (<plan stem>.w0, .w1, …)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run_cnn(parse_args(argv))


if __name__ == "__main__":
    main()
