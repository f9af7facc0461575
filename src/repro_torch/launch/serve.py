"""Serving launcher of the port: the synchronous CNN path of
``repro.launch.serve``, on the card.

  # plan the quickstart CNN for a catalog device, then serve the plan
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \\
      --requests 64 --max-batch 16 [--device v5e] [--save-plan plan.json] \\
      [--torch-device cuda|cpu]

  # serve a plan artifact verbatim
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \\
      --plan src/repro_torch/plans/quickstart_v5e_conv1_conv3.json \\
      [--params src/repro_torch/golden/quickstart_reference.npz] \\
      --requests 64 --max-batch 16

Without ``--plan`` the launcher plans as the reference's does: the
port's own resource sweep (cached under ``build/repro_torch/``), the
fitted block models, then ``plan_deployment`` for the ``--device``
profile at target 0.8, falling back per layer where nothing fits.
``--params`` (with ``--plan`` only) names an npz of layer weights under
the keys ``<plan file stem>.w0``, ``.w1``, …, as the committed golden
file stores them; without it the weights are a seeded draw.
Prints what the reference's ``run_cnn`` prints, with the device's name.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import convert
from repro_torch.core import allocate, deploy
from repro_torch.core.cnn import fitted_block_models, quickstart_cnn_config
from repro_torch.device import device_name, resolve_device
from repro_torch.runtime import load_plan, save_plan
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


def cnn_plan(args) -> deploy.DeploymentPlan:
    """Load the plan artifact ``--plan``, or plan the quickstart CNN for
    ``--device``; ``--save-plan`` writes the plan served."""
    if args.plan:
        plan = load_plan(args.plan)
        print(f"[serve] loaded plan artifact {args.plan!r} "
              f"(planned for device {plan.device.name})")
    else:
        plan = deploy.plan_deployment(
            quickstart_cnn_config(), fitted_block_models(),
            allocate.get_device(args.device), target=0.8,
            on_infeasible="fallback")
    if args.save_plan:                 # also re-exports a loaded --plan
        save_plan(plan, args.save_plan)
        print(f"[serve] plan artifact saved to {args.save_plan!r}")
    print(f"[serve] plan for {plan.device.name}: "
          + ", ".join(f"L{a.index}={a.block}@d{a.data_bits}/c{a.coeff_bits}"
                      for a in plan.layers))
    return plan


def run_cnn(args) -> Tuple[CNNEngine, List[ImageRequest], float]:
    """Serve ``args.requests`` sample images from the plan (``cnn_plan``);
    returns the engine, the served requests and the serving seconds."""
    device = resolve_device(args.torch_device)
    plan = cnn_plan(args)
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
    ap.add_argument("--plan", default=None,
                    help="DeploymentPlan JSON artifact to serve (default: "
                         "plan the quickstart CNN for --device)")
    ap.add_argument("--device", default="v5e",
                    help="catalog device profile to plan for (edge, v5e, "
                         "v5p)")
    ap.add_argument("--save-plan", default=None,
                    help="write the served plan artifact here")
    ap.add_argument("--params", default=None, metavar="NPZ",
                    help="layer weights (<plan stem>.w0, .w1, …); needs "
                         "--plan")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.params and not args.plan:
        ap.error("--params names weights by the --plan file's stem; "
                 "pass --plan with it")
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    run_cnn(parse_args(argv))


if __name__ == "__main__":
    main()
