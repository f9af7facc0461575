"""Serving launcher of the port: the synchronous CNN path and the LM
path of ``repro.launch.serve``, on the card.

  # plan the quickstart CNN for a catalog device, then serve the plan
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \\
      --requests 64 --max-batch 16 [--device v5e] [--save-plan plan.json] \\
      [--torch-device cuda|cpu]

  # serve a plan artifact verbatim
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \\
      --plan src/repro_torch/plans/quickstart_v5e_conv1_conv3.json \\
      [--params src/repro_torch/golden/quickstart_reference.npz] \\
      --requests 64 --max-batch 16

  # serve a zoo LM (its reduced "smoke" config, as the reference does)
  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
      [--arch llama3.2-3b] --requests 6 --prompt-len 16 --new-tokens 24 \\
      --max-batch 4 [--torch-device cuda|cpu]

The port's default workload is ``cnn`` (the reference's is ``lm``).
Without ``--plan`` the launcher plans as the reference's does: the
port's own resource sweep (cached under ``build/repro_torch/``), the
fitted block models, then ``plan_deployment`` for the ``--device``
profile at target 0.8, falling back per layer where nothing fits.
``--params`` (with ``--plan`` only) names an npz of layer weights under
the keys ``<plan file stem>.w0``, ``.w1``, …, as the committed golden
file stores them; without it the weights are a seeded draw.
``--workload lm`` serves ``smoke_config(--arch)`` with parameters drawn
from a generator seeded with 0 and prompts from ``numpy``'s
``default_rng(0)``, through ``serve_lm``, which takes any
``ModelConfig`` (the full-width configs too).  Prints what the
reference's ``run_cnn`` and ``run_lm`` print, with the device's name.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import ModelConfig, smoke_config
from repro_torch.core import allocate, deploy
from repro_torch.core.cnn import fitted_block_models, quickstart_cnn_config
from repro_torch.device import device_name, resolve_device
from repro_torch.runtime import load_plan, save_plan
from repro_torch.models import build_model
from repro_torch.serve import (CNNEngine, CNNServeConfig, Engine,
                               ImageRequest, Request, ServeConfig)


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


def serve_lm(cfg: ModelConfig, *, requests: int, prompt_len: int,
             new_tokens: int, max_batch: int, device="cuda"
             ) -> Tuple[Engine, List[Request], float]:
    """Serve ``requests`` prompts of ``prompt_len`` tokens (numpy's
    ``default_rng(0)``) for ``new_tokens`` tokens each through the LM
    ``Engine`` of ``cfg``, with parameters drawn from a generator seeded
    with 0 on the device.  Returns the engine (its ``model`` and
    ``params``), the served requests and the serving seconds."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = Engine(model, params, ServeConfig(
        max_batch=max_batch, max_len=prompt_len + new_tokens + 8,
        max_new_tokens=new_tokens))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
                1, cfg.vocab_size, prompt_len)], request_id=i)
            for i in range(requests)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)    # the weight draw is not serving time
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {cfg.name}: {requests} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s on {device_name(dev)})")
    for r in reqs[:3]:
        print(f"  req{r.request_id}: {r.out_tokens[:12]}...")
    return engine, reqs, dt


def run_lm(args) -> Tuple[Engine, List[Request], float]:
    """Serve the reduced config of ``--arch``, as the reference does."""
    return serve_lm(smoke_config(args.arch), requests=args.requests,
                    prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                    max_batch=args.max_batch, device=args.torch_device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Serve a CNN deployment plan or a zoo LM through "
                    "repro_torch.")
    ap.add_argument("--workload", choices=("cnn", "lm"), default="cnn",
                    help="cnn (the default) or lm")
    ap.add_argument("--arch", default="llama3.2-3b",
                    help="zoo architecture (lm)")
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
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompt tokens per request (lm)")
    ap.add_argument("--new-tokens", type=int, default=24,
                    help="tokens generated per request (lm)")
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.params and not args.plan:
        ap.error("--params names weights by the --plan file's stem; "
                 "pass --plan with it")
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    run_lm(args) if args.workload == "lm" else run_cnn(args)


if __name__ == "__main__":
    main()
