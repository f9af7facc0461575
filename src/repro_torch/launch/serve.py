"""Serving launcher of the port: the synchronous and the async CNN
paths and the LM path of ``repro.launch.serve``, on the card.

  # plan the quickstart CNN for a catalog device, then serve the plan
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \\
      --requests 64 --max-batch 16 [--device v5e] [--save-plan plan.json] \\
      [--torch-device cuda|cpu]

  # serve a plan artifact verbatim
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn \\
      --plan src/repro_torch/plans/quickstart_v5e_conv1_conv3.json \\
      [--params src/repro_torch/golden/quickstart_reference.npz] \\
      --requests 64 --max-batch 16

  # the continuous-batching gateway under Poisson arrivals at
  # --occupancy × the measured full-batch capacity
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn --async \
      --plan src/repro_torch/plans/quickstart_v5e.json \
      --params src/repro_torch/golden/quickstart_reference.npz \
      --requests 4096 --max-batch 16 --occupancy 2.0 [--max-pending 32] \
      [--deadline-ms 2] [--wait-budget-ms 5] [--max-inflight 2] \
      [--metrics-out metrics.jsonl] [--torch-device cuda|cpu]

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
``--plan-store DIR`` (without ``--plan``) serves the plan stored under
``cnn-<--device>`` in that ``ops.PlanStore``, or plans once and stores
it; ``--metrics-out FILE`` streams lifecycle events and periodic stats
snapshots there as JSON lines (``ops.JsonlTracker``), on every path.
``--workload lm`` serves ``smoke_config(--arch)`` with parameters drawn
from a generator seeded with 0 and prompts from ``numpy``'s
``default_rng(0)``, through ``serve_lm``, which takes any
``ModelConfig`` (the full-width configs too).  Prints what the
reference's ``run_cnn``, ``run_cnn_async`` and ``run_lm`` print, with
the device's name.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
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
from repro_torch.models import build_model
from repro_torch.ops import JsonlTracker, PlanStore, StatsSampler
from repro_torch.runtime import load_plan, save_plan
from repro_torch.runtime.compiled import dtype_name
from repro_torch.serve import (AsyncCNNGateway, AsyncServeConfig,
                               CNNEngine, CNNServeConfig, DeadlineExpired,
                               Engine, GatewayBacklog, ImageRequest, Request,
                               ServeConfig)


def _percentiles(lat_s):
    p = np.percentile(np.asarray(lat_s) * 1e3, [50, 95, 99])
    return {"p50_ms": p[0], "p95_ms": p[1], "p99_ms": p[2]}


# -- ops flags ---------------------------------------------------------------
def _ops_tracker(args):
    """``--metrics-out`` → a ``JsonlTracker``; None without the flag."""
    if not getattr(args, "metrics_out", None):
        return None
    tracker = JsonlTracker(args.metrics_out)
    print(f"[ops] metrics JSONL → {args.metrics_out!r}")
    return tracker


def _ops_sampler(tracker, sources, interval_s=0.5):
    if tracker is None:
        return None
    return StatsSampler(tracker, sources, interval_s=interval_s)


def _ops_finish(tracker, sampler=None):
    """Flush ops state at the end of a run and say where it went."""
    if sampler is not None:
        sampler.close()
    if tracker is not None:
        tracker.close()
        print(f"[ops] metrics: {tracker.recorded} records "
              f"({tracker.dropped} dropped) → {tracker.path}")


def _plan_from_store(args, workload: str, compute):
    """Resolve the plan through ``--plan-store``: serve the stored plan
    under ``<workload>-<device>`` if present, otherwise run
    ``compute()`` and persist the result — the next launch loads it."""
    store = PlanStore(args.plan_store)
    store_id = f"{workload}-{args.device}"
    if store_id in store:
        plan = store.load(store_id)
        print(f"[serve] loaded plan {store_id!r} from store "
              f"{args.plan_store!r}")
        return plan
    plan = compute()
    store.save(plan, store_id)
    print(f"[serve] plan {store_id!r} saved to store {args.plan_store!r}")
    return plan


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
    """Load the plan artifact ``--plan``, or the one ``--plan-store``
    holds, or plan the quickstart CNN for ``--device``; ``--save-plan``
    writes the plan served."""
    def compute():
        return deploy.plan_deployment(
            quickstart_cnn_config(), fitted_block_models(),
            allocate.get_device(args.device), target=0.8,
            on_infeasible="fallback")

    if args.plan:
        plan = load_plan(args.plan)
        print(f"[serve] loaded plan artifact {args.plan!r} "
              f"(planned for device {plan.device.name})")
    elif args.plan_store:
        plan = _plan_from_store(args, "cnn", compute)
    else:
        plan = compute()
    if args.save_plan:                 # also re-exports a loaded --plan
        save_plan(plan, args.save_plan)
        print(f"[serve] plan artifact saved to {args.save_plan!r}")
    print(f"[serve] plan for {plan.device.name}: "
          + ", ".join(f"L{a.index}={a.block}@d{a.data_bits}/c{a.coeff_bits}"
                      for a in plan.layers))
    return plan


def _plan_params(args, plan, device):
    """The ``--params`` weights of ``plan``, or None (a seeded draw)."""
    if not args.params:
        return None
    return load_params(args.params, args.plan, deploy.plan_config(plan),
                       device)


def run_cnn(args) -> Tuple[CNNEngine, List[ImageRequest], float]:
    """Serve ``args.requests`` sample images from the plan (``cnn_plan``);
    returns the engine, the served requests and the serving seconds."""
    device = resolve_device(args.torch_device)
    plan = cnn_plan(args)
    tracker = _ops_tracker(args)
    t0 = time.perf_counter()
    engine = CNNEngine.from_plan(           # prepares every bucket
        plan, params=_plan_params(args, plan, device),
        serve_cfg=CNNServeConfig(max_batch=args.max_batch), device=device)
    sampler = _ops_sampler(tracker, {"engine": engine.stats})
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
    _ops_finish(tracker, sampler)
    return engine, reqs, dt


_STAGES = ("to_task", "stack", "hop_in", "forward", "hop_back", "finish")


def _stage_summary(log, max_batch: int, wall_s: float) -> dict:
    """A run's dispatch stages (``AsyncCNNGateway.stage_log``): p50, p99
    and max ms of each stage and of the whole dispatch, the gateway's
    full-batch step (median whole dispatch over full batches), the
    worker thread's busy share of the wall, and the first and the
    slowest dispatch stage by stage."""
    if not log:
        return {}
    ms = {k: np.array([getattr(d, k) for d in log]) * 1e3
          for k in _STAGES + ("total",)}
    full = [d.total * 1e3 for d in log if d.n == max_batch]

    def stages(d):
        return {"n": d.n, "total_ms": d.total * 1e3,
                **{f"{k}_ms": getattr(d, k) * 1e3 for k in _STAGES}}
    return {
        "dispatches": len(log),
        "stages_ms": {k: {"p50": float(np.percentile(v, 50)),
                          "p99": float(np.percentile(v, 99)),
                          "max": float(v.max())} for k, v in ms.items()},
        "gateway_step_ms": float(np.median(full)) if full else None,
        "worker_busy": float(ms["forward"].sum() / 1e3 / wall_s),
        "first_dispatch": stages(log[0]),
        "slowest_dispatch": stages(max(log, key=lambda d: d.total)),
    }


def run_cnn_async(args, *, keep_every: int = 0
                  ) -> Tuple[AsyncCNNGateway, dict]:
    """Continuous-batching gateway under Poisson arrivals at an offered
    load of ``--occupancy`` × the measured full-batch service capacity.
    Reports tail latency (p50/p95/p99 over *served* requests, from each
    request's scheduled arrival), shed and expired counts — the
    front-door view the tick loop cannot give — and where each dispatch
    spends its time (``_stage_summary``).  Returns the closed gateway
    and the run's numbers; with ``keep_every`` k > 0 they include
    ``outputs``, the ``(index, image, output)`` of every served request
    whose index is a multiple of k.

    One producer coroutine walks the arrival schedule, where the
    reference starts a task per request: starting thousands of tasks
    takes longer than a fast trace lasts, and turns it into one burst.
    The offered rate the producer achieved is reported beside the
    scheduled one."""
    device = resolve_device(args.torch_device)
    plan = cnn_plan(args)
    tracker = _ops_tracker(args)
    t0 = time.perf_counter()
    wait_budget = (args.wait_budget_ms / 1e3
                   if args.wait_budget_ms else None)
    gw = AsyncCNNGateway.from_plan(
        plan, AsyncServeConfig(max_batch=args.max_batch,
                               max_pending=args.max_pending,
                               max_inflight=args.max_inflight,
                               wait_budget_s=wait_budget),
        params=_plan_params(args, plan, device), device=device,
        tracker=tracker)
    gw.stage_log = []
    sampler = _ops_sampler(tracker, {"gateway": gw.stats})
    compiled = gw.plans["plan0"].compiled
    print(f"[serve] AOT warmup: {len(compiled.buckets)} buckets × "
          f"{len(compiled.cfg.layers)} layers compiled in "
          f"{time.perf_counter() - t0:.2f}s (shared exec cache: "
          f"{len(gw.exec_cache)} executables)")

    imgs = compiled.sample_inputs(args.requests)
    # service capacity: one timed full-batch forward, the clock stopped
    # once the device has finished → arrival rate
    np_dtype = np.dtype(dtype_name(compiled.in_dtype))
    xb = torch.from_numpy(np.stack([np.asarray(i, np_dtype)
                                    for i in imgs[:args.max_batch]]))
    compiled(xb)                                   # touch
    _sync(device)
    t0 = time.perf_counter()
    compiled(xb)
    _sync(device)
    step_s = time.perf_counter() - t0
    rate = args.occupancy * args.max_batch / step_s
    print(f"[serve] full-batch step {step_s * 1e3:.2f}ms → offered load "
          f"{rate:.0f} images/s (occupancy {args.occupancy:g})")

    deadline = args.deadline_ms / 1e3 if args.deadline_ms else None
    rng = np.random.default_rng(1)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, args.requests))

    async def drive():
        latencies, lags, kept, futs = [], [], [], []
        shed, admit_s = 0, 0.0

        def served(i, due, fut):
            if not fut.cancelled() and fut.exception() is None:
                latencies.append(time.monotonic() - due)
                if keep_every and i % keep_every == 0:
                    kept.append((i, imgs[i], fut.result()))

        async with gw:
            t_start = time.monotonic()
            for i, at in enumerate(arrivals):
                # behind schedule the producer submits at once, yielding
                # between arrivals so dispatches and completions run
                due = t_start + at
                await asyncio.sleep(max(0.0, due - time.monotonic()))
                lags.append(time.monotonic() - due)
                t_admit = time.perf_counter()
                try:
                    fut = gw.submit_nowait(imgs[i], deadline=deadline)
                except GatewayBacklog:
                    shed += 1
                    continue
                finally:
                    admit_s += time.perf_counter() - t_admit
                fut.add_done_callback(functools.partial(served, i, due))
                futs.append(fut)
            produced = time.monotonic() - t_start
            for out in await asyncio.gather(*futs, return_exceptions=True):
                if isinstance(out, GatewayBacklog):
                    shed += 1                      # shed for a higher class
                elif isinstance(out, BaseException) \
                        and not isinstance(out, DeadlineExpired):
                    raise out                      # counted by stats()
            return (latencies, lags, kept, shed, admit_s, produced,
                    time.monotonic() - t_start)

    latencies, lags, kept, shed, admit_s, produced, wall = \
        asyncio.run(drive())
    stats = gw.stats()
    pct = _percentiles(latencies) if latencies else {}
    achieved = args.requests / produced if produced > 0 else float("inf")
    lag_ms = np.asarray(lags) * 1e3
    print(f"[serve] {stats['served']} served / {shed} shed / "
          f"{stats['expired']} expired of {args.requests} in {wall:.2f}s "
          f"({stats['served'] / wall:.1f} images/s) on "
          f"{device_name(device)}")
    print(f"[serve] arrivals offered at {achieved:.0f} images/s of the "
          f"{rate:.0f} scheduled (producer lag p50 "
          f"{np.percentile(lag_ms, 50):.2f}ms, max {lag_ms.max():.2f}ms), "
          f"admission {admit_s / args.requests * 1e6:.1f}us per request")
    if pct:
        print(f"[serve] latency p50={pct['p50_ms']:.1f}ms "
              f"p95={pct['p95_ms']:.1f}ms p99={pct['p99_ms']:.1f}ms "
              f"(from the scheduled arrival)")
    print(f"[serve] occupancy histogram: {stats['occupancy_hist']}  "
          f"policy: {stats['policy']}  pending bound: "
          f"{stats['max_pending']}"
          + (f" (adaptive, budget "
             f"{stats['wait_budget_s'] * 1e3:.0f}ms)"
             if stats['wait_budget_s'] else " (static)"))
    print(f"[serve] measured service rate "
          f"{stats['service_rate']:.0f} images/s, est wait "
          f"{stats['est_wait'] * 1e3:.1f}ms, shed at bound: "
          f"{stats['shed']}")
    stages = _stage_summary(gw.stage_log, args.max_batch, wall)
    if stages:
        gstep = stages["gateway_step_ms"]
        print(f"[serve] {stages['dispatches']} dispatches, ms p50/p99/max: "
              + ", ".join(f"{k} {v['p50']:.3f}/{v['p99']:.3f}/"
                          f"{v['max']:.3f}"
                          for k, v in stages["stages_ms"].items())
              + "; full-batch step through the gateway "
              + (f"{gstep:.3f}ms" if gstep is not None else "n/a")
              + f"; worker busy {stages['worker_busy'] * 100:.1f}% of "
              f"the wall")
    _ops_finish(tracker, sampler)
    res = {"requests": args.requests, "served": stats["served"],
           "shed": shed, "expired": stats["expired"],
           "failed": stats["failed"], "wall_s": wall,
           "step_ms": step_s * 1e3, "offered_per_s": rate,
           "achieved_offered_per_s": achieved,
           "producer_lag_p50_ms": float(np.percentile(lag_ms, 50)),
           "producer_lag_max_ms": float(lag_ms.max()),
           "admission_us": admit_s / args.requests * 1e6,
           "images_per_s": stats["served"] / wall, **pct,
           "service_rate": stats["service_rate"],
           "occupancy_hist": stats["occupancy_hist"],
           "max_pending": stats["max_pending"], **stages}
    if keep_every:
        res["outputs"] = sorted(kept, key=lambda t: t[0])
    return gw, res


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg: ModelConfig, *, requests: int, prompt_len: int,
             new_tokens: int, max_batch: int, device="cuda", tracker=None
             ) -> Tuple[Engine, List[Request], float]:
    """Serve ``requests`` prompts of ``prompt_len`` tokens (numpy's
    ``default_rng(0)``) for ``new_tokens`` tokens each through the LM
    ``Engine`` of ``cfg``, with parameters drawn from a generator seeded
    with 0 on the device; ``tracker`` (an ``ops.Tracker``) receives the
    engine's stats snapshots.  Returns the engine (its ``model`` and
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
    _sync(dev)                         # the weight draw is not serving time
    sampler = _ops_sampler(
        tracker, {"engine": lambda: engine.snapshot().asdict()})
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    if sampler is not None:
        sampler.close()
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {cfg.name}: {requests} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s on {device_name(dev)})")
    for r in reqs[:3]:
        print(f"  req{r.request_id}: {r.out_tokens[:12]}...")
    return engine, reqs, dt


def run_lm(args) -> Tuple[Engine, List[Request], float]:
    """Serve the reduced config of ``--arch``, as the reference does."""
    tracker = _ops_tracker(args)
    out = serve_lm(smoke_config(args.arch), requests=args.requests,
                   prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                   max_batch=args.max_batch, device=args.torch_device,
                   tracker=tracker)
    _ops_finish(tracker)
    return out


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
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="serve through the continuous-batching gateway "
                         "under Poisson arrivals (cnn)")
    ap.add_argument("--occupancy", type=float, default=1.0,
                    help="offered load as a multiple of full-batch "
                         "service capacity (cnn --async)")
    ap.add_argument("--max-pending", type=int, default=32,
                    help="gateway admission bound — the hard cap when "
                         "--wait-budget-ms makes it adaptive "
                         "(cnn --async)")
    ap.add_argument("--wait-budget-ms", type=float, default=None,
                    help="adaptive admission: size the pending bound to "
                         "measured service rate × this wait budget "
                         "(cnn --async)")
    ap.add_argument("--max-inflight", type=int, default=1,
                    help="concurrent gateway dispatches; 2 overlaps the "
                         "next batch with the one on the card "
                         "(cnn --async)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; late requests are "
                         "expired, never served late (cnn --async)")
    ap.add_argument("--plan-store", default=None, metavar="DIR",
                    help="durable plan repository (repro_torch.ops."
                         "PlanStore): load the plan from DIR if present, "
                         "else plan once and save it (cnn)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="stream lifecycle events and periodic stats "
                         "snapshots to FILE as JSON lines "
                         "(repro_torch.ops.JsonlTracker; all paths)")
    args = ap.parse_args(argv)
    if args.params and not args.plan:
        ap.error("--params names weights by the --plan file's stem; "
                 "pass --plan with it")
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.workload == "lm":
        run_lm(args)
    elif args.async_:
        run_cnn_async(args)
    else:
        run_cnn(args)


if __name__ == "__main__":
    main()
