"""Serving launcher of the port: the synchronous, async and fleet CNN
paths, the synchronous and async MoE paths and the LM path of
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

  # data-parallel: each batch split over the host's CUDA cards (sync or
  # --async; every card holds the weights, the first joins the outputs)
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn --shard \
      --plan src/repro_torch/plans/quickstart_v5e.json \
      --params src/repro_torch/golden/quickstart_reference.npz \
      --requests 64 --max-batch 16 [--async --occupancy 2.0]

  # the continuous-batching gateway under Poisson arrivals at
  # --occupancy × the measured full-batch capacity
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn --async \
      --plan src/repro_torch/plans/quickstart_v5e.json \
      --params src/repro_torch/golden/quickstart_reference.npz \
      --requests 4096 --max-batch 16 --occupancy 2.0 [--max-pending 32] \
      [--deadline-ms 2] [--wait-budget-ms 5] [--max-inflight 2] \
      [--metrics-out metrics.jsonl] [--torch-device cuda|cpu]

  # the fleet: one gateway per catalog profile (edge0, v5e0, v5p0, each
  # serving the plan the planner makes for its profile), tiered Poisson
  # arrivals at --occupancy × one bare full-batch forward, routed by
  # --router; --drain drains v5e0 halfway through the trace
  PYTHONPATH=src python -m repro_torch.launch.serve --workload cnn --fleet \
      --requests 4096 --max-batch 16 --max-pending 32 [--occupancy 1.0] \
      [--router plan_aware|least_loaded|round_robin] [--drain] [--seed 1] \
      [--cache-dir DIR | --store-root DIR] [--torch-device cuda|cpu]

  # the quantized MoE workload: plan smoke_config(--arch)'s experts
  # (plan_moe_deployment), then serve token blocks through the same
  # engine, or the gateway with --async
  PYTHONPATH=src python -m repro_torch.launch.serve --workload moe \\
      --requests 32 --max-batch 8 [--device v5e] [--arch qwen3-moe-30b-a3b] \\
      [--save-plan moe_plan.json] [--async --occupancy 2.0] \\
      [--torch-device cuda|cpu]

  # serve a zoo LM (its reduced "smoke" config, as the reference does):
  # the dense, MoE (qwen3-moe-30b-a3b, llama4-maverick-400b-a17b),
  # Mamba and hybrid (jamba-1.5-large-398b) families
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
it; ``--cache-dir DIR`` prepares every (layer, bucket) launch through
an ``ops.PersistentExecutableCache`` there (kernel libraries under
``DIR/kernels``), so a warm restart prepares nothing and runs no
``nvcc``; ``--store-root DIR`` is one ``ops.StoreRoot`` standing in for
both (plans under ``DIR/plans``, the cache under ``DIR/exec-cache``);
``--metrics-out FILE`` streams lifecycle events and periodic stats
snapshots there as JSON lines (``ops.JsonlTracker``), on every path.
``--workload moe`` plans ``moe_workload_from_config(smoke_config(--arch))``
(``--arch`` defaults to ``qwen3-moe-30b-a3b`` there) for ``--device`` at
target 0.8 with fallback, or serves ``--plan`` or the plan stored under
``moe-<--device>`` with ``--plan-store``; its weights are a seeded draw
(``CompiledMoE.from_plan``).  With ``--cache-dir`` its prepared layers
stay in memory (they launch none of the port's kernels), so a restart
prepares them again without building anything.
``--workload lm`` serves ``smoke_config(--arch)`` with parameters drawn
from a generator seeded with 0 and prompts from ``numpy``'s
``default_rng(0)``, through ``serve_lm``, which takes any
``ModelConfig`` (the full-width configs too) whose prefill takes
tokens alone: Whisper's ``frames`` and Pixtral's ``patches`` run
through ``Model.prefill``/``decode_step`` only, as in the reference,
whose ``Engine`` cannot prefill them, and ``serve_lm`` refuses those
two archs before it draws a weight.  Prints what the
reference's ``run_cnn``, ``run_cnn_async`` and ``run_lm`` print, with
the device's name, and ``run_moe``, ``run_moe_async`` what theirs
print; ``--fleet`` prints what the reference's
``run_cnn_fleet`` prints, with latency from each request's scheduled
arrival, and walks the arrivals with one producer.
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
from repro_torch.ops import (JsonlTracker, PersistentExecutableCache,
                             PlanStore, StatsSampler, StoreRoot)
from repro_torch.runtime import (load_plan, moe_workload_from_config,
                                 plan_moe_deployment, save_plan)
from repro_torch.runtime.compiled import dtype_name
from repro_torch.serve import (AsyncCNNGateway, AsyncServeConfig,
                               CNNEngine, CNNServeConfig, DeadlineExpired,
                               Engine, GatewayBacklog, ImageRequest, Request,
                               ServeConfig)


def _percentiles(lat_s):
    p = np.percentile(np.asarray(lat_s) * 1e3, [50, 95, 99])
    return {"p50_ms": p[0], "p95_ms": p[1], "p99_ms": p[2]}


# -- ops flags ---------------------------------------------------------------
def _apply_store_root(args) -> None:
    """``--store-root`` → one shared ``ops.StoreRoot`` standing in for
    both ``--plan-store`` and ``--cache-dir``: every worker process
    pointed at the same DIR shares one plan repository and one
    executable cache — which is what lets a respawned worker rebuild
    its predecessor's serving state with zero preparations (see
    ``repro_torch.chaos.respawn_gateway``)."""
    if not getattr(args, "store_root", None):
        return
    root = StoreRoot(args.store_root)
    args.plan_store = str(root.root)
    args.cache_dir = str(root.exec_cache_dir)
    print(f"[ops] shared store root at {args.store_root!r} "
          f"(plans + exec cache + leases)")


def _ops_cache(args) -> Optional[PersistentExecutableCache]:
    """``--cache-dir`` → a ``PersistentExecutableCache`` every
    preparation in this process goes through; None without the flag
    (the callers fall back to an in-memory cache)."""
    if not getattr(args, "cache_dir", None):
        return None
    cache = PersistentExecutableCache(args.cache_dir)
    print(f"[ops] persistent executable cache at {args.cache_dir!r}")
    return cache


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


def _ops_finish(tracker, sampler=None, cache=None):
    """Flush ops state at the end of a run and say where it went."""
    if sampler is not None:
        sampler.close()
    if tracker is not None:
        tracker.close()
        print(f"[ops] metrics: {tracker.recorded} records "
              f"({tracker.dropped} dropped) → {tracker.path}")
    if cache is not None:
        s = cache.stats()
        print(f"[ops] exec cache: {s['compiles']} prepared, "
              f"{s['disk_hits']} loaded from disk, "
              f"{s['disk_stores']} persisted, {s['disk_errors']} "
              f"corrupt or unwritable, {s['disk_stale']} stale")


def _plan_from_store(args, workload: str, compute,
                     device: Optional[str] = None):
    """Resolve the plan through ``--plan-store``: serve the stored plan
    under ``<workload>-<device>`` (``--device`` unless ``device`` is
    given) if present, otherwise run ``compute()`` and persist the
    result — the next launch loads it."""
    store = PlanStore(args.plan_store)
    store_id = f"{workload}-{device or args.device}"
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


def moe_plan(args) -> deploy.DeploymentPlan:
    """Load the MoE plan artifact ``--plan``, or the one ``--plan-store``
    holds under ``moe-<--device>``, or plan
    ``moe_workload_from_config(smoke_config(--arch))`` for ``--device``
    (target 0.8, fallback); ``--save-plan`` writes the plan served."""
    def compute():
        spec = moe_workload_from_config(smoke_config(args.arch))
        return plan_moe_deployment(spec, args.device, target=0.8,
                                   on_infeasible="fallback")

    if args.plan:
        plan = load_plan(args.plan)
        kind = plan.workload.kind if plan.workload is not None else "cnn"
        print(f"[serve] loaded plan artifact {args.plan!r} "
              f"(planned for device {plan.device.name}, "
              f"workload {kind!r})")
    elif args.plan_store:
        plan = _plan_from_store(args, "moe", compute)
    else:
        plan = compute()
    if args.save_plan:
        save_plan(plan, args.save_plan)
        print(f"[serve] plan artifact saved to {args.save_plan!r}")
    print(f"[serve] plan for {plan.device.name}: "
          + ", ".join(f"L{a.index}={a.block}@d{a.data_bits}/c{a.coeff_bits}"
                      for a in plan.layers)
          + f"  (quant rel-err {plan.quant_error:.4f})")
    return plan


def _plan_params(args, plan, device):
    """The ``--params`` weights of ``plan``, or None (a seeded draw)."""
    if not args.params:
        return None
    return load_params(args.params, args.plan, deploy.plan_config(plan),
                       device)


def _data_mesh(args):
    """``--shard``: a 1-D data mesh over every CUDA card of the host
    (``parallel.sharding.cnn_data_mesh``; raises without a card)."""
    if not args.shard:
        return None
    from repro_torch.parallel.sharding import cnn_data_mesh
    return cnn_data_mesh()


def run_cnn(args) -> Tuple[CNNEngine, List[ImageRequest], float]:
    """Serve ``args.requests`` sample images from the plan (``cnn_plan``);
    returns the engine, the served requests and the serving seconds."""
    device = resolve_device(args.torch_device)
    plan = cnn_plan(args)
    cache = _ops_cache(args)
    tracker = _ops_tracker(args)
    mesh = _data_mesh(args)
    t0 = time.perf_counter()
    engine = CNNEngine.from_plan(           # prepares every bucket
        plan, params=_plan_params(args, plan, device),
        serve_cfg=CNNServeConfig(max_batch=args.max_batch), device=device,
        mesh=mesh, exec_cache=cache)
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
          f"{device_name(engine.device)}"
          + (f", batch sharded over {mesh.size} device(s)" if mesh else ""))
    print(f"[serve] occupancy histogram: {stats['occupancy_hist']}  "
          f"bucket hits: {stats['bucket_hits']}")
    _ops_finish(tracker, sampler, cache)
    return engine, reqs, dt


def run_moe(args) -> Tuple[CNNEngine, List[ImageRequest], float]:
    """Serve ``args.requests`` sample token blocks from the MoE plan
    (``moe_plan``) through the same ``CNNEngine`` as the CNN path
    (``CNNEngine.from_plan`` dispatches on the plan's workload kind);
    returns the engine, the served requests and the serving seconds."""
    device = resolve_device(args.torch_device)
    plan = moe_plan(args)
    cache = _ops_cache(args)
    tracker = _ops_tracker(args)
    t0 = time.perf_counter()
    engine = CNNEngine.from_plan(
        plan, serve_cfg=CNNServeConfig(max_batch=args.max_batch),
        device=device, exec_cache=cache)
    sampler = _ops_sampler(tracker, {"engine": engine.stats})
    compiled = engine.compiled
    print(f"[serve] AOT warmup: {len(compiled.buckets)} buckets × "
          f"{compiled.num_layers} MoE layers compiled in "
          f"{time.perf_counter() - t0:.2f}s (off the serving critical path)")

    reqs = [ImageRequest(image=x, request_id=i) for i, x in
            enumerate(compiled.sample_inputs(args.requests))]
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    stats = engine.stats()
    seq_len = compiled.in_shape[0]
    print(f"[serve] {len(reqs)} token blocks ({len(reqs) * seq_len} "
          f"tokens) in {dt:.2f}s ({len(reqs) * seq_len / dt:.0f} tok/s, "
          f"{stats['images_per_step']:.1f} blocks/step) on "
          f"{device_name(device)}")
    print(f"[serve] occupancy histogram: {stats['occupancy_hist']}  "
          f"bucket hits: {stats['bucket_hits']}")
    _ops_finish(tracker, sampler, cache)
    return engine, reqs, dt


def run_moe_async(args, *, keep_every: int = 0
                  ) -> Tuple[AsyncCNNGateway, dict]:
    """The async gateway serving MoE token blocks from ``moe_plan``
    under plan id ``moe``: the driver of ``run_cnn_async``, which is
    plan-type-blind (``blocks_per_s`` in place of ``images_per_s``)."""
    device = resolve_device(args.torch_device)
    return _serve_async(args, moe_plan(args), None, device, plan_id="moe",
                        unit="blocks", keep_every=keep_every)


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
    return _serve_async(args, plan, _plan_params(args, plan, device),
                        device, plan_id="plan0", unit="images",
                        keep_every=keep_every, mesh=_data_mesh(args))


def _serve_async(args, plan, params, device: torch.device, *, plan_id: str,
                 unit: str, keep_every: int, mesh=None
                 ) -> Tuple[AsyncCNNGateway, dict]:
    """The driver of ``run_cnn_async`` and ``run_moe_async``: ``plan``
    registered under ``plan_id`` in one gateway, Poisson arrivals from
    one producer; ``unit`` names a request in the printed rates and in
    the result's ``<unit>_per_s``."""
    cache = _ops_cache(args)
    tracker = _ops_tracker(args)
    t0 = time.perf_counter()
    wait_budget = (args.wait_budget_ms / 1e3
                   if args.wait_budget_ms else None)
    gw = AsyncCNNGateway.from_plan(
        plan, AsyncServeConfig(max_batch=args.max_batch,
                               max_pending=args.max_pending,
                               max_inflight=args.max_inflight,
                               wait_budget_s=wait_budget),
        plan_id=plan_id, params=params, device=device, mesh=mesh,
        exec_cache=cache, tracker=tracker)
    gw.stage_log = []
    sampler = _ops_sampler(tracker, {"gateway": gw.stats})
    compiled = gw.plans[plan_id].compiled
    print(f"[serve] AOT warmup: {len(compiled.buckets)} buckets × "
          f"{compiled.num_layers} layers compiled in "
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
          f"{rate:.0f} {unit}/s (occupancy {args.occupancy:g})")

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
          f"({stats['served'] / wall:.1f} {unit}/s) on "
          f"{device_name(device)}")
    print(f"[serve] arrivals offered at {achieved:.0f} {unit}/s of the "
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
          f"{stats['service_rate']:.0f} {unit}/s, est wait "
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
    _ops_finish(tracker, sampler, cache)
    res = {"requests": args.requests, "served": stats["served"],
           "shed": shed, "expired": stats["expired"],
           "failed": stats["failed"], "wall_s": wall,
           "step_ms": step_s * 1e3, "offered_per_s": rate,
           "achieved_offered_per_s": achieved,
           "producer_lag_p50_ms": float(np.percentile(lag_ms, 50)),
           "producer_lag_max_ms": float(lag_ms.max()),
           "admission_us": admit_s / args.requests * 1e6,
           f"{unit}_per_s": stats["served"] / wall, **pct,
           "service_rate": stats["service_rate"],
           "occupancy_hist": stats["occupancy_hist"],
           "max_pending": stats["max_pending"], **stages}
    if keep_every:
        res["outputs"] = sorted(kept, key=lambda t: t[0])
    return gw, res


#: the fleet's workers: one per catalog profile, named ``<profile>0``
FLEET_PROFILES = ("edge", "v5e", "v5p")
#: the kernel entry a serving layer launches, by the library it runs
_REQUANT_ENTRY = {"fused_dot_layer": "fused_dot_layer_requant",
                  "packed_dot_layer": "packed_dot_layer_requant",
                  "conv1_layer": "conv1_layer"}


def plan_kernel_entries(plan) -> Tuple[str, ...]:
    """The kernel entry each layer of ``plan`` launches per served
    forward on the card (``LayerLaunch``: K1's or K2's requantizing
    entry for a dot block, K3 for Conv1)."""
    from repro_torch.blocks import get_block
    return tuple(_REQUANT_ENTRY[lib]
                 for a in plan.layers
                 for lib in get_block(a.block).serving_kernels(
                     a.data_bits, a.coeff_bits))


def fleet_plans(args) -> dict:
    """The plan the port's planner makes for each of ``FLEET_PROFILES``
    on the quickstart CNN (through ``--plan-store`` under
    ``cnn-<profile>`` when given)."""
    cfg = quickstart_cnn_config()
    plans = {}
    for name in FLEET_PROFILES:
        def compute(name=name):
            return deploy.plan_deployment(
                cfg, fitted_block_models(), allocate.get_device(name),
                target=0.8, on_infeasible="fallback")
        plans[name] = (_plan_from_store(args, "cnn", compute, device=name)
                       if args.plan_store else compute())
    return plans


def run_cnn_fleet(args, *, keep_every: int = 0):
    """Plan-aware fleet front door: one gateway per device profile
    (``FLEET_PROFILES``, each serving the plan the planner makes for
    *that* profile under one shared plan id ``cnn``), tiered Poisson
    traffic (``fleet.DEFAULT_TIERS``, from ``--seed``) at
    ``--occupancy`` × one bare full-batch forward of ``v5e0``, routed by
    ``--router``.  ``--drain`` gracefully drains ``v5e0`` when the
    producer reaches the middle of the trace — queued requests
    re-route, in-flight batches finish, nothing is lost.

    One producer walks the arrival schedule (as ``run_cnn_async``
    does) and admits with ``submit_nowait``: a request no worker can
    take is shed at the door.  Reports per-tier p50/p95/p99 from the
    scheduled arrival, served, expired, shed, refused (no admissible
    worker), failed and lost (admitted, then no worker took its
    re-route) counts, ``rerouted``, ``retried``, ``drains`` and each
    worker's served count.  Returns the closed fleet and the run's
    numbers; with ``keep_every`` k > 0 they include ``outputs``, the
    ``(index, worker_id, image, output)`` of every served request whose
    index is a multiple of k, so each output can be checked against the
    plan and weights of the worker that served it."""
    from repro_torch.fleet import (DEFAULT_TIERS, Fleet, FleetSaturated,
                                   FleetWorker, NoWorkerAvailable)
    device = resolve_device(args.torch_device)
    plans = fleet_plans(args)
    cache = _ops_cache(args)
    tracker = _ops_tracker(args)
    t0 = time.perf_counter()
    workers = []
    for name, plan in plans.items():
        gw = AsyncCNNGateway.from_plan(
            plan, AsyncServeConfig(max_batch=args.max_batch,
                                   max_pending=args.max_pending),
            plan_id="cnn", device=device, exec_cache=cache,
            tracker=tracker)
        workers.append(FleetWorker(f"{name}0", gw, name))
    build_s = time.perf_counter() - t0
    print(f"[fleet] {len(workers)} workers "
          f"({', '.join(f'{w.worker_id}:{w.profile.name}' for w in workers)})"
          f" prepared in {build_s:.2f}s")
    for w, plan in zip(workers, plans.values()):
        print(f"[fleet]   {w.worker_id:<6} plan "
              + ", ".join(f"L{a.index}={a.block}@d{a.data_bits}/"
                          f"c{a.coeff_bits}" for a in plan.layers)
              + f"; launches {list(plan_kernel_entries(plan))}")

    compiled = workers[1].gateway.plans["cnn"].compiled
    imgs = compiled.sample_inputs(args.requests)
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
    print(f"[fleet] full-batch step of {workers[1].worker_id} "
          f"{step_s * 1e3:.2f}ms → offered load {rate:.0f} images/s "
          f"(occupancy {args.occupancy:g} of one worker), router "
          f"{args.router!r}")

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, args.requests))
    tiers = list(DEFAULT_TIERS)
    shares = [t.share for t in DEFAULT_TIERS.values()]
    tier_of = rng.choice(len(tiers), size=args.requests, p=shares)

    async def drive():
        per_tier = {t: [] for t in tiers}
        counts = dict(served=0, expired=0, shed=0, refused=0, failed=0,
                      lost=0)
        kept, lags, futs = [], [], []
        fleet = Fleet(workers, router=args.router, tracker=tracker)
        sampler = _ops_sampler(tracker, {"fleet": fleet.stats})

        def settled(i, tier, due, fut):
            if fut.cancelled():
                counts["failed"] += 1
                return
            exc = fut.exception()
            if exc is None:
                counts["served"] += 1
                per_tier[tier].append(time.monotonic() - due)
                if keep_every and i % keep_every == 0:
                    kept.append((i, fut.request.worker.worker_id, imgs[i],
                                 fut.result()))
            elif isinstance(exc, DeadlineExpired):
                counts["expired"] += 1
            elif isinstance(exc, GatewayBacklog):
                counts["shed"] += 1        # shed for a higher class
            elif isinstance(exc, NoWorkerAvailable):
                counts["lost"] += 1        # admitted, then nowhere to go
            else:
                counts["failed"] += 1

        async with fleet:
            drain = None
            t_start = time.monotonic()
            for i, at in enumerate(arrivals):
                if args.drain and i == args.requests // 2:
                    print("[fleet] draining v5e0 ...")
                    drain = asyncio.ensure_future(fleet.drain("v5e0"))
                due = t_start + at
                await asyncio.sleep(max(0.0, due - time.monotonic()))
                lags.append(time.monotonic() - due)
                tier = tiers[tier_of[i]]
                try:
                    fut = fleet.submit_nowait(
                        imgs[i], tier=tier,
                        deadline=DEFAULT_TIERS[tier].deadline_s)
                except FleetSaturated:
                    counts["shed"] += 1
                    continue
                except NoWorkerAvailable:
                    counts["refused"] += 1
                    continue
                fut.add_done_callback(
                    functools.partial(settled, i, tier, due))
                futs.append(fut)
            produced = time.monotonic() - t_start
            await asyncio.gather(*futs, return_exceptions=True)
            if drain is not None:
                await drain
                print("[fleet] v5e0 drained (in-flight finished, queue "
                      "re-routed)")
            stats = fleet.stats()
        if sampler is not None:
            sampler.close()
        return (per_tier, counts, kept, lags, produced, stats,
                time.monotonic() - t_start, fleet)

    per_tier, counts, kept, lags, produced, stats, wall, fleet = \
        asyncio.run(drive())
    achieved = args.requests / produced if produced > 0 else float("inf")
    lag_ms = np.asarray(lags) * 1e3
    print(f"[fleet] {counts['served']} served / "
          f"{counts['expired'] + counts['shed']} expired-or-shed "
          f"({counts['expired']} expired, {counts['shed']} shed) / "
          f"{counts['refused']} refused / {counts['failed']} failed / "
          f"{counts['lost']} lost of {args.requests} in {wall:.2f}s "
          f"({counts['served'] / wall:.1f} images/s) on "
          f"{device_name(device)}  (rerouted={stats['rerouted']}, "
          f"retried={stats['retried']}, drains={stats['drains']})")
    print(f"[fleet] arrivals offered at {achieved:.0f} images/s of the "
          f"{rate:.0f} scheduled (producer lag p50 "
          f"{np.percentile(lag_ms, 50):.2f}ms, max {lag_ms.max():.2f}ms)")
    tier_pct = {}
    for tier, lats in per_tier.items():
        if not lats:
            continue
        pct = tier_pct[tier] = {"n": len(lats), **{
            k: float(v) for k, v in _percentiles(lats).items()}}
        print(f"[fleet]   {tier:<12} n={len(lats):<5} "
              f"p50={pct['p50_ms']:.1f}ms p95={pct['p95_ms']:.1f}ms "
              f"p99={pct['p99_ms']:.1f}ms (from the scheduled arrival)")
    per_worker = {}
    for wid, w in stats["workers"].items():
        snap = w["snapshot"] or {}
        per_worker[wid] = {"profile": w["profile"],
                           "served": snap.get("served", 0),
                           "draining": w["draining"]}
        print(f"[fleet]   {wid:<8} profile={w['profile']:<5} "
              f"served={snap.get('served', 0):<5} "
              f"draining={w['draining']}")
    _ops_finish(tracker, cache=cache)
    res = {"requests": args.requests, **counts,
           "rerouted": stats["rerouted"], "retried": stats["retried"],
           "drains": stats["drains"], "wall_s": wall, "build_s": build_s,
           "step_ms": step_s * 1e3, "offered_per_s": rate,
           "achieved_offered_per_s": achieved,
           "producer_lag_p50_ms": float(np.percentile(lag_ms, 50)),
           "producer_lag_max_ms": float(lag_ms.max()),
           "images_per_s": counts["served"] / wall, "per_tier": tier_pct,
           "per_worker": per_worker,
           "plans": {f"{name}0": list(plan_kernel_entries(plan))
                     for name, plan in plans.items()},
           "cache": cache.stats() if cache is not None else None}
    if keep_every:
        res["outputs"] = sorted(kept, key=lambda t: t[0])
    return fleet, res


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
    ``params``), the served requests and the serving seconds.  Raises
    ``ValueError``, before any weight is drawn, for a config whose
    prefill takes ``frames`` or ``patches``."""
    if cfg.enc_dec or cfg.frontend is not None:
        raise ValueError(
            f"{cfg.name}: the LM Engine prefills tokens alone, as the "
            f"reference's does; its {'frames' if cfg.enc_dec else 'patches'}"
            f" run through Model.prefill and Model.decode_step only")
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
        description="Serve a CNN or quantized-MoE deployment plan or a zoo "
                    "LM through repro_torch.")
    ap.add_argument("--workload", choices=("cnn", "lm", "moe"),
                    default="cnn", help="cnn (the default), lm or moe")
    ap.add_argument("--arch", default=None,
                    help="zoo architecture (lm: any; moe: one with MoE "
                         "blocks; default llama3.2-3b / "
                         "qwen3-moe-30b-a3b)")
    ap.add_argument("--plan", default=None,
                    help="DeploymentPlan JSON artifact to serve (default: "
                         "plan the quickstart CNN, or --arch's experts, "
                         "for --device)")
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
    ap.add_argument("--shard", action="store_true",
                    help="shard each image batch over the host's CUDA "
                         "cards (cnn, sync or --async)")
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
    ap.add_argument("--fleet", action="store_true",
                    help="serve tiered traffic through an edge/v5e/v5p "
                         "fleet front door, one gateway per profile (cnn)")
    ap.add_argument("--router", default="plan_aware",
                    choices=("plan_aware", "least_loaded", "round_robin"),
                    help="fleet routing policy (cnn --fleet)")
    ap.add_argument("--drain", action="store_true",
                    help="gracefully drain the v5e worker halfway "
                         "through the trace (cnn --fleet)")
    ap.add_argument("--seed", type=int, default=1,
                    help="rng seed for the fleet's traffic (cnn --fleet)")
    ap.add_argument("--store-root", default=None, metavar="DIR",
                    help="shared store root (repro_torch.ops.StoreRoot): "
                         "one DIR holding the plan store, the executable "
                         "cache and worker leases (replaces --plan-store "
                         "and --cache-dir)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent executable cache (repro_torch.ops."
                         "PersistentExecutableCache): warm restarts make "
                         "their launches from DIR's records and load the "
                         "kernel libraries under DIR/kernels instead of "
                         "preparing and building (all paths)")
    ap.add_argument("--plan-store", default=None, metavar="DIR",
                    help="durable plan repository (repro_torch.ops."
                         "PlanStore): load the plan from DIR if present, "
                         "else plan once and save it (cnn, moe)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="stream lifecycle events and periodic stats "
                         "snapshots to FILE as JSON lines "
                         "(repro_torch.ops.JsonlTracker; all paths)")
    args = ap.parse_args(argv)
    if args.arch is None:
        args.arch = ("qwen3-moe-30b-a3b" if args.workload == "moe"
                     else "llama3.2-3b")
    if args.params and not args.plan:
        ap.error("--params names weights by the --plan file's stem; "
                 "pass --plan with it")
    if args.workload == "moe" and (args.params or args.fleet):
        ap.error("--workload moe serves a seeded weight draw from one "
                 "gateway or engine; drop --params and --fleet")
    if args.store_root and (args.plan_store or args.cache_dir):
        ap.error("--store-root replaces --plan-store and --cache-dir; "
                 "give one or the other")
    if args.shard and (args.workload != "cnn" or args.fleet
                       or args.torch_device != "cuda"):
        ap.error("--shard shards CNN batches over the CUDA cards, sync or "
                 "--async; drop --fleet, --workload and --torch-device")
    if args.fleet and (args.plan or args.async_):
        ap.error("--fleet plans each worker's profile itself and serves "
                 "through gateways; drop --plan and --async")
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    _apply_store_root(args)
    if args.workload == "lm":
        run_lm(args)
    elif args.workload == "moe":
        run_moe_async(args) if args.async_ else run_moe(args)
    elif args.fleet:
        run_cnn_fleet(args)
    elif args.async_:
        run_cnn_async(args)
    else:
        run_cnn(args)


if __name__ == "__main__":
    main()
