"""Multi-pod dry run: trace every (arch × shape × mesh) cell on one host.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for 512 placeholder host devices; here a ``fake`` process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``, set up
before any other group) backs the production meshes — 16×16 (one pod)
and 2×16×16 (two pods) — and rank 0's view of the step is traced once on
``meta`` tensors, which allocate nothing.

Per cell:
  1. builds the model's ``init_abstract`` params and ``input_specs``
     inputs on ``meta``,
  2. places them by ``parallel.sharding.ShardingRules`` as DTensors
     (each device's shard, on ``meta``),
  3. runs the right step once — ``make_train_step``, prefill or decode —
     under ``core.hloscan.analyze_step``: a placement DTensor cannot
     propagate, or an unsupported operator, fails the cell,
  4. records memory / cost / per-class collective wire bytes into a JSON
     file with the reference's keys, which ``core.roofline`` and
     ``core.model_dse`` read (either package's corpus).

A ``trace_s`` field stands where the reference records ``lower_s`` and
``compile_s``: there is no compile.  ``--save-hlo`` writes the operator
trace (one record per counted operator, gzipped JSON) in place of HLO
text.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b \\
      --shape train_4k --mesh single --out results/
  python -m repro_torch.launch.dryrun --all --mesh both --out results/
"""

from __future__ import annotations

import argparse
import gzip
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import (SHAPES, cell_is_runnable, get_config,
                                 list_archs)
from repro_torch.core import hloscan
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import (ShardingRules, choose_mode,
                                           place_tree)
from repro_torch.train.step import make_serve_steps, make_train_step


def init_fake_group(world: int) -> None:
    """Join a ``fake`` process group of ``world`` ranks as rank 0 (no
    communication happens; collectives return at once).  Must come
    before any other group; a ``fake`` group of that size already set up
    is kept."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"dryrun: a {dist.get_backend()} group of "
                f"{dist.get_world_size()} ranks is already set up; the dry "
                f"run needs a fake group of {world}, set up before any other")
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:       # an internal module of torch
        raise RuntimeError(
            "dryrun: torch.testing._internal.distributed.fake_pg is "
            "missing from this torch build; the dry run needs its fake "
            "process group") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    init_fake_group(n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               mode: str = "auto", opt_dtype: str = "float32",
               microbatches: int = 1, collect_hlo: bool = True,
               save_hlo_path=None, cfg_overrides=None, mesh_shape=None):
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.with_overrides(**cfg_overrides)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    # per-arch logical remapping of the same physical chips: the topology
    # is fixed, the (data, model) factorization is not
    axes = (("pod", "data", "model") if len(mesh_shape) == 3
            else ("data", "model"))
    mesh = _mesh(mesh_shape, axes)
    model = build_model(cfg, "meta")
    if mode == "auto":
        mode = choose_mode(cfg, mesh)
    rules = ShardingRules(cfg, mesh, mode=mode)

    specs = model.input_specs(shape)
    params_abs = model.init_abstract()
    p_spec = rules.params_spec(params_abs)
    params = place_tree(params_abs, p_spec, mesh)

    t0 = time.time()
    keep = save_hlo_path is not None
    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=opt_dtype)
        opt_abs = adamw_init(params_abs, opt_cfg)
        opt = place_tree(opt_abs, rules.opt_spec(opt_abs, p_spec), mesh)
        batch = place_tree(specs["batch"], rules.batch_spec(specs["batch"]),
                           mesh)
        step = make_train_step(model, opt_cfg, microbatches=microbatches)
        res = hloscan.analyze_step(step, params, opt, batch, keep_trace=keep)
    elif shape.kind == "prefill":
        batch = place_tree(specs["batch"], rules.batch_spec(specs["batch"]),
                           mesh)
        prefill, _ = make_serve_steps(model)
        res = hloscan.analyze_step(prefill, params, batch, keep_trace=keep)
    else:  # decode
        cache = place_tree(specs["cache"], rules.cache_spec(specs["cache"]),
                           mesh)
        token = place_tree({"token": specs["token"]},
                           rules.batch_spec({"token": specs["token"]}),
                           mesh)["token"]
        _, decode = make_serve_steps(model)
        res = hloscan.analyze_step(decode, params, cache, token, 0,
                                   keep_trace=keep)
    t_trace = time.time() - t0

    mem = hloscan.memory_summary(res)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "mode": mode, "opt_dtype": opt_dtype,
        "microbatches": microbatches,
        "n_chips": mesh.size(),
        "trace_s": round(t_trace, 1),
        "memory": mem, "cost": hloscan.cost_summary(res),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if collect_hlo:
        result["hlo"] = {k: v for k, v in res.items()
                         if k not in ("memory", "trace", "collective_ops")}
        result["collectives"] = hloscan.collective_bytes(
            res["collective_ops"])
    if keep:
        with gzip.open(save_hlo_path, "wt") as fh:
            json.dump(res["trace"], fh)
    print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
          f"(mode={mode}, trace {t_trace:.1f}s, "
          f"temp/dev {mem.get('temp_size_in_bytes', 0) / 2**30:.2f} GiB, "
          f"args/dev {mem.get('argument_size_in_bytes', 0) / 2**30:.2f} GiB)")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "tp", "fsdp"])
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "int8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="results")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's operator trace (gzipped JSON)")
    ap.add_argument("--attn-batch-shard", action="store_true",
                    help="§Perf: shard attention batch over (data, model)")
    ap.add_argument("--attn-bf16-logits", action="store_true",
                    help="§Perf: bf16 attention logits/probs")
    args = ap.parse_args(argv)
    overrides = {}
    if args.attn_batch_shard:
        overrides["attn_batch_shard"] = True
    if args.attn_bf16_logits:
        overrides["attn_logits_bf16"] = True

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    archs = [a for a in archs if a != "paper-conv-sweep"]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    # one fake group per process: a process traces the cells of one mesh
    # size, so "both" runs the multi-pod cells in a fresh process
    if len(meshes) > 1:
        import subprocess
        import sys
        rc = 0
        for mesh_name in ("single", "multi"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--mesh", mesh_name] + _passthrough(argv)
            rc |= subprocess.run(cmd, check=False).returncode
        return rc

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                fname = outdir / (f"{args.tag}__{arch}__{shape}__"
                                  f"{mesh_name}.json")
                if fname.exists():
                    print(f"[dryrun] {fname.name} exists, skipping")
                    continue
                try:
                    hlo_path = (outdir / (fname.stem + ".trace.json.gz")
                                if args.save_hlo else None)
                    result = lower_cell(arch, shape, multi_pod=mp,
                                        mode=args.mode,
                                        opt_dtype=args.opt_dtype,
                                        microbatches=args.microbatches,
                                        save_hlo_path=hlo_path,
                                        cfg_overrides=overrides or None)
                except Exception as e:    # noqa: BLE001 — a failed cell
                    n_fail += 1
                    result = {"arch": arch, "shape": shape,
                              "mesh": mesh_name, "status": "error",
                              "error": str(e),
                              "traceback": traceback.format_exc()[-4000:]}
                    print(f"[dryrun] {arch} × {shape} × {mesh_name}: "
                          f"FAIL — {type(e).__name__}: {str(e)[:200]}")
                fname.write_text(json.dumps(result, indent=1))
    print(f"[dryrun] done; {n_fail} failures")
    return 1 if n_fail else 0


def _passthrough(argv):
    """The command line without its ``--mesh`` option."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--mesh":
            skip = True
            continue
        if a.startswith("--mesh="):
            continue
        out.append(a)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
