"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
numpy-made operands handed to both packages, a narrow network built in
either package, the layer-by-layer trace of a bucketed MoE dispatch,
and the ``cuda`` fixture that skips a
card test where there is no card (decided inside the test, never at
import, so every xdist worker collects the same tests)."""

import numpy as np
import pytest
import torch


def np_container(bits):
    return np.int8 if bits <= 8 else np.int16


def operands(rng, shape, oc, d, c, *, x_range=None):
    """numpy x ``shape`` = (N, H, W, ic) over the signed d-bit range (or
    ``x_range``, then in an int16 container) and w (oc, ic, 3, 3) over
    the signed c-bit range, with both extremes forced in."""
    lo, hi = x_range or (-(1 << (d - 1)), (1 << (d - 1)) - 1)
    x = rng.integers(lo, hi + 1, shape)
    x.reshape(-1)[:2] = (lo, hi)
    wlo, whi = -(1 << (c - 1)), (1 << (c - 1)) - 1
    w = rng.integers(wlo, whi + 1, (oc, shape[-1], 3, 3))
    w.reshape(-1)[:2] = (wlo, whi)
    xdt = np.int16 if x_range else np_container(d)
    return x.astype(xdt), w.astype(np_container(c))


def narrow_config(module):
    """A narrow three-layer net that runs all three layer kernels:
    conv4 → fused dot, conv1 → shift-add, conv3 at d6c4 → packed dot."""
    return module.CNNConfig(layers=(
        module.ConvLayerSpec(1, 4, data_bits=8, coeff_bits=6, block="conv4"),
        module.ConvLayerSpec(4, 3, data_bits=8, coeff_bits=6, shift=6,
                             block="conv1"),
        module.ConvLayerSpec(3, 3, data_bits=6, coeff_bits=4, shift=5,
                             block="conv3"),
    ), img_h=16, img_w=24)


def dispatch_trace(compiled, xb, to_backend, to_numpy):
    """The activations of one bucketed dispatch of ``xb`` (n ≤ max_batch
    numpy requests) through either package's ``CompiledModel``, layer
    by layer with its own prepared (layer, bucket) executables: ``[x,
    after layer 0, ..., output]``, each (n, ...) as numpy."""
    n = xb.shape[0]
    bucket = compiled.bucket_for(n)
    act = to_backend(np.concatenate(
        [xb, np.zeros((bucket - n,) + xb.shape[1:], xb.dtype)]))
    acts = [np.asarray(xb)]
    for i in range(compiled.num_layers):
        act = compiled._compile_layer(i, bucket)(compiled._layer_params(i),
                                                 act)
        acts.append(to_numpy(act)[:n])
    return acts


@pytest.fixture
def cuda():
    """The card, for tests marked ``cuda``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# multi-rank runs: each rank a child process (a process group is
# process-global, and the suite runs under xdist), joined by a FileStore
# under the test's tmp_path; ``python tests/torch_parity.py WORKER RANK
# WORLD DIR BACKEND`` is one rank.  A worker takes (rank, world, dir) and
# returns a dict that ``torch.save`` can write; ``run_ranks`` returns the
# ranks' dicts.
# ---------------------------------------------------------------------------

WORKERS = {}


def worker(fn):
    WORKERS[fn.__name__] = fn
    return fn


def run_ranks(name, world, tmp_path, *, backend="gloo", timeout=120):
    """Run worker ``name`` on ``world`` ranks (``backend`` "gloo"), or
    in one process that joins a ``fake`` group of ``world`` ranks
    (``backend`` "fake"); fails with the ranks' output if one fails."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    n_proc = 1 if backend == "fake" else world
    procs = [subprocess.Popen(
        [sys.executable, __file__, name, str(r), str(world), str(tmp_path),
         backend], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n_proc)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    bad = [(r, o) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode]
    assert not bad, "\n".join(f"rank {r}:\n{o[-4000:]}" for r, o in bad)
    return [torch.load(Path(tmp_path) / f"out{r}.pt") for r in range(n_proc)]


def _rank_main(argv):
    import torch.distributed as dist
    from pathlib import Path
    name, rank, world, tmp, backend = argv
    rank, world, tmp = int(rank), int(world), Path(tmp)
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    else:
        store = dist.FileStore(str(tmp / "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
    try:
        out = _to_cpu(WORKERS[name](rank, world, tmp))
    finally:
        dist.destroy_process_group()
    torch.save(out, tmp / f"out{rank}.pt")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _device():
    """Each rank's device: its card under NCCL, else the CPU."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _np_params(tmp, cfg):
    """The port's parameters of ``cfg`` on the rank's device from
    ``params.npz`` under ``tmp`` (the reference's flattened parameter
    tree)."""
    from repro_torch.convert import lm_params_from_numpy, nested_from_flat
    z = np.load(tmp / "params.npz")
    return lm_params_from_numpy(nested_from_flat(dict(z), "p"), cfg,
                                device=_device())


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _full(tree):
    """Every DTensor of ``tree`` gathered whole."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def _cfg(tmp):
    import dataclasses
    import json
    from repro_torch.configs import smoke_config
    spec = json.loads((tmp / "cfg.json").read_text())
    cfg = smoke_config(spec["arch"]).with_overrides(**spec["overrides"])
    if "capacity_factor" in spec:
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=spec["capacity_factor"]))
    return cfg


@worker
def sharded_train_step(rank, world, tmp):
    """One ``make_train_step`` step on a (2, 2) mesh, placed in the
    mode ``cfg.json`` names (tp by default), from the same state as one
    unsharded step: both losses and parameters."""
    import json
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import ShardingRules, place_tree
    from repro_torch.train.step import (loss_and_grads, make_train_step,
                                        mesh_scope)
    from repro_torch.kernels.build import LAUNCHES
    cfg = _cfg(tmp)
    mode = json.loads((tmp / "cfg.json").read_text()).get("mode", "tp")
    model = build_model(cfg, _device())
    params = _np_params(tmp, cfg)
    opt_cfg = AdamWConfig()
    batch = {k: torch.as_tensor(v, device=_device()) for k, v in batch_at(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8),
        0).items()}
    step = make_train_step(model, opt_cfg)
    grads = loss_and_grads(model, params, batch)[2]
    ref_p, _, ref_m = step(_clone(params), adamw_init(params, opt_cfg),
                           batch)
    mesh = make_host_mesh(model=min(2, world))
    rules = ShardingRules(cfg, mesh, mode=mode)
    p_spec = rules.params_spec(params)
    opt = adamw_init(params, opt_cfg)
    dp = place_tree(_clone(params), p_spec, mesh)
    do = place_tree(opt, rules.opt_spec(opt, p_spec), mesh)
    db = place_tree(batch, rules.batch_spec(batch), mesh)
    with mesh_scope(dp):
        sh_grads = loss_and_grads(model, dp, db)[2]
    k8 = LAUNCHES["flash_attention"]
    sh_p, _, sh_m = step(dp, do, db)
    k8 = LAUNCHES["flash_attention"] - k8
    return {"loss": float(ref_m["loss"]),
            "loss_sharded": float(sh_m["loss"].full_tensor()),
            "nll_sharded": float(sh_m["nll"].full_tensor()),
            "params": ref_p, "params_sharded": _full(sh_p),
            "initial": params, "grads": grads,
            "grads_sharded": _full(sh_grads), "k8_launches": k8}


@worker
def sharded_serve(rank, world, tmp):
    """Prefill and four decode steps on a (2, 2) mesh against the same
    calls unsharded: the logits of both."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import ShardingRules, place_tree
    from repro_torch.train.step import make_serve_steps
    cfg = _cfg(tmp)
    model = build_model(cfg, _device())
    params = _np_params(tmp, cfg)
    tokens = torch.as_tensor(np.load(tmp / "tokens.npy"), device=_device())
    prefill, decode = make_serve_steps(model)
    mesh = make_host_mesh(model=min(2, world))
    rules = ShardingRules(cfg, mesh, mode="tp")
    dp = place_tree(params, rules.params_spec(params), mesh)
    out = {"prefill": prefill(params, {"tokens": tokens})[0],
           "prefill_sharded": _full(prefill(
               dp, place_tree({"tokens": tokens},
                              rules.batch_spec({"tokens": tokens}),
                              mesh))[0])}
    b = tokens.shape[0]
    cache = model.init_cache(b, 8)
    dcache = place_tree(model.init_cache(b, 8),
                        rules.cache_spec(model.init_cache(b, 8)), mesh)
    for pos in range(4):
        tok = tokens[:, pos:pos + 1]
        out[f"decode{pos}"], cache = decode(params, cache, tok, pos)
        dtok = place_tree({"t": tok}, rules.batch_spec({"t": tok}),
                          mesh)["t"]
        logits, dcache = decode(dp, dcache, dtok, pos)
        out[f"decode{pos}_sharded"] = _full(logits)
    return out


@worker
def moe_shardmap(rank, world, tmp):
    """The grouped MoE layer with the shard_map dispatch and combine and
    the hints on a (2, 2) mesh, and without a mesh: outputs and the
    gradients of out.sum()."""
    from repro_torch.convert import nested_from_flat
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import P, place
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _cfg(tmp)
    z = dict(np.load(tmp / "moe.npz"))
    x = torch.as_tensor(z.pop("x"), device=_device())
    p = {k: torch.as_tensor(v, device=_device())
         for k, v in nested_from_flat(z, "p").items()}

    def run(p_, x_):
        p_ = {k: v.detach().requires_grad_() for k, v in p_.items()}
        out, _ = moe_mod.moe_layer(p_, x_, cfg)
        grads = torch.autograd.grad(out.sum(), list(p_.values()))
        return out, dict(zip(p_, grads))

    mesh = make_host_mesh(model=min(2, world))
    specs = {"router": P(None, None)}
    dp = {k: place(v, mesh, specs.get(k, P("model", None, None)))
          for k, v in p.items()}
    with implicit_replication():
        out_sh, g_sh = run(dp, place(x, mesh, P("data", None, None)))
    out, g = run(p, x)
    return {"out": out.detach(), "grads": g,
            "out_sharded": _full(out_sh).detach(),
            "grads_sharded": _full(g_sh)}


@worker
def pipeline(rank, world, tmp):
    """``pipeline_forward`` of tanh(x @ w) stages over a ("pipe",) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import pipeline_forward
    z = np.load(tmp / "pipe.npz")
    mesh = init_device_mesh(_device().type, (world,),
                            mesh_dim_names=("pipe",))
    out = pipeline_forward(lambda w, x: torch.tanh(x @ w),
                           torch.as_tensor(z["w"], device=_device()),
                           torch.as_tensor(z["x"], device=_device()),
                           mesh=mesh, axis="pipe")
    return {"out": out}


@worker
def analysis_mlp(rank, world, tmp):
    """``analyze_step`` of a column- then row-parallel MLP pair on a
    fake (4, 2) mesh, on ``meta``: one device's view."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core import hloscan
    from repro_torch.parallel.sharding import P, place
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    x = place(torch.empty(64, 128, device="meta"), mesh, P("data", None))
    w1 = place(torch.empty(128, 256, device="meta"), mesh, P(None, "model"))
    w2 = place(torch.empty(256, 128, device="meta"), mesh, P("model", None))

    def mlp(x, w1, w2):
        y = torch.relu(x @ w1) @ w2
        return y.redistribute(placements=[Shard(0), Replicate()])

    res = hloscan.analyze_step(mlp, x, w1, w2)
    res.pop("collective_ops")
    return res


@worker
def dryrun_cells(rank, world, tmp):
    """``lower_cell`` on smoke cells of every kind (the smoke configs at
    reduced shapes under the cells' names): an attention-and-MoE and an
    SSM model over a fake (4, 2) mesh, the first over (2, 2, 2); each
    record written as the dry run writes it."""
    import dataclasses
    import json
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch import dryrun
    small = {"train_4k": (32, 8), "prefill_32k": (64, 4),
             "decode_32k": (64, 8)}
    for name, (seq, batch) in small.items():
        SHAPES[name] = dataclasses.replace(SHAPES[name], seq_len=seq,
                                           global_batch=batch)
    out = {}
    for mesh_shape, archs in (((4, 2), ("qwen3-moe-30b-a3b", "mamba2-1.3b")),
                              ((2, 2, 2), ("qwen3-moe-30b-a3b",))):
        for arch in archs:
            smoke = smoke_config(arch)
            over = {f.name: getattr(smoke, f.name)
                    for f in dataclasses.fields(smoke)}
            for shape in small:
                rec = dryrun.lower_cell(arch, shape,
                                        multi_pod=len(mesh_shape) == 3,
                                        mesh_shape=mesh_shape,
                                        cfg_overrides=over)
                tag = "x".join(map(str, mesh_shape))
                (tmp / f"{tag}__{arch}__{shape}__{rec['mesh']}.json") \
                    .write_text(json.dumps(rec))
                out[(tag, arch, shape)] = rec["status"]
    return out



@worker
def suite(rank, world, tmp):
    """Every case directory under ``tmp`` in one group of ranks, in name
    order, each run by the worker its ``case.json`` names; a case that
    raises returns its traceback under ``error``, which its test
    reports."""
    import json
    import traceback
    out = {}
    for case in sorted(d for d in tmp.iterdir() if d.is_dir()):
        name = json.loads((case / "case.json").read_text())["worker"]
        try:
            out[case.name] = WORKERS[name](rank, world, case)
        except Exception:              # noqa: BLE001 — its test fails
            out[case.name] = {"error": traceback.format_exc()}
    return out


@worker
def full_width_train_step(rank, world, tmp):
    """Llama-3.2-3B at full width and depth, bf16, weights from one seed
    on every rank: one unsharded step on the rank's card (its result
    kept on the host), then one step on a (world/2, 2) mesh from the
    same state.  Returns both losses and the worst relative L2 among the
    randomly initialized leaves, and apart among the zero-initialized
    ones (the norms)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import ShardingRules, place_tree
    from repro_torch.train.step import make_train_step
    cfg = get_config("llama3.2-3b")
    dev = _device()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_at(
        DataConfig(cfg.vocab_size, 2048, 2), 0).items()}
    opt = AdamWConfig()
    step = make_train_step(model, opt)
    # a zero-initialized leaf's first AdamW update is ±lr wherever its
    # gradient is near eps, so its sign follows the summation order
    random_init = {k for k, v in tree.flatten(params).items()
                   if float(v.abs().max()) > 0}
    ref = _clone(params)
    ref, _, m = step(ref, adamw_init(ref, opt), batch)
    ref_loss = float(m["loss"])
    ref_host = {k: v.cpu() for k, v in tree.flatten(ref).items()}
    del ref
    torch.cuda.empty_cache()
    mesh = make_host_mesh(model=2)
    rules = ShardingRules(cfg, mesh, mode="tp")
    dp = place_tree(params, rules.params_spec(params), mesh)
    del params
    db = place_tree(batch, rules.batch_spec(batch), mesh)
    dp, _, m = step(dp, adamw_init(dp, opt), db)
    got = tree.flatten(_full(dp))
    errs = {k: float((got[k].cpu().float() - v.float()).norm()
                     / v.float().norm()) for k, v in ref_host.items()}
    worst = max((e, k) for k, e in errs.items() if k in random_init)
    worst_zero = max((e, k) for k, e in errs.items() if k not in random_init)
    return {"loss": ref_loss, "loss_sharded": float(m["loss"].full_tensor()),
            "worst_rel_l2": worst[0], "worst_leaf": worst[1],
            "worst_zero_init_rel_l2": worst_zero[0],
            "worst_zero_init_leaf": worst_zero[1]}


if __name__ == "__main__":
    import sys
    _rank_main(sys.argv[1:])
