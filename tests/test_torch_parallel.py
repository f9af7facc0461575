"""The port's multi-device layer on the CPU, held against the JAX
reference: sharded train and serve steps on DTensor trees placed by
``parallel.sharding.ShardingRules``, the MoE shard_map halves and the
pipeline schedule (CNN data parallelism, ``--shard``, is in
``test_torch_sharding.py``).

The multi-rank cases run in one group of four gloo ranks, each a child
process joined by a ``FileStore`` under a tmp directory
(``torch_parity.run_ranks``; the ``suite`` fixture spawns it once for
the file): a process group is process-global and the suite runs under
xdist.  The
reference's own multi-device tests fail under jax 0.9 (explicit-axis
meshes), so the sharded port is held to the reference's single-device
values — the invariant those tests assert: sharded equals unsharded.

Tolerances: a sharded train step's loss within 1e-3 of the reference's
single-device loss and within 1e-5 of the port's unsharded step, each
every gradient leaf within relative L2 1e-4 (``test_torch_train``'s
float32 gradient bound: an fsdp step sums the devices' partial
gradients in another order), and each parameter leaf after it within
relative L2 1e-5 in tp mode (``test_torch_train``'s bound for a step),
1e-4 in fsdp mode (AdamW's first update is about ±lr wherever a
gradient is near its eps, so the summation order shows there); sharded
serve logits within 1e-5 of unsharded; the MoE shard_map path within
5e-3 of the reference's dense oracle (the bound of the reference's own
test) and within one bf16 unit of the largest value of the port's
no-mesh path, gradients included (its combine sums bf16 partials, as
the reference's psum does); the pipeline within 1e-5 of the stages run
in turn."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.data import DataConfig as RefDataConfig
from repro.data.pipeline import batch_at as ref_batch_at
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.parallel.pipeline import bubble_fraction
from tests.torch_parity import run_ranks


def _flat(tree):
    return {"p/" + "/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _setup(tmp_path, arch, overrides, mode="tp"):
    """Float32 smoke params of ``arch`` drawn by the reference, written
    for the ranks; returns the reference's (cfg, model, params)."""
    cfg = ref_smoke_config(arch).with_overrides(dtype="float32",
                                                **overrides)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    np.savez(tmp_path / "params.npz", **_flat(params))
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"arch": arch, "mode": mode,
         "overrides": {"dtype": "float32", **overrides}}))
    return cfg, model, params


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9


# Llama's tied embedding with a vocab the model axis divides: the
# vocab-parallel lookup
SHARDED_ARCHS = [("qwen3-moe-30b-a3b", {}), ("mamba2-1.3b", {}),
                 ("llama3.2-3b", {"vocab_size": 504})]
# the parameters after a step, relative L2 per leaf: an fsdp step's
# gradients differ in summation order (within 1e-4), and AdamW's first
# update turns that into ±lr wherever a gradient is near its eps
STEP_REL_L2 = {"tp": 1e-5, "fsdp": 1e-4}
# and an fsdp placement (weights gathered per cycle) of the hybrid
TRAIN_CASES = [(a, o, "tp") for a, o in SHARDED_ARCHS] + [
    ("jamba-1.5-large-398b", {}, "fsdp")]


def _case(root, name, worker):
    d = root / name
    d.mkdir()
    (d / "case.json").write_text(json.dumps({"worker": worker}))
    return d


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """Every multi-rank case of this file run by one group of four gloo
    ranks (each a child process: one spawn for the file), with the
    reference's values computed here.  Returns ({case: reference
    values}, [{case: output} per rank])."""
    root = tmp_path_factory.mktemp("ranks")
    refs = {}
    for arch, overrides, mode in TRAIN_CASES:
        d = _case(root, f"train-{arch}-{mode}", "sharded_train_step")
        cfg, model, params = _setup(d, arch, overrides, mode)
        opt_cfg = RefAdamWConfig()
        batch = ref_batch_at(RefDataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=32, global_batch=8), 0)
        refs[d.name] = jax.jit(ref_make_train_step(model, opt_cfg))(
            params, ref_adamw_init(params, opt_cfg), batch)[2]
    for arch, overrides in SHARDED_ARCHS[1:]:
        d = _case(root, f"serve-{arch}", "sharded_serve")
        cfg, _, _ = _setup(d, arch, overrides)
        np.save(d / "tokens.npy", np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 12)).astype(np.int64))

    d = _case(root, "moe", "moe_shardmap")
    cfg = ref_smoke_config("qwen3-moe-30b-a3b").with_overrides(
        dtype="float32")
    over = dict(moe_groups=4, moe_combine_shardmap=True,
                moe_shard_hints=True)
    cfg = cfg.with_overrides(
        moe=dataclasses.replace(cfg.moe, capacity_factor=8.0), **over)
    p = ref_moe.init_moe(jax.random.PRNGKey(0), cfg)
    x = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
    np.savez(d / "moe.npz", x=np.asarray(x),
             **{f"p/{k}": np.asarray(v) for k, v in p.items()})
    (d / "cfg.json").write_text(json.dumps(
        {"arch": "qwen3-moe-30b-a3b", "capacity_factor": 8.0,
         "overrides": {"dtype": "float32", **over}}))
    refs["moe"] = np.asarray(ref_moe.moe_layer_dense_ref(p, x, cfg))

    d = _case(root, "pipe", "pipeline")
    s, m, mb, dim = 4, 8, 2, 16
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(s, dim, dim)) / np.sqrt(dim)).astype(np.float32)
    xs = rng.normal(size=(m, mb, dim)).astype(np.float32)
    np.savez(d / "pipe.npz", w=w, x=xs)
    ref = jnp.asarray(xs)
    for i in range(s):
        ref = jnp.tanh(ref @ jnp.asarray(w[i]))
    refs["pipe"] = np.asarray(ref)
    return refs, run_ranks("suite", 4, root, timeout=300)


def _outs(suite, case):
    """The ranks' outputs of ``case``; a rank's error fails the test."""
    outs = [rank[case] for rank in suite[1]]
    for out in outs:
        assert "error" not in out, out.get("error")
    return outs


@pytest.mark.parametrize("arch,overrides,mode", TRAIN_CASES,
                         ids=[f"{a}-{m}" for a, _, m in TRAIN_CASES])
def test_sharded_train_step(suite, arch, overrides, mode):
    """A float32 smoke model on a (2, 2) mesh: one sharded step's loss
    against the reference's single-device step and the port's unsharded
    step, its gradients, and every parameter after it."""
    from repro_torch import tree
    case = f"train-{arch}-{mode}"
    ref_m = suite[0][case]
    for out in _outs(suite, case):
        assert abs(out["nll_sharded"] - float(ref_m["nll"])) < 1e-3
        # Jamba's loss adds every MoE MLP's aux, the reference's scan
        # only each cycle's last (test_torch_train): its nll is held
        if not arch.startswith("jamba"):
            assert abs(out["loss_sharded"] - float(ref_m["loss"])) < 1e-3, \
                (out["loss_sharded"], float(ref_m["loss"]))
        assert abs(out["loss_sharded"] - out["loss"]) < 1e-5
        g_want = tree.flatten(out["grads"])
        g_got = tree.flatten(out["grads_sharded"])
        assert set(g_got) == set(g_want)
        for k in g_want:
            assert _rel_l2(g_got[k].numpy(), g_want[k].numpy()) < 1e-4, k
        want = tree.flatten(out["params"])
        got = tree.flatten(out["params_sharded"])
        initial = tree.flatten(out["initial"])
        for k in want:
            # a zero-initialized leaf's first update is ±lr wherever its
            # gradient is near AdamW's eps: its gradient is held above
            if float(initial[k].abs().max()) > 0:
                assert _rel_l2(got[k].numpy(), want[k].numpy()) < \
                    STEP_REL_L2[mode], k


@pytest.mark.parametrize("arch", [a for a, _ in SHARDED_ARCHS[1:]])
def test_sharded_serve(suite, arch):
    """Sharded prefill and four decode steps on a (2, 2) mesh: logits
    within 1e-5 of the unsharded calls (K8 and the chunked attention,
    K7 and the SSD under ``local_map``)."""
    out = _outs(suite, f"serve-{arch}")[0]
    for key in ["prefill"] + [f"decode{i}" for i in range(4)]:
        torch.testing.assert_close(out[key + "_sharded"], out[key],
                                   rtol=1e-5, atol=1e-5, msg=key)


def test_moe_shardmap_multidevice(suite):
    """The shard_map dispatch/combine with the hints (groups over data,
    experts over model) on (2, 2): within 5e-3 of the reference's dense
    oracle, within a bf16 unit of the port's no-mesh path, and
    gradients that are non-zero and within a bf16 unit of the no-mesh
    ones."""
    out = _outs(suite, "moe")[0]
    got = out["out_sharded"].numpy()
    assert float(np.max(np.abs(got - suite[0]["moe"]))) < 5e-3
    # the combine's all_reduce sums bf16 partials (the reference's psum
    # in bf16): one bf16 unit of the largest value, where the no-mesh
    # path sums in float32
    _within_bf16_unit(out["out_sharded"], out["out"], "out")
    for k, g in out["grads"].items():
        assert float(out["grads_sharded"][k].abs().sum()) > 0, k
        _within_bf16_unit(out["grads_sharded"][k], g, k)


def _within_bf16_unit(got, want, what):
    err = float((got - want).abs().max())
    assert err <= 2.0 ** -8 * float(want.abs().max()), (what, err)


def test_pipeline_matches_sequential(suite):
    """S = 4 stages, M = 8 microbatches on four ranks: within 1e-5 of
    the stages run in turn, computed by JAX from the same numpy
    weights."""
    for out in _outs(suite, "pipe"):
        assert float(np.max(np.abs(out["out"].numpy() - suite[0]["pipe"]))) \
            < 1e-5
