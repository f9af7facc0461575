"""Provenance of the port's committed plans and golden outputs.

``src/repro_torch/plans/`` holds two plans of the quickstart CNN, both
written by the reference's planner (``deploy.plan_deployment(...,
allocate.get_device("v5e"), target=0.8, on_infeasible="fallback")``):

* ``quickstart_v5e.json``             — the unpinned plan;
* ``quickstart_v5e_conv1_conv3.json`` — layer 1 pinned to conv1 and
  layer 2 to conv3, so the serving path runs all three layer kernels
  (conv4 → fused dot, conv1 → shift-add, conv3 at d6c4 → packed dot).

``src/repro_torch/golden/quickstart_reference.npz`` holds, per plan, the
reference runtime's weights (``init_cnn(PRNGKey(0), cfg)``), the 8
images of ``CompiledCNN.sample_inputs(8, seed=0)`` and the reference
``CompiledCNN``'s outputs for them; and, under ``apply.<block>.d<d>c<c>``,
the reference's ``ConvBlock.apply`` (Pallas, interpret mode) of each
block on one numpy-made 32×128 plane at the ``APPLY_POINTS`` (inputs
``.x``, ``.w``, output ``.y``).

``src/repro_torch/golden/synth_reference.json`` holds the reference's
full ``SWEEP`` rows (784, its jaxpr census): the port's planner
arithmetic is held to the reference's by feeding it these rows.

``src/repro_torch/golden/lm_reference.npz`` holds, per arch of
``LM_ARCHS`` at ``smoke_config`` in float32: the reference's parameters
(``model.init(PRNGKey(0))``, flat under ``<arch>/params/<path>``), a
numpy-made prompt batch ``<arch>/tokens`` (2, 16), the prefill logits
of the whole batch, the logits of three teacher-forced decode steps
(prefill of the first 13 tokens, then tokens 13, 14, 15 at positions
``<arch>/decode_pos``), and the reference ``Engine``'s greedy tokens for
4 numpy-made requests (``<arch>/engine_prompts`` → ``engine_tokens``).

``src/repro_torch/golden/moe_reference.npz`` holds the reference's MoE
plan for ``moe_workload_from_config(smoke_config("qwen3-moe-30b-a3b"))``
on ``v5e`` (target 0.8, fallback; ``plan``, its JSON), the per-layer
parameters of ``CompiledMoE.from_plan``'s default draw (``PRNGKey(0)``,
flat under ``params/L<i>/<name>``), the 8 token blocks of
``sample_inputs(8, seed=0)`` (``x``), and the reference ``CompiledMoE``'s
activations for them at max_batch 4, dispatched as ``MOE_DISPATCHES``
so that buckets 1, 2 and 4 all run: each layer's input (``layer_in``,
(layers, 8, 32, 64)) and the outputs (``y``).

``src/repro_torch/golden/lm_zoo_reference.npz`` holds the same entries
for each arch of ``LM_ZOO_ARCHS`` (Qwen3-MoE, Llama-4-Maverick, Jamba,
Whisper, Pixtral) at ``smoke_config`` in float32, from
``default_rng(2000 + n)``: besides the tokens, the numpy-made modality
input an arch takes (``<arch>/frames`` for Whisper, ``<arch>/patches``
for Pixtral, (2, 8, 64)); decode positions count Pixtral's 8-patch
prefix; ``engine_prompts`` → ``engine_tokens`` for the three MoE archs
only (the reference's ``Engine`` cannot prefill ``frames`` or
``patches``), with request 1's prompt equal to request 0's, so that
both decode in one wave and take MoE capacity from each other (in
Llama-4's top-1, capacity-1 decode the second is dropped).

``src/repro_torch/golden/train_reference.npz`` holds, for each arch of
``TRAIN_ARCHS`` (Llama-3.2-3B, Mamba-2-1.3B, Qwen3-MoE) at
``smoke_config`` in float32: the reference's parameters
(``model.init(PRNGKey(1))``, under ``<arch>/params/<path>``), the batch
``batch_at(DataConfig(vocab, 16, 2), 0)`` (``tokens``, ``labels``),
``forward_train``'s ``loss``, ``nll`` and ``aux``, every gradient leaf
of the loss (``<arch>/grads/<path>``) and their ``grad_norm``, and the
parameters after one ``make_train_step`` step (default lr) with float32
and with int8 AdamW states (``<arch>/step_float32/<path>``,
``<arch>/step_int8/<path>``).

The card is held against the JAX package through these files, without
importing it.  Regenerate all of them (the reference's planner and this
file run the reference's resource sweep, about a minute without its
cache), or only those named (``plans golden synth lm lm_zoo moe
train``):

    PYTHONPATH=src python tests/test_torch_golden.py [lm_zoo ...]
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.blocks import get_block
from repro.configs import smoke_config
from repro.core import allocate, deploy, synth
from repro.core.cnn import fitted_block_models, quickstart_cnn_config
from repro.data.pipeline import DataConfig, batch_at
from repro.models import build_model
from repro.optim import AdamWConfig, adamw_init
from repro.optim.adamw import global_norm
from repro.runtime import (CompiledCNN, CompiledMoE, moe_workload_from_config,
                           plan_moe_deployment)
from repro.serve import Engine, Request, ServeConfig
from repro.train.step import make_train_step
from torch_parity import dispatch_trace

ROOT = Path(__file__).resolve().parents[1]
PLANS = ROOT / "src" / "repro_torch" / "plans"
GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "quickstart_reference.npz"
SYNTH_REFERENCE = ROOT / "src" / "repro_torch" / "golden" \
    / "synth_reference.json"
SYNTH_GOLDEN = ROOT / "tests" / "golden" / "synth_golden.json"
LM_GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "lm_reference.npz"
MOE_GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "moe_reference.npz"
MOE_ARCH, MOE_MAX_BATCH, MOE_REQUESTS = "qwen3-moe-30b-a3b", 4, 8
# (start, stop) of each reference dispatch of the golden blocks: buckets
# 1, 2, then 4 and 1 (five requests chunk into 4 + 1)
MOE_DISPATCHES = ((0, 1), (1, 3), (3, 8))
LM_ARCHS = ("llama3.2-3b", "mamba2-1.3b")
LM_ZOO_GOLDEN = ROOT / "src" / "repro_torch" / "golden" \
    / "lm_zoo_reference.npz"
LM_ZOO_MOE_ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
                    "jamba-1.5-large-398b")
LM_ZOO_ARCHS = LM_ZOO_MOE_ARCHS + ("whisper-medium", "pixtral-12b")
LM_BATCH, LM_SEQ, LM_DECODE_STEPS = 2, 16, 3
TRAIN_GOLDEN = ROOT / "src" / "repro_torch" / "golden" \
    / "train_reference.npz"
TRAIN_ARCHS = ("llama3.2-3b", "mamba2-1.3b", "qwen3-moe-30b-a3b")
TRAIN_STATES = ("float32", "int8")
# the reference Engine's requests: prompts of 8 tokens, 5 new tokens each,
# two slots (the tests/test_serve.py shape)
LM_ENGINE = dict(requests=4, prompt_len=8, max_batch=2, max_len=32,
                 new_tokens=5)

# (block, data_bits, coeff_bits) of the golden ``apply`` outputs: bits 3
# and 16, the 8/9-bit container, and conv3 either side of d+c = 12
APPLY_POINTS = [(b, d, c) for b in ("conv1", "conv2", "conv3", "conv4")
                for d, c in ((3, 3), (6, 6), (8, 6), (9, 8), (16, 16))] \
    + [("conv3", 7, 6)]

# plan file stem → the layer pins it was planned with
PINS = {"quickstart_v5e": {},
        "quickstart_v5e_conv1_conv3": {1: "conv1", 2: "conv3"}}
# the (block, data_bits, coeff_bits) each committed plan assigns
ASSIGNED = {
    "quickstart_v5e": [("conv4", 8, 6), ("conv3", 8, 6), ("conv4", 6, 4)],
    "quickstart_v5e_conv1_conv3": [("conv4", 8, 6), ("conv1", 8, 6),
                                   ("conv3", 6, 4)],
}


def pinned_config(pins):
    cfg = quickstart_cnn_config()
    layers = tuple(dataclasses.replace(s, block=pins.get(i))
                   for i, s in enumerate(cfg.layers))
    return dataclasses.replace(cfg, layers=layers)


def reference_plan(stem):
    """The plan the reference's planner writes for ``stem``."""
    return deploy.plan_deployment(
        pinned_config(PINS[stem]), fitted_block_models(),
        allocate.get_device("v5e"), target=0.8, on_infeasible="fallback")


def apply_operands(block, d, c, h=32, w=128):
    """One plane over the full signed d-bit range and the block's weight
    operand over the full c-bit range, extremes forced in, from a seed
    of the design point."""
    rng = np.random.default_rng(10_000 + 1000 * int(block[-1]) + 17 * d + c)
    x = rng.integers(-(1 << (d - 1)), 1 << (d - 1), (h, w))
    x.reshape(-1)[:2] = (-(1 << (d - 1)), (1 << (d - 1)) - 1)
    wk = rng.integers(-(1 << (c - 1)), 1 << (c - 1),
                      get_block(block).weight_shape(c))
    wk.reshape(-1)[:2] = (-(1 << (c - 1)), (1 << (c - 1)) - 1)
    return (x.astype(np.int8 if d <= 8 else np.int16),
            wk.astype(np.int8 if c <= 8 else np.int16))


def reference_golden(plans):
    """Arrays of the golden npz for ``{stem: plan}`` and the
    ``APPLY_POINTS``, computed by the reference runtime and blocks."""
    arrays = {}
    for block, d, c in APPLY_POINTS:
        x, wk = apply_operands(block, d, c)
        key = f"apply.{block}.d{d}c{c}"
        arrays[f"{key}.x"], arrays[f"{key}.w"] = x, wk
        arrays[f"{key}.y"] = np.asarray(get_block(block).apply(
            jnp.asarray(x), jnp.asarray(wk), data_bits=d, coeff_bits=c))
    for stem, plan in plans.items():
        cnn = CompiledCNN.from_plan(plan, max_batch=8, warmup=False)
        xs = np.stack(cnn.sample_inputs(8, seed=0))
        for i, w in enumerate(cnn.params):
            arrays[f"{stem}.w{i}"] = np.asarray(w)
        arrays[f"{stem}.x"] = xs
        arrays[f"{stem}.y"] = np.asarray(cnn(xs))
    return arrays


def frontend_inputs(cfg):
    """The modality inputs ``cfg``'s prefill takes besides its tokens."""
    return (("frames",) if cfg.enc_dec else ()) \
        + (("patches",) if cfg.frontend == "vision" else ())


def lm_arch_golden(arch, rng, *, engine=True, same_prompts=False):
    """Arrays of one arch's LM golden entries, computed by the reference
    model (and ``Engine`` with ``engine``) at ``smoke_config`` in
    float32 from numpy's ``rng``: parameters, prompts, modality inputs
    (``0.1 * standard_normal``, (LM_BATCH, frontend_len, d_model)),
    prefill and decode logits (decode positions count a vision prefix)
    and greedy tokens (with ``same_prompts``, request 1's prompt is
    request 0's)."""
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    arrays = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        key = "/".join(p.key for p in path)
        arrays[f"{arch}/params/{key}"] = np.asarray(leaf)
    toks = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ)) \
        .astype(np.int32)
    arrays[f"{arch}/tokens"] = toks
    extra = {}
    for name in frontend_inputs(cfg):
        arrays[f"{arch}/{name}"] = (0.1 * rng.standard_normal(
            (LM_BATCH, cfg.frontend_len, cfg.d_model))).astype(np.float32)
        extra[name] = jnp.asarray(arrays[f"{arch}/{name}"])
    n_front = cfg.frontend_len if cfg.frontend == "vision" else 0
    prefill = jax.jit(model.prefill)
    logits, _ = prefill(params, {"tokens": jnp.asarray(toks), **extra})
    arrays[f"{arch}/prefill_logits"] = np.asarray(logits)
    start = LM_SEQ - LM_DECODE_STEPS
    _, cache = prefill(params, {"tokens": jnp.asarray(toks[:, :start]),
                                **extra})
    cache = {key: {name: jnp.pad(leaf, ((0, 0), (0, 0),
                                        (0, LM_DECODE_STEPS), (0, 0),
                                        (0, 0)))
                   if name in ("k", "v") else leaf
                   for name, leaf in entry.items()}
             for key, entry in cache.items()}
    decode = jax.jit(model.decode_step)
    steps = []
    for pos in range(start, LM_SEQ):
        logits, cache = decode(params, cache,
                               jnp.asarray(toks[:, pos:pos + 1]),
                               jnp.int32(n_front + pos))
        steps.append(np.asarray(logits))
    arrays[f"{arch}/decode_pos"] = np.arange(n_front + start,
                                             n_front + LM_SEQ,
                                             dtype=np.int32)
    arrays[f"{arch}/decode_logits"] = np.stack(steps)
    if engine:
        e = LM_ENGINE
        prompts = rng.integers(1, cfg.vocab_size,
                               (e["requests"], e["prompt_len"])) \
            .astype(np.int32)
        if same_prompts:
            prompts[1] = prompts[0]
        reqs = [Request(prompt=[int(t) for t in p], request_id=i)
                for i, p in enumerate(prompts)]
        Engine(model, params, ServeConfig(
            max_batch=e["max_batch"], max_len=e["max_len"],
            max_new_tokens=e["new_tokens"])).run(reqs)
        arrays[f"{arch}/engine_prompts"] = prompts
        arrays[f"{arch}/engine_tokens"] = np.asarray(
            [r.out_tokens for r in reqs], np.int32)
    return arrays


def lm_reference_golden():
    """Arrays of the LM golden npz, computed by the reference model and
    engine at ``smoke_config`` in float32."""
    arrays = {}
    for n, arch in enumerate(LM_ARCHS):
        arrays.update(lm_arch_golden(arch, np.random.default_rng(1000 + n)))
    return arrays


def lm_zoo_reference_golden():
    """Arrays of the LM-zoo golden npz: each of ``LM_ZOO_ARCHS`` as
    ``lm_arch_golden`` makes it, the ``Engine``'s greedy tokens for the
    MoE archs only (the reference's engine prefills tokens alone, so it
    cannot serve Whisper or Pixtral), two of their four prompts equal."""
    arrays = {}
    for n, arch in enumerate(LM_ZOO_ARCHS):
        moe = arch in LM_ZOO_MOE_ARCHS
        arrays.update(lm_arch_golden(arch, np.random.default_rng(2000 + n),
                                     engine=moe, same_prompts=moe))
    return arrays


def _flat_tree(prefix, tree):
    return {f"{prefix}/" + "/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def train_reference_golden():
    """Arrays of the training golden npz, computed by the reference's
    ``forward_train``, ``jax.value_and_grad`` and ``make_train_step`` at
    ``smoke_config`` in float32."""
    arrays = {}
    for arch in TRAIN_ARCHS:
        cfg = smoke_config(arch).with_overrides(dtype="float32")
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(1))
        batch = batch_at(DataConfig(cfg.vocab_size, LM_SEQ, LM_BATCH), 0)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            model.forward_train, has_aux=True))(params, jbatch)
        arrays.update(_flat_tree(f"{arch}/params", params))
        arrays[f"{arch}/tokens"] = batch["tokens"]
        arrays[f"{arch}/labels"] = batch["labels"]
        arrays[f"{arch}/loss"] = np.asarray(loss)
        for k in ("nll", "aux"):
            arrays[f"{arch}/{k}"] = np.asarray(metrics[k])
        arrays[f"{arch}/grad_norm"] = np.asarray(global_norm(grads))
        arrays.update(_flat_tree(f"{arch}/grads", grads))
        for state in TRAIN_STATES:
            opt = AdamWConfig(state_dtype=state)
            step = jax.jit(make_train_step(model, opt))
            new_params, _, _ = step(params, adamw_init(params, opt), jbatch)
            arrays.update(_flat_tree(f"{arch}/step_{state}", new_params))
    return arrays


def moe_reference_plan():
    """The reference planner's plan of the smoke Qwen3-MoE experts."""
    return plan_moe_deployment(
        moe_workload_from_config(smoke_config(MOE_ARCH)), "v5e",
        target=0.8, on_infeasible="fallback")


def moe_reference_golden():
    """Arrays of the MoE golden npz, computed by the reference's planner
    and ``CompiledMoE``."""
    plan = moe_reference_plan()
    compiled = CompiledMoE.from_plan(plan, max_batch=MOE_MAX_BATCH)
    arrays = {"plan": np.array(plan.to_json())}
    for i, p in enumerate(compiled.params):
        for name, leaf in p.items():
            arrays[f"params/L{i}/{name}"] = np.asarray(leaf)
    xs = np.stack(compiled.sample_inputs(MOE_REQUESTS, seed=0))
    traces = []
    for lo, hi in MOE_DISPATCHES:
        for c in range(lo, hi, MOE_MAX_BATCH):
            traces.append(dispatch_trace(
                compiled, xs[c:min(c + MOE_MAX_BATCH, hi)], jnp.asarray,
                np.asarray))
    acts = [np.concatenate(layer) for layer in zip(*traces)]
    # the trace is what a served call returns
    assert np.array_equal(np.asarray(compiled(xs[:1])), acts[-1][:1])
    arrays["x"] = xs
    arrays["layer_in"] = np.stack(acts[:-1])
    arrays["y"] = acts[-1]
    return arrays


def test_moe_golden_rebuilds_from_reference():
    """The committed MoE golden file is the reference's: plan, weights
    and blocks exactly, activations within 1e-6 (float32 on the CPU)."""
    want = moe_reference_golden()
    with np.load(MOE_GOLDEN) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            if k in ("layer_in", "y"):
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert np.array_equal(got[k], v), k


def test_lm_golden_rebuilds_from_reference():
    """The committed LM golden file is the reference's: parameters,
    prompts and greedy tokens exactly, logits within 1e-6 (float32 on
    the CPU; XLA may vectorize sums differently on another CPU)."""
    want = lm_reference_golden()
    with np.load(LM_GOLDEN) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            if "logits" in k:
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert np.array_equal(got[k], v), k


def test_lm_zoo_golden_rebuilds_from_reference():
    """The committed LM-zoo golden file is the reference's: parameters,
    prompts, modality inputs and greedy tokens exactly, logits within
    1e-6 (float32 on the CPU)."""
    want = lm_zoo_reference_golden()
    with np.load(LM_ZOO_GOLDEN) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            if "logits" in k:
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert np.array_equal(got[k], v), k


def test_train_golden_rebuilds_from_reference():
    """The committed training golden file is the reference's: parameters
    and the batch exactly, the losses, gradients and stepped parameters
    within 1e-5 relative and 1e-6 absolute (float32 on the CPU; another
    compilation of the step moves a parameter by up to 1.3e-6)."""
    want = train_reference_golden()
    with np.load(TRAIN_GOLDEN) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            if k.split("/")[1] in ("params", "tokens", "labels"):
                assert np.array_equal(got[k], v), k
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=k)


def committed_plans():
    return {stem: deploy.DeploymentPlan.load(PLANS / f"{stem}.json")
            for stem in PINS}


def test_committed_plans_embed_quickstart_with_pins():
    for stem, plan in committed_plans().items():
        assert plan.cnn == pinned_config(PINS[stem])
        assert plan.device.name == "v5e" and plan.target == 0.8
        assert [(a.block, a.data_bits, a.coeff_bits)
                for a in plan.layers] == ASSIGNED[stem]
        # the planner's budget verdict with on_infeasible="fallback"
        assert plan.feasible is False


def test_golden_npz_rebuilds_from_committed_plans():
    want = reference_golden(committed_plans())
    with np.load(GOLDEN) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            assert np.array_equal(got[k], v), k


def test_synth_reference_rows_hold_the_reference_golden_rows():
    """The committed reference rows agree with the reference's own
    golden sweep rows (``tests/golden/synth_golden.json``)."""
    payload = json.loads(SYNTH_REFERENCE.read_text())
    assert payload["version"] == synth.SWEEP_SCHEMA_VERSION
    assert len(payload["rows"]) == 784
    rows = {(r["block"], r["data_bits"], r["coeff_bits"]): r
            for r in payload["rows"]}
    for want in json.loads(SYNTH_GOLDEN.read_text())["rows"]:
        assert rows[(want["block"], want["data_bits"],
                     want["coeff_bits"])] == want


@pytest.mark.sweep
def test_synth_reference_rows_rebuild_from_reference_sweep(tmp_path):
    rows = synth.run_sweep(cache_path=tmp_path / "synth.json")
    assert json.loads(SYNTH_REFERENCE.read_text())["rows"] == rows


@pytest.mark.sweep
def test_committed_plans_match_reference_planner():
    for stem in PINS:
        text = (PLANS / f"{stem}.json").read_text()
        assert reference_plan(stem).to_json() + "\n" == text, stem


def write_synth_reference(rows):
    """One row per line, so that a regeneration diffs by design point."""
    lines = ",\n".join(json.dumps(r, sort_keys=True) for r in rows)
    SYNTH_REFERENCE.write_text(
        f'{{"version": {json.dumps(synth.SWEEP_SCHEMA_VERSION)}, '
        f'"rows": [\n{lines}\n]}}\n')


def main(argv=None):
    """Regenerate every committed file, or only those named in
    ``argv`` (``plans``, ``golden``, ``synth``, ``lm``, ``lm_zoo``,
    ``moe``, ``train``): a file not named is left byte for byte as it
    is."""
    names = set(argv or ()) or {"plans", "golden", "synth", "lm", "lm_zoo",
                                "moe", "train"}
    wrote = []
    if names & {"plans", "golden"}:
        plans = {stem: reference_plan(stem) for stem in PINS}
        if "plans" in names:
            PLANS.mkdir(parents=True, exist_ok=True)
            for stem, plan in plans.items():
                plan.save(PLANS / f"{stem}.json")
                wrote.append(PLANS / f"{stem}.json")
        if "golden" in names:
            GOLDEN.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(GOLDEN, **reference_golden(plans))
            wrote.append(GOLDEN)
    if "synth" in names:
        write_synth_reference(synth.run_sweep())
        wrote.append(SYNTH_REFERENCE)
    for name, path, make in (("lm", LM_GOLDEN, lm_reference_golden),
                             ("lm_zoo", LM_ZOO_GOLDEN,
                              lm_zoo_reference_golden),
                             ("moe", MOE_GOLDEN, moe_reference_golden),
                             ("train", TRAIN_GOLDEN,
                              train_reference_golden)):
        if name in names:
            np.savez_compressed(path, **make())
            wrote.append(path)
    for path in wrote:
        print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
