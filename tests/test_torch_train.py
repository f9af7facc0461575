"""The training slice of the port on the CPU, held against the JAX
reference: the data pipeline, the AdamW optimizer and its int8 state
codec, the LR schedule, the gradient codec, ``forward_train`` and its
gradients at every ``smoke_config`` arch, rematerialization, the train
step (microbatches, gradient compression), checkpoints across the two
packages, the fault-tolerant loop and the launcher.  The reference's
parameters come across by ``convert.lm_params_from_numpy``; inputs are
made with numpy.  On CPU tensors K7 and K8 run their plain versions
inside the same ``torch.autograd.Function``s the card runs.

Tolerances: batches and int8 codes exact (a code may differ only where
the value it rounds sits on a rounding boundary: the global gradient
norm, a sum over every leaf, is added in another order, and a clipped
gradient moves by an ulp); AdamW 1e-6; the loss 1e-5 relative; every
gradient leaf 1e-4 relative L2 (float32; the reference's own model path
against the port's kernels' plain versions and autograd)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_archs as ref_list_archs
from repro.configs import smoke_config as ref_smoke_config
from repro.data import pipeline as ref_pipeline
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine
from repro.parallel import compress as ref_compress
from repro.train import checkpoint as ref_checkpoint
from repro.train import step as ref_step
from repro_torch import tree
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy, nested_from_flat
from repro_torch.data import pipeline
from repro_torch.launch import train as launch
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.parallel import compress
from repro_torch.train import checkpoint, loop, step
from tests.test_torch_golden import TRAIN_ARCHS, TRAIN_GOLDEN, TRAIN_STATES

LOSS_TOL, GRAD_REL_L2, ADAM_TOL, STEP_REL_L2 = 1e-5, 1e-4, 1e-6, 1e-5
B, S = 2, 16


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    if norm == 0:
        return float(np.linalg.norm(got))
    return float(np.linalg.norm(got - want) / norm)


def _ref_flat(t):
    return {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(t)}


def _port_flat(t):
    return {k: v.float().numpy() for k, v in tree.flatten(t).items()}


def _models(arch, **overrides):
    """Both packages' float32 smoke model of ``arch`` on the reference's
    ``PRNGKey(1)`` parameters."""
    overrides = {"dtype": "float32", **overrides}
    cfg = ref_smoke_config(arch).with_overrides(**overrides)
    tcfg = smoke_config(arch).with_overrides(**overrides)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")
    return cfg, model, params, build_model(tcfg, "cpu"), tparams


def _train_batch(cfg, seed=0, step_idx=0):
    """``batch_at``'s tokens and labels, and the numpy-made modality
    input ``cfg`` takes."""
    batch = ref_pipeline.batch_at(
        ref_pipeline.DataConfig(cfg.vocab_size, S, B), step_idx)
    rng = np.random.default_rng(seed)
    names = (("frames",) if cfg.enc_dec else ()) \
        + (("patches",) if cfg.frontend == "vision" else ())
    for name in names:
        batch[name] = (0.1 * rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    return batch


def _assert_grads_close(got, want, tol=GRAD_REL_L2):
    got, want = _port_flat(got), _ref_flat(want)
    assert sorted(got) == sorted(want)
    worst = {k: _rel_l2(got[k], want[k]) for k in want}
    bad = {k: v for k, v in worst.items() if v > tol}
    assert not bad, bad


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,doc", [
    (503, 16, 2, 0, 512), (50280, 128, 3, 7, 32), (97, 1, 1, 3, 1)])
def test_batch_at_equals_reference(vocab, seq, batch, seed, doc):
    for k in (0, 1, 17):
        want = ref_pipeline.batch_at(ref_pipeline.DataConfig(
            vocab, seq, batch, seed=seed, mean_doc_len=doc), k)
        got = pipeline.batch_at(pipeline.DataConfig(
            vocab, seq, batch, seed=seed, mean_doc_len=doc), k)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            assert np.array_equal(got[name], want[name]), (k, name)


def test_memmap_pipeline_and_resume_equal_reference(tmp_path):
    """A memmap source and a pipeline resumed at step 5 give the
    reference's batches, and a resumed pipeline's batches are
    ``batch_at`` of their steps."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 1000, 4000, dtype=np.uint32) \
        .tofile(path)
    for source, p in (("synthetic", None), ("memmap", str(path))):
        want = ref_pipeline.make_pipeline(ref_pipeline.DataConfig(
            1000, 32, 4, source=source, path=p), start_step=5)
        cfg = pipeline.DataConfig(1000, 32, 4, source=source, path=p)
        got = pipeline.make_pipeline(cfg, start_step=5)
        data = np.memmap(p, dtype=np.uint32, mode="r") if p else None
        for k in range(5, 8):
            w, g = next(want), next(got)
            for name in w:
                assert np.array_equal(g[name], w[name]), (source, k, name)
                assert np.array_equal(
                    g[name], pipeline.batch_at(cfg, k, data)[name])


# ---------------------------------------------------------------------------
# optimizer, schedule, gradient codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 257, 70000])
def test_state_codec_codes_and_scales_equal_reference(n):
    """Codes and scales exactly equal, a zero block included (its scale
    floors at 1e-20), and the decoded tensors equal."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n)
         * rng.choice([1e-6, 1.0, 40.0], n)).astype(np.float32)
    x[:min(n, 256)] = 0 if n > 256 else x[:min(n, 256)]
    x = x.reshape((n // 5, 5) if n % 5 == 0 else (n,))
    want = ref_adamw.quantize_state(jnp.asarray(x))
    got = adamw.quantize_state(torch.from_numpy(x))
    assert got["codes"].dtype == torch.int8
    assert np.array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert np.array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert np.array_equal(
        adamw.dequantize_state(got, x.shape).numpy(),
        np.asarray(ref_adamw.dequantize_state(want, x.shape)))


def _adam_tree(rng, scale):
    return {"w": (rng.standard_normal((64, 48)) * scale).astype(np.float32),
            "stack": {"c": (rng.standard_normal((3, 17, 5))
                            * scale).astype(np.float32),
                      "n": (rng.standard_normal(33)
                            * scale).astype(np.float32)}}


def _on_boundary(x, scale, codes_got, codes_want):
    """Every code that differs is one apart, and ``x``, the value the
    port quantized, sits within 1e-3 of a half code there (a rounding
    boundary)."""
    diff = codes_got.astype(np.int32) - codes_want.astype(np.int32)
    if not diff.any():
        return True
    flat = np.pad(x.reshape(-1), (0, (-x.size) % adamw.BLOCK)) \
        .reshape(-1, adamw.BLOCK) / scale[:, None]
    frac = np.abs(flat - np.floor(flat) - 0.5)
    return bool(np.all(np.abs(diff) <= 1)
                and np.all(frac[diff != 0] < 1e-3))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("grad_scale", [0.003, 0.3])
def test_adamw_update_matches_reference(state_dtype, grad_scale,
                                       monkeypatch):
    """Three steps on the same gradients.  At a gradient scale of 0.003
    the global norm stays under the clip, every op is the reference's,
    and the moments (int8 codes and scales) are equal; at 0.3 the clip
    divides by a norm summed in another order, the parameters and
    float32 moments stay within 1e-6 and an int8 code may move by one
    only on a rounding boundary."""
    rng = np.random.default_rng(int(grad_scale * 1000))
    cfg = ref_adamw.AdamWConfig(state_dtype=state_dtype)
    tcfg = adamw.AdamWConfig(state_dtype=state_dtype)
    p0 = _adam_tree(rng, 1.0)
    p0_names = tree.flatten(p0)
    rp = jax.tree.map(jnp.asarray, p0)
    tp = tree.tree_map(torch.from_numpy, p0)
    rs, ts = ref_adamw.adamw_init(rp, cfg), adamw.adamw_init(tp, tcfg)
    # the float moments the port quantizes, m then v of each leaf in turn
    quantized = []
    quantize = adamw.quantize_state
    monkeypatch.setattr(adamw, "quantize_state", lambda x: (
        quantized.append(x.numpy().copy()), quantize(x))[1])
    for k in range(3):
        g = _adam_tree(rng, grad_scale)
        quantized.clear()
        rp, rs, rm = ref_adamw.adamw_update(
            jax.tree.map(jnp.asarray, g), rs, rp, 3e-4, cfg)
        tp, ts, tm = adamw.adamw_update(
            tree.tree_map(torch.from_numpy, g), ts, tp, 3e-4, tcfg)
        assert int(ts["step"]) == int(rs["step"]) == k + 1
        assert ts["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=ADAM_TOL)
        got_p, want_p = _port_flat(tp), _ref_flat(rp)
        for name in want_p:
            np.testing.assert_allclose(got_p[name], want_p[name],
                                       rtol=0, atol=ADAM_TOL, err_msg=name)
        clipped = float(rm["grad_norm"]) > cfg.grad_clip
        got_s, want_s = _port_flat(ts), _ref_flat(rs)
        assert sorted(got_s) == sorted(want_s)
        for name in want_s:
            g_, w_ = got_s[name], want_s[name]
            if not clipped:
                assert np.array_equal(g_, w_), name
            elif name.endswith("/codes"):
                moment, leaf = name.split("/", 1)
                leaf = leaf[:-len("/codes")]
                x = quantized[2 * list(p0_names).index(leaf)
                              + (moment == "v")]
                assert _on_boundary(x, want_s[name[:-len("codes")] + "scale"],
                                    g_, w_), name
            elif not name.endswith("/scale"):
                np.testing.assert_allclose(g_, w_, rtol=0, atol=ADAM_TOL,
                                           err_msg=name)


def test_cosine_schedule_matches_reference():
    for kw in (dict(peak_lr=3e-4, warmup_steps=10, total_steps=100),
               dict(peak_lr=1.0, warmup_steps=0, total_steps=7,
                    min_ratio=0.0)):
        for k in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            got = cosine_schedule(k, **kw)
            assert got.dtype == torch.float32 and got.ndim == 0
            np.testing.assert_allclose(float(got),
                                       float(ref_cosine(k, **kw)),
                                       rtol=1e-6, atol=1e-12)


def test_grad_compression_matches_reference():
    rng = np.random.default_rng(4)
    g = _adam_tree(rng, 0.01)
    g["stack"]["n"][:] = 0
    want = ref_compress.decompress_grads(
        ref_compress.compress_grads_int8(jax.tree.map(jnp.asarray, g)),
        jax.tree.map(jnp.asarray, g))
    tg = tree.tree_map(torch.from_numpy, g)
    q = compress.compress_grads_int8(tg)
    assert q["w"]["codes"].dtype == torch.int8
    got = compress.decompress_grads(q, tg)
    got_f, want_f = _port_flat(got), _ref_flat(want)
    for name in want_f:
        assert np.array_equal(got_f[name], want_f[name]), name
    bf = tree.tree_map(lambda t: t.to(torch.bfloat16), tg)
    assert all(x.dtype == torch.bfloat16 for x in tree.leaves(
        compress.decompress_grads(compress.compress_grads_int8(bf), bf)))


# ---------------------------------------------------------------------------
# forward_train and its gradients
# ---------------------------------------------------------------------------

def _ref_value_and_grad(model, params, batch, fn=None):
    fn = fn or model.forward_train
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(fn, has_aux=True))(params, jb)


def _ref_sublayer_aux_sum(cfg, params, tokens):
    """The sum of every sublayer's MoE aux loss in the reference's model,
    each from its own ``_run_sublayer`` in train mode (its scan keeps
    each cycle's last)."""
    def aux_sum(params, tokens):
        x = ref_tf._embed(params, tokens, cfg)
        aux = jnp.zeros((), jnp.float32)
        for i in range(cfg.n_cycles):
            cyc = jax.tree.map(lambda a: a[i], params["stack"])
            for j, sub in enumerate(cfg.layer_cycle):
                x, _, a = ref_tf._run_sublayer(
                    cyc[f"s{j}"], x, cfg, sub, mode="train", cache=None,
                    cache_pos=None, enc_out=None)
                aux = aux + a
        return aux
    return float(jax.jit(aux_sum)(params, jnp.asarray(tokens)))


class _NllOnly:
    """A model whose training loss is ``model``'s nll alone."""

    def __init__(self, model):
        self.model = model

    def forward_train(self, params, batch):
        _, metrics = self.model.forward_train(params, batch)
        return metrics["nll"], metrics


# Jamba: the port sums every sublayer's aux; the reference's scan keeps
# each cycle's last (ROADMAP §3), so its loss is held apart below
EVERY_AUX_SUM = ("jamba-1.5-large-398b",)


@pytest.mark.parametrize("arch", ref_list_archs())
def test_forward_train_loss_and_grads_match_reference(arch):
    """Loss, nll, aux and token count within 1e-5 and every gradient leaf
    of the loss within relative L2 1e-4 of ``jax.value_and_grad`` of the
    reference's ``forward_train``, float32 at smoke size.  For Jamba the
    nll and its gradient equal the reference's, and the aux equals the
    sum of the reference's per-sublayer aux losses (more than twice what
    its scan keeps)."""
    cfg, model, params, tmodel, tparams = _models(arch)
    batch = _train_batch(cfg)
    loss, metrics, grads = step.loss_and_grads(tmodel, tparams, batch)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    if arch in EVERY_AUX_SUM:
        def nll(p, b):
            _, m = model.forward_train(p, b)
            return m["nll"], m
        (_, rmet), rgrads = _ref_value_and_grad(model, params, batch, nll)
        _, _, grads = step.loss_and_grads(_NllOnly(tmodel), tparams, batch)
        aux = _ref_sublayer_aux_sum(cfg, params, batch["tokens"])
        assert aux > 2 * float(rmet["aux"])
        rloss = float(rmet["nll"]) + aux
        rmet = dict(rmet, aux=aux)
    else:
        (rloss, rmet), rgrads = _ref_value_and_grad(model, params, batch)
    assert int(metrics["tokens"]) == int(rmet["tokens"]) \
        == int((batch["labels"] >= 0).sum())
    for name, got, want in (("loss", loss, rloss),
                            ("nll", metrics["nll"], rmet["nll"]),
                            ("aux", metrics["aux"], rmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=name)
    _assert_grads_close(grads, rgrads)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b",
                                  "qwen3-moe-30b-a3b"])
def test_remat_policies_and_no_remat_agree(arch, monkeypatch):
    """``remat_policy`` "full" and "save_mixer_out" and the model without
    rematerialization give the same loss and gradients (the recompute
    runs the same ops on the same inputs), and K8's and K7's forwards
    run once more per layer under remat (counted on the CPU by the
    plain versions' calls)."""
    from repro_torch.kernels import conv1d, flash_attention as fa
    runs = {}
    for policy in ("full", "save_mixer_out", None):
        cfg, _, _, tmodel, tparams = _models(
            arch, remat_policy=policy or "full")
        calls = {"k8": 0, "k7": 0}
        k8, k7 = fa.flash_attention_plain, conv1d.causal_conv1d_plain

        def count8(*a, **k):
            calls["k8"] += 1
            return k8(*a, **k)

        def count7(*a, **k):
            calls["k7"] += 1
            return k7(*a, **k)
        monkeypatch.setattr(fa, "flash_attention_plain", count8)
        monkeypatch.setattr(conv1d, "causal_conv1d_plain", count7)
        if policy is None:
            monkeypatch.setattr(tf, "_remat", lambda fn, *a: fn(*a))
        runs[policy] = (step.loss_and_grads(tmodel, tparams,
                                            _train_batch(cfg)), dict(calls))
        monkeypatch.undo()
    (loss, _, grads), calls = runs[None]
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_cycle) * cfg.n_cycles
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_cycle) \
        * cfg.n_cycles
    assert calls == {"k8": n_attn, "k7": 3 * n_mamba}
    for policy in ("full", "save_mixer_out"):
        (l2, _, g2), c2 = runs[policy]
        assert c2 == {"k8": 2 * n_attn, "k7": 6 * n_mamba}, policy
        assert float(l2) == float(loss)
        for k, v in tree.flatten(grads).items():
            assert torch.equal(tree.flatten(g2)[k], v), (policy, k)


def test_forward_train_masks_labels_and_adds_nothing_without_moe():
    """Labels below 0 are left out of the mean, a batch with none valid
    divides by 1, and a dense model's aux is a float32 zero."""
    _, _, _, tmodel, tparams = _models("llama3.2-3b")
    batch = _train_batch(tmodel.cfg)
    loss, m = tmodel.forward_train(tparams, batch)
    assert float(m["aux"]) == 0.0 and m["aux"].dtype == torch.float32
    masked = dict(batch, labels=np.full_like(batch["labels"], -100))
    loss0, m0 = tmodel.forward_train(tparams, masked)
    assert float(loss0) == 0.0 and int(m0["tokens"]) == 0
    one = batch["labels"].copy()
    one[:, 1:] = -100
    _, m1 = tmodel.forward_train(tparams, dict(batch, labels=one))
    assert int(m1["tokens"]) == int((one >= 0).sum())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,microbatches,compression,state", [
    ("llama3.2-3b", 1, False, "float32"),
    ("mamba2-1.3b", 2, False, "int8"),
    ("qwen3-moe-30b-a3b", 2, True, "float32"),
    ("llama3.2-3b", 1, True, "int8")])
def test_train_step_matches_reference(arch, microbatches, compression,
                                      state):
    """Steps of ``make_train_step`` against the reference's: the loss
    and metrics within 1e-5, the parameters within relative L2 1e-5 per
    leaf; microbatches sum float32 gradients and average the metrics,
    compression rounds the gradients through the int8 codec.  Two steps
    with float32 states; one with int8 states, because the second reads
    moments whose codes may sit on the other side of a rounding boundary
    (the global norm is summed in another order), and a v that rounds to
    0 on one side only divides that element's step by eps."""
    cfg, model, params, tmodel, tparams = _models(arch)
    opt = ref_adamw.AdamWConfig(state_dtype=state)
    topt = adamw.AdamWConfig(state_dtype=state)
    rstep = jax.jit(ref_step.make_train_step(
        model, opt, microbatches=microbatches,
        grad_compression=compression))
    tstep = step.make_train_step(tmodel, topt, microbatches=microbatches,
                                 grad_compression=compression)
    rs, ts = ref_adamw.adamw_init(params, opt), adamw.adamw_init(tparams,
                                                                 topt)
    for k in range(2 if state == "float32" else 1):
        batch = _train_batch(cfg, step_idx=k)
        params, rs, rm = rstep(params, rs,
                               {n: jnp.asarray(v) for n, v in batch.items()})
        tparams, ts, tm = tstep(tparams, ts, batch)
        assert sorted(tm) == sorted(rm)
        for name in rm:
            np.testing.assert_allclose(float(tm[name]), float(rm[name]),
                                       rtol=LOSS_TOL, atol=1e-7,
                                       err_msg=name)
        got, want = _port_flat(tparams), _ref_flat(params)
        bad = {n: _rel_l2(got[n], want[n]) for n in want
               if _rel_l2(got[n], want[n]) > STEP_REL_L2}
        assert not bad, (k, bad)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_on_cpu_matches_golden(arch):
    """The committed golden (``golden/train_reference.npz``, which
    ``chip_smoke.py`` holds the card to) on the CPU: the loss within
    1e-5, every gradient leaf within relative L2 1e-4, and the
    parameters after one step with float32 and with int8 states within
    relative L2 1e-5."""
    with np.load(TRAIN_GOLDEN) as z:
        g = {k: z[k] for k in z.files if k.startswith(arch + "/")}
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    model = build_model(cfg, "cpu")
    batch = {"tokens": g[f"{arch}/tokens"], "labels": g[f"{arch}/labels"]}

    def params():
        return lm_params_from_numpy(nested_from_flat(g, f"{arch}/params"),
                                    cfg, "cpu")
    loss, metrics, grads = step.loss_and_grads(model, params(), batch)
    np.testing.assert_allclose(float(loss), g[f"{arch}/loss"],
                               rtol=LOSS_TOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(metrics[k]), g[f"{arch}/{k}"],
                                   rtol=LOSS_TOL, atol=1e-7)
    np.testing.assert_allclose(float(adamw.global_norm(grads)),
                               g[f"{arch}/grad_norm"], rtol=LOSS_TOL)
    flat = _port_flat(grads)
    assert sorted(f"{arch}/grads/{k}" for k in flat) \
        == sorted(k for k in g if k.startswith(f"{arch}/grads/"))
    bad = {k: r for k in flat
           if (r := _rel_l2(flat[k], g[f"{arch}/grads/{k}"])) > GRAD_REL_L2}
    assert not bad, bad
    for state in TRAIN_STATES:
        opt = adamw.AdamWConfig(state_dtype=state)
        p = params()
        p, _, _ = step.make_train_step(model, opt)(
            p, adamw.adamw_init(p, opt), batch)
        bad = {k: r for k, v in _port_flat(p).items()
               if (r := _rel_l2(v, g[f"{arch}/step_{state}/{k}"]))
               > STEP_REL_L2}
        assert not bad, (state, bad)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state_pair(state_dtype, dtype="float32"):
    """The same params + AdamW state in both packages (one step taken,
    so the moments are not zero), bfloat16 leaves where ``dtype`` says."""
    cfg, model, params, tmodel, tparams = _models("mamba2-1.3b", dtype=dtype)
    opt = ref_adamw.AdamWConfig(state_dtype=state_dtype)
    topt = adamw.AdamWConfig(state_dtype=state_dtype)
    batch = _train_batch(cfg)
    params, rs, _ = jax.jit(ref_step.make_train_step(model, opt))(
        params, ref_adamw.adamw_init(params, opt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tparams, ts, _ = step.make_train_step(tmodel, topt)(
        tparams, adamw.adamw_init(tparams, topt), batch)
    return ({"params": params, "opt": rs}, {"params": tparams, "opt": ts})


def _assert_state_equal(got, want):
    """A port tree equal, leaf for leaf and in dtype, to a reference tree
    (bfloat16 compared through float32)."""
    g, w = tree.flatten(got), _ref_flat(want)
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        assert str(g[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert np.array_equal(
            g[k].float().numpy() if g[k].is_floating_point()
            else g[k].numpy(), v.astype(np.float32)
            if v.dtype.name == "bfloat16" else v), k


@pytest.mark.parametrize("state_dtype,dtype", [("float32", "float32"),
                                               ("int8", "bfloat16")])
def test_checkpoint_restores_across_packages(tmp_path, state_dtype, dtype):
    """A checkpoint the port writes restores in the reference and one the
    reference writes restores in the port, leaf for leaf: the same leaf
    keys, sha1 file names and manifest (bfloat16 stored as float32 with
    its dtype recorded), int8 codes and the int32 step included."""
    ref_state, port_state = _state_pair(state_dtype, dtype)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_checkpoint.Checkpointer(ref_dir).save(3, ref_state)
    checkpoint.Checkpointer(port_dir).save(3, port_state)
    mr = json.loads((ref_dir / "step_0000000003" / "manifest.json")
                    .read_text())
    mp = json.loads((port_dir / "step_0000000003" / "manifest.json")
                    .read_text())
    assert mp == mr
    assert "params/stack/s0/mamba/conv_x" in mp["leaves"]
    if dtype == "bfloat16":
        assert mp["leaves"]["params/embed"]["dtype"] == "bfloat16"
    # the reference restores the port's checkpoint into its template
    step_r, from_port = ref_checkpoint.Checkpointer(port_dir).restore(
        ref_state)
    assert step_r == 3
    for k, v in _ref_flat(from_port).items():
        w = _ref_flat(ref_state)[k]
        assert v.dtype == w.dtype and v.shape == w.shape, k
    # ... and it equals what the port saved
    _assert_state_equal(port_state, from_port)
    # the port restores the reference's checkpoint into its template
    step_t, from_ref = checkpoint.Checkpointer(ref_dir).restore(port_state)
    assert step_t == 3
    _assert_state_equal(from_ref, ref_state)


def test_checkpoint_commits_atomically_and_keeps_the_newest(tmp_path):
    ck = checkpoint.Checkpointer(tmp_path, keep=2)
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "step": torch.zeros((), dtype=torch.int32)}
    for s in (1, 2, 3):
        ck.save(s, state)
    (tmp_path / "step_0000000009.tmp").mkdir()     # a torn write
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore({"w": torch.zeros(3, 2), "step": state["step"]})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore({"w": state["w"], "other": state["step"]})
    with pytest.raises(FileNotFoundError):
        checkpoint.Checkpointer(tmp_path / "empty").restore(state)


# ---------------------------------------------------------------------------
# the loop and the launcher
# ---------------------------------------------------------------------------

def _loop_setup(tmp_path, name, **kw):
    cfg = smoke_config("llama3.2-3b").with_overrides(dtype="float32")
    model = build_model(cfg, "cpu")
    data = pipeline.DataConfig(cfg.vocab_size, 16, 2)
    tcfg = loop.TrainConfig(steps=8, lr=1e-2, log_every=4, ckpt_every=4,
                            ckpt_dir=str(tmp_path / name), **kw)
    return model, data, tcfg


def test_loop_loss_falls_and_reports_straggler_stats(tmp_path):
    model, data, tcfg = _loop_setup(tmp_path, "run")
    lines = []
    params, opt, history = loop.train(model, data, tcfg, log=lines.append)
    assert [h["step"] for h in history] == [1, 4, 8]
    assert history[-1]["loss"] < history[0]["loss"] - 0.2
    for h in history:
        assert 0 < h["p50_ms"] <= h["p95_ms"] <= h["max_ms"]
    assert int(opt["step"]) == 8
    assert checkpoint.Checkpointer(tcfg.ckpt_dir).all_steps() == [4, 8]
    t = loop.StepTimer(window=3)
    assert t.stats() == {}
    for dt in (0.5, 0.001, 0.002, 0.003):
        t.add(dt)
    assert t.times == [0.001, 0.002, 0.003] and t.stats()["max_ms"] == 3.0


def test_loop_preemption_resume_equals_uninterrupted_run(tmp_path):
    """A run preempted at step 5 checkpoints the 5 steps done, and a
    restart resumes there: its last loss and its parameters equal an
    uninterrupted run's (within 1e-5); the restored parameters fit a
    fresh template."""
    model, data, tcfg = _loop_setup(tmp_path, "whole")
    p_whole, _, h_whole = loop.train(model, data, tcfg, log=lambda _: None)
    _, _, pre = _loop_setup(tmp_path, "cut", fail_at_step=5)
    with pytest.raises(RuntimeError, match="preemption at step 5"):
        loop.train(model, data, pre, log=lambda _: None)
    assert checkpoint.Checkpointer(pre.ckpt_dir).latest_step() == 5
    lines = []
    resumed = loop.TrainConfig(**{**pre.__dict__, "fail_at_step": None})
    p_res, _, h_res = loop.train(model, data, resumed, log=lines.append)
    assert lines[0] == "[train] resumed from step 5"
    assert h_res[-1]["step"] == h_whole[-1]["step"] == 8
    np.testing.assert_allclose(h_res[-1]["loss"], h_whole[-1]["loss"],
                               rtol=1e-5)
    for k, v in tree.flatten(p_whole).items():
        np.testing.assert_allclose(tree.flatten(p_res)[k].numpy(),
                                   v.numpy(), rtol=0, atol=1e-5, err_msg=k)
    template = model.init(torch.Generator("cpu").manual_seed(9))
    _, restored = checkpoint.Checkpointer(pre.ckpt_dir).restore(
        {"params": template})
    for k, v in tree.flatten(p_res).items():
        assert torch.equal(tree.flatten(restored["params"])[k], v), k


def test_launch_train_on_cpu(tmp_path, capsys):
    history = launch.main(["--arch", "mamba2-1.3b", "--smoke", "--steps",
                           "3", "--batch", "2", "--seq", "16",
                           "--opt-dtype", "int8", "--ckpt-dir",
                           str(tmp_path), "--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "last loss" in out
    assert [h["step"] for h in history] == [1]
    assert checkpoint.Checkpointer(tmp_path).latest_step() == 3


def test_launch_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch.parse_args(["--arch", "llama3.2-3b"]).torch_device \
        == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        launch.main(["--arch", "llama3.2-3b", "--smoke"])
