"""The rest of the LM zoo in the port on the CPU, held against the JAX
reference: the MoE MLP inside the LM (Qwen3-MoE, Llama-4-Maverick with
its shared expert and dense/MoE interleave, Jamba's hybrid Mamba/MoE
cycle), the encoder-decoder (Whisper, ``frames``) and the vision prefix
(Pixtral, ``patches``), at ``smoke_config`` in float32, with the
reference's parameters carried across by
``convert.lm_params_from_numpy`` and inputs made with numpy.  On CPU
tensors the kernels K7 and K8 run their plain versions.

Tolerances: logits and caches 2e-3 (the reference's own decode/prefill
bound, ``tests/test_decode.py``); greedy tokens exact (the MoE routing
and its capacity drops decide them, so a wrong tie or rank shows as
another token); the MoE aux loss 1e-5 (float32 layers); the in-place
weight draw exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_tf
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy, nested_from_flat
from repro_torch.launch import serve as launch
from repro_torch.models import build_model, layers
from repro_torch.models import transformer as tf
from repro_torch.serve import Engine, Request, ServeConfig
from tests.test_torch_lm import _close, _np, _pad_kv
from tests.test_torch_golden import (LM_ENGINE, LM_ZOO_ARCHS,
                                     LM_ZOO_GOLDEN, LM_ZOO_MOE_ARCHS,
                                     frontend_inputs)

ZOO_TOL, AUX_TOL = 2e-3, 1e-5
B, S, N_DECODE = 2, 16, 3


def _models(arch, key=1, **overrides):
    """Both packages' float32 smoke model of ``arch`` on the reference's
    parameters from ``PRNGKey(key)``."""
    cfg = ref_smoke_config(arch).with_overrides(dtype="float32",
                                                **overrides)
    tcfg = smoke_config(arch).with_overrides(dtype="float32", **overrides)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(key))
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")
    return cfg, model, params, build_model(tcfg, "cpu"), tparams


def _batch(cfg, seed):
    """A (B, S) prompt batch and the modality inputs ``cfg`` takes."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    for name in frontend_inputs(cfg):
        batch[name] = (0.1 * rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    return batch


def _n_front(cfg):
    return cfg.frontend_len if cfg.frontend == "vision" else 0


def _zoo_run(arch):
    """Prefill logits and cache of a (2, 16) batch, and three
    teacher-forced decode steps' logits, from both packages."""
    cfg, model, params, tmodel, tparams = _models(arch)
    batch = _batch(cfg, 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step)
    out = {"ref": {}, "port": {}}
    logits, cache = prefill(params, jbatch)
    tlogits, tcache = tmodel.prefill(tparams, batch)
    out["ref"]["prefill"], out["port"]["prefill"] = logits, tlogits
    out["ref"]["cache"], out["port"]["cache"] = cache, tcache
    start = S - N_DECODE
    short = dict(batch, tokens=batch["tokens"][:, :start])
    _, cache = prefill(params, dict(jbatch, tokens=jbatch["tokens"][:, :start]))
    _, tcache = tmodel.prefill(tparams, short)
    cache, tcache = _pad_kv(cache, N_DECODE, jnp), _pad_kv(tcache, N_DECODE,
                                                            torch)
    toks = batch["tokens"]
    steps, tsteps = [], []
    for t in range(start, S):
        pos = _n_front(cfg) + t
        logits, cache = decode(params, cache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(pos))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             toks[:, t:t + 1], pos)
        steps.append(_np(logits))
        tsteps.append(tlogits)
    out["ref"]["decode"] = np.stack(steps)
    out["port"]["decode"] = torch.stack(tsteps)
    return out


@pytest.fixture(scope="module")
def zoo():
    runs = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = _zoo_run(arch)
        return runs[arch]
    return get


# ---------------------------------------------------------------------------
# the model against the reference: prefill, its cache, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ZOO_ARCHS)
def test_zoo_prefill_logits(zoo, arch):
    run = zoo(arch)
    assert run["port"]["prefill"].dtype == torch.float32
    assert tuple(run["port"]["prefill"].shape) == run["ref"]["prefill"].shape
    _close(run["port"]["prefill"], run["ref"]["prefill"], ZOO_TOL)


@pytest.mark.parametrize("arch", LM_ZOO_ARCHS)
def test_zoo_prefill_cache(zoo, arch):
    """k/v (Pixtral's over the prefix and the tokens), Whisper's
    cross-attention ``ck``/``cv`` and Jamba's conv and SSM states."""
    ref, port = zoo(arch)["ref"]["cache"], zoo(arch)["port"]["cache"]
    assert set(ref) == set(port)
    for key in ref:
        assert set(ref[key]) == set(port[key])
        for name, leaf in ref[key].items():
            assert tuple(port[key][name].shape) == leaf.shape, (key, name)
            _close(port[key][name], leaf, ZOO_TOL)


@pytest.mark.parametrize("arch", LM_ZOO_ARCHS)
def test_zoo_decode_logits(zoo, arch):
    run = zoo(arch)
    _close(run["port"]["decode"], run["ref"]["decode"], ZOO_TOL)


@pytest.mark.parametrize("arch", LM_ZOO_ARCHS)
def test_zoo_decode_matches_prefill(arch):
    """The reference's ``test_decode_matches_prefill`` invariant in the
    port: decode at position S−1 (counting a vision prefix) against a
    prefill over S tokens, the MoE capacity raised so that neither drops
    a token."""
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(1))
    batch = _batch(cfg, 4)
    full, _ = model.prefill(params, batch)
    _, cache = model.prefill(params, dict(batch,
                                          tokens=batch["tokens"][:, :S - 1]))
    logits, _ = model.decode_step(params, _pad_kv(cache, 1, torch),
                                  batch["tokens"][:, S - 1:],
                                  _n_front(cfg) + S - 1)
    err = float((full - logits).abs().max())
    assert err < ZOO_TOL, f"{arch}: decode/prefill mismatch {err}"


@pytest.mark.parametrize("arch", LM_ZOO_MOE_ARCHS)
def test_moe_sublayer_aux_matches_reference(arch):
    """Each sublayer's ``_run_sublayer`` returns its MoE MLP's aux loss,
    a float32 scalar, equal to the reference's for the same sublayer on
    the same input (None for a dense or no MLP, where the reference's is
    0).  Prefill and decode drop them, as the reference's do;
    ``forward_train`` adds every one of them, where the reference's scan
    keeps each cycle's last (``tests/test_torch_train.py``)."""
    cfg, _, params, tmodel, tparams = _models(arch)
    tcfg = tmodel.cfg
    toks = _batch(cfg, 5)["tokens"]
    x = ref_tf._embed(params, jnp.asarray(toks), cfg)
    tx = tf._embed(tparams, torch.from_numpy(toks).long(), tcfg)
    n_aux = 0
    for i in range(cfg.n_cycles):
        cyc = jax.tree.map(lambda a: a[i], params["stack"])
        tcyc = tf.index_tree(tparams["stack"], i)
        for j, sub in enumerate(cfg.layer_cycle):
            x, _, aux = ref_tf._run_sublayer(
                cyc[f"s{j}"], x, cfg, sub, mode="prefill", cache={},
                cache_pos=None, enc_out=None)
            tx, _, taux = tf._run_sublayer(
                tcyc[f"s{j}"], tx, tcfg, tcfg.layer_cycle[j],
                mode="prefill", cache={}, cache_pos=None, enc_out=None)
            _close(tx, x, ZOO_TOL)
            if sub.mlp != "moe":
                assert taux is None and float(aux) == 0.0
                continue
            assert taux.dtype == torch.float32 and taux.ndim == 0
            assert float(aux) > 0
            _close(taux, aux, AUX_TOL)
            n_aux += 1
    n_moe = sum(s.mlp == "moe" for s in cfg.layer_cycle)
    assert n_aux == n_moe * cfg.n_cycles > 0


# ---------------------------------------------------------------------------
# serving: MoE capacity across the engine's pool (the committed golden
# outputs themselves are held in tests/test_torch_lm.py)
# ---------------------------------------------------------------------------

def _golden_model(arch):
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    with np.load(LM_ZOO_GOLDEN) as z:
        g = {k: z[k] for k in z.files if k.startswith(arch + "/")}
    params = lm_params_from_numpy(nested_from_flat(g, f"{arch}/params"),
                                  cfg, "cpu")
    return g, build_model(cfg, "cpu"), params


def _serve(model, params, prompts, **kw):
    reqs = [Request(prompt=[int(t) for t in p], request_id=i)
            for i, p in enumerate(prompts)]
    Engine(model, params, ServeConfig(admission="lockstep", **kw)).run(reqs)
    return [r.out_tokens for r in reqs]


def test_llama4_identical_prompts_take_capacity_from_each_other():
    """Llama-4's smoke decode routes top 1 of 4 experts at capacity
    max(1, round(1.25 · 2 · 1 / 4)) = 1: two identical rows pick the
    same expert and the second is dropped to its shared expert alone,
    so request 1 decodes other tokens than request 0 — in the reference
    and in the port, which ranks ties by the same stable sort."""
    arch = "llama4-maverick-400b-a17b"
    g, model, params = _golden_model(arch)
    want = g[f"{arch}/engine_tokens"].tolist()
    assert want[0][0] == want[1][0]          # the same prefill
    assert want[0] != want[1]                # then the drop
    got = _serve(model, params, g[f"{arch}/engine_prompts"][:2],
                 max_batch=2, max_len=LM_ENGINE["max_len"],
                 max_new_tokens=LM_ENGINE["new_tokens"])
    assert got == want[:2]
    # one request alone keeps its expert: the first request's tokens
    alone = _serve(model, params, g[f"{arch}/engine_prompts"][1:2],
                   max_batch=1, max_len=LM_ENGINE["max_len"],
                   max_new_tokens=LM_ENGINE["new_tokens"])
    assert alone == want[:1]


@pytest.mark.parametrize("arch", LM_ZOO_MOE_ARCHS)
def test_engine_empty_slot_rows_match_reference(arch):
    """Empty slots decode token 0 beside the live ones and take MoE
    capacity in token order.  Request 0 stops at an EOS after its second
    token, so from then on slot 0 is an empty row ranked before request
    1's: both engines must give the same tokens."""
    cfg, model, params, tmodel, tparams = _models(arch, key=0)
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, 8)]
               for _ in range(2)]

    def ref_serve(eos):
        reqs = [RefRequest(prompt=list(p), request_id=i)
                for i, p in enumerate(prompts)]
        RefEngine(model, params, RefServeConfig(
            max_batch=2, max_len=32, max_new_tokens=8, eos_id=eos)).run(reqs)
        return [r.out_tokens for r in reqs]

    free = ref_serve(-1)
    eos = free[0][1]
    want = ref_serve(eos)
    assert len(want[0]) == 2 and eos not in want[1][:2]
    assert _serve(tmodel, tparams, prompts, max_batch=2, max_len=32,
                  max_new_tokens=8, eos_id=eos) == want


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ZOO_MOE_ARCHS)
def test_launcher_serves_moe_lm_on_cpu(arch):
    args = launch.parse_args(["--workload", "lm", "--arch", arch,
                              "--requests", "3", "--prompt-len", "8",
                              "--new-tokens", "4", "--torch-device", "cpu"])
    engine, reqs, dt = launch.run_lm(args)
    assert engine.model.cfg == smoke_config(arch) and dt > 0
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert all(0 <= t < engine.model.cfg.vocab_size
               for r in reqs for t in r.out_tokens)


@pytest.mark.parametrize("arch,name", [("whisper-medium", "frames"),
                                       ("pixtral-12b", "patches")])
def test_launcher_refuses_frontend_archs_before_drawing_weights(
        monkeypatch, arch, name):
    def no_draw(*a, **kw):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(tf, "init_params", no_draw)
    args = launch.parse_args(["--workload", "lm", "--arch", arch,
                              "--torch-device", "cpu"])
    with pytest.raises(ValueError,
                       match=f"{arch}: .*prefills tokens alone.*{name}"):
        launch.run_lm(args)


# ---------------------------------------------------------------------------
# the weight draw and the parameter carrier
# ---------------------------------------------------------------------------

def _draw_as_before(gen, cfg):
    """The draw of the port before the in-place stack: every cycle drawn
    into a list, then ``torch.stack``-ed leafwise."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    dt = cfg.torch_dtype
    params = {
        "embed": layers.embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": layers.const_init(gen, (cfg.d_model,), 0.0),
        "stack": stack([{f"s{j}": tf._init_sublayer(gen, cfg, sub)
                         for j, sub in enumerate(cfg.layer_cycle)}
                        for _ in range(cfg.n_cycles)])}
    if not cfg.tie_embeddings:
        params["unembed"] = layers.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dt, fan_in=cfg.d_model)
    return params


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b"])
@pytest.mark.parametrize("n_layers", [None, 1])
def test_in_place_init_draws_the_same_weights(arch, n_layers):
    """The in-place stack draws the numbers the list-then-stack draw
    did, in the same order, so a seed gives the same weights as before
    (one cycle: the stack is a view of the draw)."""
    cfg = smoke_config(arch)
    if n_layers:
        cfg = cfg.with_overrides(n_layers=n_layers)
    got = tf.init_params(torch.Generator().manual_seed(0), cfg)
    want = _draw_as_before(torch.Generator().manual_seed(0), cfg)
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_draw_stacked_allocates_each_leaf_once():
    """Each draw lands in its slice of one stacked tensor per leaf."""
    draws = iter(range(10))

    def draw():
        i = next(draws)
        return {"a": torch.full((2, 3), float(i)),
                "b": {"c": torch.full((4,), -float(i))}}
    stack = tf._draw_stacked(draw, 3)
    assert tuple(stack["a"].shape) == (3, 2, 3)
    assert [float(stack["a"][i, 0, 0]) for i in range(3)] == [0., 1., 2.]
    assert [float(stack["b"]["c"][i, 0]) for i in range(3)] == [0., -1., -2.]
    assert stack["a"].is_contiguous() and next(draws) == 3


def test_oversized_leaves_are_drawn_in_slices(monkeypatch):
    """Above ``DRAW_SLICE`` elements a leaf is drawn slice by slice of
    its leading axis, into the result in its dtype: the same scale and
    no float32 copy of the whole leaf; at or below it, in one piece."""
    gen = torch.Generator().manual_seed(3)
    small = layers._normal(gen, (6, 50, 40), 0.5, torch.bfloat16)
    monkeypatch.setattr(layers, "DRAW_SLICE", 50 * 40 * 2)
    calls = []
    real = torch.randn

    def spy(*a, **kw):
        calls.append(tuple(a[0]))
        return real(*a, **kw)
    monkeypatch.setattr(torch, "randn", spy)
    big = layers._normal(torch.Generator().manual_seed(3), (6, 50, 40), 0.5,
                         torch.bfloat16)
    assert calls == [(2, 50, 40)] * 3
    assert big.dtype == torch.bfloat16 and tuple(big.shape) == (6, 50, 40)
    assert torch.isfinite(big.float()).all()
    assert abs(float(big.float().std()) - 0.5) < 0.02
    assert abs(float(small.float().std()) - 0.5) < 0.02


@pytest.mark.parametrize("arch", LM_ZOO_ARCHS)
def test_params_from_numpy_round_trips_every_leaf(arch):
    cfg = ref_smoke_config(arch)                          # bfloat16
    tcfg = smoke_config(arch)
    tree = jax.tree.map(np.asarray, ref_build_model(cfg).init(
        jax.random.PRNGKey(0)))
    got = lm_params_from_numpy(tree, tcfg, "cpu")
    want = dict(_leaves(tree))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.float32 if v.dtype == np.float32
                                else torch.bfloat16), k
        assert np.array_equal(got[k].float().numpy(), _np(v)), k
    routers = [k for k in got if k.endswith("moe/router")]
    assert len(routers) == (0 if cfg.moe is None else sum(
        s.mlp == "moe" for s in cfg.layer_cycle))
    assert all(got[k].dtype == torch.float32 for k in routers)


@pytest.mark.parametrize("arch,path", [
    ("qwen3-moe-30b-a3b", ("stack", "s0", "moe", "w_up")),
    ("qwen3-moe-30b-a3b", ("stack", "s0", "moe", "router")),
    ("llama4-maverick-400b-a17b", ("stack", "s1", "moe", "shared_down")),
    ("jamba-1.5-large-398b", ("stack", "s3", "moe", "w_gate")),
    ("whisper-medium", ("enc_stack", "s0", "attn", "wq")),
    ("whisper-medium", ("enc_norm",)),
    ("whisper-medium", ("stack", "s0", "cross", "wk")),
    ("whisper-medium", ("stack", "s0", "ln_x"))])
def test_params_from_numpy_refuses_a_wrong_new_leaf(arch, path):
    tree = jax.tree.map(_np, ref_build_model(ref_smoke_config(arch)).init(
        jax.random.PRNGKey(0)))
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = node[path[-1]][..., :-1]
    with pytest.raises(ValueError, match="params." + ".".join(path)
                       + ": shape"):
        lm_params_from_numpy(tree, smoke_config(arch), "cpu")
    del node[path[-1]]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(tree, smoke_config(arch), "cpu")
