"""The LM slice of the port on the CPU, held against the JAX reference:
configs, model modules, the whole slice (``prefill``/``decode_step``)
and the serving ``Engine``, with the reference's parameters carried
across by ``convert.lm_params_from_numpy`` and inputs made with numpy.
On CPU tensors the kernels K7 and K8 run their plain versions.

Tolerances: float32 layers 1e-5 (the same float32 arithmetic, other
libm and sum orders); attention 2e-4 (``tests/test_attention.py``); the
Mamba block 2e-5; the whole slice 2e-3 at float32 (the reference's own
decode/prefill bound, ``tests/test_decode.py``); bfloat16 logits 3e-2
(see ``test_slice_bf16_logits``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import lm_params_from_numpy, nested_from_flat
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as launch
from repro_torch.models import attention, build_model, layers, ssm
from repro_torch.serve import Engine, Request, ServeConfig
from tests.test_attention import naive_attention
from tests.test_torch_golden import (LM_ARCHS, LM_ENGINE, LM_GOLDEN,
                                     LM_ZOO_ARCHS, LM_ZOO_GOLDEN)

SLICE_ARCHS = ("llama3.2-3b", "mamba2-1.3b", "gemma2-2b")
LAYER_TOL, ATTN_TOL, MAMBA_TOL, SLICE_TOL = 1e-5, 2e-4, 2e-5, 2e-3
BF16_LOGITS_TOL = 3e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got.float() if torch.is_tensor(got)
                                   else got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    assert list_archs() == ref_list_archs()
    for arch in list_archs():
        for mine, ref in ((get_config(arch), ref_get_config(arch)),
                          (smoke_config(arch), ref_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
            assert mine.param_count() == ref.param_count(), arch
            assert mine.torch_dtype == getattr(torch, ref.dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 5, 64)), dtype)
    w = jnp.asarray(rng.normal(size=(64,)) * 0.1, jnp.float32)
    want = ref_layers.rms_norm(x, w, 1e-6)
    got = layers.rms_norm(_t(_np(x)).to(getattr(torch, dtype)), _t(w), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # bf16: one rounding of the same float32 value on each side
    _close(got, want, LAYER_TOL if dtype == "float32" else 2 ** -8)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7) + 90)[None, :]
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(layers.apply_rope(_t(x), _t(pos), theta), want, LAYER_TOL)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
def test_mlp(act, gated):
    """SwiGLU, GeGLU (the tanh GELU that ``jax.nn.gelu`` defaults to)
    and the plain 2-matrix MLP."""
    rng = np.random.default_rng(2)
    p = ref_layers.init_mlp(jax.random.PRNGKey(0), 16, 32, gated,
                            jnp.float32)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32) * 3
    want = ref_layers.mlp(p, jnp.asarray(x), act)
    got = layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap(cap):
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    _close(layers.softcap(_t(x), cap), ref_layers.softcap(jnp.asarray(x),
                                                          cap), LAYER_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, s, t, h, kh, d):
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, t, kh, d)).astype(np.float32),
            rng.normal(size=(b, t, kh, d)).astype(np.float32))


@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (True, 8, None), (True, None, 50.0),
    (False, None, None)])
def test_multi_head_attention(h, kh, causal, window, cap):
    """The ``tests/test_attention.py`` cases against the reference's
    chunked path and the naive oracle (the first goes to K8)."""
    q, k, v = _qkv(np.random.default_rng(0), 2, 64, 64, h, kh, 16)
    kw = dict(causal=causal, window=window, cap=cap, q_chunk=16)
    want = ref_attn.multi_head_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention.multi_head_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, want, ATTN_TOL)
    _close(got, naive_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, cap=cap), ATTN_TOL)


def test_decode_valid_len_masks_stale_cache():
    q, k, v = _qkv(np.random.default_rng(1), 2, 1, 32, 4, 2, 16)
    valid = 10
    pk, pv = k.copy(), v.copy()
    pk[:, valid:], pv[:, valid:] = 1e4, 1e4
    kw = dict(causal=False, q_offset=valid - 1, kv_valid_len=valid)
    got = attention.multi_head_attention(_t(q), _t(pk), _t(pv), **kw)
    _close(got, ref_attn.multi_head_attention(
        *map(jnp.asarray, (q, pk, pv)), **kw), ATTN_TOL)
    _close(got, naive_attention(jnp.asarray(q), jnp.asarray(k[:, :valid]),
                                jnp.asarray(v[:, :valid]), causal=False),
           ATTN_TOL)


@pytest.mark.parametrize("cap", [None, 50.0])
def test_non_divisible_chunking(cap):
    """48 rows in chunks of at most 32 (two of 24); with a softcap the
    call keeps the chunked path."""
    q, k, v = _qkv(np.random.default_rng(2), 1, 48, 48, 4, 4, 8)
    kw = dict(causal=True, cap=cap, q_chunk=32)
    got = attention.multi_head_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, ref_attn.multi_head_attention(
        *map(jnp.asarray, (q, k, v)), **kw), ATTN_TOL)


def test_flash_dispatch_rule(monkeypatch):
    """K8 takes exactly the full-sequence causal calls without window,
    softcap or cache masking from position 0."""
    calls = []

    def spy(q, k, v, causal):
        calls.append(q.shape[1])
        return fa.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(attention, "flash_attention", spy)
    q, k, v = map(_t, _qkv(np.random.default_rng(3), 1, 8, 8, 4, 2, 16))
    mha = attention.multi_head_attention
    mha(q, k, v, causal=True)
    assert calls == [8]
    for kw in (dict(causal=False), dict(causal=True, window=4),
               dict(causal=True, cap=50.0), dict(causal=True, q_offset=2),
               dict(causal=True, kv_valid_len=8),
               dict(causal=True, logits_bf16=True)):
        mha(q, k, v, **kw)
        mha(q[:, :1], k, v, **kw)
    mha(q[:, :1], k, v, causal=True)
    assert calls == [8]


@pytest.mark.parametrize("pos", [0, 5, 14, 20])
def test_cache_write_clamps_like_dynamic_update_slice(pos):
    cache = np.zeros((2, 16, 2, 4), np.float32)
    new = np.random.default_rng(pos).normal(size=(2, 3, 2, 4)) \
        .astype(np.float32)
    want = jax.lax.dynamic_update_slice(jnp.asarray(cache),
                                        jnp.asarray(new), (0, pos, 0, 0))
    got = _t(cache)
    attention._write_cache(got, _t(new), pos)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("first", [15, 1])
def test_mamba_block_prefill_then_decode(first, empty):
    """Prefill over ``first`` tokens (15: not a chunk multiple), then two
    decode steps carrying the conv and SSM states.  The port starts from
    a zeroed cache, or from ``{}`` as its model's prefill does (no state
    to the kernel); the reference always from its zeroed cache."""
    cfg = ref_smoke_config("mamba2-1.3b").with_overrides(dtype="float32")
    tcfg = smoke_config("mamba2-1.3b").with_overrides(dtype="float32")
    p = ref_ssm.init_mamba(jax.random.PRNGKey(4), cfg)
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, first + 2, cfg.d_model)).astype(np.float32)
    cache = ref_ssm.init_mamba_cache(cfg, 2)
    tcache = {} if empty else ssm.init_mamba_cache(tcfg, 2,
                                                      device="cpu")
    for lo, hi in ((0, first), (first, first + 1), (first + 1, first + 2)):
        y, cache = ref_ssm.mamba_block(p, jnp.asarray(x[:, lo:hi]), cfg,
                                       cache=cache)
        ty, tcache = ssm.mamba_block(tp, _t(x[:, lo:hi]), tcfg,
                                     cache=tcache)
        _close(ty, y, MAMBA_TOL)
        for name in cache:
            _close(tcache[name], cache[name], MAMBA_TOL)
    y, _ = ref_ssm.mamba_block(p, jnp.asarray(x), cfg)
    ty, none = ssm.mamba_block(tp, _t(x), tcfg)
    assert none is None
    _close(ty, y, MAMBA_TOL)


# ---------------------------------------------------------------------------
# the whole slice: prefill and decode against the reference
# ---------------------------------------------------------------------------

def _pad_kv(cache, n, xp):
    return {key: {name: (xp.pad(leaf, ((0, 0), (0, 0), (0, n), (0, 0),
                                      (0, 0)))
                         if xp is jnp else torch.nn.functional.pad(
                             leaf, (0, 0, 0, 0, 0, n)))
                  if name in ("k", "v") else leaf
                  for name, leaf in entry.items()}
            for key, entry in cache.items()}


def _slice_run(arch, dtype):
    """Prefill logits and cache of a (2, 16) batch, and three
    teacher-forced decode steps' logits, from both packages."""
    cfg = ref_smoke_config(arch).with_overrides(dtype=dtype)
    tcfg = smoke_config(arch).with_overrides(dtype=dtype)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    tmodel = build_model(tcfg, "cpu")
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    out = {"ref": {}, "port": {}}
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step)
    logits, cache = prefill(params, {"tokens": jnp.asarray(toks)})
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": toks})
    out["ref"]["prefill"], out["port"]["prefill"] = logits, tlogits
    out["ref"]["cache"], out["port"]["cache"] = cache, tcache
    _, cache = prefill(params, {"tokens": jnp.asarray(toks[:, :13])})
    _, tcache = tmodel.prefill(tparams, {"tokens": toks[:, :13]})
    cache, tcache = _pad_kv(cache, 3, jnp), _pad_kv(tcache, 3, torch)
    steps, tsteps = [], []
    for pos in range(13, 16):
        logits, cache = decode(params, cache, jnp.asarray(
            toks[:, pos:pos + 1]), jnp.int32(pos))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             toks[:, pos:pos + 1], pos)
        steps.append(logits)
        tsteps.append(tlogits)
    out["ref"]["decode"] = np.stack([_np(s) for s in steps])
    out["port"]["decode"] = torch.stack(tsteps)
    return out


@pytest.fixture(scope="module")
def slice_f32():
    return {arch: _slice_run(arch, "float32") for arch in SLICE_ARCHS}


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_slice_prefill_logits(slice_f32, arch):
    run = slice_f32[arch]
    assert run["port"]["prefill"].dtype == torch.float32
    _close(run["port"]["prefill"], run["ref"]["prefill"], SLICE_TOL)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_slice_prefill_cache(slice_f32, arch):
    ref, port = slice_f32[arch]["ref"]["cache"], \
        slice_f32[arch]["port"]["cache"]
    assert set(ref) == set(port)
    for key in ref:
        assert set(ref[key]) == set(port[key])
        for name, leaf in ref[key].items():
            assert tuple(port[key][name].shape) == leaf.shape, (key, name)
            _close(port[key][name], leaf, SLICE_TOL)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_slice_decode_logits(slice_f32, arch):
    run = slice_f32[arch]
    _close(run["port"]["decode"], run["ref"]["decode"], SLICE_TOL)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_slice_bf16_logits(arch):
    """bfloat16: the logits are a bf16 product (the tied embedding's
    einsum) cast to float32, one bf16 unit is 2^-9 at |logit| in
    [0.25, 0.5), and both sides round every activation in bf16 at other
    places (XLA rounds a fused elementwise chain once, torch each
    operator; the Mamba conv's float32 sum, ``test_torch_lm_kernels``).
    The reading is up to 4 units (0.008); the bound is 3e-2, 15 units."""
    run = _slice_run(arch, "bfloat16")
    _close(run["port"]["prefill"], run["ref"]["prefill"], BF16_LOGITS_TOL)
    _close(run["port"]["decode"], run["ref"]["decode"], BF16_LOGITS_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["llama3.2-3b", "mamba2-1.3b"])
def served(request):
    arch = request.param
    cfg = ref_smoke_config(arch).with_overrides(dtype="float32")
    tcfg = smoke_config(arch).with_overrides(dtype="float32")
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, "cpu")
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")
    return cfg, model, params, tmodel, tparams


def _serve_both(served, prompts, max_batch, max_len, n_new):
    cfg, model, params, tmodel, tparams = served
    ref = [RefRequest(prompt=list(p), request_id=i)
           for i, p in enumerate(prompts)]
    RefEngine(model, params, RefServeConfig(
        max_batch=max_batch, max_len=max_len, max_new_tokens=n_new)).run(ref)
    port = [Request(prompt=list(p), request_id=i)
            for i, p in enumerate(prompts)]
    engine = Engine(tmodel, tparams, ServeConfig(
        max_batch=max_batch, max_len=max_len, max_new_tokens=n_new,
        admission="lockstep"))
    engine.run(port)
    return ref, port, engine


def test_engine_single_request_matches_reference(served):
    ref, port, engine = _serve_both(served, [[5, 9, 2, 11, 3, 7, 1, 8]], 2,
                                    64, 6)
    assert port[0].out_tokens == ref[0].out_tokens and port[0].done
    t = engine.timings()
    assert t["prefills"] == 1 and t["decode_steps"] == 5


def test_engine_batch_of_requests_matches_reference(served):
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, served[0].vocab_size, 8)]
               for _ in range(5)]
    ref, port, engine = _serve_both(served, prompts, 2, 40, 5)
    for r, p in zip(ref, port):
        assert p.done and len(p.out_tokens) == 5
        assert p.out_tokens == r.out_tokens
    assert engine.timings()["prefills"] == 5


def test_engine_batched_equals_solo(served):
    """Slot isolation: a request decoded alone and inside a batch."""
    _, _, _, tmodel, tparams = served
    p1, p2 = [4, 8, 15, 16, 23, 42, 7, 9], [1, 2, 3, 4, 5, 6, 7, 8]
    solo = Request(prompt=list(p1))
    Engine(tmodel, tparams, ServeConfig(max_batch=1, max_len=48,
                                        max_new_tokens=4)).run([solo])
    r1, r2 = Request(prompt=list(p1)), Request(prompt=list(p2))
    Engine(tmodel, tparams, ServeConfig(max_batch=2, max_len=48,
                                        max_new_tokens=4)).run([r1, r2])
    assert solo.out_tokens == r1.out_tokens


def test_engine_sampling_draws_from_its_generator(served):
    _, _, _, tmodel, tparams = served
    outs = []
    for _ in range(2):
        req = Request(prompt=[3, 1, 4, 1, 5])
        Engine(tmodel, tparams, ServeConfig(
            max_batch=1, max_len=32, max_new_tokens=6, temperature=1.0),
            generator=torch.Generator().manual_seed(7)).run([req])
        outs.append(req.out_tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 6
    assert all(0 <= t < tmodel.cfg.vocab_size for t in outs[0])


# every arch's committed reference outputs: the dense and SSM archs in
# lm_reference.npz, the rest of the zoo in lm_zoo_reference.npz
GOLDEN_OF = {arch: LM_GOLDEN for arch in LM_ARCHS} \
    | {arch: LM_ZOO_GOLDEN for arch in LM_ZOO_ARCHS}


@pytest.mark.parametrize("arch", list(GOLDEN_OF))
def test_port_on_cpu_matches_lm_golden(arch):
    """What ``chip_smoke.py`` holds on the card, here on the CPU: the
    committed reference outputs from the committed parameters (and
    modality inputs; decode positions count a vision prefix), and the
    ``Engine``'s greedy tokens where the file holds them (for the MoE
    archs, two identical prompts decoding in one wave)."""
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    with np.load(GOLDEN_OF[arch]) as z:
        g = {k: z[k] for k in z.files if k.startswith(arch + "/")}
    model = build_model(cfg, "cpu")
    params = lm_params_from_numpy(nested_from_flat(g, f"{arch}/params"),
                                  cfg, "cpu")
    batch = {"tokens": g[f"{arch}/tokens"]}
    for name in ("frames", "patches"):
        if f"{arch}/{name}" in g:
            batch[name] = g[f"{arch}/{name}"]
    logits, _ = model.prefill(params, batch)
    _close(logits, g[f"{arch}/prefill_logits"], SLICE_TOL)
    pos = g[f"{arch}/decode_pos"]
    start = batch["tokens"].shape[1] - len(pos)
    _, cache = model.prefill(params, dict(batch,
                                          tokens=batch["tokens"][:, :start]))
    cache = _pad_kv(cache, len(pos), torch)
    for i, p in enumerate(pos):
        t = start + i
        logits, cache = model.decode_step(params, cache,
                                          batch["tokens"][:, t:t + 1], int(p))
        _close(logits, g[f"{arch}/decode_logits"][i], SLICE_TOL)
    if f"{arch}/engine_prompts" not in g:
        return
    reqs = [Request(prompt=[int(t) for t in p], request_id=i)
            for i, p in enumerate(g[f"{arch}/engine_prompts"])]
    Engine(model, params, ServeConfig(
        max_batch=LM_ENGINE["max_batch"], max_len=LM_ENGINE["max_len"],
        max_new_tokens=LM_ENGINE["new_tokens"],
        admission="lockstep")).run(reqs)
    assert [r.out_tokens for r in reqs] \
        == g[f"{arch}/engine_tokens"].tolist()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b"])
def test_launcher_serves_lm_on_cpu(arch):
    args = launch.parse_args(["--workload", "lm", "--arch", arch,
                              "--requests", "3", "--new-tokens", "4",
                              "--torch-device", "cpu"])
    engine, reqs, dt = launch.run_lm(args)
    assert engine.model.cfg == smoke_config(arch) and dt > 0
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    assert all(len(r.prompt) == 16 for r in reqs)
    assert launch.parse_args([]).workload == "cnn"


# ---------------------------------------------------------------------------
# the parameter carrier
# ---------------------------------------------------------------------------

def test_params_from_numpy_takes_bf16_and_checks_shapes():
    cfg = ref_smoke_config("llama3.2-3b")                    # bfloat16
    tcfg = smoke_config("llama3.2-3b")
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    assert tree["embed"].dtype.name == "bfloat16"
    got = lm_params_from_numpy(tree, tcfg, "cpu")
    f32 = lm_params_from_numpy(jax.tree.map(_np, params), tcfg, "cpu")
    assert got["embed"].dtype == torch.bfloat16
    assert got["final_norm"].dtype == torch.float32
    assert torch.equal(got["stack"]["s0"]["attn"]["wq"],
                       f32["stack"]["s0"]["attn"]["wq"])
    assert np.array_equal(got["embed"].float().numpy(), _np(tree["embed"]))
    bad = jax.tree.map(_np, params)
    bad["embed"] = bad["embed"][:, :-1]
    with pytest.raises(ValueError, match="params.embed: shape"):
        lm_params_from_numpy(bad, tcfg, "cpu")
    del bad["embed"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(bad, tcfg, "cpu")
    ints = jax.tree.map(lambda a: np.zeros(a.shape, np.int32), params)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lm_params_from_numpy(ints, tcfg, "cpu")
