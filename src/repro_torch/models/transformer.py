"""Unified decoder LM: the dense and SSM families.

Port of ``repro.models.transformer`` for decoder-only models without MoE
MLPs or a modality frontend (Llama, Gemma-2, Granite, Mamba-2).  The
stack holds ``n_cycles`` stacked *cycles* (the repeating sublayer
pattern from the config): every parameter and cache leaf leads with an
``n_cycles`` dimension, as the reference's ``lax.scan`` carries them,
and a Python loop walks the cycles.  The reference's rematerialization
(``jax.checkpoint``) is a training concern and has no counterpart in
this inference path.

Cache layout (decode): a dictionary ``{"s<j>": {leaf: tensor}}`` whose
leaves lead with ``n_cycles``.  ``decode_step`` writes each layer's new
K/V and SSM state into the cache it is given, in place (the reference
returns an updated copy), and returns the same dictionary.

An MoE MLP raises ``NotImplementedError``: the MoE layer itself is
ported (``models.moe``, served by the MoE workload), but its place in
the LM waits for ROADMAP's LM-zoo item, as do an encoder-decoder and a
modality frontend; ``forward_train`` waits for the training slice.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, DENSE, MOE,
                                      NONE)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (const_init, dense_init, embed_init,
                                       init_mlp, mlp, rms_norm, softcap)


def check_supported(cfg) -> None:
    """Raise for what this slice of the port does not run yet."""
    if any(sub.mlp == MOE for sub in cfg.layer_cycle):
        raise NotImplementedError(
            f"{cfg.name}: the MoE layer is ported (repro_torch.models.moe) "
            f"but an LM's MoE MLP is not yet (ROADMAP: the LM-zoo item)")
    if cfg.enc_dec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models and modality frontends are "
            f"not ported yet (ROADMAP: the LM-zoo item)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_sublayer(gen, cfg, sub):
    p = {"ln1": const_init(gen, (cfg.d_model,), 0.0)}
    if sub.mixer in (ATTN, LOCAL_ATTN):
        p["attn"] = attn_mod.init_attention(gen, cfg)
    elif sub.mixer == MAMBA:
        p["mamba"] = ssm_mod.init_mamba(gen, cfg)
    if sub.mlp != NONE:
        p["ln2"] = const_init(gen, (cfg.d_model,), 0.0)
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                            cfg.torch_dtype)
    return p


def _stack(trees: List[Dict]) -> Dict:
    """Leafwise ``torch.stack`` of equally shaped nested dictionaries."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def index_tree(tree, i: int):
    """The ``i``-th cycle of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(gen, cfg):
    """Parameters drawn from ``gen`` on its device; with ``gen=None``,
    empty tensors of the same shapes and dtypes on ``meta``."""
    check_supported(cfg)
    dt = cfg.torch_dtype
    params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": const_init(gen, (cfg.d_model,), 0.0),
        "stack": _stack([
            {f"s{j}": _init_sublayer(gen, cfg, sub)
             for j, sub in enumerate(cfg.layer_cycle)}
            for _ in range(cfg.n_cycles)]),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dt, fan_in=cfg.d_model)
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int,
               device: DeviceLike = "cuda"):
    """Zero-initialized decode cache (leaves lead with n_cycles), on the
    card unless the caller passes ``device="cpu"``."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = cfg.torch_dtype
    cache = {}
    for j, sub in enumerate(cfg.layer_cycle):
        if sub.mixer in (ATTN, LOCAL_ATTN):
            kv = (cfg.n_cycles, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            entry = {"k": torch.zeros(kv, dtype=dt, device=device),
                     "v": torch.zeros(kv, dtype=dt, device=device)}
        elif sub.mixer == MAMBA:
            one = ssm_mod.init_mamba_cache(cfg, batch, device)
            entry = {k: torch.zeros((cfg.n_cycles,) + tuple(v.shape),
                                    dtype=v.dtype, device=device)
                     for k, v in one.items()}
        else:
            entry = {}
        cache[f"s{j}"] = entry
    return cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _run_sublayer(p, x, cfg, sub, *, mode, cache, cache_pos):
    """mode: 'prefill' | 'decode'.  Returns (x, new cache entries)."""
    new_cache = {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    window = cfg.sliding_window if sub.mixer == LOCAL_ATTN else None

    if sub.mixer in (ATTN, LOCAL_ATTN):
        if mode == "prefill":
            y, kv = attn_mod.attention_block(p["attn"], h, cfg, causal=True,
                                             window=window, return_kv=True)
        else:  # decode
            y, kv = attn_mod.attention_block(
                p["attn"], h, cfg, window=window,
                cache_kv=(cache["k"], cache["v"]), cache_pos=cache_pos)
        new_cache["k"], new_cache["v"] = kv
        x = x + y
    elif sub.mixer == MAMBA:
        # prefill starts from empty states ({}: the kernel's zero halo)
        mcache = ({k: cache[k] for k in ("conv_x", "conv_B", "conv_C", "ssm")}
                  if mode == "decode" else {})
        y, mc = ssm_mod.mamba_block(p["mamba"], h, cfg, cache=mcache)
        new_cache.update(mc)
        x = x + y

    if sub.mlp != NONE:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(p["mlp"], h, cfg.act)
    return x, new_cache


def _run_stack(params, x, cfg, *, mode, cache, cache_pos=None):
    """Walk the cycle stack, writing each layer's new cache entries into
    ``cache`` (leaves lead with n_cycles) in place.  Returns x."""
    for i in range(cfg.n_cycles):
        cyc_params = index_tree(params["stack"], i)
        for j, sub in enumerate(cfg.layer_cycle):
            key = f"s{j}"
            sub_cache = index_tree(cache[key], i)
            x, nc = _run_sublayer(cyc_params[key], x, cfg, sub, mode=mode,
                                  cache=sub_cache, cache_pos=cache_pos)
            for name, val in nc.items():
                dst = sub_cache[name]
                if val.data_ptr() != dst.data_ptr():
                    dst.copy_(val)
    return x


def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.int64,
                           device=params["embed"].device)


def _embed(params, tokens, cfg):
    x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params, x, cfg):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["unembed"]
    return softcap(logits.float(), cfg.final_softcap)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def prefill(params, batch, cfg):
    """Full-sequence prefill.  Returns (last-position logits (B,V), cache)."""
    check_supported(cfg)
    tokens = _tokens(params, batch["tokens"])
    x = _embed(params, tokens, cfg)
    cache = init_cache(cfg, tokens.shape[0], x.shape[1], x.device)
    x = _run_stack(params, x, cfg, mode="prefill", cache=cache)
    logits = _logits(params, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(params, cache, token, pos, cfg):
    """One decode step.  token: (B,1) ints; pos: int (write slot).
    Returns (logits (B,V), cache), the cache updated in place."""
    check_supported(cfg)
    x = _embed(params, _tokens(params, token), cfg)
    x = _run_stack(params, x, cfg, mode="decode", cache=cache,
                   cache_pos=int(pos))
    logits = _logits(params, x, cfg)
    return logits[:, 0], cache
