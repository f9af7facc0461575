"""Unified decoder LM (+ optional encoder for Whisper).

Port of ``repro.models.transformer``: ``forward_train``, ``prefill`` and
``decode_step`` for every family of the zoo — dense, MoE MLPs
(``models.moe``), Mamba-2 and hybrid stacks, the encoder-decoder
(Whisper: ``frames``) and the vision prefix (Pixtral: ``patches``), the
modality inputs arriving as precomputed embeddings as in the reference.
The stack holds ``n_cycles`` stacked *cycles* (the repeating sublayer
pattern from the config): every parameter and cache leaf leads with an
``n_cycles`` dimension, as the reference's ``lax.scan`` carries them,
and a Python loop walks the cycles.

Training rematerializes every sublayer, as the reference's
``jax.checkpoint`` does, with ``torch.utils.checkpoint`` (non-reentrant):
``remat_policy="full"`` recomputes the whole sublayer in the backward,
``"save_mixer_out"`` checkpoints the mixer half and the MLP half apart,
so the mixer's output (the MLP half's input) is kept.  The recompute
runs the forward again, kernels included.  The loss adds every MoE
MLP's aux loss; the reference's scan adds only each cycle's last
sublayer's, which differs where a cycle holds more than one MoE MLP
(Jamba).

Cache layout (decode): a dictionary ``{"s<j>": {leaf: tensor}}`` whose
leaves lead with ``n_cycles``.  ``decode_step`` writes each layer's new
K/V and SSM state into the cache it is given, in place (the reference
returns an updated copy), and returns the same dictionary.

Each stacked parameter leaf is allocated once and every cycle is drawn
into its slice (``_draw_stacked``), so a model's weights exist once at
the peak of the draw, not twice.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, DENSE, NONE)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (const_init, dense_init, embed_init,
                                       init_mlp, mlp, rms_norm, softcap)
from repro_torch.parallel.sharding import (gather_data_axes, is_dtensor,
                                           kernel_placements, shard_map)
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_sublayer(gen, cfg, sub, *, cross: bool = False):
    p = {"ln1": const_init(gen, (cfg.d_model,), 0.0)}
    if sub.mixer in (ATTN, LOCAL_ATTN):
        p["attn"] = attn_mod.init_attention(gen, cfg)
    elif sub.mixer == MAMBA:
        p["mamba"] = ssm_mod.init_mamba(gen, cfg)
    if cross:
        p["ln_x"] = const_init(gen, (cfg.d_model,), 0.0)
        p["cross"] = attn_mod.init_attention(gen, cfg)
    if sub.mlp != NONE:
        p["ln2"] = const_init(gen, (cfg.d_model,), 0.0)
        if sub.mlp == DENSE:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                                cfg.torch_dtype)
        else:
            p["moe"] = moe_mod.init_moe(gen, cfg)
    return p


def _init_enc_layer(gen, cfg):
    """One encoder layer: bidirectional attention and a dense MLP."""
    return {"s0": {
        "ln1": const_init(gen, (cfg.d_model,), 0.0),
        "attn": attn_mod.init_attention(gen, cfg),
        "ln2": const_init(gen, (cfg.d_model,), 0.0),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                        cfg.torch_dtype)}}


def _copy_into(stack: Dict, tree: Dict, i: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _copy_into(stack[k], v, i)
        else:
            stack[k][i].copy_(v)


def _draw_stacked(draw: Callable[[], Dict], n: int) -> Dict:
    """``n`` calls of ``draw`` stacked leafwise, as ``torch.stack`` of
    the list of draws would give them, but each stacked leaf allocated
    once: every draw is copied into its slice and freed before the
    next, so the peak is the stack and one draw (one draw stacks as
    views, with no copy)."""
    first = draw()
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    stack = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    _copy_into(stack, first, 0)
    del first
    for i in range(1, n):
        _copy_into(stack, draw(), i)
    return stack


def index_tree(tree, i: int):
    """The ``i``-th cycle of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int):
    """The ``n`` cycles of a stacked tree (views, no copies), each leaf
    cut by one ``unbind``: its backward stacks the cycles' gradients
    once, where indexing every cycle apart would add a zero-padded
    gradient of the whole stacked leaf per cycle."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def init_params(gen, cfg):
    """Parameters drawn from ``gen`` on its device; with ``gen=None``,
    empty tensors of the same shapes and dtypes on ``meta``.  The draws
    run in a fixed order: the embedding, the decoder cycles, the
    unembedding, then the encoder layers."""
    dt = cfg.torch_dtype
    params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": const_init(gen, (cfg.d_model,), 0.0),
        "stack": _draw_stacked(
            lambda: {f"s{j}": _init_sublayer(gen, cfg, sub,
                                             cross=cfg.enc_dec)
                     for j, sub in enumerate(cfg.layer_cycle)},
            cfg.n_cycles),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dt, fan_in=cfg.d_model)
    if cfg.enc_dec:
        params["enc_stack"] = _draw_stacked(
            lambda: _init_enc_layer(gen, cfg), cfg.n_enc_layers)
        params["enc_norm"] = const_init(gen, (cfg.d_model,), 0.0)
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, enc_len: int = 0,
               device: DeviceLike = "cuda"):
    """Zero-initialized decode cache (leaves lead with n_cycles), on the
    card unless the caller passes ``device="cpu"``.  An encoder-decoder's
    entries also hold the cross-attention K/V (``ck``, ``cv``) over
    ``enc_len`` encoder positions."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    cache = {}

    def zeros(*shape, dtype=dt):
        return torch.zeros((cfg.n_cycles,) + shape, dtype=dtype,
                           device=device)

    for j, sub in enumerate(cfg.layer_cycle):
        if sub.mixer in (ATTN, LOCAL_ATTN):
            kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            entry = {"k": zeros(*kv), "v": zeros(*kv)}
        elif sub.mixer == MAMBA:
            one = ssm_mod.init_mamba_cache(cfg, batch, device)
            entry = {k: zeros(*v.shape, dtype=v.dtype)
                     for k, v in one.items()}
        else:
            entry = {}
        if cfg.enc_dec:
            ckv = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
            entry["ck"], entry["cv"] = zeros(*ckv), zeros(*ckv)
        cache[f"s{j}"] = entry
    return cache


def _cache_on_mesh(cfg, batch: int, max_len: int, enc_len: int, mesh,
                   device):
    """``init_cache`` as DTensors on ``mesh``, each leaf placed by
    ``ShardingRules.cache_spec`` (the placement the decode steps take
    their cache in), each device allocating only its shard."""
    from repro_torch.parallel.sharding import ShardingRules, placed_zeros
    abstract = init_cache(cfg, batch, max_len, enc_len, "meta")
    spec = ShardingRules(cfg, mesh).cache_spec(abstract)
    return tree_map(lambda t, sp: placed_zeros(t.shape, t.dtype, mesh, sp,
                                               device), abstract, spec)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mixer(p, x, cfg, sub, *, mode, cache, cache_pos, enc_out):
    """The first half of a sublayer: its mixer (attention or Mamba) and
    the cross attention, each with its residual.  Returns (x, new cache
    entries: none in train mode)."""
    new_cache = {}
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    window = cfg.sliding_window if sub.mixer == LOCAL_ATTN else None

    if sub.mixer in (ATTN, LOCAL_ATTN):
        if mode == "train":
            y, _ = attn_mod.attention_block(p["attn"], h, cfg, causal=True,
                                            window=window)
        elif mode == "prefill":
            y, kv = attn_mod.attention_block(p["attn"], h, cfg, causal=True,
                                             window=window, return_kv=True)
            new_cache["k"], new_cache["v"] = kv
        else:  # decode
            y, kv = attn_mod.attention_block(
                p["attn"], h, cfg, window=window,
                cache_kv=(cache["k"], cache["v"]), cache_pos=cache_pos)
            new_cache["k"], new_cache["v"] = kv
        x = x + y
    elif sub.mixer == MAMBA:
        # train keeps no state (None); prefill starts from empty states
        # ({}: the kernel's zero halo)
        mcache = None if mode == "train" else (
            {k: cache[k] for k in ("conv_x", "conv_B", "conv_C", "ssm")}
            if mode == "decode" else {})
        y, mc = ssm_mod.mamba_block(p["mamba"], h, cfg, cache=mcache)
        if mc is not None:
            new_cache.update(mc)
        x = x + y

    if "cross" in p:
        # cross attention over the encoder's output: its K/V are computed
        # in train and prefill (prefill writes them to the cache) and
        # read back in decode
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        if mode == "decode":
            ckv = (cache["ck"], cache["cv"])
        else:
            ckv = attn_mod.init_cross_kv(p["cross"], enc_out, cfg)
            if mode == "prefill":
                new_cache["ck"], new_cache["cv"] = ckv
        y, _ = attn_mod.attention_block(p["cross"], h, cfg, cross_kv=ckv)
        x = x + y
    return x, new_cache


def _mlp_half(p, x, cfg, sub):
    """The second half of a sublayer: its MLP with the residual.
    Returns (x, the MoE MLP's aux loss or None)."""
    if sub.mlp == NONE:
        return x, None
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if sub.mlp == DENSE:
        return x + mlp(p["mlp"], h, cfg.act), None
    y, aux = moe_mod.moe_layer(p["moe"], h, cfg)
    return x + y, aux


def _run_sublayer(p, x, cfg, sub, *, mode, cache, cache_pos, enc_out):
    """mode: 'train' | 'prefill' | 'decode'.  Returns (x, new cache
    entries, the MoE MLP's aux loss or None)."""
    x, new_cache = _mixer(p, x, cfg, sub, mode=mode, cache=cache,
                          cache_pos=cache_pos, enc_out=enc_out)
    x, aux = _mlp_half(p, x, cfg, sub)
    return x, new_cache, aux


def _gathered(tree):
    """``tree`` with every fsdp weight's data-axis shards gathered
    (``parallel.sharding.gather_data_axes``); plain tensors as they
    are."""
    return tree_map(gather_data_axes, tree)


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (``jax.checkpoint``'s counterpart) where grad is enabled."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _train_sublayer(p, x, cfg, sub, enc_out):
    """One sublayer in train mode under ``cfg.remat_policy``.  Returns
    (x, the MoE MLP's aux loss or None)."""
    # an fsdp weight is gathered inside the rematerialized function, so
    # the recompute gathers it again instead of keeping it whole
    def mixer(p_, x_, enc_):
        return _mixer(_gathered(p_), x_, cfg, sub, mode="train", cache=None,
                      cache_pos=None, enc_out=enc_)[0]

    def mlp_half(p_, x_):
        return _mlp_half(_gathered(p_), x_, cfg, sub)

    if cfg.remat_policy == "save_mixer_out":
        return _remat(mlp_half, p, _remat(mixer, p, x, enc_out))
    return _remat(lambda p_, x_, enc_: mlp_half(p_, mixer(p_, x_, enc_)),
                  p, x, enc_out)


def _run_stack(params, x, cfg, *, mode, cache=None, cache_pos=None,
               enc_out=None):
    """Walk the cycle stack.  Returns (x, aux): in train mode (no cache)
    aux is the sum of every MoE MLP's aux loss, a float32 scalar; in
    prefill and decode each layer's new cache entries are written into
    ``cache`` (leaves lead with n_cycles) in place and aux is None (the
    aux losses are dropped, as the reference's prefill and decode drop
    them)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if mode == "train" else None
    for i, cyc_params in enumerate(unstack(params["stack"], cfg.n_cycles)):
        for j, sub in enumerate(cfg.layer_cycle):
            key = f"s{j}"
            if mode == "train":
                x, a = _train_sublayer(cyc_params[key], x, cfg, sub,
                                       enc_out)
                if a is not None:
                    aux = aux + a
                continue
            sub_cache = index_tree(cache[key], i)
            x, nc, _ = _run_sublayer(_gathered(cyc_params[key]), x, cfg, sub,
                                     mode=mode, cache=sub_cache,
                                     cache_pos=cache_pos, enc_out=enc_out)
            for name, val in nc.items():
                dst = sub_cache[name]
                if _data_ptr(val) != _data_ptr(dst):
                    dst.copy_(val)
    return x, aux


def _data_ptr(t) -> int:
    """Where ``t``'s data starts (a DTensor's: its local shard's)."""
    return (t.to_local() if is_dtensor(t) else t).data_ptr()


def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.int64,
                           device=params["embed"].device)


def _frontend_input(params, batch, name, cfg) -> torch.Tensor:
    """``batch[name]`` (``frames`` or ``patches``, (B, F, D) precomputed
    embeddings) on the parameters' device in the model's dtype."""
    return torch.as_tensor(batch[name], device=params["embed"].device) \
        .to(cfg.torch_dtype)


def _lookup(table, tokens):
    """``table[tokens]``.  Under a mesh the gather runs under
    ``local_map`` (DTensor's sharding rules for the gather's backward,
    ``index_put``, fail on these placements): a vocab-sharded table is
    looked up on each device among its own rows, the others masked to
    zero, and the partial sums all-reduced — the vocab-parallel
    embedding, an explicit ``redistribute``; a table sharded over
    ``d_model`` is looked up shard by shard and the output gathered;
    tokens keep their batch shards where the table is replicated over
    that axis."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    t_pl, x_pl, out_pl, vocab_axis = [], [], [], None
    for a, (pt, px) in enumerate(zip(table.placements, tokens.placements)):
        batch = isinstance(px, Shard) and px.dim == 0
        if isinstance(pt, Shard) and not batch and (
                pt.dim == 1 or vocab_axis is None):
            t_pl.append(pt)
            x_pl.append(Replicate())
            if pt.dim == 0:
                vocab_axis = a
                out_pl.append(Partial())
            else:
                out_pl.append(Shard(2))
        else:
            t_pl.append(Replicate())
            x_pl.append(Shard(0) if batch else Replicate())
            out_pl.append(Shard(0) if batch else Replicate())

    def look(tab, tok):
        if vocab_axis is None:
            return tab[tok]
        rows = tab.shape[0]
        idx = tok - mesh.get_local_rank(vocab_axis) * rows
        ok = (idx >= 0) & (idx < rows)
        return tab[idx.clamp(0, rows - 1)] * ok[..., None].to(tab.dtype)

    x = shard_map(look, mesh, (t_pl, x_pl), out_pl)(table, tokens)
    # the residual stream replicated over the model axis (Megatron's
    # layout): a d_model-sharded stream would meet a head-sharded bias
    # in Mamba's dt, which torch 2.11's DTensor cannot add
    return x.redistribute(placements=[
        Replicate() if isinstance(p, Partial) or p == Shard(2) else p
        for p in x.placements])


def _embed(params, tokens, cfg):
    x = _lookup(params["embed"], tokens)
    if cfg.scale_embeddings:
        # the scale rounded to the stream's dtype on the host, as a
        # Python number: no copy to the device (a CUDA graph's capture
        # allows none), the same product as with a tensor of that dtype
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def _logits(params, x, cfg):
    x = rms_norm(x, gather_data_axes(params["final_norm"]), cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["unembed"]
    return softcap(logits.float(), cfg.final_softcap)


def _encode(params, frames, cfg):
    """Whisper encoder over stub frame embeddings (B, F, D): sinusoidal
    positions, then per layer bidirectional attention and the MLP, then
    the encoder's final norm."""
    f, d = frames.shape[1], cfg.d_model
    pos = torch.arange(f, dtype=torch.float32, device=frames.device)
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=frames.device) / d))
    ang = pos[:, None] * inv[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    x = frames + pe[None].to(frames.dtype)
    for layer in unstack(params["enc_stack"], cfg.n_enc_layers):
        p = _gathered(layer["s0"])
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, _ = attn_mod.attention_block(p["attn"], h, cfg, causal=False)
        x = x + y
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(p["mlp"], h, cfg.act)
    return rms_norm(x, gather_data_axes(params["enc_norm"]), cfg.norm_eps)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _embed_inputs(params, batch, cfg):
    """The token embeddings with a vision prefix in front, and the
    encoder's output for an encoder-decoder.  Returns (x, tokens, the
    prefix's length, enc_out or None)."""
    tokens = _tokens(params, batch["tokens"])
    x = _embed(params, tokens, cfg)
    n_front, enc_out = 0, None
    if cfg.frontend == "vision":
        patches = _frontend_input(params, batch, "patches", cfg)
        n_front = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    if cfg.enc_dec:
        enc_out = _encode(params, _frontend_input(params, batch, "frames",
                                                  cfg), cfg)
    return x, tokens, n_front, enc_out


def _gold(logits, labels):
    """Each label's logit, (B, S).  Under a mesh the gather runs under
    ``local_map`` on the batch shards with the vocab gathered whole:
    DTensor's sharding rule for ``gather`` fails inside its masked
    partial reduction (torch 2.13)."""
    def take(lg, lb):
        return torch.gather(lg, -1, lb[..., None])[..., 0]
    if not is_dtensor(logits):
        return take(logits, labels)
    pl = kernel_placements(logits, lambda d, n: d == 0)
    return shard_map(take, logits.device_mesh, (pl, pl), pl)(logits, labels)


def forward_train(params, batch, cfg):
    """batch: tokens (B, S), labels (B, S) (below 0: masked), [patches
    (B, P, D) | frames (B, F, D)].  Returns (loss, metrics): the mean
    next-token NLL over the valid labels plus the MoE aux losses, and
    ``nll``, ``aux`` and ``tokens`` (the valid labels' count)."""
    x, tokens, n_front, enc_out = _embed_inputs(params, batch, cfg)
    labels = torch.as_tensor(batch["labels"], dtype=torch.int64,
                             device=tokens.device)
    x, aux = _run_stack(params, x, cfg, mode="train", enc_out=enc_out)
    if n_front:
        x = x[:, n_front:]
    logits = _logits(params, x, cfg)

    valid = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels.clamp(min=0))
    nll = ((logz - gold) * valid).sum() / valid.sum().clamp(min=1)
    metrics = {"nll": nll, "aux": aux,
               "tokens": valid.sum().to(torch.int32)}
    return nll + aux, metrics


def prefill(params, batch, cfg):
    """Full-sequence prefill.  batch: tokens (B, S) [, patches (B, P, D)
    | frames (B, F, D)].  Returns (last-position logits (B,V), cache);
    a vision prefix's P positions come first in the cache, so decode
    positions count them."""
    x, tokens, _, enc_out = _embed_inputs(params, batch, cfg)
    enc_len = 0 if enc_out is None else enc_out.shape[1]
    if is_dtensor(x):
        cache = _cache_on_mesh(cfg, tokens.shape[0], x.shape[1], enc_len,
                               x.device_mesh, x.device)
    else:
        cache = init_cache(cfg, tokens.shape[0], x.shape[1], enc_len,
                           x.device)
    x, _ = _run_stack(params, x, cfg, mode="prefill", cache=cache,
                      enc_out=enc_out)
    logits = _logits(params, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(params, cache, token, pos, cfg):
    """One decode step.  token: (B,1) ints; pos: int (write slot), or a
    (B,) integer tensor of each row's own write slot (attention rows
    rotate, write and attend at their own position).  Returns (logits
    (B,V), cache), the cache updated in place."""
    x = _embed(params, _tokens(params, token), cfg)
    if torch.is_tensor(pos):
        pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    else:
        pos = int(pos)
    x, _ = _run_stack(params, x, cfg, mode="decode", cache=cache,
                      cache_pos=pos)
    logits = _logits(params, x, cfg)
    return logits[:, 0], cache
