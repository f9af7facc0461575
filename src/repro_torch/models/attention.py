"""Attention: GQA with optional sliding window, logit softcaps and KV cache.

Port of ``repro.models.attention``.  A full-sequence causal call without
window, softcap or cache masking — the prefill of a dense model such as
Llama — goes to the attention kernel K8
(``kernels.flash_attention.flash_attention``: the CUDA kernel on the
card, its plain version on the CPU).  Every other call takes the
reference's chunked path: the query is cut into chunks so the live
logits tensor is O(B·H·chunk·T) instead of O(B·H·S·T); decode (a single
query position against a cache) takes the direct path.

Under a mesh (q, k and v are DTensors, placed by
``parallel.sharding.ShardingRules``) K8, a ctypes launch that cannot take
a DTensor, and the chunked path both run under ``local_map``: each
device attends over its own shards, the batch over the data axes and
the heads over ``model`` where both the query and the kv heads divide it
(``_on_shards``).  Tensors on ``meta`` (the dry run) take the chunked
path, the path the reference's dry run lowers.

Two things the reference's zoo has not, for the port-only Qwen3-30B-A3B:
a config with ``qk_norm`` (``configs.qwen3_30b_a3b.QKNormConfig``)
RMS-normalizes each query and key head over ``head_dim`` before RoPE,
with per-layer ``q_norm`` and ``k_norm`` weights; and a decode step may
take its cache position per row, a (B,) integer tensor: each row rotates,
writes its K/V and attends to ``[0, pos[b]]`` at its own position.  An
int position takes the reference's path and gives its numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, const_init, dense_init,
                                       rms_norm, softcap)
from repro_torch.parallel.sharding import (P, is_dtensor, kernel_placements,
                                           shard_map, to_placements)

NEG_INF = -2.3819763e38  # most-negative bf16-representable


def init_attention(gen, cfg):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    p = {
        "wq": dense_init(gen, (d, h, hd), dt, fan_in=d),
        "wk": dense_init(gen, (d, kh, hd), dt, fan_in=d),
        "wv": dense_init(gen, (d, kh, hd), dt, fan_in=d),
        "wo": dense_init(gen, (h, hd, d), dt, fan_in=h * hd),
    }
    if getattr(cfg, "qk_norm", False):     # no config of the reference's
        p["q_norm"] = const_init(gen, (hd,), 0.0)
        p["k_norm"] = const_init(gen, (hd,), 0.0)
    return p


def _attend(qc, k, v, row_pos, col_pos, *, causal, window, valid_len, cap,
            scale, logits_dtype=torch.float32):
    """qc: (B,C,KH,G,Dh)  k,v: (B,T,KH,Dh)  row_pos: (C,), or (B,C) per
    row  col_pos: (T,)  valid_len: None, an int, or (B,) per row."""
    logits = torch.einsum("bckgd,btkd->bckgt", qc.to(logits_dtype),
                          k.to(logits_dtype)).float() * scale
    logits = softcap(logits, cap)
    rows = (row_pos if row_pos.ndim == 2 else row_pos[None])[:, :, None]
    cols = col_pos[None, None, :]
    mask = torch.ones(rows.shape[:2] + cols.shape[2:], dtype=torch.bool,
                      device=qc.device)                      # (B|1, C, T)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    if torch.is_tensor(valid_len):
        mask &= cols < valid_len[:, None, None]
    elif valid_len is not None:
        mask &= cols < valid_len
    logits = torch.where(mask[:, :, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bckgt,btkd->bckgd", probs.to(logits_dtype),
                       v.to(logits_dtype))
    return out.to(v.dtype)


def uses_flash_kernel(s: int, *, causal: bool, window, cap, q_offset,
                      kv_valid_len, logits_bf16: bool = False,
                      device: torch.device = None) -> bool:
    """The dispatch rule of K8, on the call's arguments alone: a
    full-sequence causal call (S > 1) with no window, softcap or cache
    masking, from position 0 — the prefill of a dense model.  Calls that
    ask for bf16 logits keep the chunked path, which computes them so,
    and so do tensors on ``meta``, which no kernel runs on."""
    return (s > 1 and causal and window is None and cap is None
            and kv_valid_len is None and isinstance(q_offset, int)
            and q_offset == 0 and not logits_bf16
            and (device is None or device.type != "meta"))


def _maybe_batch_shard(x, enable: bool):
    """The reference's §Perf hint: when the heads do not divide the
    model axis the attention math is replicated across ``model``;
    resharding the *batch* over (data, model) instead parallelizes it, at
    the cost of two boundary reshards.  An explicit ``redistribute`` of
    a DTensor; without a mesh (a plain tensor) nothing to do."""
    if not enable or not is_dtensor(x):
        return x
    spec = P(("data", "model"), *([None] * (x.ndim - 1)))
    return x.redistribute(placements=to_placements(spec, x.device_mesh))


def _on_shards(fn, q, k, v):
    """``fn(q, k, v)`` under ``local_map`` on DTensors: each device runs
    it on its shards.  q keeps a shard of the batch (dim 0) and of the
    heads (dim 2, where the axis divides both the query and the kv
    heads, so every query head's kv head is local); any other placement
    (a sequence-sharded cache, a partial sum) is gathered first.  k and
    v follow q's placements; the output has them too."""
    h, kh = q.shape[2], k.shape[2]
    pl = kernel_placements(
        q, lambda d, n: d == 0 or (d == 2 and h % n == 0 and kh % n == 0))
    return shard_map(fn, q.device_mesh, (pl, pl, pl), pl)(q, k, v)


def _flash(q, k, v):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)


def multi_head_attention(q, k, v, *, causal: bool,
                         window: Optional[int] = None,
                         cap: Optional[float] = None,
                         q_offset=0,
                         kv_valid_len=None,
                         q_chunk: int = 1024,
                         batch_shard: bool = False,
                         logits_bf16: bool = False):
    """q: (B,S,H,Dh); k,v: (B,T,KH,Dh) -> (B,S,H,Dh).

    ``q_offset``: absolute position of q[0] (decode against a cache),
    an int or, per row, a (B,) integer tensor.
    ``kv_valid_len``: scalar — mask cache positions >= it (decode); with
    a per-row ``q_offset``, per row too, (B,).
    ``batch_shard``: reshard DTensor inputs and output with the batch
    over (data, model) (``_maybe_batch_shard``).
    """
    s = q.shape[1]
    q = _maybe_batch_shard(q, batch_shard)
    k = _maybe_batch_shard(k, batch_shard)
    v = _maybe_batch_shard(v, batch_shard)
    if uses_flash_kernel(s, causal=causal, window=window, cap=cap,
                         q_offset=q_offset, kv_valid_len=kv_valid_len,
                         logits_bf16=logits_bf16, device=q.device):
        attend = _flash
    else:
        def attend(q_, k_, v_):
            return _chunked(q_, k_, v_, causal=causal, window=window,
                            cap=cap, q_offset=q_offset,
                            kv_valid_len=kv_valid_len, q_chunk=q_chunk,
                            logits_bf16=logits_bf16)
    # under a mesh K8 (a ctypes launch) and the chunk loop run on each
    # device's shards
    out = _on_shards(attend, q, k, v) if is_dtensor(q) else attend(q, k, v)
    return _maybe_batch_shard(out, batch_shard)


def _chunked(q, k, v, *, causal, window, cap, q_offset, kv_valid_len,
             q_chunk, logits_bf16):
    """The reference's attention: one chunk of queries at a time, or the
    single query position of a decode step."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / (hd ** 0.5)
    ldt = torch.bfloat16 if logits_bf16 else torch.float32
    qg = q.reshape(b, s, kh, g, hd)
    col_pos = torch.arange(t, device=q.device)

    if s == 1:  # decode: single query position, no chunking
        if torch.is_tensor(q_offset):          # a position per row
            row_pos = q_offset.reshape(b, 1)
        else:
            # a fill, not a copy from the host, which would wait for the
            # card
            row_pos = torch.full((1,), int(q_offset), dtype=torch.int64,
                                 device=q.device)
        out = _attend(qg, k, v, row_pos, col_pos, causal=causal,
                      window=window, valid_len=kv_valid_len, cap=cap,
                      scale=scale, logits_dtype=ldt)
        return out.reshape(b, s, h, hd)

    n_chunks = max(1, -(-s // q_chunk))
    while s % n_chunks:
        n_chunks += 1
    c = s // n_chunks
    outs = []
    for idx in range(n_chunks):
        row_pos = q_offset + idx * c + torch.arange(c, device=q.device)
        outs.append(_attend(qg[:, idx * c:(idx + 1) * c], k, v, row_pos,
                            col_pos, causal=causal, window=window,
                            valid_len=kv_valid_len, cap=cap, scale=scale,
                            logits_dtype=ldt))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """``jax.lax.dynamic_update_slice(cache, new, (0, pos, 0, 0))`` in
    place: the start clamps to [0, T - S] as XLA's does.  A per-row
    ``pos`` (B,) writes each row's single new position (S = 1) at its
    own, clamped the same way."""
    t, s = cache.shape[1], new.shape[1]
    if torch.is_tensor(pos):
        if s != 1:
            raise ValueError(f"per-row cache positions write one position "
                             f"a row, not {s}")
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos.clamp(0, t - 1)] = new[:, 0].to(cache.dtype)
        return
    start = min(max(int(pos), 0), t - s)
    cache[:, start:start + s] = new.to(cache.dtype)


def attention_block(p, x, cfg, *, causal=True, window=None,
                    positions=None, cache_kv=None, cache_pos=None,
                    cross_kv=None, return_kv=False):
    """One attention sublayer (projections + MHA), cache-aware.

    Modes:
      * full-sequence (train / prefill): ``cache_kv=None``; pass
        ``return_kv=True`` to hand (k, v) to a new cache.
      * decode: x is (B,1,D); ``cache_kv=(k_cache, v_cache)`` with absolute
        write position ``cache_pos`` (an int); attends to
        cache[0:cache_pos+1].  The new K/V are written into the cache
        tensors in place (the reference returns updated copies), and the
        same tensors come back as the new cache.  ``cache_pos`` may be a
        (B,) integer tensor on x's device: row b then rotates and writes
        at ``cache_pos[b]`` and attends to cache[b, 0:cache_pos[b]+1].
      * cross attention: ``cross_kv=(k, v)`` precomputed from the encoder.
    """
    b, s, _ = x.shape
    per_row = torch.is_tensor(cache_pos)
    if positions is None:
        if per_row:
            positions = cache_pos[:, None] \
                + torch.arange(s, device=x.device)[None, :]
        else:
            start = 0 if cache_pos is None else int(cache_pos)
            positions = (start + torch.arange(s, device=x.device))[None, :]

    q = _project(x, p["wq"])
    if cross_kv is not None:
        k, v = cross_kv
        out = multi_head_attention(q, k, v, causal=False,
                                   cap=cfg.attn_softcap,
                                   batch_shard=cfg.attn_batch_shard,
                                   logits_bf16=cfg.attn_logits_bf16)
        new_kv = None
    else:
        k = _project(x, p["wk"])
        vv = _project(x, p["wv"])
        if "q_norm" in p:     # QK-norm: every head over head_dim
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if cache_kv is not None:
            k_cache, v_cache = cache_kv
            pos = cache_pos if per_row else int(cache_pos)
            _write_cache(k_cache, k, pos)
            _write_cache(v_cache, vv, pos)
            out = multi_head_attention(
                q, k_cache, v_cache, causal=False, window=window,
                cap=cfg.attn_softcap, q_offset=pos,
                kv_valid_len=pos + s,
                batch_shard=cfg.attn_batch_shard,
                logits_bf16=cfg.attn_logits_bf16)
            new_kv = (k_cache, v_cache)
        else:
            out = multi_head_attention(q, k, vv, causal=causal,
                                       window=window, cap=cfg.attn_softcap,
                                       batch_shard=cfg.attn_batch_shard,
                                       logits_bf16=cfg.attn_logits_bf16)
            new_kv = (k, vv) if return_kv else None
    h, hd, d = p["wo"].shape
    y = out.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d)
    return y, new_kv


def init_cross_kv(p, enc_out, cfg):
    """Precompute cross-attention K/V from encoder output (no RoPE)."""
    return _project(enc_out, p["wk"]), _project(enc_out, p["wv"])
