"""Mamba-2 (SSD — state-space duality) block.

Port of ``repro.models.ssm``.  The chunked SSD algorithm recasts the
selective-scan recurrence as dense einsums over fixed-size chunks plus
one short sequential loop over per-chunk states:

  intra-chunk   Y_intra = (C Bᵀ ∘ L) X
  chunk states  S_c     = (B ∘ decay_to_end)ᵀ X
  recurrence    h_c     = exp(sum_c) h_{c-1} + S_c   (a loop over chunks)
  inter-chunk   Y_inter = (C h_{c-1}) ∘ decay_from_start

These are plain ``torch.einsum`` products, as the reference leaves them
to XLA.  The depthwise causal conv1d in front of the SSM runs the CUDA
kernel K7 (``kernels.conv1d.causal_conv1d``, its plain version on the
CPU) in prefill and in decode.  It follows the Pallas kernel's
arithmetic — float32 products and sums, then a cast to x's dtype before
the SiLU — where the reference's model conv multiplies and adds in x's
dtype; in bfloat16 the two differ by up to one bf16 unit.

Decode carries (conv_state, ssm_state) and costs O(1) per token.

Under a mesh (DTensor inputs) K7, a ctypes launch, runs under
``local_map`` (``_conv_on_mesh``): the batch over the data axes and the
channels over ``model`` where the taps are sharded there (``conv_x``,
as ``ShardingRules`` places it).  The SSD runs under ``local_map`` too
(``_ssd_on_mesh``), over the batch and the heads.  On ``meta`` (the dry
run) the conv is K7's plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.conv1d import causal_conv1d as conv1d_kernel
from repro_torch.kernels.conv1d import causal_conv1d_plain
from repro_torch.models.layers import const_init, dense_init, rms_norm
from repro_torch.parallel.sharding import (is_dtensor, kernel_placements,
                                           shard_map)


def ssm_dims(cfg):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    n_heads = inner // s.head_dim
    return inner, n_heads


def init_mamba(gen, cfg):
    s = cfg.ssm
    d = cfg.d_model
    inner, nh = ssm_dims(cfg)
    gn = s.n_groups * s.state_dim
    dt = cfg.torch_dtype
    # A in (-dt_max_decay, 0): store log(-A) per head
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))
    return {
        "w_z": dense_init(gen, (d, inner), dt),
        "w_x": dense_init(gen, (d, inner), dt),
        "w_B": dense_init(gen, (d, gn), dt),
        "w_C": dense_init(gen, (d, gn), dt),
        "w_dt": dense_init(gen, (d, nh), dt),
        "conv_x": dense_init(gen, (s.conv_kernel, inner), dt,
                             fan_in=s.conv_kernel),
        "conv_B": dense_init(gen, (s.conv_kernel, gn), dt,
                             fan_in=s.conv_kernel),
        "conv_C": dense_init(gen, (s.conv_kernel, gn), dt,
                             fan_in=s.conv_kernel),
        "dt_bias": const_init(gen, (nh,), 0.0),
        "a_log": a_log.to("meta" if gen is None else gen.device),
        "d_skip": const_init(gen, (nh,), 1.0),
        "norm": const_init(gen, (inner,), 0.0),
        "w_out": dense_init(gen, (inner, d), dt, fan_in=inner),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, conv_state=None):
    """Depthwise causal conv + SiLU.  x: (B,S,C); w: (K,C).

    ``conv_state``: (B,K-1,C) trailing context (decode) or None (a zero
    halo, which the kernel supplies itself); returns (y, new_state) with
    new_state = (conv_state ‖ x)[:, S:].  One K7 launch on the card.
    """
    k = w.shape[0]
    s = x.shape[1]
    if is_dtensor(x):
        y = _conv_on_mesh(x, w, conv_state).to(x.dtype)
    else:
        y = _conv(x, w, conv_state).to(x.dtype)
    if s >= k - 1:
        new_state = x[:, s - (k - 1):, :]
    elif conv_state is None:
        new_state = F.pad(x, (0, 0, k - 1 - s, 0))
    else:
        new_state = torch.cat([conv_state[:, s:, :], x], dim=1)
    return F.silu(y), new_state


def _conv(x, w, state=None):
    """K7 on x, w and the state (contiguous); on ``meta`` (the dry run)
    its plain version, which no kernel runs on."""
    state = None if state is None else state.contiguous()
    conv = causal_conv1d_plain if x.device.type == "meta" else conv1d_kernel
    return conv(x.contiguous(), w.contiguous(), state)


def _conv_on_mesh(x, w, conv_state):
    """K7 under ``local_map`` on DTensors: x (B,S,C) keeps a shard of
    the batch, and of the channels on each axis where the taps w (K,C)
    are sharded too; anything else is gathered first.  The state follows
    x; the float32 output has x's placements."""
    from torch.distributed.tensor import Replicate, Shard
    pl = kernel_placements(x, lambda d, n: d == 0)
    wpl = [Replicate()] * len(pl)
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if isinstance(px, Shard) and px.dim == 2 \
                and isinstance(pw, Shard) and pw.dim == 1:
            pl[i], wpl[i] = px, pw

    def run(x_, w_, *state):
        return _conv(x_, w_, *state)

    args = (x, w) if conv_state is None else (x, w, conv_state)
    placements = (pl, wpl) if conv_state is None else (pl, wpl, pl)
    return shard_map(run, x.device_mesh, placements, pl)(*args)


def _ssd_chunked(x, dt, a, B, C, chunk: int):
    """SSD over a full sequence.

    x: (B,S,NH,P)  dt: (B,S,NH)  a: (NH,) negative  B,C: (B,S,G,N)
    Returns (y (B,S,NH,P), final_state (B,NH,N,P)).
    """
    b, s, nh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = nh // g
    s_orig = s
    if s % chunk:
        # zero-pad to a chunk multiple: padded steps have dt=0 so they leave
        # the state untouched and contribute nothing (outputs sliced off).
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk

    xr = x.reshape(b, nc, chunk, nh, p)
    dtr = dt.reshape(b, nc, chunk, nh)
    Br = B.reshape(b, nc, chunk, g, n)
    Cr = C.reshape(b, nc, chunk, g, n)

    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))

    h = torch.zeros((b, nh, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        xc, dtc = xr[:, ci], dtr[:, ci]       # (b,Q,NH,P) (b,Q,NH)
        da = dtc * a[None, None, :]                        # (b,Q,NH) ≤ 0
        cum = torch.cumsum(da, dim=1)
        total = cum[:, -1, :]                              # (b,NH)
        xdt = (xc * dtc[..., None]).float()                # (b,Q,NH,P)

        # expand groups to heads per chunk, in float32
        Bc = torch.repeat_interleave(Br[:, ci], rep, dim=2).float()
        Cc = torch.repeat_interleave(Cr[:, ci], rep, dim=2).float()

        # intra-chunk:  L[q,t] = exp(cum_q - cum_t) for q >= t (masked
        # before the exp: masked lanes have rel > 0, whose exp overflows)
        rel = cum[:, :, None, :] - cum[:, None, :, :]      # (b,Q,Q,NH)
        rel = torch.where(causal[None, :, :, None], rel,
                          torch.full_like(rel, -torch.inf))
        L = torch.exp(rel)
        scores = torch.einsum("bqhn,bthn->bqth", Cc, Bc)   # (b,Q,Q,NH)
        y_intra = torch.einsum("bqth,bthp->bqhp", scores * L, xdt)

        # inter-chunk: contribution of the incoming state
        decay_from_start = torch.exp(cum)                  # (b,Q,NH)
        y_inter = torch.einsum("bqhn,bhnp->bqhp",
                               Cc * decay_from_start[..., None], h)

        # carry: state at the end of this chunk
        decay_to_end = torch.exp(total[:, None, :] - cum)  # (b,Q,NH)
        state = torch.einsum("bthn,bthp->bhnp",
                             Bc * decay_to_end[..., None], xdt)
        h = h * torch.exp(total)[:, :, None, None] + state
        ys.append(y_intra + y_inter)

    y = torch.stack(ys, dim=1).reshape(b, s, nh, p)[:, :s_orig]
    return y.to(x.dtype), h


def _ssd_decode(x, dt, a, B, C, h):
    """One-token SSD step.  x: (B,1,NH,P) dt: (B,1,NH) B,C: (B,1,G,N)
    h: (B,NH,N,P) -> (y (B,1,NH,P), h')."""
    nh = x.shape[2]
    g = B.shape[2]
    rep = nh // g
    Bh = torch.repeat_interleave(B[:, 0], rep, dim=1).float()  # (B,NH,N)
    Ch = torch.repeat_interleave(C[:, 0], rep, dim=1).float()
    dt0 = dt[:, 0].float()                                     # (B,NH)
    da = torch.exp(dt0 * a[None, :])                           # (B,NH)
    xdt = (x[:, 0] * dt0[..., None]).float()                   # (B,NH,P)
    h = h * da[:, :, None, None] + torch.einsum("bhn,bhp->bhnp", Bh, xdt)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    return y[:, None].to(x.dtype), h


def _ssd_on_mesh(fn, x, dt, a, B, C, *h0):
    """The SSD ``fn`` under ``local_map`` on DTensors (its chunk loop has
    no collective): x (B,S,NH,P) keeps a shard of the batch and, with one
    group of B and C, of the heads; dt, a, B, C and the state h
    (B,NH,N,P) follow x's placements; anything else is gathered first."""
    from torch.distributed.tensor import Replicate, Shard
    g = B.shape[2]
    pl_x = kernel_placements(x, lambda d, n: d == 0 or (d == 2 and g == 1))
    r = Replicate()

    def follow(batch, heads):
        """Each axis's placement on a tensor whose batch dim is
        ``batch`` and head dim ``heads`` (None: it has none)."""
        out = []
        for p in pl_x:
            dim = (batch if p == Shard(0) else heads if p == Shard(2)
                   else None)
            out.append(r if dim is None else Shard(dim))
        return out

    ins = (pl_x, follow(0, 2), follow(None, 0), follow(0, None),
           follow(0, None)) + ((follow(0, 1),) if h0 else ())
    return shard_map(fn, x.device_mesh, ins,
                     (pl_x, follow(0, 1)))(x, dt, a, B, C, *h0)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), without torch's linear branch above 20."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba_block(p, x: torch.Tensor, cfg, *, cache=None):
    """Full Mamba-2 block.  x: (B,S,D).

    cache: None (train), an empty dict (prefill from empty states:
    zero conv halos, a zero SSM state) or dict(conv_x, conv_B, conv_C,
    ssm) for decode/prefill carry.  Returns (y, new_cache_or_None), the
    new cache for any cache that is not None.  Three K7 launches (the x,
    B and C convs) per call.
    """
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    inner, nh = ssm_dims(cfg)
    g, n = s_cfg.n_groups, s_cfg.state_dim

    z = x @ p["w_z"]                                       # (B,S,inner)
    xs = x @ p["w_x"]
    Bx = x @ p["w_B"]
    Cx = x @ p["w_C"]
    dt = x.float() @ p["w_dt"].float()

    cs_x = cs_B = cs_C = None
    if cache:
        cs_x, cs_B, cs_C = cache["conv_x"], cache["conv_B"], cache["conv_C"]
    xs, ns_x = causal_conv1d(xs, p["conv_x"], cs_x)
    Bx, ns_B = causal_conv1d(Bx, p["conv_B"], cs_B)
    Cx, ns_C = causal_conv1d(Cx, p["conv_C"], cs_C)

    dt = _softplus(dt + p["dt_bias"][None, None, :])       # (B,S,NH)
    a = -torch.exp(p["a_log"])                              # (NH,)
    xh = xs.reshape(b, s, nh, s_cfg.head_dim)
    Bh = Bx.reshape(b, s, g, n)
    Ch = Cx.reshape(b, s, g, n)

    if cache is None or s > 1:
        # prefill always starts from an empty SSM state, as the
        # reference's does (its cache's ``ssm`` is not read here)
        def ssd(x_, dt_, a_, B_, C_):
            return _ssd_chunked(x_, dt_, a_, B_, C_,
                                min(s_cfg.chunk_size, s))
        args = (xh, dt, a, Bh, Ch)
    else:
        h0 = cache["ssm"] if cache else torch.zeros(
            (b, nh, n, s_cfg.head_dim), dtype=torch.float32, device=x.device)
        ssd = _ssd_decode
        args = (xh, dt, a, Bh, Ch, h0)
    y, h_final = _ssd_on_mesh(ssd, *args) if is_dtensor(xh) else ssd(*args)

    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]

    new_cache = None
    if cache is not None:
        new_cache = {"conv_x": ns_x, "conv_B": ns_B, "conv_C": ns_C,
                     "ssm": h_final}
    return out, new_cache


def init_mamba_cache(cfg, batch: int, device: DeviceLike = "cuda"):
    """Zero-initialized decode cache of one Mamba layer, on the card
    unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    s = cfg.ssm
    inner, nh = ssm_dims(cfg)
    gn = s.n_groups * s.state_dim
    k = s.conv_kernel
    dt = cfg.torch_dtype
    return {
        "conv_x": torch.zeros((batch, k - 1, inner), dtype=dt, device=device),
        "conv_B": torch.zeros((batch, k - 1, gn), dtype=dt, device=device),
        "conv_C": torch.zeros((batch, k - 1, gn), dtype=dt, device=device),
        "ssm": torch.zeros((batch, nh, s.state_dim, s.head_dim),
                           dtype=torch.float32, device=device),
    }
