"""Mixture-of-Experts with sort-based top-k dispatch under a capacity bound.

Port of ``repro.models.moe`` for one device.  Dispatch never builds the
O(tokens × experts × capacity) one-hot tensor: assignments are ranked
inside their expert by one stable argsort and a per-expert count, then
scattered into a dense (experts × capacity, d_model) buffer that feeds
the expert products.  Tokens beyond capacity are dropped (switch-style
routing); the combine step re-weights by the router probability and sums
the surviving top-k paths, reading only the buffer's filled rows.

The products (``_expert_ffn``) adapt to what they are given.  On the
flat path without a mesh, a gated SiLU FFN in float32 or bf16 on the
card off the autograd graph (the MoE serving workload in float32, an
LM's MoE MLP in inference in its dtype) runs ``kernels.moe_expert_gemm``:
each expert's fill (its count clamped to the capacity, on the device)
bounds the rows computed, two launches of the dtype's kernels.  Every
other call (the CPU, training, the grouped path, DTensors, an ungated
or non-SiLU FFN) runs three batched products (``torch.bmm``) over every
row, counted in ``kernels.build.LAUNCHES`` under
``moe_expert_gemm.BMM_FALLBACK``.

Parity with the reference, which runs this path in float32:

* ``_top_k`` is a stable descending sort, so ties (every zero padding
  row's router probabilities are exactly uniform) put the lower expert
  index first, as ``lax.top_k`` does; ``torch.topk`` promises no order.
* Ranks come from ``torch.argsort(stable=True)``, as ``jnp.argsort`` is
  stable, and the capacity is ``int(max(k, round(cf·n·k/e)))`` with
  Python's half-even ``round``.
* Expert counts are a ``scatter_add_`` (``torch.bincount`` on a card
  reads its input's maximum back to the host), and nothing in a layer
  calls ``.item()``, ``nonzero`` or boolean-mask indexing: a forward
  enqueues its work without waiting for the card.
* Every dropped assignment writes into the buffer's last (sentinel)
  row, which is discarded; those duplicate writes race harmlessly.
* Products run in the input's dtype: in the MoE workload full float32,
  where the module expects ``torch.backends.cuda.matmul.allow_tf32`` off
  and the float32 matmul precision at ``"highest"`` (torch's defaults;
  TF32 would move the outputs well past the tolerances the goldens are
  held to), and in an LM's MoE MLP its dtype (bf16 at full width).

Under a mesh (the layer's input is a DTensor placed by
``parallel.sharding.ShardingRules``, the port's counterpart of the
reference's ambient mesh) DTensor propagates the expert products, and
every region without a DTensor sharding rule runs under ``local_map``,
as the reference's own ``shard_map`` regions do:

* the flat path's routing, ranking, dispatch and combine (the stable
  sort, ``scatter_add_``, ``index_copy_``, gathers) run replicated on
  every device (``_replicated``), the expert products on the experts'
  shards;
* the grouped path (``cfg.moe_groups > 1``) routes each group where it
  lives, the groups over the data axes (``_per_group``);
* ``_dispatch_shardmap`` (``cfg.moe_combine_shardmap``) builds on each
  (data, model) device only its own experts' buffers, with no
  collective; ``_combine_shardmap`` scatter-adds each device's experts'
  contributions and finishes with one ``all_reduce`` over ``model`` in
  bf16 (the reference's ``psum``), an explicit ``redistribute`` of a
  partial sum; ``_combine_gspmd`` combines each group's gathered
  expert outputs;
* ``_hint`` (``cfg.moe_shard_hints``) is an explicit ``redistribute``.

The reference's fallbacks hold: without a mesh, without a ``model``
axis, or with experts that do not divide it, the shard_map halves take
the single-device path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, moe_expert_gemm as meg
from repro_torch.models.layers import _act, dense_init
from repro_torch.ops import spans
from repro_torch.parallel.sharding import (P, axis_sizes, mesh_of,
                                           shard_map, to_placements)


def init_moe(gen: Optional[torch.Generator], cfg) -> Dict[str, torch.Tensor]:
    """The layer's parameters drawn from ``gen`` (on its device), in the
    reference's layout: a float32 router (d, e), expert weights
    (e, d, fe) / (e, fe, d) in ``cfg.torch_dtype``, and the shared
    experts when the config has them.  Without a generator the tensors
    are empty, on ``meta``."""
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_ff_expert, m.num_experts
    dt = cfg.torch_dtype
    p = {
        "router": dense_init(gen, (d, e), torch.float32),
        "w_up": dense_init(gen, (e, d, fe), dt, fan_in=d),
        "w_down": dense_init(gen, (e, fe, d), dt, fan_in=fe),
    }
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, (e, d, fe), dt, fan_in=d)
    if m.n_shared_experts:
        fs = fe * m.n_shared_experts
        p["shared_up"] = dense_init(gen, (d, fs), dt)
        p["shared_down"] = dense_init(gen, (fs, d), dt, fan_in=fs)
        if cfg.mlp_gated:
            p["shared_gate"] = dense_init(gen, (d, fs), dt)
    return p


def _symmetric_scale(absmax: torch.Tensor, bits: int,
                     floor: float) -> torch.Tensor:
    """``hi / max(absmax, floor)`` with hi = 2^(bits-1) - 1, as a true
    division (a Python scalar over a tensor is a reciprocal times the
    scalar in torch, which can differ from the reference in the last
    bit)."""
    hi = float((1 << (bits - 1)) - 1)
    m = absmax.clamp_min(floor)
    return torch.full_like(m, hi) / m


def quantize_moe_params(p: Dict[str, torch.Tensor], coeff_bits: int
                        ) -> Dict[str, torch.Tensor]:
    """Fake-quantize the expert and shared FFN weights onto the
    symmetric ``coeff_bits``-bit grid with one scale per tensor (its
    max magnitude maps to 2^(c-1) - 1, floored at 1e-9), rounded half
    to even and scaled back; the router stays exact, as the
    reference's does (expert choice is control flow)."""
    def q(w):
        s = _symmetric_scale(w.abs().amax(), coeff_bits, 1e-9)
        return (torch.round(w * s) / s).to(w.dtype)

    return {k: (v if k == "router" else q(v)) for k, v in p.items()}


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    largest first, the lower index first among equal values (the order
    of ``lax.top_k``)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _dp_entry(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else "data"


def _hint(x, spec_axes, enable: bool):
    """The reference's §Perf sharding hint, an explicit ``redistribute``
    of a DTensor to ``spec_axes`` (``"data"`` standing for the data axes
    of a multi-pod mesh); without a mesh nothing to do."""
    mesh = mesh_of(x)
    if not enable or mesh is None:
        return x
    dp = _dp_entry(mesh)
    spec = P(*(dp if a == "data" else a for a in spec_axes))
    return x.redistribute(placements=to_placements(spec, mesh))


def _local(fn, mesh, in_specs, out_specs):
    """``fn`` under ``local_map`` on ``mesh`` (the reference's
    ``shard_map``): its inputs redistributed to ``in_specs``, its outputs
    placed by ``out_specs`` (one spec, or a list of them)."""
    def pl(spec):
        return to_placements(spec, mesh)
    out = tuple(pl(sp) for sp in out_specs) \
        if isinstance(out_specs, list) and len(out_specs) > 1 \
        else pl(out_specs[0] if isinstance(out_specs, list) else out_specs)
    return shard_map(fn, mesh, [pl(sp) for sp in in_specs], out)


def _replicated(fn, mesh, n_in: int, n_out: int):
    """``fn`` under ``local_map`` with every input gathered whole and
    every output replicated: each device runs the same computation."""
    return _local(fn, mesh, [P()] * n_in, [P()] * n_out)


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """Router softmax, the renormalized top-k and the full probabilities
    of tokens ``xf`` (..., d)."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_vals, top_ids = _top_k(probs, k)
    top_vals = top_vals / torch.clamp(
        top_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_vals, top_ids


def _expert_counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert along the last axis of ``ids`` (…, m) →
    (…, e), without a host sync."""
    counts = torch.zeros(ids.shape[:-1] + (e,), dtype=torch.long,
                         device=ids.device)
    return counts.scatter_add_(-1, ids, torch.ones_like(ids))


def _aux_loss(probs, counts, n_tokens: int, e: int, weight: float):
    """Switch-style load-balancing loss: e · Σ mean(probs) · (assigned
    share) · weight; ``counts`` (e,) is the top-k assignments per
    expert, the sum over tokens of the one-hot top-k."""
    me = probs.reshape(-1, e).mean(dim=0)
    ce = counts.to(torch.float32) / n_tokens
    return e * torch.sum(me * ce) * weight


def _capacity(cf: float, n: int, k: int, e: int) -> int:
    return int(max(k, round(cf * n * k / e)))


def _rank(flat_ids: torch.Tensor, counts: torch.Tensor, capacity: int,
          e: int):
    """Rank of each assignment inside its expert, in token order, over
    the last axis of ``flat_ids`` (…, m): (slot, keep), where a kept
    assignment's slot is ``expert · capacity + rank`` and a dropped
    one's the sentinel ``e · capacity``."""
    m = flat_ids.shape[-1]
    sort_idx = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, -1, sort_idx)
    starts = torch.cumsum(counts, dim=-1) - counts           # exclusive
    ranks_sorted = torch.arange(m, device=flat_ids.device) \
        - torch.gather(starts, -1, sorted_ids)
    ranks = torch.zeros_like(ranks_sorted).scatter_(-1, sort_idx,
                                                    ranks_sorted)
    keep = ranks < capacity
    slot = torch.where(keep, flat_ids * capacity + ranks,
                       torch.full_like(ranks, e * capacity))
    return slot, keep


def _expert_ffn(expert_in: torch.Tensor, p, act: str,
                hints: bool = False,
                fill: Optional[torch.Tensor] = None,
                rows: Optional[int] = None) -> torch.Tensor:
    """The experts' FFN over their buffers (e, c, d) → (e, c, d), inside
    the ``moe.experts`` span.  Given each expert's ``fill`` (rows its
    buffer holds, on the device; ``rows`` a bound of their sum), a call
    that ``kernels.moe_expert_gemm.takes`` (on the card, float32 or
    bf16, no gradient, gated SiLU, no DTensor) computes only the filled
    rows (``moe_expert_ffn``: two kernels), and the rows past the fill
    are unspecified.
    Every other call runs ``expert_ffn_bmm``: three (two ungated)
    batched products over every row (DTensor products under a mesh, the
    hidden activations hinted to experts over ``model``), counted in
    ``build.LAUNCHES[meg.BMM_FALLBACK]``."""
    with spans.span("moe.experts"):
        if fill is not None and meg.takes(expert_in, p, act):
            return meg.moe_expert_ffn(expert_in, p["w_gate"], p["w_up"],
                                      p["w_down"], fill, rows)
        build.LAUNCHES[meg.BMM_FALLBACK] += 1
        return meg.expert_ffn_bmm(
            expert_in, p["w_up"], p["w_down"], p.get("w_gate"),
            act=lambda t: _act(t, act),
            mid=lambda h: _hint(h, ("model", "data", None), hints))


def _shared(p, xf: torch.Tensor, act: str) -> torch.Tensor:
    hs = xf @ p["shared_up"]
    if "shared_gate" in p:
        hs = _act(xf @ p["shared_gate"], act) * hs
    else:
        hs = _act(hs, act)
    return hs @ p["shared_down"]


def moe_layer(p, x: torch.Tensor, cfg):
    """x (B, S, D) → (out (B, S, D), aux loss scalar)."""
    if cfg.moe_groups > 1:
        return moe_layer_grouped(p, x, cfg)
    return _moe_layer_flat(p, x, cfg)


def _moe_layer_flat(p, x: torch.Tensor, cfg):
    """x: (B,S,D) -> (out (B,S,D), aux_loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = m.num_experts, m.top_k
    xf = x.reshape(n, d)
    capacity = _capacity(m.capacity_factor, n, k, e)
    mesh = mesh_of(x)
    hints = cfg.moe_shard_hints

    def route_dispatch(xf_, router):
        probs, top_vals, top_ids = _route(xf_, router, k)   # (N,E),(N,k)
        flat_ids = top_ids.reshape(-1)                       # (N*k,)
        counts = _expert_counts(flat_ids, e)                 # (E,)
        # ---- sort-based rank-within-expert ---------------------------
        slot, keep = _rank(flat_ids, counts, capacity, e)
        # ---- dispatch: scatter tokens into the expert buffer ---------
        x_rep = xf_.unsqueeze(1).expand(n, k, d).reshape(n * k, d)
        buf = xf_.new_zeros((e * capacity + 1, d))
        buf.index_copy_(0, slot, x_rep)    # dropped → the sentinel row
        aux = _aux_loss(probs, counts, n, e, m.router_aux_weight)
        fill = torch.clamp(counts, max=capacity)     # rows each buffer holds
        return (buf[:-1].reshape(e, capacity, d), slot, keep, top_vals, aux,
                fill)

    def combine(expert_out, slot, keep, top_vals):
        # ---- combine: gather surviving assignments back ---------------
        flat_out = expert_out.reshape(e * capacity, d)
        gathered = torch.where(
            keep[:, None], flat_out[torch.clamp(slot, max=e * capacity - 1)],
            torch.zeros((), dtype=flat_out.dtype, device=flat_out.device))
        return torch.einsum("nkd,nk->nd", gathered.reshape(n, k, d).float(),
                            top_vals.float()).to(flat_out.dtype)

    if mesh is not None:
        # routing, ranking and the scatter/gather pair have no DTensor
        # sharding rule: each device runs them on the whole batch; the
        # products take every row (no fill)
        replicated = _replicated(
            lambda xf_, router: route_dispatch(xf_, router)[:5], mesh, 2, 5)
        combine = _replicated(combine, mesh, 4, 1)
        expert_in, slot, keep, top_vals, aux = replicated(xf, p["router"])
        fill = None
    else:
        expert_in, slot, keep, top_vals, aux, fill = route_dispatch(
            xf, p["router"])
    expert_in = _hint(expert_in, ("model", "data", None), hints)
    # every assignment fills at most one row: n · k bounds the fills' sum
    expert_out = _hint(_expert_ffn(expert_in, p, cfg.act, hints, fill,
                                   n * k), ("model", "data", None), hints)
    # free the buffers before the combine, whose gathers set the layer's
    # peak memory
    del expert_in, fill
    out = _hint(combine(expert_out, slot, keep, top_vals), ("data", None),
                hints)

    # ---- shared experts (always-on path) ------------------------------
    if "shared_up" in p:
        out = out + _shared(p, xf, cfg.act)
    return out.reshape(b, s, d), aux


def moe_layer_grouped(p, x: torch.Tensor, cfg):
    """Group-local routing: tokens split into ``cfg.moe_groups`` groups,
    each ranked, capacity-bounded, dispatched and combined on its own
    (capacity per group: cf·n_loc·k/E), the combine a scatter-add of
    the weighted contributions into each group's (NL, D) float32
    token buffer, as the reference's does.  Under a mesh the groups
    lie over the data axes and the experts over ``model``."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = m.num_experts, m.top_k
    g = cfg.moe_groups
    if n % g:
        raise ValueError(f"{n} tokens do not split into {g} groups")
    nl = n // g
    hints = cfg.moe_shard_hints
    mesh = mesh_of(x)
    xg = _hint(x.reshape(g, nl, d), ("data", None, None), hints)
    cap = _capacity(m.capacity_factor, nl, k, e)

    def route(xg_, router):
        probs, top_vals, top_ids = _route(xg_, router, k)    # (G,NL,E|k)
        flat_ids = top_ids.reshape(xg_.shape[0], nl * k)
        counts = _expert_counts(flat_ids, e)                  # (G,E)
        slot, keep = _rank(flat_ids, counts, cap, e)          # (G,NL*k)
        return probs, counts, slot, keep, top_vals

    if mesh is not None:
        dp = _dp_entry(mesh)
        route = _local(route, mesh, [P(dp, None, None), P()],
                       [P(dp, None, None), P(dp, None), P(dp, None),
                        P(dp, None), P(dp, None, None)])
    probs, counts, slot, keep, top_vals = route(xg, p["router"])
    aux = _aux_loss(probs, counts.sum(dim=0), n, e, m.router_aux_weight)

    shapes = dict(nl=nl, e=e, cap=cap, d=d, k=k)
    if cfg.moe_combine_shardmap:
        # per model rank, build ONLY the local experts' buffers — the
        # forward dispatch needs no collective at all
        expert_in = _dispatch_shardmap(xg, slot, keep, **shapes)
    else:
        expert_in = _build_buffers(xg, slot, keep, **shapes)
    expert_in = _hint(expert_in, ("data", "model", None, None), hints)
    expert_out = _hint(_grouped_ffn(expert_in, p, cfg.act),
                       ("data", "model", None, None), hints)
    if cfg.moe_combine_shardmap:
        out = _combine_shardmap(expert_out, slot, keep, top_vals, **shapes)
    else:
        out = _combine_gspmd(expert_out, slot, keep, top_vals, **shapes)
    out = _hint(out.to(x.dtype), ("data", None, None), hints)
    out = out.reshape(b, s, d)

    if "shared_up" in p:
        out = out + _shared(p, x.reshape(n, d), cfg.act).reshape(b, s, d)
    return out, aux


def _token_of(nl: int, k: int, device) -> torch.Tensor:
    """The token of each of the NL·k assignments of a group."""
    return torch.arange(nl, device=device)[:, None].expand(nl, k) \
        .reshape(-1)


def _scatter_buffers(xl, idx, rows: int, d: int, k: int):
    """Each group's tokens scattered into its (rows + 1, d) buffer at
    ``idx`` (G', NL·k), the last row the sentinel of dropped
    assignments: (G', rows, d)."""
    gl, nl = xl.shape[0], xl.shape[1]
    x_rep = xl.unsqueeze(2).expand(gl, nl, k, d).reshape(gl, nl * k, d)
    buf = xl.new_zeros((gl, rows + 1, d))
    buf.scatter_(1, idx[..., None].expand(gl, nl * k, d), x_rep)
    return buf[:, :-1]


def _build_buffers(xg, slot, keep, *, nl, e, cap, d, k):
    """Every group's (E, C, D) expert buffer: (G, E, C, D); under a
    mesh each device builds its own groups' buffers."""
    def build(xl, sl, kp):
        return _scatter_buffers(xl, sl, e * cap, d, k) \
            .reshape(xl.shape[0], e, cap, d)
    mesh = mesh_of(xg)
    if mesh is None:
        return build(xg, slot, keep)
    dp = _dp_entry(mesh)
    return _local(build, mesh, [P(dp, None, None), P(dp, None),
                                P(dp, None)],
                  P(dp, None, None, None))(xg, slot, keep)


def _experts_split(mesh, e: int) -> bool:
    """Whether the experts shard over the mesh's ``model`` axis (the
    reference's condition for its shard_map halves)."""
    sizes = axis_sizes(mesh)
    return "model" in sizes and e % sizes["model"] == 0


def _grouped_ffn(expert_in, p, act: str):
    """The experts' FFN over (G, E, C, D) buffers: each expert's
    products over the buffers of every group at once.  Under a mesh it
    runs under ``local_map`` on each device's groups and experts (the
    weights' other shards gathered, as an fsdp placement needs)."""
    g, e, cap, d = expert_in.shape

    def ffn(xin, *ws):
        gl, el = xin.shape[0], xin.shape[1]
        pw = dict(zip(names, ws))
        flat = xin.transpose(0, 1).reshape(el, gl * cap, d)
        return _expert_ffn(flat, pw, act).reshape(el, gl, cap, d) \
            .transpose(0, 1)

    names = [nm for nm in ("w_up", "w_gate", "w_down") if nm in p]
    ws = [p[nm] for nm in names]
    mesh = mesh_of(expert_in)
    if mesh is None:
        return ffn(expert_in, *ws)
    dp = _dp_entry(mesh)
    em = "model" if _experts_split(mesh, e) else None
    return _local(ffn, mesh, [P(dp, em, None, None)]
                  + [P(em, None, None)] * len(ws),
                  P(dp, em, None, None))(expert_in, *ws)


def _combine_group_local(eo, sl, kp, vl, base, *, nl, cap, d, k):
    """Scatter-add combine of the experts in ``eo`` (G', E', C, D),
    whose first slot is ``base``: each kept assignment's output times
    its router weight into its token's float32 row: (G', NL, D)."""
    gl, el = eo.shape[0], eo.shape[1]
    loc = sl - base
    ok = kp & (loc >= 0) & (loc < el * cap)
    flat = eo.reshape(gl, el * cap, d)
    contrib = torch.gather(
        flat, 1,
        torch.clamp(loc, 0, el * cap - 1)[..., None].expand(gl, nl * k, d)) \
        * vl.reshape(gl, nl * k)[..., None].to(flat.dtype)
    token_of = _token_of(nl, k, eo.device)
    idx = torch.where(ok, token_of, torch.full_like(token_of, nl))
    acc = torch.zeros((gl, nl + 1, d), dtype=torch.float32, device=eo.device)
    acc.scatter_add_(1, idx[..., None].expand(gl, nl * k, d),
                     contrib.float())
    return acc[:, :-1]


def _combine_shardmap(expert_out, slot, keep, vals, *, nl, e, cap, d, k):
    """Explicit-collective combine.  Under ``local_map`` each (data,
    model) device gathers *only its local experts'* outputs and
    scatter-adds its partial (NL, D) token buffer; one ``all_reduce``
    over ``model`` in bf16 (a partial sum redistributed to replicated:
    the reference's ``psum``) finishes it — k× less wire traffic than
    reducing the gathered (NL·k, D) tensor.  The router weights'
    gradient on each device is likewise partial over ``model``."""
    mesh = mesh_of(expert_out)
    if mesh is None or not _experts_split(mesh, e):
        # fallback: no mesh or a non-divisible expert count
        return _combine_gspmd(expert_out, slot, keep, vals, nl=nl, e=e,
                              cap=cap, d=d, k=k)
    from torch.distributed.tensor import Partial, Replicate
    dp = _dp_entry(mesh)
    el = e // axis_sizes(mesh)["model"]

    def local(eo, sl, kp, vl):
        base = mesh.get_local_rank("model") * el * cap
        part = _combine_group_local(eo, sl, kp, vl, base, nl=nl, cap=cap,
                                    d=d, k=k)
        return part.to(torch.bfloat16)

    out = to_placements(P(dp, None, None), mesh)
    out[list(mesh.mesh_dim_names).index("model")] = Partial()
    ins = [to_placements(sp, mesh) for sp in (
        P(dp, "model", None, None), P(dp, None), P(dp, None),
        P(dp, None, None))]
    part = shard_map(local, mesh, ins, out)(expert_out, slot, keep, vals)
    summed = part.redistribute(placements=[
        Replicate() if isinstance(q, Partial) else q
        for q in part.placements])
    return summed.float()


def _dispatch_shardmap(xg, slot, keep, *, nl, e, cap, d, k):
    """Collective-free forward dispatch.  Under ``local_map`` each
    (data, model) device scatters its local tokens into the buffer slice
    of its *own* experts only; the result is born sharded (G→data,
    E→model) with no forward communication.  The tokens' gradient on
    each device is partial over ``model`` (only its experts'), so the
    backward is one sum of the (G, NL, D) token gradient — the mirror of
    the combine."""
    mesh = mesh_of(xg)
    if mesh is None or not _experts_split(mesh, e):
        return _build_buffers(xg, slot, keep, nl=nl, e=e, cap=cap, d=d, k=k)
    dp = _dp_entry(mesh)
    el = e // axis_sizes(mesh)["model"]

    def local(xl, sl, kp):
        base = mesh.get_local_rank("model") * el * cap
        loc = sl - base
        ok = kp & (loc >= 0) & (loc < el * cap)
        idx = torch.where(ok, loc, torch.full_like(loc, el * cap))
        return _scatter_buffers(xl, idx, el * cap, d, k) \
            .reshape(xl.shape[0], el, cap, d)

    return _local(local, mesh, [P(dp, None, None), P(dp, None), P(dp, None)],
                  P(dp, "model", None, None))(xg, slot, keep)


def _combine_gspmd(expert_out, slot, keep, vals, *, nl, e, cap, d, k):
    """Each group's combine over all E experts' outputs; under a mesh
    each device combines its own groups with the experts gathered."""
    def combine(eo, sl, kp, vl):
        return _combine_group_local(eo, sl, kp, vl, 0, nl=nl, cap=cap, d=d,
                                    k=k)
    mesh = mesh_of(expert_out)
    if mesh is None:
        return combine(expert_out, slot, keep, vals)
    dp = _dp_entry(mesh)
    return _local(combine, mesh, [P(dp, None, None, None), P(dp, None),
                                  P(dp, None), P(dp, None, None)],
                  P(dp, None, None))(expert_out, slot, keep, vals)


def moe_layer_dense_ref(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Oracle: every expert on every token, combined by the router's
    renormalized top-k weights; no capacity drops."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    _, top_vals, top_ids = _route(xf, p["router"], m.top_k)
    h = torch.matmul(xf, p["w_up"])                            # (E,N,F)
    if "w_gate" in p:
        h = _act(torch.matmul(xf, p["w_gate"]), cfg.act) * h
    else:
        h = _act(h, cfg.act)
    every = torch.bmm(h, p["w_down"])                          # (E,N,D)
    weight = torch.zeros((n, m.num_experts), dtype=torch.float32,
                         device=x.device).scatter_(1, top_ids, top_vals)
    out = torch.einsum("end,ne->nd", every.float(), weight).to(x.dtype)
    if "shared_up" in p:
        out = out + _shared(p, xf, cfg.act)
    return out.reshape(b, s, d)
