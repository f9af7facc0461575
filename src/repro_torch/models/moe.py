"""Mixture-of-Experts with sort-based top-k dispatch under a capacity bound.

Port of ``repro.models.moe`` for one device.  Dispatch never builds the
O(tokens × experts × capacity) one-hot tensor: assignments are ranked
inside their expert by one stable argsort and a per-expert count, then
scattered into a dense (experts × capacity, d_model) buffer that feeds
three batched expert products (``torch.bmm``).  Tokens beyond capacity
are dropped (switch-style routing); the combine step re-weights by the
router probability and sums the surviving top-k paths.

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

Not ported: ``_hint`` (a sharding constraint, a no-op without a mesh)
and the multi-device halves ``_combine_shardmap``,
``_dispatch_shardmap`` and ``_combine_gspmd``, which wait for the
multi-device item; ``cfg.moe_shard_hints`` and
``cfg.moe_combine_shardmap`` are therefore ignored here, as the
reference ignores them without a mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import _act, dense_init


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


def _expert_ffn(expert_in: torch.Tensor, p, act: str) -> torch.Tensor:
    """The experts' FFN over their buffers (e, c, d) → (e, c, d): three
    (two ungated) batched products."""
    h = torch.bmm(expert_in, p["w_up"])
    if "w_gate" in p:
        h = _act(torch.bmm(expert_in, p["w_gate"]), act) * h
    else:
        h = _act(h, act)
    return torch.bmm(h, p["w_down"])


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

    probs, top_vals, top_ids = _route(xf, p["router"], k)     # (N,E),(N,k)
    flat_ids = top_ids.reshape(-1)                            # (N*k,)
    counts = _expert_counts(flat_ids, e)                      # (E,)
    aux = _aux_loss(probs, counts, n, e, m.router_aux_weight)

    # ---- sort-based rank-within-expert -------------------------------
    capacity = _capacity(m.capacity_factor, n, k, e)
    slot, keep = _rank(flat_ids, counts, capacity, e)

    # ---- dispatch: scatter tokens into the expert buffer -------------
    x_rep = xf.unsqueeze(1).expand(n, k, d).reshape(n * k, d)
    buf = x.new_zeros((e * capacity + 1, d))
    buf.index_copy_(0, slot, x_rep)        # dropped → the sentinel row
    expert_out = _expert_ffn(buf[:-1].reshape(e, capacity, d), p, cfg.act)

    # ---- combine: gather surviving assignments back -------------------
    flat_out = expert_out.reshape(e * capacity, d)
    gathered = torch.where(
        keep[:, None], flat_out[torch.clamp(slot, max=e * capacity - 1)],
        torch.zeros((), dtype=x.dtype, device=x.device))      # (N*k, D)
    out = torch.einsum("nkd,nk->nd", gathered.reshape(n, k, d).float(),
                       top_vals.float()).to(x.dtype)

    # ---- shared experts (always-on path) ------------------------------
    if "shared_up" in p:
        out = out + _shared(p, xf, cfg.act)
    return out.reshape(b, s, d), aux


def moe_layer_grouped(p, x: torch.Tensor, cfg):
    """Group-local routing: tokens split into ``cfg.moe_groups`` groups,
    each ranked, capacity-bounded, dispatched and combined on its own
    (capacity per group: cf·n_loc·k/E), the combine a scatter-add of
    the weighted contributions into each group's (NL, D) float32
    token buffer, as the reference's does."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = m.num_experts, m.top_k
    g = cfg.moe_groups
    if n % g:
        raise ValueError(f"{n} tokens do not split into {g} groups")
    nl = n // g
    xg = x.reshape(g, nl, d)

    probs, top_vals, top_ids = _route(xg, p["router"], k)    # (G,NL,E|k)
    flat_ids = top_ids.reshape(g, nl * k)
    counts = _expert_counts(flat_ids, e)                      # (G,E)
    aux = _aux_loss(probs, counts.sum(dim=0), n, e, m.router_aux_weight)

    cap = _capacity(m.capacity_factor, nl, k, e)
    slot, keep = _rank(flat_ids, counts, cap, e)              # (G,NL*k)

    x_rep = xg.unsqueeze(2).expand(g, nl, k, d).reshape(g, nl * k, d)
    buf = x.new_zeros((g, e * cap + 1, d))
    buf.scatter_(1, slot[..., None].expand(g, nl * k, d), x_rep)
    # each expert's products over the buffers of every group at once
    expert_in = buf[:, :-1].reshape(g, e, cap, d).transpose(0, 1) \
        .reshape(e, g * cap, d)
    expert_out = _expert_ffn(expert_in, p, cfg.act).reshape(e, g, cap, d) \
        .transpose(0, 1).reshape(g, e * cap, d)

    # scatter-add combine of the weighted contributions
    contrib = torch.gather(
        expert_out, 1,
        torch.clamp(slot, max=e * cap - 1)[..., None].expand(g, nl * k, d)) \
        * top_vals.reshape(g, nl * k)[..., None].to(expert_out.dtype)
    token_of = torch.arange(nl, device=x.device)[:, None] \
        .expand(nl, k).reshape(-1)
    idx = torch.where(keep, token_of, torch.full_like(token_of, nl))
    acc = torch.zeros((g, nl + 1, d), dtype=torch.float32, device=x.device)
    acc.scatter_add_(1, idx[..., None].expand(g, nl * k, d),
                     contrib.float())
    out = acc[:, :-1].to(x.dtype).reshape(b, s, d)

    if "shared_up" in p:
        out = out + _shared(p, x.reshape(n, d), cfg.act).reshape(b, s, d)
    return out, aux


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
