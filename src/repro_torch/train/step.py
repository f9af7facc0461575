"""Train and serve step builders.

Port of ``repro.train.step``.  The reference's steps are pure functions
for ``jit``; these run eagerly.  The loss's gradient is
``torch.autograd.grad`` with respect to the parameter leaves, so no
tensor of the caller's tree is marked as requiring grad; the update then
writes the new parameters and float32 moments in place
(``optim.adamw``).

The sharded steps are the same functions over DTensor trees placed by
``parallel.sharding.ShardingRules`` (params, optimizer state, batch and
cache): DTensor propagates the placements through the model, as GSPMD
does through the reference's jitted step, and each step runs under
``implicit_replication`` so the model's own plain tensors (positions,
masks, constants) count as replicated.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.parallel.compress import compress_grads_int8, decompress_grads
from repro_torch.parallel.sharding import is_dtensor
from repro_torch.tree import leaves, tree_map


def mesh_scope(params):
    """``implicit_replication`` where ``params`` are DTensors (a sharded
    step), else nothing."""
    if is_dtensor(leaves(params)[0]):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _like(g, p):
    """A DTensor gradient placed as its parameter: DTensor leaves a
    replicated parameter's gradient as a partial sum over the devices
    that used it, and this ``redistribute`` is the data-parallel
    gradient reduction GSPMD inserts for the reference."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(placements=p.placements)
    return g


def loss_and_grads(model, params, batch):
    """(loss, metrics, grads) of ``model.forward_train`` on ``batch``: the
    gradient of the loss for every parameter leaf, in the leaf's dtype
    (zeros for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    with torch.enable_grad():
        # fresh autograd leaves over the parameters' storage (no copy)
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = leaves(req)
        loss, metrics = model.forward_train(req, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else _like(g, p)
                  for p, g in zip(flat, grads)])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map(lambda _: next(grads), params)


def make_train_step(model, opt_cfg: AdamWConfig, *, lr: float = 3e-4,
                    microbatches: int = 1, grad_compression: bool = False):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics); ``params`` and the float32 moments are updated in place.

    ``microbatches > 1`` splits the batch along its first axis and sums
    the microbatches' gradients in float32 (a Python loop in place of the
    reference's ``lax.scan``), then divides by their count; the loss and
    metrics are the microbatches' means.  ``grad_compression`` rounds
    the gradients through the int8 block codec.
    """

    def accumulate(params, batch):
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        losses, metricses = [], []
        for i in range(microbatches):
            mb_batch = {k: v[i * (len(v) // microbatches):
                             (i + 1) * (len(v) // microbatches)]
                        for k, v in batch.items()}
            loss, metrics, grads = loss_and_grads(model, params, mb_batch)
            tree_map(lambda a, g: a.add_(g), acc, grads)
            losses.append(loss)
            metricses.append(metrics)
            del grads
        grads = tree_map(lambda a: a.div_(microbatches), acc)
        metrics = {k: torch.stack([m[k] for m in metricses]).float().mean()
                   for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, grads

    def step(params, opt_state, batch):
        with mesh_scope(params):
            if microbatches > 1:
                loss, metrics, grads = accumulate(params, batch)
            else:
                loss, metrics, grads = loss_and_grads(model, params, batch)
            if grad_compression:
                grads = decompress_grads(compress_grads_int8(grads), grads)
            params, opt_state, opt_metrics = adamw_update(
                grads, opt_state, params, lr, opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return step


def make_serve_steps(model):
    """Returns (prefill_fn, decode_fn)."""

    def prefill_fn(params, batch):
        with mesh_scope(params), torch.no_grad():
            return model.prefill(params, batch)

    def decode_fn(params, cache, token, pos):
        with mesh_scope(params), torch.no_grad():
            return model.decode_step(params, cache, token, pos)

    return prefill_fn, decode_fn
