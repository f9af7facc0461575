"""GPipe-style pipeline parallelism: point-to-point boundary transfers.

Port of ``repro.parallel.pipeline``.  For deployments beyond one pod the
``pod`` axis can run as a pipeline axis instead of outer DP: each stage
holds a contiguous span of layer cycles, microbatches stream through the
stages with a send/receive at every boundary, and the bubble fraction is
(S-1)/(M+S-1) for S stages and M microbatches.

The schedule is generic over a user-supplied ``stage_fn(stage_params, x)
-> x``, so it composes with the model zoo's stacked-cycle parameters:
stage s owns cycles [s·C/S, (s+1)·C/S).

The rotating-buffer formulation runs every stage every tick on its
current microbatch (SPMD: no per-stage control flow beyond who injects
and who emits), as the reference's ``shard_map`` does; its ``ppermute``
becomes one ``batch_isend_irecv`` per tick on the axis's group, and its
final ``all_gather`` the group's ``all_gather``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import is_dtensor


def _stage_slice(leaf, idx: int):
    """This stage's slice of a leaf that leads with the stage axis: the
    local shard of a DTensor sharded over the axis, or row ``idx`` of a
    plain tensor every rank holds whole."""
    if is_dtensor(leaf):
        return leaf.to_local()[0]
    return leaf[idx]


def pipeline_forward(stage_fn: Callable, stage_params, x_microbatches,
                     *, mesh, axis: str = "pipe"):
    """Run M microbatches through S pipeline stages.

    stage_params: a tree (nested dicts) whose leaves lead with the stage
      axis (DTensors sharded over ``axis``, or whole tensors);
    x_microbatches: (M, mb, ...) activations, the same on every rank.
    Returns (M, mb, ...) outputs from the LAST stage, on every rank.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    m = x_microbatches.shape[0]

    def local(tree):
        if isinstance(tree, dict):
            return {k: local(v) for k, v in tree.items()}
        return _stage_slice(tree, idx)

    params = local(stage_params)
    xs = x_microbatches
    nxt_rank = dist.get_global_rank(group, idx + 1) \
        if idx + 1 < n_stages else None
    prv_rank = dist.get_global_rank(group, idx - 1) if idx > 0 else None

    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(m + n_stages - 1):
        # stage 0 injects microbatch t (or microbatch 0 once drained)
        x_in = xs[t if t < m else 0] if idx == 0 else buf
        y = stage_fn(params, x_in)
        # pass to the next stage; the first stage receives nothing
        ops = []
        if nxt_rank is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt_rank,
                                  group))
        recv = torch.zeros_like(y)
        if prv_rank is not None:
            ops.append(dist.P2POp(dist.irecv, recv, prv_rank, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        buf = recv
        # the last stage emits microbatch t - (S-1)
        emit_t = t - (n_stages - 1)
        if emit_t >= 0:
            outs[emit_t] = y
    # only the last stage's outs are real; broadcast them back
    gathered = [torch.empty_like(outs) for _ in range(n_stages)]
    dist.all_gather(gathered, outs, group=group)
    return gathered[n_stages - 1]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
