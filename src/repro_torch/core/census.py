"""Op census of a block's plain per-plane form — the sweep's "synthesis
report".

Port of ``repro.core.hloscan.jaxpr_resources`` as the block sweep and
the planner's validation use it.  The reference traces ``blk.apply``
with ``jax.make_jaxpr`` and walks the equations, multiplying the Pallas
body's counts by the grid.  Here the block's plain row-tile body
(``ConvBlock.kernel_body``, the counterpart of the Pallas body) runs
under a ``TorchDispatchMode`` on ``meta`` tensors: every aten operator
is seen with its output's shape and dtype, and nothing is computed.
One row tile is counted and multiplied by the grid (H / tile_h); the
zero padding outside the grid is counted once.  This is the planner's
model of a design point, never an execution path.

The aten operators map onto the reference's classes (``hloscan.py``'s
``_ELEMENTWISE``, ``_ADD_LIKE``, ``_MEMORY_OPS``):

  elementwise  add, sub, mul, div, neg, abs, sign, where (``select_n``),
               the comparisons, the bitwise ops and shifts, clamp,
               maximum/minimum, and ``_to_copy`` (``convert_element_type``)
  add-like     add, sub
  reductions   sum, amax, amin, prod, cumsum, argmax, argmin
  memory       views and copies — slice, select, view, _unsafe_view,
               expand, permute, transpose, unsqueeze, squeeze, stack, cat,
               constant_pad_nd, clone — and tensor creation (zeros, ones,
               full, scalar_tensor, the reference's ``broadcast_in_dim`` of
               a literal), counted by output bytes
  dot          ``repro_torch::int_dot`` (``dot_general``)

The values of ``vpu_ops``, ``add_chain``, ``mem_move_bytes`` and
``temp_bytes`` therefore differ from the reference's (aten is not
jaxpr); their shape over the design grid is what the planner's models
fit.  ``mxu_flops``, ``mxu_cost``, ``hbm_bytes`` and
``pallas_vmem_bytes`` follow from shapes and dtypes alone and equal the
reference's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.blocks import BlockLike, get_block
from repro_torch.kernels import conv2d

_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "where",
    "eq", "ne", "ge", "gt", "le", "lt", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "__lshift__", "__rshift__",
    "bitwise_left_shift", "bitwise_right_shift", "clamp", "maximum",
    "minimum", "_to_copy", "remainder", "pow", "exp", "log", "tanh",
    "sigmoid", "erf", "rsqrt", "sqrt", "floor", "round",
}
_ADD_LIKE = {"add", "sub", "rsub"}
_REDUCTIONS = {"sum", "amax", "amin", "prod", "cumsum", "argmax", "argmin"}
_MEMORY_OPS = {
    "slice", "select", "view", "_unsafe_view", "reshape", "expand",
    "permute", "transpose", "t", "unsqueeze", "squeeze", "stack", "cat",
    "constant_pad_nd", "clone", "alias", "flip", "index", "gather",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "scalar_tensor", "empty", "empty_like", "new_empty", "new_zeros",
}
_DOTS = {"int_dot"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _outputs(out):
    return [o for o in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(o, torch.Tensor)]


class _Census(TorchDispatchMode):
    """Counts every operator that runs inside it, ``mult`` times."""

    def __init__(self):
        super().__init__()
        self.res: Dict[str, float] = defaultdict(float)
        self.mult = 1.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = _outputs(out)
        res, mult = self.res, self.mult
        if name in _DOTS:
            a, b = args[0], args[1]
            m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
            flops = 2 * m * n * k * outs[0][..., 0, 0].numel()
            res["mxu_flops"] += mult * flops
            # the MXU runs int8 at 4× the int32 rate (the DSP-width
            # analogue the reference's census charges)
            wid = max(a.element_size(), b.element_size())
            res["mxu_cost"] += mult * flops * wid / 4.0
        elif name in _ELEMENTWISE:
            n = sum(o.numel() for o in outs)
            wid = max(o.element_size() for o in outs)
            res["vpu_count"] += mult * n
            res["vpu_ops"] += mult * n * wid / 4.0
            if name in _ADD_LIKE:
                res["add_chain"] += mult * n * wid / 4.0
        elif name in _REDUCTIONS:
            n = sum(t.numel() for t in args if isinstance(t, torch.Tensor))
            res["vpu_ops"] += mult * n
            res["add_chain"] += mult * n
        elif name in _MEMORY_OPS:
            res["mem_move_bytes"] += mult * sum(_nbytes(o) for o in outs)
        res["temp_bytes"] += mult * sum(_nbytes(o) for o in outs)
        return out


def block_resources(block: BlockLike, img_h: int, img_w: int, *,
                    data_bits: int, coeff_bits: int,
                    tile_h: int = 16) -> Dict[str, float]:
    """Resource census of ``block.apply`` on one (img_h, img_w) plane at
    a design point: ``vpu_ops``, ``add_chain``, ``mxu_flops``,
    ``mxu_cost``, ``mem_move_bytes``, ``temp_bytes``, ``hbm_bytes``
    (argument bytes + output bytes) and ``pallas_vmem_bytes`` (the
    staged operands — padded plane and weights — plus one output
    tile)."""
    blk = get_block(block)
    if img_h % tile_h:
        raise ValueError(f"{blk.name}: image height {img_h} not divisible "
                         f"by tile_h={tile_h}")
    grid = img_h // tile_h
    n_out = 2 if blk.dual_output else 1
    x = torch.empty((1, img_h, img_w), device="meta",
                    dtype=conv2d.container_dtype(data_bits))
    wk = torch.empty((1, *blk.weight_shape(coeff_bits)), device="meta",
                     dtype=conv2d.container_dtype(coeff_bits))
    body = blk.kernel_body(data_bits=data_bits, coeff_bits=coeff_bits)
    census = _Census()
    with census:
        xpad = F.pad(x, (1, 1, 1, 1))
        census.mult = float(grid)
        body(xpad[..., :tile_h + 2, :], wk)
    res = dict(census.res)
    # every grid step loads its staged operands (the Pallas body's
    # ``x_ref[...]`` and ``w_ref[...]``), live temporaries as the
    # reference counts its ref loads
    staged = _nbytes(xpad) + _nbytes(wk)
    res["temp_bytes"] = res.get("temp_bytes", 0.0) + grid * staged
    out_bytes = n_out * img_h * img_w * 4
    res["arg_bytes"] = float(_nbytes(x) + _nbytes(wk))
    res["out_bytes"] = float(out_bytes)
    res["hbm_bytes"] = res["arg_bytes"] + res["out_bytes"]
    res["pallas_vmem_bytes"] = float(staged + out_bytes / grid)
    return res
