"""Gradient compression: a block-wise int8 round trip of the gradients.

Port of ``repro.parallel.compress``: ``make_train_step(...,
grad_compression=True)`` rounds each gradient through the int8 block
codec of the 8-bit optimizer (``optim.adamw``) where a data-parallel
reduction would take it.  On DTensor gradients the codec
gathers each leaf and places its blocks over the data axes
(``optim.adamw``).
"""

from __future__ import annotations

from repro_torch.optim.adamw import dequantize_state, quantize_state
from repro_torch.tree import tree_map


def compress_grads_int8(grads):
    """Every gradient leaf as ``{"codes", "scale"}``."""
    return tree_map(quantize_state, grads)


def decompress_grads(q, like):
    """The gradients ``q`` encodes, each in the shape and dtype of its
    leaf in ``like``."""
    return tree_map(
        lambda g, qq: dequantize_state(qq, g.shape, g).to(g.dtype), like, q)
