"""Plain oracles of the convolution blocks (exact integer arithmetic).

Port of ``repro.kernels.ref.conv2d_3x3_ref`` and ``conv_block_ref``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d import wrap_int


def conv2d_3x3_ref(x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """'same' zero-padded 3×3 convolution (cross-correlation, matching the
    kernels).  x: (H, W) any int dtype; wk: (3, 3).  Returns int32, the
    int32 sum modulo 2^32 as the reference's wraps."""
    h, w = x.shape
    xpad = F.pad(x.to(torch.int64), (1, 1, 1, 1))
    wk = wk.to(torch.int64)
    acc = torch.zeros((h, w), dtype=torch.int64, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + xpad[di:di + h, dj:dj + w] * wk[di, dj]
    return wrap_int(acc).to(torch.int32)


def conv_block_ref(block: str, x: torch.Tensor, wk: torch.Tensor, **_):
    """Oracle for ``ops.conv_block``: conv1/conv2 → (H, W); conv3/conv4
    → (2, H, W) (both coefficient planes)."""
    if block in ("conv1", "conv2"):
        return conv2d_3x3_ref(x, wk)
    return torch.stack([conv2d_3x3_ref(x, wk[0]), conv2d_3x3_ref(x, wk[1])])
