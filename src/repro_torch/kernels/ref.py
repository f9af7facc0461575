"""Plain oracles of the kernels.

Port of ``repro.kernels.ref``: ``conv2d_3x3_ref`` and ``conv_block_ref``
(exact integer arithmetic) and ``causal_conv1d_ref`` (float32).
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


def causal_conv1d_ref(x: torch.Tensor, w: torch.Tensor,
                      conv_state=None) -> torch.Tensor:
    """Depthwise causal conv (pre-activation).  x: (B, S, C); w: (K, C);
    ``conv_state``: (B, K-1, C) or None (zeros).  Returns float32
    (B, S, C): the K products added in float32 from j = 0."""
    k = w.shape[0]
    b, s, c = x.shape
    if conv_state is None:
        conv_state = torch.zeros((b, k - 1, c), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state, x], dim=1).float()
    wf = w.float()
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xp[:, i:i + s, :] * wf[i][None, None, :]
    return y
