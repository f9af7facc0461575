"""Plain reference of the fixed-point CNN the benchmark serves.

Each layer is a 'same' zero-padded 3×3 cross-correlation over every input
channel, accumulated exactly (int64, then wrapped to the int32
accumulator), shifted right arithmetically by ``min(shift, 31)`` and
clamped to ``[0, 2^(data_bits-1) - 1]`` (ReLU folded into the clamp).
Activations are channels-last, weights (out, in, 3, 3).  Plain torch
integer arithmetic; imports nothing of the port.

``operand_bits`` computes the same network with every operand cut to its
top ``operand_bits`` bits before each layer: the lower-precision control
(int4 for the int8 containers the configuration states).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    return ((t + (1 << 31)) & ((1 << 32) - 1)) - (1 << 31)


def _cut(t: torch.Tensor, bits: int, operand_bits: Optional[int]):
    """``t`` with only its top ``operand_bits`` of ``bits`` bits kept."""
    if operand_bits is None or bits <= operand_bits:
        return t
    drop = bits - operand_bits
    return (t >> drop) << drop


def layer(x: torch.Tensor, w: torch.Tensor, spec: Dict,
          operand_bits: Optional[int] = None) -> torch.Tensor:
    """One layer: x (N, H, W, Cin) integers, w (Cout, Cin, 3, 3) integers
    → (N, H, W, Cout) int64 in the layer's activation range."""
    n, h, wd, _ = x.shape
    xs = _cut(x.to(torch.int64), spec["data_bits"], operand_bits)
    ws = _cut(w.to(torch.int64), spec["coeff_bits"], operand_bits)
    xp = F.pad(xs.permute(0, 3, 1, 2), (1, 1, 1, 1))          # N,Cin,H+2,W+2
    acc = torch.zeros((n, ws.shape[0], h, wd), dtype=torch.int64,
                      device=x.device)
    for di in range(3):
        for dj in range(3):
            tap = xp[:, None, :, di:di + h, dj:dj + wd]          # N,1,Cin,H,W
            acc += (tap * ws[None, :, :, di, dj, None, None]).sum(dim=2)
    hi = (1 << (spec["data_bits"] - 1)) - 1
    out = torch.clamp(_wrap32(acc) >> min(spec["shift"], 31), 0, hi)
    return out.permute(0, 2, 3, 1)


def forward(x: torch.Tensor, weights: Sequence[torch.Tensor], net: Dict, *,
            operand_bits: Optional[int] = None,
            block: int = 32) -> torch.Tensor:
    """The network over images x (N, H, W, C0), ``block`` images at a
    time so that the int64 taps fit; returns int64 (N, H, W, C_last)."""
    outs = []
    for s in range(0, x.shape[0], block):
        act = x[s:s + block]
        for w, spec in zip(weights, net["layers"]):
            act = layer(act, w, spec, operand_bits)
        outs.append(act)
    return torch.cat(outs)
