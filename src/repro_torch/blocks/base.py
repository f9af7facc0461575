"""Abstract ``ConvBlock`` and the layer-fused dot kernels.

Port of ``repro.blocks.base``.  A block carries the paper's metadata
(``name``, ``convs_per_step``, ``dual_output``, ``weight_shape``,
``supports``, ``packed_ok``) and runs a whole CNN layer through
``apply_batched``: x (N, H, W, in_ch) — or one (H, W, in_ch) image — and
w (out_ch, in_ch, 3, 3) give the exact int32 accumulator (N, out_ch, H,
W) = Σ_ic conv(x[..., ic], w[oc, ic]).

Where the reference's default ``batched_layer`` vmaps the block's
per-plane Pallas body over every (image, out_ch, in_ch) plane, the port's
runs the block's whole-layer kernel (``layer_kernel``).  The dot blocks
override ``batched_layer`` as in the reference, with ``fused_dot_layer``
and ``packed_dot_layer`` — CUDA kernels here, each with its plain
PyTorch version beside it.  The per-plane ``apply``/``reference`` wait
for the per-plane kernels (conv2/3/4).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import conv2d

BIT_RANGE = (3, 16)     # sweep-supported data/coeff bit widths (paper §3.2)


@dataclass(frozen=True)
class ConvBlock:
    """One parameterizable 3×3 convolution block (paper §3.1).

    Frozen + hashable; the layer kernel is supplied by subclasses via
    ``layer_kernel`` (or a ``batched_layer`` override)."""

    name: str
    convs_per_step: int       # convolutions produced per grid step
    dual_output: bool         # two coefficient planes per call?
    description: str = ""

    # -- metadata -----------------------------------------------------

    def weight_shape(self, coeff_bits: int | None = None) -> Tuple[int, ...]:
        """Per-call weight operand shape (``coeff_bits`` kept for blocks
        whose operand layout depends on the coefficient width)."""
        del coeff_bits
        return (2, 3, 3) if self.dual_output else (3, 3)

    def supports(self, data_bits: int, coeff_bits: int) -> bool:
        """Whether the (data_bits, coeff_bits) design point is valid."""
        lo, hi = BIT_RANGE
        return lo <= data_bits <= hi and lo <= coeff_bits <= hi

    def packed_ok(self, data_bits: int, coeff_bits: int) -> bool:
        """Whether the block runs in its operand-packed regime at this
        design point (False for blocks that never pack)."""
        del data_bits, coeff_bits
        return False

    # -- execution ----------------------------------------------------

    def layer_kernel(self, x, w, *, data_bits: int, coeff_bits: int):
        """The block's whole-layer kernel (subclasses)."""
        raise NotImplementedError(
            f"{self.name}: no whole-layer kernel; override batched_layer")

    def _validate(self, x, w, data_bits: int, coeff_bits: int,
                  tile_h: int) -> None:
        """The layer checks of the reference's ``apply_batched``, with its
        messages."""
        if x.ndim not in (3, 4):
            raise ValueError(
                f"{self.name}: expected (H, W, in_ch) or (N, H, W, in_ch), "
                f"got shape {tuple(x.shape)}")
        if not self.supports(data_bits, coeff_bits):
            raise ValueError(
                f"{self.name}: unsupported design point "
                f"(data_bits={data_bits}, coeff_bits={coeff_bits})")
        if w.ndim != 4 or tuple(w.shape[2:]) != (3, 3) \
                or w.shape[1] != x.shape[-1]:
            raise ValueError(
                f"{self.name}: expected weights (out_ch, in_ch={x.shape[-1]},"
                f" 3, 3), got {tuple(w.shape)}")
        if x.shape[-3] % tile_h:
            raise ValueError(
                f"{self.name}: image height {x.shape[-3]} not divisible by "
                f"tile_h={tile_h}")

    def apply_batched(self, x, w, *, data_bits: int, coeff_bits: int,
                      tile_h: int = 16):
        """One CNN layer.  x: (H, W, in_ch) container int, or an
        (N, H, W, in_ch) image batch; w: (out_ch, in_ch, 3, 3).  Returns
        the exact int32 accumulator (out_ch, H, W) — or (N, out_ch, H,
        W); the caller applies its own rescale/activation.  ``tile_h`` is
        the reference's row tile: the image height must divide by it."""
        self._validate(x, w, data_bits, coeff_bits, tile_h)
        if x.ndim == 4:
            return self.batched_layer(x, w, data_bits=data_bits,
                                      coeff_bits=coeff_bits, tile_h=tile_h)
        return self.batched_layer(x[None], w, data_bits=data_bits,
                                  coeff_bits=coeff_bits, tile_h=tile_h)[0]

    def batched_layer(self, x, w, *, data_bits: int, coeff_bits: int,
                      tile_h: int = 16):
        """Whole-batch layer execution: x (N, H, W, in_ch) → exact int32
        (N, out_ch, H, W).  Default: the block's ``layer_kernel`` — one
        launch for every plane, the in_ch sum and every image.  The dot
        blocks override this with the layer-fused dots."""
        del tile_h
        return self.layer_kernel(x, w, data_bits=data_bits,
                                 coeff_bits=coeff_bits)


# ---------------------------------------------------------------------------
# layer-fused dots for the dot blocks
#
# The same integer arithmetic as the per-plane kernels: products widen
# exactly into int32 and int32 accumulation is order-independent modulo
# 2^32, so every formulation is bit-identical to the reference.
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, out, x_int16, w_int16, n, h, w, ic, oc, stream
_FUSED_ARGTYPES = (_P, _P, _P) + (_I,) * 7 + (_P,)
# x, w, out, x_int16, w_int16, n, h, w, ic, oc, shift, stream
_PACKED_ARGTYPES = (_P, _P, _P) + (_I,) * 8 + (_P,)


def _layer_taps(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, ic) → 'same'-padded tap stack (N, H, W, ic, 9)."""
    n, h, wd, ic = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)).permute(0, 2, 3, 1)
    return torch.stack([xp[:, di:di + h, dj:dj + wd, :]
                        for di in range(3) for dj in range(3)], dim=-1)


def fused_dot_layer_plain(x, w, *, data_bits: int, coeff_bits: int):
    """Plain version of ``fused_dot_layer``: the reference's im2col dot
    with operands cast to ``_dot_dtype``, summed exactly in int64 one
    tap at a time and wrapped to int32."""
    n, h, wd, ic = x.shape
    oc = w.shape[0]
    ddt = conv2d._dot_dtype(data_bits, coeff_bits)
    pat = _layer_taps(x.to(ddt).to(torch.int64))         # (N, H, W, ic, 9)
    wm = w.to(ddt).to(torch.int64).reshape(oc, ic, 9)
    acc = torch.zeros((n, h, wd, oc), dtype=torch.int64, device=x.device)
    for t in range(9):
        acc = acc + (pat[..., None, :, t] * wm[:, :, t]).sum(dim=-1)
    return conv2d.wrap_int(acc).to(torch.int32).permute(0, 3, 1, 2) \
        .contiguous()


def fused_dot_layer(x, w, *, data_bits: int, coeff_bits: int):
    """One integer dot for the whole layer: x (N, H, W, ic) container
    int, w (oc, ic, 3, 3) → exact int32 (N, oc, H, W).  On the card an
    implicit GEMM that never writes the im2col matrix
    (``csrc/fused_dot_layer.cu``); the plain version on the CPU."""
    conv2d.check_layer_operands("fused_dot_layer", x, w)
    if x.device.type == "cpu":
        return fused_dot_layer_plain(x, w, data_bits=data_bits,
                                     coeff_bits=coeff_bits)
    if conv2d._dot_dtype(data_bits, coeff_bits) == torch.int8:
        # the reference narrows both operands to its int8 dot dtype
        x, w = x.to(torch.int8), w.to(torch.int8)
    return conv2d.launch_layer(fused_dot_layer, _FUSED_ARGTYPES, x, w,
                               w.shape[0], w.numel())


fused_dot_layer.launches = 0


def _check_pack_shift(data_bits: int, coeff_bits: int) -> int:
    s = conv2d._pack_shift(data_bits, coeff_bits)
    if s > conv2d.PACK_SHIFT_BUDGET:
        raise ValueError(
            f"packed_dot_layer: pack shift {s} = data_bits + coeff_bits + 3 "
            f"exceeds the {conv2d.PACK_SHIFT_BUDGET}-bit int32 operand "
            f"(data_bits={data_bits}, coeff_bits={coeff_bits})")
    return s


def packed_dot_layer_plain(x, w, *, data_bits: int, coeff_bits: int):
    """Plain version of ``packed_dot_layer``: the reference's paired
    operands, one int32 dot per input plane (exact in int64, then
    wrapped), the signed field split per plane, then the int32 sum over
    input channels."""
    n, h, wd, ic = x.shape
    oc = w.shape[0]
    s = _check_pack_shift(data_bits, coeff_bits)
    if oc % 2:                      # odd tail: duplicate + discard twin
        w = torch.cat([w, w[-1:]], dim=0)
    pairs = w.shape[0] // 2
    wk = w.to(torch.int64).reshape(pairs, 2, ic, 9)
    packed = conv2d.wrap_int(wk[:, 0] * (1 << s) + wk[:, 1])  # (p, ic, 9)
    pat = _layer_taps(x.to(torch.int64))                  # (N, H, W, ic, 9)
    acc = torch.zeros((n, h, wd, pairs, ic), dtype=torch.int64,
                      device=x.device)
    for t in range(9):
        acc = acc + pat[..., None, :, t] * packed[:, :, t]
    acc = conv2d.wrap_int(acc)
    half = 1 << (s - 1)
    lo = ((acc + half) & ((1 << s) - 1)) - half           # signed low field
    hi = conv2d.wrap_int(acc - lo) >> s
    out = torch.stack([conv2d.wrap_int(hi.sum(dim=-1)),
                       conv2d.wrap_int(lo.sum(dim=-1))], dim=-1)
    return out.reshape(n, h, wd, pairs * 2)[..., :oc].to(torch.int32) \
        .permute(0, 3, 1, 2).contiguous()


def packed_dot_layer(x, w, *, data_bits: int, coeff_bits: int):
    """Conv3's operand packing, layer-fused: coefficient pairs share one
    int32 operand (w_hi·2^S + w_lo), halving the dot width; the S-bit
    field split happens per input plane, before the sum over input
    channels.  x (N, H, W, ic), w (oc, ic, 3, 3) → exact int32 (N, oc,
    H, W).  On the card ``csrc/packed_dot_layer.cu``; the plain version
    on the CPU.  Takes every design point whose shift S = d + c + 3
    fits the int32 operand (where the reference's raises, this does)."""
    conv2d.check_layer_operands("packed_dot_layer", x, w)
    s = _check_pack_shift(data_bits, coeff_bits)
    if x.device.type == "cpu":
        return packed_dot_layer_plain(x, w, data_bits=data_bits,
                                      coeff_bits=coeff_bits)
    return conv2d.launch_layer(packed_dot_layer, _PACKED_ARGTYPES, x, w,
                               w.shape[0], (w.shape[0] + 1) // 2 * w.shape[1]
                               * 9, s)


packed_dot_layer.launches = 0
