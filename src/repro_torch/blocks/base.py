"""Abstract ``ConvBlock`` and the layer-fused dot kernels.

Port of ``repro.blocks.base``.  A block carries the paper's metadata
(``name``, ``convs_per_step``, ``dual_output``, ``weight_shape``,
``supports``, ``packed_ok``) and runs:

* ``apply`` — one (H, W) plane through the block's plane kernel
  (``plane_kernel``: K3–K6 on the card), ``reference`` its oracle;
* ``apply_batched`` on one (H, W, in_ch) image — every (out_ch, in_ch)
  plane (channel pairs for dual blocks) in one plane-kernel launch, then
  the sum over in_ch, as the reference's vmapped ``_apply_batched``;
* ``apply_batched`` on an (N, H, W, in_ch) batch: ``batched_layer``,
  by default the block's whole-layer kernel (``layer_kernel``); the dot
  blocks override it, as in the reference, with ``fused_dot_layer`` and
  ``packed_dot_layer`` — CUDA kernels here, each with its plain PyTorch
  version beside it;
* ``apply_batched_requant`` — the serving path (``runtime.LayerLaunch``):
  the layer and its requantize, ``requantize(apply_batched(...))``.
  The dot blocks run it as one launch, ``fused_dot_layer_requant`` and
  ``packed_dot_layer_requant``, whose epilogue writes the next layer's
  channels-last container.

``apply`` and ``apply_batched`` return the exact int32 accumulator,
Σ_ic conv(x[..., ic], w[oc, ic]).  ``kernel_body`` hands the census (``core.census``) the
block's plain row-tile body, the counterpart of the reference's Pallas
body.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, conv2d, ref

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

    def serving_kernels(self, data_bits: int, coeff_bits: int
                        ) -> Tuple[str, ...]:
        """The kernel libraries ``apply_batched_requant`` launches at
        this design point on the card — what preparing a serving launch
        builds.  Default: every kernel of ``build.KERNELS`` (a block
        that does not say); the paper's blocks name their own."""
        del data_bits, coeff_bits
        return build.KERNELS

    # -- execution ----------------------------------------------------

    def kernel_body(self, *, data_bits: int, coeff_bits: int):
        """The plain row-tile body (subclasses): a callable (xpad tile,
        weights) → int32 tile, the counterpart of the reference's Pallas
        body, which the census counts."""
        raise NotImplementedError(f"{self.name}: no kernel body")

    def plane_kernel(self, x, w, *, data_bits: int, coeff_bits: int):
        """The block's plane kernel (subclasses): x (P, H, W), w (P,
        *weight_shape()) → int32 (P, H, W), or (P, 2, H, W) for dual
        blocks."""
        raise NotImplementedError(f"{self.name}: no plane kernel")

    def layer_kernel(self, x, w, *, data_bits: int, coeff_bits: int):
        """The block's whole-layer kernel (subclasses)."""
        raise NotImplementedError(
            f"{self.name}: no whole-layer kernel; override batched_layer")

    def _validate(self, x, w, data_bits: int, coeff_bits: int,
                  tile_h: int) -> None:
        """The plane checks of the reference's ``apply``, with its
        messages."""
        if not self.supports(data_bits, coeff_bits):
            raise ValueError(
                f"{self.name}: unsupported design point "
                f"(data_bits={data_bits}, coeff_bits={coeff_bits})")
        want = self.weight_shape(coeff_bits)
        if tuple(w.shape) != want:
            raise ValueError(
                f"{self.name}: weight shape {tuple(w.shape)} != {want}")
        if x.shape[0] % tile_h:
            raise ValueError(
                f"{self.name}: image height {x.shape[0]} not divisible by "
                f"tile_h={tile_h}")

    def apply(self, x, w, *, data_bits: int, coeff_bits: int,
              tile_h: int = 16):
        """One plane through the block's plane kernel.  x: (H, W)
        container int; w: ``weight_shape()``.  Returns the int32
        'same'-padded conv output — (H, W), or (2, H, W) for dual-output
        blocks."""
        self._validate(x, w, data_bits, coeff_bits, tile_h)
        return self.plane_kernel(x[None].contiguous(), w[None].contiguous(),
                                 data_bits=data_bits,
                                 coeff_bits=coeff_bits)[0]

    def reference(self, x, w):
        """Plain oracle for ``apply`` (exact integer arithmetic)."""
        if self.dual_output:
            return torch.stack([ref.conv2d_3x3_ref(x, w[0]),
                                ref.conv2d_3x3_ref(x, w[1])])
        return ref.conv2d_3x3_ref(x, w)

    def _validate_layer(self, x, w, data_bits: int, coeff_bits: int,
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
        self._validate_layer(x, w, data_bits, coeff_bits, tile_h)
        if x.ndim == 4:
            return self.batched_layer(x, w, data_bits=data_bits,
                                      coeff_bits=coeff_bits, tile_h=tile_h)
        return self.plane_layer(x, w, data_bits=data_bits,
                                coeff_bits=coeff_bits)

    def plane_layer(self, x, w, *, data_bits: int, coeff_bits: int):
        """One image's layer on the plane kernel, as the reference's
        ``_apply_batched``: x (H, W, in_ch), w (out_ch, in_ch, 3, 3) →
        int32 (out_ch, H, W).  Every (out_ch, in_ch) plane — for dual
        blocks every (channel pair, in_ch) plane, an odd last channel
        paired with a copy of itself and the twin discarded — goes
        through one plane-kernel launch, then the int32 sum over
        in_ch."""
        h, wd, ic = x.shape
        oc = w.shape[0]
        kw = dict(data_bits=data_bits, coeff_bits=coeff_bits)
        if not self.dual_output:
            xs = x.permute(2, 0, 1).expand(oc, ic, h, wd)
            y = self.plane_kernel(
                xs.reshape(oc * ic, h, wd).contiguous(),
                w.reshape(oc * ic, 3, 3).contiguous(), **kw)
            return conv2d.wrap_int(y.reshape(oc, ic, h, wd).sum(dim=1)) \
                .to(torch.int32)
        if oc % 2:
            w = torch.cat([w, w[-1:]], dim=0)
        pairs = w.shape[0] // 2
        wp = w.reshape(pairs, 2, ic, 3, 3).transpose(1, 2)  # (p, ic, 2, ..)
        xs = x.permute(2, 0, 1).expand(pairs, ic, h, wd)
        y = self.plane_kernel(xs.reshape(pairs * ic, h, wd).contiguous(),
                              wp.reshape(pairs * ic, 2, 3, 3).contiguous(),
                              **kw)
        acc = conv2d.wrap_int(y.reshape(pairs, ic, 2, h, wd).sum(dim=1))
        return acc.reshape(pairs * 2, h, wd)[:oc].to(torch.int32)

    def apply_batched_requant(self, x, w, *, data_bits: int,
                              coeff_bits: int, shift: int, tile_h: int = 16):
        """One CNN layer on an (N, H, W, in_ch) batch and its requantize:
        ``conv2d.requantize(apply_batched(x, w, ...), shift, data_bits)``,
        the next layer's activations (N, H, W, out_ch) in
        ``container_dtype(data_bits)``, through ``batched_layer_requant``:
        one launch for the dot blocks."""
        self._validate_layer(x, w, data_bits, coeff_bits, tile_h)
        return self.batched_layer_requant(x, w, data_bits=data_bits,
                                          coeff_bits=coeff_bits, shift=shift)

    def batched_layer_requant(self, x, w, *, data_bits: int,
                              coeff_bits: int, shift: int):
        """Whole-batch layer and requantize: x (N, H, W, in_ch) → (N, H,
        W, out_ch) in ``container_dtype(data_bits)``.  Default:
        ``batched_layer``, then ``conv2d.requantize``; the dot blocks
        override this with the requantizing entries of their kernels."""
        return conv2d.requantize(
            self.batched_layer(x, w, data_bits=data_bits,
                               coeff_bits=coeff_bits), shift, data_bits)

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
# the same, then shift, out_bits
_FUSED_REQUANT_ARGTYPES = (_P, _P, _P) + (_I,) * 9 + (_P,)
# x, w, out, x_int16, w_int16, n, h, w, ic, oc, pack_shift, stream
_PACKED_ARGTYPES = (_P, _P, _P) + (_I,) * 8 + (_P,)
# the same, then shift, out_bits
_PACKED_REQUANT_ARGTYPES = (_P, _P, _P) + (_I,) * 10 + (_P,)


def _layer_taps(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, ic) → 'same'-padded tap stack (N, H, W, ic, 9)."""
    n, h, wd, ic = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)).permute(0, 2, 3, 1)
    return torch.stack([xp[:, di:di + h, dj:dj + wd, :]
                        for di in range(3) for dj in range(3)], dim=-1)


def fused_dot_route(data_bits: int, coeff_bits: int) -> str:
    """The route ``fused_dot_layer`` takes on the card for operands in
    their widths' containers: ``dp4a`` where ``_dot_dtype`` is int8
    (every layer of the committed plans; the wrapper narrows both
    operands to int8 and the C entry runs ``__dp4a`` on two int8
    containers), else ``imad``, 32-bit multiply-adds on the CUDA
    cores."""
    return "dp4a" if conv2d._dot_dtype(data_bits, coeff_bits) == torch.int8 \
        else "imad"


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
    implicit GEMM over a staged tile that never writes the im2col matrix
    (``csrc/fused_dot_layer.cu``), on the route ``fused_dot_route``
    names; the plain version on the CPU."""
    conv2d.check_layer_operands("fused_dot_layer", x, w)
    if x.device.type == "cpu":
        return fused_dot_layer_plain(x, w, data_bits=data_bits,
                                     coeff_bits=coeff_bits)
    x, w = conv2d.narrow_to_dot_dtype(x, w, data_bits, coeff_bits)
    return conv2d.launch_layer("fused_dot_layer", _FUSED_ARGTYPES, x, w,
                               w.shape[0], w.numel())


def fused_dot_layer_requant_plain(x, w, *, data_bits: int, coeff_bits: int,
                                  shift: int, out_bits: int):
    """Plain version of ``fused_dot_layer_requant``:
    ``conv2d.requantize`` of ``fused_dot_layer_plain``."""
    return conv2d.requantize(
        fused_dot_layer_plain(x, w, data_bits=data_bits,
                              coeff_bits=coeff_bits), shift, out_bits)


def fused_dot_layer_requant(x, w, *, data_bits: int, coeff_bits: int,
                            shift: int, out_bits: int):
    """``fused_dot_layer`` and the layer's requantize in one launch:
    x (N, H, W, ic), w (oc, ic, 3, 3) → (N, H, W, oc) in
    ``container_dtype(out_bits)``, equal to ``conv2d.requantize(
    fused_dot_layer(x, w, ...), shift, out_bits)``.  The kernel's
    epilogue shifts, clamps and writes the channels-last container, so
    the int32 accumulator never reaches device memory."""
    name = "fused_dot_layer_requant"
    conv2d.check_layer_operands(name, x, w)
    conv2d.check_requant(name, shift, out_bits)
    if x.device.type == "cpu":
        return fused_dot_layer_requant_plain(
            x, w, data_bits=data_bits, coeff_bits=coeff_bits, shift=shift,
            out_bits=out_bits)
    x, w = conv2d.narrow_to_dot_dtype(x, w, data_bits, coeff_bits)
    return conv2d.launch_layer(name, _FUSED_REQUANT_ARGTYPES, x, w,
                               w.shape[0], w.numel(), min(shift, 31),
                               out_bits, out_bits=out_bits)


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
    return conv2d.launch_layer("packed_dot_layer", _PACKED_ARGTYPES, x, w,
                               w.shape[0], (w.shape[0] + 1) // 2 * w.shape[1]
                               * 9, s)


def packed_dot_layer_requant_plain(x, w, *, data_bits: int, coeff_bits: int,
                                   shift: int, out_bits: int):
    """Plain version of ``packed_dot_layer_requant``:
    ``conv2d.requantize`` of ``packed_dot_layer_plain``."""
    return conv2d.requantize(
        packed_dot_layer_plain(x, w, data_bits=data_bits,
                               coeff_bits=coeff_bits), shift, out_bits)


def packed_dot_layer_requant(x, w, *, data_bits: int, coeff_bits: int,
                             shift: int, out_bits: int):
    """``packed_dot_layer`` and the layer's requantize in one launch:
    x (N, H, W, ic), w (oc, ic, 3, 3) → (N, H, W, oc) in
    ``container_dtype(out_bits)``, equal to ``conv2d.requantize(
    packed_dot_layer(x, w, ...), shift, out_bits)``; the epilogue writes
    the channels-last container."""
    name = "packed_dot_layer_requant"
    conv2d.check_layer_operands(name, x, w)
    conv2d.check_requant(name, shift, out_bits)
    s = _check_pack_shift(data_bits, coeff_bits)
    if x.device.type == "cpu":
        return packed_dot_layer_requant_plain(
            x, w, data_bits=data_bits, coeff_bits=coeff_bits, shift=shift,
            out_bits=out_bits)
    return conv2d.launch_layer(name, _PACKED_REQUANT_ARGTYPES, x, w,
                               w.shape[0], (w.shape[0] + 1) // 2 * w.shape[1]
                               * 9, s, min(shift, 31), out_bits,
                               out_bits=out_bits)
