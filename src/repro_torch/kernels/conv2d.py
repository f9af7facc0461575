"""Integer helpers of the convolution blocks, and the Conv1 layer kernel.

Port of ``repro.kernels.conv2d``.  The helpers keep the reference's
names and rules (containers, packing limit, accumulator and dot widths).
The TPU's per-plane Pallas bodies become whole-layer kernels here:
``conv1_layer`` replaces ``conv1_kernel`` as ``ConvBlock.batched_layer``
drives it; the per-plane ``conv2/3/4_kernel`` are not ported yet.

Every layer kernel has a plain PyTorch version beside it, which follows
the kernel's integer widths.  A wrapper runs the plain version for a
tensor on the CPU and launches the CUDA kernel for a tensor on the card
(or raises); ``<wrapper>.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

PACK_SHIFT_BUDGET = 31          # int32 accumulator bits
PACKED_LIMIT = 12               # data_bits + coeff_bits ≤ 12 → packed mode

# the containers a layer kernel takes for activations and weights
CONTAINERS = (torch.int8, torch.int16)
# weights a kernel stages in shared memory without opting in above 48 KB
SMEM_WEIGHT_BYTES = 48 * 1024


def container_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def conv3_packed_ok(data_bits: int, coeff_bits: int) -> bool:
    return data_bits + coeff_bits <= PACKED_LIMIT


def _pack_shift(data_bits: int, coeff_bits: int) -> int:
    # |y| <= 9 · 2^(d-1) · 2^(c-1) < 2^(d+c+2); one guard bit for sign.
    return data_bits + coeff_bits + 3


def _acc_dtype(data_bits: int, coeff_bits: int) -> torch.dtype:
    """Narrowest safe accumulator for 9 taps of d-bit × c-bit products:
    d+c-1 product bits + 4 accumulation bits + sign."""
    need = data_bits + coeff_bits + 5
    return torch.int16 if need <= 16 else torch.int32


def _dot_dtype(data_bits: int, coeff_bits: int) -> torch.dtype:
    """int8 operands when both widths fit them, else int32."""
    return torch.int8 if (data_bits <= 8 and coeff_bits <= 8) \
        else torch.int32


def wrap_int(t: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """The ``bits``-bit two's-complement value of an int64 tensor, as
    int64: what an int16/int32 accumulator of the reference holds after
    wrapping.  Plain versions compute exactly in int64 and wrap with
    this, since signed overflow in a narrower dtype is not defined."""
    half = 1 << (bits - 1)
    return ((t + half) & ((1 << bits) - 1)) - half


def _taps(xpad: torch.Tensor, h: int, w: int):
    """The 9 shifted (…, h, w) views of a zero-padded (…, h+2, w+2)
    plane stack, tap t = 3·di + dj."""
    return [xpad[..., di:di + h, dj:dj + w]
            for di in range(3) for dj in range(3)]


def check_layer_operands(name: str, x: torch.Tensor, w: torch.Tensor
                         ) -> None:
    """Shape, dtype and device checks shared by the layer kernels:
    x (N, H, W, ic) and w (oc, ic, 3, 3), both in an int8/int16
    container, on one device."""
    if x.ndim != 4 or w.ndim != 4 \
            or tuple(w.shape[1:]) != (x.shape[-1], 3, 3):
        raise ValueError(
            f"{name}: expected x (N, H, W, ic) and w (oc, ic, 3, 3), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in CONTAINERS or w.dtype not in CONTAINERS:
        raise ValueError(
            f"{name}: x and w must be int8 or int16 containers, got "
            f"{x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device} but w on {w.device}")


def launch_layer(wrapper, argtypes, x: torch.Tensor, w: torch.Tensor,
                 out_channels: int, weight_words: int, *extra: int
                 ) -> torch.Tensor:
    """Launch the kernel of ``wrapper`` (named as it is) on x's device
    and current stream, add one to ``wrapper.launches``, and return the
    (N, out_channels, H, W) int32 output.  Raises on what the kernel
    does not take and on any launch error; never falls back.  An empty
    batch has nothing to compute and launches nothing."""
    name = wrapper.__name__
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for a tensor on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: x is on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}")
    if 4 * weight_words > SMEM_WEIGHT_BYTES:
        raise ValueError(
            f"{name}: {weight_words} staged weight words exceed the "
            f"kernel's {SMEM_WEIGHT_BYTES}-byte shared-memory budget")
    n, h, wd, ic = x.shape
    out = torch.empty((n, out_channels, h, wd), dtype=torch.int32,
                      device=x.device)
    if n == 0:
        return out
    fn = build.kernel(name, argtypes)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
             int(x.dtype == torch.int16), int(w.dtype == torch.int16),
             n, h, wd, ic, w.shape[0], *extra,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(name, err)
    wrapper.launches += 1
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, out, x_int16, w_int16, n, h, w, ic, oc, coeff_bits, acc16, stream
_CONV1_ARGTYPES = (_P, _P, _P) + (_I,) * 9 + (_P,)


def conv1_layer_plain(x: torch.Tensor, w: torch.Tensor, *, data_bits: int,
                      coeff_bits: int) -> torch.Tensor:
    """Plain version of ``conv1_layer``: the TPU's per-tap masked
    shift-add, on every (image, oc, ic) plane at once, each plane wrapped
    to the accumulator width ``_acc_dtype`` picks, then summed over ic
    in int32."""
    n, h, wd, ic = x.shape
    acc_bits = 16 if _acc_dtype(data_bits, coeff_bits) == torch.int16 \
        else 32
    xpad = F.pad(x.permute(0, 3, 1, 2).to(torch.int64), (1, 1, 1, 1))
    wk = w.to(torch.int64)
    mag, neg = wk.abs(), wk < 0
    acc = torch.zeros((n, w.shape[0], ic, h, wd), dtype=torch.int64,
                      device=x.device)
    for t, tap in enumerate(_taps(xpad, h, wd)):
        tap = tap[:, None]                               # (N, 1, ic, H, W)
        m = mag[:, :, t // 3, t % 3][None, :, :, None, None]
        part = torch.zeros_like(acc)
        for b in range(coeff_bits):         # unrolled: ops ∝ coeff_bits
            part = part + torch.where(((m >> b) & 1) == 1, tap * (1 << b), 0)
        s = neg[:, :, t // 3, t % 3][None, :, :, None, None]
        acc = acc + torch.where(s, -part, part)
    planes = wrap_int(acc, acc_bits)                    # (N, oc, ic, H, W)
    return wrap_int(planes.sum(dim=2)).to(torch.int32)


def conv1_layer(x: torch.Tensor, w: torch.Tensor, *, data_bits: int,
                coeff_bits: int) -> torch.Tensor:
    """The multiply-free Conv1 block over a whole layer: x (N, H, W, ic)
    container int, w (oc, ic, 3, 3) → exact int32 (N, oc, H, W) =
    Σ_ic shift-add conv(x[..., ic], w[oc, ic]).  One CUDA launch on the
    card (``csrc/conv1_layer.cu``); the plain version on the CPU."""
    check_layer_operands("conv1_layer", x, w)
    if x.device.type == "cpu":
        return conv1_layer_plain(x, w, data_bits=data_bits,
                                 coeff_bits=coeff_bits)
    acc16 = int(_acc_dtype(data_bits, coeff_bits) == torch.int16)
    return launch_layer(conv1_layer, _CONV1_ARGTYPES, x, w, w.shape[0],
                        w.numel(), coeff_bits, acc16)


conv1_layer.launches = 0
