"""Integer helpers of the convolution blocks, the Conv1 layer kernel
and the per-plane kernels of Conv2, Conv3 and Conv4.

Port of ``repro.kernels.conv2d``.  The helpers keep the reference's
names and rules (containers, packing limit, accumulator and dot widths).

* ``conv1_layer`` replaces ``conv1_kernel`` as ``ConvBlock.batched_layer``
  drives it: one launch for a whole layer.
* ``conv2_planes``, ``conv3_planes`` and ``conv4_planes`` replace
  ``conv2_kernel``, ``conv3_kernel`` and ``conv4_kernel`` as the
  reference's vmapped ``pallas_call`` runs them: a batch of P planes,
  each with its own weights, in one launch.

Every kernel has a plain PyTorch version beside it, which follows the
kernel's integer widths.  The per-plane plain versions follow the Pallas
bodies row tile by row tile (``conv1_tile`` … ``conv4_tile`` over
``run_plane_tiles``'s grid), in the reference's dtypes, and contract
with ``int_dot``; ``core.census`` counts the same tile bodies.  A
wrapper runs the plain version for a tensor on the CPU and launches the
CUDA kernel for a tensor on the card (or raises) through
``build.launch``, which counts it in ``build.LAUNCHES`` under the C
entry's name (the wrapper's).
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


def narrow_to_dot_dtype(x, w, data_bits: int, coeff_bits: int):
    """The reference's dots narrow both operands to int8 where
    ``_dot_dtype`` is int8; the kernels take the narrowed containers.
    An operand already in int8 is returned as it is, without a call
    into torch (the per-plane path makes one launch per plane)."""
    if _dot_dtype(data_bits, coeff_bits) == torch.int8:
        if x.dtype != torch.int8:
            x = x.to(torch.int8)
        if w.dtype != torch.int8:
            w = w.to(torch.int8)
    return x, w


def requantize(acc: torch.Tensor, shift: int, out_bits: int
               ) -> torch.Tensor:
    """A layer's rescale + ReLU + requantize: the int32 accumulator —
    (out_ch, H, W) or (N, out_ch, H, W) — shifted right arithmetically
    by ``min(shift, 31)`` (a shift past 31 fills with the sign, as XLA's
    does), clamped to [0, 2^(out_bits−1) − 1], cast to
    ``container_dtype(out_bits)`` and laid out channels-last,
    contiguous."""
    hi = (1 << (out_bits - 1)) - 1
    return torch.clamp(acc >> min(shift, 31), 0, hi) \
        .to(container_dtype(out_bits)).movedim(-3, -1).contiguous()


def check_requant(name: str, shift: int, out_bits: int) -> None:
    """What a requantizing entry takes: a shift ≥ 0 and an output width
    whose container is int8 or int16."""
    if shift < 0 or not 1 <= out_bits <= 16:
        raise ValueError(f"{name}: need shift >= 0 and 1 <= out_bits <= 16, "
                         f"got shift={shift}, out_bits={out_bits}")


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


def _im2col(xpad: torch.Tensor, th: int, w: int) -> torch.Tensor:
    """(…, th+2, w+2) padded tile → (…, th·w, 9) patches."""
    return torch.stack(_taps(xpad, th, w), dim=-1) \
        .reshape(*xpad.shape[:-2], th * w, 9)


@torch.library.custom_op("repro_torch::int_dot", mutates_args=())
def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched integer dot a (…, m, k) · b (…, k, n) → int32 (…, m, n),
    exact modulo 2^32: the reference's ``dot_general`` with
    ``preferred_element_type=int32``.  One operator, so that the census
    sees a dot in its operands' types (``mxu_flops``, ``mxu_cost``), not
    the int64 products this plain form computes it with."""
    prod = a.to(torch.int64).unsqueeze(-1) * b.to(torch.int64).unsqueeze(-3)
    return wrap_int(prod.sum(dim=-2)).to(torch.int32)


@int_dot.register_fake
def _int_dot_shape(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.new_empty((*a.shape[:-1], b.shape[-1]), dtype=torch.int32)


def _check_containers(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in CONTAINERS or w.dtype not in CONTAINERS:
        raise ValueError(
            f"{name}: x and w must be int8 or int16 containers, got "
            f"{x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device} but w on {w.device}")


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
    _check_containers(name, x, w)


def launch_layer(name: str, argtypes, x: torch.Tensor, w: torch.Tensor,
                 out_channels: int, weight_words: int, *extra: int,
                 out_bits: int | None = None) -> torch.Tensor:
    """Launch the C entry ``name`` on x (``build.launch``) and return
    the int32 accumulator (N, out_channels, H, W) — or, for a
    requantizing entry (``out_bits`` given), the channels-last
    activations (N, H, W, out_channels) in ``container_dtype(out_bits)``.
    Raises on what the kernel does not take (beyond ``build.launch``'s
    checks, weights past the shared-memory budget)."""
    if 4 * weight_words > SMEM_WEIGHT_BYTES:
        raise ValueError(
            f"{name}: {weight_words} staged weight words exceed the "
            f"kernel's {SMEM_WEIGHT_BYTES}-byte shared-memory budget")
    n, h, wd, ic = x.shape
    if out_bits is None:
        out = torch.empty((n, out_channels, h, wd), dtype=torch.int32,
                          device=x.device)
    else:
        out = torch.empty((n, h, wd, out_channels),
                          dtype=container_dtype(out_bits), device=x.device)
    return build.launch(name, argtypes, (x, w), out, x.data_ptr(),
                        w.data_ptr(), out.data_ptr(),
                        int(x.dtype == torch.int16),
                        int(w.dtype == torch.int16), n, h, wd, ic,
                        w.shape[0], *extra)


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
    card (``csrc/conv1_layer.cu``, which computes each shift-add plane as
    the same sum modulo 2^32 of taps times w' = sign(w)·(|w| & mask));
    the plain version on the CPU."""
    check_layer_operands("conv1_layer", x, w)
    if x.device.type == "cpu":
        return conv1_layer_plain(x, w, data_bits=data_bits,
                                 coeff_bits=coeff_bits)
    acc16 = int(_acc_dtype(data_bits, coeff_bits) == torch.int16)
    return launch_layer("conv1_layer", _CONV1_ARGTYPES, x, w, w.shape[0],
                        w.numel(), coeff_bits, acc16)


# ---------------------------------------------------------------------------
# per-plane kernels: the Pallas bodies conv2/3/4_kernel over P planes
# ---------------------------------------------------------------------------

def conv1_tile(xpad: torch.Tensor, wk: torch.Tensor, *, data_bits: int,
               coeff_bits: int) -> torch.Tensor:
    """Body of ``conv1_kernel`` on one padded row tile: xpad (…, th+2,
    w+2) container int, wk (…, 3, 3) → int32 (…, th, w).  Per tap,
    ``coeff_bits`` masked shift-adds by the bits of |w|, then w's sign,
    in the accumulator dtype ``_acc_dtype`` picks (int16 only where no
    sum can wrap; int32 wraps as the reference's does).  The plane
    kernel of Conv1 is ``conv1_layer``, the same function."""
    adt = _acc_dtype(data_bits, coeff_bits)
    th, w = xpad.shape[-2] - 2, xpad.shape[-1] - 2
    taps = _taps(xpad.to(adt), th, w)
    wk = wk.to(adt)
    one = torch.ones((), dtype=adt, device=xpad.device)
    acc = torch.zeros((*xpad.shape[:-2], th, w), dtype=adt,
                      device=xpad.device)
    for t, tap in enumerate(taps):
        c = wk[..., t // 3, t % 3, None, None]
        mag = c.abs()
        sign = torch.where(c < 0, -one, one)
        part = torch.zeros_like(acc)
        for b in range(coeff_bits):          # unrolled: ops ∝ coeff_bits
            part = part + torch.where(((mag >> b) & 1) == 1, tap << b,
                                      torch.zeros_like(tap))
        acc = acc + sign * part
    return acc.to(torch.int32)


def conv2_tile(xpad: torch.Tensor, wk: torch.Tensor, *, data_bits: int,
               coeff_bits: int) -> torch.Tensor:
    """Body of ``conv2_kernel``: (th·w, 9) im2col · the 9 taps in
    ``_dot_dtype``.  xpad (…, th+2, w+2), wk (…, 3, 3) → int32 (…, th,
    w)."""
    ddt = _dot_dtype(data_bits, coeff_bits)
    th, w = xpad.shape[-2] - 2, xpad.shape[-1] - 2
    patches = _im2col(xpad.to(ddt), th, w)
    y = int_dot(patches, wk.to(ddt).reshape(*wk.shape[:-2], 9, 1))
    return y.reshape(*xpad.shape[:-2], th, w)


def conv3_tile(xpad: torch.Tensor, wk: torch.Tensor, *, data_bits: int,
               coeff_bits: int) -> torch.Tensor:
    """Body of ``conv3_kernel``: xpad (…, th+2, w+2), wk (…, 2, 3, 3) →
    int32 (…, 2, th, w).  Inside the packing regime one int32 dot with
    the operand (w_hi << S) + w_lo, S = d+c+3, then the signed field
    split; outside it two dots in ``_dot_dtype``."""
    th, w = xpad.shape[-2] - 2, xpad.shape[-1] - 2
    lead = xpad.shape[:-2]
    patches = _im2col(xpad.to(torch.int32), th, w)
    wk = wk.to(torch.int32).reshape(*wk.shape[:-3], 2, 9)
    if conv3_packed_ok(data_bits, coeff_bits):
        s = _pack_shift(data_bits, coeff_bits)
        packed = (wk[..., 0, :] << s) + wk[..., 1, :]
        acc = int_dot(patches, packed[..., None]).reshape(*lead, th, w)
        half = 1 << (s - 1)
        lo = ((acc + half) & ((1 << s) - 1)) - half      # signed low field
        hi = (acc - lo) >> s
        return torch.stack([hi, lo], dim=-3)
    # packing infeasible → two dots (degenerates to Conv4)
    ddt = _dot_dtype(data_bits, coeff_bits)
    return torch.stack([
        int_dot(patches.to(ddt), wk[..., j, :, None].to(ddt))
        .reshape(*lead, th, w) for j in range(2)], dim=-3)


def conv4_tile(xpad: torch.Tensor, wk: torch.Tensor, *, data_bits: int,
               coeff_bits: int) -> torch.Tensor:
    """Body of ``conv4_kernel``: two independent 9-tap dots in
    ``_dot_dtype``.  xpad (…, th+2, w+2), wk (…, 2, 3, 3) → int32 (…, 2,
    th, w)."""
    ddt = _dot_dtype(data_bits, coeff_bits)
    th, w = xpad.shape[-2] - 2, xpad.shape[-1] - 2
    patches = _im2col(xpad.to(ddt), th, w)
    wk = wk.to(ddt).reshape(*wk.shape[:-3], 2, 9)
    return torch.stack([
        int_dot(patches, wk[..., j, :, None]).reshape(*xpad.shape[:-2], th, w)
        for j in range(2)], dim=-3)


# rows of the plain versions' row tiles (the reference's default tile_h;
# the result does not depend on it)
TILE_H = 16


def run_plane_tiles(tile, x: torch.Tensor, wk: torch.Tensor, *,
                    data_bits: int, coeff_bits: int) -> torch.Tensor:
    """The reference's ``run_block_kernel`` grid in plain form: pad the
    (…, H, W) planes once, run ``tile`` on each row tile of ``TILE_H``
    rows (a shorter last one where H does not divide), and join the
    tiles along H."""
    h = x.shape[-2]
    xpad = F.pad(x, (1, 1, 1, 1))
    return torch.cat([
        tile(xpad[..., r:r + min(TILE_H, h - r) + 2, :], wk,
             data_bits=data_bits, coeff_bits=coeff_bits)
        for r in range(0, h, TILE_H)], dim=-2)


def check_plane_operands(name: str, x: torch.Tensor, w: torch.Tensor,
                         n_out: int) -> None:
    """Shape, dtype and device checks of the plane kernels: x (P, H, W)
    and w (P, 3, 3) — or (P, 2, 3, 3) for two outputs — in int8/int16
    containers, on one device."""
    want = (2, 3, 3) if n_out == 2 else (3, 3)
    if x.ndim != 3 or tuple(w.shape[1:]) != want \
            or w.shape[0] != x.shape[0]:
        raise ValueError(
            f"{name}: expected x (P, H, W) and w (P, "
            f"{', '.join(map(str, want))}), got {tuple(x.shape)} and "
            f"{tuple(w.shape)}")
    _check_containers(name, x, w)


def launch_planes(name: str, argtypes, x: torch.Tensor, w: torch.Tensor,
                  n_out: int, *extra: int) -> torch.Tensor:
    """Launch the plane kernel ``name`` on x (``build.launch``) and
    return the int32 output (P, H, W), or (P, 2, H, W) for two
    outputs.  The per-plane path makes one such call per plane."""
    p, h, wd = x.shape
    shape = (p, 2, h, wd) if n_out == 2 else (p, h, wd)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    return build.launch(name, argtypes, (x, w), out, x.data_ptr(),
                        w.data_ptr(), out.data_ptr(),
                        int(x.dtype == torch.int16),
                        int(w.dtype == torch.int16), p, h, wd, *extra)


# x, w, out, x_int16, w_int16, p, h, w, stream
_PLANE_ARGTYPES = (_P, _P, _P) + (_I,) * 5 + (_P,)
# x, w, out, x_int16, w_int16, p, h, w, shift (0: two dots), stream
_CONV3_ARGTYPES = (_P, _P, _P) + (_I,) * 6 + (_P,)


def conv2_planes_plain(x, w, *, data_bits: int,
                       coeff_bits: int) -> torch.Tensor:
    """Plain version of ``conv2_planes``: ``conv2_tile`` over the row
    tiles of every plane."""
    return run_plane_tiles(conv2_tile, x, w, data_bits=data_bits,
                           coeff_bits=coeff_bits)


def conv2_planes(x, w, *, data_bits: int, coeff_bits: int) -> torch.Tensor:
    """Conv2 on P planes, each with its own weights: x (P, H, W)
    container int, w (P, 3, 3) → exact int32 (P, H, W).  One CUDA launch
    on the card (``csrc/conv2_planes.cu``); the plain version on the
    CPU."""
    check_plane_operands("conv2_planes", x, w, 1)
    if x.device.type == "cpu":
        return conv2_planes_plain(x, w, data_bits=data_bits,
                                  coeff_bits=coeff_bits)
    x, w = narrow_to_dot_dtype(x, w, data_bits, coeff_bits)
    return launch_planes("conv2_planes", _PLANE_ARGTYPES, x, w, 1)


def conv3_planes_plain(x, w, *, data_bits: int,
                       coeff_bits: int) -> torch.Tensor:
    """Plain version of ``conv3_planes``: ``conv3_tile`` over the row
    tiles of every plane."""
    return run_plane_tiles(conv3_tile, x, w, data_bits=data_bits,
                           coeff_bits=coeff_bits)


def conv3_planes(x, w, *, data_bits: int, coeff_bits: int) -> torch.Tensor:
    """Conv3 on P planes: x (P, H, W) container int, w (P, 2, 3, 3) →
    exact int32 (P, 2, H, W).  Inside the packing regime
    (``conv3_packed_ok``) one dot per pixel with the packed operand and
    the signed field split; outside it two dots.  One CUDA launch on the
    card (``csrc/conv3_planes.cu``); the plain version on the CPU."""
    check_plane_operands("conv3_planes", x, w, 2)
    if x.device.type == "cpu":
        return conv3_planes_plain(x, w, data_bits=data_bits,
                                  coeff_bits=coeff_bits)
    shift = 0
    if conv3_packed_ok(data_bits, coeff_bits):
        shift = _pack_shift(data_bits, coeff_bits)
    else:
        x, w = narrow_to_dot_dtype(x, w, data_bits, coeff_bits)
    return launch_planes("conv3_planes", _CONV3_ARGTYPES, x, w, 2, shift)


def conv4_planes_plain(x, w, *, data_bits: int,
                       coeff_bits: int) -> torch.Tensor:
    """Plain version of ``conv4_planes``: ``conv4_tile`` over the row
    tiles of every plane."""
    return run_plane_tiles(conv4_tile, x, w, data_bits=data_bits,
                           coeff_bits=coeff_bits)


def conv4_planes(x, w, *, data_bits: int, coeff_bits: int) -> torch.Tensor:
    """Conv4 on P planes: two independent dots per pixel.  x (P, H, W)
    container int, w (P, 2, 3, 3) → exact int32 (P, 2, H, W).  One CUDA
    launch on the card (``csrc/conv4_planes.cu``); the plain version on
    the CPU."""
    check_plane_operands("conv4_planes", x, w, 2)
    if x.device.type == "cpu":
        return conv4_planes_plain(x, w, data_bits=data_bits,
                                  coeff_bits=coeff_bits)
    x, w = narrow_to_dot_dtype(x, w, data_bits, coeff_bits)
    return launch_planes("conv4_planes", _PLANE_ARGTYPES, x, w, 2)
