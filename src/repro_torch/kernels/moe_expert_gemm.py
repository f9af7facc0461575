"""The MoE expert products over the filled rows of each expert's capacity
buffer: two CUDA kernels and their plain version.

The reference computes the experts' FFN with jnp ``einsum``s over the
whole (experts, capacity, d) buffer (``repro.models.moe``).
``expert_ffn_bmm`` runs them as three (two ungated) ``torch.bmm`` over
every row; ``models.moe._expert_ffn`` takes it for every call the
kernels do not take, and it is the kernels' plain version: a row's
products read only that row, so on every filled row it computes what
they do.  ``moe_expert_ffn`` takes each expert's fill, the tokens its
buffer holds (``clamp(counts, max=capacity)``, on the device), and
computes only those rows, in float32, in two launches
(``csrc/moe_expert_gemm.cu``):

* ``moe_expert_gemm_gate_up``: h = silu(x · W_gate) * (x · W_up), the
  SiLU and the product in the kernel's epilogue;
* ``moe_expert_gemm_down``: y = h · W_down.

Rows at or past an expert's fill are unspecified: the kernels do not
write them (the outputs are ``torch.empty``), and whoever reads the
outputs reads only filled rows.

``moe_expert_ffn.launches`` counts the kernels' launches (two a call) and
``moe_expert_ffn.bmm_fallbacks`` the expert FFNs that ``models.moe`` ran
as ``expert_ffn_bmm`` instead (``takes`` says which calls the kernels
take).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# the device the kernels run on
DEVICE = "cuda"
# tensor types the kernels take (a DTensor, a subclass, does not pass)
_PLAIN = (torch.Tensor, torch.nn.Parameter)
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w_gate, w_up, fill, h, e, cap, d, f, stream
_GATE_UP_ARGTYPES = (_P,) * 5 + (_I,) * 4 + (_P,)
# h, w_down, fill, y, e, cap, f, d, stream
_DOWN_ARGTYPES = (_P,) * 4 + (_I,) * 4 + (_P,)


def expert_ffn_bmm(x, w_up, w_down, w_gate=None, act=F.silu,
                   mid=lambda h: h):
    """The experts' FFN over every row of their buffers x (E, C, D):
    ``act`` of x · W_gate times x · W_up (``act`` of x · W_up when
    ungated), ``mid`` of that (E, C, F) hidden activation, times W_down:
    three (two) ``torch.bmm``.  The plain version of ``moe_expert_ffn``
    on its filled rows."""
    h = torch.bmm(x, w_up)
    if w_gate is not None:
        h = act(torch.bmm(x, w_gate)) * h
    else:
        h = act(h)
    return torch.bmm(mid(h), w_down)


def takes(x: torch.Tensor, p, act: str) -> bool:
    """Whether the kernels compute the experts' FFN of buffers ``x``
    (E, C, D) under weights ``p``: a gated SiLU FFN in float32 on the
    card, off the autograd graph, with plain tensors (no DTensor) whose
    widths are whole float4s."""
    if act != "silu" or "w_gate" not in p:
        return False
    ts = (x, p["w_gate"], p["w_up"], p["w_down"])
    return (all(type(t) in _PLAIN and t.dtype == torch.float32
                and t.device == x.device for t in ts)
            and x.device.type == DEVICE
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts))
            and x.shape[-1] % 4 == 0 and p["w_up"].shape[-1] % 4 == 0)


def _check(x, w_gate, w_up, w_down, fill) -> None:
    if x.ndim != 3:
        raise ValueError(f"moe_expert_ffn: x must be (E, C, D), got "
                         f"{tuple(x.shape)}")
    e, _, d = x.shape
    f = w_up.shape[-1]
    want = {"w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"moe_expert_ffn: {name} must be {want[name]}, "
                             f"got {tuple(t.shape)}")
    if tuple(fill.shape) != (e,) or fill.dtype != torch.int64:
        raise ValueError(f"moe_expert_ffn: fill must be ({e},) int64, got "
                         f"{tuple(fill.shape)} {fill.dtype}")
    for t in (x, w_gate, w_up, w_down):
        if t.dtype != torch.float32:
            raise ValueError(f"moe_expert_ffn: float32 only, got {t.dtype}")
    if any(t.device != x.device for t in (w_gate, w_up, w_down, fill)):
        raise ValueError("moe_expert_ffn: every tensor on x's device")


def moe_expert_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """The gated SiLU FFN of every expert over its buffer's filled rows:
    x (E, C, D), w_gate and w_up (E, D, F), w_down (E, F, D) in float32,
    fill (E,) int64 (rows held, at most C) → (E, C, D), whose rows at or
    past an expert's fill are unspecified.  Two launches on the card; the
    plain version (``expert_ffn_bmm``, every row) on the CPU."""
    _check(x, w_gate, w_up, w_down, fill)
    if x.device.type == "cpu":
        return expert_ffn_bmm(x, w_up, w_down, w_gate)
    return moe_expert_gemm_down(moe_expert_gemm_gate_up(x, w_gate, w_up, fill),
                                w_down, fill)


def _launchable(name: str, *tensors) -> None:
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for a tensor on {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x is on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if x.shape[-1] % 4 or tensors[1].shape[-1] % 4:
        raise ValueError(f"{name}: the widths must be multiples of 4, got "
                         f"{x.shape[-1]} and {tensors[1].shape[-1]}")


def moe_expert_gemm_gate_up(x, w_gate, w_up, fill) -> torch.Tensor:
    """silu(x · W_gate) * (x · W_up) on each expert's filled rows: one
    launch on the card (counted)."""
    _launchable("moe_expert_gemm_gate_up", x, w_gate, w_up, fill)
    e, cap, d = x.shape
    f = w_up.shape[-1]
    h = torch.empty((e, cap, f), dtype=torch.float32, device=x.device)
    if h.numel() == 0:
        return h
    fn = build.kernel("moe_expert_gemm_gate_up", _GATE_UP_ARGTYPES)
    err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
             fill.data_ptr(), h.data_ptr(), e, cap, d, f,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check("moe_expert_gemm_gate_up", err)
    moe_expert_ffn.launches += 1
    # the work of the whole capacity, an upper bound: the fills stay on
    # the device, so the host cannot count the filled rows
    build.report_work("moe_expert_gemm_gate_up", 2 * 2 * e * cap * d * f,
                      4 * (e * cap * d + 2 * e * d * f + e * cap * f))
    return h


def moe_expert_gemm_down(h, w_down, fill) -> torch.Tensor:
    """h · W_down on each expert's filled rows: one launch on the card
    (counted)."""
    _launchable("moe_expert_gemm_down", h, w_down, fill)
    e, cap, f = h.shape
    d = w_down.shape[-1]
    y = torch.empty((e, cap, d), dtype=torch.float32, device=h.device)
    if y.numel() == 0:
        return y
    fn = build.kernel("moe_expert_gemm_down", _DOWN_ARGTYPES)
    err = fn(h.data_ptr(), w_down.data_ptr(), fill.data_ptr(), y.data_ptr(),
             e, cap, f, d, torch.cuda.current_stream(h.device).cuda_stream)
    build.check("moe_expert_gemm_down", err)
    moe_expert_ffn.launches += 1
    build.report_work("moe_expert_gemm_down", 2 * e * cap * d * f,
                      4 * (e * cap * f + e * f * d + e * cap * d))
    return y


moe_expert_ffn.launches = 0
moe_expert_ffn.bmm_fallbacks = 0
