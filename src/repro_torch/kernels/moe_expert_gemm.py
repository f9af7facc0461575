"""The MoE expert products over the filled rows of each expert's capacity
buffer: two CUDA kernels in each of float32 and bf16, and their plain
version.

The reference computes the experts' FFN with jnp ``einsum``s over the
whole (experts, capacity, d) buffer (``repro.models.moe``).
``expert_ffn_bmm`` runs them as three (two ungated) ``torch.bmm`` over
every row; ``models.moe._expert_ffn`` takes it for every call the
kernels do not take, and it is the kernels' plain version: a row's
products read only that row, so on every filled row it computes what
they do.  ``moe_expert_ffn`` takes each expert's fill, the tokens its
buffer holds (``clamp(counts, max=capacity)``, on the device), and
computes only those rows, in two launches:

* ``moe_expert_gemm_gate_up``: h = silu(x · W_gate) * (x · W_up), the
  SiLU and the product in the kernel's epilogue;
* ``moe_expert_gemm_down``: y = h · W_down.

Each runs the kernel of its tensors' dtype: float32 on the CUDA cores
(``csrc/moe_expert_gemm.cu``: the MoE serving workload), bf16 on the
tensor cores with float32 sums, each output rounded to bf16 once
(``csrc/moe_expert_gemm_bf16.cu``: an LM's MoE MLP).  The two share no
device code: the float32 products want the CUDA cores' multiply-adds,
the bf16 ones the tensor cores.  The bf16 kernels also take ``rows``,
an upper bound of the fills' sum that the host knows (the routed
assignments, tokens × top-k): it sizes their grid over the experts'
row tiles, so that a prefill, whose capacity is every token, launches
no block per empty tile.

Rows at or past an expert's fill are unspecified: the kernels do not
write them (the outputs are ``torch.empty``), and whoever reads the
outputs reads only filled rows.

Each launch goes through ``build.launch``, which counts it in
``build.LAUNCHES`` under its C entry's name (``ENTRIES``: two a call);
``models.moe`` counts there, under ``BMM_FALLBACK``, the expert FFNs it
ran as ``expert_ffn_bmm`` instead (``takes`` says which calls the
kernels take).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# the device the kernels run on
DEVICE = "cuda"
# tensor types the kernels take (a DTensor, a subclass, does not pass)
_PLAIN = (torch.Tensor, torch.nn.Parameter)
_P, _I = ctypes.c_void_p, ctypes.c_int
# each product's C entry and argument types, by dtype: x, w_gate, w_up,
# fill, h, e, cap, d, f, stream; h, w_down, fill, y, e, cap, f, d,
# stream; the bf16 entries take rows before the stream
_GATE_UP = {torch.float32: ("moe_expert_gemm_gate_up",
                            (_P,) * 5 + (_I,) * 4 + (_P,)),
            torch.bfloat16: ("moe_expert_gemm_bf16_gate_up",
                             (_P,) * 5 + (_I,) * 5 + (_P,))}
_DOWN = {torch.float32: ("moe_expert_gemm_down",
                         (_P,) * 4 + (_I,) * 4 + (_P,)),
         torch.bfloat16: ("moe_expert_gemm_bf16_down",
                          (_P,) * 4 + (_I,) * 5 + (_P,))}
# the C entries ``moe_expert_ffn`` launches, and the key of
# ``build.LAUNCHES`` that counts the calls run as ``expert_ffn_bmm``
ENTRIES = tuple(e for t in (_GATE_UP, _DOWN) for e, _ in t.values())
BMM_FALLBACK = "expert_ffn_bmm"

# the dtypes the kernels take, and the elements of the 16 bytes that each
# row's width must be whole multiples of (float4 loads; TMA's strides)
_VECTOR = {torch.float32: 4, torch.bfloat16: 8}


def launches() -> int:
    """The expert kernels' launches in this process: ``build.LAUNCHES``
    summed over ``ENTRIES``."""
    return sum(build.LAUNCHES[e] for e in ENTRIES)


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
    (E, C, D) under weights ``p``: a gated SiLU FFN in float32 or bf16
    (every tensor the same) on the card, off the autograd graph, with
    plain tensors (no DTensor) whose widths are whole 16-byte vectors."""
    if act != "silu" or "w_gate" not in p or x.dtype not in _VECTOR:
        return False
    ts = (x, p["w_gate"], p["w_up"], p["w_down"])
    vec = _VECTOR[x.dtype]
    return (all(type(t) in _PLAIN and t.dtype == x.dtype
                and t.device == x.device for t in ts)
            and x.device.type == DEVICE
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts))
            and x.shape[-1] % vec == 0 and p["w_up"].shape[-1] % vec == 0)


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
    if x.dtype not in _VECTOR or any(t.dtype != x.dtype
                                     for t in (w_gate, w_up, w_down)):
        raise ValueError(f"moe_expert_ffn: float32 or bf16, every tensor "
                         f"the same, got {x.dtype}, {w_gate.dtype}, "
                         f"{w_up.dtype}, {w_down.dtype}")
    if any(t.device != x.device for t in (w_gate, w_up, w_down, fill)):
        raise ValueError("moe_expert_ffn: every tensor on x's device")


def moe_expert_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, fill: torch.Tensor,
                   rows: Optional[int] = None) -> torch.Tensor:
    """The gated SiLU FFN of every expert over its buffer's filled rows:
    x (E, C, D), w_gate and w_up (E, D, F), w_down (E, F, D) in float32
    or bf16, fill (E,) int64 (rows held, at most C) → (E, C, D), whose
    rows at or past an expert's fill are unspecified; ``rows`` an upper
    bound of ``fill.sum()`` (default E · C).  Two launches on the card;
    the plain version (``expert_ffn_bmm``, every row) on the CPU."""
    _check(x, w_gate, w_up, w_down, fill)
    if x.device.type == "cpu":
        return expert_ffn_bmm(x, w_up, w_down, w_gate)
    return moe_expert_gemm_down(
        moe_expert_gemm_gate_up(x, w_gate, w_up, fill, rows), w_down, fill,
        rows)


def _check_vectors(name: str, x, *weights) -> None:
    vec = _VECTOR.get(x.dtype)
    if vec is None or any(t.dtype != x.dtype for t in weights):
        raise ValueError(f"{name}: float32 or bf16 tensors of one dtype, "
                         f"got {[t.dtype for t in (x, *weights)]}")
    if x.shape[-1] % vec or weights[0].shape[-1] % vec:
        raise ValueError(f"{name}: the widths must be multiples of {vec}, "
                         f"got {x.shape[-1]} and {weights[0].shape[-1]}")


def _rows(rows: Optional[int], e: int, cap: int) -> int:
    """The bound of the fills' sum a bf16 launch sizes its grid by: the
    caller's, or every row of the buffer."""
    return e * cap if rows is None else min(int(rows), e * cap)


def moe_expert_gemm_gate_up(x, w_gate, w_up, fill,
                            rows: Optional[int] = None) -> torch.Tensor:
    """silu(x · W_gate) * (x · W_up) on each expert's filled rows, in
    x's dtype: one launch on the card (counted)."""
    _check_vectors("moe_expert_gemm_gate_up", x, w_gate, w_up)
    e, cap, d = x.shape
    f = w_up.shape[-1]
    h = torch.empty((e, cap, f), dtype=x.dtype, device=x.device)
    entry, argtypes = _GATE_UP[x.dtype]
    bound = () if x.dtype == torch.float32 else (_rows(rows, e, cap),)
    # the work of the whole capacity, an upper bound: the fills stay on
    # the device, so the host cannot count the filled rows
    return build.launch(
        entry, argtypes, (x, w_gate, w_up, fill), h, x.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), fill.data_ptr(), h.data_ptr(),
        e, cap, d, f, *bound,
        work=(2 * 2 * e * cap * d * f, x.element_size()
              * (e * cap * d + 2 * e * d * f + e * cap * f)))


def moe_expert_gemm_down(h, w_down, fill,
                         rows: Optional[int] = None) -> torch.Tensor:
    """h · W_down on each expert's filled rows, in h's dtype: one launch
    on the card (counted)."""
    _check_vectors("moe_expert_gemm_down", h, w_down)
    e, cap, f = h.shape
    d = w_down.shape[-1]
    y = torch.empty((e, cap, d), dtype=h.dtype, device=h.device)
    entry, argtypes = _DOWN[h.dtype]
    bound = () if h.dtype == torch.float32 else (_rows(rows, e, cap),)
    return build.launch(
        entry, argtypes, (h, w_down, fill), y, h.data_ptr(),
        w_down.data_ptr(), fill.data_ptr(), y.data_ptr(), e, cap, f, d,
        *bound, work=(2 * e * cap * d * f, h.element_size()
                      * (e * cap * f + e * f * d + e * cap * d)))
