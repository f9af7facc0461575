"""Attention with an online softmax: the CUDA kernel K8 and its plain
version.

Port of ``repro.kernels.flash_attention``.  ``flash_attention`` replaces
``flash_attention`` (``_flash_kernel``): q (B, S, H, Dh), k and v
(B, T, KH, Dh); query head h reads kv head h // (H / KH); scale
1/√Dh; a causal mask of ``NEG_INF`` (key col > query row, both counted
from 0); a float32 running max, denominator and accumulator; the output
``acc / max(l, 1e-20)`` in q's dtype.  Unlike the Pallas kernel it takes
any S and T: rows past S are not computed and keys past T are masked.

A wrapper runs the plain version for a tensor on the CPU and launches
the kernel (``csrc/flash_attention.cu``) for a tensor on the card (or
raises) through ``build.launch``, which counts it in
``build.LAUNCHES["flash_attention"]`` and reports its work.  The kernel
has two instantiations behind one entry, chosen by the dtype: bfloat16
runs on the tensor cores (P·V as P_hi·V + P_lo·V, so P keeps about 16
bits), float32 on the CUDA cores.

Gradients: where grad is enabled and an input requires it, the call
goes through ``_FlashAttention``, a ``torch.autograd.Function`` whose
forward is the same launch (the plain version on the CPU, so the CPU
tests run the backward the card runs).  The reference has no backward
kernel: ``jax.grad`` differentiates its model's chunked einsum
attention.  The backward here does the same with torch ops: it
recomputes the model's chunked ``_attend`` one query chunk at a time
and takes ``torch.autograd.grad`` of it, so it never holds more than
one chunk's logits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
FLOATS = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
# the kernel's key tile: the plain version adds its tiles in the same
# groups, so both round the running sums at the same places (query
# tiles change nothing)
BLOCK_K = 64
BLOCK_Q = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """Plain version of ``flash_attention``: the same blocked online
    softmax over (query tile, key tile) pairs, batched over B and H.
    Causal query tiles stop at the diagonal's last key tile (the tiles
    past it are masked whole and change nothing)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / (d ** 0.5)
    qf = q.float().permute(0, 2, 1, 3) * scale             # (B, H, S, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, BLOCK_Q):
        qi = qf[:, :, q0:q0 + BLOCK_Q]
        rows = q0 + torch.arange(qi.shape[2], device=q.device)
        m = torch.full(qi.shape[:3], NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qi)
        t_end = min(t, q0 + qi.shape[2]) if causal else t
        for k0 in range(0, t_end, BLOCK_K):
            kj, vj = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
            sc = qi @ kj.transpose(-1, -2)                  # (B, H, bq, bk)
            if causal:
                cols = k0 + torch.arange(kj.shape[2], device=q.device)
                sc = torch.where(cols[None, :] <= rows[:, None], sc,
                                 torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vj
            m = m_new
        out[:, :, q0:q0 + BLOCK_Q] = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape) \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"flash_attention: expected q (B, S, H, D) and k, v (B, T, KH, D) "
            f"with KH dividing H, got {tuple(q.shape)}, {tuple(k.shape)} "
            f"and {tuple(v.shape)}")
    if q.dtype not in FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k and v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")


_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, bf16, b, s, t, h, kh, d, scale, causal, stream
_ARGTYPES = (_P, _P, _P, _P) + (_I,) * 7 + (ctypes.c_float, _I, _P)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention of q (B, S, H, Dh) over k, v (B, T, KH, Dh) → (B, S, H,
    Dh) in q's dtype (float32 or bfloat16).  One CUDA launch on the card,
    routed by dtype: bfloat16 to the tensor-core kernel, float32 to the
    CUDA-core kernel; a launch the kernel refuses raises and never falls
    back to the other.  The plain version on the CPU.  Differentiable
    (``_FlashAttention``) where grad is enabled and an input requires
    it."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


# the query rows one backward chunk recomputes (the model's q_chunk)
GRAD_CHUNK = 1024


class _FlashAttention(torch.autograd.Function):
    """K8 with a gradient: the forward launches the kernel, the backward
    recomputes the model's chunked attention in torch ops."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, dout):
        # models.attention imports this module: import at call time
        from repro_torch.models.attention import _attend
        q, k, v = ctx.saved_tensors
        b, s, h, d = q.shape
        t, kh = k.shape[1], k.shape[2]
        col_pos = torch.arange(t, device=q.device)
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        with torch.enable_grad():
            kr, vr = k.detach().requires_grad_(), v.detach().requires_grad_()
            for q0 in range(0, s, GRAD_CHUNK):
                qc = q[:, q0:q0 + GRAD_CHUNK].detach().requires_grad_()
                c = qc.shape[1]
                out = _attend(qc.reshape(b, c, kh, h // kh, d), kr, vr,
                              q0 + torch.arange(c, device=q.device), col_pos,
                              causal=ctx.causal, window=None, valid_len=None,
                              cap=None, scale=1.0 / (d ** 0.5))
                gq, gk, gv = torch.autograd.grad(
                    out.reshape(b, c, h, d), (qc, kr, vr),
                    dout[:, q0:q0 + c])
                dq[:, q0:q0 + c] = gq
                dk += gk
                dv += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    """The launch on the card (counted), the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel takes head dims up "
                         f"to {MAX_HEAD_DIM}, got {d}")
    out = torch.empty_like(q)
    # the work: the causal half of 4·B·H·S·T·D
    return build.launch(
        "flash_attention", _ARGTYPES, (q, k, v), out, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, s, t, h, kh, d, 1.0 / (d ** 0.5),
        int(causal), work=((2 if causal else 4) * b * h * s * t * d,
                           sum(x.numel() * x.element_size()
                               for x in (q, k, v, out))))
