"""The arithmetic of the port's two redesigned kernels, held on the CPU.

A CUDA kernel cannot run here, but the arithmetic it does can: each test
below computes, in plain PyTorch, exactly what the kernel computes and in
the widths it computes it, and holds that model against the kernel's
plain version (which the card tests hold the kernel against).

* K3 ``conv1_layer`` (``csrc/conv1_layer.cu``) replaces the TPU's masked
  shift-add with one integer multiply-add per (tap, oc): w' = sign(w) ·
  (|w| & (2^coeff_bits − 1)) staged once, each plane Σ_t tap_t · w'_t
  modulo 2^32, the plane's low 16 bits sign-extended where the reference
  accumulates in int16 (d + c + 5 ≤ 16), then the sum over ic modulo
  2^32.  The model equals ``conv1_layer_plain`` bit for bit.
* K8 ``flash_attention`` in bf16 (``csrc/flash_attention.cu``) runs on the
  tensor cores: Q·Kᵀ on bf16 operands summed in float32 and scaled by
  1/√D afterwards, the online softmax per key tile of 64 in float32, and
  P·V as P_hi·V + P_lo·V with P_hi = bf16(P) and P_lo = bf16(P − P_hi).
  Up to D = 128 two key groups take alternate key tiles and merge their
  maxima, sums and accumulators at the end.
  The model is within the card tests' bf16 tolerance (rtol 2^-7, atol
  1e-3) of ``flash_attention_plain``.  With a single bf16 P (P_lo
  dropped, as FA2 and SDPA do) it misses that tolerance at the Llama
  width (1, 300, 24, 8 kv heads, 128), causal: P rounded to 8 bits moves
  the output by more than one bf16 unit.  That is why the kernel keeps
  the split.

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_numerics.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import conv2d, flash_attention as fa
from torch_parity import operands

U32 = (1 << 32) - 1


# ---------------------------------------------------------------------------
# K3: the Conv1 layer as an exact integer multiply-accumulate
# ---------------------------------------------------------------------------

def conv1_product_model(x: torch.Tensor, w: torch.Tensor, *, data_bits: int,
                        coeff_bits: int) -> torch.Tensor:
    """``conv1_layer`` as the kernel computes it.  Every accumulator is a
    uint32 word, kept here as an int64 in [0, 2^32) and masked after each
    add; each product is taken on the signed values (|tap| ≤ 2^15,
    |w'| < 2^16, so it is exact in int64) and is the same modulo 2^32."""
    n, h, wd, ic = x.shape
    wk = w.to(torch.int64)
    mag = wk.abs() & ((1 << coeff_bits) - 1)
    w_prime = torch.where(wk < 0, -mag, mag)          # staged once
    sh = 16 if conv2d._acc_dtype(data_bits, coeff_bits) == torch.int16 \
        else 0
    xpad = F.pad(x.permute(0, 3, 1, 2).to(torch.int64), (1, 1, 1, 1))
    total = torch.zeros((n, w.shape[0], h, wd), dtype=torch.int64)
    for c in range(ic):
        plane = torch.zeros_like(total)
        for t in range(9):
            tap = xpad[:, c, t // 3:t // 3 + h, t % 3:t % 3 + wd]
            wt = w_prime[:, c, t // 3, t % 3]
            plane = (plane + tap[:, None] * wt[None, :, None, None]) & U32
        # (int32)(plane << sh) >> sh: the low 32 - sh bits, sign-extended
        v = (plane << sh) & U32
        v = torch.where(v >= 1 << 31, v - (1 << 32), v) >> sh
        total = (total + v) & U32
    return torch.where(total >= 1 << 31, total - (1 << 32), total) \
        .to(torch.int32)


BITS = range(3, 17)


@pytest.mark.parametrize("d", BITS)
@pytest.mark.parametrize("c", BITS)
def test_conv1_product_form_equals_plain(d, c):
    """The full 3..16 × 3..16 grid, inputs over the signed d-bit range and
    weights over the signed c-bit range with both extremes in."""
    rng = np.random.default_rng(100 * d + c)
    x, w = operands(rng, (2, 6, 9, 3), 4, d, c)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    want = conv2d.conv1_layer_plain(x, w, data_bits=d, coeff_bits=c)
    assert torch.equal(conv1_product_model(x, w, data_bits=d, coeff_bits=c),
                       want)


def _container_range(rng, shape, dtype):
    info = torch.iinfo(dtype)
    a = rng.integers(info.min, info.max + 1, shape)
    a.reshape(-1)[:2] = (info.min, info.max)
    return torch.from_numpy(a).to(dtype)


# the acc16 boundary (d + c + 5 = 16: int16 planes; = 17: int32), the int8
# and int16 containers of each operand, and the widest widths
CONTAINER_POINTS = [(5, 6), (6, 6), (3, 8), (8, 3), (4, 7), (8, 8), (9, 8),
                    (8, 9), (3, 16), (16, 16)]


@pytest.mark.parametrize("d,c", CONTAINER_POINTS)
@pytest.mark.parametrize("x_dtype", [None, torch.int16],
                         ids=["x_own_container", "x_int16"])
def test_conv1_product_form_container_range(d, c, x_dtype):
    """Inputs and weights over their whole int8/int16 container, the most
    negative weight (−128 or −32768, whose magnitude the mask cuts)
    included, on both sides of the acc16 boundary."""
    rng = np.random.default_rng(7 * d + c)
    x = _container_range(rng, (2, 5, 7, 4),
                         x_dtype or conv2d.container_dtype(d))
    w = _container_range(rng, (3, 4, 3, 3), conv2d.container_dtype(c))
    assert int(w.min()) == torch.iinfo(w.dtype).min
    want = conv2d.conv1_layer_plain(x, w, data_bits=d, coeff_bits=c)
    assert torch.equal(conv1_product_model(x, w, data_bits=d, coeff_bits=c),
                       want)


def test_conv1_acc16_boundary_wraps_differently():
    """The two sides of the boundary are different functions on operands
    whose planes leave the int16 range (9 · 127 · 63 > 2^15), and the
    model follows each."""
    x = torch.full((1, 6, 6, 2), 127, dtype=torch.int8)
    w = torch.full((2, 2, 3, 3), 63, dtype=torch.int8)
    y16 = conv1_product_model(x, w, data_bits=5, coeff_bits=6)
    y32 = conv1_product_model(x, w, data_bits=6, coeff_bits=6)
    assert not torch.equal(y16, y32)
    assert torch.equal(y16, conv2d.conv1_layer_plain(
        x, w, data_bits=5, coeff_bits=6))
    assert torch.equal(y32, conv2d.conv1_layer_plain(
        x, w, data_bits=6, coeff_bits=6))


# ---------------------------------------------------------------------------
# K8: bf16 attention on the tensor cores
# ---------------------------------------------------------------------------

BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)    # the card tests' bf16 bound


def flash_tensor_core_model(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            split_p: bool = True) -> torch.Tensor:
    """bf16 ``flash_attention`` as the tensor-core kernel computes it, per
    key tile of ``fa.BLOCK_K``: float32 sums of bf16 products, the scale
    applied to the float32 scores, masked to ``NEG_INF``; P split into
    bf16 hi and lo parts for P·V (``split_p=False``: P rounded to bf16
    once); up to D = 128, two key groups of alternate tiles, merged."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / (d ** 0.5)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    groups = 2 if d <= 128 else 1
    parts = [_online_softmax(qf, kf, vf, scale, causal, split_p,
                             range(grp * fa.BLOCK_K, t,
                                   groups * fa.BLOCK_K))
             for grp in range(groups)]
    m, l, acc = parts[0]
    for m_g, l_g, acc_g in parts[1:]:
        m_new = torch.maximum(m, m_g)
        a0, a1 = torch.exp(m - m_new), torch.exp(m_g - m_new)
        l = l * a0 + l_g * a1
        acc = acc * a0[..., None] + acc_g * a1[..., None]
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _online_softmax(qf, kf, vf, scale, causal, split_p, tiles):
    """(running max, sum, accumulator) of one key group over the key tiles
    starting at ``tiles``."""
    b, h, s, d = qf.shape
    rows = torch.arange(s)
    m = torch.full((b, h, s), fa.NEG_INF)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for k0 in tiles:
        kj, vj = kf[:, :, k0:k0 + fa.BLOCK_K], vf[:, :, k0:k0 + fa.BLOCK_K]
        sc = (qf @ kj.transpose(-1, -2)) * scale
        if causal:
            cols = k0 + torch.arange(kj.shape[2])
            sc = torch.where(cols[None, :] <= rows[:, None], sc,
                             torch.full_like(sc, fa.NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vj
        if split_p:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vj
        acc = acc * alpha[..., None] + pv
        m = m_new
    return m, l, acc


def _qkv(b, s, t, h, kh, d, seed):
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(torch.bfloat16)
    return bf16(b, s, h, d), bf16(b, t, kh, d), bf16(b, t, kh, d)


# (B, S, T, H, KH, D, causal): the Llama-3.2-3B width at a length that is
# not a tile multiple, D = 8, 72 and 256, MQA, and S != T non-causal
K8_CASES = [(1, 300, 300, 24, 8, 128, True),
            (2, 100, 100, 4, 2, 8, True),
            (1, 130, 130, 6, 3, 72, True),
            (1, 100, 160, 4, 2, 256, True),
            (2, 128, 128, 8, 1, 64, True),
            (1, 70, 200, 4, 2, 128, False),
            (2, 200, 70, 8, 1, 128, False)]


@pytest.mark.parametrize("b,s,t,h,kh,d,causal", K8_CASES)
def test_flash_split_p_model_within_bf16_tolerance(b, s, t, h, kh, d,
                                                   causal):
    q, k, v = _qkv(b, s, t, h, kh, d, seed=s + t + d)
    got = flash_tensor_core_model(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_flash_single_bf16_p_misses_bf16_tolerance():
    """Why the kernel splits P: rounded to bf16 once, P moves outputs at
    the Llama width by more than the bound the split holds."""
    b, s, t, h, kh, d, causal = K8_CASES[0]
    q, k, v = _qkv(b, s, t, h, kh, d, seed=s + t + d)
    want = fa.flash_attention_plain(q, k, v, causal=causal).float()
    single = flash_tensor_core_model(q, k, v, causal=causal, split_p=False)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(single.float(), want, **BF16_TOL)
    split = flash_tensor_core_model(q, k, v, causal=causal)
    assert (split.float() - want).abs().max() \
        < (single.float() - want).abs().max()
