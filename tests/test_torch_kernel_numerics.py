"""The arithmetic of the port's redesigned kernels, held on the CPU.

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
* K1 ``fused_dot_layer`` (``csrc/fused_dot_layer.cu``) on its dp4a route
  (int8 dots): where ic % 4 == 0, words of 4 channels as they lie in
  memory against weights packed alike, 9 · ic / 4 dp4a per output;
  otherwise, as at ic = 1, each window row's 3 staged taps packed into
  a word by two byte permutes, whose 4th byte (a copy of the first tap)
  meets a zero weight byte, 3 · ic dp4a per output.  Both models equal
  ``fused_dot_layer_plain`` bit for bit.
* K2 ``packed_dot_layer`` (``csrc/packed_dot_layer.cu``): staged words of
  4 int8 or 2 int16 channels, lanes past ic zero, each channel extracted
  by a sign-extending byte permute; the packed dot per channel, the
  field split per channel, the sums over channels in the staged order.
  The model equals ``packed_dot_layer_plain`` bit for bit.
* K4 ``conv2_planes``, K5 ``conv3_planes`` and K6 ``conv4_planes``
  (``csrc/conv{2,3,4}_planes.cu``) over the staged tile of
  ``common.cuh`` at ic = 1: each block's halo tile of one plane, zeros
  outside the plane, each thread's 2 pixels of one column from its 4 x 3
  window, the stores cropped to the plane.  Conv3 in its packing regime:
  the packed operand (w_hi << S) + w_lo modulo 2^32 and the signed field
  split; otherwise one dot (Conv2) or two (Conv4, Conv3 outside the
  regime), a multiply-add per (tap, output), int8 dots included (dp4a
  was slower here).
  The models equal ``conv{2,3,4}_planes_plain`` bit for bit, and on a
  few points the reference's ``ConvBlock.apply`` (Pallas in interpret
  mode).
* The requantizing epilogue of K1 and K2: the int32 sum shifted by
  min(shift, 31), clamped to [0, 2^(out_bits−1) − 1], each pixel's
  channels packed into one 4-, 8- or 16-byte word where they fill the
  register tile, else stored one by one.  The model's bytes equal
  ``conv2d.requantize``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_numerics.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.blocks as ref_blocks
from repro_torch.blocks import base
from repro_torch.kernels import conv2d, flash_attention as fa
from torch_parity import np_container, operands

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


# ---------------------------------------------------------------------------
# K1 and K2: the dot kernels over the staged tile, and their epilogue
# ---------------------------------------------------------------------------

def _word(t: torch.Tensor) -> torch.Tensor:
    """A sign-extended value as the 32-bit word the kernels hold, kept
    as an int64 in [0, 2^32)."""
    return t.to(torch.int64) & U32


def _signed(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 1 << 31, words - (1 << 32), words)


def _lanes(words: torch.Tensor) -> torch.Tensor:
    """The 4 signed bytes of 32-bit words, low byte first: (..., 4)."""
    b = torch.stack([(words >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    return torch.where(b >= 128, b - 256, b)


def dp4a_model(a, b, c):
    """``__dp4a``: c plus the 4 products of signed bytes, modulo 2^32."""
    return (c + (_lanes(a) * _lanes(b)).sum(dim=-1)) & U32


def prmt_model(x, y, sel: int, sign: bool = False):
    """PTX ``prmt.b32`` in its default mode on words x, y: result byte n
    is byte (sel_n & 7) of y:x, or with ``sign`` and sel_n & 8 that
    byte's top bit replicated (``__byte_perm`` is the mode without)."""
    xy = (y << 32) | x
    out = torch.zeros_like(x)
    for n in range(4):
        s = (sel >> (4 * n)) & 0xF
        byte = (xy >> (8 * (s & 7))) & 0xFF
        if sign and s & 8:
            byte = torch.where(byte >= 128, 0xFF, 0)
        out = out | (byte << (8 * n))
    return out


def pack4(b0, b1, b2, b3):
    """Four signed bytes as one word, the first in the low byte."""
    return ((b0 & 0xFF) | (b1 & 0xFF) << 8 | (b2 & 0xFF) << 16
            | (b3 & 0xFF) << 24)


def _taps(xpad, h, wd, t):
    return xpad[:, t // 3:t // 3 + h, t % 3:t % 3 + wd]


def k1_dp4a_model(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``fused_dot_layer`` on its dp4a route as the kernel computes it,
    on int8 x (N, H, W, ic) and w (oc, ic, 3, 3)."""
    n, h, wd, ic = x.shape
    oc = w.shape[0]
    wk = w.to(torch.int64)
    acc = torch.zeros((n, h, wd, oc), dtype=torch.int64)
    if ic % 4 == 0:
        # staged: the words of memory, 4 channels each; weights packed so
        xw = _word(x.contiguous().view(torch.int32))      # (N, H, W, ic/4)
        xpad = F.pad(xw.permute(0, 3, 1, 2), (1, 1, 1, 1)) \
            .permute(0, 2, 3, 1)
        ww = pack4(*(wk[:, e::4] for e in range(4)))      # (oc, ic/4, 3, 3)
        for t in range(9):
            tap = xpad[:, t // 3:t // 3 + h, t % 3:t % 3 + wd]
            wt = ww[:, :, t // 3, t % 3]                  # (oc, ic/4)
            for k in range(ic // 4):
                acc = dp4a_model(tap[..., k, None], wt[:, k], acc)
        return _signed(acc).to(torch.int32).permute(0, 3, 1, 2)
    # staged: one sign-extended word per channel; each window row's 3
    # taps packed by __byte_perm(__byte_perm(a, b, 0x0040), c, 0x3410)
    xpad = F.pad(_word(x).permute(0, 3, 1, 2), (1, 1, 1, 1))
    for c in range(ic):
        for di in range(3):
            row = xpad[:, c, di:di + h]
            packed = prmt_model(prmt_model(row[..., :wd], row[..., 1:wd + 1],
                                           0x0040),
                                row[..., 2:wd + 2], 0x3410)
            wrow = pack4(wk[:, c, di, 0], wk[:, c, di, 1], wk[:, c, di, 2],
                         torch.zeros_like(wk[:, c, di, 0]))
            acc = dp4a_model(packed[..., None], wrow, acc)
    return _signed(acc).to(torch.int32).permute(0, 3, 1, 2)


INT8_POINTS = [(3, 3), (3, 8), (6, 4), (6, 5), (6, 6), (8, 6), (8, 8)]


@pytest.mark.parametrize("d,c", INT8_POINTS)
@pytest.mark.parametrize("ic", [1, 3, 8])
@pytest.mark.parametrize("x_int16", [False, True],
                         ids=["x_own_container", "x_int16"])
def test_k1_dp4a_model_equals_plain(d, c, ic, x_int16):
    """Both word forms (ic = 8: channels; ic = 1, 3: rows) over the int8
    points, also on int16 container-range inputs, which the wrapper
    narrows to int8 as the reference's int8 dot does."""
    rng = np.random.default_rng(40 * d + c + ic)
    x, w = operands(rng, (2, 5, 7, ic), 5, d, c,
                    x_range=(-32768, 32767) if x_int16 else None)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    assert base.fused_dot_route(d, c) == "dp4a"
    xn, wn = conv2d.narrow_to_dot_dtype(x, w, d, c)
    assert torch.equal(k1_dp4a_model(xn, wn), base.fused_dot_layer_plain(
        x, w, data_bits=d, coeff_bits=c))


def test_k1_row_words_carry_a_stray_byte_against_a_zero_weight():
    """The packed row word's 4th byte is a copy of its first tap, not 0:
    the kernel relies on the zero 4th weight byte, and a nonzero one
    there would change the sum."""
    x = torch.tensor([[[[5], [-3], [7]]]], dtype=torch.int8)     # (1,1,3,1)
    row = _word(x[0, 0, :, 0])
    packed = prmt_model(prmt_model(row[:1], row[1:2], 0x0040), row[2:3],
                        0x3410)
    assert _lanes(packed).tolist() == [[5, -3, 7, 5]]
    w = torch.ones((1, 1, 3, 3), dtype=torch.int8)
    want = base.fused_dot_layer_plain(x, w, data_bits=8, coeff_bits=8)
    assert torch.equal(k1_dp4a_model(x, w), want)
    stray = dp4a_model(packed, pack4(*(torch.tensor([1])
                                       for _ in range(4))), 0)
    assert int(stray) == 5 - 3 + 7 + 5


def _lane_selector(size: int, e: int) -> int:
    """The selector of ``repro::lane<TX>(word, e)`` (common.cuh)."""
    lo = size * e
    top = lo + size - 1
    sign = 8 | top
    if size == 1:
        return lo | sign << 4 | sign << 8 | sign << 12
    return lo | top << 4 | sign << 8 | sign << 12


def k2_model(x: torch.Tensor, w: torch.Tensor, *, data_bits: int,
             coeff_bits: int) -> torch.Tensor:
    """``packed_dot_layer`` as the kernel computes it: x staged as words
    of E = 4 / itemsize channels (lanes past ic zero), each channel
    extracted by a sign-extending permute, one packed int32 dot per
    (pair, channel) modulo 2^32, the signed field split per channel,
    the sums over channels modulo 2^32."""
    n, h, wd, ic = x.shape
    oc = w.shape[0]
    size = x.element_size()
    e_per = 4 // size
    s = conv2d._pack_shift(data_bits, coeff_bits)
    xp = F.pad(x, (0, -ic % e_per)).contiguous()          # zero lanes
    words = _word(xp.view(torch.int32))                   # (N, H, W, K)
    wpad = F.pad(words.permute(0, 3, 1, 2), (1, 1, 1, 1))  # (N, K, H+2, W+2)
    wk = w.to(torch.int64)
    pairs = (oc + 1) // 2
    hi_ch = [2 * p for p in range(pairs)]
    lo_ch = [min(2 * p + 1, oc - 1) for p in range(pairs)]
    packed = ((_word(wk[hi_ch]) << s) + _word(wk[lo_ch])) & U32
    half, field = 1 << (s - 1), (1 << s) - 1
    sum_hi = torch.zeros((n, pairs, h, wd), dtype=torch.int64)
    sum_lo = torch.zeros_like(sum_hi)
    for c in range(ic):
        plane = prmt_model(wpad[:, c // e_per], torch.zeros_like(
            wpad[:, 0]), _lane_selector(size, c % e_per), sign=True)
        acc = torch.zeros_like(sum_hi)
        for t in range(9):
            acc = (acc + plane[:, None, t // 3:t // 3 + h,
                               t % 3:t % 3 + wd]
                   * packed[None, :, c, t // 3, t % 3, None, None]) & U32
        lo = ((acc + half) & field) - half
        hi = _signed((acc - lo) & U32) >> s
        sum_hi = (sum_hi + hi) & U32
        sum_lo = (sum_lo + lo) & U32
    out = torch.stack([sum_hi, sum_lo], dim=2).reshape(n, 2 * pairs, h, wd)
    return _signed(out[:, :oc]).to(torch.int32)


K2_POINTS = [(d, c) for d, c in [(3, 3), (3, 8), (6, 4), (6, 5), (6, 6),
                                 (8, 6), (8, 8), (9, 8), (8, 9), (12, 16),
                                 (16, 12)]]


@pytest.mark.parametrize("d,c", K2_POINTS)
@pytest.mark.parametrize("ic,oc", [(5, 5), (8, 4)])
@pytest.mark.parametrize("x_int16", [False, True],
                         ids=["x_own_container", "x_int16"])
def test_k2_word_model_equals_plain(d, c, ic, oc, x_int16):
    """Every pack-legal point of the card tests' grid, a partial last
    word (ic = 5) and the serving layer's 8 → 4, in both containers and
    on int16 container-range inputs."""
    rng = np.random.default_rng(60 * d + c + ic)
    x, w = operands(rng, (2, 5, 7, ic), oc, d, c,
                    x_range=(-32768, 32767) if x_int16 else None)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(k2_model(x, w, data_bits=d, coeff_bits=c),
                       base.packed_dot_layer_plain(x, w, data_bits=d,
                                                   coeff_bits=c))


def requant_epilogue_model(acc: torch.Tensor, shift: int, out_bits: int):
    """The epilogue of the requantizing entries on acc (N, oc, H, W)
    int32: each value shifted as an int32 by min(shift, 31) and clamped
    to [0, 2^(out_bits−1) − 1]; per pixel, each register tile of OCT
    channels (4 where oc <= 4, else 8) stored as one 4-, 8- or 16-byte
    word where it is whole and its offset in the (16-byte aligned)
    output is a multiple of the word, else value by value.  Returns the
    (N, H, W, oc) container read back from the bytes written, and the
    numbers of word and single-value stores."""
    n, oc, h, wd = acc.shape
    hi = (1 << (out_bits - 1)) - 1
    dt = conv2d.container_dtype(out_bits)
    size = torch.iinfo(dt).bits // 8
    v = torch.clamp(acc.to(torch.int64) >> min(shift, 31), 0, hi)
    v = v.permute(0, 2, 3, 1).reshape(-1, oc)             # pixels × oc
    mem = torch.full((v.shape[0] * oc * size,), 0xA5, dtype=torch.uint8)
    little = [(v >> (8 * b)) & 0xFF for b in range(size)]  # value bytes
    oct_ = 4 if oc <= 4 else 8
    words = singles = 0
    for pix in range(v.shape[0]):
        for o0 in range(0, oc, oct_):
            n_ch = min(oct_, oc - o0)
            at = (pix * oc + o0) * size
            whole = n_ch == oct_ and oct_ * size in (4, 8, 16) \
                and at % (oct_ * size) == 0
            words += whole
            singles += 0 if whole else n_ch
            for j in range(n_ch):
                for b in range(size):
                    mem[at + j * size + b] = little[b][pix, o0 + j]
    return mem.view(dt).reshape(n, h, wd, oc), words, singles


@pytest.mark.parametrize("shift", [0, 7, 31, 40])
@pytest.mark.parametrize("out_bits", [3, 8, 9, 16])
@pytest.mark.parametrize("oc", [4, 5, 8, 12])
def test_requant_epilogue_model_equals_requantize(shift, out_bits, oc):
    """Accumulators over the whole int32 range, negative ones and both
    extremes included; at the serving widths (oc = 4, 8) every pixel
    is whole-word stores."""
    rng = np.random.default_rng(shift + 17 * out_bits + oc)
    a = rng.integers(-(1 << 31), 1 << 31, (2, oc, 3, 5))
    a.reshape(-1)[:3] = (-(1 << 31), (1 << 31) - 1, -1)
    acc = torch.from_numpy(a).to(torch.int32)
    got, words, singles = requant_epilogue_model(acc, shift, out_bits)
    assert torch.equal(got, conv2d.requantize(acc, shift, out_bits))
    if oc in (4, 8):
        assert singles == 0 and words == 2 * 3 * 5


# (kernel, d, c): the serving points, the int8/int16 boundary and the
# widest widths each entry takes
REQUANT_ENTRY_CASES = [("fused_dot_layer", 8, 6), ("fused_dot_layer", 6, 4),
                       ("fused_dot_layer", 9, 8), ("fused_dot_layer", 16, 16),
                       ("packed_dot_layer", 6, 4), ("packed_dot_layer", 8, 3),
                       ("packed_dot_layer", 9, 3), ("packed_dot_layer", 16, 12)]


@pytest.mark.parametrize("name,d,c", REQUANT_ENTRY_CASES)
def test_requant_entries_equal_requantize_of_plain(name, d, c):
    """On the CPU each ``*_requant`` wrapper is ``_requantize`` of the
    int32 wrapper's plain version, at the layer's own shift and data
    bits, also past shift 31."""
    from repro_torch.core import cnn
    rng = np.random.default_rng(5 * d + c)
    x, w = operands(rng, (2, 6, 9, 3), 5, d, c)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    layer = getattr(base, name)
    requant = getattr(base, f"{name}_requant")
    acc = layer(x, w, data_bits=d, coeff_bits=c)
    for shift in (0, 7, 40):
        spec = cnn.ConvLayerSpec(3, 5, data_bits=d, coeff_bits=c,
                                 shift=shift)
        got = requant(x, w, data_bits=d, coeff_bits=c, shift=shift,
                      out_bits=d)
        assert got.dtype == conv2d.container_dtype(d)
        assert torch.equal(got, cnn._requantize(acc, spec))


def test_fused_dot_routes_are_fixed_by_the_dot_dtype():
    """dp4a for int8 dots, the CUDA cores' multiply-add for int32 ones:
    the C entry runs dp4a exactly where the wrapper's narrowing leaves
    both containers int8, which is where ``fused_dot_route`` names it;
    the plain version on the CPU takes either kind of dot."""
    assert base.fused_dot_route(8, 8) == "dp4a"
    assert base.fused_dot_route(9, 8) == base.fused_dot_route(8, 9) == "imad"
    for d, c in CONTAINER_POINTS:
        x = torch.zeros((1, 4, 4, 2), dtype=conv2d.container_dtype(d))
        w = torch.zeros((3, 2, 3, 3), dtype=conv2d.container_dtype(c))
        xn, wn = conv2d.narrow_to_dot_dtype(x, w, d, c)
        both_int8 = xn.dtype == wn.dtype == torch.int8
        assert (base.fused_dot_route(d, c) == "dp4a") == both_int8, (d, c)
    x = torch.zeros((1, 4, 4, 2), dtype=torch.int16)
    w = torch.zeros((3, 2, 3, 3), dtype=torch.int8)
    assert base.fused_dot_layer(x, w, data_bits=9,
                                coeff_bits=8).shape == (1, 3, 4, 4)
    assert base.fused_dot_layer_requant(
        x, w, data_bits=9, coeff_bits=8, shift=7,
        out_bits=9).shape == (1, 4, 4, 3)


# ---------------------------------------------------------------------------
# K4, K5 and K6: the plane kernels over the staged tile
# ---------------------------------------------------------------------------

# common.cuh's tile: TILE_THREADS threads, each PPT rows of one column
TILE_THREADS, TILE_H, TILE_W, PPT = 256, 16, 32, 2


def staged_plane_tiles(x: torch.Tensor) -> torch.Tensor:
    """x (P, H, W) as ``stage(..., ic = 1, ...)`` leaves it in shared
    memory, for every block (plane, tile row, tile column): the (TILE_H +
    2, TILE_W + 2) halo tile of sign-extended values, zeros outside the
    plane, also where the tile overhangs it.  (P, TY, TX, 18, 34)."""
    p, h, wd = x.shape
    ty, tx = -(-h // TILE_H), -(-wd // TILE_W)
    xpad = F.pad(x.to(torch.int64),
                 (1, tx * TILE_W + 1 - wd, 1, ty * TILE_H + 1 - h))
    rows = torch.arange(ty)[:, None] * TILE_H + torch.arange(TILE_H + 2)
    cols = torch.arange(tx)[:, None] * TILE_W + torch.arange(TILE_W + 2)
    return xpad[:, rows[:, None, :, None], cols[None, :, None, :]]


def thread_windows(tiles: torch.Tensor) -> torch.Tensor:
    """Each thread's (PPT + 2) x 3 window of its block's staged tile
    (``load_window``): thread i owns column i % TILE_W from row
    (i / TILE_W) · PPT.  (..., TILE_THREADS, PPT + 2, 3)."""
    i = torch.arange(TILE_THREADS)
    r = (i // TILE_W * PPT)[:, None] + torch.arange(PPT + 2)
    q = (i % TILE_W)[:, None] + torch.arange(3)
    return tiles[..., r[:, :, None], q[:, None, :]]


def write_plane_pixels(acc: torch.Tensor, h: int, wd: int) -> torch.Tensor:
    """``write_pixels<int32_t, NOUT>``: thread i's pixel p, output j,
    lands at row tr0 + (i / TILE_W) · PPT + p, column tc0 + i % TILE_W of
    output plane j, where it lies inside the plane.  acc (P, TY, TX,
    TILE_THREADS, PPT, NOUT) → (P, NOUT, H, W); each tile pixel is
    written by exactly one (thread, pixel)."""
    p, ty, tx, n_out = (*acc.shape[:3], acc.shape[-1])
    i = torch.arange(TILE_THREADS)
    rows = (i // TILE_W * PPT)[:, None] + torch.arange(PPT)    # (256, PPT)
    cols = (i % TILE_W)[:, None].expand(-1, PPT)
    hits = torch.zeros((TILE_H, TILE_W), dtype=torch.int64)
    hits.index_put_((rows.reshape(-1), cols.reshape(-1)),
                    torch.ones(TILE_THREADS * PPT, dtype=torch.int64),
                    accumulate=True)
    assert bool((hits == 1).all())
    tile = torch.zeros((p, ty, tx, n_out, TILE_H, TILE_W),
                       dtype=torch.int64)
    tile[:, :, :, :, rows, cols] = acc.permute(0, 1, 2, 5, 3, 4)
    out = tile.permute(0, 3, 1, 4, 2, 5).reshape(p, n_out, ty * TILE_H,
                                                 tx * TILE_W)
    return _signed(out[:, :, :h, :wd]).to(torch.int32)


def plane_tile_model(name: str, x: torch.Tensor, w: torch.Tensor, *,
                     data_bits: int, coeff_bits: int) -> torch.Tensor:
    """``conv2_planes`` / ``conv3_planes`` / ``conv4_planes`` as the
    kernels compute them on x (P, H, W) and w (P, 3, 3) or (P, 2, 3, 3),
    after the wrapper's narrowing:
    * Conv3 in its packing regime: the staged packed operands
      (w_hi << S) + w_lo modulo 2^32, one dot per pixel, the signed field
      split in registers;
    * otherwise one dot (Conv2, ``dot_planes<1>``) or two (Conv4, Conv3
      outside the regime, ``dot_planes<2>``), a multiply-add per (tap,
      output) modulo 2^32, for int8 dots too.
    Every product is taken on signed values (exact in int64) and is the
    same modulo 2^32 as the kernels' uint32_t one."""
    d, c = data_bits, coeff_bits
    p, h, wd = x.shape
    n_out = 1 if name == "conv2_planes" else 2
    packed = name == "conv3_planes" and conv2d.conv3_packed_ok(d, c)
    if not packed:
        x, w = conv2d.narrow_to_dot_dtype(x, w, d, c)
    win = thread_windows(staged_plane_tiles(x))      # (P, TY, TX, 256, 4, 3)
    wk = w.to(torch.int64).reshape(p, 1, 1, 1, n_out, 3, 3)
    acc = torch.zeros((*win.shape[:4], PPT, n_out), dtype=torch.int64)
    if packed:
        s = conv2d._pack_shift(d, c)
        op = _signed(((_word(wk[..., 0, :, :]) << s) + _word(wk[..., 1, :, :]))
                     & U32)                          # (P, 1, 1, 1, 3, 3)
        half, field = 1 << (s - 1), (1 << s) - 1
        for pp in range(PPT):
            a = torch.zeros(win.shape[:4], dtype=torch.int64)
            for t in range(9):
                a = (a + win[..., pp + t // 3, t % 3]
                     * op[..., t // 3, t % 3]) & U32
            lo = ((a + half) & field) - half
            acc[..., pp, 0] = _signed((a - lo) & U32) >> s
            acc[..., pp, 1] = lo & U32
    else:
        for pp in range(PPT):
            for j in range(n_out):
                a = torch.zeros(win.shape[:4], dtype=torch.int64)
                for t in range(9):
                    a = (a + win[..., pp + t // 3, t % 3]
                         * wk[..., j, t // 3, t % 3]) & U32
                acc[..., pp, j] = a
    out = write_plane_pixels(acc, h, wd)
    return out[:, 0] if n_out == 1 else out


PLANE_PLAIN = {"conv2_planes": conv2d.conv2_planes_plain,
               "conv3_planes": conv2d.conv3_planes_plain,
               "conv4_planes": conv2d.conv4_planes_plain}
# each kernel's seed offset
PLANE_SEED = {"conv2_planes": 2000, "conv3_planes": 1000, "conv4_planes": 0}
# a tile with a short last column of tiles, planes that fill no tile
PLANE_TILE_SHAPES = [(3, 16, 24), (2, 17, 33), (2, 1, 1)]


def plane_operands(rng, shape, d, c, *, x_range=None, n_out=2):
    """Planes over the signed d-bit range (or ``x_range``, then in an
    int16 container) and (P, 2, 3, 3) weights — (P, 3, 3) for one
    output — over the signed c-bit range, extremes forced in."""
    x, _ = operands(rng, (*shape, 1), 1, d, c, x_range=x_range)
    wlo, whi = -(1 << (c - 1)), (1 << (c - 1)) - 1
    wshape = (shape[0], 3, 3) if n_out == 1 else (shape[0], 2, 3, 3)
    w = rng.integers(wlo, whi + 1, wshape)
    w.reshape(-1)[:2] = (wlo, whi)
    return (torch.from_numpy(x[..., 0].copy()),
            torch.from_numpy(w.astype(np_container(c))))


@pytest.mark.parametrize("d", BITS)
@pytest.mark.parametrize("c", BITS)
@pytest.mark.parametrize("name", sorted(PLANE_PLAIN))
def test_plane_tile_model_equals_plain(name, d, c):
    """The full 3..16 × 3..16 grid (both sides of Conv3's packing
    boundary d + c = 12 / 13, of the int8 dot and of the containers),
    on planes of (16, 24), (17, 33) and (1, 1), with inputs over the
    signed d-bit range and over the whole int16 container."""
    rng = np.random.default_rng(PLANE_SEED[name] + 20 * d + c)
    n_out = 1 if name == "conv2_planes" else 2
    for shape in PLANE_TILE_SHAPES:
        for x_range in (None, (-32768, 32767)):
            x, w = plane_operands(rng, shape, d, c, x_range=x_range,
                                  n_out=n_out)
            want = PLANE_PLAIN[name](x, w, data_bits=d, coeff_bits=c)
            got = plane_tile_model(name, x, w, data_bits=d, coeff_bits=c)
            assert torch.equal(got, want), (shape, x_range)


# (block, d, c): Conv3 packed (int8 and int16 inputs), Conv3 outside the
# regime in int8 and int32 dots, Conv4 in both, Conv2 in both and at the
# widest widths
APPLY_MODEL_POINTS = [("conv3", 6, 6), ("conv3", 9, 3), ("conv3", 8, 6),
                      ("conv3", 16, 16), ("conv4", 8, 6), ("conv4", 9, 8),
                      ("conv2", 8, 6), ("conv2", 9, 8), ("conv2", 16, 16)]


@pytest.mark.parametrize("block,d,c", APPLY_MODEL_POINTS)
def test_plane_tile_model_equals_reference_apply(block, d, c):
    """On a plane of 32 x 24 (two tile rows, a short tile column) the
    model of the block's plane kernel equals the reference's
    ``ConvBlock.apply``, its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(70 * d + c)
    x, w = plane_operands(rng, (1, 32, 24), d, c,
                          n_out=1 if block == "conv2" else 2)
    want = np.asarray(ref_blocks.get_block(block).apply(
        jnp.asarray(x[0].numpy()), jnp.asarray(w[0].numpy()), data_bits=d,
        coeff_bits=c))
    got = plane_tile_model(f"{block}_planes", x, w, data_bits=d,
                           coeff_bits=c)[0]
    assert np.array_equal(got.numpy(), want)
