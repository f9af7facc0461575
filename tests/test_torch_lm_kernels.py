"""The LM slice's kernels on the CPU: the plain versions of K7
(``causal_conv1d``) and K8 (``flash_attention``) against the reference's
Pallas kernels in interpret mode and its oracles, on numpy-made inputs.
On a CPU tensor each wrapper runs its plain version and launches
nothing; the kernels themselves are held against these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances are the reference's own: 1e-5 for the conv (float32
products and sums, the same K terms in the same order; XLA may fuse a
multiply-add), 2e-4 for float32 attention and 2e-2 for bfloat16
attention (``tests/test_flash_attention.py``).

The gradients of both wrappers (their ``torch.autograd.Function``s,
the same on the CPU and on the card) are held against ``jax.grad`` of
the reference's model paths, which ``jax.grad`` differentiates in
training: the chunked einsum attention and the jnp conv, within the same
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import attention as ref_attn
from repro.models import ssm as ref_ssm
from repro_torch.kernels import conv1d, flash_attention as fa, ops
from repro_torch.kernels.build import LAUNCHES
from repro_torch.models import ssm
from tests.test_attention import naive_attention

CONV_TOL = 1e-5
F32_TOL, BF16_TOL = 2e-4, 2e-2


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# K7: causal conv1d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,c,k", [(16, 8, 4), (37, 64, 4), (128, 128, 2)])
def test_conv1d_plain_matches_pallas(s, c, k):
    """The ``tests/test_kernels.py`` cases, against the Pallas kernel."""
    rng = np.random.default_rng(s + c)
    x = rng.normal(size=(2, s, c)).astype(np.float32)
    w = rng.normal(size=(k, c)).astype(np.float32)
    y_ref = np.asarray(ref_ops.causal_conv1d(jnp.asarray(x), jnp.asarray(w)))
    before = LAUNCHES["causal_conv1d"]
    y = ops.causal_conv1d(_t(x), _t(w))
    assert LAUNCHES["causal_conv1d"] == before  # plain on the CPU
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, s, c)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=CONV_TOL,
                               atol=CONV_TOL)
    assert torch.equal(y, conv1d.causal_conv1d_plain(_t(x), _t(w)))


@pytest.mark.parametrize("s", [1, 2, 5])
@pytest.mark.parametrize("k", [4, 2])
def test_conv1d_plain_with_state_matches_oracle(s, k):
    """Decode (S = 1) and short prefills (S < K-1) read the halo from a
    nonzero state, against ``ref.causal_conv1d_ref``."""
    rng = np.random.default_rng(10 * s + k)
    x = rng.normal(size=(3, s, 24)).astype(np.float32)
    w = rng.normal(size=(k, 24)).astype(np.float32)
    st = rng.normal(size=(3, k - 1, 24)).astype(np.float32)
    y_ref = np.asarray(ref_oracle.causal_conv1d_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(st)))
    y = conv1d.causal_conv1d(_t(x), _t(w), _t(st))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=CONV_TOL,
                               atol=CONV_TOL)
    np.testing.assert_allclose(
        ops.causal_conv1d_ref(_t(x), _t(w), _t(st)).numpy(), y_ref,
        rtol=CONV_TOL, atol=CONV_TOL)


def test_conv1d_plain_bf16_inputs_accumulate_in_f32():
    """bf16 inputs: the products of bf16 values are exact in float32, so
    the plain version and the oracle agree to the float32 sum order."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(1, 40, 32)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(4, 32)), jnp.bfloat16)
    st = jnp.asarray(rng.normal(size=(1, 3, 32)), jnp.bfloat16)
    y_ref = np.asarray(ref_oracle.causal_conv1d_ref(x, w, st))
    to_t = lambda a: _t(np.asarray(a, np.float32)).to(torch.bfloat16)
    y = conv1d.causal_conv1d(to_t(x), to_t(w), to_t(st))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=CONV_TOL,
                               atol=CONV_TOL)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("s", [1, 2, 33])
def test_model_conv_matches_reference_model_conv_f32(s, with_state):
    """``models.ssm.causal_conv1d`` (K7, cast, SiLU) and its new state
    against the reference's model conv in float32, where both add the
    same float32 products (the reference documents rtol 1e-4); without
    a state (a prefill) the port passes none to the kernel and builds
    the new state from x alone, zero-padded when S < K-1."""
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32) if with_state \
        else None
    y_ref, ns_ref = ref_ssm.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if st is None else jnp.asarray(st))
    y, ns = ssm.causal_conv1d(_t(x), _t(w), None if st is None else _t(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=CONV_TOL)
    assert np.array_equal(ns.numpy(), np.asarray(ns_ref))


def test_model_conv_bf16_gap_to_reference():
    """In bfloat16 the reference's model conv (``models/ssm.py``,
    ``sum(xp[:, i:i+s] * w[i])``) rounds each product and partial sum to
    bf16, where the Pallas kernel, and so the port, adds in float32 and
    rounds once.  At the Mamba-2-1.3B prefill shape: every pre-SiLU
    value differs by at most 2^-6 · Σ_j |x_j w_j| (eight roundings of at
    most 2^-9 of a partial sum), and the largest difference is one bf16
    unit in the last place of the largest |y|."""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(1, 512, 4352)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(4, 4352)) * 0.5, jnp.bfloat16)
    xp = jnp.pad(x, ((0, 0), (3, 0), (0, 0)))
    y_ref = sum(xp[:, i:i + 512, :] * w[i][None, None, :] for i in range(4))
    f32 = lambda a: np.asarray(a, np.float32)
    mag = sum(np.abs(f32(xp)[:, i:i + 512, :] * f32(w)[i]) for i in range(4))
    to_t = lambda a: _t(f32(a)).to(torch.bfloat16)
    y = ops.causal_conv1d(to_t(x), to_t(w)).to(torch.bfloat16)
    a, b = y.float().numpy(), f32(y_ref)
    assert np.all(np.abs(a - b) <= 2.0 ** -6 * mag)
    top_ulp = 2.0 ** (np.floor(np.log2(np.abs(b).max())) - 7)
    assert np.abs(a - b).max() <= top_ulp
    assert np.mean(a != b) > 0.05     # the gap is real, not a no-op


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,k", [(1, 4), (2, 4), (37, 4), (16, 2)])
def test_conv1d_backward_matches_reference_grad(s, k, with_state):
    """``models.ssm.causal_conv1d`` (K7's ``Function``, the cast, the
    SiLU) differentiated by torch against ``jax.grad`` of the reference's
    model conv: the gradients of x, w and the state within 1e-5, and
    the output of a plain call has no autograd graph."""
    rng = np.random.default_rng(100 * s + k)
    x = rng.normal(size=(2, s, 24)).astype(np.float32)
    w = rng.normal(size=(k, 24)).astype(np.float32)
    st = rng.normal(size=(2, k - 1, 24)).astype(np.float32)
    dy = rng.normal(size=(2, s, 24)).astype(np.float32)

    def ref_loss(x_, w_, st_):
        y, _ = ref_ssm.causal_conv1d(x_, w_, st_ if with_state else None)
        return jnp.sum(y * dy)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(st))
    tx, tw, tst = (_t(a).requires_grad_() for a in (x, w, st))
    y, _ = ssm.causal_conv1d(tx, tw, tst if with_state else None)
    assert y.grad_fn is not None
    y.backward(_t(dy))
    for got, ref, name in ((tx, want[0], "x"), (tw, want[1], "w"),
                           (tst, want[2], "state")):
        if name == "state" and not with_state:
            assert got.grad is None
            continue
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=CONV_TOL, atol=CONV_TOL,
                                   err_msg=name)
    with torch.no_grad():
        assert conv1d.causal_conv1d(tx, tw).grad_fn is None
    assert conv1d.causal_conv1d(_t(x), _t(w)).grad_fn is None


def test_conv1d_backward_bf16_accumulates_in_f32():
    """bf16 inputs: the gradients come back in bf16, computed in float32
    (against float32 torch autograd of the plain version on the same
    bf16 values, within one bf16 unit)."""
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(1, 40, 32)).astype(np.float32)) \
        .to(torch.bfloat16).requires_grad_()
    w = _t(rng.normal(size=(4, 32)).astype(np.float32)) \
        .to(torch.bfloat16).requires_grad_()
    dy = _t(rng.normal(size=(1, 40, 32)).astype(np.float32))
    conv1d.causal_conv1d(x, w).backward(dy)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    xf = x.detach().float().requires_grad_()
    wf = w.detach().float().requires_grad_()
    conv1d.causal_conv1d_plain(xf, wf).backward(dy)
    for got, want in ((x.grad, xf.grad), (w.grad, wf.grad)):
        torch.testing.assert_close(got.float(), want.to(torch.bfloat16)
                                   .float(), rtol=2 ** -7, atol=1e-5)


def test_conv1d_refuses_what_it_does_not_take():
    x, w = torch.zeros(2, 5, 8), torch.zeros(4, 8)
    with pytest.raises(ValueError, match="expected x"):
        conv1d.causal_conv1d(x, torch.zeros(4, 9))
    with pytest.raises(ValueError, match="state must be"):
        conv1d.causal_conv1d(x, w, torch.zeros(2, 2, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv1d.causal_conv1d(x.to(torch.float16), w)
    with pytest.raises(ValueError, match="share one dtype"):
        conv1d.causal_conv1d(x, w.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# K8: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t", [(128, 128), (256, 256)])
def test_flash_plain_matches_pallas(h, kh, causal, s, t):
    """The ``tests/test_flash_attention.py`` grid, against the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(h * 100 + s + causal)
    b, d = 2, 32
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kh, d)).astype(np.float32)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=64,
                                block_k=64))
    before = LAUNCHES["flash_attention"]
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert LAUNCHES["flash_attention"] == before  # plain on the CPU
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, s, h, d)
    np.testing.assert_allclose(out.numpy(), want, rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_plain_bf16_matches_pallas():
    rng = np.random.default_rng(1)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 128, 2, 16)), jnp.bfloat16)
               for _ in range(3))
    want = np.asarray(ref_flash(q, k, v, causal=True), np.float32)
    to_t = lambda a: _t(np.asarray(a, np.float32)).to(torch.bfloat16)
    out = fa.flash_attention(to_t(q), to_t(k), to_t(v), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("s,t,causal", [(200, 200, True), (100, 300, True),
                                        (77, 45, False), (1, 33, False)])
def test_flash_plain_any_length_matches_naive(s, t, causal):
    """Lengths that are not a multiple of 128 (the Pallas kernel asserts
    divisibility; the port's kernel masks the ragged tiles), against
    ``tests/test_attention.py::naive_attention``."""
    rng = np.random.default_rng(s * 7 + t)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, t, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, t, 2, 16)).astype(np.float32)
    want = np.asarray(naive_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal))
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), want, rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_refuses_what_it_does_not_take():
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="KH dividing H"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="must share"):
        fa.flash_attention(q, q.to(torch.bfloat16), q)


@pytest.mark.parametrize("h,kh", [(4, 2), (8, 1)])
@pytest.mark.parametrize("s,causal,grad_chunk", [
    (16, True, 1024), (300, True, 1024), (77, False, 1024),
    (300, True, 128), (77, False, 32)])
def test_flash_backward_matches_reference_grad(h, kh, s, causal,
                                               grad_chunk, monkeypatch):
    """K8 differentiated by torch (its ``Function``: the plain forward on
    the CPU, the backward recomputing the model's chunked attention one
    ``GRAD_CHUNK`` rows at a time, here also in several chunks, the last
    ragged) against ``jax.grad`` of the reference's chunked einsum
    attention (``models.attention.multi_head_attention``, the path
    ``jax.grad`` takes in training): the output and the gradients of q,
    k and v within 2e-4."""
    monkeypatch.setattr(fa, "GRAD_CHUNK", grad_chunk)
    rng = np.random.default_rng(h * 1000 + s)
    d = 16
    q = rng.normal(size=(1, s, h, d)).astype(np.float32)
    k = rng.normal(size=(1, s, kh, d)).astype(np.float32)
    v = rng.normal(size=(1, s, kh, d)).astype(np.float32)
    dout = rng.normal(size=(1, s, h, d)).astype(np.float32)

    def ref_loss(q_, k_, v_):
        out = ref_attn.multi_head_attention(q_, k_, v_, causal=causal)
        return jnp.sum(out * dout), out
    (_, ref_out), want = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    before = LAUNCHES["flash_attention"]
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(_t(dout))
    assert LAUNCHES["flash_attention"] == before  # plain on the CPU
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=F32_TOL, atol=F32_TOL)
    for got, ref, name in ((tq, want[0], "q"), (tk, want[1], "k"),
                           (tv, want[2], "v")):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)


def test_flash_backward_bf16_and_routing():
    """bf16: the gradients come back in bf16 within 2e-2 of the
    reference's; without grad (no input requires it, or under
    ``no_grad``) the call is the plain forward with no graph, as
    prefill and decode run it."""
    rng = np.random.default_rng(2)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 64, 2, 16)), jnp.bfloat16)
               for _ in range(3))
    dout = rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(
        ref_attn.multi_head_attention(q_, k_, v_, causal=True)
        .astype(jnp.float32) * dout), argnums=(0, 1, 2))(q, k, v)
    to_t = lambda a: _t(np.asarray(a, np.float32)).to(torch.bfloat16)
    tq, tk, tv = (to_t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    out.backward(_t(dout).to(torch.bfloat16))
    for got, ref in ((tq, want[0]), (tk, want[1]), (tv, want[2])):
        assert got.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(got.grad.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)
    with torch.no_grad():
        assert fa.flash_attention(tq, tk, tv).grad_fn is None
    assert fa.flash_attention(tq.detach(), tk.detach(),
                              tv.detach()).grad_fn is None
