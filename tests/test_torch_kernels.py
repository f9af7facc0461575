"""The port's integer primitives, plain oracle and Conv1 layer kernel,
held against the JAX package on the same numpy-made inputs.  The path is
exact integer arithmetic, so every comparison has tolerance zero."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.blocks import get_block as ref_get_block
from repro.kernels import conv2d as ref_conv2d
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import conv2d, ops, ref
from repro_torch.kernels.build import LAUNCHES
from torch_parity import operands

BIT_GRID = list(itertools.product(range(3, 17), repeat=2))


def _name(dtype):
    return str(dtype).removeprefix("torch.") if isinstance(
        dtype, torch.dtype) else jnp.dtype(dtype).name


def test_helpers_match_reference_over_bit_grid():
    assert conv2d.PACKED_LIMIT == ref_conv2d.PACKED_LIMIT
    assert conv2d.PACK_SHIFT_BUDGET == ref_conv2d.PACK_SHIFT_BUDGET
    for d, c in BIT_GRID:
        assert conv2d.conv3_packed_ok(d, c) \
            == ref_conv2d.conv3_packed_ok(d, c)
        assert conv2d._pack_shift(d, c) == ref_conv2d._pack_shift(d, c)
        assert _name(conv2d._acc_dtype(d, c)) \
            == _name(ref_conv2d._acc_dtype(d, c))
        assert _name(conv2d._dot_dtype(d, c)) \
            == _name(ref_conv2d._dot_dtype(d, c))
    for bits in range(3, 17):
        assert _name(conv2d.container_dtype(bits)) \
            == _name(ref_conv2d.container_dtype(bits))


@pytest.mark.parametrize("bits", range(3, 17))
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_fixed_matches_reference(bits, signed):
    """Half-way values round to even in both; out-of-range values
    clamp; the container is the same."""
    rng = np.random.default_rng(bits)
    hi = 1 << bits
    xs = np.concatenate([
        rng.uniform(-2 * hi, 2 * hi, 64),
        np.arange(-hi, hi, max(1, hi // 32)) + 0.5,       # exact halves
        [-0.5, 0.5, 1.5, 2.5, -1.5, -2.5, 0.0],
    ]).astype(np.float32)
    want = np.asarray(ref_ops.quantize_fixed(jnp.asarray(xs), bits,
                                             signed=signed))
    got = ops.quantize_fixed(torch.from_numpy(xs), bits,
                             signed=signed).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    ints = rng.integers(-2 * hi, 2 * hi, 32)
    assert np.array_equal(
        ops.quantize_fixed(torch.from_numpy(ints), bits,
                           signed=signed).numpy(),
        np.asarray(ref_ops.quantize_fixed(jnp.asarray(ints), bits,
                                          signed=signed)))


@pytest.mark.parametrize("d,c", [(3, 3), (8, 6), (9, 8), (16, 16)])
def test_conv2d_3x3_ref_matches_reference(d, c):
    rng = np.random.default_rng(d * 17 + c)
    x, w = operands(rng, (16, 20, 1), 1, d, c)
    want = np.asarray(ref_ref.conv2d_3x3_ref(jnp.asarray(x[..., 0]),
                                             jnp.asarray(w[0, 0])))
    got = ref.conv2d_3x3_ref(torch.from_numpy(x[..., 0]),
                             torch.from_numpy(w[0, 0])).numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_wrap_int_is_twos_complement():
    t = torch.tensor([0, 1, -1, 2**31 - 1, 2**31, -2**31 - 1, 9 * 2**30,
                      2**15, -2**15 - 1], dtype=torch.int64)
    assert conv2d.wrap_int(t).to(torch.int32).tolist() \
        == np.array(t.tolist(), np.int64).astype(np.int32).tolist()
    assert conv2d.wrap_int(t, 16).tolist() \
        == np.array(t.tolist(), np.int64).astype(np.int16).tolist()


# bit points for the Pallas Conv1 comparison: the int16/int32 plane
# accumulator boundary (d+c+5 = 16 | 17), the 8/9-bit containers, the
# main path's d8c6 and the extremes
CONV1_POINTS = [(3, 3), (3, 8), (6, 5), (6, 6), (8, 6), (8, 8), (9, 8),
                (8, 9), (16, 16)]


@pytest.mark.parametrize("d,c", CONV1_POINTS)
def test_conv1_layer_matches_pallas_conv1(d, c):
    """The plain Conv1 layer against the reference's Conv1 block
    (Pallas in interpret mode) at N=2, H=16, W=20, ic=3, oc=5."""
    rng = np.random.default_rng(100 * d + c)
    x, w = operands(rng, (2, 16, 20, 3), 5, d, c)
    want = np.asarray(ref_get_block("conv1").apply_batched(
        jnp.asarray(x), jnp.asarray(w), data_bits=d, coeff_bits=c))
    got = conv2d.conv1_layer(torch.from_numpy(x), torch.from_numpy(w),
                             data_bits=d, coeff_bits=c).numpy()
    assert got.shape == (2, 5, 16, 20) and got.dtype == np.int32
    assert np.array_equal(got, want)


def test_conv1_layer_int16_accumulator_wraps_like_reference():
    """Container-range int16 inputs at d=3: the reference's int16 plane
    accumulator wraps, and so does the port's, before the ic sum."""
    rng = np.random.default_rng(7)
    x, w = operands(rng, (1, 16, 8, 3), 3, 3, 8, x_range=(-32768, 32767))
    want = np.asarray(ref_get_block("conv1").apply_batched(
        jnp.asarray(x), jnp.asarray(w), data_bits=3, coeff_bits=8))
    got = conv2d.conv1_layer(torch.from_numpy(x), torch.from_numpy(w),
                             data_bits=3, coeff_bits=8).numpy()
    assert np.array_equal(got, want)
    wide = np.einsum("nhwc,oc->nohw", x.astype(np.int64),
                     w[:, :, 1, 1].astype(np.int64))  # not the reference
    assert not np.array_equal(got, wide)


@pytest.mark.parametrize("bad", ["rank", "ic", "dtype", "float"])
def test_conv1_layer_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((1, 16, 8, 2), dtype=torch.int8)
    w = torch.zeros((3, 2, 3, 3), dtype=torch.int8)
    if bad == "rank":
        x = x[0]
    elif bad == "ic":
        w = torch.zeros((3, 4, 3, 3), dtype=torch.int8)
    elif bad == "dtype":
        x = x.to(torch.int32)
    else:
        w = w.float()
    with pytest.raises(ValueError, match="conv1_layer"):
        conv2d.conv1_layer(x, w, data_bits=8, coeff_bits=6)


def test_conv1_layer_on_cpu_counts_no_launch():
    before = LAUNCHES["conv1_layer"]
    conv2d.conv1_layer(torch.zeros((1, 16, 8, 1), dtype=torch.int8),
                       torch.ones((2, 1, 3, 3), dtype=torch.int8),
                       data_bits=8, coeff_bits=6)
    assert LAUNCHES["conv1_layer"] == before
