"""The port's block library (``repro_torch.blocks``) held against
``repro.blocks`` on the same numpy-made inputs: metadata, validation,
the layer-fused dots over the whole bit grid, and ``apply_batched`` for
every block.  Tolerance zero throughout (exact integer arithmetic)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.blocks as ref_blocks
from repro_torch import blocks
from repro_torch.blocks import base
from repro_torch.kernels import conv2d
from torch_parity import operands

BIT_GRID = list(itertools.product(range(3, 17), repeat=2))


@pytest.mark.parametrize("d,c", BIT_GRID)
def test_dot_layers_match_reference(d, c):
    """The plain fused and packed dots against ``repro.blocks``' own at
    every (d, c) in 3..16 × 3..16 — the d+c = 12 packing boundary and
    the 8/9-bit containers included — with odd out_ch.  Where the
    packed operand's shift passes 31 bits both refuse."""
    rng = np.random.default_rng(1000 + 17 * d + c)
    x, w = operands(rng, (2, 8, 12, 3), 5, d, c)
    jx, jw, tx, tw = (jnp.asarray(x), jnp.asarray(w), torch.from_numpy(x),
                      torch.from_numpy(w))
    want = np.asarray(ref_blocks.fused_dot_layer(jx, jw, data_bits=d,
                                                 coeff_bits=c))
    got = blocks.fused_dot_layer(tx, tw, data_bits=d, coeff_bits=c).numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    if conv2d._pack_shift(d, c) > conv2d.PACK_SHIFT_BUDGET:
        with pytest.raises(OverflowError):
            ref_blocks.packed_dot_layer(jx, jw, data_bits=d, coeff_bits=c)
        with pytest.raises(ValueError, match="pack shift"):
            blocks.packed_dot_layer(tx, tw, data_bits=d, coeff_bits=c)
        return
    want = np.asarray(ref_blocks.packed_dot_layer(jx, jw, data_bits=d,
                                                  coeff_bits=c))
    got = blocks.packed_dot_layer(tx, tw, data_bits=d, coeff_bits=c).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("oc", [1, 2, 3, 4])
def test_packed_dot_pairs_odd_and_even_out_channels(oc):
    """Pairing, including the odd tail duplicated and its twin dropped,
    at the packing boundary d+c = 12."""
    rng = np.random.default_rng(oc)
    x, w = operands(rng, (1, 16, 8, 2), oc, 6, 6)
    want = np.asarray(ref_blocks.packed_dot_layer(
        jnp.asarray(x), jnp.asarray(w), data_bits=6, coeff_bits=6))
    got = blocks.packed_dot_layer(torch.from_numpy(x), torch.from_numpy(w),
                                  data_bits=6, coeff_bits=6).numpy()
    assert got.shape == (1, oc, 16, 8)
    assert np.array_equal(got, want)


def test_registry_and_metadata_match_reference():
    assert blocks.list_blocks() == ref_blocks.list_blocks()
    for name in blocks.list_blocks():
        mine, theirs = blocks.get_block(name), ref_blocks.get_block(name)
        assert (mine.name, mine.convs_per_step, mine.dual_output,
                mine.description) == (theirs.name, theirs.convs_per_step,
                                      theirs.dual_output, theirs.description)
        assert mine.weight_shape(6) == theirs.weight_shape(6)
        for d, c in BIT_GRID + [(2, 8), (8, 17)]:
            assert mine.supports(d, c) == theirs.supports(d, c)
            assert mine.packed_ok(d, c) == theirs.packed_ok(d, c)
    assert blocks.BIT_RANGE == ref_blocks.BIT_RANGE


def test_registry_register_get_unregister():
    blk = base.ConvBlock(name="test_custom", convs_per_step=1,
                         dual_output=False)
    try:
        assert blocks.register_block(blk) is blk
        assert blocks.get_block("test_custom") is blk
        with pytest.raises(ValueError, match="already registered"):
            blocks.register_block(blk)
        x = torch.zeros((1, 16, 8, 1), dtype=torch.int8)
        w = torch.zeros((1, 1, 3, 3), dtype=torch.int8)
        with pytest.raises(NotImplementedError, match="test_custom"):
            blk.apply_batched(x, w, data_bits=8, coeff_bits=8)
    finally:
        blocks.unregister_block("test_custom")
    with pytest.raises(KeyError, match="unknown conv block 'test_custom'"):
        blocks.get_block("test_custom")


@pytest.mark.parametrize("case", ["ndim", "bits", "weights", "height"])
def test_apply_batched_validation_messages_match_reference(case):
    x = np.zeros((2, 16, 8, 3), np.int8)
    w = np.zeros((4, 3, 3, 3), np.int8)
    d, c = 8, 6
    if case == "ndim":
        x = x[0, 0]
    elif case == "bits":
        d = 17
    elif case == "weights":
        w = w[:, :2]
    else:
        x = x[:, :12]
    msgs = []
    for mod, conv in ((ref_blocks, jnp.asarray), (blocks, torch.from_numpy)):
        with pytest.raises(ValueError) as e:
            mod.get_block("conv4").apply_batched(conv(x), conv(w),
                                                 data_bits=d, coeff_bits=c)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("name", ["conv1", "conv2", "conv3", "conv4"])
@pytest.mark.parametrize("d,c", [(6, 4), (8, 6), (10, 8)])
def test_apply_batched_matches_reference(name, d, c):
    """Every block's ``apply_batched`` on an image batch and on one
    (H, W, in_ch) image, against the reference's (whose single image
    runs the per-plane Pallas kernels in interpret mode)."""
    rng = np.random.default_rng(1000 * int(name[-1]) + 17 * d + c)
    x, w = operands(rng, (2, 16, 12, 2), 3, d, c)
    ref_blk, blk = ref_blocks.get_block(name), blocks.get_block(name)
    for xi in (x, x[0]):
        want = np.asarray(ref_blk.apply_batched(
            jnp.asarray(xi), jnp.asarray(w), data_bits=d, coeff_bits=c))
        got = blk.apply_batched(torch.from_numpy(xi), torch.from_numpy(w),
                                data_bits=d, coeff_bits=c).numpy()
        assert got.shape == want.shape
        assert np.array_equal(got, want)


def test_fused_dot_narrows_int16_operands_like_reference():
    """Where the reference dots in int8 (d, c ≤ 8) it narrows wider
    containers first; the port does the same."""
    rng = np.random.default_rng(5)
    x = rng.integers(-300, 300, (1, 16, 8, 2)).astype(np.int16)
    w = rng.integers(-200, 200, (3, 2, 3, 3)).astype(np.int16)
    want = np.asarray(ref_blocks.fused_dot_layer(
        jnp.asarray(x), jnp.asarray(w), data_bits=8, coeff_bits=8))
    got = blocks.fused_dot_layer(torch.from_numpy(x), torch.from_numpy(w),
                                 data_bits=8, coeff_bits=8).numpy()
    assert np.array_equal(got, want)
