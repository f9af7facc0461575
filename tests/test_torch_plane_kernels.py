"""The port's per-plane block path held against ``repro.blocks`` and
``repro.core.cnn`` on the same numpy-made inputs: the plain versions of
the plane kernels (K4–K6) and ``ConvBlock.apply`` against the reference's
``ConvBlock.apply`` (Pallas in interpret mode), the single-image
``apply_batched``, ``cnn_forward_loop``, the golden ``apply`` outputs and
the deprecated shims.  Tolerance zero throughout (exact integer
arithmetic)."""

import itertools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.blocks as ref_blocks
from repro.core import cnn as ref_cnn
from repro.kernels import ops as ref_ops
from repro_torch import blocks, convert
from repro_torch.core import cnn
from repro_torch.kernels import conv2d, ops, ref
from repro_torch.kernels.build import LAUNCHES
from test_torch_cnn import reference_params
from test_torch_golden import APPLY_POINTS, GOLDEN
from torch_parity import np_container

BLOCKS = ("conv1", "conv2", "conv3", "conv4")
# bits 3 and 16, d+c = 12 and 13 (conv3's packing boundary), the 8/9-bit
# containers, and the accumulator boundary of conv1 (d+c = 11/12)
EDGE_BITS = [(3, 3), (3, 16), (16, 3), (16, 16), (6, 6), (7, 6), (6, 7),
             (5, 6), (8, 8), (9, 8), (8, 9)]
PLAIN = {"conv2": conv2d.conv2_planes_plain,
         "conv3": conv2d.conv3_planes_plain,
         "conv4": conv2d.conv4_planes_plain}
WRAPPERS = {"conv2": conv2d.conv2_planes, "conv3": conv2d.conv3_planes,
            "conv4": conv2d.conv4_planes}


def plane_operands(rng, name, d, c, shape=(32, 24)):
    """One plane over the full signed d-bit range and the block's weight
    operand over the full c-bit range, extremes forced in."""
    x = rng.integers(-(1 << (d - 1)), 1 << (d - 1), shape)
    x.reshape(-1)[:2] = (-(1 << (d - 1)), (1 << (d - 1)) - 1)
    w = rng.integers(-(1 << (c - 1)), 1 << (c - 1),
                     ref_blocks.get_block(name).weight_shape(c))
    w.reshape(-1)[:2] = (-(1 << (c - 1)), (1 << (c - 1)) - 1)
    return x.astype(np_container(d)), w.astype(np_container(c))


def reference_apply(name, x, w, d, c):
    return np.asarray(ref_blocks.get_block(name).apply(
        jnp.asarray(x), jnp.asarray(w), data_bits=d, coeff_bits=c))


@pytest.mark.parametrize("name", BLOCKS)
@pytest.mark.parametrize("d,c", EDGE_BITS)
def test_apply_and_plain_planes_match_reference_apply(name, d, c):
    """``ConvBlock.apply`` (a 2-row-tile grid) and, for the dot blocks,
    the plane kernel's plain version on a stack of planes, against the
    reference's Pallas ``apply`` in interpret mode."""
    rng = np.random.default_rng(100 * int(name[-1]) + 17 * d + c)
    x, w = plane_operands(rng, name, d, c)
    want = reference_apply(name, x, w, d, c)
    blk = blocks.get_block(name)
    got = blk.apply(torch.from_numpy(x), torch.from_numpy(w), data_bits=d,
                    coeff_bits=c).numpy()
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape and np.array_equal(got, want)
    if name == "conv1":
        got = conv2d.run_plane_tiles(
            conv2d.conv1_tile, torch.from_numpy(x)[None],
            torch.from_numpy(w)[None], data_bits=d, coeff_bits=c)[0]
    else:
        # the same plane twice and a second plane, one call
        x2, w2 = plane_operands(rng, name, d, c)
        got = PLAIN[name](torch.from_numpy(np.stack([x, x2, x])),
                          torch.from_numpy(np.stack([w, w2, w])),
                          data_bits=d, coeff_bits=c)
        assert np.array_equal(got[2].numpy(), want)
        got = got[0]
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), blk.reference(
        torch.from_numpy(x), torch.from_numpy(w)).numpy())


@pytest.mark.sweep
@pytest.mark.parametrize("name", BLOCKS)
def test_apply_matches_reference_apply_full_grid(name):
    for d, c in itertools.product(range(3, 17), repeat=2):
        rng = np.random.default_rng(17 * d + c)
        x, w = plane_operands(rng, name, d, c, shape=(16, 8))
        got = blocks.get_block(name).apply(
            torch.from_numpy(x), torch.from_numpy(w), data_bits=d,
            coeff_bits=c).numpy()
        assert np.array_equal(got, reference_apply(name, x, w, d, c)), (d, c)


@pytest.mark.parametrize("block,d,c", APPLY_POINTS,
                         ids=[f"{b}-d{d}c{c}" for b, d, c in APPLY_POINTS])
def test_apply_matches_golden(block, d, c):
    with np.load(GOLDEN) as z:
        key = f"apply.{block}.d{d}c{c}"
        x, w, y = z[f"{key}.x"], z[f"{key}.w"], z[f"{key}.y"]
    got = blocks.get_block(block).apply(torch.from_numpy(x),
                                        torch.from_numpy(w), data_bits=d,
                                        coeff_bits=c)
    assert np.array_equal(got.numpy(), y)


def test_plane_wrappers_take_int16_containers_like_reference():
    """Containers wider than the bits: where the reference dots in int8
    it narrows the operands; Conv3's packed dot stays in int32."""
    rng = np.random.default_rng(7)
    x = rng.integers(-300, 300, (32, 24)).astype(np.int16)
    for name, d, c in (("conv2", 8, 8), ("conv4", 8, 6), ("conv3", 8, 6),
                       ("conv3", 6, 6)):
        shape = ref_blocks.get_block(name).weight_shape(c)
        w = rng.integers(-200, 200, shape).astype(np.int16)
        want = reference_apply(name, x, w, d, c)
        got = WRAPPERS[name](torch.from_numpy(x)[None],
                             torch.from_numpy(w)[None], data_bits=d,
                             coeff_bits=c)[0]
        assert np.array_equal(got.numpy(), want), (name, d, c)


@pytest.mark.parametrize("name", ["conv2", "conv3", "conv4"])
def test_plane_wrappers_check_operands(name):
    kern = WRAPPERS[name]
    n_w = (3, 3) if name == "conv2" else (2, 3, 3)
    x = torch.zeros((2, 16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"expected x \(P, H, W\)"):
        kern(x, torch.zeros((3, *n_w), dtype=torch.int8), data_bits=6,
             coeff_bits=4)
    with pytest.raises(ValueError, match="containers"):
        kern(x.to(torch.int32), torch.zeros((2, *n_w), dtype=torch.int8),
             data_bits=6, coeff_bits=4)
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        conv2d.launch_planes(kern.__name__, conv2d._PLANE_ARGTYPES,
                             x.to("meta"),
                             torch.zeros((2, *n_w), dtype=torch.int8,
                                         device="meta"), len(n_w) - 1)
    before = LAUNCHES[kern.__name__]
    assert kern(x, torch.zeros((2, *n_w), dtype=torch.int8), data_bits=6,
                coeff_bits=4).shape[0] == 2
    assert LAUNCHES[kern.__name__] == before  # plain on the CPU


def test_apply_validation_messages_match_reference():
    x = np.zeros((32, 24), np.int8)
    cases = [("conv2", x, np.zeros((3, 3), np.int8), 17, 6),
             ("conv3", x, np.zeros((3, 3), np.int8), 6, 6),
             ("conv1", x[:20], np.zeros((3, 3), np.int8), 6, 6)]
    for name, xi, wi, d, c in cases:
        msgs = []
        for mod, conv in ((ref_blocks, jnp.asarray),
                          (blocks, torch.from_numpy)):
            with pytest.raises(ValueError) as e:
                mod.get_block(name).apply(conv(xi), conv(wi), data_bits=d,
                                          coeff_bits=c)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("name", BLOCKS)
@pytest.mark.parametrize("oc", [1, 5])
@pytest.mark.parametrize("d,c", [(6, 6), (9, 8)])
def test_single_image_apply_batched_matches_reference(name, oc, d, c):
    """The 3-D branch — every (oc, ic) plane (channel pairs for dual
    blocks, the odd tail duplicated and its twin dropped) in one plane
    launch, then the sum over in_ch — against the reference's vmapped
    Pallas path."""
    rng = np.random.default_rng(oc * 100 + 17 * d + c)
    x = rng.integers(-(1 << (d - 1)), 1 << (d - 1), (32, 16, 3))
    w = rng.integers(-(1 << (c - 1)), 1 << (c - 1), (oc, 3, 3, 3))
    x, w = x.astype(np_container(d)), w.astype(np_container(c))
    want = np.asarray(ref_blocks.get_block(name).apply_batched(
        jnp.asarray(x), jnp.asarray(w), data_bits=d, coeff_bits=c))
    got = blocks.get_block(name).apply_batched(
        torch.from_numpy(x), torch.from_numpy(w), data_bits=d,
        coeff_bits=c).numpy()
    assert got.shape == want.shape == (oc, 32, 16)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("blocks_", [("conv4", "conv3", "conv4"),
                                     ("conv2", "conv1", "conv3")])
def test_cnn_forward_loop_matches_reference_on_quickstart(blocks_):
    """The per-plane loop and the single-image batched forward on the
    quickstart CNN with the reference's weights, against the reference's
    loop."""
    cfg = cnn.quickstart_cnn_config()
    weights = reference_params(ref_cnn.quickstart_cnn_config())
    rng = np.random.default_rng(3)
    x = rng.integers(0, 128, (cfg.img_h, cfg.img_w, 1)).astype(np.int8)
    want = np.asarray(ref_cnn.cnn_forward_loop(
        [jnp.asarray(w) for w in weights], jnp.asarray(x),
        ref_cnn.quickstart_cnn_config(), blocks_))
    params = convert.params_from_numpy(weights, cfg, "cpu")
    got = cnn.cnn_forward_loop(params, torch.from_numpy(x), cfg, blocks_)
    assert np.array_equal(got.numpy(), want)
    got = cnn.cnn_forward(params, torch.from_numpy(x), cfg, blocks_)
    assert np.array_equal(got.numpy(), want)


def test_conv_block_shims_warn_and_dispatch_like_reference():
    rng = np.random.default_rng(9)
    x, w = plane_operands(rng, "conv3", 6, 6)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    msgs = []
    for mod, args in ((ref_ops, (jnp.asarray(x), jnp.asarray(w))),
                      (ops, (tx, tw))):
        with pytest.warns(DeprecationWarning) as rec:
            y = mod.conv_block("conv3", *args, data_bits=6, coeff_bits=6)
            y_ref = mod.conv_block_ref("conv3", *args, data_bits=6)
        msgs.append([str(r.message) for r in rec])
        assert np.array_equal(np.asarray(y), np.asarray(y_ref))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(ValueError, match="unknown block 'conv9'"):
                mod.conv_block("conv9", *args, data_bits=6, coeff_bits=6)
    assert msgs[0] == msgs[1]
    assert np.array_equal(ref.conv_block_ref("conv3", tx, tw).numpy(),
                          reference_apply("conv3", x, w, 6, 6))
