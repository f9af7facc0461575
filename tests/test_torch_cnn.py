"""The port's CNN core (``repro_torch.core.cnn``) and weight conversion
(``repro_torch.convert``) held against ``repro.core.cnn``: specs and
config, the requantize step, the batched forward and the oracle, on the
reference's own weights carried across as numpy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cnn as ref_cnn
from repro_torch import convert
from repro_torch.core import cnn
from torch_parity import narrow_config, operands


def reference_params(cfg, seed=0):
    return [np.asarray(w) for w in
            ref_cnn.init_cnn(jax.random.PRNGKey(seed), cfg)]


def images(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    d0 = cfg.layers[0].data_bits
    return rng.integers(0, 1 << (d0 - 1), (n, cfg.img_h, cfg.img_w,
                                           cfg.layers[0].in_channels)
                        ).astype(np.int8)


def test_quickstart_config_matches_reference():
    assert dataclasses.asdict(cnn.quickstart_cnn_config()) \
        == dataclasses.asdict(ref_cnn.quickstart_cnn_config())


@pytest.mark.parametrize("kw", [
    dict(data_bits=2), dict(data_bits=17), dict(coeff_bits=2),
    dict(coeff_bits=17), dict(shift=-1), dict(in_channels=0),
    dict(out_channels=0)])
def test_layer_spec_validation_matches_reference(kw):
    args = dict(in_channels=1, out_channels=2) | kw
    msgs = []
    for mod in (ref_cnn, cnn):
        with pytest.raises(ValueError) as e:
            mod.ConvLayerSpec(**args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("data_bits", [3, 6, 8, 9, 16])
@pytest.mark.parametrize("shift", [0, 5, 7, 31, 40])
def test_requantize_matches_reference(data_bits, shift):
    rng = np.random.default_rng(data_bits * 100 + shift)
    acc = rng.integers(-2**31, 2**31, (2, 3, 16, 8)).astype(np.int32)
    acc.reshape(-1)[:2] = (-2**31, 2**31 - 1)
    spec_args = dict(in_channels=1, out_channels=3, data_bits=data_bits,
                     shift=shift)
    for a in (acc, acc[0]):
        want = np.asarray(ref_cnn._requantize(
            jnp.asarray(a), ref_cnn.ConvLayerSpec(**spec_args)))
        got = cnn._requantize(torch.from_numpy(a),
                              cnn.ConvLayerSpec(**spec_args)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_init_cnn_shape_dtype_scale():
    """The torch draw differs from jax.random's; its shapes, containers
    and scale are the reference's."""
    cfg = dataclasses.replace(narrow_config(cnn), layers=(
        cnn.ConvLayerSpec(4, 32, coeff_bits=6),
        cnn.ConvLayerSpec(32, 16, coeff_bits=12)))
    ref_cfg = dataclasses.replace(narrow_config(ref_cnn), layers=(
        ref_cnn.ConvLayerSpec(4, 32, coeff_bits=6),
        ref_cnn.ConvLayerSpec(32, 16, coeff_bits=12)))
    mine = cnn.init_cnn(torch.Generator().manual_seed(0), cfg)
    theirs = ref_cnn.init_cnn(jax.random.PRNGKey(0), ref_cfg)
    again = cnn.init_cnn(torch.Generator().manual_seed(0), cfg)
    floats = cnn.init_cnn_float(torch.Generator().manual_seed(0), cfg)
    for w, r, w2, f, spec in zip(mine, theirs, again, floats, cfg.layers):
        assert tuple(w.shape) == r.shape
        assert str(w.dtype).removeprefix("torch.") == jnp.dtype(r.dtype).name
        assert torch.equal(w, w2)                      # seeded, repeatable
        lim = 1 << (spec.coeff_bits - 1)
        assert int(w.min()) >= -lim and int(w.max()) < lim
        scale = 2.0 ** (spec.coeff_bits - 2) / 3.0
        assert abs(float(f.std()) / scale - 1.0) < 0.1


def test_cnn_forward_and_oracle_match_reference():
    cfg, ref_cfg = narrow_config(cnn), narrow_config(ref_cnn)
    arrays = reference_params(ref_cfg)
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    xs = images(cfg, 2)
    want = np.asarray(ref_cnn.cnn_forward_ref(
        [jnp.asarray(a) for a in arrays], jnp.asarray(xs), ref_cfg))
    blocks = [s.block for s in cfg.layers]
    got = cnn.cnn_forward(params, torch.from_numpy(xs), cfg, blocks)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(cnn.cnn_forward_ref(params, torch.from_numpy(xs),
                                              cfg).numpy(), want)
    # one (H, W, C) image through both paths
    one = cnn.cnn_forward(params, torch.from_numpy(xs[0]), cfg, blocks)
    assert np.array_equal(one.numpy(), want[0])


def test_cnn_forward_ref_matches_reference_at_wide_bits():
    """The oracle's int32 sums wrap where the reference's do."""
    ref_cfg = ref_cnn.CNNConfig(layers=(
        ref_cnn.ConvLayerSpec(3, 2, data_bits=16, coeff_bits=16, shift=20),),
        img_h=16, img_w=8)
    cfg = cnn.CNNConfig(layers=(
        cnn.ConvLayerSpec(3, 2, data_bits=16, coeff_bits=16, shift=20),),
        img_h=16, img_w=8)
    rng = np.random.default_rng(3)
    x, w = operands(rng, (16, 8, 3), 2, 16, 16)
    want = np.asarray(ref_cnn.cnn_forward_ref([jnp.asarray(w)],
                                              jnp.asarray(x), ref_cfg))
    got = cnn.cnn_forward_ref([torch.from_numpy(w)], torch.from_numpy(x),
                              cfg).numpy()
    assert np.array_equal(got, want)


def test_params_from_numpy_carries_reference_weights():
    cfg = narrow_config(cnn)
    arrays = reference_params(narrow_config(ref_cnn), seed=4)
    params = convert.params_from_numpy(arrays, cfg, "cpu")
    for p, a, spec in zip(params, arrays, cfg.layers):
        assert p.dtype == torch.int8 and p.device.type == "cpu"
        assert np.array_equal(p.numpy(), a)


@pytest.mark.parametrize("bad", ["count", "shape", "range", "fraction"])
def test_params_from_numpy_rejects_bad_weights(bad):
    cfg = narrow_config(cnn)
    arrays = [np.zeros((s.out_channels, s.in_channels, 3, 3), np.int8)
              for s in cfg.layers]
    if bad == "count":
        arrays = arrays[:2]
    elif bad == "shape":
        arrays[1] = arrays[1][:, :2]
    elif bad == "range":
        arrays[0] = arrays[0].astype(np.int32) + 200
    else:
        arrays[2] = arrays[2] + 0.5
    with pytest.raises(ValueError):
        convert.params_from_numpy(arrays, cfg, "cpu")


def test_params_from_numpy_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = narrow_config(cnn)
    with pytest.raises(RuntimeError, match="is_available"):
        convert.params_from_numpy(
            reference_params(narrow_config(ref_cnn)), cfg, "cuda")
