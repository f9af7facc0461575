"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
numpy-made operands handed to both packages, a narrow network built in
either package, the layer-by-layer trace of a bucketed MoE dispatch,
and the ``cuda`` fixture that skips a
card test where there is no card (decided inside the test, never at
import, so every xdist worker collects the same tests)."""

import numpy as np
import pytest
import torch


def np_container(bits):
    return np.int8 if bits <= 8 else np.int16


def operands(rng, shape, oc, d, c, *, x_range=None):
    """numpy x ``shape`` = (N, H, W, ic) over the signed d-bit range (or
    ``x_range``, then in an int16 container) and w (oc, ic, 3, 3) over
    the signed c-bit range, with both extremes forced in."""
    lo, hi = x_range or (-(1 << (d - 1)), (1 << (d - 1)) - 1)
    x = rng.integers(lo, hi + 1, shape)
    x.reshape(-1)[:2] = (lo, hi)
    wlo, whi = -(1 << (c - 1)), (1 << (c - 1)) - 1
    w = rng.integers(wlo, whi + 1, (oc, shape[-1], 3, 3))
    w.reshape(-1)[:2] = (wlo, whi)
    xdt = np.int16 if x_range else np_container(d)
    return x.astype(xdt), w.astype(np_container(c))


def narrow_config(module):
    """A narrow three-layer net that runs all three layer kernels:
    conv4 → fused dot, conv1 → shift-add, conv3 at d6c4 → packed dot."""
    return module.CNNConfig(layers=(
        module.ConvLayerSpec(1, 4, data_bits=8, coeff_bits=6, block="conv4"),
        module.ConvLayerSpec(4, 3, data_bits=8, coeff_bits=6, shift=6,
                             block="conv1"),
        module.ConvLayerSpec(3, 3, data_bits=6, coeff_bits=4, shift=5,
                             block="conv3"),
    ), img_h=16, img_w=24)


def dispatch_trace(compiled, xb, to_backend, to_numpy):
    """The activations of one bucketed dispatch of ``xb`` (n ≤ max_batch
    numpy requests) through either package's ``CompiledModel``, layer
    by layer with its own prepared (layer, bucket) executables: ``[x,
    after layer 0, ..., output]``, each (n, ...) as numpy."""
    n = xb.shape[0]
    bucket = compiled.bucket_for(n)
    act = to_backend(np.concatenate(
        [xb, np.zeros((bucket - n,) + xb.shape[1:], xb.dtype)]))
    acts = [np.asarray(xb)]
    for i in range(compiled.num_layers):
        act = compiled._compile_layer(i, bucket)(compiled._layer_params(i),
                                                 act)
        acts.append(to_numpy(act)[:n])
    return acts


@pytest.fixture
def cuda():
    """The card, for tests marked ``cuda``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the card")
    return torch.device("cuda")
