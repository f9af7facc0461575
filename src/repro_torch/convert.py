"""Carry the reference's CNN parameters across to the port.

The port draws weights from a ``torch.Generator``, which cannot
reproduce ``jax.random``; where both sides must compute the same thing,
the reference's weights come across as numpy arrays (for example
``[np.asarray(w) for w in repro.core.cnn.init_cnn(key, cfg)]``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.cnn import CNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.conv2d import container_dtype


def params_from_numpy(arrays: Sequence, cfg: CNNConfig,
                      device: DeviceLike = "cuda") -> List[torch.Tensor]:
    """One (out_ch, in_ch, 3, 3) weight tensor per layer of ``cfg``, in
    the layer's coefficient container, on ``device``.  Raises on a
    wrong count, shape, a non-integral value or one outside the
    container (which would wrap)."""
    dev = resolve_device(device)
    if len(arrays) != len(cfg.layers):
        raise ValueError(f"need one weight array per layer: {len(arrays)} "
                         f"arrays for {len(cfg.layers)} layers")
    params = []
    for i, (a, spec) in enumerate(zip(arrays, cfg.layers)):
        a = np.asarray(a)
        want = (spec.out_channels, spec.in_channels, 3, 3)
        if a.shape != want:
            raise ValueError(f"layer {i}: weights {a.shape} != {want}")
        if not np.issubdtype(a.dtype, np.integer) \
                and np.any(a != np.round(a)):
            raise ValueError(f"layer {i}: weights carry non-integral values")
        cdt = container_dtype(spec.coeff_bits)
        info = torch.iinfo(cdt)
        if a.size and (a.min() < info.min or a.max() > info.max):
            raise ValueError(f"layer {i}: weights outside the {cdt} "
                             f"container [{info.min}, {info.max}]")
        params.append(torch.from_numpy(a.astype(np.int64)).to(cdt).to(dev))
    return params
