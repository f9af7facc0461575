"""Carry the reference's CNN, LM and MoE parameters across to the port.

The port draws weights from a ``torch.Generator``, which cannot
reproduce ``jax.random``; where both sides must compute the same thing,
the reference's weights come across as numpy arrays (for example
``[np.asarray(w) for w in repro.core.cnn.init_cnn(key, cfg)]``, the LM
parameter pytree as nested dicts of ``np.asarray`` leaves, or an MoE
workload's per-layer parameter dicts).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.cnn import CNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.conv2d import container_dtype
from repro_torch.models import moe, transformer


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


def _leaf_tensor(a, where: str) -> torch.Tensor:
    """A float32 numpy array, or a bfloat16 one (the ``ml_dtypes`` type
    ``np.asarray`` gives for a JAX bf16 array, which ``torch.from_numpy``
    rejects: its bits are viewed as int16, then as ``torch.bfloat16``),
    as a CPU tensor of the same dtype and values."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16)
    if a.dtype != np.float32:
        raise ValueError(f"{where}: expected float32 or bfloat16, got "
                         f"{a.dtype}")
    return torch.from_numpy(a.copy())


def lm_params_from_numpy(tree: Mapping, cfg,
                         device: DeviceLike = "cuda") -> Dict:
    """The port's LM parameters for ``cfg`` from the reference's
    parameter pytree as nested dicts of numpy arrays (float32, or
    bfloat16 by dtype name), on ``device``.  Every leaf is checked
    against the shape the port's ``init_params`` gives it and cast to
    its dtype there (float32 → bfloat16 is exact for values that were
    bfloat16), for every family of the zoo: MoE MLPs (``moe/*``, the
    router kept in float32, Llama-4's ``shared_*``), the encoder
    (``enc_stack``, ``enc_norm``) and the decoder's cross attention
    (``ln_x``, ``cross``).  Raises on a missing, extra or misshapen
    leaf."""
    dev = resolve_device(device)
    want = transformer.init_params(None, cfg)        # shapes on meta

    def convert(node, spec, where):
        if isinstance(spec, dict):
            if not isinstance(node, Mapping):
                raise ValueError(f"{where}: expected a dict")
            if set(node) != set(spec):
                raise ValueError(
                    f"{where}: keys {sorted(node)} != {sorted(spec)}")
            return {k: convert(node[k], spec[k], f"{where}.{k}")
                    for k in spec}
        t = _leaf_tensor(node, where)
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                             f"{tuple(spec.shape)}")
        return t.to(device=dev, dtype=spec.dtype)

    return convert(tree, want, "params")


def moe_params_from_numpy(arrays: Sequence[Mapping], spec,
                          device: DeviceLike = "cuda") -> List[Dict]:
    """The port's per-layer MoE parameters for the workload ``spec``
    (a ``runtime.MoEWorkloadSpec``) from the reference's per-layer
    parameter dicts of numpy arrays (float32), on ``device``.  Every
    layer's keys and every array's shape are checked against the
    port's ``init_moe`` for that layer.  Raises on a wrong layer count,
    a missing, extra or misshapen array, or another dtype."""
    dev = resolve_device(device)
    if len(arrays) != len(spec.layers):
        raise ValueError(f"need one parameter dict per layer: "
                         f"{len(arrays)} dicts for {len(spec.layers)} "
                         f"layers")
    out = []
    for i, layer in enumerate(arrays):
        want = moe.init_moe(None, spec.layer_cfg(i))     # shapes on meta
        if not isinstance(layer, Mapping) or set(layer) != set(want):
            got = sorted(layer) if isinstance(layer, Mapping) else layer
            raise ValueError(f"layer {i}: keys {got} != {sorted(want)}")
        params = {}
        for k, spec_t in want.items():
            where = f"layer {i}.{k}"
            t = _leaf_tensor(layer[k], where)
            if t.dtype != torch.float32:
                raise ValueError(f"{where}: expected float32, got "
                                 f"{t.dtype}")
            if tuple(t.shape) != tuple(spec_t.shape):
                raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                                 f"{tuple(spec_t.shape)}")
            params[k] = t.to(dev)
        out.append(params)
    return out


def nested_from_flat(arrays: Mapping, prefix: str, sep: str = "/") -> Dict:
    """The nested dictionary stored flat under ``<prefix><sep>a<sep>b…``
    keys (as the committed LM golden file stores a parameter pytree)."""
    tree: Dict = {}
    head = prefix + sep
    for key in arrays:
        if not key.startswith(head):
            continue
        *path, leaf = key[len(head):].split(sep)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arrays[key]
    return tree
