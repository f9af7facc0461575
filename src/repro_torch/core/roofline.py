"""Roofline terms from dry-run records.

Port of ``repro.core.roofline``, with the peaks as a record (``Peaks``)
instead of module constants:

  compute    = per-device FLOPs        / peak FLOP/s
  memory     = per-device HBM bytes    / peak bytes/s
  collective = per-device wire bytes   / link bytes/s

A dry-run record's ``hlo`` counts are one device's (``core.hloscan``),
so only the useful-work yardstick MODEL_FLOPS = 6·N·D (train) / 2·N·D
(inference), N the active parameter count, is divided by the chips.

``H100_SXM``, the default, is NVIDIA's data sheet for the H100 SXM at
700 W: 989e12 bf16 dense FLOP/s, 3.35e12 HBM bytes/s, 450e9 NVLink
bytes/s each way.  ``V5E`` holds the reference's TPU v5e figures, for
parity with the reference's records only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Peaks:
    name: str
    flops: float                 # bf16 FLOP/s per chip
    hbm_bw: float                # bytes/s per chip
    link_bw: float               # bytes/s per link (~per chip, one link)


H100_SXM = Peaks("h100-sxm", 989e12, 3.35e12, 450e9)
V5E = Peaks("v5e", 197e12, 819e9, 50e9)


_SHAPE_META = {
    "train_4k": ("train", 4096, 256),
    "prefill_32k": ("prefill", 32768, 32),
    "decode_32k": ("decode", 32768, 128),
    "long_500k": ("decode", 524288, 1),
}


def _shape_meta(result: Dict):
    """(kind, seq, batch) of the record's cell; a record of a step that
    is no named cell carries its own ``kind``, ``seq_len`` and
    ``global_batch``."""
    if result["shape"] in _SHAPE_META:
        return _SHAPE_META[result["shape"]]
    return result["kind"], result["seq_len"], result["global_batch"]


def min_bytes(result: Dict) -> float:
    """Lower bound on HBM bytes that MUST move per step (global):
    weights (+ optimizer state round-trip for train) + KV/state cache for
    decode — the memory-side roofline floor."""
    n, n_act = result["params"], result["active_params"]
    kind, seq, batch = _shape_meta(result)
    if kind == "train":
        # read bf16 params + write grads + read/write fp32 m,v + param write
        return n * (2 + 2 + 16 + 2)
    if kind == "prefill":
        return n * 2
    # decode: active weights stream once per token + cache read
    from repro_torch.configs import get_config
    try:
        cfg = get_config(result["arch"])
    except KeyError:
        return n_act * 2
    n_attn = sum(1 for s in cfg.layer_cycle
                 if s.mixer in ("attn", "local")) * cfg.n_cycles
    cache = n_attn * 2 * seq * batch * cfg.kv_dim * 2
    if cfg.ssm is not None:
        n_mamba = sum(1 for s in cfg.layer_cycle
                      if s.mixer == "mamba") * cfg.n_cycles
        inner = cfg.ssm.expand * cfg.d_model
        nh = inner // cfg.ssm.head_dim
        cache += n_mamba * batch * nh * cfg.ssm.state_dim * \
            cfg.ssm.head_dim * 4
    return n_act * 2 + cache


def model_flops(result: Dict) -> float:
    """Useful FLOPs per step for the cell, from analytic param counts."""
    n_active = result["active_params"]
    kind, seq, batch = _shape_meta(result)
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch           # one new token per sequence


def roofline_terms(result: Dict, peaks: Peaks = H100_SXM) -> Dict:
    chips = result["n_chips"]
    hlo = result.get("hlo", {})
    if "flops" in hlo:
        flops_dev = hlo["flops"]
        bytes_dev = hlo["hbm_bytes"]
        coll = hlo.get("collective_total", 0.0)
    else:
        cost = result["cost"]
        flops_dev = cost["flops"]
        bytes_dev = cost["bytes_accessed"]
        coll = result.get("collectives", {}).get("total", 0.0)

    t_compute = flops_dev / peaks.flops
    t_memory = bytes_dev / peaks.hbm_bw
    t_coll = coll / peaks.link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)

    mf = model_flops(result)
    useful_ratio = mf / max(flops_dev * chips, 1.0)
    # the ideal step is bounded by BOTH the useful compute and the
    # minimal weight/cache traffic (decode is legitimately memory-bound)
    ideal = max(mf / (chips * peaks.flops),
                min_bytes(result) / (chips * peaks.hbm_bw))
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": flops_dev * chips,
        "useful_flops_ratio": useful_ratio,
        "ideal_s": ideal,
        "roofline_fraction": ideal / bound if bound > 0 else 0.0,
    }
