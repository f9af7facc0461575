"""The "synthesis" sweep (paper §3.2).

Port of ``repro.core.synth``.  For every block × (data_bits, coeff_bits)
∈ [3..16]² — 196 configurations per block, 784 total — count the
block's plain per-plane form with the op census (``core/census.py``)
and record its resource vector.  This is the analogue of running Vivado
synthesis per configuration and scraping the utilization report; rows
are cached to JSON so downstream analyses (correlation, model fitting,
allocation) never re-count.

Resource classes and their FPGA counterparts:

  vpu_ops        ↔ LLUT   (elementwise combinational work)
  add_chain      ↔ CChain (accumulation adds)
  mxu_flops      ↔ DSP    (dot/conv MACs)
  mem_move_bytes ↔ MLUT   (distributed-memory movement)
  temp_bytes     ↔ FF     (live intermediate storage)
  hbm_bytes      ↔ BRAM   (block-memory traffic)
  vmem_bytes     — the staged working set (the reference's VMEM)

The rows are the port's own census, not the reference's jaxpr census:
they carry their own schema version and cache under
``build/repro_torch/``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from repro_torch.blocks import BlockLike, get_block
from repro_torch.configs.paper_conv import ConvSweepConfig, SWEEP
from repro_torch.core import census
from repro_torch.kernels import build

RESOURCES = ["vpu_ops", "add_chain", "mxu_cost", "mxu_flops",
             "mem_move_bytes", "temp_bytes", "hbm_bytes", "vmem_bytes"]

_FPGA_NAME = {
    "vpu_ops": "LLUT", "add_chain": "CChain", "mxu_cost": "DSP",
    "mxu_flops": "DSP_raw", "mem_move_bytes": "MLUT", "temp_bytes": "FF",
    "hbm_bytes": "BRAM", "vmem_bytes": "VMEM",
}


def fpga_name(resource: str) -> str:
    return _FPGA_NAME.get(resource, resource)


def vmem_bytes(img_h: int, img_w: int, tile_h: int, data_bits: int,
               coeff_bits: int, n_out: int) -> float:
    """Analytic staged working set: padded image + weights + out tile.

    The padded image is staged in its *data container* dtype (int8 ≤ 8
    bits, else int16), so the image term scales with ``d_item``; weights
    likewise use the coeff container, while the int32 output tile is
    width-independent.  Geometry-parameterized so the deployment planner
    (core/deploy.py) can evaluate the working set at the deployed image
    size, not just the sweep image."""
    d_item = 1 if data_bits <= 8 else 2
    c_item = 1 if coeff_bits <= 8 else 2
    img = (img_h + 2) * (img_w + 2) * d_item   # container-width pad
    wk = n_out * 9 * c_item
    out = n_out * tile_h * img_w * 4
    return float(img + wk + out)


def _vmem_bytes(cfg: ConvSweepConfig, data_bits: int, coeff_bits: int,
                n_out: int) -> float:
    # sweep image: 4 row-tiles high, one tile wide
    return vmem_bytes(4 * cfg.tile_h, cfg.tile_w, cfg.tile_h,
                      data_bits, coeff_bits, n_out)


def synth_one(block: BlockLike, data_bits: int, coeff_bits: int,
              cfg: ConvSweepConfig = SWEEP) -> Dict[str, float]:
    """Count one registered block at one design point; all block
    properties (weight shape, convs/step, packing) come from the
    ``ConvBlock`` registry entry."""
    blk = get_block(block)
    res = census.block_resources(blk, 4 * cfg.tile_h, cfg.tile_w,
                                 data_bits=data_bits, coeff_bits=coeff_bits,
                                 tile_h=cfg.tile_h)
    out = {k: float(res.get(k, 0.0)) for k in RESOURCES if k != "vmem_bytes"}
    out["vmem_bytes"] = _vmem_bytes(cfg, data_bits, coeff_bits,
                                    2 if blk.dual_output else 1)
    out["convs_per_step"] = float(blk.convs_per_step)
    out["packed"] = float(blk.packed_ok(data_bits, coeff_bits))
    return out


# bump when row semantics change so pre-existing caches regenerate
# instead of silently serving stale numbers; a string, so that it never
# equals a version of the reference's jaxpr-census rows
SWEEP_SCHEMA_VERSION = "repro_torch.census/1"

DEFAULT_CACHE = build.BUILD_DIR / "synth.json"


def run_sweep(cfg: ConvSweepConfig = SWEEP,
              cache_path: str | Path = DEFAULT_CACHE,
              force: bool = False) -> List[dict]:
    cache = Path(cache_path)
    if cache.exists() and not force:
        payload = json.loads(cache.read_text())
        if (isinstance(payload, dict)
                and payload.get("version") == SWEEP_SCHEMA_VERSION):
            return payload["rows"]
        # stale cache → fall through and re-sweep
    rows = []
    for block in cfg.blocks:
        blk = get_block(block)
        for d in cfg.data_bits:
            for c in cfg.coeff_bits:
                row = {"block": blk.name, "data_bits": d, "coeff_bits": c}
                row.update(synth_one(blk, d, c, cfg))
                rows.append(row)
    cache.parent.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_name(f".{cache.name}.tmp")
    tmp.write_text(json.dumps({"version": SWEEP_SCHEMA_VERSION,
                               "rows": rows}))
    tmp.replace(cache)
    return rows


def sweep_arrays(rows: List[dict], block: str):
    """(d, c, {resource: y}) numpy arrays for one block."""
    sel = [r for r in rows if r["block"] == block]
    d = np.array([r["data_bits"] for r in sel], float)
    c = np.array([r["coeff_bits"] for r in sel], float)
    ys = {k: np.array([r[k] for r in sel], float) for k in RESOURCES}
    return d, c, ys
