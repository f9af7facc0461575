"""Framework-level DSE: the paper's prediction methodology lifted from
convolution blocks to whole-model training/serving steps.

Port of ``repro.core.model_dse`` (numpy, over the port's
``core.polyfit``).  The expensive oracle is the dry run of a cell over
512 devices (``launch.dryrun``; the reference compiles it with XLA — the
synthesis analogue); the model predicts the dry run's roofline terms
from *analytic* config features, so mesh/sharding/architecture
trade-offs can be explored without running it.  The corpus may come
from either package: both write the same record keys.

  features  x_f = analytic FLOPs   (6·N_active·tokens · train-multiplier)
            x_m = analytic bytes   (param + activation + cache residency)
            x_c = analytic collective bytes (TP all-reduces + DP grad
                   reduction + EP dispatch, from the sharding rules)
  targets   measured per-device HLO flops / HBM bytes / wire bytes from
            the dry-run corpus (results/*.json)

Per target, Algorithm 1 fits y = poly(x) (degree ≤ 2 here — the relation
is near-linear with a remat/dispatch calibration slope), validated by
leave-one-out MAPE — the same §4.1 metrics as the block-level tables.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import polyfit


def analytic_features(arch: str, shape_name: str, n_chips: int,
                      mesh: str) -> Dict[str, float]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    tp = 16
    dp = n_chips // tp
    tokens_step = (shape.global_batch if shape.kind == "decode"
                   else shape.seq_len * shape.global_batch)
    passes = 4.0 if shape.kind == "train" else 1.0   # fwd+remat+bwd

    # parameter-path flops (MoE padded by the capacity factor)
    n_act = cfg.active_param_count()
    if cfg.moe is not None:
        n_act = n_act * cfg.moe.capacity_factor
    f = 2.0 * n_act * tokens_step * passes

    # attention flops, with the sharding rule's head-replication factor:
    # heads that don't divide the model axis are computed on every TP rank
    n_attn = sum(1 for s in cfg.layer_cycle
                 if s.mixer in ("attn", "local")) * cfg.n_cycles
    if n_attn and cfg.n_heads:
        t_kv = shape.seq_len
        q_rows = tokens_step
        attn = 4.0 * q_rows * t_kv * cfg.n_heads * cfg.head_dim \
            * n_attn * passes
        if cfg.n_heads % tp:
            attn *= tp               # replicated over the model axis
        f += attn
    # SSD flops (intra-chunk quadratic + state updates)
    if cfg.ssm is not None:
        n_mamba = sum(1 for s in cfg.layer_cycle
                      if s.mixer == "mamba") * cfg.n_cycles
        inner = cfg.ssm.expand * cfg.d_model
        nh = inner // cfg.ssm.head_dim
        q = cfg.ssm.chunk_size
        per_tok = 2 * q * nh * (cfg.ssm.state_dim + 2 * cfg.ssm.head_dim)
        ssd = per_tok * tokens_step * n_mamba * passes
        if shape.kind == "decode":
            ssd = 2 * nh * cfg.ssm.state_dim * cfg.ssm.head_dim \
                * tokens_step * n_mamba
        f += ssd
    # memory: params (+grads+moments for train) + working activations
    pbytes = cfg.param_count() * 2
    if shape.kind == "train":
        pbytes = cfg.param_count() * (2 + 4 + 4 + 4)
    tokens = shape.seq_len * shape.global_batch
    if shape.kind == "decode":
        tokens = shape.global_batch
        # cache residency
        kv = (cfg.n_layers * 2 * shape.seq_len * shape.global_batch
              * cfg.kv_dim * 2)
        pbytes += kv
    act = tokens * cfg.d_model * 2 * max(cfg.n_layers // 8, 1)
    mem = pbytes + act
    # collectives: TP activation reductions + DP gradient reduction
    tp_coll = tokens * cfg.d_model * 2 * 2 * cfg.n_layers / n_chips
    dp_coll = (cfg.param_count() * 4 * 2 / n_chips
               if shape.kind == "train" else 0.0)
    ep_coll = 0.0
    if cfg.moe is not None:
        ep_coll = tokens * cfg.d_model * 2 * cfg.moe.top_k * 2 / n_chips
    return {"x_flops": f / n_chips, "x_mem": mem / n_chips,
            "x_coll": tp_coll + dp_coll + ep_coll,
            "is_train": 1.0 if shape.kind == "train" else 0.0}


TARGETS = {"flops": ("x_flops",), "hbm_bytes": ("x_mem",),
           "collective_total": ("x_coll",)}


@dataclass
class DSEModel:
    models: Dict[str, polyfit.PolyModel]
    loo: Dict[str, Dict[str, float]]

    def predict(self, arch: str, shape_name: str, n_chips: int = 256,
                mesh: str = "single") -> Dict[str, float]:
        feats = analytic_features(arch, shape_name, n_chips, mesh)
        kind = SHAPES[shape_name].kind
        out = {}
        for tgt, (fx,) in TARGETS.items():
            m = self.models[tgt]
            pred = (m.predict(feats[fx], 0.0, kind=kind)
                    if isinstance(m, _KindModel)
                    else m.predict(feats[fx], 0.0))
            out[tgt] = float(np.maximum(pred[0], 0.0))
        return out


def load_corpus(results_dir: str | Path, tag: str = "baseline"
                ) -> List[dict]:
    rows = []
    for f in sorted(Path(results_dir).glob(f"{tag}__*.json")):
        r = json.loads(f.read_text())
        if r.get("status") == "ok" and "flops" in r.get("hlo", {}):
            rows.append(r)
    return rows


def fit_dse(rows: List[dict]) -> DSEModel:
    """Per (target × shape-kind) log-space fits: train / prefill / decode
    cells have different calibration slopes (backward+remat multipliers,
    cache streaming), which one pooled fit smears together."""
    models, loo = {}, {}
    kinds = sorted({SHAPES[r["shape"]].kind for r in rows})
    for tgt, (fx,) in TARGETS.items():
        preds_all, y_all = [], []
        kind_models = {}
        for kind in kinds:
            sel = [r for r in rows if SHAPES[r["shape"]].kind == kind]
            X = np.array([analytic_features(
                r["arch"], r["shape"], r["n_chips"], r["mesh"])[fx]
                for r in sel])
            Y = np.array([r["hlo"].get(tgt, 0.0) for r in sel])
            lx = np.log10(np.maximum(X, 1.0))
            ly = np.log10(np.maximum(Y, 1.0))
            kind_models[kind] = _LogPoly(
                polyfit.algorithm1(lx, np.zeros_like(lx), ly,
                                   max_degree=2))
            for i in range(len(X)):   # leave-one-out within kind
                mask = np.arange(len(X)) != i
                mi = polyfit.algorithm1(lx[mask], np.zeros_like(lx[mask]),
                                        ly[mask], max_degree=2)
                preds_all.append(10 ** mi.predict(lx[i], 0.0)[0])
                y_all.append(Y[i])
        models[tgt] = _KindModel(kind_models)
        preds_all, y_all = np.array(preds_all), np.array(y_all)
        loo[tgt] = polyfit.error_metrics(y_all, preds_all)
        loo[tgt]["log_mae"] = float(np.mean(np.abs(
            np.log10(np.maximum(preds_all, 1.0))
            - np.log10(np.maximum(y_all, 1.0)))))
    return DSEModel(models, loo)


class _KindModel:
    """Dispatch to the shape-kind-specific log-space fit."""

    def __init__(self, kind_models):
        self.kind_models = kind_models

    def predict(self, x, c, kind="train"):
        m = self.kind_models.get(kind,
                                 next(iter(self.kind_models.values())))
        return m.predict(x, c)


class _LogPoly:
    """Wrap a log-space PolyModel to predict in linear space."""

    def __init__(self, inner):
        self.inner = inner

    def predict(self, x, c):
        lx = np.log10(np.maximum(np.atleast_1d(np.asarray(x, float)), 1.0))
        return 10 ** self.inner.predict(lx, np.zeros_like(lx))
