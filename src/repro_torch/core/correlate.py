"""Pearson correlation analysis (paper §3.3, Table 3).

Port of ``repro.core.correlate`` (numpy already; the port keeps its own
copy).

Correlates (data_bits, coeff_bits) against each resource class per block,
and resources against each other — the step that decides which model family
Algorithm 1 fits (linear-polynomial vs segmented)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.synth import RESOURCES, sweep_arrays


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    sa, sb = np.std(a), np.std(b)
    if sa < 1e-12 or sb < 1e-12:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


def correlation_table(rows: List[dict], block: str) -> Dict:
    """Paper Table 3 analogue for one block: every resource vs the two
    input parameters and vs every other resource."""
    d, c, ys = sweep_arrays(rows, block)
    out = {}
    names = [r for r in RESOURCES if np.std(ys[r]) > 1e-12]
    for r in names:
        entry = {"data_bits": pearson(d, ys[r]),
                 "coeff_bits": pearson(c, ys[r])}
        for r2 in names:
            if r2 == r:
                break
            entry[r2] = pearson(ys[r], ys[r2])
        out[r] = entry
    return out


def choose_model_family(corr_entry: Dict[str, float]) -> str:
    """Paper §3.3: strong linear correlation → plain polynomial; a
    zero/weak correlation with one input (Conv3's packing regime) →
    segmented regression."""
    cd = abs(corr_entry.get("data_bits", 0.0))
    cc = abs(corr_entry.get("coeff_bits", 0.0))
    if min(cd, cc) < 0.3 and max(cd, cc) < 0.65:
        return "segmented"
    return "polynomial"
