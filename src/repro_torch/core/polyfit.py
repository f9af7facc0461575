"""Algorithm 1 (paper §3.4): polynomial resource models with term pruning.

Port of ``repro.core.polyfit`` (numpy and scipy already; the port keeps
its own copy).

For each (block, resource): fit bivariate polynomials of degree 1..4 in
(data_bits, coeff_bits); keep — exactly as the paper's pseudocode — the
*lowest* R² that still clears the 0.9 gate (the least-overfitting model
above threshold); drop statistically insignificant terms (OLS t-test) and
keep the pruned model if its R² stays ≥ 0.9.

Conv3 gets the paper's segmented regression: one polynomial per packing
regime (data_bits + coeff_bits ≤ 12 → packed dual-conv; else two-dot
fallback), matching its zero Pearson correlation with data size.

Validation metrics (paper §4.1): MSE (EQM), MAE (EAM), R², MAPE (EAMP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import stats


def _terms(degree: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(degree + 1) for j in range(degree + 1)
            if i + j <= degree]


def _design(d: np.ndarray, c: np.ndarray,
             terms: List[Tuple[int, int]]) -> np.ndarray:
    return np.stack([(d ** i) * (c ** j) for i, j in terms], axis=1)


@dataclass
class PolyModel:
    terms: List[Tuple[int, int]]
    coefs: np.ndarray
    degree: int
    r2: float

    def predict(self, d, c):
        d = np.asarray(d, float)
        c = np.asarray(c, float)
        return _design(np.atleast_1d(d), np.atleast_1d(c),
                       self.terms) @ self.coefs

    def formula(self, target: str = "y") -> str:
        parts = []
        for (i, j), co in zip(self.terms, self.coefs):
            t = f"{co:+.4g}"
            if i:
                t += f"·d{'^' + str(i) if i > 1 else ''}"
            if j:
                t += f"·c{'^' + str(j) if j > 1 else ''}"
            parts.append(t)
        return f"{target} = " + " ".join(parts)


# Segment schemes: known hardware regime boundaries (the paper segments
# Conv3 at its 8-bit DSP-packing limit; our TPU analogues are the int8/int16
# container boundary and the int32-accumulator packing budget d+c ≤ 12).
def _container_seg(d, c):
    return (d > 8).astype(int) * 2 + (c > 8).astype(int)


def _pack_seg(d, c):
    return np.where((d + c) <= 12, 0, 1 + _container_seg(d, c))


SCHEMES = {"container": _container_seg, "pack": _pack_seg}


@dataclass
class SegmentedModel:
    """Piecewise polynomial split at hardware regime boundaries."""
    scheme: str
    models: Dict[int, PolyModel]
    r2: float = 0.0

    def predict(self, d, c):
        d = np.atleast_1d(np.asarray(d, float))
        c = np.atleast_1d(np.asarray(c, float))
        seg = SCHEMES[self.scheme](d, c)
        out = np.empty_like(d)
        default = next(iter(self.models.values()))
        for s in np.unique(seg):
            m = self.models.get(int(s), default)
            mask = seg == s
            out[mask] = m.predict(d[mask], c[mask])
        return out


def r_squared(y, yhat) -> float:
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    if ss_tot < 1e-12:
        return 1.0 if ss_res < 1e-9 else 0.0
    return 1.0 - ss_res / ss_tot


def fit_poly(d, c, y, degree: int,
             terms: Optional[List[Tuple[int, int]]] = None) -> PolyModel:
    terms = terms if terms is not None else _terms(degree)
    X = _design(d, c, terms)
    coefs, *_ = np.linalg.lstsq(X, y, rcond=None)
    return PolyModel(terms, coefs, degree, r_squared(y, X @ coefs))


def prune_insignificant(model: PolyModel, d, c, y,
                        alpha: float = 0.05) -> PolyModel:
    """Drop terms whose OLS t-test p-value exceeds alpha, then refit.
    The intercept is always kept."""
    X = _design(d, c, model.terms)
    n, k = X.shape
    if n <= k:
        return model
    resid = y - X @ model.coefs
    dof = n - k
    sigma2 = float(resid @ resid) / max(dof, 1)
    xtx_inv = np.linalg.pinv(X.T @ X)
    se = np.sqrt(np.maximum(np.diag(xtx_inv) * sigma2, 1e-30))
    tvals = model.coefs / se
    pvals = 2 * (1 - stats.t.cdf(np.abs(tvals), dof))
    keep = [t for t, p in zip(model.terms, pvals)
            if p <= alpha or t == (0, 0)]
    if len(keep) == len(model.terms) or not keep:
        return model
    return fit_poly(d, c, y, model.degree, terms=keep)


def algorithm1(d, c, y, *, r2_gate: float = 0.9,
               max_degree: int = 4) -> PolyModel:
    """Paper Algorithm 1, verbatim: among degrees 1..4, keep the model with
    the smallest R² that is still ≥ the 0.9 gate; prune insignificant
    terms; keep the pruned model if it stays above the gate.  Falls back to
    the best-R² model when nothing clears the gate."""
    best: Optional[PolyModel] = None
    best_r2 = 1.0 + 1e-9
    fallback: Optional[PolyModel] = None
    for degree in range(1, max_degree + 1):
        m = fit_poly(d, c, y, degree)
        if fallback is None or m.r2 > fallback.r2:
            fallback = m
        if r2_gate <= m.r2 < best_r2:
            best, best_r2 = m, m.r2
    if best is None:
        best = fallback
    pruned = prune_insignificant(best, d, c, y)
    if pruned.r2 >= r2_gate:
        best = pruned
    return best


def fit_segmented(d, c, y, scheme: str = "container", **kw) -> SegmentedModel:
    seg_ids = SCHEMES[scheme](d, c)
    models = {}
    for s in np.unique(seg_ids):
        mask = seg_ids == s
        models[int(s)] = algorithm1(d[mask], c[mask], y[mask], **kw)
    seg = SegmentedModel(scheme, models)
    seg.r2 = r_squared(y, seg.predict(d, c))
    return seg


def fit_auto(d, c, y, *, block: str = "", r2_gate: float = 0.9):
    """The paper's end-to-end model choice: plain polynomial when it clears
    the R² gate, otherwise segmented at the block's regime boundaries."""
    m = algorithm1(d, c, y, r2_gate=r2_gate)
    if m.r2 >= r2_gate:
        return m
    scheme = "pack" if block == "conv3" else "container"
    return fit_segmented(d, c, y, scheme=scheme, r2_gate=r2_gate)


def error_metrics(y, yhat) -> Dict[str, float]:
    err = y - yhat
    nz = np.abs(y) > 1e-9
    mape = float(np.mean(np.abs(err[nz] / y[nz])) * 100) if nz.any() else 0.0
    return {"mse": float(np.mean(err ** 2)),
            "mae": float(np.mean(np.abs(err))),
            "r2": r_squared(y, yhat),
            "mape_pct": mape}
