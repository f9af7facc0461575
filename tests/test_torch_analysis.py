"""The port's analysis modules on the CPU, held against the JAX
reference: ``core.hloscan``'s tables and its per-device step count,
``core.roofline`` (with the reference's v5e peaks, for parity),
``core.model_dse`` (features, fits and leave-one-out metrics) and
``launch.dryrun``'s cells on fake process groups (a child process
each: a process group is process-global).  Exact, or within 1e-9 for
the fits."""

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_is_runnable as ref_runnable
from repro.configs import get_config as ref_get_config
from repro.core import hloscan as ref_hloscan
from repro.core import model_dse as ref_dse
from repro.core import roofline as ref_roofline
from repro_torch.configs import list_archs
from repro_torch.core import hloscan, model_dse, roofline
from tests.torch_parity import run_ranks

ARCHS = [a for a in list_archs() if a != "paper-conv-sweep"]
CELLS = [(a, s) for a in ARCHS for s in REF_SHAPES
         if ref_runnable(ref_get_config(a), REF_SHAPES[s])[0]]


def test_tables_equal_reference():
    assert hloscan._COLLECTIVE_FACTOR == ref_hloscan._COLLECTIVE_FACTOR
    assert hloscan._DTYPE_BYTES == ref_hloscan._DTYPE_BYTES
    for dtype in hloscan._TORCH_TYPE:
        assert hloscan.dtype_bytes(dtype) == \
            torch.empty((), dtype=dtype).element_size()


def test_collective_bytes_factors():
    ops = [{"op": "all-reduce", "bytes": 256.0},
           {"op": "all-gather", "bytes": 256.0}]
    got = hloscan.collective_bytes(ops)
    assert got["all-reduce"] == 2 * 256
    assert got["all-gather"] == 256
    assert got["total"] == 3 * 256
    assert hloscan.count_collectives(ops) == {"all-reduce": 1,
                                              "all-gather": 1}


def test_analyze_step_counts_one_device(tmp_path):
    """A column-/row-parallel MLP pair, x (64, 128) over 4 data ranks,
    256 hidden over 2 model ranks: each device multiplies (16, 128) by
    (128, 128) and (16, 128) by (128, 128), and all-reduces its (16,
    128) float32 partial sum (ring factor 2)."""
    res = run_ranks("analysis_mlp", 8, tmp_path, backend="fake")[0]
    assert res["flops"] == 2 * (2 * 16 * 128 * 128)
    assert res["coll_all-reduce"] == 2 * 16 * 128 * 4
    assert res["colln_all-reduce"] == 1
    assert res["collective_total"] == res["coll_all-reduce"]
    assert res["memory"]["argument_size_in_bytes"] == \
        (16 * 128 + 128 * 128 + 128 * 128) * 4
    assert res["memory"]["output_size_in_bytes"] == 16 * 128 * 4


def _records(seed=0):
    """Seeded dry-run records of every runnable cell."""
    rng = np.random.default_rng(seed)
    rows = []
    for arch, shape in CELLS:
        cfg = ref_get_config(arch)
        for chips, mesh in ((256, "single"), (512, "multi")):
            rows.append({
                "arch": arch, "shape": shape, "mesh": mesh,
                "n_chips": chips, "status": "ok",
                "params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
                "hlo": {"flops": float(rng.uniform(1e12, 1e15)),
                        "hbm_bytes": float(rng.uniform(1e9, 1e12)),
                        "collective_total": float(rng.uniform(1e6, 1e10))},
                "cost": {"flops": 1.0, "bytes_accessed": 1.0}})
    return rows


def test_roofline_equals_reference():
    for r in _records():
        assert roofline.model_flops(r) == ref_roofline.model_flops(r)
        assert roofline.min_bytes(r) == ref_roofline.min_bytes(r)
        assert roofline.roofline_terms(r, roofline.V5E) == \
            ref_roofline.roofline_terms(r)
    assert (roofline.V5E.flops, roofline.V5E.hbm_bw, roofline.V5E.link_bw) \
        == (ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW,
            ref_roofline.ICI_BW)


@pytest.mark.parametrize("chips", [256, 512])
def test_analytic_features_equal_reference(chips):
    mesh = "single" if chips == 256 else "multi"
    for arch in ARCHS:
        for shape in REF_SHAPES:
            assert model_dse.analytic_features(arch, shape, chips, mesh) == \
                ref_dse.analytic_features(arch, shape, chips, mesh)


def test_fit_dse_equals_reference():
    """A seeded synthetic corpus: the same per-kind fits, predictions and
    leave-one-out metrics."""
    rows = _records(seed=3)
    got, want = model_dse.fit_dse(rows), ref_dse.fit_dse(rows)
    for tgt in want.loo:
        for k, v in want.loo[tgt].items():
            assert abs(got.loo[tgt][k] - v) <= 1e-9 * max(1.0, abs(v)), \
                (tgt, k)
    for arch, shape in CELLS[::5]:
        g, w = got.predict(arch, shape), want.predict(arch, shape)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-9 * max(1.0, abs(w[k])), (k, arch)


def test_dryrun_cells_on_fake_meshes(tmp_path):
    """``lower_cell`` on smoke train, prefill and decode cells of an
    attention-and-MoE model (Qwen3-MoE) and an SSM (Mamba-2) over a fake
    (4, 2) mesh and of the first over (2, 2, 2): every status ok, and
    ``load_corpus`` of either package reads the records back."""
    out = run_ranks("dryrun_cells", 8, tmp_path, backend="fake")[0]
    assert len(out) == 9 and all(v == "ok" for v in out.values()), out
    for tag, n in (("4x2", 6), ("2x2x2", 3)):
        rows = model_dse.load_corpus(tmp_path, tag)
        assert len(rows) == n
        for r in rows:
            assert r["hlo"]["flops"] > 0 and r["hlo"]["hbm_bytes"] > 0
            assert r["n_chips"] == 8
        assert ref_dse.load_corpus(tmp_path, tag) == rows
