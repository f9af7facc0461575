"""The port's planner held against the reference's: the op census
(``repro_torch.core.census``) against the reference's jaxpr census rows,
and the planner's arithmetic — fits, allocation, plans, Pareto frontier,
device selection, the float oracle — fed the reference's own rows
(``src/repro_torch/golden/synth_reference.json``).

The census owes the reference exact values for the columns that follow
from shapes and dtypes (``mxu_flops``, ``mxu_cost``, ``hbm_bytes``,
``vmem_bytes``, ``convs_per_step``, ``packed``) and the same shape over
the design grid for the op counts (``vpu_ops``, ``add_chain``,
``mem_move_bytes``, ``temp_bytes``): the same model family and segment
scheme per block and resource, and Conv1's ``vpu_ops`` ∝ coeff_bits
with its steps where the reference's step."""

import dataclasses
import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocate as ref_allocate
from repro.core import correlate as ref_correlate
from repro.core import deploy as ref_deploy
from repro.core import polyfit as ref_polyfit
from repro.core.cnn import quickstart_cnn_config as ref_quickstart
from repro_torch.configs.paper_conv import REDUCED_SWEEP, SWEEP
from repro_torch.core import (allocate, census, cnn, correlate, deploy,
                              polyfit, synth)
from test_torch_golden import PLANS, SYNTH_GOLDEN, SYNTH_REFERENCE

EXACT = ("mxu_flops", "mxu_cost", "hbm_bytes", "vmem_bytes",
         "convs_per_step", "packed")
DEVICES = ("edge", "v5e", "v5p")


def reference_rows():
    return json.loads(SYNTH_REFERENCE.read_text())["rows"]


def _key(r):
    return r["block"], r["data_bits"], r["coeff_bits"]


@pytest.fixture(scope="module")
def ref_rows():
    return reference_rows()


@pytest.mark.parametrize("i", range(6), ids=lambda i: f"row{i}")
def test_census_equals_reference_golden_rows(i):
    want = json.loads(SYNTH_GOLDEN.read_text())["rows"][i]
    got = synth.synth_one(want["block"], want["data_bits"],
                          want["coeff_bits"], SWEEP)
    for k in EXACT:
        assert got[k] == want[k], (_key(want), k)


def test_census_counts_one_tile_times_the_grid():
    """The rate columns scale with the grid exactly; the staged working
    set is the padded plane, the weights and one output tile."""
    one = census.block_resources("conv3", 16, 128, data_bits=6,
                                 coeff_bits=6)
    four = census.block_resources("conv3", 64, 128, data_bits=6,
                                  coeff_bits=6)
    for k in ("vpu_ops", "add_chain", "mxu_flops", "mxu_cost"):
        assert four[k] == 4 * one[k] > 0, k
    assert four["pallas_vmem_bytes"] == 66 * 130 + 18 + 2 * 16 * 128 * 4
    assert four["hbm_bytes"] == 64 * 128 + 18 + 2 * 64 * 128 * 4
    with pytest.raises(ValueError, match="not divisible by tile_h=16"):
        census.block_resources("conv2", 24, 128, data_bits=6, coeff_bits=6)


def model_shapes(rows, blocks):
    """(model family, fit_auto's scheme) per (block, resource), by the
    reference's own correlate and polyfit."""
    out = {}
    for b in blocks:
        table = ref_correlate.correlation_table(rows, b)
        d, c, ys = synth.sweep_arrays(rows, b)
        for r in synth.RESOURCES:
            fam = ref_correlate.choose_model_family(table[r]) \
                if r in table else "constant"
            m = ref_polyfit.fit_auto(d, c, ys[r], block=b)
            out[(b, r)] = (fam, getattr(m, "scheme", "polynomial"))
    return out


def test_census_model_shapes_match_reference_reduced(tmp_path, ref_rows):
    cfg = REDUCED_SWEEP
    rows = synth.run_sweep(cfg, cache_path=tmp_path / "synth.json")
    grid = {(b, d, c) for b in cfg.blocks for d in cfg.data_bits
            for c in cfg.coeff_bits}
    ref_sel = [r for r in ref_rows if _key(r) in grid]
    assert {_key(r) for r in rows} == grid
    assert model_shapes(rows, cfg.blocks) == model_shapes(ref_sel,
                                                          cfg.blocks)


@pytest.mark.sweep
def test_census_matches_reference_full_sweep(tmp_path, ref_rows):
    rows = synth.run_sweep(SWEEP, cache_path=tmp_path / "synth.json")
    by_key = {_key(r): r for r in ref_rows}
    for r in rows:
        for k in EXACT:
            assert r[k] == by_key[_key(r)][k], (_key(r), k)
    assert model_shapes(rows, SWEEP.blocks) \
        == model_shapes(ref_rows, SWEEP.blocks)


def _conv1_vpu(points):
    return {(d, c): synth.synth_one("conv1", d, c)["vpu_ops"]
            for d, c in points}


def _steps_along_d(vpu, c, ds):
    return [d for d in ds[:-1] if vpu[(d + 1, c)] != vpu[(d, c)]]


def _whole_op_steps_along_d(vpu, c, ds):
    # the reference's rows also step by a fraction of one op (0.25 or
    # 0.5) at the container boundary: its ``jnp.pad`` converts the fill
    # value into the container, an operation aten's ``constant_pad_nd``
    # does not expose
    return [d for d in ds[:-1] if abs(vpu[(d + 1, c)] - vpu[(d, c)]) >= 1]


@pytest.mark.parametrize("fixed_c", [3, 5, 8])
def test_conv1_vpu_steps_where_reference_steps(fixed_c, ref_rows):
    """At fixed coeff_bits, Conv1's vpu_ops changes along data_bits
    exactly where the reference's changes by whole ops: the int16/int32
    accumulator boundary (d+c+5 = 16/17), which at c = 3 is the 8/9-bit
    container boundary."""
    ds = list(range(3, 17))
    mine = _conv1_vpu([(d, fixed_c) for d in ds])
    ref = {(r["data_bits"], r["coeff_bits"]): r["vpu_ops"]
           for r in ref_rows if r["block"] == "conv1"}
    assert _steps_along_d(mine, fixed_c, ds) \
        == _whole_op_steps_along_d(ref, fixed_c, ds) \
        == [16 - 5 - fixed_c]
    assert set(_steps_along_d(ref, fixed_c, ds)) \
        <= set(_steps_along_d(mine, fixed_c, ds)) | {8}


@pytest.mark.parametrize("fixed_d", [3, 8, 9])
def test_conv1_vpu_grows_with_coeff_bits_like_reference(fixed_d, ref_rows):
    """At fixed data_bits, Conv1's vpu_ops grows with coeff_bits (one
    masked shift-add per coefficient bit), linearly within an
    accumulator regime, and its slope changes where the reference's
    does."""
    cs = list(range(3, 17))
    mine = _conv1_vpu([(fixed_d, c) for c in cs])
    ref = {(r["data_bits"], r["coeff_bits"]): r["vpu_ops"]
           for r in ref_rows if r["block"] == "conv1"}

    def kinks(v):
        return [c for c in cs[1:-1] if v[(fixed_d, c + 1)] - v[(fixed_d, c)]
                != v[(fixed_d, c)] - v[(fixed_d, c - 1)]]

    assert all(mine[(fixed_d, c + 1)] > mine[(fixed_d, c)] for c in cs[:-1])
    assert kinks(mine) == kinks(ref)


def test_fits_on_reference_rows_match_reference(ref_rows):
    """correlate and polyfit, fed the reference's rows: the same
    correlation table, model family, scheme, terms and coefficients
    (rtol 1e-12)."""
    for b in SWEEP.blocks:
        table = correlate.correlation_table(ref_rows, b)
        assert table == ref_correlate.correlation_table(ref_rows, b)
        for r in table:
            assert correlate.choose_model_family(table[r]) \
                == ref_correlate.choose_model_family(table[r])
        d, c, ys = synth.sweep_arrays(ref_rows, b)
        for r in synth.RESOURCES:
            mine = polyfit.fit_auto(d, c, ys[r], block=b)
            theirs = ref_polyfit.fit_auto(d, c, ys[r], block=b)
            pairs = [(mine, theirs)]
            if isinstance(theirs, ref_polyfit.SegmentedModel):
                assert mine.scheme == theirs.scheme
                assert sorted(mine.models) == sorted(theirs.models)
                pairs = [(mine.models[s], theirs.models[s])
                         for s in theirs.models]
            for m, t in pairs:
                assert m.terms == t.terms and m.degree == t.degree, (b, r)
                np.testing.assert_allclose(m.coefs, t.coefs, rtol=1e-12,
                                           atol=0)


@pytest.fixture(scope="module")
def both_models(ref_rows):
    return (allocate.BlockModels.fit(ref_rows),
            ref_allocate.BlockModels.fit(ref_rows))


def _layers(plan):
    return [(a.block, a.data_bits, a.coeff_bits) for a in plan.layers]


@pytest.mark.parametrize("dev", DEVICES)
def test_planner_on_reference_rows_writes_reference_plans(dev, both_models):
    bm, ref_bm = both_models
    cfg, ref_cfg = cnn.quickstart_cnn_config(), ref_quickstart()
    for kw in (dict(), dict(bit_candidates=deploy.DEFAULT_BIT_CANDIDATES)):
        mine = deploy.plan_deployment(cfg, bm, allocate.get_device(dev),
                                      target=0.8, on_infeasible="fallback",
                                      **kw)
        theirs = ref_deploy.plan_deployment(
            ref_cfg, ref_bm, ref_allocate.get_device(dev), target=0.8,
            on_infeasible="fallback", **kw)
        assert mine.to_json() == theirs.to_json()
    assert deploy.DEFAULT_BIT_CANDIDATES == ref_deploy.DEFAULT_BIT_CANDIDATES
    alloc = allocate.allocate(bm, data_bits=8, coeff_bits=6,
                              budgets=allocate.get_device(dev))
    ref_alloc = ref_allocate.allocate(ref_bm, data_bits=8, coeff_bits=6,
                                      budgets=ref_allocate.get_device(dev))
    assert dataclasses.asdict(alloc) == dataclasses.asdict(ref_alloc)


def test_v5e_plan_on_reference_rows_is_the_committed_plan(both_models):
    bm, _ = both_models
    plan = deploy.plan_deployment(cnn.quickstart_cnn_config(), bm,
                                  allocate.get_device("v5e"), target=0.8,
                                  on_infeasible="fallback")
    assert plan.to_json() + "\n" \
        == (PLANS / "quickstart_v5e.json").read_text()


def test_frontier_and_device_selection_match_reference(both_models):
    """Without the quantization error (null on both sides: the two
    frameworks draw different weights) the frontier and the cheapest
    fitting part are the reference's, plan for plan."""
    bm, ref_bm = both_models
    cfg, ref_cfg = cnn.quickstart_cnn_config(), ref_quickstart()
    mine = deploy.pareto_frontier(cfg, bm, measure_error=False)
    theirs = ref_deploy.pareto_frontier(ref_cfg, ref_bm,
                                        measure_error=False)
    assert [p.to_json() for p in mine] == [p.to_json() for p in theirs]
    for kw in (dict(), dict(bit_candidates=((4, 4), (6, 4)))):
        dev, plan = deploy.select_device(cfg, bm, **kw)
        ref_dev, ref_plan = ref_deploy.select_device(ref_cfg, ref_bm, **kw)
        assert dev.name == ref_dev.name
        assert plan.to_json() == ref_plan.to_json()
    small = dataclasses.replace(cfg, img_h=16, img_w=16)
    with pytest.raises(deploy.DeploymentError, match="no device"):
        deploy.select_device(small, bm, catalog=[allocate.get_device(
            "edge")], target=1e-9)


def test_float_forward_matches_reference_on_carried_weights():
    cfg = dataclasses.replace(cnn.quickstart_cnn_config(), img_h=16,
                              img_w=24)
    ref_cfg = dataclasses.replace(ref_quickstart(), img_h=16, img_w=24)
    rng = np.random.default_rng(4)
    weights = [rng.standard_normal((s.out_channels, s.in_channels, 3, 3))
               .astype(np.float32) * 2.0 ** (s.coeff_bits - 2) / 3.0
               for s in cfg.layers]
    x = rng.uniform(0, 127, (16, 24, 1)).astype(np.float32)
    want = np.asarray(ref_deploy._float_forward(
        [jnp.asarray(w) for w in weights], jnp.asarray(x), ref_cfg))
    got = deploy._float_forward([torch.from_numpy(w) for w in weights],
                                torch.from_numpy(x), cfg).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 *
                               np.abs(want).max())


def test_quantization_error_is_a_relative_rmse():
    cfg = dataclasses.replace(cnn.quickstart_cnn_config(), img_h=16,
                              img_w=16)
    g = torch.Generator().manual_seed(1)
    err = deploy.quantization_error(cfg, generator=g)
    assert 0.0 <= err <= 1.0 + 1e-9
    assert err == deploy.quantization_error(
        cfg, generator=torch.Generator().manual_seed(1))


def test_validate_plan_on_own_reduced_sweep(tmp_path):
    """The launcher's loop on the CPU: the port's own (reduced) sweep →
    fitted models → a v5e plan → ``validate_plan``: bit-exact against
    the oracle, and the census at the deployed geometry within 2 % MAPE
    of the models' prediction on every budgeted resource."""
    rows = synth.run_sweep(REDUCED_SWEEP, cache_path=tmp_path / "s.json")
    bm = cnn.fitted_block_models(rows)
    cfg = cnn.quickstart_cnn_config()
    plan = deploy.plan_deployment(cfg, bm, allocate.get_device("v5e"),
                                  target=0.8, on_infeasible="fallback")
    val = deploy.validate_plan(plan, cfg, device="cpu")
    assert val.bit_exact
    for r in allocate.BUDGET_RESOURCES:
        assert val.metrics[r]["mape_pct"] < 2.0, (r, val.metrics[r])
    assert set(val.predicted) == set(allocate.BUDGET_RESOURCES)
    assert 0.0 <= val.quant_error


def test_fitted_block_models_memoizes_the_default_sweep(tmp_path,
                                                         monkeypatch):
    calls = []
    run_sweep = synth.run_sweep

    def fake_sweep():
        calls.append(1)
        return run_sweep(REDUCED_SWEEP, cache_path=tmp_path / "synth.json")

    monkeypatch.setattr(synth, "run_sweep", fake_sweep)
    cnn.clear_fitted_model_cache()
    try:
        bm = cnn.fitted_block_models()
        assert cnn.fitted_block_models() is bm and calls == [1]
        blocks = cnn.choose_blocks(cnn.quickstart_cnn_config())
        assert [b.name for b in blocks] == ["conv4", "conv4", "conv4"]
    finally:
        cnn.clear_fitted_model_cache()


def test_sweep_cache_is_versioned_and_lives_under_build(tmp_path):
    assert synth.DEFAULT_CACHE.parent == synth.build.BUILD_DIR
    cfg = dataclasses.replace(REDUCED_SWEEP, blocks=("conv2",),
                              data_bits=(4,), coeff_bits=(4, 9))
    path = tmp_path / "synth.json"
    rows = synth.run_sweep(cfg, cache_path=path)
    payload = json.loads(path.read_text())
    assert payload["version"] == synth.SWEEP_SCHEMA_VERSION
    assert payload["rows"] == rows and len(rows) == 2
    path.write_text(json.dumps({"version": 2, "rows": []}))   # foreign
    assert synth.run_sweep(cfg, cache_path=path) == rows


def test_device_catalog_and_lookup_match_reference():
    for mine, theirs in itertools.zip_longest(
            allocate.DEVICE_CATALOG, ref_allocate.DEVICE_CATALOG):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert deploy.device_profile("v5p").name == "v5p"
    msgs = []
    for mod in (deploy, ref_deploy):
        with pytest.raises(mod.DeploymentError) as e:
            mod.device_profile("h100")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert synth.fpga_name("vpu_ops") == "LLUT"
