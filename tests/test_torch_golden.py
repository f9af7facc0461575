"""Provenance of the port's committed plans and golden outputs.

``src/repro_torch/plans/`` holds two plans of the quickstart CNN, both
written by the reference's planner (``deploy.plan_deployment(...,
allocate.get_device("v5e"), target=0.8, on_infeasible="fallback")``):

* ``quickstart_v5e.json``             — the unpinned plan;
* ``quickstart_v5e_conv1_conv3.json`` — layer 1 pinned to conv1 and
  layer 2 to conv3, so the serving path runs all three layer kernels
  (conv4 → fused dot, conv1 → shift-add, conv3 at d6c4 → packed dot).

``src/repro_torch/golden/quickstart_reference.npz`` holds, per plan, the
reference runtime's weights (``init_cnn(PRNGKey(0), cfg)``), the 8
images of ``CompiledCNN.sample_inputs(8, seed=0)`` and the reference
``CompiledCNN``'s outputs for them: the card is held against the JAX
package through this file, without importing it.

Regenerate both (the planner runs the resource sweep, about a minute
without its cache):

    PYTHONPATH=src python tests/test_torch_golden.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro.core import allocate, deploy
from repro.core.cnn import fitted_block_models, quickstart_cnn_config
from repro.runtime import CompiledCNN

ROOT = Path(__file__).resolve().parents[1]
PLANS = ROOT / "src" / "repro_torch" / "plans"
GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "quickstart_reference.npz"

# plan file stem → the layer pins it was planned with
PINS = {"quickstart_v5e": {},
        "quickstart_v5e_conv1_conv3": {1: "conv1", 2: "conv3"}}
# the (block, data_bits, coeff_bits) each committed plan assigns
ASSIGNED = {
    "quickstart_v5e": [("conv4", 8, 6), ("conv3", 8, 6), ("conv4", 6, 4)],
    "quickstart_v5e_conv1_conv3": [("conv4", 8, 6), ("conv1", 8, 6),
                                   ("conv3", 6, 4)],
}


def pinned_config(pins):
    cfg = quickstart_cnn_config()
    layers = tuple(dataclasses.replace(s, block=pins.get(i))
                   for i, s in enumerate(cfg.layers))
    return dataclasses.replace(cfg, layers=layers)


def reference_plan(stem):
    """The plan the reference's planner writes for ``stem``."""
    return deploy.plan_deployment(
        pinned_config(PINS[stem]), fitted_block_models(),
        allocate.get_device("v5e"), target=0.8, on_infeasible="fallback")


def reference_golden(plans):
    """Arrays of the golden npz for ``{stem: plan}``, computed by the
    reference runtime."""
    arrays = {}
    for stem, plan in plans.items():
        cnn = CompiledCNN.from_plan(plan, max_batch=8, warmup=False)
        xs = np.stack(cnn.sample_inputs(8, seed=0))
        for i, w in enumerate(cnn.params):
            arrays[f"{stem}.w{i}"] = np.asarray(w)
        arrays[f"{stem}.x"] = xs
        arrays[f"{stem}.y"] = np.asarray(cnn(xs))
    return arrays


def committed_plans():
    return {stem: deploy.DeploymentPlan.load(PLANS / f"{stem}.json")
            for stem in PINS}


def test_committed_plans_embed_quickstart_with_pins():
    for stem, plan in committed_plans().items():
        assert plan.cnn == pinned_config(PINS[stem])
        assert plan.device.name == "v5e" and plan.target == 0.8
        assert [(a.block, a.data_bits, a.coeff_bits)
                for a in plan.layers] == ASSIGNED[stem]
        # the planner's budget verdict with on_infeasible="fallback"
        assert plan.feasible is False


def test_golden_npz_rebuilds_from_committed_plans():
    want = reference_golden(committed_plans())
    with np.load(GOLDEN) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            assert np.array_equal(got[k], v), k


@pytest.mark.sweep
def test_committed_plans_match_reference_planner():
    for stem in PINS:
        text = (PLANS / f"{stem}.json").read_text()
        assert reference_plan(stem).to_json() + "\n" == text, stem


def main():
    plans = {stem: reference_plan(stem) for stem in PINS}
    PLANS.mkdir(parents=True, exist_ok=True)
    for stem, plan in plans.items():
        plan.save(PLANS / f"{stem}.json")
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **reference_golden(plans))
    print(f"wrote {len(plans)} plans to {PLANS} and {GOLDEN} "
          f"({GOLDEN.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
