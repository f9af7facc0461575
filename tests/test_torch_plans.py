"""The port's plan artifact (``repro_torch.core.deploy`` and
``repro_torch.runtime.plan_io``/``workloads``) held against the
reference's: byte-equal JSON round-trips of the golden fixtures and of
the port's committed plans, the v1 upgrade, and the MoE plan read,
round-tripped and compiled."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import deploy as ref_deploy
from repro_torch import runtime
from repro_torch.core import deploy

TESTS = Path(__file__).parent
PLANS = TESTS.parent / "src" / "repro_torch" / "plans"
FIXTURES = {
    "plan_golden": TESTS / "golden" / "plan_golden.json",
    "plan_v1_golden": TESTS / "golden" / "plan_v1_golden.json",
    "quickstart_v5e": PLANS / "quickstart_v5e.json",
    "quickstart_v5e_conv1_conv3": PLANS / "quickstart_v5e_conv1_conv3.json",
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_to_json_round_trip_is_byte_equal_to_reference(name):
    text = FIXTURES[name].read_text()
    mine = deploy.DeploymentPlan.from_json(text)
    theirs = ref_deploy.DeploymentPlan.from_json(text)
    assert mine.to_json() == theirs.to_json()
    assert deploy.DeploymentPlan.from_json(mine.to_json()) == mine
    if name != "plan_v1_golden":               # v2 files are to_json + \n
        assert mine.to_json() + "\n" == text
    assert dataclasses.asdict(deploy.plan_config(mine)) \
        == dataclasses.asdict(ref_deploy.plan_config(theirs))
    assert mine.block_names() == theirs.block_names()
    assert mine.bits() == theirs.bits()
    assert mine.max_usage_pct == theirs.max_usage_pct


def test_v1_plan_upgrades_to_the_v2_plan():
    v1 = deploy.DeploymentPlan.from_json(FIXTURES["plan_v1_golden"]
                                         .read_text())
    v2 = deploy.DeploymentPlan.from_json(FIXTURES["plan_golden"].read_text())
    assert v1 == v2
    assert deploy.plan_config(v1) == deploy.plan_config(v2)


def test_moe_plan_is_not_yet_ported():
    """The name dates from before the MoE workload was ported: the
    reference's MoE golden plan now loads in the port, its ``to_json()``
    is byte-identical to the file, and it compiles on the CPU."""
    text = (TESTS / "golden" / "plan_moe_golden.json").read_text()
    theirs = ref_deploy.DeploymentPlan.from_json(text)
    mine = deploy.DeploymentPlan.from_json(text)
    assert mine.to_json() + "\n" == text == theirs.to_json() + "\n"
    assert mine.workload.to_payload() == theirs.workload.to_payload()
    compiled = runtime.compile_plan(mine, max_batch=2, device="cpu")
    assert isinstance(compiled, runtime.CompiledMoE)
    assert [(s.data_bits, s.coeff_bits) for s in compiled.spec.layers] \
        == mine.bits() == [(8, 8), (6, 4)]
    y = compiled(np.stack(compiled.sample_inputs(3, seed=0)))
    assert tuple(y.shape) == (3,) + compiled.in_shape
    assert bool(torch.isfinite(y).all())


def test_unknown_schema_and_kind_raise_like_reference():
    text = FIXTURES["plan_golden"].read_text()
    bad = text.replace('"version": 2', '"version": 99')
    msgs = []
    for mod in (ref_deploy, deploy):
        with pytest.raises(ValueError) as e:
            mod.DeploymentPlan.from_json(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    bad = text.replace('"kind": "cnn"', '"kind": "rnn"')
    for mod in (ref_deploy, deploy):        # the registered lists differ
        with pytest.raises(ValueError, match="unknown workload kind 'rnn'"):
            mod.DeploymentPlan.from_json(bad)


def test_plan_config_without_network_raises():
    plan = deploy.DeploymentPlan.from_json(
        FIXTURES["plan_golden"].read_text())
    plan.cnn = None
    with pytest.raises(ValueError, match="no CNNConfig"):
        deploy.plan_config(plan)


def test_plan_io_save_load_round_trip(tmp_path):
    plan = runtime.load_plan(FIXTURES["quickstart_v5e_conv1_conv3"])
    path = runtime.save_plan(plan, tmp_path / "sub" / "plan.json")
    assert runtime.load_plan(path) == plan
    assert path.read_text() == plan.to_json()
    assert [p.name for p in path.parent.iterdir()] == ["plan.json"]
    saved = plan.save(tmp_path / "again.json")
    assert saved.read_text() == FIXTURES[
        "quickstart_v5e_conv1_conv3"].read_text()


def test_workload_registry():
    assert runtime.list_workloads() == ["cnn", "moe"]
    assert runtime.get_workload("cnn") is runtime.CNNWorkloadSpec
    assert runtime.get_workload("moe") is runtime.MoEWorkloadSpec
    with pytest.raises(ValueError, match="unknown workload kind"):
        runtime.get_workload("rnn")
    plan = runtime.load_plan(FIXTURES["quickstart_v5e"])
    spec = runtime.workload_spec(plan)
    assert spec.cnn == plan.cnn
    assert runtime.CNNWorkloadSpec.from_payload(spec.to_payload()) == spec
    plan.cnn = None
    with pytest.raises(ValueError, match="neither a workload spec"):
        runtime.workload_spec(plan)
