"""The whole slice: the port's ``CNNEngine`` serving the committed,
reference-planned quickstart plan at full width, held against the golden
outputs the JAX package wrote and against the reference's ``CNNEngine``
(outputs and ``stats()``), plus the launcher and the copied serving
policy/slot-pool modules."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as ref_deploy
from repro.serve import CNNEngine as RefCNNEngine
from repro.serve import CNNServeConfig as RefCNNServeConfig
from repro.serve import ImageRequest as RefImageRequest
from repro.serve import policy as ref_policy
from repro.serve import slots as ref_slots
from repro_torch import convert, runtime
from repro_torch.core import deploy
from repro_torch.launch import serve as launcher
from repro_torch.serve import (CNNEngine, CNNServeConfig, ImageRequest,
                               policy, slots)

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
PINNED = SRC / "plans" / "quickstart_v5e_conv1_conv3.json"
GOLDEN = SRC / "golden" / "quickstart_reference.npz"
STEM = PINNED.stem


def golden_weights():
    with np.load(GOLDEN) as z:
        return [z[f"{STEM}.w{i}"] for i in range(3)], z[f"{STEM}.x"], \
            z[f"{STEM}.y"]


def port_engine(device, max_batch=4):
    plan = runtime.load_plan(PINNED)
    weights, _, _ = golden_weights()
    params = convert.params_from_numpy(weights, deploy.plan_config(plan),
                                       device)
    return CNNEngine.from_plan(
        plan, params=params, device=device,
        serve_cfg=CNNServeConfig(max_batch=max_batch, aot_warmup=False))


@pytest.fixture(scope="module")
def served():
    """9 requests (steps of 4, 4, 1) through both engines at full
    width, max_batch 4, on the pinned plan with the golden weights."""
    weights, _, _ = golden_weights()
    ref_engine = RefCNNEngine.from_plan(
        ref_deploy.DeploymentPlan.load(PINNED),
        params=[jnp.asarray(w) for w in weights],
        serve_cfg=RefCNNServeConfig(max_batch=4, aot_warmup=False))
    engine = port_engine("cpu")
    images = engine.compiled.sample_inputs(9)
    ref_reqs = [RefImageRequest(image=x, request_id=i)
                for i, x in enumerate(images)]
    reqs = [ImageRequest(image=x, request_id=i)
            for i, x in enumerate(images)]
    ref_engine.run(ref_reqs)
    engine.run(reqs)
    return ref_engine, ref_reqs, engine, reqs


def test_slice_matches_jax_golden(served):
    _, _, engine, reqs = served
    _, gx, gy = golden_weights()
    assert engine.cfg.layers[1].block == "conv1"
    assert np.array_equal(np.stack([r.image for r in reqs[:8]]), gx)
    ys = np.stack([r.output for r in reqs[:8]])
    assert ys.dtype == gy.dtype and np.array_equal(ys, gy)


def test_slice_matches_reference_engine(served):
    ref_engine, ref_reqs, engine, reqs = served
    assert all(r.done for r in reqs)
    for a, b in zip(ref_reqs, reqs):
        assert np.array_equal(np.asarray(a.output), b.output)
    mine, theirs = engine.stats(), ref_engine.stats()
    assert mine == theirs
    assert mine["occupancy_hist"] == {4: 2, 1: 1}
    assert mine["bucket_hits"] == {1: 1, 2: 0, 4: 2}


def test_launcher_serves_on_cpu(capsys):
    engine, reqs, dt = launcher.run_cnn(launcher.parse_args([
        "--workload", "cnn", "--plan", str(PINNED), "--params", str(GOLDEN),
        "--requests", "3", "--max-batch", "2", "--torch-device", "cpu"]))
    out = capsys.readouterr().out
    assert "L1=conv1@d8/c6" in out and "images/s" in out and "on cpu" in out
    assert "occupancy histogram: {1: 1, 2: 1}" in out
    assert all(r.done for r in reqs) and dt > 0
    _, gx, gy = golden_weights()
    assert np.array_equal(np.stack([r.output for r in reqs]), gy[:3])


def test_launcher_params_need_every_layer(tmp_path):
    weights, _, _ = golden_weights()
    np.savez(tmp_path / "two.npz", **{f"{STEM}.w{i}": weights[i]
                                        for i in range(2)})
    with pytest.raises(ValueError,
                       match=rf"no weights for layer 2 \({STEM}\.w2\)"):
        launcher.run_cnn(launcher.parse_args([
            "--plan", str(PINNED), "--params", str(tmp_path / "two.npz"),
            "--torch-device", "cpu"]))


def test_engine_admission_and_pool_rules():
    engine = port_engine("cpu", max_batch=2)
    with pytest.raises(ValueError, match="image shape"):
        engine.submit(ImageRequest(image=np.zeros((4, 4, 1), np.int8)))
    assert engine.step() == 0
    x = engine.compiled.sample_inputs(1)[0]
    assert engine.submit(ImageRequest(image=x))
    assert engine.submit(ImageRequest(image=x))
    assert not engine.submit(ImageRequest(image=x))      # pool full
    assert engine.step() == 2 and engine.images_served == 2
    with pytest.raises(ValueError, match="smaller than the slot pool"):
        CNNEngine(serve_cfg=CNNServeConfig(max_batch=4),
                  compiled=engine.compiled)
    with pytest.raises(ValueError, match="max_batch=0"):
        CNNEngine.from_plan(runtime.load_plan(PINNED), device="cpu",
                            serve_cfg=CNNServeConfig(max_batch=0))


def test_engine_on_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CNNEngine.from_plan(runtime.load_plan(PINNED))
    with pytest.raises(RuntimeError, match="is_available"):
        launcher.run_cnn(launcher.parse_args(["--plan", str(PINNED)]))


def test_policies_match_reference():
    class Req:
        def __init__(self, priority, deadline):
            self.priority, self.deadline = priority, deadline

    reqs = [Req(0, None), Req(1, 5.0), Req(1, 2.0), Req(0, 1.0),
            Req(None, None)]
    for name in ("fifo", "edf", "deadline", None):
        mine, theirs = policy.get_policy(name), ref_policy.get_policy(name)
        assert [mine.key(r, i, 0.0) for i, r in enumerate(reqs)] \
            == [theirs.key(r, i, 0.0) for i, r in enumerate(reqs)]
        assert [reqs.index(r) for r in mine.order(reqs, 0.0)] \
            == [reqs.index(r) for r in theirs.order(reqs, 0.0)]
    assert policy.list_policies() == ref_policy.list_policies()
    assert [policy.expired(r, 3.0) for r in reqs] \
        == [ref_policy.expired(r, 3.0) for r in reqs]
    msgs = []
    for mod in (ref_policy, policy):
        with pytest.raises(ValueError) as e:
            mod.get_policy("lifo")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_slot_pool_telemetry_matches_reference():
    """The same steps on the same injected clock give the same
    histogram, step count and service-rate estimates."""
    def drive(mod):
        t = iter(np.arange(0.0, 10.0, 0.25))
        pool = mod.SlotPool(4, clock=lambda: float(next(t)))
        for live in (4, 1, 9, 0, 3):                  # t = 0 … 1.0
            pool._note_step(live)
        for live, launched in ((2, 1.1), (4, 1.2), (3, 3.0)):
            pool._note_step(live, launched_at=launched)
        return pool
    mine, theirs = drive(slots), drive(ref_slots)
    assert mine.occupancy_hist == theirs.occupancy_hist
    assert mine.steps == theirs.steps
    assert mine.service_rate == theirs.service_rate
    assert mine.service_rate_slow == theirs.service_rate_slow
    a, b = (p.snapshot(clock=lambda: 1.0, served=5).asdict()
            for p in (mine, theirs))
    assert a == b
    msgs = []
    for mod in (ref_slots, slots):
        with pytest.raises(ValueError) as e:
            mod.SlotPool(0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
