"""The port's quantized MoE workload (the MoE half of
``repro_torch.runtime.workloads``) held against the reference's: twins
of ``tests/test_workloads.py``'s MoE tests (registry, plan lifecycle,
bucketed compile, sync engine, gateway beside a CNN plan, mixed fleet,
config bridge); the planner field for field and the demand model
exactly; ``CompiledMoE`` against the reference's ``CompiledMoE`` on the
reference's weights at every bucket, layer by layer and end to end; the
committed golden file; and the launcher's ``--workload moe``, sync and
``--async``."""

import asyncio
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.core import deploy as ref_deploy
from repro.runtime import workloads as ref_wl
from repro_torch import convert
from repro_torch import runtime
from repro_torch.configs import smoke_config
from repro_torch.core.deploy import (DeploymentError, DeploymentPlan,
                                     plan_config)
from repro_torch.launch import serve as launcher
from repro_torch.ops import PersistentExecutableCache, PlanStore
from repro_torch.runtime.compiled import CompiledCNN
from repro_torch.runtime.workloads import (CNNWorkloadSpec, CompiledMoE,
                                           MoELayerSpec, MoEWorkloadSpec,
                                           WorkloadSpec, _dense_ref_forward,
                                           _eager_forward, _fake_quant,
                                           compile_plan, fake_quant_flips,
                                           get_workload,
                                           list_workloads, moe_layer_demand,
                                           moe_plan_spec,
                                           moe_workload_from_config,
                                           plan_moe_deployment,
                                           register_workload,
                                           validate_moe_plan, workload_spec)
from repro_torch.serve import (AsyncCNNGateway, AsyncServeConfig, CNNEngine,
                               CNNServeConfig, ImageRequest)
from torch_parity import dispatch_trace

ROOT = Path(__file__).resolve().parents[1]
QUICKSTART = ROOT / "src" / "repro_torch" / "plans" / "quickstart_v5e.json"
MOE_GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "moe_reference.npz"
TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_moe_spec(module=None, n_layers=2, **kw):
    """``tests/test_workloads.py``'s tiny spec, in the port (or in
    ``module``, the reference's workloads)."""
    m = module or runtime.workloads
    layer = m.MoELayerSpec(d_ff_expert=16, num_experts=4, top_k=2, **kw)
    return m.MoEWorkloadSpec(layers=(layer,) * n_layers, d_model=8,
                             seq_len=8)


def _plan(**kw):
    return plan_moe_deployment(tiny_moe_spec(**kw), "v5e")


def _cnn_plan():
    """A committed plan of the quickstart CNN (K1 on the card)."""
    return runtime.load_plan(QUICKSTART)


def _drop_quant_error(text):
    payload = json.loads(text)
    payload.pop("quant_error")
    return payload


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_builtin_kinds_registered():
    assert list_workloads() == ["cnn", "moe"] == ref_wl.list_workloads()
    assert get_workload("cnn") is CNNWorkloadSpec
    assert get_workload("moe") is MoEWorkloadSpec


def test_unknown_kind_lists_registered():
    with pytest.raises(ValueError, match="cnn.*moe"):
        get_workload("ssm")


def test_reregistering_kind_rejected():
    with pytest.raises(ValueError, match="already registered"):
        @register_workload
        class Impostor(WorkloadSpec):
            kind = "moe"


def test_abstract_kind_rejected():
    with pytest.raises(ValueError, match="concrete kind"):
        @register_workload
        class NoKind(WorkloadSpec):
            pass


def test_workload_spec_wraps_cnn_plans():
    plan = _cnn_plan()
    spec = workload_spec(plan)
    assert isinstance(spec, CNNWorkloadSpec)
    assert spec.cnn == plan.cnn


# ---------------------------------------------------------------------------
# the planner against the reference's
# ---------------------------------------------------------------------------

# (d_ff_expert, experts, top_k, shared, cf, d_model, seq_len, layers)
SPECS = {
    "tiny": (16, 4, 2, 0, 2.0, 8, 8, 2),
    "shared": (16, 4, 1, 1, 1.5, 8, 8, 3),
    "wide": (128, 8, 2, 0, 2.0, 64, 32, 1),
    "qwen3-smoke": (64, 4, 2, 0, 2.0, 64, 32, 2),
}


def _specs(name):
    fe, e, k, sh, cf, d, s, n = SPECS[name]
    out = []
    for m in (runtime.workloads, ref_wl):
        layer = m.MoELayerSpec(d_ff_expert=fe, num_experts=e, top_k=k,
                               n_shared_experts=sh, capacity_factor=cf)
        out.append(m.MoEWorkloadSpec(layers=(layer,) * n, d_model=d,
                                     seq_len=s))
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("device", ["edge", "v5e", "v5p"])
@pytest.mark.parametrize("on_infeasible", ["raise", "fallback"])
def test_plan_moe_deployment_equals_reference(name, device, on_infeasible):
    """Layers, bits, demand, usage, feasibility and the embedded spec
    equal the reference planner's, field for field; ``quant_error`` is
    the port's own draw; an infeasible plan raises the same message."""
    spec, ref_spec = _specs(name)
    try:
        want = ref_wl.plan_moe_deployment(ref_spec, device,
                                          on_infeasible=on_infeasible)
    except ref_deploy.DeploymentError as e:
        with pytest.raises(DeploymentError) as got:
            plan_moe_deployment(spec, device, on_infeasible=on_infeasible)
        assert str(got.value) == str(e)
        return
    got = plan_moe_deployment(spec, device, on_infeasible=on_infeasible)
    assert _drop_quant_error(got.to_json()) \
        == _drop_quant_error(want.to_json())
    assert got.workload == MoEWorkloadSpec.from_payload(
        want.workload.to_payload())
    assert 0 < got.quant_error < 1


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("bits", [(4, 4), (8, 6), (12, 10), (16, 16)])
def test_moe_layer_demand_equals_reference(name, bits):
    spec, ref_spec = _specs(name)
    got = moe_layer_demand(spec, spec.layers[0], *bits)
    want = ref_wl.moe_layer_demand(ref_spec, ref_spec.layers[0], *bits)
    assert got == want
    assert all(type(v) is float for v in got.values())


def test_plan_moe_deployment_pins_bits_and_takes_budget_mappings():
    spec, ref_spec = _specs("shared")
    budgets = {"mxu_cost": 1e5, "hbm_bytes": 1e4, "vpu_ops": 1e4,
               "vmem_bytes": 1e6}
    for kw in ({"bit_candidates": None}, {}):
        got = plan_moe_deployment(spec, budgets, on_infeasible="fallback",
                                  **kw)
        want = ref_wl.plan_moe_deployment(ref_spec, budgets,
                                          on_infeasible="fallback", **kw)
        assert _drop_quant_error(got.to_json()) \
            == _drop_quant_error(want.to_json())
    with pytest.raises(ValueError, match="on_infeasible"):
        plan_moe_deployment(spec, "v5e", on_infeasible="skip")


def test_moe_layer_spec_validation():
    with pytest.raises(ValueError, match="top_k"):
        MoELayerSpec(d_ff_expert=8, num_experts=4, top_k=5)
    with pytest.raises(ValueError, match="data_bits"):
        MoELayerSpec(d_ff_expert=8, num_experts=4, top_k=2, data_bits=1)
    with pytest.raises(ValueError, match="at least one layer"):
        MoEWorkloadSpec(layers=(), d_model=8)
    with pytest.raises(ValueError, match="must be ≥ 1"):
        tiny_moe_spec(n_layers=1).__class__(
            layers=tiny_moe_spec().layers, d_model=0)


# ---------------------------------------------------------------------------
# MoE plan lifecycle: plan → round-trip → compile → validate
# ---------------------------------------------------------------------------

def test_moe_plan_round_trips_save_load(tmp_path):
    plan = _plan()
    assert plan.feasible and plan.cnn is None
    assert plan.workload.kind == "moe"
    path = runtime.save_plan(plan, tmp_path / "moe_plan.json")
    loaded = runtime.load_plan(path)
    assert loaded == plan
    assert json.loads(path.read_text())["workload"]["kind"] == "moe"
    # the reference reads the port's artifact, and the port the
    # reference's, to the same bytes
    ref = ref_deploy.DeploymentPlan.from_json(path.read_text())
    assert ref.to_json() == plan.to_json()


def test_moe_planner_picks_highest_precision_that_fits():
    plan = _plan()
    assert plan.bits() == [(12, 10)] * 2
    spec = moe_plan_spec(plan)
    assert [(s.data_bits, s.coeff_bits) for s in spec.layers] \
        == plan.bits()


def test_moe_plan_infeasible_on_edge_feasible_on_v5e():
    spec = MoEWorkloadSpec(
        layers=(MoELayerSpec(d_ff_expert=128, num_experts=8, top_k=2),),
        d_model=64, seq_len=32)
    assert plan_moe_deployment(spec, "v5e").feasible
    with pytest.raises(DeploymentError, match="does not fit device 'edge'"):
        plan_moe_deployment(spec, "edge")
    fallback = plan_moe_deployment(spec, "edge", on_infeasible="fallback")
    assert not fallback.feasible


def test_moe_plan_config_raises_with_kind():
    with pytest.raises(ValueError, match="'moe' workload"):
        plan_config(_plan())
    with pytest.raises(ValueError, match="not 'moe'"):
        moe_plan_spec(_cnn_plan())


def test_compiled_moe_matches_eager_and_tracks_dense_ref():
    """validate_moe_plan's verdict: the bucketed path is the eager
    quantized stack, and quantization stays near the dense oracle."""
    plan = _plan()
    v = validate_moe_plan(plan, device="cpu")
    assert v.compiled_matches_eager
    assert v.dense_ref_rel_err < 0.15
    assert v.quant_error == plan.quant_error


def test_coarser_bits_raise_quant_error():
    fine = tiny_moe_spec(data_bits=12, coeff_bits=10)
    coarse = tiny_moe_spec(data_bits=4, coeff_bits=4)
    fine_err = plan_moe_deployment(fine, "v5e", bit_candidates=None)
    coarse_err = plan_moe_deployment(coarse, "v5e", bit_candidates=None)
    assert coarse_err.quant_error > fine_err.quant_error


def test_compile_plan_dispatches_by_kind():
    moe = compile_plan(_plan(), max_batch=2, device="cpu")
    cnn = compile_plan(_cnn_plan(), max_batch=2, device="cpu")
    assert isinstance(moe, CompiledMoE) and moe.kind == "moe"
    assert isinstance(cnn, CompiledCNN) and cnn.kind == "cnn"
    assert moe.stats()["kind"] == "moe"
    assert moe.in_dtype == torch.float32
    assert moe.input_noun == "token block"


def test_compiled_moe_bucketing_and_chunking():
    """Padding to a bucket and chunking past max_batch change no
    request's output: padding tokens never displace real tokens under
    capacity."""
    compiled = compile_plan(_plan(), max_batch=4, device="cpu")
    xs = np.stack(compiled.sample_inputs(7, seed=3))
    y_all = compiled(xs).numpy()            # chunks 4 + 3 (padded to 4)
    singles = np.stack([compiled(x).numpy() for x in xs])
    np.testing.assert_allclose(y_all, singles, **TOL)
    assert sum(compiled.bucket_hits.values()) > 0


def test_padded_bucket_rows_equal_rows_served_alone():
    """A padded bucket's real rows equal the same rows served alone, on
    the committed golden plan (bucket 4 for 3 rows, 16 for 9)."""
    compiled = compile_plan(_golden_plan(), max_batch=16, device="cpu")
    xs = np.stack(compiled.sample_inputs(9, seed=5))
    for n in (3, 9):
        y = compiled(xs[:n]).numpy()
        for r in range(n):
            np.testing.assert_allclose(y[r], compiled(xs[r]).numpy(), **TOL)
    assert compiled.bucket_hits[4] == 1 and compiled.bucket_hits[16] == 1


def test_moe_validate_input_rejects():
    compiled = compile_plan(_plan(), max_batch=2, warmup=False,
                            device="cpu")
    with pytest.raises(ValueError, match="token block shape"):
        compiled.validate_input(np.zeros((3, 3), np.float32))
    bad = np.zeros(compiled.in_shape, np.float32)
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        compiled.validate_input(bad)
    with pytest.raises(ValueError, match="dtype"):
        compiled.validate_input(
            np.zeros(compiled.in_shape, np.complex64))
    with pytest.raises(ValueError, match="one param dict per layer"):
        CompiledMoE(compiled.spec, compiled.params[:1], device="cpu")


def test_prepared_layer_refuses_another_shape():
    compiled = compile_plan(_plan(), max_batch=2, device="cpu")
    layer = compiled._compile_layer(0, 2)
    with pytest.raises(ValueError, match=r"prepared for \(2, 8, 8\)"):
        layer(compiled.params[0], torch.zeros(1, 8, 8))
    assert compiled(np.zeros((0, 8, 8), np.float32)).shape == (0, 8, 8)


def test_missing_card_raises():
    plan = _plan()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        compile_plan(plan)


# ---------------------------------------------------------------------------
# the port's CompiledMoE against the reference's, on carried weights
# ---------------------------------------------------------------------------

def _twins(ref_plan, max_batch):
    """The reference's ``CompiledMoE`` of ``ref_plan`` (its default draw)
    and the port's on the same weights, on the CPU."""
    ref = ref_wl.CompiledMoE.from_plan(ref_plan, max_batch=max_batch)
    plan = DeploymentPlan.from_json(ref_plan.to_json())
    arrays = [{k: np.asarray(v) for k, v in p.items()} for p in ref.params]
    port = CompiledMoE.from_plan(
        plan, params=convert.moe_params_from_numpy(
            arrays, moe_plan_spec(plan), "cpu"),
        max_batch=max_batch, device="cpu")
    return ref, port


def _traces(ref, port, xb):
    ref_acts = dispatch_trace(ref, xb, jnp.asarray, np.asarray)
    port_acts = dispatch_trace(port, xb, torch.from_numpy,
                               lambda t: t.numpy())
    return ref_acts, port_acts


def _layer_by_layer(ref_acts, port, bucket):
    """Each of the port's prepared (layer, bucket) launches on the
    reference's input to that layer equals the reference's output."""
    for i in range(port.num_layers):
        x = ref_acts[i]
        xp = np.concatenate([x, np.zeros((bucket - len(x),) + x.shape[1:],
                                         np.float32)])
        y = port._compile_layer(i, bucket)(port.params[i],
                                           torch.from_numpy(xp))
        np.testing.assert_allclose(y.numpy()[:len(x)], ref_acts[i + 1],
                                   **TOL, err_msg=f"layer {i}")


@pytest.fixture(scope="module")
def qwen_twins():
    ref_plan = ref_wl.plan_moe_deployment(
        ref_wl.moe_workload_from_config(ref_smoke_config(
            "qwen3-moe-30b-a3b")), "v5e", on_infeasible="fallback")
    return _twins(ref_plan, 4)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_compiled_moe_equals_reference_at_every_bucket(qwen_twins, n, seed):
    """At every bucket of max_batch 4 (padded ones included) each layer
    of the port's ``CompiledMoE`` equals the reference's on the same
    input, and the whole forward equals it unless a fake-quant rounding
    flip (a value on a rounding boundary, moved by float summation
    order) explains the difference."""
    ref, port = qwen_twins
    xb = np.stack(port.sample_inputs(n, seed=seed))
    ref_acts, port_acts = _traces(ref, port, xb)
    _layer_by_layer(ref_acts, port, port.bucket_for(n))
    fake_quant_flips(port_acts, ref_acts,
              [s.data_bits for s in port.spec.layers], **TOL)
    np.testing.assert_array_equal(port(xb).numpy(), port_acts[-1])


def test_compiled_moe_equals_reference_chunked(qwen_twins):
    """Past max_batch (7 → chunks of 4 and 3) the served outputs are
    the chunks' dispatches, and equal the reference's as above."""
    ref, port = qwen_twins
    xs = np.stack(port.sample_inputs(7, seed=11))
    y = port(xs).numpy()
    y_ref = np.asarray(ref(xs))
    for lo, hi in ((0, 4), (4, 7)):
        ref_acts, port_acts = _traces(ref, port, xs[lo:hi])
        np.testing.assert_array_equal(y[lo:hi], port_acts[-1])
        np.testing.assert_array_equal(y_ref[lo:hi], ref_acts[-1])
        fake_quant_flips(port_acts, ref_acts,
                  [s.data_bits for s in port.spec.layers], **TOL)


@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_fake_quant_equals_reference(bits):
    """Per-token fake quantization is bit-exact with the reference's,
    the 1e-6 floor kept for an all-zero token."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((3, 8, 16)).astype(np.float32) * 3
    x[1, 2] = 0.0
    got = _fake_quant(torch.from_numpy(x), bits).numpy()
    want = np.asarray(ref_wl._fake_quant(jnp.asarray(x), bits))
    np.testing.assert_array_equal(got, want)
    assert not got[1, 2].any()


def test_fake_quant_flips_explains_only_rounding_flips():
    """A value on a rounding boundary that moves by less than the
    tolerance is a flip, found where it is; an output that moves with
    every layer input equal is an arithmetic difference, and raises."""
    x = np.zeros((2, 1, 4), np.float32)
    x[:, 0] = [7.0, 0.5, -1.0, 2.0]         # 3-bit grid: step 7/3, 0.5 lands
    nudged = x.copy()                        # below the half step, and
    nudged[1, 0, 3] = 7 / 6 + 1e-6           # 7/6 exactly on it
    x[1, 0, 3] = 7 / 6 - 1e-6
    y = x.copy()
    y_moved = y.copy()
    y_moved[1] += 1.0
    assert fake_quant_flips([x, y], [x, y], [3], atol=1e-5) == []
    assert fake_quant_flips([nudged, y_moved], [x, y], [3],
                            atol=1e-5) == [[1, 0, 0, 3]]
    with pytest.raises(AssertionError, match="block 1.*no fake-quant"):
        fake_quant_flips([x, y_moved], [x, y], [3], atol=1e-5)


def test_eager_and_dense_forwards_equal_reference(qwen_twins):
    ref, port = qwen_twins
    x = np.stack(port.sample_inputs(2, seed=4))
    spec, ref_spec = port.spec, ref.spec
    np.testing.assert_allclose(
        _dense_ref_forward(spec, port.params, torch.from_numpy(x)).numpy(),
        np.asarray(ref_wl._dense_ref_forward(ref_spec, ref.params,
                                             jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        _eager_forward(spec, port.params, torch.from_numpy(x),
                       quant_act=False).numpy(),
        np.asarray(ref_wl._eager_forward(ref_spec, ref.params,
                                         jnp.asarray(x), quant_act=False)),
        **TOL)


def test_moe_params_from_numpy_checks_keys_and_shapes():
    spec = tiny_moe_spec()
    ref_spec = tiny_moe_spec(ref_wl)
    arrays = [{k: np.asarray(v) for k, v in p.items()}
              for p in ref_spec.init_params(jax.random.PRNGKey(0))]
    got = convert.moe_params_from_numpy(arrays, spec, "cpu")
    assert [sorted(p) for p in got] == [sorted(p) for p in arrays]
    assert all(np.array_equal(got[0][k].numpy(), arrays[0][k])
               for k in arrays[0])
    with pytest.raises(ValueError, match="one parameter dict per layer"):
        convert.moe_params_from_numpy(arrays[:1], spec, "cpu")
    bad = [dict(a) for a in arrays]
    bad[1]["w_up"] = bad[1]["w_up"][:, :-1]
    with pytest.raises(ValueError, match="layer 1.w_up: shape"):
        convert.moe_params_from_numpy(bad, spec, "cpu")
    del bad[1]["w_up"]
    with pytest.raises(ValueError, match="layer 1: keys"):
        convert.moe_params_from_numpy(bad, spec, "cpu")
    ints = [{k: np.zeros(v.shape, np.int32) for k, v in a.items()}
            for a in arrays]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        convert.moe_params_from_numpy(ints, spec, "cpu")


# ---------------------------------------------------------------------------
# the committed golden file (what the card is held to)
# ---------------------------------------------------------------------------

def _golden_plan():
    with np.load(MOE_GOLDEN) as z:
        return DeploymentPlan.from_json(str(z["plan"]))


def test_golden_plan_is_the_reference_planners():
    with np.load(MOE_GOLDEN) as z:
        text = str(z["plan"])
    plan = DeploymentPlan.from_json(text)
    assert plan.to_json() == text
    assert plan.device.name == "v5e" and plan.target == 0.8
    spec = moe_workload_from_config(smoke_config("qwen3-moe-30b-a3b"))
    mine = plan_moe_deployment(spec, "v5e", target=0.8,
                               on_infeasible="fallback")
    assert _drop_quant_error(mine.to_json()) == _drop_quant_error(text)


def test_golden_outputs_on_the_port():
    """The port on the golden weights and blocks: every layer equals the
    reference's activations on the reference's input, and each output
    equals the golden one unless a rounding flip explains it."""
    with np.load(MOE_GOLDEN) as z:
        plan = DeploymentPlan.from_json(str(z["plan"]))
        spec = moe_plan_spec(plan)
        params = convert.moe_params_from_numpy(
            [{k.split("/")[-1]: z[k] for k in z.files
              if k.startswith(f"params/L{i}/")}
             for i in range(len(spec.layers))], spec, "cpu")
        xs, layer_in, y = z["x"], z["layer_in"], z["y"]
    port = CompiledMoE.from_plan(plan, params=params, max_batch=4,
                                 device="cpu")
    ref_acts = list(layer_in) + [y]
    for lo, hi in ((0, 1), (1, 3), (3, 7), (7, 8)):
        part = [a[lo:hi] for a in ref_acts]
        _layer_by_layer(part, port, port.bucket_for(hi - lo))
    port_acts = [np.concatenate(layer) for layer in zip(*(
        dispatch_trace(port, xs[lo:hi], torch.from_numpy,
                       lambda t: t.numpy())
        for lo, hi in ((0, 1), (1, 3), (3, 7), (7, 8))))]
    flips = fake_quant_flips(port_acts, ref_acts,
                      [s.data_bits for s in spec.layers], **TOL)
    assert len(flips) <= 1, flips


# ---------------------------------------------------------------------------
# serving: sync engine + async gateway, plan-type-blind
# ---------------------------------------------------------------------------

def test_sync_engine_serves_moe_plan():
    plan = _plan()
    eng = CNNEngine.from_plan(plan, serve_cfg=CNNServeConfig(max_batch=2),
                              device="cpu")
    xs = eng.compiled.sample_inputs(3, seed=1)
    reqs = [ImageRequest(image=x, request_id=i) for i, x in enumerate(xs)]
    eng.run(reqs)
    assert all(r.done for r in reqs)
    assert reqs[0].output.shape == eng.compiled.in_shape
    np.testing.assert_array_equal(
        np.stack([r.output for r in reqs[:2]]),
        eng.compiled(np.stack(xs[:2])).numpy())
    # admission rejects a CNN-shaped payload on the MoE plan
    with pytest.raises(ValueError, match="token block shape"):
        eng.submit(ImageRequest(image=np.zeros((8, 8, 1), np.int8)))


def test_gateway_serves_moe_and_cnn_side_by_side():
    """One ``AsyncCNNGateway`` serving a CNN plan and a quantized MoE
    plan concurrently, each validating its own input contract, sharing
    one ``ExecutableCache``; every output equals its backend's direct
    call."""
    async def main():
        gw = AsyncCNNGateway(AsyncServeConfig(max_batch=2, max_pending=16))
        gw.register_plan(_cnn_plan(), plan_id="cnn", device="cpu")
        gw.register_plan(_plan(), plan_id="moe", device="cpu")
        assert gw.plans["cnn"].kind == "cnn"
        assert gw.plans["moe"].kind == "moe"
        async with gw:
            cnn_in = gw.plans["cnn"].compiled.sample_inputs(2, seed=0)
            moe_in = gw.plans["moe"].compiled.sample_inputs(2, seed=0)
            futs = [await gw.submit(x, plan_id="cnn") for x in cnn_in]
            futs += [await gw.submit(x, plan_id="moe") for x in moe_in]
            outs = await asyncio.gather(*futs)
            assert outs[0].shape == gw.plans["cnn"].compiled.in_shape[:2] \
                + (4,)
            assert outs[2].shape == gw.plans["moe"].compiled.in_shape
            for k, (pid, xs) in enumerate((("cnn", cnn_in),
                                           ("moe", moe_in))):
                np.testing.assert_array_equal(
                    np.stack(outs[2 * k:2 * k + 2]),
                    gw.plans[pid].compiled(np.stack(xs)).numpy())
            # per-plan admission: an MoE block is refused on the CNN
            # plan and an image on the MoE plan, each with its noun
            with pytest.raises(ValueError, match="image shape"):
                await gw.submit(moe_in[0], plan_id="cnn")
            with pytest.raises(ValueError, match="token block shape"):
                await gw.submit(cnn_in[0], plan_id="moe")
        assert gw.served == 4
    asyncio.run(main())


def test_moe_plans_share_exec_cache_across_gateway_plans():
    async def main():
        gw = AsyncCNNGateway(AsyncServeConfig(max_batch=2))
        plan = _plan()
        gw.register_plan(plan, plan_id="moe-a", device="cpu")
        before = gw.plans["moe-a"].compiled.compiles
        gw.register_plan(plan, plan_id="moe-b", generator=None,
                         device="cpu")
        # identical layer specs: the second registration prepares nothing
        assert gw.plans["moe-b"].compiled.compiles == 0
        assert before > 0
        await gw.close()
    asyncio.run(main())


def test_persistent_cache_keeps_moe_layers_in_memory(tmp_path):
    """A ``--cache-dir`` cache holds a MoE plan's prepared layers in
    memory only: nothing is written, and a fresh cache on the same
    directory prepares them again."""
    plan = _plan()              # two identical layers: one key a bucket
    first = PersistentExecutableCache(tmp_path)
    compile_plan(plan, max_batch=2, device="cpu", exec_cache=first)
    assert first.stats()["compiles"] == 2 and first.disk_stores == 0
    assert [p.name for p in tmp_path.iterdir()] == []
    again = PersistentExecutableCache(tmp_path)
    model = compile_plan(plan, max_batch=2, device="cpu", exec_cache=again)
    assert model.compiles == 2 and again.disk_hits == 0


# ---------------------------------------------------------------------------
# mixed CNN + MoE fleet: plan-aware placement honors workload hosting
# ---------------------------------------------------------------------------

def test_fleet_routes_mixed_cnn_and_moe_plans():
    """An edge worker hosting only the CNN plan and a v5e worker hosting
    both: MoE traffic goes only to the v5e, CNN traffic to either, both
    complete; draining the only MoE-capable worker makes MoE traffic
    unroutable while CNN traffic still flows."""
    from repro_torch.fleet import Fleet, FleetWorker, NoWorkerAvailable

    cnn_plan = _cnn_plan()
    moe_plan = _plan()

    def gateway(plans):
        gw = AsyncCNNGateway(AsyncServeConfig(max_batch=2, max_pending=16))
        for pid, plan in plans:
            gw.register_plan(plan, plan_id=pid, device="cpu")
        return gw

    async def main():
        edge = FleetWorker("edge0", gateway([("cnn", cnn_plan)]), "edge")
        v5e = FleetWorker("v5e0", gateway([("cnn", cnn_plan),
                                           ("moe", moe_plan)]), "v5e")
        assert edge.workload_kinds == {"cnn"}
        assert v5e.workload_kinds == {"cnn", "moe"}
        fleet = Fleet([edge, v5e], router="plan_aware")
        async with fleet:
            cnn_in = v5e.gateway.plans["cnn"].compiled.sample_inputs(
                4, seed=0)
            moe_in = v5e.gateway.plans["moe"].compiled.sample_inputs(
                4, seed=0)
            futs = [await fleet.submit(x, plan_id="cnn") for x in cnn_in]
            futs += [await fleet.submit(x, plan_id="moe") for x in moe_in]
            outs = await asyncio.gather(*futs)
            assert all(o is not None for o in outs)
            np.testing.assert_array_equal(
                np.stack(outs[4:]),
                v5e.gateway.plans["moe"].compiled(np.stack(moe_in)).numpy())
            stats = fleet.stats()
            assert stats["workers"]["edge0"]["workloads"] == ["cnn"]
            assert stats["workers"]["v5e0"]["workloads"] == ["cnn", "moe"]
            assert v5e.gateway.plans["moe"].served == 4
            v5e.draining = True
            with pytest.raises(NoWorkerAvailable):
                fleet.submit_nowait(moe_in[0], plan_id="moe")
            fut = await fleet.submit(cnn_in[0], plan_id="cnn")
            assert (await fut) is not None
    asyncio.run(main())


# ---------------------------------------------------------------------------
# config-zoo bridge
# ---------------------------------------------------------------------------

def test_moe_workload_from_config():
    cfg = smoke_config("qwen3-moe-30b-a3b")
    spec = moe_workload_from_config(cfg, n_layers=1, seq_len=4)
    assert spec.d_model == cfg.d_model
    assert spec.layers[0].num_experts == cfg.moe.num_experts
    assert plan_moe_deployment(spec, "v5e").feasible
    ref = ref_wl.moe_workload_from_config(
        ref_smoke_config("qwen3-moe-30b-a3b"), n_layers=1, seq_len=4)
    assert spec.to_payload() == ref.to_payload()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_full_width_moe_workload_equals_reference(arch):
    """The zoo's full-width expert geometries give the reference's spec
    and demand (Qwen3-MoE-30B-A3B: 128 experts, top 8, 768 wide)."""
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    spec = moe_workload_from_config(get_config(arch))
    ref = ref_wl.moe_workload_from_config(ref_get_config(arch))
    assert spec.to_payload() == ref.to_payload()
    assert moe_layer_demand(spec, spec.layers[0], 8, 8) \
        == ref_wl.moe_layer_demand(ref, ref.layers[0], 8, 8)


def test_moe_workload_from_dense_config_raises():
    with pytest.raises(ValueError, match="no MoE block"):
        moe_workload_from_config(smoke_config("llama3.2-3b"))


# ---------------------------------------------------------------------------
# the launcher's --workload moe
# ---------------------------------------------------------------------------

def _args(*extra):
    return launcher.parse_args(["--workload", "moe", "--requests", "6",
                                "--max-batch", "4", "--torch-device", "cpu",
                                *extra])


def test_launcher_moe_sync_serves_the_smoke_plan(tmp_path, capsys):
    args = _args("--save-plan", str(tmp_path / "moe.json"))
    assert args.arch == "qwen3-moe-30b-a3b"
    engine, reqs, dt = launcher.run_moe(args)
    assert all(r.done for r in reqs) and dt > 0
    assert engine.compiled.kind == "moe"
    assert engine.stats()["bucket_hits"] == {1: 0, 2: 1, 4: 1}
    np.testing.assert_array_equal(
        np.stack([r.output for r in reqs[:4]]),
        engine.compiled(np.stack([r.image for r in reqs[:4]])).numpy())
    out = capsys.readouterr().out
    assert "L0=moe_ffn@d12/c10" in out and "tok/s" in out
    saved = runtime.load_plan(tmp_path / "moe.json")
    ref_plan = ref_wl.plan_moe_deployment(
        ref_wl.moe_workload_from_config(ref_smoke_config(
            "qwen3-moe-30b-a3b")), "v5e", target=0.8,
        on_infeasible="fallback")
    assert _drop_quant_error(saved.to_json()) \
        == _drop_quant_error(ref_plan.to_json())
    # --plan serves the artifact verbatim
    engine2, _, _ = launcher.run_moe(_args("--plan",
                                           str(tmp_path / "moe.json")))
    assert engine2.compiled.spec == engine.compiled.spec


def test_launcher_moe_async_serves_through_the_gateway(tmp_path):
    args = _args("--async", "--occupancy", "1.0",
                 "--metrics-out", str(tmp_path / "m.jsonl"),
                 "--plan-store", str(tmp_path / "store"))
    gw, res = launcher.run_moe_async(args, keep_every=2)
    assert res["served"] + res["shed"] + res["expired"] == 6
    assert res["served"] > 0 and res["failed"] == 0
    assert res["blocks_per_s"] > 0
    compiled = gw.plans["moe"].compiled
    for _, x, y in res["outputs"]:
        np.testing.assert_allclose(y, compiled(x).numpy(), **TOL)
    assert PlanStore(tmp_path / "store").list_plans() == ["moe-v5e"]
    assert (tmp_path / "m.jsonl").read_text()
    # a second launch loads the stored plan instead of planning
    gw2, _ = launcher.run_moe_async(args)
    assert gw2.plans["moe"].compiled.spec == compiled.spec


def test_launcher_moe_main_and_flags(monkeypatch, tmp_path):
    launcher.main(["--workload", "moe", "--requests", "2", "--max-batch",
                   "2", "--torch-device", "cpu", "--cache-dir",
                   str(tmp_path / "cache")])
    with pytest.raises(SystemExit):
        launcher.parse_args(["--workload", "moe", "--fleet"])
    with pytest.raises(SystemExit):
        launcher.parse_args(["--workload", "moe", "--plan", "p.json",
                             "--params", "w.npz"])
    assert launcher.parse_args(["--workload", "lm"]).arch == "llama3.2-3b"
    # no fallback hides the card: cuda (the default) without one raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launcher.run_moe(launcher.parse_args(["--workload", "moe"]))
