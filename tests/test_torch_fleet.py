"""The port's ``repro_torch.fleet`` on the CPU, held against
``repro.fleet``: the virtual-clock simulator field for field under every
router (seeds 0–2, a kill and respawn, a drain, a retirement, a
mixed-plan trace), the routers' picks on drawn views, the health state
machine on outcome sequences, and the live ``Fleet`` over CPU gateways
fed the same sequential scenario as the reference's (infer; kill with
re-route, respawn through ``respawn_gateway``; drain with re-route),
with equal outputs and counters.  Then every live test of the
reference's ``tests/test_fleet.py`` and the fleet half of
``tests/test_chaos.py`` against the port, the cancelled-canary
invariant the reference breaks, a gateway's shed taking no health
strike, and the launcher's ``--fleet``, ``--cache-dir`` and
``--store-root``."""

import asyncio
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

from repro import chaos as ref_chaos
from repro import fleet as ref_fleet
from repro import ops as ref_ops
from repro import serve as ref_serve
from repro.core import cnn as ref_cnn
from repro.core import deploy as ref_deploy
from repro_torch import convert
from repro_torch.chaos import (FaultInjector, FaultPlan, FaultSpec,
                               respawn_gateway)
from repro_torch.core import deploy
from repro_torch.core.cnn import cnn_forward_ref
from repro_torch.core.deploy import DeploymentError, device_profile
from repro_torch.fleet import (DEFAULT_TIERS, NOMINAL_V5E_RATE, TIERS,
                               TIER_PRIORITY, Fleet, FleetError,
                               FleetSaturated, FleetWorker, HealthPolicy,
                               NoWorkerAvailable, SimWorkerSpec, WorkerHealth,
                               WorkerView, get_router, list_routers,
                               make_trace, nominal_rate, profile_speed,
                               simulate)
from repro_torch.fleet.sim import V5E_IMAGE_S, V5E_OVERHEAD_S
from repro_torch.launch import serve as launcher
from repro_torch.ops import StoreRoot
from repro_torch.runtime import load_plan
from repro_torch.serve import AsyncCNNGateway, AsyncServeConfig

PLANS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"
QUICKSTART = PLANS / "quickstart_v5e.json"


def _ref_cfg():
    return ref_cnn.CNNConfig(layers=(
        ref_cnn.ConvLayerSpec(1, 4, data_bits=8, coeff_bits=6,
                              block="conv4"),
        ref_cnn.ConvLayerSpec(4, 3, data_bits=6, coeff_bits=4,
                              block="conv3"),
    ), img_h=16, img_w=64)


@pytest.fixture(scope="module")
def plan():
    ref_plan = ref_deploy.plan_deployment(
        _ref_cfg(), ref_cnn.fitted_block_models(), target=0.8,
        on_infeasible="fallback")
    return deploy.DeploymentPlan.from_json(ref_plan.to_json())


@pytest.fixture(scope="module")
def compiled(plan):
    """One CPU CompiledCNN shared by the live-fleet tests (registering a
    prepared plan into a gateway is free)."""
    return launcher.AsyncCNNGateway.from_plan(
        plan, AsyncServeConfig(max_batch=4), device="cpu").plans[
            "plan0"].compiled


def _gateway(plan, compiled, *, max_pending=16, faults=None):
    gw = AsyncCNNGateway(AsyncServeConfig(max_batch=4,
                                          max_pending=max_pending),
                         faults=faults)
    gw.register_plan(plan, plan_id="cnn", compiled=compiled)
    return gw


def _forward_ref(compiled, imgs):
    return cnn_forward_ref(compiled.params, torch.from_numpy(np.stack(imgs)),
                           compiled.cfg).numpy()


# ---------------------------------------------------------------------------
# the simulator against the reference's
# ---------------------------------------------------------------------------

SIM_SPECS = (("w0-edge", "edge"), ("w1-v5e", "v5e"), ("w2-v5p", "v5p"))


def _rate(occupancy=2.2, max_batch=8):
    return occupancy * max_batch / (V5E_OVERHEAD_S + max_batch * V5E_IMAGE_S)


def _both_sims(n, seed, router, *, plan_mix=None, specs=None, **kw):
    """``simulate`` of both packages on the same trace parameters."""
    out = []
    for mod in (ref_fleet, __import__("repro_torch.fleet",
                                      fromlist=["simulate"])):
        spec_list = [mod.SimWorkerSpec(*s) for s in (specs or SIM_SPECS)]
        trace = mod.make_trace(n, _rate(), seed=seed, plan_mix=plan_mix)
        horizon = float(trace.arrivals[-1])
        args = {k: (v * horizon if k.endswith("_at") else v)
                for k, v in kw.items()}
        out.append((trace, mod.simulate(spec_list, trace, router, **args)))
    return out


def _assert_same_sim(ref, port):
    (rt, rr), (pt, pr) = ref, port
    for name in ("arrivals", "tier_idx", "deadlines"):
        assert np.array_equal(getattr(rt, name), getattr(pt, name))
    assert (rt.plan_idx is None) == (pt.plan_idx is None)
    if rt.plan_idx is not None:
        assert np.array_equal(rt.plan_idx, pt.plan_idx)
    assert json.dumps(rr.to_payload(), sort_keys=True) \
        == json.dumps(pr.to_payload(), sort_keys=True)
    assert rr.all_slos_met == pr.all_slos_met


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("router", ["plan_aware", "least_loaded",
                                    "round_robin"])
def test_sim_equals_the_reference(router, seed):
    _assert_same_sim(*_both_sims(3000, seed, router))


@pytest.mark.parametrize("router", ["plan_aware", "round_robin"])
def test_sim_with_a_kill_and_respawn_equals_the_reference(router):
    ref, port = _both_sims(4000, 3, router, kill_at=0.4,
                           kill_worker="w0-edge", respawn_at=0.6)
    _assert_same_sim(ref, port)
    res = port[1]
    assert res.lost == 0 and res.kill_rerouted > 0
    assert res.completed == 4000


@pytest.mark.parametrize("router", ["plan_aware", "least_loaded"])
def test_sim_with_a_drain_equals_the_reference(router):
    ref, port = _both_sims(4000, 4, router, drain_at=0.5,
                           drain_worker="w0-edge")
    _assert_same_sim(ref, port)
    assert port[1].lost == 0 and port[1].per_worker["w0-edge"]["drained"]


def test_sim_with_a_mixed_plan_trace_and_retirement_equals_the_reference():
    specs = (("w0-edge", "edge", ("cnn",)),
             ("w1-v5e", "v5e", ("cnn", "moe")),
             ("w2-v5p", "v5p", ("cnn", "moe")))
    ref, port = _both_sims(5000, 5, "plan_aware", specs=specs,
                           plan_mix={"cnn": 0.7, "moe": 0.3})
    _assert_same_sim(ref, port)
    assert port[1].per_worker["w0-edge"]["served_by_plan"].get("moe", 0) \
        == 0
    ref, port = _both_sims(3000, 6, "plan_aware", specs=specs,
                           plan_mix={"cnn": 0.5, "moe": 0.5},
                           retire_at=0.5, retire_plan_id="moe")
    _assert_same_sim(ref, port)
    assert port[1].refused_retired > 0 and port[1].lost == 0


def test_sim_validation_and_profile_speeds():
    trace = make_trace(10, _rate())
    specs = [SimWorkerSpec(w, p) for w, p in SIM_SPECS]
    for kw, match in ((dict(kill_at=1.0), "go together"),
                      (dict(respawn_at=1.0), "requires"),
                      (dict(kill_at=2.0, kill_worker="w1-v5e",
                            respawn_at=1.0), "kill_at"),
                      (dict(kill_at=1.0, kill_worker="nope"),
                       "unknown kill_worker"),
                      (dict(drain_at=1.0), "go together")):
        with pytest.raises(ValueError, match=match):
            simulate(specs, trace, **kw)
    with pytest.raises(ValueError):
        make_trace(0, _rate())
    with pytest.raises(ValueError, match="sum to 1"):
        make_trace(10, _rate(), plan_mix={"cnn": 0.7, "moe": 0.2})
    for name in ("edge", "v5e", "v5p"):
        p, r = device_profile(name), ref_deploy.device_profile(name)
        assert profile_speed(p) == ref_fleet.profile_speed(r)
        assert nominal_rate(p) == ref_fleet.nominal_rate(r)
    assert NOMINAL_V5E_RATE == ref_fleet.NOMINAL_V5E_RATE
    assert TIERS == ref_fleet.TIERS and TIER_PRIORITY \
        == ref_fleet.TIER_PRIORITY
    assert {k: (v.share, v.deadline_s, v.slo_p99_s)
            for k, v in DEFAULT_TIERS.items()} \
        == {k: (v.share, v.deadline_s, v.slo_p99_s)
            for k, v in ref_fleet.DEFAULT_TIERS.items()}


# ---------------------------------------------------------------------------
# routers and health against the reference's
# ---------------------------------------------------------------------------

def _views(mod, specs):
    return [mod.WorkerView(f"w{i}", cost=c,
                           plan_ids=("cnn",) if has else ("x",),
                           queue_depth=d, rate=rate, healthy=h,
                           draining=dr, est_wait_s=ew)
            for i, (c, has, d, rate, h, dr, ew) in enumerate(specs)]


def _check_routers(specs, tier, headroom, now, picks=3):
    """Every router of both packages over the same views: the same
    worker, picked ``picks`` times (round robin rotates); never an
    inadmissible one, never None while one is admissible."""
    deadline = None if headroom is None else now + headroom
    for name in list_routers():
        port_r, ref_r = get_router(name), ref_fleet.get_router(name)
        for _ in range(picks):
            pv, rv = _views(ref_fleet.router, specs), \
                _views(__import__("repro_torch.fleet.router",
                                  fromlist=["WorkerView"]), specs)
            got = port_r.select("cnn", tier, rv, now, deadline=deadline)
            want = ref_r.select("cnn", tier, pv, now, deadline=deadline)
            assert (got is None) == (want is None)
            admissible = [v for v in rv if v.accepting
                          and "cnn" in v.plan_ids]
            if admissible:
                assert got in admissible
                assert got.worker_id == want.worker_id
            else:
                assert got is None


@pytest.mark.parametrize("seed", range(40))
def test_routers_pick_the_reference_worker_on_seeded_views(seed):
    rng = np.random.default_rng(seed)
    specs = [(float(rng.uniform(0.1, 5.0)), bool(rng.random() < 0.8),
              int(rng.integers(0, 50)), float(rng.uniform(1.0, 500.0)),
              bool(rng.random() < 0.8), bool(rng.random() < 0.2),
              None if rng.random() < 0.5 else float(rng.uniform(0, 2)))
             for _ in range(int(rng.integers(0, 8)))]
    headroom = None if rng.random() < 0.4 else float(rng.uniform(0.01, 3))
    _check_routers(specs, TIERS[seed % 3], headroom,
                   float(rng.uniform(0, 100)))


if HAVE_HYPOTHESIS:
    _worker_specs = st.lists(st.tuples(
        st.floats(0.1, 5.0), st.booleans(), st.integers(0, 50),
        st.floats(1.0, 500.0), st.booleans(), st.booleans(),
        st.one_of(st.none(), st.floats(0.0, 5.0))), max_size=8)
else:                                        # pragma: no cover
    _worker_specs = None


@settings(max_examples=150, deadline=None)
@given(specs=_worker_specs, tier=st.sampled_from(TIERS),
       headroom=st.one_of(st.none(), st.floats(0.01, 10.0)),
       now=st.floats(0.0, 100.0))
def test_routers_pick_the_reference_worker(specs, tier, headroom, now):
    _check_routers(specs, tier, headroom, now)


def test_router_registry():
    a, b = get_router("round_robin"), get_router("round_robin")
    assert a is not b and get_router(a) is a
    assert get_router(None).name == "plan_aware"
    with pytest.raises(ValueError, match="unknown router"):
        get_router("coin_flip")
    assert list_routers() == ref_fleet.list_routers()


def _health_trace(h, ops):
    out = []
    for op, t in ops:
        if op == "fail":
            h.note_failure(t)
        elif op == "ok":
            h.note_success()
        elif op == "neutral":
            h.note_neutral()
        elif op == "probe":
            h.begin_probe()
        else:
            h.force_eject(t)
        out.append((h.healthy, h.ejected, h.probing, h.ejected_at,
                    h.consecutive_failures, h.ejections, h.probes,
                    h.routable(t), h.routable(t + 0.5), h.routable(t + 2)))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_health_follows_the_reference(seed):
    rng = np.random.default_rng(seed)
    ops = [(str(rng.choice(["fail", "ok", "neutral", "probe", "kill"],
                           p=[0.4, 0.2, 0.1, 0.2, 0.1])), 0.3 * k)
           for k in range(60)]
    kw = dict(eject_after=int(rng.integers(1, 4)),
              probe_interval=float(rng.uniform(0.2, 1.5)))
    assert _health_trace(WorkerHealth(HealthPolicy(**kw)), ops) \
        == _health_trace(ref_fleet.WorkerHealth(ref_fleet.HealthPolicy(**kw)),
                         ops)


def test_health_policy_and_profiles():
    with pytest.raises(ValueError):
        HealthPolicy(eject_after=0)
    with pytest.raises(ValueError):
        HealthPolicy(probe_interval=0.0)
    w = FleetWorker("w0", object(), "edge")
    assert w.profile.name == "edge" and w.rate > 0
    with pytest.raises(DeploymentError):
        FleetWorker("w1", object(), "edgy")


# ---------------------------------------------------------------------------
# the live Fleet against the reference's, one sequential scenario
# ---------------------------------------------------------------------------

def _scenario(imgs, workers):
    """infer three; submit eight without yielding and kill ``a`` (its
    queue re-routes); respawn ``a`` through ``spawn``; infer two; submit
    eight and drain ``b`` (its queue re-routes)."""
    async def main():
        fleet = workers()
        async with fleet:
            outs = [await fleet.infer(x) for x in imgs[:3]]
            futs = [fleet.submit_nowait(x) for x in imgs[3:11]]
            fleet.kill("a")
            outs += await asyncio.gather(*futs)
            await fleet.respawn("a")
            outs += [await fleet.infer(x) for x in imgs[11:13]]
            futs = [fleet.submit_nowait(x) for x in imgs[13:21]]
            await fleet.drain("b")
            outs += await asyncio.gather(*futs)
            stats = fleet.stats()
            healthy = fleet.workers["a"].health.healthy
            cache = fleet.workers["a"].gateway.exec_cache.stats()
        return np.stack(outs), stats, healthy, cache
    return asyncio.run(main())


def test_fleet_scenario_equals_the_reference(tmp_path):
    """The port's ``Fleet`` over CPU gateways on the committed
    quickstart plan and the reference's over its own, both from a
    ``StoreRoot`` through ``respawn_gateway``, fed one sequential
    scenario: equal outputs, equal order-independent counters, and the
    respawned worker prepares nothing and is re-admitted."""
    plan = load_plan(QUICKSTART)
    ref_plan = ref_deploy.DeploymentPlan.from_json(plan.to_json())
    ref_weights = [np.asarray(w) for w in ref_cnn.init_cnn(
        jax.random.PRNGKey(0), ref_deploy.plan_config(ref_plan))]
    params = {"cnn": convert.params_from_numpy(
        ref_weights, deploy.plan_config(plan), "cpu")}
    cfg = dict(max_batch=4, max_pending=16)

    root = StoreRoot(tmp_path / "port")
    root.plans.save(plan, "cnn")
    ref_root = ref_ops.StoreRoot(tmp_path / "ref")
    ref_root.plans.save(ref_plan, "cnn")

    def port_spawn():
        return respawn_gateway(root, "a", ["cnn"], AsyncServeConfig(**cfg),
                               device="cpu", params=params)

    def ref_spawn():
        return ref_chaos.respawn_gateway(ref_root, "a", ["cnn"],
                                         ref_serve.AsyncServeConfig(**cfg))

    def port_fleet():
        gw_b = respawn_gateway(root, "b", ["cnn"], AsyncServeConfig(**cfg),
                               device="cpu", params=params)
        return Fleet([FleetWorker("a", port_spawn(), "v5e", spawn=port_spawn,
                                  health=HealthPolicy(eject_after=1,
                                                      probe_interval=0.05)),
                      FleetWorker("b", gw_b, "v5e")], router="round_robin")

    def ref_fleet_():
        gw_b = ref_chaos.respawn_gateway(ref_root, "b", ["cnn"],
                                         ref_serve.AsyncServeConfig(**cfg))
        return ref_fleet.Fleet(
            [ref_fleet.FleetWorker("a", ref_spawn(), "v5e", spawn=ref_spawn,
                                   health=ref_fleet.HealthPolicy(
                                       eject_after=1, probe_interval=0.05)),
             ref_fleet.FleetWorker("b", gw_b, "v5e")], router="round_robin")

    compiled = port_spawn().plans["cnn"].compiled
    imgs = compiled.sample_inputs(21, seed=11)
    port = _scenario(imgs, port_fleet)
    ref = _scenario(imgs, ref_fleet_)
    assert np.array_equal(port[0], ref[0])
    assert np.array_equal(port[0], _forward_ref(compiled, imgs))
    keys = ("served", "rerouted", "drains", "kills", "respawns", "retried",
            "expired", "cancelled", "worker_failures")
    assert {k: port[1][k] for k in keys} == {k: ref[1][k] for k in keys}
    assert port[1]["served"] == 21 and port[1]["rerouted"] > 0
    assert port[1]["kills"] == 1 and port[1]["drains"] == 1
    assert port[2] and ref[2]                    # a re-admitted
    assert port[3]["compiles"] == ref[3]["compiles"] == 0
    assert port[3]["disk_hits"] \
        == compiled.num_layers * len(compiled.buckets)


# ---------------------------------------------------------------------------
# the live Fleet: the reference's tests, against the port
# ---------------------------------------------------------------------------

def test_fleet_serves_exactly_across_workers(plan, compiled):
    workers = [FleetWorker("edge0", _gateway(plan, compiled), "edge"),
               FleetWorker("v5e0", _gateway(plan, compiled), "v5e"),
               FleetWorker("v5p0", _gateway(plan, compiled), "v5p")]
    imgs = compiled.sample_inputs(9)

    async def main():
        fleet = Fleet(workers, router="round_robin")
        async with fleet:
            futs = [await fleet.submit(img, tier=TIERS[i % 3])
                    for i, img in enumerate(imgs)]
            outs = await asyncio.gather(*futs)
            served_by = [f.request.worker.worker_id for f in futs]
            return outs, fleet.stats(), served_by

    outs, stats, served_by = asyncio.run(main())
    assert np.array_equal(np.stack(outs), _forward_ref(compiled, imgs))
    assert stats["served"] == 9
    assert sorted(w["snapshot"]["served"]
                  for w in stats["workers"].values()) == [3, 3, 3]
    assert served_by == ["edge0", "v5e0", "v5p0"] * 3


def test_fleet_validation():
    gw = object()
    with pytest.raises(ValueError, match="at least one"):
        Fleet([])
    with pytest.raises(ValueError, match="duplicate"):
        Fleet([FleetWorker("a", gw), FleetWorker("a", gw)])
    with pytest.raises(ValueError, match="max_retries"):
        Fleet([FleetWorker("a", gw)], max_retries=-1)

    async def bad_tier():
        fleet = Fleet([FleetWorker("a", gw)])
        await fleet.__aenter__()
        with pytest.raises(ValueError, match="unknown tier"):
            fleet.submit_nowait(np.zeros(1), tier="platinum")

    asyncio.run(bad_tier())


def test_fleet_no_worker_and_saturation_errors(plan, compiled):
    imgs = compiled.sample_inputs(4)

    async def main():
        workers = [FleetWorker("a", _gateway(plan, compiled, max_pending=1),
                               "v5e"),
                   FleetWorker("b", _gateway(plan, compiled, max_pending=1),
                               "v5e")]
        fleet = Fleet(workers, router="least_loaded")
        async with fleet:
            f0 = fleet.submit_nowait(imgs[0])
            f1 = fleet.submit_nowait(imgs[1])
            with pytest.raises(FleetSaturated):
                fleet.submit_nowait(imgs[2])
            await asyncio.gather(f0, f1)
            await fleet.drain("a")
            await fleet.drain("b")
            with pytest.raises(NoWorkerAvailable):
                fleet.submit_nowait(imgs[3])
            with pytest.raises(FleetError, match="unknown worker"):
                await fleet.drain("zz")
            return fleet.stats()

    stats = asyncio.run(main())
    assert stats["served"] == 2 and stats["drains"] == 2


def test_fleet_drain_loses_nothing(plan, compiled):
    imgs = compiled.sample_inputs(12)

    async def main():
        workers = [FleetWorker("a", _gateway(plan, compiled), "v5e"),
                   FleetWorker("b", _gateway(plan, compiled), "v5e")]
        fleet = Fleet(workers, router="round_robin")
        async with fleet:
            futs = [fleet.submit_nowait(img) for img in imgs]
            drained = await fleet.drain("a")
            assert drained.draining and not drained.outstanding
            outs = await asyncio.gather(*futs)
            return outs, fleet.stats()

    outs, stats = asyncio.run(main())
    assert np.array_equal(np.stack(outs), _forward_ref(compiled, imgs))
    assert stats["served"] == len(imgs) and stats["rerouted"] > 0
    assert stats["workers"]["a"]["draining"]


class _Exploding:
    """A compiled model whose dispatches raise until healed."""

    def __init__(self, inner):
        self._inner = inner
        self.broken = True

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, *a, **k):
        if self.broken:
            raise RuntimeError("device exploded")
        return self._inner(*a, **k)


def _bad_and_good(plan, compiled):
    gw_bad = _gateway(plan, compiled)
    bomb = _Exploding(compiled)
    gw_bad.plans["cnn"].compiled = bomb
    return bomb, [FleetWorker("bad", gw_bad, "edge",
                              health=HealthPolicy(eject_after=1,
                                                  probe_interval=0.05)),
                  FleetWorker("good", _gateway(plan, compiled), "v5e")]


def test_fleet_failure_retry_ejection_and_probe_readmission(plan,
                                                            compiled):
    bomb, workers = _bad_and_good(plan, compiled)
    imgs = compiled.sample_inputs(6)

    async def main():
        fleet = Fleet(workers, router="least_loaded")
        async with fleet:
            out0 = await fleet.infer(imgs[0])    # explodes, retried
            assert workers[0].health.ejections == 1
            outs = await asyncio.gather(
                *[await fleet.submit(img) for img in imgs[1:4]])
            await asyncio.sleep(0.06)            # probe comes due
            bomb.broken = False
            out4 = await fleet.infer(imgs[4])    # the canary
            assert workers[0].health.healthy
            out5 = await fleet.infer(imgs[5])
            return [out0, *outs, out4, out5], fleet.stats()

    outs, stats = asyncio.run(main())
    assert np.array_equal(np.stack(outs), _forward_ref(compiled, imgs))
    assert stats["served"] == 6 and stats["worker_failures"] >= 1
    assert stats["retried"] >= 1 and stats["workers"]["bad"]["probes"] >= 1


def test_fleet_cancelled_canary_releases_probe(plan, compiled):
    """A client cancelling the very request that was an ejected worker's
    probe canary releases the probe (``note_neutral``) before
    ``cancel()`` returns; the healed worker is then re-admitted by the
    second canary.  The reference breaks this: it releases the probe
    from done-callbacks a loop turn or more later, and the same checks
    fail there (``tests/test_fleet.py``)."""
    bomb, workers = _bad_and_good(plan, compiled)
    imgs = compiled.sample_inputs(3)

    async def main():
        fleet = Fleet(workers, router="least_loaded")
        async with fleet:
            await fleet.infer(imgs[0])           # explodes → ejected
            assert not workers[0].health.healthy
            await asyncio.sleep(0.06)            # probe comes due
            canary = fleet.submit_nowait(imgs[1])
            assert workers[0].health.probing     # it took the canary
            gw_req = canary.request.worker_fut
            assert canary.cancel()               # client walks away
            # settled before cancel() returned: the probe is released,
            # the request left the worker, the gateway cancelled it
            assert not workers[0].health.probing
            assert not workers[0].outstanding and gw_req.cancelled()
            assert fleet.cancelled == 1
            await asyncio.gather(canary, return_exceptions=True)
            await asyncio.sleep(0)
            assert not workers[0].health.probing
            assert not workers[0].health.healthy
            await asyncio.sleep(0.06)
            bomb.broken = False                  # the worker heals
            await fleet.infer(imgs[2])           # the second canary
            assert workers[0].health.healthy
            return fleet.stats()

    stats = asyncio.run(main())
    assert stats["cancelled"] == 1
    assert stats["workers"]["bad"]["probes"] == 2
    assert stats["workers"]["bad"]["routable"]


def test_fleet_kill_cancels_gateway_requests_and_callbacks_reroute(
        plan, compiled):
    """``kill`` cancels a dead worker's gateway requests before it
    returns (the port's gateway futures cancel their request at once),
    and the fleet's done-callbacks still see each cancellation and
    re-route it: every request completes, exactly."""
    imgs = compiled.sample_inputs(10)

    async def main():
        workers = [FleetWorker("a", _gateway(plan, compiled), "v5e",
                               health=HealthPolicy(eject_after=1,
                                                   probe_interval=0.05)),
                   FleetWorker("b", _gateway(plan, compiled), "v5e")]
        fleet = Fleet(workers, router="round_robin")
        async with fleet:
            futs = [fleet.submit_nowait(img) for img in imgs]
            on_a = [f.request for f in futs if f.request.worker.worker_id
                    == "a"]
            killed = fleet.kill("a")
            assert killed.dead and fleet.kill("a") is killed
            assert all(fr.worker_fut.cancelled() for fr in on_a)
            assert workers[0].gateway.cancelled == len(on_a) == 5
            assert fleet.rerouted == 0           # callbacks not run yet
            with pytest.raises(FleetError, match="unknown worker"):
                fleet.kill("zz")
            with pytest.raises(FleetError, match="not dead"):
                await fleet.respawn("b")
            with pytest.raises(FleetError, match="no spawn factory"):
                await fleet.respawn("a")
            outs = await asyncio.gather(*futs)
            assert all(fr.worker.worker_id == "b" for fr in on_a)
            await fleet.respawn("a", gateway=_gateway(plan, compiled))
            canary = [await fleet.infer(img) for img in imgs[:2]]
            assert workers[0].health.healthy
            return outs, canary, fleet.stats()

    outs, canary, stats = asyncio.run(main())
    refs = _forward_ref(compiled, imgs)
    assert np.array_equal(np.stack(outs), refs)
    assert np.array_equal(canary[0], refs[0])
    assert stats["kills"] == 1 and stats["respawns"] == 1
    assert stats["rerouted"] == 5 and stats["served"] == len(imgs) + 2
    assert not stats["workers"]["a"]["dead"]


def test_a_gateway_shed_is_not_a_worker_failure(plan, compiled):
    """A request its gateway sheds for a higher-class arrival is a load
    signal: the worker takes no health strike and stays routable, and
    the request is retried elsewhere (the reference strikes the worker,
    so a fleet at its admission bounds ejects busy, healthy workers)."""
    imgs = compiled.sample_inputs(3)

    async def main():
        workers = [FleetWorker("a", _gateway(plan, compiled, max_pending=1),
                               "v5e", health=HealthPolicy(eject_after=1)),
                   FleetWorker("b", _gateway(plan, compiled), "v5p")]
        fleet = Fleet(workers, router="round_robin")
        async with fleet:
            # a best-effort request queued on a (its bound is 1), then
            # an interactive arrival at a's gateway sheds it
            queued = fleet.submit_nowait(imgs[0], tier="best_effort")
            assert queued.request.worker.worker_id == "a"
            hi = workers[0].gateway.submit_nowait(
                imgs[1], priority=TIER_PRIORITY["interactive"] * 16)
            out = await queued
            await hi
            return out, queued.request.worker.worker_id, fleet.stats(), \
                workers[0].health

    out, served_by, stats, health = asyncio.run(main())
    assert np.array_equal(out, _forward_ref(compiled, imgs[:1])[0])
    assert served_by == "b"
    assert stats["retried"] == 1 and stats["worker_failures"] == 0
    assert health.healthy and health.consecutive_failures == 0
    assert stats["workers"]["a"]["routable"]


def test_fleet_submit_chunk_partial_admission(plan, compiled):
    imgs = compiled.sample_inputs(6)

    async def main():
        workers = [FleetWorker("a", _gateway(plan, compiled, max_pending=1),
                               "v5e"),
                   FleetWorker("b", _gateway(plan, compiled, max_pending=1),
                               "v5e")]
        fleet = Fleet(workers, router="least_loaded")
        async with fleet:
            futs, refused = fleet.submit_chunk(imgs[:4])
            assert len(futs) == 2 and refused == 2
            outs = await asyncio.gather(*futs)
            await fleet.drain("a")
            await fleet.drain("b")
            with pytest.raises(NoWorkerAvailable):
                fleet.submit_chunk(imgs[4:])
            return outs

    outs = asyncio.run(main())
    assert np.array_equal(np.stack(outs), _forward_ref(compiled, imgs[:2]))


def test_fleet_stats_surface(plan, compiled):
    workers = [FleetWorker("w0", _gateway(plan, compiled), "v5e")]

    async def main():
        fleet = Fleet(workers)
        async with fleet:
            return fleet.stats()

    stats = asyncio.run(main())
    w = stats["workers"]["w0"]
    assert stats["router"] == "plan_aware"
    assert w["profile"] == "v5e" and w["plans"] == ["cnn"]
    assert w["workloads"] == ["cnn"]
    assert w["healthy"] and w["routable"] and not w["draining"]
    assert w["snapshot"]["queue_depth"] == 0
    assert w["snapshot"]["max_batch"] == 4


def test_fleet_rollout_and_retire(plan, compiled):
    """``rollout`` prepares a plan off the loop on every worker's own
    device and registers it between dispatches; ``retire_plan`` drains
    it fleet-wide."""
    imgs = compiled.sample_inputs(2)

    async def main():
        workers = [FleetWorker("a", _gateway(plan, compiled), "v5e"),
                   FleetWorker("b", _gateway(plan, compiled), "v5e")]
        fleet = Fleet(workers, router="round_robin")
        async with fleet:
            done = await fleet.rollout(plan, "cnn2")
            assert done == {"a": "cnn2", "b": "cnn2"}
            assert await fleet.rollout(plan, "cnn2") == {}
            outs = [await fleet.infer(x, plan_id="cnn2") for x in imgs]
            served = await fleet.retire_plan("cnn2")
            with pytest.raises(NoWorkerAvailable):
                fleet.submit_nowait(imgs[0], plan_id="cnn2")
            return outs, served, workers[0].gateway.plans

    outs, served, plans = asyncio.run(main())
    assert served == 2 and "cnn2" not in plans
    assert np.array_equal(np.stack(outs), _forward_ref(compiled, imgs))


def test_chaos_crash_kill_respawn_over_a_shared_store(tmp_path, plan,
                                                      compiled):
    """A seeded crash mid-dispatch: the fleet kills the worker and
    re-routes its queued and mid-dispatch requests; the respawn
    rebuilds the gateway from the shared ``StoreRoot`` (lease takeover,
    the plan from the store, zero preparations) and the probe re-admits
    it.  ``completed + refused == requests`` and ``lost == 0``."""
    root = StoreRoot(tmp_path / "state")
    root.plans.save(plan, "cnn")
    inj = FaultInjector(FaultPlan((
        FaultSpec("crash_dispatch", "a", after_n=1),), seed=42))
    cfg = AsyncServeConfig(max_batch=4, max_pending=32)

    def spawn_a():
        inj.revive("a")
        return respawn_gateway(root, "a", ["cnn"], cfg, device="cpu")

    gw_a = respawn_gateway(root, "a", ["cnn"], cfg, device="cpu",
                           faults=inj.for_target("a"))
    gw_b = respawn_gateway(root, "b", ["cnn"], cfg, device="cpu")
    assert root.list_leases() == ["a", "b"]
    model = gw_b.plans["cnn"].compiled
    imgs = model.sample_inputs(24)

    async def main():
        workers = [FleetWorker("a", gw_a, "v5e", spawn=spawn_a,
                               health=HealthPolicy(eject_after=1,
                                                   probe_interval=0.05)),
                   FleetWorker("b", gw_b, "v5e")]
        fleet = Fleet(workers, router="round_robin")
        async with fleet:
            futs, refused = [], 0
            for i, img in enumerate(imgs):
                try:
                    futs.append(fleet.submit_nowait(img))
                except FleetError:
                    refused += 1
                if i % 4 == 3:
                    await asyncio.sleep(0.01)
            outs = await asyncio.gather(*futs)
            assert fleet.workers["a"].dead
            respawned = await fleet.respawn("a")
            canary = [await fleet.infer(img) for img in imgs[:2]]
            assert respawned.health.healthy
            return (outs, refused, canary, fleet.stats(),
                    respawned.gateway.exec_cache.stats())

    outs, refused, canary, stats, cache = asyncio.run(main())
    assert len(outs) + refused == len(imgs)
    refs = _forward_ref(model, imgs)
    assert np.array_equal(np.stack(outs), refs[:len(outs)])
    assert np.array_equal(canary[0], refs[0])
    assert stats["kills"] == 1 and stats["rerouted"] > 0
    assert stats["served"] == len(outs) + 2
    assert [(k, t) for k, t, _ in inj.injected] == [("crash_dispatch", "a")]
    assert cache["compiles"] == 0
    assert cache["disk_hits"] == model.num_layers * len(model.buckets)
    assert root.list_leases() == ["a", "b"]


# ---------------------------------------------------------------------------
# the launcher: --fleet, --cache-dir, --store-root
# ---------------------------------------------------------------------------

def _fleet_args(*extra):
    return launcher.parse_args([
        "--fleet", "--requests", "24", "--max-batch", "4", "--max-pending",
        "8", "--occupancy", "0.5", "--torch-device", "cpu", *extra])


@pytest.mark.parametrize("router", ["plan_aware", "least_loaded",
                                    "round_robin"])
def test_run_cnn_fleet_conserves_requests_and_serves_exactly(router):
    fleet, res = launcher.run_cnn_fleet(_fleet_args("--router", router,
                                                    "--seed", "3"),
                                        keep_every=4)
    assert res["served"] + res["expired"] + res["shed"] == 24
    assert res["failed"] == res["lost"] == res["refused"] == 0
    assert sum(w["served"] for w in res["per_worker"].values()) \
        == res["served"]
    assert set(res["per_worker"]) == {"edge0", "v5e0", "v5p0"}
    assert all(len(v) == 3 for v in res["plans"].values())
    kept = res["outputs"]
    assert kept and all(i % 4 == 0 for i, _, _, _ in kept)
    for i, wid, x, y in kept:
        c = fleet.workers[wid].gateway.plans["cnn"].compiled
        assert np.array_equal(y, _forward_ref(c, [x])[0])
    for tier, pct in res["per_tier"].items():
        assert tier in TIERS and pct["p50_ms"] <= pct["p99_ms"]


def test_launcher_fleet_with_a_drain_and_a_cache_dir(tmp_path, capsys):
    cache = tmp_path / "cache"
    launcher.main(["--workload", "cnn", *(
        "--fleet --requests 16 --max-batch 4 --max-pending 8 "
        "--torch-device cpu --drain").split(), "--cache-dir", str(cache)])
    out = capsys.readouterr().out
    assert "draining v5e0" in out and "drains=1" in out
    assert "0 failed / 0 lost of 16" in out
    assert "0 loaded from disk" in out and "persisted" in out
    fleet, res = launcher.run_cnn_fleet(_fleet_args("--cache-dir",
                                                    str(cache)))
    assert res["cache"]["compiles"] == 0 and res["cache"]["disk_hits"] > 0


def test_launcher_store_root_plans_once_and_warms(tmp_path, capsys):
    root = tmp_path / "root"
    args = _fleet_args("--store-root", str(root))
    launcher._apply_store_root(args)
    assert args.plan_store == str(root)
    assert args.cache_dir == str(root / "exec-cache")
    _, first = launcher.run_cnn_fleet(args)
    assert StoreRoot(root).plans.list_plans() == ["cnn-edge", "cnn-v5e",
                                                  "cnn-v5p"]
    args = _fleet_args("--store-root", str(root))
    launcher._apply_store_root(args)
    _, second = launcher.run_cnn_fleet(args)
    assert first["cache"]["compiles"] > 0
    assert second["cache"]["compiles"] == 0
    assert second["cache"]["disk_hits"] == first["cache"]["disk_stores"]
    assert first["plans"] == second["plans"]
    out = capsys.readouterr().out
    assert "loaded plan 'cnn-v5p' from store" in out
    # the sync and async paths take a store root too
    launcher.main(["--store-root", str(root), "--requests", "2",
                   "--max-batch", "2", "--torch-device", "cpu"])
    launcher.main(["--store-root", str(root), "--async", "--requests", "4",
                   "--max-batch", "2", "--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert "loaded plan 'cnn-v5e' from store" in out
    assert "[ops] exec cache:" in out


def test_launcher_flag_errors():
    for argv in (["--store-root", "a", "--cache-dir", "b"],
                 ["--store-root", "a", "--plan-store", "b"],
                 ["--fleet", "--plan", str(QUICKSTART)],
                 ["--fleet", "--async"],
                 ["--fleet", "--router", "coin_flip"]):
        with pytest.raises(SystemExit):
            launcher.parse_args(argv)
    args = launcher.parse_args(["--fleet"])
    assert args.router == "plan_aware" and args.seed == 1
    assert args.torch_device == "cuda" and not args.drain
