"""The port's ``repro_torch.chaos`` and ``ops.StoreRoot`` on the CPU:
fault plans against the reference's (the same JSON from the same seed,
each package reading the other's, the same ``injected`` log from the
same checks), the runtime seams (a crash rides the gateway's
failed-dispatch path, a stalled heartbeat reads as a missed heartbeat
to ``FleetWorker.view``), the disk-fault helpers, ``StoreRoot``'s layout
and leases (a live foreign holder started as a subprocess), and
``respawn_gateway``'s warm start from the store, which prepares
nothing."""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import chaos as ref_chaos
from repro import ops as ref_ops
from repro.core import cnn as ref_cnn
from repro.core import deploy as ref_deploy
from repro_torch import convert
from repro_torch.chaos import (FAULT_KINDS, FAULT_PLAN_SCHEMA_VERSION,
                               FaultInjector, FaultPlan, FaultSpec,
                               HeartbeatStalled, TrackerDiskFull,
                               WorkerCrashed, corrupt_cache_entries,
                               make_fault_plan, respawn_gateway,
                               tear_plan_write)
from repro_torch.core import deploy
from repro_torch.core.cnn import cnn_forward_ref
from repro_torch.fleet import FleetWorker, HealthPolicy
from repro_torch.ops import (JsonlTracker, LeaseHeld, PlanNotFound,
                             StoreRoot, read_log)
from repro_torch.runtime import load_plan
from repro_torch.serve import AsyncCNNGateway, AsyncServeConfig

PLANS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "plans"


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


def _gateway(plan, *, faults=None, max_pending=16):
    return AsyncCNNGateway.from_plan(
        plan, AsyncServeConfig(max_batch=4, max_pending=max_pending),
        plan_id="cnn", device="cpu", faults=faults)


def _forward_ref(compiled, imgs):
    return cnn_forward_ref(compiled.params, torch.from_numpy(np.stack(imgs)),
                           compiled.cfg).numpy()


# ---------------------------------------------------------------------------
# fault plans against the reference's
# ---------------------------------------------------------------------------

def test_schema_and_kinds_match_the_reference():
    assert FAULT_KINDS == ref_chaos.FAULT_KINDS
    assert FAULT_PLAN_SCHEMA_VERSION == ref_chaos.FAULT_PLAN_SCHEMA_VERSION


@pytest.mark.parametrize("payload,match", [
    (dict(kind="explode", target="w", at=1.0), "unknown fault kind"),
    (dict(kind="crash_dispatch", target="", at=1.0), "non-empty"),
    (dict(kind="crash_dispatch", target="w"), "exactly one"),
    (dict(kind="crash_dispatch", target="w", at=1.0, after_n=1),
     "exactly one"),
    (dict(kind="crash_dispatch", target="w", at=-1.0), "must be ≥ 0"),
    (dict(kind="crash_dispatch", target="w", after_n=0), "must be ≥ 1"),
    (dict(kind="crash_dispatch", target="w", at=1.0, duration_s=1.0),
     "duration_s does not apply"),
    (dict(kind="crash_dispatch", target="w", after_n=1, count=2),
     "count does not apply"),
    (dict(kind="stall_heartbeat", target="w", at=1.0, duration_s=0.0),
     "must be > 0"),
    (dict(kind="tracker_disk_full", target="w", after_n=1, count=0),
     "must be ≥ 1"),
    (dict(kind="crash_dispatch", target="w", at=1.0, blast_radius=3),
     "unknown FaultSpec fields"),
])
def test_spec_validation_matches_the_reference(payload, match):
    for mod in (ref_chaos, sys.modules["repro_torch.chaos"]):
        with pytest.raises(ValueError, match=match):
            mod.FaultSpec.from_payload(payload)


KIND_SETS = (("crash_dispatch",),
             ("crash_dispatch", "stall_heartbeat", "tracker_disk_full"),
             FAULT_KINDS)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kinds", KIND_SETS)
def test_make_fault_plan_gives_the_reference_json(seed, kinds):
    kw = dict(workers=("a", "b", "c"), horizon_s=37.5, kinds=kinds)
    port = make_fault_plan(seed, **kw)
    ref = ref_chaos.make_fault_plan(seed, **kw)
    assert port.to_json() == ref.to_json()
    assert port == make_fault_plan(seed, **kw) and port.seed == seed
    # each package reads the other's JSON
    assert FaultPlan.from_json(ref.to_json()) == port
    assert ref_chaos.FaultPlan.from_json(port.to_json()) == ref
    for spec in port.of_kind("crash_dispatch", "stall_heartbeat"):
        assert 0.2 * 37.5 <= spec.at <= 0.7 * 37.5


def test_plan_queries_and_foreign_payloads():
    plan = FaultPlan((
        FaultSpec("crash_dispatch", "a", at=3.5),
        FaultSpec("stall_heartbeat", "b", at=1.0, duration_s=2.0),
        FaultSpec("tracker_disk_full", "a", after_n=4, count=2),
    ), seed=7)
    assert FaultPlan.from_json(plan.to_json()) == plan
    assert [s.kind for s in plan.for_target("a")] \
        == ["crash_dispatch", "tracker_disk_full"]
    assert [s.target for s in plan.of_kind("stall_heartbeat")] == ["b"]
    with pytest.raises(ValueError, match="unknown fault kind"):
        plan.of_kind("meteor_strike")
    payload = plan.to_payload()
    assert "duration_s" not in payload["specs"][0]
    payload["schema_version"] = 999
    with pytest.raises(ValueError, match="schema_version"):
        FaultPlan.from_payload(payload)
    with pytest.raises(ValueError, match="at least one worker"):
        make_fault_plan(7, workers=(), horizon_s=1.0)
    with pytest.raises(ValueError, match="horizon_s"):
        make_fault_plan(7, workers=("a",), horizon_s=0.0)


def _drive_injector(chaos, plan_json, checks):
    """Run ``checks`` — (target, point, now) seam checks, or
    ("tracker", target, None) disk writes, or ("revive", target, None)
    — through one package's injector; return what each did and the
    ``injected`` log."""
    inj = chaos.FaultInjector(chaos.FaultPlan.from_json(plan_json))
    io = {}
    seen = []
    for target, point, now in checks:
        try:
            if target == "revive":
                inj.revive(point)
            elif target == "tracker":
                fault = io.setdefault(point, inj.tracker_io_fault(point))
                if fault is not None:
                    fault({"event": "x"})
            else:
                inj.for_target(target).check(point, now=now)
            seen.append("ok")
        except Exception as e:             # noqa: BLE001 — compared below
            seen.append(f"{type(e).__name__}: {e}")
    return seen, inj.injected, sorted(inj.crashed)


@pytest.mark.parametrize("seed", range(6))
def test_injector_fires_the_reference_log(seed):
    """The same plan and the same sequence of seam checks give the same
    outcomes, messages and ``injected`` log in both packages."""
    plan = make_fault_plan(seed, workers=("a", "b"), horizon_s=10.0,
                           kinds=FAULT_KINDS)
    extra = FaultPlan((FaultSpec("crash_dispatch", "b", after_n=3),
                       FaultSpec("stall_heartbeat", "a", after_n=2,
                                 count=2)), seed=seed)
    merged = FaultPlan(plan.specs + extra.specs, seed=seed)
    rng = np.random.default_rng(seed)
    checks = []
    for k in range(120):
        r = rng.random()
        if r < 0.1:
            checks.append(("tracker", str(rng.choice(["a", "b"])), None))
        elif r < 0.13:
            checks.append(("revive", str(rng.choice(["a", "b"])), None))
        else:
            checks.append((str(rng.choice(["a", "b", "c"])),
                           str(rng.choice(["dispatch", "heartbeat",
                                           "other"])),
                           float(k) * 0.1))
    port = _drive_injector(sys.modules["repro_torch.chaos"],
                           merged.to_json(), checks)
    ref = _drive_injector(ref_chaos, merged.to_json(), checks)
    assert port == ref
    assert port[1]                        # something fired


def test_crash_is_sticky_until_revive():
    inj = FaultInjector(FaultPlan((
        FaultSpec("crash_dispatch", "w", after_n=1),)))
    seam = inj.for_target("w")
    with pytest.raises(WorkerCrashed, match="crashed mid-dispatch"):
        seam.check("dispatch", now=0.0)
    with pytest.raises(WorkerCrashed, match="is dead"):
        seam.check("heartbeat", now=1.0)
    inj.check("other", "dispatch", now=1.0)
    inj.revive("w")
    seam.check("dispatch", now=2.0)        # the fired spec stays consumed
    assert [(k, t) for k, t, _ in inj.injected] == [("crash_dispatch", "w")]


def test_stall_window_and_tracker_disk_full(tmp_path):
    inj = FaultInjector(FaultPlan((
        FaultSpec("stall_heartbeat", "w", at=10.0, duration_s=5.0),
        FaultSpec("tracker_disk_full", "w", after_n=2, count=2))))
    seam = inj.for_target("w")
    seam.check("heartbeat", now=9.0)
    with pytest.raises(HeartbeatStalled):
        seam.check("heartbeat", now=14.9)
    seam.check("heartbeat", now=15.0)
    assert inj.tracker_io_fault("other") is None
    fault = inj.tracker_io_fault("w")
    with pytest.raises(TrackerDiskFull):
        fault({})
        fault({})
    # the port's tracker counts the refused writes and never raises
    inj2 = FaultInjector(FaultPlan((
        FaultSpec("tracker_disk_full", "w", after_n=2, count=2),)))
    tracker = JsonlTracker(tmp_path / "m.jsonl",
                           io_fault=inj2.tracker_io_fault("w"))
    for i in range(5):
        tracker.log_event("e", i=i)
    tracker.close()
    assert tracker.write_errors == 2
    assert [e["i"] for e in read_log(tmp_path / "m.jsonl").events
            if e["event"] == "e"] == [0, 3, 4]


# ---------------------------------------------------------------------------
# the runtime seams
# ---------------------------------------------------------------------------

def test_a_crash_rides_the_gateway_failed_dispatch_path(plan):
    """The injected crash surfaces through the gateway's failed-dispatch
    path: the request's future fails with ``WorkerCrashed``, the dead
    worker fails its heartbeat too, and after a revive it serves
    exactly again."""
    inj = FaultInjector(FaultPlan((
        FaultSpec("crash_dispatch", "w", after_n=1),)))
    gw = _gateway(plan, faults=inj.for_target("w"))
    compiled = gw.plans["cnn"].compiled
    imgs = compiled.sample_inputs(2)

    async def main():
        async with gw:
            fut = await gw.submit(imgs[0])
            with pytest.raises(WorkerCrashed):
                await fut
            assert gw.failed == 1 and gw.served == 0
            with pytest.raises(WorkerCrashed):
                gw.snapshot()                  # a missed heartbeat
            inj.revive("w")
            return await gw.infer(imgs[1])

    out = asyncio.run(main())
    assert np.array_equal(out, _forward_ref(compiled, imgs[1:])[0])
    assert [k for k, _, _ in inj.injected] == ["crash_dispatch"]
    assert sum(compiled.bucket_hits.values()) == 1   # the crash ran nothing


def test_a_stalled_heartbeat_is_a_missed_heartbeat_to_the_view(plan):
    """``stall_heartbeat`` makes ``snapshot()`` raise; ``FleetWorker.view``
    reads that as a missed heartbeat — a health strike and an
    unroutable view — and the worker is routable again after the
    window and a success."""
    clock = [0.0]
    inj = FaultInjector(FaultPlan((
        FaultSpec("stall_heartbeat", "w", at=1.0, duration_s=2.0),)))
    gw = AsyncCNNGateway.from_plan(
        plan, AsyncServeConfig(max_batch=4), plan_id="cnn", device="cpu",
        clock=lambda: clock[0], faults=inj.for_target("w"))
    worker = FleetWorker("w", gw, "v5e",
                         health=HealthPolicy(eject_after=2,
                                             probe_interval=10.0))
    view = worker.view(0.0)
    assert view.healthy and view.plan_ids == frozenset({"cnn"})
    clock[0] = 1.5
    for k in range(2):
        view = worker.view(1.5)
        assert not view.healthy and view.max_batch == 1
        assert worker.health.consecutive_failures == k + 1
    assert worker.health.ejected and worker.health.ejections == 1
    clock[0] = 3.5                              # window over
    assert not worker.view(3.5).healthy         # still ejected
    assert worker.view(11.5).healthy            # the probe is due
    worker.health.begin_probe()
    worker.health.note_success()
    assert worker.view(11.6).healthy and worker.health.healthy
    assert [k for k, _, _ in inj.injected] == ["stall_heartbeat"] * 2


# ---------------------------------------------------------------------------
# disk faults
# ---------------------------------------------------------------------------

def test_corrupt_cache_entries_sorted_and_limited(tmp_path):
    for name in ("b.exe", "a.exe", "c.exe", "keep.other"):
        (tmp_path / name).write_bytes(b"payload")
    (tmp_path / "kernels").mkdir()
    (tmp_path / "kernels" / "lib.so").write_bytes(b"payload")
    hit = corrupt_cache_entries(tmp_path, limit=2)
    assert [p.name for p in hit] == ["a.exe", "b.exe"]
    assert (tmp_path / "a.exe").read_bytes() != b"payload"
    for name in ("c.exe", "keep.other", "kernels/lib.so"):
        assert (tmp_path / name).read_bytes() == b"payload"


def test_a_torn_plan_write_never_shadows_the_live_plan(tmp_path, plan):
    root = StoreRoot(tmp_path)
    root.plans.save(plan, "cnn")
    other = load_plan(PLANS / "quickstart_v5e.json").to_json()
    tmp = tear_plan_write(root.plans, "cnn", other, cut=len(other) // 3)
    assert tmp.exists() and tmp.parent == root.plans.path_for("cnn").parent
    assert tmp.read_text() == other[:len(other) // 3]
    assert root.plans.load("cnn").to_json() == plan.to_json()
    assert root.plans.list_plans() == ["cnn"]
    # the reference's store reads the same directory the same way
    assert ref_ops.PlanStore(tmp_path).load("cnn").to_json() == plan.to_json()
    assert ref_ops.PlanStore(tmp_path).list_plans() == ["cnn"]


# ---------------------------------------------------------------------------
# StoreRoot: layout and leases
# ---------------------------------------------------------------------------

def test_store_root_layout_and_lease_lifecycle(tmp_path, plan):
    root = StoreRoot(tmp_path / "state")
    assert sorted(p.name for p in root.root.iterdir()) == [
        "exec-cache", "leases", "plans", "quarantine", "retired"]
    root.plans.save(plan, "cnn")
    assert root.plans.list_plans() == ["cnn"]
    cache = root.exec_cache()
    assert cache.cache_dir == root.exec_cache_dir
    assert cache.kernel_dir == root.exec_cache_dir / "kernels"
    lease = root.acquire_lease("w0")
    assert lease.held and root.list_leases() == ["w0"]
    data = json.loads((root.root / "leases" / "w0").read_text())
    assert data["pid"] == os.getpid() and data["worker_id"] == "w0"
    lease.release()
    lease.release()
    assert not lease.held and root.list_leases() == []
    with pytest.raises(ValueError, match="plan_id"):
        root.acquire_lease("../escape")
    # the reference's StoreRoot opens the same layout
    ref_root = ref_ops.StoreRoot(tmp_path / "state")
    assert ref_root.plans.list_plans() == ["cnn"]


def test_lease_takeover_and_stale_release(tmp_path):
    root = StoreRoot(tmp_path / "state")
    old = root.acquire_lease("w")
    new = root.acquire_lease("w")          # own-pid takeover (respawn)
    assert root.list_leases() == ["w"]
    old.release()                          # stale handle: token-checked
    assert root.list_leases() == ["w"]
    new.release()
    assert root.list_leases() == []
    path = root.root / "leases" / "w"
    path.write_text(json.dumps({"worker_id": "w", "pid": 2 ** 30,
                                "acquired_at": 0.0}))   # a dead holder
    with root.acquire_lease("w"):
        assert json.loads(path.read_text())["pid"] == os.getpid()
    assert root.list_leases() == []
    path.write_text("{torn")                # unreadable: stale
    with root.acquire_lease("w"):
        assert root.list_leases() == ["w"]


def test_lease_held_by_a_live_foreign_process(tmp_path):
    """A lease written by another live process is refused with
    ``LeaseHeld``; once that process is gone, it is taken over."""
    root = StoreRoot(tmp_path / "state")
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import json, os, sys, time\n"
         "from pathlib import Path\n"
         "p = Path(sys.argv[1])\n"
         "p.write_text(json.dumps({'worker_id': 'w', 'pid': os.getpid(), "
         "'acquired_at': 1.0}))\n"
         "print('held', flush=True)\n"
         "time.sleep(60)\n",
         str(root.root / "leases" / "w")],
        stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "held"
        with pytest.raises(LeaseHeld, match="live pid"):
            root.acquire_lease("w")
        assert root.list_leases() == ["w"]
    finally:
        holder.kill()
        holder.wait(timeout=30)
    with root.acquire_lease("w") as lease:
        assert lease.pid == os.getpid()


# ---------------------------------------------------------------------------
# respawn_gateway: restart from the store
# ---------------------------------------------------------------------------

def test_respawn_gateway_warm_from_the_store(tmp_path, plan):
    root = StoreRoot(tmp_path / "state")
    root.plans.save(plan, "cnn")
    cfg = AsyncServeConfig(max_batch=4)
    first = respawn_gateway(root, "w0", ["cnn"], cfg, device="cpu")
    compiled = first.plans["cnn"].compiled
    layers = compiled.num_layers * len(compiled.buckets)
    assert first.exec_cache.stats()["compiles"] == layers
    assert first.exec_cache.stats()["disk_stores"] == layers

    gw = respawn_gateway(root, "w1", ["cnn"], cfg, device="cpu")
    s = gw.exec_cache.stats()
    assert s["compiles"] == 0 and s["disk_hits"] == layers
    assert sorted(gw.plans) == ["cnn"] and gw.lease.held
    assert root.list_leases() == ["w0", "w1"]
    for w0, w1 in zip(compiled.params, gw.plans["cnn"].compiled.params):
        assert torch.equal(w0, w1)           # the same seeded draw
    imgs = compiled.sample_inputs(3, seed=2)

    async def main():
        async with gw:
            return [await gw.infer(x) for x in imgs]

    assert np.array_equal(np.stack(asyncio.run(main())),
                          _forward_ref(compiled, imgs))
    gw.lease.release()
    first.lease.release()
    # a missing plan fails loudly and releases the lease it took
    with pytest.raises(PlanNotFound):
        respawn_gateway(root, "w1", ["ghost"], device="cpu")
    assert root.list_leases() == []


def test_respawn_gateway_takes_the_reference_weights(tmp_path, plan):
    """``params`` carries each plan's weights, here the reference's
    ``init_cnn`` draw; the respawned worker then serves the reference's
    outputs."""
    ref_weights = [np.asarray(w) for w in ref_cnn.init_cnn(
        jax.random.PRNGKey(0), _ref_cfg())]
    params = convert.params_from_numpy(ref_weights, deploy.plan_config(plan),
                                       "cpu")
    root = StoreRoot(tmp_path)
    root.plans.save(plan, "cnn")
    gw = respawn_gateway(root, "w", ["cnn"], AsyncServeConfig(max_batch=2),
                         device="cpu", params={"cnn": params})
    compiled = gw.plans["cnn"].compiled
    imgs = compiled.sample_inputs(2, seed=6)
    want = np.stack([np.asarray(ref_cnn.cnn_forward_ref(
        ref_weights, x, ref_deploy.plan_config(
            ref_deploy.DeploymentPlan.from_json(plan.to_json()))))
        for x in imgs])
    assert np.array_equal(compiled(np.stack(imgs)).numpy(), want)
    gw.lease.release()


def test_respawn_defaults_to_the_card(tmp_path, plan):
    """Without ``device=`` the gateway serves on the card; where there
    is none that raises, and the lease is released on the way out."""
    root = StoreRoot(tmp_path)
    root.plans.save(plan, "cnn")
    if torch.cuda.is_available():
        gw = respawn_gateway(root, "w", ["cnn"])
        assert gw.plans["cnn"].compiled.device.type == "cuda"
        gw.lease.release()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            respawn_gateway(root, "w", ["cnn"])
    assert root.list_leases() == []
