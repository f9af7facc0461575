"""The port's async continuous-batching gateway on the CPU (the kernels'
plain versions): every test of ``tests/test_async_serve.py`` held
against the port — admission bound and deadline invariants
(property-tested on the synchronous scheduling core), exact outputs,
backpressure, cancellation, multi-plan routing, cross-plan sharing of
prepared launches — the port against the reference's gateway and
admission queue on the same inputs, the two invariants the reference
does not keep, and the launcher's ``--async`` path."""

import asyncio
import dataclasses
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

from repro import ops as ref_ops
from repro import serve as ref_serve
from repro.core import cnn as ref_cnn
from repro.core import deploy as ref_deploy
from repro_torch import convert
from repro_torch.core import deploy
from repro_torch.core.cnn import (CNNConfig, ConvLayerSpec, cnn_forward_ref,
                                  init_cnn)
from repro_torch.launch import serve as launcher
from repro_torch.ops import PlanStore, read_log
from repro_torch.runtime import (CompiledCNN, DispatchAborted,
                                 ExecutableCache, load_plan)
from repro_torch.serve import (AdmissionQueue, AsyncCNNGateway, AsyncRequest,
                               AsyncServeConfig, DeadlineExpired,
                               GatewayBacklog, GatewayStats, get_policy)
from repro_torch.serve.slots import SlotPool

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
PINNED = SRC / "plans" / "quickstart_v5e_conv1_conv3.json"
GOLDEN = SRC / "golden" / "quickstart_reference.npz"


def _cfg():
    return ref_cnn.CNNConfig(layers=(
        ref_cnn.ConvLayerSpec(1, 4, data_bits=8, coeff_bits=6,
                              block="conv4"),
        ref_cnn.ConvLayerSpec(4, 3, data_bits=6, coeff_bits=4,
                              block="conv3"),
    ), img_h=16, img_w=64)


@pytest.fixture(scope="module")
def ref_plan():
    """The reference's planner on ``_cfg()``, as its tests plan it."""
    return ref_deploy.plan_deployment(_cfg(), ref_cnn.fitted_block_models(),
                                      target=0.8, on_infeasible="fallback")


@pytest.fixture(scope="module")
def plan(ref_plan):
    """The same plan, read by the port from the reference's artifact."""
    return deploy.DeploymentPlan.from_json(ref_plan.to_json())


def _ref_weights(ref_plan, seed=0):
    """The reference's default weights for the plan (``init_cnn`` with
    ``PRNGKey(seed)``), as numpy arrays."""
    return [np.asarray(w) for w in ref_cnn.init_cnn(
        jax.random.PRNGKey(seed), ref_deploy.plan_config(ref_plan))]


def _params(plan, weights):
    return convert.params_from_numpy(weights, deploy.plan_config(plan),
                                     "cpu")


def _gateway(plan, ref_plan, cfg, **kw):
    """The port's gateway on the CPU, with the reference's weights."""
    return AsyncCNNGateway.from_plan(
        plan, cfg, params=_params(plan, _ref_weights(ref_plan)),
        device="cpu", **kw)


def _images(compiled, k, seed=0):
    return compiled.sample_inputs(k, seed)


def _ref_out(compiled, imgs):
    """``cnn_forward_ref`` of the port on the CPU, per image."""
    return cnn_forward_ref(compiled.params, torch.from_numpy(np.stack(imgs)),
                           compiled.cfg).numpy()


def _req(i, *, plan_id="p", priority=0, deadline=None, now=0.0,
         cls=AsyncRequest):
    return cls(image=np.zeros(1), plan_id=plan_id, request_id=i,
               priority=priority, deadline=deadline, arrived_at=now)


def _serve_all(gw, imgs, **kw):
    async def main():
        async with gw:
            futs = [await gw.submit(img, **kw) for img in imgs]
            return await asyncio.gather(*futs)
    return asyncio.run(main())


# ---------------------------------------------------------------------------
# the synchronous scheduling core (no event loop)
# ---------------------------------------------------------------------------

def test_admission_queue_bound_and_rejection():
    q = AdmissionQueue(max_pending=3, policy="edf")
    assert all(q.admit(_req(i), 0.0) for i in range(3))
    assert q.full and len(q) == 3
    assert not q.admit(_req(3), 0.0)        # at the bound: refused
    _, batch = q.pop_batch(2, 0.0)
    assert [r.request_id for r in batch] == [0, 1]
    assert len(q) == 1 and not q.full
    assert q.admit(_req(4), 0.0)


def test_admission_queue_expires_instead_of_serving_late():
    q = AdmissionQueue(max_pending=8, policy="edf")
    on_time = _req(0, deadline=10.0)
    late = _req(1, deadline=2.0)
    assert q.admit(on_time, 0.0) and q.admit(late, 0.0)
    _, batch = q.pop_batch(8, now=5.0)      # past late's deadline
    assert [r.request_id for r in batch] == [0]
    assert late.status == "expired"
    assert isinstance(late.error, DeadlineExpired)
    assert q.expired == 1
    # already expired on admission: terminal immediately, never queued
    dead = _req(2, deadline=1.0)
    assert q.admit(dead, now=5.0)           # handled, not refused
    assert dead.status == "expired" and len(q) == 0


def test_admission_queue_edf_order_and_priority_tiers():
    q = AdmissionQueue(max_pending=8, policy="edf")
    q.admit(_req(0, deadline=9.0), 0.0)
    q.admit(_req(1, deadline=3.0), 0.0)
    q.admit(_req(2), 0.0)                   # no deadline: last in tier
    q.admit(_req(3, deadline=99.0, priority=1), 0.0)   # higher tier
    _, batch = q.pop_batch(8, 0.0)
    assert [r.request_id for r in batch] == [3, 1, 0, 2]


def test_admission_queue_single_plan_batches_hold_others_back():
    q = AdmissionQueue(max_pending=8, policy="fifo")
    q.admit(_req(0, plan_id="a"), 0.0)
    q.admit(_req(1, plan_id="b"), 0.0)
    q.admit(_req(2, plan_id="a"), 0.0)
    pid, batch = q.pop_batch(8, 0.0)
    assert pid == "a" and [r.request_id for r in batch] == [0, 2]
    pid, batch = q.pop_batch(8, 0.0)
    assert pid == "b" and [r.request_id for r in batch] == [1]
    assert len(q) == 0


def test_admission_queue_cancelled_entries_never_pop():
    q = AdmissionQueue(max_pending=4, policy="fifo")
    reqs = [_req(i) for i in range(3)]
    for r in reqs:
        q.admit(r, 0.0)
    assert reqs[1].cancel()
    q.note_terminal()                       # the gateway's cancel hook
    assert len(q) == 2
    _, batch = q.pop_batch(8, 0.0)
    assert [r.request_id for r in batch] == [0, 2]


if HAVE_HYPOTHESIS:
    _ops = st.lists(st.tuples(
        st.sampled_from(["submit", "pop", "tick", "cancel"]),
        st.integers(0, 7),                  # pop width / cancel index
        st.one_of(st.none(), st.floats(0.0, 4.0)),   # relative deadline
    ), min_size=1, max_size=60)
else:                                        # pragma: no cover
    _ops = None


@settings(max_examples=60, deadline=None)
@given(ops_list=_ops, bound=st.integers(1, 6))
def test_admission_bound_and_deadline_invariants(ops_list, bound):
    """Under any interleaving of submits, pops, clock ticks and cancels,
    (a) the live pending count never exceeds the bound, (b) a popped
    batch never contains an expired or cancelled request, and (c) every
    request ends served-able, expired, cancelled, or refused."""
    q = AdmissionQueue(max_pending=bound, policy="edf")
    now = 0.0
    submitted, popped, refused = [], [], []
    for op, arg, dl in ops_list:
        if op == "submit":
            r = _req(len(submitted),
                     deadline=None if dl is None else now + dl, now=now)
            if q.admit(r, now):
                if r.status == "pending":
                    submitted.append(r)
            else:
                refused.append(r)
            assert len(q) <= bound
        elif op == "pop":
            _, batch = q.pop_batch(arg + 1, now)
            for r in batch:
                assert r.status == "pending"
                assert r.deadline is None or r.deadline >= now
                popped.append(r)
            assert len(q) <= bound
        elif op == "tick":
            now += 0.5 + (0.0 if dl is None else dl)
        elif op == "cancel":
            pending = [r for r in submitted
                       if r.status == "pending" and r not in popped]
            if pending:
                r = pending[arg % len(pending)]
                assert r.cancel()
                q.note_terminal()
        assert 0 <= len(q) <= bound
    _, batch = q.pop_batch(10 ** 6, now)
    popped.extend(batch)
    assert len(q) == 0
    for r in submitted:
        assert (r in popped and r.status == "pending") \
            or r.status in ("expired", "cancelled")
    for r in refused:
        assert r.status == "pending" and r not in popped


def test_admission_queue_refuses_terminal_requests():
    """A request that reached a terminal state before admission is
    never queued: the live count cannot leak a slot of the bound."""
    q = AdmissionQueue(max_pending=2, policy="edf")
    r = _req(0)
    assert r.cancel()
    assert q.admit(r, 0.0)              # handled (already terminal)...
    assert len(q) == 0                  # ...but never queued
    _, batch = q.pop_batch(8, 0.0)
    assert batch == []
    assert q.admit(_req(1), 0.0) and q.admit(_req(2), 0.0)
    assert q.full and len(q) == 2


def test_admission_queue_shed_victim_and_probe():
    """At the bound a higher-priority arrival ejects the least-urgent
    pending entry; a same-class arrival is refused."""
    q = AdmissionQueue(max_pending=2, policy="edf")
    lo0, lo1 = _req(0, priority=0), _req(1, priority=0)
    assert q.admit(lo0, 0.0) and q.admit(lo1, 0.0) and q.full
    assert not q.outranked_by(_req(2, priority=0), 0.0)
    assert q.shed_victim(_req(2, priority=0), 0.0) is None
    hi = _req(3, priority=9)
    assert q.outranked_by(hi, 0.0)
    victim = q.shed_victim(hi, 0.0)
    assert victim is lo1 and victim.status == "shed"
    assert isinstance(victim.error, GatewayBacklog)
    assert q.shed == 1 and len(q) == 1
    assert q.admit(hi, 0.0) and q.full
    assert not q.outranked_by(_req(4, priority=0), 0.0)
    assert q.outranked_by(_req(5, priority=10), 0.0)
    _, batch = q.pop_batch(8, 0.0)
    assert [r.request_id for r in batch] == [3, 0]


def test_admission_queue_resize_bound():
    q = AdmissionQueue(max_pending=4, policy="fifo")
    assert all(q.admit(_req(i), 0.0) for i in range(4))
    q.resize(2)                   # shrink below live: nothing evicted
    assert q.max_pending == 2 and len(q) == 4 and q.full
    assert not q.admit(_req(9), 0.0)
    _, batch = q.pop_batch(3, 0.0)
    assert len(batch) == 3
    assert q.admit(_req(4), 0.0) and q.full    # back under the bound
    q.resize(0)
    assert q.max_pending == 1                  # clamped: never zero


if HAVE_HYPOTHESIS:
    _conserve_ops = st.lists(st.tuples(
        st.sampled_from(["admit", "admit_terminal", "cancel", "pop",
                         "evict", "resize", "shed"]),
        st.integers(0, 7),
    ), min_size=1, max_size=80)
else:                                        # pragma: no cover
    _conserve_ops = None


@settings(max_examples=80, deadline=None)
@given(ops_list=_conserve_ops, bound=st.integers(1, 5))
def test_admission_live_count_conservation(ops_list, bound):
    """Across any interleaving of admissions (already-terminal requests
    too), cancellations, pops, drain evictions, bound resizes and
    class-aware sheds, the live count equals the pending entries in the
    heap, and a full drain restores the whole bound."""
    q = AdmissionQueue(max_pending=bound, policy="edf")
    n = 0
    hi_bound = bound                  # high-water admission bound seen
    for op, arg in ops_list:
        if op == "admit":
            q.admit(_req(n), 0.0)
            n += 1
        elif op == "admit_terminal":
            r = _req(n)
            n += 1
            assert r.cancel()
            assert q.admit(r, 0.0)      # handled, never queued
        elif op == "cancel":
            pending = [r for _, _, r in q._heap
                       if r.status == "pending"]
            if pending:
                assert pending[arg % len(pending)].cancel()
                q.note_terminal()
        elif op == "pop":
            q.pop_batch(arg + 1, 0.0)
        elif op == "evict":
            for r in q.evict_pending():
                assert r.cancel()
                q.note_terminal()
        elif op == "resize":
            q.resize(arg + 1)
            hi_bound = max(hi_bound, q.max_pending)
        elif op == "shed":
            r = _req(n, priority=arg)
            n += 1
            if not q.admit(r, 0.0):
                v = q.shed_victim(r, 0.0)
                if v is not None:
                    assert v.status == "shed"
                    assert q.admit(r, 0.0)
        live_in_heap = sum(1 for _, _, r in q._heap
                           if r.status == "pending")
        assert len(q) == live_in_heap
        assert 0 <= len(q) <= hi_bound
    q.resize(bound)
    q.pop_batch(10 ** 6, 0.0)
    assert len(q) == 0
    assert all(q.admit(_req(n + i), 0.0) for i in range(bound))
    assert q.full


def test_shed_after_shrink_sheds_nobody():
    """Invariant 1, the reference's counterexample: at ``bound=2``,
    ``[admit, admit, resize(0), shed(1)]`` keeps live == pending in the
    heap and sheds nobody — one ejection cannot make room below the
    shrunk bound, so the arrival is the one refused."""
    q = AdmissionQueue(max_pending=2, policy="edf")
    a, b = _req(0), _req(1)
    assert q.admit(a, 0.0) and q.admit(b, 0.0)
    q.resize(0)
    arrival = _req(2, priority=1)
    assert q.outranked_by(arrival, 0.0)
    assert not q.admit(arrival, 0.0)
    assert q.shed_victim(arrival, 0.0) is None
    assert q.shed == 0 and a.status == b.status == "pending"
    assert len(q) == 2 == sum(1 for _, _, r in q._heap
                              if r.status == "pending")
    # once the queue is under the bound again, shedding works as before
    q.pop_batch(1, 0.0)
    assert q.full and len(q) == 1
    assert q.shed_victim(arrival, 0.0) is not None and q.admit(arrival, 0.0)


if HAVE_HYPOTHESIS:
    _parity_ops = st.lists(st.tuples(
        st.sampled_from(["submit", "shed", "pop", "tick", "cancel",
                         "resize", "evict"]),
        st.integers(0, 7),
        st.one_of(st.none(), st.floats(0.0, 4.0)),
    ), min_size=1, max_size=60)
else:                                        # pragma: no cover
    _parity_ops = None


def _ids(reqs):
    return [None if r is None else r.request_id for r in reqs]


@settings(max_examples=80, deadline=None)
@given(ops_list=_parity_ops, bound=st.integers(1, 5))
def test_admission_queue_matches_reference(ops_list, bound):
    """The same op sequence through the port's and the reference's
    ``AdmissionQueue`` gives the same popped ids, statuses, ``expired``
    and ``shed`` — on every sequence up to where the reference breaks
    its own live-count invariant (a shed after a shrink), where the port
    refuses the arrival instead."""
    queues = (AdmissionQueue(bound, "edf"),
              ref_serve.AdmissionQueue(bound, "edf"))
    classes = (AsyncRequest, ref_serve.AsyncRequest)
    reqs = ([], [])
    now = 0.0
    for op, arg, dl in ops_list:
        if op in ("submit", "shed"):
            n = len(reqs[0])
            pair = [_req(n, priority=arg if op == "shed" else 0,
                         deadline=None if dl is None else now + dl,
                         now=now, cls=c) for c in classes]
            for rs, r in zip(reqs, pair):
                rs.append(r)
            got = [q.admit(r, now) for q, r in zip(queues, pair)]
            assert got[0] == got[1]
            if not got[0] and op == "shed":
                victims = [q.shed_victim(r, now)
                           for q, r in zip(queues, pair)]
                if victims[1] is not None \
                        and not queues[1].admit(pair[1], now):
                    assert victims[0] is None   # the port refuses
                    return                      # the reference broke
                assert _ids(victims)[0] == _ids(victims)[1]
                if victims[0] is not None:
                    assert queues[0].admit(pair[0], now)
        elif op == "pop":
            (pa, ba), (pb, bb) = [q.pop_batch(arg + 1, now) for q in queues]
            assert pa == pb and _ids(ba) == _ids(bb)
        elif op == "tick":
            now += 0.5 + (0.0 if dl is None else dl)
        elif op == "cancel":
            pending = [r.request_id for _, _, r in queues[0]._heap
                       if r.status == "pending"]
            if pending:
                i = sorted(pending)[arg % len(pending)]
                for q, rs in zip(queues, reqs):
                    assert rs[i].cancel()
                    q.note_terminal()
        elif op == "resize":
            for q in queues:
                q.resize(arg)
        elif op == "evict":
            evicted = [q.evict_pending() for q in queues]
            assert sorted(_ids(evicted[0])) == sorted(_ids(evicted[1]))
            for q, ev in zip(queues, evicted):
                for r in ev:
                    assert r.cancel()
                    q.note_terminal()
        assert len(queues[0]) == len(queues[1])
        assert [r.status for r in reqs[0]] == [r.status for r in reqs[1]]
        assert (queues[0].expired, queues[0].shed) \
            == (queues[1].expired, queues[1].shed)


# ---------------------------------------------------------------------------
# the asyncio gateway end to end (CPU: the kernels' plain versions)
# ---------------------------------------------------------------------------

def test_gateway_serves_bit_exact(plan, ref_plan):
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=4,
                                                   max_pending=16))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 9)
    outs = _serve_all(gw, imgs)
    np.testing.assert_array_equal(np.stack(outs), _ref_out(compiled, imgs))
    stats = gw.stats()
    assert stats["served"] == 9 and stats["pending"] == 0
    assert sum(k * v for k, v in stats["occupancy_hist"].items()) == 9


def test_gateway_outputs_equal_reference_gateway(plan, ref_plan):
    """The reference's gateway and the port's serve the same images to
    equal outputs (tolerance 0) and equal telemetry, on the same plan
    and weights."""
    cfg = AsyncServeConfig(max_batch=4, max_pending=16)
    gw = _gateway(plan, ref_plan, cfg)
    ref_gw = ref_serve.AsyncCNNGateway.from_plan(ref_plan, cfg)
    imgs = ref_gw.plans["plan0"].compiled.sample_inputs(9)
    outs, ref_outs = _serve_all(gw, imgs), _serve_all(ref_gw, imgs)
    for a, b in zip(outs, ref_outs):
        assert np.array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    mine, theirs = gw.stats(), ref_gw.stats()
    for key in ("plans", "served", "rejected", "expired", "cancelled",
                "failed", "shed", "pending", "occupancy_hist", "steps"):
        assert mine[key] == theirs[key], key


def test_gateway_backpressure_and_load_shedding(plan, ref_plan):
    """submit_nowait sheds load at the bound; submit awaits space and
    completes once the drain frees it."""
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=3))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 12, seed=3)

    async def main():
        async with gw:
            futs, shed = [], 0
            for img in imgs:
                try:
                    futs.append(gw.submit_nowait(img))
                except GatewayBacklog:
                    shed += 1
            assert shed > 0                  # the bound engaged
            assert gw.stats()["pending"] <= 3
            futs.append(await gw.submit(imgs[0]))
            outs = await asyncio.gather(*futs)
            return outs, shed

    outs, shed = asyncio.run(main())
    stats = gw.stats()
    assert stats["rejected"] == shed
    assert stats["served"] == len(outs)
    assert len(outs) == 12 - shed + 1


def test_gateway_expired_requests_fail_not_served_late(plan, ref_plan):
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=32))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 3, seed=4)

    async def main():
        async with gw:
            dead = await gw.submit(imgs[0], deadline=-1.0)
            ok = await gw.submit(imgs[1], deadline=60.0)
            with pytest.raises(DeadlineExpired):
                await dead
            return await ok

    out = asyncio.run(main())
    np.testing.assert_array_equal(out, _ref_out(compiled, imgs[1:2])[0])
    assert gw.stats()["expired"] == 1


def test_gateway_cancellation_releases_bound_and_skips_serve(plan,
                                                             ref_plan):
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=4))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 4, seed=5)

    async def main():
        async with gw:
            futs = [gw.submit_nowait(img) for img in imgs]
            futs[2].cancel()
            return await asyncio.gather(*futs, return_exceptions=True)

    done = asyncio.run(main())
    assert isinstance(done[2], asyncio.CancelledError)
    assert [isinstance(d, np.ndarray) for d in done] \
        == [True, True, False, True]
    stats = gw.stats()
    assert stats["cancelled"] == 1 and stats["served"] == 3


def test_gateway_multi_plan_routing_and_shared_cache(plan, ref_plan):
    """Two plans with identical layer specs share every prepared launch;
    requests route to their plan and both serve exactly, with each
    plan's own weights."""
    gw = AsyncCNNGateway(AsyncServeConfig(max_batch=4, max_pending=16))
    gw.register_plan(plan, plan_id="a", device="cpu",
                     params=_params(plan, _ref_weights(ref_plan)))
    compiles_after_a = gw.exec_cache.compiles
    assert compiles_after_a > 0
    gw.register_plan(plan, plan_id="b", device="cpu",
                     generator=torch.Generator().manual_seed(7))
    assert gw.exec_cache.compiles == compiles_after_a
    assert gw.plans["b"].compiled.compiles == 0
    assert gw.plans["b"].compiled.warmed_up

    ca, cb = gw.plans["a"].compiled, gw.plans["b"].compiled
    imgs = _images(ca, 6, seed=6)

    async def main():
        async with gw:
            fa = [await gw.submit(img, plan_id="a") for img in imgs[:3]]
            fb = [await gw.submit(img, plan_id="b") for img in imgs[3:]]
            return (await asyncio.gather(*fa), await asyncio.gather(*fb))

    outs_a, outs_b = asyncio.run(main())
    np.testing.assert_array_equal(np.stack(outs_a),
                                  _ref_out(ca, imgs[:3]))
    np.testing.assert_array_equal(np.stack(outs_b),
                                  _ref_out(cb, imgs[3:]))
    assert gw.stats()["plans"] == {"a": 3, "b": 3}


def test_multi_plan_outputs_equal_reference_gateway(plan, ref_plan):
    """Both gateways with two plans (the reference's weights under keys 0
    and 7) serve interleaved requests to equal outputs per plan, with
    the same sharing of compiled layers."""
    cfg = AsyncServeConfig(max_batch=4, max_pending=16)
    ref_gw = ref_serve.AsyncCNNGateway(cfg)
    gw = AsyncCNNGateway(cfg)
    for pid, seed in (("a", 0), ("b", 7)):
        ref_gw.register_plan(ref_plan, plan_id=pid,
                             key=jax.random.PRNGKey(seed))
        gw.register_plan(plan, plan_id=pid, device="cpu",
                         params=_params(plan, _ref_weights(ref_plan, seed)))
    assert gw.exec_cache.compiles == ref_gw.exec_cache.compiles
    imgs = ref_gw.plans["a"].compiled.sample_inputs(8, 2)
    routes = ["a", "b", "b", "a", "b", "a", "a", "b"]

    def run(g):
        async def main():
            async with g:
                futs = [await g.submit(img, plan_id=pid)
                        for img, pid in zip(imgs, routes)]
                return await asyncio.gather(*futs)
        return asyncio.run(main())

    outs, ref_outs = run(gw), run(ref_gw)
    for a, b in zip(outs, ref_outs):
        assert np.array_equal(a, np.asarray(b))
    assert gw.stats()["plans"] == ref_gw.stats()["plans"] \
        == {"a": 4, "b": 4}
    # the two plans' weights differ, so their outputs do
    assert not np.array_equal(outs[0], gw.plans["b"].compiled(imgs[0])
                              .numpy())


def test_gateway_failed_dispatch_fails_futures_instead_of_hanging(
        plan, ref_plan):
    """A dispatch error other than DispatchAborted propagates into every
    affected future — stranding them pending would hang clients."""
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=4))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 2)

    class _Exploding:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def __call__(self, *a, **k):
            raise RuntimeError("device exploded")

    gw.plans["plan0"].compiled = _Exploding(compiled)

    async def main():
        async with gw:
            futs = [await gw.submit(img) for img in imgs]
            return await asyncio.gather(*futs, return_exceptions=True)

    done = asyncio.run(main())
    assert all(isinstance(d, RuntimeError)
               and "device exploded" in str(d) for d in done)
    stats = gw.stats()
    assert stats["served"] == 0 and stats["pending"] == 0
    assert stats["failed"] == 2


def test_gateway_dispatches_in_its_worker_thread(plan, ref_plan):
    """Dispatches run in the gateway's one worker thread, never on the
    event loop's, and each result is a host array before its future
    resolves."""
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=8))
    compiled = gw.plans["plan0"].compiled
    threads = []

    class _Recording:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def __call__(self, *a, **k):
            threads.append(threading.current_thread().name)
            return self._inner(*a, **k)

    gw.plans["plan0"].compiled = _Recording(compiled)
    imgs = _images(compiled, 5, seed=12)
    outs = _serve_all(gw, imgs)
    assert all(isinstance(o, np.ndarray) for o in outs)
    np.testing.assert_array_equal(np.stack(outs), _ref_out(compiled, imgs))
    assert len(threads) >= 3
    assert all(t.startswith("repro-serve") for t in threads)
    assert threading.current_thread().name not in threads


def test_gateway_has_no_sync_drain(plan, ref_plan):
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=4))
    with pytest.raises(TypeError, match="no sync drain"):
        gw.run([])
    with pytest.raises(TypeError, match="continuously"):
        gw.step()


def test_gateway_validates_images_at_the_door(plan, ref_plan):
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=4))

    async def main():
        async with gw:
            with pytest.raises(ValueError, match="image shape"):
                gw.submit_nowait(np.zeros((3, 3, 1), np.int8))
            with pytest.raises(ValueError, match="non-integral"):
                gw.submit_nowait(np.full(
                    gw.plans["plan0"].compiled.in_shape, 0.5, np.float32))
            with pytest.raises(ValueError, match="unknown plan id"):
                gw.submit_nowait(np.zeros((3, 3, 1), np.int8),
                                 plan_id="nope")

    asyncio.run(main())
    assert gw.stats()["served"] == 0


def test_gateway_policy_matches_sync_engine_ordering():
    """The gateway and the sync drain schedule identically: same policy
    object, same keys, same realized order."""
    pol = get_policy("edf")
    reqs = [_req(0, deadline=9.0), _req(1, deadline=3.0),
            _req(2), _req(3, priority=2)]
    q = AdmissionQueue(max_pending=8, policy=pol)
    for r in reqs:
        q.admit(r, 0.0)
    _, batch = q.pop_batch(8, 0.0)
    assert [r.request_id for r in batch] \
        == [r.request_id for r in pol.order(reqs, 0.0)]


# ---------------------------------------------------------------------------
# lifecycle: cancellation, close, shedding, chunks
# ---------------------------------------------------------------------------

def test_gateway_cancel_under_backpressure_recovers_full_bound(plan,
                                                               ref_plan):
    """Repeatedly fill the admission bound, cancel every queued future,
    refill: each cancellation frees exactly one slot of the bound."""
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=4))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 4, seed=13)

    async def main():
        async with gw:
            for _ in range(5):
                futs = [gw.submit_nowait(img) for img in imgs]
                with pytest.raises(GatewayBacklog):
                    gw.submit_nowait(imgs[0])
                for f in futs:
                    f.cancel()
                await asyncio.gather(*futs, return_exceptions=True)
                assert len(gw.queue) == 0
            futs = [gw.submit_nowait(img) for img in imgs]
            return await asyncio.gather(*futs)

    outs = asyncio.run(main())
    assert all(isinstance(o, np.ndarray) for o in outs)
    stats = gw.stats()
    assert stats["cancelled"] == 20 and stats["served"] == 4
    assert stats["pending"] == 0


def test_cancel_frees_the_bound_before_cancel_returns(plan, ref_plan):
    """Invariant 2: when ``cancel()`` on a submitted future returns, its
    request is cancelled, its slot of the bound is free and it is
    counted — no loop turn in between.  Five rounds of fill, cancel,
    refill leave ``len(gw.queue) == 0`` straight after each gather."""
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=4))
    imgs = _images(gw.plans["plan0"].compiled, 4, seed=13)

    async def main():
        async with gw:
            for rnd in range(5):
                futs = [gw.submit_nowait(img) for img in imgs]
                assert gw.queue.full
                for k, f in enumerate(futs):
                    assert f.cancel()
                    assert len(gw.queue) == 3 - k
                    assert gw.cancelled == 5 * rnd + k + 1
                # the freed bound admits at once, still without a yield
                refill = gw.submit_nowait(imgs[0])
                assert refill.cancel() and len(gw.queue) == 0
                await asyncio.gather(*futs, refill, return_exceptions=True)
                assert len(gw.queue) == 0
                assert not refill.cancel()      # terminal: no recount
            return gw.cancelled

    assert asyncio.run(main()) == 25
    assert gw.stats()["served"] == 0 and gw.stats()["cancelled"] == 25


def test_gateway_close_resolves_backpressured_submitters(plan, ref_plan):
    """Submitters parked at the admission bound when the gateway closes
    all resolve — admitted and served, or failed with "closing"."""
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=2))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 8, seed=14)

    async def main():
        async with gw:
            queued = [gw.submit_nowait(img) for img in imgs[:2]]
            waiters = [asyncio.ensure_future(gw.submit(img))
                       for img in imgs[2:]]
            await asyncio.sleep(0)      # park them at the bound
        futs = await asyncio.wait_for(asyncio.gather(*waiters), 10.0)
        return await asyncio.wait_for(
            asyncio.gather(*queued, *futs, return_exceptions=True),
            10.0)

    outs = asyncio.run(main())
    assert all(isinstance(o, (np.ndarray, RuntimeError)) for o in outs)
    failed = [o for o in outs if isinstance(o, RuntimeError)]
    assert sum(isinstance(o, np.ndarray) for o in outs) \
        + len(failed) == 8
    assert all("closing" in str(e) for e in failed)
    assert gw.stats()["pending"] == 0


def test_gateway_class_aware_shedding_at_the_bound(plan, ref_plan):
    """At the bound a higher-class arrival ejects the least-urgent
    pending request: the victim's future raises ``GatewayBacklog``, the
    arrival is served, and a same-class arrival is still refused."""
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=2,
                                                   policy="edf"))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 4, seed=15)

    async def main():
        async with gw:
            lo = [gw.submit_nowait(img, priority=0)
                  for img in imgs[:2]]
            hi = gw.submit_nowait(imgs[2], priority=5)
            with pytest.raises(GatewayBacklog):
                gw.submit_nowait(imgs[3], priority=0)
            return await asyncio.gather(*lo, hi,
                                        return_exceptions=True)

    done = asyncio.run(main())
    shed = [d for d in done[:2] if isinstance(d, GatewayBacklog)]
    assert len(shed) == 1                  # exactly one victim
    assert isinstance(done[2], np.ndarray)  # the high-class arrival
    assert sum(isinstance(d, np.ndarray) for d in done) == 2
    stats = gw.stats()
    assert stats["shed"] == 1 and stats["rejected"] == 1
    assert stats["served"] == 2


def _fake_clock_run(gw, clock, imgs):
    """A fixed trace on a fake clock: five submits at t = 0 (deadlines
    5, 1 and none at priority 0, one at priority 5 that sheds a victim,
    one at priority 0 refused), then the clock jumps to t = 2 before
    the drain runs.  Returns {request index: outcome}."""
    trace = [(0, 5.0), (0, 1.0), (0, None), (5, None), (0, None)]

    async def main():
        async with gw:
            futs = {}
            for i, (prio, dl) in enumerate(trace):
                try:
                    futs[i] = gw.submit_nowait(imgs[i], priority=prio,
                                               deadline=dl)
                except Exception as e:          # noqa: BLE001
                    futs[i] = e
            clock[0] = 2.0
            keys = [i for i, f in futs.items()
                    if not isinstance(f, Exception)]
            done = await asyncio.gather(*(futs[i] for i in keys),
                                        return_exceptions=True)
            out = {i: f for i, f in futs.items() if isinstance(f, Exception)}
            out.update(zip(keys, done))
            return out

    def outcome(x):
        if isinstance(x, Exception):
            return type(x).__name__
        return np.asarray(x)

    return {i: outcome(x) for i, x in asyncio.run(main()).items()}


def test_fake_clock_expiry_and_shedding_match_reference(plan, ref_plan):
    """On one fake-clock trace the port's and the reference's gateways
    serve, expire, shed and refuse the same requests, and serve them to
    equal outputs."""
    cfg = AsyncServeConfig(max_batch=2, max_pending=3, policy="edf")
    t_ref, t_port = [0.0], [0.0]
    ref_gw = ref_serve.AsyncCNNGateway.from_plan(
        ref_plan, cfg, clock=lambda: t_ref[0])
    gw = _gateway(plan, ref_plan, cfg, clock=lambda: t_port[0])
    imgs = ref_gw.plans["plan0"].compiled.sample_inputs(5, 21)
    ref_out = _fake_clock_run(ref_gw, t_ref, imgs)
    out = _fake_clock_run(gw, t_port, imgs)
    kinds = {i: (o if isinstance(o, str) else "served")
             for i, o in out.items()}
    assert kinds == {i: (o if isinstance(o, str) else "served")
                     for i, o in ref_out.items()}
    assert kinds == {0: "served", 1: "DeadlineExpired",
                     2: "GatewayBacklog", 3: "served", 4: "GatewayBacklog"}
    for i, k in kinds.items():
        if k == "served":
            assert np.array_equal(out[i], ref_out[i])
    mine, theirs = gw.stats(), ref_gw.stats()
    for key in ("served", "expired", "shed", "rejected"):
        assert mine[key] == theirs[key], key


def test_gateway_submit_chunk_partial_admission(plan, ref_plan):
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=3))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 5, seed=16)

    async def main():
        async with gw:
            futs, refused = gw.submit_chunk(imgs)  # no yields: bound=3
            assert len(futs) == 3 and refused == 2
            outs = await asyncio.gather(*futs)
            futs2, refused2 = gw.submit_chunk(imgs[:2])
            assert refused2 == 0
            return outs, await asyncio.gather(*futs2)

    outs, outs2 = asyncio.run(main())
    assert len(outs) == 3 and len(outs2) == 2
    assert gw.stats()["rejected"] == 1     # chunk stops at the refusal


# ---------------------------------------------------------------------------
# adaptive admission and configuration
# ---------------------------------------------------------------------------

def test_slot_pool_rate_estimator_busy_runs_and_idle_gaps():
    t = [0.0]
    pool = SlotPool(max_batch=8, clock=lambda: t[0])
    assert pool.service_rate == 0.0 and pool.service_rate_slow == 0.0
    t[0] = 0.1
    pool._note_step(8, launched_at=0.0)
    assert pool.service_rate == pytest.approx(80.0)
    assert pool.service_rate_slow == pytest.approx(80.0)
    # an idle gap, then a fresh run at the same speed: no dilution
    t[0] = 100.1
    pool._note_step(8, launched_at=100.0)
    assert pool.service_rate == pytest.approx(80.0)
    for _ in range(6):
        t0 = t[0]
        t[0] += 0.01                   # 8 images / 10 ms = 800 img/s
        pool._note_step(8, launched_at=t0)
    assert pool.service_rate > 400.0
    assert pool.service_rate_slow < pool.service_rate
    snap = pool.snapshot(queue_depth=40)
    assert snap.service_rate == pool.service_rate
    assert snap.est_wait == pytest.approx(40 / pool.service_rate)


def test_gateway_adaptive_bound_tracks_measured_rate():
    t = [0.0]
    gw = AsyncCNNGateway(
        AsyncServeConfig(max_batch=4, max_pending=64, min_pending=6,
                         wait_budget_s=0.5),
        clock=lambda: t[0])
    gw._adapt_bound(force=True)
    assert gw.queue.max_pending == 6
    t[0] = 0.1
    gw._note_step(4, launched_at=0.0)
    gw._adapt_bound(force=True)
    assert gw.queue.max_pending == 20          # ceil(40 img/s × 0.5 s)
    for _ in range(200):
        t0 = t[0]
        t[0] += 0.001                  # 4000 img/s, far past the cap
        gw._note_step(4, launched_at=t0)
    gw._adapt_bound(force=True)
    assert gw.queue.max_pending == 64
    gw2 = AsyncCNNGateway(AsyncServeConfig(max_batch=4, max_pending=7))
    gw2._adapt_bound(force=True)
    assert gw2.queue.max_pending == 7


def test_async_serve_config_validation_and_pool_sizing():
    with pytest.raises(ValueError, match="max_inflight"):
        AsyncCNNGateway(AsyncServeConfig(max_batch=2, max_inflight=0))
    with pytest.raises(ValueError, match="wait_budget_s"):
        AsyncCNNGateway(AsyncServeConfig(max_batch=2,
                                         wait_budget_s=0.0))
    with pytest.raises(ValueError, match="min_pending"):
        AsyncCNNGateway(AsyncServeConfig(max_batch=2, min_pending=0))
    with pytest.raises(ValueError, match="batch_linger"):
        AsyncCNNGateway(AsyncServeConfig(max_batch=2,
                                         batch_linger=-0.1))
    gw = AsyncCNNGateway(AsyncServeConfig(max_batch=4, max_inflight=2))
    assert gw.free_slots() == 8 and gw.cfg.max_batch == 4


def test_register_plan_refuses_unported_kind_and_missing_card(
        plan, monkeypatch):
    """A still-unknown workload kind raises at registration, never in a
    dispatch (``ValueError``, or ``NotImplementedError`` for a kind the
    reference serves and the port does not yet), and a ``moe`` plan now
    registers; ``cuda`` without a card raises; a compiled model
    narrower than the slot pool is refused."""
    from repro_torch.runtime import workloads

    class _RnnSpec:
        kind = "rnn"

    rnn = dataclasses.replace(plan, workload=_RnnSpec())
    gw = AsyncCNNGateway(AsyncServeConfig(max_batch=2))
    with pytest.raises(ValueError, match="unknown workload kind 'rnn'"):
        gw.register_plan(rnn, device="cpu")
    with monkeypatch.context() as m:
        m.setitem(workloads._NOT_YET_PORTED, "rnn", "a recurrent workload")
        with pytest.raises(NotImplementedError, match="'rnn'.*not yet"):
            gw.register_plan(rnn, device="cpu")
    assert gw.plans == {}
    layer = workloads.MoELayerSpec(d_ff_expert=16, num_experts=4, top_k=2)
    moe = workloads.plan_moe_deployment(
        workloads.MoEWorkloadSpec(layers=(layer,), d_model=8, seq_len=8),
        "v5e")
    assert gw.register_plan(moe, plan_id="moe", device="cpu") == "moe"
    assert gw.plans["moe"].kind == "moe"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        AsyncCNNGateway.from_plan(plan)
    narrow = CompiledCNN.from_plan(plan, max_batch=1, device="cpu",
                                   warmup=False)
    with pytest.raises(ValueError, match="smaller than"):
        gw.register_plan(plan, compiled=narrow)


# ---------------------------------------------------------------------------
# runtime: shared cache + cancellation-safe dispatch
# ---------------------------------------------------------------------------

def _port_cfg():
    return CNNConfig(layers=(
        ConvLayerSpec(1, 4, data_bits=8, coeff_bits=6, block="conv4"),
        ConvLayerSpec(4, 3, data_bits=6, coeff_bits=4, block="conv3"),
    ), img_h=16, img_w=64)


def test_compiled_cnn_shares_executables_across_instances():
    cfg = _port_cfg()
    params = init_cnn(torch.Generator().manual_seed(0), cfg)
    blocks = [s.block for s in cfg.layers]
    cache = ExecutableCache()
    a = CompiledCNN(cfg, params, blocks, max_batch=4, device="cpu",
                    exec_cache=cache)
    n = cache.compiles
    assert n == len(cache) == len(a.buckets) * len(cfg.layers)
    b = CompiledCNN(cfg, params, blocks, max_batch=4, device="cpu",
                    exec_cache=cache)
    assert cache.compiles == n and b.compiles == 0   # all cache hits
    assert b.warmed_up
    x = np.stack(_images(a, 3, seed=8))
    assert torch.equal(a(x), b(x))


def test_compiled_cnn_dispatch_abort():
    cfg = _port_cfg()
    params = init_cnn(torch.Generator().manual_seed(0), cfg)
    cnn = CompiledCNN(cfg, params, [s.block for s in cfg.layers],
                      max_batch=2, device="cpu")
    x = np.stack(_images(cnn, 1, seed=9))
    with pytest.raises(DispatchAborted):
        cnn(x, should_abort=lambda: True)
    y = cnn(x, should_abort=lambda: False)
    assert torch.equal(y, cnn_forward_ref(params, torch.from_numpy(x), cfg))


# ---------------------------------------------------------------------------
# the GatewayStats snapshot seam (shared by SlotPool and the gateway)
# ---------------------------------------------------------------------------

def test_slot_pool_and_gateway_share_the_snapshot_seam(plan, ref_plan):
    pool = SlotPool(max_batch=3)
    snap = pool.snapshot(clock=lambda: 12.5)
    assert isinstance(snap, GatewayStats)
    assert snap.timestamp == 12.5
    assert snap.queue_depth == 0 and snap.inflight == 0
    assert snap.depth == 0 and snap.max_batch == 3
    assert pool.stats()["occupancy_hist"] == {}

    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=8))
    gsnap = gw.snapshot()
    assert isinstance(gsnap, GatewayStats)
    assert gsnap.max_batch == 2 and gsnap.depth == 0
    d = gsnap.asdict()
    for key in ("timestamp", "queue_depth", "inflight", "max_batch",
                "steps", "occupancy_hist", "served", "rejected",
                "expired", "cancelled", "failed"):
        assert key in d, key
    stats = gw.stats()
    assert stats["served"] == 0 and stats["failed"] == 0
    assert stats["inflight"] == 0


def test_gateway_snapshot_tracks_queue_and_terminals(plan, ref_plan):
    gw = _gateway(plan, ref_plan, AsyncServeConfig(max_batch=2,
                                                   max_pending=8))
    compiled = gw.plans["plan0"].compiled
    imgs = _images(compiled, 5, seed=11)

    async def main():
        async with gw:
            futs = [gw.submit_nowait(img) for img in imgs]
            pre = gw.snapshot()
            assert pre.queue_depth == 5 and pre.depth == 5
            outs = await asyncio.gather(*futs)
            return pre, outs

    pre, outs = asyncio.run(main())
    post = gw.snapshot()
    assert post.queue_depth == 0 and post.inflight == 0
    assert post.served == len(outs) == 5
    assert post.steps >= 3            # max_batch=2 → ≥ ceil(5/2) steps
    assert sum(k * v for k, v in post.occupancy_hist.items()) == 5


# ---------------------------------------------------------------------------
# the launcher's --async path, the tracker seam and --plan-store
# ---------------------------------------------------------------------------

def test_launcher_async_on_cpu(tmp_path, capsys):
    """``--async`` through ``main`` on the CPU: the pinned plan with the
    golden weights under Poisson arrivals; every request is served, shed
    or expired, none fails, and ``--metrics-out`` leaves a sealed log."""
    metrics = tmp_path / "m.jsonl"
    launcher.main([
        "--workload", "cnn", "--async", "--plan", str(PINNED),
        "--params", str(GOLDEN), "--requests", "24", "--max-batch", "4",
        "--occupancy", "2.0", "--max-pending", "8",
        "--metrics-out", str(metrics), "--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert "full-batch step" in out and "offered load" in out
    assert "on cpu" in out and "latency p50=" in out
    assert "pending bound: 8 (static)" in out
    log = read_log(metrics)
    assert log.sealed and log.dropped == 0
    events = [e["event"] for e in log.events]
    assert "plan_registered" in events and "dispatch_complete" in events
    last = [e for e in log.events if e["event"] == "stats"][-1]["metrics"]
    assert last["failed"] == 0 and last["served"] > 0


def test_run_cnn_async_conserves_requests_and_matches_golden():
    gw, res = launcher.run_cnn_async(launcher.parse_args([
        "--async", "--plan", str(PINNED), "--params", str(GOLDEN),
        "--requests", "16", "--max-batch", "4", "--occupancy", "0.5",
        "--deadline-ms", "60000", "--wait-budget-ms", "50",
        "--torch-device", "cpu"]), keep_every=3)
    assert res["served"] + res["shed"] + res["expired"] == 16
    assert res["failed"] == 0 and res["served"] > 0
    assert res["step_ms"] > 0 and res["p50_ms"] <= res["p99_ms"]
    assert res["achieved_offered_per_s"] > 0
    assert res["producer_lag_max_ms"] >= res["producer_lag_p50_ms"]
    assert gw.stats()["wait_budget_s"] == 0.05
    with np.load(GOLDEN) as z:
        gx, gy = z[f"{PINNED.stem}.x"], z[f"{PINNED.stem}.y"]
    compiled = gw.plans["plan0"].compiled
    assert np.array_equal(compiled(gx).numpy(), gy)
    # the served outputs it kept (indices 0, 3, ...) are the reference
    # forward's of their images
    kept = res["outputs"]
    assert kept and all(i % 3 == 0 for i, _, _ in kept)
    assert [i for i, _, _ in kept] == sorted({i for i, _, _ in kept})
    want = cnn_forward_ref(compiled.params,
                           torch.from_numpy(np.stack([x for _, x, _ in kept])),
                           compiled.cfg).numpy()
    assert np.array_equal(np.stack([y for _, _, y in kept]), want)
    # every served request went through a dispatch with stage stamps
    assert res["dispatches"] == len(gw.stage_log) > 0
    assert sum(d.n for d in gw.stage_log) == res["served"]
    for d in gw.stage_log:
        assert min(d) >= 0 and d.forward > 0
    stages = res["stages_ms"]
    assert set(stages) == set(launcher._STAGES) | {"total"}
    assert stages["total"]["max"] >= res["slowest_dispatch"]["total_ms"] \
        - 1e-9
    assert 0 < res["worker_busy"] <= 1


def test_launcher_tracks_the_sync_path(tmp_path):
    metrics = tmp_path / "m.jsonl"
    launcher.run_cnn(launcher.parse_args([
        "--plan", str(PINNED), "--requests", "3", "--max-batch", "2",
        "--metrics-out", str(metrics), "--torch-device", "cpu"]))
    log = read_log(metrics)
    assert log.sealed
    stats = [e for e in log.events if e["event"] == "stats"]
    assert stats and stats[-1]["source"] == "engine"
    assert stats[-1]["metrics"]["images_served"] == 3


def test_plan_store_flag_plans_once_then_loads(tmp_path, capsys):
    """``--plan-store``: the first launch plans and stores under
    ``cnn-<device>``; the next loads the stored plan without planning,
    and the reference's store reads it too."""
    args = launcher.parse_args(["--plan-store", str(tmp_path),
                                "--device", "v5e", "--torch-device", "cpu"])
    planned = load_plan(PINNED)
    calls = []

    def compute():
        calls.append(1)
        return planned

    first = launcher._plan_from_store(args, "cnn", compute)
    second = launcher._plan_from_store(args, "cnn", compute)
    assert calls == [1]
    assert first.to_json() == second.to_json() == planned.to_json()
    assert PlanStore(tmp_path).list_plans() == ["cnn-v5e"]
    assert ref_ops.PlanStore(tmp_path).load("cnn-v5e").to_json() \
        == planned.to_json()
    out = capsys.readouterr().out
    assert "saved to store" in out and "loaded plan 'cnn-v5e'" in out
    # the launcher's plan resolution reads the store when --plan is absent
    assert launcher.cnn_plan(args).to_json() == planned.to_json()
