"""``Fleet`` — the plan-aware multi-worker serving front door.

Port of ``repro.fleet.fleet`` over the port's ``AsyncCNNGateway``.  One
invariant the reference does not keep holds here: cancelling a future
the fleet returned settles the cancellation before ``cancel()``
returns (``_FleetFuture``) — the request leaves its worker's
outstanding set, a probe it was the canary of is released
(``note_neutral``), and the worker's future is cancelled, which in the
port's gateway cancels the request itself at once.  The reference does
this from a done-callback a loop turn or more later, and a worker whose
canary was cancelled can read as probing until then.  And a request a
gateway sheds for a higher-class arrival (``GatewayBacklog``) is a load
signal, not a worker fault: it is retried elsewhere without a health
strike, where the reference's strike ejects busy, healthy workers and
leaves a fleet at its admission bounds refusing everything.

One ``AsyncCNNGateway`` serves one process; a ``Fleet`` serves a
*heterogeneous set* of them — each worker running its own deployment
plan on its own ``DeviceProfile`` — behind a single ``submit`` /
``submit_nowait`` door with the same semantics the gateway has
(``submit`` awaits admission = backpressure; ``submit_nowait`` raises
when nothing can take the request = shedding).  Per request the fleet:

  route      builds one ``WorkerView`` per worker from a consistent
             ``GatewayStats`` snapshot and asks the ``Router`` (plan-
             aware by default: deadline-tight → fastest, best-effort →
             cheapest that fits) to place the request.  The router
             never sees — and so can never pick — a worker that lacks
             the plan, is draining, or is unhealthy.
  health     every outcome feeds the worker's ``WorkerHealth`` machine:
             ``eject_after`` consecutive failures eject it from
             routing; after ``probe_interval`` the router may send one
             canary, and a served canary re-admits the worker.  A
             failed request is retried on another worker (bounded by
             ``max_retries``) before the caller sees the error.
  drain      ``drain(worker_id)`` stops new admissions to the worker,
             pulls its queued-but-not-dispatched requests back out of
             the gateway (``extract_queued``) and re-routes them, then
             waits for its in-flight batches to finish — zero admitted
             requests lost, the invariant the fleet benchmark and the
             regression tests pin.

The fleet tracks each client request as a ``FleetRequest`` whose
deadline stays anchored to *first* admission: re-routes and retries
spend the same budget, so a detour can never smuggle a request past
its SLA.  Deadlines are handed to workers as remaining-relative
seconds, so a fleet and its gateways need not share a clock epoch.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.chaos.inject import WorkerCrashed
from repro_torch.fleet.router import Router, RouterLike, get_router
from repro_torch.fleet.worker import FleetWorker
from repro_torch.serve.async_engine import DeadlineExpired, GatewayBacklog

#: gateway scheduling priority per tier — interactive preempts batch
#: preempts best-effort inside every worker's EDF admission queue
TIER_PRIORITY = {"interactive": 2, "batch": 1, "best_effort": 0}


class FleetError(RuntimeError):
    """Base class for fleet routing/admission failures."""


class NoWorkerAvailable(FleetError):
    """No healthy, non-draining worker serves the request's plan."""


class FleetSaturated(FleetError, GatewayBacklog):
    """Every admissible worker's admission queue is at its bound —
    the fleet-level analogue of ``GatewayBacklog`` (and a subclass of
    it, so gateway-aware shedding code handles fleets unchanged)."""


@dataclass(eq=False)               # identity hash — requests live in sets
class FleetRequest:
    """One client request as the fleet tracks it across workers."""
    image: np.ndarray
    plan_id: str
    tier: str
    priority: int
    deadline: Optional[float]      # absolute on the *fleet* clock
    request_id: int
    future: "asyncio.Future"
    attempts: int = 0
    client_cancelled: bool = False
    worker_fut: Optional["asyncio.Future"] = field(default=None,
                                                   repr=False)
    worker: Optional[FleetWorker] = field(default=None, repr=False)
    # the client's cancel() settled the request with its worker
    settled: bool = False


class _FleetFuture(asyncio.Future):
    """The future ``submit``/``submit_nowait`` return.  ``request`` is
    the ``FleetRequest`` it resolves (its ``worker`` the worker it was
    last handed to: the one that served it, once done).  ``cancel()``
    settles the cancellation in the fleet (``Fleet._client_cancelled``)
    before it returns, where a done-callback would run a loop turn
    later."""

    def __init__(self, fleet: "Fleet", *, loop):
        super().__init__(loop=loop)
        self._fleet = fleet
        self.request: Optional[FleetRequest] = None

    def cancel(self, msg=None) -> bool:
        if not super().cancel(msg):
            return False
        if self.request is not None:
            self._fleet._client_cancelled(self.request)
        return True


class Fleet:
    """The front door.  Typical lifecycle::

        fleet = Fleet([FleetWorker("edge0", gw_edge, "edge"),
                       FleetWorker("v5e0", gw_v5e, "v5e"),
                       FleetWorker("v5p0", gw_v5p, "v5p")],
                      router="plan_aware")
        async with fleet:
            fut = await fleet.submit(img, tier="interactive",
                                     deadline=0.25)
            out = await fut
            await fleet.drain("v5e0")      # zero requests lost
    """

    def __init__(self, workers: Sequence[FleetWorker],
                 router: RouterLike = "plan_aware", *,
                 max_retries: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 tracker=None):
        if not workers:
            raise ValueError("a fleet needs at least one worker")
        ids = [w.worker_id for w in workers]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids: {sorted(ids)}")
        if max_retries < 0:
            raise ValueError(f"max_retries={max_retries} must be ≥ 0")
        self.workers: Dict[str, FleetWorker] = {
            w.worker_id: w for w in sorted(workers,
                                           key=lambda w: w.worker_id)}
        self.router: Router = get_router(router)
        self.max_retries = max_retries
        self.clock = clock
        # ops telemetry sink (repro_torch.ops.Tracker): worker lifecycle
        # events (ejected/probed/readmitted), plan rollout/retire
        self.tracker = tracker
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tasks: set = set()
        self._next_id = 0
        self._closing = False
        # fleet-level counters (mutated on the loop thread)
        self.served = 0
        self.expired = 0
        self.cancelled = 0
        self.rerouted = 0
        self.retried = 0
        self.worker_failures = 0
        self.drains = 0
        self.kills = 0
        self.respawns = 0

    def _track(self, event: str, **fields) -> None:
        if self.tracker is not None:
            self.tracker.log_event(event, **fields)

    # -- lifecycle --------------------------------------------------------
    def _ensure_started(self) -> None:
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
        elif self._loop is not loop:
            raise RuntimeError("fleet is bound to a different event loop")

    async def __aenter__(self) -> "Fleet":
        self._ensure_started()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        """Let every worker drain its queue, then shut all of them
        down.  In-flight re-route tasks are awaited first so nothing
        is submitted into a closing gateway."""
        self._closing = True
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        for w in self.workers.values():
            await w.gateway.close()

    # -- admission --------------------------------------------------------
    def _resolve_plan(self, plan_id: Optional[str]) -> str:
        if plan_id is not None:
            return plan_id
        for w in self.workers.values():
            for pid in w.gateway.plans:
                return pid
        raise FleetError("no plan registered on any worker")

    def _make_request(self, image, plan_id, tier, priority, deadline
                      ) -> FleetRequest:
        if tier not in TIER_PRIORITY:
            raise ValueError(f"unknown tier {tier!r}; known: "
                             f"{sorted(TIER_PRIORITY)}")
        now = self.clock()
        fut = _FleetFuture(self, loop=self._loop)
        fr = FleetRequest(
            image=image, plan_id=self._resolve_plan(plan_id), tier=tier,
            priority=priority, request_id=self._next_id,
            deadline=None if deadline is None else now + deadline,
            future=fut)
        fut.request = fr
        self._next_id += 1
        return fr

    def _client_cancelled(self, fr: FleetRequest) -> None:
        """The client cancelled ``fr``'s future.  While a worker holds
        the request, settle it now: the worker did nothing wrong, but
        it may have been mid-probe with this very request as its
        canary — release the probe (``note_neutral``), or an ejected
        worker could stay "probing" and never be routable again.  Then
        cancel the worker's future, which cancels the gateway request
        before it returns.  With no worker yet (admission still
        awaited), ``_attach`` settles it; with the worker's outcome
        already in, ``_on_worker_done`` does."""
        fr.client_cancelled = True
        wfut, worker = fr.worker_fut, fr.worker
        if wfut is None or wfut.done() or fr.settled:
            return
        fr.settled = True
        self._release(worker, fr)
        worker.health.note_neutral()
        self.cancelled += 1
        wfut.cancel()

    def submit_nowait(self, image, *, plan_id: Optional[str] = None,
                      tier: str = "best_effort", priority: int = 0,
                      deadline: Optional[float] = None
                      ) -> "asyncio.Future":
        """Route and admit one image, or raise: ``NoWorkerAvailable``
        when no admissible worker serves the plan (health/drain),
        ``FleetSaturated`` when every admissible worker's admission
        queue is at its bound.  ``deadline`` is relative seconds from
        now and is spent across any re-routes or retries."""
        self._ensure_started()
        if self._closing:
            raise RuntimeError("fleet is closing")
        fr = self._make_request(image, plan_id, tier, priority, deadline)
        excluded: set = set()
        while True:
            worker = self._select(fr, self.clock(), excluded)
            if worker is None:
                if excluded:
                    raise FleetSaturated(
                        f"every admissible worker for plan "
                        f"{fr.plan_id!r} is at its admission bound "
                        f"({sorted(excluded)}); retry with backoff or "
                        f"use `await fleet.submit(...)`")
                raise NoWorkerAvailable(
                    f"no healthy, non-draining worker serves plan "
                    f"{fr.plan_id!r}")
            try:
                wfut = worker.gateway.submit_nowait(
                    fr.image, plan_id=fr.plan_id,
                    priority=self._gateway_priority(fr),
                    deadline=self._remaining(fr))
            except GatewayBacklog:
                excluded.add(worker.worker_id)
                continue
            self._attach(fr, worker, wfut)
            return fr.future

    def submit_chunk(self, images, *, plan_id: Optional[str] = None,
                     tier: str = "best_effort", priority: int = 0,
                     deadline: Optional[float] = None
                     ) -> Tuple[list, int]:
        """Admit a batch of images *partially*: each image routes
        independently (so a chunk may span workers), and the first
        ``FleetSaturated`` stops admission — the admitted prefix is
        returned as ``(futures, refused)`` instead of all-or-nothing.
        ``NoWorkerAvailable`` still raises: a fleet with no admissible
        worker is an outage, not saturation."""
        futs: list = []
        for image in images:
            try:
                futs.append(self.submit_nowait(
                    image, plan_id=plan_id, tier=tier,
                    priority=priority, deadline=deadline))
            except FleetSaturated:
                return futs, len(images) - len(futs)
        return futs, 0

    async def submit(self, image, *, plan_id: Optional[str] = None,
                     tier: str = "best_effort", priority: int = 0,
                     deadline: Optional[float] = None
                     ) -> "asyncio.Future":
        """Route and admit one image, **awaiting** admission when the
        chosen worker's queue is at its bound — backpressure propagates
        to the producer, exactly like ``AsyncCNNGateway.submit``."""
        self._ensure_started()
        if self._closing:
            raise RuntimeError("fleet is closing")
        fr = self._make_request(image, plan_id, tier, priority, deadline)
        await self._route_and_admit(fr)
        if fr.worker_fut is None:
            await fr.future            # routing failed: raises the error
        return fr.future

    async def infer(self, image, **kw) -> np.ndarray:
        """Submit and await the result in one call."""
        fut = await self.submit(image, **kw)
        return await fut

    # -- routing core -----------------------------------------------------
    def _gateway_priority(self, fr: FleetRequest) -> int:
        return TIER_PRIORITY[fr.tier] * 16 + fr.priority

    def _remaining(self, fr: FleetRequest) -> Optional[float]:
        """Deadline budget left, as the relative seconds the worker
        gateway expects (anchored to first fleet admission)."""
        if fr.deadline is None:
            return None
        return fr.deadline - self.clock()

    def _views(self, now: float, excluded=frozenset()):
        return [w.view(now) for wid, w in self.workers.items()
                if wid not in excluded]

    def _select(self, fr: FleetRequest, now: float,
                excluded=frozenset()) -> Optional[FleetWorker]:
        view = self.router.select(fr.plan_id, fr.tier,
                                  self._views(now, excluded), now,
                                  deadline=fr.deadline)
        if view is None:
            return None
        worker = self.workers[view.worker_id]
        if worker.health.ejected:
            worker.health.begin_probe()   # this request is the canary
            self._track("worker_probe", worker_id=worker.worker_id,
                        probes=worker.health.probes)
        return worker

    def _attach(self, fr: FleetRequest, worker: FleetWorker,
                wfut: "asyncio.Future") -> None:
        fr.attempts += 1
        fr.worker_fut = wfut
        fr.worker = worker
        worker.outstanding.add(fr)
        wfut.add_done_callback(
            lambda f, fr=fr, w=worker: self._on_worker_done(fr, w, f))
        if fr.client_cancelled:
            # cancelled while its admission was awaited
            self._client_cancelled(fr)

    @staticmethod
    def _release(worker: FleetWorker, fr: FleetRequest) -> None:
        """``fr`` no longer owes ``worker`` anything: wake ``drain``
        when the worker's last request leaves."""
        worker.outstanding.discard(fr)
        if not worker.outstanding:
            for ev in worker._idle_waiters:
                ev.set()

    def _spawn(self, coro) -> None:
        task = self._loop.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _route_and_admit(self, fr: FleetRequest,
                               excluded=frozenset()) -> None:
        """Route ``fr`` and admit it with backpressure; terminal
        routing failures resolve the client future instead of raising
        (callers on the re-route path are fire-and-forget tasks)."""
        if fr.future.done():
            return
        now = self.clock()
        if fr.deadline is not None and now > fr.deadline:
            self.expired += 1
            fr.future.set_exception(DeadlineExpired(
                f"fleet request {fr.request_id} deadline passed "
                f"before (re-)admission"))
            return
        worker = self._select(fr, now, excluded)
        if worker is None:
            fr.future.set_exception(NoWorkerAvailable(
                f"no healthy, non-draining worker serves plan "
                f"{fr.plan_id!r}"))
            return
        try:
            wfut = await worker.gateway.submit(
                fr.image, plan_id=fr.plan_id,
                priority=self._gateway_priority(fr),
                deadline=self._remaining(fr))
        except Exception as e:          # noqa: BLE001 — gateway closing
            if not fr.future.done():    # or admission-time validation
                fr.future.set_exception(e)
            return
        self._attach(fr, worker, wfut)

    # -- outcome handling -------------------------------------------------
    def _on_worker_done(self, fr: FleetRequest, worker: FleetWorker,
                        wfut) -> None:
        if fr.settled:
            return                  # the client's cancel() settled it
        self._release(worker, fr)
        if wfut.cancelled():
            if fr.client_cancelled:
                # the *client* walked away — the worker did nothing
                # wrong, but it may have been mid-probe with this very
                # request as its canary: leave the probe state cleared
                # (note_neutral), or an ejected worker would stay
                # "probing" forever and never become routable again
                worker.health.note_neutral()
                self.cancelled += 1
                if not fr.future.done():
                    fr.future.cancel()
                return
            # drain eviction: the worker gave the request back — route
            # it to another worker on the same deadline budget
            self.rerouted += 1
            self._spawn(self._route_and_admit(fr))
            return
        exc = wfut.exception()
        if exc is None:
            was_ejected = worker.health.ejected
            worker.health.note_success()
            if was_ejected:
                self._track("worker_readmitted",
                            worker_id=worker.worker_id)
            self.served += 1
            if not fr.future.done():
                fr.future.set_result(wfut.result())
        elif isinstance(exc, DeadlineExpired):
            # the worker functioned; the request was simply late — no
            # health strike, but clear any outstanding probe
            worker.health.note_neutral()
            self.expired += 1
            if not fr.future.done():
                fr.future.set_exception(exc)
        elif isinstance(exc, WorkerCrashed):
            # the worker process died mid-dispatch (chaos-injected or
            # real): record the failure, declare the worker dead (kill
            # is idempotent and sweeps up its queued + in-flight
            # siblings) and re-route this request on its original
            # deadline budget *without* spending the bounded retry
            # budget — a crashed worker's requests are victims of the
            # crash, not evidence against the requests themselves
            self.worker_failures += 1
            worker.health.note_failure(self.clock())
            if not worker.dead:
                self.kill(worker.worker_id)
            if not fr.future.done():
                self.rerouted += 1
                self._spawn(self._route_and_admit(
                    fr, excluded=frozenset({worker.worker_id})))
        elif isinstance(exc, GatewayBacklog):
            # the gateway shed the request for a higher-class arrival:
            # a load signal, not a worker fault — no health strike (the
            # reference counts it as a failure, so a fleet at its
            # admission bounds ejects its busy, healthy workers and then
            # refuses everything), but a retry elsewhere within the
            # retry budget, on the original deadline
            worker.health.note_neutral()
            if fr.attempts <= self.max_retries and not fr.future.done():
                self.retried += 1
                self._spawn(self._route_and_admit(
                    fr, excluded=frozenset({worker.worker_id})))
            elif not fr.future.done():
                fr.future.set_exception(exc)
        else:
            self.worker_failures += 1
            was_ejected = worker.health.ejected
            worker.health.note_failure(self.clock())
            if worker.health.ejected and not was_ejected:
                self._track("worker_ejected",
                            worker_id=worker.worker_id,
                            ejections=worker.health.ejections)
            if fr.attempts <= self.max_retries and not fr.future.done():
                self.retried += 1
                self._spawn(self._route_and_admit(
                    fr, excluded=frozenset({worker.worker_id})))
            elif not fr.future.done():
                fr.future.set_exception(exc)

    # -- draining ---------------------------------------------------------
    async def drain(self, worker_id: str) -> FleetWorker:
        """Gracefully take ``worker_id`` out of service: stop new
        admissions (the router no longer sees it), re-route its queued
        requests to the rest of the fleet, and wait until its in-flight
        batches finish.  Zero admitted requests are lost: every evicted
        request re-enters routing with its original deadline budget.
        The worker stays registered (and drained) — flip ``.draining``
        back to False to re-admit it."""
        self._ensure_started()
        try:
            worker = self.workers[worker_id]
        except KeyError:
            raise FleetError(
                f"unknown worker {worker_id!r}; fleet has: "
                f"{sorted(self.workers)}") from None
        if not worker.draining:
            worker.draining = True
            self.drains += 1
            self._track("worker_draining", worker_id=worker_id)
            worker.gateway.extract_queued()   # futures cancel → re-route
        if worker.outstanding:
            ev = asyncio.Event()
            worker._idle_waiters.append(ev)
            try:
                await ev.wait()
            finally:
                worker._idle_waiters.remove(ev)
        return worker

    # -- kill / respawn (crash recovery) ----------------------------------
    def kill(self, worker_id: str) -> FleetWorker:
        """Declare ``worker_id`` dead *now* — the un-graceful cousin of
        ``drain``.  The worker becomes unroutable (``dead`` flag +
        ``force_eject``) and every request it still owes is re-routed
        on its **original** deadline budget: queued-but-undispatched
        requests come back through ``extract_queued`` and mid-dispatch
        ones have their worker futures cancelled — both resolve through
        the existing cancelled-not-by-client branch of the outcome
        machine, which re-routes.  Nothing is lost: a request that
        cannot be re-placed resolves with ``NoWorkerAvailable``
        (refused), never silence.  Idempotent."""
        self._ensure_started()
        try:
            worker = self.workers[worker_id]
        except KeyError:
            raise FleetError(
                f"unknown worker {worker_id!r}; fleet has: "
                f"{sorted(self.workers)}") from None
        if worker.dead:
            return worker
        worker.dead = True
        self.kills += 1
        worker.health.force_eject(self.clock())
        self._track("worker_killed", worker_id=worker_id)
        try:
            # queued requests: futures cancel → outcome machine re-routes
            worker.gateway.extract_queued()
        except Exception:   # noqa: BLE001 — a dead gateway may not answer
            pass
        for fr in list(worker.outstanding):
            # mid-dispatch requests: cancelling the worker future both
            # aborts the gateway-side request and re-routes here
            if fr.worker_fut is not None and not fr.worker_fut.done():
                fr.worker_fut.cancel()
        return worker

    async def respawn(self, worker_id: str, *,
                      gateway=None) -> FleetWorker:
        """Bring a killed worker back behind the same fleet identity.

        The replacement ``gateway`` is either passed in or built by the
        worker's ``spawn`` factory **off the event loop** — with a
        factory like ``repro_torch.chaos.respawn_gateway`` over a shared
        ``StoreRoot`` the rebuild makes its launches from the shared
        cache's records (zero preparations) and reloads its plans from
        the shared ``PlanStore``.  The worker does *not* return to routing
        directly: it stays ejected with its probe immediately due, so
        the first request routed to it is the canary and re-admission
        goes through the existing health-probe path."""
        self._ensure_started()
        try:
            worker = self.workers[worker_id]
        except KeyError:
            raise FleetError(
                f"unknown worker {worker_id!r}; fleet has: "
                f"{sorted(self.workers)}") from None
        if not worker.dead:
            raise FleetError(
                f"worker {worker_id!r} is not dead; respawn follows "
                f"kill — use drain() for graceful maintenance")
        if gateway is None:
            if worker.spawn is None:
                raise FleetError(
                    f"worker {worker_id!r} has no spawn factory; pass "
                    f"gateway= or construct FleetWorker(..., spawn=...)")
            gateway = await self._loop.run_in_executor(None, worker.spawn)
        old = worker.gateway
        worker.gateway = gateway
        worker.dead = False
        worker.draining = False
        # stay ejected, probe due *immediately*: the next routed
        # request is the canary that re-admits the worker
        health = worker.health
        health.probing = False
        health.ejected_at = self.clock() - health.policy.probe_interval
        self.respawns += 1
        self._track("worker_respawned", worker_id=worker_id)
        try:
            await old.close()
        except Exception:   # noqa: BLE001 — the dead gateway owes nothing
            pass
        return worker

    # -- live plan reload -------------------------------------------------
    def _target_workers(self, worker_ids: Optional[Sequence[str]]
                        ) -> Dict[str, FleetWorker]:
        if worker_ids is None:
            return dict(self.workers)
        targets = {}
        for wid in worker_ids:
            try:
                targets[wid] = self.workers[wid]
            except KeyError:
                raise FleetError(
                    f"unknown worker {wid!r}; fleet has: "
                    f"{sorted(self.workers)}") from None
        return targets

    async def rollout(self, plan, plan_id: str, *,
                      worker_ids: Optional[Sequence[str]] = None,
                      params=None, generator=None) -> Dict[str, str]:
        """Register ``plan`` on live workers without pausing serving.

        Each target worker prepares the plan **off the event loop**
        (``run_in_executor``) into its gateway's executable cache —
        with a ``PersistentExecutableCache`` this loads stored records,
        not a preparation storm — and then registers it between
        dispatches.  It runs on the device of the gateway's first plan
        (the card when it has none).  Workers
        already serving ``plan_id`` are skipped (idempotent rollouts).
        Workers roll sequentially, so a broken plan fails on the first
        worker with the rest untouched.  Returns ``{worker_id:
        plan_id}`` for the workers that registered."""
        self._ensure_started()
        targets = self._target_workers(worker_ids)
        registered: Dict[str, str] = {}
        for wid, worker in targets.items():
            gw = worker.gateway
            if plan_id in gw.plans:
                continue
            from repro_torch.runtime.workloads import compile_plan
            dev = next((e.compiled.device for e in gw.plans.values()),
                       "cuda")
            compiled = await self._loop.run_in_executor(
                None, lambda gw=gw, dev=dev: compile_plan(
                    plan, params=params, generator=generator,
                    max_batch=gw.cfg.max_batch, device=dev,
                    warmup=gw.cfg.aot_warmup,
                    exec_cache=gw.exec_cache))
            gw.register_plan(plan, plan_id=plan_id, compiled=compiled)
            registered[wid] = plan_id
            self._track("plan_rollout", plan_id=plan_id, worker_id=wid)
        return registered

    async def retire_plan(self, plan_id: str, *,
                          worker_ids: Optional[Sequence[str]] = None
                          ) -> int:
        """Retire ``plan_id`` fleet-wide without dropping in-flight
        requests.  Two phases: first **every** target gateway closes
        admission for the plan (``begin_retire`` — the routers stop
        seeing it at once, so no re-route can land on a copy that is
        about to vanish), then each gateway's ``retire_plan`` drains
        its queued + in-flight requests for the plan to completion.
        Returns the total requests the plan served across the fleet.
        Workers that never hosted the plan are skipped."""
        self._ensure_started()
        targets = {wid: w for wid, w in
                   self._target_workers(worker_ids).items()
                   if plan_id in w.gateway.plans
                   or plan_id in getattr(w.gateway, "retired_plans", {})}
        for worker in targets.values():       # phase 1: stop routing
            if plan_id in worker.gateway.plans:
                worker.gateway.begin_retire(plan_id)
        total = 0
        for worker in targets.values():       # phase 2: drain + evict
            total += await worker.gateway.retire_plan(plan_id)
        self._track("plan_retired_fleet", plan_id=plan_id,
                    workers=sorted(targets), served=total)
        return total

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        """Fleet counters plus one consistent per-worker snapshot
        (`GatewayStats` + health/drain state)."""
        now = self.clock()
        per_worker = {}
        for wid, w in self.workers.items():
            try:
                snap = w.gateway.snapshot().asdict()
            except Exception:       # noqa: BLE001 — missed heartbeat
                snap = None
            per_worker[wid] = {
                "profile": w.profile.name,
                "cost": w.profile.cost,
                "plans": sorted(w.plan_ids),
                "workloads": sorted(w.workload_kinds),
                "rate": w.rate,
                "healthy": w.health.healthy,
                "routable": w.health.routable(now),
                "ejections": w.health.ejections,
                "probes": w.health.probes,
                "draining": w.draining,
                "dead": w.dead,
                "outstanding": len(w.outstanding),
                "snapshot": snap,
            }
        return {
            "router": self.router.name,
            "served": self.served,
            "expired": self.expired,
            "cancelled": self.cancelled,
            "rerouted": self.rerouted,
            "retried": self.retried,
            "worker_failures": self.worker_failures,
            "drains": self.drains,
            "kills": self.kills,
            "respawns": self.respawns,
            "workers": per_worker,
        }
