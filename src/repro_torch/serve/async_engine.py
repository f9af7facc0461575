"""Async continuous-batching gateway over
``repro_torch.runtime.CompiledModel``.

Port of ``repro.serve.async_engine``, on the card unless the caller
asks for the CPU.  Two invariants the reference does not keep hold
here: class-aware shedding ejects a victim only when that one ejection
makes room for the arrival (``AdmissionQueue.shed_victim``), and
cancelling a future that ``submit``/``submit_nowait`` returned cancels
its request before ``cancel()`` returns (``_RequestFuture``).  The
reference's fault-injection seam is here (``faults=``, consulted at the
"dispatch" point inside a batch's ``try`` and the "heartbeat" point in
``snapshot()``), and ``exec_cache`` takes any ``ExecutableCache``,
``ops.PersistentExecutableCache`` included.

The sync ``CNNEngine`` is a *tick loop*: gather whatever occupies the
slots, run one blocking step, scatter, repeat — fine for offline
workloads handed over as a list, blind to everything a front door needs
under live traffic.  ``AsyncCNNGateway`` is the production path, the
vLLM-style request-level scheduler adapted to feed-forward CNN serving:

  admission     a **bounded** pending queue.  ``submit`` applies
                backpressure (awaits space); ``submit_nowait`` raises
                ``GatewayBacklog`` — traffic beyond the bound is
                refused at the door, never absorbed into an unbounded
                queue whose tail latency grows without limit.  The
                bound itself is **adaptive** when ``wait_budget_s`` is
                set: it tracks measured service rate × the wait budget
                (clamped to [``min_pending``, ``max_pending``]), so the
                queue holds exactly as much work as the hardware can
                clear inside the budget — the paper's resource-driven
                sizing applied to the one serving-tier resource,
                admission capacity.  At the bound, shedding is
                **class-aware**: a ``submit_nowait`` arrival that
                outranks the least-urgent pending request (the policy's
                ``shed_key`` order — best-effort sheds first) ejects it
                with ``GatewayBacklog`` instead of being refused
                itself.  ``submit_chunk`` admits request batches
                *partially* — free capacity worth of images instead of
                all-or-nothing.
  continuous    the drain task launches a new ``CompiledModel`` bucket
                dispatch **the moment slots free up** — no global tick.
                Dispatches run in a worker thread pool, so the event
                loop keeps admitting, cancelling, and expiring requests
                while a batch is on-device, and (``max_inflight > 1``)
                a second batch can overlap the first.
  deadlines     requests carry optional ``deadline``/``priority``;
                batches are formed in ``repro_torch.serve.policy`` order
                (EDF by default here — the *same* policy objects the
                sync engines accept, so both paths order identically).
                A request whose deadline passes before its batch
                launches is **expired** — completed with
                ``DeadlineExpired``, never silently served late.
  cancellation  the future returned by ``submit`` supports
                ``cancel()`` at any point: while queued (slot of the
                bound is released before ``cancel()`` returns), or
                mid-flight (the dispatch polls ``CompiledModel``'s
                ``should_abort`` hook and abandons the layers not yet
                launched once every request in the flight is
                cancelled; on the card the launched ones run on).
  multi-plan    ``register_plan`` routes any number of
                ``DeploymentPlan``s through one gateway.  All plans
                share one ``runtime.ExecutableCache``: two plans whose
                layer specs coincide share prepared launches instead of
                preparing per plan.  Each batch is single-plan (plans
                may differ in geometry/precision); the scheduler picks
                the plan owning the most urgent pending request.

The scheduling core (``AdmissionQueue``) is deliberately synchronous
and clock-injected — the admission-bound and deadline invariants are
property-tested directly, no event loop required.  The asyncio shell
owns futures and the one worker thread that runs dispatches.
"""

from __future__ import annotations

import asyncio
import contextlib
import heapq
import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.ops import spans
from repro_torch.runtime.compiled import (CompiledModel, DispatchAborted,
                                          ExecutableCache, dtype_name)
from repro_torch.runtime.workloads import (compile_plan, get_workload,
                                           workload_spec)
from repro_torch.serve import policy as policy_mod
from repro_torch.serve.policy import PolicyLike, get_policy
from repro_torch.serve.slots import GatewayStats, SlotPool


class GatewayBacklog(RuntimeError):
    """Admission refused: the pending queue is at its bound.  The
    caller sheds load (or uses ``submit`` and waits) — the gateway
    never buffers beyond its bound."""


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before its batch launched; it was
    removed from the queue, not served late."""


class RequestCancelled(RuntimeError):
    """The request was cancelled via ``AsyncRequest.cancel`` before a
    result was produced."""


class PlanUnavailable(RuntimeError):
    """The target plan is retiring or was retired: admission refuses
    new requests for it.  In-flight and already-queued requests still
    complete — retirement drains, it never drops."""


@dataclass(eq=False)               # identity hash: requests live in sets
class AsyncRequest:
    """One in-flight gateway request.  ``deadline`` is absolute on the
    gateway clock (``submit``'s ``deadline`` argument is *relative*
    seconds and is converted on admission).  All state transitions
    happen on the gateway's event-loop thread — call ``cancel`` from
    the loop (schedule with ``call_soon_threadsafe`` from others)."""
    image: np.ndarray
    plan_id: str
    request_id: int = 0
    priority: int = 0
    deadline: Optional[float] = None
    arrived_at: float = 0.0
    # admission on the span clock (``time.perf_counter_ns``), taken
    # whatever the gateway's ``clock``: where ``gateway.queue`` starts
    admitted_ns: int = 0
    # terminal state, set exactly once by the scheduling core:
    # pending → done | expired | cancelled | failed | shed
    status: str = "pending"
    output: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    _on_done: Optional[Callable[["AsyncRequest"], None]] = field(
        default=None, repr=False)

    def cancel(self) -> bool:
        """Cancel a still-pending request (False once terminal).  A
        queued request frees its admission slot at the next queue
        operation; a mid-flight one stops the dispatch early if every
        flight-mate is cancelled too, and its result is discarded."""
        if self.status != "pending":
            return False
        self._finish("cancelled", error=RequestCancelled(
            f"request {self.request_id} cancelled"))
        return True

    def _finish(self, status: str, *, output=None, error=None) -> None:
        if self.status != "pending":      # first terminal state wins
            return
        self.status = status
        self.output = output
        self.error = error
        if self._on_done is not None:
            self._on_done(self)


class _RequestFuture(asyncio.Future):
    """The future ``submit``/``submit_nowait`` return.  ``cancel()``
    cancels the request itself before it returns — its terminal hook
    frees the request's slot of the admission bound and counts it —
    where a done-callback would wait for the next turn of the loop."""

    def __init__(self, req: "AsyncRequest", *, loop):
        super().__init__(loop=loop)
        self._req = req

    def cancel(self, msg=None) -> bool:
        if not super().cancel(msg):
            return False
        self._req.cancel()
        return True


class _ShedProbe:
    """Stand-in for a not-yet-built request in shed-order comparisons.
    Policies read ``priority``/``deadline`` duck-typed, so this is all
    ``AdmissionQueue.outranked_by`` needs to decide admission at the
    bound without constructing the real request first."""

    __slots__ = ("priority", "deadline")

    def __init__(self, priority: int, deadline: Optional[float]):
        self.priority = priority
        self.deadline = deadline


class AdmissionQueue:
    """Bounded, policy-ordered pending set with deadline expiry — the
    synchronous scheduling core of the gateway.

    Invariants (property-tested in ``tests/test_torch_async_serve.py``):

    * live pending count never exceeds ``max_pending`` — ``admit``
      refuses first — and always equals the pending entries in the
      heap: ``shed_victim`` ejects only when that makes room;
    * ``pop_batch`` never returns a request whose deadline has passed —
      expired requests are finished with ``DeadlineExpired`` instead;
    * cancelled requests are never returned either (lazy heap deletion:
      terminal entries are dropped whenever they surface).
    """

    def __init__(self, max_pending: int, policy: PolicyLike = "edf"):
        if max_pending < 1:
            raise ValueError(f"max_pending={max_pending} must be ≥ 1")
        self.max_pending = max_pending
        self.policy = get_policy(policy)
        self._heap: List[Tuple[tuple, int, AsyncRequest]] = []
        self._seq = 0
        self._live = 0                 # pending entries (≤ max_pending)
        self.expired: int = 0          # finished with DeadlineExpired
        self.shed: int = 0             # ejected for a higher-class arrival
        # upper bound on the max pending shed_key (None = unknown):
        # lets ``outranked_by`` answer the common full-queue refusal in
        # O(1).  Removals leave it stale-high (safe: forces a scan),
        # admissions raise it, scans refresh it exactly.
        self._shed_ceiling: Optional[tuple] = None

    def __len__(self) -> int:
        return self._live

    @property
    def full(self) -> bool:
        return self._live >= self.max_pending

    def resize(self, max_pending: int) -> None:
        """Set a new admission bound (adaptive admission's seam).
        Shrinking below the current live count evicts nothing — the
        queue simply reads as full until it drains back under the new
        bound; growing takes effect on the next ``admit``."""
        self.max_pending = max(1, int(max_pending))

    def note_terminal(self) -> None:
        """A queued request reached a terminal state outside the queue
        (cancel): its admission slot is free immediately."""
        self._live -= 1

    def admit(self, req: AsyncRequest, now: float) -> bool:
        """Queue ``req``; False when at the bound (caller backpressures
        or rejects).  A request already past its deadline is expired on
        the spot — it never occupies a slot of the bound.  A request
        that is already *terminal* (e.g. its future was cancelled while
        ``submit`` awaited backpressure) is likewise handled without
        queueing: admitting it would bump the live count for an entry
        whose terminal hook has already run (or never will), leaking a
        slot of the bound on every occurrence until the gateway refuses
        all traffic."""
        if req.status != "pending":
            return True                # already terminal: never queued
        if policy_mod.expired(req, now):
            self.expired += 1
            req._finish("expired", error=DeadlineExpired(
                f"request {req.request_id} deadline predates admission"))
            return True                # handled (terminally), not queued
        if self.full:
            return False
        heapq.heappush(
            self._heap, (self.policy.key(req, self._seq, now),
                         self._seq, req))
        shed_key = self.policy.shed_key(req, self._seq, now)
        if self._shed_ceiling is None or shed_key > self._shed_ceiling:
            self._shed_ceiling = shed_key
        self._seq += 1
        self._live += 1
        return True

    def outranked_by(self, probe, now: float) -> bool:
        """True when some pending entry sheds below ``probe`` — i.e. a
        request of the probe's class arriving *now* would take a
        victim's slot instead of being refused.  ``probe`` only needs
        ``priority``/``deadline`` (policies read them duck-typed), so
        the gateway can answer "would this be refused?" at the bound
        *before* paying for request construction — under overload the
        refused path is the hot path.

        That hot path is O(1) in the common case: ``_shed_ceiling``
        upper-bounds every pending shed_key (sound because both
        built-in policies' shed keys are time-invariant once assigned),
        so a probe at or above the ceiling is refused without touching
        the heap.  Only a probe *below* the ceiling pays for a scan,
        which re-tightens the ceiling to the exact maximum."""
        candidate = self.policy.shed_key(probe, self._seq, now)
        ceiling = self._shed_ceiling
        if ceiling is not None and candidate >= ceiling:
            return False
        best = None
        for _, seq, queued in self._heap:
            if queued.status == "pending":
                k = self.policy.shed_key(queued, seq, now)
                if best is None or k > best:
                    best = k
        self._shed_ceiling = best
        return best is not None and best > candidate

    def shed_victim(self, req: AsyncRequest, now: float
                    ) -> Optional[AsyncRequest]:
        """Class-aware shedding at the bound: locate the least-urgent
        pending entry (maximal ``policy.shed_key`` — the same order
        batches form in, reversed) and, **iff** the incoming ``req``
        strictly outranks it, finish the victim with ``GatewayBacklog``
        and free its admission slot so ``req`` can take it.  Returns
        the victim, or ``None`` when ``req`` is itself the least
        urgent (the caller refuses it — under FIFO nothing ever
        outranks a queued request, so shedding degenerates to plain
        refusal), or when one ejection would not make room: after a
        ``resize`` below the live count the queue stays full without
        the victim, and shedding it would lose both requests."""
        if self._live - 1 >= self.max_pending:
            return None
        candidate = self.policy.shed_key(req, self._seq, now)
        worst_key, victim = None, None
        for _, seq, queued in self._heap:
            if queued.status != "pending":
                continue               # lazy-deleted entry
            k = self.policy.shed_key(queued, seq, now)
            if worst_key is None or k > worst_key:
                worst_key, victim = k, queued
        if victim is None or worst_key <= candidate:
            return None
        self._live -= 1
        self.shed += 1
        victim._finish("shed", error=GatewayBacklog(
            f"request {victim.request_id} shed at the admission bound "
            f"for a higher-class arrival"))
        return victim

    def pop_batch(self, max_n: int, now: float
                  ) -> Tuple[Optional[str], List[AsyncRequest]]:
        """Form the next single-plan batch: the most urgent pending
        request picks the plan, then up to ``max_n`` requests of *that
        plan* follow in policy order.  Other plans' requests are held
        back for the next batch with their original heap entries (keys
        and arrival order preserved exactly).  Terminal entries are
        dropped lazily; overdue ones are expired here — ``pop_batch``
        never returns a request that is already too late."""
        held: List[Tuple[tuple, int, AsyncRequest]] = []
        batch: List[AsyncRequest] = []
        plan_id: Optional[str] = None
        while len(batch) < max_n and self._heap:
            key, seq, req = heapq.heappop(self._heap)
            if req.status != "pending":   # cancelled while queued
                continue                  # (bound slot already released)
            if policy_mod.expired(req, now):
                self._live -= 1
                self.expired += 1
                req._finish("expired", error=DeadlineExpired(
                    f"request {req.request_id} expired after "
                    f"{now - req.arrived_at:.3f}s in queue"))
                continue
            if plan_id is None:
                plan_id = req.plan_id
            if req.plan_id != plan_id:
                held.append((key, seq, req))
                continue
            self._live -= 1
            batch.append(req)
        for entry in held:
            heapq.heappush(self._heap, entry)
        return plan_id, batch

    def pending_for(self, plan_id: str) -> int:
        """Count still-pending queued entries targeting one plan — the
        drain check live plan retirement polls until zero."""
        return sum(1 for _, _, req in self._heap
                   if req.status == "pending" and req.plan_id == plan_id)

    def evict_pending(self) -> List[AsyncRequest]:
        """Remove every still-pending entry from the heap *without*
        finishing it or touching the live count.  The caller owns the
        evicted requests: it must drive each to a terminal state, whose
        hook releases the admission slot via ``note_terminal`` — the
        seam ``AsyncCNNGateway.extract_queued`` (fleet draining) uses.
        Terminal entries still parked in the heap are dropped for free
        (their lazy deletion completes here)."""
        evicted = [req for _, _, req in self._heap
                   if req.status == "pending"]
        self._heap.clear()
        return evicted


@dataclass
class AsyncServeConfig:
    max_batch: int = 8             # dispatch width = top bucket
    max_pending: int = 64          # admission bound (queued, not in-flight)
    max_inflight: int = 1          # concurrent bucket dispatches
    policy: PolicyLike = "edf"     # batch-formation order
    aot_warmup: bool = True        # prepare all buckets at register
    # adaptive admission (None = static bound, the pre-adaptive behavior):
    # the bound tracks ceil(measured service_rate × wait_budget_s),
    # clamped to [min_pending (default max_batch), max_pending] — the
    # queue holds what the hardware clears inside the budget, no more.
    wait_budget_s: Optional[float] = None
    min_pending: Optional[int] = None
    # batch coalescing: with an idle pool and a *partial* batch queued,
    # wait up to ``batch_linger × (max_batch / measured rate)`` seconds
    # (woken early by every new arrival) for the batch to fill before
    # dispatching.  A k=1 sliver costs a whole dispatch slot the same
    # ~full-batch service time costs — during an overload ramp those
    # slivers are pure capacity loss.  0 disables (dispatch instantly).
    batch_linger: float = 0.0


class _PlanEntry:
    def __init__(self, plan_id: str, compiled: CompiledModel):
        self.plan_id = plan_id
        self.compiled = compiled
        self.served = 0

    @property
    def kind(self) -> str:
        return self.compiled.kind

    @property
    def np_dtype(self) -> np.dtype:
        """The compiled input's container as numpy names it."""
        return np.dtype(dtype_name(self.compiled.in_dtype))


class DispatchStages(NamedTuple):
    """Seconds of one completed dispatch, stage by stage, on
    ``time.perf_counter_ns``: from the batch's pop in the drain loop to
    its task starting (``to_task``), stacking the images (``stack``),
    the hop into the worker thread (``hop_in``), the forward and the
    copy to the host there (``forward``), the hop back to the loop
    (``hop_back``), and finishing the requests' futures (``finish``).
    Each is the duration of the ``gateway.<stage>`` span of that name
    (``runtime.forward`` for ``forward``; ``ops.spans``)."""
    n: int
    to_task: float
    stack: float
    hop_in: float
    forward: float
    hop_back: float
    finish: float

    @property
    def total(self) -> float:
        return (self.to_task + self.stack + self.hop_in + self.forward
                + self.hop_back + self.finish)

    @classmethod
    def from_stamps(cls, n: int, stamps: Tuple[int, ...]
                    ) -> "DispatchStages":
        """The stages between seven successive stamps in ns (the pop,
        the task's start, stacked, the worker's start and end, back on
        the loop, finished)."""
        return cls(n, *((b - a) / 1e9 for a, b in zip(stamps, stamps[1:])))


def _device_scope(device: torch.device):
    """Make ``device`` the worker thread's current card for one
    dispatch, so the kernels launch on that card's current stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class AsyncCNNGateway(SlotPool):
    """The asyncio front door.  Request lifecycle::

        fut = await gw.submit(img)        # backpressure at the bound
        out = await fut                   # (H, W, C_out) container ints

    The gateway is also an (async) context manager::

        async with AsyncCNNGateway.from_plan(plan) as gw:
            ...

    Slot accounting rides on ``SlotPool``: in-flight requests occupy
    slots, ``release`` wakes the drain task through a release hook, and
    the occupancy histogram / ``stats()`` telemetry is shared with the
    sync engines (bounded + thread-safe by construction).
    """

    def __init__(self, cfg: Optional[AsyncServeConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 exec_cache: Optional[ExecutableCache] = None,
                 tracker=None, faults=None):
        cfg = cfg if cfg is not None else AsyncServeConfig()
        if cfg.max_inflight < 1:
            raise ValueError(f"max_inflight={cfg.max_inflight} must be ≥ 1")
        if cfg.wait_budget_s is not None and cfg.wait_budget_s <= 0:
            raise ValueError(
                f"wait_budget_s={cfg.wait_budget_s} must be > 0 "
                f"(or None for a static bound)")
        if cfg.min_pending is not None and cfg.min_pending < 1:
            raise ValueError(
                f"min_pending={cfg.min_pending} must be ≥ 1")
        if cfg.batch_linger < 0.0:
            raise ValueError(
                f"batch_linger={cfg.batch_linger} must be ≥ 0")
        # the slot pool holds one dispatch-width batch per allowed
        # in-flight dispatch: with max_inflight > 1 the next batch can
        # occupy slots (and launch) while the previous is on-device —
        # dispatch width itself stays cfg.max_batch (see _drain).
        super().__init__(cfg.max_batch * cfg.max_inflight, clock=clock,
                         faults=faults)
        self.cfg = cfg
        self.clock = clock
        self.queue = AdmissionQueue(cfg.max_pending, cfg.policy)
        self.plans: Dict[str, _PlanEntry] = {}
        # shared across all plans
        self.exec_cache = (exec_cache if exec_cache is not None
                           else ExecutableCache())
        # ops telemetry sink (repro_torch.ops.Tracker); every call is
        # fire-and-forget and must never block the loop thread
        self.tracker = tracker
        if tracker is not None \
                and getattr(self.exec_cache, "on_event", False) is None:
            self.exec_cache.on_event = (
                lambda ev, fields: tracker.log_event(ev, **fields))
        self._default_plan: Optional[str] = None
        self._retiring: set = set()    # admission-closed, still draining
        self.retired_plans: Dict[str, int] = {}   # plan_id → served
        # one device, one execution stream: a single worker thread
        # serialises device compute no matter how many dispatches are
        # staged.  ``max_inflight > 1`` still pays off — the *next*
        # batch's host-side prep (stack, future wiring) overlaps the
        # current compute, and its launches start the instant the
        # worker frees with no event-loop round trip — but two
        # dispatches never timeslice the same device, which on a
        # host-shared device starves one dispatch into a straggler
        # whose latency the rate estimator then reads as lost capacity.
        # ``kernels.build.LAUNCHES`` is bumped from this thread without
        # a lock; with one worker no two bumps race.
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-serve")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake: Optional[asyncio.Event] = None
        self._space: Optional[asyncio.Event] = None
        self._drain_task: Optional[asyncio.Task] = None
        self._closing = False
        self._inflight = 0             # dispatches currently launched
        self._next_id = 0
        self._last_adapt = -math.inf   # rate-limits per-arrival resizes
        # counters (all mutated on the loop thread; read anywhere)
        self.served = 0
        self.rejected = 0
        self.cancelled = 0
        self.failed = 0
        self.aborted_dispatches = 0
        # per-dispatch stage stamps, off unless a caller sets a list:
        # each completed dispatch then appends a ``DispatchStages``
        self.stage_log: Optional[list] = None

    # -- plan registry ----------------------------------------------------
    def register_plan(self, plan, *, plan_id: Optional[str] = None,
                      params=None,
                      generator: Optional[torch.Generator] = None,
                      device: DeviceLike = "cuda", mesh=None,
                      compiled: Optional[CompiledModel] = None) -> str:
        """Route ``plan`` through this gateway: the plan's
        ``WorkloadSpec`` builds the compiled backend on ``device``, or
        data-parallel over ``mesh`` (a ``parallel.sharding.CNNDataMesh``,
        CNN plans; ``runtime.compile_plan``; ``cuda`` without a card
        raises): a
        ``cnn`` or a ``moe`` plan.  A workload kind the port does not
        serve yet raises ``NotImplementedError`` here, and an unknown
        one ``ValueError``, never inside a dispatch.  All
        registered plans prepare into the gateway's shared
        ``ExecutableCache`` — layers that coincide across plans (same
        block/bits/geometry/device) reuse one prepared launch per
        bucket, so registering a second near-identical plan is nearly
        free.  ``params`` default to a seeded draw from ``generator``.
        The first registered plan is the default target for
        ``submit``."""
        if plan_id is None:
            plan_id = f"plan{len(self.plans)}"
        if plan_id in self.plans:
            raise ValueError(f"plan id {plan_id!r} already registered")
        if compiled is None:
            get_workload(workload_spec(plan).kind)
            compiled = compile_plan(
                plan, params=params, generator=generator, device=device,
                mesh=mesh, max_batch=self.cfg.max_batch,
                warmup=self.cfg.aot_warmup, exec_cache=self.exec_cache)
        elif compiled.max_batch < self.cfg.max_batch:
            raise ValueError(
                f"compiled max_batch={compiled.max_batch} smaller than "
                f"the slot pool ({self.cfg.max_batch})")
        self.plans[plan_id] = _PlanEntry(plan_id, compiled)
        if self._default_plan is None:
            self._default_plan = plan_id
        self._track("plan_registered", plan_id=plan_id,
                    kind=compiled.kind)
        return plan_id

    @classmethod
    def from_plan(cls, plan, cfg: Optional[AsyncServeConfig] = None, *,
                  plan_id: Optional[str] = None, params=None,
                  generator: Optional[torch.Generator] = None,
                  device: DeviceLike = "cuda", mesh=None,
                  clock: Callable[[], float] = time.monotonic,
                  exec_cache: Optional[ExecutableCache] = None,
                  tracker=None, faults=None) -> "AsyncCNNGateway":
        gw = cls(cfg, clock=clock, exec_cache=exec_cache, tracker=tracker,
                 faults=faults)
        gw.register_plan(plan, plan_id=plan_id, params=params,
                         generator=generator, device=device, mesh=mesh)
        return gw

    def _track(self, event: str, **fields) -> None:
        if self.tracker is not None:
            self.tracker.log_event(event, **fields)

    @property
    def routable_plans(self) -> frozenset:
        """Plan ids admission currently accepts — registered minus
        retiring.  Fleet routing reads this, so a retiring plan stops
        receiving traffic the moment ``begin_retire`` runs."""
        return frozenset(pid for pid in self.plans
                         if pid not in self._retiring)

    def _entry(self, plan_id: Optional[str]) -> _PlanEntry:
        pid = plan_id if plan_id is not None else self._default_plan
        if pid is None:
            raise RuntimeError("no plan registered "
                               "(call register_plan first)")
        if pid in self._retiring:
            raise PlanUnavailable(
                f"plan {pid!r} is retiring; routable: "
                f"{sorted(self.routable_plans)}")
        try:
            return self.plans[pid]
        except KeyError:
            if pid in self.retired_plans:
                raise PlanUnavailable(
                    f"plan {pid!r} was retired; routable: "
                    f"{sorted(self.routable_plans)}") from None
            raise ValueError(
                f"unknown plan id {pid!r}; registered: "
                f"{sorted(self.plans)}") from None

    # -- live retirement ---------------------------------------------------
    def begin_retire(self, plan_id: str) -> None:
        """Phase 1 of live retirement: stop routing new requests to
        ``plan_id`` — admission raises ``PlanUnavailable``, the default
        plan reassigns to the next routable one — while queued and
        in-flight requests continue untouched.  Idempotent; the fleet
        marks every worker this way before draining any of them so no
        re-route lands on a copy that is about to disappear."""
        if plan_id not in self.plans:
            raise ValueError(
                f"unknown plan id {plan_id!r}; registered: "
                f"{sorted(self.plans)}")
        if plan_id in self._retiring:
            return
        self._retiring.add(plan_id)
        if self._default_plan == plan_id:
            self._default_plan = next(
                (pid for pid in self.plans if pid not in self._retiring),
                None)
        self._track("plan_retiring", plan_id=plan_id)

    def _plan_outstanding(self, plan_id: str) -> int:
        """Queued + in-flight requests still owed to ``plan_id``."""
        queued = self.queue.pending_for(plan_id)
        inflight = sum(1 for r in self.active
                       if r is not None and r.plan_id == plan_id
                       and r.status == "pending")
        return queued + inflight

    async def retire_plan(self, plan_id: str, *,
                          poll_s: float = 0.01) -> int:
        """Retire a plan from a live gateway **without dropping
        in-flight requests**: close admission (``begin_retire``), wait
        for every queued and in-flight request of the plan to reach a
        terminal state through the normal dispatch path, then evict the
        compiled entry.  Returns the plan's lifetime served count.
        Concurrent retires of the same plan join the same drain;
        retiring an already-retired plan returns its count."""
        self._ensure_started()
        if plan_id not in self.plans:
            if plan_id in self.retired_plans:
                return self.retired_plans[plan_id]
            raise ValueError(
                f"unknown plan id {plan_id!r}; registered: "
                f"{sorted(self.plans)}")
        self.begin_retire(plan_id)
        while plan_id in self.plans and self._plan_outstanding(plan_id):
            self._wake.set()          # keep the drain task moving
            self._space.set()         # wake submit waiters so those
            await asyncio.sleep(poll_s)   # targeting this plan can fail
        entry = self.plans.pop(plan_id, None)
        self._retiring.discard(plan_id)
        if entry is not None:
            self.retired_plans[plan_id] = entry.served
            self._track("plan_retired", plan_id=plan_id,
                        served=entry.served)
        return self.retired_plans.get(plan_id, 0)

    # -- lifecycle --------------------------------------------------------
    def _ensure_started(self) -> None:
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
            self._wake = asyncio.Event()
            self._space = asyncio.Event()
            self._space.set()
            # a freed slot can mean "next batch can launch": wake the
            # drain task from whatever thread released the slot
            self.add_release_hook(lambda: loop.call_soon_threadsafe(
                self._wake.set))
            self._drain_task = loop.create_task(self._drain())
        elif self._loop is not loop:
            raise RuntimeError("gateway is bound to a different event loop")

    async def __aenter__(self) -> "AsyncCNNGateway":
        self._ensure_started()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        """Drain what is queued, then stop the drain task."""
        if self._drain_task is None:
            self._executor.shutdown(wait=True)
            return
        self._closing = True
        self._wake.set()
        self._space.set()             # backpressure waiters must not hang
        await self._drain_task
        self._executor.shutdown(wait=True)

    # -- admission --------------------------------------------------------
    def _make_request(self, image, plan_id, priority, deadline
                      ) -> Tuple[AsyncRequest, "asyncio.Future"]:
        entry = self._entry(plan_id)
        img = entry.compiled.validate_input(image, self._next_id)
        now = self.clock()
        req = AsyncRequest(
            image=img, plan_id=entry.plan_id, request_id=self._next_id,
            priority=priority,
            deadline=None if deadline is None else now + deadline,
            arrived_at=now)
        self._next_id += 1
        # a caller cancelling the *future* cancels the request too,
        # before ``cancel()`` returns
        fut = _RequestFuture(req, loop=self._loop)

        def on_done(r: AsyncRequest, fut=fut) -> None:
            if fut.done():
                return
            if r.status == "done":
                fut.set_result(r.output)
            elif r.status == "cancelled":
                fut.cancel()
            else:
                fut.set_exception(r.error)

        req._on_done = on_done
        return req, fut

    def _adapt_bound(self, force: bool = False) -> None:
        """Resize the admission bound to what the hardware can clear
        inside ``cfg.wait_budget_s`` at the *measured* service rate —
        the paper's resource-driven sizing applied to admission
        capacity.  No-op when no wait budget is configured (static
        bound).  Until the rate estimator warms up (or after an idle
        gap dilutes it to ~0) the bound floors at ``min_pending``
        (default ``max_batch``: always one full batch admissible); it
        never exceeds ``cfg.max_pending``, the configured hard cap.

        The bound reads the **slow** rate horizon: shrinking the door
        is a capacity commitment, and honouring it on a transient
        stall would shed a burst the hardware will clear moments
        later.  ``est_wait`` and routing keep the fast horizon.

        Per-arrival calls are rate-limited to ~2 ms: under sustained
        overload arrivals outnumber dispatches ~30:1, and resizing on
        each one spends event-loop time recomputing a bound that only
        moves when a step completes.  ``force=True`` (used on batch
        completion, where the estimate actually changed) bypasses the
        limiter."""
        budget = self.cfg.wait_budget_s
        if budget is None:
            return
        now = self.clock()
        if not force and now - self._last_adapt < 2e-3:
            return
        self._last_adapt = now
        floor = (self.cfg.min_pending if self.cfg.min_pending is not None
                 else self.cfg.max_batch)
        rate = self.service_rate_slow
        bound = math.ceil(rate * budget) if rate > 0 else floor
        self.queue.resize(max(floor, min(bound, self.cfg.max_pending)))
        self._signal_space()          # a grown bound frees waiters

    def submit_nowait(self, image, *, plan_id: Optional[str] = None,
                      priority: int = 0, deadline: Optional[float] = None
                      ) -> "asyncio.Future":
        """Admit one image or raise ``GatewayBacklog`` when the pending
        queue is at its bound (load shedding).  At the bound, shedding
        is class-aware: if this arrival outranks the least-urgent
        pending request (policy ``shed_key`` order), that request is
        ejected — its future raises ``GatewayBacklog`` — and this one
        takes its slot; otherwise this arrival is the one refused.
        ``deadline`` is relative seconds from now; the returned future
        resolves to the output activations, raises ``DeadlineExpired``,
        or is cancelled.  Its own work is the ``gateway.submit`` span."""
        if not spans.on():
            return self._submit_nowait(image, plan_id, priority, deadline)
        with spans.span("gateway.submit") as sp:
            fut = self._submit_nowait(image, plan_id, priority, deadline)
            sp.request = fut._req.request_id
        return fut

    def _submit_nowait(self, image, plan_id, priority, deadline
                       ) -> "asyncio.Future":
        self._ensure_started()
        if self._closing:
            raise RuntimeError("gateway is closing")
        self._adapt_bound()
        if self.queue.full:
            # refuse *before* building the request: under sustained
            # overload the refused path is the hot path, and paying
            # image validation + future wiring per shed arrival steals
            # event-loop time from dispatch
            now = self.clock()
            probe = _ShedProbe(
                priority, None if deadline is None else now + deadline)
            if not self.queue.outranked_by(probe, now):
                self.rejected += 1
                raise GatewayBacklog(
                    f"pending queue at its bound "
                    f"({self.queue.max_pending}); retry with backoff or "
                    f"use `await submit(...)` for backpressure")
        req, fut = self._make_request(image, plan_id, priority, deadline)
        now = self.clock()
        if not self.queue.admit(req, now):
            victim = self.queue.shed_victim(req, now)
            if victim is None or not self.queue.admit(req, now):
                self.rejected += 1
                raise GatewayBacklog(
                    f"pending queue at its bound "
                    f"({self.queue.max_pending}); retry with backoff or "
                    f"use `await submit(...)` for backpressure")
        self._bookkeep_admitted(req)
        return fut

    def submit_chunk(self, images, *, plan_id: Optional[str] = None,
                     priority: int = 0, deadline: Optional[float] = None
                     ) -> Tuple[List["asyncio.Future"], int]:
        """Admit a *batch* of images partially: as many as the bound
        has room for (in order), instead of all-or-nothing.  Returns
        ``(futures, refused)`` where ``futures`` covers the admitted
        prefix and ``refused`` counts the images that were shed at the
        bound (each counted in ``rejected``).  A caller that cannot
        tolerate partial admission should ``await submit`` per image
        for backpressure instead."""
        futs: List[asyncio.Future] = []
        for image in images:
            try:
                futs.append(self.submit_nowait(
                    image, plan_id=plan_id, priority=priority,
                    deadline=deadline))
            except GatewayBacklog:
                return futs, len(images) - len(futs)
        return futs, 0

    async def submit(self, image, *, plan_id: Optional[str] = None,
                     priority: int = 0, deadline: Optional[float] = None
                     ) -> "asyncio.Future":
        """Admit one image, **awaiting** while the queue is at its
        bound — backpressure propagates to the producer instead of
        growing the queue.  The request (and its validation) is built
        once; only admission retries.  Its deadline stays anchored to
        the first attempt — time spent waiting for space counts against
        it, so backpressure cannot smuggle a request past its SLA."""
        self._ensure_started()
        if self._closing:
            raise RuntimeError("gateway is closing")
        req, fut = self._make_request(image, plan_id, priority, deadline)
        while True:
            if self._closing:
                # a wakeup from close() must *not* re-try admission:
                # the drain task may already have exited, and a request
                # admitted after that pends forever.  Fail it instead —
                # its future resolves with the error.
                if req.status == "pending":
                    self.failed += 1
                    req._finish("failed",
                                error=RuntimeError("gateway is closing"))
                return fut
            if req.plan_id in self._retiring \
                    or req.plan_id not in self.plans:
                # the target plan retired while this submit awaited
                # backpressure: admitting now would strand the request
                # (retirement has already drained past it) — fail it
                if req.status == "pending":
                    self.failed += 1
                    req._finish("failed", error=PlanUnavailable(
                        f"plan {req.plan_id!r} retired while awaiting "
                        f"admission"))
                return fut
            self._adapt_bound()
            if self.queue.admit(req, self.clock()):
                self._bookkeep_admitted(req)
                return fut
            self._space.clear()
            if not self.queue.full:   # space freed before the clear —
                continue              # re-check avoids a lost wakeup
            await self._space.wait()

    def _bookkeep_admitted(self, req: AsyncRequest) -> None:
        req.admitted_ns = time.perf_counter_ns()
        if req.status == "pending":
            # queued: wake the drain task
            orig = req._on_done

            def on_done(r, orig=orig):
                if r.status == "cancelled":
                    self.cancelled += 1
                    if r not in self._inflight_set:
                        self.queue.note_terminal()
                        self._signal_space()
                orig(r)

            req._on_done = on_done
            self._wake.set()
        # expired-on-admission requests already finished via _on_done

    def _signal_space(self) -> None:
        if self._space is not None and not self.queue.full:
            self._space.set()

    # -- the continuous drain ---------------------------------------------
    @property
    def _inflight_set(self):
        return {r for r in self.active if r is not None}

    async def _drain(self) -> None:
        loop = self._loop
        pending_flights = set()
        linger_until: Optional[float] = None
        while True:
            self._wake.clear()
            free = self.free_slots()
            launched = False
            # Only form a batch when a dispatch can actually *start*
            # (inflight < max_inflight): launching into a busy executor
            # would fragment what could be one full batch into slivers.
            # Overlap policy: the first dispatch launches on any
            # pending work, but a *concurrent* one (max_inflight > 1)
            # requires a full batch of backlog — overlapping hides the
            # Python-side dispatch gap under overload (throughput),
            # while at low load two half-empty contending dispatches
            # would only inflate latency.
            pressure = (self._inflight == 0
                        or len(self.queue) >= self.cfg.max_batch)
            # Batch coalescing (cfg.batch_linger): an *idle* pool with
            # a partial batch queued holds the dispatch briefly — each
            # new admission wakes this wait, so the linger ends the
            # moment the batch fills or the deadline passes.  A k=1
            # sliver occupies a dispatch slot for ~a full batch's
            # service time; during an overload ramp (queue filling in
            # milliseconds) dispatching slivers forfeits real capacity.
            want_linger = (self.cfg.batch_linger > 0.0 and free > 0
                           and 0 < len(self.queue) < self.cfg.max_batch
                           and self._inflight == 0 and not self._closing)
            if not want_linger:
                linger_until = None
            elif linger_until is None:
                rate = self.service_rate
                linger_until = self.clock() + (
                    self.cfg.batch_linger * self.cfg.max_batch / rate
                    if rate > 0.0 else 0.0)
            if want_linger and self.clock() < linger_until:
                try:
                    await asyncio.wait_for(
                        self._wake.wait(),
                        linger_until - self.clock())
                except asyncio.TimeoutError:
                    pass
                continue
            if free > 0 and len(self.queue) > 0 and pressure \
                    and self._inflight < self.cfg.max_inflight:
                # dispatch width is cfg.max_batch (the top bucket),
                # not the pool size — the pool is max_inflight batches
                # wide so the next batch stages while one is on-device
                width = min(free, self.cfg.max_batch)
                plan_id, batch = self.queue.pop_batch(width, self.clock())
                self._signal_space()
                if batch and plan_id not in self.plans:
                    # the plan was evicted with requests still queued
                    # (shouldn't happen — retire drains first — but a
                    # KeyError here would kill the drain task for good)
                    for r in batch:
                        self.failed += 1
                        r._finish("failed", error=PlanUnavailable(
                            f"plan {plan_id!r} is no longer registered"))
                    continue
                if batch:
                    slots = [self.occupy(r) for r in batch]
                    self._inflight += 1
                    popped = time.perf_counter_ns()
                    # a dispatch popped while a profiler records is
                    # recorded whole; its id is its span's
                    dispatch_id = 0
                    if spans.on():
                        dispatch_id = spans.RECORDER.new_id()
                        for r in batch:
                            spans.RECORDER.add(
                                "gateway.queue", r.admitted_ns, popped,
                                request=r.request_id, dispatch=dispatch_id)
                    flight = loop.create_task(self._run_batch(
                        self.plans[plan_id], batch, slots,
                        popped_at=popped, dispatch_id=dispatch_id))
                    pending_flights.add(flight)
                    flight.add_done_callback(pending_flights.discard)
                    launched = True
            if launched:
                continue              # immediately try to form another
            if self._closing and len(self.queue) == 0 \
                    and not pending_flights:
                return
            await self._wake.wait()

    async def _run_batch(self, entry: _PlanEntry, batch, slots, *,
                         popped_at: int, dispatch_id: int = 0) -> None:
        """Run one popped batch: ``popped_at`` is the pop on
        ``time.perf_counter_ns``; a ``dispatch_id`` (its
        ``gateway.dispatch`` span's id, 0 for none) records its spans."""
        compiled = entry.compiled
        launched_at = self._rate_clock()
        started = time.perf_counter_ns()
        record = dispatch_id > 0
        ids = dict(parent=dispatch_id, dispatch=dispatch_id)
        forward = []                   # the worker's stretch (its stamps)
        alive = [r for r in batch if r.status == "pending"]
        try:
            if alive:
                with spans.stamped("gateway.stack", record, start=started,
                                   **ids) as stack:
                    images = torch.from_numpy(np.stack(
                        [np.asarray(r.image, entry.np_dtype)
                         for r in alive]))

                def abort() -> bool:
                    return all(r.status != "pending" for r in alive)

                def dispatch() -> np.ndarray:
                    # runs in the worker thread; the copy to the host
                    # waits for the device, so no future resolves before
                    # the batch has been computed
                    with spans.stamped("runtime.forward", record,
                                       **ids) as fwd, \
                            _device_scope(compiled.device):
                        forward.append(fwd)
                        y = compiled(images, should_abort=abort)
                        with spans.span("gateway.copy_out"):
                            return y.cpu().numpy()

                try:
                    # chaos seam: a scheduled worker crash raises here
                    # and rides the failed-dispatch path below — the
                    # requests fail, the fleet takes a health strike
                    # and re-routes, exactly as for a real device loss
                    self._fault_check("dispatch", plan_id=entry.plan_id,
                                      n=len(alive))
                    out = await self._loop.run_in_executor(
                        self._executor, dispatch)
                except DispatchAborted:
                    self.aborted_dispatches += 1
                    self._track("dispatch_aborted",
                                plan_id=entry.plan_id, n=len(alive))
                    out = None
                except Exception as e:        # noqa: BLE001 — a failed
                    # dispatch must fail its requests, never strand
                    # their futures in a forever-pending state
                    for r in alive:
                        r._finish("failed", error=e)
                        self.failed += 1
                    out = None
                if out is not None:
                    with spans.stamped("gateway.finish", record,
                                       **ids) as finish:
                        done = 0
                        for k, r in enumerate(alive):
                            if r.status == "pending":
                                r._finish("done", output=out[k])
                                self.served += 1
                                entry.served += 1
                                done += 1
                        self._note_step(len(alive), launched_at=launched_at)
                    fwd = forward[0]
                    stamps = (popped_at, started, stack.end, fwd.start,
                              fwd.end, finish.start, finish.end)
                    if self.stage_log is not None:
                        self.stage_log.append(
                            DispatchStages.from_stamps(len(alive), stamps))
                    if record:
                        self._record_dispatch(dispatch_id, stamps)
                    self._track("dispatch_complete",
                                plan_id=entry.plan_id, n=done)
        finally:
            self._inflight -= 1
            for s in slots:
                self.release(s)       # hooks re-wake the drain task
            self._adapt_bound(force=True)   # fresh rate → fresh bound
            self._signal_space()

    @staticmethod
    def _record_dispatch(dispatch_id: int, stamps: Tuple[int, ...]) -> None:
        """The dispatch's span and the children its stamps alone give
        (the stack, the forward and the finish recorded themselves)."""
        rec, ids = spans.RECORDER, dict(parent=dispatch_id,
                                        dispatch=dispatch_id)
        rec.add("gateway.dispatch", stamps[0], stamps[6],
                span_id=dispatch_id, dispatch=dispatch_id)
        rec.add("gateway.to_task", stamps[0], stamps[1], **ids)
        rec.add("gateway.hop_in", stamps[2], stamps[3], **ids)
        rec.add("gateway.hop_back", stamps[4], stamps[5], **ids)

    # -- fleet draining seam ----------------------------------------------
    def extract_queued(self) -> List[AsyncRequest]:
        """Pull every queued-but-not-in-flight request out of the
        admission queue so a fleet front door can re-route it to
        another worker (graceful drain).  Each extracted request is
        cancelled — its future resolves as cancelled and its admission
        slot frees via the normal terminal hook — and the returned
        ``AsyncRequest``s carry everything (image, plan id, priority,
        absolute deadline) a re-route needs.  In-flight batches are
        untouched: they finish through the usual dispatch path."""
        evicted = self.queue.evict_pending()
        for req in evicted:
            req.cancel()            # terminal hook releases the bound
        self._signal_space()
        return evicted

    # -- sugar ------------------------------------------------------------
    async def infer(self, image, **kw) -> np.ndarray:
        """Submit and await the result in one call."""
        fut = await self.submit(image, **kw)
        return await fut

    # the gateway reuses SlotPool's slot bookkeeping + telemetry, but its
    # serving interface is submit/infer — the sync drain entry points
    # would silently mis-admit (async submit has a different signature)
    def run(self, requests, **kw):
        raise TypeError(
            "AsyncCNNGateway has no sync drain — submit requests with "
            "`await gw.submit(img)` / `gw.submit_nowait(img)` (or use "
            "repro_torch.serve.CNNEngine for list workloads)")

    def step(self):
        raise TypeError("AsyncCNNGateway dispatches continuously; "
                        "there is no manual step()")

    # -- observability ----------------------------------------------------
    def snapshot(self) -> GatewayStats:
        """One consistent ``GatewayStats`` capture on the gateway's own
        clock: queue depth, in-flight slots, occupancy histogram, and
        every terminal counter in a single pass — the heartbeat the
        fleet health checks and routers read (never racing dict
        reads)."""
        # chaos seam: a stalled/crashed worker raises here, which
        # ``FleetWorker.view`` reads as a missed heartbeat — the same
        # path a hung process takes
        self._fault_check("heartbeat")
        return super().snapshot(
            clock=self.clock, queue_depth=len(self.queue),
            served=self.served, rejected=self.rejected,
            expired=self.queue.expired, cancelled=self.cancelled,
            failed=self.failed)

    def stats(self) -> dict:
        """Gateway counters + the SlotPool occupancy histogram + the
        shared-cache compile telemetry (one entry per distinct
        (layer, bucket) across *all* registered plans).  Built from one
        ``snapshot()`` so every field is from the same instant."""
        snap = self.snapshot()
        return {
            "plans": {pid: e.served for pid, e in self.plans.items()},
            "retiring": sorted(self._retiring),
            "retired_plans": dict(self.retired_plans),
            "served": snap.served,
            "rejected": snap.rejected,
            "expired": snap.expired,
            "cancelled": snap.cancelled,
            "failed": snap.failed,
            "shed": self.queue.shed,
            "aborted_dispatches": self.aborted_dispatches,
            "pending": snap.queue_depth,
            "inflight": snap.inflight,
            "max_pending": self.queue.max_pending,
            "wait_budget_s": self.cfg.wait_budget_s,
            "max_batch": self.cfg.max_batch,
            "slots": snap.max_batch,   # = max_batch × max_inflight
            "max_inflight": self.cfg.max_inflight,
            "policy": self.queue.policy.name,
            "steps": snap.steps,
            "occupancy_hist": dict(snap.occupancy_hist),
            "service_rate": snap.service_rate,
            "est_wait": snap.est_wait,
            "exec_cache": self.exec_cache.stats(),
        }
