"""Shared fixed-slot-pool discipline for the serving engines.

A copy of ``repro.serve.slots`` (the port keeps its own, importing
nothing of ``repro``), without the fault-injection seam, which arrives
with the port of ``repro.chaos``.  Every engine runs the same
bookkeeping: a fixed pool of ``max_batch`` request slots, a queue that
backfills free slots, and one engine ``step`` per drain over the
occupied slots.  ``SlotPool`` centralizes it:

  slots       ``active`` (fixed-size list of Optional requests),
              ``_free_slot``/``free_slots``, ``occupy``/``release``,
              ``live`` (occupied (slot, request) pairs)
  drain loop  ``run`` — heap-ordered queue backfill + step until both
              queue and pool are empty.  The ordering comes from a
              shared ``repro_torch.serve.policy`` policy (FIFO by default —
              a pre-sorted heap, so the seed's O(n) drain is kept);
              the async gateway uses the *same* policies, so sync and
              async order work identically.
  telemetry   ``occupancy_hist`` — live-slot histogram per step.  The
              backing store is a **fixed array of ``max_batch``
              counters** (a subclass reporting a bogus occupancy is
              clamped into range, never a new key), and every update
              and snapshot takes ``_stats_lock`` — ``stats()`` is safe
              to call from another thread while the async drain is
              mid-step, and two threads noting steps never lose counts.
  rate        ``service_rate`` — an EWMA of measured service capacity
              (images/sec over busy intervals), fed by ``_note_step``
              from the pool's own clock.  ``snapshot()`` derives
              ``est_wait`` (outstanding work ÷ measured rate) from it,
              which is what the async gateway's adaptive admission
              bound and the fleet routers consume: *measure, then
              resize the block to the budget*.

Subclasses implement ``submit`` (admission + request validation) and
``step`` (one tick over the pool), calling ``_note_step(live)`` so the
occupancy histogram stays current.  ``add_release_hook`` lets an async
owner be woken (e.g. ``loop.call_soon_threadsafe``) whenever capacity
frees — the async gateway's waiters block on exactly that signal.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.policy import PolicyLike, get_policy


@dataclass(frozen=True)
class GatewayStats:
    """One *consistent* point-in-time view of a serving engine — the
    snapshot the fleet health checks and routers read.

    Every field is captured in a single pass under the pool's stats
    lock (plus the owner's counters, which are only ever mutated on one
    thread), so a reader never sees e.g. a ``served`` count from after
    a step paired with an ``occupancy_hist`` from before it — the
    racing-dict-reads failure mode ``stats()`` dictionaries had.

    ``timestamp`` is the owner's monotonic clock at capture: a fleet
    treats snapshots as heartbeats and compares them by age.
    """
    timestamp: float               # monotonic clock at capture
    queue_depth: int               # admitted but not yet dispatched
    inflight: int                  # occupied slots (on-device or staged)
    max_batch: int
    steps: int
    occupancy_hist: Dict[int, int] = field(default_factory=dict)
    # terminal counts (zero for engines that don't track a class)
    served: int = 0
    rejected: int = 0
    expired: int = 0
    cancelled: int = 0
    failed: int = 0
    # measured throughput telemetry (0.0 until the first two steps):
    # ``service_rate`` is the pool's EWMA images/sec; ``est_wait`` is
    # ``depth / service_rate`` — the seconds of outstanding work a new
    # arrival would wait behind, as *measured*, not modeled.  Fleet
    # routers prefer these over inferring wait from raw queue depth.
    service_rate: float = 0.0
    est_wait: float = 0.0

    @property
    def depth(self) -> int:
        """Total outstanding work: queued + in-flight."""
        return self.queue_depth + self.inflight

    def asdict(self) -> Dict:
        return dataclasses.asdict(self)


class SlotPool:
    def __init__(self, max_batch: int, *,
                 clock: Callable[[], float] = time.monotonic,
                 rate_alpha: float = 0.25):
        if max_batch < 1:
            raise ValueError(
                f"max_batch={max_batch} must be ≥ 1 (a zero-slot "
                f"pool can never drain its queue)")
        if not 0.0 < rate_alpha <= 1.0:
            raise ValueError(
                f"rate_alpha={rate_alpha} must be in (0, 1]")
        self.max_batch = max_batch
        self.active: List[Optional[object]] = [None] * max_batch
        # realized live-slot counts: _occupancy[k-1] = steps that ran
        # with exactly k occupied slots (k ≥ 1; empty ticks don't step).
        # Fixed-size by construction — the histogram can never grow a
        # key per distinct batch size an engine happens to report.
        self._occupancy = [0] * max_batch
        self.steps = 0
        self._stats_lock = threading.Lock()
        self._release_hooks: List[Callable[[], None]] = []
        # measured service capacity: EWMA of live/Δt between
        # consecutive *busy* steps on the pool's clock (intervals with
        # idle time are skipped when the caller reports launch times —
        # see _note_step), so a lull in traffic never reads as the
        # hardware having slowed down.
        self._rate_clock = clock
        self._rate_alpha = float(rate_alpha)
        self._rate_ewma = 0.0
        # second, much slower EWMA of the same samples: the admission
        # bound reads this one, so believing "capacity halved" takes
        # sustained evidence (~16× the fast horizon) and a transient
        # host stall absorbs into the queue instead of mass-shedding a
        # recoverable burst; ``service_rate`` (routing, est_wait) stays
        # fast so wait estimates track reality promptly
        self._rate_slow_alpha = self._rate_alpha / 16.0
        self._rate_slow = 0.0
        self._last_step_t: Optional[float] = None
        # busy-run accumulator (callers that report launch times):
        # images completed since the run's first launch — the sample
        # is run_images/Δt from that anchor, which aggregates
        # overlapped dispatches correctly and never spans idle time
        # marks are (completion time, cumulative run images) — the
        # sample window slides over them so the estimate forgets any
        # stretch more than ~2 pool-fills of images ago
        self._run_marks: Deque[Tuple[float, int]] = deque()
        self._run_images = 0

    # -- slot bookkeeping ------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def free_slots(self) -> int:
        """How many slots are currently unoccupied."""
        return sum(1 for r in self.active if r is None)

    def live(self):
        """Occupied (slot, request) pairs, in slot order."""
        return [(i, r) for i, r in enumerate(self.active) if r is not None]

    def occupy(self, req) -> int:
        """Place ``req`` into the first free slot; raises when full
        (callers gate on ``free_slots``/``_free_slot`` first)."""
        slot = self._free_slot()
        if slot is None:
            raise RuntimeError("slot pool full")
        self.active[slot] = req
        return slot

    def release(self, slot: int) -> None:
        """Free one slot and wake any release hooks (async waiters)."""
        self.active[slot] = None
        for hook in self._release_hooks:
            hook()

    def add_release_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook()`` after every ``release`` — the async gateway
        registers ``loop.call_soon_threadsafe(...)`` here so coroutines
        waiting for capacity wake the moment a slot frees."""
        self._release_hooks.append(hook)

    # -- telemetry -------------------------------------------------------
    def _note_step(self, live: int, *,
                   launched_at: Optional[float] = None) -> None:
        """Record one executed tick over ``live`` occupied slots.
        Out-of-range counts clamp to the nearest bucket (the histogram
        is bounded by construction); thread-safe under the async drain.

        Also feeds the EWMA service-*capacity* estimator.  A caller
        that knows when this step's work was *launched* should pass
        ``launched_at``: completions then accumulate into **busy
        runs** — a dispatch launched after the previous completion
        starts a fresh run at its own launch time — and each sample is
        images over elapsed time inside a **sliding window** of the
        run's most recent ~2 pool-fills of completions.  That
        aggregates overlapped dispatches correctly (pairwise
        completion gaps would alias), forgets a transient slow stretch
        within ~2 pool-fills (a cumulative run average would drag for
        the rest of the run), and idle time never enters a
        sample, so a lull in traffic cannot read as the hardware
        having slowed down: the estimate is what the pool clears when
        given work, which is what admission bounds and routers size
        against.  Callers whose loops are always busy (the sync
        drain) omit ``launched_at`` and sample ``live/Δt`` between
        consecutive steps."""
        k = min(max(int(live), 1), self.max_batch)
        now = self._rate_clock()
        with self._stats_lock:
            self.steps += 1
            self._occupancy[k - 1] += 1
            inst = None
            if launched_at is None:
                if self._last_step_t is not None:
                    dt = now - self._last_step_t
                    if dt > 0.0:
                        inst = k / dt
            else:
                if (self._last_step_t is None
                        or launched_at > self._last_step_t):
                    # fresh busy run anchored at this launch
                    self._run_images = 0
                    self._run_marks.clear()
                    self._run_marks.append((launched_at, 0))
                self._run_images += k
                # slide the window: drop marks once ≥ 2 pool-fills of
                # completions sit behind a newer one, so a transient
                # bad stretch (host noise, one slow dispatch) washes
                # out of the estimate within ~2 pool-fills instead of
                # dragging the whole run's cumulative average down
                marks = self._run_marks
                while len(marks) >= 2 and \
                        self._run_images - marks[1][1] >= 2 * self.max_batch:
                    marks.popleft()
                t0, c0 = marks[0]
                dt = now - t0
                if dt > 0.0:
                    inst = (self._run_images - c0) / dt
                marks.append((now, self._run_images))
            if inst is not None:
                # a k-image step carries k images of evidence: blend
                # with 1-(1-α)^k so the estimate converges per
                # *image*, not per step — a trickle of 1-image batches
                # cannot pin the estimate while full batches snap it
                # to the measured rate fast
                w = 1.0 - (1.0 - self._rate_alpha) ** k
                self._rate_ewma = (
                    inst if self._rate_ewma == 0.0
                    else w * inst + (1.0 - w) * self._rate_ewma)
                ws = 1.0 - (1.0 - self._rate_slow_alpha) ** k
                self._rate_slow = (
                    inst if self._rate_slow == 0.0
                    else ws * inst + (1.0 - ws) * self._rate_slow)
            self._last_step_t = now

    @property
    def service_rate(self) -> float:
        """Measured throughput (EWMA images/sec); 0.0 until two steps
        have run on the pool's clock."""
        with self._stats_lock:
            return self._rate_ewma

    @property
    def service_rate_slow(self) -> float:
        """Slow-horizon throughput EWMA (images/sec) — what capacity
        commitments (the adaptive admission bound) should read: it
        takes sustained evidence to move, so a transient host stall
        queues instead of shedding, while a real sustained slowdown
        still tightens the bound within a few dozen pool-fills."""
        with self._stats_lock:
            return self._rate_slow

    @property
    def occupancy_hist(self) -> Dict[int, int]:
        """Sparse view of the bounded histogram: {live count: steps},
        zero-count buckets omitted (snapshot — safe to mutate)."""
        with self._stats_lock:
            counts = list(self._occupancy)
        return {k + 1: c for k, c in enumerate(counts) if c}

    def snapshot(self, *, clock: Callable[[], float] = time.monotonic,
                 queue_depth: int = 0, **counters) -> GatewayStats:
        """One consistent ``GatewayStats`` capture: histogram, step
        count, and slot occupancy are read in a single critical section
        under ``_stats_lock``.  Subclasses layer their own terminal
        counters on via ``**counters`` (``served=``, ``expired=``, …)
        and their queue depth via ``queue_depth`` — those are owned by
        a single mutating thread, so reading them alongside the locked
        fields yields the one-pass snapshot fleet health checks need."""
        with self._stats_lock:
            hist = {k + 1: c for k, c in enumerate(self._occupancy) if c}
            steps = self.steps
            inflight = sum(1 for r in self.active if r is not None)
            rate = self._rate_ewma
        est_wait = ((queue_depth + inflight) / rate) if rate > 0 else 0.0
        return GatewayStats(
            timestamp=clock(), queue_depth=queue_depth, inflight=inflight,
            max_batch=self.max_batch, steps=steps, occupancy_hist=hist,
            service_rate=rate, est_wait=est_wait, **counters)

    def stats(self) -> Dict:
        """Base telemetry dict — one consistent ``snapshot()`` flattened
        to the mapping shape the engines' ``stats()`` extend."""
        return self.snapshot().asdict()

    # -- engine interface ------------------------------------------------
    def submit(self, req) -> bool:
        """Admit one request into a free slot; False when it must wait
        (pool full, or the engine's admission rule defers it)."""
        raise NotImplementedError

    def step(self):
        """One tick over the occupied slots (subclasses)."""
        raise NotImplementedError

    # -- the drain loop ---------------------------------------------------
    def run(self, requests: Sequence, *, policy: PolicyLike = None,
            clock: Callable[[], float] = time.monotonic) -> List:
        """Serve a workload to completion: backfill free slots from the
        queue in ``policy`` order, step, repeat.

        The queue is a binary heap on the policy's static sort key.
        Under the default FIFO policy the keys are the arrival indices,
        so heapify of the already-ordered list is O(n) and each pop
        O(log n) — a large workload still costs ~O(n log n), not the
        seed's O(n²) ``list.pop(0)``.  Pass ``policy="edf"`` (or any
        ``repro_torch.serve.policy`` policy) for deadline-aware ordering —
        the *same* policies the async gateway schedules with."""
        requests = list(requests)
        pol = get_policy(policy)
        now = clock()
        heap = [(pol.key(r, i, now), i, r)
                for i, r in enumerate(requests)]
        heapq.heapify(heap)
        head = None                     # popped but not yet admitted
        while heap or head is not None \
                or any(r is not None for r in self.active):
            while True:
                if head is None:
                    if not heap:
                        break
                    head = heapq.heappop(heap)
                if not self.submit(head[2]):
                    break               # pool full / deferred: step first
                head = None
            self.step()
        return requests
