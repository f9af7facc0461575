"""Virtual-clock fleet simulation — the seeded million-request SLO
harness of the reference's ``benchmarks/fleet_bench.py``.  Port of
``repro.fleet.sim``: numpy and the port's routers, no device; the same
seed gives a result identical, field for field, to the reference's.

Serving a million real CNN requests per benchmark run is not an option
in CI; what the fleet claims need is the *queueing* behavior, not the
convolutions.  This module replays a seeded arrival trace through the
**same router objects, the same ``WorkerView`` projection, and the same
EDF ordering discipline** the live fleet uses, against workers whose
service times follow their device profile's relative speed (a v5p is
``mxu_cost(v5p)/mxu_cost(v5e)`` ≈ 2.3× faster than a v5e per image, an
edge part 10× slower — the same ratios the deployment planner budgets
with).  Everything runs on a virtual clock driven by an event heap:

  arrival      route via ``Router.select`` over live views → push into
               the worker's EDF queue (priority tier, then deadline,
               then arrival — ``repro_torch.serve.policy.DeadlinePolicy``'s
               key, so the sim orders work exactly like the gateway)
  dispatch     an idle worker pops up to ``max_batch`` requests and
               schedules one batch completion at
               ``now + overhead + n · per_image`` (profile-scaled)
  completion   latencies recorded arrival→completion; next batch forms
  drain        at ``drain_at`` the worker stops admissions, its queued
               requests are evicted and re-routed through the same
               router — the virtual twin of ``Fleet.drain``

Determinism is absolute: the trace is a seeded ``default_rng`` draw,
every router tie-break ends on ``worker_id``, and the clock is just
float arithmetic — the same seed produces bit-identical results, which
is what lets the reference's ``BENCH_fleet.json`` be committed and
diffed, and what the port's parity tests hold against.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.allocate import V5E, DeviceProfile
from repro_torch.core.deploy import device_profile
from repro_torch.fleet.fleet import TIER_PRIORITY
from repro_torch.fleet.router import (Router, RouterLike, WorkerView,
                                      get_router)

#: v5e-scale service model: one batch costs overhead + n × per-image.
#: Other profiles scale both by their MXU budget relative to v5e —
#: the same relative-speed assumption the deployment planner budgets
#: with.  Absolute values mirror the measured quickstart-CNN step
#: (~12 ms for a full batch of 8 on the v5e profile).
V5E_IMAGE_S = 1.25e-3
V5E_OVERHEAD_S = 2.0e-3


@dataclass(frozen=True)
class TierSpec:
    """One traffic class: its share of the trace, the relative deadline
    stamped on its requests (None = no deadline), and the p99 SLO the
    benchmark holds the fleet to."""
    share: float
    deadline_s: Optional[float]
    slo_p99_s: float


#: the benchmark's three tiers: deadline-tight interactive traffic,
#: deadlined batch traffic, and undeadlined best-effort bulk
DEFAULT_TIERS: Dict[str, TierSpec] = {
    "interactive": TierSpec(share=0.2, deadline_s=0.25, slo_p99_s=0.25),
    "batch": TierSpec(share=0.3, deadline_s=2.0, slo_p99_s=2.0),
    "best_effort": TierSpec(share=0.5, deadline_s=None, slo_p99_s=15.0),
}


def profile_speed(profile: DeviceProfile) -> float:
    """Relative service speed vs v5e (the planner's MXU-budget ratio)."""
    return profile.budgets["mxu_cost"] / V5E.budgets["mxu_cost"]


@dataclass(frozen=True)
class SimWorkerSpec:
    """One simulated worker: a catalog profile (by name or value), the
    plans it serves, and its batch geometry."""
    worker_id: str
    profile: Union[str, DeviceProfile] = "v5e"
    plan_ids: Tuple[str, ...] = ("cnn",)
    max_batch: int = 8

    def resolve_profile(self) -> DeviceProfile:
        return (device_profile(self.profile)
                if isinstance(self.profile, str) else self.profile)


@dataclass(frozen=True)
class Trace:
    """A seeded request trace: sorted arrival times, per-request tier
    index, absolute deadline (+inf when none), and plan assignment
    (``plan_ids[plan_idx[i]]``; ``plan_idx=None`` constant-folds every
    request onto ``plan_ids[0]`` — the single-workload trace)."""
    arrivals: np.ndarray           # float64, sorted
    tier_idx: np.ndarray           # int8 index into tier_names
    deadlines: np.ndarray          # float64 absolute (inf = none)
    tier_names: Tuple[str, ...]
    plan_ids: Tuple[str, ...]      # distinct plan ids in the trace
    tiers: Dict[str, TierSpec]
    plan_idx: Optional[np.ndarray] = None   # int8 index into plan_ids

    def __len__(self) -> int:
        return len(self.arrivals)


def make_trace(n: int, rate: float, *,
               tiers: Dict[str, TierSpec] = DEFAULT_TIERS,
               plan_id: str = "cnn",
               plan_mix: Optional[Dict[str, float]] = None,
               seed: int = 0) -> Trace:
    """Seeded Poisson trace: exponential inter-arrivals at ``rate``
    requests/sec, tiers drawn at their configured shares, deadlines
    stamped relative to each arrival.  ``plan_mix`` (plan id → traffic
    share, summing to 1) draws a per-request plan for mixed-workload
    fleets — e.g. ``{"cnn": 0.7, "moe": 0.3}`` interleaves CNN and MoE
    requests through the same routing; without it every request targets
    ``plan_id`` and the rng stream is untouched, so pre-existing
    single-plan traces stay bit-identical.  Same (n, rate, tiers, mix,
    seed) → bit-identical trace."""
    if n < 1 or rate <= 0:
        raise ValueError(f"need n ≥ 1 and rate > 0 (got {n}, {rate})")
    shares = np.array([t.share for t in tiers.values()], dtype=np.float64)
    if not math.isclose(float(shares.sum()), 1.0, rel_tol=1e-9):
        raise ValueError(f"tier shares must sum to 1 (got "
                         f"{float(shares.sum()):.6f})")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    tier_idx = rng.choice(len(shares), size=n, p=shares).astype(np.int8)
    rel = np.array([math.inf if t.deadline_s is None else t.deadline_s
                    for t in tiers.values()])
    deadlines = arrivals + rel[tier_idx]
    plan_ids: Tuple[str, ...] = (plan_id,)
    plan_idx = None
    if plan_mix is not None:
        pshares = np.array(list(plan_mix.values()), dtype=np.float64)
        if not math.isclose(float(pshares.sum()), 1.0, rel_tol=1e-9):
            raise ValueError(f"plan_mix shares must sum to 1 (got "
                             f"{float(pshares.sum()):.6f})")
        plan_ids = tuple(plan_mix)
        plan_idx = rng.choice(len(pshares), size=n,
                              p=pshares).astype(np.int8)
    return Trace(arrivals=arrivals, tier_idx=tier_idx,
                 deadlines=deadlines, tier_names=tuple(tiers),
                 plan_ids=plan_ids, tiers=dict(tiers), plan_idx=plan_idx)


class _SimWorker:
    """Simulation-side worker: an EDF request queue, one in-flight
    batch, and a ``WorkerView`` updated in place (the router reads the
    view, never this object)."""

    __slots__ = ("spec", "profile", "per_image_s", "overhead_s", "view",
                 "queue", "busy", "served", "batches", "busy_s",
                 "served_by_tier", "served_by_plan", "dead", "gen")

    def __init__(self, spec: SimWorkerSpec):
        self.spec = spec
        self.profile = spec.resolve_profile()
        speed = profile_speed(self.profile)
        self.per_image_s = V5E_IMAGE_S / speed
        self.overhead_s = V5E_OVERHEAD_S / speed
        # steady-state full-batch service rate, for est_wait ordering
        full = self.overhead_s + spec.max_batch * self.per_image_s
        self.view = WorkerView(
            spec.worker_id, cost=self.profile.cost,
            plan_ids=spec.plan_ids, rate=spec.max_batch / full,
            max_batch=spec.max_batch)
        self.view.est_wait_s = 0.0
        self.queue: List[Tuple[tuple, int, int]] = []   # (key, seq, req)
        self.busy = False
        self.served = 0
        self.batches = 0
        self.busy_s = 0.0
        self.served_by_tier: Dict[str, int] = {}
        self.served_by_plan: Dict[str, int] = {}
        self.dead = False
        # incarnation counter: a kill bumps it, so completion events
        # scheduled by a dead incarnation are discarded at pop time
        self.gen = 0

    def service_s(self, n: int) -> float:
        return self.overhead_s + n * self.per_image_s

    def sync_wait(self) -> None:
        """Publish the view's reported wait after a queue/inflight
        mutation — the sim's stand-in for ``GatewayStats.est_wait``
        (the live gateway measures its rate; the sim's rate *is* its
        service model, so backlog over rate is exact).  Same float
        expression as the view's depth-over-rate fallback, so routing
        decisions — and the committed benchmark — are bit-identical to
        a view that reports no measured wait."""
        v = self.view
        v.est_wait_s = (v.queue_depth + v.inflight) / max(v.rate, 1e-9)


@dataclass
class SimResult:
    """One simulated run, reduced to the numbers the SLO acceptance
    reads.  ``per_tier[t]["slo_met"]`` is the headline; ``late`` counts
    deadline-carrying requests served past their deadline (the sim
    serves everything and scores lateness post-hoc — the live gateway
    would have expired them, which shows up as the same SLO miss)."""
    router: str
    n: int
    offered_rate: float
    duration_s: float
    completed: int
    lost: int
    rerouted: int
    late: int
    late_rerouted: int
    per_tier: Dict[str, Dict[str, float]]
    per_worker: Dict[str, Dict[str, object]]
    # live plan retirement (``retire_at``/``retire_plan_id``): arrivals
    # for the retired plan after routing closed — refused at the door,
    # not lost (every already-admitted request still completes)
    refused_retired: int = 0
    retired_plan: Optional[str] = None
    # kill→respawn (``kill_at``/``kill_worker``/``respawn_at``): queued
    # + mid-dispatch requests of the killed worker re-routed at kill
    # time on their original deadlines — the recovery contract is that
    # none of them land in ``lost``
    kill_rerouted: int = 0
    killed_worker: Optional[str] = None
    respawn_at_s: Optional[float] = None

    @property
    def all_slos_met(self) -> bool:
        return all(t["slo_met"] for t in self.per_tier.values())

    def to_payload(self) -> dict:
        return {
            "router": self.router,
            "requests": self.n,
            "offered_rate_per_s": self.offered_rate,
            "duration_s": self.duration_s,
            "completed": self.completed,
            "lost": self.lost,
            "rerouted": self.rerouted,
            "late": self.late,
            "late_rerouted": self.late_rerouted,
            "per_tier": self.per_tier,
            "per_worker": self.per_worker,
            "all_slos_met": self.all_slos_met,
            "refused_retired": self.refused_retired,
            "retired_plan": self.retired_plan,
            "kill_rerouted": self.kill_rerouted,
            "killed_worker": self.killed_worker,
            "respawn_at_s": self.respawn_at_s,
        }


def simulate(worker_specs: Sequence[SimWorkerSpec], trace: Trace,
             router: RouterLike = "plan_aware", *,
             drain_at: Optional[float] = None,
             drain_worker: Optional[str] = None,
             retire_at: Optional[float] = None,
             retire_plan_id: Optional[str] = None,
             kill_at: Optional[float] = None,
             kill_worker: Optional[str] = None,
             respawn_at: Optional[float] = None) -> SimResult:
    """Replay ``trace`` through a simulated fleet under ``router``.

    ``drain_at``/``drain_worker`` schedule one mid-trace graceful
    drain: at that virtual time the worker stops admissions, its queued
    requests re-enter routing (original arrival times and deadlines —
    the detour is on the request's own clock), and its in-flight batch
    finishes normally.  Fully deterministic for a fixed trace.

    ``retire_at``/``retire_plan_id`` schedule one mid-trace live plan
    retirement — the virtual twin of ``Fleet.retire_plan``: at that
    virtual time the plan disappears from every worker's routable set
    at once (phase 1), so later arrivals for it are *refused* (counted
    in ``refused_retired``, not ``lost``) while every request admitted
    before the cut still dispatches and completes normally (phase 2's
    drain) — zero admitted requests lost.

    ``kill_at``/``kill_worker`` schedule one mid-trace *crash* — the
    virtual twin of ``Fleet.kill``: unlike a drain, the in-flight batch
    does **not** finish (the process died mid-dispatch); it and every
    queued request re-enter routing at kill time on their original
    deadlines, counted in ``kill_rerouted``.  ``respawn_at`` (requires
    a kill, ≥ ``kill_at``) brings the same worker back warm — the
    virtual twin of ``Fleet.respawn`` from the shared store: same
    service model, empty queue, routable again.  The recovery
    invariant the benchmark gates: ``lost == 0`` through kill→respawn.
    """
    rtr: Router = get_router(router)
    workers = [_SimWorker(s) for s in sorted(worker_specs,
                                             key=lambda s: s.worker_id)]
    if len({w.spec.worker_id for w in workers}) != len(workers):
        raise ValueError("duplicate sim worker ids")
    if (drain_at is None) != (drain_worker is None):
        raise ValueError("drain_at and drain_worker go together")
    if (retire_at is None) != (retire_plan_id is None):
        raise ValueError("retire_at and retire_plan_id go together")
    if (kill_at is None) != (kill_worker is None):
        raise ValueError("kill_at and kill_worker go together")
    if respawn_at is not None:
        if kill_at is None:
            raise ValueError("respawn_at requires kill_at/kill_worker")
        if respawn_at < kill_at:
            raise ValueError(f"respawn_at={respawn_at} must be ≥ "
                             f"kill_at={kill_at}")
    by_id = {w.spec.worker_id: w for w in workers}
    if kill_worker is not None and kill_worker not in by_id:
        raise ValueError(f"unknown kill_worker {kill_worker!r}")
    views = [w.view for w in workers]

    n = len(trace)
    arrivals = trace.arrivals
    tier_idx = trace.tier_idx
    deadlines = trace.deadlines
    tier_names = trace.tier_names
    plan_names = trace.plan_ids
    # per-request plan index (constant 0 for single-workload traces)
    plan_arr = (np.zeros(n, dtype=np.int8) if trace.plan_idx is None
                else trace.plan_idx)
    tier_prio = np.array([TIER_PRIORITY[t] for t in tier_names])

    lat = np.full(n, np.nan)
    rerouted_mask = np.zeros(n, dtype=bool)
    lost = 0
    rerouted = 0
    refused_retired = 0
    kill_rerouted = 0

    # completion events only — arrivals stream from the sorted array;
    # ``gen`` stamps the worker incarnation that scheduled the batch,
    # so a kill invalidates its pending completion without heap surgery
    events: List[Tuple[float, int, int, int]] = []  # (time, seq, widx, gen)
    eseq = 0
    widx = {w.spec.worker_id: k for k, w in enumerate(workers)}

    def enqueue(w: _SimWorker, req: int, seq: int) -> None:
        # the gateway's EDF key: priority tier, then deadline, arrival
        key = (-int(tier_prio[tier_idx[req]]), float(deadlines[req]), seq)
        heapq.heappush(w.queue, (key, seq, req))
        w.view.queue_depth += 1
        w.sync_wait()

    def start_batch(w: _SimWorker, now: float) -> None:
        nonlocal eseq
        if w.busy or not w.queue:
            return
        # single-plan batches, most-urgent plan wins — the gateway's
        # dispatch rule: the EDF head picks the plan, the batch fills
        # with that plan's requests in EDF order (other plans' requests
        # keep their queue position for the next dispatch)
        batch = []
        head_plan = plan_arr[w.queue[0][2]]
        skipped = []
        while w.queue and len(batch) < w.spec.max_batch:
            entry = heapq.heappop(w.queue)
            if plan_arr[entry[2]] == head_plan:
                batch.append(entry[2])
            else:
                skipped.append(entry)
        for entry in skipped:
            heapq.heappush(w.queue, entry)
        w.view.queue_depth -= len(batch)
        w.view.inflight = len(batch)
        w.sync_wait()
        w.busy = batch
        svc = w.service_s(len(batch))
        w.busy_s += svc
        heapq.heappush(events,
                       (now + svc, eseq, widx[w.spec.worker_id], w.gen))
        eseq += 1

    def route(req: int, now: float, seq: int) -> bool:
        view = rtr.select(plan_names[plan_arr[req]],
                          tier_names[tier_idx[req]], views, now,
                          deadline=(None if math.isinf(deadlines[req])
                                    else float(deadlines[req])))
        if view is None:
            return False
        w = by_id[view.worker_id]
        enqueue(w, req, seq)
        start_batch(w, now)
        return True

    drain_time = math.inf if drain_at is None else float(drain_at)
    drained = False
    retire_time = math.inf if retire_at is None else float(retire_at)
    retired = False
    kill_time = math.inf if kill_at is None else float(kill_at)
    killed = False
    respawn_time = math.inf if respawn_at is None else float(respawn_at)
    respawned = False

    def note_unroutable(req: int) -> None:
        """An arrival no worker takes: a request for the retired plan
        was *refused* at the closed door; anything else is lost."""
        nonlocal lost, refused_retired
        if retired and plan_names[plan_arr[req]] == retire_plan_id:
            refused_retired += 1
        else:
            lost += 1

    def maybe_retire(now: float) -> None:
        """Phase 1 of ``Fleet.retire_plan`` on the virtual clock: the
        plan leaves every routable set at once.  Queued and in-flight
        requests for it are untouched — they dispatch through the
        normal batch path (phase 2's drain)."""
        nonlocal retired
        if retired or now < retire_time:
            return
        retired = True
        for w in workers:
            w.view.plan_ids = frozenset(
                p for p in w.view.plan_ids if p != retire_plan_id)

    def maybe_drain(now: float) -> None:
        # an evicted request failing re-route is *lost* even when its
        # plan retired — it had been admitted, unlike a fresh arrival
        nonlocal drained, rerouted, lost
        if drained or now < drain_time:
            return
        drained = True
        w = by_id[drain_worker]
        w.view.draining = True
        evicted = [req for _, _, req in sorted(w.queue)]
        w.queue.clear()
        w.view.queue_depth = 0
        w.sync_wait()
        for req in evicted:
            rerouted += 1
            rerouted_mask[req] = True
            # re-enter routing at drain time on the original deadline
            if not route(req, drain_time, 10 * n + req):
                lost += 1

    def maybe_kill(now: float) -> None:
        # the virtual twin of ``Fleet.kill``: the process dies, so —
        # unlike a drain — the in-flight batch does NOT finish; it and
        # the queue re-enter routing at kill time on their original
        # deadlines.  A re-route no survivor takes is *lost* (the
        # invariant the recovery bench gates to zero).
        nonlocal killed, rerouted, kill_rerouted, lost
        if killed or now < kill_time:
            return
        killed = True
        w = by_id[kill_worker]
        w.dead = True
        w.gen += 1                  # voids the pending completion event
        w.view.healthy = False
        # mid-dispatch first: it was dispatched because it was the most
        # urgent work, so it re-routes ahead of the queue
        evicted = ([] if not w.busy else list(w.busy)) \
            + [req for _, _, req in sorted(w.queue)]
        w.busy = False
        w.queue.clear()
        w.view.queue_depth = 0
        w.view.inflight = 0
        w.sync_wait()
        for req in evicted:
            rerouted += 1
            kill_rerouted += 1
            rerouted_mask[req] = True
            if not route(req, kill_time, 20 * n + req):
                lost += 1

    def maybe_respawn(now: float) -> None:
        # the virtual twin of ``Fleet.respawn`` from the shared store:
        # the worker returns warm (same service model — the executable
        # deserializes, nothing recompiles), empty queue, routable
        nonlocal respawned
        if respawned or now < respawn_time or not killed:
            return
        respawned = True
        w = by_id[kill_worker]
        w.dead = False
        w.view.healthy = True
        w.sync_wait()

    i = 0                           # next arrival index
    now = 0.0
    while i < n or events:
        next_arrival = arrivals[i] if i < n else math.inf
        if events and events[0][0] <= next_arrival:
            t, _, k, g = heapq.heappop(events)
            now = t
            maybe_retire(now)
            maybe_drain(now)
            maybe_kill(now)
            maybe_respawn(now)
            w = workers[k]
            if g != w.gen:
                # completion scheduled by a killed incarnation — the
                # batch already re-routed at kill time; drop the event
                continue
            batch = w.busy
            w.busy = False
            w.view.inflight = 0
            w.sync_wait()
            w.batches += 1
            for req in batch:
                lat[req] = now - arrivals[req]
                name = tier_names[tier_idx[req]]
                w.served_by_tier[name] = w.served_by_tier.get(name, 0) + 1
                pname = plan_names[plan_arr[req]]
                w.served_by_plan[pname] = w.served_by_plan.get(pname, 0) + 1
            w.served += len(batch)
            start_batch(w, now)
        else:
            now = next_arrival
            maybe_retire(now)
            maybe_drain(now)
            maybe_kill(now)
            maybe_respawn(now)
            if not route(i, now, i):
                note_unroutable(i)
            i += 1
    # a drain/retire/kill scheduled after the last event still happens
    maybe_retire(retire_time if retire_time is not math.inf else now)
    maybe_drain(drain_time if drain_time is not math.inf else now)
    maybe_kill(kill_time if kill_time is not math.inf else now)
    maybe_respawn(respawn_time if respawn_time is not math.inf else now)

    completed = int(np.count_nonzero(~np.isnan(lat)))
    finite_dl = ~np.isinf(deadlines)
    done = ~np.isnan(lat)
    late_mask = done & finite_dl & (arrivals + lat > deadlines)
    per_tier = {}
    for t, name in enumerate(tier_names):
        mask = (tier_idx == t) & done
        spec = trace.tiers[name]
        if not mask.any():
            per_tier[name] = {"served": 0, "slo_p99_s": spec.slo_p99_s,
                              "slo_met": True}
            continue
        p50, p95, p99 = np.percentile(lat[mask], [50, 95, 99])
        per_tier[name] = {
            "served": int(mask.sum()),
            "p50_s": float(p50), "p95_s": float(p95), "p99_s": float(p99),
            "mean_s": float(lat[mask].mean()),
            "max_s": float(lat[mask].max()),
            "late": int(np.count_nonzero(late_mask & (tier_idx == t))),
            "slo_p99_s": spec.slo_p99_s,
            "slo_met": bool(p99 <= spec.slo_p99_s),
        }
    duration = float(now)
    per_worker = {}
    for w in workers:
        per_worker[w.spec.worker_id] = {
            "profile": w.profile.name,
            "cost": w.profile.cost,
            "served": w.served,
            "batches": w.batches,
            "images_per_batch": w.served / max(w.batches, 1),
            "utilization": w.busy_s / max(duration, 1e-9),
            "served_by_tier": dict(sorted(w.served_by_tier.items())),
            "served_by_plan": dict(sorted(w.served_by_plan.items())),
            "plan_ids": list(w.spec.plan_ids),
            "drained": w.view.draining,
            "killed": bool(killed and w.spec.worker_id == kill_worker),
            "respawned": bool(respawned
                              and w.spec.worker_id == kill_worker),
        }
    return SimResult(
        router=rtr.name, n=n, offered_rate=float(
            n / arrivals[-1]) if n else 0.0,
        duration_s=duration, completed=completed, lost=lost,
        rerouted=rerouted, late=int(np.count_nonzero(late_mask)),
        late_rerouted=int(np.count_nonzero(late_mask & rerouted_mask)),
        per_tier=per_tier, per_worker=per_worker,
        refused_retired=refused_retired, retired_plan=retire_plan_id,
        kill_rerouted=kill_rerouted,
        killed_worker=(kill_worker if killed else None),
        respawn_at_s=(float(respawn_at) if respawned else None))
