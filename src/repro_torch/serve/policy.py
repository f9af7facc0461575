"""Request-scheduling policies shared by every serving engine.

A copy of ``repro.serve.policy`` (the port keeps its own, importing
nothing of ``repro``).  Every engine must order work **identically** —
otherwise two paths serve the same workload in different orders and
tail-latency comparisons are meaningless.  This module is the one place
that ordering lives:

  ``FifoPolicy``      arrival order (the seed behavior).
  ``DeadlinePolicy``  priority tiers first (higher ``priority`` wins),
                      then earliest deadline (EDF), then arrival order —
                      a request without a deadline sorts after every
                      request that has one, inside its priority tier.

A policy maps a request to a **static sort key** (``key``); engines are
free to heapify once (the sync drain) or keep a live heap (the async
gateway) — the realized order is the same either way.  Requests are
duck-typed: ``priority`` / ``deadline`` are read with ``getattr``
defaults, so the LM ``Request`` (which has neither) sorts FIFO under
every policy.

Deadlines are *absolute* timestamps on the engine's clock
(``time.monotonic`` unless injected); ``expired(req, now)`` is the one
shared definition of "too late" so the sync and async paths can never
disagree about it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union


def priority_of(req) -> int:
    """Higher = more urgent; requests without the attribute are 0."""
    p = getattr(req, "priority", 0)
    return 0 if p is None else int(p)


def deadline_of(req) -> Optional[float]:
    """Absolute deadline on the engine clock, or None (no deadline)."""
    return getattr(req, "deadline", None)


def expired(req, now: float) -> bool:
    """True when ``req`` can no longer be started on time.  The one
    shared lateness rule: a request is expired once ``now`` has passed
    its absolute deadline; no-deadline requests never expire."""
    d = deadline_of(req)
    return d is not None and now > d


class SchedulingPolicy:
    """Orders requests.  ``key`` must be a static, mutually comparable
    tuple — engines sort/heapify on it without re-keying."""

    name = "policy"

    def key(self, req, seq: int, now: float) -> Tuple:
        raise NotImplementedError

    def shed_key(self, req, seq: int, now: float) -> Tuple:
        """Shed order is the *reverse* of service order: when bounded
        admission must eject a pending request to make room for a more
        urgent arrival, the victim is the pending entry with the
        **maximal** ``shed_key`` — by default the very key batches form
        on, so the last request that would have been served is the
        first one shed.  One ordering, two doors: batch formation and
        admission shedding can never disagree about who is least
        urgent.  Under FIFO the newest arrival always carries the
        maximal key, so a newcomer never outranks anyone and shedding
        degenerates to plain refusal — the seed behavior."""
        return self.key(req, seq, now)

    def order(self, reqs: Sequence, now: float) -> List:
        """Requests sorted most-urgent-first (stable on arrival order)."""
        return [r for _, _, r in sorted(
            (self.key(r, i, now), i, r) for i, r in enumerate(reqs))]


class FifoPolicy(SchedulingPolicy):
    """Arrival order — the seed engines' implicit policy."""

    name = "fifo"

    def key(self, req, seq: int, now: float) -> Tuple:
        return (seq,)


class DeadlinePolicy(SchedulingPolicy):
    """Priority tiers, then earliest-deadline-first, then arrival.

    Sort key: ``(-priority, deadline or +inf, seq)`` — a high-priority
    request preempts every lower tier regardless of deadlines, and
    inside a tier the soonest deadline runs first (no-deadline requests
    queue behind all deadlined ones, FIFO among themselves)."""

    name = "edf"

    def key(self, req, seq: int, now: float) -> Tuple:
        d = deadline_of(req)
        return (-priority_of(req), math.inf if d is None else float(d), seq)


FIFO = FifoPolicy()
EDF = DeadlinePolicy()

_POLICIES = {"fifo": FIFO, "edf": EDF, "deadline": EDF}

PolicyLike = Union[str, SchedulingPolicy, None]


def get_policy(policy: PolicyLike) -> SchedulingPolicy:
    """Resolve a policy name (or pass a policy through).  ``None`` means
    FIFO — the seed behavior stays the default everywhere."""
    if policy is None:
        return FIFO
    if isinstance(policy, SchedulingPolicy):
        return policy
    try:
        return _POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {policy!r}; "
            f"known: {sorted(set(_POLICIES))}") from None


def list_policies() -> Tuple[str, ...]:
    return tuple(sorted(set(_POLICIES)))
