"""Worker health: consecutive-failure ejection, probe re-admission.
Port of ``repro.fleet.health`` (pure Python, the same state machine).

Health is judged from serving *outcomes* (every completed, failed, or
unreachable request reported by the fleet) against ``GatewayStats``
heartbeats: a worker that fails ``eject_after`` requests in a row is
ejected — routers stop seeing it — and after ``probe_interval`` seconds
in exile it becomes *probe-due*: the router may send it exactly one
live request as a canary.  A served probe re-admits the worker
immediately; a failed probe restarts the exile clock (linear back-off
by re-arming the same interval, so a flapping worker costs one request
per interval, not a retry storm).

The state machine is synchronous and clock-injected, exactly like the
gateway's ``AdmissionQueue``: the live asyncio ``Fleet`` feeds it
``time.monotonic`` outcomes, the virtual-clock simulator feeds it
simulated time, and the transitions are unit-tested with a fake clock.

States::

    healthy ──(eject_after consecutive failures)──▶ ejected
    ejected ──(probe_interval elapsed)────────────▶ probe-due
    probe-due ──(router picks it: begin_probe)────▶ probing
    probing ──(success)──▶ healthy      probing ──(failure)──▶ ejected
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HealthPolicy:
    """Fleet-wide knobs for the per-worker state machine."""
    eject_after: int = 3        # consecutive failures before ejection
    probe_interval: float = 1.0   # seconds ejected before a probe is due

    def __post_init__(self):
        if self.eject_after < 1:
            raise ValueError(
                f"eject_after={self.eject_after} must be ≥ 1")
        if self.probe_interval <= 0:
            raise ValueError(
                f"probe_interval={self.probe_interval} must be > 0")


class WorkerHealth:
    """One worker's health state.  ``routable(now)`` is what the fleet
    projects into the router's ``WorkerView.healthy``; ``begin_probe``
    must be called when an ejected worker is actually *selected*, so at
    most one canary is outstanding at a time."""

    def __init__(self, policy: HealthPolicy):
        self.policy = policy
        self.consecutive_failures = 0
        self.ejected = False
        self.ejected_at = 0.0
        self.probing = False
        # cumulative telemetry
        self.ejections = 0
        self.probes = 0

    @property
    def healthy(self) -> bool:
        return not self.ejected

    def routable(self, now: float) -> bool:
        """May the router send this worker a request right now?  True
        while healthy, and for an ejected worker exactly when a probe
        is due and none is already in flight."""
        if not self.ejected:
            return True
        return (not self.probing
                and now - self.ejected_at >= self.policy.probe_interval)

    def begin_probe(self) -> None:
        """An ejected worker was selected: the request now in flight is
        the canary — no second one until it resolves."""
        if self.ejected:
            self.probing = True
            self.probes += 1

    def note_success(self) -> None:
        """A request served: reset the failure streak; a successful
        probe re-admits the worker."""
        self.consecutive_failures = 0
        if self.ejected:
            self.ejected = False
        self.probing = False

    def note_neutral(self) -> None:
        """An outcome that says nothing about worker health (e.g. the
        request's deadline expired while queued): the failure streak is
        untouched, but an outstanding probe is released so the next
        canary can go out."""
        self.probing = False

    def force_eject(self, now: float) -> None:
        """Administrative ejection (worker killed / declared dead):
        immediately unroutable, probe clock armed at ``now``.  Unlike
        ``note_failure`` this does not wait for a failure streak —
        death is not a statistical question.  Idempotent on an
        already-ejected worker (re-arms the exile clock)."""
        if not self.ejected:
            self.ejections += 1
        self.ejected = True
        self.ejected_at = now
        self.probing = False
        self.consecutive_failures = max(self.consecutive_failures,
                                        self.policy.eject_after)

    def note_failure(self, now: float) -> None:
        """A request failed (dispatch error or unreachable stats).
        Failed probes re-arm the exile clock; ``eject_after`` straight
        failures eject a healthy worker."""
        self.consecutive_failures += 1
        if self.ejected:
            self.probing = False
            self.ejected_at = now          # back off: full interval again
        elif self.consecutive_failures >= self.policy.eject_after:
            self.ejected = True
            self.ejected_at = now
            self.probing = False
            self.ejections += 1

    def __repr__(self) -> str:                    # pragma: no cover
        state = ("probing" if self.probing
                 else "ejected" if self.ejected else "healthy")
        return (f"WorkerHealth({state}, "
                f"streak={self.consecutive_failures}, "
                f"ejections={self.ejections})")
