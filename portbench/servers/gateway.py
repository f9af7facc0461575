"""The server of the kinds that serve a frozen plan: the port's
``serve.async_engine.AsyncCNNGateway`` with the configuration's plan
registered, handed the weights the kind drew from the seed.

Requests go in through ``submit_nowait``, the entry users call; one is
done when its future resolves, and emits the kind's units per request
then.  The gateway's ``stage_log`` notes each dispatch's stages and,
here, when it completed.  The cell's ``"gateway"`` block holds the
gateway's settings.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np

from portbench import harness


class StampedLog(list):
    """``AsyncCNNGateway.stage_log`` that also notes when each dispatch
    completed, on the recorder's clock."""

    def __init__(self, clock: Callable[[], float]):
        super().__init__()
        self.clock = clock
        self.stamps: List[float] = []

    def append(self, item) -> None:
        self.stamps.append(self.clock())
        super().append(item)


class Recorder(harness.Recorder):
    """Hands payloads to the gateway."""

    def __init__(self, gw, plan_id: str, pool: np.ndarray,
                 order: np.ndarray, keep: Callable[[int], bool]):
        from repro_torch.serve.async_engine import GatewayBacklog
        super().__init__(pool, order, keep)
        self.gw, self.plan_id = gw, plan_id
        self.backlog = GatewayBacklog

    def hand_over(self, i: int):
        try:
            return self.gw.submit_nowait(self.pool[self.payload_index(i)],
                                         plan_id=self.plan_id)
        except self.backlog:
            return None


@dataclass(kw_only=True)
class RunData(harness.RunData):
    """A gateway run: beside the common record, each completed dispatch
    as (completion time, ``DispatchStages``), the units a request
    carries, a request payload's bytes (by which the device trace is cut
    into dispatches) and the most requests a dispatch holds."""
    stages: List[Tuple[float, object]]
    units_per_request: int
    request_bytes: int
    max_batch: int


def _dispatches(data: RunData, admitted: List[int]) -> List[List[int]]:
    """The requests each dispatch served.  The cell's policy serves the
    queue in admission order and one dispatch is in flight at a time, so
    dispatch k holds the next ``n`` admitted requests; a log whose sizes
    do not add up to the answered requests gives nothing."""
    sizes = [st.n for _, st in data.stages]
    answered = [i for i in admitted if data.status[i] == "done"]
    if sum(sizes) != len(answered):
        return []
    out, k = [], 0
    for n in sizes:
        out.append(answered[k:k + n])
        k += n
    return out


class Server:
    """The gateway with the cell's plan registered, every bucket called
    once."""

    def __init__(self, system, cell, seed: int, device, config_dir):
        import torch
        from repro_torch.runtime import load_plan
        from repro_torch.serve.async_engine import (AsyncCNNGateway,
                                                    AsyncServeConfig)
        self.system, self.cell, self.device = system, cell, device
        self.torch = torch
        config = system.config
        gcfg = cell["gateway"]
        self.gw = AsyncCNNGateway(AsyncServeConfig(
            max_batch=gcfg["max_batch"], max_pending=gcfg["max_pending"],
            max_inflight=gcfg["max_inflight"], policy=gcfg["policy"],
            wait_budget_s=gcfg["wait_budget_s"],
            batch_linger=gcfg["batch_linger"]))
        self.plan_id = cell["config"]
        self.gw.register_plan(
            load_plan(config_dir / config["plan"]),
            plan_id=self.plan_id, params=system.params(), device=device)
        compiled = self.gw.plans[self.plan_id].compiled
        if list(compiled.buckets) != list(config["buckets"]):
            raise ValueError(f"the program serves buckets {compiled.buckets}"
                             f", the configuration states "
                             f"{config['buckets']}")
        # every bucket once through the program's entry, so that no first
        # call (kernel binding, cuBLAS heuristics) falls in the window
        for b in compiled.buckets:
            compiled(system.pool[:b])
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def recorder(self, order: np.ndarray,
                 keep: Callable[[int], bool]) -> Recorder:
        """The window's recorder; the gateway's stage log stamps on its
        clock from now on."""
        rec = Recorder(self.gw, self.plan_id, self.system.pool, order, keep)
        self.gw.stage_log = StampedLog(rec.now)
        return rec

    async def warm(self) -> None:
        """Two full dispatches and a single request through the gateway:
        its event loop, worker thread and futures, before any window."""
        rec = Recorder(self.gw, self.plan_id, self.system.pool,
                       np.arange(len(self.system.pool)), lambda i: False)
        n = 2 * self.cell["gateway"]["max_batch"] + 1
        futs = [rec.submit() for _ in range(n)]
        await asyncio.wait([f for f in futs if f is not None])

    async def close(self, rec: Recorder) -> None:
        rec.gw = None                  # the gateway is freed by release()
        await self.gw.close()

    def profiler_warmup(self) -> None:
        """One profiled forward, so that the profiler's own start-up
        (CUPTI) is set-up and not part of the traced slice."""
        from torch.profiler import ProfilerActivity, profile
        compiled = self.gw.plans[self.plan_id].compiled
        with profile(activities=[ProfilerActivity.CUDA]):
            compiled(self.system.pool[:1])
            self._sync()

    def data(self, rec: Recorder, **common) -> RunData:
        """The run's record: each answered request emits its units at its
        answer's time (written here, after the window, so that the window
        runs no more host code than the requests' own stamps)."""
        log = self.gw.stage_log or []
        system = self.system
        answered = common["status"] == "done"
        common.update(emitted_t=common["done"][answered],
                      emitted_units=np.full(int(answered.sum()),
                                            system.units_per_request))
        return RunData(
            **common, stages=list(zip(getattr(log, "stamps", []), log)),
            ops_per_unit=system.ops_per_request / system.units_per_request,
            units_per_request=system.units_per_request,
            request_bytes=system.request_bytes,
            max_batch=self.cell["gateway"]["max_batch"])

    def release(self) -> None:
        """Free the gateway, its compiled plan and the weights it was
        handed."""
        self.gw = None

    def check(self, rec: Recorder, data: RunData, rng: np.random.Generator,
              *, control: bool = False):
        payload = [rec.payload_index(i) for i in range(len(rec.sent))]
        return self.system.check(rec.answers, payload,
                                 _dispatches(data, rec.admitted), rng,
                                 self.cell["check"]["compare"],
                                 control=control)
