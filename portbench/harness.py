"""One run of one cell: set up, measure for a fixed window, check.

The system under test is the port's ``serve.async_engine.AsyncCNNGateway``
with the cell's frozen plan registered, handed weights the benchmark drew
from the seed.  A traffic module (``traffic/<kind>.py``) drives it through
``submit_nowait``, the entry users call, while a ``Recorder`` stamps every
request: when it was handed over, when its answer came back and what the
answer was.  After the window every request still owed
an answer is waited for (a minute at most), the device's peak memory is
read, the program's state is freed, and the kind's plain reference
recomputes a seeded sample of the answers.

With ``trace`` the last ``TRACE_SLICE_S`` seconds of the window run under
``torch.profiler``; per-layer metrics read the device there and the host
before it.
"""

from __future__ import annotations

import asyncio
import functools
import gc
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from portbench import catalog

SRC = catalog.ROOT / "src"
#: seconds after the window closes that an answer is still waited for
SETTLE_S = 60.0
#: the traced slice at the window's end: 2 s, or a quarter of a short window
TRACE_SLICE_S = 2.0


def import_port():
    """Put the port's sources on the path (the checkout's ``src/``)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


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


class Recorder:
    """Hands payloads to the gateway and stamps each request.  Every time
    is in seconds from the window's start on ``time.perf_counter``."""

    def __init__(self, gw, plan_id: str, pool: np.ndarray,
                 order: np.ndarray, keep: Callable[[int], bool]):
        from repro_torch.serve.async_engine import GatewayBacklog
        self.gw, self.plan_id, self.pool = gw, plan_id, pool
        self.order, self.keep = order, keep
        self.backlog = GatewayBacklog
        self.t0 = time.perf_counter()
        self.sent: List[float] = []
        self.done: List[float] = []
        self.status: List[str] = []
        self.admitted: List[int] = []      # request indices, in admission
        self.answers: Dict[int, np.ndarray] = {}
        self.pending: set = set()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def payload_index(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def submit(self):
        """Submit the next request; its future, or None when the gateway
        refused it at the door."""
        i = len(self.sent)
        self.sent.append(self.now())
        self.done.append(float("nan"))
        self.status.append("pending")
        try:
            fut = self.gw.submit_nowait(self.pool[self.payload_index(i)],
                                        plan_id=self.plan_id)
        except self.backlog:
            self.status[i] = "shed"
            return None
        self.admitted.append(i)
        self.pending.add(fut)
        fut.add_done_callback(functools.partial(self._finished, i))
        return fut

    def _finished(self, i: int, fut) -> None:
        self.done[i] = self.now()
        self.pending.discard(fut)
        if fut.cancelled():
            self.status[i] = "cancelled"
        elif fut.exception() is not None:
            self.status[i] = type(fut.exception()).__name__
        else:
            self.status[i] = "done"
            if self.keep(i):
                self.answers[i] = fut.result()


@dataclass
class RunData:
    """What a run recorded, as metric readers see it.  Times are seconds
    from the window's start; ``traced`` is the profiled slice, or None."""
    cell: Dict
    config: Dict
    seconds: float
    setup_s: float
    sent: np.ndarray
    done: np.ndarray
    status: np.ndarray
    stages: List[Tuple[float, object]]
    units_per_request: int
    ops_per_request: float
    request_bytes: int
    max_batch: int
    traced: Optional[Tuple[float, float]] = None
    events: list = field(default_factory=list)

    @property
    def host_end(self) -> float:
        """Where the untraced part of the window ends."""
        return self.traced[0] if self.traced else self.seconds

    def completed(self, end: float) -> np.ndarray:
        """Mask of requests answered within [0, end)."""
        return (self.status == "done") & (self.done < end)


@dataclass
class Outcome:
    data: RunData
    checks: Dict[str, float]
    limits: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    device_kind: str
    busy_s: Optional[float] = None
    window_s: Optional[float] = None

    @property
    def correct(self) -> bool:
        return self.checks.get("compared", 0) > 0 and all(
            self.checks.get(k, float("inf")) <= lim
            for k, lim in self.limits.items())


def _keep_fn(check: Dict, seed: int) -> Callable[[int], bool]:
    """Which answers are kept for the check: runs of ``keep_run``
    consecutive requests, one run in every ``keep_every``, at an offset
    drawn from the seed."""
    run, every = check["keep_run"], check["keep_every"]
    off = int(np.random.default_rng([seed, 2]).integers(every))
    return lambda i: (i // run) % every == off


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


class Bench:
    """A cell set up once: ``warm``, then ``window``, then, once the
    program's state is released, ``check``."""

    def __init__(self, cell_name: str, seed: int, *, device: str = "cuda",
                 root: Path = catalog.ROOT):
        import_port()
        import torch
        from repro_torch.runtime import load_plan
        from repro_torch.serve.async_engine import (AsyncCNNGateway,
                                                    AsyncServeConfig)
        self.seed = seed
        self.torch = torch
        self.device = torch.device(device)
        self.cell = catalog.cell(cell_name, root)
        self.config = catalog.config(self.cell["config"], root)
        kind = catalog.module("kinds", self.config["kind"], root)
        self.traffic = catalog.module("traffic", self.cell["traffic"]["kind"],
                                      root)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        self.system = kind.System(self.config, seed, self.device,
                                  catalog.config_dir(root))
        gcfg = self.cell["gateway"]
        self.gw = AsyncCNNGateway(AsyncServeConfig(
            max_batch=gcfg["max_batch"], max_pending=gcfg["max_pending"],
            max_inflight=gcfg["max_inflight"], policy=gcfg["policy"],
            wait_budget_s=gcfg["wait_budget_s"],
            batch_linger=gcfg["batch_linger"]))
        self.plan_id = self.cell["config"]
        self.gw.register_plan(
            load_plan(catalog.config_dir(root) / self.config["plan"]),
            plan_id=self.plan_id, params=self.system.params(),
            device=self.device)
        compiled = self.gw.plans[self.plan_id].compiled
        if list(compiled.buckets) != list(self.config["buckets"]):
            raise ValueError(f"the program serves buckets {compiled.buckets}"
                             f", the configuration states "
                             f"{self.config['buckets']}")
        # every bucket once through the program's entry, so that no first
        # call (kernel binding, cuBLAS heuristics) falls in the window
        for b in compiled.buckets:
            compiled(self.system.pool[:b])
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    async def warm(self) -> None:
        """Two full dispatches and a single request through the gateway:
        its event loop, worker thread and futures, before any window."""
        order = np.arange(len(self.system.pool))
        rec = Recorder(self.gw, self.plan_id, self.system.pool, order,
                       lambda i: False)
        n = 2 * self.cell["gateway"]["max_batch"] + 1
        futs = [rec.submit() for _ in range(n)]
        await asyncio.wait([f for f in futs if f is not None])

    async def window(self, seconds: float, *, trace: bool = False
                     ) -> Tuple[Recorder, Optional[Dict]]:
        """Drive the cell's traffic for ``seconds``, then wait for every
        answer still owed.  Returns the recorder and, traced, the
        profiler's slice."""
        params = self.cell["traffic"]
        plan = self.traffic.plan(params, self.seed, seconds,
                                 len(self.system.pool))
        self.gw.stage_log = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats(self.device)
        rec = Recorder(self.gw, self.plan_id, self.system.pool,
                       plan["order"], _keep_fn(self.cell["check"],
                                               self.seed))
        self.gw.stage_log = StampedLog(rec.now)
        profiled = None
        prof_task = None
        if trace:
            prof_task = asyncio.ensure_future(self._profile(rec, seconds))
        await self.traffic.drive(rec, params, plan, seconds)
        await asyncio.sleep(max(0.0, seconds - rec.now()))
        if prof_task is not None:
            profiled = await prof_task
        if rec.pending:
            await asyncio.wait(set(rec.pending), timeout=SETTLE_S)
        rec.gw = None                  # the gateway is freed by release()
        return rec, profiled

    async def _profile(self, rec: Recorder, seconds: float) -> Dict:
        from torch.profiler import ProfilerActivity, profile
        from portbench.yardstick import trace as tr
        start = seconds - min(TRACE_SLICE_S, seconds / 4)
        await asyncio.sleep(max(0.0, start - rec.now()))
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t_on = rec.now()
        await asyncio.sleep(max(0.0, seconds - rec.now()))
        t_off = rec.now()
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            events = tr.device_events(path)
        finally:
            os.remove(path)
        return {"slice": (t_on, t_off), "events": events}

    def profiler_warmup(self) -> None:
        """One profiled forward, so that the profiler's own start-up
        (CUPTI) is set-up and not part of the traced slice."""
        from torch.profiler import ProfilerActivity, profile
        compiled = self.gw.plans[self.plan_id].compiled
        with profile(activities=[ProfilerActivity.CUDA]):
            compiled(self.system.pool[:1])
            self._sync()

    def data(self, rec: Recorder, seconds: float, setup_s: float,
             profiled: Optional[Dict]) -> RunData:
        log = self.gw.stage_log or []
        return RunData(
            cell=self.cell, config=self.config, seconds=seconds,
            setup_s=setup_s, sent=np.asarray(rec.sent, dtype=np.float64),
            done=np.asarray(rec.done, dtype=np.float64),
            status=np.asarray(rec.status),
            stages=list(zip(getattr(log, "stamps", []), log)),
            units_per_request=self.system.units_per_request,
            ops_per_request=self.system.ops_per_request,
            request_bytes=self.system.request_bytes,
            max_batch=self.cell["gateway"]["max_batch"],
            traced=profiled["slice"] if profiled else None,
            events=profiled["events"] if profiled else [])

    def release(self) -> None:
        """Free the program's state: the gateway, its compiled plan and
        the weights it was handed."""
        self.gw = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, rec: Recorder, data: RunData, *,
              control: bool = False) -> Dict[str, float]:
        chk = self.cell["check"]
        rng = np.random.default_rng([self.seed, 3])
        payload = [rec.payload_index(i) for i in range(len(rec.sent))]
        with self.torch.no_grad():
            out = self.system.check(rec.answers, payload,
                                    _dispatches(data, rec.admitted), rng,
                                    chk["compare"], control=control)
        out["lost"] = int(np.sum(data.status == "pending"))
        return out


def run_cell(cell_name: str, seed: int, seconds: float, *,
             trace: bool = False, device: str = "cuda",
             root: Path = catalog.ROOT,
             started: Optional[float] = None) -> Outcome:
    """Set up, warm up, measure for ``seconds``, check.  ``started`` is
    the process's first clock reading (``time.perf_counter``), from which
    ``setup_s`` runs to the window's start."""
    started = time.perf_counter() if started is None else started
    bench = Bench(cell_name, seed, device=device, root=root)
    if trace:
        bench.profiler_warmup()

    async def main():
        await bench.warm()
        setup_s = time.perf_counter() - started
        rec, profiled = await bench.window(seconds, trace=trace)
        await bench.gw.close()
        return rec, setup_s, profiled

    rec, setup_s, profiled = asyncio.run(main())
    data = bench.data(rec, seconds, setup_s, profiled)
    torch = bench.torch
    peak = int(torch.cuda.max_memory_allocated(bench.device)) \
        if bench.device.type == "cuda" else 0
    kind_name = torch.cuda.get_device_name(bench.device) \
        if bench.device.type == "cuda" else "cpu"
    bench.release()
    checks = bench.check(rec, data)
    limits = dict(bench.config["limits"], lost=0)
    # a request belongs to the window if it was sent before it closed
    attempted = data.sent < seconds
    failed = int(np.sum(attempted & (data.status != "done")))
    busy = window = None
    if profiled:
        from portbench.yardstick import trace as tr
        busy = tr.busy_s(profiled["events"])
        window = profiled["slice"][1] - profiled["slice"][0]
    return Outcome(data=data, checks=checks, limits=limits,
                   attempted=int(np.sum(attempted)), failed=failed,
                   memory_peak_bytes=peak, device_kind=kind_name,
                   busy_s=busy, window_s=window)
