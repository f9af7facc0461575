"""One run of one cell: set up, measure for a fixed window, check.

A run is split between what every cell shares, here, and a server, which
belongs to the configuration's kind (``kinds/<kind>.py`` names it in
``SERVER``; ``servers/<server>.py`` holds it).  The server sets the port
up from the kind's ``System`` (weights and payloads the benchmark drew
from the seed) and the cell's own settings block, warms every shape the
cell's traffic uses, and hands out a ``Recorder`` through which a traffic
module (``traffic/<kind>.py``) drives it: ``submit()`` hands the next
request to the program, and the recorder stamps when it was handed over,
when its answer came back, what the answer was and, as ``emit``, each
unit of work (an image, a token) when the program produced it.

Here: TF32 off; ``setup_s`` from the process's start to the window's
start; the window itself; with ``trace`` the last ``TRACE_SLICE_S``
seconds of it under ``torch.profiler``; after it every request still
owed an answer waited for (a minute at most), the device's peak memory
read and the program released; then the server hands a seeded sample of
the recorded answers to the kind's plain reference.  Per-layer metrics
read the device in the traced slice and the host before it.

A server module holds ``Server(system, cell, seed, device, config_dir)``
with ``profiler_warmup()``, ``async warm()``, ``recorder(order, keep)``,
``async close(rec)``, ``data(rec, **common) -> RunData``, ``release()``
and ``check(rec, data, rng, control=False)``.
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


class Recorder:
    """Hands requests to the program and stamps each.  Every time is in
    seconds from the window's start on ``time.perf_counter``.  A server's
    recorder implements ``hand_over(i)``: the future of request ``i``'s
    answer, or None when the program refused it at the door."""

    def __init__(self, pool, order: np.ndarray,
                 keep: Callable[[int], bool]):
        self.pool, self.order, self.keep = pool, order, keep
        self.t0 = time.perf_counter()
        self.sent: List[float] = []
        self.done: List[float] = []
        self.status: List[str] = []
        self.admitted: List[int] = []      # request indices, in admission
        self.answers: Dict[int, object] = {}
        self.pending: set = set()
        #: (time, units) of the work the program produced, as produced
        self.emitted: List[Tuple[float, int]] = []

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def payload_index(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def hand_over(self, i: int):
        raise NotImplementedError

    def submit(self):
        """Submit the next request; its future, or None when the program
        refused it at the door."""
        i = len(self.sent)
        self.sent.append(self.now())
        self.done.append(float("nan"))
        self.status.append("pending")
        fut = self.hand_over(i)
        if fut is None:
            self.status[i] = "shed"
            return None
        self.admitted.append(i)
        self.pending.add(fut)
        fut.add_done_callback(functools.partial(self._finished, i))
        return fut

    def emit(self, units: int, at: float) -> None:
        """``units`` of work produced at ``at``.  Safe from any thread."""
        self.emitted.append((at, units))

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


@dataclass(kw_only=True)
class RunData:
    """What a run recorded, as metric readers see it.  Times are seconds
    from the window's start; ``emitted_t`` and ``emitted_units`` are the
    work the program produced and when; ``ops_per_unit`` the operations a
    unit needs (the yardstick's count); ``traced`` is the profiled slice,
    or None.  A server's subclass adds what only it records."""
    cell: Dict
    config: Dict
    seconds: float
    setup_s: float
    sent: np.ndarray
    done: np.ndarray
    status: np.ndarray
    emitted_t: np.ndarray
    emitted_units: np.ndarray
    ops_per_unit: float
    traced: Optional[Tuple[float, float]] = None
    events: list = field(default_factory=list)

    @property
    def host_end(self) -> float:
        """Where the untraced part of the window ends."""
        return self.traced[0] if self.traced else self.seconds

    def completed(self, end: float) -> np.ndarray:
        """Mask of requests answered within [0, end)."""
        return (self.status == "done") & (self.done < end)

    def units_before(self, end: float) -> int:
        """Units the program produced within [0, end)."""
        return int(np.sum(self.emitted_units[self.emitted_t < end]))


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


class Bench:
    """A cell set up once: its server's ``warm``, then ``window``, then,
    once the program's state is released, ``check``.  ``server`` is the
    kind's server over the kind's ``system``."""

    def __init__(self, cell_name: str, seed: int, *, device: str = "cuda",
                 root: Path = catalog.ROOT):
        import_port()
        import torch
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
        config_dir = catalog.config_dir(root)
        self.system = kind.System(self.config, seed, self.device, config_dir)
        self.server = catalog.module("servers", kind.SERVER, root).Server(
            self.system, self.cell, seed, self.device, config_dir)

    async def window(self, seconds: float, *, trace: bool = False
                     ) -> Tuple[Recorder, Optional[Dict]]:
        """Drive the cell's traffic for ``seconds``, then wait for every
        answer still owed and close the server.  Returns the recorder
        and, traced, the profiler's slice."""
        params = self.cell["traffic"]
        plan = self.traffic.plan(params, self.seed, seconds,
                                 len(self.system.pool))
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats(self.device)
        rec = self.server.recorder(plan["order"],
                                   _keep_fn(self.cell["check"], self.seed))
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
        await self.server.close(rec)
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

    def data(self, rec: Recorder, seconds: float, setup_s: float,
             profiled: Optional[Dict]) -> RunData:
        emitted = np.asarray(rec.emitted, dtype=np.float64).reshape(-1, 2)
        return self.server.data(
            rec, cell=self.cell, config=self.config, seconds=seconds,
            setup_s=setup_s, sent=np.asarray(rec.sent, dtype=np.float64),
            done=np.asarray(rec.done, dtype=np.float64),
            status=np.asarray(rec.status), emitted_t=emitted[:, 0],
            emitted_units=emitted[:, 1].astype(np.int64),
            traced=profiled["slice"] if profiled else None,
            events=profiled["events"] if profiled else [])

    def release(self) -> None:
        """Free the program's state."""
        self.server.release()
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, rec: Recorder, data: RunData, *,
              control: bool = False) -> Dict[str, float]:
        rng = np.random.default_rng([self.seed, 3])
        with self.torch.no_grad():
            out = self.server.check(rec, data, rng, control=control)
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
        bench.server.profiler_warmup()

    async def main():
        await bench.server.warm()
        setup_s = time.perf_counter() - started
        rec, profiled = await bench.window(seconds, trace=trace)
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
