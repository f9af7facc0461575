"""The server of the kinds that serve a language model: the port's
``serve.engine.Engine`` over the model the kind builds from the seed.

A request is one prompt of the kind's pool; its answer is the tokens the
engine decoded for it.  Submitted requests wait in the server's queue,
in order, until ``Engine.submit`` admits the one at its head: nothing is
shed.  One loop admits and steps the engine in a worker thread, so the
event loop that runs the clients' callbacks never blocks on the device.
Every token is emitted as a unit when it is produced: a prefill's first
token when the prefill returns, a decode step's tokens, one a live slot,
when the step ends (its sampled tokens read back).  A request is done at
its last token.

For the requests that the cell's check keeps, the server keeps the
logits rows that the program's own ``prefill`` and ``decode_step``
returned for them, copied to the host: the engine sees the model
through ``Tap``, which holds each call's logits until the loop takes
them.

The cell's ``"engine"`` block: ``max_batch``, ``max_len``,
``max_new_tokens``.  The kind's ``System`` gives ``pool`` (prompts, each
a sequence of token ids), ``model_and_params()`` (the port's model
object and its parameters, on the device, built anew for the server),
``ops_per_unit`` (the yardstick's operations of one emitted token) and
``check(answers, rng, check, control=False)``, which judges ``Answer``s
by request index under the cell's ``"check"`` block.
"""

from __future__ import annotations

import asyncio
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import harness


@dataclass
class Answer:
    """What the engine served for one request: ``prompt`` is its index
    in the kind's pool, ``tokens`` what it decoded, and ``logits`` (kept
    requests only) the program's row for each of those tokens, (tokens,
    vocabulary) on the host: row k is what token k was sampled from."""
    prompt: int
    tokens: List[int]
    logits: Optional[torch.Tensor] = None


class Tap:
    """The program's model as the engine sees it: every call passes
    through, and the logits of the last ``prefill`` or ``decode_step``
    stay in ``last``."""

    def __init__(self, model):
        self.model = model
        self.last: Optional[torch.Tensor] = None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, batch):
        logits, cache = self.model.prefill(params, batch)
        self.last = logits
        return logits, cache

    def decode_step(self, params, cache, token, pos):
        logits, cache = self.model.decode_step(params, cache, token, pos)
        self.last = logits
        return logits, cache


class Recorder(harness.Recorder):
    """Hands prompts to the server's queue; a request is done at its
    last token's stamp."""

    def __init__(self, server: "Server", order: np.ndarray,
                 keep: Callable[[int], bool]):
        super().__init__(server.system.pool, order, keep)
        self.server = server
        self.last_token: Dict[int, float] = {}

    def hand_over(self, i: int):
        return self.server.enqueue(i, self.payload_index(i))

    def _finished(self, i: int, fut) -> None:
        super()._finished(i, fut)
        if i in self.last_token:
            self.done[i] = self.last_token.pop(i)


@dataclass(kw_only=True)
class RunData(harness.RunData):
    """An engine run: beside the common record, each decode step as
    (start, end, live slots) and each prefill as (start, end, prompt
    length), on the recorder's clock."""
    steps: np.ndarray
    prefills: np.ndarray


class Server:
    """``Engine`` over the kind's model, every prompt length of the pool
    prefilled and the pool decoded once in the worker thread before the
    window."""

    def __init__(self, system, cell, seed: int, device, config_dir):
        from repro_torch.serve.engine import Engine, ServeConfig
        self.system, self.cell, self.device = system, cell, device
        ecfg = cell["engine"]
        model, params = system.model_and_params()
        self.params = params
        self.tap = Tap(model)
        self.engine = Engine(self.tap, params, ServeConfig(
            max_batch=ecfg["max_batch"], max_len=ecfg["max_len"],
            max_new_tokens=ecfg["max_new_tokens"]))
        self.executor = ThreadPoolExecutor(
            1, thread_name_prefix="portbench-engine")
        #: (request index, ``Request``) in submission order
        self.queue: deque = deque()
        #: request index → (prompt index, future of its ``Answer``)
        self.owed: Dict[int, Tuple[int, asyncio.Future]] = {}
        self.rows: Dict[int, List[torch.Tensor]] = {}
        self.steps: List[Tuple[float, float, int]] = []
        self.prefills: List[Tuple[float, float, int]] = []
        self.error: Optional[BaseException] = None
        self._task: Optional[asyncio.Task] = None
        self._closing = False
        self._wake: Optional[asyncio.Event] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _request(self, i: int, prompt: int):
        from repro_torch.serve.engine import Request
        return Request(prompt=[int(t) for t in self.system.pool[prompt]],
                       request_id=i)

    def _warm_shapes(self) -> None:
        """One prefill at every prompt length of the pool, each followed
        by one decode step of the whole pool, the slot freed after."""
        lengths = {}
        for k, prompt in enumerate(self.system.pool):
            lengths.setdefault(len(prompt), k)
        with torch.no_grad():
            for k in lengths.values():
                if not self.engine.submit(self._request(-1, k)):
                    raise RuntimeError("the engine refused a warm-up "
                                       "request into an empty pool")
                self.engine.step()
                for slot, _ in self.engine.live():
                    self.engine.release(slot)
        self._sync()

    async def warm(self) -> None:
        """Every shape, in the worker thread that serves the window (the
        thread's own library handles are made there)."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self.executor, self._warm_shapes)

    def profiler_warmup(self) -> None:
        """One profiled prefill, so that the profiler's own start-up
        (CUPTI) is set-up and not part of the traced slice."""
        from torch.profiler import ProfilerActivity, profile
        prompt = min(self.system.pool, key=len)
        batch = {"tokens": torch.tensor([[int(t) for t in prompt]],
                                        dtype=torch.int64,
                                        device=self.device)}
        with profile(activities=[ProfilerActivity.CUDA]), torch.no_grad():
            self.tap.model.prefill(self.params, batch)
            self._sync()

    def recorder(self, order: np.ndarray,
                 keep: Callable[[int], bool]) -> Recorder:
        """The window's recorder, and the serving loop started on the
        running event loop."""
        rec = Recorder(self, order, keep)
        self._wake = asyncio.Event()
        self._task = asyncio.ensure_future(self._serve(rec))
        return rec

    def enqueue(self, i: int, prompt: int) -> asyncio.Future:
        """Request ``i`` queued for admission; the future of its
        ``Answer``."""
        fut = asyncio.get_running_loop().create_future()
        if self.error is not None:
            fut.set_exception(self.error)
            return fut
        req = self._request(i, prompt)
        self.owed[i] = (prompt, fut)
        self.queue.append((i, req))
        self._wake.set()
        return fut

    def _tick(self, rec: Recorder) -> List[Tuple[int, Answer, float]]:
        """In the worker thread: admit from the queue's head while the
        engine takes it, then one decode step.  Returns the requests that
        finished, with their answers and last token's stamp."""
        eng, tap = self.engine, self.tap
        finished = []
        with torch.no_grad():
            while self.queue:
                i, req = self.queue[0]
                t0 = rec.now()
                if not eng.submit(req):
                    break
                self.queue.popleft()
                t = rec.now()
                rec.emit(1, t)
                self.prefills.append((t0, t, len(req.prompt)))
                if rec.keep(i):
                    self.rows[i] = [tap.last[0].cpu()]
            live = eng.live()
            if not live:
                return finished
            t0 = rec.now()
            eng.step()
            t = rec.now()
            rec.emit(len(live), t)
            self.steps.append((t0, t, len(live)))
            kept = [(slot, r.request_id) for slot, r in live
                    if r.request_id in self.rows]
            if kept:
                got = tap.last[[slot for slot, _ in kept]].cpu()
                for k, (_, i) in enumerate(kept):
                    self.rows[i].append(got[k])
            for _, r in live:
                if r.done:
                    i = r.request_id
                    rows = self.rows.pop(i, None)
                    finished.append((i, Answer(
                        self.owed[i][0], list(r.out_tokens),
                        torch.stack(rows) if rows else None), t))
        return finished

    async def _serve(self, rec: Recorder) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if not self.queue and not self.engine.live():
                if self._closing:
                    return
                self._wake.clear()
                await self._wake.wait()
                continue
            try:
                finished = await loop.run_in_executor(self.executor,
                                                      self._tick, rec)
            except Exception as exc:   # the program failed: fail what is owed
                self.error = exc
                self.queue.clear()
                for _, fut in self.owed.values():
                    fut.set_exception(exc)
                self.owed.clear()
                return
            for i, answer, t in finished:
                rec.last_token[i] = t
                self.owed.pop(i)[1].set_result(answer)
            # let the answered clients' next requests join the queue
            await asyncio.sleep(0)

    async def close(self, rec: Recorder) -> None:
        """Stop the serving loop once the queue and the pool are empty,
        and raise what failed the program, if anything did."""
        self._closing = True
        self._wake.set()
        try:
            await self._task
        finally:
            self.executor.shutdown(wait=True)
        if self.error is not None:
            raise self.error

    def data(self, rec: Recorder, **common) -> RunData:
        return RunData(
            **common, ops_per_unit=self.system.ops_per_unit,
            steps=np.asarray(self.steps, dtype=np.float64).reshape(-1, 3),
            prefills=np.asarray(self.prefills,
                                dtype=np.float64).reshape(-1, 3))

    def release(self) -> None:
        """Free the engine, its cache, the model and its parameters."""
        self.engine = self.tap = self.params = None

    def check(self, rec: Recorder, data: RunData, rng: np.random.Generator,
              *, control: bool = False):
        return self.system.check(rec.answers, rng, self.cell["check"],
                                 control=control)
