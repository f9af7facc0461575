"""Spans of the serving path, recorded while ``torch.profiler`` records.

A span is one named stretch of a thread's time: its start and end on
``time.perf_counter_ns``, the recording thread, its own id, its
parent's id (0 for none), and the ids of the request and the dispatch
it belongs to (-1 for none).  A dispatch's id is the id of its
``gateway.dispatch`` span.  The spans of one ``AsyncCNNGateway``
dispatch::

    gateway.dispatch            the batch's pop to the end of finish
      gateway.to_task           the pop to the dispatch's task starting
      gateway.stack             stacking the payloads on the host
      gateway.hop_in            the hop into the worker thread
      runtime.forward           (worker thread) ``compiled(...)`` and
        runtime.copy_in           the copy to the device
        runtime.layers            the layer loop (``moe.experts`` inside)
        gateway.copy_out          ``.cpu()``: waits for the device and
                                  copies the answers back
      gateway.hop_back          the hop back to the event loop
      gateway.finish            resolving the requests' futures

and, per request, ``gateway.submit`` (``submit_nowait``'s own work) and
``gateway.queue`` (admission to the pop of the request's batch); the
process adds ``process.gc`` (one garbage collection, its generation in
``arg``).  ``AsyncCNNGateway``'s ``DispatchStages`` are differences of
the same stamps.

**When.** A site records only while a ``torch.profiler`` session
records (``torch.autograd.profiler._is_profiler_enabled``); otherwise it
costs that check (and, around a stretch of code, a shared null
context).  A span around a stretch of code on one thread
(``span``, ``stamped``) also opens a ``record_function`` range of its
name, so an operator who profiles the server with CPU and CUDA activity
sees the spans on the host lanes and ``moe.experts`` over its kernels.
Spans put together from stamps after the fact (``SpanRecorder.add``:
the queue wait, the hops, GC) go to the ring only.

**Where.** ``RECORDER``, one ring of ``CAPACITY`` spans for the
process, safe to append from any thread; past its bound it drops the
oldest and counts them (``dropped``).  ``snapshot()`` copies it out.

**Clock.** ``unix_offset_ns``, taken at the first span, puts a stamp
on Unix time; a ``torch.profiler`` chrome trace stamps its events in
Unix microseconds less its ``baseTimeNanoseconds``, so a span lands on
the device trace's timeline at
``(start + unix_offset_ns - baseTimeNanoseconds) / 1000``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

__all__ = ["Span", "SpanRecorder", "RECORDER", "CAPACITY", "on", "span",
           "stamped"]

#: spans the ring holds
CAPACITY = 65_536


class Span(NamedTuple):
    """One recorded span; stamps in ns on ``time.perf_counter_ns``."""
    name: str
    start: int
    end: int
    thread: int
    id: int
    parent: int = 0
    request: int = -1
    dispatch: int = -1
    arg: int = -1


def on() -> bool:
    """True while a ``torch.profiler`` session records."""
    return _profiler._is_profiler_enabled


class SpanRecorder:
    """A bounded ring of spans, one clock offset to Unix time, and the
    per-thread stack of open spans that nested spans take their parent
    and dispatch from."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.dropped = 0
        self.unix_offset_ns: Optional[int] = None
        self._ring: deque = deque(maxlen=capacity)
        # re-entrant: a garbage collection started by this thread may
        # record its span from inside ``add``
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._gc_start: Optional[int] = None

    def new_id(self) -> int:
        return next(self._ids)

    def add(self, name: str, start: int, end: int, *, span_id: int = 0,
            parent: int = 0, request: int = -1, dispatch: int = -1,
            thread: Optional[int] = None, arg: int = -1) -> int:
        """Record one span from its stamps; returns its id."""
        if self.unix_offset_ns is None:
            self._first()
        span_id = span_id or next(self._ids)
        # a plain tuple (a ``Span``'s fields): ``snapshot`` names them
        item = (name, start, end,
                threading.get_ident() if thread is None else thread,
                span_id, parent, request, dispatch, arg)
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(item)
        return span_id

    def _first(self) -> None:
        """Take the clock offset and hook garbage collection, once."""
        with self._lock:
            if self.unix_offset_ns is None:
                self.unix_offset_ns = time.time_ns() - time.perf_counter_ns()
                gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if not on():
            self._gc_start = None
        elif phase == "start":
            self._gc_start = time.perf_counter_ns()
        elif self._gc_start is not None:
            start, self._gc_start = self._gc_start, None
            self.add("process.gc", start, time.perf_counter_ns(),
                     arg=info.get("generation", -1))

    def snapshot(self) -> List[Span]:
        """The spans the ring holds, oldest first."""
        enabled = gc.isenabled()
        gc.disable()                   # no GC span lands mid-copy
        try:
            with self._lock:
                items = list(self._ring)
        finally:
            if enabled:
                gc.enable()
        return [Span._make(t) for t in items]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


RECORDER = SpanRecorder()


class _Stamps:
    """A stretch of code timed on the span clock and not recorded."""
    __slots__ = ("start", "end")

    def __init__(self, start: Optional[int] = None):
        self.start = start
        self.end = 0

    def __enter__(self) -> "_Stamps":
        if self.start is None:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        return False


class _Span(_Stamps):
    """A stretch of code recorded as a span, inside a ``record_function``
    range of its name; the open span is its thread's current one."""
    __slots__ = ("name", "id", "parent", "request", "dispatch", "_range")

    def __init__(self, name: str, start: Optional[int], span_id: int,
                 parent: Optional[int], request: int,
                 dispatch: Optional[int]):
        super().__init__(start)
        self.name, self.id, self.parent = name, span_id, parent
        self.request, self.dispatch = request, dispatch
        self._range = _profiler.record_function(name)

    def __enter__(self) -> "_Span":
        stack = RECORDER._stack()
        top = stack[-1] if stack else None
        if self.parent is None:
            self.parent = top.id if top is not None else 0
        if self.dispatch is None:
            self.dispatch = top.dispatch if top is not None else -1
        self.id = self.id or RECORDER.new_id()
        stack.append(self)
        self._range.__enter__()
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        self._range.__exit__(*exc)
        RECORDER._stack().pop()
        RECORDER.add(self.name, self.start, self.end, span_id=self.id,
                     parent=self.parent, request=self.request,
                     dispatch=self.dispatch)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, *, request: int = -1, dispatch: Optional[int] = None,
         parent: Optional[int] = None, span_id: int = 0):
    """A span around a stretch of code on this thread, recorded while a
    profiler records; ``parent`` and ``dispatch`` default to the
    thread's open span's.  Off, a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, None, span_id, parent, request, dispatch)


def stamped(name: str, record: bool, *, start: Optional[int] = None,
            request: int = -1, dispatch: Optional[int] = None,
            parent: Optional[int] = None, span_id: int = 0):
    """Like ``span``, for a site that reads the stretch's stamps
    (``.start``, from ``start`` if given, and ``.end``) either way:
    recorded when ``record``."""
    if not record:
        return _Stamps(start)
    return _Span(name, start, span_id, parent, request, dispatch)
