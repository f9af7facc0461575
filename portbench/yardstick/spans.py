"""The port's spans on the device trace's clock, and what the span
metrics read from them.

The port records spans (``repro_torch.ops.spans``) while
``torch.profiler`` records: in a traced run, those of the traced slice
and of the harness's profiled warm-up.  Each is stamped on
``time.perf_counter_ns``; the recorder keeps one offset from that clock
to Unix time.  A chrome trace stamps its events in Unix microseconds
less its ``baseTimeNanoseconds``, which is the same for every profiler
session of a process, so ``recorded()`` moves each span onto the
timeline of ``RunData.events``.

The slice runs from the first to the last device event of the run; a
run without device events has for slice the stretch its gateway spans
cover.  Readings that set spans against device events move the spans
onto the trace's own clock first (``on_device_clock``), anchored at
each dispatch's input copy, and check the result on its answer copy
(``guarded``): on an H100 host the trace's device clock was seen to
drift against the host's by up to 7 ms a second within one slice, in
about half the traced runs.  Durations and gaps are read on the
host's clock, as recorded.  Dispatch spans carry their dispatch's id; the warm-up's spans,
from a bare call of the compiled model, carry none and are not read.
A port without the recorder gives no spans, and every reading is None.
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
from bisect import bisect_left
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: how far (µs) an answer copy may lie outside its ``gateway.copy_out``
#: span and still count as inside it
COPY_SLACK_US = 100.0
#: the share of the slice's dispatches whose answer copy must lie inside
#: their ``gateway.copy_out`` span for the clocks to count as one
COPY_GUARD = 0.9
#: how far (µs) the device trace's clock may move against the spans'
#: from one anchor to the next (and from the nominal conversion to the
#: first): well under half of the MoE cell's 75 ms dispatch, so that no
#: span meets a neighbour's copy
MAX_SHIFT_US = 30_000.0
#: spans of waiting, not of work: no part of the host's time is named by
#: them
WAITS = ("gateway.queue",)


@dataclass(frozen=True)
class Span:
    """One program span, in microseconds on the trace's clock."""
    name: str
    ts: float
    end: float
    thread: int
    id: int
    parent: int = 0
    request: int = -1
    dispatch: int = -1
    arg: int = -1

    @property
    def dur(self) -> float:
        return self.end - self.ts


@functools.cache
def trace_base_ns() -> int:
    """The ``baseTimeNanoseconds`` of this process's profiler traces,
    read from the export of an empty session."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    with prof:
        pass
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return int(json.load(f).get("baseTimeNanoseconds", 0))
    finally:
        os.remove(path)


def recorded() -> Optional[List[Span]]:
    """The port's recorded spans on the trace's clock, oldest first, or
    None when the port has no recorder or it holds no span."""
    try:
        from repro_torch.ops import spans as port
    except ImportError:
        return None
    items = port.RECORDER.snapshot()
    offset = port.RECORDER.unix_offset_ns
    if not items or offset is None:
        return None
    shift = offset - trace_base_ns()
    return [Span(s.name, (s.start + shift) / 1e3, (s.end + shift) / 1e3,
                 s.thread, s.id, s.parent, s.request, s.dispatch, s.arg)
            for s in items]


def slice_us(run, items: Optional[Sequence[Span]]
             ) -> Optional[Tuple[float, float]]:
    if not items:
        return None
    if run.events:
        return run.events[0].ts, max(e.end for e in run.events)
    gateway = [s for s in items if s.name.startswith("gateway.")]
    if not gateway:
        return None
    return min(s.ts for s in gateway), max(s.end for s in gateway)


def _inside(s: Span, sl: Tuple[float, float]) -> bool:
    return sl[0] <= s.ts and s.end <= sl[1]


def _median_ms(values: List[float]) -> Optional[float]:
    return float(np.median(values)) / 1e3 if values else None


def queue_wait_ms(run, items) -> Optional[float]:
    """Median ``gateway.queue`` over the requests popped in the slice."""
    sl = slice_us(run, items)
    if sl is None:
        return None
    return _median_ms([s.dur for s in items if s.name == "gateway.queue"
                       and sl[0] <= s.end <= sl[1]])


def dispatch_spans(run, items) -> List[Span]:
    """The ``gateway.dispatch`` spans that lie in the slice, in order."""
    sl = slice_us(run, items)
    if sl is None:
        return []
    return sorted((s for s in items
                   if s.name == "gateway.dispatch" and _inside(s, sl)),
                  key=lambda s: s.ts)


def loop_gap_ms(run, items) -> Optional[float]:
    """Median time from one dispatch's end to the next one's pop, over
    consecutive dispatches in the slice: the loop outside every stage."""
    ds = dispatch_spans(run, items)
    return _median_ms([b.ts - a.end for a, b in zip(ds, ds[1:])])


def copy_in_ms(run, items) -> Optional[float]:
    """Median ``runtime.copy_in`` of the dispatches in the slice."""
    sl = slice_us(run, items)
    if sl is None:
        return None
    return _median_ms([s.dur for s in items if s.name == "runtime.copy_in"
                       and s.dispatch > 0 and _inside(s, sl)])


def _overlap(a0: float, a1: float, sl: Tuple[float, float]) -> float:
    return max(0.0, min(a1, sl[1]) - max(a0, sl[0]))


def gc_pause_share_pct(run, items) -> Optional[float]:
    """Σ ``process.gc`` within the slice over the slice, in %."""
    sl = slice_us(run, items)
    if sl is None or sl[1] <= sl[0]:
        return None
    paused = sum(_overlap(s.ts, s.end, sl) for s in items
                 if s.name == "process.gc")
    return 100.0 * paused / (sl[1] - sl[0])


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def idle_intervals(run, sl: Tuple[float, float]
                   ) -> List[Tuple[float, float]]:
    """The stretches of the slice in which no device operation ran."""
    out, cur = [], sl[0]
    for a, b in _union((e.ts, e.end) for e in run.events):
        if a > cur:
            out.append((cur, min(a, sl[1])))
        cur = max(cur, b)
    if cur < sl[1]:
        out.append((cur, sl[1]))
    return [(a, b) for a, b in out if b > a]


def _nearest(events: list, starts: List[float], t: float):
    """Of ``events`` (in start order, ``starts`` theirs), the one whose
    end is nearest to ``t`` within ``MAX_SHIFT_US``, or None."""
    best = None
    k = bisect_left(starts, t - 2 * MAX_SHIFT_US)
    while k < len(events) and events[k].ts <= t + MAX_SHIFT_US:
        e = events[k]
        if abs(e.end - t) <= MAX_SHIFT_US \
                and (best is None or abs(e.end - t) < abs(best.end - t)):
            best = e
        k += 1
    return best


def clock_anchors(run, items) -> List[Tuple[float, float]]:
    """Where the spans' clock meets the device trace's: for each
    dispatch's ``runtime.copy_in`` span around the slice, (the span's
    end, the shift that ends its host-to-device copy there).  The host
    waits in ``x.to(device)`` until a pageable copy has ended: on one
    clock the copy ends 20-35 µs before the span does (an H100 host).
    Each anchor takes the copy nearest to where the last one puts it,
    so the anchors follow a drift of the trace's clock."""
    sl = slice_us(run, items)
    if sl is None or not run.events:
        return []
    copies = [e for e in run.events if e.is_htod]
    starts = [e.ts for e in copies]
    ins = sorted((s for s in items if s.name == "runtime.copy_in"
                  and s.dispatch > 0 and sl[0] - MAX_SHIFT_US <= s.ts
                  and s.end <= sl[1] + MAX_SHIFT_US), key=lambda s: s.ts)
    out, shift = [], 0.0
    for s in ins:
        e = _nearest(copies, starts, s.end + shift)
        if e is not None:
            shift = e.end - s.end
            out.append((s.end, shift))
    return out


def on_device_clock(run, items) -> List[Span]:
    """The spans moved onto the device trace's clock: each end by the
    shift the anchors give there, in proportion between the two nearest
    (beyond the first or the last, along the line of the two there).
    Without anchors, the spans as ``recorded()`` converted them."""
    anchors = clock_anchors(run, items)
    if not anchors:
        return list(items)
    at = [a for a, _ in anchors]

    def moved(t: float) -> float:
        if len(anchors) == 1:
            return t + anchors[0][1]
        k = min(max(bisect_left(at, t), 1), len(at) - 1)
        (a0, d0), (a1, d1) = anchors[k - 1], anchors[k]
        return t + d0 + (d1 - d0) * (t - a0) / (a1 - a0)

    return [Span(s.name, moved(s.ts), moved(s.end), s.thread, s.id,
                 s.parent, s.request, s.dispatch, s.arg) for s in items]


def copy_out_spans(run, items) -> List[Span]:
    """The slice's dispatches' ``gateway.copy_out`` spans."""
    sl = slice_us(run, items)
    if sl is None or not run.events:
        return []
    return [s for s in items if s.name == "gateway.copy_out"
            and s.dispatch > 0 and _inside(s, sl)]


def answer_copies(run) -> list:
    return [e for e in run.events
            if e.cat == "gpu_memcpy" and "DtoH" in e.name]


def copy_out_share(run, items) -> Optional[float]:
    """Share of the slice's dispatches whose answers' device-to-host
    copy lies inside their ``gateway.copy_out`` span (within
    ``COPY_SLACK_US``).  The host waits in ``.cpu()`` until that copy
    ends, so on one clock the copy lies inside the span."""
    outs = copy_out_spans(run, items)
    if not outs:
        return None
    copies = answer_copies(run)
    starts = [e.ts for e in copies]
    hit = 0
    for s in outs:
        lo, hi = s.ts - COPY_SLACK_US, s.end + COPY_SLACK_US
        k = bisect_left(starts, lo)
        while k < len(copies) and copies[k].ts <= hi:
            if copies[k].end <= hi:
                hit += 1
                break
            k += 1
    return hit / len(outs)


def forward_kernel_share(run, items) -> Optional[float]:
    """Share of the slice's dispatches whose ``runtime.forward`` span
    holds the start of some kernel of the trace."""
    sl = slice_us(run, items)
    if sl is None or not run.events:
        return None
    fwds = [s for s in items if s.name == "runtime.forward"
            and s.dispatch > 0 and _inside(s, sl)]
    if not fwds:
        return None
    starts = [e.ts for e in run.events if e.cat == "kernel"]
    held = sum(1 for s in fwds
               if bisect_left(starts, s.ts) < len(starts)
               and starts[bisect_left(starts, s.ts)] <= s.end)
    return held / len(fwds)


def guarded(run, items) -> Optional[List[Span]]:
    """The spans on the device trace's clock (``on_device_clock``) if
    they pass the guard there: ``COPY_GUARD`` of the slice's dispatches
    hold their answer copy in their ``copy_out`` span, and as many their
    kernels in their forward.  The anchors are the input copies, the
    guard the output copies, so a clock the anchors do not fix gives no
    reading; nor does a trace that lost its kernels (seen on an H100
    host: about 40 events in a 2 s slice, the copies alone, where a
    sound one holds about 50,000)."""
    if not items:
        return None
    moved = on_device_clock(run, items)
    shares = (copy_out_share(run, moved), forward_kernel_share(run, moved))
    if any(x is None or x < COPY_GUARD for x in shares):
        return None
    return moved


def idle_named_share_pct(run, items) -> Optional[float]:
    """Share of the slice's device idle time that lies inside some
    program span other than a wait, in %, on the device trace's clock;
    None when the spans fail the guard there."""
    moved = guarded(run, items)
    if moved is None:
        return None
    sl = slice_us(run, moved)
    idle = idle_intervals(run, sl)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    named = _union((s.ts, s.end) for s in moved if s.name not in WAITS)
    covered, k = 0.0, 0
    for a, b in idle:
        while k < len(named) and named[k][1] <= a:
            k += 1
        j = k
        while j < len(named) and named[j][0] < b:
            covered += _overlap(named[j][0], named[j][1], (a, b))
            j += 1
    return 100.0 * covered / total


def idle_by_span(run, items) -> Optional[Dict[str, float]]:
    """The slice's device idle time in µs, split by the innermost span
    (the latest started of those open, the shorter of two that start
    together; waits left out) at each instant; ``"(none)"`` holds what
    no span covers, on the device trace's clock; None when the spans
    fail the guard there."""
    moved = guarded(run, items)
    if moved is None:
        return None
    sl = slice_us(run, moved)
    work = sorted((s for s in moved if s.name not in WAITS
                   and s.end > sl[0] and s.ts < sl[1]), key=lambda s: s.ts)
    cuts = sorted({sl[0], sl[1]} | {s.ts for s in work}
                  | {s.end for s in work})
    idle = idle_intervals(run, sl)
    out: Dict[str, float] = {}
    active: List[Span] = []
    p = q = 0
    for a, b in zip(cuts, cuts[1:]):
        while p < len(work) and work[p].ts <= a:
            active.append(work[p])
            p += 1
        active = [s for s in active if s.end >= b]
        while q < len(idle) and idle[q][1] <= a:
            q += 1
        spent, j = 0.0, q
        while j < len(idle) and idle[j][0] < b:
            spent += _overlap(idle[j][0], idle[j][1], (a, b))
            j += 1
        if spent > 0:
            name = max(active, key=lambda s: (s.ts, -s.end)).name \
                if active else "(none)"
            out[name] = out.get(name, 0.0) + spent
    return out
