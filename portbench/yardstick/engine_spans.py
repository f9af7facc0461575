"""The engine's spans (``serve.engine``: ``engine.submit``,
``engine.step`` and their children) on the device trace's clock, and the
share of the device's idle time they name.

As ``spans.py`` does for the gateway's dispatches, the spans are moved
onto the trace's own clock, anchored at a copy the host waits for at
the end of a span.  A decode step reads its sampled tokens back,
(max_batch,) int64 values, inside its ``engine.sample`` span, which
ends as ``.tolist()`` returns, and a prefill its first token, one int64
value, inside the ``engine.sample`` span under its ``engine.submit``:
on one clock that device-to-host copy ends just before the span does
(an H100 host: within about 20 µs; the start of a span lies up to 300
µs after the copy before it, the host's work and the interpreter's lock
between them).  So a slice that holds only a wave's prefills is
anchored too.  The result is checked at the uploads the host waits
for: a step's tokens and positions, (2, max_batch) int64 values,
between the ``engine.step`` span's start and its ``engine.decode``
span's, and a prefill's prompt within ``PREFILL_UPLOAD_US`` of its
``engine.prefill`` span's start: on one clock each host-to-device copy
ends there.  Copies are told apart by their sizes and directions.  A
port without the engine's spans gives no reading.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import List, Optional, Sequence, Tuple

from portbench.yardstick import spans as sp

PREFIX = "engine."
#: how long (µs) after its ``engine.prefill`` span starts a prefill's
#: prompt upload may end: the prompt made a tensor on the host and
#: copied (a few hundred µs), with room for two of the interpreter's
#: 5 ms switches to another thread; a tenth of a prefill of the cell's
#: shortest prompts (100 ms and more), so a span put on a neighbour's
#: prefill fails the guard
PREFILL_UPLOAD_US = 10_000.0


def slice_us(run, items) -> Optional[Tuple[float, float]]:
    """The traced slice, from the first to the last device event."""
    if not items or not run.events:
        return None
    return run.events[0].ts, max(e.end for e in run.events)


def _copies(run, direction: str, nbytes: int) -> list:
    return [e for e in run.events if e.cat == "gpu_memcpy"
            and direction in e.name and int(e.args.get("bytes", 0)) == nbytes]


def _step_children(items, name: str, parent: str = "engine.step"
                   ) -> List[sp.Span]:
    """The ``name`` spans of decode steps (or of another ``parent``),
    in order."""
    steps = {s.id for s in items if s.name == parent}
    return sorted((s for s in items if s.name == name and s.parent in steps),
                  key=lambda s: s.ts)


def _readbacks(run) -> list:
    """The sampled tokens' device-to-host copies: a step's (max_batch,)
    int64 values and a prefill's one."""
    sizes = {8, 8 * run.cell["engine"]["max_batch"]}
    return [e for e in run.events if e.cat == "gpu_memcpy"
            and "DtoH" in e.name and int(e.args.get("bytes", 0)) in sizes]


def _first_shift(samples: List[sp.Span], copies: list) -> float:
    """The shift of the first anchor: of the read-backs within
    ``spans.MAX_SHIFT_US`` of the first sample's end, the one that puts
    the most samples' ends within ``spans.COPY_SLACK_US`` of a
    read-back's (a step of about 46 ms is shorter than twice the
    recorded clock's error, so the nearest read-back may be a
    neighbour's)."""
    ends = sorted(e.end for e in copies)

    def matched(shift: float) -> int:
        n = 0
        for s in samples:
            k = bisect_left(ends, s.end + shift - sp.COPY_SLACK_US)
            n += k < len(ends) and ends[k] <= s.end + shift + sp.COPY_SLACK_US
        return n
    t = samples[0].end
    near = [e - t for e in ends if abs(e - t) <= sp.MAX_SHIFT_US]
    return max(near, key=lambda d: (matched(d), -abs(d))) if near else 0.0


def clock_anchors(run, items) -> List[Tuple[float, float]]:
    """(an ``engine.sample`` end, the shift that ends its read-back
    there) for each decode step and prefill around the slice, the first
    by ``_first_shift``, each next taking the copy nearest to where the
    last one puts it."""
    sl = slice_us(run, items)
    if sl is None:
        return []
    copies = sorted(_readbacks(run), key=lambda e: e.ts)
    starts = [e.ts for e in copies]
    sampled = _step_children(items, "engine.sample") + _step_children(
        items, "engine.sample", "engine.submit")
    samples = [s for s in sorted(sampled, key=lambda s: s.ts)
               if sl[0] - sp.MAX_SHIFT_US <= s.ts
               and s.end <= sl[1] + sp.MAX_SHIFT_US]
    if not samples:
        return []
    out, shift = [], _first_shift(samples, copies)
    for s in samples:
        e = sp._nearest(copies, starts, s.end + shift)
        if e is not None:
            shift = e.end - s.end
            out.append((s.end, shift))
    return out


def on_device_clock(run, items) -> List[sp.Span]:
    """The spans moved onto the trace's clock between the anchors (as
    ``spans.on_device_clock`` moves them); without anchors, as
    recorded."""
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

    return [sp.Span(s.name, moved(s.ts), moved(s.end), s.thread, s.id,
                    s.parent, s.request, s.dispatch, s.arg) for s in items]


def upload_share(run, items, between: Tuple[float, float]
                 ) -> Optional[float]:
    """Share of the steps and prefills that start ``between`` two times
    (the first and the last anchor: one before the first is placed by
    the anchors' line, not between two) whose upload ends where the host
    waits for it (within ``spans.COPY_SLACK_US``): a step's (2,
    max_batch) values between its start and its ``engine.decode`` span's
    start; a prefill's prompt (any other host-to-device copy) within
    ``PREFILL_UPLOAD_US`` of its ``engine.prefill`` span's start."""
    steps = {s.id: s for s in items if s.name == "engine.step"}
    size = 16 * run.cell["engine"]["max_batch"]
    windows = [(steps[d.parent].ts, d.ts)
               for d in _step_children(items, "engine.decode")
               if between[0] <= steps[d.parent].ts and d.end <= between[1]]
    step_ends = sorted(e.end for e in _copies(run, "HtoD", size))
    prefills = [(p.ts, p.ts + PREFILL_UPLOAD_US) for p in items
                if p.name == "engine.prefill"
                and between[0] <= p.ts and p.end <= between[1]]
    prompt_ends = sorted(e.end for e in run.events
                         if e.cat == "gpu_memcpy" and "HtoD" in e.name
                         and int(e.args.get("bytes", 0)) != size)
    hit = 0
    for ends, spans_ in ((step_ends, windows), (prompt_ends, prefills)):
        for lo, hi in spans_:
            k = bisect_left(ends, lo - sp.COPY_SLACK_US)
            hit += k < len(ends) and ends[k] <= hi + sp.COPY_SLACK_US
    n = len(windows) + len(prefills)
    return hit / n if n else None


def guarded(run, items: Optional[Sequence[sp.Span]]
            ) -> Optional[List[sp.Span]]:
    """The engine's spans on the trace's clock if at least
    ``spans.COPY_GUARD`` of the steps and prefills between the anchors
    then hold their uploads where the host waits for them; else
    None."""
    if not items:
        return None
    mine = [s for s in items if s.name.startswith(PREFIX)]
    anchors = clock_anchors(run, mine)
    if len(anchors) < 2:
        return None
    moved = on_device_clock(run, mine)
    share = upload_share(run, moved, (anchors[0][0] + anchors[0][1],
                                      anchors[-1][0] + anchors[-1][1]))
    if share is None or share < sp.COPY_GUARD:
        return None
    return moved


def idle_named_share_pct(run, items) -> Optional[float]:
    """Share of the slice's device idle time inside some ``engine.*``
    span, in %, on the trace's clock; None when the spans fail the
    guard there."""
    moved = guarded(run, items)
    if moved is None:
        return None
    sl = slice_us(run, moved)
    idle = sp.idle_intervals(run, sl)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    named = sp._union((s.ts, s.end) for s in moved)
    covered = 0.0
    for a, b in idle:
        covered += sum(sp._overlap(x, y, (a, b)) for x, y in named
                       if x < b and y > a)
    return 100.0 * covered / total
