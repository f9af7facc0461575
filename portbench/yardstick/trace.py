"""Reduction of a ``torch.profiler`` chrome trace to the device's events.

The profiler records every kernel, copy and fill the card ran while it
was on (CUPTI tracing covers every host thread).  ``device_events`` keeps
those, ``busy_s`` takes the union of their intervals, ``dispatches`` cuts
the timeline at each host-to-device copy of request payloads, and
``breakdown`` names the device operations that took most time and the
longest gaps between operations.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass(frozen=True)
class DeviceEvent:
    """One device operation: its category, name, start and duration in
    microseconds on the profiler's clock, and the profiler's arguments
    (``bytes`` of a copy, ``grid`` of a kernel)."""
    cat: str
    name: str
    ts: float
    dur: float
    args: Dict

    @property
    def end(self) -> float:
        return self.ts + self.dur

    @property
    def is_htod(self) -> bool:
        return self.cat == "gpu_memcpy" and "HtoD" in self.name


def device_events(trace_path: str) -> List[DeviceEvent]:
    """The device operations of an exported chrome trace, in start
    order."""
    with open(trace_path) as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    out = [DeviceEvent(e["cat"], e.get("name", ""), float(e["ts"]),
                       float(e.get("dur", 0.0)), e.get("args", {}) or {})
           for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    out.sort(key=lambda e: e.ts)
    return out


def busy_s(events: List[DeviceEvent]) -> float:
    """Seconds in which at least one device operation ran: the union of
    the events' intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for e in events:
        if cur_e is None or e.ts > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = e.ts, e.end
        else:
            cur_e = max(cur_e, e.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def dispatches(events: List[DeviceEvent], request_bytes: int,
               max_requests: int) -> List[tuple]:
    """The timeline cut into dispatches: each starts at a host-to-device
    copy whose size is a whole number (1 to ``max_requests``) of request
    payloads and holds the device operations up to the next such copy.
    Returns ``(requests, events)`` for every dispatch whose start and
    end both lie in the trace (the first and last cuts may be partial and
    are dropped)."""
    cuts = [i for i, e in enumerate(events)
            if e.is_htod and int(e.args.get("bytes", 0)) > 0
            and int(e.args["bytes"]) % request_bytes == 0
            and int(e.args["bytes"]) // request_bytes <= max_requests]
    return [(int(events[a].args["bytes"]) // request_bytes, events[a:b])
            for a, b in zip(cuts, cuts[1:])]


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without its return type and argument list, cut to
    ``width`` characters."""
    name = re.sub(r"^void\s+", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):        # the first '(' outside templates
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut].strip()[:width]


def breakdown(events: List[DeviceEvent], top: int = 10) -> Optional[Dict]:
    """The ``top`` device operations by total seconds, and the ``top``
    longest idle gaps, each named by the operations on either side."""
    if not events:
        return None
    by_name: Dict[str, float] = {}
    for e in events:
        k = short_name(e.name)
        by_name[k] = by_name.get(k, 0.0) + e.dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    last = events[0]
    for e in events[1:]:
        if e.ts > last.end:
            gaps.append((f"{short_name(last.name, 38)} -> "
                         f"{short_name(e.name, 38)}",
                         (e.ts - last.end) / 1e6))
        if e.end > last.end:
            last = e
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps[:top]]}
