"""Ops telemetry: ``Tracker`` ABC, JSONL exporter, and stats sampler.

Port of ``repro.ops.tracker`` (it uses only the standard library); the
records and the file format are the reference's.

Serving components (gateway, fleet, caches) emit two kinds of signal:
**lifecycle events** (plan registered/retired, cache compile/disk hit/
fallback, worker ejected/probed) and **periodic stats snapshots** (the
``stats()`` dicts ``SlotPool``/``AsyncCNNGateway``/``Fleet`` already
expose).  ``Tracker`` is the sink abstraction for both; components take
an optional tracker and call it fire-and-forget.

The contract that matters: **a tracker never blocks or breaks the
serving path.**  ``JsonlTracker`` writes from a background thread fed
by a bounded queue — when the queue is full the entry is *dropped and
counted*, not waited on; writer errors are swallowed; ``close()``
flushes everything queued and appends a final ``tracker_closed`` record
carrying the recorded/dropped totals, so the file itself says whether
it is complete.

    with JsonlTracker("metrics.jsonl") as tr:
        gw = AsyncCNNGateway(cfg, tracker=tr)
        sampler = StatsSampler(tr, {"gateway": gw.stats}, interval_s=0.5)
        ...
        sampler.close()
    log = read_log("metrics.jsonl")
    assert log.sealed and log.dropped == 0

Every record is one JSON object per line with at least ``t`` (epoch
seconds) and ``event``; samples use ``event: "stats"`` plus ``source``
and the snapshot under ``metrics``.  ``read_log`` parses a file back
into a ``TrackerLog`` that surfaces the seal totals (recorded /
dropped / write_errors) so recovery tests can bound telemetry loss;
``read_events`` remains the events-only convenience.
"""

from __future__ import annotations

import abc
import json
import os
import queue
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Mapping, Optional, Tuple, Union

__all__ = ["Tracker", "NullTracker", "JsonlTracker", "StatsSampler",
           "TrackerLog", "read_log", "read_events"]


class Tracker(abc.ABC):
    """Sink for lifecycle events and metric snapshots.

    Implementations must make ``record`` cheap and non-blocking — it is
    called from the serving path.  ``log_event``/``log_metrics`` are
    convenience shapers over ``record``.
    """

    @abc.abstractmethod
    def record(self, entry: dict) -> None:
        """Accept one record (must not block or raise)."""

    def log_event(self, event: str, **fields) -> None:
        entry = {"t": time.time(), "event": event}
        entry.update(fields)
        self.record(entry)

    def log_metrics(self, source: str, metrics: Mapping) -> None:
        self.record({"t": time.time(), "event": "stats",
                     "source": source, "metrics": dict(metrics)})

    def close(self) -> None:
        """Flush and release resources (idempotent)."""

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullTracker(Tracker):
    """Discards everything; the default when no tracker is wired."""

    def record(self, entry: dict) -> None:
        pass


class _CLOSE:  # sentinel enqueued by close()
    pass


class JsonlTracker(Tracker):
    """Background-threaded JSONL exporter (see module docstring).

    ``max_queue`` bounds memory under a stalled disk: overflow entries
    are dropped and tallied in ``dropped`` rather than back-pressuring
    the caller.  ``flush_interval_s`` bounds how stale the file can be
    while the process lives; ``close()`` (or context-manager exit)
    drains the queue fully and fsyncs.
    """

    def __init__(self, path: Union[str, Path], *, max_queue: int = 4096,
                 flush_interval_s: float = 0.25,
                 io_fault: Optional[Callable[[dict], None]] = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self.recorded = 0
        self.dropped = 0
        self.write_errors = 0
        #: fault-injection seam: called with each entry before the disk
        #: write; raising simulates a full/failing disk for that entry
        #: (the entry is counted in ``write_errors``, never retried)
        self.io_fault = io_fault
        self._closed = False
        self._lock = threading.Lock()
        self._flush_interval_s = flush_interval_s
        self._fh = open(self.path, "a", encoding="utf-8")
        self._thread = threading.Thread(
            target=self._run, name="jsonl-tracker", daemon=True)
        self._thread.start()

    # -- producer side (serving path) --------------------------------

    def record(self, entry: dict) -> None:
        with self._lock:
            if self._closed:
                self.dropped += 1
                return
            try:
                self._q.put_nowait(entry)
                self.recorded += 1
            except queue.Full:
                self.dropped += 1

    # -- writer thread -----------------------------------------------

    def _write(self, entry: dict) -> None:
        try:
            if self.io_fault is not None:
                self.io_fault(entry)
            self._fh.write(json.dumps(entry, default=repr,
                                      sort_keys=True) + "\n")
        except Exception:   # noqa: BLE001 — telemetry must not raise
            with self._lock:
                self.write_errors += 1

    def _run(self) -> None:
        dirty = False
        while True:
            try:
                item = self._q.get(timeout=self._flush_interval_s)
            except queue.Empty:
                if dirty:
                    try:
                        self._fh.flush()
                    except Exception:
                        pass
                    dirty = False
                continue
            if item is _CLOSE:
                break
            self._write(item)
            dirty = True
        # drain whatever raced in behind the sentinel, then seal
        while True:
            try:
                self._write(self._q.get_nowait())
            except queue.Empty:
                break
        with self._lock:
            recorded, dropped = self.recorded, self.dropped
            write_errors = self.write_errors
        self._write({"t": time.time(), "event": "tracker_closed",
                     "recorded": recorded, "dropped": dropped,
                     "write_errors": write_errors})
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except Exception:
            pass
        self._fh.close()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(_CLOSE)       # blocking put is fine at shutdown
        self._thread.join()


@dataclass(frozen=True)
class TrackerLog:
    """A parsed tracker file plus its integrity verdict.

    ``sealed`` is True when the file ends with the ``tracker_closed``
    record a clean ``close()`` writes; only then are ``recorded`` /
    ``dropped`` / ``write_errors`` available (they come from the seal,
    the single source of truth for telemetry-loss bounds — recovery
    tests assert ``log.dropped == 0`` after a kill→respawn run).  An
    unsealed file means the tracker process died mid-flight: the events
    read are a prefix and no loss bound can be claimed.  ``torn_lines``
    counts unparseable lines skipped during the read (crash-torn
    trailing writes).
    """

    events: Tuple[dict, ...]
    sealed: bool
    recorded: Optional[int] = None
    dropped: Optional[int] = None
    write_errors: Optional[int] = None
    torn_lines: int = 0


def read_log(path: Union[str, Path]) -> TrackerLog:
    """Parse a tracker JSONL file into events + seal totals."""
    events: List[dict] = []
    torn = 0
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                torn += 1
    sealed = bool(events) and events[-1].get("event") == "tracker_closed"
    seal = events[-1] if sealed else {}
    return TrackerLog(events=tuple(events), sealed=sealed,
                      recorded=seal.get("recorded"),
                      dropped=seal.get("dropped"),
                      write_errors=seal.get("write_errors"),
                      torn_lines=torn)


def read_events(path: Union[str, Path]) -> List[dict]:
    """Parse a tracker JSONL file (skipping any torn trailing line)."""
    return list(read_log(path).events)


class StatsSampler:
    """Periodically records ``stats()`` snapshots into a tracker.

    ``sources`` maps a name to a zero-arg callable returning a dict
    (e.g. ``{"gateway": gw.stats, "fleet": fleet.stats}``).  A source
    that raises produces a ``sample_error`` event instead of killing
    the sampler.  ``close()`` takes one final sample so short runs
    still leave a snapshot, then stops the thread.
    """

    def __init__(self, tracker: Tracker,
                 sources: Mapping[str, Callable[[], Mapping]], *,
                 interval_s: float = 0.5):
        self.tracker = tracker
        self.sources = dict(sources)
        self.interval_s = interval_s
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="stats-sampler", daemon=True)
        self._thread.start()

    def _sample_once(self) -> None:
        for name, fn in self.sources.items():
            try:
                self.tracker.log_metrics(name, fn())
            except Exception as err:   # noqa: BLE001 — keep sampling
                self.tracker.log_event("sample_error", source=name,
                                       error=repr(err))
        self.samples += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._sample_once()

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join()
        self._sample_once()       # final snapshot at shutdown

    def __enter__(self) -> "StatsSampler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
