"""Host readings of an engine run (``servers/engine.py``'s ``RunData``):
its decode steps, (start, end, live slots), and its prefills, (start,
end, prompt length), in seconds on the recorder's clock.  Each reads
the steps or prefills that ended before the traced slice; with none to
read, None."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _before(rows: np.ndarray, run) -> np.ndarray:
    return rows[rows[:, 1] < run.host_end] if len(rows) else rows


def step_ms(run) -> Optional[float]:
    """Median time of one decode step, in ms."""
    steps = _before(run.steps, run)
    if not len(steps):
        return None
    return float(np.median(steps[:, 1] - steps[:, 0])) * 1e3


def slot_occupancy_pct(run) -> Optional[float]:
    """Mean live slots a decode step over the engine's ``max_batch``,
    in %."""
    steps = _before(run.steps, run)
    if not len(steps):
        return None
    return 100.0 * float(np.mean(steps[:, 2])) \
        / run.cell["engine"]["max_batch"]


def prefill_ms_per_ktok(run) -> Optional[float]:
    """Prefill time per 1,000 prompt tokens, in ms."""
    pre = _before(run.prefills, run)
    if not len(pre):
        return None
    return 1e6 * float(np.sum(pre[:, 1] - pre[:, 0])) / float(
        np.sum(pre[:, 2]))
