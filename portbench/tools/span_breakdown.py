"""Where a traced run's device idle goes, by program span.

    python3 portbench/tools/span_breakdown.py --workload moe-closed64 \
        --seed 11 --seconds 30

One process runs one traced window of the cell (as ``run.py --trace 1``
does) and prints one JSON line, also appended to
``portbench/out/span-breakdown-<cell>.jsonl`` (the harness's git-ignored
output directory): the rate, the span metrics and the stage metrics, the
share of the slice's dispatches whose answer copy lies inside their
``gateway.copy_out`` span, on the nominal clock and on the trace's clock
as the input copies anchor it (``yardstick.spans.on_device_clock``; the
range of the anchors' shifts), how long after the copy's end that span
ends there, the slice's device idle a dispatch split by innermost span
(``yardstick.spans.idle_by_span``), and the dispatch period inside the
slice from the gateway's stage stamps. On a port without spans the span
readings are null. Runs on a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402
from portbench.yardstick import readings, spans  # noqa: E402


def copy_out_lags_us(run, items) -> list:
    """For each ``gateway.copy_out`` span of the slice with an answer
    copy inside it: the span's end less the copy's end."""
    out = []
    for s in spans.copy_out_spans(run, items):
        inside = [e for e in spans.answer_copies(run)
                  if s.ts - spans.COPY_SLACK_US <= e.ts
                  and e.end <= s.end + spans.COPY_SLACK_US]
        if inside:
            out.append(s.end - max(e.end for e in inside))
    return out


def breakdown(out) -> dict:
    run = out.data
    items = spans.recorded()
    dispatches = spans.dispatch_spans(run, items)
    split = spans.idle_by_span(run, items)
    anchors = spans.clock_anchors(run, items)
    moved = spans.on_device_clock(run, items) if items else None
    lags = copy_out_lags_us(run, moved) if moved else []
    t_on = run.traced[0]
    stamps = [t for t, _ in run.stages if t >= t_on]
    totals = [st.total for t, st in run.stages if t >= t_on]
    per = max(len(dispatches), 1)
    return {
        "tokens_per_s": readings.rate_per_s(run),
        "correct": out.correct,
        "device": out.device_kind,
        "queue_wait_ms": spans.queue_wait_ms(run, items),
        "loop_gap_ms": spans.loop_gap_ms(run, items),
        "copy_in_ms": spans.copy_in_ms(run, items),
        "gc_pause_share_pct": spans.gc_pause_share_pct(run, items),
        "idle_named_share_pct": spans.idle_named_share_pct(run, items),
        "copy_out_share": spans.copy_out_share(run, items),
        "copy_out_share_anchored": spans.copy_out_share(run, moved)
        if moved else None,
        "forward_kernel_share": spans.forward_kernel_share(run, moved)
        if moved else None,
        "anchors": len(anchors),
        "anchor_shift_us": [min(d for _, d in anchors),
                            max(d for _, d in anchors)] if anchors else None,
        "copy_out_lag_us_median": float(np.median(lags)) if lags else None,
        "copy_out_lag_us_max": float(max(lags)) if lags else None,
        "forward_ms": readings.stage_median_ms(run, lambda st: st.forward),
        "gateway_overhead_ms": readings.stage_median_ms(
            run, lambda st: st.total - st.forward),
        "idle_share_pct": readings.idle_share_pct(run),
        "dispatches_in_slice": len(dispatches),
        "idle_ms_per_dispatch": None if split is None else {
            k: v / 1e3 / per
            for k, v in sorted(split.items(), key=lambda kv: -kv[1])},
        "slice_period_ms_median": float(np.median(np.diff(stamps))) * 1e3
        if len(stamps) > 1 else None,
        "slice_stage_total_ms_median": float(np.median(totals)) * 1e3
        if totals else None,
        "spans": len(items) if items else 0,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           trace=True)
    row = {"cell": args.workload, "seed": args.seed, **breakdown(out)}
    line = json.dumps(row)
    print(line, flush=True)
    path = Path(__file__).resolve().parents[1] / "out" \
        / f"span-breakdown-{args.workload}.jsonl"
    path.parent.mkdir(exist_ok=True)
    with open(path, "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
