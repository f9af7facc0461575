"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Untraced, the result's metrics are the cell's end-to-end metrics in
``BENCHMARK.json``; traced, its per-layer metrics.  The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, traced also ``breakdown``, and
``checks`` last: every number the output check compared, beside its
limit); the checks are also the last lines of standard error.  For a
cell ``BENCHMARK.json`` does not list, without a CUDA card, or with JAX
loaded once the window has closed, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="cell name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(outcome, readers: dict, units: dict) -> dict:
    """The result line's object, ``checks`` last; a metric whose reader
    finds nothing to read is left out."""
    from portbench.yardstick import trace as tr
    data = outcome.data
    metrics = {}
    for name, read in readers.items():
        value = read(data)
        if value is None:
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"{name} reads {value}: more requests went "
                               f"unanswered than the statistic allows")
        metrics[name] = {"value": value, "unit": units[name]}
    device = {"platform": "gpu", "kind": outcome.device_kind, "count": 1,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if data.traced is not None:
        device.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
        bd = tr.breakdown(data.events)
        if bd is not None:
            out["breakdown"] = bd
    checks = {"compared": {"value": outcome.checks.get("compared", 0),
                           "at_least": 1}}
    for k, lim in outcome.limits.items():
        checks[k] = {"value": outcome.checks.get(k), "limit": lim}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import catalog, harness
    import torch

    bench = catalog.benchmark(ROOT)
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: BENCHMARK.json lists no cell {args.workload!r}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    names = catalog.metrics_for(bench, args.workload, bool(args.trace))
    readers = {n: catalog.module("metrics", n).read for n in names}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    outcome = harness.run_cell(args.workload, args.seed, args.seconds,
                               trace=bool(args.trace), started=STARTED)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    line = result(outcome, readers, units)
    for k, v in line["checks"].items():
        print(f"check {k}: {v}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
