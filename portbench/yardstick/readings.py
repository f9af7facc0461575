"""The arithmetic the metric readers share, over a run's ``RunData``.

Host readings (dispatch stages, work produced) come from the part of
the window before the traced slice; device readings from the slice's
profiler events.  A reading with nothing to read is None.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from portbench.yardstick import peaks, trace, work

K1 = re.compile(r"(^|\s|::)fused_\w+_kernel<")


def rate_per_s(run, end: Optional[float] = None) -> Optional[float]:
    """Units (images, tokens) the program produced in [0, end) per
    second (a gateway's request emits its units when it is answered, a
    decode step its tokens when it ends)."""
    end = run.seconds if end is None else end
    n = run.units_before(end)
    return n / end if n else None


def host_stages(run) -> List:
    """The dispatches that completed before the traced slice."""
    return [st for t, st in run.stages if t < run.host_end]


def stage_median_ms(run, of) -> Optional[float]:
    stages = host_stages(run)
    return float(np.median([of(st) for st in stages])) * 1e3 \
        if stages else None


def mfu_pct(run, peak_per_s: float) -> Optional[float]:
    """Operations of the units produced before the traced slice, per
    second of that part of the window, as a share of ``peak_per_s``."""
    rate = rate_per_s(run, run.host_end)
    if rate is None:
        return None
    return 100.0 * rate * run.ops_per_unit / peak_per_s


def idle_share_pct(run) -> Optional[float]:
    """Share of the traced slice in which no device operation ran."""
    if not run.traced or not run.events:
        return None
    window = run.traced[1] - run.traced[0]
    return 100.0 * (1.0 - trace.busy_s(run.events) / window)


def traced_dispatches(run):
    return trace.dispatches(run.events, run.request_bytes, run.max_batch)


def k1_roofline_pct(run) -> Optional[float]:
    """Σ least time over Σ device time of K1's launches (its kernels are
    ``fused_*_kernel`` in ``csrc/fused_dot_layer.cu``) in the traced
    dispatches that launch K1 once per layer of the configuration's
    network, each layer bounded at the dispatch's images."""
    net = run.config["network"]
    bound = spent = 0.0
    for n, events in traced_dispatches(run):
        k1 = [e for e in events if e.cat == "kernel" and K1.search(e.name)]
        if len(k1) != len(net["layers"]):
            continue
        bound += sum(work.conv_layer_bound_s(n, net, i)
                     for i in range(len(k1)))
        spent += sum(e.dur for e in k1) / 1e6
    return 100.0 * bound / spent if spent else None


def expert_gemm_roofline_pct(run) -> Optional[float]:
    """FLOPs the dispatched tokens need at the float32 peak over the
    device time of the GEMM kernels (names holding ``gemm``) in the traced
    dispatches that launch the most common number of them (a dispatch
    whose trace lost a kernel's events is left out)."""
    flops_token = work.moe_flops_per_token(run.config)
    cut = [(n, [e for e in events if e.cat == "kernel"
                and "gemm" in e.name.lower()])
           for n, events in traced_dispatches(run)]
    counts = [len(g) for _, g in cut if g]
    if not counts:
        return None
    usual = max(set(counts), key=counts.count)
    need = spent = 0.0
    for n, gemms in cut:
        if len(gemms) == usual:
            need += n * run.units_per_request * flops_token \
                / peaks.FP32_FLOPS_PER_S
            spent += sum(e.dur for e in gemms) / 1e6
    return 100.0 * need / spent
