#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs
on one CUDA card.  Run from the root of a checkout:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro`` and runs, in
order (any mismatch or error raises and the exit code is non-zero):

1. environment: the card's name and power limit as nvidia-smi reports
   them, and the torch, CUDA and nvcc versions;
2. build: the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc each, all started together), with ``-Xptxas -v``;
3. kernels against their plain PyTorch versions on the card, with
   tolerance zero (``torch.equal``: the path is exact integer
   arithmetic) at the serving path's shapes at bucket 16 and on an edge
   grid of bit widths with odd out_ch and in_ch = 40; at the serving
   shapes each kernel is timed with CUDA events over back-to-back calls
   (``ms``, host launch cost included) and from a profiler trace
   (``device_ms``, the kernel alone), beside its plain version, the
   least time the card could take (``bound_ms``) and
   ``torch.nn.functional.conv2d`` on float32 copies with TF32 off
   (``library_ms``, exact at these widths; timed here only);
4. serve: ``repro_torch.launch.serve``'s code path on both committed
   plans with the golden weights, 64 requests, max_batch 16, after one
   untimed warm-up pass; outputs must equal the JAX reference's golden
   outputs (``src/repro_torch/golden/quickstart_reference.npz``) and the
   port's ``cnn_forward_ref`` on the CPU; every launch counter is set to
   0 just before each plan is served and read just after, and each
   kernel of the path must have launched at least once per forward;
   then images/s from passes of 4,096 requests per plan (unpinned,
   pinned, pinned, unpinned, twice over), and a profiler trace of one
   pinned pass for the device time per step, by kernel, and the idle
   share;
5. one JSON line ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero without a result where ``torch.cuda.is_available()``
is false, or where the port's sources are not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PLANS = ROOT / "src" / "repro_torch" / "plans"
GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "quickstart_reference.npz"
PINNED = "quickstart_v5e_conv1_conv3"
UNPINNED = "quickstart_v5e"
REQUESTS, MAX_BATCH = 64, 16
TIMED_REQUESTS = 4096            # 256 full steps per timed pass
PROFILED_REQUESTS = 1024

# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; int8
# tensor cores 1,979 TOP/s; 67 TFLOP/s float32 outside the tensor cores,
# taken as the rate of int32 operands (the table has no int32 entry).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
CUDA_CORE_OPS_PER_S = 67e12

# main-path shapes at bucket 16: (kernel, N, H, W, ic, oc, d, c, on the
# pinned plan); the pinned plan runs each kernel at one of them
MAIN_CASES = (
    ("fused_dot_layer", 16, 32, 128, 1, 8, 8, 6, True),
    ("fused_dot_layer", 16, 32, 128, 8, 8, 8, 6, False),
    ("fused_dot_layer", 16, 32, 128, 8, 4, 6, 4, False),
    ("conv1_layer", 16, 32, 128, 8, 8, 8, 6, True),
    ("packed_dot_layer", 16, 32, 128, 8, 4, 6, 4, True),
)
# (d, c) edge grid, run at (2, 16, 24, ic=40) → oc=5
EDGE_BITS = ((3, 3), (3, 8), (6, 6), (8, 8), (9, 8), (8, 9), (16, 16),
             (12, 16), (16, 12))
REPLACES = {
    "conv1_layer": "src/repro/kernels/conv2d.py:75",
    "fused_dot_layer": "src/repro/blocks/base.py:245",
    "packed_dot_layer": "src/repro/blocks/base.py:261",
}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def operands(rng, n, h, w, ic, oc, d, c, *, x_range=None):
    """Inputs over the full signed d-bit range (or ``x_range``) and
    weights over the full c-bit range, extremes forced in."""
    import numpy as np
    import torch
    from repro_torch.kernels.conv2d import container_dtype
    lo, hi = x_range or (-(1 << (d - 1)), (1 << (d - 1)) - 1)
    x = rng.integers(lo, hi + 1, (n, h, w, ic))
    x.reshape(-1)[:2] = (lo, hi)
    wlo, whi = -(1 << (c - 1)), (1 << (c - 1)) - 1
    wk = rng.integers(wlo, whi + 1, (oc, ic, 3, 3))
    wk.reshape(-1)[:2] = (wlo, whi)
    xdt = torch.int16 if x_range else container_dtype(d)
    return (torch.from_numpy(x.astype(np.int64)).to(xdt).cuda(),
            torch.from_numpy(wk.astype(np.int64)).to(container_dtype(c))
            .cuda())


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, kernel_name: str, iters: int = 50):
    """Mean device time per call of the CUDA kernels whose name holds
    ``kernel_name``, from a ``torch.profiler`` trace of ``iters`` calls:
    the kernel alone, without the host's launch cost that the CUDA-event
    time of back-to-back calls includes.  None when the trace holds no
    device time for it (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0)
                   for e in prof.key_averages() if kernel_name in e.key)
    return total_us / iters / 1e3 if total_us else None


def bound(x, wk, d, c):
    """(bound_ms, bound_by): the larger of the bytes the layer must move
    (x and w read once, the int32 output written once) over the memory
    rate and the operations its function needs over the peak rate of
    their type.  All three kernels compute a 3x3 convolution of in_ch
    into out_ch (the shift-adds and the packing are how the reference
    computes it, not what it computes): a multiply and an add per tap,
    input channel and output, at the int8 rate where ``_dot_dtype``
    takes int8 operands, else at the CUDA-core rate."""
    import torch
    from repro_torch.kernels.conv2d import _dot_dtype
    n, h, w, ic = x.shape
    oc = wk.shape[0]
    pix = n * h * w
    nbytes = (x.numel() * x.element_size() + wk.numel() * wk.element_size()
              + pix * oc * 4)
    ops = 2 * pix * oc * ic * 9
    rate = INT8_OPS_PER_S if _dot_dtype(d, c) == torch.int8 \
        else CUDA_CORE_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_conv(x, wk):
    """(ms, output) of one cuDNN float32 convolution of the same layer
    (TF32 off), which is exact at these widths: the yardstick, never
    called by the port."""
    import torch
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    xf = x.permute(0, 3, 1, 2).float().contiguous()
    wf = wk.float().contiguous()
    return time_ms(lambda: F.conv2d(xf, wf, padding=1), 200, warmup=10), \
        F.conv2d(xf, wf, padding=1)


def check_kernels():
    """Phase 3.  Returns {kernel: entry} for the kernels line."""
    import numpy as np
    import torch
    from repro_torch.blocks import base
    from repro_torch.kernels import conv2d

    wrappers = {
        "conv1_layer": (conv2d.conv1_layer, conv2d.conv1_layer_plain),
        "fused_dot_layer": (base.fused_dot_layer,
                            base.fused_dot_layer_plain),
        "packed_dot_layer": (base.packed_dot_layer,
                             base.packed_dot_layer_plain),
    }
    entries = {k: {"name": k, "route": "cuda",
                   "source": f"src/repro_torch/kernels/csrc/{k}.cu",
                   "replaces": REPLACES[k], "max_abs_err": 0,
                   "equal": True, "cases": []} for k in wrappers}
    rng = np.random.default_rng(0)

    def compare(name, label, x, wk, d, c):
        kern, plain = wrappers[name]
        y = kern(x, wk, data_bits=d, coeff_bits=c)
        torch.cuda.synchronize()
        y_plain = plain(x, wk, data_bits=d, coeff_bits=c)
        err = int((y.to(torch.int64) - y_plain.to(torch.int64)).abs().max())
        eq = torch.equal(y, y_plain)
        print(f"  {name:17s} {label:34s} equal={eq} max_abs_err={err}")
        if not eq:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {label}: max_abs_err={err}")
        e = entries[name]
        e["max_abs_err"] = max(e["max_abs_err"], err)
        return y

    print("[kernels] main-path shapes at bucket 16, against the plain "
          "versions (tolerance 0)")
    for name, n, h, w, ic, oc, d, c, pinned in MAIN_CASES:
        x, wk = operands(rng, n, h, w, ic, oc, d, c)
        label = f"({n},{h},{w},{ic})->{oc} d{d}c{c}"
        y = compare(name, label, x, wk, d, c)
        kern, plain = wrappers[name]
        ms = time_ms(lambda: kern(x, wk, data_bits=d, coeff_bits=c), 200,
                     warmup=10)
        plain_ms = time_ms(lambda: plain(x, wk, data_bits=d, coeff_bits=c),
                           5, warmup=1)
        dev_ms = device_ms(lambda: kern(x, wk, data_bits=d, coeff_bits=c),
                           f"{name}_kernel")
        lib_ms, y_lib = library_conv(x, wk)
        lib_eq = torch.equal(y_lib.to(torch.int32), y)
        b_ms, b_by = bound(x, wk, d, c)
        case = {"shape": [n, h, w, ic], "oc": oc, "d": d, "c": c,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "library_equal": lib_eq}
        print(f"    ms={ms:.6f} device_ms={dev_ms} plain_ms={plain_ms:.6f} "
              f"bound_ms={b_ms:.6f} ({b_by}) library_ms={lib_ms:.6f} "
              f"library_equal={lib_eq}")
        entries[name]["cases"].append(case)
        if pinned:
            entries[name].update({k: case[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
            entries[name]["shape"] = case["shape"] + [oc]

    print("[kernels] edge grid: (2, 16, 24, ic=40) -> oc=5, full signed "
          "ranges with the extremes")
    for d, c in EDGE_BITS:
        x, wk = operands(rng, 2, 16, 24, 40, 5, d, c)
        for name in wrappers:
            if name == "packed_dot_layer" \
                    and conv2d._pack_shift(d, c) > conv2d.PACK_SHIFT_BUDGET:
                try:
                    base.packed_dot_layer(x, wk, data_bits=d, coeff_bits=c)
                except ValueError:
                    print(f"  {name:17s} d{d}c{c}: refused (pack shift "
                          f"exceeds 31 bits), as the reference raises")
                    continue
                raise AssertionError(f"{name} took d{d}c{c}")
            compare(name, f"d{d}c{c}", x, wk, d, c)
    # int16 inputs over the whole container at d=3: the Conv1 plane
    # accumulator is int16 there and wraps as the reference's does
    x, wk = operands(rng, 2, 16, 24, 40, 5, 3, 8, x_range=(-32768, 32767))
    for name in wrappers:
        compare(name, "d3c8 container-range x (int16)", x, wk, 3, 8)
    return entries


def serve_args(stem, requests):
    from repro_torch.launch import serve
    return serve.parse_args([
        "--workload", "cnn", "--plan", str(PLANS / f"{stem}.json"),
        "--params", str(GOLDEN), "--requests", str(requests),
        "--max-batch", str(MAX_BATCH), "--torch-device", "cuda"])


def serve_plans(entries):
    """Phase 4: both committed plans through the launcher's code path.

    Each plan is served once untimed first, so that no later pass pays
    a first use (library load, lazy module load, allocator growth); then
    once with its launch counts read and its outputs checked.  Images/s
    come from later passes of TIMED_REQUESTS each, in the order unpinned,
    pinned, pinned, unpinned, twice over, timed with ``perf_counter``.
    Returns
    ({plan: [images/s per pass]}, {plan: [ms per step per pass]})."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.blocks import base
    from repro_torch.core import deploy
    from repro_torch.core.cnn import cnn_forward_ref
    from repro_torch.kernels import conv2d
    from repro_torch.launch import serve
    from repro_torch.runtime import load_plan

    counters = {"conv1_layer": conv2d.conv1_layer,
                "fused_dot_layer": base.fused_dot_layer,
                "packed_dot_layer": base.packed_dot_layer}
    for e in entries.values():
        e["launches"] = 0
    golden = np.load(GOLDEN)
    for stem in (UNPINNED, PINNED):
        serve.run_cnn(serve_args(stem, REQUESTS))          # warm-up pass
        for fn in counters.values():
            fn.launches = 0
        engine, reqs, _ = serve.run_cnn(serve_args(stem, REQUESTS))
        launches = {k: fn.launches for k, fn in counters.items()}
        forwards = sum(engine.stats()["bucket_hits"].values())
        xs = np.stack([r.image for r in reqs])
        ys = np.stack([r.output for r in reqs])
        if not (np.array_equal(xs[:8], golden[f"{stem}.x"])
                and np.array_equal(ys[:8], golden[f"{stem}.y"])):
            raise AssertionError(f"{stem}: outputs differ from the JAX "
                                 f"reference's golden")
        pcfg = deploy.plan_config(load_plan(PLANS / f"{stem}.json"))
        params = convert.params_from_numpy(
            [golden[f"{stem}.w{i}"] for i in range(len(pcfg.layers))],
            pcfg, "cpu")
        y_ref = cnn_forward_ref(params, torch.from_numpy(xs), pcfg).numpy()
        if not np.array_equal(ys, y_ref):
            raise AssertionError(f"{stem}: outputs differ from the port's "
                                 f"cnn_forward_ref on the CPU")
        want = {"fused_dot_layer"} | (
            {"conv1_layer", "packed_dot_layer"} if stem == PINNED else set())
        for k in want:
            if launches[k] < forwards:
                raise AssertionError(
                    f"{stem}: {k} launched {launches[k]} times in "
                    f"{forwards} forwards")
        for k, v in launches.items():
            entries[k]["launches"] += v
        print(f"[serve] {stem}: {forwards} forwards, launches {launches}; "
              f"{len(reqs)} outputs equal cnn_forward_ref (CPU), the first "
              f"8 equal the JAX golden")

    rates = {UNPINNED: [], PINNED: []}
    step_ms = {UNPINNED: [], PINNED: []}
    for stem in (UNPINNED, PINNED, PINNED, UNPINNED) * 2:
        engine, reqs, dt = serve.run_cnn(serve_args(stem, TIMED_REQUESTS))
        if not all(r.done for r in reqs):
            raise AssertionError(f"{stem}: a timed request was not served")
        rates[stem].append(len(reqs) / dt)
        step_ms[stem].append(dt * 1e3 / engine.stats()["steps"])
    for stem in rates:
        print(f"[serve] {stem}: {TIMED_REQUESTS} requests per timed pass, "
              f"images/s {rates[stem]}, ms per step {step_ms[stem]} on "
              f"{torch.cuda.get_device_name(0)}")
    return rates, step_ms


def serve_profile(stem, step_ms):
    """Device time of one served pass of PROFILED_REQUESTS on ``stem``
    from a ``torch.profiler`` trace, per step and by kernel, and the
    device's idle share against ``step_ms`` (the untraced timed passes'
    mean wall time per step).  None when the trace holds no device
    time (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine, _, _ = serve.run_cnn(serve_args(stem, PROFILED_REQUESTS))
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU and e.device_time_total > 0:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    if not by_name:
        print("[profile] the trace holds no device time: not measured")
        return None
    steps = engine.stats()["steps"]
    busy_ms = sum(by_name.values()) / 1e3 / steps
    wall_ms = sum(step_ms) / len(step_ms)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    result = {"plan": stem, "steps": steps, "device_ms_per_step": busy_ms,
              "wall_ms_per_step": wall_ms,
              "idle_share": 1.0 - busy_ms / wall_ms,
              "top_ms_per_step": [[k[:80], v / 1e3 / steps]
                                  for k, v in top]}
    print(f"[profile] {stem}: {busy_ms:.6f} ms of device time per step "
          f"against {wall_ms:.6f} ms of wall time per step (untraced): "
          f"idle share {result['idle_share']:.4f}")
    for k, v in result["top_ms_per_step"]:
        print(f"  {v:.6f} ms/step  {k}")
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port's sources are not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    try:
        smi = nvidia_smi_line()
        nvcc_v = subprocess.run([build.nvcc(), "--version"],
                                capture_output=True, text=True, check=True,
                                timeout=60).stdout.strip().splitlines()[-1]
        print(f"[env] card: {smi}")
        print(f"[env] torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, nvcc: {nvcc_v}")

        t0 = time.perf_counter()
        reports = build.build()
        print(f"[build] {len(reports)} kernels built in "
              f"{time.perf_counter() - t0:.1f}s into {build.BUILD_DIR}")
        for name, log in reports.items():
            for line in log.splitlines():
                if "ptxas info" in line and ("Used" in line
                                             or "Compiling" in line):
                    print(f"  {name}: {line.strip()}")

        entries = check_kernels()
        rates, step_ms = serve_plans(entries)
        prof = serve_profile(PINNED, step_ms[PINNED])
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "equal", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "shape", "cases")
        line = {"kernels": [{k: e[k] for k in keys}
                            for e in entries.values()],
                "images_per_s": rates, "ms_per_step": step_ms,
                "serve_profile": prof, "card": smi}
        print(json.dumps(line))
        print(smi)
    except Exception:                  # noqa: BLE001 — report and fail
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
