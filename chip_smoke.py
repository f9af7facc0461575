#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs
on one CUDA card.  Run from the root of a checkout:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro`` and runs, in
order (any mismatch or error raises and the exit code is non-zero):

1. environment: the card's name and power limit as nvidia-smi reports
   them, the torch, CUDA and nvcc versions, and the int32 CUDA-core rate
   from the card's SM count and maximum SM clock;
2. build: the eight CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc each, all started together), with ``-Xptxas -v``, and the
   count of tensor-core instructions in K8's SASS (``cuobjdump``);
3. layer kernels (K1–K3) against their plain PyTorch versions on the
   card, with tolerance zero (``torch.equal``: the path is exact integer
   arithmetic) at the serving path's shapes at bucket 16 and on an edge
   grid of bit widths with odd out_ch, at in_ch = 40 and at the
   unaligned in_ch = 3; K1 and K2 in both their entries, the int32
   accumulator and the layer with its requantize (``*_requant``, which
   the serving path runs); at the serving shapes each entry is timed
   with CUDA events over back-to-back calls (``ms``, host launch cost
   included) and from a profiler trace (``device_ms``, the kernel
   alone), beside its plain version, the least time the card could
   take (``bound_ms``) and ``torch.nn.functional.conv2d`` on float32
   copies with TF32 off (``library_ms`` by events and
   ``library_device_ms``, the device time of every kernel the library
   calls launch, from a profiler trace; exact at these widths; for a
   requantizing entry followed by the torch shift, clamp, cast and
   channels-last copy; timed here only); K1's route at each shape
   (dp4a for int8 dots) is printed;
4. plane kernels (K4–K6) the same way: at P = 1 on 32×128, on planes
   that fill no tile (P = 3 on 17×33, P = 4 on 1×1) and on P = 300
   planes of 16×24, at the quickstart layers' plane counts (out_ch·in_ch,
   or channel pairs · in_ch, as the single-image ``plane_layer`` launches
   them) and at P = 1 (one launch per plane, as ``cnn_forward_loop`` makes
   them), with their bits, where they are timed (``library_ms``: one
   grouped ``F.conv2d``, groups = P), on the edge grid, on int16
   container-range inputs, and through ``ConvBlock.apply`` against the
   JAX reference's golden ``apply`` outputs;
5. serve: ``repro_torch.launch.serve``'s code path on both committed
   plans with the golden weights, 64 requests, max_batch 16, after one
   untimed warm-up pass; outputs must equal the JAX reference's golden
   outputs (``src/repro_torch/golden/quickstart_reference.npz``) and the
   port's ``cnn_forward_ref`` on the CPU; every launch counter is set to
   0 just before each plan is served and read just after, and each
   layer must have launched its entry once per forward (K1 and K2
   through their requantizing entries, never the int32 ones);
   then images/s from passes of 4,096 requests per plan (unpinned,
   pinned, pinned, unpinned, twice over), and a profiler trace of one
   pass of each plan for the device time per step, by kernel, the idle
   share and the device operations per step (how many of them torch
   kernels);
6. the per-plane path on both committed plans with the golden weights:
   ``cnn_forward_loop`` (one plane-kernel launch per plane) and the
   single-image ``cnn_forward`` of every golden image equal the golden
   outputs;
7. plan on the card: the launcher's default path — the port's own full
   resource sweep (timed), a ``v5e`` plan, ``validate_plan`` on the
   card (bit-exact, MAPE < 2 % on every budgeted resource), the same
   for a plan with layers pinned to conv2, conv1 and conv3, then 16
   requests served from the ``v5e`` plan; the counters are set to 0
   just before and read just after, and each plane kernel must have
   launched; then, counted apart, ``cnn_forward_loop`` of the pinned
   plan on a few seeded images with seeded weights (K4 at P = 1, one
   launch per Conv2 plane, K3 and K5), equal to ``cnn_forward_ref`` on
   the CPU;
8. the async gateway: both committed plans registered in one
   ``AsyncCNNGateway`` (max_batch 16, on the card, golden weights)
   sharing one ``ExecutableCache``, which must hold exactly the two
   plans' distinct layers × 5 buckets (counted from the keys); the 8
   golden images and 64 seeded samples of each plan interleaved through
   ``await submit(..., plan_id=...)``, every output equal to
   ``cnn_forward_ref`` on the CPU and the golden ones to the JAX golden,
   with the counters set to 0 just before and read just after (each
   plan's forwards launch SERVE_LAUNCHES per forward, never K1's or K2's
   int32 entries); ``should_abort`` returning True at its second poll
   raises ``DispatchAborted`` with exactly layer 0's launch counted; then
   the launcher's ``run_cnn_async`` on each plan, 4,096 Poisson arrivals
   at occupancy 0.8 and 2.0 with ``--max-pending 32`` and one run with
   ``--deadline-ms 2 --wait-budget-ms 5``, each with ``served + shed +
   expired == requests``, ``served > 0`` and ``failed == 0`` (a dispatch
   that raises fails its futures, so a kernel that fails cannot pass
   unseen), and the served outputs of every 16th request equal to
   ``cnn_forward_ref`` on the CPU, printing the full-batch step (bare
   forward and through the gateway), the offered load scheduled and
   achieved, images/s, p50/p95/p99 from the scheduled arrival, service
   rate, occupancy and each dispatch stage's p50/p99/max with the
   card's name and power limit;
9. the fleet and recovery: the launcher's ``run_cnn_fleet`` (``edge0``,
   ``v5e0``, ``v5p0``, each on the plan the port's planner makes for its
   profile, max_batch 16, ``--max-pending 32``, one fresh ``--cache-dir``
   shared by the three gateways and the four runs) on 4,096 tiered
   Poisson arrivals (``--seed 1``) at occupancy 1.0 of one bare
   full-batch forward, under each router and once more under
   ``plan_aware`` with ``--drain``; each run with ``served + expired +
   shed == requests``, nothing failed, refused or lost, one drain where
   asked, every layer of every forward launching its entry once (the
   counters set to 0 just before and read just after), and the served
   outputs of every 16th request equal to ``cnn_forward_ref`` on the CPU
   with the plan and weights of the worker that served it; then
   recovery: a fresh ``StoreRoot`` holding the pinned plan under
   ``cnn`` (K1, K2 and K3), workers ``a`` and ``b`` from
   ``respawn_gateway`` (cold build seconds and ``nvcc`` runs), a seeded
   fault plan that crashes ``a`` at its first dispatch, 256 requests,
   ``Fleet.kill`` then ``Fleet.respawn`` from the store: ``completed +
   refused == requests``, nothing lost, some re-routed, every completion
   equal to ``cnn_forward_ref``, the respawned gateway's cache with 0
   preparations and layers × buckets disk hits, ``a`` re-admitted by the
   health probe; then a fresh process on the same root (``python3
   chip_smoke.py --warm-start``: ``LeaseHeld`` for ``b``, no ``nvcc`` run,
   nothing prepared, every library bound from the root's
   ``exec-cache/kernels/``, outputs equal to the parent's), every cache
   entry corrupted (each quarantined as ``*.corrupt`` and re-prepared),
   one library replaced by garbage (quarantined and rebuilt in a fresh
   process, never loaded) and a torn plan write (the live plan loads,
   listings skip the temp file);
10. the LM path (K7, K8): the conv1d and attention kernels against their
   plain versions on the card at the full-width shapes (K7 bit-exact at
   the launches of a Mamba-2-1.3B layer: 4096 and 128 channels, a
   prefill of (1, 512) without a state and a decode step of (4, 1) with
   one, K = 4, bf16, and their sums per layer; K8's bf16 tensor-core
   instantiation within one bf16 unit at (1, 512, 24, 128) with 8 kv
   heads, causal, and at S = 300; its float32 CUDA-core instantiation
   within 2e-5 at the smoke golden's shape (2, 16, 4, 2 kv heads, 16)),
   timed as in phase 3 (``library_ms`` and ``library_device_ms``:
   ``F.scaled_dot_product_attention`` and a depthwise ``F.conv1d``);
   device times are read by kernel name (``conv1_layer_kernel``,
   ``flash_attention_bf16_kernel``, ``flash_attention_f32_kernel``, ...);
   both smoke archs at float32 against the JAX reference's golden file
   ``src/repro_torch/golden/lm_reference.npz`` (logits within 2e-3,
   greedy tokens equal); then the launcher's ``serve_lm`` at full width
   and depth for Llama-3.2-3B (28 layers) and Mamba-2-1.3B (48 layers),
   bf16, random weights from a seeded generator: 8 requests, prompt 512,
   32 new tokens, max_batch 4, after one untimed warm-up pass, with the
   counters set to 0 before each arch and read after (K8 once per
   attention layer per prefill and never in decode, K7 three times per
   Mamba layer per prefill and per decode step); prefill ms per
   request, decode ms per step, tokens/s, and a profiler trace of 16
   decode steps for the device time and idle share per step; and one
   prefill at full width cut to 4 layers on the card (kernels) against
   the same parameters on the CPU (plain versions), relative L2 error of
   the logits under 5e-2;
11. one JSON line ``{"kernels": [...]}`` (with the fleet and recovery
   results under ``"fleet"`` and ``"recovery"``), the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

It exits non-zero without a result where ``torch.cuda.is_available()``
is false, or where the port's sources are not beside it.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import tempfile
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
# tensor cores 1,979 TOP/s.  Integer operands wider than 8 bits run on
# the CUDA cores: a Hopper SM has 64 INT32 lanes (half its 128 FP32
# lanes), each a multiply-add (2 operations) per clock, so their rate is
# computed from the card's SM count and maximum SM clock (``int32_rate``).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
INT32_LANES_PER_SM = 64
# bf16 dense tensor cores 989 TFLOP/s; float32 outside the tensor cores
# 67 TFLOP/s
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

# main-path shapes at bucket 16: (kernel, N, H, W, ic, oc, d, c, on the
# pinned plan); the pinned plan runs each kernel at one of them
MAIN_CASES = (
    ("fused_dot_layer", 16, 32, 128, 1, 8, 8, 6, True),
    ("fused_dot_layer", 16, 32, 128, 8, 8, 8, 6, False),
    ("fused_dot_layer", 16, 32, 128, 8, 4, 6, 4, False),
    ("conv1_layer", 16, 32, 128, 8, 8, 8, 6, True),
    ("packed_dot_layer", 16, 32, 128, 8, 4, 6, 4, True),
)
# the quickstart layers' shift (``ConvLayerSpec.shift``), at which the
# requantizing entries are timed
SERVE_SHIFT = 7
# (d, c) edge grid, run at (2, 16, 24, ic=40) and (2, 16, 23, 3) → oc=5
EDGE_BITS = ((3, 3), (3, 8), (6, 6), (8, 8), (9, 8), (8, 9), (16, 16),
             (12, 16), (16, 12))
REPLACES = {
    "conv1_layer": "src/repro/kernels/conv2d.py:75",
    "fused_dot_layer": "src/repro/blocks/base.py:245",
    "packed_dot_layer": "src/repro/blocks/base.py:261",
    "conv2_planes": "src/repro/kernels/conv2d.py:107",
    "conv3_planes": "src/repro/kernels/conv2d.py:119",
    "conv4_planes": "src/repro/kernels/conv2d.py:146",
    "causal_conv1d": "src/repro/kernels/conv1d.py:30",
    "flash_attention": "src/repro/kernels/flash_attention.py:65",
}
# plane-kernel cases at the quickstart layers (1→8, 8→8, 8→4 channels,
# 32×128): (kernel, P, d, c, on the own v5e plan's path); P is out_ch ·
# in_ch for conv2 and channel pairs · in_ch for conv3/conv4 in the
# single-image ``plane_layer``, and 1 in ``cnn_forward_loop``, which makes
# nearly all of the plane kernels' launches (one per plane)
PLANE_CASES = (
    ("conv2_planes", 1, 8, 6, False),
    ("conv2_planes", 8, 8, 6, True), ("conv2_planes", 64, 8, 6, False),
    ("conv2_planes", 32, 6, 4, False),
    ("conv3_planes", 1, 8, 6, False), ("conv3_planes", 1, 6, 4, False),
    ("conv3_planes", 4, 8, 6, False), ("conv3_planes", 32, 8, 6, True),
    ("conv3_planes", 16, 6, 4, False),
    ("conv4_planes", 1, 8, 6, False), ("conv4_planes", 1, 6, 4, False),
    ("conv4_planes", 4, 8, 6, False), ("conv4_planes", 32, 8, 6, False),
    ("conv4_planes", 16, 6, 4, True),
)
# the launches of one served forward of each committed plan, by entry:
# K1 and K2 only through their requantizing entries
SERVE_LAUNCHES = {
    UNPINNED: {"fused_dot_layer_requant": 3},
    PINNED: {"fused_dot_layer_requant": 1, "conv1_layer": 1,
             "packed_dot_layer_requant": 1},
}
# the pins of the planned variant that runs conv2 (K4) and conv1 (K3)
PINNED_PLAN_PINS = {0: "conv2", 1: "conv1", 2: "conv3"}
# cnn_forward_loop of that variant: images, and the seed of its images
# and weights
PINNED_LOOP_IMAGES, PINNED_LOOP_SEED = 4, 18
SERVED_FROM_OWN_PLAN = 16
# the gateway phase: seeded sample inputs per plan beside the 8 golden
# images, and the launcher's --async runs on each plan (4,096 Poisson
# arrivals each, --max-pending 32)
GATEWAY_SAMPLES, GATEWAY_SEED = 64, 19
GATEWAY_REQUESTS, GATEWAY_MAX_PENDING = 4096, 32
# of each --async run, the served outputs of every 16th request are held
# against cnn_forward_ref on the CPU (up to 256 per run)
GATEWAY_KEEP_EVERY = 16
GATEWAY_RUNS = (("occupancy 0.8", ("--occupancy", "0.8")),
                ("occupancy 2.0", ("--occupancy", "2.0")),
                ("deadline 2 ms", ("--occupancy", "2.0", "--deadline-ms",
                                   "2", "--wait-budget-ms", "5")))
# the fleet phase: the launcher's --fleet (edge0, v5e0, v5p0 on their own
# plans, one fresh --cache-dir shared by the three gateways and the four
# runs) under each router and once more with --drain; 4,096 tiered
# Poisson arrivals (--seed 1) at occupancy 1.0, --max-pending 32; the
# served outputs of every 16th request held against cnn_forward_ref on
# the CPU with the serving worker's plan and weights
FLEET_REQUESTS, FLEET_SEED, FLEET_KEEP_EVERY = 4096, 1, 16
FLEET_RUNS = (("plan_aware", ()), ("least_loaded", ()),
              ("round_robin", ()), ("plan_aware", ("--drain",)))
# the recovery phase: workers a and b from respawn_gateway over a fresh
# StoreRoot holding the pinned plan under plan id "cnn"; a seeded fault
# plan crashes a at its first dispatch; 256 requests; then a warm start
# in a fresh process (worker c) on 16 seeded images
RECOVERY_REQUESTS, RECOVERY_FAULT_SEED, RECOVERY_MAX_PENDING = 256, 42, 64
WARM_IMAGES, WARM_SEED = 16, 23
RECOVERY_PLAN_ID = "cnn"

LM_GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "lm_reference.npz"
LM_ARCHS = ("llama3.2-3b", "mamba2-1.3b")
LM_GOLDEN_TOL = 2e-3             # the reference's decode/prefill bound
LM_REQUESTS, LM_PROMPT, LM_NEW, LM_MAX_BATCH = 8, 512, 32, 4
LM_PROFILED_STEPS = 16
# the kernel-vs-plain check at full width: 4 layers, a prompt that is a
# multiple of neither attention tile (32 rows, 64 keys)
LM_CUT_LAYERS, LM_CUT_PROMPT = 4, 100
LM_CUT_REL_L2 = 5e-2
# K7's design: the x, B and C convs of a Mamba layer are three launches,
# in prefill and in each decode step
K7_PER_MAMBA_LAYER = 3
# K8 against its plain version in bf16: the split P keeps the two float32
# results within about 2^-16 relative, so the bf16 outputs are at most one
# bf16 unit apart
K8_BF16_TOL = dict(rtol=2 ** -7, atol=1e-3)
# K8's float32 instantiation against its plain version: the same blocked
# online softmax, products summed in another order
K8_F32_TOL = dict(rtol=2e-5, atol=2e-5)
# the numbers of a timed case that its kernel's headline entry carries
TIMES = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
         "library_ms", "library_device_ms")


def sass_tensor_ops(name: str):
    """How many tensor-core instructions (HMMA or HGMMA) the built
    library of kernel ``name`` holds, from ``cuobjdump -sass``; None
    where the toolkit has no cuobjdump or it fails (not measured)."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        return None
    return sum(op in line for line in out.stdout.splitlines()
               for op in ("HMMA", "HGMMA"))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


@functools.lru_cache(maxsize=None)
def int32_rate() -> float:
    """Integer operations per second of the CUDA cores: SMs × 64 INT32
    lanes × 2 operations (multiply-add) × the maximum SM clock, as the
    card reports them."""
    import torch
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * 2 * mhz * 1e6


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


def device_ms(fn, kernel_name: str | None = None, iters: int = 50):
    """Mean device time per call of the CUDA kernels whose name holds
    ``kernel_name`` (of every kernel the calls launch where it is None:
    a library call's own device time), from a ``torch.profiler`` trace
    of ``iters`` calls: the kernels alone, without the host's launch
    cost that the CUDA-event time of back-to-back calls includes.  None
    when the trace holds no device time for them (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.events()
                   if e.device_type != DeviceType.CPU
                   and (kernel_name is None or kernel_name in e.name))
    return total_us / iters / 1e3 if total_us else None


def bound(x, wk, d, c, out_itemsize=4):
    """(bound_ms, bound_by): the larger of the bytes the layer must move
    (x and w read once, the output written once: the int32 accumulator,
    or for a requantizing entry (``out_itemsize`` 1 or 2) the next
    layer's container) over the memory rate and the operations its
    function needs over the peak rate of their type.  All three kernels
    compute a 3x3 convolution of in_ch into out_ch (the shift-adds and
    the packing are how the reference computes it, not what it
    computes): a multiply and an add per tap, input channel and output,
    at the int8 rate where ``_dot_dtype`` takes int8 operands, else at
    the CUDA-core rate (``int32_rate``)."""
    n, h, w, ic = x.shape
    oc = wk.shape[0]
    pix = n * h * w
    nbytes = (x.numel() * x.element_size() + wk.numel() * wk.element_size()
              + pix * oc * out_itemsize)
    return _bound(nbytes, 2 * pix * oc * ic * 9, d, c)


def plane_bound(x, wk, n_out, d, c):
    """(bound_ms, bound_by) of a plane kernel: x (P, H, W) and w read
    once, the int32 output (P, n_out, H, W) written once; ``n_out``
    3x3 convolutions per plane (Conv3's packing is how the reference
    computes its two), a multiply and an add per tap, at the rate of
    ``_dot_dtype``'s operands."""
    pix = x.numel()
    nbytes = (x.numel() * x.element_size() + wk.numel() * wk.element_size()
              + pix * n_out * 4)
    return _bound(nbytes, 2 * pix * n_out * 9, d, c)


def _bound(nbytes, ops, d, c):
    import torch
    from repro_torch.kernels.conv2d import _dot_dtype
    rate = INT8_OPS_PER_S if _dot_dtype(d, c) == torch.int8 \
        else int32_rate()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_conv(x, wk):
    """(ms, device_ms, output) of one cuDNN float32 convolution of the
    same layer (TF32 off), which is exact at these widths: the
    yardstick, never called by the port."""
    import torch
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    xf = x.permute(0, 3, 1, 2).float().contiguous()
    wf = wk.float().contiguous()

    def conv():
        return F.conv2d(xf, wf, padding=1)
    return time_ms(conv, 200, warmup=10), device_ms(conv), conv()


def library_conv_requant(x, wk, shift, d):
    """(ms, device_ms) of the same function as a requantizing entry from
    library calls: the cuDNN convolution of ``library_conv``, then the
    torch shift, clamp, cast and channels-last copy (``requantize``).
    Timed here only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d import requantize
    xf = x.permute(0, 3, 1, 2).float().contiguous()
    wf = wk.float().contiguous()

    def conv():
        return requantize(F.conv2d(xf, wf, padding=1).to(torch.int32),
                          shift, d)
    return time_ms(conv, 200, warmup=10), device_ms(conv)


def device_name(name, d, c):
    """The device kernel an entry launches at d, c: K1's is
    ``fused_dp4a_kernel`` or ``fused_imad_kernel`` by its route."""
    from repro_torch.blocks import base
    if name == "fused_dot_layer":
        return f"fused_{base.fused_dot_route(d, c)}_kernel"
    return f"{name}_kernel"


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
    requant = {
        "fused_dot_layer": (base.fused_dot_layer_requant,
                            base.fused_dot_layer_requant_plain),
        "packed_dot_layer": (base.packed_dot_layer_requant,
                             base.packed_dot_layer_requant_plain),
    }
    entries = {k: kernel_entry(k) for k in wrappers}
    compare = _comparer(entries, wrappers)
    rng = np.random.default_rng(0)

    def compare_requant(name, label, x, wk, d, c, shift, **kw):
        kern, plain = requant[name]
        args = dict(data_bits=d, coeff_bits=c, shift=shift, out_bits=d)
        y = kern(x, wk, **args, **kw)
        torch.cuda.synchronize()
        y_plain = plain(x, wk, **args)
        err = int((y.to(torch.int64) - y_plain.to(torch.int64)).abs()
                  .max()) if y.numel() else 0
        eq = torch.equal(y, y_plain)
        print(f"  {name + '_requant':24s} {label:34s} shift={shift} "
              f"equal={eq} max_abs_err={err}")
        if not eq:
            raise AssertionError(f"{name}_requant disagrees with its plain "
                                 f"version at {label}, shift {shift}: "
                                 f"max_abs_err={err}")
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"],
                                           err)

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
                           device_name(name, d, c))
        lib_ms, lib_dev_ms, y_lib = library_conv(x, wk)
        lib_eq = torch.equal(y_lib.to(torch.int32), y)
        b_ms, b_by = bound(x, wk, d, c)
        case = {"shape": [n, h, w, ic], "oc": oc, "d": d, "c": c,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms, "library_equal": lib_eq}
        print(f"    ms={ms:.6f} device_ms={dev_ms} plain_ms={plain_ms:.6f} "
              f"bound_ms={b_ms:.6f} ({b_by}) library_ms={lib_ms:.6f} "
              f"library_device_ms={lib_dev_ms} library_equal={lib_eq}")
        entries[name]["cases"].append(case)
        if pinned:
            entries[name].update({k: case[k] for k in TIMES})
            entries[name]["shape"] = case["shape"] + [oc]
        if name not in requant:
            continue
        # the requantizing entry, as LayerLaunch runs it
        kern_r, plain_r = requant[name]
        args = dict(data_bits=d, coeff_bits=c, shift=SERVE_SHIFT, out_bits=d)
        compare_requant(name, label, x, wk, d, c, SERVE_SHIFT)
        ms = time_ms(lambda: kern_r(x, wk, **args), 200, warmup=10)
        plain_ms = time_ms(lambda: plain_r(x, wk, **args), 5, warmup=1)
        dev_ms = device_ms(lambda: kern_r(x, wk, **args),
                           device_name(name, d, c))
        lib_ms, lib_dev_ms = library_conv_requant(x, wk, SERVE_SHIFT, d)
        b_ms, b_by = bound(x, wk, d, c,
                           conv2d.container_dtype(d).itemsize)
        rcase = {"shape": [n, h, w, ic], "oc": oc, "d": d, "c": c,
                 "shift": SERVE_SHIFT, "ms": ms, "device_ms": dev_ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib_ms, "library_device_ms": lib_dev_ms}
        print(f"    requant: ms={ms:.6f} device_ms={dev_ms} "
              f"plain_ms={plain_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
              f"library_ms={lib_ms:.6f} library_device_ms={lib_dev_ms}")
        entries[name].setdefault("requant_cases", []).append(rcase)
        if pinned:
            entries[name]["requant"] = {k: rcase[k] for k in TIMES} | {
                "shape": case["shape"] + [oc]}
        if name == "fused_dot_layer":
            case["dot_route"] = base.fused_dot_route(d, c)
            print(f"    K1 route at {label}: {case['dot_route']}")

    print("[kernels] edge grid: (2, 16, 24, ic=40) -> oc=5, full signed "
          "ranges with the extremes, and the unaligned (2, 16, 23, 3) -> 5")
    for d, c in EDGE_BITS:
        for shape in ((2, 16, 24, 40), (2, 16, 23, 3)):
            x, wk = operands(rng, *shape, 5, d, c)
            for name in wrappers:
                label = f"{tuple(shape)} d{d}c{c}"
                if name == "packed_dot_layer" and conv2d._pack_shift(d, c) \
                        > conv2d.PACK_SHIFT_BUDGET:
                    try:
                        base.packed_dot_layer(x, wk, data_bits=d,
                                              coeff_bits=c)
                    except ValueError:
                        print(f"  {name:17s} {label}: refused (pack shift "
                              f"exceeds 31 bits), as the reference raises")
                        continue
                    raise AssertionError(f"{name} took d{d}c{c}")
                compare(name, label, x, wk, d, c)
                if name in requant:
                    for shift in (0, 40):
                        compare_requant(name, label, x, wk, d, c, shift)
    # int16 inputs over the whole container at d=3: the Conv1 plane
    # accumulator is int16 there and wraps as the reference's does
    x, wk = operands(rng, 2, 16, 24, 40, 5, 3, 8, x_range=(-32768, 32767))
    for name in wrappers:
        compare(name, "d3c8 container-range x (int16)", x, wk, 3, 8)
        if name in requant:
            compare_requant(name, "d3c8 container-range x (int16)", x, wk,
                            3, 8, SERVE_SHIFT)
    return entries


def plane_operands(rng, p, h, w, d, c, n_out, *, x_range=None):
    """P planes over the full signed d-bit range (or ``x_range``, then
    in an int16 container) and their weights over the full c-bit
    range, extremes forced in, on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels.conv2d import container_dtype
    lo, hi = x_range or (-(1 << (d - 1)), (1 << (d - 1)) - 1)
    x = rng.integers(lo, hi + 1, (p, h, w))
    x.reshape(-1)[:2] = (lo, hi)
    wshape = (p, 3, 3) if n_out == 1 else (p, n_out, 3, 3)
    wk = rng.integers(-(1 << (c - 1)), 1 << (c - 1), wshape)
    wk.reshape(-1)[:2] = (-(1 << (c - 1)), (1 << (c - 1)) - 1)
    xdt = torch.int16 if x_range else container_dtype(d)
    return (torch.from_numpy(x).to(xdt).cuda(),
            torch.from_numpy(wk).to(container_dtype(c)).cuda())


def library_planes(x, wk, n_out):
    """(ms, device_ms, output) of one grouped cuDNN float32 convolution
    of the same planes (groups = P, TF32 off), exact at the timed
    widths: the yardstick, never called by the port."""
    import torch
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    p, h, w = x.shape
    xf = x.float()[None].contiguous()
    wf = wk.float().reshape(p * n_out, 1, 3, 3).contiguous()

    def conv():
        return F.conv2d(xf, wf, padding=1, groups=p)
    y = conv()[0].reshape((p, n_out, h, w) if n_out > 1 else (p, h, w))
    return time_ms(conv, 200, warmup=10), device_ms(conv), y


def _comparer(entries, wrappers):
    """compare(name, label, x, wk, d, c): one kernel call against its
    plain version on the same card tensors, tolerance 0; raises on a
    mismatch and keeps the largest error in the kernel's entry."""
    import torch

    def compare(name, label, x, wk, d, c):
        kern, plain = wrappers[name][:2]
        y = kern(x, wk, data_bits=d, coeff_bits=c)
        torch.cuda.synchronize()
        y_plain = plain(x, wk, data_bits=d, coeff_bits=c)
        err = int((y.to(torch.int64) - y_plain.to(torch.int64)).abs()
                  .max()) if y.numel() else 0
        eq = torch.equal(y, y_plain)
        print(f"  {name:17s} {label:34s} equal={eq} max_abs_err={err}")
        if not eq:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {label}: max_abs_err={err}")
        e = entries[name]
        e["max_abs_err"] = max(e["max_abs_err"], err)
        return y
    return compare


def kernel_entry(name):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "max_abs_err": 0, "equal": True,
            "cases": [], "launches": 0}


def check_plane_kernels():
    """Phase 4.  Returns {kernel: entry} for the kernels line."""
    import numpy as np
    import torch
    from repro_torch.blocks import get_block
    from repro_torch.kernels import conv2d

    wrappers = {
        "conv2_planes": (conv2d.conv2_planes, conv2d.conv2_planes_plain, 1),
        "conv3_planes": (conv2d.conv3_planes, conv2d.conv3_planes_plain, 2),
        "conv4_planes": (conv2d.conv4_planes, conv2d.conv4_planes_plain, 2),
    }
    entries = {k: kernel_entry(k) for k in wrappers}
    compare = _comparer(entries, wrappers)
    rng = np.random.default_rng(1)

    print("[planes] P = 1 on 32x128, against the plain versions "
          "(tolerance 0)")
    for name, (_, _, n_out) in wrappers.items():
        for d, c in ((8, 6), (6, 6), (16, 16)):
            x, wk = plane_operands(rng, 1, 32, 128, d, c, n_out)
            compare(name, f"P=1 (32,128) d{d}c{c}", x, wk, d, c)

    print("[planes] planes that fit no tile: P=3 on (17, 33), P=4 on "
          "(1, 1), and P=300 on (16, 24)")
    for name, (_, _, n_out) in wrappers.items():
        for p, h, w in ((3, 17, 33), (4, 1, 1), (300, 16, 24)):
            for d, c in ((8, 6), (6, 4), (16, 16)):
                x, wk = plane_operands(rng, p, h, w, d, c, n_out)
                compare(name, f"P={p} ({h},{w}) d{d}c{c}", x, wk, d, c)

    print("[planes] the quickstart layers' plane counts on 32x128, timed")
    for name, p, d, c, on_plan in PLANE_CASES:
        kern, plain, n_out = wrappers[name]
        x, wk = plane_operands(rng, p, 32, 128, d, c, n_out)
        y = compare(name, f"P={p} (32,128) d{d}c{c}", x, wk, d, c)
        ms = time_ms(lambda: kern(x, wk, data_bits=d, coeff_bits=c), 200,
                     warmup=10)
        plain_ms = time_ms(lambda: plain(x, wk, data_bits=d, coeff_bits=c),
                           5, warmup=1)
        dev_ms = device_ms(lambda: kern(x, wk, data_bits=d, coeff_bits=c),
                           f"{name}_kernel")
        lib_ms, lib_dev_ms, y_lib = library_planes(x, wk, n_out)
        lib_eq = torch.equal(y_lib.to(torch.int32), y)
        b_ms, b_by = plane_bound(x, wk, n_out, d, c)
        case = {"shape": [p, 32, 128], "d": d, "c": c, "ms": ms,
                "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms, "library_equal": lib_eq}
        print(f"    ms={ms:.6f} device_ms={dev_ms} plain_ms={plain_ms:.6f} "
              f"bound_ms={b_ms:.6f} ({b_by}) library_ms={lib_ms:.6f} "
              f"library_device_ms={lib_dev_ms} library_equal={lib_eq}")
        entries[name]["cases"].append(case)
        if on_plan:
            entries[name].update({k: case[k] for k in TIMES})
            entries[name]["shape"] = case["shape"]

    print("[planes] edge grid: P=5 on (16, 24), full signed ranges with "
          "the extremes, and int16 container-range inputs")
    for d, c in EDGE_BITS + ((6, 7), (7, 6), (5, 3)):
        for name, (_, _, n_out) in wrappers.items():
            x, wk = plane_operands(rng, 5, 16, 24, d, c, n_out)
            compare(name, f"P=5 d{d}c{c}", x, wk, d, c)
    for name, (_, _, n_out) in wrappers.items():
        for d, c in ((3, 8), (6, 6)):
            x, wk = plane_operands(rng, 5, 16, 24, d, c, n_out,
                                   x_range=(-32768, 32767))
            compare(name, f"d{d}c{c} container-range x (int16)", x, wk, d,
                    c)

    print("[planes] ConvBlock.apply on the card against the JAX "
          "reference's golden apply outputs")
    with np.load(GOLDEN) as z:
        keys = sorted({k.rsplit(".", 1)[0] for k in z.files
                       if k.startswith("apply.")})
        for key in keys:
            _, block, bits = key.split(".")
            d, c = (int(v) for v in bits[1:].split("c"))
            y = get_block(block).apply(
                torch.from_numpy(z[f"{key}.x"]).cuda(),
                torch.from_numpy(z[f"{key}.w"]).cuda(), data_bits=d,
                coeff_bits=c)
            if not np.array_equal(y.cpu().numpy(), z[f"{key}.y"]):
                raise AssertionError(f"{key}: apply on the card differs "
                                     f"from the JAX golden")
    print(f"  {len(keys)} golden apply outputs equal (tolerance 0)")
    return entries


def serve_args(stem, requests):
    from repro_torch.launch import serve
    return serve.parse_args([
        "--workload", "cnn", "--plan", str(PLANS / f"{stem}.json"),
        "--params", str(GOLDEN), "--requests", str(requests),
        "--max-batch", str(MAX_BATCH), "--torch-device", "cuda"])


def serve_plans(entries):
    """Phase 5: both committed plans through the launcher's code path.

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
    from repro_torch.core import deploy
    from repro_torch.core.cnn import cnn_forward_ref
    from repro_torch.launch import serve
    from repro_torch.runtime import load_plan

    golden = np.load(GOLDEN)
    for stem in (UNPINNED, PINNED):
        serve.run_cnn(serve_args(stem, REQUESTS))          # warm-up pass
        # each layer's launch per forward, and none through the int32
        # entries of K1 and K2: their layers run the requantizing ones
        per_forward = SERVE_LAUNCHES[stem]
        engine, reqs, _ = drive(
            entries, f"serve {stem}", set(per_forward),
            lambda: serve.run_cnn(serve_args(stem, REQUESTS)))
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
        got = LAUNCHES[f"serve {stem}"]
        for k, v in got.items():
            if v != per_forward.get(k, 0) * forwards:
                raise AssertionError(
                    f"{stem}: {k} launched {v} times in {forwards} forwards, "
                    f"want {per_forward.get(k, 0)} per forward")
        print(f"[serve] {stem}: {forwards} forwards; {len(reqs)} outputs "
              f"equal cnn_forward_ref (CPU), the first 8 equal the JAX "
              f"golden")

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
    by_name, ops, torch_ops = {}, 0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CPU and e.device_time_total > 0:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            ops += 1
            torch_ops += "at::native" in e.name
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
              "device_ops_per_step": ops / steps,
              "torch_kernels_per_step": torch_ops / steps,
              "top_ms_per_step": [[k[:80], v / 1e3 / steps]
                                  for k, v in top]}
    print(f"[profile] {stem}: {busy_ms:.6f} ms of device time per step "
          f"against {wall_ms:.6f} ms of wall time per step (untraced): "
          f"idle share {result['idle_share']:.4f}; "
          f"{result['device_ops_per_step']} device ops per step, "
          f"{result['torch_kernels_per_step']} of them torch kernels")
    for k, v in result["top_ms_per_step"]:
        print(f"  {v:.6f} ms/step  {k}")
    return result


# every path's launches by entry, as ``drive`` read them
LAUNCHES = {}


def counters():
    """Every kernel wrapper of the port, by entry name."""
    from repro_torch.blocks import base
    from repro_torch.kernels import conv1d, conv2d, flash_attention
    return {"conv1_layer": conv2d.conv1_layer,
            "fused_dot_layer": base.fused_dot_layer,
            "fused_dot_layer_requant": base.fused_dot_layer_requant,
            "packed_dot_layer": base.packed_dot_layer,
            "packed_dot_layer_requant": base.packed_dot_layer_requant,
            "conv2_planes": conv2d.conv2_planes,
            "conv3_planes": conv2d.conv3_planes,
            "conv4_planes": conv2d.conv4_planes,
            "causal_conv1d": conv1d.causal_conv1d,
            "flash_attention": flash_attention.flash_attention}


def drive(entries, label, want, fn):
    """Run one path ``fn()`` with every launch counter set to 0 just
    before it and read just after; fail if an entry in ``want`` was not
    launched; add the counts to the kernels' entries (a kernel's
    launches are those of all its entries, ``launches_by_entry`` keeps
    them apart).  Returns what ``fn`` returns."""
    from repro_torch.kernels import build
    fns = counters()
    for f in fns.values():
        f.launches = 0
    out = fn()
    launches = {k: f.launches for k, f in fns.items()}
    missing = sorted(k for k in want if launches[k] < 1)
    if missing:
        raise AssertionError(f"{label}: {missing} never launched "
                             f"({launches})")
    LAUNCHES[label] = launches
    for k, v in launches.items():
        kern = build.library_of(k)
        e = entries.setdefault(kern, kernel_entry(kern))
        e["launches"] += v
        by_path = e.setdefault("launches_by_path", {})
        by_path[label] = by_path.get(label, 0) + v
        if kern in build.ENTRIES.values():
            e.setdefault("launches_by_entry", {}).setdefault(label, {})[k] = v
    print(f"[{label}] launches {launches}")
    return out


# the kernel each block runs on the per-plane path
PLANE_KERNEL_OF = {"conv1": "conv1_layer", "conv2": "conv2_planes",
                   "conv3": "conv3_planes", "conv4": "conv4_planes"}


def per_plane_forwards(entries):
    """Phase 6: ``cnn_forward_loop`` and the single-image ``cnn_forward``
    of both committed plans, golden weights, every golden image."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core import cnn, deploy
    from repro_torch.runtime import load_plan

    with np.load(GOLDEN) as golden:
        for stem in (UNPINNED, PINNED):
            plan = load_plan(PLANS / f"{stem}.json")
            pcfg = deploy.plan_config(plan)
            params = convert.params_from_numpy(
                [golden[f"{stem}.w{i}"] for i in range(len(pcfg.layers))],
                pcfg, "cuda")
            gx, gy = golden[f"{stem}.x"], golden[f"{stem}.y"]
            want = {PLANE_KERNEL_OF[b] for b in plan.block_names()}
            for fwd in (cnn.cnn_forward_loop, cnn.cnn_forward):
                def run():
                    t0 = time.perf_counter()
                    ys = np.stack([fwd(params, torch.from_numpy(x).cuda(),
                                       pcfg, plan.block_names()).cpu()
                                   .numpy() for x in gx])
                    return ys, time.perf_counter() - t0
                ys, dt = drive(entries, f"{fwd.__name__} {stem}", want, run)
                if not np.array_equal(ys, gy):
                    raise AssertionError(f"{stem}: {fwd.__name__} differs "
                                         f"from the JAX golden")
                print(f"  {fwd.__name__} {stem}: {len(gx)} images equal the "
                      f"JAX golden, {dt * 1e3 / len(gx):.3f} ms per image")


def plan_on_card(entries):
    """Phase 7: the launcher's default path — the port's own sweep, a
    v5e plan, ``validate_plan`` on the card, then serving from the plan.
    Returns the numbers for the kernels line."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import allocate, cnn, deploy, synth
    from repro_torch.launch import serve

    args = serve.parse_args([
        "--workload", "cnn", "--device", "v5e", "--requests",
        str(SERVED_FROM_OWN_PLAN), "--max-batch", str(MAX_BATCH),
        "--torch-device", "cuda"])

    def run():
        t0 = time.perf_counter()
        rows = synth.run_sweep(force=True)
        sweep_s = time.perf_counter() - t0
        print(f"[plan] the port's own sweep: {len(rows)} design points in "
              f"{sweep_s:.3f} s (op census on meta tensors, host CPU)")
        cnn.clear_fitted_model_cache()
        plan = serve.cnn_plan(args)
        print(f"[plan] {plan.to_json(indent=None)}")
        cfg = plan.cnn
        pins = tuple(dataclasses.replace(s, block=PINNED_PLAN_PINS[i])
                     for i, s in enumerate(cfg.layers))
        pinned = deploy.plan_deployment(
            dataclasses.replace(cfg, layers=pins), cnn.fitted_block_models(),
            allocate.get_device("v5e"), target=0.8, on_infeasible="fallback")
        vals = {}
        for label, p in (("v5e", plan), ("v5e pinned", pinned)):
            t0 = time.perf_counter()
            val = deploy.validate_plan(p, p.cnn, device="cuda")
            mape = {r: m["mape_pct"] for r, m in val.metrics.items()}
            vals[label] = {"blocks": p.block_names(), "bits": p.bits(),
                           "bit_exact": val.bit_exact, "mape_pct": mape,
                           "quant_error": val.quant_error,
                           "seconds": time.perf_counter() - t0}
            print(f"[plan] validate_plan {label} "
                  f"{list(zip(p.block_names(), p.bits()))}: bit_exact="
                  f"{val.bit_exact} mape_pct={mape}")
            if not val.bit_exact:
                raise AssertionError(f"{label}: the forward on the card "
                                     f"differs from cnn_forward_ref")
        # the reference's gate holds the planned (unpinned) plan; the
        # pinned variant's Conv1 layer is reported, not gated
        bad = {r: m for r, m in vals["v5e"]["mape_pct"].items() if m >= 2.0}
        if bad:
            raise AssertionError(f"v5e plan: MAPE >= 2 % on {bad}")
        engine, reqs, dt = serve.run_cnn(args)
        xs = torch.from_numpy(np.stack([r.image for r in reqs]))
        ys = np.stack([r.output for r in reqs])
        y_ref = cnn.cnn_forward_ref([w.cpu() for w in engine.compiled.params],
                                    xs, engine.cfg).numpy()
        if not (all(r.done for r in reqs) and np.array_equal(ys, y_ref)):
            raise AssertionError("serving the own plan: outputs differ from "
                                 "cnn_forward_ref on the CPU")
        print(f"[plan] served {len(reqs)} requests from the own plan; "
              f"outputs equal cnn_forward_ref (CPU)")
        return {"sweep_seconds": sweep_s, "plan": plan.block_names(),
                "bits": plan.bits(), "validate": vals}, pinned

    want = {"conv1_layer", "conv2_planes", "conv3_planes", "conv4_planes",
            "fused_dot_layer_requant"}
    planned, pinned = drive(entries, "plan on the card", want, run)
    planned["pinned_loop"] = pinned_loop(entries, pinned)
    return planned


def pinned_loop(entries, plan):
    """Phase 7, last: ``cnn_forward_loop`` of the conv2-pinned ``plan``
    on PINNED_LOOP_IMAGES images on the card against ``cnn_forward_ref``
    on the CPU, with its own launch counts: K4 once per Conv2 plane (P =
    1) of every image."""
    import numpy as np
    import torch
    from repro_torch.core import cnn, deploy
    from repro_torch.kernels import ops

    pcfg = deploy.plan_config(plan)
    blocks = plan.block_names()
    params = cnn.init_cnn(torch.Generator().manual_seed(PINNED_LOOP_SEED),
                          pcfg)
    d0 = pcfg.layers[0].data_bits
    xs = ops.quantize_fixed(torch.from_numpy(
        np.random.default_rng(PINNED_LOOP_SEED).integers(
            0, 1 << (d0 - 1), (PINNED_LOOP_IMAGES, pcfg.img_h, pcfg.img_w,
                               pcfg.layers[0].in_channels))
        .astype(np.float32)), d0)
    on_card = [w.cuda() for w in params]

    def run():
        t0 = time.perf_counter()
        ys = torch.stack([cnn.cnn_forward_loop(on_card, x.cuda(), pcfg,
                                               blocks).cpu() for x in xs])
        return ys, time.perf_counter() - t0
    label = "cnn_forward_loop v5e pinned"
    ys, dt = drive(entries, label, {PLANE_KERNEL_OF[b] for b in blocks}, run)
    if not torch.equal(ys, cnn.cnn_forward_ref(params, xs, pcfg)):
        raise AssertionError(f"{label}: differs from cnn_forward_ref on the "
                             f"CPU")
    k4 = LAUNCHES[label]["conv2_planes"]
    planes = PINNED_LOOP_IMAGES * sum(
        s.out_channels * s.in_channels for s in pcfg.layers
        if s.block == "conv2")
    if k4 != planes:
        raise AssertionError(f"{label}: conv2_planes launched {k4} times, "
                             f"want one per Conv2 plane ({planes})")
    res = {"blocks": blocks, "bits": plan.bits(),
           "images": PINNED_LOOP_IMAGES, "conv2_planes_launches": k4,
           "ms_per_image": dt * 1e3 / PINNED_LOOP_IMAGES}
    print(f"[plan] {label} {list(zip(blocks, plan.bits()))}: "
          f"{PINNED_LOOP_IMAGES} images equal cnn_forward_ref (CPU), "
          f"{res['ms_per_image']:.3f} ms per image, conv2_planes launched "
          f"{k4} times (P = 1)")
    return res


def _check_serve_launches(label, forwards):
    """Each plan's forwards (``{stem: n}``) launched their entries
    SERVE_LAUNCHES times per forward, and nothing else."""
    got = LAUNCHES[label]
    for k, v in got.items():
        want = sum(SERVE_LAUNCHES[stem].get(k, 0) * n
                   for stem, n in forwards.items())
        if v != want:
            raise AssertionError(
                f"{label}: {k} launched {v} times in {forwards} forwards, "
                f"want {want}")


def forward_in_threads(model, xb, reps=10):
    """Median ms of one full-batch forward with its copy to the host,
    run in this thread, in a worker thread while this one waits, and in
    a worker thread while this one runs Python, as the gateway's event
    loop does under load: what sharing the interpreter costs the
    gateway's ``forward`` stage."""
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    def once():
        t0 = time.perf_counter()
        model(xb).cpu()
        return time.perf_counter() - t0

    def spun(ex):
        fut = ex.submit(once)
        while not fut.done():
            pass
        return fut.result()

    with ThreadPoolExecutor(1) as ex:
        ex.submit(once).result()
        runs = {"main": lambda: once(),
                "worker_main_waits": lambda: ex.submit(once).result(),
                "worker_main_spins": lambda: spun(ex)}
        return {k: statistics.median(f() for _ in range(reps)) * 1e3
                for k, f in runs.items()}


class GCTimes:
    """Collections of the cyclic garbage collector while the context is
    open: per generation, how many and their longest and total ms (a
    collection holds the interpreter, so it stalls both of the
    gateway's threads)."""

    def __enter__(self):
        import gc
        self.log, self._t0 = [], 0.0
        gc.callbacks.append(self._on_gc)
        return self

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.log.append((info["generation"],
                             (time.perf_counter() - self._t0) * 1e3))

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._on_gc)

    def summary(self):
        out = {}
        for gen, ms in self.log:
            g = out.setdefault(gen, {"n": 0, "max_ms": 0.0, "total_ms": 0.0})
            g["n"] += 1
            g["max_ms"] = max(g["max_ms"], ms)
            g["total_ms"] += ms
        return out


def gateway_on_card(entries, smi):
    """Phase 8: the async gateway on the card.  Both committed plans in
    one ``AsyncCNNGateway`` sharing one ``ExecutableCache``, golden
    weights; the golden images and seeded samples of both plans,
    interleaved through ``submit``; an abort after layer 0; then the
    launcher's ``run_cnn_async`` on each plan.  Returns the numbers for
    the JSON line."""
    import asyncio
    import numpy as np
    import torch
    from repro_torch.core import deploy
    from repro_torch.core.cnn import cnn_forward_ref
    from repro_torch.launch import serve
    from repro_torch.runtime import (DispatchAborted, ExecutableCache,
                                     load_plan)
    from repro_torch.runtime.compiled import dtype_name
    from repro_torch.serve import AsyncCNNGateway, AsyncServeConfig

    stems = (UNPINNED, PINNED)
    cache = ExecutableCache()
    gw = AsyncCNNGateway(AsyncServeConfig(max_batch=MAX_BATCH),
                         exec_cache=cache)
    for stem in stems:
        path = PLANS / f"{stem}.json"
        plan = load_plan(path)
        gw.register_plan(plan, plan_id=stem, device="cuda",
                         params=serve.load_params(
                             GOLDEN, path, deploy.plan_config(plan), "cuda"))
    compiled = {stem: gw.plans[stem].compiled for stem in stems}
    layer_keys = {stem: {c._layer_key(i, MAX_BATCH)[:-1]
                         for i in range(c.num_layers)}
                  for stem, c in compiled.items()}
    distinct = set().union(*layer_keys.values())
    buckets = compiled[UNPINNED].buckets
    if len(cache) != len(distinct) * len(buckets):
        raise AssertionError(
            f"gateway: the shared cache holds {len(cache)} prepared "
            f"launches, want {len(distinct)} distinct layers x "
            f"{len(buckets)} buckets")
    shared = set.intersection(*layer_keys.values())
    print(f"[gateway] one ExecutableCache for both plans: {len(cache)} "
          f"prepared launches = {len(distinct)} distinct layers x "
          f"{len(buckets)} buckets; {len(shared)} layer(s) prepared once "
          f"for both plans: {sorted(k[:6] for k in shared)}")

    with np.load(GOLDEN) as golden:
        gx = {stem: golden[f"{stem}.x"] for stem in stems}
        gy = {stem: golden[f"{stem}.y"] for stem in stems}
    xs = {stem: list(gx[stem]) + compiled[stem].sample_inputs(
        GATEWAY_SAMPLES, GATEWAY_SEED) for stem in stems}
    order = [(stem, k) for k in range(len(xs[UNPINNED])) for stem in stems]

    async def interleaved():
        async with gw:
            futs = [await gw.submit(xs[stem][k], plan_id=stem)
                    for stem, k in order]
            return await asyncio.gather(*futs)

    def run():
        t0 = time.perf_counter()
        outs = asyncio.run(interleaved())
        return outs, time.perf_counter() - t0
    label = "gateway both plans"
    want = set().union(*(SERVE_LAUNCHES[stem] for stem in stems))
    outs, dt = drive(entries, label, want, run)
    forwards = {stem: sum(c.bucket_hits.values())
                for stem, c in compiled.items()}
    _check_serve_launches(label, forwards)
    for stem in stems:
        ys = np.stack([o for (st, _), o in zip(order, outs) if st == stem])
        if not np.array_equal(ys[:len(gx[stem])], gy[stem]):
            raise AssertionError(f"gateway {stem}: outputs differ from the "
                                 f"JAX reference's golden")
        c = compiled[stem]
        y_ref = cnn_forward_ref([w.cpu() for w in c.params],
                                torch.from_numpy(np.stack(xs[stem])),
                                c.cfg).numpy()
        if not np.array_equal(ys, y_ref):
            raise AssertionError(f"gateway {stem}: outputs differ from "
                                 f"cnn_forward_ref on the CPU")
    stats = gw.stats()
    if stats["failed"] or stats["served"] != len(order):
        raise AssertionError(f"gateway: {stats['served']} of {len(order)} "
                             f"served, {stats['failed']} failed")
    print(f"[gateway] {len(order)} requests interleaved over both plans "
          f"through submit in {dt:.3f} s: every output equals "
          f"cnn_forward_ref (CPU), the golden images' the JAX golden; "
          f"forwards {forwards}, occupancy {stats['occupancy_hist']}")

    # abort on the card: the callback says stop at its second poll, so
    # only layer 0 (conv4 d8c6 1->8 on both plans: K1's requantizing
    # entry) was launched
    model = compiled[PINNED]
    if model.blocks[0].name != "conv4":
        raise AssertionError(f"{PINNED}: layer 0 is {model.blocks[0].name}")
    polls = []

    def abort():
        polls.append(1)
        return len(polls) >= 2

    def run_abort():
        try:
            model(gx[PINNED], should_abort=abort)
        except DispatchAborted:
            torch.cuda.synchronize()
            return True
        return False
    label = "gateway abort"
    if not drive(entries, label, {"fused_dot_layer_requant"}, run_abort):
        raise AssertionError("gateway abort: no DispatchAborted")
    launched = {k: v for k, v in LAUNCHES[label].items() if v}
    if launched != {"fused_dot_layer_requant": 1}:
        raise AssertionError(f"gateway abort: launched {launched}, want "
                             f"layer 0's one launch")
    print(f"[gateway] abort at the second poll: DispatchAborted after "
          f"{launched}")

    # the forward stage in and out of a worker thread, at bucket 16
    threads = {}
    for stem in stems:
        np_dtype = np.dtype(dtype_name(compiled[stem].in_dtype))
        xb = torch.from_numpy(np.stack([np.asarray(x, np_dtype)
                                        for x in xs[stem][:MAX_BATCH]]))
        threads[stem] = forward_in_threads(compiled[stem], xb)
        print(f"[gateway] {stem} full-batch forward + copy to the host, "
              f"median ms: " + ", ".join(f"{k} {v:.6f}"
                                         for k, v in threads[stem].items())
              + f" on {smi}")
    import gc
    print(f"[gateway] {len(gc.get_objects())} objects tracked by the "
          f"garbage collector before the --async runs")

    runs = {}
    for stem in stems:
        for name, flags in GATEWAY_RUNS:
            args = serve.parse_args([
                "--workload", "cnn", "--async", "--plan",
                str(PLANS / f"{stem}.json"), "--params", str(GOLDEN),
                "--requests", str(GATEWAY_REQUESTS), "--max-batch",
                str(MAX_BATCH), "--max-pending", str(GATEWAY_MAX_PENDING),
                *flags, "--torch-device", "cuda"])
            label = f"gateway run_cnn_async {stem} {name}"
            with GCTimes() as gct:
                g, res = drive(entries, label, set(SERVE_LAUNCHES[stem]),
                               lambda: serve.run_cnn_async(
                                   args, keep_every=GATEWAY_KEEP_EVERY))
            res["gc"] = gct.summary()
            c = g.plans["plan0"].compiled
            _check_serve_launches(label, {stem: sum(
                c.bucket_hits.values())})
            total = res["served"] + res["shed"] + res["expired"]
            if total != GATEWAY_REQUESTS or res["served"] < 1 \
                    or res["failed"]:
                raise AssertionError(f"{label}: {res}")
            # served outputs of full, partial and padded batches alike
            kept = res.pop("outputs")
            if not kept:
                raise AssertionError(f"{label}: no served output kept")
            y_ref = cnn_forward_ref(
                [w.cpu() for w in c.params],
                torch.from_numpy(np.stack([x for _, x, _ in kept])),
                c.cfg).numpy()
            if not np.array_equal(np.stack([y for _, _, y in kept]), y_ref):
                bad = [i for (i, _, y), r in zip(kept, y_ref)
                       if not np.array_equal(y, r)]
                raise AssertionError(f"{label}: served outputs of requests "
                                     f"{bad[:8]} differ from "
                                     f"cnn_forward_ref on the CPU")
            res["outputs_checked"] = len(kept)
            gstep = res.get("gateway_step_ms")
            print(f"[gateway] {label}: full-batch step "
                  f"{res['step_ms']:.6f} ms (bare forward), "
                  f"{gstep} ms through the gateway; offered "
                  f"{res['offered_per_s']:.1f} images/s scheduled, "
                  f"{res['achieved_offered_per_s']:.1f} achieved (producer "
                  f"lag p50 {res['producer_lag_p50_ms']:.6f} ms, max "
                  f"{res['producer_lag_max_ms']:.6f} ms; admission "
                  f"{res['admission_us']:.3f} us per request); served "
                  f"{res['images_per_s']:.1f} images/s ({res['served']} "
                  f"served, {res['shed']} shed, {res['expired']} expired), "
                  f"p50/p95/p99 {res.get('p50_ms')}/{res.get('p95_ms')}/"
                  f"{res.get('p99_ms')} ms from the scheduled arrival, "
                  f"service rate {res['service_rate']:.1f} images/s, "
                  f"occupancy {res['occupancy_hist']}, pending bound "
                  f"{res['max_pending']}; {len(kept)} served outputs equal "
                  f"cnn_forward_ref (CPU); on {smi}")
            print(f"[gateway]   {res['dispatches']} dispatches, stage ms "
                  f"p50/p99/max: " + ", ".join(
                      f"{k} {v['p50']:.6f}/{v['p99']:.6f}/{v['max']:.6f}"
                      for k, v in res["stages_ms"].items())
                  + f"; worker busy {res['worker_busy'] * 100:.2f} % of "
                  f"the wall; first dispatch {res['first_dispatch']}; "
                  f"slowest {res['slowest_dispatch']}; garbage "
                  f"collections {res['gc']}")
            runs[label] = res
    return {"cache_entries": len(cache), "distinct_layers": len(distinct),
            "shared_layers": len(shared), "forwards": forwards,
            "interleaved_seconds": dt, "forward_in_threads_ms": threads,
            "runs": runs}


def _fleet_forwards(fleet):
    """Served forwards (bucket dispatches) per worker of a closed
    fleet."""
    return {wid: sum(w.gateway.plans["cnn"].compiled.bucket_hits.values())
            for wid, w in fleet.workers.items()}


def fleet_on_card(entries, smi, cache_dir):
    """Phase 9a: the launcher's ``run_cnn_fleet`` on the card, under
    each router and once more with ``--drain``, all four runs through
    one fresh ``--cache-dir``.  Returns the numbers for the JSON
    line."""
    import numpy as np
    import torch
    from repro_torch.core.cnn import cnn_forward_ref
    from repro_torch.launch import serve

    runs = {}
    for router, flags in FLEET_RUNS:
        label = f"fleet {router}" + ("".join(f" {f[2:]}" for f in flags))
        args = serve.parse_args([
            "--workload", "cnn", "--fleet", "--requests",
            str(FLEET_REQUESTS), "--max-batch", str(MAX_BATCH),
            "--max-pending", str(GATEWAY_MAX_PENDING), "--occupancy", "1.0",
            "--seed", str(FLEET_SEED), "--router", router, *flags,
            "--cache-dir", str(cache_dir), "--torch-device", "cuda"])
        plans = serve.fleet_plans(args)
        per_plan = {f"{name}0": serve.plan_kernel_entries(plan)
                    for name, plan in plans.items()}
        want = set().union(*map(set, per_plan.values()))
        fleet, res = drive(entries, label, want, lambda: serve.run_cnn_fleet(
            args, keep_every=FLEET_KEEP_EVERY))
        forwards = _fleet_forwards(fleet)
        for k, v in LAUNCHES[label].items():
            exp = sum(forwards[wid] * layers.count(k)
                      for wid, layers in per_plan.items())
            if v != exp:
                raise AssertionError(f"{label}: {k} launched {v} times in "
                                     f"{forwards} forwards, want {exp}")
        kept = res.pop("outputs")
        if res["served"] + res["expired"] + res["shed"] != FLEET_REQUESTS \
                or res["failed"] or res["lost"] or res["refused"] \
                or res["served"] < 1:
            raise AssertionError(f"{label}: {res}")
        if "--drain" in flags and res["drains"] != 1:
            raise AssertionError(f"{label}: drains {res['drains']}")
        if not kept:
            raise AssertionError(f"{label}: no served output kept")
        by_worker = {}
        for i, wid, x, y in kept:
            by_worker.setdefault(wid, []).append((i, x, y))
        for wid, items in by_worker.items():
            c = fleet.workers[wid].gateway.plans["cnn"].compiled
            y_ref = cnn_forward_ref(
                [w.cpu() for w in c.params],
                torch.from_numpy(np.stack([x for _, x, _ in items])),
                c.cfg).numpy()
            if not np.array_equal(np.stack([y for _, _, y in items]), y_ref):
                raise AssertionError(
                    f"{label}: outputs {wid} served differ from "
                    f"cnn_forward_ref on the CPU with its plan and weights")
        res["outputs_checked"] = {wid: len(v) for wid, v in by_worker.items()}
        res["forwards"] = forwards
        print(f"[fleet] {label}: {res['served']} served, {res['expired']} "
              f"expired, {res['shed']} shed of {FLEET_REQUESTS} in "
              f"{res['wall_s']:.6f} s ({res['images_per_s']:.1f} images/s; "
              f"offered {res['offered_per_s']:.1f} scheduled, "
              f"{res['achieved_offered_per_s']:.1f} achieved; bare step "
              f"{res['step_ms']:.6f} ms); rerouted {res['rerouted']}, "
              f"retried {res['retried']}, drains {res['drains']}; per tier "
              f"{res['per_tier']}; per worker {res['per_worker']}; cache "
              f"{res['cache']}; plans launch {res['plans']}; served outputs "
              f"{res['outputs_checked']} equal cnn_forward_ref (CPU); "
              f"on {smi}")
        runs[label] = res
    return runs


def _recovery_config():
    from repro_torch.serve import AsyncServeConfig
    return AsyncServeConfig(max_batch=MAX_BATCH,
                            max_pending=RECOVERY_MAX_PENDING)


def _serve_images(gw, imgs):
    import asyncio

    async def main():
        async with gw:
            futs = [await gw.submit(x) for x in imgs]
            return await asyncio.gather(*futs)
    return asyncio.run(main())


def warm_start(root_dir, worker_id, out, rebuilt=None):
    """The recovery phase's fresh process: open the store root the
    parent holds, check that the parent's lease on ``b`` holds, build a
    gateway for ``worker_id`` from the root and serve the seeded
    images; write its outputs and numbers to ``out`` (npz) and check
    that it prepared nothing, ran no ``nvcc`` (or, with ``rebuilt``,
    exactly one, for that quarantined library) and bound every kernel
    library from the root's ``exec-cache/kernels/``."""
    import numpy as np
    from repro_torch.chaos import respawn_gateway
    from repro_torch.kernels import build
    from repro_torch.ops import LeaseHeld, StoreRoot

    root = StoreRoot(root_dir)
    try:
        root.acquire_lease("b")
        raise AssertionError("warm start: the parent's lease on b was "
                             "taken over")
    except LeaseHeld:
        pass
    t0 = time.perf_counter()
    gw = respawn_gateway(root, worker_id, [RECOVERY_PLAN_ID],
                         _recovery_config(), device="cuda")
    build_s = time.perf_counter() - t0
    stats = gw.exec_cache.stats()
    bound = build.bound_paths()
    kdir = (root.exec_cache_dir / "kernels").resolve()
    compiled = gw.plans[RECOVERY_PLAN_ID].compiled
    layers = compiled.num_layers * len(compiled.buckets)
    want_nvcc = 0 if rebuilt is None else 1
    problems = []
    if build.nvcc_runs != want_nvcc:
        problems.append(f"nvcc_runs {build.nvcc_runs}, want {want_nvcc}")
    if stats["compiles"] != 0 or stats["disk_hits"] != layers:
        problems.append(f"cache {stats}, want 0 compiles and {layers} "
                        f"disk hits")
    if set(bound) != {"conv1_layer", "fused_dot_layer", "packed_dot_layer"} \
            or any(p.resolve().parent != kdir for p in bound.values()):
        problems.append(f"libraries bound from {bound}, want {kdir}")
    for name in bound:
        if not build.verified(name, kdir):
            problems.append(f"{name}: bound library fails its hash")
    if rebuilt is not None:
        lib = build.library_path(rebuilt, kdir)
        if not lib.with_name(lib.name + ".corrupt").exists():
            problems.append(f"{rebuilt}: no quarantined *.corrupt library")
    imgs = compiled.sample_inputs(WARM_IMAGES, WARM_SEED)
    outs = np.stack(_serve_images(gw, imgs))
    gw.lease.release()
    np.savez(out, outputs=outs, build_s=build_s,
             nvcc_runs=build.nvcc_runs, compiles=stats["compiles"],
             disk_hits=stats["disk_hits"],
             bound=json.dumps({k: str(v) for k, v in bound.items()}))
    if problems:
        raise AssertionError(f"warm start {worker_id}: {problems}")
    return 0


def _warm_start_process(root_dir, worker_id, out, rebuilt=None):
    """Run ``warm_start`` in a fresh process; return its npz."""
    import numpy as np
    cmd = [sys.executable, str(Path(__file__).resolve()), "--warm-start",
           str(root_dir), worker_id, str(out)]
    if rebuilt is not None:
        cmd += ["--rebuilt", rebuilt]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"warm start {worker_id} exited "
                             f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def recovery_on_card(entries, smi, root_dir):
    """Phase 9b: kill and restart-from-store on the card.  Workers a and
    b from ``respawn_gateway`` over a fresh ``StoreRoot`` (the pinned
    plan: K1, K2 and K3), a seeded fault plan that crashes a at its
    first dispatch, 256 requests, ``Fleet.kill`` then ``Fleet.respawn``
    from the store; then a warm start in a fresh process, a corrupted
    cache, a corrupted kernel library and a torn plan write.  Returns
    the numbers for the JSON line."""
    import asyncio
    import numpy as np
    import torch
    from repro_torch.chaos import (FaultInjector, FaultPlan, FaultSpec,
                                   corrupt_cache_entries, respawn_gateway,
                                   tear_plan_write)
    from repro_torch.core.cnn import cnn_forward_ref
    from repro_torch.fleet import (Fleet, FleetError, FleetWorker,
                                   HealthPolicy)
    from repro_torch.kernels import build
    from repro_torch.ops import StoreRoot
    from repro_torch.runtime import load_plan

    root = StoreRoot(root_dir)
    plan = load_plan(PLANS / f"{PINNED}.json")
    root.plans.save(plan, RECOVERY_PLAN_ID)
    faults = FaultPlan((FaultSpec("crash_dispatch", "a", after_n=1),),
                       seed=RECOVERY_FAULT_SEED)
    inj = FaultInjector(FaultPlan.from_json(faults.to_json()))
    nvcc0 = build.nvcc_runs
    t0 = time.perf_counter()
    gw_a = respawn_gateway(root, "a", [RECOVERY_PLAN_ID], _recovery_config(),
                           faults=inj.for_target("a"), device="cuda")
    gw_b = respawn_gateway(root, "b", [RECOVERY_PLAN_ID], _recovery_config(),
                           device="cuda")
    cold_s = time.perf_counter() - t0
    cold_nvcc = build.nvcc_runs - nvcc0
    compiled = gw_b.plans[RECOVERY_PLAN_ID].compiled
    layers = compiled.num_layers * len(compiled.buckets)
    if gw_a.exec_cache.stats()["compiles"] != layers \
            or gw_b.exec_cache.stats()["disk_hits"] != layers:
        raise AssertionError(f"recovery: cold root {gw_a.exec_cache.stats()}"
                             f", then {gw_b.exec_cache.stats()}")
    print(f"[recovery] cold root: workers a and b built in {cold_s:.6f} s, "
          f"{cold_nvcc} nvcc runs into {root.exec_cache_dir / 'kernels'}; a "
          f"prepared {layers} launches, b loaded {layers} from disk")

    imgs = compiled.sample_inputs(RECOVERY_REQUESTS, GATEWAY_SEED)

    def spawn_a():
        inj.revive("a")                          # the restart
        return respawn_gateway(root, "a", [RECOVERY_PLAN_ID],
                               _recovery_config(), device="cuda")

    workers = [FleetWorker("a", gw_a, "v5e", spawn=spawn_a,
                           health=HealthPolicy(eject_after=1,
                                               probe_interval=0.05)),
               FleetWorker("b", gw_b, "v5e")]

    async def main():
        fleet = Fleet(workers, router="round_robin")
        async with fleet:
            futs, refused = [], 0
            for i, img in enumerate(imgs):
                try:
                    futs.append((i, fleet.submit_nowait(img)))
                except FleetError:
                    refused += 1
                if i % 8 == 7:                   # let dispatches (and
                    await asyncio.sleep(0.002)   # the crash) happen
            outs = await asyncio.gather(*(f for _, f in futs),
                                        return_exceptions=True)
            dead = fleet.workers["a"].dead
            t_respawn = time.perf_counter()
            respawned = await fleet.respawn("a")  # via the spawn factory
            respawn_s = time.perf_counter() - t_respawn
            canaries = 0
            while not respawned.health.healthy and canaries < 8:
                await fleet.infer(imgs[canaries])
                canaries += 1
            return (futs, outs, refused, dead, respawn_s, canaries,
                    fleet.stats(), fleet)

    label = "recovery kill respawn"
    futs, outs, refused, dead, respawn_s, canaries, stats, fleet = drive(
        entries, label, set(SERVE_LAUNCHES[PINNED]),
        lambda: asyncio.run(main()))
    gw_a2 = fleet.workers["a"].gateway
    forwards = sum(gw.plans[RECOVERY_PLAN_ID].compiled.bucket_hits
                   [b] for gw in (gw_a, gw_b, gw_a2)
                   for b in compiled.buckets)
    _check_serve_launches(label, {PINNED: forwards})
    failed = [o for o in outs if isinstance(o, BaseException)]
    completed = len(outs) - len(failed)
    lost = len(failed)
    respawn_cache = gw_a2.exec_cache.stats()
    if completed + refused != RECOVERY_REQUESTS or lost \
            or stats["rerouted"] < 1 or not dead or stats["kills"] != 1:
        raise AssertionError(f"{label}: {completed} completed + {refused} "
                             f"refused of {RECOVERY_REQUESTS}, {lost} lost "
                             f"({failed[:3]}), dead {dead}, {stats}")
    if inj.injected[0][:2] != ("crash_dispatch", "a") or len(inj.injected) != 1:
        raise AssertionError(f"{label}: injected {inj.injected}")
    if respawn_cache["compiles"] != 0 or respawn_cache["disk_hits"] != layers:
        raise AssertionError(f"{label}: the respawned gateway's cache "
                             f"{respawn_cache}, want 0 compiles and "
                             f"{layers} disk hits")
    if not fleet.workers["a"].health.healthy:
        raise AssertionError(f"{label}: a not re-admitted after {canaries} "
                             f"canaries")
    for gw in (gw_a, gw_a2):
        for w0, w1 in zip(gw.plans[RECOVERY_PLAN_ID].compiled.params,
                          compiled.params):
            if not torch.equal(w0, w1):
                raise AssertionError(f"{label}: workers' weights differ")
    xs = np.stack([imgs[i] for i, _ in futs])
    y_ref = cnn_forward_ref([w.cpu() for w in compiled.params],
                            torch.from_numpy(xs), compiled.cfg).numpy()
    if not np.array_equal(np.stack(outs), y_ref):
        raise AssertionError(f"{label}: completions differ from "
                             f"cnn_forward_ref on the CPU")
    print(f"[recovery] {label}: {completed} completed + {refused} refused "
          f"of {RECOVERY_REQUESTS}, {lost} lost, rerouted "
          f"{stats['rerouted']}, kills {stats['kills']}, respawns "
          f"{stats['respawns']}; every completion equals cnn_forward_ref "
          f"(CPU); respawn in {respawn_s:.6f} s with cache {respawn_cache}; "
          f"a re-admitted after {canaries} canaries; injected "
          f"{inj.injected}")
    res = {"requests": RECOVERY_REQUESTS, "completed": completed,
           "refused": refused, "lost": lost, "rerouted": stats["rerouted"],
           "kills": stats["kills"], "respawns": stats["respawns"],
           "cold_build_s": cold_s, "cold_nvcc_runs": cold_nvcc,
           "respawn_s": respawn_s, "respawn_cache": respawn_cache,
           "canaries": canaries, "forwards": forwards,
           "fault_plan": faults.to_payload()}

    # the same 16 seeded images through the parent's respawned gateway
    warm_imgs = compiled.sample_inputs(WARM_IMAGES, WARM_SEED)
    gw_p = respawn_gateway(root, "p", [RECOVERY_PLAN_ID], _recovery_config(),
                           device="cuda")
    parent_out = np.stack(_serve_images(gw_p, warm_imgs))
    gw_p.lease.release()

    # 1. a fresh process: LeaseHeld for b, nothing prepared, no nvcc
    warm = _warm_start_process(root_dir, "c", Path(root_dir) / "warm_c.npz")
    if not np.array_equal(warm["outputs"], parent_out):
        raise AssertionError("warm start: outputs differ from the parent's")
    res["warm"] = {"build_s": float(warm["build_s"]),
                   "nvcc_runs": int(warm["nvcc_runs"]),
                   "compiles": int(warm["compiles"]),
                   "disk_hits": int(warm["disk_hits"]),
                   "bound": json.loads(str(warm["bound"]))}
    print(f"[recovery] warm start in a fresh process (worker c): built in "
          f"{res['warm']['build_s']:.6f} s against {cold_s:.6f} s cold; "
          f"{res['warm']['nvcc_runs']} nvcc runs, "
          f"{res['warm']['compiles']} launches prepared, "
          f"{res['warm']['disk_hits']} loaded; libraries from "
          f"{res['warm']['bound']}; LeaseHeld for b; its outputs on "
          f"{WARM_IMAGES} seeded images equal the parent's")

    # 2. every cache entry corrupted: quarantined and re-prepared
    hit = corrupt_cache_entries(root.exec_cache_dir)
    gw_d = respawn_gateway(root, "d", [RECOVERY_PLAN_ID], _recovery_config(),
                           device="cuda")
    s_d = gw_d.exec_cache.stats()
    quarantined = sorted(root.exec_cache_dir.glob("*.corrupt"))
    out_d = np.stack(_serve_images(gw_d, warm_imgs))
    gw_d.lease.release()
    if len(hit) != layers or s_d["disk_errors"] != layers \
            or s_d["compiles"] != layers or len(quarantined) != layers \
            or not np.array_equal(out_d, parent_out):
        raise AssertionError(f"corrupt cache: {len(hit)} corrupted, "
                             f"{len(quarantined)} quarantined, cache {s_d}")
    res["corrupt_cache"] = {"corrupted": len(hit),
                            "quarantined": len(quarantined), "cache": s_d}
    print(f"[recovery] corrupt cache: {len(hit)} entries corrupted, "
          f"{len(quarantined)} quarantined as *.corrupt and re-prepared "
          f"({s_d}); outputs equal the parent's")

    # 3. a corrupted kernel library: quarantined and rebuilt, never loaded
    kdir = root.exec_cache_dir / "kernels"
    lib = build.library_path("packed_dot_layer", kdir)
    # a new file in its place: this process may have the old one mapped,
    # and writing over a mapped library in place faults its pages
    junk = lib.with_name(lib.name + ".junk")
    junk.write_bytes(b"\x00garbage, not a shared library\x00")
    junk.replace(lib)
    bad = _warm_start_process(root_dir, "e", Path(root_dir) / "warm_e.npz",
                              rebuilt="packed_dot_layer")
    if not np.array_equal(bad["outputs"], parent_out):
        raise AssertionError("corrupt library: outputs differ")
    res["corrupt_library"] = {"library": lib.name,
                              "nvcc_runs": int(bad["nvcc_runs"]),
                              "compiles": int(bad["compiles"])}
    print(f"[recovery] corrupt library {lib.name}: quarantined as *.corrupt "
          f"and rebuilt in a fresh process ({int(bad['nvcc_runs'])} nvcc "
          f"run, {int(bad['compiles'])} launches prepared), the rebuilt "
          f"one bound; outputs equal the parent's")

    # 4. a torn plan write: the live plan survives, listings skip it
    other = load_plan(PLANS / f"{UNPINNED}.json").to_json()
    tmp = tear_plan_write(root.plans, RECOVERY_PLAN_ID, other,
                          cut=len(other) // 2)
    if root.plans.load(RECOVERY_PLAN_ID).to_json() != plan.to_json() \
            or root.plans.list_plans() != [RECOVERY_PLAN_ID] \
            or not tmp.exists():
        raise AssertionError("torn write: the live plan did not survive")
    res["torn_write"] = {"temp": tmp.name, "plans": root.plans.list_plans()}
    print(f"[recovery] torn plan write {tmp.name}: load('cnn') returns the "
          f"old plan, listings show {root.plans.list_plans()}; on {smi}")
    gw_b.lease.release()
    gw_a2.lease.release()
    return res


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _lm_bound(nbytes, flops, rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_lm_kernels(entries):
    """Phase 10, kernels: K7 and K8 against their plain versions on the
    card at the full-width shapes, timed, into their ``entries``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import conv1d, flash_attention as fa
    from repro_torch.models.ssm import ssm_dims

    torch.backends.cuda.matmul.allow_tf32 = False
    for k in ("causal_conv1d", "flash_attention"):
        entries.setdefault(k, kernel_entry(k))
    g = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") \
            .to(torch.bfloat16)

    # the launches of one Mamba-2-1.3B layer on the serving path: the x
    # conv over `inner` channels and the B and C convs over `gn` each; a
    # prefill of LM_PROMPT without a state (the kernel's zero halo), a
    # decode step at LM_MAX_BATCH with the cache's state
    mcfg = get_config("mamba2-1.3b")
    inner, _ = ssm_dims(mcfg)
    gn, kk = mcfg.ssm.n_groups * mcfg.ssm.state_dim, mcfg.ssm.conv_kernel
    conv_cases = [(phase, b, s, c, reps) for phase, b, s in (
        ("prefill", 1, LM_PROMPT), ("decode", LM_MAX_BATCH, 1))
        for c, reps in ((inner, 1), (gn, 2))]
    print("[lm kernels] causal_conv1d against its plain version "
          "(tolerance 0: the same float32 roundings in the same order)")
    e = entries["causal_conv1d"]
    e["per_layer"] = {ph: {"ms": 0.0, "device_ms": 0.0}
                      for ph in ("prefill", "decode")}
    for phase, b, s, c, reps in conv_cases:
        x, w = randn(b, s, c), randn(kk, c)
        st = randn(b, kk - 1, c) if phase == "decode" else None
        y = conv1d.causal_conv1d(x, w, st)
        torch.cuda.synchronize()
        y_plain = conv1d.causal_conv1d_plain(x, w, st)
        err = float((y - y_plain).abs().max())
        eq = torch.equal(y, y_plain)
        print(f"  causal_conv1d {phase} ({b},{s},{c}) K{kk} "
              f"state={st is not None} bf16: equal={eq} max_abs_err={err}")
        if not eq:
            raise AssertionError(f"causal_conv1d disagrees with its plain "
                                 f"version at ({b},{s},{c}): {err}")
        e["max_abs_err"] = max(e["max_abs_err"], err)
        ms = time_ms(lambda: conv1d.causal_conv1d(x, w, st), 200, warmup=10)
        plain_ms = time_ms(lambda: conv1d.causal_conv1d_plain(x, w, st), 20,
                           warmup=2)
        dev_ms = device_ms(lambda: conv1d.causal_conv1d(x, w, st),
                           "causal_conv1d_kernel")
        xpad = torch.cat([st if st is not None
                          else x.new_zeros(b, kk - 1, c), x], 1) \
            .transpose(1, 2).contiguous()
        wt = w.t().contiguous()[:, None, :]

        def lib():
            return F.conv1d(xpad, wt, groups=c)
        lib_ms = time_ms(lib, 200, warmup=10)
        lib_dev_ms = device_ms(lib)
        b_ms, b_by = _lm_bound(_nbytes(x, w, st) + y.numel() * 4,
                               2 * b * s * c * kk, FP32_FLOPS_PER_S)
        case = {"phase": phase, "shape": [b, s, c, kk],
                "state": st is not None, "per_layer": reps, "ms": ms,
                "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms}
        print(f"    ms={ms:.6f} device_ms={dev_ms} plain_ms={plain_ms:.6f} "
              f"bound_ms={b_ms:.6f} ({b_by}) library_ms={lib_ms:.6f} "
              f"library_device_ms={lib_dev_ms}")
        e["cases"].append(case)
        layer = e["per_layer"][phase]
        layer["ms"] += reps * ms
        layer["device_ms"] = None if dev_ms is None \
            or layer["device_ms"] is None \
            else layer["device_ms"] + reps * dev_ms
        if phase == "prefill" and c == inner:   # the headline: conv_x
            e.update({k_: case[k_] for k_ in TIMES + ("shape",)})
    print(f"  per Mamba layer (conv_x + conv_B + conv_C): "
          f"{json.dumps(e['per_layer'])}")

    print(f"[lm kernels] flash_attention against its plain version "
          f"(bf16 on the tensor cores {K8_BF16_TOL}, float32 on the CUDA "
          f"cores {K8_F32_TOL})")
    e = entries["flash_attention"]
    e["instantiations"] = {}
    # the Llama-3.2-3B prefill (bf16) and the smoke golden's first prefill
    # (float32: the only float32 K8 launches of the script)
    with np.load(LM_GOLDEN) as z:
        gb, gs = z["llama3.2-3b/tokens"].shape
    scfg = smoke_config("llama3.2-3b")
    for b, s, h, kh, d, dtype in (
            (1, 512, 24, 8, 128, torch.bfloat16),
            (1, 300, 24, 8, 128, torch.bfloat16),
            (gb, gs, scfg.n_heads, scfg.n_kv_heads, scfg.head_dim,
             torch.float32)):
        q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda")
                   .to(dtype) for n in (h, kh, kh))
        bf16 = dtype == torch.bfloat16
        tol = K8_BF16_TOL if bf16 else K8_F32_TOL
        kname = "flash_attention_bf16_kernel" if bf16 \
            else "flash_attention_f32_kernel"
        out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=True)
        err = float((out.float() - want.float()).abs().max())
        label = f"({b},{s},{h},{d}) kv {kh} causal {str(dtype)[6:]}"
        print(f"  flash_attention {label}: max_abs_err={err}")
        torch.testing.assert_close(out.float(), want.float(), **tol)
        e["max_abs_err"] = max(e["max_abs_err"], err)
        ms = time_ms(lambda: fa.flash_attention(q, k, v), 100, warmup=5)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v), 10,
                           warmup=2)
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v), kname)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        lib_ms = time_ms(sdpa, 100, warmup=5)
        lib_dev_ms = device_ms(sdpa)
        lib_err = float((sdpa().transpose(1, 2).float() - out.float()).abs()
                        .max())
        # the causal half of 4·B·H·S·T·D, bf16 on the tensor cores,
        # float32 on the CUDA cores
        b_ms, b_by = _lm_bound(_nbytes(q, k, v, out), 2 * b * h * s * s * d,
                               BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S)
        case = {"shape": [b, s, h, kh, d], "dtype": str(dtype)[6:],
                "kernel": kname, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                "library_max_abs_diff": lib_err}
        print(f"    ms={ms:.6f} device_ms={dev_ms} plain_ms={plain_ms:.6f} "
              f"bound_ms={b_ms:.6f} ({b_by}) library_ms={lib_ms:.6f} "
              f"library_device_ms={lib_dev_ms} "
              f"library_max_abs_diff={lib_err}")
        e["cases"].append(case)
        if s == 512 or not bf16:
            e["instantiations"][case["dtype"]] = case
        if s == 512:
            e.update({k_: case[k_] for k_ in TIMES + ("shape",)})


def _lm_golden_params(z, arch, cfg, device):
    from repro_torch import convert
    return convert.lm_params_from_numpy(
        convert.nested_from_flat(z, f"{arch}/params"), cfg, device)


def lm_golden(entries):
    """Phase 10, golden: both smoke archs at float32 on the card against
    the JAX reference's committed outputs."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, Request, ServeConfig

    with np.load(LM_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    for arch in LM_ARCHS:
        cfg = smoke_config(arch).with_overrides(dtype="float32")
        model = build_model(cfg, "cuda")
        params = _lm_golden_params(golden, arch, cfg, "cuda")
        toks = golden[f"{arch}/tokens"]
        pos = golden[f"{arch}/decode_pos"]
        want = {"flash_attention"} if arch.startswith("llama") \
            else {"causal_conv1d"}

        def run():
            errs = []
            logits, _ = model.prefill(params, {"tokens": toks})
            errs.append(np.abs(logits.cpu().numpy()
                               - golden[f"{arch}/prefill_logits"]).max())
            _, cache = model.prefill(params, {"tokens": toks[:, :pos[0]]})
            for entry in cache.values():
                for name in ("k", "v"):
                    if name in entry:
                        entry[name] = torch.nn.functional.pad(
                            entry[name], (0, 0, 0, 0, 0, len(pos)))
            for i, p in enumerate(pos):
                logits, cache = model.decode_step(params, cache,
                                                  toks[:, p:p + 1], int(p))
                errs.append(np.abs(logits.cpu().numpy()
                                   - golden[f"{arch}/decode_logits"][i])
                            .max())
            reqs = [Request(prompt=[int(t) for t in p], request_id=i)
                    for i, p in enumerate(golden[f"{arch}/engine_prompts"])]
            Engine(model, params, ServeConfig(
                max_batch=2, max_len=32, max_new_tokens=5)).run(reqs)
            return float(max(errs)), [r.out_tokens for r in reqs]

        err, tokens = drive(entries, f"lm golden {arch}", want, run)
        same = tokens == golden[f"{arch}/engine_tokens"].tolist()
        print(f"[lm golden] {arch} float32 on the card: logits max_abs_err "
              f"{err:.3e} (tolerance {LM_GOLDEN_TOL}), greedy tokens equal "
              f"{same}")
        if err > LM_GOLDEN_TOL or not same:
            raise AssertionError(f"{arch}: the card differs from the JAX "
                                 f"golden (err {err}, tokens {tokens})")


def lm_decode_profile(model, params, prompts):
    """Device time per decode step from a profiler trace of
    LM_PROFILED_STEPS steps of a full pool of ``prompts`` (prefilled and
    stepped once untraced)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Engine, Request, ServeConfig
    engine = Engine(model, params, ServeConfig(
        max_batch=LM_MAX_BATCH, max_len=LM_PROMPT + LM_NEW + 8,
        max_new_tokens=LM_PROFILED_STEPS + 2))
    for i, p in enumerate(prompts[:LM_MAX_BATCH]):
        if not engine.submit(Request(prompt=list(p), request_id=i)):
            raise AssertionError("profile: a request was not admitted")
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LM_PROFILED_STEPS):
            engine.step()
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    by_name, n_device = {}, 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU and ev.device_time_total > 0:
            by_name[ev.name] = by_name.get(ev.name, 0.0) \
                + ev.device_time_total
            n_device += 1
    if not by_name:
        print("[lm profile] the trace holds no device time: not measured")
        return None
    if engine.timings()["decode_steps"] != LM_PROFILED_STEPS + 1:
        raise AssertionError("profile: the pool did not stay full")
    busy_ms = sum(by_name.values()) / 1e3 / LM_PROFILED_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": LM_PROFILED_STEPS, "device_ms_per_step": busy_ms,
            "device_ops_per_step": n_device / LM_PROFILED_STEPS,
            "traced_wall_ms_per_step": traced_s * 1e3 / LM_PROFILED_STEPS,
            "top_ms_per_step": [[k[:80], v / 1e3 / LM_PROFILED_STEPS]
                                for k, v in top]}


def lm_full_width(entries):
    """Phase 10, full width: the launcher's ``serve_lm`` for both archs at
    full width and depth, bf16.  Returns the numbers per arch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, LOCAL_ATTN, MAMBA
    from repro_torch.launch import serve

    out = {}
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()

        def run():
            t0 = time.perf_counter()
            engine, reqs, dt = serve.serve_lm(
                cfg, requests=LM_REQUESTS, prompt_len=LM_PROMPT,
                new_tokens=LM_NEW, max_batch=LM_MAX_BATCH, device="cuda")
            # the rest of the call: model build, weight draw, requests
            return engine, reqs, dt, time.perf_counter() - t0 - dt
        run()                                        # untimed warm-up
        attn = sum(s.mixer in (ATTN, LOCAL_ATTN)
                   for s in cfg.layer_cycle) * cfg.n_cycles
        mamba = sum(s.mixer == MAMBA for s in cfg.layer_cycle) \
            * cfg.n_cycles
        want = ({"flash_attention"} if attn else set()) \
            | ({"causal_conv1d"} if mamba else set())
        engine, reqs, dt, setup_s = drive(entries, f"lm full width {arch}",
                                          want, run)
        model, params = engine.model, engine.params
        t = engine.timings()
        k7 = entries["causal_conv1d"]["launches_by_path"][
            f"lm full width {arch}"]
        k8 = entries["flash_attention"]["launches_by_path"][
            f"lm full width {arch}"]
        if k8 != attn * t["prefills"]:
            raise AssertionError(f"{arch}: flash_attention launched {k8} "
                                 f"times, want {attn} per prefill x "
                                 f"{t['prefills']} and none in decode")
        if k7 != K7_PER_MAMBA_LAYER * mamba * (t["prefills"]
                                               + t["decode_steps"]):
            raise AssertionError(
                f"{arch}: causal_conv1d launched {k7} times, want "
                f"{K7_PER_MAMBA_LAYER} per Mamba layer ({mamba}) per prefill "
                f"and decode step ({t['prefills']} + {t['decode_steps']})")
        if not all(r.done and len(r.out_tokens) == LM_NEW
                   and all(0 <= x < cfg.vocab_size for x in r.out_tokens)
                   for r in reqs):
            raise AssertionError(f"{arch}: a request was not served whole")
        tokens = sum(len(r.out_tokens) for r in reqs)
        decoded = tokens - t["prefills"]   # each prefill samples one token
        res = {
            "params": sum(t.numel() for t in _leaves(params)),
            "setup_s": setup_s, "layers": cfg.n_layers,
            "requests": LM_REQUESTS, "prompt_len": LM_PROMPT,
            "new_tokens": LM_NEW, "max_batch": LM_MAX_BATCH,
            "seconds": dt, "tokens_per_s": tokens / dt,
            "prefills": t["prefills"], "decode_steps": t["decode_steps"],
            "prefill_ms_per_request": t["prefill_s"] * 1e3 / t["prefills"],
            "prefill_tokens_per_s":
                t["prefills"] * LM_PROMPT / t["prefill_s"],
            "decode_ms_per_step": t["decode_s"] * 1e3 / t["decode_steps"],
            "decode_tokens_per_s": decoded / t["decode_s"],
            "launches": {"flash_attention": k8, "causal_conv1d": k7},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        prof = lm_decode_profile(model, params, [r.prompt for r in reqs])
        if prof is not None:
            prof["idle_share"] = 1.0 - prof["device_ms_per_step"] \
                / res["decode_ms_per_step"]
            # untraced wall time per device operation the step enqueues
            prof["wall_us_per_device_op"] = res["decode_ms_per_step"] \
                * 1e3 / prof["device_ops_per_step"]
        res["decode_profile"] = prof
        out[arch] = res
        print(f"[lm full width] {arch}: {json.dumps(res)}")
        del params, engine, model
        torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def lm_plain_vs_kernel(entries):
    """Phase 10, one prefill at full width cut to LM_CUT_LAYERS layers: the
    card (kernels) against the same parameters on the CPU (plain
    versions), bf16."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    out = {}
    for arch in LM_ARCHS:
        cfg = get_config(arch).with_overrides(n_layers=LM_CUT_LAYERS)
        model = build_model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(1))
        toks = np.random.default_rng(2).integers(
            1, cfg.vocab_size, (1, LM_CUT_PROMPT))
        want = {"flash_attention"} if arch.startswith("llama") \
            else {"causal_conv1d"}
        logits, _ = drive(entries, f"lm cut {arch}", want,
                          lambda: model.prefill(params, {"tokens": toks}))
        t0 = time.perf_counter()
        cpu_logits, _ = build_model(cfg, "cpu").prefill(
            _tree_map(lambda t: t.cpu(), params), {"tokens": toks})
        cpu_s = time.perf_counter() - t0
        a, b = logits.float().cpu(), cpu_logits.float()
        rel = float((a - b).norm() / b.norm())
        res = {"layers": LM_CUT_LAYERS, "prompt_len": LM_CUT_PROMPT,
               "rel_l2": rel, "max_abs_err": float((a - b).abs().max()),
               "logit_abs_max": float(b.abs().max()),
               "argmax_equal": bool(torch.equal(a.argmax(-1),
                                                b.argmax(-1))),
               "finite": bool(torch.isfinite(a).all()), "cpu_s": cpu_s}
        print(f"[lm cut] {arch} {LM_CUT_LAYERS} layers, prompt "
              f"{LM_CUT_PROMPT}, card (kernels) vs CPU (plain): "
              f"{json.dumps(res)}")
        if not (res["finite"] and rel < LM_CUT_REL_L2):
            raise AssertionError(f"{arch}: the card's prefill differs from "
                                 f"the CPU's: relative L2 error {rel}")
        out[arch] = res
        del params, model
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--warm-start":
        # the recovery phase's fresh process (``_warm_start_process``)
        sys.path.insert(0, str(ROOT / "src"))
        rest = sys.argv[2:]
        rebuilt = None
        if "--rebuilt" in rest:
            k = rest.index("--rebuilt")
            rebuilt = rest[k + 1]
            rest = rest[:k] + rest[k + 2:]
        return warm_start(*rest, rebuilt=rebuilt)
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
        print(f"[env] int32 CUDA-core rate {int32_rate():.6e} op/s "
              f"({torch.cuda.get_device_properties(0).multi_processor_count}"
              f" SMs x {INT32_LANES_PER_SM} lanes x 2 x the maximum SM "
              f"clock)")

        t0 = time.perf_counter()
        reports = build.build()
        print(f"[build] {len(reports)} kernels built in "
              f"{time.perf_counter() - t0:.1f}s into {build.BUILD_DIR}")
        for name, log in reports.items():
            for line in log.splitlines():
                if "ptxas info" in line and ("Used" in line
                                             or "Compiling" in line):
                    print(f"  {name}: {line.strip()}")
        tensor_ops = sass_tensor_ops("flash_attention")
        print(f"[build] flash_attention: {tensor_ops} tensor-core "
              f"instructions (HMMA/HGMMA) in its SASS (cuobjdump -sass)")

        entries = check_kernels()
        entries.update(check_plane_kernels())
        rates, step_ms = serve_plans(entries)
        prof = {stem: serve_profile(stem, step_ms[stem])
                for stem in (PINNED, UNPINNED)}
        per_plane_forwards(entries)
        planned = plan_on_card(entries)
        gateway = gateway_on_card(entries, smi)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
            fleet = fleet_on_card(entries, smi, Path(tmp) / "fleet-cache")
            recovery = recovery_on_card(entries, smi, Path(tmp) / "root")
        check_lm_kernels(entries)
        lm_golden(entries)
        lm = lm_full_width(entries)
        lm_cut = lm_plain_vs_kernel(entries)
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "equal") + TIMES + (
                "shape", "launches_by_path", "cases")
        extra = ("instantiations", "requant", "requant_cases",
                 "launches_by_entry")
        line = {"kernels": [{k: e[k] for k in keys}
                            | {k: e[k] for k in extra if k in e}
                            for e in entries.values()],
                "images_per_s": rates, "ms_per_step": step_ms,
                "serve_profile": prof, "plan_on_card": planned,
                "gateway": gateway, "fleet": fleet, "recovery": recovery,
                "lm_k7_per_mamba_layer": entries["causal_conv1d"]["per_layer"],
                "lm_full_width": lm, "lm_cut_plain_vs_kernel": lm_cut,
                "int32_ops_per_s": int32_rate(), "card": smi}
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
