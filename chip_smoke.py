#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs
on one CUDA card.  Run from the root of a checkout:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro`` and runs, in
order (any mismatch or error raises and the exit code is non-zero; "the
counter" is ``kernels.build.LAUNCHES``, every kernel launch by C entry):

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
   requests served from the ``v5e`` plan; the launches it adds to
   the counter are read, and each plane kernel must have
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
   with the launches they add to the counter read (each
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
   launches it adds to the counter read), and the served
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
   launches each arch adds to the counter read (K8 once per
   attention layer per prefill and never in decode, K7 three times per
   Mamba layer per prefill and per decode step); prefill ms per
   request, decode ms per step, tokens/s, and a profiler trace of 16
   decode steps for the device time and idle share per step; and one
   prefill at full width cut to 4 layers on the card (kernels) against
   the same parameters on the CPU (plain versions), relative L2 error of
   the logits under 5e-2;
11. the quantized MoE workload (no kernel of its own: the expert
   products are ``torch.bmm`` in float32, TF32 off): the JAX reference's
   golden smoke Qwen3-MoE plan (``golden/moe_reference.npz``) on its
   weights at max_batch 4 — each layer of each bucket (1, 2, 4) on the
   reference's input to it within atol 1e-4 and relative L2 1e-5 of the
   reference's output; then served through ``CNNEngine`` and through one
   ``AsyncCNNGateway`` that also serves ``quickstart_v5e`` on its golden
   weights (the launches they add to the counter read: K1's
   requantizing entry for the CNN plan, the float32 expert kernels
   twice a layer a forward for the MoE plan), in the golden's
   dispatches, every served block equal to the port's own layer trace of
   that dispatch and within atol 1e-4 (relative L2 1e-5) of the golden,
   or moved off it only by a fake-quant rounding flip (a value on a
   rounding boundary, found and printed), the CNN outputs exact, a MoE
   block refused on the CNN plan and an image on the MoE plan; then the
   expert kernels ``moe_expert_gemm_gate_up`` and ``_down`` against their
   plain version, the three ``torch.bmm`` of ``expert_ffn_bmm``, on every
   filled row (rows past the fill NaN in their inputs; MOE_KERNEL_TOL)
   at the benchmark cell's layer (E 128, capacity 64, d 2048, f 768, the
   fills of a seeded 512-token dispatch and their filled share), at
   bucket 1 and at a ragged shape, timed at both buckets against the
   three ``torch.bmm`` (``library_ms``) beside their bound over the
   filled rows (a device time below its bound not measured); the bf16
   expert kernels at Qwen3-30B-A3B's dropless decode step (8 tokens) and
   at a prefill of 1,108 tokens on seeded fills, against float32
   products of the same bf16 inputs (MOE_BF16_TOL, and no further than
   the bf16 ``torch.bmm``), timed against those ``torch.bmm`` beside
   the bound of the experts that hold a row; then the
   full-width Qwen3-MoE-30B-A3B experts (2 layers, 32 tokens a block,
   d_model 2048, 128 experts, top 8, 768 wide) planned for ``v5e`` with
   fallback, compiled at max_batch 16 from a seeded draw on the card,
   equal to ``_eager_forward`` at every bucket (rtol = atol = 1e-5), the
   relative error against ``moe_layer_dense_ref``, one forward under
   ``torch.cuda.set_sync_debug_mode("error")``, ms per step at bucket 16
   by CUDA events, device ms, ops and idle share per step from a
   profiler trace, tokens/s through ``CNNEngine`` for 256 blocks (the
   expert kernels launched twice a layer a forward, no
   ``expert_ffn_bmm`` fallback), each with the card's name and power limit;
12. the rest of the LM zoo (K7, K8): Qwen3-MoE, Llama-4-Maverick,
   Jamba, Whisper and Pixtral at ``smoke_config`` in float32 against the
   JAX reference's golden file ``src/repro_torch/golden/
   lm_zoo_reference.npz`` (logits within 2e-3, the MoE archs' greedy
   engine tokens equal, two identical prompts in one wave among them; K8
   once per attention layer per prefill and never in decode, K7 three
   times per Jamba Mamba layer per call; the float32 MoE MLP of the MoE
   archs on the expert kernels, launched by each MoE arch and by no
   other); then
   Qwen3-MoE-30B-A3B at full
   width and depth (48 layers, 61 GB of bf16 weights from a seeded
   generator) through the launcher's ``serve_lm`` with phase 10's
   traffic after a one-layer warm-up, the launches it adds to the
   counter read (K8 48 times per prefill, never in decode; the
   bf16 MoE MLP's products on the bf16 expert kernels: launched twice
   an MoE layer a prefill and a graphed decode step, no
   ``expert_ffn_bmm`` fallback):
   prefill ms per request, decode ms per step, tokens/s, peak memory, a
   profiler trace of 16 decode steps (device ms, idle share, device ops
   per step, against the step's byte bound), one decode step under
   ``set_sync_debug_mode("error")`` and one layer's expert products at
   the decode shape against their byte bound; then full-width cuts —
   Qwen3-MoE at 4 layers, Llama-4-Maverick at one cycle (2 layers),
   Whisper-medium (24 + 24 layers, 1500 numpy-made frames) and
   Pixtral-12B (40 layers, 256 numpy-made patches) whole — each prefill
   on K8 against the same prefill with K8's plain version and decode at
   position S−1 against a prefill over S positions (the MoE capacity
   raised), relative L2 of the logits within 5e-2; then K8
   bf16 against its plain version at the zoo's shapes (1, 512, 32, 128)
   kv 4 and (1, 512, 16, 64) kv 16, timed as in phase 10; each part's
   seconds printed;
13. training (K7, K8 forward; their ``torch.autograd.Function``s'
   backwards, torch ops): Llama-3.2-3B, Mamba-2-1.3B and Qwen3-MoE at
   ``smoke_config`` in float32 against the JAX reference's golden file
   ``src/repro_torch/golden/train_reference.npz`` (loss, nll and aux
   within 1e-5 relative, every gradient leaf within relative L2 1e-4,
   the attention projections and the conv taps among them, the
   parameters after one ``make_train_step`` step with float32 and with
   int8 AdamW states within relative L2 1e-5; K8 and K7 launched for
   each layer's forward and its remat recompute); then Llama-3.2-3B (28
   layers) and Mamba-2-1.3B (48 layers) at full width and depth, bf16,
   seeded weights drawn on the card: 4 steps of ``make_train_step`` over
   ``batch_at`` batches of 2 x 2048 tokens with float32 states, the
   launches they add to the counter read (every loss
   finite, every parameter leaf with a non-zero gradient at step 1, K8
   or K7 launched the derived count every step), ms per step, tokens/s,
   peak memory, a profiler trace of one step (device ms, idle share,
   device ops, the kernel's share), one step with int8 states and its
   peak memory; Llama-3.2-3B cut to 2 layers, a 1 x 256 batch, its loss
   and gradients on the card (kernels) against the CPU (plain versions)
   within 1e-2 and relative L2 5e-2; ``train()`` at smoke size with
   a preemption (``fail_at_step``) and a resume equal to an
   uninterrupted run within 1e-5, its checkpoint restored into a fresh
   template; and K8 and K7 at the two full-width steps' shapes against
   their plain versions, timed as in phase 10, with each one's forward
   and backward beside the library call's; each part's seconds
   printed;
14. the multi-device layer: two dry-run cells of ``repro_torch.launch.
   dryrun`` started first, each in its own process on the host's CPU
   (Qwen3-MoE-30B-A3B x train_4k and, ``--mode fsdp``, Jamba-1.5-Large x
   prefill_32k, both over a ``fake`` group of 256 ranks); then (a) the
   launcher's ``--shard`` path on both committed plans with the golden
   weights over ``cnn_data_mesh()`` (outputs equal to the JAX golden and
   to the unsharded engine, launches as in phase 5, the mesh size
   printed); (b) on a one-device NCCL (data, model) mesh, Llama-3.2-3B at
   full width and depth, bf16, seeded: one ``make_train_step`` step on
   DTensor trees placed by ``ShardingRules`` (the weights wrapped, not
   copied) against one unsharded step from the same state (loss within
   1e-3 relative, every parameter leaf within relative L2 1e-3, K8
   launched 56 times through ``local_map``, the launches it adds to
   the counter read), peak memory, then a prefill of 2 x 512
   tokens and 8 greedy decode steps with the cache placed by
   ``cache_spec`` against the unsharded path (logits within 5e-2
   relative L2, tokens equal); (c) ``core.hloscan.analyze_step`` of the
   sharded step (FLOPs, bytes, the peak it counts beside
   ``torch.cuda.max_memory_allocated``), ``roofline_terms`` with
   ``H100_SXM`` beside the measured ms per step (CUDA events, steps 2-4)
   and their fraction; (d) the dry-run cells read back: status ``ok``,
   seconds, per-device argument and temporary bytes beside the card's
   memory; each part's seconds printed;
15. one JSON line ``{"kernels": [...]}`` (with the fleet and recovery
   results under ``"fleet"`` and ``"recovery"``, the MoE workload's
   under ``"moe"``, the LM zoo's under ``"lm_zoo"``, training's under
   ``"train"``, the multi-device layer's under ``"parallel"``), the
   nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only-parallel`` builds the kernels and runs
phase 14 alone (no result line), for work on that phase;
``--only-experts`` builds the kernels and runs phase 11's expert
kernels alone (float32 and bf16) and prints their numbers as one JSON
line; ``--only-lm`` builds the kernels and runs the LM paths the serving
``Engine`` drives (phase 10's kernel checks, goldens and full-width
serving; phase 12's goldens and full-width Qwen3-MoE) and prints their
numbers as one JSON line;
``--json-out PATH`` also writes the ``{"kernels": ...}`` line to PATH.

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
# the MoE phase: the JAX reference's golden smoke plan served at max_batch
# 4 in its dispatches (buckets 1, 2, 4, 1), held at atol 1e-4 and a
# relative L2 of 1e-5; then the full-width Qwen3-MoE-30B-A3B experts at
# max_batch 16, compiled against eager at 1e-5 (validate_moe_plan's)
MOE_GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "moe_reference.npz"
MOE_GOLDEN_MAX_BATCH = 4
MOE_DISPATCHES = ((0, 1), (1, 3), (3, 7), (7, 8))
MOE_ATOL, MOE_REL_L2 = 1e-4, 1e-5
MOE_EAGER_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_ARCH, MOE_MAX_BATCH, MOE_SEED = "qwen3-moe-30b-a3b", 16, 24
MOE_TIMED_BLOCKS, MOE_PROFILED_STEPS = 256, 8
# the expert kernels against their plain versions: float32 sums of 2048
# (768) products in another order, outputs of order 1
MOE_KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
# the bf16 expert kernels: relative L2 of the filled rows against float32
# products of the same bf16 inputs (each output rounded to bf16 once), no
# larger than the three bf16 torch.bmm's; the shapes of Qwen3-30B-A3B's
# dropless decode step (8 tokens) and of a prefill of the benchmark's mean
# prompt (1,108 tokens), fills from seeded top-8 routings, and the seeds
# the mean count of experts that hold a row is read over
MOE_BF16_TOL = 2.0 ** -7
MOE_BF16_CASES = (("decode", 8), ("prefill 1108", 1108))
MOE_BF16_FILL_SEEDS = 16
# the benchmark cell's dispatch: 32-token blocks, capacity factor 2
MOE_BLOCK_TOKENS, MOE_CAPACITY_FACTOR = 32, 2.0
# the LM-zoo phase: the five smoke archs against the JAX reference's
# golden file; Qwen3-MoE-30B-A3B at full width and depth through serve_lm
# with the LM traffic above; full-width cuts (depth, or None: whole), the
# prefill on K8 against the plain path and decode against prefill within
# LM_CUT_REL_L2, the MoE capacity raised to a slot per token for the
# latter; K8 at the zoo's new shapes (B, S, H, KH, Dh)
LM_ZOO_GOLDEN = ROOT / "src" / "repro_torch" / "golden" \
    / "lm_zoo_reference.npz"
LM_ZOO_ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
                "jamba-1.5-large-398b", "whisper-medium", "pixtral-12b")
ZOO_FULL_ARCH = "qwen3-moe-30b-a3b"
ZOO_CUTS = (("qwen3-moe-30b-a3b", 4), ("llama4-maverick-400b-a17b", 2),
            ("whisper-medium", None), ("pixtral-12b", None))
K8_ZOO_SHAPES = {"qwen3-moe-30b-a3b": (1, 512, 32, 4, 128),
                 "whisper-medium decoder": (1, 512, 16, 16, 64)}
# the training phase: the three smoke archs of the JAX reference's
# training golden (loss, every gradient leaf, one AdamW step with float32
# and with int8 states); Llama-3.2-3B and Mamba-2-1.3B at full width and
# depth, bf16, TRAIN_STEPS steps of batch_at traffic with float32 AdamW
# states, then one with int8 states; Llama-3.2-3B cut to TRAIN_CUT_LAYERS
# layers, the card's loss and gradients (kernels) against the CPU's
# (plain versions); the fault-tolerant loop at smoke size
TRAIN_GOLDEN = ROOT / "src" / "repro_torch" / "golden" \
    / "train_reference.npz"
TRAIN_GOLDEN_ARCHS = ("llama3.2-3b", "mamba2-1.3b", "qwen3-moe-30b-a3b")
TRAIN_STATES = ("float32", "int8")
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2, TRAIN_STEP_REL_L2 = 1e-5, 1e-4, 1e-5
TRAIN_FULL_ARCHS = ("llama3.2-3b", "mamba2-1.3b")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR, TRAIN_SEED = 2, 2048, 4, \
    3e-4, 13
TRAIN_CUT_LAYERS, TRAIN_CUT_SEQ, TRAIN_CUT_LOSS_RTOL = 2, 256, 1e-2
TRAIN_LOOP_STEPS, TRAIN_LOOP_FAIL_AT, TRAIN_LOOP_CKPT_EVERY = 12, 6, 4
# a training step's device time by kind of kernel, by name (the first
# kind whose marks a kernel's name holds)
TRAIN_KERNEL_KINDS = (
    ("flash_attention", ("flash_attention",)),
    ("causal_conv1d", ("causal_conv1d",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
    ("reduce", ("reduce", "softmax", "scan", "norm")),
    ("copy", ("copy", "cat", "index", "gather", "scatter")),
    ("elementwise", ("elementwise",)))
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


def device_events(prof):
    """The operations of a ``torch.profiler`` trace that took device
    time (kernels, copies, fills), without the device-side ranges of user
    annotations: the port's spans are ``record_function`` ranges, which
    the trace also lays on the device's timeline over the kernels they
    hold."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type != DeviceType.CPU and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, kernel_name: str | None = None, iters: int = 50):
    """Mean device time per call of the CUDA kernels whose name holds
    ``kernel_name`` (of every kernel the calls launch where it is None:
    a library call's own device time), from a ``torch.profiler`` trace
    of ``iters`` calls: the kernels alone, without the host's launch
    cost that the CUDA-event time of back-to-back calls includes.  None
    when the trace holds no device time for them (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in device_events(prof)
                   if kernel_name is None or kernel_name in e.name)
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
    """The kernels line's entry of a kernel that replaces a TPU kernel
    (``REPLACES``), which the kernel phases compare with its plain
    version and time; the launches alone of any other (the expert
    kernels, which phase 11 compares and times in its own numbers)."""
    e = {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": REPLACES.get(name), "launches": 0}
    if name in REPLACES:
        e.update(max_abs_err=0, equal=True, cases=[])
    return e


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
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine, _, _ = serve.run_cnn(serve_args(stem, PROFILED_REQUESTS))
        torch.cuda.synchronize()
    by_name, ops, torch_ops = {}, 0, 0
    for e in device_events(prof):
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


def drive(entries, label, want, fn):
    """Run one path ``fn()`` and read what it added to the launch
    counter (``kernels.build.LAUNCHES``) under every C entry and under
    ``expert_ffn_bmm``, into ``LAUNCHES[label]``; fail if an entry in
    ``want`` was not launched; add the entries' counts to the kernels'
    entries (a kernel's launches are those of all its entries,
    ``launches_by_entry`` keeps them apart).  The counts are differences
    across ``fn()``: the same as setting the counter to 0 before it and
    reading it after, without clearing what readers around the path
    have counted.  Returns what ``fn`` returns."""
    from repro_torch.kernels import build, moe_expert_gemm as meg
    before = build.LAUNCHES.copy()
    out = fn()
    launches = {k: build.LAUNCHES[k] - before[k]
                for k in (*build.ENTRIES, meg.BMM_FALLBACK)}
    missing = sorted(k for k in want if launches[k] < 1)
    if missing:
        raise AssertionError(f"{label}: {missing} never launched "
                             f"({launches})")
    LAUNCHES[label] = launches
    for k in build.ENTRIES:
        v = launches[k]
        kern = build.library_of(k)
        e = entries.setdefault(kern, kernel_entry(kern))
        e["launches"] += v
        by_path = e.setdefault("launches_by_path", {})
        by_path[label] = by_path.get(label, 0) + v
        if list(build.ENTRIES.values()).count(kern) > 1:
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


def _check_serve_launches(label, forwards, also=None):
    """Each plan's forwards (``{stem: n}``) launched their entries
    SERVE_LAUNCHES times per forward, each entry of ``also``
    (``{entry: n}``, another plan's) n times more, and nothing else."""
    got = LAUNCHES[label]
    for k, v in got.items():
        want = (also or {}).get(k, 0) + sum(
            SERVE_LAUNCHES[stem].get(k, 0) * n
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
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.ssm import ssm_dims

    torch.backends.cuda.matmul.allow_tf32 = False
    for k in ("causal_conv1d", "flash_attention"):
        entries.setdefault(k, kernel_entry(k))
    g = torch.Generator(device="cuda").manual_seed(8)

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
        case = k7_case(e, g, phase, b, s, c, kk,
                       with_state=phase == "decode")
        case["per_layer"] = reps
        layer = e["per_layer"][phase]
        layer["ms"] += reps * case["ms"]
        layer["device_ms"] = None if case["device_ms"] is None \
            or layer["device_ms"] is None \
            else layer["device_ms"] + reps * case["device_ms"]
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
    # (float32: the instantiation the float32 goldens run)
    with np.load(LM_GOLDEN) as z:
        gb, gs = z["llama3.2-3b/tokens"].shape
    scfg = smoke_config("llama3.2-3b")
    for b, s, h, kh, d, dtype in (
            (1, 512, 24, 8, 128, torch.bfloat16),
            (1, 300, 24, 8, 128, torch.bfloat16),
            (gb, gs, scfg.n_heads, scfg.n_kv_heads, scfg.head_dim,
             torch.float32)):
        case = k8_case(e, g, b, s, h, kh, d, dtype)
        if s == 512 or dtype == torch.float32:
            e["instantiations"][case["dtype"]] = case
        if s == 512:
            e.update({k_: case[k_] for k_ in TIMES + ("shape",)})


def k7_case(e, g, phase, b, s, c, kk, *, with_state):
    """K7 on bf16 x (b, s, c) with K = kk taps (and a state where asked)
    on the card: the kernel equal to its plain version, then timed as
    phase 3 times a kernel beside a depthwise ``F.conv1d``; the case is
    added to the kernel's entry ``e`` and returned."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv1d

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    x, w = randn(b, s, c), randn(kk, c)
    st = randn(b, kk - 1, c) if with_state else None
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
            "state": st is not None, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms}
    print(f"    ms={ms:.6f} device_ms={dev_ms} plain_ms={plain_ms:.6f} "
          f"bound_ms={b_ms:.6f} ({b_by}) library_ms={lib_ms:.6f} "
          f"library_device_ms={lib_dev_ms}")
    e["cases"].append(case)
    return case


def k8_case(e, g, b, s, h, kh, d, dtype):
    """K8 on (b, s, h, d) queries with kh kv heads, causal, on the card:
    the kernel against its plain version (``K8_BF16_TOL`` in bf16,
    ``K8_F32_TOL`` in float32), then timed as phase 3 times a kernel
    beside ``F.scaled_dot_product_attention``; the case is added to
    the kernel's entry ``e`` and returned."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

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
    # the causal half of 4·B·H·S·T·D, bf16 on the tensor cores, float32
    # on the CUDA cores
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
    return case


def _lm_golden_params(z, arch, cfg, device):
    from repro_torch import convert
    return convert.lm_params_from_numpy(
        convert.nested_from_flat(z, f"{arch}/params"), cfg, device)


def _attention_and_mamba_layers(cfg):
    """(decoder attention sublayers that take K8 in prefill, Mamba
    sublayers) of ``cfg``: local attention keeps the chunked path."""
    from repro_torch.configs.base import ATTN, MAMBA
    return (sum(s.mixer == ATTN for s in cfg.layer_cycle) * cfg.n_cycles,
            sum(s.mixer == MAMBA for s in cfg.layer_cycle) * cfg.n_cycles)


def _frontend_batch(cfg, tokens, rng):
    """``tokens`` and the numpy-made modality input ``cfg`` takes
    (``0.1 * standard_normal``, (B, frontend_len, d_model))."""
    import numpy as np
    batch = {"tokens": tokens}
    names = (("frames",) if cfg.enc_dec else ()) \
        + (("patches",) if cfg.frontend == "vision" else ())
    for name in names:
        batch[name] = (0.1 * rng.standard_normal(
            (tokens.shape[0], cfg.frontend_len, cfg.d_model))) \
            .astype(np.float32)
    return batch


def _pad_attention_cache(cache, n):
    import torch
    for entry in cache.values():
        for name in ("k", "v"):
            if name in entry:
                entry[name] = torch.nn.functional.pad(entry[name],
                                                      (0, 0, 0, 0, 0, n))
    return cache


def lm_golden(entries, path, archs, label):
    """Phases 10 and 12 (a): smoke archs at float32 on the card against
    the JAX reference's committed outputs in ``path``: logits within
    LM_GOLDEN_TOL (a vision prefix counted in the decode positions), the
    greedy engine tokens equal where the file holds them, K8 once per
    attention layer per prefill and never in decode, K7
    K7_PER_MAMBA_LAYER times per Mamba layer per call; the expert
    kernels (a float32 gated SiLU MoE MLP in inference takes them)
    launched by every arch with MoE layers and by no other
    (``drive``'s counts of the expert entries)."""
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import build, moe_expert_gemm as meg
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, Request, ServeConfig

    with np.load(path) as z:
        golden = {k: z[k] for k in z.files}
    out = {}
    for arch in archs:
        cfg = smoke_config(arch).with_overrides(dtype="float32")
        model = build_model(cfg, "cuda")
        params = _lm_golden_params(golden, arch, cfg, "cuda")
        attn, mamba = _attention_and_mamba_layers(cfg)
        batch = {"tokens": golden[f"{arch}/tokens"]}
        for name in ("frames", "patches"):
            if f"{arch}/{name}" in golden:
                batch[name] = golden[f"{arch}/{name}"]
        pos = golden[f"{arch}/decode_pos"]
        start = batch["tokens"].shape[1] - len(pos)
        want = ({"flash_attention"} if attn else set()) \
            | ({"causal_conv1d"} if mamba else set())

        def counted(fn):
            k7 = build.LAUNCHES["causal_conv1d"]
            k8 = build.LAUNCHES["flash_attention"]
            res = fn()
            return res, (build.LAUNCHES["flash_attention"] - k8,
                         build.LAUNCHES["causal_conv1d"] - k7)

        def run():
            errs, calls = [], []
            (logits, _), n = counted(lambda: model.prefill(params, batch))
            calls.append(("prefill", n))
            errs.append(np.abs(logits.cpu().numpy()
                               - golden[f"{arch}/prefill_logits"]).max())
            (_, cache), n = counted(lambda: model.prefill(
                params, dict(batch, tokens=batch["tokens"][:, :start])))
            calls.append(("prefill", n))
            cache = _pad_attention_cache(cache, len(pos))
            for i, p in enumerate(pos):
                t = start + i
                (logits, cache), n = counted(lambda: model.decode_step(
                    params, cache, batch["tokens"][:, t:t + 1], int(p)))
                calls.append(("decode", n))
                errs.append(np.abs(logits.cpu().numpy()
                                   - golden[f"{arch}/decode_logits"][i])
                            .max())
            tokens = None
            if f"{arch}/engine_prompts" in golden:
                reqs = [Request(prompt=[int(t) for t in p], request_id=i)
                        for i, p in enumerate(
                            golden[f"{arch}/engine_prompts"])]
                Engine(model, params, ServeConfig(
                    max_batch=2, max_len=32, max_new_tokens=5,
                    admission="lockstep")).run(reqs)
                tokens = [r.out_tokens for r in reqs]
            return float(max(errs)), calls, tokens

        err, calls, tokens = drive(entries, f"{label} {arch}", want, run)
        experts = sum(LAUNCHES[f"{label} {arch}"][e] for e in meg.ENTRIES)
        if (experts > 0) != (cfg.moe is not None):
            raise AssertionError(f"{arch}: the expert kernels launched "
                                 f"{experts} times (MoE layers: "
                                 f"{cfg.moe is not None})")
        print(f"[{label} {arch}] expert kernel launches {experts}")
        for kind, (k8, k7) in calls:
            if k8 != (attn if kind == "prefill" else 0) \
                    or k7 != K7_PER_MAMBA_LAYER * mamba:
                raise AssertionError(
                    f"{arch} {kind}: K8 launched {k8} times (want "
                    f"{attn if kind == 'prefill' else 0}), K7 {k7} (want "
                    f"{K7_PER_MAMBA_LAYER * mamba})")
        same = tokens is None \
            or tokens == golden[f"{arch}/engine_tokens"].tolist()
        out[arch] = {"max_abs_err": err, "engine_tokens_equal":
                     None if tokens is None else same,
                     "k8_per_prefill": attn, "k7_per_call":
                     K7_PER_MAMBA_LAYER * mamba,
                     "moe_expert_launches": experts}
        print(f"[{label}] {arch} float32 on the card: logits "
              f"max_abs_err {err:.3e} (tolerance {LM_GOLDEN_TOL}), K8 "
              f"{attn} per prefill and 0 per decode step, K7 "
              f"{K7_PER_MAMBA_LAYER * mamba} per call, greedy tokens "
              f"equal {out[arch]['engine_tokens_equal']}")
        if err > LM_GOLDEN_TOL or not same:
            raise AssertionError(f"{arch}: the card differs from the JAX "
                                 f"golden (err {err}, tokens {tokens})")
        del params, model
    return out


def lm_decode_profile(model, params, prompts):
    """Device time per decode step from a profiler trace of
    LM_PROFILED_STEPS steps of a full pool of ``prompts`` (prefilled and
    stepped once untraced)."""
    import torch
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
    for ev in device_events(prof):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total
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


def serve_full_width(entries, cfg, label, warm_up):
    """The launcher's ``serve_lm`` for ``cfg`` at full width, bf16, with
    the LM traffic, after ``warm_up()`` (untimed), the launches it adds
    to the counter read under ``label``: K8 once per
    attention layer per prefill and never in decode, K7
    K7_PER_MAMBA_LAYER times per Mamba layer per prefill and decode step
    (the per-slot Engine's steps are CUDA-graph replays, which
    ``DecodeGraph`` adds to the counter); every request served whole.
    Returns (the numbers: times, tokens/s, peak memory, the decode
    step's byte bound and a decode profile; the engine, which holds the
    model and its weights)."""
    import torch
    from repro_torch.launch import serve

    warm_up()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        engine, reqs, dt = serve.serve_lm(
            cfg, requests=LM_REQUESTS, prompt_len=LM_PROMPT,
            new_tokens=LM_NEW, max_batch=LM_MAX_BATCH, device="cuda")
        # the rest of the call: model build, weight draw, requests
        return engine, reqs, dt, time.perf_counter() - t0 - dt
    attn, mamba = _attention_and_mamba_layers(cfg)
    want = ({"flash_attention"} if attn else set()) \
        | ({"causal_conv1d"} if mamba else set())
    engine, reqs, dt, setup_s = drive(entries, label, want, run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    params = engine.params
    t = engine.timings()
    k7 = entries["causal_conv1d"]["launches_by_path"][label]
    k8 = entries["flash_attention"]["launches_by_path"][label]
    if k8 != attn * t["prefills"]:
        raise AssertionError(f"{cfg.name}: flash_attention launched {k8} "
                             f"times, want {attn} per prefill x "
                             f"{t['prefills']} and none in decode")
    if k7 != K7_PER_MAMBA_LAYER * mamba * (t["prefills"]
                                           + t["decode_steps"]):
        raise AssertionError(
            f"{cfg.name}: causal_conv1d launched {k7} times, want "
            f"{K7_PER_MAMBA_LAYER} per Mamba layer ({mamba}) per prefill "
            f"and decode step ({t['prefills']} + {t['decode_steps']})")
    if not all(r.done and len(r.out_tokens) == LM_NEW
               and all(0 <= x < cfg.vocab_size for x in r.out_tokens)
               for r in reqs):
        raise AssertionError(f"{cfg.name}: a request was not served whole")
    tokens = sum(len(r.out_tokens) for r in reqs)
    decoded = tokens - t["prefills"]   # each prefill samples one token
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    # a decode step reads every weight but the embedding (rows of it)
    step_bound_ms = (weight_bytes - params["embed"].numel()
                     * params["embed"].element_size()) \
        / HBM_BYTES_PER_S * 1e3
    res = {
        "params": sum(x.numel() for x in _leaves(params)),
        "weight_gb": weight_bytes / 1e9,
        "setup_s": setup_s, "layers": cfg.n_layers,
        "requests": LM_REQUESTS, "prompt_len": LM_PROMPT,
        "new_tokens": LM_NEW, "max_batch": LM_MAX_BATCH,
        "seconds": dt, "tokens_per_s": tokens / dt,
        "prefills": t["prefills"], "decode_steps": t["decode_steps"],
        "prefill_ms_per_request": t["prefill_s"] * 1e3 / t["prefills"],
        "prefill_tokens_per_s": t["prefills"] * LM_PROMPT / t["prefill_s"],
        "decode_ms_per_step": t["decode_s"] * 1e3 / t["decode_steps"],
        "decode_tokens_per_s": decoded / t["decode_s"],
        "decode_step_bound_ms": step_bound_ms,
        "launches": {"flash_attention": k8, "causal_conv1d": k7},
        "peak_memory_gb": peak_gb}
    prof = lm_decode_profile(engine.model, params, [r.prompt for r in reqs])
    if prof is not None:
        prof["idle_share"] = 1.0 - prof["device_ms_per_step"] \
            / res["decode_ms_per_step"]
        # untraced wall time per device operation the step enqueues
        prof["wall_us_per_device_op"] = res["decode_ms_per_step"] \
            * 1e3 / prof["device_ops_per_step"]
        prof["bound_share"] = step_bound_ms / prof["device_ms_per_step"]
    res["decode_profile"] = prof
    return res, engine


def lm_full_width(entries):
    """Phase 10, full width: the launcher's ``serve_lm`` for both archs at
    full width and depth, bf16, each after one untimed pass of the same
    serving.  Returns the numbers per arch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    out = {}
    for arch in LM_ARCHS:
        cfg = get_config(arch)

        def warm_up():
            serve.serve_lm(cfg, requests=LM_REQUESTS, prompt_len=LM_PROMPT,
                           new_tokens=LM_NEW, max_batch=LM_MAX_BATCH,
                           device="cuda")
        res, engine = serve_full_width(entries, cfg,
                                       f"lm full width {arch}", warm_up)
        out[arch] = res
        print(f"[lm full width] {arch}: {json.dumps(res)}")
        del engine
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


def _moe_trace(compiled, xb):
    """The activations of one bucketed dispatch of the numpy blocks
    ``xb`` through ``compiled``'s own prepared (layer, bucket) launches,
    on its device: ``[x, after layer 0, ..., output]`` as numpy."""
    import numpy as np
    import torch
    n = xb.shape[0]
    bucket = compiled.bucket_for(n)
    act = torch.from_numpy(np.concatenate(
        [xb, np.zeros((bucket - n,) + xb.shape[1:], np.float32)])) \
        .to(compiled.device)
    acts = [np.asarray(xb)]
    for i in range(compiled.num_layers):
        act = compiled._compile_layer(i, bucket)(compiled.params[i], act)
        acts.append(act.cpu().numpy()[:n])
    return acts


def _rel_l2(a, b):
    import numpy as np
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def _moe_against_golden(label, acts, golden_acts, bits):
    """End to end against the golden: the blocks no flip moved within
    MOE_ATOL and MOE_REL_L2; returns the numbers for the JSON line."""
    import numpy as np
    from repro_torch.runtime.workloads import fake_quant_flips
    flips = fake_quant_flips(acts, golden_acts, bits, atol=MOE_ATOL)
    keep = [r for r in range(len(acts[-1])) if r not in {f[0] for f in flips}]
    y, g = acts[-1][keep], golden_acts[-1][keep]
    err, rel = float(np.abs(y - g).max()), _rel_l2(y, g)
    if rel > MOE_REL_L2:
        raise AssertionError(f"{label}: relative L2 {rel} > {MOE_REL_L2}")
    allrel = _rel_l2(acts[-1], golden_acts[-1])
    print(f"[moe golden] {label}: {len(keep)} of {len(acts[-1])} blocks "
          f"within atol {MOE_ATOL} (max_abs_err {err:.3e}, relative L2 "
          f"{rel:.3e}); {len(flips)} moved by a fake-quant rounding flip "
          f"[block, layer, token, channel]: {flips}; relative L2 over all "
          f"8 blocks {allrel:.3e}")
    return {"max_abs_err": err, "rel_l2": rel, "rel_l2_all": allrel,
            "flips": flips}


def moe_golden_on_card(entries, smi):
    """Phase 11, golden: the JAX reference's smoke MoE plan on its
    weights, layer by layer, through ``CNNEngine`` and through one
    gateway beside the quickstart CNN plan."""
    import asyncio
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core import deploy
    from repro_torch.launch import serve
    from repro_torch.runtime import (CompiledMoE, ExecutableCache,
                                     load_plan, moe_plan_spec)
    from repro_torch.serve import (AsyncCNNGateway, AsyncServeConfig,
                                   CNNEngine, CNNServeConfig, ImageRequest)

    with np.load(MOE_GOLDEN) as z:
        plan = deploy.DeploymentPlan.from_json(str(z["plan"]))
        spec = moe_plan_spec(plan)
        arrays = [{k.split("/")[-1]: z[k] for k in z.files
                   if k.startswith(f"params/L{i}/")}
                  for i in range(len(spec.layers))]
        xs, golden_acts = z["x"], list(z["layer_in"]) + [z["y"]]
    params = convert.moe_params_from_numpy(arrays, spec, "cuda")
    bits = [s.data_bits for s in spec.layers]
    compiled = CompiledMoE(spec, params, max_batch=MOE_GOLDEN_MAX_BATCH,
                           device="cuda")

    # each layer at each bucket on the reference's input to it
    layer_err, layer_rel = 0.0, 0.0
    for lo, hi in MOE_DISPATCHES:
        bucket = compiled.bucket_for(hi - lo)
        for i in range(compiled.num_layers):
            x = golden_acts[i][lo:hi]
            xp = torch.from_numpy(np.concatenate(
                [x, np.zeros((bucket - len(x),) + x.shape[1:],
                             np.float32)])).cuda()
            y = compiled._compile_layer(i, bucket)(compiled.params[i], xp) \
                .cpu().numpy()[:len(x)]
            want = golden_acts[i + 1][lo:hi]
            err, rel = float(np.abs(y - want).max()), _rel_l2(y, want)
            if err > MOE_ATOL or rel > MOE_REL_L2:
                raise AssertionError(
                    f"moe golden layer {i} at bucket {bucket}: "
                    f"max_abs_err {err}, relative L2 {rel}")
            layer_err, layer_rel = max(layer_err, err), max(layer_rel, rel)
    print(f"[moe golden] each layer at buckets 1, 2, 4 on the reference's "
          f"input: max_abs_err {layer_err:.3e}, relative L2 "
          f"{layer_rel:.3e} (tolerance {MOE_ATOL}, {MOE_REL_L2})")
    traces = [_moe_trace(compiled, xs[lo:hi]) for lo, hi in MOE_DISPATCHES]
    acts = [np.concatenate(layer) for layer in zip(*traces)]
    res = {"layers": {"max_abs_err": layer_err, "rel_l2": layer_rel}}

    def served_equal_trace(label, ys):
        err = float(np.abs(np.stack(ys) - acts[-1]).max())
        if err > 1e-6:
            raise AssertionError(f"{label}: served blocks differ from the "
                                 f"layer trace of the same dispatches by "
                                 f"{err}")
        return err

    # the sync engine, one golden dispatch per run
    engine = CNNEngine(serve_cfg=CNNServeConfig(
        max_batch=MOE_GOLDEN_MAX_BATCH), compiled=compiled)
    reqs = [ImageRequest(image=x, request_id=i) for i, x in enumerate(xs)]

    def run_engine():
        for lo, hi in MOE_DISPATCHES:
            engine.run(reqs[lo:hi])
        return [r.output for r in reqs]
    ys = drive(entries, "moe golden engine", set(), run_engine)
    served_equal_trace("moe golden engine", ys)
    res["engine"] = _moe_against_golden("CNNEngine", acts, golden_acts, bits)

    # one gateway: the quickstart CNN plan (K1) beside the MoE plan
    cnn_path = PLANS / f"{UNPINNED}.json"
    cnn_plan = load_plan(cnn_path)
    gw = AsyncCNNGateway(AsyncServeConfig(max_batch=MOE_GOLDEN_MAX_BATCH,
                                          max_pending=32),
                         exec_cache=ExecutableCache())
    gw.register_plan(cnn_plan, plan_id="cnn", device="cuda",
                     params=serve.load_params(
                         GOLDEN, cnn_path, deploy.plan_config(cnn_plan),
                         "cuda"))
    gw.register_plan(plan, plan_id="moe", device="cuda", params=params)
    with np.load(GOLDEN) as golden:
        gx, gy = golden[f"{UNPINNED}.x"], golden[f"{UNPINNED}.y"]

    async def both():
        async with gw:
            moe_out, cnn_out = [], []
            for k, (lo, hi) in enumerate(MOE_DISPATCHES):
                # one loop turn admits the whole dispatch
                futs = [gw.submit_nowait(xs[r], plan_id="moe")
                        for r in range(lo, hi)]
                cfuts = [gw.submit_nowait(gx[2 * k + j], plan_id="cnn")
                         for j in range(2)]
                moe_out += await asyncio.gather(*futs)
                cnn_out += await asyncio.gather(*cfuts)
            refused = []
            for x, pid in ((xs[0], "cnn"), (gx[0], "moe")):
                try:
                    await gw.submit(x, plan_id=pid)
                except ValueError as e:
                    refused.append(str(e).split(":")[1].strip()[:40])
            return moe_out, cnn_out, refused

    label = "moe gateway beside cnn"
    moe_out, cnn_out, refused = drive(
        entries, label, {"fused_dot_layer_requant"},
        lambda: asyncio.run(both()))
    hits = dict(gw.plans["moe"].compiled.bucket_hits)
    if hits != {1: 2, 2: 1, 4: 1}:
        raise AssertionError(f"{label}: MoE dispatches {hits}, want the "
                             f"golden's buckets 1, 2, 4, 1")
    cnn_forwards = sum(gw.plans["cnn"].compiled.bucket_hits.values())
    # the MoE plan's float32 expert products: each entry once a layer a
    # forward, no ``expert_ffn_bmm``
    moe_launches = gw.plans["moe"].compiled.num_layers * sum(hits.values())
    _check_serve_launches(label, {UNPINNED: cnn_forwards},
                          {"moe_expert_gemm_gate_up": moe_launches,
                           "moe_expert_gemm_down": moe_launches})
    if not np.array_equal(np.stack(cnn_out), gy):
        raise AssertionError(f"{label}: the CNN outputs differ from the JAX "
                             f"reference's golden")
    if len(refused) != 2:
        raise AssertionError(f"{label}: admission refused {refused}, want "
                             f"a MoE block on the CNN plan and an image on "
                             f"the MoE plan")
    served_equal_trace(label, moe_out)
    res["gateway"] = _moe_against_golden("gateway beside quickstart_v5e",
                                         acts, golden_acts, bits)
    res["gateway"].update({"moe_bucket_hits": hits,
                           "cnn_forwards": cnn_forwards,
                           "refused": refused})
    print(f"[moe golden] gateway: {len(cnn_out)} CNN outputs equal the JAX "
          f"golden beside the MoE plan; refused {refused}; on {smi}")
    return res


def _expert_bound(e, cap, d, f, itemsize=4, rate=FP32_FLOPS_PER_S):
    """(bound_ms, bound_by, flops) of a layer's three expert products
    (e × cap × d by e × d × f twice, then e × cap × f by e × f × d) at
    ``itemsize`` bytes an element: the buffer and the three weights read
    once, the output written once, against 2·e·cap·d·f multiply-adds per
    product at ``rate`` (float32 outside the tensor cores by default)."""
    nbytes = itemsize * (e * cap * d + 3 * e * d * f + e * cap * d)
    flops = 3 * 2 * e * cap * d * f
    return _lm_bound(nbytes, flops, rate) + (flops,)


def _useful_expert_bound(fill, d, f, part="ffn", itemsize=4,
                         rate=FP32_FLOPS_PER_S):
    """(bound_ms, bound_by, flops) of a layer's expert products over the
    filled rows alone: ``sum(fill)`` rows by each weight (2·d·f
    multiply-adds a row each), against each weight of every expert that
    holds a row read once and the filled rows read and written.  ``part``
    is "ffn" (the three products: x in, y out), "gate_up" (W_gate and
    W_up: x in, h out) or "down" (W_down: h in, y out)."""
    weights, row_io = {"ffn": (3, 2 * d), "gate_up": (2, d + f),
                       "down": (1, f + d)}[part]
    used, rows = int((fill > 0).sum()), int(fill.sum())
    flops = weights * 2 * rows * d * f
    nbytes = itemsize * (weights * used * d * f + rows * row_io)
    return _lm_bound(nbytes, flops, rate) + (flops,)


def _unless_lost(res, key, bound_ms, label):
    """Set the device time ``res[key]`` to None where it reads below
    ``bound_ms``: less than the least time the card could take means the
    trace lost events, so the reading is not a measurement (it is kept
    under ``<key>_lost_events``)."""
    if res[key] is not None and res[key] < bound_ms:
        print(f"[{label}] {key} reads {res[key]} ms, below its bound "
              f"{bound_ms} ms: the trace lost events, not measured")
        res[f"{key}_lost_events"], res[key] = res[key], None


def _filled_rows(fill, cap):
    """(E, C, 1): whether each row of each expert's buffer holds a
    token."""
    import torch
    return (torch.arange(cap, device=fill.device)[None, :]
            < fill[:, None])[..., None]


def _seeded_fill(e, k, n, cap, d, seed):
    """Each expert's fill at a dispatch of ``n`` unit-normal tokens
    through a unit-normal router / sqrt(d): the layer's own routing."""
    import torch
    from repro_torch.models import moe as moe_mod
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, generator=g, device="cuda")
    router = torch.randn(d, e, generator=g, device="cuda") / d ** 0.5
    _, _, ids = moe_mod._route(x, router, k)
    return torch.clamp(moe_mod._expert_counts(ids.reshape(-1), e), max=cap)


def moe_expert_kernels(smi):
    """Phase 11, the expert kernels: ``moe_expert_gemm_gate_up`` and
    ``_down`` against their plain version (``expert_ffn_bmm``, which
    ``_expert_ffn`` runs where they do not) on the card on the filled
    rows (rows past the fill pre-set to NaN in the buffer and the
    hidden activations; MOE_KERNEL_TOL), at the benchmark cell's layer
    (bucket 16), at the small bucket 1 and at a ragged shape (two row
    tiles, widths not a multiple of the column slices), then timed at
    both buckets against the three ``torch.bmm`` (``library_ms``; the
    plain version is the same call), with the bound over the filled
    rows; a device time below its bound is not measured
    (``_unless_lost``).  Returns the numbers."""
    import torch
    from repro_torch.kernels import moe_expert_gemm as meg
    from repro_torch.models import moe as moe_mod

    def case(e, cap, d, f, fill, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(e, cap, d, generator=g, device="cuda")
        ws = {"w_gate": torch.randn(e, d, f, generator=g, device="cuda")
              / d ** 0.5,
              "w_up": torch.randn(e, d, f, generator=g, device="cuda")
              / d ** 0.5,
              "w_down": torch.randn(e, f, d, generator=g, device="cuda")
              / f ** 0.5}
        empty = ~_filled_rows(fill, cap)
        x.masked_fill_(empty, float("nan"))
        return x, ws, empty

    def check(label, x, ws, fill, empty):
        hs = []
        y_plain = meg.expert_ffn_bmm(x, ws["w_up"], ws["w_down"],
                                     ws["w_gate"],
                                     mid=lambda h: hs.append(h) or h)
        h_plain = hs[0]
        n0 = meg.launches()
        h = meg.moe_expert_gemm_gate_up(x, ws["w_gate"], ws["w_up"], fill)
        y = meg.moe_expert_gemm_down(h_plain.masked_fill(empty, float("nan")),
                                     ws["w_down"], fill)
        y2 = meg.moe_expert_ffn(x, ws["w_gate"], ws["w_up"], ws["w_down"],
                                fill)
        torch.cuda.synchronize()
        if meg.launches() - n0 != 4:
            raise AssertionError(f"moe expert kernels {label}: "
                                 f"{meg.launches() - n0} "
                                 f"launches, not 4")
        errs = {}
        for name, got, want in (("gate_up", h, h_plain), ("down", y, y_plain),
                                ("ffn", y2, y_plain)):
            rows = ~empty.expand_as(got)
            g_, w_ = got[rows], want[rows]
            if not torch.isfinite(g_).all():
                raise AssertionError(f"moe expert kernels {label} {name}: "
                                     f"a filled row is not finite")
            errs[name] = float((g_ - w_).abs().max()) if g_.numel() else 0.0
            if not torch.allclose(g_, w_, **MOE_KERNEL_TOL):
                raise AssertionError(f"moe expert kernels {label} {name}: "
                                     f"max abs err {errs[name]}")
        return errs

    out = {"card": smi, "tol": MOE_KERNEL_TOL, "cases": []}
    e, k, d, f = 128, 8, 2048, 768
    for label, bucket, seed in (("bucket 16", 16, MOE_SEED),
                                ("bucket 1", 1, MOE_SEED + 1)):
        n = bucket * MOE_BLOCK_TOKENS
        cap = moe_mod._capacity(MOE_CAPACITY_FACTOR, n, k, e)
        fill = _seeded_fill(e, k, n, cap, d, seed)
        x, ws, empty = case(e, cap, d, f, fill, seed)
        errs = check(label, x, ws, fill, empty)
        xz = torch.nan_to_num(x, nan=0.0)

        def kernels():
            return meg.moe_expert_ffn(xz, ws["w_gate"], ws["w_up"],
                                      ws["w_down"], fill)

        def bmm():
            return meg.expert_ffn_bmm(xz, ws["w_up"], ws["w_down"],
                                      ws["w_gate"])
        b_ms, b_by, flops = _useful_expert_bound(fill, d, f)
        res = {"label": label, "shape": [e, cap, d, f],
               "filled_rows": int(fill.sum()),
               "filled_share": float(fill.sum()) / (e * cap),
               "max_fill": int(fill.max()), "max_abs_err": errs,
               "ms": time_ms(kernels, 20),
               "device_ms": device_ms(kernels, "moe_expert_gemm", iters=10),
               "gate_up_device_ms": device_ms(
                   kernels, "moe_expert_gemm_kernel<true>", iters=10),
               "down_device_ms": device_ms(
                   kernels, "moe_expert_gemm_kernel<false>", iters=10),
               "library_ms": time_ms(bmm, 20),
               "library_device_ms": device_ms(bmm, iters=10),
               "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9}
        tag = f"moe expert kernels {label}"
        _unless_lost(res, "device_ms", b_ms, tag)
        for part in ("gate_up", "down"):
            _unless_lost(res, f"{part}_device_ms",
                         _useful_expert_bound(fill, d, f, part)[0], tag)
        _unless_lost(res, "library_device_ms",
                     _expert_bound(e, cap, d, f)[0], tag)
        if res["device_ms"]:
            res["bound_share"] = b_ms / res["device_ms"]
        out["cases"].append(res)
        print(f"[moe expert kernels] {label}: {json.dumps(res)}")
        del x, xz, ws
        torch.cuda.empty_cache()
    # two row tiles, ragged widths (masked columns and K), drops
    e, cap, d, f = 6, 100, 132, 100
    fill = torch.tensor([0, 1, 7, 8, 9, 130], device="cuda")
    x, ws, empty = case(e, cap, d, f, fill, MOE_SEED + 2)
    errs = check("ragged", x, ws, fill, empty)
    out["cases"].append({"label": "ragged", "shape": [e, cap, d, f],
                         "fill": fill.tolist(), "max_abs_err": errs})
    print(f"[moe expert kernels] ragged {[e, cap, d, f]} fills "
          f"{fill.tolist()}: max abs err {errs}")
    out["bf16"] = moe_expert_kernels_bf16(smi)
    return out


def moe_expert_kernels_bf16(smi):
    """Phase 11, the bf16 expert kernels at Qwen3-30B-A3B's widths
    (E 128, top 8, d 2048, f 768, dropless: capacity n): at a decode
    step of 8 tokens and a prefill of 1,108, on a seeded routing's
    fills, each held to float32 products of the same bf16 inputs on the
    filled rows (MOE_BF16_TOL relative L2, and no further than the three
    bf16 ``torch.bmm``), then timed against those ``torch.bmm``
    (``library_ms``) beside the bound of the experts that hold a row
    and the bound of all of them, with the mean count of experts that
    hold a row over MOE_BF16_FILL_SEEDS routings.  Returns the
    numbers."""
    import torch
    from repro_torch.kernels import moe_expert_gemm as meg
    from repro_torch.models import moe as moe_mod

    def rel_l2(got, want, rows):
        got, want = got[rows].float(), want[rows].float()
        return float((got - want).norm() / want.norm())

    e, k, d, f = 128, 8, 2048, 768
    out = {"card": smi, "tol_rel_l2": MOE_BF16_TOL, "cases": []}
    for label, n in MOE_BF16_CASES:
        cap = moe_mod._capacity(e / k, n, k, e)
        live = [int((_seeded_fill(e, k, n, cap, d, MOE_SEED + 100 + s)
                     > 0).sum()) for s in range(MOE_BF16_FILL_SEEDS)]
        fill = _seeded_fill(e, k, n, cap, d, MOE_SEED + 3)
        g = torch.Generator(device="cuda").manual_seed(MOE_SEED + 3)
        filled = _filled_rows(fill, cap)
        x = torch.randn(e, cap, d, generator=g, device="cuda") \
            .masked_fill(~filled, 0).bfloat16()
        ws = {name: (torch.randn(e, *shape, generator=g, device="cuda")
                     / shape[0] ** 0.5).bfloat16()
              for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                                  ("w_down", (f, d)))}
        rows = n * k

        def kernels():
            return meg.moe_expert_ffn(x, ws["w_gate"], ws["w_up"],
                                      ws["w_down"], fill, rows)

        def bmm():
            return meg.expert_ffn_bmm(x, ws["w_up"], ws["w_down"],
                                      ws["w_gate"])
        xf = x.float()
        h32 = torch.nn.functional.silu(torch.bmm(xf, ws["w_gate"].float())) \
            * torch.bmm(xf, ws["w_up"].float())
        y32 = torch.bmm(h32, ws["w_down"].float())
        del xf, h32
        n0 = meg.launches()
        y = kernels()
        torch.cuda.synchronize()
        if meg.launches() - n0 != 2:
            raise AssertionError(f"moe expert kernels bf16 {label}: "
                                 f"{meg.launches() - n0} "
                                 f"launches, not 2")
        r = filled.expand_as(y)
        err, err_bmm = rel_l2(y, y32, r), rel_l2(bmm(), y32, r)
        if not (torch.isfinite(y[r]).all() and err <= MOE_BF16_TOL
                and err <= err_bmm):
            raise AssertionError(f"moe expert kernels bf16 {label}: relative "
                                 f"L2 {err} (torch.bmm {err_bmm}, limit "
                                 f"{MOE_BF16_TOL})")
        del y, y32
        b_ms, b_by, flops = _useful_expert_bound(fill, d, f, itemsize=2,
                                                 rate=BF16_FLOPS_PER_S)
        all_ms, all_by, _ = _expert_bound(e, cap, d, f, 2, BF16_FLOPS_PER_S)
        res = {"label": label, "shape": [e, cap, d, f], "rows_bound": rows,
               "filled_rows": int(fill.sum()),
               "experts_with_rows": int((fill > 0).sum()),
               "experts_with_rows_mean": sum(live) / len(live),
               "experts_with_rows_seeds": live, "max_fill": int(fill.max()),
               "rel_l2": err, "library_rel_l2": err_bmm,
               "ms": time_ms(kernels, 20),
               "device_ms": device_ms(kernels, "moe_expert_gemm_bf16",
                                      iters=10),
               "gate_up_device_ms": device_ms(
                   kernels, "moe_expert_gemm_bf16_kernel<true>", iters=10),
               "down_device_ms": device_ms(
                   kernels, "moe_expert_gemm_bf16_kernel<false>", iters=10),
               "library_ms": time_ms(bmm, 20),
               "library_device_ms": device_ms(bmm, iters=10),
               "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
               "all_experts_bound_ms": all_ms, "all_experts_bound_by": all_by}
        tag = f"moe expert kernels bf16 {label}"
        _unless_lost(res, "device_ms", b_ms, tag)
        for part in ("gate_up", "down"):
            _unless_lost(res, f"{part}_device_ms", _useful_expert_bound(
                fill, d, f, part, 2, BF16_FLOPS_PER_S)[0], tag)
        _unless_lost(res, "library_device_ms", all_ms, tag)
        if res["device_ms"]:
            res["bound_share"] = b_ms / res["device_ms"]
        out["cases"].append(res)
        print(f"[moe expert kernels bf16] {label}: {json.dumps(res)}")
        del x, ws
        torch.cuda.empty_cache()
    return out


def moe_full_width(entries, smi):
    """Phase 11, full width: the Qwen3-MoE-30B-A3B experts planned for
    ``v5e``, compiled at max_batch 16 on the card, against eager at every
    bucket, under sync-debug mode, then timed.  Returns the numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_expert_gemm as meg
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime import (CompiledMoE, moe_plan_spec,
                                     moe_workload_from_config,
                                     plan_moe_deployment)
    from repro_torch.runtime.workloads import (_dense_ref_forward,
                                               _eager_forward, _rel_rmse)
    from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest

    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the MoE path runs full float32")
    spec = moe_workload_from_config(get_config(MOE_ARCH))
    t0 = time.perf_counter()
    plan = plan_moe_deployment(
        spec, "v5e", target=0.8, on_infeasible="fallback",
        generator=torch.Generator(device="cuda").manual_seed(MOE_SEED))
    plan_s = time.perf_counter() - t0
    pspec = moe_plan_spec(plan)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    compiled = CompiledMoE.from_plan(
        plan, generator=torch.Generator(device="cuda").manual_seed(MOE_SEED),
        max_batch=MOE_MAX_BATCH, device="cuda")
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    weight_gb = sum(t.numel() * t.element_size() for p in compiled.params
                    for t in p.values()) / 1e9
    print(f"[moe full width] {MOE_ARCH} experts: {json.dumps(spec.to_payload())}"
          f"; v5e plan feasible {plan.feasible}, bits {plan.bits()}, "
          f"quant_error {plan.quant_error:.6f} (planned in {plan_s:.2f} s); "
          f"compiled at max_batch {MOE_MAX_BATCH} in {compile_s:.2f} s, "
          f"{weight_gb:.3f} GB of float32 weights")

    rng = np.random.default_rng(MOE_SEED)
    blocks = rng.standard_normal((MOE_MAX_BATCH,) + compiled.in_shape) \
        .astype(np.float32)
    xd = torch.from_numpy(blocks).cuda()
    per_bucket = {}
    for b in compiled.buckets:
        y = compiled(xd[:b])
        ye = _eager_forward(pspec, compiled.params, xd[:b])
        err = float((y - ye).abs().max())
        if not torch.allclose(y, ye, **MOE_EAGER_TOL):
            raise AssertionError(f"moe full width bucket {b}: compiled "
                                 f"differs from eager by {err}")
        per_bucket[b] = err
    float_params = pspec.init_params(
        torch.Generator(device="cuda").manual_seed(MOE_SEED),
        quantized=False)
    dense_rel = _rel_rmse(_eager_forward(pspec, compiled.params, xd[:1]),
                          _dense_ref_forward(pspec, float_params, xd[:1]))
    del float_params
    torch.cuda.empty_cache()
    print(f"[moe full width] compiled vs _eager_forward max_abs_err by "
          f"bucket {per_bucket} (rtol = atol = 1e-5); dense_ref_rel_err "
          f"{dense_rel:.6f}")

    # no host sync inside a forward
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        compiled(xd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[moe full width] one forward at bucket 16 under "
          "set_sync_debug_mode('error'): no host sync")

    n_tok = MOE_MAX_BATCH * compiled.in_shape[0]
    step_ms = time_ms(lambda: compiled(xd), 20)
    compiled(xd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(MOE_PROFILED_STEPS):
            compiled(xd)
        torch.cuda.synchronize()
    by_name, n_ops = {}, 0
    for ev in device_events(prof):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total
        n_ops += 1
    profile_res = None
    if by_name:
        busy = sum(by_name.values()) / 1e3 / MOE_PROFILED_STEPS
        gemm = sum(v for k, v in by_name.items() if "gemm" in k.lower()) \
            / 1e3 / MOE_PROFILED_STEPS
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        profile_res = {
            "device_ms_per_step": busy, "gemm_ms_per_step": gemm,
            "device_ops_per_step": n_ops / MOE_PROFILED_STEPS,
            "idle_share": 1.0 - busy / step_ms,
            "top_ms_per_step": [[k[:80], v / 1e3 / MOE_PROFILED_STEPS]
                                for k, v in top]}
    else:
        print("[moe full width] the trace holds no device time: not "
              "measured")

    # the layer's capacity at bucket 16 (phase 11's expert kernels time
    # its products)
    m = pspec.layers[0]
    cap = moe_mod._capacity(m.capacity_factor, n_tok, m.top_k,
                            m.num_experts)

    # 256 blocks through the sync engine at max_batch 16
    engine = CNNEngine(serve_cfg=CNNServeConfig(max_batch=MOE_MAX_BATCH),
                       compiled=compiled)
    xs = compiled.sample_inputs(MOE_TIMED_BLOCKS, seed=MOE_SEED)
    engine.run([ImageRequest(image=x, request_id=i)
                for i, x in enumerate(xs[:MOE_MAX_BATCH])])   # warm-up

    steps0 = engine.stats()["steps"]

    def serve_blocks():
        reqs = [ImageRequest(image=x, request_id=i)
                for i, x in enumerate(xs)]
        t0 = time.perf_counter()
        engine.run(reqs)
        return reqs, time.perf_counter() - t0
    forwards0 = sum(compiled.bucket_hits.values())
    reqs, dt = drive(entries, "moe full width engine", set(), serve_blocks)
    got = LAUNCHES["moe full width engine"]
    expert_calls = {"launches": sum(got[e] for e in meg.ENTRIES),
                    "bmm_fallbacks": got[meg.BMM_FALLBACK],
                    "forwards": sum(compiled.bucket_hits.values())
                    - forwards0, "layers": compiled.num_layers}
    if expert_calls["bmm_fallbacks"] or expert_calls["launches"] != \
            2 * expert_calls["layers"] * expert_calls["forwards"]:
        raise AssertionError(f"moe full width: the expert kernels did not "
                             f"run twice a layer a forward: {expert_calls}")
    print(f"[moe full width] expert products over {expert_calls['forwards']}"
          f" forwards of {expert_calls['layers']} layers: "
          f"expert kernel launches {expert_calls['launches']}, "
          f"bmm fallbacks {expert_calls['bmm_fallbacks']}")
    outs = np.stack([r.output for r in reqs])
    if not (all(r.done for r in reqs) and np.isfinite(outs).all()):
        raise AssertionError("moe full width: a block was not served whole")
    res = {"arch": MOE_ARCH, "spec": spec.to_payload(),
           "feasible": plan.feasible, "bits": plan.bits(),
           "quant_error": plan.quant_error, "plan_s": plan_s,
           "compile_s": compile_s, "weight_gb": weight_gb,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "eager_max_abs_err": per_bucket,
           "dense_ref_rel_err": dense_rel, "sync_free_forward": True,
           "ms_per_step_bucket16": step_ms,
           "tokens_per_s_bare": n_tok / step_ms * 1e3,
           "profile": profile_res, "expert_calls": expert_calls,
           "engine_blocks": MOE_TIMED_BLOCKS, "engine_s": dt,
           "engine_steps": engine.stats()["steps"] - steps0,
           "engine_tokens_per_s": MOE_TIMED_BLOCKS * compiled.in_shape[0]
           / dt, "card": smi}
    print(f"[moe full width] bucket 16 ({n_tok} tokens, capacity {cap}): "
          f"{step_ms:.6f} ms per step (CUDA events), "
          f"{res['tokens_per_s_bare']:.1f} tokens/s; profile "
          f"{json.dumps(profile_res)}; CNNEngine {MOE_TIMED_BLOCKS} blocks in "
          f"{dt:.4f} s, {res['engine_tokens_per_s']:.1f} tokens/s; on {smi}")
    del engine, compiled
    torch.cuda.empty_cache()
    return res


def zoo_full_width(entries, smi):
    """Phase 12 (b): Qwen3-MoE-30B-A3B at full width and depth, bf16,
    through ``serve_full_width`` after a warm-up of one layer at the same
    widths (the same kernels at the same shapes), then a
    decode step under sync-debug mode and one layer's expert products
    at the decode shape against their byte bound.  Returns the
    numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MOE
    from repro_torch.kernels import moe_expert_gemm as meg
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod

    cfg = get_config(ZOO_FULL_ARCH)

    def warm_up():
        serve.serve_lm(cfg.with_overrides(n_layers=1),
                       requests=LM_MAX_BATCH, prompt_len=LM_PROMPT,
                       new_tokens=2, max_batch=LM_MAX_BATCH, device="cuda")
    label = f"lm zoo full width {ZOO_FULL_ARCH}"
    res, engine = serve_full_width(entries, cfg, label, warm_up)
    res["card"] = smi
    # the bf16 MoE MLP in inference runs the bf16 expert kernels: no
    # torch.bmm (the served path's own counts, without the warm-up's)
    got = LAUNCHES[label]
    res["expert_calls"] = {"launches": sum(got[e] for e in meg.ENTRIES),
                           "bmm_fallbacks": got[meg.BMM_FALLBACK]}
    moe_layers = sum(s.mlp == MOE for s in cfg.layer_cycle) * cfg.n_cycles
    if res["expert_calls"]["bmm_fallbacks"] or \
            res["expert_calls"]["launches"] != 2 * moe_layers * (
                res["prefills"] + res["decode_steps"]):
        raise AssertionError(f"lm zoo full width: the bf16 MoE MLP did not "
                             f"run the expert kernels alone, twice an MoE "
                             f"layer ({moe_layers}) a prefill and a graphed "
                             f"decode step: {res['expert_calls']}")
    print(f"[lm zoo full width] {ZOO_FULL_ARCH} expert products: "
          f"expert kernel launches {res['expert_calls']['launches']}, "
          f"bmm fallbacks {res['expert_calls']['bmm_fallbacks']}")
    model, params = engine.model, engine.params

    # one decode step of the pool enqueues its work without a host sync
    cache = model.init_cache(LM_MAX_BATCH, LM_PROMPT + LM_NEW + 8)
    tok = torch.ones((LM_MAX_BATCH, 1), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(params, cache, tok, LM_PROMPT)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    res["sync_free_decode_step"] = True
    del cache

    # one layer's expert products at the decode step's shapes
    m = cfg.moe
    cap = moe_mod._capacity(m.capacity_factor, LM_MAX_BATCH, m.top_k,
                            m.num_experts)
    p0 = {k: v[0] for k, v in params["stack"]["s0"]["moe"].items()}
    buf = torch.randn(m.num_experts, cap, cfg.d_model, device="cuda") \
        .to(cfg.torch_dtype)

    def products():
        h = torch.bmm(buf, p0["w_up"])
        torch.bmm(buf, p0["w_gate"])
        return torch.bmm(h, p0["w_down"])
    b_ms, b_by, _ = _expert_bound(m.num_experts, cap, cfg.d_model,
                                  m.d_ff_expert, buf.element_size(),
                                  BF16_FLOPS_PER_S)
    bmm = {"shape": [m.num_experts, cap, cfg.d_model, m.d_ff_expert],
           "capacity": cap, "ms": time_ms(products, 20),
           "device_ms": device_ms(products, iters=10),
           "ffn_device_ms": device_ms(
               lambda: moe_mod._expert_ffn(buf, p0, cfg.act), iters=10),
           "bound_ms": b_ms, "bound_by": b_by}
    if bmm["device_ms"] is not None and bmm["device_ms"] < b_ms:
        # below the least time the card could take: back-to-back calls
        # find part of the weights in L2, or the trace lost events
        print(f"[lm zoo full width] the expert products' trace reads "
              f"{bmm['device_ms']} ms, below their bound: not measured")
        bmm["device_ms_below_bound"], bmm["device_ms"] = \
            bmm["device_ms"], None
    if bmm["device_ms"]:
        bmm["bound_share"] = b_ms / bmm["device_ms"]
        bmm["per_step_ms"] = bmm["device_ms"] * cfg.n_layers
    res["expert_products"] = bmm
    print(f"[lm zoo full width] {ZOO_FULL_ARCH}: {json.dumps(res)}")
    del buf, p0, params, model, engine
    torch.cuda.empty_cache()
    return res


class plain_attention:
    """Inside the block, the model's attention runs K8's plain version
    on the card in place of its kernel: the plain path a full-width
    prefill on the kernel is held against."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.models import attention
        self._mod, self._kernel = attention, attention.flash_attention
        attention.flash_attention = fa.flash_attention_plain
        return self

    def __exit__(self, *exc):
        self._mod.flash_attention = self._kernel


def _tensor_rel_l2(a, b):
    return _rel_l2(a.float().cpu().numpy(), b.float().cpu().numpy())


def zoo_cuts(entries):
    """Phase 12 (c)–(e): each of ZOO_CUTS at full width (cut to the given
    depth, or whole), bf16, seeded weights, numpy-made tokens and
    modality input: the prefill on K8 against the plain path and decode
    at position S−1 against a prefill over S positions (the MoE capacity
    raised so that neither drops a token), each within LM_CUT_REL_L2 of
    the logits."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    out = {}
    for arch, n_layers in ZOO_CUTS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if n_layers:
            cfg = cfg.with_overrides(n_layers=n_layers)
        model = build_model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        rng = np.random.default_rng(2)
        batch = _frontend_batch(cfg, rng.integers(
            1, cfg.vocab_size, (1, LM_CUT_PROMPT)), rng)
        attn, _ = _attention_and_mamba_layers(cfg)
        label = f"lm zoo cut {arch}"

        logits, _ = drive(entries, label, {"flash_attention"},
                          lambda: model.prefill(params, batch))
        k8 = entries["flash_attention"]["launches_by_path"][label]
        if k8 != attn:
            raise AssertionError(f"{arch}: flash_attention launched {k8} "
                                 f"times in one prefill, want {attn}")
        with plain_attention():
            plain, _ = model.prefill(params, batch)
        rel = _tensor_rel_l2(logits, plain)
        # decode against prefill, no capacity drop on either side: at
        # capacity_factor = experts / top_k an expert has a slot for
        # every token
        dcfg = cfg if cfg.moe is None else cfg.with_overrides(
            moe=dataclasses.replace(
                cfg.moe,
                capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        dmodel = build_model(dcfg, "cuda")
        n_front = cfg.frontend_len if cfg.frontend == "vision" else 0
        full, _ = dmodel.prefill(params, batch)
        _, cache = dmodel.prefill(params, dict(
            batch, tokens=batch["tokens"][:, :-1]))
        dec, _ = dmodel.decode_step(params, _pad_attention_cache(cache, 1),
                                    batch["tokens"][:, -1:],
                                    n_front + LM_CUT_PROMPT - 1)
        dec_rel = _tensor_rel_l2(dec, full)
        res = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
               "frontend_len": cfg.frontend_len if cfg.frontend else 0,
               "prompt_len": LM_CUT_PROMPT,
               "params": sum(x.numel() for x in _leaves(params)),
               "draw_s": draw_s, "k8_launches": k8,
               "kernel_vs_plain_rel_l2": rel,
               "kernel_vs_plain_argmax_equal": bool(torch.equal(
                   logits.argmax(-1), plain.argmax(-1))),
               "decode_vs_prefill_rel_l2": dec_rel,
               "decode_vs_prefill_argmax_equal": bool(torch.equal(
                   dec.argmax(-1), full.argmax(-1))),
               "finite": bool(torch.isfinite(logits).all()
                              and torch.isfinite(dec).all()),
               "seconds": time.perf_counter() - t0}
        print(f"[lm zoo cut] {arch}: {json.dumps(res)}")
        for what, r in (("kernel vs plain", rel),
                        ("decode vs prefill", dec_rel)):
            if not (res["finite"] and r <= LM_CUT_REL_L2):
                raise AssertionError(
                    f"{arch}: {what} relative L2 {r} (bound "
                    f"{LM_CUT_REL_L2}, finite {res['finite']})")
        out[arch] = res
        del params, model, dmodel, cache, logits, plain, full, dec
        torch.cuda.empty_cache()
    return out


def zoo_k8_shapes(entries):
    """Phase 12 (f): K8 in bf16 against its plain version at the zoo's
    new attention shapes, timed as phase 10 times Llama's."""
    import torch
    e = entries["flash_attention"]
    g = torch.Generator(device="cuda").manual_seed(12)
    print(f"[lm zoo kernels] flash_attention at the zoo's shapes "
          f"({K8_BF16_TOL})")
    return {name: k8_case(e, g, b, s, h, kh, d, torch.bfloat16)
            for name, (b, s, h, kh, d) in K8_ZOO_SHAPES.items()}


def lm_zoo(entries, smi):
    """Phase 12, the LM zoo: (a)–(f), each part's seconds printed."""
    out, seconds = {}, {}
    for part, fn in (("golden", lambda: lm_golden(
                         entries, LM_ZOO_GOLDEN, LM_ZOO_ARCHS,
                         "lm zoo golden")),
                     ("full_width", lambda: zoo_full_width(entries, smi)),
                     ("cuts", lambda: zoo_cuts(entries)),
                     ("k8_shapes", lambda: zoo_k8_shapes(entries))):
        t0 = time.perf_counter()
        out[part] = fn()
        seconds[part] = time.perf_counter() - t0
        print(f"[lm zoo] {part}: {seconds[part]:.1f} s")
    out["seconds"] = seconds
    return out


def _flat_np(tree_):
    from repro_torch import tree
    return {k: v.detach().float().cpu().numpy()
            for k, v in tree.flatten(tree_).items()}


def _per_step_launches(cfg):
    """K8's and K7's launches per training step of ``cfg`` (one batch, no
    microbatches): each layer's forward, and its recompute in the
    backward (every sublayer is rematerialized; the backwards launch no
    kernel)."""
    attn, mamba = _attention_and_mamba_layers(cfg)
    return {"flash_attention": 2 * attn,
            "causal_conv1d": 2 * K7_PER_MAMBA_LAYER * mamba}


def train_golden(entries):
    """Phase 13 (a): the three archs of ``TRAIN_GOLDEN`` at smoke size,
    float32, on the card (K8's float32 and K7's kernels in the forward,
    their ``Function``s' backwards) against the JAX reference: loss,
    nll and aux within ``TRAIN_LOSS_RTOL``, every gradient leaf within
    ``TRAIN_GRAD_REL_L2``, the parameters after one ``make_train_step``
    step with float32 and with int8 AdamW states within
    ``TRAIN_STEP_REL_L2``; the kernels launched as
    ``_per_step_launches`` says, per step."""
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.step import loss_and_grads, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    with np.load(TRAIN_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    out = {}
    for arch in TRAIN_GOLDEN_ARCHS:
        cfg = smoke_config(arch).with_overrides(dtype="float32")
        model = build_model(cfg, "cuda")
        batch = {"tokens": golden[f"{arch}/tokens"],
                 "labels": golden[f"{arch}/labels"]}
        want_n = _per_step_launches(cfg)
        want = {k for k, v in want_n.items() if v}

        def run():
            counts = []

            def counted(fn):
                k8, k7 = (build.LAUNCHES["flash_attention"],
                          build.LAUNCHES["causal_conv1d"])
                res = fn()
                counts.append({"flash_attention":
                               build.LAUNCHES["flash_attention"] - k8,
                               "causal_conv1d":
                               build.LAUNCHES["causal_conv1d"] - k7})
                return res
            params = _lm_golden_params(golden, arch, cfg, "cuda")
            loss, metrics, grads = counted(
                lambda: loss_and_grads(model, params, batch))
            stepped = {}
            for state in TRAIN_STATES:
                opt = AdamWConfig(state_dtype=state)
                p = _lm_golden_params(golden, arch, cfg, "cuda")
                p, _, _ = counted(lambda: make_train_step(model, opt)(
                    p, adamw_init(p, opt), batch))
                stepped[state] = _flat_np(p)
            return (loss, metrics, float(global_norm(grads)),
                    _flat_np(grads), stepped, counts)

        loss, metrics, gnorm, grads, stepped, counts = drive(
            entries, f"train golden {arch}", want, run)
        res = {"loss": float(loss), "golden_loss": float(
            golden[f"{arch}/loss"]), "launches_per_step": counts}
        errs = {"loss": abs(float(loss) / float(golden[f"{arch}/loss"])
                            - 1),
                "grad_norm": abs(gnorm / float(golden[f"{arch}/grad_norm"])
                                 - 1)}
        for k in ("nll", "aux"):
            ref = float(golden[f"{arch}/{k}"])
            errs[k] = abs(float(metrics[k]) - ref) / max(abs(ref), 1e-30)
        names = sorted(k for k in golden if k.startswith(f"{arch}/grads/"))
        if sorted(f"{arch}/grads/{k}" for k in grads) != names:
            raise AssertionError(f"{arch}: gradient leaves differ from the "
                                 f"golden's")
        grad_err = {k: _rel_l2(v, golden[f"{arch}/grads/{k}"])
                    for k, v in grads.items()}
        step_err = {state: max(_rel_l2(v, golden[
            f"{arch}/step_{state}/{k}"]) for k, v in flat.items())
            for state, flat in stepped.items()}
        res.update({"rel_err": errs, "grad_rel_l2_max": max(
            grad_err.values()), "grad_rel_l2_worst": max(
            grad_err, key=grad_err.get), "step_rel_l2_max": step_err,
            # the leaves whose gradients run through K8's and K7's
            # backwards
            "kernel_grad_rel_l2": {k: v for k, v in grad_err.items() if
                                   k.rsplit("/", 1)[-1] in (
                                       "wq", "wk", "wv", "conv_x",
                                       "conv_B", "conv_C")}})
        print(f"[train golden] {arch} float32 on the card: "
              f"{json.dumps(res)}")
        bad = [k for k, v in errs.items() if v > TRAIN_LOSS_RTOL
               and not (k == "aux" and float(golden[f"{arch}/aux"]) == 0
                        and float(metrics["aux"]) == 0)]
        bad += [k for k, v in grad_err.items() if v > TRAIN_GRAD_REL_L2]
        bad += [s_ for s_, v in step_err.items() if v > TRAIN_STEP_REL_L2]
        if bad:
            raise AssertionError(f"{arch}: the card's training differs from "
                                 f"the JAX golden at {bad}")
        if not res["kernel_grad_rel_l2"]:
            raise AssertionError(f"{arch}: no gradient through K7 or K8")
        if any(c != want_n for c in counts):
            raise AssertionError(f"{arch}: launches per step {counts}, want "
                                 f"{want_n} (forward + remat recompute)")
        out[arch] = res
        del model
    return out


def _step_profile(step_fn, params, state, batch, kernel):
    """Device time, device ops and ``kernel``'s share of the device time
    of one training step, from a profiler trace.  Returns (the numbers or
    None where the trace holds no device time, params, state)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3
    by_name, n_device = {}, 0
    for ev in device_events(prof):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total
        n_device += 1
    if not by_name:
        print("[train profile] the trace holds no device time: not "
              "measured")
        return None, params, state
    dev_ms = sum(by_name.values()) / 1e3
    k_ms = sum(v for n, v in by_name.items() if kernel in n) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    by_kind = {}
    for n, v in by_name.items():
        kind = next((k for k, marks in TRAIN_KERNEL_KINDS if any(
            mark in n for mark in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + v / 1e3
    return ({"device_ms": dev_ms, "device_ops": n_device,
             "traced_wall_ms": traced_ms, "kernel": kernel,
             "kernel_device_ms": k_ms, "kernel_share": k_ms / dev_ms,
             "loss": float(m["loss"]), "by_kind_ms": by_kind,
             "top_ms": [[k[:80], v / 1e3] for k, v in top]},
            params, state)


def train_full_width(entries, smi):
    """Phase 13 (b): each of ``TRAIN_FULL_ARCHS`` at full width and depth,
    bf16, seeded weights drawn on the card: TRAIN_STEPS steps of
    ``make_train_step`` (float32 AdamW states, lr TRAIN_LR) over
    ``batch_at`` batches of TRAIN_BATCH x TRAIN_SEQ, the launches they add
    to the counter read: every loss finite, every parameter
    leaf's gradient non-zero at step 1 (the float32 first moment after
    one step is (1 - b1) x the clipped gradient), K8/K7 launched
    ``_per_step_launches`` times a step; ms per step by CUDA events,
    tokens/s, peak memory, one more step under the profiler (device ms,
    idle share against the untraced step, device ops, the kernel's
    share), then one step with int8 states and its peak memory.  Returns
    the numbers."""
    import math
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step

    out = {}
    for arch in TRAIN_FULL_ARCHS:
        cfg = get_config(arch)
        want_n = _per_step_launches(cfg)
        kernel = "flash_attention" if want_n["flash_attention"] \
            else "causal_conv1d"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, "cuda")
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda")
                            .manual_seed(TRAIN_SEED))
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in tree.leaves(params))
        opt = AdamWConfig()
        data = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
        step_fn = make_train_step(model, opt, lr=TRAIN_LR)

        def run():
            state = adamw_init(params, opt)
            rows = []
            for k in range(TRAIN_STEPS):
                batch = batch_at(data, k)
                before = (build.LAUNCHES["flash_attention"],
                          build.LAUNCHES["causal_conv1d"])
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                _, state, m = step_fn(params, state, batch)
                stop.record()
                torch.cuda.synchronize()
                row = {"step": k + 1, "ms": start.elapsed_time(stop),
                       "loss": float(m["loss"]), "nll": float(m["nll"]),
                       "grad_norm": float(m["grad_norm"]),
                       "launches": {
                           "flash_attention":
                               build.LAUNCHES["flash_attention"]
                               - before[0],
                           "causal_conv1d":
                               build.LAUNCHES["causal_conv1d"]
                               - before[1]}}
                if k == 0:
                    norms = {n: float(v.norm())
                             for n, v in tree.flatten(state["m"]).items()}
                    row["zero_grad_leaves"] = sorted(
                        n for n, v in norms.items() if not v > 0)
                    row["leaves"] = len(norms)
                rows.append(row)
                print(f"[train full width] {arch} step {k + 1}: "
                      f"{json.dumps(row)}")
            return rows, state

        rows, state = drive(entries, f"train full width {arch}",
                            {kernel}, run)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steady = [r["ms"] for r in rows[1:]]
        ms = sum(steady) / len(steady)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        # 6 x params x tokens for the forward and backward products, 2 x
        # more for the rematerialized forward, bf16 on the tensor cores
        model_flops = 8 * n_params * tokens
        prof, _, state = _step_profile(step_fn, params, state,
                                       batch_at(data, TRAIN_STEPS), kernel)
        if prof is not None:
            prof["idle_share"] = 1.0 - prof["device_ms"] / ms
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt8 = AdamWConfig(state_dtype="int8")
        state8 = adamw_init(params, opt8)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        _, state8, m8 = make_train_step(model, opt8, lr=TRAIN_LR)(
            params, state8, batch_at(data, TRAIN_STEPS + 1))
        stop.record()
        torch.cuda.synchronize()
        int8 = {"ms": start.elapsed_time(stop), "loss": float(m8["loss"]),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state8
        res = {"params": n_params, "layers": cfg.n_layers,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
               "draw_s": draw_s, "steps": rows, "ms_per_step": ms,
               "tokens_per_s": tokens / ms * 1e3,
               "peak_memory_gb": peak_gb,
               "launches_per_step_want": want_n,
               "model_flops_per_step": model_flops,
               "bound_ms": model_flops / BF16_FLOPS_PER_S * 1e3,
               "bound_by": "operations", "profile": prof,
               "int8_step": int8, "card": smi}
        print(f"[train full width] {arch}: {json.dumps(res)}")
        bad = [r["step"] for r in rows if not math.isfinite(r["loss"])]
        if bad or not math.isfinite(int8["loss"]):
            raise AssertionError(f"{arch}: a loss is not finite ({rows}, "
                                 f"{int8})")
        if rows[0]["zero_grad_leaves"]:
            raise AssertionError(f"{arch}: zero gradients at step 1 in "
                                 f"{rows[0]['zero_grad_leaves']}")
        if any(r["launches"] != want_n for r in rows):
            raise AssertionError(f"{arch}: launches per step "
                                 f"{[r['launches'] for r in rows]}, want "
                                 f"{want_n}")
        out[arch] = res
        del params, model, step_fn
        torch.cuda.empty_cache()
    return out


def train_cut(entries):
    """Phase 13 (c): Llama-3.2-3B at full width cut to TRAIN_CUT_LAYERS
    layers, bf16, one batch of 1 x TRAIN_CUT_SEQ: the loss and every
    gradient leaf on the card (kernels) against the same parameters on
    the CPU (plain versions): loss within TRAIN_CUT_LOSS_RTOL, each leaf
    within LM_CUT_REL_L2."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import loss_and_grads

    cfg = get_config("llama3.2-3b").with_overrides(n_layers=TRAIN_CUT_LAYERS)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(3))
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (1, TRAIN_CUT_SEQ + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _, grads = drive(entries, "train cut llama3.2-3b",
                           {"flash_attention"},
                           lambda: loss_and_grads(model, params, batch))
    t0 = time.perf_counter()
    cpu_loss, _, cpu_grads = loss_and_grads(
        build_model(cfg, "cpu"), _tree_map(lambda t: t.cpu(), params), batch)
    cpu_s = time.perf_counter() - t0
    a, b = _flat_np(grads), _flat_np(cpu_grads)
    errs = {k: _rel_l2(a[k], b[k]) for k in b}
    res = {"layers": TRAIN_CUT_LAYERS, "seq": TRAIN_CUT_SEQ,
           "loss": float(loss), "cpu_loss": float(cpu_loss),
           "loss_rel_err": abs(float(loss) / float(cpu_loss) - 1),
           "grad_rel_l2": errs, "cpu_s": cpu_s}
    print(f"[train cut] llama3.2-3b {TRAIN_CUT_LAYERS} layers, seq "
          f"{TRAIN_CUT_SEQ}, card (kernels) vs CPU (plain): "
          f"{json.dumps(res)}")
    bad = {k: v for k, v in errs.items() if not v < LM_CUT_REL_L2}
    if bad or not res["loss_rel_err"] < TRAIN_CUT_LOSS_RTOL:
        raise AssertionError(f"the card's training differs from the CPU's: "
                             f"loss {res['loss_rel_err']}, leaves {bad}")
    del params, grads, model
    torch.cuda.empty_cache()
    return res


def train_loop_on_card(entries, ckpt_root):
    """Phase 13 (d): ``train()`` on the card at smoke size (Llama-3.2-3B,
    float32): an uninterrupted run of TRAIN_LOOP_STEPS steps, then a run
    preempted at TRAIN_LOOP_FAIL_AT (``fail_at_step``: a checkpoint of
    the steps done) and resumed from its newest checkpoint; the resumed
    run's last loss and parameters within 1e-5 of the uninterrupted
    run's, and its final checkpoint restored into a fresh template."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.loop import TrainConfig, train

    cfg = smoke_config("llama3.2-3b").with_overrides(dtype="float32")
    model = build_model(cfg, "cuda")
    data = DataConfig(cfg.vocab_size, 32, 4)
    base = TrainConfig(steps=TRAIN_LOOP_STEPS, lr=3e-3, log_every=4,
                       ckpt_every=TRAIN_LOOP_CKPT_EVERY,
                       ckpt_dir=str(ckpt_root / "whole"))

    def run():
        whole = train(model, data, base, log=lambda _: None)
        cut = dataclasses.replace(base, ckpt_dir=str(ckpt_root / "cut"),
                                  fail_at_step=TRAIN_LOOP_FAIL_AT)
        try:
            train(model, data, cut, log=lambda _: None)
        except RuntimeError as e:
            if "simulated preemption" not in str(e):
                raise
        else:
            raise AssertionError("the preempted run did not stop")
        saved = Checkpointer(cut.ckpt_dir).latest_step()
        lines = []
        resumed = train(model, data, dataclasses.replace(
            cut, fail_at_step=None), log=lines.append)
        return whole, saved, lines, resumed

    (p_w, _, h_w), saved, lines, (p_r, _, h_r) = drive(
        entries, "train loop", {"flash_attention"}, run)
    param_err = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(p_w), tree.leaves(p_r)))
    _, restored = Checkpointer(str(ckpt_root / "cut")).restore(
        {"params": model.init(torch.Generator(device="cuda")
                              .manual_seed(9))})
    restored_equal = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(restored["params"]), tree.leaves(p_r)))
    res = {"steps": TRAIN_LOOP_STEPS, "preempted_at": TRAIN_LOOP_FAIL_AT,
           "saved_at_preemption": saved, "resumed_log": lines[0],
           "first_loss": h_w[0]["loss"], "last_loss": h_w[-1]["loss"],
           "resumed_last_loss": h_r[-1]["loss"],
           "param_max_abs_diff": param_err,
           "restored_equal": restored_equal,
           "p50_ms": h_w[-1]["p50_ms"], "p95_ms": h_w[-1]["p95_ms"]}
    print(f"[train loop] on the card: {json.dumps(res)}")
    if not (saved == TRAIN_LOOP_FAIL_AT
            and lines[0] == f"[train] resumed from step {saved}"
            and abs(res["resumed_last_loss"] - res["last_loss"])
            <= 1e-5 * abs(res["last_loss"]) and param_err <= 1e-5
            and restored_equal and res["last_loss"] < res["first_loss"]):
        raise AssertionError(f"the loop on the card: {res}")
    return res


def train_kernel_shapes(entries):
    """Phase 13 (e): K8 at Llama-3.2-3B's training shape (TRAIN_BATCH x
    TRAIN_SEQ, 24 heads, kv 8, head dim 128, causal, bf16) and K7 at
    Mamba-2-1.3B's (conv_x: TRAIN_BATCH x TRAIN_SEQ x 4096, K = 4, bf16,
    no state) against their plain versions, timed as in phase 10; then
    each wrapper's forward and backward through its
    ``torch.autograd.Function`` (ms by CUDA events, the gradients of
    every input) beside the library call's
    (``F.scaled_dot_product_attention``, a depthwise ``F.conv1d``).
    Returns the numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import conv1d, flash_attention as fa
    from repro_torch.models.ssm import ssm_dims

    g = torch.Generator(device="cuda").manual_seed(23)
    lcfg, mcfg = get_config("llama3.2-3b"), get_config("mamba2-1.3b")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    h, kh, d = lcfg.n_heads, lcfg.n_kv_heads, lcfg.head_dim
    print("[train kernels] flash_attention at Llama-3.2-3B's training "
          "shape")
    k8 = k8_case(entries["flash_attention"], g, b, s, h, kh, d,
                 torch.bfloat16)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda")
               .to(torch.bfloat16).requires_grad_() for n in (h, kh, kh))
    dout = torch.randn(b, s, h, d, generator=g, device="cuda") \
        .to(torch.bfloat16)
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doutt = dout.transpose(1, 2).contiguous()

    def k8_fwd_bwd():
        q.grad = k.grad = v.grad = None
        fa.flash_attention(q, k, v).backward(dout)

    def sdpa_fwd_bwd():
        qt.grad = kt.grad = vt.grad = None
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True).backward(doutt)
    k8["fwd_bwd_ms"] = time_ms(k8_fwd_bwd, 10, warmup=2)
    k8["library_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, 10, warmup=2)

    inner, _ = ssm_dims(mcfg)
    kk = mcfg.ssm.conv_kernel
    print("[train kernels] causal_conv1d at Mamba-2-1.3B's training shape")
    k7 = k7_case(entries["causal_conv1d"], g, "train", b, s, inner, kk,
                 with_state=False)
    x = torch.randn(b, s, inner, generator=g, device="cuda") \
        .to(torch.bfloat16).requires_grad_()
    w = torch.randn(kk, inner, generator=g, device="cuda") \
        .to(torch.bfloat16).requires_grad_()
    dy = torch.randn(b, s, inner, generator=g, device="cuda")
    xpad = torch.nn.functional.pad(x.detach(), (0, 0, kk - 1, 0)) \
        .transpose(1, 2).contiguous().requires_grad_()
    wt = w.detach().t().contiguous()[:, None, :].requires_grad_()
    dyt = dy.to(torch.bfloat16).transpose(1, 2).contiguous()

    def k7_fwd_bwd():
        x.grad = w.grad = None
        conv1d.causal_conv1d(x, w).backward(dy)

    def conv_fwd_bwd():
        xpad.grad = wt.grad = None
        F.conv1d(xpad, wt, groups=inner).backward(dyt)
    k7["fwd_bwd_ms"] = time_ms(k7_fwd_bwd, 10, warmup=2)
    k7["library_fwd_bwd_ms"] = time_ms(conv_fwd_bwd, 10, warmup=2)
    res = {"flash_attention": k8, "causal_conv1d": k7}
    print(f"[train kernels] {json.dumps(res)}")
    return res


def train_phase(entries, smi):
    """Phase 13, training: (a)–(e), each part's seconds printed."""
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        for part, fn in (("golden", lambda: train_golden(entries)),
                         ("full_width", lambda: train_full_width(entries,
                                                                 smi)),
                         ("cut", lambda: train_cut(entries)),
                         ("loop", lambda: train_loop_on_card(
                             entries, Path(tmp))),
                         ("kernels", lambda: train_kernel_shapes(entries))):
            t0 = time.perf_counter()
            out[part] = fn()
            seconds[part] = time.perf_counter() - t0
            print(f"[train] {part}: {seconds[part]:.1f} s")
    out["seconds"] = seconds
    return out


# the multi-device phase: --shard on both committed plans; Llama-3.2-3B
# at full width and depth on a one-device NCCL (data, model) mesh — one
# train step (2 x 2048 tokens, as phase 13) against one unsharded step
# from the same state, a prefill of PAR_PROMPT tokens for PAR_BATCH
# sequences and PAR_DECODE greedy decode steps against the unsharded
# path; the analysis of the sharded step; two dry-run cells
PAR_ARCH = "llama3.2-3b"
PAR_LOSS_RTOL, PAR_LEAF_REL_L2 = 1e-3, 1e-3
PAR_BATCH, PAR_PROMPT, PAR_DECODE = 2, 512, 8
PAR_TIMED_STEPS = 3
DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k", "auto"),
                ("jamba-1.5-large-398b", "prefill_32k", "fsdp"))


def start_dryruns(out_dir):
    """Phase 14 (d), started first: each dry-run cell in its own process
    (``python -m repro_torch.launch.dryrun``, so its ``fake`` group never
    meets the NCCL one), on the host's CPU, the card hidden.  Returns
    the processes with their start times."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, mode in DRYRUN_CELLS:
        log = open(Path(out_dir) / f"{arch}__{shape}.log", "w")
        procs.append((arch, shape, mode, time.perf_counter(), log,
                      subprocess.Popen(
                          [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--mesh",
                           "single", "--mode", mode, "--out", str(out_dir)],
                          env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def finish_dryruns(procs, out_dir):
    """Phase 14 (d): wait for each cell (600 s at most), read its record:
    status ``ok``, seconds, and the per-device argument and temporary
    bytes beside the card's own memory."""
    import torch
    card = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for arch, shape, mode, t0, log, proc in procs:
        try:
            rc = proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
        finally:
            log.close()
        seconds = time.perf_counter() - t0
        rec_path = Path(out_dir) / f"baseline__{arch}__{shape}__single.json"
        rec = json.loads(rec_path.read_text()) if rec_path.exists() else {}
        if rc or not rec:
            log_text = (Path(out_dir) / f"{arch}__{shape}.log").read_text()
            raise AssertionError(
                f"dry run {arch} x {shape} failed (rc {rc}):\n"
                f"{log_text[-3000:]}\n{rec.get('traceback', '')}")
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} x {shape}: {rec}")
        mem = rec["memory"]
        res = {"arch": arch, "shape": shape, "mode": rec["mode"],
               "n_chips": rec["n_chips"], "status": rec["status"],
               "seconds": seconds, "trace_s": rec["trace_s"],
               "argument_bytes_per_device": mem["argument_size_in_bytes"],
               "temp_bytes_per_device": mem["temp_size_in_bytes"],
               "card_bytes": card,
               "flops_per_device": rec["hlo"]["flops"],
               "hbm_bytes_per_device": rec["hlo"]["hbm_bytes"],
               "collective_bytes_per_device":
                   rec["hlo"]["collective_total"]}
        print(f"[parallel dryrun] {arch} x {shape} x single "
              f"({rec['mode']}, {rec['n_chips']} devices): status ok in "
              f"{seconds:.1f} s; per device "
              f"{res['argument_bytes_per_device'] / 1e9:.3f} GB of arguments "
              f"and "
              f"{res['temp_bytes_per_device'] / 1e9:.3f} GB of temporaries "
              f"against this card's {card / 1e9:.3f} GB")
        out[f"{arch}__{shape}"] = res
    return out


def shard_cnn(entries):
    """Phase 14 (a): the launcher's ``--shard`` path on both committed
    plans with the golden weights over ``cnn_data_mesh()``: outputs equal
    to the JAX golden and to the unsharded engine, each layer's entry
    launched once per forward per device, the launches each plan adds
    to the counter read."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import cnn_data_mesh
    golden = np.load(GOLDEN)
    out = {"mesh_devices": cnn_data_mesh().size}
    for stem in (UNPINNED, PINNED):
        args = serve_args(stem, REQUESTS)
        args.shard = True
        engine, reqs, dt = drive(entries, f"parallel shard {stem}",
                                 set(SERVE_LAUNCHES[stem]),
                                 lambda: serve.run_cnn(args))
        forwards = sum(engine.stats()["bucket_hits"].values())
        _check_serve_launches(f"parallel shard {stem}",
                              {stem: forwards * engine.mesh.size})
        ys = np.stack([r.output for r in reqs])
        if not np.array_equal(ys[:8], golden[f"{stem}.y"]):
            raise AssertionError(f"--shard {stem}: outputs differ from the "
                                 f"JAX golden")
        _, plain, _ = serve.run_cnn(serve_args(stem, REQUESTS))
        if not np.array_equal(ys, np.stack([r.output for r in plain])):
            raise AssertionError(f"--shard {stem}: outputs differ from the "
                                 f"unsharded engine")
        out[stem] = {"forwards": forwards, "requests": len(reqs),
                     "seconds": dt}
        print(f"[parallel shard] {stem}: {len(reqs)} requests over a mesh "
              f"of {engine.mesh.size} device(s), {forwards} forwards, "
              f"outputs equal the JAX golden and the unsharded engine")
    return out


def _rel_l2_t(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _cuda_ms(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def sharded_llama(entries, smi, tmp):
    """Phase 14 (b) and (c) on a one-device NCCL (data, model) mesh."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import hloscan
    from repro_torch.core.roofline import H100_SXM, roofline_terms
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import ShardingRules, place_tree
    from repro_torch.train.step import make_serve_steps, make_train_step

    dist.init_process_group("nccl", store=dist.FileStore(
        str(Path(tmp) / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config(PAR_ARCH)
        model = build_model(cfg, "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device="cuda")
                            .manual_seed(TRAIN_SEED))
        rules = ShardingRules(cfg, mesh, mode="tp")
        opt = AdamWConfig()
        data = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in batch_at(data, 0).items()}
        step = make_train_step(model, opt, lr=TRAIN_LR)
        want_k8 = _per_step_launches(cfg)["flash_attention"]

        # (b) one unsharded step on a copy, its result kept on the host
        ref = tree.tree_map(lambda t: t.clone(), params)
        ref, ref_state, ref_m = step(ref, adamw_init(ref, opt), batch)
        ref_loss = float(ref_m["loss"])
        ref_host = {k: v.cpu() for k, v in tree.flatten(ref).items()}
        del ref, ref_state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # the same state as DTensors: wrapped, not copied
        p_spec = rules.params_spec(params)
        dparams = place_tree(params, p_spec, mesh)
        dstate = adamw_init(dparams, opt)
        dbatch = place_tree(batch, rules.batch_spec(batch), mesh)
        dparams, dstate, m = drive(entries, "parallel sharded train",
                                   {"flash_attention"},
                                   lambda: step(dparams, dstate, dbatch))
        k8 = LAUNCHES["parallel sharded train"]["flash_attention"]
        loss = float(m["loss"].full_tensor())
        got = tree.flatten(dparams)
        worst = max((_rel_l2_t(got[k].to_local().cpu(), v), k)
                    for k, v in ref_host.items())
        peak_train = torch.cuda.max_memory_allocated()
        train = {"loss": loss, "loss_unsharded": ref_loss,
                 "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                 "worst_leaf_rel_l2": worst[0], "worst_leaf": worst[1],
                 "k8_launches": k8, "k8_launches_want": want_k8,
                 "peak_memory_gb": peak_train / 1e9}
        print(f"[parallel train] {json.dumps(train)}")
        if train["loss_rel_err"] > PAR_LOSS_RTOL or worst[0] > \
                PAR_LEAF_REL_L2 or k8 != want_k8:
            raise AssertionError(f"sharded train step: {train}")
        del ref_host

        # (c) the analysis of the sharded step, then steps 2-4 timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        batch1 = place_tree({k: torch.as_tensor(v, device="cuda")
                             for k, v in batch_at(data, 1).items()},
                            rules.batch_spec(batch), mesh)
        res = hloscan.analyze_step(step, dparams, dstate, batch1)
        measured_peak = torch.cuda.max_memory_allocated()
        mem = hloscan.memory_summary(res)
        times = []
        for k in range(PAR_TIMED_STEPS):
            bk = place_tree({kk: torch.as_tensor(v, device="cuda")
                             for kk, v in batch_at(data, 2 + k).items()},
                            rules.batch_spec(batch), mesh)
            ms, (dparams, dstate, _) = _cuda_ms(
                lambda: step(dparams, dstate, bk))
            times.append(ms)
        ms = sum(times) / len(times)
        record = {"arch": PAR_ARCH, "shape": "train", "kind": "train",
                  "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
                  "n_chips": 1, "params": cfg.param_count(),
                  "active_params": cfg.active_param_count(),
                  "hlo": {k: res[k] for k in ("flops", "hbm_bytes",
                                              "collective_total")}}
        terms = roofline_terms(record, H100_SXM)
        bound_s = max(terms["compute_s"], terms["memory_s"],
                      terms["collective_s"])
        analysis = {
            "flops": res["flops"], "hbm_bytes": res["hbm_bytes"],
            "collective_total": res["collective_total"], "ops": res["ops"],
            "kernels": res["kernels"], "memory": mem,
            "counted_peak_gb": (base + mem["temp_size_in_bytes"]) / 1e9,
            "measured_peak_gb": measured_peak / 1e9,
            "steps_ms": times, "ms_per_step": ms, "roofline": terms,
            "bound_ms": bound_s * 1e3,
            "bound_over_measured": bound_s * 1e3 / ms,
            "ideal_over_measured": terms["ideal_s"] * 1e3 / ms,
            "card": smi}
        print(f"[parallel analysis] {json.dumps(analysis)}")

        # (b) serving: prefill + greedy decode, sharded against unsharded
        prefill, decode = make_serve_steps(model)
        rng = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 1)
        prompts = torch.randint(0, cfg.vocab_size, (PAR_BATCH, PAR_PROMPT),
                                generator=rng, device="cuda")

        def serve(p, place_batch, place_cache):
            """Prefill, the cache padded for PAR_DECODE more positions
            (on a one-device mesh a DTensor's local tensor is the whole
            tensor), then greedy decode.  Returns (logits per call,
            tokens)."""
            logits, cache = prefill(p, {"tokens": place_batch(prompts)})
            big = place_cache(model.init_cache(PAR_BATCH,
                                               PAR_PROMPT + PAR_DECODE))
            for key, entry in cache.items():
                for name, t in entry.items():
                    src = _local(t)
                    _local(big[key][name])[:, :, :src.shape[2]].copy_(src)
            outs, toks = [_local(logits)], []
            for i in range(PAR_DECODE):
                toks.append(outs[-1].argmax(-1, keepdim=True))
                logits, big = decode(p, big, place_batch(toks[-1]),
                                     PAR_PROMPT + i)
                outs.append(_local(logits))
            return outs, torch.cat(toks, 1)

        def place_batch(t):
            return place_tree({"t": t}, rules.batch_spec({"t": t}),
                              mesh)["t"]

        def place_cache(c):
            return place_tree(c, rules.cache_spec(c), mesh)

        plain_outs, plain_toks = serve(params_plain(dparams), _same, _same)
        sh_outs, sh_toks = drive(entries, "parallel sharded serve",
                                 {"flash_attention"},
                                 lambda: serve(dparams, place_batch,
                                               place_cache))
        errs = [_rel_l2_t(a, b) for a, b in zip(sh_outs, plain_outs)]
        serve_res = {"batch": PAR_BATCH, "prompt": PAR_PROMPT,
                     "decode_steps": PAR_DECODE, "logits_rel_l2": errs,
                     "tokens_equal": bool(torch.equal(sh_toks, plain_toks)),
                     "k8_launches": LAUNCHES["parallel sharded serve"]
                     ["flash_attention"]}
        print(f"[parallel serve] {json.dumps(serve_res)}")
        if max(errs) > LM_CUT_REL_L2 or not serve_res["tokens_equal"]:
            raise AssertionError(f"sharded serve: {serve_res}")
        return {"train": train, "analysis": analysis, "serve": serve_res}
    finally:
        dist.destroy_process_group()


def _same(t):
    return t


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def params_plain(dparams):
    """The local tensors of a one-device mesh's DTensor tree (the same
    storage: the unsharded path runs on the very weights)."""
    if isinstance(dparams, dict):
        return {k: params_plain(v) for k, v in dparams.items()}
    return dparams.to_local()


def parallel_phase(entries, smi):
    """Phase 14, the multi-device layer: (d) started first in its own
    processes, then (a), (b) and (c), then (d) read; each part's seconds
    printed."""
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-par-") as tmp:
        t_all = time.perf_counter()
        procs = start_dryruns(tmp)
        try:
            for part, fn in (("shard", lambda: shard_cnn(entries)),
                             ("llama", lambda: sharded_llama(entries, smi,
                                                             tmp))):
                t0 = time.perf_counter()
                out[part] = fn()
                seconds[part] = time.perf_counter() - t0
                print(f"[parallel] {part}: {seconds[part]:.1f} s")
            t0 = time.perf_counter()
            out["dryrun"] = finish_dryruns(procs, tmp)
            seconds["dryrun_wait"] = time.perf_counter() - t0
        finally:
            for *_, log, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        seconds["phase"] = time.perf_counter() - t_all
        print(f"[parallel] phase: {seconds['phase']:.1f} s")
    out["seconds"] = seconds
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

        if "--only-parallel" in sys.argv[1:]:
            # phase 14 alone, for working on it (no result line)
            print(json.dumps({"parallel": parallel_phase({}, smi)}))
            return 0
        if "--only-experts" in sys.argv[1:]:
            # phase 11's expert kernels alone, float32 and bf16
            print(json.dumps({"expert_kernels": moe_expert_kernels(smi)}))
            return 0
        if "--only-lm" in sys.argv[1:]:
            entries = {}
            check_lm_kernels(entries)
            lm_golden(entries, LM_GOLDEN, LM_ARCHS, "lm golden")
            lm = lm_full_width(entries)
            lm_golden(entries, LM_ZOO_GOLDEN, LM_ZOO_ARCHS, "lm zoo golden")
            zoo = zoo_full_width(entries, smi)
            print(json.dumps({"lm_full_width": lm, "lm_zoo_full_width": zoo,
                              "card": smi}))
            return 0
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
        lm_golden(entries, LM_GOLDEN, LM_ARCHS, "lm golden")
        lm = lm_full_width(entries)
        lm_cut = lm_plain_vs_kernel(entries)
        moe = {"golden": moe_golden_on_card(entries, smi),
               "expert_kernels": moe_expert_kernels(smi),
               "full_width": moe_full_width(entries, smi)}
        zoo = lm_zoo(entries, smi)
        trained = train_phase(entries, smi)
        parallel = parallel_phase(entries, smi)
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "equal") + TIMES + (
                "shape", "launches_by_path", "cases")
        extra = ("instantiations", "requant", "requant_cases",
                 "launches_by_entry")
        # the expert kernels' checks and times are phase 11's (``moe``):
        # their entries hold their launches alone
        counted = ("name", "route", "source", "replaces", "launches",
                   "launches_by_path")
        line = {"kernels": [{k: e[k] for k in (keys if e["replaces"]
                                               else counted)}
                            | {k: e[k] for k in extra if k in e}
                            for e in entries.values()],
                "images_per_s": rates, "ms_per_step": step_ms,
                "serve_profile": prof, "plan_on_card": planned,
                "gateway": gateway, "fleet": fleet, "recovery": recovery,
                "lm_k7_per_mamba_layer": entries["causal_conv1d"]["per_layer"],
                "lm_full_width": lm, "lm_cut_plain_vs_kernel": lm_cut,
                "moe": moe, "lm_zoo": zoo, "train": trained,
                "parallel": parallel,
                "int32_ops_per_s": int32_rate(), "card": smi}
        print(json.dumps(line))
        if "--json-out" in sys.argv[1:]:
            # the whole line, for a caller whose captured output keeps
            # only its end
            out = Path(sys.argv[sys.argv.index("--json-out") + 1])
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(line))
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
