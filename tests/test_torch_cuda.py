"""Card tests of the port: each CUDA kernel against its plain PyTorch
version on the card (tolerance 0 for the integer kernels and the conv1d,
stated tolerances for attention) — K1 and K2 in their int32 and their
requantizing entries, K1 on both its routes (dp4a for int8 dots, the
CUDA cores' multiply-add for int32 ones) — the launch contract, and
the slices on the card against the JAX reference's golden outputs: the
serving path (K1–K3), the per-plane path (``ConvBlock.apply``,
``cnn_forward_loop``, ``validate_plan``: K3–K6), the LM path (K7,
K8: ``prefill``, ``decode_step`` and the ``Engine``; the whole zoo at
smoke size, and Qwen3-MoE at full width cut to 4 layers), the quantized MoE
workload (layer by layer against the golden, the bucketed forward
against eager, no host sync; its expert kernels against their plain
versions), and the persistent
cache's kernel libraries (a corrupt one quarantined and rebuilt; a warm
start in a fresh process that builds nothing), and training (the
gradients through K7's and K8's ``torch.autograd.Function``s against the
CPU's, ``forward_train``'s loss and gradients against the reference's
training golden), and the multi-device layer (sharded train and serve
steps on a one-device NCCL mesh; on four cards, a (2, 2) full-width
Llama-3.2-3B step, the MoE shard_map halves and the pipeline).
Every test here carries the ``cuda`` marker and skips without a card;
this file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, runtime
from repro_torch.blocks import base, get_block
from repro_torch.core import allocate, cnn, deploy, synth
from repro_torch.configs.paper_conv import REDUCED_SWEEP
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import conv1d, conv2d, flash_attention as fa
from repro_torch.kernels import moe_expert_gemm as meg
from repro_torch.kernels.build import LAUNCHES
from repro_torch.models import build_model
from repro_torch.serve import (AsyncCNNGateway, AsyncServeConfig, CNNEngine,
                               CNNServeConfig, Engine, ImageRequest, Request,
                               ServeConfig)
from torch_parity import cuda, operands  # noqa: F401 (fixture)

pytestmark = pytest.mark.cuda

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
UNPINNED = SRC / "plans" / "quickstart_v5e.json"
PINNED = SRC / "plans" / "quickstart_v5e_conv1_conv3.json"
GOLDEN = SRC / "golden" / "quickstart_reference.npz"
LM_GOLDEN = SRC / "golden" / "lm_reference.npz"
MOE_GOLDEN = SRC / "golden" / "moe_reference.npz"
LM_ZOO_GOLDEN = SRC / "golden" / "lm_zoo_reference.npz"
TRAIN_GOLDEN = SRC / "golden" / "train_reference.npz"



KERNELS = {"conv1_layer": (conv2d.conv1_layer, conv2d.conv1_layer_plain),
           "fused_dot_layer": (base.fused_dot_layer,
                               base.fused_dot_layer_plain),
           "packed_dot_layer": (base.packed_dot_layer,
                                base.packed_dot_layer_plain)}
# int16/int32 plane accumulator boundary, packing boundary, containers,
# the serving points and the extremes
POINTS = [(3, 3), (3, 8), (6, 4), (6, 5), (6, 6), (8, 6), (8, 8), (9, 8),
          (8, 9), (12, 16), (16, 12), (16, 16)]
CASES = [(k, d, c) for k in KERNELS for d, c in POINTS
         if k != "packed_dot_layer"
         or conv2d._pack_shift(d, c) <= conv2d.PACK_SHIFT_BUDGET]


@pytest.mark.parametrize("name,d,c", CASES)
def test_kernel_matches_plain_on_card(cuda, name, d, c):
    kernel, plain = KERNELS[name]
    rng = np.random.default_rng(300 * d + c)
    x, w = operands(rng, (3, 16, 40, 40), 7, d, c)
    xc, wc = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    before = LAUNCHES[kernel.__name__]
    y = kernel(xc, wc, data_bits=d, coeff_bits=c)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel.__name__] == before + 1
    assert y.dtype == torch.int32 and tuple(y.shape) == (3, 7, 16, 40)
    assert torch.equal(y, plain(xc, wc, data_bits=d, coeff_bits=c))
    assert np.array_equal(y.cpu().numpy(), plain(
        torch.from_numpy(x), torch.from_numpy(w), data_bits=d,
        coeff_bits=c).numpy())


# the requantizing entries of K1 and K2, with their plain versions
REQUANT = {"fused_dot_layer": (base.fused_dot_layer_requant,
                               base.fused_dot_layer_requant_plain),
           "packed_dot_layer": (base.packed_dot_layer_requant,
                                base.packed_dot_layer_requant_plain)}
REQUANT_CASES = [(k, d, c) for k, d, c in CASES if k in REQUANT]
SHIFTS = (0, 7, 31, 40)


def check_requant(name, xc, wc, d, c):
    """Each shift of ``SHIFTS``: one launch, the container of d, equal to
    the plain version on the card."""
    kernel, plain = REQUANT[name]
    n, h, wd, _ = xc.shape
    for shift in SHIFTS:
        before = LAUNCHES[kernel.__name__]
        y = kernel(xc, wc, data_bits=d, coeff_bits=c, shift=shift,
                   out_bits=d)
        torch.cuda.synchronize()
        assert LAUNCHES[kernel.__name__] == before + 1
        assert y.dtype == conv2d.container_dtype(d)
        assert tuple(y.shape) == (n, h, wd, wc.shape[0])
        assert torch.equal(y, plain(xc, wc, data_bits=d, coeff_bits=c,
                                    shift=shift, out_bits=d)), shift


@pytest.mark.parametrize("name,d,c", REQUANT_CASES)
def test_requant_entry_matches_plain_on_card(cuda, name, d, c):
    rng = np.random.default_rng(700 * d + c)
    x, w = operands(rng, (3, 16, 40, 40), 7, d, c)
    check_requant(name, torch.from_numpy(x).to(cuda),
                  torch.from_numpy(w).to(cuda), d, c)


@pytest.mark.parametrize("name", sorted(REQUANT))
def test_requant_entry_container_range_int16_inputs_on_card(cuda, name):
    rng = np.random.default_rng(13)
    x, w = operands(rng, (2, 16, 24, 5), 3, 3, 8, x_range=(-32768, 32767))
    check_requant(name, torch.from_numpy(x).to(cuda),
                  torch.from_numpy(w).to(cuda), 3, 8)


# chip_smoke.py's MAIN_CASES: the serving layers at bucket 16
MAIN_CASES = [("fused_dot_layer", (16, 32, 128, 1), 8, 8, 6),
              ("fused_dot_layer", (16, 32, 128, 8), 8, 8, 6),
              ("fused_dot_layer", (16, 32, 128, 8), 4, 6, 4),
              ("conv1_layer", (16, 32, 128, 8), 8, 8, 6),
              ("packed_dot_layer", (16, 32, 128, 8), 4, 6, 4)]


@pytest.mark.parametrize("name,shape,oc,d,c", MAIN_CASES)
def test_main_path_shapes_on_card(cuda, name, shape, oc, d, c):
    """The int32 entry and the layer with its requantize as serving runs
    it (K1, K2: the requantizing entry; K3: ``conv1_layer``, then
    ``requantize``), each equal to its plain version."""
    rng = np.random.default_rng(sum(shape) + oc)
    x, w = operands(rng, shape, oc, d, c)
    xc, wc = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    kernel, plain = KERNELS[name]
    assert torch.equal(kernel(xc, wc, data_bits=d, coeff_bits=c),
                       plain(xc, wc, data_bits=d, coeff_bits=c))
    if name in REQUANT:
        check_requant(name, xc, wc, d, c)
    else:
        y = get_block("conv1").apply_batched_requant(
            xc, wc, data_bits=d, coeff_bits=c, shift=7)
        assert torch.equal(y, conv2d.requantize(
            plain(xc, wc, data_bits=d, coeff_bits=c), 7, d))


@pytest.mark.parametrize("d,c", POINTS)
@pytest.mark.parametrize("shape,oc", [((3, 16, 40, 40), 7),
                                      ((2, 16, 40, 1), 8),
                                      ((2, 16, 23, 3), 5)],
                         ids=["channels", "ic1", "rows"])
def test_fused_dot_routes_match_plain_on_card(cuda, shape, oc, d, c):
    """K1 on the route its containers pick: dp4a on int8 dots, over
    words of 4 channels (ic % 4 == 0) or of a window row's 3 taps
    (ic = 1, 3), and the CUDA cores' multiply-add on int32 dots."""
    rng = np.random.default_rng(900 * d + c + shape[-1])
    x, w = operands(rng, shape, oc, d, c)
    xc, wc = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    y = base.fused_dot_layer(xc, wc, data_bits=d, coeff_bits=c)
    assert torch.equal(y, base.fused_dot_layer_plain(xc, wc, data_bits=d,
                                                     coeff_bits=c))
    check_requant("fused_dot_layer", xc, wc, d, c)


def unaligned(x):
    """A contiguous copy of x whose data starts one element past an
    8-byte boundary, so no row of it is aligned for the vector loads."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = flat[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 8
    return view


@pytest.mark.parametrize("d,c", [(8, 6), (6, 4), (9, 8), (3, 8)])
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_layer_kernels_unaligned_rows_on_card(cuda, name, d, c):
    """(2, 16, 23, 3) → 5: 3-channel rows, which no vector load takes;
    then 8 channels starting off an 8-byte boundary."""
    kernel, plain = KERNELS[name]
    rng = np.random.default_rng(31 * d + c)
    for shape in ((2, 16, 23, 3), (2, 16, 23, 8)):
        x, w = operands(rng, shape, 5, d, c)
        xc, wc = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
        if shape[-1] == 8:
            xc = unaligned(xc)
        assert torch.equal(kernel(xc, wc, data_bits=d, coeff_bits=c),
                           plain(xc, wc, data_bits=d, coeff_bits=c))
        if name in REQUANT:
            check_requant(name, xc, wc, d, c)


@pytest.mark.parametrize("name", sorted(REQUANT))
def test_requant_entry_refuses_what_it_does_not_take(cuda, name):
    kernel, _ = REQUANT[name]
    kw = dict(data_bits=6, coeff_bits=4, shift=7, out_bits=6)
    x = torch.zeros((1, 16, 8, 2), dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 2, 3, 3), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(x.transpose(1, 2).contiguous().transpose(1, 2), w, **kw)
    with pytest.raises(ValueError, match="on cuda"):
        kernel(x, w.cpu(), **kw)
    with pytest.raises(ValueError, match="out_bits"):
        kernel(x, w, **dict(kw, out_bits=17))
    with pytest.raises(ValueError, match="shift"):
        kernel(x, w, **dict(kw, shift=-1))
    big = torch.zeros((64, 64, 3, 3), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        kernel(torch.zeros((1, 16, 8, 64), dtype=torch.int8, device=cuda),
               big, **kw)
    before = LAUNCHES[kernel.__name__]
    empty = kernel(x[:0], w, **kw)
    assert tuple(empty.shape) == (0, 16, 8, 3) and empty.dtype == torch.int8
    assert LAUNCHES[kernel.__name__] == before


# every entry that goes through ``conv2d.launch_layer``: (kernel, plain,
# the requantizing arguments)
LAYER_ENTRIES = {name: (k, p, {}) for name, (k, p) in KERNELS.items()} | {
    f"{name}_requant": (k, p, dict(shift=7, out_bits=8))
    for name, (k, p) in REQUANT.items()}


@pytest.mark.parametrize("name", sorted(LAYER_ENTRIES))
def test_layer_kernel_launches_on_the_current_stream(cuda, name):
    """Under ``torch.cuda.stream(s)`` a layer entry runs on s, after the
    work queued there before it: its input is written on s behind a
    sleep, so a launch on another stream would read the zeros the input
    held before."""
    kernel, plain, requant = LAYER_ENTRIES[name]
    kw = dict(data_bits=8, coeff_bits=6, **requant)
    x, w = operands(np.random.default_rng(4), (2, 32, 128, 8), 4, 8, 6)
    xc, wc = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    staged = torch.zeros_like(xc)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = LAUNCHES[kernel.__name__]
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        staged.copy_(xc)
        y = kernel(staged, wc, **kw)
    side.synchronize()
    assert LAUNCHES[kernel.__name__] == before + 1
    assert torch.equal(y, plain(xc, wc, **kw))


# Conv1 at the shapes its paths launch: the serving layer at bucket 1
# and the per-plane call (one image, ic = oc = 1); and more than one
# register tile of output channels over more than one staged chunk of
# input channels
CONV1_PATH_CASES = [((1, 32, 128, 8), 8, 8, 6), ((1, 32, 128, 1), 1, 8, 6),
                    ((2, 20, 40, 12), 17, 6, 5)]


@pytest.mark.parametrize("shape,oc,d,c", CONV1_PATH_CASES,
                         ids=["bucket1", "per_plane", "oc_tiles"])
def test_conv1_layer_at_path_shapes_on_card(cuda, shape, oc, d, c):
    rng = np.random.default_rng(shape[-1] + oc)
    x, w = operands(rng, shape, oc, d, c)
    xc, wc = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    before = LAUNCHES["conv1_layer"]
    y = conv2d.conv1_layer(xc, wc, data_bits=d, coeff_bits=c)
    torch.cuda.synchronize()
    assert LAUNCHES["conv1_layer"] == before + 1
    assert tuple(y.shape) == (shape[0], oc, *shape[1:3])
    assert torch.equal(y, conv2d.conv1_layer_plain(xc, wc, data_bits=d,
                                                   coeff_bits=c))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_container_range_int16_inputs_on_card(cuda, name):
    """Inputs over the whole int16 container at d=3 (Conv1's int16 plane
    accumulator wraps; the int8 dot narrows them as the reference
    does)."""
    kernel, plain = KERNELS[name]
    rng = np.random.default_rng(11)
    x, w = operands(rng, (2, 16, 24, 5), 3, 3, 8, x_range=(-32768, 32767))
    xc, wc = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    assert torch.equal(kernel(xc, wc, data_bits=3, coeff_bits=8),
                       plain(xc, wc, data_bits=3, coeff_bits=8))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_refuses_what_it_does_not_take(cuda, name):
    kernel, _ = KERNELS[name]
    x = torch.zeros((1, 16, 8, 2), dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 2, 3, 3), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(x.transpose(1, 2).contiguous().transpose(1, 2), w,
               data_bits=6, coeff_bits=4)
    with pytest.raises(ValueError, match="on cuda"):
        kernel(x, w.cpu(), data_bits=6, coeff_bits=4)
    big = torch.zeros((64, 64, 3, 3), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        kernel(torch.zeros((1, 16, 8, 64), dtype=torch.int8, device=cuda),
               big, data_bits=6, coeff_bits=4)
    empty = kernel(x[:0], w, data_bits=6, coeff_bits=4)
    assert tuple(empty.shape) == (0, 3, 16, 8)


def golden_engine(device, max_batch):
    plan = runtime.load_plan(PINNED)
    pcfg = deploy.plan_config(plan)
    with np.load(GOLDEN) as z:
        weights = [z[f"{PINNED.stem}.w{i}"] for i in range(3)]
        gx, gy = z[f"{PINNED.stem}.x"], z[f"{PINNED.stem}.y"]
    params = convert.params_from_numpy(weights, pcfg, device)
    engine = CNNEngine.from_plan(plan, params=params, device=device,
                                 serve_cfg=CNNServeConfig(max_batch=max_batch))
    return engine, gx, gy


def test_slice_on_card_matches_golden_through_all_kernels(cuda):
    """One forward of the pinned plan: K3 once, K1 and K2 once each
    through their requantizing entries and never through the int32
    ones."""
    engine, gx, gy = golden_engine(cuda, 8)
    counters = [conv2d.conv1_layer, base.fused_dot_layer_requant,
                base.packed_dot_layer_requant, base.fused_dot_layer,
                base.packed_dot_layer]
    before = [LAUNCHES[fn.__name__] for fn in counters]
    reqs = [ImageRequest(image=x, request_id=i)
            for i, x in enumerate(engine.compiled.sample_inputs(8))]
    engine.run(reqs)
    assert np.array_equal(np.stack([r.image for r in reqs]), gx)
    assert np.array_equal(np.stack([r.output for r in reqs]), gy)
    assert [LAUNCHES[fn.__name__] - b for fn, b in zip(counters, before)] \
        == [1, 1, 1, 0, 0]


def test_gateway_on_card_matches_golden(cuda):
    """The async gateway on the card, its dispatches in its worker
    thread: the pinned plan's golden images equal the golden outputs,
    with K1–K3 launched through their requantizing entries once per
    forward and never through the int32 ones."""
    engine, gx, gy = golden_engine(cuda, 8)
    gw = AsyncCNNGateway(AsyncServeConfig(max_batch=8))
    gw.register_plan(None, compiled=engine.compiled)
    counters = [conv2d.conv1_layer, base.fused_dot_layer_requant,
                base.packed_dot_layer_requant, base.fused_dot_layer,
                base.packed_dot_layer]
    before = [LAUNCHES[fn.__name__] for fn in counters]

    async def main():
        async with gw:
            futs = [gw.submit_nowait(x) for x in gx]
            return await asyncio.gather(*futs)

    outs = asyncio.run(main())
    assert np.array_equal(np.stack(outs), gy)
    forwards = sum(engine.compiled.bucket_hits.values())
    assert forwards == 1 and gw.stats()["served"] == len(gx)
    assert [LAUNCHES[fn.__name__] - b for fn, b in zip(counters, before)] \
        == [1, 1, 1, 0, 0]


def _golden_params(device):
    plan = runtime.load_plan(PINNED)
    with np.load(GOLDEN) as z:
        weights = [z[f"{PINNED.stem}.w{i}"] for i in range(3)]
        gx, gy = z[f"{PINNED.stem}.x"], z[f"{PINNED.stem}.y"]
    return plan, convert.params_from_numpy(
        weights, deploy.plan_config(plan), device), gx, gy


def test_cache_quarantines_and_rebuilds_a_corrupt_library(cuda, tmp_path):
    """A persistent cache on the card builds the pinned plan's three
    kernel libraries into ``<cache_dir>/kernels``; a library overwritten
    with garbage is quarantined as ``*.corrupt`` and rebuilt when the
    next cache makes its launches from disk, and the goldens stay
    exact."""
    from repro_torch.kernels import build
    from repro_torch.ops import PersistentExecutableCache
    plan, params, gx, gy = _golden_params(cuda)
    cold = PersistentExecutableCache(tmp_path)
    model = runtime.CompiledCNN.from_plan(plan, params=params, device=cuda,
                                          max_batch=8, exec_cache=cold)
    kdir = tmp_path / "kernels"
    libs = {"conv1_layer", "fused_dot_layer", "packed_dot_layer"}
    assert all(build.verified(n, kdir) for n in libs)
    assert np.array_equal(model(gx).cpu().numpy(), gy)
    lib = build.library_path("packed_dot_layer", kdir)
    junk = lib.with_name("junk")          # replaced, not written over:
    junk.write_bytes(b"\x00garbage")      # this process may map the old
    junk.replace(lib)
    runs = build.nvcc_runs
    warm = PersistentExecutableCache(tmp_path)
    again = runtime.CompiledCNN.from_plan(plan, params=params, device=cuda,
                                          max_batch=8, exec_cache=warm)
    assert warm.stats()["compiles"] == 0 and build.nvcc_runs == runs + 1
    assert lib.with_name(lib.name + ".corrupt").read_bytes() \
        == b"\x00garbage"
    assert build.verified("packed_dot_layer", kdir)
    assert np.array_equal(again(gx).cpu().numpy(), gy)


def test_warm_start_in_a_fresh_process_on_card(cuda, tmp_path):
    """A gateway built from a warm ``StoreRoot`` in a fresh process runs
    no ``nvcc``, prepares nothing, binds every kernel library from the
    root's ``exec-cache/kernels`` and serves the goldens exactly."""
    import json
    import subprocess
    import sys
    from repro_torch.chaos import respawn_gateway
    from repro_torch.ops import StoreRoot
    plan, _, gx, gy = _golden_params(cuda)
    root = StoreRoot(tmp_path)
    root.plans.save(plan, "cnn")
    cold = respawn_gateway(root, "a", ["cnn"], AsyncServeConfig(max_batch=8),
                           device="cuda")
    assert cold.exec_cache.stats()["compiles"] > 0
    cold.lease.release()
    np.save(tmp_path / "gx.npy", gx)
    code = f"""
import asyncio, json, sys
import numpy as np
from repro_torch import convert
from repro_torch.chaos import respawn_gateway
from repro_torch.core import deploy
from repro_torch.kernels import build
from repro_torch.ops import StoreRoot
from repro_torch.serve import AsyncServeConfig
root = StoreRoot({str(tmp_path)!r})
plan = root.plans.load("cnn")
with np.load({str(GOLDEN)!r}) as z:
    weights = [z["{PINNED.stem}.w" + str(i)] for i in range(3)]
params = convert.params_from_numpy(weights, deploy.plan_config(plan), "cuda")
gw = respawn_gateway(root, "c", ["cnn"], AsyncServeConfig(max_batch=8),
                     device="cuda", params={{"cnn": params}})
gx = np.load({str(tmp_path / "gx.npy")!r})
async def main():
    async with gw:
        return await asyncio.gather(*[gw.submit_nowait(x) for x in gx])
np.save({str(tmp_path / "out.npy")!r}, np.stack(asyncio.run(main())))
gw.lease.release()
print(json.dumps({{"nvcc_runs": build.nvcc_runs,
                  "cache": gw.exec_cache.stats(),
                  "bound": {{k: str(v) for k, v in build.bound_paths().items()}}}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(SRC.parent)})
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["nvcc_runs"] == 0 and res["cache"]["compiles"] == 0
    assert res["cache"]["disk_hits"] == 3 * 4
    assert set(res["bound"]) == {"conv1_layer", "fused_dot_layer",
                                 "packed_dot_layer"}
    kdir = (root.exec_cache_dir / "kernels").resolve()
    assert all(Path(p).resolve().parent == kdir
               for p in res["bound"].values())
    assert np.array_equal(np.load(tmp_path / "out.npy"), gy)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16, 17])
def test_compiled_on_card_matches_cpu_at_every_bucket(cuda, n):
    engine, _, _ = golden_engine(cuda, 16)
    model = engine.compiled
    xs = np.stack(model.sample_inputs(n, seed=n))
    y = model(xs)
    assert y.device.type == "cuda"
    ref = cnn.cnn_forward_ref([w.cpu() for w in model.params],
                              torch.from_numpy(xs), model.cfg)
    assert torch.equal(y.cpu(), ref)


PLANE_KERNELS = {"conv2": (conv2d.conv2_planes, conv2d.conv2_planes_plain),
                 "conv3": (conv2d.conv3_planes, conv2d.conv3_planes_plain),
                 "conv4": (conv2d.conv4_planes, conv2d.conv4_planes_plain)}
PLANE_CASES = [(k, d, c) for k in PLANE_KERNELS for d, c in POINTS
               + [(6, 7), (7, 6), (5, 3)]]


def plane_operands(rng, name, p, h, w, d, c, *, x_range=None):
    lo, hi = x_range or (-(1 << (d - 1)), (1 << (d - 1)) - 1)
    x = rng.integers(lo, hi + 1, (p, h, w))
    x.reshape(-1)[:2] = (lo, hi)
    wshape = (p, 3, 3) if name == "conv2" else (p, 2, 3, 3)
    wk = rng.integers(-(1 << (c - 1)), 1 << (c - 1), wshape)
    wk.reshape(-1)[:2] = (-(1 << (c - 1)), (1 << (c - 1)) - 1)
    xdt = torch.int16 if x_range else conv2d.container_dtype(d)
    return (torch.from_numpy(x).to(xdt),
            torch.from_numpy(wk).to(conv2d.container_dtype(c)))


@pytest.mark.parametrize("name,d,c", PLANE_CASES)
def test_plane_kernel_matches_plain_on_card(cuda, name, d, c):
    kernel, plain = PLANE_KERNELS[name]
    rng = np.random.default_rng(500 * d + c)
    x, w = plane_operands(rng, name, 33, 32, 40, d, c)
    xc, wc = x.to(cuda), w.to(cuda)
    before = LAUNCHES[kernel.__name__]
    y = kernel(xc, wc, data_bits=d, coeff_bits=c)
    torch.cuda.synchronize()
    assert LAUNCHES[kernel.__name__] == before + 1
    n_out = () if name == "conv2" else (2,)
    assert y.dtype == torch.int32 and tuple(y.shape) == (33, *n_out, 32, 40)
    assert torch.equal(y, plain(xc, wc, data_bits=d, coeff_bits=c))
    assert torch.equal(y.cpu(), plain(x, w, data_bits=d, coeff_bits=c))


@pytest.mark.parametrize("name", sorted(PLANE_KERNELS))
def test_plane_kernel_container_range_int16_inputs_on_card(cuda, name):
    kernel, plain = PLANE_KERNELS[name]
    rng = np.random.default_rng(12)
    for d, c in ((3, 8), (6, 6)):
        x, w = plane_operands(rng, name, 4, 16, 24, d, c,
                              x_range=(-32768, 32767))
        xc, wc = x.to(cuda), w.to(cuda)
        assert torch.equal(kernel(xc, wc, data_bits=d, coeff_bits=c),
                           plain(xc, wc, data_bits=d, coeff_bits=c))


# the per-plane path's P = 1, planes that fill no tile (17 x 33, 1 x 1)
# and a grid of many planes; the serving points, both containers and the
# widest widths
PLANE_SHAPES = [(1, 32, 128), (3, 17, 33), (4, 1, 1), (300, 16, 24)]
SHAPE_POINTS = [(8, 6), (6, 4), (16, 16), (9, 3), (3, 9)]


@pytest.mark.parametrize("shape", PLANE_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLANE_SHAPES])
@pytest.mark.parametrize("name", sorted(PLANE_KERNELS))
def test_plane_kernel_shapes_on_card(cuda, name, shape):
    kernel, plain = PLANE_KERNELS[name]
    rng = np.random.default_rng(sum(shape))
    for d, c in SHAPE_POINTS:
        x, w = plane_operands(rng, name, *shape, d, c)
        xc, wc = x.to(cuda), w.to(cuda)
        y = kernel(xc, wc, data_bits=d, coeff_bits=c)
        assert torch.equal(y, plain(xc, wc, data_bits=d, coeff_bits=c)), \
            (d, c)


@pytest.mark.parametrize("name", sorted(PLANE_KERNELS))
def test_plane_kernel_launches_on_the_current_stream(cuda, name):
    """Under ``torch.cuda.stream(s)`` the kernel runs on s, after the
    work queued there before it: its input is written on s behind a
    sleep, so a launch on another stream would read the zeros the
    input held before."""
    kernel, plain = PLANE_KERNELS[name]
    x, w = plane_operands(np.random.default_rng(3), name, 4, 32, 128, 8, 6)
    xc, wc = x.to(cuda), w.to(cuda)
    staged = torch.zeros_like(xc)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = LAUNCHES[kernel.__name__]
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        staged.copy_(xc)
        y = kernel(staged, wc, data_bits=8, coeff_bits=6)
    side.synchronize()
    assert LAUNCHES[kernel.__name__] == before + 1
    assert torch.equal(y, plain(xc, wc, data_bits=8, coeff_bits=6))


@pytest.mark.parametrize("name", sorted(PLANE_KERNELS))
def test_plane_kernel_refuses_what_it_does_not_take(cuda, name):
    kernel, _ = PLANE_KERNELS[name]
    x, w = plane_operands(np.random.default_rng(0), name, 2, 16, 8, 6, 4)
    x, w = x.to(cuda), w.to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(x.transpose(1, 2).contiguous().transpose(1, 2), w,
               data_bits=6, coeff_bits=4)
    with pytest.raises(ValueError, match="on cuda"):
        kernel(x, w.cpu(), data_bits=6, coeff_bits=4)
    before = LAUNCHES[kernel.__name__]
    assert kernel(x[:0], w[:0], data_bits=6, coeff_bits=4).shape[0] == 0
    assert LAUNCHES[kernel.__name__] == before


def test_apply_on_card_matches_golden(cuda):
    with np.load(GOLDEN) as z:
        keys = sorted({k.rsplit(".", 1)[0] for k in z.files
                       if k.startswith("apply.")})
        assert len(keys) == 21
        for key in keys:
            _, block, bits = key.split(".")
            d, c = (int(v) for v in bits[1:].split("c"))
            y = get_block(block).apply(
                torch.from_numpy(z[f"{key}.x"]).to(cuda),
                torch.from_numpy(z[f"{key}.w"]).to(cuda), data_bits=d,
                coeff_bits=c)
            assert y.device.type == "cuda"
            assert np.array_equal(y.cpu().numpy(), z[f"{key}.y"]), key


@pytest.mark.parametrize("plan_path", [UNPINNED, PINNED],
                         ids=lambda p: p.stem)
def test_per_plane_forwards_on_card_match_golden(cuda, plan_path):
    plan = runtime.load_plan(plan_path)
    pcfg = deploy.plan_config(plan)
    with np.load(GOLDEN) as z:
        weights = [z[f"{plan_path.stem}.w{i}"] for i in range(3)]
        gx, gy = z[f"{plan_path.stem}.x"], z[f"{plan_path.stem}.y"]
    params = convert.params_from_numpy(weights, pcfg, cuda)
    x = torch.from_numpy(gx[0]).to(cuda)
    for fwd in (cnn.cnn_forward_loop, cnn.cnn_forward):
        y = fwd(params, x, pcfg, plan.block_names())
        assert np.array_equal(y.cpu().numpy(), gy[0]), fwd.__name__


def test_validate_plan_on_card(cuda, tmp_path):
    rows = synth.run_sweep(REDUCED_SWEEP, cache_path=tmp_path / "s.json")
    cfg = cnn.quickstart_cnn_config()
    plan = deploy.plan_deployment(cfg, cnn.fitted_block_models(rows),
                                  allocate.get_device("v5e"), target=0.8,
                                  on_infeasible="fallback")
    before = LAUNCHES["conv4_planes"]
    val = deploy.validate_plan(plan, cfg, device=cuda)
    assert LAUNCHES["conv4_planes"] > before
    assert val.bit_exact
    for r, m in val.metrics.items():
        assert m["mape_pct"] < 2.0, (r, m)


# (B, S, C, K, with a state, dtype): the launches of a Mamba-2-1.3B layer
# on the serving path (conv_x over 4096 channels, conv_B and conv_C over
# 128 each; a prefill of 512 without a state, a decode step at batch 4
# with one), short prefills against a state, odd channel counts
CONV1D_CASES = [(1, 512, 4096, 4, False, torch.bfloat16),
                (1, 512, 128, 4, False, torch.bfloat16),
                (4, 1, 4096, 4, True, torch.bfloat16),
                (4, 1, 128, 4, True, torch.bfloat16),
                (2, 37, 64, 4, True, torch.float32),
                (2, 2, 64, 4, True, torch.float32),
                (3, 130, 100, 3, False, torch.float32),
                (2, 70, 33, 1, True, torch.bfloat16)]


@pytest.mark.parametrize("b,s,c,k,with_state,dtype", CONV1D_CASES)
def test_conv1d_kernel_matches_plain_on_card(cuda, b, s, c, k, with_state,
                                             dtype):
    """Bit-exact: the kernel rounds each product and sum in float32 in
    the plain version's order (no fused multiply-add)."""
    g = torch.Generator(device=cuda).manual_seed(s * c + k)
    x = torch.randn(b, s, c, generator=g, device=cuda).to(dtype)
    w = torch.randn(k, c, generator=g, device=cuda).to(dtype)
    st = torch.randn(b, k - 1, c, generator=g, device=cuda).to(dtype) \
        if with_state else None
    before = LAUNCHES["causal_conv1d"]
    y = conv1d.causal_conv1d(x, w, st)
    torch.cuda.synchronize()
    assert LAUNCHES["causal_conv1d"] == before + 1
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, c)
    assert torch.equal(y, conv1d.causal_conv1d_plain(x, w, st))


# (B, S, T, H, KH, D, causal, dtype): the Llama-3.2-3B prefill shape, a
# length that is not a tile multiple, the smoke width, D = 8 and 256,
# MQA, S != T; bf16 (the tensor-core kernel) also at D = 8 and 72 (head
# dims padded to 16 and 80), at D = 36 (not a multiple of 8: the tiles
# load without cp.async) and non-causal with S > T
FLASH_CASES = [(1, 512, 512, 24, 8, 128, True, torch.bfloat16),
               (1, 300, 300, 24, 8, 128, True, torch.bfloat16),
               (2, 16, 16, 4, 2, 16, True, torch.float32),
               (2, 48, 48, 4, 4, 8, True, torch.float32),
               (2, 256, 256, 8, 1, 32, False, torch.float32),
               (1, 100, 300, 4, 2, 256, True, torch.float32),
               (1, 65, 130, 8, 4, 256, False, torch.bfloat16),
               (2, 100, 100, 4, 2, 8, True, torch.bfloat16),
               (1, 130, 130, 6, 3, 72, True, torch.bfloat16),
               (1, 77, 77, 4, 4, 36, True, torch.bfloat16),
               (2, 200, 70, 8, 1, 128, False, torch.bfloat16),
               # the LM zoo's prefills: Qwen3-MoE (GQA group 8) and
               # Whisper's decoder (MHA at head dim 64)
               (1, 512, 512, 32, 4, 128, True, torch.bfloat16),
               (1, 512, 512, 16, 16, 64, True, torch.bfloat16)]


@pytest.mark.parametrize("b,s,t,h,kh,d,causal,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, b, s, t, h, kh, d, causal,
                                            dtype):
    """float32: 2e-5 (the same blocked online softmax, products summed in
    another order); bfloat16: the tensor-core kernel's split P keeps its
    float32 result within about 2^-16 relative of the plain version's, so
    the two round at most one bf16 unit apart (2^-7 relative)."""
    g = torch.Generator(device=cuda).manual_seed(s + t + d)
    q = torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, t, kh, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, t, kh, d, generator=g, device=cuda).to(dtype)
    before = LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 \
        else dict(rtol=2 ** -7, atol=1e-3)
    torch.testing.assert_close(out.float(), want.float(), **tol)


def test_lm_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv1d.causal_conv1d(x.transpose(1, 2).contiguous().transpose(1, 2),
                             torch.zeros(4, 16, device=cuda))
    with pytest.raises(ValueError, match="K <= 8"):
        conv1d.causal_conv1d(x, torch.zeros(9, 16, device=cuda))
    q = torch.zeros(1, 8, 2, 512, device=cuda)
    with pytest.raises(ValueError, match="head dims up to 256"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q)


def _pad_kv(cache, n):
    for entry in cache.values():
        for name in ("k", "v"):
            if name in entry:
                entry[name] = torch.nn.functional.pad(entry[name],
                                                      (0, 0, 0, 0, 0, n))
    return cache


LM_GOLDEN_ARCHS = {"llama3.2-3b": LM_GOLDEN, "mamba2-1.3b": LM_GOLDEN,
                   "qwen3-moe-30b-a3b": LM_ZOO_GOLDEN,
                   "llama4-maverick-400b-a17b": LM_ZOO_GOLDEN,
                   "jamba-1.5-large-398b": LM_ZOO_GOLDEN,
                   "whisper-medium": LM_ZOO_GOLDEN,
                   "pixtral-12b": LM_ZOO_GOLDEN}


@pytest.mark.parametrize("arch", list(LM_GOLDEN_ARCHS))
def test_lm_on_card_matches_golden(cuda, arch):
    """Every zoo arch's smoke config at float32 on the card against the
    reference's committed outputs: logits within 2e-3 (a vision prefix
    counted in the decode positions), greedy tokens equal where the file
    holds them (for the MoE archs two identical prompts in one wave); K8
    once per attention layer per prefill and never in decode, K7 three
    times per Mamba layer per call; the expert kernels twice per MoE
    layer per call (a float32 gated SiLU MoE MLP in inference), never
    without one."""
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    with np.load(LM_GOLDEN_ARCHS[arch]) as z:
        g = {k: z[k] for k in z.files if k.startswith(arch + "/")}
    model = build_model(cfg, cuda)
    params = convert.lm_params_from_numpy(
        convert.nested_from_flat(g, f"{arch}/params"), cfg, cuda)
    batch = {"tokens": g[f"{arch}/tokens"]}
    for name in ("frames", "patches"):
        if f"{arch}/{name}" in g:
            batch[name] = g[f"{arch}/{name}"]
    attn = sum(s.mixer == "attn" for s in cfg.layer_cycle) * cfg.n_cycles
    mamba = sum(s.mixer == "mamba" for s in cfg.layer_cycle) * cfg.n_cycles
    k7, k8 = LAUNCHES["causal_conv1d"], LAUNCHES["flash_attention"]
    experts = meg.launches()
    logits, _ = model.prefill(params, batch)
    assert LAUNCHES["flash_attention"] - k8 == attn
    assert LAUNCHES["causal_conv1d"] - k7 == 3 * mamba
    assert (meg.launches() - experts > 0) \
        == (cfg.moe is not None)
    np.testing.assert_allclose(logits.cpu().numpy(),
                               g[f"{arch}/prefill_logits"], rtol=2e-3,
                               atol=2e-3)
    pos = g[f"{arch}/decode_pos"]
    start = batch["tokens"].shape[1] - len(pos)
    _, cache = model.prefill(params, dict(batch,
                                          tokens=batch["tokens"][:, :start]))
    cache = _pad_kv(cache, len(pos))
    k7, k8 = LAUNCHES["causal_conv1d"], LAUNCHES["flash_attention"]
    for i, p in enumerate(pos):
        t = start + i
        logits, cache = model.decode_step(params, cache,
                                          batch["tokens"][:, t:t + 1], int(p))
        np.testing.assert_allclose(logits.cpu().numpy(),
                                   g[f"{arch}/decode_logits"][i],
                                   rtol=2e-3, atol=2e-3)
    assert LAUNCHES["flash_attention"] == k8
    assert LAUNCHES["causal_conv1d"] - k7 == 3 * mamba * len(pos)
    if f"{arch}/engine_prompts" in g:
        reqs = [Request(prompt=[int(t) for t in p], request_id=i)
                for i, p in enumerate(g[f"{arch}/engine_prompts"])]
        Engine(model, params, ServeConfig(max_batch=2, max_len=32,
                                          max_new_tokens=5,
                                          admission="lockstep")).run(reqs)
        assert [r.out_tokens for r in reqs] \
            == g[f"{arch}/engine_tokens"].tolist()


def test_qwen3_moe_full_width_cut_kernel_matches_plain_on_card(cuda):
    """Qwen3-MoE-30B-A3B at full width cut to 4 layers, bf16, seeded
    weights: the prefill on K8 (4 launches) against the same prefill
    with K8's plain version, relative L2 of the logits within 5e-2."""
    from repro_torch.models import attention
    cfg = get_config("qwen3-moe-30b-a3b").with_overrides(n_layers=4)
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(1))
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (1, 100))
    before = LAUNCHES["flash_attention"]
    logits, _ = model.prefill(params, {"tokens": toks})
    assert LAUNCHES["flash_attention"] - before == 4
    kernel = attention.flash_attention
    attention.flash_attention = fa.flash_attention_plain
    try:
        plain, _ = model.prefill(params, {"tokens": toks})
    finally:
        attention.flash_attention = kernel
    assert LAUNCHES["flash_attention"] - before == 4
    a, b = logits.float().cpu(), plain.float().cpu()
    assert torch.isfinite(a).all()
    assert float((a - b).norm() / b.norm()) < 5e-2


def test_moe_on_card_matches_golden_and_syncs_nothing(cuda):
    """The golden smoke MoE plan on the card: each layer at buckets 1, 2
    and 4 on the JAX reference's input to it within 1e-4 of the
    reference's output, the bucketed forward equal to the unbucketed
    stack, and a forward that never waits for the card."""
    from repro_torch.runtime.workloads import _eager_forward
    with np.load(MOE_GOLDEN) as z:
        plan = deploy.DeploymentPlan.from_json(str(z["plan"]))
        spec = runtime.moe_plan_spec(plan)
        params = convert.moe_params_from_numpy(
            [{k.split("/")[-1]: z[k] for k in z.files
              if k.startswith(f"params/L{i}/")}
             for i in range(len(spec.layers))], spec, "cuda")
        acts = list(z["layer_in"]) + [z["y"]]
    model = runtime.CompiledMoE(spec, params, max_batch=4, device="cuda")
    for lo, hi in ((0, 1), (1, 3), (3, 7)):
        bucket = model.bucket_for(hi - lo)
        for i in range(model.num_layers):
            y = model._compile_layer(i, bucket)(
                model.params[i], torch.from_numpy(acts[i][lo:hi]).cuda())
            np.testing.assert_allclose(y.cpu().numpy(), acts[i + 1][lo:hi],
                                       rtol=1e-5, atol=1e-4)
    x = torch.from_numpy(acts[0][:4]).cuda()
    assert torch.equal(model(x), _eager_forward(spec, model.params, x))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("e,cap,d,f,fill", [
    (8, 64, 256, 128, [0, 1, 7, 8, 9, 33, 64, 64]),
    (6, 100, 132, 100, [0, 1, 7, 8, 9, 130]),
])
def test_moe_expert_gemm_matches_plain_on_card(cuda, e, cap, d, f, fill):
    """The two expert kernels against their plain version
    (``expert_ffn_bmm``, and its hidden activation) on the card on every
    filled row (rtol = atol = 1e-4: float32 sums in another order), with
    every row past the fill NaN in their inputs; two launches a call.
    The second shape has two row tiles, widths that are no multiple of
    the column slices, and a fill past the capacity."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(e, cap, d, generator=g, device="cuda")
    wg, wu = (torch.randn(e, d, f, generator=g, device="cuda") / d ** 0.5
              for _ in range(2))
    wd = torch.randn(e, f, d, generator=g, device="cuda") / f ** 0.5
    fill = torch.tensor(fill, device="cuda")
    empty = ~(torch.arange(cap, device="cuda")[None, :]
              < fill[:, None])[..., None]
    x.masked_fill_(empty, float("nan"))
    hs = []
    y_want = meg.expert_ffn_bmm(x, wu, wd, wg,
                                mid=lambda h: hs.append(h) or h)
    h_want = hs[0]
    before = meg.launches()
    h = meg.moe_expert_gemm_gate_up(x, wg, wu, fill)
    y = meg.moe_expert_ffn(x, wg, wu, wd, fill)
    torch.cuda.synchronize()
    assert meg.launches() - before == 3
    for got, want in ((h, h_want), (y, y_want)):
        rows = ~empty.expand_as(got)
        torch.testing.assert_close(got[rows], want[rows], rtol=1e-4,
                                   atol=1e-4)


#: relative L2 error of the bf16 expert kernels' filled rows against
#: float32 products of the same bf16 inputs: each output is rounded to
#: bf16 once (a relative error of at most 2^-9; h's rounding adds as much
#: again to y), so twice bf16's rounding unit, 2^-7, holds them with room
BF16_EXPERT_TOL = 2.0 ** -7

#: (E, C, D, F, fills, rows) of the bf16 expert kernels' card cases:
#: "decode" is Qwen3-30B-A3B's decode step (8 tokens, top 8, dropless:
#: capacity 8), its fills from a seeded routing; "prefill" a prompt of
#: 1,108 tokens (capacity 1,108) with skewed fills, one expert holding
#: every token; "ragged" widths that are no multiple of the column
#: slices or of K's stage, fills past the capacity, and a bound of 0 on
#: the fills' sum, so that each block loops over the items
BF16_EXPERT_CASES = {
    "decode": (128, 8, 2048, 768, "route:8", 64),
    "decode-empty": (128, 8, 2048, 768, "all:0", 64),
    "decode-full": (128, 8, 2048, 768, "all:8", None),
    "prefill": (128, 1108, 2048, 768, "skew:1108", 8 * 1108),
    "ragged": (6, 100, 136, 104, [0, 1, 7, 8, 65, 130], 0),
}


def _bf16_expert_fill(spec, e, cap, d, seed):
    """Each expert's fill for a case: a seeded top-8 routing of n tokens
    (``route:n``), every expert at n (``all:n``), a skewed split of
    8 n rows (``skew:n``: shares as 1 / (i + 1)^1.5, clamped to the
    capacity), or the list itself."""
    from repro_torch.models import moe as moe_mod
    if isinstance(spec, list):
        return torch.tensor(spec, device="cuda")
    kind, n = spec.split(":")
    n = int(n)
    if kind == "all":
        return torch.full((e,), n, dtype=torch.int64, device="cuda")
    if kind == "skew":
        share = 1.0 / np.arange(1, e + 1) ** 1.5
        fill = np.floor(8 * n * share / share.sum()).astype(np.int64)
        fill[e // 2:] = 0
        return torch.from_numpy(np.minimum(fill, cap)).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, generator=g, device="cuda")
    router = torch.randn(d, e, generator=g, device="cuda") / d ** 0.5
    _, _, ids = moe_mod._route(x, router, 8)
    return torch.clamp(moe_mod._expert_counts(ids.reshape(-1), e), max=cap)


def _bf16_expert_inputs(e, cap, d, f, fill, seed):
    """bf16 buffers x (E, C, D), zeros past each fill as the dispatch
    leaves them, the weights, and the (E, C, 1) filled rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    filled = (torch.arange(cap, device="cuda")[None, :]
              < fill[:, None])[..., None]
    x = torch.randn(e, cap, d, generator=g, device="cuda") \
        .masked_fill(~filled, 0).bfloat16()
    wg, wu = ((torch.randn(e, d, f, generator=g, device="cuda")
               / d ** 0.5).bfloat16() for _ in range(2))
    wd = (torch.randn(e, f, d, generator=g, device="cuda")
          / f ** 0.5).bfloat16()
    return x, wg, wu, wd, filled


def _rel_l2_rows(got, want, rows):
    got, want = got[rows].float(), want[rows].float()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("case", sorted(BF16_EXPERT_CASES))
def test_moe_expert_gemm_bf16_matches_float32_on_card(cuda, case):
    """The bf16 expert kernels on each case's filled rows against float32
    products of the same bf16 inputs (TF32 off): within BF16_EXPERT_TOL
    relative L2, and at least as close as ``expert_ffn_bmm`` in bf16
    (three roundings where the kernels' epilogue rounds once); the down
    kernel alone on the gate_up kernel's h equal to the pair; with every
    row past the fill NaN in x and in h, every written row unchanged bit
    for bit; two launches a call."""
    e, cap, d, f, spec, rows = BF16_EXPERT_CASES[case]
    fill = _bf16_expert_fill(spec, e, cap, d, seed=11)
    x, wg, wu, wd, filled = _bf16_expert_inputs(e, cap, d, f, fill, seed=12)
    xf, wgf, wuf, wdf = (t.float() for t in (x, wg, wu, wd))
    h_want = torch.nn.functional.silu(torch.bmm(xf, wgf)) * torch.bmm(xf, wuf)
    y_want = torch.bmm(h_want, wdf)
    del xf, wgf, wuf, wdf
    hs = []
    y_bmm = meg.expert_ffn_bmm(x, wu, wd, wg, mid=lambda h: hs.append(h) or h)
    before = meg.launches()
    h = meg.moe_expert_gemm_gate_up(x, wg, wu, fill, rows)
    y = meg.moe_expert_ffn(x, wg, wu, wd, fill, rows)
    torch.cuda.synchronize()
    assert meg.launches() - before == 3
    assert h.dtype == y.dtype == torch.bfloat16
    rows_h, rows_y = filled.expand_as(h), filled.expand_as(y)
    assert bool(rows_y.any()) == (int(fill.sum()) > 0)
    if rows_y.any():
        for got, want, bmm, r in ((h, h_want, hs[0], rows_h),
                                  (y, y_want, y_bmm, rows_y)):
            assert torch.isfinite(got[r]).all()
            err = _rel_l2_rows(got, want, r)
            assert err <= BF16_EXPERT_TOL
            assert err <= _rel_l2_rows(bmm, want, r)
    y_down = meg.moe_expert_gemm_down(h, wd, fill, rows)
    assert torch.equal(y_down[rows_y], y[rows_y])
    nan = float("nan")
    h_p = meg.moe_expert_gemm_gate_up(x.masked_fill(~filled, nan), wg, wu,
                                      fill, rows)
    y_p = meg.moe_expert_gemm_down(h.masked_fill(~filled, nan), wd, fill,
                                   rows)
    torch.cuda.synchronize()
    assert torch.equal(h_p[rows_h], h[rows_h])
    assert torch.equal(y_p[rows_y], y[rows_y])


def test_moe_expert_gemm_bf16_graph_replays_equal_eager_on_card(cuda):
    """The bf16 pair at the decode shape captured in one CUDA graph and
    replayed with the fills and the buffer changed between replays (four
    seeded routings, no row, every row): each replay's filled rows equal
    an eager call's on the same inputs bit for bit."""
    e, cap, d, f = 128, 8, 2048, 768
    fills = [_bf16_expert_fill("route:8", e, cap, d, seed=s)
             for s in range(4)]
    fills += [_bf16_expert_fill("all:0", e, cap, d, 0),
              _bf16_expert_fill("all:8", e, cap, d, 0)]
    inputs = [_bf16_expert_inputs(e, cap, d, f, fl, seed=20 + i)
              for i, fl in enumerate(fills)]
    x = inputs[0][0].clone()
    _, wg, wu, wd, _ = inputs[0]
    fill = fills[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        meg.moe_expert_ffn(x, wg, wu, wd, fill, e * cap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = meg.moe_expert_ffn(x, wg, wu, wd, fill, e * cap)
    for fl, (xi, _, _, _, filled) in zip(fills, inputs):
        fill.copy_(fl)
        x.copy_(xi)
        graph.replay()
        want = meg.moe_expert_ffn(xi, wg, wu, wd, fl, e * cap)
        torch.cuda.synchronize()
        rows = filled.expand_as(out)
        assert torch.equal(out[rows], want[rows])


# ---------------------------------------------------------------------------
# training: gradients through K7 and K8
# ---------------------------------------------------------------------------

def _grads_on(device, fn, arrays, dout):
    """(output, gradients of ``sum(fn(*inputs) * dout)``) with the
    numpy ``arrays`` as inputs on ``device``, as float32 CPU tensors."""
    ins = [torch.from_numpy(a).to(device) for a in arrays]
    dtype = torch.bfloat16 if dout.dtype == np.float16 else None
    if dtype is not None:
        ins = [t.to(dtype) for t in ins]
    ins = [t.requires_grad_() for t in ins]
    out = fn(*ins)
    d = torch.from_numpy(dout.astype(np.float32)).to(device).to(out.dtype)
    out.backward(d)
    return out.detach().float().cpu(), [t.grad.float().cpu() for t in ins]


@pytest.mark.parametrize("b,s,h,kh,d,dtype", [
    (2, 16, 4, 2, 16, np.float32), (1, 1100, 8, 2, 64, np.float32),
    (2, 512, 24, 8, 128, np.float16)])
def test_flash_backward_on_card_matches_cpu(cuda, b, s, h, kh, d, dtype):
    """K8's ``Function`` on the card (one kernel launch forward, the
    chunked recompute backward) against the same on the CPU (the plain
    forward): float32 output within 2e-5 and gradients within 1e-4;
    bf16 (``np.float16`` marks it here) output within one bf16 unit and
    gradients within 2e-2."""
    rng = np.random.default_rng(s + d)
    arrays = [rng.standard_normal((b, s, n, d)).astype(np.float32)
              for n in (h, kh, kh)]
    dout = rng.standard_normal((b, s, h, d)).astype(dtype)
    before = LAUNCHES["flash_attention"]
    out, grads = _grads_on(cuda, fa.flash_attention, arrays, dout)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    cpu_out, cpu_grads = _grads_on("cpu", fa.flash_attention, arrays, dout)
    f32 = dtype == np.float32
    torch.testing.assert_close(out, cpu_out, **(
        dict(rtol=2e-5, atol=2e-5) if f32 else dict(rtol=2 ** -7,
                                                    atol=1e-3)))
    for got, want in zip(grads, cpu_grads):
        torch.testing.assert_close(got, want, **(
            dict(rtol=1e-4, atol=1e-4) if f32 else dict(rtol=2e-2,
                                                        atol=2e-2)))


@pytest.mark.parametrize("b,s,c,k,dtype", [
    (2, 37, 64, 4, np.float32), (2, 2048, 4096, 4, np.float16),
    (2, 2048, 128, 4, np.float16)])
def test_conv1d_backward_on_card_matches_cpu(cuda, b, s, c, k, dtype):
    """K7's ``Function`` on the card against the CPU: the forward equal
    (the kernel's float32 order), the gradients of x and w within 1e-5
    relative (float32 sums in another order); bf16 (``np.float16`` marks
    it) gradients within one bf16 unit."""
    rng = np.random.default_rng(s + c)
    arrays = [rng.standard_normal((b, s, c)).astype(np.float32),
              rng.standard_normal((k, c)).astype(np.float32)]
    dout = rng.standard_normal((b, s, c)).astype(dtype)
    before = LAUNCHES["causal_conv1d"]
    out, grads = _grads_on(cuda, conv1d.causal_conv1d, arrays, dout)
    torch.cuda.synchronize()
    assert LAUNCHES["causal_conv1d"] == before + 1
    cpu_out, cpu_grads = _grads_on("cpu", conv1d.causal_conv1d, arrays,
                                   dout)
    assert torch.equal(out, cpu_out)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == np.float32 \
        else dict(rtol=2 ** -7, atol=1e-2)
    for got, want in zip(grads, cpu_grads):
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b",
                                  "qwen3-moe-30b-a3b"])
def test_forward_train_on_card_matches_golden(cuda, arch):
    """``forward_train`` at smoke size, float32, on the card against the
    reference's training golden: the loss within 1e-5 relative and every
    gradient leaf (the attention projections and conv taps, whose
    gradients run through K8's and K7's backwards, among them) within
    relative L2 1e-4; K8/K7 launched for each layer's forward and its
    remat recompute."""
    from repro_torch import tree
    from repro_torch.train.step import loss_and_grads
    with np.load(TRAIN_GOLDEN) as z:
        g = {k: z[k] for k in z.files if k.startswith(arch + "/")}
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    params = convert.lm_params_from_numpy(
        convert.nested_from_flat(g, f"{arch}/params"), cfg, cuda)
    before = LAUNCHES["flash_attention"] + LAUNCHES["causal_conv1d"]
    loss, _, grads = loss_and_grads(
        build_model(cfg, cuda), params,
        {"tokens": g[f"{arch}/tokens"], "labels": g[f"{arch}/labels"]})
    layers = cfg.n_layers * (3 if arch.startswith("mamba") else 1)
    assert LAUNCHES["flash_attention"] + LAUNCHES["causal_conv1d"] \
        == before + 2 * layers
    np.testing.assert_allclose(float(loss), g[f"{arch}/loss"], rtol=1e-5)
    for k, v in tree.flatten(grads).items():
        want = g[f"{arch}/grads/{k}"]
        err = np.linalg.norm(v.cpu().numpy() - want) / np.linalg.norm(want)
        assert err < 1e-4, (k, err)


# ---------------------------------------------------------------------------
# the multi-device layer on the card: each case in child processes joined
# by an NCCL group (``torch_parity.run_ranks``)
# ---------------------------------------------------------------------------

def _write_smoke_case(tmp_path, arch, **extra):
    """The reference's smoke parameters of ``arch`` from the training
    golden, as the ranks read them, and their config."""
    import json
    with np.load(TRAIN_GOLDEN) as z:
        np.savez(tmp_path / "params.npz", **{
            "p/" + k[len(arch) + len("/params/"):]: z[k] for k in z.files
            if k.startswith(f"{arch}/params/")})
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"arch": arch, "overrides": {"dtype": "float32"}, **extra}))


def test_sharded_train_step_on_card(cuda, tmp_path):
    """Llama smoke, float32, a one-device NCCL (data, model) mesh: the
    sharded step's loss within 1e-5 of the unsharded step's, every
    gradient within relative L2 1e-4 and every parameter after it within
    1e-5; K8 launched through ``local_map`` twice per layer (forward and
    remat recompute)."""
    from torch_parity import run_ranks
    from repro_torch import tree
    _write_smoke_case(tmp_path, "llama3.2-3b")
    out = run_ranks("sharded_train_step", 1, tmp_path, backend="nccl")[0]
    assert abs(out["loss_sharded"] - out["loss"]) <= 1e-5 * abs(out["loss"])
    assert out["k8_launches"] == 2 * smoke_config("llama3.2-3b").n_layers
    for a, b, tol in (("grads", "grads_sharded", 1e-4),
                      ("params", "params_sharded", 1e-5)):
        want, got = tree.flatten(out[a]), tree.flatten(out[b])
        for k, v in want.items():
            err = float((got[k] - v).norm() / max(float(v.norm()), 1e-30))
            assert err < tol, (a, k, err)


def test_sharded_serve_on_card(cuda, tmp_path):
    """Llama smoke on a one-device NCCL mesh: a sharded prefill (K8
    through ``local_map``) and four decode steps against the unsharded
    calls, logits within 1e-5."""
    from torch_parity import run_ranks
    _write_smoke_case(tmp_path, "llama3.2-3b")
    np.save(tmp_path / "tokens.npy", np.random.default_rng(0).integers(
        0, smoke_config("llama3.2-3b").vocab_size, (4, 12)))
    out = run_ranks("sharded_serve", 1, tmp_path, backend="nccl")[0]
    for key in ["prefill"] + [f"decode{i}" for i in range(4)]:
        torch.testing.assert_close(out[key + "_sharded"], out[key],
                                   rtol=1e-5, atol=1e-5, msg=key)


def test_four_cards(cuda, tmp_path):
    """Four NCCL ranks, one card each (skips below four cards): the
    (2, 2) sharded Llama-3.2-3B train step at full width against one
    card's (loss within 1e-3 relative, every randomly initialized
    parameter leaf within relative L2 1e-3, bf16: a zero-initialized
    norm's first AdamW update is ±lr wherever its gradient is near eps,
    as ``test_torch_parallel`` says), the MoE shard_map halves against
    the no-mesh path (a bf16 unit: the combine sums bf16 partials) and
    the dense oracle (5e-3), and ``pipeline_forward`` over 4 stages
    against the stages run in turn (1e-5)."""
    import json
    import dataclasses
    from torch_parity import run_ranks
    from repro_torch.models import moe as moe_mod
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    (tmp_path / "llama").mkdir()
    full = run_ranks("full_width_train_step", 4, tmp_path / "llama",
                     backend="nccl", timeout=900)
    for out in full:
        print(f"four cards, full width: {out}")
        assert abs(out["loss_sharded"] - out["loss"]) <= \
            1e-3 * abs(out["loss"]), out
        assert out["worst_rel_l2"] < 1e-3, out

    moe_dir = tmp_path / "moe"
    moe_dir.mkdir()
    cfg = smoke_config("qwen3-moe-30b-a3b").with_overrides(
        dtype="float32", moe_groups=4, moe_combine_shardmap=True,
        moe_shard_hints=True)
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                     capacity_factor=8.0))
    p = moe_mod.init_moe(torch.Generator().manual_seed(0), cfg)
    x = 0.1 * torch.randn((4, 16, cfg.d_model),
                          generator=torch.Generator().manual_seed(1))
    np.savez(moe_dir / "moe.npz", x=x.numpy(),
             **{f"p/{k}": v.numpy() for k, v in p.items()})
    (moe_dir / "cfg.json").write_text(json.dumps(
        {"arch": "qwen3-moe-30b-a3b", "capacity_factor": 8.0,
         "overrides": {"dtype": "float32", "moe_groups": 4,
                       "moe_combine_shardmap": True,
                       "moe_shard_hints": True}}))
    out = run_ranks("moe_shardmap", 4, moe_dir, backend="nccl")[0]
    dense = moe_mod.moe_layer_dense_ref(p, x, cfg)
    assert float((out["out_sharded"] - dense).abs().max()) < 5e-3
    for got, want in [(out["out_sharded"], out["out"])] + [
            (out["grads_sharded"][k], g) for k, g in out["grads"].items()]:
        assert float(got.abs().sum()) > 0
        assert float((got - want).abs().max()) <= \
            2.0 ** -8 * float(want.abs().max())

    pipe_dir = tmp_path / "pipe"
    pipe_dir.mkdir()
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(4, 16, 16)) / 4).astype(np.float32)
    xs = rng.normal(size=(8, 2, 16)).astype(np.float32)
    np.savez(pipe_dir / "pipe.npz", w=w, x=xs)
    ref = torch.from_numpy(xs)
    for i in range(4):
        ref = torch.tanh(ref @ torch.from_numpy(w[i]))
    for out in run_ranks("pipeline", 4, pipe_dir, backend="nccl"):
        assert float((out["out"] - ref).abs().max()) < 1e-5


def test_per_row_decode_graph_matches_eager_on_card(cuda):
    """The published Qwen3-30B-A3B at smoke size in bf16 (QK-norm,
    dropless) on the card: three prompts of 5, 9 and 13 tokens in one
    pool cache, decoded four steps at per-row positions through
    ``Model.decode_step`` (a CUDA graph captured at the first step and
    replayed) and through the eager ``transformer.decode_step`` on a
    copy of the cache: the same logits and caches, bit for bit (the
    same kernels on the same tensors), and the expert kernels launched
    twice a layer a step, never ``torch.bmm``; then the per-slot
    ``Engine``, in
    float32 (TF32 off: a pool of three and a request alone take
    products of other shapes), serves each request the tokens it gets
    alone."""
    from repro_torch.models import transformer as tf
    cfg = smoke_config("qwen3-30b-a3b")
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(5))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 9, 13)]
    graphed = model.init_cache(3, 32)
    toks = []
    for b, p in enumerate(prompts):
        logits, one = model.prefill(params, {"tokens": [p]})
        for name in ("k", "v"):
            graphed["s0"][name][:, b, :len(p)] = one["s0"][name][:, 0]
        toks.append(int(logits.argmax(-1)))
    eager = {k: {n: t.clone() for n, t in e.items()}
             for k, e in graphed.items()}
    tok = torch.tensor(toks, device=cuda)[:, None]
    pos = torch.tensor([5, 9, 13], device=cuda)
    for _ in range(4):
        n0, l0 = LAUNCHES[meg.BMM_FALLBACK], meg.launches()
        got, _ = model.decode_step(params, graphed, tok, pos)
        # the eager first step and each replay: every layer's bf16
        # expert products on the two bf16 kernels, none on torch.bmm
        assert LAUNCHES[meg.BMM_FALLBACK] - n0 == 0
        assert meg.launches() - l0 == 2 * cfg.n_layers
        want, _ = tf.decode_step(params, eager, tok, pos, cfg)
        assert torch.equal(got, want)
        tok, pos = want.argmax(-1)[:, None], pos + 1
    assert model._decode_graph is not None
    for name in ("k", "v"):
        assert torch.equal(graphed["s0"][name], eager["s0"][name])

    cfg32 = cfg.with_overrides(dtype="float32")
    params32 = build_model(cfg32, cuda).init(
        torch.Generator(device=cuda).manual_seed(5))

    def serve(batch, ps):
        reqs = [Request(prompt=list(p)) for p in ps]
        Engine(build_model(cfg32, cuda), params32, ServeConfig(
            max_batch=batch, max_len=32, max_new_tokens=6)).run(reqs)
        return [r.out_tokens for r in reqs]
    assert serve(3, prompts) == [serve(1, [p])[0] for p in prompts]


#: causal_conv1d launches per Mamba layer in a prefill or a decode step
K7_PER_MAMBA_LAYER = 3


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b",
                                  "gemma2-2b", "jamba-1.5-large-398b"])
def test_per_slot_engine_on_card_serves_each_request_as_alone(cuda, arch):
    """The per-slot ``Engine`` on the card (its decode steps CUDA-graph
    replays after an eager first) at smoke size in float32 with TF32
    off, dropless: prompts of 5, 9 and 13 tokens decoding together get
    the tokens each gets alone; attention, sliding windows, Mamba state
    (K7, counted once a Mamba layer a prefill and a decode step) and MoE
    layers at per-row positions."""
    import dataclasses
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_overrides(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params = build_model(cfg, cuda).init(
        torch.Generator(device=cuda).manual_seed(6))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 9, 13)]
    mamba = sum(s.mixer == "mamba" for s in cfg.layer_cycle) \
        * cfg.n_cycles

    def serve(batch, ps):
        reqs = [Request(prompt=list(p)) for p in ps]
        engine = Engine(build_model(cfg, cuda), params, ServeConfig(
            max_batch=batch, max_len=32, max_new_tokens=6))
        k7 = LAUNCHES["causal_conv1d"]
        engine.run(reqs)
        t = engine.timings()
        assert LAUNCHES["causal_conv1d"] - k7 \
            == K7_PER_MAMBA_LAYER * mamba * (t["prefills"]
                                             + t["decode_steps"])
        return [r.out_tokens for r in reqs]
    assert serve(3, prompts) == [serve(1, [p])[0] for p in prompts]
