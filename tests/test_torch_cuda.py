"""Card tests of the port: each CUDA kernel against its plain PyTorch
version on the card (tolerance 0 for the integer kernels and the conv1d,
stated tolerances for attention) — K1 and K2 in their int32 and their
requantizing entries, K1 on both its routes (dp4a for int8 dots, the
CUDA cores' multiply-add for int32 ones) — the launch contract, and
the slices on the card against the JAX reference's golden outputs: the
serving path (K1–K3), the per-plane path (``ConvBlock.apply``,
``cnn_forward_loop``, ``validate_plan``: K3–K6), the LM path (K7,
K8: ``prefill``, ``decode_step`` and the ``Engine``), and the persistent
cache's kernel libraries (a corrupt one quarantined and rebuilt; a warm
start in a fresh process that builds nothing).
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
from repro_torch.configs import smoke_config
from repro_torch.kernels import conv1d, conv2d, flash_attention as fa
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
    before = kernel.launches
    y = kernel(xc, wc, data_bits=d, coeff_bits=c)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
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
        before = kernel.launches
        y = kernel(xc, wc, data_bits=d, coeff_bits=c, shift=shift,
                   out_bits=d)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
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
    before = kernel.launches
    empty = kernel(x[:0], w, **kw)
    assert tuple(empty.shape) == (0, 16, 8, 3) and empty.dtype == torch.int8
    assert kernel.launches == before


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
    before = kernel.launches
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        staged.copy_(xc)
        y = kernel(staged, wc, **kw)
    side.synchronize()
    assert kernel.launches == before + 1
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
    before = conv2d.conv1_layer.launches
    y = conv2d.conv1_layer(xc, wc, data_bits=d, coeff_bits=c)
    torch.cuda.synchronize()
    assert conv2d.conv1_layer.launches == before + 1
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
    before = [fn.launches for fn in counters]
    reqs = [ImageRequest(image=x, request_id=i)
            for i, x in enumerate(engine.compiled.sample_inputs(8))]
    engine.run(reqs)
    assert np.array_equal(np.stack([r.image for r in reqs]), gx)
    assert np.array_equal(np.stack([r.output for r in reqs]), gy)
    assert [fn.launches - b for fn, b in zip(counters, before)] \
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
    before = [fn.launches for fn in counters]

    async def main():
        async with gw:
            futs = [gw.submit_nowait(x) for x in gx]
            return await asyncio.gather(*futs)

    outs = asyncio.run(main())
    assert np.array_equal(np.stack(outs), gy)
    forwards = sum(engine.compiled.bucket_hits.values())
    assert forwards == 1 and gw.stats()["served"] == len(gx)
    assert [fn.launches - b for fn, b in zip(counters, before)] \
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
    before = kernel.launches
    y = kernel(xc, wc, data_bits=d, coeff_bits=c)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
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
    before = kernel.launches
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        staged.copy_(xc)
        y = kernel(staged, wc, data_bits=8, coeff_bits=6)
    side.synchronize()
    assert kernel.launches == before + 1
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
    before = kernel.launches
    assert kernel(x[:0], w[:0], data_bits=6, coeff_bits=4).shape[0] == 0
    assert kernel.launches == before


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
    before = conv2d.conv4_planes.launches
    val = deploy.validate_plan(plan, cfg, device=cuda)
    assert conv2d.conv4_planes.launches > before
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
    before = conv1d.causal_conv1d.launches
    y = conv1d.causal_conv1d(x, w, st)
    torch.cuda.synchronize()
    assert conv1d.causal_conv1d.launches == before + 1
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
               (2, 200, 70, 8, 1, 128, False, torch.bfloat16)]


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
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
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


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-1.3b"])
def test_lm_on_card_matches_golden(cuda, arch):
    """The smoke configs at float32 on the card against the reference's
    committed outputs: logits within 2e-3, greedy tokens equal; K8 runs
    once per attention layer in prefill and never in decode, K7 three
    times per Mamba layer in both."""
    cfg = smoke_config(arch).with_overrides(dtype="float32")
    with np.load(LM_GOLDEN) as z:
        g = {k: z[k] for k in z.files if k.startswith(arch + "/")}
    model = build_model(cfg, cuda)
    params = convert.lm_params_from_numpy(
        convert.nested_from_flat(g, f"{arch}/params"), cfg, cuda)
    toks = g[f"{arch}/tokens"]
    attn = cfg.n_layers if arch.startswith("llama") else 0
    mamba = cfg.n_layers - attn
    k7, k8 = conv1d.causal_conv1d.launches, fa.flash_attention.launches
    logits, _ = model.prefill(params, {"tokens": toks})
    assert fa.flash_attention.launches - k8 == attn
    assert conv1d.causal_conv1d.launches - k7 == 3 * mamba
    np.testing.assert_allclose(logits.cpu().numpy(),
                               g[f"{arch}/prefill_logits"], rtol=2e-3,
                               atol=2e-3)
    pos = g[f"{arch}/decode_pos"]
    _, cache = model.prefill(params, {"tokens": toks[:, :pos[0]]})
    for entry in cache.values():
        for name in ("k", "v"):
            if name in entry:
                entry[name] = torch.nn.functional.pad(
                    entry[name], (0, 0, 0, 0, 0, len(pos)))
    k7, k8 = conv1d.causal_conv1d.launches, fa.flash_attention.launches
    for i, p in enumerate(pos):
        logits, cache = model.decode_step(params, cache, toks[:, p:p + 1],
                                          int(p))
        np.testing.assert_allclose(logits.cpu().numpy(),
                                   g[f"{arch}/decode_logits"][i],
                                   rtol=2e-3, atol=2e-3)
    assert fa.flash_attention.launches == k8
    assert conv1d.causal_conv1d.launches - k7 == 3 * mamba * len(pos)
    reqs = [Request(prompt=[int(t) for t in p], request_id=i)
            for i, p in enumerate(g[f"{arch}/engine_prompts"])]
    Engine(model, params, ServeConfig(max_batch=2, max_len=32,
                                      max_new_tokens=5)).run(reqs)
    assert [r.out_tokens for r in reqs] == g[f"{arch}/engine_tokens"] \
        .tolist()
