"""The port's batch-bucketed runtime (``repro_torch.runtime.compiled``)
held against the reference's ``CompiledCNN``: outputs at every rung of
``bucket_ladder(16)`` and past it (on a narrow net and on both
committed plans, whose dot layers run the requantizing entries), the
same requests from the same seed, admission checks, the single-flight
cache, abort polling, and no silent fallback to the CPU."""

import dataclasses
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cnn as ref_cnn
from repro.core import deploy as ref_deploy
from repro.runtime import CompiledCNN as RefCompiledCNN
from repro.runtime import bucket_ladder as ref_bucket_ladder
from repro_torch import convert
from repro_torch.blocks import base
from repro_torch.core import cnn, deploy
from repro_torch.kernels import conv2d
from repro_torch.runtime import (CompiledCNN, DispatchAborted,
                                 ExecutableCache, bucket_ladder)
from torch_parity import narrow_config


@pytest.fixture(scope="module")
def pair():
    """The reference's CompiledCNN and the port's (on the CPU) over the
    narrow three-kernel net, with the reference's weights on both."""
    ref_cfg, cfg = narrow_config(ref_cnn), narrow_config(cnn)
    arrays = [np.asarray(w) for w in
              ref_cnn.init_cnn(jax.random.PRNGKey(0), ref_cfg)]
    blocks = [s.block for s in cfg.layers]
    theirs = RefCompiledCNN(ref_cfg, [jnp.asarray(a) for a in arrays],
                            blocks, max_batch=16, warmup=False)
    mine = CompiledCNN(cfg, convert.params_from_numpy(arrays, cfg, "cpu"),
                       blocks, max_batch=16, device="cpu")
    return theirs, mine


def test_bucket_ladder_matches_reference():
    for m in range(1, 40):
        assert bucket_ladder(m) == ref_bucket_ladder(m)
    with pytest.raises(ValueError, match="max_batch=0"):
        bucket_ladder(0)


def test_sample_inputs_match_reference(pair):
    theirs, mine = pair
    for seed in (0, 3):
        a, b = theirs.sample_inputs(5, seed=seed), mine.sample_inputs(
            5, seed=seed)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n", list(bucket_ladder(16)) + [3, 17])
def test_compiled_matches_reference_at_every_bucket(pair, n):
    """Every rung of the ladder, a padded batch (3 → bucket 4) and a
    chunked one (17 → 16 + 1)."""
    theirs, mine = pair
    xs = np.stack(theirs.sample_inputs(n, seed=n))
    want = np.asarray(theirs(xs))
    got = mine(xs)
    assert got.dtype == torch.int8 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)


SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
GOLDEN = SRC / "golden" / "quickstart_reference.npz"


@pytest.fixture(scope="module", params=["quickstart_v5e",
                                        "quickstart_v5e_conv1_conv3"])
def plan_pair(request):
    """Both runtimes on a committed plan with the reference's golden
    weights, images cut to 16 x 24 (the weights do not depend on the
    image size)."""
    text = (SRC / "plans" / f"{request.param}.json").read_text()
    ref_cfg = dataclasses.replace(
        ref_deploy.plan_config(ref_deploy.DeploymentPlan.from_json(text)),
        img_h=16, img_w=24)
    plan = deploy.DeploymentPlan.from_json(text)
    cfg = dataclasses.replace(deploy.plan_config(plan), img_h=16, img_w=24)
    with np.load(GOLDEN) as z:
        arrays = [z[f"{request.param}.w{i}"] for i in range(len(cfg.layers))]
    theirs = RefCompiledCNN(ref_cfg, [jnp.asarray(a) for a in arrays],
                            plan.block_names(), max_batch=16, warmup=False)
    mine = CompiledCNN(cfg, convert.params_from_numpy(arrays, cfg, "cpu"),
                       plan.block_names(), max_batch=16, device="cpu")
    return theirs, mine


@pytest.mark.parametrize("n", list(bucket_ladder(16)) + [3, 17])
def test_committed_plans_match_reference_at_every_bucket(plan_pair, n,
                                                         monkeypatch):
    """Each dot layer (conv4, conv3 packed or not) goes through its
    kernel's requantizing entry, Conv1 through its layer kernel and the
    torch requantize; the outputs equal the reference's at every bucket."""
    theirs, mine = plan_pair
    calls = []
    for name in ("fused_dot_layer_requant_plain",
                 "packed_dot_layer_requant_plain"):
        fn = getattr(base, name)
        monkeypatch.setattr(base, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    xs = np.stack(theirs.sample_inputs(n, seed=n))
    got = mine(xs)
    assert np.array_equal(got.numpy(), np.asarray(theirs(xs)))
    blocks = mine.blocks
    dots = sum(b.name != "conv1" for b in blocks)
    assert len(calls) == dots * -(-n // 16)


def test_single_request_and_empty_batch(pair):
    theirs, mine = pair
    x = theirs.sample_inputs(1, seed=9)[0]
    assert np.array_equal(mine(x).numpy(), np.asarray(theirs(x)))
    empty = mine(np.zeros((0,) + mine.in_shape, np.int8))
    assert tuple(empty.shape) == (0, 16, 24, 3)
    assert tuple(empty.shape) == np.asarray(
        theirs(np.zeros((0,) + theirs.in_shape, np.int8))).shape


def test_warmup_prepares_every_bucket_and_stats_match_reference(pair):
    theirs, mine = pair
    assert mine.warmed_up
    assert mine.compiles == len(mine.buckets) * mine.num_layers
    assert set(mine.stats()) == set(theirs.stats())
    lazy = CompiledCNN(mine.cfg, mine.params, mine.blocks, max_batch=4,
                       device="cpu", warmup=False)
    lazy(mine.sample_inputs(1)[0])
    assert lazy.compiles == lazy.num_layers and not lazy.warmed_up
    assert lazy.bucket_hits == {1: 1, 2: 0, 4: 0}


@pytest.mark.parametrize("case", ["shape", "fraction", "range"])
def test_validate_input_messages_match_reference(pair, case):
    theirs, mine = pair
    x = np.zeros(mine.in_shape, np.float32)
    if case == "shape":
        x = x[:8]
    elif case == "fraction":
        x[0, 0, 0] = 0.5
    else:
        x[0, 0, 0] = 200
    msgs = []
    for model in (theirs, mine):
        with pytest.raises(ValueError) as e:
            model.validate_input(x, request_id=7)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_call_rejects_wrong_shape_and_dtype(pair):
    _, mine = pair
    with pytest.raises(ValueError, match="image shape"):
        mine(np.zeros((2, 16, 8, 1), np.int8))
    with pytest.raises(ValueError, match="dtype int16 != compiled input"):
        mine(np.zeros((2,) + mine.in_shape, np.int16))


def test_should_abort_is_polled_between_layers(pair):
    _, mine = pair
    polls = []

    def abort_before_layer_2():
        polls.append(1)
        return len(polls) > 2

    with pytest.raises(DispatchAborted, match="before layer 2"):
        mine(np.stack(mine.sample_inputs(2)),
             should_abort=abort_before_layer_2)


def test_shared_cache_keeps_weights_per_model(pair):
    """Two models over identical layers share one preparation per
    (layer, bucket); each still runs its own weights."""
    theirs, mine = pair
    cache = ExecutableCache()
    gen = torch.Generator().manual_seed(1)
    other = [torch.randint(-8, 8, tuple(w.shape), generator=gen,
                           dtype=torch.int8) for w in mine.params]
    a = CompiledCNN(mine.cfg, mine.params, mine.blocks, max_batch=2,
                    device="cpu", exec_cache=cache)
    b = CompiledCNN(mine.cfg, other, mine.blocks, max_batch=2,
                    device="cpu", exec_cache=cache)
    assert a.compiles == 6 and b.compiles == 0 and len(cache) == 6
    xs = np.stack(mine.sample_inputs(2))
    assert np.array_equal(a(xs).numpy(), np.asarray(theirs(xs)))
    assert torch.equal(b(xs), cnn.cnn_forward_ref(
        other, torch.from_numpy(xs), mine.cfg))


def test_executable_cache_is_single_flight():
    cache = ExecutableCache(on_event=lambda e, f: events.append(e))
    events, builds = [], []
    gate = threading.Event()

    def build():
        builds.append(1)
        gate.wait(5)
        return "exe"

    threads = [threading.Thread(target=cache.get_or_build,
                                args=(("k",), build)) for _ in range(4)]
    for t in threads:
        t.start()
    while cache.coalesced < 3:
        threading.Event().wait(0.01)
    gate.set()
    for t in threads:
        t.join(5)
        assert not t.is_alive()
    assert builds == [1] and events == ["cache_compile"]
    # the three waiters are served the one build as hits
    assert cache.stats() == {"executables": 1, "compiles": 1, "hits": 3,
                             "coalesced": 3}
    assert cache.get_or_build(("k",), build) == "exe"
    assert cache.hits == 4


def test_executable_cache_failed_build_frees_key():
    def boom(event, fields):
        raise RuntimeError("observer")     # must never break serving

    cache = ExecutableCache(on_event=boom)
    with pytest.raises(KeyError):
        cache.get_or_build(("k",), lambda: {}["missing"])
    assert ("k",) not in cache
    assert cache.get_or_build(("k",), lambda: "exe") == "exe"


def test_cuda_without_card_raises(pair, monkeypatch):
    """No silent fallback: asking for the card where there is none
    raises instead of running on the CPU."""
    _, mine = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CompiledCNN(mine.cfg, mine.params, mine.blocks, max_batch=2)
    with pytest.raises(RuntimeError, match="is_available"):
        CompiledCNN.from_plan(_plan_of(mine), device="cuda")


def _plan_of(model):
    from repro_torch.core import deploy
    from repro_torch.core.allocate import BUDGET_RESOURCES, DeviceProfile
    layers = tuple(deploy.LayerAssignment(
        index=i, block=s.block, data_bits=s.data_bits,
        coeff_bits=s.coeff_bits, calls=1,
        demand={r: 0.0 for r in BUDGET_RESOURCES})
        for i, s in enumerate(model.cfg.layers))
    return deploy.DeploymentPlan(
        device=DeviceProfile("t", {r: 1.0 for r in BUDGET_RESOURCES}),
        target=0.8, layers=layers, demand={}, usage_pct={"x": 0.0},
        convs_per_step=1.0, cnn=model.cfg)


def test_from_plan_draws_seeded_weights(pair):
    _, mine = pair
    a = CompiledCNN.from_plan(_plan_of(mine), device="cpu", max_batch=1)
    b = CompiledCNN.from_json(_plan_of(mine).to_json(), device="cpu",
                              max_batch=1)
    for wa, wb, spec in zip(a.params, b.params, mine.cfg.layers):
        assert torch.equal(wa, wb)
        assert wa.dtype == conv2d.container_dtype(spec.coeff_bits)


def test_kernel_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on the card gets no plain
    version: the wrapper raises."""
    from repro_torch.blocks import base
    x = torch.zeros((1, 16, 8, 2), dtype=torch.int8, device="meta")
    w = torch.zeros((3, 2, 3, 3), dtype=torch.int8, device="meta")
    for fn in (conv2d.conv1_layer, base.fused_dot_layer,
               base.packed_dot_layer):
        with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
            fn(x, w, data_bits=6, coeff_bits=4)


def test_resolve_device_names_the_card_index(monkeypatch):
    """``cuda`` resolves to the current card with its index, as tensors
    moved there report their device, so the prepared launches' device
    checks and cache keys compare equal."""
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
