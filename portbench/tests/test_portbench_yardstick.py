"""The benchmark's own arithmetic: work per request, K1's bytes, the
trace reduction and the metric readers over a recorded run."""

import numpy as np
import pytest

from portbench import catalog
from portbench.yardstick import readings, trace, work

CNN = catalog.config("quickstart-cnn")
MOE = catalog.config("qwen3-moe-30b-a3b-experts")
#: a gateway run's record
RunData = catalog.module("servers", "gateway").RunData


def test_cnn_ops_per_image():
    # 2·H·W·9·Σ Cin·Cout = 2·4096·9·(8 + 64 + 32)
    assert work.cnn_ops_per_image(CNN["network"]) == 7_667_712


def test_moe_flops_per_token():
    # 32 layers × (router 2·2048·128 + 8 experts × 3 products
    # × 2·2048·768)
    assert work.moe_flops_per_token(MOE) == 32 * 76_021_760 \
        == 2_432_696_320


@pytest.mark.parametrize("i, nbytes, bound_ms", [
    (0, 65_536 + 72 + 524_288, 0.0001761),
    (1, 524_288 + 576 + 524_288, 0.0003132),
    (2, 524_288 + 288 + 262_144, 0.0002348),
])
def test_k1_launch_bytes_and_bound(i, nbytes, bound_ms):
    """Each layer's bytes at bucket 16 (int8 in, weights, int8 out) and
    the bound they give at 3.35 TB/s: the port's ``bound_ms`` for K1's
    requantizing entry at the three quickstart shapes."""
    net = CNN["network"]
    layer = net["layers"][i]
    assert work.conv_layer_bytes(16, 32, 128, layer,
                                 layer["data_bits"]) == nbytes
    assert work.conv_layer_bound_s(16, net, i) * 1e3 == pytest.approx(
        bound_ms, rel=1e-3)


def _emitted(status, done, units: int) -> dict:
    """What a gateway run emits: each answered request's units at its
    answer's time."""
    ok = np.asarray(status) == "done"
    return {"emitted_t": np.asarray(done, float)[ok],
            "emitted_units": np.full(int(ok.sum()), units)}


def _run(status, sent, done, **kw) -> RunData:
    return RunData(cell={}, config=CNN, seconds=10.0, setup_s=1.0,
                   sent=np.asarray(sent, float),
                   done=np.asarray(done, float), status=np.asarray(status),
                   **_emitted(status, done, 1),
                   stages=kw.pop("stages", []), units_per_request=1,
                   ops_per_unit=7_667_712, request_bytes=4096,
                   max_batch=16, **kw)


def test_rate_and_mfu_count_answers_in_the_window():
    sent = np.array([0.0, 1.0, 2.0, 3.0, 9.0, 9.9])
    done = np.array([0.5, 1.5, 2.5, 3.5, 9.5, 10.5])
    run = _run(["done"] * 6, sent, done, traced=(8.0, 10.0))
    assert readings.rate_per_s(run) == pytest.approx(5 / 10.0)
    # before the traced slice: 4 images in 8 s
    assert readings.mfu_pct(run, 1e15) == pytest.approx(
        100.0 * 0.5 * 7_667_712 / 1e15)


def _ev(cat, name, ts, dur, **args):
    return trace.DeviceEvent(cat, name, ts, dur, args)


def test_busy_union_and_breakdown():
    evs = [_ev("kernel", "void a<int>(int*)", 0, 10),
           _ev("kernel", "b", 5, 10),          # overlaps a
           _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 30, 5)]
    assert trace.busy_s(evs) == pytest.approx(20e-6)
    bd = trace.breakdown(evs)
    assert bd["device_ops"][0] == ["a<int>", pytest.approx(10e-6)]
    assert bd["idle_gaps"] == [["b -> Memcpy DtoH", pytest.approx(15e-6)]]


def test_dispatches_cut_at_payload_copies():
    """The timeline is cut at host-to-device copies of whole payloads; a
    copy of some other size is part of a dispatch, and the partial
    dispatches at either end are dropped."""
    h = "Memcpy HtoD (Pageable -> Device)"
    evs = [_ev("kernel", "fused_dp4a_kernel<x>", 0, 2),
           _ev("gpu_memcpy", h, 10, 1, bytes=3 * 4096),
           _ev("kernel", "fused_dp4a_kernel<x>", 12, 2),
           _ev("gpu_memcpy", h, 15, 1, bytes=100),
           _ev("gpu_memcpy", h, 20, 1, bytes=16 * 4096),
           _ev("kernel", "fused_dp4a_kernel<x>", 22, 2),
           _ev("gpu_memcpy", h, 30, 1, bytes=4096)]
    cut = trace.dispatches(evs, 4096, 16)
    assert [(n, len(e)) for n, e in cut] == [(3, 3), (16, 2)]


def test_k1_roofline_over_traced_dispatches():
    """Three K1 launches of 1 ms each per dispatch of 16 images: the
    share is the three layers' bounds over 3 ms."""
    h = "Memcpy HtoD (Pageable -> Device)"
    evs = []
    for t0 in (0, 10_000):
        evs.append(_ev("gpu_memcpy", h, t0, 10, bytes=16 * 4096))
        evs += [_ev("kernel", "void (anonymous namespace)::fused_dp4a_kernel"
                    "<signed char, 8, true>(signed char const*)",
                    t0 + 100 + 1000 * k, 1000)
                for k in range(3)]
    evs.append(_ev("gpu_memcpy", h, 20_000, 10, bytes=4096))
    run = _run(["done"], [0.0], [1.0], traced=(8.0, 10.0),
               events=evs)
    bound = sum(work.conv_layer_bound_s(16, CNN["network"], i)
                for i in range(3))
    assert readings.k1_roofline_pct(run) == pytest.approx(
        100 * bound / 3e-3)
    assert readings.idle_share_pct(run) == pytest.approx(
        100 * (1 - 2 * 3010e-6 / 2.0 - 10e-6 / 2.0))


def test_expert_gemm_roofline_skips_a_dispatch_with_lost_events():
    """Two dispatches of 16 blocks with 8 GEMMs of 1 ms, and one whose
    trace lost a GEMM: the share counts the first two only."""
    moe = catalog.config("qwen3-moe-30b-a3b-experts")
    h = "Memcpy HtoD (Pageable -> Device)"
    block = 32 * 2048 * 4
    evs = []
    for d, gemms in enumerate((8, 8, 7)):
        t0 = d * 20_000
        evs.append(_ev("gpu_memcpy", h, t0, 10, bytes=16 * block))
        evs += [_ev("kernel", "sm80_xmma_gemm_f32f32_ffma", t0 + 100
                    + 1000 * k, 1000) for k in range(gemms)]
    evs.append(_ev("gpu_memcpy", h, 60_000, 10, bytes=block))
    run = RunData(cell={}, config=moe, seconds=10.0, setup_s=1.0,
                  sent=np.zeros(1),
                  done=np.ones(1), status=np.asarray(["done"]),
                  **_emitted(["done"], [1.0], 32), stages=[],
                  units_per_request=32, ops_per_unit=0,
                  request_bytes=block, max_batch=16, traced=(8.0, 10.0),
                  events=evs)
    need = 2 * 512 * 2_432_696_320 / 67e12
    assert readings.expert_gemm_roofline_pct(run) == pytest.approx(
        100 * need / 16e-3)
