"""``repro_torch.ops.spans`` and its sites on the MoE serving path, on
the CPU: nothing is recorded without a profiler; under one, every
dispatch of ``AsyncCNNGateway`` leaves its span tree (the worker
thread's spans included), every request its submit and queue spans,
``DispatchStages`` equals the spans' stamps, the ring drops and counts
past its bound, a garbage collection leaves ``process.gc``, and the
clock offset puts a span on the exported trace's timeline."""

import asyncio
import gc
import json
from collections import Counter

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.ops import spans
from repro_torch.runtime.workloads import (MoELayerSpec, MoEWorkloadSpec,
                                           plan_moe_deployment)
from repro_torch.serve import AsyncCNNGateway, AsyncServeConfig

N_LAYERS = 2
REQUESTS = 10
MAX_BATCH = 4


def _plan():
    layer = MoELayerSpec(d_ff_expert=16, num_experts=4, top_k=2)
    return plan_moe_deployment(
        MoEWorkloadSpec(layers=(layer,) * N_LAYERS, d_model=8, seq_len=8),
        "v5e")


def _serve():
    """Serve ``REQUESTS`` token blocks through a gateway on the CPU;
    returns its stage log and the requests' ids."""
    async def main():
        gw = AsyncCNNGateway(AsyncServeConfig(max_batch=MAX_BATCH,
                                              max_pending=16))
        gw.register_plan(_plan(), device="cpu")
        gw.stage_log = []
        async with gw:
            xs = gw.plans["plan0"].compiled.sample_inputs(REQUESTS, seed=0)
            futs = [gw.submit_nowait(x) for x in xs]
            await asyncio.gather(*futs)
        return gw.stage_log, [f._req.request_id for f in futs]
    return asyncio.run(main())


@pytest.fixture
def recorder():
    spans.RECORDER.clear()
    yield spans.RECORDER
    spans.RECORDER.clear()


@pytest.fixture
def traced(recorder):
    """A gateway run under a CPU profiler: (stage log, request ids,
    spans)."""
    with profile(activities=[ProfilerActivity.CPU]):
        log, ids = _serve()
    return log, ids, recorder.snapshot()


def test_no_profiler_records_nothing(recorder):
    log, ids = _serve()
    assert sum(st.n for st in log) == REQUESTS
    assert recorder.snapshot() == [] and recorder.dropped == 0
    assert not spans.on()
    assert spans.span("x") is spans.span("y")    # the shared null context


def _by_parent(items):
    out = {}
    for s in items:
        out.setdefault(s.parent, []).append(s)
    return out


def test_every_dispatch_leaves_its_span_tree(traced):
    log, ids, got = traced
    kids = _by_parent(got)
    dispatches = sorted((s for s in got if s.name == "gateway.dispatch"),
                        key=lambda s: s.start)
    assert len(dispatches) == len(log) >= 3
    for d in dispatches:
        assert d.dispatch == d.id and d.parent == 0 and d.request == -1
        children = {s.name: s for s in kids[d.id]}
        assert sorted(children) == sorted(
            ["gateway.to_task", "gateway.stack", "gateway.hop_in",
             "runtime.forward", "gateway.hop_back", "gateway.finish"])
        assert len(kids[d.id]) == 6
        assert all(s.dispatch == d.id for s in kids[d.id])
        fwd = children["runtime.forward"]
        assert fwd.thread != d.thread          # the worker thread
        assert children["gateway.stack"].thread == d.thread
        under = {s.name: s for s in kids[fwd.id]}
        assert sorted(under) == ["gateway.copy_out", "runtime.copy_in",
                                 "runtime.layers"]
        assert all(s.dispatch == d.id and s.thread == fwd.thread
                   for s in kids[fwd.id])
        experts = kids[under["runtime.layers"].id]
        assert [s.name for s in experts] == ["moe.experts"] * N_LAYERS
        assert all(s.dispatch == d.id for s in experts)
        # children lie inside their parents, in stage order
        stages = sorted(kids[d.id], key=lambda s: s.start)
        assert stages[0].start == d.start and stages[-1].end == d.end
        assert all(a.end == b.start for a, b in zip(stages, stages[1:]))
        for s in kids[fwd.id]:
            assert fwd.start <= s.start <= s.end <= fwd.end


def test_request_spans_carry_their_dispatch(traced):
    log, ids, got = traced
    dispatch_ids = {s.id for s in got if s.name == "gateway.dispatch"}
    submits = [s for s in got if s.name == "gateway.submit"]
    queues = [s for s in got if s.name == "gateway.queue"]
    assert sorted(s.request for s in submits) == sorted(ids)
    assert sorted(s.request for s in queues) == sorted(ids)
    assert {s.dispatch for s in queues} == dispatch_ids
    per_dispatch = Counter(s.dispatch for s in queues)
    pops = {s.id: s.start for s in got if s.name == "gateway.dispatch"}
    for q in queues:
        assert q.end == pops[q.dispatch] and q.start <= q.end
    by_start = sorted(pops, key=pops.get)
    assert [per_dispatch[d] for d in by_start] == [st.n for st in log]
    sub = {s.request: s for s in submits}
    for q in queues:                 # admitted inside its submit
        assert sub[q.request].start <= q.start <= sub[q.request].end


def test_dispatch_stages_are_the_spans_stamps(traced):
    log, ids, got = traced
    kids = _by_parent(got)
    dispatches = sorted((s for s in got if s.name == "gateway.dispatch"),
                        key=lambda s: s.start)
    fields = ("to_task", "stack", "hop_in", "forward", "hop_back", "finish")
    for st, d in zip(log, dispatches):
        by_name = {s.name: s for s in kids[d.id]}
        for field, name in zip(fields, ("gateway.to_task", "gateway.stack",
                                        "gateway.hop_in", "runtime.forward",
                                        "gateway.hop_back",
                                        "gateway.finish")):
            s = by_name[name]
            assert getattr(st, field) == (s.end - s.start) / 1e9, field
        assert st.total == pytest.approx((d.end - d.start) / 1e9, abs=1e-9)


def test_ring_drops_and_counts_past_its_bound():
    rec = spans.SpanRecorder(capacity=4)
    for k in range(10):
        rec.add(f"s{k}", k, k + 1)
    kept = rec.snapshot()
    assert [s.name for s in kept] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6
    assert len({s.id for s in kept}) == 4
    rec.clear()
    assert rec.snapshot() == [] and rec.dropped == 0


def test_garbage_collection_leaves_a_span(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("test.first"):        # hooks GC on first record
            pass
        gc.collect()
    collected = [s for s in recorder.snapshot() if s.name == "process.gc"]
    assert collected and collected[-1].arg == 2
    assert all(s.start <= s.end for s in collected)
    n = len(recorder.snapshot())
    gc.collect()                              # off: nothing more
    assert len(recorder.snapshot()) == n


def test_span_lands_on_the_exported_trace(recorder, tmp_path):
    """A span around a ``record_function`` marker, moved onto the trace's
    clock (Unix time less ``baseTimeNanoseconds``), within 0.5 ms of the
    marker's event."""
    prof = profile(activities=[ProfilerActivity.CPU])
    with prof:
        with spans.span("test.clock") as sp:
            with record_function("test.marker"):
                sum(range(200_000))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        raw = json.load(f)
    marker = next(e for e in raw["traceEvents"]
                  if e.get("name") == "test.marker")
    base = int(raw.get("baseTimeNanoseconds", 0))
    off = recorder.unix_offset_ns
    start_us = (sp.start + off - base) / 1e3
    end_us = (sp.end + off - base) / 1e3
    assert abs(marker["ts"] - start_us) < 500.0
    assert abs(marker["ts"] + marker["dur"] - end_us) < 500.0
    assert start_us <= marker["ts"] and marker["ts"] + marker["dur"] <= end_us
