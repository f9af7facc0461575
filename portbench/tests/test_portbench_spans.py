"""The span metrics over synthetic spans and device events: the slice,
each reader's arithmetic, no reading where there is nothing to read or
where the ``copy_out`` guard fails, the idle split by innermost span,
the move onto the trace's clock, the catalog listing the idle split for
a traced ``moe-closed64`` run only, and the readers over a profiled run
of the cell on the CPU."""

import json
import sys
from types import SimpleNamespace

import pytest

from portbench import catalog, harness
from portbench.yardstick import spans
from portbench.yardstick.trace import DeviceEvent

harness.import_port()

FIVE = ["queue_wait_ms.moe", "loop_gap_ms.moe", "copy_in_ms.moe",
        "gc_pause_share.moe", "idle_named_share.moe"]
#: where each of the three dispatches pops (µs)
BASES = (0.0, 1000.0, 2100.0)


def _dispatch(b: float, k: int):
    """One dispatch's spans at ``b``: pop to finish 800 µs, its forward
    on thread 2 from 150 to 700, the answers' copy-out from 400 to 690,
    two requests queued for 300 and 100 µs."""
    d = 10 + k
    loop = dict(thread=1, parent=d, dispatch=d)
    fwd = 100 + k
    work = dict(thread=2, parent=fwd, dispatch=d)
    return [
        spans.Span("gateway.dispatch", b, b + 800, 1, d, dispatch=d),
        spans.Span("gateway.to_task", b, b + 50, id=20 + k, **loop),
        spans.Span("gateway.stack", b + 50, b + 100, id=30 + k, **loop),
        spans.Span("gateway.hop_in", b + 100, b + 150, id=40 + k, **loop),
        spans.Span("runtime.forward", b + 150, b + 700, 2, fwd, d, -1, d),
        spans.Span("gateway.hop_back", b + 700, b + 750, id=50 + k, **loop),
        spans.Span("gateway.finish", b + 750, b + 800, id=60 + k, **loop),
        spans.Span("runtime.copy_in", b + 160, b + 260, id=70 + k, **work),
        spans.Span("runtime.layers", b + 260, b + 400, id=80 + k, **work),
        spans.Span("gateway.copy_out", b + 400, b + 690, id=90 + k,
                   **work),
        spans.Span("gateway.queue", b - 300, b, 1, 200 + 2 * k,
                   request=2 * k, dispatch=d),
        spans.Span("gateway.queue", b - 100, b, 1, 201 + 2 * k,
                   request=2 * k + 1, dispatch=d),
    ]


def _items(shift: float = 0.0, drift: float = 0.0, moved=None):
    """The spans on a clock ``shift`` µs off the trace's and running
    ``drift`` faster, and the spans ``moved`` names (name, dispatch
    index) ``moved[...]`` µs further."""
    moved = moved or {}
    out = []
    for k, b in enumerate(BASES):
        for s in _dispatch(b, k):
            d = moved.get((s.name, k), 0.0)
            out.append(spans.Span(s.name, s.ts + d, s.end + d, s.thread,
                                  s.id, s.parent, s.request, s.dispatch))
    out += [spans.Span("process.gc", 850, 870, 1, 300, arg=0),
            spans.Span("process.gc", 1850, 1870, 1, 301, arg=2),
            spans.Span("gateway.submit", 900, 910, 1, 302, request=4),
            spans.Span("gateway.submit", 1900, 1910, 1, 303, request=5),
            # the profiled warm-up's bare call: no dispatch
            spans.Span("runtime.copy_in", 2950, 2990, 2, 304)]
    return [spans.Span(s.name, s.ts * (1 + drift) + shift,
                       s.end * (1 + drift) + shift, s.thread, s.id,
                       s.parent, s.request, s.dispatch, s.arg) for s in out]


def _ev(cat, name, ts, end, **args):
    return DeviceEvent(cat, name, ts, end - ts, args)


def _run(events=True):
    evs = [_ev("kernel", "prev", -100, -50)]
    for b in BASES:
        evs += [_ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
                    b + 200, b + 260, bytes=4096),
                _ev("kernel", "void gemm_kernel<float>()", b + 270, b + 600),
                _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                    b + 620, b + 680, bytes=4096)]
    evs.append(_ev("kernel", "next", 3000, 3010))
    return SimpleNamespace(events=sorted(evs, key=lambda e: e.ts)
                           if events else [])


#: idle in the slice [-100, 3010]: 1,700 µs, of which 1,110 µs under a
#: span other than a queue wait (the warm-up's copy-in among them)
IDLE, NAMED = 1700.0, 1150.0


def test_slice_is_the_device_events_or_the_gateway_spans():
    assert spans.slice_us(_run(), _items()) == (-100, 3010)
    assert spans.slice_us(_run(events=False), _items()) == (-300, 2900)
    assert spans.slice_us(_run(), None) is None
    assert spans.slice_us(_run(events=False),
                          [spans.Span("process.gc", 0, 1, 1, 1)]) is None


def test_each_readers_arithmetic():
    run, items = _run(), _items()
    # popped in the slice: every request, 300 and 100 µs each
    assert spans.queue_wait_ms(run, items) == pytest.approx(0.2)
    # from 800 to 1000 and from 1800 to 2100
    assert spans.loop_gap_ms(run, items) == pytest.approx(0.25)
    # the warm-up's copy (40 µs, no dispatch) is not read
    assert spans.copy_in_ms(run, items) == pytest.approx(0.1)
    assert spans.gc_pause_share_pct(run, items) == pytest.approx(
        100 * 40 / 3110)
    assert spans.copy_out_share(run, items) == 1.0
    assert spans.idle_named_share_pct(run, items) == pytest.approx(
        100 * NAMED / IDLE)


def test_the_slice_cuts_what_it_reads():
    """Without device events the slice is the gateway spans' stretch
    ([-300, 2900]); a narrower device slice leaves out the dispatches
    and pops outside it."""
    assert spans.loop_gap_ms(_run(events=False), _items()) == \
        pytest.approx(0.25)
    run = SimpleNamespace(events=[e for e in _run().events
                                  if 900 <= e.ts <= 2700])
    # the slice is [1200, 2700]: no dispatch inside it, one pop (1000
    # is out, 2100 in)
    assert spans.slice_us(run, _items()) == (1200, 2700)
    assert spans.loop_gap_ms(run, _items()) is None
    assert spans.queue_wait_ms(run, _items()) == pytest.approx(0.2)
    assert spans.dispatch_spans(run, _items()) == []


def test_idle_by_innermost_span():
    split = spans.idle_by_span(_run(), _items())
    assert sum(split.values()) == pytest.approx(IDLE)
    assert split["(none)"] == pytest.approx(IDLE - NAMED)
    assert split["gateway.hop_back"] == pytest.approx(150.0)
    assert split["gateway.to_task"] == pytest.approx(150.0)
    # 40 µs a dispatch before its copy starts, and the warm-up's 40
    assert split["runtime.copy_in"] == pytest.approx(160.0)
    assert split["process.gc"] == pytest.approx(40.0)
    assert "gateway.queue" not in split
    assert spans.idle_by_span(_run(events=False), _items()) is None


@pytest.mark.parametrize("reader", [
    spans.queue_wait_ms, spans.loop_gap_ms, spans.copy_in_ms,
    spans.gc_pause_share_pct, spans.idle_named_share_pct,
    spans.copy_out_share, spans.forward_kernel_share, spans.guarded,
    spans.idle_by_span])
def test_nothing_to_read_reads_none(reader):
    assert reader(_run(), None) is None
    assert reader(_run(), []) is None
    if reader not in (spans.queue_wait_ms, spans.loop_gap_ms,
                      spans.copy_in_ms, spans.gc_pause_share_pct):
        assert reader(_run(events=False), _items()) is None


@pytest.mark.parametrize("shift, share", [(400.0, 0.0), (-150.0, 0.0),
                                          (60.0, 1.0), (-60.0, 1.0),
                                          (5000.0, None)])
def test_copy_out_share_on_the_nominal_clock(shift, share):
    """Spans moved off the trace's clock: earlier by more than the
    0.1 ms slack, or later by more than a copy-out span is long, no
    answer copy lies in its span; within the slack every one does;
    with no copy-out span in the slice there is nothing to test."""
    assert spans.copy_out_share(_run(), _items(shift)) == share


@pytest.mark.parametrize("shift", [0.0, 400.0, -150.0])
def test_anchors_put_the_spans_on_the_trace_clock(shift):
    """Spans off the trace's clock by ``shift``: each dispatch's input
    copy, which ends with its ``runtime.copy_in`` span, anchors them back
    where they belong, and every reading is that of the spans on the
    trace's clock."""
    run, items = _run(), _items(shift)
    assert spans.clock_anchors(run, items) == [
        (b + 260 + shift, -shift) for b in BASES]
    back = spans.on_device_clock(run, items)
    assert [(s.name, s.ts, s.end) for s in back] == [
        (s.name, pytest.approx(s.ts), pytest.approx(s.end))
        for s in _items()]
    assert spans.idle_named_share_pct(run, items) == pytest.approx(
        100 * NAMED / IDLE)
    assert spans.idle_by_span(run, items) == pytest.approx(
        spans.idle_by_span(run, _items()))


def test_anchors_follow_a_drifting_clock():
    """A host clock 20 % slow against the trace's: the anchors follow
    it, and every span lands where it belongs."""
    run, items = _run(), _items(drift=-0.2)
    assert spans.copy_out_share(run, items) < spans.COPY_GUARD
    shifts = [d for _, d in spans.clock_anchors(run, items)]
    assert shifts == pytest.approx([0.2 * (b + 260) for b in BASES])
    back = spans.on_device_clock(run, items)
    assert [(s.ts, s.end) for s in back] == [
        (pytest.approx(s.ts), pytest.approx(s.end)) for s in _items()]
    assert spans.idle_named_share_pct(run, items) == pytest.approx(
        100 * NAMED / IDLE)


def test_the_guard_is_not_the_anchor():
    """One dispatch's answer copy-out off by 0.4 ms against its own
    input copy: the anchors do not move it back, and 2/3 < 0.9 gives
    no reading."""
    run = _run()
    items = _items(moved={("gateway.copy_out", 1): 400.0})
    assert spans.copy_out_share(run, spans.on_device_clock(run, items)) \
        == pytest.approx(2 / 3)
    assert spans.guarded(run, items) is None
    assert spans.idle_named_share_pct(run, items) is None
    assert spans.idle_by_span(run, items) is None


def test_a_trace_that_lost_its_kernels_gives_no_reading():
    """The copies alone, as a trace that lost its kernel events holds
    them: the clock checks out, the idle does not."""
    run = _run()
    assert spans.forward_kernel_share(run, _items()) == 1.0
    run.events = [e for e in run.events if e.cat != "kernel"
                  or e.name in ("prev", "next")]
    assert spans.copy_out_share(run, _items()) == 1.0
    assert spans.forward_kernel_share(run, _items()) == 0.0
    assert spans.guarded(run, _items()) is None
    assert spans.idle_named_share_pct(run, _items()) is None


def test_without_input_copies_the_nominal_clock_stands():
    run = _run()
    run.events = [e for e in run.events if not e.is_htod]
    assert spans.clock_anchors(run, _items()) == []
    assert spans.on_device_clock(run, _items(150.0)) == _items(150.0)


def test_guard_fails_below_nine_in_ten():
    """One dispatch of three without its answer copy: 2/3 < 0.9 under
    every shift."""
    run = _run()
    run.events = [e for e in run.events
                  if not (e.cat == "gpu_memcpy" and "DtoH" in e.name
                          and e.ts > 2000)]
    assert spans.copy_out_share(run, _items()) == pytest.approx(2 / 3)
    assert spans.guarded(run, _items()) is None
    assert spans.idle_named_share_pct(run, _items()) is None


def test_metric_files_read_the_recorder(monkeypatch):
    monkeypatch.setattr(spans, "recorded", _items)
    want = {"queue_wait_ms.moe": 0.2, "loop_gap_ms.moe": 0.25,
            "copy_in_ms.moe": 0.1, "gc_pause_share.moe": 100 * 40 / 3110,
            "idle_named_share.moe": 100 * NAMED / IDLE}
    for name in FIVE:
        read = catalog.module("metrics", name).read
        assert read(_run()) == pytest.approx(want[name]), name
    monkeypatch.setattr(spans, "recorded", lambda: None)
    for name in FIVE:
        assert catalog.module("metrics", name).read(_run()) is None


def test_recorded_is_none_without_spans_or_without_the_recorder(
        monkeypatch):
    from repro_torch.ops import spans as port
    port.RECORDER.clear()
    assert spans.recorded() is None
    port.RECORDER.add("gateway.stack", 1, 2)
    try:
        assert [s.name for s in spans.recorded()] == ["gateway.stack"]
        monkeypatch.setitem(sys.modules, "repro_torch.ops.spans", None)
        monkeypatch.delattr("repro_torch.ops.spans")
        assert spans.recorded() is None      # a port that has no recorder
    finally:
        port.RECORDER.clear()


def test_recorded_spans_land_on_the_trace_clock(tmp_path):
    """A port span around a ``record_function`` marker, read back through
    ``recorded()``, within 0.5 ms of the marker in the exported trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.ops import spans as port
    port.RECORDER.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    try:
        with prof:
            with port.span("test.clock"):
                with record_function("test.marker"):
                    sum(range(200_000))
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        raw = json.loads(path.read_text())
        assert int(raw["baseTimeNanoseconds"]) == spans.trace_base_ns()
        marker = next(e for e in raw["traceEvents"]
                      if e.get("name") == "test.marker")
        got = next(s for s in spans.recorded() if s.name == "test.clock")
        assert abs(got.ts - marker["ts"]) < 500.0
        assert abs(got.end - (marker["ts"] + marker["dur"])) < 500.0
    finally:
        port.RECORDER.clear()


def test_catalog_lists_the_idle_split_for_a_traced_moe_run_only():
    """``idle_named_share.moe`` is listed, for a traced ``moe-closed64``
    run only; the other four are files a benchmark change can list by
    name (an untraced CPU run, which the harness's whole-run test reads
    every listed metric from, records no span for them)."""
    bench = catalog.benchmark()
    traced = catalog.metrics_for(bench, "moe-closed64", True)
    assert "idle_named_share.moe" in traced
    assert not set(FIVE) & set(traced) - {"idle_named_share.moe"}
    assert not set(FIVE) & set(catalog.metrics_for(bench, "moe-closed64",
                                                   False))
    for trace in (False, True):
        assert not set(FIVE) & set(catalog.metrics_for(bench, "cnn-closed64",
                                                       trace))
    m = {m["name"]: m for m in bench["per_layer"]}["idle_named_share.moe"]
    assert m["source"] == "program_span" and m["moves"] == "tokens_per_s"
    assert m["workloads"] == ["moe-closed64"]
    for name in FIVE:
        assert callable(catalog.module("metrics", name).read)


def test_span_metrics_read_a_profiled_run_on_the_cpu(tmp_path):
    """The MoE cell at test sizes run on the CPU inside a CPU profiler
    session: the port records its spans, and each reader but the idle
    split (no device events on the CPU) reads the run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from portbench.tests.tiny import make_root
    from repro_torch.ops import spans as port
    root = make_root(tmp_path)
    port.RECORDER.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = harness.run_cell("moe-closed64", 2 ** 31 + 977, 1.0,
                                   device="cpu", root=root)
        assert out.correct, out.checks
        names = {s.name for s in port.RECORDER.snapshot()}
        assert {"gateway.queue", "gateway.dispatch", "runtime.copy_in",
                "gateway.copy_out", "moe.experts"} <= names
        value = {name: catalog.module("metrics", name, root).read(out.data)
                 for name in FIVE}
    finally:
        port.RECORDER.clear()
    assert value.pop("idle_named_share.moe") is None
    gc_share = value.pop("gc_pause_share.moe")
    assert gc_share is not None and 0 <= gc_share < 100
    for name, v in value.items():
        assert v is not None and np.isfinite(v) and v > 0, name
